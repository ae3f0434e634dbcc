"""Grace .xvg table read/write — copy of viamd_tpu.io.xvg.

Capability mirror of md_xvg.h (script `import("file.xvg")` at
VIAMD src/viamd.cpp:2852; export_xvg at src/main.cpp:5628).
"""

from __future__ import annotations

import numpy as np


def read_xvg(path: str) -> tuple[np.ndarray, dict]:
    """Read .xvg → ((ncols, nrows) float array, metadata dict)."""
    meta: dict = {"title": "", "xaxis": "", "yaxis": "", "legends": []}
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("@"):
                body = line[1:].strip()
                if body.startswith("title"):
                    meta["title"] = body.split('"')[1] if '"' in body else ""
                elif body.startswith("xaxis"):
                    meta["xaxis"] = body.split('"')[1] if '"' in body else ""
                elif body.startswith("yaxis"):
                    meta["yaxis"] = body.split('"')[1] if '"' in body else ""
                elif " legend " in body:
                    meta["legends"].append(
                        body.split('"')[1] if '"' in body else ""
                    )
                continue
            try:
                rows.append([float(t) for t in line.split()])
            except ValueError:
                continue
    if not rows:
        return np.zeros((0, 0), np.float32), meta
    ncol = min(len(r) for r in rows)
    arr = np.asarray([r[:ncol] for r in rows], np.float32).T
    return arr, meta


def write_xvg(
    path_or_buf,
    columns: np.ndarray,  # (ncols, nrows)
    title: str = "",
    xaxis: str = "",
    yaxis: str = "",
    legends: list[str] | None = None,
):
    """Write columns as .xvg (first column = x)."""
    cols = np.asarray(columns)
    lines = [
        f'@    title "{title}"',
        f'@    xaxis label "{xaxis}"',
        f'@    yaxis label "{yaxis}"',
        "@TYPE xy",
    ]
    for i, leg in enumerate(legends or []):
        lines.append(f'@ s{i} legend "{leg}"')
    for r in range(cols.shape[1]):
        lines.append(" ".join(f"{cols[c, r]:12.6g}" for c in range(cols.shape[0])))
    text = "\n".join(lines) + "\n"
    if hasattr(path_or_buf, "write"):
        path_or_buf.write(text)
    else:
        with open(path_or_buf, "w") as f:
            f.write(text)
