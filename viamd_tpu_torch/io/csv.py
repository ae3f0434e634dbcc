"""CSV table read/write — copy of viamd_tpu.io.csv (md_csv.h capability: script import + export_csv,
VIAMD src/main.cpp:5677)."""

from __future__ import annotations

import numpy as np


def read_csv(path: str) -> tuple[np.ndarray, list[str]]:
    """Read CSV → ((ncols, nrows) float array, header names)."""
    header: list[str] = []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = [p.strip() for p in line.split(",")]
            try:
                rows.append([float(p) for p in parts])
            except ValueError:
                if not header and not rows:
                    header = parts
                continue
    if not rows:
        return np.zeros((0, 0), np.float32), header
    ncol = min(len(r) for r in rows)
    return np.asarray([r[:ncol] for r in rows], np.float32).T, header


def write_csv(path_or_buf, columns: np.ndarray, header: list[str] | None = None):
    cols = np.asarray(columns)
    lines = []
    if header:
        lines.append(",".join(header))
    for r in range(cols.shape[1]):
        lines.append(",".join(f"{cols[c, r]:.6g}" for c in range(cols.shape[0])))
    text = "\n".join(lines) + "\n"
    if hasattr(path_or_buf, "write"):
        path_or_buf.write(text)
    else:
        with open(path_or_buf, "w") as f:
            f.write(text)
