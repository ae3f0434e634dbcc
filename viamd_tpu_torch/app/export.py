"""Exports: property tables (CSV/XVG with resampling), Gaussian cube
volumes, structure subsets, images — port of viamd_tpu/app/export.py.

Host code over the port's EvalResult and System: the cube, MetaImage and
structure writers are the JAX package's, byte for byte; the distribution
resampling runs ops/histogram.py::resample_histogram on the CPU; the
structure filter is evaluated on `device`. PNGs are written by
`encode_png` with the standard library; PIL is imported only to write
JPG/BMP/TGA and to read images.

Rebuild of the reference's export surface: export_xvg/export_csv
(VIAMD src/main.cpp:5628,5677), export_cube (:5706-5820), the
property-export window's resampling (sample_range:5822), the structure
export window (query-filtered subsets → xyz/pdb over all/current/range
frames, :6066-6093), and screenshots (create_screenshot:6399).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

BOHR_PER_ANGSTROM = 1.8897259886


# -- property tables ---------------------------------------------------------


def export_temporal_csv(result, path_or_buf, names: Optional[list] = None):
    from viamd_tpu_torch.io.csv import write_csv

    names = names or [
        p.name for p in result.properties if p.kind == "temporal"
    ]
    cols = [np.asarray(result.times)]
    header = ["time"]
    for nm in names:
        v = result.temporal[nm]
        for d in range(v.shape[1]):
            cols.append(v[:, d])
            header.append(nm if v.shape[1] == 1 else f"{nm}[{d + 1}]")
    write_csv(path_or_buf, np.stack(cols), header)


def export_temporal_xvg(result, path_or_buf, names: Optional[list] = None):
    from viamd_tpu_torch.io.xvg import write_xvg

    names = names or [
        p.name for p in result.properties if p.kind == "temporal"
    ]
    cols = [np.asarray(result.times)]
    legends = []
    for nm in names:
        v = result.temporal[nm]
        for d in range(v.shape[1]):
            cols.append(v[:, d])
            legends.append(nm if v.shape[1] == 1 else f"{nm}[{d + 1}]")
    write_xvg(
        path_or_buf, np.stack(cols),
        title="viamd_tpu temporal properties",
        xaxis="time", yaxis="value", legends=legends,
    )


def export_distribution_csv(
    result, path_or_buf, name: str, bins: Optional[int] = None, volume=0.0
):
    """Distribution export with optional conservative resampling
    (sample_range, main.cpp:5822)."""
    from viamd_tpu_torch.io.csv import write_csv

    p = result.property(name)
    hist = (
        result.normalized_distribution(name, volume)
        if volume
        else result.distributions[name]
    )
    if bins and bins != hist.shape[0]:
        import torch

        from viamd_tpu_torch.ops.histogram import resample_histogram

        hist = resample_histogram(torch.tensor(hist), bins).numpy()
    n = hist.shape[0]
    x = p.spec.r_min + (np.arange(n) + 0.5) / n * (p.spec.r_max - p.spec.r_min)
    write_csv(path_or_buf, np.stack([x, hist]), ["r", name])


# -- cube volumes ------------------------------------------------------------


def export_cube(
    path_or_buf,
    grid: np.ndarray,  # (nx, ny, nz)
    origin,  # (3,) Å
    voxel,  # (3,) Å per axis (axis-aligned)
    atoms_z: Optional[np.ndarray] = None,
    atoms_xyz: Optional[np.ndarray] = None,
    comment: str = "viamd_tpu volume export",
    axes: Optional[np.ndarray] = None,  # (3,3) voxel VECTORS (Å, rows)
):
    """Gaussian .cube (export_cube, main.cpp:5706): Bohr units, z-fastest.

    `axes` row i is the full voxel vector of grid axis i (Å) — the cube
    format supports oriented grids (the veloxchem OBB export); when given
    it replaces the axis-aligned `voxel` diagonal."""
    grid = np.asarray(grid)
    nx, ny, nz = grid.shape
    o = np.asarray(origin, np.float64) * BOHR_PER_ANGSTROM
    if axes is not None:
        ax = np.asarray(axes, np.float64) * BOHR_PER_ANGSTROM
    else:
        v = np.asarray(voxel, np.float64) * BOHR_PER_ANGSTROM
        ax = np.diag(v)
    na = len(atoms_z) if atoms_z is not None else 0
    lines = [comment, "generated by viamd_tpu"]
    lines.append(f"{na:5d}{o[0]:12.6f}{o[1]:12.6f}{o[2]:12.6f}")
    for n, a in zip((nx, ny, nz), ax):
        lines.append(f"{n:5d}{a[0]:12.6f}{a[1]:12.6f}{a[2]:12.6f}")
    if na:
        xyz = np.asarray(atoms_xyz, np.float64) * BOHR_PER_ANGSTROM
        for z, p in zip(atoms_z, xyz):
            lines.append(
                f"{int(z):5d}{float(z):12.6f}{p[0]:12.6f}{p[1]:12.6f}{p[2]:12.6f}"
            )
    flat = grid.reshape(nx * ny, nz)
    for row in flat:
        for beg in range(0, nz, 6):
            lines.append(
                "".join(f"{val:13.5E}" for val in row[beg : beg + 6])
            )
    text = "\n".join(lines) + "\n"
    if hasattr(path_or_buf, "write"):
        path_or_buf.write(text)
    else:
        with open(path_or_buf, "w") as f:
            f.write(text)


def export_mhd(
    path: str,
    grid: np.ndarray,  # (nx, ny, nz)
    origin,  # (3,) Å (world position of the grid-frame origin corner)
    voxel,  # (3,) Å spacing along the grid axes
    orientation: Optional[np.ndarray] = None,  # (3,3) grid→world, columns
    atoms_z: Optional[np.ndarray] = None,
    atoms_xyz: Optional[np.ndarray] = None,  # (na, 3) Å
):
    """MetaImage volume export — the reference's "raw + mhd + xyz" file
    format (veloxchem.cpp:5586-5591 EXPORT_FILE_FORMAT_RAW_MHD_XYZ):
    `<path>.raw` float32 payload, `<path>.mhd` text header (DimSize /
    ElementSpacing / Offset / TransformMatrix), and `<path>.xyz` with the
    atoms when given. Returns the three file paths written."""
    import os

    base = path
    for ext in (".mhd", ".raw", ".xyz"):
        if base.endswith(ext):
            base = base[: -len(ext)]
            break
    g = np.asarray(grid, np.float32)
    raw_path = base + ".raw"
    mhd_path = base + ".mhd"
    # MetaImage is x-fastest; our grids are (nx, ny, nz) C-order
    # (z-fastest) — transpose so DimSize matches the payload order
    g.T.tofile(raw_path)
    R = (np.asarray(orientation, np.float64)
         if orientation is not None else np.eye(3))
    o = np.asarray(origin, np.float64)
    v = np.asarray(voxel, np.float64)
    hdr = [
        "ObjectType = Image",
        "NDims = 3",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        "CompressedData = False",
        "TransformMatrix = " + " ".join(
            f"{R[i, j]:.9g}" for j in range(3) for i in range(3)
        ),
        f"Offset = {o[0]:.9g} {o[1]:.9g} {o[2]:.9g}",
        "CenterOfRotation = 0 0 0",
        "AnatomicalOrientation = ???",
        f"ElementSpacing = {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}",
        f"DimSize = {g.shape[0]} {g.shape[1]} {g.shape[2]}",
        "ElementType = MET_FLOAT",
        f"ElementDataFile = {os.path.basename(raw_path)}",
    ]
    with open(mhd_path, "w") as f:
        f.write("\n".join(hdr) + "\n")
    out = [mhd_path, raw_path]
    if atoms_z is not None and atoms_xyz is not None:
        from viamd_tpu_torch.core.elements import SYMBOLS

        xyz_path = base + ".xyz"
        with open(xyz_path, "w") as f:
            f.write(f"{len(atoms_z)}\nviamd_tpu volume export\n")
            for z, p in zip(atoms_z, np.asarray(atoms_xyz, np.float64)):
                sym = SYMBOLS[int(z)] if 0 <= int(z) < len(SYMBOLS) else "X"
                f.write(
                    f"{sym} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n"
                )
        out.append(xyz_path)
    return out


def read_cube(path: str):
    """Parse a .cube back → (grid, origin Å, voxel Å, atoms_z, atoms_xyz Å)."""
    with open(path) as f:
        lines = f.read().splitlines()
    na, *o = lines[2].split()
    na = int(na)
    origin = np.array([float(t) for t in o]) / BOHR_PER_ANGSTROM
    dims = []
    voxel = []
    for k in range(3):
        parts = lines[3 + k].split()
        dims.append(int(parts[0]))
        voxel.append(float(parts[1 + k]) / BOHR_PER_ANGSTROM)
    zs, xyz = [], []
    for k in range(na):
        parts = lines[6 + k].split()
        zs.append(int(parts[0]))
        xyz.append([float(t) / BOHR_PER_ANGSTROM for t in parts[2:5]])
    vals = []
    for line in lines[6 + na :]:
        vals.extend(float(t) for t in line.split())
    grid = np.asarray(vals, np.float32).reshape(*dims)
    return grid, origin, np.asarray(voxel), np.asarray(zs), np.asarray(xyz)


# -- structure subsets (draw_structure_export_window, main.cpp:6066) ---------


def export_structure(
    session,
    path: str,
    filter_expr: str = "all",
    frames: str | list = "current",
    device="cuda",
):
    """Query-filtered subset → .pdb or .xyz; frames: 'current' | 'all' |
    list of indices. The filter is evaluated on `device`. Reads
    `session.system`, `.stored_selections`, `.current_coords()`,
    `.trajectory` and `.num_frames`."""
    from viamd_tpu_torch.script import evaluate_filter

    sys = session.system
    mask, _ = evaluate_filter(filter_expr, sys, session.stored_selections, device=device)
    idx = mask.indices()
    if frames == "current":
        coords = session.current_coords()[None]
    else:
        traj = session.trajectory
        fidx = (
            list(range(session.num_frames)) if frames == "all" else list(frames)
        )
        coords, _cells = traj.load_frames(fidx)
    if path.endswith(".xyz"):
        from viamd_tpu_torch.core import elements as E

        lines = []
        for f in range(coords.shape[0]):
            lines.append(str(idx.size))
            lines.append(f"frame {f}")
            for i in idx:
                sym = E.SYMBOLS[sys.element[i]] or "X"
                p = coords[f, i]
                lines.append(f"{sym} {p[0]:.4f} {p[1]:.4f} {p[2]:.4f}")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    else:
        from viamd_tpu_torch.io.pdb import write_pdb

        with open(path, "w") as fh:
            fh.write(write_pdb(sys, coords_frames=coords, mask=mask))


# -- images (create_screenshot, main.cpp:6399) -------------------------------


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 → an 8-bit RGB/RGBA PNG, with the standard library
    only, byte for byte what PIL's default PNG writer gives (and so the JAX
    package's `save_image`): each row takes the first of the None, Up, Sub
    and Paeth filters with the least sum of |signed byte|; one deflate
    stream (level 6, memLevel 9, Z_FILTERED) split into IDAT chunks of
    max(65536, 4W) bytes."""
    import struct
    import zlib

    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    x = arr.reshape(h, w * c).astype(np.int16)
    up = np.concatenate([np.zeros((1, w * c), np.int16), x[:-1]])
    left = np.concatenate([np.zeros((h, c), np.int16), x[:, :-c]], axis=1)
    up_left = np.concatenate([np.zeros((h, c), np.int16), up[:, :-c]], axis=1)
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    rows = x.astype(np.uint8)
    kind = np.zeros(h, np.uint8)
    cost = np.minimum(rows, 256 - rows.astype(np.int32)).sum(axis=1)
    for code, pred in ((2, up), (1, left), (4, paeth)):
        f = (x - pred).astype(np.uint8)
        fc = np.minimum(f, 256 - f.astype(np.int32)).sum(axis=1)
        take = fc < cost
        rows[take], kind[take], cost = f[take], code, np.where(take, fc, cost)
    deflate = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    z = deflate.compress(np.concatenate([kind[:, None], rows], axis=1).tobytes()) + deflate.flush()

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    step = max(65536, 4 * w)
    idat = b"".join(chunk(b"IDAT", z[i:i + step]) for i in range(0, len(z), step))
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + idat + chunk(b"IEND", b"")


def save_image(path: str, rgba: np.ndarray):
    """(H,W,4|3) float [0,1] → PNG (by `encode_png`, no imaging library) or
    JPG/BMP/TGA via PIL; the JAX package's bytes either way."""
    arr = np.clip(np.asarray(rgba) * 255 + 0.5, 0, 255).astype(np.uint8)
    if path.lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(encode_png(arr))
        return
    from PIL import Image

    img = Image.fromarray(arr, "RGBA" if arr.shape[-1] == 4 else "RGB")
    if path.lower().endswith((".jpg", ".jpeg", ".bmp")):
        img = img.convert("RGB")
    img.save(path)


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGBA")
    return np.asarray(img).astype(np.float32) / 255.0
