"""Covalent bond inference (host-side, load-time) — numpy copy of
viamd_tpu.ops.bonds.

Capability mirror of mdlib's covalent-bond inference inside
md_util_system_postprocess (VIAMD src/viamd.cpp:690-692):
two atoms are bonded when their distance lies within
[BOND_MIN, r_cov(i) + r_cov(j) + TOLERANCE].

Runs once at load time on the host, so it is a NumPy cell-list sweep —
O(N) bins with a 27-neighbor half-stencil so each pair is visited once.
"""

from __future__ import annotations

import logging

import numpy as np

from viamd_tpu_torch.core import elements as elem
from viamd_tpu_torch.core.unitcell import UnitCell

_log = logging.getLogger(__name__)

BOND_MIN = 0.4  # Å — closer than this is an artifact, not a bond
BOND_TOLERANCE = 0.3  # Å added on top of summed covalent radii


def infer_covalent_bonds(
    coords: np.ndarray, z: np.ndarray, cell: UnitCell | None = None
) -> np.ndarray:
    """Return (nbonds, 2) int32 bond pairs (i < j).

    PBC note: bonds across the periodic boundary are found by wrapping bin
    neighbors; triclinic cells bin in FRACTIONAL space (per-axis bin count
    from the lattice-plane spacing, min-image = fractional round — the same
    scheme as the device-side ops.neighbors triclinic grid).
    """
    n = coords.shape[0]
    if n < 2:
        return np.zeros((0, 2), np.int32)
    coords = np.asarray(coords, np.float32)
    z = np.asarray(z)
    rcov = elem.COVALENT_RADII[z].astype(np.float32)
    max_cut = float(2.0 * rcov.max() + BOND_TOLERANCE)
    max_cut = max(max_cut, 1.0)

    periodic = cell is not None and cell.is_periodic
    tri = periodic and not cell.is_orthorhombic
    basis32 = inv64 = None
    if tri:
        b64 = np.asarray(cell.basis, np.float64)
        inv64 = np.linalg.inv(b64)
        basis32 = b64.astype(np.float32)
        # fractional bins; per-axis perpendicular width = spacing/nbins
        spacing = 1.0 / np.linalg.norm(inv64, axis=0)
        span = np.ones(3)
        pos = np.mod(coords.astype(np.float64) @ inv64, 1.0)
        pos[pos >= 1.0] = 0.0
        nbins = np.maximum(
            1, np.floor(spacing / max_cut).astype(np.int64)
        )
    elif periodic:
        ext = cell.extent().astype(np.float64)
        span = ext.copy()
        pos = np.mod(coords.astype(np.float64), ext)
    else:
        lo = coords.min(axis=0).astype(np.float64) - 1e-3
        span = coords.max(axis=0) - lo + 2e-3
        pos = coords.astype(np.float64) - lo

    if not tri:
        nbins = np.maximum(1, np.floor(span / max_cut).astype(np.int64))
    if periodic and (nbins < 3).any():
        # too few bins per axis for a correct wrap half-stencil: small
        # systems brute-force with full PBC; large ones fall back to the
        # APERIODIC cell list (all non-wrap bonds found; wrap-around bonds
        # missed with a warning) — returning zero bonds here would be a
        # far worse failure than missing the boundary crossers
        if n <= 4096:
            return _brute_force(coords, rcov, cell)
        _log.warning(
            "bond inference: periodic cell too small for the wrap stencil "
            f"(bins {tuple(int(v) for v in nbins)}); bonds across the "
            "periodic boundary will be missed"
        )
        return infer_covalent_bonds(coords, z, cell=None)
    binw = span / nbins
    bidx = np.minimum((pos / binw).astype(np.int64), nbins - 1)
    flat = (bidx[:, 0] * nbins[1] + bidx[:, 1]) * nbins[2] + bidx[:, 2]
    order = np.argsort(flat, kind="stable")
    flat_sorted = flat[order]
    # bin start offsets
    nb_total = int(nbins.prod())
    counts = np.bincount(flat_sorted, minlength=nb_total)
    starts = np.concatenate([[0], np.cumsum(counts)])

    # Full 27-neighbor stencil; each unordered bin pair is processed exactly
    # once via the `nb_flat > b` guard below (the neighborhood is symmetric, so
    # the smaller-flat bin of any neighboring pair sees the larger one). The
    # self bin (offset 0,0,0) is handled triangularly.
    stencil = [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
    ]

    out_i, out_j = [], []
    ext32 = (
        cell.extent().astype(np.float32)
        if periodic and not tri
        else np.ones(3, np.float32)
    )
    pos32 = pos.astype(np.float32)

    nonempty = np.nonzero(counts)[0]
    nb = nbins
    for b in nonempty:
        bx, r = divmod(b, nb[1] * nb[2])
        by, bz = divmod(r, nb[2])
        ai = order[starts[b] : starts[b + 1]]
        for dx, dy, dz in stencil:
            cx, cy, cz = bx + dx, by + dy, bz + dz
            if periodic:
                cx %= nb[0]
                cy %= nb[1]
                cz %= nb[2]
            elif not (0 <= cx < nb[0] and 0 <= cy < nb[1] and 0 <= cz < nb[2]):
                continue
            nb_flat = (cx * nb[1] + cy) * nb[2] + cz
            if nb_flat == b:
                if (dx, dy, dz) != (0, 0, 0):
                    continue
                ii, jj = np.triu_indices(ai.size, k=1)
                pi, pj = ai[ii], ai[jj]
            elif nb_flat > b:
                aj = order[starts[nb_flat] : starts[nb_flat + 1]]
                if not aj.size:
                    continue
                pi = np.repeat(ai, aj.size)
                pj = np.tile(aj, ai.size)
            else:
                continue  # visited from the other bin
            if not pi.size:
                continue
            d = pos32[pi] - pos32[pj]
            if periodic:
                d -= ext32 * np.round(d / ext32)
            if tri:
                d = d @ basis32  # fractional min-image → cartesian
            dist = np.sqrt((d * d).sum(axis=1))
            cut = rcov[pi] + rcov[pj] + BOND_TOLERANCE
            ok = (dist > BOND_MIN) & (dist < cut)
            if ok.any():
                out_i.append(pi[ok])
                out_j.append(pj[ok])

    if not out_i:
        return np.zeros((0, 2), np.int32)
    bi = np.concatenate(out_i)
    bj = np.concatenate(out_j)
    lo_, hi_ = np.minimum(bi, bj), np.maximum(bi, bj)
    pairs = np.stack([lo_, hi_], axis=1).astype(np.int32)
    pairs = np.unique(pairs, axis=0)
    return pairs


def _brute_force(coords, rcov, cell):
    n = coords.shape[0]
    if n > 4096:  # safety: brute force only for small systems
        return np.zeros((0, 2), np.int32)
    d = coords[:, None, :] - coords[None, :, :]
    if cell is not None and cell.is_periodic:
        if cell.is_orthorhombic:
            ext = cell.extent()
            d -= ext * np.round(d / ext)
        else:
            b = np.asarray(cell.basis, np.float64)
            f = d @ np.linalg.inv(b)
            d = (f - np.round(f)) @ b
    dist = np.sqrt((d * d).sum(axis=-1))
    cut = rcov[:, None] + rcov[None, :] + BOND_TOLERANCE
    ok = (dist > BOND_MIN) & (dist < cut)
    i, j = np.nonzero(np.triu(ok, k=1))
    return np.stack([i, j], axis=1).astype(np.int32)
