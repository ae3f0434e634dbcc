"""Density-field topology: critical points + connectivity graph — copy of
viamd_tpu.ops.topo (host numpy, float64).

Rebuild of mdlib's md_topo.h (reference capability: density topology
critical points + graph rendering for QM electron densities,
VIAMD src/components/veloxchem/veloxchem.cpp:572-700).

Critical points of a voxel grid: voxels that are local extrema/saddles of
their 26-neighborhood, classified by the sign pattern of the Hessian
eigenvalues (trilinear-grid finite differences): maxima (3 negative —
nuclear attractors in QM densities), minima (3 positive — cage points),
and two saddle ranks (bond / ring points). The bond graph connects maxima
whose connecting segment stays above a density fraction of the weaker
endpoint (a discrete gradient-path proxy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CriticalPoint:
    kind: str  # 'max' | 'min' | 'bond' | 'ring'
    index: tuple  # voxel (i, j, k)
    position: np.ndarray  # world coords
    value: float


_KIND_BY_NEG = {3: "max", 2: "bond", 1: "ring", 0: "min"}


def critical_points(
    grid: np.ndarray,
    origin=np.zeros(3),
    voxel=np.ones(3),
    min_value: float = 1e-4,
) -> list[CriticalPoint]:
    """Find + classify critical points of a (nx,ny,nz) scalar grid."""
    g = np.asarray(grid, np.float64)
    nx, ny, nz = g.shape
    if min(nx, ny, nz) < 3:
        return []
    core = g[1:-1, 1:-1, 1:-1]

    # 26-neighborhood extremum test with a lexicographic tie-break:
    # plateaus (exactly-equal neighbors — common on symmetric grids with
    # even dims) emit exactly ONE representative voxel: strict compare
    # against lexicographically-preceding neighbors, non-strict against
    # following ones.
    is_max = np.abs(core) > min_value
    is_min = np.abs(core) > min_value
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                v = g[
                    1 + dx : nx - 1 + dx,
                    1 + dy : ny - 1 + dy,
                    1 + dz : nz - 1 + dz,
                ]
                precedes = (dx, dy, dz) < (0, 0, 0)
                if precedes:
                    is_max &= core > v
                    is_min &= core < v
                else:
                    is_max &= core >= v
                    is_min &= core <= v

    out: list[CriticalPoint] = []

    def hessian_at(i, j, k):
        H = np.empty((3, 3))
        idx = np.array([i, j, k])

        def val(off):
            p = idx + off
            return g[p[0], p[1], p[2]]

        for a in range(3):
            ea = np.eye(3, dtype=int)[a]
            H[a, a] = val(ea) - 2 * val([0, 0, 0] * 1) + val(-ea)
            for b in range(a + 1, 3):
                eb = np.eye(3, dtype=int)[b]
                H[a, b] = H[b, a] = (
                    val(ea + eb) - val(ea - eb) - val(-ea + eb) + val(-ea - eb)
                ) / 4.0
        return H

    origin = np.asarray(origin, np.float64)
    voxel = np.asarray(voxel, np.float64)

    def emit(mask, default_kind):
        for i, j, k in zip(*np.nonzero(mask)):
            gi, gj, gk = i + 1, j + 1, k + 1
            H = hessian_at(gi, gj, gk)
            evals = np.linalg.eigvalsh(H)
            neg = int((evals < 0).sum())
            kind = _KIND_BY_NEG.get(neg, default_kind)
            pos = origin + (np.array([gi, gj, gk]) + 0.5) * voxel
            out.append(
                CriticalPoint(kind, (gi, gj, gk), pos.astype(np.float32),
                              float(g[gi, gj, gk]))
            )

    emit(is_max, "max")
    emit(is_min, "min")
    return out


def bond_graph(
    points: list[CriticalPoint],
    grid: np.ndarray,
    origin=np.zeros(3),
    voxel=np.ones(3),
    threshold_frac: float = 0.5,
    max_dist_voxels: float = 16.0,
) -> list[tuple[int, int]]:
    """Edges between density maxima whose straight-line density profile
    stays above `threshold_frac` of the weaker endpoint (the topology graph
    rendering of veloxchem.cpp:624-700)."""
    maxima = [(i, p) for i, p in enumerate(points) if p.kind == "max"]
    g = np.asarray(grid, np.float64)
    voxel = np.asarray(voxel, np.float64)
    edges = []
    for a in range(len(maxima)):
        ia, pa = maxima[a]
        for b in range(a + 1, len(maxima)):
            ib, pb = maxima[b]
            d_vox = np.linalg.norm(
                (np.asarray(pa.index) - np.asarray(pb.index)).astype(float)
            )
            if d_vox > max_dist_voxels:
                continue
            lo = threshold_frac * min(pa.value, pb.value)
            n = max(int(d_vox * 2), 2)
            ok = True
            for t in np.linspace(0, 1, n):
                ijk = (
                    np.asarray(pa.index) * (1 - t) + np.asarray(pb.index) * t
                )
                i, j, k = np.clip(
                    np.round(ijk).astype(int), 0, np.array(g.shape) - 1
                )
                if g[i, j, k] < lo:
                    ok = False
                    break
            if ok:
                edges.append((ia, ib))
    return edges
