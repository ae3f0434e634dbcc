"""Selection utilities: grow by bonds / radius, selection → script text.

A numpy copy of viamd_tpu/core/selection_utils.py (host code, no device
work) over the port's Bitfield and System.

Capability mirrors:
- mask grow by covalent bonds / by radius (md_util grow capability used by
  the reference's selection UI, VIAMD src/viamd.h selection-grow
  surface);
- the context-popup script generator that turns the current selection into
  script identifiers with compact atom-range syntax
  (generate_script_selection_suggestions / write_script_atom_ranges,
  VIAMD src/main.cpp:2484-2530).
"""

from __future__ import annotations

import numpy as np

from viamd_tpu_torch.core.bitfield import Bitfield
from viamd_tpu_torch.core.system import System


def grow_by_bonds(mask: Bitfield, bonds: np.ndarray, steps: int = 1) -> Bitfield:
    """Expand a selection along covalent bonds `steps` times."""
    sel = mask.to_bools()
    if not len(bonds):
        return Bitfield.from_bools(sel)
    b0, b1 = bonds[:, 0], bonds[:, 1]
    for _ in range(steps):
        new = sel.copy()
        hit = sel[b0] | sel[b1]
        new[b0[hit]] = True
        new[b1[hit]] = True
        if (new == sel).all():
            break
        sel = new
    return Bitfield.from_bools(sel)


def grow_by_radius(
    mask: Bitfield, coords: np.ndarray, radius: float, cell=None
) -> Bitfield:
    """Expand a selection to all atoms within `radius` Å of it (PBC-aware:
    orthorhombic cells min-image per axis, triclinic via the fractional
    round)."""
    sel = mask.to_bools()
    idx = np.nonzero(sel)[0]
    if not idx.size:
        return Bitfield.from_bools(sel)
    coords = np.asarray(coords, np.float32)
    ext = basis = inv = None
    if cell is not None and cell.is_periodic:
        if cell.is_orthorhombic:
            ext = cell.extent().astype(np.float32)
        else:
            basis = np.asarray(cell.basis, np.float32)
            inv = np.linalg.inv(basis.astype(np.float64)).astype(np.float32)
    out = sel.copy()
    # chunked distance check against the selected set
    chunk = max(1, int(4e6 // max(idx.size, 1)))
    for beg in range(0, coords.shape[0], chunk):
        end = min(beg + chunk, coords.shape[0])
        d = coords[beg:end, None, :] - coords[None, idx, :]
        if ext is not None:
            d -= ext * np.round(d / ext)
        elif basis is not None:
            f = d @ inv
            d = (f - np.round(f)) @ basis
        near = (d * d).sum(-1).min(axis=1) <= radius * radius
        out[beg:end] |= near
    return Bitfield.from_bools(out)


def atom_ranges_script(mask: Bitfield) -> str:
    """Compact `atom(...)` expression from a selection
    (write_script_atom_ranges, main.cpp:2484): 1-based inclusive ranges."""
    idx = mask.indices()
    if not idx.size:
        return "atom(0:0)"  # empty
    parts = []
    beg = prev = int(idx[0])
    for i in idx[1:]:
        i = int(i)
        if i == prev + 1:
            prev = i
            continue
        parts.append((beg, prev))
        beg = prev = i
    parts.append((beg, prev))
    args = ", ".join(
        f"{b + 1}" if b == e else f"{b + 1}:{e + 1}" for b, e in parts
    )
    return f"atom({args})"


def selection_suggestions(sys: System, mask: Bitfield) -> list[str]:
    """Script-identifier suggestions for a selection
    (generate_script_selection_suggestions, main.cpp:2530): prefer the
    semantic forms (whole residues / chains / element sets) and fall back to
    atom ranges."""
    out = []
    sel = mask.to_bools()
    # whole residues?
    offs = sys.res_offsets
    res_full = np.array(
        [sel[offs[r] : offs[r + 1]].all() for r in range(sys.nres)]
    )
    res_any = np.array(
        [sel[offs[r] : offs[r + 1]].any() for r in range(sys.nres)]
    )
    if res_full.any() and (res_full == res_any).all():
        ridx = np.nonzero(res_full)[0]
        parts = []
        beg = prev = int(ridx[0])
        for r in ridx[1:]:
            r = int(r)
            if r == prev + 1:
                prev = r
                continue
            parts.append((beg, prev))
            beg = prev = r
        parts.append((beg, prev))
        args = ", ".join(
            f"{b + 1}" if b == e else f"{b + 1}:{e + 1}" for b, e in parts
        )
        out.append(f"residue({args})")
        names = {sys.res_names[sys.res_name_id[r]] for r in ridx}
        if len(names) == 1 and res_full.sum() == (
            sys.res_name_id == sys.res_names.lookup(next(iter(names)))
        ).sum():
            out.append(f"resname(\"{next(iter(names))}\")")
    # pure element set?
    zsel = set(sys.element[sel].tolist())
    if zsel and set(sys.element[~sel].tolist()).isdisjoint(zsel):
        from viamd_tpu_torch.core import elements as E

        syms = ", ".join(f"'{E.SYMBOLS[z]}'" for z in sorted(zsel))
        out.append(f"element({syms})")
    out.append(atom_ranges_script(mask))
    return out
