"""Molecular system data model — numpy copy of viamd_tpu.core.system
(`System`, `build_system`, the structural flags, and `postprocess`: element,
radius and mass inference, residue flags, bond inference through
ops.bonds, backbone detection) and `InstanceTable`.

Mirror of mdlib's md_system_t (reference capability surface:
SoA atom arrays x/y/z/flags + atom types, bonds, residues ("components"),
chains ("instances"), protein backbone, unitcell — used throughout
VIAMD src/viamd.{h,cpp}, e.g. viamd.h:1550-1570, main.cpp:629).

Layout is SoA NumPy on host; device code receives coordinates and index
lists as tensors. String-ish metadata (names) is interned into integer label
tables so per-atom data stays numeric.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from viamd_tpu_torch.core import elements as elem
from viamd_tpu_torch.core.unitcell import UnitCell

# Atom flags (bit positions) — mirrors the flag vocabulary viamd renders from
# (selection/highlight/visibility bits are runtime, these are structural).
FLAG_BACKBONE = 1 << 0
FLAG_SIDECHAIN = 1 << 1
FLAG_WATER = 1 << 2
FLAG_ION = 1 << 3
FLAG_AMINO = 1 << 4
FLAG_NUCLEIC = 1 << 5
FLAG_HETERO = 1 << 6

_WATER_RES = {"HOH", "H2O", "SOL", "WAT", "TIP", "TIP3", "TIP4", "SPC", "ICE"}
_ION_RES = {
    "NA", "NA+", "K", "K+", "CL", "CL-", "MG", "MG2", "CA2", "ZN", "ZN2",
    "FE", "FE2", "FE3", "CU", "MN", "LI", "RB", "CS", "F", "BR", "I", "SOD",
    "POT", "CLA", "CAL",
}
_AMINO_RES = elem._AMINO_ACIDS
_NUCLEIC_RES = elem._NUCLEIC


class LabelTable:
    """Interned string table: labels ↔ int32 ids (device-friendly categories)."""

    __slots__ = ("labels", "_index")

    def __init__(self):
        self.labels: list[str] = []
        self._index: dict[str, int] = {}

    def intern(self, s: str) -> int:
        i = self._index.get(s)
        if i is None:
            i = len(self.labels)
            self.labels.append(s)
            self._index[s] = i
        return i

    def lookup(self, s: str) -> int:
        """Return id or -1 if absent."""
        return self._index.get(s, -1)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i: int) -> str:
        return self.labels[i]


@dataclasses.dataclass
class Backbone:
    """Protein backbone bookkeeping (per backbone residue).

    Mirrors mdlib's protein_backbone.{segment,range} capability
    (VIAMD src/viamd.cpp:510-511): atom indices of N/CA/C/O (+CB if
    present) per backbone residue, grouped into contiguous chain ranges.
    """

    res_idx: np.ndarray  # (nbb,) int32 residue index of each backbone segment
    atom_n: np.ndarray  # (nbb,) int32
    atom_ca: np.ndarray  # (nbb,) int32
    atom_c: np.ndarray  # (nbb,) int32
    atom_o: np.ndarray  # (nbb,) int32
    ranges: np.ndarray  # (nranges, 2) int32 [beg, end) into the nbb axis

    @property
    def count(self) -> int:
        return int(self.res_idx.shape[0])



@dataclasses.dataclass
class InstanceTable:
    """Instances: atom ranges + rigid transforms, DISTINCT from chains.

    Mirrors md_system_t.instance (VIAMD src/viamd.h:1560-1570 —
    md_system_instance_count/atom_range, per-instance transforms fed to
    md_gfx_structure_set_instance_{atom_ranges,transforms} at
    viamd.cpp:607-613). Instances materialize mmCIF assemblies/symmetry
    copies WITHOUT replicating atoms: each row references a base atom
    range and carries the 4×4 operator that places the copy. Multiple
    rows may share a range (one asym group under several operators);
    `find_by_atom` returns the first (identity-operator) owner, matching
    md_system_instance_find_by_atom_idx's base-atom semantics.
    """

    atom_ranges: np.ndarray  # (K, 2) int32 [beg, end) into base atoms
    transforms: np.ndarray  # (K, 4, 4) float32 row-vector-style A·x + t
    label_id: np.ndarray  # (K,) int32 → labels ("asymId·operId")
    labels: LabelTable

    @property
    def count(self) -> int:
        return int(self.atom_ranges.shape[0])

    def is_identity(self, k: int, tol: float = 1e-6) -> bool:
        return bool(
            np.allclose(self.transforms[k], np.eye(4, dtype=np.float32),
                        atol=tol)
        )

    def find_by_atom(self, atom_idx: int) -> int:
        """First instance whose range contains the atom (md_system_
        instance_find_by_atom_idx), -1 if none."""
        for k in range(self.count):
            b, e = self.atom_ranges[k]
            if b <= atom_idx < e:
                return k
        return -1

    def expansion(self, coords: np.ndarray):
        """Expanded per-instance geometry: (xyz (M,3) f32, src (M,) int32).

        `src` maps every expanded atom back to its base atom index — the
        picking/color/radius gather for instanced draws (the md_gfx
        per-instance draw, viamd.cpp:611-613, as an explicit expansion
        since the raster consumes flat arrays)."""
        xs, srcs = [], []
        for k in range(self.count):
            b, e = (int(v) for v in self.atom_ranges[k])
            T = self.transforms[k]
            p = coords[b:e]
            xs.append(p @ T[:3, :3].T + T[:3, 3])
            srcs.append(np.arange(b, e, dtype=np.int32))
        return (
            np.concatenate(xs, axis=0).astype(np.float32),
            np.concatenate(srcs, axis=0),
        )

    @property
    def nontrivial(self) -> bool:
        """True when expansion differs from the base system (any
        non-identity operator)."""
        return any(not self.is_identity(k) for k in range(self.count))


@dataclasses.dataclass
class System:
    """A molecular system: atoms + topology + unit cell (host-resident)."""

    # atoms (SoA)
    x: np.ndarray  # (n,) float32, Å
    y: np.ndarray
    z: np.ndarray
    element: np.ndarray  # (n,) int32 atomic number (0 = unknown)
    flags: np.ndarray  # (n,) uint32
    radius: np.ndarray  # (n,) float32 vdw radius
    mass: np.ndarray  # (n,) float32
    atom_name_id: np.ndarray  # (n,) int32 → atom_names
    atom_names: LabelTable
    # residues
    atom_res_idx: np.ndarray  # (n,) int32
    res_name_id: np.ndarray  # (nres,) int32 → res_names
    res_id: np.ndarray  # (nres,) int32 author residue number
    res_offsets: np.ndarray  # (nres+1,) int32 atom ranges
    res_names: LabelTable
    # chains
    atom_chain_idx: np.ndarray  # (n,) int32 (-1 = no chain)
    chain_id: np.ndarray  # (nchains,) int32 → chain_labels
    chain_offsets: np.ndarray  # (nchains+1,) int32 atom ranges
    chain_labels: LabelTable
    # bonds
    bonds: np.ndarray  # (nbonds, 2) int32
    # backbone (None until postprocess)
    backbone: Optional[Backbone]
    # cell
    cell: UnitCell
    # optional per-atom extras
    occupancy: Optional[np.ndarray] = None
    bfactor: Optional[np.ndarray] = None
    velocity: Optional[np.ndarray] = None  # (n,3) f32 if the format provides it
    # instances (assemblies / symmetry copies) — None for most formats
    instances: Optional[InstanceTable] = None

    # -- shape queries -------------------------------------------------------
    @property
    def natoms(self) -> int:
        return int(self.x.shape[0])

    @property
    def nres(self) -> int:
        return int(self.res_id.shape[0])

    @property
    def nchains(self) -> int:
        return int(self.chain_id.shape[0])

    @property
    def nbonds(self) -> int:
        return int(self.bonds.shape[0])

    @property
    def ninstances(self) -> int:
        return self.instances.count if self.instances is not None else 0

    def coords(self) -> np.ndarray:
        """(n,3) float32 coordinates."""
        return np.stack([self.x, self.y, self.z], axis=1)

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        lo = np.array(
            [self.x.min(), self.y.min(), self.z.min()], np.float32
        ) if self.natoms else np.zeros(3, np.float32)
        hi = np.array(
            [self.x.max(), self.y.max(), self.z.max()], np.float32
        ) if self.natoms else np.zeros(3, np.float32)
        return lo, hi

    # per-atom views of residue-level data
    def atom_res_name_id(self) -> np.ndarray:
        return self.res_name_id[self.atom_res_idx]

    def atom_res_id(self) -> np.ndarray:
        return self.res_id[self.atom_res_idx]

    def __repr__(self):
        return (
            f"System(atoms={self.natoms}, residues={self.nres}, "
            f"chains={self.nchains}, bonds={self.nbonds}, "
            f"cell={'periodic' if self.cell.is_periodic else 'none'})"
        )


def build_system(
    *,
    coords: np.ndarray,  # (n,3) float Å
    atom_names: list[str],
    res_names: list[str],  # per atom
    res_ids: list[int] | np.ndarray,  # per atom (author numbering)
    chain_ids: Optional[list[str]] = None,  # per atom
    elements_z: Optional[np.ndarray] = None,  # per atom atomic numbers (optional)
    cell: Optional[UnitCell] = None,
    occupancy: Optional[np.ndarray] = None,
    bfactor: Optional[np.ndarray] = None,
    velocity: Optional[np.ndarray] = None,
) -> System:
    """Assemble a System from per-atom parse results (no inference yet).

    Residue boundaries are derived from change-points of (res_id, res_name,
    chain); chain boundaries from change-points of chain id.
    """
    coords = np.asarray(coords, np.float32)
    n = coords.shape[0]
    res_ids = np.asarray(res_ids, np.int32)
    if chain_ids is None:
        chain_ids = [""] * n

    atab, rtab, ctab = LabelTable(), LabelTable(), LabelTable()
    atom_name_id = np.fromiter(
        (atab.intern(s) for s in atom_names), np.int32, count=n
    )
    res_name_per_atom = np.fromiter(
        (rtab.intern(s) for s in res_names), np.int32, count=n
    )
    chain_per_atom = np.fromiter(
        (ctab.intern(s) for s in chain_ids), np.int32, count=n
    )

    # residue change-points
    if n:
        change = np.zeros(n, bool)
        change[0] = True
        change[1:] = (
            (res_ids[1:] != res_ids[:-1])
            | (res_name_per_atom[1:] != res_name_per_atom[:-1])
            | (chain_per_atom[1:] != chain_per_atom[:-1])
        )
        res_start = np.nonzero(change)[0].astype(np.int32)
        atom_res_idx = np.cumsum(change).astype(np.int32) - 1
    else:
        res_start = np.zeros(0, np.int32)
        atom_res_idx = np.zeros(0, np.int32)
    nres = res_start.size
    res_offsets = np.concatenate([res_start, [n]]).astype(np.int32)
    res_name_id = res_name_per_atom[res_start] if nres else np.zeros(0, np.int32)
    res_id_arr = res_ids[res_start] if nres else np.zeros(0, np.int32)

    # chain change-points
    if n:
        cchange = np.zeros(n, bool)
        cchange[0] = True
        cchange[1:] = chain_per_atom[1:] != chain_per_atom[:-1]
        chain_start = np.nonzero(cchange)[0].astype(np.int32)
        atom_chain_idx = np.cumsum(cchange).astype(np.int32) - 1
    else:
        chain_start = np.zeros(0, np.int32)
        atom_chain_idx = np.zeros(0, np.int32)
    nch = chain_start.size
    chain_offsets = np.concatenate([chain_start, [n]]).astype(np.int32)
    chain_id_arr = chain_per_atom[chain_start] if nch else np.zeros(0, np.int32)

    if elements_z is None:
        elements_z = np.zeros(n, np.int32)
    else:
        elements_z = np.asarray(elements_z, np.int32)

    return System(
        x=np.ascontiguousarray(coords[:, 0]),
        y=np.ascontiguousarray(coords[:, 1]),
        z=np.ascontiguousarray(coords[:, 2]),
        element=elements_z,
        flags=np.zeros(n, np.uint32),
        radius=np.zeros(n, np.float32),
        mass=np.zeros(n, np.float32),
        atom_name_id=atom_name_id,
        atom_names=atab,
        atom_res_idx=atom_res_idx,
        res_name_id=res_name_id,
        res_id=res_id_arr,
        res_offsets=res_offsets,
        res_names=rtab,
        atom_chain_idx=atom_chain_idx,
        chain_id=chain_id_arr,
        chain_offsets=chain_offsets,
        chain_labels=ctab,
        bonds=np.zeros((0, 2), np.int32),
        backbone=None,
        cell=cell or UnitCell.none(),
        occupancy=occupancy,
        bfactor=bfactor,
        velocity=velocity,
    )


def postprocess(sys: System, infer_bonds: bool = True) -> System:
    """Element/radius/mass inference, structural flags, bonds, backbone.

    Capability mirror of md_util_system_postprocess
    (VIAMD src/viamd.cpp:690-692). Mutates and returns `sys`.
    """
    n = sys.natoms
    if n == 0:
        return sys
    res_name_per_atom = [
        sys.res_names[i] for i in sys.atom_res_name_id()
    ]
    # element inference where missing
    if not sys.element.any() or (sys.element == 0).any():
        z = sys.element.copy()
        for i in np.nonzero(z == 0)[0]:
            z[i] = elem.infer_element(
                sys.atom_names[sys.atom_name_id[i]], res_name_per_atom[i]
            )
        sys.element = z
    sys.radius = elem.VDW_RADII[sys.element].astype(np.float32)
    sys.mass = elem.MASSES[sys.element].astype(np.float32)

    # structural flags from residue names
    flags = np.zeros(n, np.uint32)
    rn_upper = np.array([s.upper() for s in sys.res_names.labels])
    res_flags = np.zeros(len(rn_upper), np.uint32)
    for i, s in enumerate(rn_upper):
        f = 0
        if s in _WATER_RES:
            f |= FLAG_WATER
        elif s in _ION_RES:
            f |= FLAG_ION
        elif s in _AMINO_RES:
            f |= FLAG_AMINO
        elif s in _NUCLEIC_RES:
            f |= FLAG_NUCLEIC
        else:
            f |= FLAG_HETERO
        res_flags[i] = f
    flags |= res_flags[sys.atom_res_name_id()]
    sys.flags = flags

    if infer_bonds and sys.nbonds == 0:
        from viamd_tpu_torch.ops.bonds import infer_covalent_bonds

        sys.bonds = infer_covalent_bonds(
            sys.coords(), sys.element, sys.cell
        )

    _detect_backbone(sys)
    _flag_backbone_atoms(sys)
    return sys


def _detect_backbone(sys: System):
    """Find N/CA/C/O atoms per amino residue; group consecutive ones."""
    want = {"N": 0, "CA": 1, "C": 2, "O": 3}
    nres = sys.nres
    slots = np.full((nres, 4), -1, np.int32)
    amino = np.zeros(nres, bool)
    res_flag_amino = np.array(
        [
            sys.res_names[rid].upper() in _AMINO_RES
            for rid in sys.res_name_id
        ]
    )
    for r in np.nonzero(res_flag_amino)[0]:
        beg, end = sys.res_offsets[r], sys.res_offsets[r + 1]
        for a in range(beg, end):
            nm = sys.atom_names[sys.atom_name_id[a]].upper()
            if nm in want and slots[r, want[nm]] < 0:
                slots[r, want[nm]] = a
            elif nm == "OT1" and slots[r, 3] < 0:  # terminal oxygen variants
                slots[r, 3] = a
        amino[r] = (slots[r, :3] >= 0).all()  # O may be missing at C-term

    bb_res = np.nonzero(amino)[0].astype(np.int32)
    if not bb_res.size:
        sys.backbone = None
        return
    # contiguous runs of residue indices within the same chain
    ranges = []
    run_start = 0
    res_chain = np.array(
        [sys.atom_chain_idx[sys.res_offsets[r]] for r in bb_res]
    )
    for i in range(1, bb_res.size + 1):
        if (
            i == bb_res.size
            or bb_res[i] != bb_res[i - 1] + 1
            or res_chain[i] != res_chain[i - 1]
        ):
            if i - run_start >= 2:  # a backbone needs ≥2 residues
                ranges.append((run_start, i))
            run_start = i
    if not ranges:
        sys.backbone = None
        return
    sys.backbone = Backbone(
        res_idx=bb_res,
        atom_n=slots[bb_res, 0],
        atom_ca=slots[bb_res, 1],
        atom_c=slots[bb_res, 2],
        atom_o=slots[bb_res, 3],
        ranges=np.array(ranges, np.int32),
    )


def _flag_backbone_atoms(sys: System):
    if sys.backbone is None:
        return
    bb = sys.backbone
    for arr in (bb.atom_n, bb.atom_ca, bb.atom_c, bb.atom_o):
        valid = arr[arr >= 0]
        sys.flags[valid] |= FLAG_BACKBONE
    # sidechain = amino atoms not flagged backbone
    amino = (sys.flags & FLAG_AMINO) != 0
    not_bb = (sys.flags & FLAG_BACKBONE) == 0
    sys.flags[amino & not_bb] |= FLAG_SIDECHAIN
