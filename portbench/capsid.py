"""The benchmark's protein deployment, made from a seed: a T = 1 icosahedral
virus capsid of 60 coat-protein chains in a periodic box of three-site
water and ions, and its frames (NAMD's STMV benchmark system at its sizes;
`portbench/configs/stmv.json` names what is generated in the place of the
source's files).

A frozen recipe that imports nothing of the program, as `inputs.py` is:
the harness turns these arrays into the program's objects and the plain
reference (`portbench/reference/cartoon.py`) reads them as they are. The
same seed gives the same arrays; every seed gives the same sizes.

- One template chain of poly-alanine (N, H, CA, HA, CB, HB1-3, C, O a
  residue) is built from ideal internal coordinates by NeRF: Engh-Huber
  bond lengths and angles, omega 180 degrees, and the per-residue
  (phi, psi) of `pattern()`: an extended N-terminal arm, eight 8-residue
  beta strands in two meanders, one 12-residue alpha helix between them
  and coil around them. The coil's angles were chosen once so that the
  chain is compact (CA radius of gyration 17.6 A) and stay fixed here.
- The 60 rotations of the icosahedral group place 60 copies about the box
  centre, the template's centroid at `shell_radius_A` from it.
- Waters sit on a jittered cubic lattice, as `inputs.water_box`'s do; a
  site whose oxygen lies within `CLEARANCE_A` of a protein atom is not
  used, and the ions take lattice sites drawn from the seed.
- Frames are the base configuration plus N(0, jitter) per atom and frame
  (`inputs.frames`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.spatial

from portbench.inputs import WATER_SITES, frames, host_seed

# one residue's atoms in file order: name, atomic number
RESIDUE = (("N", 7), ("H", 1), ("CA", 6), ("HA", 1), ("CB", 6), ("HB1", 1), ("HB2", 1),
           ("HB3", 1), ("C", 6), ("O", 8))
ATOM = {name: k for k, (name, _) in enumerate(RESIDUE)}
# bonds inside a residue, by position in RESIDUE; C(i)-N(i+1) joins residues
RESIDUE_BONDS = ((0, 1), (0, 2), (2, 3), (2, 4), (4, 5), (4, 6), (4, 7), (2, 8), (8, 9))
ION_Z = {"NA": 11, "CL": 17}

# Engh & Huber (1991) bond lengths (A) and angles (degrees); the hydrogens'
# and CB's placements are the usual ideal ones
N_CA, CA_C, C_N, C_O = 1.458, 1.525, 1.329, 1.231
N_CA_C, CA_C_N, C_N_CA, CA_C_O = 111.2, 116.2, 121.7, 120.8
N_H, C_N_H = 1.01, 119.5
CA_HA, N_CA_HA, HA_TORSION = 1.09, 109.5, -118.2
CA_CB, N_CA_CB, CB_TORSION = 1.530, 110.5, 122.6
CB_HB, CA_CB_HB = 1.09, 109.5
OMEGA = 180.0

# the secondary-structure elements of the template chain, N to C
ARM, STRAND, HELIX = (-75.0, 145.0), (-120.0, 130.0), (-57.0, -47.0)
ELEMENTS = (("arm", 15), ("coil", 4), ("strand", 8), ("coil", 4), ("strand", 8), ("coil", 6),
            ("strand", 8), ("coil", 4), ("strand", 8), ("coil", 10), ("helix", 12),
            ("coil", 10), ("strand", 8), ("coil", 4), ("strand", 8), ("coil", 6),
            ("strand", 8), ("coil", 4), ("strand", 8), ("coil", 16))
# (phi, psi) of the coil residues in chain order, degrees
COIL = (
    (103.4, 160.6), (57.4, -54.4), (-172.8, 149.8), (-110.2, 72.5), (81.8, -126.0),
    (-60.6, -92.3), (-21.3, 46.2), (-28.0, 148.0), (66.7, -65.4), (107.4, 96.5),
    (-112.6, 67.5), (-70.9, 82.1), (8.5, 63.8), (78.9, -62.8), (-25.4, -81.2), (108.1, -2.9),
    (173.1, 175.3), (-42.8, 24.8), (-86.7, -90.3), (84.4, -165.8), (156.4, 158.2),
    (7.3, -17.3), (67.5, -31.2), (100.0, 157.9), (101.8, 155.1), (135.3, -31.8),
    (-66.6, -97.9), (-179.7, -47.9), (120.2, 107.6), (162.2, -55.2), (-19.4, -34.2),
    (50.7, -47.6), (166.2, 10.2), (122.4, -100.3), (-15.9, 99.4), (128.7, -2.0),
    (-164.8, 48.6), (155.9, -128.1), (-47.8, -96.7), (41.3, -117.9), (-93.3, 76.2),
    (53.6, -172.9), (19.3, -35.4), (2.4, -170.5), (-76.8, -163.3), (-13.2, 4.8), (24.0, 73.2),
    (-42.2, -141.3), (90.0, -134.2), (42.3, -39.5), (124.4, -179.3), (21.6, 99.7),
    (-5.0, 169.3), (-2.3, -167.1), (175.0, -142.3), (51.4, -69.9), (-34.4, 140.9),
    (-18.8, 47.5), (-141.4, -120.8), (-22.5, -78.3), (19.4, 78.8), (120.9, 77.2),
    (121.9, -144.7), (-27.7, 46.7), (-176.1, -156.2), (59.0, -49.8), (36.1, 169.8),
    (-76.3, -141.3),
)

CLEARANCE_A = 2.5  # no water oxygen nearer a protein atom


def pattern() -> np.ndarray:
    """(159, 2) float64 (phi, psi) of the template chain, degrees."""
    out, coil = [], iter(COIL)
    fixed = {"arm": ARM, "strand": STRAND, "helix": HELIX}
    for kind, n in ELEMENTS:
        out += [next(coil) if kind == "coil" else fixed[kind] for _ in range(n)]
    return np.asarray(out, np.float64)


def _place(a, b, c, bond: float, angle: float, torsion: float) -> np.ndarray:
    """NeRF: the atom d bonded to c with |cd| = bond, angle bcd and
    dihedral abcd (degrees)."""
    bc = c - b
    bc /= np.linalg.norm(bc)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    th, ph = np.radians(angle), np.radians(torsion)
    return c + bond * (-np.cos(th) * bc + np.sin(th) * (np.cos(ph) * m - np.sin(ph) * n))


def template(n_res: int) -> np.ndarray:
    """(n_res, 10, 3) float64 atoms of the template chain's first n_res
    residues, in RESIDUE order, the centroid at the origin."""
    pp = pattern()[:n_res]
    x = np.zeros((n_res, len(RESIDUE), 3))
    N, CA, C = ATOM["N"], ATOM["CA"], ATOM["C"]
    x[0, CA] = (N_CA, 0.0, 0.0)
    th = np.radians(N_CA_C)
    x[0, C] = x[0, CA] + CA_C * np.array([-np.cos(th), np.sin(th), 0.0])
    for i in range(1, n_res):
        x[i, N] = _place(x[i - 1, N], x[i - 1, CA], x[i - 1, C], C_N, CA_C_N, pp[i - 1, 1])
        x[i, CA] = _place(x[i - 1, CA], x[i - 1, C], x[i, N], N_CA, C_N_CA, OMEGA)
        x[i, C] = _place(x[i - 1, C], x[i, N], x[i, CA], CA_C, N_CA_C, pp[i, 0])
    for i in range(n_res):
        n, ca, c = x[i, N], x[i, CA], x[i, C]
        phi, psi = pp[i]
        x[i, ATOM["O"]] = _place(n, ca, c, C_O, CA_C_O, psi + 180.0)
        x[i, ATOM["H"]] = _place(c, ca, n, N_H, C_N_H, phi + 180.0)
        x[i, ATOM["HA"]] = _place(c, n, ca, CA_HA, N_CA_HA, HA_TORSION)
        cb = x[i, ATOM["CB"]] = _place(c, n, ca, CA_CB, N_CA_CB, CB_TORSION)
        for k, tor in enumerate((60.0, 180.0, 300.0)):
            x[i, ATOM["HB1"] + k] = _place(n, ca, cb, CB_HB, CA_CB_HB, tor)
    return x - x.reshape(-1, 3).mean(0)


def _axis_rotation(axis, angle: float) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * (k @ k)


def icosahedral_rotations() -> np.ndarray:
    """(60, 3, 3) the rotations of the icosahedral group, the identity
    first: the closure of a five-fold turn about (0, 1, golden ratio) and a
    two-fold turn about z, in the order a breadth-first walk meets them."""
    gold = (1.0 + np.sqrt(5.0)) / 2.0
    gens = (_axis_rotation((0.0, 1.0, gold), 2.0 * np.pi / 5.0),
            _axis_rotation((0.0, 0.0, 1.0), np.pi))
    group, queue = [np.eye(3)], [np.eye(3)]
    while queue:
        g = queue.pop(0)
        for h in gens:
            r = h @ g
            if not any(np.abs(r - q).max() < 1e-9 for q in group):
                group.append(r)
                queue.append(r)
    if len(group) != 60:
        raise RuntimeError(f"the icosahedral closure has {len(group)} rotations, not 60")
    return np.stack(group)


def chain_label(k: int) -> str:
    """A one-character chain id: A-Z, then a-z, then 0-9."""
    labels = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
    return labels[k]


@dataclass
class Capsid:
    """The capsid system: protein chains, then waters (OW, HW1, HW2), then
    ions (Na+, then Cl-), in one periodic cube."""

    n_chains: int
    residues_per_chain: int
    n_waters: int
    n_ions: int
    box: float  # edge, A
    coords: np.ndarray  # (n, 3) float32 base configuration
    z: np.ndarray  # (n,) int32 atomic numbers
    atom_names: list
    res_names: list
    res_ids: np.ndarray  # (n,) int32, 1-based: protein residues in chain order, waters, ions
    chain_ids: list  # one id per protein chain, "" for the solvent
    bonds: np.ndarray  # (n_bonds, 2) int32: the template's, then O-H1 and O-H2

    @property
    def n_atoms(self) -> int:
        return self.coords.shape[0]

    @property
    def n_protein_atoms(self) -> int:
        return self.n_chains * self.residues_per_chain * len(RESIDUE)

    @property
    def basis(self) -> np.ndarray:
        return np.diag(np.full(3, self.box)).astype(np.float32)

    def backbone(self, name: str) -> np.ndarray:
        """(n_chains · residues_per_chain,) int64 atom index of `name` (N,
        CA, C or O) of every protein residue, in chain order."""
        n_res = self.n_chains * self.residues_per_chain
        return np.arange(n_res, dtype=np.int64) * len(RESIDUE) + ATOM[name]

    def chain_ranges(self) -> np.ndarray:
        """(n_chains, 2) [begin, end) of each chain's residues."""
        beg = np.arange(self.n_chains) * self.residues_per_chain
        return np.stack([beg, beg + self.residues_per_chain], 1)


def sizes(config: dict) -> dict:
    """The atom counts a configuration file gives, without building."""
    protein = config["n_chains"] * config["residues_per_chain"] * len(RESIDUE)
    waters = 3 * config["n_waters"]
    return {"protein": protein, "water": waters, "ions": config["n_ions"],
            "atoms": protein + waters + config["n_ions"]}


def _solvent_sites(protein: np.ndarray, n_sites: int, box: float, rng) -> np.ndarray:
    """(n_sites, 3) jittered lattice sites clear of the protein, in lattice
    order: the finest cubic lattice at least as coarse as n_sites asks for
    that keeps that many clear, each site moved by N(0, 0.1 cell), then
    n_sites of the clear ones drawn from the seed."""
    tree = scipy.spatial.cKDTree(protein)
    g = int(np.ceil(n_sites ** (1.0 / 3.0)))
    while True:
        cell_w = box / g
        grid = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"), -1).reshape(-1, 3)
        sites = (grid + 0.5) * cell_w + rng.normal(scale=0.1 * cell_w, size=grid.shape)
        near, _ = tree.query(sites, k=1, distance_upper_bound=CLEARANCE_A)
        clear = np.nonzero(~np.isfinite(near))[0]
        if clear.size >= n_sites:
            return sites[np.sort(rng.choice(clear, size=n_sites, replace=False))]
        g += 1


def capsid(config: dict, seed: int) -> Capsid:
    """The capsid system a configuration file describes."""
    rng = np.random.RandomState(host_seed(seed))
    n_ch, n_res, box = config["n_chains"], config["residues_per_chain"], float(config["box_A"])
    n_wat, n_ion = config["n_waters"], config["n_ions"]
    rot = icosahedral_rotations()[:n_ch]
    tmpl = template(n_res)  # (n_res, 10, 3), centred
    # the template's centroid on a fixed general direction, shell_radius_A out
    offset = np.array([0.31, 0.52, 0.79])
    offset *= config["shell_radius_A"] / np.linalg.norm(offset)
    centre = np.full(3, box * 0.5)
    prot = np.einsum("kij,rj->kri", rot, (tmpl.reshape(-1, 3) + offset)) + centre
    prot = prot.reshape(-1, 3)

    sites = _solvent_sites(prot, n_wat + n_ion, box, rng)
    pick = rng.permutation(sites.shape[0])
    ions = sites[np.sort(pick[:n_ion])]
    wsite = sites[np.sort(pick[n_ion:])]
    th = rng.uniform(0, 2 * np.pi, n_wat)  # each water turned about z
    c, s = np.cos(th)[:, None], np.sin(th)[:, None]
    ox, oy, oz = (WATER_SITES[None, :, k] for k in range(3))
    wat = np.stack([wsite[:, None, 0] + ox * c - oy * s, wsite[:, None, 1] + ox * s + oy * c,
                    wsite[:, None, 2] + oz], -1)

    n_na = n_ion // 2
    ion_names = ["NA"] * n_na + ["CL"] * (n_ion - n_na)
    n_prot = prot.shape[0]
    per_res = [name for name, _ in RESIDUE]
    res_prot = np.repeat(np.arange(1, n_ch * n_res + 1, dtype=np.int32), len(RESIDUE))
    res_wat = np.repeat(np.arange(n_ch * n_res + 1, n_ch * n_res + n_wat + 1, dtype=np.int32), 3)
    res_ion = np.arange(n_ch * n_res + n_wat + 1, n_ch * n_res + n_wat + n_ion + 1, dtype=np.int32)

    first = np.arange(n_ch * n_res) * len(RESIDUE)
    intra = np.concatenate([np.stack([first + a, first + b], 1) for a, b in RESIDUE_BONDS])
    link = np.arange(n_ch * n_res).reshape(n_ch, n_res)[:, :-1].reshape(-1) * len(RESIDUE)
    peptide = np.stack([link + ATOM["C"], link + len(RESIDUE) + ATOM["N"]], 1)
    o = n_prot + np.arange(0, 3 * n_wat, 3)
    water_bonds = np.concatenate([np.stack([o, o + 1], 1), np.stack([o, o + 2], 1)])
    return Capsid(
        n_chains=n_ch, residues_per_chain=n_res, n_waters=n_wat, n_ions=n_ion, box=box,
        coords=np.concatenate([prot, wat.reshape(-1, 3), ions]).astype(np.float32),
        z=np.concatenate([np.tile(np.array([zz for _, zz in RESIDUE], np.int32), n_ch * n_res),
                          np.tile(np.array([8, 1, 1], np.int32), n_wat),
                          np.array([ION_Z[nm] for nm in ion_names], np.int32)]),
        atom_names=per_res * (n_ch * n_res) + ["OW", "HW1", "HW2"] * n_wat + ion_names,
        res_names=["ALA"] * n_prot + ["SOL"] * (3 * n_wat) + ion_names,
        res_ids=np.concatenate([res_prot, res_wat, res_ion]),
        chain_ids=[chain_label(k) for k in range(n_ch) for _ in range(n_res * len(RESIDUE))]
        + [""] * (3 * n_wat + n_ion),
        bonds=np.concatenate([intra, peptide, water_bonds]).astype(np.int32),
    )


def make(config: dict, seed: int, device):
    """The capsid and its frames a configuration file describes."""
    cap = capsid(config, seed)
    return cap, frames(cap, config["n_frames"], config["jitter_A"], seed, device)
