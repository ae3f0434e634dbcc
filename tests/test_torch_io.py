"""viamd_tpu_torch.io against viamd_tpu.io (JAX package) on the CPU.

The fixtures are the JAX I/O tests' own (tests/test_io.py,
tests/test_io_formats.py: the same texts, the same seeded frames, files
written by the JAX writers); both packages' loaders read them and must give
equal `System` fields, frames, cells and times. The port's writers must
give byte-identical files, its `.vtraj` caches must open in either package,
and its XTC codec copy must fail on corrupt files exactly where the JAX one
does. Every comparison is exact: these are host codecs in numpy and C++.
"""

import dataclasses
import os

import numpy as np
import pytest

from tests.conftest import make_ala_pdb
from viamd_tpu.core.unitcell import UnitCell as JUnitCell
from viamd_tpu_torch.core.unitcell import UnitCell

_TEXT_GRO = (
    "Test box\n"
    "    6\n"
    "    1SOL     OW    1   0.230   0.628   0.113\n"
    "    1SOL    HW1    2   0.260   0.732   0.115\n"
    "    1SOL    HW2    3   0.137   0.626   0.150\n"
    "    2SOL     OW    4   1.275   0.932   0.569\n"
    "    2SOL    HW1    5   1.337   0.943   0.650\n"
    "    2SOL    HW2    6   1.326   0.898   0.490\n"
    "   1.82060   1.82060   1.82060\n"
)
_TEXT_XYZ = {
    "plain": "3\nwater\nO 0.0 0.0 0.0\nH 0.96 0.0 0.0\nH -0.24 0.93 0.0\n",
    "multiframe": "2\ncomment\nC 0.0 0.0 0.0\nO 1.2 0.0 0.0\n"
                  "2\ncomment\nC 0.0 0.0 0.1\nO 1.2 0.0 0.1\n",
    "lattice": '2\nLattice="10 0 0 0 10 0 0 0 10"\nC 0 0 0\nO 1.2 0 0\n',
    "tinker_arc": "3 water\n1 O 0.000 0.000 0.000 1 2 3\n2 H 0.960 0.000 0.000 2 1\n"
                  "3 H -0.240 0.930 0.000 2 1\n",
}


def _frames(F=5, n=40, seed=0):
    """tests/test_io_formats.py's frames."""
    rng = np.random.RandomState(seed)
    return rng.uniform(0, 30, (F, n, 3)).astype(np.float32)


def _cells(cj: JUnitCell, ct: UnitCell):
    np.testing.assert_array_equal(np.asarray(ct.basis), np.asarray(cj.basis))
    np.testing.assert_array_equal(np.asarray(ct.inv_basis), np.asarray(cj.inv_basis))
    assert ct.kind == cj.kind


def same_system(sj, st):
    """Every field of the port's System equals the JAX one's."""
    for f in dataclasses.fields(sj):
        a, b = getattr(sj, f.name), getattr(st, f.name)
        if f.name == "cell":
            _cells(a, b)
        elif f.name in ("atom_names", "res_names", "chain_labels"):
            assert b.labels == a.labels, f.name
        elif f.name in ("backbone", "instances"):
            assert (a is None) == (b is None), f.name
            if a is not None:
                for g in dataclasses.fields(a):
                    va, vb = getattr(a, g.name), getattr(b, g.name)
                    if g.name == "labels":
                        assert vb.labels == va.labels
                    else:
                        np.testing.assert_array_equal(vb, va, err_msg=f"{f.name}.{g.name}")
        elif a is None:
            assert b is None, f.name
        else:
            assert b.dtype == np.asarray(a).dtype, f.name
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=f.name)


def same_traj(tj, tt):
    """Frames, cells (the port's from its scan, the JAX's from its reads)
    and times equal."""
    assert (tt.num_frames, tt.num_atoms) == (tj.num_frames, tj.num_atoms)
    np.testing.assert_array_equal(tt.frame_times, np.asarray(tj.frame_times))
    every = list(range(tj.num_frames))
    xj, cj = tj.load_frames(every)
    xt, ct = tt.load_frames(every)
    np.testing.assert_array_equal(xt, np.asarray(xj))
    np.testing.assert_array_equal(ct, np.asarray(cj))
    np.testing.assert_array_equal(tt.cells, np.asarray(cj))
    out = np.empty_like(xt[::-2])
    tt.load_frames_into(every[::-2], out)
    np.testing.assert_array_equal(out, xt[::-2])
    for i in {0, tj.num_frames - 1}:
        (aj, cellj), (at, cellt) = tj.load_frame(i), tt.load_frame(i)
        np.testing.assert_array_equal(at, np.asarray(aj))
        _cells(cellj, cellt)


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# -- structures -----------------------------------------------------------------------


@pytest.mark.parametrize("n_models", [1, 10])
def test_pdb(n_models):
    from viamd_tpu.io.pdb import parse_pdb as j_parse
    from viamd_tpu_torch.io.pdb import parse_pdb

    text = make_ala_pdb(4, n_models=n_models)
    (sj, tj), (st, tt) = j_parse(text), parse_pdb(text)
    same_system(sj, st)
    assert (tj is None) == (tt is None) == (n_models == 1)
    if tj is not None:
        same_traj(tj, tt)


def test_pdb_write():
    from viamd_tpu.core.bitfield import Bitfield as JBitfield
    from viamd_tpu.io.pdb import parse_pdb as j_parse, write_pdb as j_write
    from viamd_tpu_torch.core.bitfield import Bitfield
    from viamd_tpu_torch.io.pdb import parse_pdb, write_pdb

    sj, tj = j_parse(make_ala_pdb(4, n_models=3))
    st, tt = parse_pdb(make_ala_pdb(4, n_models=3))
    assert write_pdb(st) == j_write(sj)
    frames = tt.load_frames(range(3))[0]
    assert write_pdb(st, frames) == j_write(sj, frames)
    assert write_pdb(st, mask=Bitfield.from_range(st.natoms, 0, 5)) == \
        j_write(sj, mask=JBitfield.from_range(sj.natoms, 0, 5))
    # the port reads back what it wrote as the JAX package does
    same_system(j_parse(j_write(sj))[0], parse_pdb(write_pdb(st))[0])


def test_pdb_model_atom_count_mismatch():
    """A model with another atom count fails the host parser's pass; the
    Python pass names it, in both packages alike."""
    from viamd_tpu.io.pdb import parse_pdb as j_parse
    from viamd_tpu_torch.io.pdb import parse_pdb

    lines = make_ala_pdb(4, n_models=3).splitlines()
    last_atom = max(i for i, ln in enumerate(lines) if ln.startswith("ATOM"))
    text = "\n".join(lines[:last_atom] + lines[last_atom + 1:]) + "\n"
    with pytest.raises(ValueError) as ej:
        j_parse(text)
    with pytest.raises(ValueError) as et:
        parse_pdb(text)
    assert str(et.value) == str(ej.value)


def test_gro():
    from viamd_tpu.io.gro import parse_gro as j_parse
    from viamd_tpu_torch.io.gro import parse_gro

    same_system(j_parse(_TEXT_GRO), parse_gro(_TEXT_GRO))


def test_gro_of_the_water_box(tmp_path):
    """chip_smoke's `[io]` writes the headline box as .gro with its own
    writer (fixed GROMACS columns, serials mod 100,000): both packages read
    it alike, with datagen's elements (inferred from OW/HW1/HW2), residues
    and a cell within the file's 5 decimals of nm."""
    from chip_smoke import write_gro
    from viamd_tpu.io.gro import load_gro as j_load
    from viamd_tpu_torch.datagen import water_box
    from viamd_tpu_torch.io.gro import load_gro

    sys_, traj = water_box(100, n_frames=1, seed=3)
    path = str(tmp_path / "water.gro")
    write_gro(path, sys_, traj.load_frames([0])[0][0])
    sj, st = j_load(path), load_gro(path)
    same_system(sj, st)
    np.testing.assert_array_equal(st.element, sys_.element)
    np.testing.assert_array_equal(st.res_offsets, sys_.res_offsets)
    np.testing.assert_allclose(st.coords(), traj.load_frames([0])[0][0], atol=5e-3)
    np.testing.assert_allclose(st.cell.basis, sys_.cell.basis, atol=5e-4)


@pytest.mark.parametrize("kind", sorted(_TEXT_XYZ))
def test_xyz(kind):
    from viamd_tpu.io.xyz import parse_xyz as j_parse
    from viamd_tpu_torch.io.xyz import parse_xyz

    (sj, tj), (st, tt) = j_parse(_TEXT_XYZ[kind]), parse_xyz(_TEXT_XYZ[kind])
    same_system(sj, st)
    assert (tj is None) == (tt is None)
    if tj is not None:
        same_traj(tj, tt)


def _cif_texts():
    import inspect

    import tests.test_io_formats as f

    src = inspect.getsource(f.TestMMCIF.test_parse)
    plain = src[src.index('"""') + 3 : src.rindex('"""')]
    return {"plain": plain, "assembly": f._ASSEMBLY_CIF}


@pytest.mark.parametrize("kind", ["plain", "assembly"])
def test_mmcif(kind):
    from viamd_tpu.io.mmcif import parse_mmcif as j_parse
    from viamd_tpu_torch.io.mmcif import parse_mmcif

    text = _cif_texts()[kind]
    sj, st = j_parse(text), parse_mmcif(text)
    same_system(sj, st)
    assert (st.instances is not None) == (kind == "assembly")
    if kind == "assembly":
        inst_j, inst_t = sj.instances, st.instances
        assert inst_t.count == 2 and inst_t.nontrivial == inst_j.nontrivial
        assert [inst_t.is_identity(k) for k in range(2)] == [True, False]
        assert inst_t.find_by_atom(2) == inst_j.find_by_atom(2) == 0
        for a, b in zip(inst_t.expansion(st.coords()), inst_j.expansion(sj.coords())):
            np.testing.assert_array_equal(a, b)


def test_interop_carries_instance_tables():
    from tests._torch_parity import port_system
    from viamd_tpu.io.mmcif import parse_mmcif as j_parse
    from viamd_tpu_torch.io.mmcif import parse_mmcif

    text = _cif_texts()["assembly"]
    same_system(parse_mmcif(text), port_system(j_parse(text)))


_LAMMPS_DATA = """LAMMPS data file via viamd_tpu test

4 atoms
2 atom types

0.0 20.0 xlo xhi
0.0 20.0 ylo yhi
0.0 20.0 zlo zhi

Masses

1 15.999
2 1.008

Atoms # full

1 1 1 -0.8 5.0 5.0 5.0
2 1 2 0.4 5.96 5.0 5.0
3 1 2 0.4 4.76 5.93 5.0
4 2 1 -0.8 10.0 10.0 10.0
"""


def _dump_text(triclinic: bool) -> str:
    frames = []
    for step in (0, 100):
        box = ("ITEM: BOX BOUNDS xy xz yz pp pp pp\n-1.0 11.0 1.0\n0.0 10.0 -1.0\n"
               "0.0 10.0 0.5\n" if triclinic else
               "ITEM: BOX BOUNDS pp pp pp\n0.0 10.0\n0.0 10.0\n0.0 10.0\n")
        frames.append(
            f"ITEM: TIMESTEP\n{step}\nITEM: NUMBER OF ATOMS\n3\n{box}"
            f"ITEM: ATOMS id type x y z\n2 1 2.0 2.0 {2.0 + step / 100}\n"
            "1 1 1.0 1.0 1.0\n3 1 3.0 3.0 3.0\n"
        )
    return "".join(frames)


def test_lammps_data(tmp_path):
    from viamd_tpu.io.lammps import load_lammps_data as j_load
    from viamd_tpu_torch.io.lammps import load_lammps_data

    p = tmp_path / "w.data"
    p.write_text(_LAMMPS_DATA)
    same_system(j_load(str(p)), load_lammps_data(str(p)))


@pytest.mark.parametrize("triclinic", [False, True])
def test_lammps_dump(tmp_path, triclinic):
    from viamd_tpu.io.lammps import load_lammps_trajectory as j_load
    from viamd_tpu_torch.io.lammps import load_lammps_trajectory

    p = tmp_path / "d.lammpstrj"
    p.write_text(_dump_text(triclinic))
    same_traj(j_load(str(p)), load_lammps_trajectory(str(p)))


# -- trajectories -------------------------------------------------------------------


@pytest.mark.parametrize("periodic", [True, False])
def test_dcd(tmp_path, periodic):
    from viamd_tpu.io.dcd import DCDTrajectory as JDCD, write_dcd as j_write
    from viamd_tpu_torch.io.dcd import DCDTrajectory, write_dcd

    coords = _frames()
    cj = JUnitCell.from_lengths_angles(30, 31, 32, 80, 90, 100) if periodic else None
    ct = UnitCell.from_lengths_angles(30, 31, 32, 80, 90, 100) if periodic else None
    pj, pt = str(tmp_path / "j.dcd"), str(tmp_path / "t.dcd")
    j_write(pj, coords, cj)
    write_dcd(pt, coords, ct)
    assert _bytes(pt) == _bytes(pj)
    same_traj(JDCD(pj), DCDTrajectory(pj))


@pytest.mark.parametrize("periodic", [True, False])
def test_trr(tmp_path, periodic):
    from viamd_tpu.io.trr import TRRTrajectory as JTRR, write_trr as j_write
    from viamd_tpu_torch.io.trr import TRRTrajectory, write_trr

    coords = _frames()
    basis = np.array([[30, 0, 0], [4, 30, 0], [-3, 2, 30]], np.float32)
    cj = JUnitCell.from_basis(basis) if periodic else None
    ct = UnitCell.from_basis(basis) if periodic else None
    pj, pt = str(tmp_path / "j.trr"), str(tmp_path / "t.trr")
    j_write(pj, coords, cj, times=np.arange(5) * 2.0)
    write_trr(pt, coords, ct, times=np.arange(5) * 2.0)
    assert _bytes(pt) == _bytes(pj)
    same_traj(JTRR(pj), TRRTrajectory(pj))


@pytest.mark.parametrize(
    "case",
    ["roundtrip", "small_system_plain", "large_spread", "triclinic"],
)
def test_xtc(tmp_path, case):
    """TestXTC's files (the ≤ 9-atom uncompressed path, the > 2^24 spread
    of the bitsize == 0 path), written by both packages to equal bytes and
    read by both to equal frames, cells and times; ranged reads of
    scattered frames equal the JAX reader's."""
    from viamd_tpu.io.xtc import XTCTrajectory as JXTC, write_xtc as j_write
    from viamd_tpu_torch.io.xtc import XTCTrajectory, write_xtc

    basis = np.diag([30.0, 30.0, 30.0]).astype(np.float32)
    coords = _frames(F=4, n=200, seed=1)
    if case == "small_system_plain":
        coords, basis = _frames(F=3, n=5, seed=2), None
    elif case == "large_spread":
        coords = np.random.RandomState(3).uniform(0, 20000.0, (2, 50, 3)).astype(np.float32)
        basis = None
    elif case == "triclinic":
        basis = np.array([[30, 0, 0], [15, 26, 0], [15, 8.66, 24.5]], np.float32)
    cj = JUnitCell.from_basis(basis) if basis is not None else None
    ct = UnitCell.from_basis(basis) if basis is not None else None
    pj, pt = str(tmp_path / "j.xtc"), str(tmp_path / "t.xtc")
    j_write(pj, coords, cj, precision=1000.0)
    write_xtc(pt, coords, ct, precision=1000.0)
    assert _bytes(pt) == _bytes(pj)
    tj, tt = JXTC(pj), XTCTrajectory(pj)
    same_traj(tj, tt)
    idx = [tj.num_frames - 1, 0, tj.num_frames // 2]
    for a, b in zip(tt.load_frames(idx), tj.load_frames(idx)):
        np.testing.assert_array_equal(a, b)


def test_xtc_water_runs(tmp_path):
    """TestXTCRuns: the small-delta run encoding on a water box, equal
    bytes, equal frames."""
    from tests.conftest import make_water_box
    from viamd_tpu.io.xtc import XTCTrajectory as JXTC, write_xtc as j_write
    from viamd_tpu_torch.io.xtc import XTCTrajectory, write_xtc

    sys_j, traj = make_water_box(256, box=20.0, n_frames=4)
    xyz, _ = traj.load_frames(list(range(4)))
    pj, pt = str(tmp_path / "j.xtc"), str(tmp_path / "t.xtc")
    j_write(pj, np.asarray(xyz), sys_j.cell)
    write_xtc(pt, np.asarray(xyz), UnitCell.from_basis(np.asarray(sys_j.cell.basis)))
    assert _bytes(pt) == _bytes(pj)
    assert os.path.getsize(pt) / (4 * sys_j.natoms) < 5.0
    same_traj(JXTC(pj), XTCTrajectory(pt))


def _outcome(cls, path):
    try:
        t = cls(path)
        xyz, cell = t.load_frame(0)
        return ("ok", t.num_frames, np.asarray(xyz).tobytes(), np.asarray(cell.basis).tobytes())
    except (ValueError, OSError, EOFError) as e:
        return (type(e).__name__, str(e))


def test_xtc_corrupt(tmp_path):
    """TestXTCCorrupt's seeded sweep of truncated, byte-flipped and rotated
    files: each port load succeeds with the JAX reader's frame or raises
    the JAX reader's error (never a crash)."""
    from viamd_tpu.io.xtc import XTCTrajectory as JXTC, write_xtc as j_write
    from viamd_tpu_torch.io.xtc import XTCTrajectory

    coords = _frames(F=2, n=60, seed=4)
    p0 = str(tmp_path / "base.xtc")
    j_write(p0, coords, JUnitCell.orthorhombic(30, 30, 30))
    base = _bytes(p0)
    rng = np.random.RandomState(0)
    kinds = set()
    for i in range(200):
        data = bytearray(base)
        mode = rng.randint(3)
        if mode == 0:
            data = data[: rng.randint(1, len(data))]
        elif mode == 1:
            for _ in range(rng.randint(1, 30)):
                data[rng.randint(len(data))] = rng.randint(256)
        else:
            k = rng.randint(1, len(data))
            data = data[k:] + data[:k]
        p = str(tmp_path / "c.xtc")
        with open(p, "wb") as f:
            f.write(bytes(data))
        want, got = _outcome(JXTC, p), _outcome(XTCTrajectory, p)
        assert got == want, (i, mode)
        kinds.add(want[0])
    assert {"ok", "ValueError"} <= kinds


# -- the packed cache, the sidecar, the loader -------------------------------------------


def test_packed_cache(tmp_path):
    """transcode and write_cache give the JAX package's bytes; each
    package opens the other's cache."""
    from tests.conftest import make_water_box
    from viamd_tpu.io.cache import PackedTrajectory as JPacked
    from viamd_tpu.io.cache import transcode as j_transcode, write_cache as j_write
    from viamd_tpu_torch.io.cache import PackedTrajectory, transcode, write_cache
    from viamd_tpu_torch.io.trajectory import InMemoryTrajectory

    _, traj_j = make_water_box()
    frames, cells = traj_j.load_frames(range(traj_j.num_frames))
    traj_t = InMemoryTrajectory(frames, cells=cells, times=np.arange(5) * 0.5)
    traj_j._times = np.arange(5) * 0.5
    pj, pt = str(tmp_path / "j.vtraj"), str(tmp_path / "t.vtraj")
    j_transcode(traj_j, pj, chunk=2)
    transcode(traj_t, pt, chunk=2)
    assert _bytes(pt) == _bytes(pj)
    same_traj(JPacked(pt), PackedTrajectory(pj))
    j_write(pj, iter(zip(frames, cells)), frames.shape[1], 5)
    write_cache(pt, iter(zip(frames, cells)), frames.shape[1], 5)
    assert _bytes(pt) == _bytes(pj)
    j_write(pj, iter(frames), frames.shape[1], 5, cells=cells)
    write_cache(pt, iter(frames), frames.shape[1], 5, cells=cells)
    assert _bytes(pt) == _bytes(pj)
    bad = tmp_path / "bad.vtraj"
    bad.write_bytes(b"XXXX" + b"\0" * 60)
    with pytest.raises(ValueError, match="not a vtraj"):
        PackedTrajectory(str(bad))


def test_sidecar(tmp_path):
    """TestSidecarCache: an XTC's first load writes a `.vtraj` sidecar (the
    JAX package's bytes), later loads open it, `cache=False` reads the XTC;
    a sidecar written by either package serves the other."""
    from viamd_tpu.io import load_file as j_load
    from viamd_tpu_torch.io import load_file
    from viamd_tpu_torch.io.xtc import write_xtc

    p = tmp_path / "a.pdb"
    p.write_text(make_ala_pdb(4, n_models=6))
    r = load_file(str(p))
    frames = r.trajectory.load_frames(range(6))[0]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    paths = {k: str(tmp_path / k / "a.xtc") for k in "jt"}
    for xp in paths.values():
        write_xtc(xp, frames, cell=None)
    rj = j_load(paths["j"], system=j_load(str(p)).system)
    rt = load_file(paths["t"], system=r.system)
    assert type(rt.trajectory).__name__ == "PackedTrajectory"
    assert _bytes(paths["t"] + ".vtraj") == _bytes(paths["j"] + ".vtraj")
    same_traj(rj.trajectory, rt.trajectory)
    r3 = load_file(paths["t"], system=r.system, cache=False)
    assert type(r3.trajectory).__name__ == "XTCTrajectory"
    same_traj(rj.trajectory, r3.trajectory)
    # the JAX package's sidecar opens in the port
    assert load_file(paths["j"], system=r.system).trajectory.path == paths["j"] + ".vtraj"
    from viamd_tpu_torch.datagen import water_box

    with pytest.raises(ValueError, match="does not match"):
        load_file(paths["t"], system=water_box(7, n_frames=1)[0])


def test_loader_table(tmp_path):
    from viamd_tpu.io.loader import loader_for_path as j_for
    from viamd_tpu_torch.io import LoaderFlags, load_file, loader_for_path

    for ext in ("pdb", "gro", "xyz", "xmol", "arc", "cif", "data", "lammpstrj",
                "xtc", "trr", "dcd", "vtraj", "unknown", "PDB"):
        name, flags = loader_for_path(f"foo.{ext}")
        jname, jflags = j_for(f"foo.{ext}")
        assert (name, int(flags)) == (jname, int(jflags)), ext
    assert loader_for_path("foo.gro")[1] & LoaderFlags.SYSTEM
    p = tmp_path / "ala.pdb"
    p.write_text(make_ala_pdb(4, n_models=3))
    res = load_file(str(p))
    assert res.system.natoms == 20 and res.trajectory.num_frames == 3
    with pytest.raises(ValueError, match="Unsupported"):
        load_file(str(tmp_path / "x.vlx"))


def test_load_file_formats(tmp_path):
    """load_file over every format the fixtures above hold: the port's
    result equals the JAX package's."""
    from viamd_tpu.io import load_file as j_load
    from viamd_tpu.io.dcd import write_dcd
    from viamd_tpu.io.trr import write_trr
    from viamd_tpu_torch.io import load_file

    files = {
        "a.pdb": make_ala_pdb(4, n_models=2), "w.gro": _TEXT_GRO,
        "m.xyz": _TEXT_XYZ["multiframe"], "c.cif": _cif_texts()["assembly"],
        "l.data": _LAMMPS_DATA, "d.lammpstrj": _dump_text(True),
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    write_dcd(str(tmp_path / "t.dcd"), _frames(n=3), JUnitCell.orthorhombic(30, 30, 30))
    write_trr(str(tmp_path / "t.trr"), _frames(n=3), JUnitCell.orthorhombic(30, 30, 30))
    for name in sorted(files) + ["t.dcd", "t.trr"]:
        rj, rt = j_load(str(tmp_path / name)), load_file(str(tmp_path / name))
        assert int(rt.flags) == int(rj.flags), name
        assert (rt.system is None) == (rj.system is None), name
        if rj.system is not None:
            same_system(rj.system, rt.system)
        assert (rt.trajectory is None) == (rj.trajectory is None), name
        if rj.trajectory is not None:
            same_traj(rj.trajectory, rt.trajectory)


# -- tables -------------------------------------------------------------------------


def _edr_fixture():
    names = ["Potential", "Kinetic En.", "Temperature"]
    t = np.linspace(0.0, 10.0, 21)
    e = np.stack([np.sin(t), np.cos(t) * 100.0, 300.0 + t], axis=1)
    return names, t, e


@pytest.mark.parametrize("double", [False, True])
def test_edr(tmp_path, double):
    from viamd_tpu.io.edr import read_edr as j_read, write_edr as j_write
    from viamd_tpu_torch.io.edr import read_edr, write_edr

    names, t, e = _edr_fixture()
    pj, pt = str(tmp_path / "j.edr"), str(tmp_path / "t.edr")
    j_write(pj, names, t, e, double=double)
    write_edr(pt, names, t, e, double=double)
    assert _bytes(pt) == _bytes(pj)
    (cj, lj), (ct, lt) = j_read(pj), read_edr(pj)
    assert lt == lj
    np.testing.assert_array_equal(ct, cj)


def test_edr_file_version_1(tmp_path):
    """TestEDR.test_file_version_1's hand-built layout."""
    import struct

    from viamd_tpu.io.edr import read_edr as j_read
    from viamd_tpu_torch.io.edr import read_edr

    out = bytearray(struct.pack(">i", 2))
    for nm in (b"Potential\x00", b"Pressure\x00"):
        out += struct.pack(">i", len(nm)) + nm + b"\x00" * ((4 - len(nm) % 4) % 4)
    for fi, (t, e0, e1) in enumerate([(0.0, 1.5, -2.0), (0.5, 1.25, -1.0)]):
        out += struct.pack(">f", t) + struct.pack(">i", fi)
        out += struct.pack(">iiiii", 2, 0, 0, 0, 0)
        for e in (e0, e1):
            out += struct.pack(">ffff", e, 0.0, 0.0, 0.0)
    p = tmp_path / "old.edr"
    p.write_bytes(bytes(out))
    (cj, lj), (ct, lt) = j_read(str(p)), read_edr(str(p))
    assert lt == lj == ["Time", "Potential", "Pressure"]
    np.testing.assert_array_equal(ct, cj)
    p.write_bytes(bytes(out[:-3]))
    with pytest.raises(ValueError) as ej:
        j_read(str(p))
    with pytest.raises(ValueError) as et:
        read_edr(str(p))
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("fmt", ["xvg", "csv"])
def test_tables(tmp_path, fmt):
    import importlib

    j_mod = importlib.import_module(f"viamd_tpu.io.{fmt}")
    t_mod = importlib.import_module(f"viamd_tpu_torch.io.{fmt}")
    cols = np.stack([np.arange(12) * 0.5, np.sin(np.arange(12)) * 7.0, np.arange(12) ** 2.0])
    pj, pt = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
    if fmt == "xvg":
        kw = dict(title="T", xaxis="t (ps)", yaxis="E", legends=["a", "b"])
        j_mod.write_xvg(pj, cols, **kw)
        t_mod.write_xvg(pt, cols, **kw)
        read_j, read_t = j_mod.read_xvg, t_mod.read_xvg
    else:
        j_mod.write_csv(pj, cols, header=["t", "a", "b"])
        t_mod.write_csv(pt, cols, header=["t", "a", "b"])
        read_j, read_t = j_mod.read_csv, t_mod.read_csv
    assert _bytes(pt) == _bytes(pj)
    (aj, mj), (at, mt) = read_j(pj), read_t(pj)
    np.testing.assert_array_equal(at, aj)
    assert mt == mj
