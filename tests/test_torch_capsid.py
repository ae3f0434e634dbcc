"""The STMV capsid deployment (portbench/capsid.py, configs/stmv.json) through
the port's normal path, held to the benchmark's plain reference of a
cartoon frame (portbench/reference/cartoon.py), on the CPU at a small size.

Nothing here imports the JAX package, so the card test collects on a
machine that has a GPU but no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_capsid.py

Tolerances.
- Sizes, backbone ranges, chains: exact.
- Secondary structure: the program's class (the largest of its coil,
  helix, sheet weights) on frame 0 equals the class of the pattern's own
  phi/psi for at least 90% of residues: frame 0 carries N(0, 0.08 A) noise
  on every atom, which moves a dihedral by a few degrees, and a residue
  whose pattern angles lie that near a zone's class boundary may change
  class.
- Frames against the reference: the limits of `limits/stmv.cartoon.json`,
  the cell's own, each number at or under its limit. Both sides run the
  same float32 and float64 operations in the same order on the same
  device (the interpolation, the phi/psi, the colours, the float64 mesh,
  the view transform, the ray tests in list order, HBAO, tonemap, FXAA), so
  the program reads 0 on picks and depths; the limits leave room only for
  what a device may round apart.
- A mutation (the ribbon 10% wider, or one chain's coordinates a frame
  late) exceeds at least one of those limits.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import capsid, run as R
from portbench.kinds import cartoon as kind
from portbench.reference import cartoon as ref

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 977


def small_files(width=160, height=120):
    files = R.cell_files("stmv.cartoon")
    files["config"].update(n_chains=3, residues_per_chain=80, n_waters=400, n_ions=4,
                           box_A=60.0, shell_radius_A=20.0, n_frames=6)
    files["traffic"].update(width=width, height=height, distance_box=1.4)
    return files


def keep(cell, ks=(0, 9)):
    """Render frames k of the mix through the kind, keeping each for the
    check, as a window keeps its sampled and last frames (k = 9 plays
    between trajectory frames 1 and 2) -> the cell."""
    for k in ks:
        cell.kept.append(kind.render(cell, kind.view_params(
            cell.traffic, cell.wb, cell.config["n_frames"], k)))
    return cell


@pytest.fixture(scope="module")
def small_cell():
    """The cartoon kind's set-up on the CPU at a small size, two frames
    kept."""
    torch.set_num_threads(2)
    files = small_files()
    cell = keep(kind.setup(files["config"], files["traffic"], SEED, "cpu"))
    yield files, cell
    kind.release(cell)


def again(files, cell):
    """The same session's frames again, kept in a cell of their own."""
    return keep(kind.Cell(files["config"], files["traffic"], cell.wb, cell.session))


def test_full_size_sizes():
    """The full configuration's counts, worked out from the file, and the
    generated system's, without frames."""
    cfg = json.loads((ROOT / "portbench/configs/stmv.json").read_text())
    n = capsid.sizes(cfg)
    assert (n["protein"], n["water"], n["ions"]) == (95400, 970626, 602)
    assert n["atoms"] == cfg["n_atoms"] == 1066628
    assert ref.triangle_count(cfg["n_chains"], cfg["residues_per_chain"]) == 606960
    cap = capsid.capsid(cfg, SEED)
    assert cap.n_atoms == 1066628 and cap.coords.shape == (1066628, 3)
    assert len(set(cap.chain_ids[:cap.n_protein_atoms])) == 60
    assert cap.res_ids.max() == 9540 + 323542 + 602
    assert sorted(set(cap.res_names)) == ["ALA", "CL", "NA", "SOL"]
    assert np.bincount(cap.z)[[11, 17]].tolist() == [301, 301]
    assert cap.bonds.shape == (60 * (159 * 9 + 158) + 2 * 323542, 2)
    prot = cap.coords[:cap.n_protein_atoms].astype(np.float64)
    centre = np.full(3, cfg["box_A"] / 2)
    per_chain = prot.reshape(60, -1, 3).mean(1) - centre
    np.testing.assert_allclose(np.linalg.norm(per_chain, axis=1), 75.0, atol=1e-3)
    assert (prot > 0).all() and (prot < cfg["box_A"]).all()  # no chain crosses the cell
    import scipy.spatial

    o = cap.coords[cap.n_protein_atoms:cap.n_protein_atoms + 3 * 323542:3]
    d, _ = scipy.spatial.cKDTree(prot).query(o, k=1)
    assert d.min() >= capsid.CLEARANCE_A


def test_template_and_group():
    """The template chain is compact; the 60 rotations form the group."""
    x = capsid.template(159)
    ca = x[:, capsid.ATOM["CA"]]
    assert np.sqrt(((ca - ca.mean(0)) ** 2).sum(1).mean()) <= 20.0
    bonds = np.linalg.norm(x[:, capsid.ATOM["CA"]] - x[:, capsid.ATOM["N"]], axis=1)
    np.testing.assert_allclose(bonds, capsid.N_CA, atol=1e-9)
    g = capsid.icosahedral_rotations()
    np.testing.assert_allclose(np.linalg.det(g), 1.0, atol=1e-12)
    np.testing.assert_allclose(g @ g.transpose(0, 2, 1), np.broadcast_to(np.eye(3), g.shape),
                               atol=1e-12)
    prod = np.einsum("aij,bjk->abik", g, g).reshape(-1, 9)
    flat = g.reshape(60, 9)
    assert (np.abs(prod[:, None] - flat[None]).max(-1) < 1e-9).any(1).all()  # closed


def test_same_seed_same_arrays():
    files = small_files()
    a = capsid.capsid(files["config"], SEED)
    b = capsid.capsid(files["config"], SEED)
    c = capsid.capsid(files["config"], SEED + 1)
    np.testing.assert_array_equal(a.coords, b.coords)
    assert a.coords.shape == c.coords.shape and not np.array_equal(a.coords, c.coords)


def test_secondary_structure_and_backbone(small_cell):
    """The program's backbone is one range a chain, and its secondary
    structure on frame 0 follows the pattern's zones."""
    from viamd_tpu_torch.ops.backbone import secondary_structure
    from viamd_tpu_torch.render.backbone_rep import current_ss_weights

    files, cell = small_cell
    s, cap = cell.session, cell.wb
    bb = s.system.backbone
    np.testing.assert_array_equal(bb.ranges, cap.chain_ranges())
    np.testing.assert_array_equal(bb.atom_ca, cap.backbone("CA"))
    s.set_frame(0.0)
    got = current_ss_weights(s.system, s.device_coords(), device="cpu").argmax(-1)
    pp = torch.as_tensor(np.tile(capsid.pattern()[:cap.residues_per_chain], (cap.n_chains, 1)))
    pos = torch.arange(got.shape[0]) % cap.residues_per_chain
    valid = (pos > 0) & (pos < cap.residues_per_chain - 1)
    want = secondary_structure(torch.deg2rad(pp[:, 0]), torch.deg2rad(pp[:, 1]), valid).argmax(-1)
    assert (got == want).float().mean() >= 0.9
    assert {int(v) for v in want.unique()} == {0, 1, 2}  # coil, helix and sheet all there


def test_frames_equal_the_reference(small_cell):
    """The frames the window kept, against the reference, within the
    cell's limits; the program reads 0 on picks and depths."""
    files, cell = small_cell
    values, _, failed = kind.check(cell, SEED, "cpu", files["limits"])
    assert set(values) == set(files["limits"])
    assert failed == 0 and all(values[k] <= v for k, v in files["limits"].items()), values
    assert values["pick_mismatch"] == 0.0 and values["depth_rel_max"] == 0.0
    rgba, depth, pick = cell.kept[0].out
    assert rgba.shape == (120, 160, 4) and 0.05 < float((pick >= 0).float().mean()) < 0.95


@pytest.mark.parametrize("mutation", ["wider_ribbon", "chain_a_frame_late"])
def test_mutation_exceeds_a_limit(mutation, small_cell, monkeypatch):
    """The cell's limits catch a mesh 10% wider and a chain one frame late."""
    from viamd_tpu_torch.render import ribbon_mesh as rm

    files, cell = small_cell
    stack = cell.session.trajectory.stack
    saved = stack.clone()
    if mutation == "wider_ribbon":
        real = rm.ribbon_mesh
        monkeypatch.setattr(rm, "ribbon_mesh",
                            lambda *a, **k: real(*a, **dict(k, width_scale=1.1)))
    else:
        n = cell.wb.residues_per_chain * len(capsid.RESIDUE)
        stack[1:, :n] = saved[:-1, :n]
    try:
        broken = again(files, cell)
    finally:
        stack.copy_(saved)
    values, _, failed = kind.check(broken, SEED, "cpu", files["limits"])
    assert failed >= 1 and any(values[k] > v for k, v in files["limits"].items()), values


def test_cartoon_spans(small_cell, tracer_state):
    """The cartoon's spans, in Session.render's tree, record only while the
    tracer collects."""
    from viamd_tpu_torch.core.tracing import TRACER

    files, cell = small_cell
    TRACER.reset()
    TRACER.enabled = False
    again(files, cell)
    assert TRACER.spans() == []
    TRACER.enabled = True
    kind.render(cell, kind.view_params(files["traffic"], cell.wb, 6, 1))
    sp = TRACER.spans()
    paths = {}
    for x in sp:
        chain, p = [x.name], x.parent
        while p >= 0:
            chain.insert(0, sp[p].name)
            p = sp[p].parent
        paths[x.name] = "/".join(chain)
    assert paths["cartoon.ss"] == "render/render.colors/cartoon.ss"
    assert paths["cartoon.mesh"] == "render/render.draw/cartoon.mesh"
    assert paths["cartoon.gather"] == "render/render.draw/cartoon.gather"
    assert paths["triangles.bin"] == "render/render.draw/triangles.bin"
    assert paths["triangles.kernel"] == "render/render.draw/triangles.kernel"


@pytest.fixture
def tracer_state():
    from viamd_tpu_torch.core.tracing import TRACER

    was = TRACER.enabled
    yield
    TRACER.enabled = was
    TRACER.reset()


@pytest.mark.requires_cuda
def test_full_size_on_the_card():
    """On the card, at the cell's sizes: the frames of the timed path
    against the reference within the cell's limits, the mesh built by one
    ribbon.cu launch a frame, the triangles handed to the raster counted,
    and the control over a limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the triangle kernel has no CPU mode")
    from viamd_tpu_torch.render import cuda_ribbon, cuda_triangles

    files = R.cell_files("stmv.cartoon")
    cfg, tr = files["config"], files["traffic"]
    cell = kind.setup(cfg, tr, SEED, "cuda")
    before = cuda_triangles.triangles
    built = (cuda_ribbon.launches, cuda_ribbon.triangles)
    w = kind.window(cell, 0.0, SEED, steps=2)
    count = ref.triangle_count(cfg["n_chains"], cfg["residues_per_chain"])
    assert cuda_triangles.triangles - before == 2 * count
    # one ribbon.cu launch a frame builds the mesh triangles.cu takes
    assert (cuda_ribbon.launches - built[0], cuda_ribbon.triangles - built[1]) == (2, 2 * count)
    kind.release(cell)
    values, _, failed = kind.check(cell, SEED, "cuda", files["limits"])
    assert w["frames"] == 2 and failed == 0, values
    control = kind.control(cfg, tr, SEED, "cuda")
    assert any(control[k] > v for k, v in files["limits"].items()), control
