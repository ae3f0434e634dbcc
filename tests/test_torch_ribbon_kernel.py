"""csrc/ribbon.cu (render/cuda_ribbon.py) against its plain version,
render/ribbon_mesh.py::ribbon_mesh followed by render/triangles.py::
view_transform.

On the CPU: the frame-independent tables the kernel and the session take
(`ribbon_tables`: each triangle's CA atom and backbone residue, each
chain's first triangle) against `ribbon_mesh`'s own sources and order, the
CPU route of `ribbon_view`, the session's cache of the tables, and the
wrapper's refusal of CPU tensors.

On the card (`requires_cuda`; nothing of the JAX package or of the `tests`
package is imported, so these collect on a machine with a GPU and no JAX):
    python -m pytest --noconftest -m requires_cuda tests/test_torch_ribbon_kernel.py

Tolerance: none. The kernel repeats numpy's float64 operations in numpy's
order and the view product in float32 in PyTorch's, and is built with
-fmad=false, so every vertex of every triangle must be bit-equal.
"""

import inspect

import numpy as np
import pytest
import torch

from viamd_tpu_torch.core.system import build_system, postprocess
from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.datagen import polyala_helix
from viamd_tpu_torch.render import cuda_ribbon
from viamd_tpu_torch.render.ribbon_mesh import ribbon_mesh, ribbon_tables, ribbon_view
from viamd_tpu_torch.render.triangles import view_transform

SEED = 2**31 + 977  # tests/test_torch_capsid.py's
STYLE = ("cartoon", "coil_width", "coil_thickness", "ribbon_width", "ribbon_thickness",
         "arrow_scale", "width_scale")  # ribbon_mesh's styling keywords


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _helix(n_res=8, seed=1):
    """One jittered poly-alanine helix chain and its frame 0."""
    sys_, traj = polyala_helix(n_res, n_frames=1, seed=seed)
    return sys_, traj.load_frames([0])[0][0]


def _chains(n_chains=3, n_res=9, seed=4):
    """n_chains jittered helices side by side, one chain each."""
    one, traj = polyala_helix(n_res, n_frames=n_chains, seed=seed)
    frames = traj.load_frames(range(n_chains))[0]
    k = one.natoms
    names = [one.atom_names[i] for i in one.atom_name_id]
    x = np.concatenate([frames[c] + [12.0 * c, 0, 0] for c in range(n_chains)]).astype(np.float32)
    sys_ = postprocess(build_system(
        coords=x, atom_names=names * n_chains, res_names=["ALA"] * (k * n_chains),
        res_ids=np.tile(np.asarray(one.res_id)[one.atom_res_idx], n_chains),
        chain_ids=[chr(65 + c) for c in range(n_chains) for _ in range(k)],
        elements_z=np.tile(one.element, n_chains), cell=UnitCell.none(),
    ))
    return sys_, x


def _capsid(small: bool):
    """The stmv.cartoon deployment's system and base frame at SEED (three
    short chains when `small`)."""
    from portbench import capsid, run as R

    cfg = R.cell_files("stmv.cartoon")["config"]
    if small:
        cfg.update(n_chains=3, residues_per_chain=80, n_waters=400, n_ions=4, box_A=60.0,
                   shell_radius_A=20.0, n_frames=6)
    cap = capsid.capsid(cfg, SEED)
    sys_ = build_system(coords=cap.coords, atom_names=cap.atom_names, res_names=cap.res_names,
                        res_ids=cap.res_ids, chain_ids=cap.chain_ids, elements_z=cap.z,
                        cell=UnitCell.orthorhombic(cap.box, cap.box, cap.box))
    sys_.bonds = cap.bonds.copy()
    postprocess(sys_, infer_bonds=False)
    return sys_, cap.coords


def _pattern(nbb, pattern):
    """(nbb, 3) one-hot (coil, helix, sheet) weights from a string of
    c / h / s, repeated."""
    w = np.zeros((nbb, 3), np.float32)
    for i in range(nbb):
        w[i, "chs".index(pattern[i % len(pattern)])] = 1.0
    return w


def _flipped():
    """A 12-residue helix with every second residue's O mirrored through
    its C, so the peptide planes alternate and the flip correction turns
    them back."""
    sys_, x = _helix(12, seed=5)
    x = x.copy()
    bb = sys_.backbone
    for r in range(1, bb.count, 2):
        c, o = bb.atom_c[r], bb.atom_o[r]
        x[o] = x[c] - (x[o] - x[c])
    return sys_, x


# (system, frame, SS: None | pattern | "current", keywords) per case
CASES = {
    "ala_no_ss": (lambda: _helix(), None, dict(cartoon=True)),
    "chains_subdiv5_wide": (lambda: _chains(), "cssscchhhss",
                            dict(cartoon=True, subdiv=5, width_scale=1.3)),
    "current_ss": (lambda: _chains(), "current", dict(cartoon=True)),
    "ribbons": (lambda: _helix(), "ccchhhss", dict(cartoon=False)),
    "two_residues": (lambda: _helix(2, seed=3), "ss", dict(cartoon=True)),
    "sheet_ends": (lambda: _helix(12, seed=5), "scchsssccsss", dict(cartoon=True)),
    "co_flips": (_flipped, "s", dict(cartoon=True)),
    "capsid": (lambda: _capsid(small=False), "current", dict(cartoon=True)),
}


def _ss(sys_, x, pattern, device):
    from viamd_tpu_torch.render.backbone_rep import current_ss_weights

    if pattern is None:
        return None
    if pattern == "current":
        return current_ss_weights(sys_, x, device=device).contiguous()
    return torch.as_tensor(_pattern(sys_.backbone.count, pattern), device=device)


def _view(x):
    from viamd_tpu_torch.render.camera import compute_optimal_view

    return compute_optimal_view(x.min(0), x.max(0)).view_matrix()


# -- on the CPU --------------------------------------------------------------------


def _chain_of_atoms(sys_):
    """The drawn chain (index into ribbon_tables' chains) of each CA atom
    of a chain of >= 2 residues, -1 elsewhere."""
    bb = sys_.backbone
    out = np.full(sys_.natoms, -1)
    c = 0
    for beg, end in np.asarray(bb.ranges):
        if end - beg >= 2:
            out[bb.atom_ca[beg:end]] = c
            c += 1
    return out


@pytest.mark.parametrize("case,subdiv", [
    ("helix", 8), ("chains", 8), ("chains", 5), ("chains", 1), ("two_residues", 3),
    ("capsid_small", 8),
])
def test_tables_match_ribbon_mesh(case, subdiv):
    """Each triangle's CA atom and residue, and each chain's first triangle,
    against ribbon_mesh's sources in ribbon_mesh's order."""
    sys_, x = {"helix": _helix, "chains": _chains, "two_residues": lambda: _helix(2, seed=3),
               "capsid_small": lambda: _capsid(small=True)}[case]()
    tris, src = ribbon_mesh(sys_, x, subdiv=subdiv)
    t = ribbon_tables(sys_, subdiv, device="cpu")
    assert t.subdiv == subdiv and t.count == len(tris)
    assert t.src.dtype == torch.int32 and np.array_equal(t.src.numpy(), src)
    bb = sys_.backbone
    atoms = t.atoms.numpy()
    np.testing.assert_array_equal(atoms, np.stack([bb.atom_ca, bb.atom_c, bb.atom_o]))
    res = t.res.numpy()
    np.testing.assert_array_equal(atoms[0][res], src)  # the residue of each triangle
    # each chain's triangles are one block, at the offsets the tables give
    chains = t.chains.numpy()
    owner = _chain_of_atoms(sys_)[src]
    assert (np.diff(owner) >= 0).all() and owner.min() == 0
    starts = np.searchsorted(owner, np.arange(len(chains)))
    np.testing.assert_array_equal(chains[:, 2], starts)
    np.testing.assert_array_equal(chains[:, :2], [(b, e - b) for b, e in np.asarray(bb.ranges)
                                                  if e - b >= 2])
    ends = np.append(chains[1:, 2], t.count)
    for (beg, k, off), end in zip(chains, ends):  # the chain's residues, its ends capped
        assert res[off:end].min() == beg and res[off:end].max() == beg + k - 1
        np.testing.assert_array_equal(res[end - 4:end], [beg, beg, beg + k - 1, beg + k - 1])


def test_tables_refuse_what_ribbon_mesh_refuses():
    sys_, x = _helix()
    sys_.backbone = None
    with pytest.raises(ValueError, match="no protein backbone"):
        ribbon_tables(sys_, device="cpu")
    with pytest.raises(ValueError, match="no protein backbone"):
        ribbon_mesh(sys_, x)


@pytest.mark.parametrize("kw", [dict(cartoon=True), dict(cartoon=False, width_scale=0.7)])
def test_cpu_route_is_the_plain_version(kw):
    """On the CPU, ribbon_view is ribbon_mesh then view_transform."""
    sys_, x = _chains()
    ss = _ss(sys_, x, "cssscchhhss", "cpu")
    view = _view(x)
    got = ribbon_view(sys_, torch.as_tensor(x), ss, view, ribbon_tables(sys_, 5, device="cpu"),
                      **kw)
    tris, _ = ribbon_mesh(sys_, x, ss_weights=ss.numpy(), subdiv=5, **kw)
    want = view_transform(tris, view, device="cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)


def _style_defaults(fn):
    """fn's keywords that style the mesh, with their defaults."""
    params = inspect.signature(fn).parameters
    return {k: params[k].default for k in STYLE}


def test_wrapper_refuses_cpu_tensors():
    sys_, x = _helix()
    t = ribbon_tables(sys_, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_ribbon.mesh(torch.as_tensor(x), None, t.chains, t.atoms, t.count, np.eye(4),
                         subdiv=8, **_style_defaults(ribbon_mesh))


def test_styling_has_one_source():
    """The wrapper takes every styling keyword from its caller, and
    ribbon_view's defaults are ribbon_mesh's, so the two routes style the
    mesh alike."""
    params = inspect.signature(cuda_ribbon.mesh).parameters
    for k in ("subdiv", *STYLE):
        assert params[k].kind is inspect.Parameter.KEYWORD_ONLY, k
        assert params[k].default is inspect.Parameter.empty, k
    assert _style_defaults(ribbon_view) == _style_defaults(ribbon_mesh)


def test_session_keeps_the_tables():
    """Session._ribbon_tables builds once per system, and again after
    SYSTEM_INIT."""
    from viamd_tpu_torch.app import Session
    from viamd_tpu_torch.app.events import EventType

    s = Session(device="cpu")
    s.load_demo(n_res=6, n_frames=2)
    a = s._ribbon_tables()
    assert s._ribbon_tables() is a and a.count == len(ribbon_mesh(s.system, s.current_coords())[0])
    s.events.broadcast(EventType.SYSTEM_INIT, s)
    assert s._ribbon_tables() is not a


# -- on the card -------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain(case, cuda):
    """The kernel's view-space triangles, and the tables' sources, against
    view_transform(ribbon_mesh(...)) on the card, bit for bit."""
    make, pattern, kw = CASES[case]
    sys_, x = make()
    x = np.asarray(x, np.float32)
    ss = _ss(sys_, x, pattern, cuda)
    view = _view(x)
    tables = ribbon_tables(sys_, kw.get("subdiv", 8), device=cuda)
    style = {k: v for k, v in kw.items() if k != "subdiv"}
    before = cuda_ribbon.launches
    got = ribbon_view(sys_, torch.as_tensor(x, device=cuda), ss, view, tables, **style)
    assert cuda_ribbon.launches == before + 1
    tris, src = ribbon_mesh(sys_, x, ss_weights=None if ss is None else ss.cpu().numpy(), **kw)
    want = view_transform(tris, view, device=cuda)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    differ = (got.view(torch.int32) != want.view(torch.int32)).any(dim=(1, 2))
    assert int(differ.sum()) == 0, f"{int(differ.sum())} of {len(want)} triangles differ"
    assert np.array_equal(tables.src.cpu().numpy(), src)
