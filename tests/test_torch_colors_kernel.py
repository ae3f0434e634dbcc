"""csrc/colors.cu (render/cuda_colors.py) against its plain version, and the
plain version against the numpy chain of render/color.py that
Session._rep_colors ran on the host before the colours moved to the
device (`numpy_chain` below).

On the CPU: the Session's colours (the plain version) against the numpy
chain for every mapping of COLOR_MAPPINGS, uniform, secondary structure
and property, bare and with tint, saturation, a filter and a selection; the
CA subset and the radii; a dynamic filter; empty selections; the wrapper's
input checks; and the colour state's uploads.

On the card (`requires_cuda`; nothing of the JAX package or of the `tests`
package is imported, so these collect on a machine with a GPU and no JAX):
    python -m pytest --noconftest -m requires_cuda tests/test_torch_colors_kernel.py

Tolerances.
- Kernel against plain version (on the card and on the CPU): none. Both are
  float32 in the same order, the tint's sum in float64, and the library is
  built with -fmad=false.
- Plain version against the numpy chain: alpha, the radii, and every
  channel that neither a desaturation (saturation or selection) nor the
  secondary-structure blend computes are bit-equal. Those two are within
  1e-6: numpy's float32 matrix products, `(N, 3) @ (3,)` for the luminance
  and `(nbb, 3) @ (3, 4)` for the blend, do not sum in sequential order
  (about 15% of luminances differ from (r·w0 + g·w1) + b·w2 in the last
  bit), where the kernel and its plain version do.
"""

import numpy as np
import pytest
import torch

from viamd_tpu_torch.app import Session
from viamd_tpu_torch.app.events import EventType
from viamd_tpu_torch.core.bitfield import Bitfield
from viamd_tpu_torch.render import color as color_mod
from viamd_tpu_torch.render import cuda_colors
from viamd_tpu_torch.render.backbone_rep import current_ss_weights

MAPPINGS = [*color_mod.COLOR_MAPPINGS, "uniform", "secondary_structure", "property"]
SEED = 2**31 + 1103


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def demo():
    """A CPU session over the 16-residue demo helix, its script evaluated
    (a per-structure property `a1`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    s = Session(num_workers=1, device="cpu")
    s.load_demo(n_res=16, n_frames=6)
    s.evaluate().force()
    yield s
    s.shutdown()
    torch.set_num_threads(n)


@pytest.fixture
def sess(demo):
    """The demo session with one default representation and no selection,
    at frame 0."""
    demo.representations.clear()
    demo.add_representation()
    demo.selection = Bitfield(demo.system.natoms)
    demo.set_frame(0.0)
    return demo


def numpy_chain(s, rep, ss_w, show_selection) -> np.ndarray:
    """Session._rep_colors as it ran on the host: render/color.py's numpy
    functions over every atom."""
    sys = s.system
    mapping = color_mod.COLOR_MAPPINGS.get(rep.color_mapping)
    if rep.color_mapping == "secondary_structure" and ss_w is not None:
        cols = color_mod.color_atoms_secondary_structure(sys, ss_w)
    elif rep.color_mapping == "property":
        cols = s._property_colors(rep)[1]()
    elif mapping:
        cols = mapping(sys)
    else:
        cols = color_mod.color_atoms_uniform(sys, rep.uniform_color)
    if rep.tint_scale > 0.0 or rep.saturation < 1.0:
        every = np.ones(sys.natoms, bool)
        if rep.tint_scale > 0.0:
            cols = color_mod.tint_colors(cols, every, rep.tint_color, rep.tint_scale)
        if rep.saturation < 1.0:
            cols = color_mod.desaturate_colors(cols, every, 1.0 - rep.saturation)
    if rep.mask is not None:
        cols = color_mod.filter_colors(cols, rep.mask)
    if show_selection and s.selection and s.selection.popcount():
        cols = color_mod.desaturate_colors(cols, ~s.selection)
    return cols


def hold(got: torch.Tensor, want: np.ndarray, loose: np.ndarray) -> None:
    """Alpha bit-equal; rgb bit-equal outside the `loose` atoms, within
    1e-6 in them (module docstring)."""
    got = got.cpu().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.array_equal(got[:, 3], want[:, 3])
    assert np.array_equal(got[~loose, :3], want[~loose, :3])
    assert np.abs(got[loose, :3] - want[loose, :3]).max(initial=0.0) <= 1e-6


def loose_atoms(s, rep, show_selection) -> np.ndarray:
    """The atoms whose rgb a desaturation or the SS blend computes."""
    n = s.system.natoms
    if rep.saturation < 1.0:
        return np.ones(n, bool)
    out = np.zeros(n, bool)
    if rep.color_mapping == "secondary_structure":
        out |= cuda_colors.backbone_residues(s.system) >= 0
    if show_selection and s.selection and s.selection.popcount():
        out |= ~s.selection.to_bools()
    return out


@pytest.mark.parametrize("styled", [False, True], ids=["bare", "styled"])
@pytest.mark.parametrize("mapping", MAPPINGS)
def test_plain_matches_numpy_chain(sess, mapping, styled):
    """Every mapping, bare and with tint, saturation, a filter and a
    selection: all atoms, the radii, and the CA subset."""
    s = sess
    rep = s.representations[0]
    rep.color_mapping, rep.prop = mapping, "a1"
    s.set_frame(2.5)
    if styled:
        rep.tint_color, rep.tint_scale, rep.saturation = (1.0, 0.5, 0.2, 1.0), 0.3, 0.6
        rep.filter = "residue(2:12)"
        s._update_representations()
        s.select("residue(1:4)")
    ss_t = current_ss_weights(s.system, s.device_coords(), device="cpu")
    cols, radii = s._rep_colors(rep, ss_t, True, radii=True)
    want = numpy_chain(s, rep, ss_t.numpy(), True)
    hold(cols, want, loose_atoms(s, rep, True))
    r_want = np.where(want[:, 3] > 0, s.system.radius, 0.0).astype(np.float32)
    assert np.array_equal(radii.numpy(), r_want)
    ca = s._ribbon_tables().atoms[0]
    sub, none = s._rep_colors(rep, ss_t, True, subset=ca)
    assert none is None and torch.equal(sub, cols[ca.long()])


def test_tint_alone_bit_equal(sess):
    """The tint adds numpy's float64 product to a float32 one: bit-equal,
    with no tolerance at all."""
    rep = sess.representations[0]
    rep.tint_color, rep.tint_scale = (0.9, 0.1, 0.33, 1.0), 0.45
    cols, _ = sess._rep_colors(rep, None, True)
    want = numpy_chain(sess, rep, None, True)
    assert np.array_equal(cols.numpy(), want)


def test_empty_selection(sess):
    """An empty selection, or none, desaturates nothing."""
    rep = sess.representations[0]
    want = numpy_chain(sess, rep, None, True)
    for sel in (Bitfield(sess.system.natoms), None):
        sess.selection = sel
        cols, _ = sess._rep_colors(rep, None, True)
        assert np.array_equal(cols.numpy(), want)
    sess.select("residue(1:4)")
    cols, _ = sess._rep_colors(rep, None, False)  # selection visuals off
    assert np.array_equal(cols.numpy(), want)


def test_dynamic_filter(sess):
    """A dynamic filter's mask follows the frame: the colours equal the
    numpy chain's at every frame, and its words are uploaded when the mask
    changes, not otherwise."""
    s = sess
    rep = s.representations[0]
    rep.filter = "within(4.0, residue(1)) and element('C')"
    s._update_representations()
    assert rep.dynamic
    s.select("residue(3:6)")
    s.render(24, 16)  # the first frame uploads every table
    masks = [rep.mask]
    for t in (0.0, 1.0, 2.75, 4.5):
        s.set_frame(t)
        n0 = cuda_colors.uploads
        s.render(24, 16)
        changed = rep.mask != masks[-1]
        assert cuda_colors.uploads - n0 == int(changed), t
        masks.append(rep.mask)
        cols, _ = s._rep_colors(rep, None, True)
        hold(cols, numpy_chain(s, rep, None, True), loose_atoms(s, rep, True))
    assert len({m.hash64() for m in masks}) > 1


def _uploads(s, **kw) -> int:
    n0 = cuda_colors.uploads
    s.render(24, 16, **kw)
    return cuda_colors.uploads - n0


@pytest.mark.parametrize("rep_type", ["spacefill", "cartoon"])
def test_state_uploads(sess, rep_type):
    """The tables are uploaded once: 0 uploads over frames where only the
    frame and the camera change; one after a change of the selection, of
    the filter or of the mapping; the mapping's table and the radii (for
    a raster rep) after a change of system."""
    from viamd_tpu_torch.render.camera import compute_optimal_view

    s = sess
    rep = s.representations[0]
    rep.type = rep_type
    rep.color_mapping = "secondary_structure" if rep_type == "cartoon" else "cpk"
    s.select("residue(1:4)")
    s.render(24, 16)
    lo, hi = s.system.aabb()
    for k, t in enumerate((0.5, 1.0, 3.25)):
        s.set_frame(t)
        s.camera = compute_optimal_view(lo - k, hi + 2 * k)
        assert _uploads(s) == 0
    s.select("residue(2:5)")
    assert _uploads(s) == 1
    rep.filter = "residue(1:10)"
    s._update_representations()
    assert _uploads(s) == 1
    rep.color_mapping = "chain"
    assert _uploads(s) == 1
    assert _uploads(s) == 0
    s.events.broadcast(EventType.SYSTEM_INIT, s)  # the system changed in place
    assert _uploads(s) == (2 if rep_type == "spacefill" else 1)
    assert _uploads(s, show_selection=False) == 0


def test_each_representation_its_state(sess):
    """Each representation holds its own colour state, made on its first
    frame."""
    s = sess
    a = s.representations[0]
    b = s.add_representation(type="licorice", color_mapping="residue_index")
    assert a.colors is None and b.colors is None
    s.render(24, 16)
    assert isinstance(a.colors, cuda_colors.ColorState) and b.colors is not a.colors
    held = b.colors
    assert _uploads(s) == 0 and b.colors is held


def _inputs(n=200, nbb=12, device="cpu", seed=3):
    """Random inputs of every kind for n atoms."""
    g = np.random.default_rng(seed)
    base = g.random((n, 4), dtype=np.float32)
    base[::7, 3] = 0.0
    ss = g.random((nbb, 3), dtype=np.float32)
    bbres = np.where(g.random(n) < 0.6, g.integers(0, nbb, n), -1).astype(np.int32)
    mask = Bitfield.from_bools(g.random(n) < 0.7)
    sel = Bitfield.from_bools(g.random(n) < 0.3)
    subset = g.permutation(n)[: n // 3].astype(np.int32)
    radius = g.random(n, dtype=np.float32) + 1.0
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return dict(base=t(base), ss=t(ss), bbres=t(bbres), mask=t(cuda_colors.words(mask)),
                selection=t(cuda_colors.words(sel)), subset=t(subset), radius=t(radius))


def _args(x, table: bool, **drop):
    keys = ("base", "ss", "bbres", "mask", "selection", "subset", "radius")
    out = [None if drop.get(k) else x[k] for k in keys]
    if table:
        out[1] = out[2] = None
    else:
        out[0] = None
    return out


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape", "words", "subset", "nothing"])
def test_wrapper_refuses(bad):
    """The kernel takes CUDA tensors of its dtypes and shapes, and refuses
    anything else before a launch."""
    x = _inputs()
    if bad == "dtype":
        x["base"] = x["base"].double()
    elif bad == "shape":
        x["base"] = x["base"][:, :3].contiguous()
    elif bad == "words":
        x["mask"] = x["mask"][:-1].contiguous()
    elif bad == "subset":
        x["subset"] = x["subset"].long()
    args = _args(x, table=True)
    if bad == "nothing":
        args = [None, None, *args[2:]]
    err = TypeError if bad in ("dtype", "subset") else ValueError
    n0 = cuda_colors.launches
    with pytest.raises(err):
        cuda_colors.colors(*args)
    assert cuda_colors.launches == n0


def test_route_by_device():
    """atom_colors takes the plain version for CPU tensors, on every input
    combination the kernel takes."""
    x = _inputs()
    for table in (True, False):
        for drop in ({}, dict(mask=True, selection=True, subset=True, radius=True)):
            args = _args(x, table, **drop)
            got = cuda_colors.atom_colors(*args, tint=(0.2, 0.4, 0.6, 1.0), tint_scale=0.25,
                                          saturation=0.5)
            want = cuda_colors.colors_plain(*args, tint=(0.2, 0.4, 0.6, 1.0), tint_scale=0.25,
                                            saturation=0.5)
            assert torch.equal(got[0], want[0])
            assert (got[1] is None) == bool(drop) and (got[1] is None or torch.equal(got[1],
                                                                                   want[1]))


# -- on the card ---------------------------------------------------------------------------

STYLES = {
    "bare": {},
    "tint_saturation": dict(tint=(1.0, 0.5, 0.2, 1.0), tint_scale=0.3, saturation=0.6),
}


def _on_card(args, style):
    """The kernel, the plain version on the card and on the CPU: equal bit
    for bit; one launch."""
    n0 = cuda_colors.launches
    got = cuda_colors.atom_colors(*args, **style)
    assert cuda_colors.launches == n0 + 1
    want = cuda_colors.colors_plain(*args, **style)
    cpu = cuda_colors.colors_plain(*[None if a is None else a.cpu() for a in args], **style)
    for g, w, c in zip(got, want, cpu):
        assert (g is None) == (w is None) == (c is None)
        if g is not None:
            assert g.device.type == "cuda" and torch.equal(g, w) and torch.equal(g.cpu(), c)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("style", list(STYLES))
@pytest.mark.parametrize("table", [True, False], ids=["table", "ss"])
def test_kernel_matches_plain_random(cuda, table, style):
    x = _inputs(n=5_003, nbb=97, device=cuda)
    for drop in ({}, dict(subset=True), dict(mask=True, selection=True, radius=True)):
        _on_card(_args(x, table, **drop), STYLES[style])


@pytest.fixture(scope="module")
def capsid_inputs():
    """The stmv.cartoon deployment's system at SEED, its base frame's SS
    weights, and its filter (protein) and selection (chain 1's residues)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from portbench import capsid, run as R
    from viamd_tpu_torch.core.system import build_system, postprocess
    from viamd_tpu_torch.core.unitcell import UnitCell

    cfg = R.cell_files("stmv.cartoon")["config"]
    cap = capsid.capsid(cfg, SEED)
    sys_ = build_system(coords=cap.coords, atom_names=cap.atom_names, res_names=cap.res_names,
                        res_ids=cap.res_ids, chain_ids=cap.chain_ids, elements_z=cap.z,
                        cell=UnitCell.orthorhombic(cap.box, cap.box, cap.box))
    sys_.bonds = cap.bonds.copy()
    postprocess(sys_, infer_bonds=False)
    dev = torch.device("cuda")
    protein = Bitfield(sys_.natoms)
    protein.set_range(0, int(sys_.res_offsets[sys_.backbone.res_idx[-1] + 1]))
    chain1 = Bitfield(sys_.natoms)
    chain1.set_range(0, int(sys_.res_offsets[cfg["residues_per_chain"]]))
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return dict(
        base=t(color_mod.color_atoms_cpk(sys_)),
        ss=current_ss_weights(sys_, cap.coords, device=dev).contiguous(),
        bbres=t(cuda_colors.backbone_residues(sys_)), mask=t(cuda_colors.words(protein)),
        selection=t(cuda_colors.words(chain1)),
        subset=t(np.asarray(sys_.backbone.atom_ca, np.int32)),
        radius=t(np.asarray(sys_.radius, np.float32)), natoms=sys_.natoms,
    )


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["ss_all", "ss_ca", "cpk_all"])
def test_kernel_matches_plain_capsid(cuda, capsid_inputs, case):
    """The 1,066,628-atom capsid: its SS colours over every atom (filter,
    selection, radii), over the 9,540 CA atoms (the cartoon's launch),
    and its CPK colours."""
    x = capsid_inputs
    assert x["natoms"] == 1_066_628 and x["subset"].shape[0] == 9_540
    args = _args(x, table=case == "cpk_all", subset=case != "ss_ca",
                 radius=case == "ss_ca")
    _on_card(args, {})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("style", list(STYLES))
def test_kernel_matches_plain_water1m(cuda, style):
    """A 1,000,002-atom water box's CPK colours, its filter all, the
    first 2,000 waters selected, with the radii (water1m.view's launch)."""
    from viamd_tpu_torch.datagen import water_box

    sys_, _ = water_box(333_334, n_frames=1, seed=SEED % 2**31)
    every, sel = Bitfield(sys_.natoms), Bitfield(sys_.natoms)
    every.set_range(0, sys_.natoms)
    sel.set_range(0, 6_000)
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    args = [t(color_mod.color_atoms_cpk(sys_)), None, None, t(cuda_colors.words(every)),
            t(cuda_colors.words(sel)), None, t(np.asarray(sys_.radius, np.float32))]
    assert sys_.natoms == 1_000_002
    _on_card(args, STYLES[style])


@pytest.mark.requires_cuda
def test_session_one_launch_a_rep_no_uploads(cuda, monkeypatch):
    """A card session: one colours launch a representation a frame, 0
    uploads over frames where only the frame and the camera change, and
    its colours equal the plain version's on the same inputs, and the
    numpy chain's within the module's tolerance."""
    from viamd_tpu_torch.render.camera import compute_optimal_view

    s = Session(num_workers=1, device=cuda)
    try:
        s.load_demo(n_res=24, n_frames=8)
        s.representations[0].color_mapping = "residue_index"
        s.add_representation(type="cartoon", color_mapping="secondary_structure",
                             saturation=0.8)
        s.add_representation(type="licorice", filter="residue(1:6)", tint_scale=0.2)
        s.select("residue(3:9)")
        s.render(96, 64)
        lo, hi = s.system.aabb()
        n0, u0 = cuda_colors.launches, cuda_colors.uploads
        for k in range(4):
            s.set_frame(0.75 * k)
            s.camera = compute_optimal_view(lo - k, hi + k)
            s.render(96, 64)
        assert cuda_colors.launches - n0 == 4 * 3
        assert cuda_colors.uploads == u0
        ss_t = current_ss_weights(s.system, s.device_coords(), device=cuda)
        got = [s._rep_colors(r, ss_t, True, radii=True) for r in s.representations]
        monkeypatch.setattr(cuda_colors, "colors", cuda_colors.colors_plain)
        want = [s._rep_colors(r, ss_t, True, radii=True) for r in s.representations]
        for r, g, w in zip(s.representations, got, want):
            assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
            hold(g[0], numpy_chain(s, r, ss_t.cpu().numpy(), True), loose_atoms(s, r, True))
    finally:
        s.shutdown()
