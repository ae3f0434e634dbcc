"""The protein views' host geometry and colours: render/color.py,
render/ribbon_mesh.py and render/backbone_rep.py::backbone_tube of the port
(numpy copies) against viamd_tpu, on the same inputs.

Tolerance: none. Each is a copy of host numpy code, so every colour,
triangle vertex, radius and source id must be bit-equal.
"""

import numpy as np
import pytest

from tests._torch_parity import port_system
from tests.conftest import make_ala_pdb
from viamd_tpu_torch.core.bitfield import Bitfield as TBitfield
from viamd_tpu_torch.render import color as t_color
from viamd_tpu_torch.render.backbone_rep import backbone_tube
from viamd_tpu_torch.render.ribbon_mesh import ribbon_mesh


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


def _ala(n_res=8):
    from viamd_tpu.io.pdb import parse_pdb

    sys, _ = parse_pdb(make_ala_pdb(n_res))
    return sys


def _chains(n_chains=3, n_res=9, seed=4):
    """n_chains copies of a jittered poly-alanine helix side by side, one
    chain each (three backbone ranges), through the JAX package's
    build_system and postprocess."""
    from viamd_tpu.core.system import build_system, postprocess
    from viamd_tpu.core.unitcell import UnitCell
    from viamd_tpu.datagen import polyala_helix

    one, traj = polyala_helix(n_res, n_frames=n_chains, seed=seed)
    frames = traj.load_frames(range(n_chains))[0]
    k = one.natoms
    names = [one.atom_names[i] for i in one.atom_name_id]
    return postprocess(build_system(
        coords=np.concatenate([frames[c] + [12.0 * c, 0, 0] for c in range(n_chains)]),
        atom_names=names * n_chains,
        res_names=["ALA"] * (k * n_chains),
        res_ids=np.tile(np.asarray(one.res_id)[one.atom_res_idx], n_chains),
        chain_ids=[chr(65 + c) for c in range(n_chains) for _ in range(k)],
        elements_z=np.tile(one.element, n_chains),
        cell=UnitCell.none(),
    ))


def _ss(nbb, pattern):
    """(nbb, 3) one-hot (coil, helix, sheet) weights from a string of
    c / h / s, repeated."""
    w = np.zeros((nbb, 3), np.float32)
    for i in range(nbb):
        w[i, "chs".index(pattern[i % len(pattern)])] = 1.0
    return w


# -- colours ---------------------------------------------------------------------


def test_conversions_match_jax():
    from viamd_tpu.render import color as j_color

    rng = np.random.RandomState(0)
    rgb = rng.rand(64, 3)
    rgb[0] = [0.5, 0.5, 0.5]  # grey: no hue
    rgb[1] = [0.0, 0.0, 0.0]
    rgb[2] = [1.0, 0.0, 0.0]
    h, s, v = rng.rand(3, 64)
    _equal(t_color.hsv_to_rgb(h, s, v), j_color.hsv_to_rgb(h, s, v))
    _equal(t_color.rgb_to_hsv(rgb), j_color.rgb_to_hsv(rgb))
    for name in ("_srgb_to_linear", "_linear_to_srgb", "rgb_to_oklab"):
        _equal(getattr(t_color, name)(rgb), getattr(j_color, name)(rgb))
    lab = j_color.rgb_to_oklab(rgb)
    _equal(t_color.oklab_to_rgb(lab), j_color.oklab_to_rgb(lab))
    t = rng.rand(64, 1)
    _equal(t_color.oklab_mix(rgb, rgb[::-1], t), j_color.oklab_mix(rgb, rgb[::-1], t))
    rgba = np.concatenate([rgb, rng.rand(64, 1)], 1).astype(np.float32)
    rgba[3] = [1.2, -0.1, 0.5, 1.0]  # clipped
    _equal(t_color.pack_u32(rgba), j_color.pack_u32(rgba))
    packed = j_color.pack_u32(rgba)
    _equal(t_color.unpack_u32(packed), j_color.unpack_u32(packed))
    _equal(t_color._hash_color(np.arange(40)), j_color._hash_color(np.arange(40)))
    _equal(t_color.SS_COLORS, j_color.SS_COLORS)
    assert t_color.COLOR_MAPPINGS.keys() == j_color.COLOR_MAPPINGS.keys()


@pytest.mark.parametrize("system", ["ala", "chains"])
def test_atom_colourings_match_jax(system):
    from viamd_tpu.core.bitfield import Bitfield as JBitfield
    from viamd_tpu.render import color as j_color

    jsys = _ala() if system == "ala" else _chains()
    tsys = port_system(jsys)
    n = jsys.natoms
    for name, fn in j_color.COLOR_MAPPINGS.items():
        _equal(t_color.COLOR_MAPPINGS[name](tsys), fn(jsys))
    _equal(t_color.color_atoms_uniform(tsys, (0.1, 0.2, 0.3, 0.4)),
           j_color.color_atoms_uniform(jsys, (0.1, 0.2, 0.3, 0.4)))
    nbb = jsys.backbone.count
    rng = np.random.RandomState(1)
    ss = rng.dirichlet(np.ones(3), nbb).astype(np.float32)
    _equal(t_color.color_atoms_secondary_structure(tsys, ss),
           j_color.color_atoms_secondary_structure(jsys, ss))
    # property colouring: one value for every atom, and one per structure
    structs = [np.arange(i, min(i + 7, n)) for i in range(0, n, 7)]
    vals = rng.uniform(-1, 3, len(structs))
    base = j_color.color_atoms_chain(jsys)
    for args, kw in (((2.5, (0.0, 4.0)), {}), ((vals, (-1.0, 3.0), "plasma", structs), {}),
                     ((vals, (2.0, 2.0)), {"base": base}), ((np.zeros(0), (1.0, 2.0)), {})):
        _equal(t_color.color_atoms_property(tsys, *args, **kw),
               j_color.color_atoms_property(jsys, *args, **kw))
    # masked passes, with a bitfield and with a bool array
    cols = j_color.color_atoms_cpk(jsys)
    keep = rng.rand(n) < 0.6
    for tm, jm in ((TBitfield.from_bools(keep), JBitfield.from_bools(keep)), (keep, keep)):
        _equal(t_color.filter_colors(cols, tm), j_color.filter_colors(cols, jm))
        _equal(t_color.tint_colors(cols, tm, (1.0, 0.2, 0.1, 1.0), 0.3),
               j_color.tint_colors(cols, jm, (1.0, 0.2, 0.1, 1.0), 0.3))
        _equal(t_color.desaturate_colors(cols, tm), j_color.desaturate_colors(cols, jm))
        _equal(t_color.desaturate_colors(cols, ~TBitfield.from_bools(keep), 0.2),
               j_color.desaturate_colors(cols, ~JBitfield.from_bools(keep), 0.2))


# -- ribbon / cartoon meshes and the tube ------------------------------------------


@pytest.mark.parametrize(
    "system,pattern,kw",
    [
        ("ala", "ccchhhss", dict(cartoon=True)),  # the JAX test's styling
        ("ala", "ccchhhss", dict(cartoon=False)),  # ribbons
        ("ala", None, dict(cartoon=True)),  # no SS: coil everywhere
        ("chains", "cssscchhhss", dict(cartoon=True, subdiv=5, width_scale=1.3)),
        ("chains", "current", dict(cartoon=True)),
    ],
)
def test_ribbon_mesh_matches_jax(system, pattern, kw):
    from viamd_tpu.render.backbone_rep import current_ss_weights
    from viamd_tpu.render.ribbon_mesh import ribbon_mesh as j_ribbon

    jsys = _ala() if system == "ala" else _chains()
    tsys = port_system(jsys)
    coords = jsys.coords()
    nbb = jsys.backbone.count
    if pattern is None:
        ss = None
    elif pattern == "current":
        ss = current_ss_weights(jsys, coords)
    else:
        ss = _ss(nbb, pattern)
    tris, src = ribbon_mesh(tsys, coords, ss_weights=ss, **kw)
    jtris, jsrc = j_ribbon(jsys, coords, ss_weights=ss, **kw)
    _equal(tris, jtris)
    _equal(src, jsrc)
    assert tris.dtype == np.float32 and np.isfinite(tris).all() and len(tris) == len(src)


@pytest.mark.parametrize("system,kw", [
    ("ala", dict(subdiv=4)),
    ("chains", dict(subdiv=8, radius=0.5)),
    ("chains", dict(cartoon=True)),
])
def test_backbone_tube_matches_jax(system, kw):
    from viamd_tpu.render.backbone_rep import backbone_tube as j_tube

    jsys = _ala() if system == "ala" else _chains()
    tsys = port_system(jsys)
    coords = jsys.coords()
    if kw.get("cartoon"):
        kw = dict(kw, ss_weights=_ss(jsys.backbone.count, "chhsscc"))
    for got, want in zip(backbone_tube(tsys, coords, **kw), j_tube(jsys, coords, **kw)):
        _equal(got, want)
    pts = backbone_tube(tsys, coords, **kw)[0]
    # the spline passes near the first CA atom
    assert np.linalg.norm(pts[0] - coords[tsys.backbone.atom_ca[0]]) < 0.5
