"""ops/backbone.py of the port (φ/ψ, secondary structure, its temporal
denoise) and render/backbone_rep.py::current_ss_weights against viamd_tpu on
the CPU: the same seeded numpy inputs through both packages.

Tolerances. Angles: atol 1e-4 rad, as tests/test_torch_geometry.py holds
dihedrals (float32 min-image products and atan2 of sums the two frameworks
round apart). Secondary-structure weights from given angles: atol 1e-6
(float32 ellipse terms; the JAX CPU backend contracts a·b + c into FMAs);
from coordinates: atol 5e-4, the angle tolerance times the largest slope of
a zone weight, 2/50 per degree · 5.73e-3 degree. Denoise: exact, on
one-hot classifications, whose window sums are small integers.
"""

import numpy as np
import pytest
import torch

from tests._torch_parity import port_system
from tests.conftest import make_ala_pdb
from viamd_tpu_torch.ops import backbone as t_bb
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.render.backbone_rep import current_ss_weights

ANGLE_ATOL = 1e-4


def _wrapped_diff(a, b):
    """|a − b| on the circle (radians): ±π are the same angle."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


def _ala():
    from viamd_tpu.io.pdb import parse_pdb

    sys, _ = parse_pdb(make_ala_pdb(6))
    return sys, sys.coords()[None]


def _helix():
    from viamd_tpu.datagen import polyala_helix

    sys, traj = polyala_helix(24, n_frames=6, seed=2)
    return sys, traj.load_frames(range(6))[0]


def _triclinic_helix():
    """The helix's frames wrapped into a small triclinic cell, so bonds
    cross the boundary and the angles need the minimum image."""
    from viamd_tpu.core.unitcell import UnitCell

    sys, frames = _helix()
    basis = np.array([[14.0, 0, 0], [4.0, 13.0, 0], [-3.0, 2.0, 15.0]], np.float32)
    inv = np.linalg.inv(basis.astype(np.float64))
    f = frames.astype(np.float64) @ inv
    wrapped = ((f - np.floor(f)) @ basis).astype(np.float32)
    sys.cell = UnitCell.from_basis(basis)
    return sys, wrapped


@pytest.mark.parametrize("case", [_ala, _helix, _triclinic_helix])
def test_backbone_angles_match_jax(case):
    import jax.numpy as jnp

    from viamd_tpu.ops import backbone as j_bb
    from viamd_tpu.ops.pbc import inv_basis_of as j_inv

    sys, frames = case()
    bb = sys.backbone
    vp, vn = j_bb.make_backbone_validity(bb.ranges, bb.count)
    tvp, tvn = t_bb.make_backbone_validity(bb.ranges, bb.count)
    assert np.array_equal(vp, tvp) and np.array_equal(vn, tvn)
    basis = np.asarray(sys.cell.basis, np.float32)
    idx = (bb.atom_n, bb.atom_ca, bb.atom_c)
    jphi, jpsi = j_bb.backbone_angles_frames(
        jnp.asarray(frames), *(jnp.asarray(a) for a in idx), jnp.asarray(vp),
        jnp.asarray(vn), jnp.asarray(basis), j_inv(jnp.asarray(basis)),
    )
    tb = torch.as_tensor(basis)
    args = (*(torch.as_tensor(a) for a in idx), torch.as_tensor(vp), torch.as_tensor(vn))
    phi, psi = t_bb.backbone_angles_frames(torch.as_tensor(frames), *args, tb, inv_basis_of(tb))
    assert phi.shape == psi.shape == (frames.shape[0], bb.count)
    assert _wrapped_diff(phi.numpy(), jphi).max() <= ANGLE_ATOL
    assert _wrapped_diff(psi.numpy(), jpsi).max() <= ANGLE_ATOL
    # the chain ends: no previous residue → φ 0, no next → ψ 0 (exactly)
    for beg, end in bb.ranges:
        assert (phi[:, beg] == 0).all() and (psi[:, end - 1] == 0).all()
    # one frame without the batch dimension gives the batch's row (within
    # rounding: the batched min-image product is another matmul kernel)
    phi0, psi0 = t_bb.backbone_angles(torch.as_tensor(frames[0]), *args, tb, inv_basis_of(tb))
    assert _wrapped_diff(phi0.numpy(), phi[0].numpy()).max() <= 1e-6
    assert _wrapped_diff(psi0.numpy(), psi[0].numpy()).max() <= 1e-6


def test_secondary_structure_matches_jax():
    import jax.numpy as jnp

    from viamd_tpu.ops import backbone as j_bb

    rng = np.random.RandomState(4)
    deg = np.pi / 180
    # a grid over the whole plane (ψ's wrap at ±180 included), the zone
    # centres, and random angles
    g = np.arange(-180.0, 181.0, 7.5)
    phi = np.concatenate([np.repeat(g, g.size), [-80, -110, -60], rng.uniform(-180, 180, 500)])
    psi = np.concatenate([np.tile(g, g.size), [-40, 130, -45], rng.uniform(-180, 180, 500)])
    phi, psi = (phi * deg).astype(np.float32), (psi * deg).astype(np.float32)
    valid = rng.rand(phi.size) < 0.9
    want = np.asarray(j_bb.secondary_structure(jnp.asarray(phi), jnp.asarray(psi), jnp.asarray(valid)))
    got = t_bb.secondary_structure(torch.as_tensor(phi), torch.as_tensor(psi), torch.as_tensor(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert got[-503, 1] > 0.5 and got[-502, 2] > 0.5  # helix, sheet centres


@pytest.mark.parametrize("window", [3, 5])
def test_ss_denoise_is_exact(window):
    import jax.numpy as jnp

    from viamd_tpu.ops import backbone as j_bb

    rng = np.random.RandomState(5)
    F, nbb = 17, 9
    ss = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (F, nbb))]
    ss[:, 0] = [0, 1, 0]
    ss[8, 0] = [1, 0, 0]  # one flicker frame in an all-helix residue
    want = np.asarray(j_bb.ss_denoise_temporal(jnp.asarray(ss), window=window))
    got = t_bb.ss_denoise_temporal(torch.as_tensor(ss), window=window).numpy()
    assert got.shape == (F, nbb, 3)
    assert np.array_equal(got, want)
    assert got[8, 0, 1] > 0.5  # the majority restores the helix


@pytest.mark.parametrize("case", [_ala, _helix])
def test_current_ss_weights_match_jax(case):
    from viamd_tpu.render.backbone_rep import current_ss_weights as j_ss

    sys, frames = case()
    want = j_ss(sys, frames[0])
    got = current_ss_weights(port_system(sys), frames[0], device="cpu")
    assert isinstance(got, torch.Tensor) and got.shape == (sys.backbone.count, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)
