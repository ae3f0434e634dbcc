"""The frozen input recipe: the same seed gives the same arrays, every seed
the same sizes, and seeds past 32 signed bits are taken."""

import numpy as np
import pytest
import torch

from portbench import inputs

SEEDS = (0, 7, 2**31 + 12345, 2**32 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(seed):
    a, fa = inputs.make(_cfg(), seed, "cpu")
    b, fb = inputs.make(_cfg(), seed, "cpu")
    assert np.array_equal(a.coords, b.coords) and torch.equal(fa, fb)
    assert np.array_equal(a.bonds, b.bonds) and np.array_equal(a.res_ids, b.res_ids)


def test_every_seed_same_sizes():
    shapes = set()
    for seed in SEEDS:
        wb, st = inputs.make(_cfg(), seed, "cpu")
        shapes.add((wb.n_atoms, wb.box, tuple(st.shape), int((wb.z == 8).sum())))
    assert len(shapes) == 1
    ((n, box, shape, n_o),) = shapes
    assert n == 3 * 500 and shape == (4, n, 3) and n_o == 500
    assert box == pytest.approx((n / 0.1) ** (1 / 3))


def test_seeds_differ():
    a = inputs.make(_cfg(), 1, "cpu")
    b = inputs.make(_cfg(), 2, "cpu")
    assert not np.array_equal(a[0].coords, b[0].coords)
    assert not torch.equal(a[1], b[1])


def test_frames_are_the_base_plus_jitter():
    wb, st = inputs.make(_cfg(), 5, "cpu")
    d = st - torch.as_tensor(wb.coords)
    assert float(d.std()) == pytest.approx(0.15, rel=0.05)
    assert float(d.mean().abs()) < 0.01


def test_water_geometry():
    wb = inputs.water_box(500, 0.1, 3)
    x = wb.coords.reshape(-1, 3, 3)
    oh = np.linalg.norm(x[:, 1:] - x[:, :1], axis=-1)
    assert np.allclose(oh[:, 0], 0.9572, atol=1e-5)
    assert np.allclose(oh[:, 1], np.hypot(0.24, 0.9266), atol=1e-5)
    assert (wb.z.reshape(-1, 3) == [8, 1, 1]).all()


def _cfg():
    return {"n_waters": 500, "density_atoms_per_A3": 0.1, "n_frames": 4, "jitter_A": 0.15}
