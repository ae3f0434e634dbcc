"""Multi-device histograms of the port (viamd_tpu_torch.parallel and the
sharded pair histograms) against the one-rank port and the JAX package.

Ranks are processes started by `parallel.launch.spawn` on the CPU (gloo,
world 2 and 4); what they run lives in `viamd_tpu_torch.parallel.programs`,
which imports no JAX. The JAX oracles run here, on conftest's 8 virtual
devices, as the JAX package's own tests run them. The JAX package is
imported inside the parity tests only, so the tests marked `requires_cuda`
collect on a machine that has a GPU but no JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_parallel.py

Tolerances: histograms are integer counts. A row partition of the cell
walk, and the slab-sharded histogram against the one-rank route: identical
(each candidate pair belongs to one A cell; int32 partials are summed).
Against the JAX package: the slab-sharded histogram identical to its
Pallas kernel's on this box, and the dense atom-sharded histogram within 1
count of JAX's (its `dist < edge` binning against the port's
int(dist · nbins / r_max)).
"""

import time

import numpy as np
import pytest
import torch

from viamd_tpu_torch.ops import cuda_rdf
from viamd_tpu_torch.ops.neighbors import choose_grid_r
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.parallel import programs
from viamd_tpu_torch.parallel.launch import RankError, spawn

RHOMBIC = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.5, 0.5, 0.5**0.5]])


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread here, as in the ranks: the walks are many small
    ops, and with the cores shared several threads an op only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(kind: str, device="cpu"):
    """(x, idx_a, idx_b (None: A against itself), basis, r_max, dims,
    fractional, radius) of a small periodic box."""
    rng = np.random.RandomState(7)
    if kind == "fractional":  # a rhombic dodecahedron of edge 24 Å
        basis = (RHOMBIC * 24.0).astype(np.float32)
        frac = rng.uniform(0, 1, (700, 3))
        x = (frac @ basis.astype(np.float64)).astype(np.float32)
        r_max, radius = 3.5, 1
    else:
        basis = np.diag([26.0, 23.0, 24.0]).astype(np.float32)
        x = rng.uniform(-1.0, 25.0, (700, 3)).astype(np.float32)
        r_max, radius = (4.0, 1) if kind != "radius2" else (9.0, 2)
    n = x.shape[0]
    if kind == "a!=b":
        ia, ib = np.arange(0, n, 2, dtype=np.int32), np.arange(1, n, 3, dtype=np.int32)
    else:
        ia, ib = np.arange(n, dtype=np.int32), None
    if kind == "fractional":
        widths = 1.0 / np.linalg.norm(np.linalg.inv(basis.astype(np.float64)), axis=0)
    else:
        widths = np.diag(basis).astype(np.float64)
    dims = choose_grid_r(widths, r_max / radius, ia.size, radius=1)[0]
    return x, ia, ib, basis, r_max, tuple(dims), kind == "fractional", radius


def _lists(x, ia, ib, basis, dims, fractional, device):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    b = t(basis)
    inv = inv_basis_of(b)
    a = cuda_rdf.cell_lists(t(x), t(ia), b, inv, dims, fractional)
    bl = a if ib is None else cuda_rdf.cell_lists(t(x), t(ib), b, inv, dims, fractional)
    return a, bl, b, inv


def _partitions(dx: int) -> list:
    """Even splits over 1-4 ranks, and an uneven one: one rank owns row 0,
    another the last row (a half-stencil slab edge that wraps)."""
    out = [[cuda_rdf.slab_rows(k, n, dx) for k in range(n)] for n in (1, 2, 3, 4)]
    out.append([(0, 1), (1, dx - 1), (dx - 1, dx)])
    return out


@pytest.mark.parametrize("kind", ["same", "a!=b", "radius2", "fractional"])
def test_row_partitions_sum_to_the_whole_walk(kind):
    x, ia, ib, basis, r_max, dims, frac, radius = _case(kind)
    assert min(dims) >= 2 * radius + 1 and dims[0] >= 4, dims
    a, b, bt, inv = _lists(x, ia, ib, basis, dims, frac, "cpu")
    args = (*a, *b, bt, inv, dims, 64, r_max, ib is None, radius)
    whole_work = {}
    whole = cuda_rdf.pair_hist_cells_plain(*args, work=whole_work)
    assert whole.sum() > 0
    # the walk equals the all-pairs specification
    ones = lambda i: torch.ones(len(i))  # noqa: E731
    ib_ = ia if ib is None else ib
    spec = cuda_rdf.pair_dist_histogram_scatter_idx(
        torch.as_tensor(x), torch.as_tensor(ia), torch.as_tensor(ib_), ones(ia), ones(ib_),
        bt, inv, 64, r_max)
    assert torch.equal(whole, spec)
    for part in _partitions(dims[0]):
        works = [{} for _ in part]
        parts = [cuda_rdf.pair_hist_cells_plain(*args, work=w, rows=rows)
                 for rows, w in zip(part, works)]
        assert torch.equal(torch.stack(parts).sum(0), whole), part
        assert sum(w["pairs"] for w in works) == whole_work["pairs"], part


def test_rows_are_checked():
    x, ia, ib, basis, r_max, dims, frac, radius = _case("same")
    a, b, bt, inv = _lists(x, ia, ib, basis, dims, frac, "cpu")
    for rows in ((-1, 2), (2, 1), (0, dims[0] + 1)):
        with pytest.raises(ValueError, match="rows"):
            cuda_rdf.pair_hist_cells_plain(*a, *b, bt, inv, dims, 64, r_max, True, rows=rows)
    empty = cuda_rdf.pair_hist_cells_plain(*a, *b, bt, inv, dims, 64, r_max, True, rows=(2, 2))
    assert empty.sum() == 0


def test_slab_rows_even_split():
    # the headline grid over 4 ranks, and the radius-2 grid (5 rows)
    assert [cuda_rdf.slab_rows(k, 4, 10) for k in range(4)] == [(0, 2), (2, 5), (5, 7), (7, 10)]
    assert [cuda_rdf.slab_rows(k, 4, 5) for k in range(4)] == [(0, 1), (1, 2), (2, 3), (3, 5)]


@pytest.fixture(scope="module")
def ops_on_ranks():
    """One launch of 4 CPU ranks: the slab-sharded histogram (2 and 4 ways,
    A against itself and A ≠ B, the JAX test's box cut to 400 atoms), the
    dense atom-sharded one (test_ops.py:1545's case) and the JAX modules
    each rank loaded."""
    rng = np.random.RandomState(11)
    L, n = 30.0, 400
    x = rng.uniform(0, L, (n, 3)).astype(np.float32)
    wb = rng.rand(n) < 0.5
    idx_a = np.arange(n, dtype=np.int32)
    idx_b = np.nonzero(wb)[0].astype(np.int32)
    basis = np.diag([L] * 3).astype(np.float32)
    dims = tuple(choose_grid_r(np.full(3, L), 4.0, n, radius=1)[0])
    rng2 = np.random.RandomState(11)
    L2, n2 = 20.0, 300
    x2 = rng2.uniform(0, L2, (n2, 3)).astype(np.float32)
    wa2 = (rng2.rand(n2) < 0.5).astype(np.float32)
    wb2 = (rng2.rand(n2) < 0.5).astype(np.float32)
    basis2 = np.diag([L2] * 3).astype(np.float32)
    t0 = time.perf_counter()
    out = spawn(programs.sequence, 4, "cpu",
                (programs.slab_histograms, (x, idx_a, None, basis, 128, 4.0, dims),
                 {"splits": (2, 4)}),
                (programs.slab_histograms, (x, idx_a, idx_b, basis, 128, 4.0, dims),
                 {"splits": (2, 4)}),
                (programs.dense_histogram, (x2, wa2, wb2, basis2, 16, 6.0), {}),
                (programs.reference_modules, (), {}),
                (programs.mesh_layout, (), {}),
                timeout=120)
    return dict(x=x, idx_a=idx_a, idx_b=idx_b, L=L, dims=dims, x2=x2, wa2=wa2, wb2=wb2,
                L2=L2, out=out, seconds=time.perf_counter() - t0)


def _assert_hist_close(got, want, per_bin):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.sum() == want.sum(), (got.sum(), want.sum())
    assert np.abs(got - want).max() <= per_bin, np.abs(got - want).max()
    assert want.sum() > 0


def test_slab_sharded_matches_one_rank_and_jax(ops_on_ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from viamd_tpu.ops import pallas_rdf

    c = ops_on_ranks
    x, dims, L = c["x"], c["dims"], c["L"]
    assert dims[0] % 4 != 0  # an uneven split: 7 rows over 4 ranks
    basis = torch.as_tensor(np.diag([L] * 3).astype(np.float32))
    inv = inv_basis_of(basis)
    mesh = Mesh(np.array(jax.devices()[:4]), ("atoms",))
    box = jnp.asarray(np.full(3, L, np.float32))
    for i, idx_b in ((0, None), (1, c["idx_b"])):
        ia = torch.as_tensor(c["idx_a"])
        ib = ia if idx_b is None else torch.as_tensor(idx_b)
        one = cuda_rdf.pair_dist_histogram_cl(torch.as_tensor(x), ia, ib, basis, inv, 128, 4.0,
                                              dims).numpy()
        for rank in c["out"]:
            for split in (2, 4):
                np.testing.assert_array_equal(rank[i][split], one)
        sym = idx_b is None
        jb = c["idx_a"] if sym else idx_b
        _, cap = choose_grid_r(np.full(3, L), 4.0, len(c["idx_a"]), radius=1)
        _, cap_b = choose_grid_r(np.full(3, L), 4.0, len(jb), radius=1)
        want = pallas_rdf.pair_dist_histogram_pl_sharded(
            jnp.asarray(x), jnp.asarray(c["idx_a"]), jnp.asarray(jb), box, 128, 4.0,
            dims, cap, cap_b, mesh, radius=1, symmetric=sym, interpret=True,
        )
        np.testing.assert_array_equal(one, np.asarray(want))


def test_atom_sharded_dense_matches_jax(ops_on_ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from viamd_tpu.ops import rdf as j_rdf
    from viamd_tpu.ops.pbc import inv_basis_of as j_inv

    c = ops_on_ranks
    basis = jnp.asarray(np.diag([c["L2"]] * 3).astype(np.float32))
    mesh = Mesh(np.array(jax.devices()), ("atoms",))
    want = np.asarray(j_rdf.pair_dist_histogram_atom_sharded(
        jnp.asarray(c["x2"]), jnp.asarray(c["wa2"]), jnp.asarray(c["wb2"]), basis,
        j_inv(basis), 16, 6.0, mesh, tile=64))
    got = [rank[2] for rank in c["out"]]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])  # every rank holds the sum
    _assert_hist_close(got[0], want, 1)


def test_ranks_import_no_jax(ops_on_ranks):
    assert [rank[3] for rank in ops_on_ranks["out"]] == [[]] * 4


def test_mesh_layout(ops_on_ranks):
    """Ranks row-major over the grid, as np.array(devs).reshape(n // atoms,
    atoms) lays out the JAX package's devices; a group per line; the
    even split of shard_batch; replicated = rank 0's; the JAX package's
    errors."""
    for rank, got in enumerate(r[4] for r in ops_on_ranks["out"]):
        f, a = divmod(rank, 2)
        assert got["shape"] == ({"frames": 4}, {"frames": 2, "atoms": 2})
        assert got["coords"] == ({"frames": rank}, {"frames": f, "atoms": a})
        assert got["lines"] == {"frames": [a, a + 2], "atoms": [2 * f, 2 * f + 1],
                                None: [0, 1, 2, 3]}
        assert got["shard"] == [[0, 1, 2, 3, 4] if f == 0 else [5, 6, 7, 8, 9],
                                [0, 1, 2, 3, 4] if a == 0 else [5, 6, 7, 8, 9]]
        assert got["replicated"] == [10, 10, 10]
        assert got["errors"][:2] == ["need 5 devices, have 4",
                                     "4 devices not divisible by atoms=3"]
        assert "declares 3 devices on axis 'atoms' but the mesh has 2" in got["errors"][2]


def test_backend_rule_and_no_cpu_fallback():
    from viamd_tpu_torch.parallel import mesh

    assert mesh.backend_for("cpu", 4) == "gloo"
    n = torch.cuda.device_count()
    assert mesh.backend_for("cuda", n + 1) == "gloo"  # ranks share a card
    if n:
        assert mesh.backend_for("cuda", n) == "nccl"
        assert mesh.rank_device(n + 1, "cuda") == torch.device("cuda", (n + 1) % n)
    else:  # no card: a CUDA rank raises, before any process starts
        with pytest.raises(RuntimeError, match="is_available"):
            mesh.rank_device(0, "cuda")
        with pytest.raises(RuntimeError, match="is_available"):
            spawn(programs.reference_modules, 2, "cuda", timeout=30)


def test_spawn_fails_when_a_rank_raises():
    t0 = time.perf_counter()
    with pytest.raises(RankError, match="rank 1 of 2 failed(.|\n)*fails on purpose"):
        spawn(programs.fail_on, 2, "cpu", 1, timeout=60)
    # rank 0 was left in a collective: it was ended, not waited for
    assert time.perf_counter() - t0 < 45


def test_spawn_fails_at_its_timeout():
    t0 = time.perf_counter()
    with pytest.raises(RankError, match="not done within 0.5 s"):
        spawn(programs.evaluate, 2, "cpu", programs.FLAGSHIP, 32, 64, 1, timeout=0.5)
    assert time.perf_counter() - t0 < 20


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["same", "a!=b", "radius2", "fractional"])
def test_row_partitions_on_the_card(kind, cuda):
    """The kernel with a row window equals the plain walk of those rows,
    and the partials of every partition sum to the whole kernel."""
    x, ia, ib, basis, r_max, dims, frac, radius = _case(kind)
    a, b, bt, inv = _lists(x, ia, ib, basis, dims, frac, cuda)
    args = (*a, *b, bt, inv, dims, 64, r_max, ib is None, radius)
    whole = cuda_rdf.pair_hist_cells(*args)
    for part in _partitions(dims[0]):
        parts = [cuda_rdf.pair_hist_cells(*args, rows=rows) for rows in part]
        for rows, got in zip(part, parts):
            torch.testing.assert_close(
                got, cuda_rdf.pair_hist_cells_plain(*args, rows=rows), rtol=0, atol=0)
        assert torch.equal(torch.stack(parts).sum(0), whole), part
