"""Slab-sharded lattice V-cycle (parallel/lattice_cycle.py) on the 8-device
virtual CPU mesh: halo-exchange smoothing, slab-aligned stride-k transfers,
coarse-grid agglomeration, and the PCG driver.

The reference has no distributed tier (survey §2.13); correctness target is
the single-device masked-multicolor device cycle (identical math, different
partitioning), per the survey's multi-chip test recipe (§4 end note).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
from algebraicmultigrid_tpu.parallel.lattice_cycle import (
    AXIS,
    build_slab_hierarchy,
    cycle_lattice_sharded,
    matvec_lattice_sharded,
    place_slab_hierarchy,
    solve_lattice_sharded,
)

pytestmark = pytest.mark.multichip

# 144 keeps the 8-slab hierarchy's shape at 216: a sharded fine level, then
# the agglomeration seam to replicated levels
N = 144


@pytest.fixture(scope="module")
def ml():
    LP = amg.poisson((N, N), lattice=True)
    return amg.structured_smoothed_aggregation(
        LP, proxy=72, cut_rows=2000, min_proxy_dim=16,
        aggregate=amg.StructuredAggregation(box=3),
    )


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide the 8-device virtual mesh"
    return jax.sharding.Mesh(np.array(devs[:8]), (AXIS,))


@pytest.fixture(scope="module")
def h8(ml, mesh):
    return place_slab_hierarchy(build_slab_hierarchy(ml, 8), mesh)


def _grid(v, h):
    Wx, Wy = h.fine_dims
    Wxp, Wyp = h.fine_pdims
    g = np.zeros((Wxp, Wyp), np.float32)
    g[:Wx, :Wy] = np.asarray(v, np.float32).reshape(Wx, Wy)
    return jnp.asarray(g)


def test_builder_shards_fine_agglomerates_coarse(ml, h8):
    h = h8
    assert h.levels[0].sharded, "144-row fine level must shard over 8 slabs"
    assert not h.levels[-1].sharded, "coarse tail must be agglomerated"
    # slab alignment invariant: a sharded child's padded rows = parent's / k
    for a, b in zip(h.levels[:-1], h.levels[1:]):
        if b.sharded:
            assert b.pdims[0] == a.pdims[0] // a.k


def test_placed_hierarchy_spans_mesh(h8):
    # sharded levels hold one slab per device, replicated levels a copy on
    # every device of the mesh
    for lv in h8.levels:
        for arr in (lv.A, lv.dinv, lv.T, lv.S):
            assert len(arr.sharding.device_set) == 8
            n_shards = len({s.index for s in arr.addressable_shards})
            assert n_shards == (8 if lv.sharded else 1)


def test_sharded_matvec_matches_host(ml, mesh, h8):
    h = h8
    A = ml.levels[0].A
    n = A.shape[0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(matvec_lattice_sharded(h, _grid(x, h), mesh))
    Wx, Wy = h.fine_dims
    y_ref = (A @ x).reshape(Wx, Wy)
    err = np.abs(y[:Wx, :Wy] - y_ref).max() / max(np.abs(y_ref).max(), 1e-30)
    assert err < 1e-5, err


@pytest.mark.parametrize("cycle", [amg.V(), amg.W(), amg.F()])
def test_sharded_cycle_matches_single_device(ml, mesh, h8, cycle):
    """The slab-partitioned V/W/F cycle computes the same cycle as the
    single-device masked-multicolor engine (same color steps, same factored
    transfers, same multilevel.jl:200-212 recursion policy) — partitioning
    must not change the math."""
    from algebraicmultigrid_tpu.models.device import (
        _one_iteration,
        build_device_hierarchy,
    )

    h = h8
    hd = build_device_hierarchy(ml, dtype=jnp.float32)
    n = N * N
    rng = np.random.default_rng(1)
    b = rng.standard_normal(n).astype(np.float32)

    bg = _grid(b, h)
    xg = np.asarray(cycle_lattice_sharded(h, jnp.zeros_like(bg), bg, mesh, cycle))
    Wx, Wy = h.fine_dims
    x_slab = xg[:Wx, :Wy].reshape(n)

    bp = jnp.asarray(np.pad(b, (0, hd.fine_padded - n)))
    x_ref = np.asarray(
        _one_iteration(hd, cycle, jnp.zeros_like(bp), bp)
    )[:n]
    err = np.abs(x_slab - x_ref).max() / max(np.abs(x_ref).max(), 1e-30)
    assert err < 2e-4, err

    if isinstance(cycle, amg.V):
        # shard invariance (survey §5.2 debug contract): the n_sh = 1
        # hierarchy (no shard_map, no collectives) matches the 8-slab result
        # up to f32 reduction order — partitioning doesn't change the math
        h1 = build_slab_hierarchy(ml, 1)
        bg1 = _grid(b, h1)
        mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]), (AXIS,))
        x1 = np.asarray(cycle_lattice_sharded(h1, jnp.zeros_like(bg1), bg1, mesh1))
        err1 = np.abs(xg[:Wx, :Wy] - x1[:Wx, :Wy]).max() / max(np.abs(x1).max(), 1e-30)
        assert err1 < 2e-5, err1


def test_sharded_general_smoothers(mesh):
    """Jacobi pre + backward-SOR post — the full smoother protocol surface
    (smoother.jl:10-23,92-99,173-180) on the slab tier, checked against the
    single-device engine."""
    from algebraicmultigrid_tpu.models.device import (
        _one_iteration,
        build_device_hierarchy,
    )

    pre = amg.Jacobi(0.6, iter=2)
    post = amg.SOR(1.1, amg.BackwardSweep(), ordering="multicolor")
    LP = amg.poisson((N, N), lattice=True)
    ml2 = amg.structured_smoothed_aggregation(
        LP, proxy=72, cut_rows=2000, min_proxy_dim=16,
        aggregate=amg.StructuredAggregation(box=3),
        presmoother=pre, postsmoother=post,
    )
    h = build_slab_hierarchy(ml2, 8)
    hd = build_device_hierarchy(ml2, dtype=jnp.float32)
    n = N * N
    b = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    bg = _grid(b, h)
    xg = np.asarray(cycle_lattice_sharded(h, jnp.zeros_like(bg), bg, mesh))
    Wx, Wy = h.fine_dims
    bp = jnp.asarray(np.pad(b, (0, hd.fine_padded - n)))
    x_ref = np.asarray(_one_iteration(hd, amg.V(), jnp.zeros_like(bp), bp))[:n]
    err = np.abs(xg[:Wx, :Wy].reshape(n) - x_ref).max() / max(np.abs(x_ref).max(), 1e-30)
    assert err < 2e-4, err


def test_solve_lattice_sharded_converges(ml, mesh):
    A = ml.levels[0].A
    n = A.shape[0]
    b = A @ np.ones(n)
    x, iters, relres = solve_lattice_sharded(
        ml, b, mesh=mesh, tol=1e-6, maxiter=40, log=True
    )
    assert relres < 1e-6, (iters, relres)
    assert iters <= 25, iters  # reference-class SA-PCG iteration count
    err = np.linalg.norm(x - 1.0) / np.sqrt(n)
    assert err < 1e-4, err
