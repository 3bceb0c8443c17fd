"""Device operator formats on the CPU: every lowering ``lower_operator``
picks (lattice, strided-diagonal, block-Toeplitz, dense, ELL) against
scipy's SpMV, the precision of every f32 dot the solve path issues, and the
device cycle against the host tier (``models/multilevel.py``)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax.extend.core import ClosedJaxpr, Jaxpr

import algebraicmultigrid_tpu as amg
from algebraicmultigrid_tpu.models.device import (
    _one_iteration,
    _pcg_fused,
    build_device_hierarchy,
    lower_operator,
)
from algebraicmultigrid_tpu.models.multilevel import _cycle_host
from algebraicmultigrid_tpu.ops.banded import BTOp, DenseOp, SDIA, bt_from_csr, mat_vec
from algebraicmultigrid_tpu.ops.lattice_nd_op import LatND
from algebraicmultigrid_tpu.ops.lattice_op import Lat2D
from algebraicmultigrid_tpu.ops.sparse import ELL, bandwidth, rcm_permutation, round_up


def _scrambled(A, seed=0):
    A = sp.csr_matrix(A)
    p = np.random.default_rng(seed).permutation(A.shape[0])
    return A[p][:, p].tocsr()


def _elasticity_like():
    # 2 dofs per node on a 2-D grid: kron(poisson, 2x2 block) → 10 nnz/row
    base = sp.csr_matrix(amg.poisson((24, 24)))
    blk = np.array([[2.0, 0.3], [0.3, 1.5]])
    return _scrambled(sp.kron(base, blk).tocsr(), seed=9)


def _random_graph():
    # randlap-class: n=100 random sparse Laplacian
    M = sp.random(100, 100, density=0.06, random_state=np.random.RandomState(2))
    return sp.csgraph.laplacian(sp.csr_matrix(M + M.T)).tocsr()


def _rectangular_transfer():
    # transfer-operator-like: fine rows, coarse columns, banded slope 1/2
    nf, nco = 3000, 1500
    rng = np.random.default_rng(3)
    rows = np.repeat(np.arange(nf), 3)
    cols = np.clip(rows // 2 + rng.integers(-40, 41, rows.shape[0]), 0, nco - 1)
    P = sp.coo_matrix(
        (rng.standard_normal(rows.shape[0]), (rows, cols)), shape=(nf, nco)
    ).tocsr()
    P.sum_duplicates()
    return P


MATRICES = {
    "mesh2d_scrambled": lambda: _scrambled(amg.poisson((48, 48)), seed=2),
    "mesh3d_scrambled": lambda: _scrambled(amg.poisson((13, 11, 9)), seed=3),
    "mesh2d_rcm": lambda: (lambda A: A[rcm_permutation(A)][:, rcm_permutation(A)].tocsr())(
        _scrambled(amg.poisson((48, 48)), seed=2)
    ),
    "elasticity_like": _elasticity_like,
    "random_graph": _random_graph,
    "rectangular_transfer": _rectangular_transfer,
}


def _padded(x, rows):
    """x zero-padded along its row axis to a multiple of 8, as the cycle
    keeps level vectors."""
    out = np.zeros((round_up(rows, 8),) + x.shape[1:], x.dtype)
    out[:rows] = x
    return jnp.asarray(out)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("force_ell", [False, True])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_lowered_spmv_matches_scipy(name, force_ell, dtype):
    A = MATRICES[name]()
    op = lower_operator(A, dtype, force_ell=force_ell)
    if force_ell:
        assert isinstance(op, ELL)
    assert op.dtype == dtype
    x = np.random.default_rng(0).standard_normal(A.shape[1]).astype(dtype)
    y = np.asarray(jax.jit(mat_vec)(op, _padded(x, A.shape[1])))[: A.shape[0]]
    ref = A @ x.astype(np.float64)
    tol = 1e-6 if dtype == np.float32 else 1e-14
    assert np.abs(y - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_lowered_spmv_multi_rhs(name):
    # a block of k right-hand sides equals k single applies
    A = MATRICES[name]()
    op = lower_operator(A, np.float32)
    X = _padded(np.random.default_rng(1).standard_normal((A.shape[1], 3)).astype(np.float32), A.shape[1])
    Y = np.asarray(mat_vec(op, X))
    for j in range(3):
        col = np.asarray(mat_vec(op, X[:, j]))
        np.testing.assert_allclose(Y[:, j], col, rtol=1e-6, atol=1e-6 * max(np.abs(col).max(), 1.0))


def test_rcm_basis_kept_only_when_it_halves_bandwidth():
    # natural-order meshes are already narrow: no permuted basis
    A = sp.csr_matrix(amg.poisson((64, 64)))
    assert 2 * bandwidth(A[rcm_permutation(A)][:, rcm_permutation(A)]) > bandwidth(A)
    ml = amg.smoothed_aggregation(A)
    h = build_device_hierarchy(ml, dtype=jnp.float32)
    assert h.perm0 is None


# ---------------------------------------------------------------- precision


def _dot_sites(jaxpr, out):
    """Every dot_general in a jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, ClosedJaxpr):
                    _dot_sites(sub.jaxpr, out)
                elif isinstance(sub, Jaxpr):
                    _dot_sites(sub, out)
    return out


def _unpinned_f32_dots(fn, *args):
    """f32 dot_generals without Precision.HIGHEST — on a GPU such a dot may
    run in TF32 (about three decimal digits)."""
    bad = []
    for eqn in _dot_sites(jax.make_jaxpr(fn)(*args).jaxpr, []):
        if not any(v.aval.dtype == jnp.float32 for v in eqn.invars):
            continue
        prec = eqn.params.get("precision")
        precs = prec if isinstance(prec, (tuple, list)) else (prec,)
        if not all(p == jax.lax.Precision.HIGHEST for p in precs):
            bad.append(str(eqn)[:120])
    return bad


def _bt_operator():
    # exact block-Toeplitz map: rows mT+r couple to columns (m+δ)C+c
    rng = np.random.default_rng(4)
    T, C, Mb = 4, 2, 32
    P = sp.lil_matrix((Mb * T, Mb * C))
    # f32-representable coefficients: the f32 operator then has no remainder
    blocks = {d: rng.standard_normal((T, C)).astype(np.float32) for d in (-1, 0, 1)}
    for m in range(Mb):
        for d, B in blocks.items():
            if 0 <= m + d < Mb:
                P[m * T : (m + 1) * T, (m + d) * C : (m + d + 1) * C] = B
    op = bt_from_csr(P.tocsr(), dtype=np.float32)
    assert isinstance(op, BTOp)
    return op


FORMATS = {
    "Lat2D": lambda: lower_operator(amg.poisson((24, 24), lattice=True), np.float32),
    "LatND": lambda: lower_operator(amg.poisson((8, 8, 8), lattice=True), np.float32),
    "SDIA": lambda: lower_operator(sp.csr_matrix(amg.poisson((24, 24))), np.float32),
    "BTOp": _bt_operator,
    "DenseOp": lambda: lower_operator(_random_graph(), np.float32),
    "ELL": lambda: lower_operator(_scrambled(amg.poisson((48, 48))), np.float32),
}
FORMAT_TYPES = {"Lat2D": Lat2D, "LatND": LatND, "SDIA": SDIA, "BTOp": BTOp, "DenseOp": DenseOp, "ELL": ELL}


@pytest.mark.parametrize("rhs", [1, 3])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_mat_vec_f32_dots_pinned(fmt, rhs):
    op = FORMATS[fmt]()
    assert isinstance(op, FORMAT_TYPES[fmt])
    n = round_up(op.shape[1], 8)
    x = jnp.zeros((n,) if rhs == 1 else (n, rhs), jnp.float32)
    assert _unpinned_f32_dots(mat_vec, op, x) == []


def _hierarchies():
    gs = amg.GaussSeidel(ordering="multicolor")
    LP = amg.poisson((48, 48), lattice=True)
    return {
        "structured_sa": amg.structured_smoothed_aggregation(
            LP, proxy=24, cut_rows=500, min_proxy_dim=9,
            aggregate=amg.StructuredAggregation(box=3),
        ),
        "ruge_stuben": amg.ruge_stuben(
            sp.csr_matrix(amg.poisson((32, 32))), presmoother=gs, postsmoother=gs
        ),
        "unstructured_sa": amg.smoothed_aggregation(_scrambled(amg.poisson((48, 48)))),
    }


@pytest.mark.parametrize("kind", ["structured_sa", "ruge_stuben", "unstructured_sa"])
def test_cycle_and_pcg_f32_dots_pinned(kind):
    ml = _hierarchies()[kind]
    h = build_device_hierarchy(ml, dtype=jnp.float32)
    b = jnp.zeros(h.fine_padded, jnp.float32)
    cyc = lambda h, b: _one_iteration(h, amg.V(), jnp.zeros_like(b), b)
    assert _unpinned_f32_dots(cyc, h, b) == []
    pcg = lambda h, b: _pcg_fused(h, b, 10, 0.0, amg.V())
    assert _unpinned_f32_dots(pcg, h, b) == []


# ------------------------------------------------- device cycle vs host tier


def _jacobi_hierarchy(kind):
    jac = amg.Jacobi()
    if kind == "structured_sa":
        return amg.structured_smoothed_aggregation(
            amg.poisson((48, 48), lattice=True), proxy=24, cut_rows=500,
            min_proxy_dim=9, aggregate=amg.StructuredAggregation(box=3),
            presmoother=jac, postsmoother=jac,
        )
    return amg.smoothed_aggregation(
        _scrambled(amg.poisson((40, 40))), presmoother=jac, postsmoother=jac
    )


@pytest.mark.parametrize("cycle", [amg.V(), amg.W(), amg.F()], ids=["V", "W", "F"])
@pytest.mark.parametrize("kind", ["structured_sa", "unstructured_sa"])
def test_jacobi_f64_cycle_matches_host(kind, cycle):
    """Jacobi is applied identically by both engines, so one f64 cycle of
    the device engine equals the host tier's up to summation order."""
    ml = _jacobi_hierarchy(kind)
    n = ml.levels[0].A.shape[0]
    b = np.random.default_rng(5).standard_normal(n)
    h = build_device_hierarchy(ml, dtype=jnp.float64)
    bq = b if h.perm0 is None else b[np.asarray(h.perm0)[:n]]
    bp = jnp.asarray(np.pad(bq, (0, h.fine_padded - n)))
    x_dev = np.asarray(_one_iteration(h, cycle, jnp.zeros_like(bp), bp))[:n]
    if h.iperm0 is not None:
        x_dev = x_dev[np.asarray(h.iperm0)[:n]]
    x_host = np.zeros(n)
    _cycle_host(ml, cycle, x_host, b, 0)
    err = np.abs(x_dev - x_host).max() / np.abs(x_host).max()
    assert err <= 1e-10, err
