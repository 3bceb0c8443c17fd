"""Device (JAX) solve engine — the accelerator hot path.

The reference's solve phase is scalar Julia loops over CSC
(``/root/reference/src/multilevel.jl:214-239``, ``src/smoother.jl:73-90``).
Here the entire cycle is a single jitted computation over a static pytree
hierarchy:

* every level's A/P/R is lowered to a static-shape device format (lattice
  planes, strided diagonals, block-Toeplitz, dense or padded ELL — see
  ``build_device_hierarchy``), shapes static under ``jit``;
* level vectors stay padded end-to-end (no dynamic slicing inside the cycle);
* smoothers are (a) weighted Jacobi, (b) **multicolor** GS/SOR — color-by-
  color batched row updates, a true Gauss-Seidel for the color-permuted
  ordering with no sequential recurrence (the data-parallel answer to
  survey §2.8's "hardest to vectorise" note), or (c) an exact natural-order ``lax.scan``
  recurrence for conformance with the reference's sweep semantics;
* the V/W/F recursion (multilevel.jl:200-212) unrolls at trace time over the
  static level list; the iteration loop is a ``lax.while_loop`` carrying the
  on-device residual norm — zero host↔device sync until convergence;
* the coarse solve is a replicated dense pinv-matmul / QR triangular solve
  (coarse_solver.jl:9-16,66-81 semantics, incl. the singular path).
"""

from __future__ import annotations

import dataclasses
import math
import os
from functools import partial
from typing import Any, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import (
    BackwardSweep,
    Cycle,
    F,
    ForwardSweep,
    GaussSeidel,
    Jacobi,
    SOR,
    SymmetricSweep,
    V,
    W,
)
from ..ops.banded import BTOp, DenseOp, SDIA, bt_from_csr, dense_from_csr, mat_vec, sdia_from_csr
from ..ops.coloring import graph_coloring
from ..ops.sparse import ELL, bandwidth, ell_from_csr, rcm_permutation, round_up
from ..ops.spmv import ell_spmv
from .coarse import Pinv, QRSolver
from .multilevel import MultiLevel

_HI = jax.lax.Precision.HIGHEST  # no TF32 in f32 dots


def as_csr_cached(M):
    import scipy.sparse as _sp

    return M.tocsr() if _sp.issparse(M) else M


__all__ = [
    "DeviceLevel",
    "DeviceHierarchy",
    "build_device_hierarchy",
    "lower_operator",
    "device_cycle_fn",
    "run_fixed_cycles",
    "solve_device",
    "cg_device",
    "solve_refined",
]


# --------------------------------------------------------------------------
# smoother caches
# --------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JacobiCache:
    """x ← x + ω·D⁻¹(b − Ax); zero-diag rows frozen (smoother.jl:101-171)."""

    dinv: jax.Array  # [rows_padded], 0 where diag == 0 (freeze)
    omega: float = dataclasses.field(metadata=dict(static=True))
    iter: int = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MulticolorCache:
    """Stacked per-color row blocks for parallel GS/SOR sweeps.

    Zero-diagonal rows are excluded from every color (frozen — the
    reference's ``ifelse(d == 0, x[i], …)`` skip).  ``rows`` is padded with
    an out-of-range sentinel; scatters use ``mode='drop'``.
    """

    rows: jax.Array  # i32[n_colors, cmax]
    data: jax.Array  # [n_colors, cmax, width] with diagonal slot zeroed
    cols: jax.Array  # i32[n_colors, cmax, width]
    dinv: jax.Array  # [n_colors, cmax]
    omega: float = dataclasses.field(metadata=dict(static=True))
    iter: int = dataclasses.field(metadata=dict(static=True))
    forward: bool = dataclasses.field(metadata=dict(static=True))
    backward: bool = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScanGSCache:
    """Exact natural-order GS/SOR recurrence via ``lax.scan`` (conformance
    path; sequential — not the hot path)."""

    diag: jax.Array  # [rows_padded]
    omega: float = dataclasses.field(metadata=dict(static=True))
    iter: int = dataclasses.field(metadata=dict(static=True))
    forward: bool = dataclasses.field(metadata=dict(static=True))
    backward: bool = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MaskedMulticolorCache:
    """Gather-free multicolor GS/SOR: per color, one full SpMV + masked
    blend.  Identical updates to the gather variant (same coloring), but
    every op is dense-regular — the pairing for the lattice, SDIA and dense
    operator formats.  Frozen (zero-diag) and padding rows carry color
    id = n_colors and are never selected."""

    color_of: jax.Array  # i32[rows_padded]
    dinv: jax.Array  # [rows_padded]
    n_colors: int = dataclasses.field(metadata=dict(static=True))
    omega: float = dataclasses.field(metadata=dict(static=True))
    iter: int = dataclasses.field(metadata=dict(static=True))
    forward: bool = dataclasses.field(metadata=dict(static=True))
    backward: bool = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceLevel:
    A: Any  # Lat2D | LatND | SDIA | BTOp | DenseOp | ELL
    P: Any
    R: Any
    pre: Any
    post: Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CoarseCache:
    """Dense replicated coarse solve operand(s)."""

    mat: jax.Array  # pinv matrix, or stacked QR as (Q, R) below
    qr_q: jax.Array
    qr_r: jax.Array
    kind: str = dataclasses.field(metadata=dict(static=True))  # 'pinv' | 'qr'
    n: int = dataclasses.field(metadata=dict(static=True))
    rows_padded: int = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceHierarchy:
    levels: Tuple[DeviceLevel, ...]
    coarse: CoarseCache
    final_A: ELL  # for the outer residual when the hierarchy is trivial
    # fine-level RCM basis (unstructured ELL levels): the cycle runs in the permuted
    # basis; solve entry applies perm0 to b and exit iperm0 to x (both are
    # padded-identity-extended int32 index vectors; None = natural order)
    perm0: Any = None
    iperm0: Any = None

    @property
    def n_fine(self) -> int:
        return self.levels[0].A.shape[0] if self.levels else self.coarse.n

    @property
    def fine_padded(self) -> int:
        return self.levels[0].A.rows_padded if self.levels else self.coarse.rows_padded


# --------------------------------------------------------------------------
# smoother application
# --------------------------------------------------------------------------


def fit_len(v: jax.Array, n: int) -> jax.Array:
    """Pad-or-slice the leading axis to exactly n (operator formats may
    produce different internal paddings)."""
    m = v.shape[0]
    if m == n:
        return v
    if m > n:
        return v[:n]
    pad = [(0, n - m)] + [(0, 0)] * (v.ndim - 1)
    return jnp.pad(v, pad)


def _smooth_jacobi(cache: JacobiCache, A, x, b):
    n = x.shape[0]
    for _ in range(cache.iter):
        r = b - fit_len(mat_vec(A, x), n)
        dinv = cache.dinv if x.ndim == 1 else cache.dinv[:, None]
        x = x + cache.omega * dinv * r
    return x


def _smooth_masked_multicolor(cache: MaskedMulticolorCache, A, x, b):
    n = x.shape[0]
    dinv = cache.dinv if x.ndim == 1 else cache.dinv[:, None]

    def color_step(c, x):
        r = b - fit_len(mat_vec(A, x), n)
        upd = x + cache.omega * dinv * r
        sel = cache.color_of == c
        if x.ndim > 1:
            sel = sel[:, None]
        return jnp.where(sel, upd, x)

    from ..ops.coloring import color_steps

    for c in color_steps(
        cache.n_colors, cache.iter, cache.forward, cache.backward, cache.omega
    ):
        x = color_step(c, x)
    return x


def _color_step(cache: MulticolorCache, c, x, b):
    rows = cache.rows[c]
    data = cache.data[c]
    cols = cache.cols[c]
    dinv = cache.dinv[c]
    xg = jnp.take(x, cols, axis=0)  # [cmax, width, ...]
    bc = jnp.take(b, rows, mode="clip", axis=0)
    xc = jnp.take(x, rows, mode="clip", axis=0)
    if x.ndim == 1:
        rsum = jnp.sum(data * xg, axis=1)
        upd = (1 - cache.omega) * xc + cache.omega * dinv * (bc - rsum)
    else:
        rsum = jnp.sum(data[:, :, None] * xg, axis=1)
        upd = (1 - cache.omega) * xc + cache.omega * dinv[:, None] * (bc - rsum)
    return x.at[rows].set(upd, mode="drop")


def _smooth_multicolor(cache: MulticolorCache, A: ELL, x, b):
    n_colors = cache.rows.shape[0]
    for _ in range(cache.iter):
        if cache.forward:
            x = jax.lax.fori_loop(
                0, n_colors, lambda c, xx: _color_step(cache, c, xx, b), x
            )
        if cache.backward:
            x = jax.lax.fori_loop(
                0,
                n_colors,
                lambda c, xx: _color_step(cache, n_colors - 1 - c, xx, b),
                x,
            )
    return x


def _scan_sweep(cache: ScanGSCache, A: ELL, x, b, reverse: bool):
    rows_padded = A.rows_padded
    w = cache.omega

    def body(x, i):
        data = A.data[i]
        cols = A.cols[i]
        d = cache.diag[i]
        xg = jnp.take(x, cols, axis=0)
        dd = data if x.ndim == 1 else data[:, None]
        rsum = jnp.sum(dd * xg, axis=0) - d * x[i]
        cand = (1 - w) * x[i] + w * (b[i] - rsum) / jnp.where(d == 0, 1, d)
        newval = jnp.where(d == 0, x[i], cand)
        return x.at[i].set(newval), None

    idx = jnp.arange(rows_padded)
    x, _ = jax.lax.scan(body, x, idx, reverse=reverse)
    return x


def _smooth_scan_gs(cache: ScanGSCache, A: ELL, x, b):
    for _ in range(cache.iter):
        if cache.forward:
            x = _scan_sweep(cache, A, x, b, reverse=False)
        if cache.backward:
            x = _scan_sweep(cache, A, x, b, reverse=True)
    return x


def _apply_smoother(cache, A, x, b):
    from ..ops.blockgs import BlockGSCache, smooth_blockgs

    if isinstance(cache, JacobiCache):
        return _smooth_jacobi(cache, A, x, b)
    if isinstance(cache, BlockGSCache):
        return smooth_blockgs(cache, A, x, b)
    if isinstance(cache, MaskedMulticolorCache):
        return _smooth_masked_multicolor(cache, A, x, b)
    if isinstance(cache, MulticolorCache):
        return _smooth_multicolor(cache, A, x, b)
    if isinstance(cache, ScanGSCache):
        return _smooth_scan_gs(cache, A, x, b)
    raise TypeError(f"unknown device smoother cache {type(cache)}")


# --------------------------------------------------------------------------
# building the device hierarchy
# --------------------------------------------------------------------------


def _build_smoother_cache(config, A_csr, A_dev, dtype, colors=None, sym=False):
    from .lattice import LatticeMatrix
    from .lattice_nd import LatticeMatrixND

    if isinstance(A_csr, LatticeMatrixND):
        cache = _build_lattice_nd_smoother_cache(config, A_csr, A_dev, dtype)
        if cache is not None:
            return cache
        A_csr = A_csr.tocsr()  # rare fallback: materialise
    if isinstance(A_csr, LatticeMatrix):
        cache = _build_lattice_smoother_cache(config, A_csr, A_dev, dtype)
        if cache is not None:
            return cache
        A_csr = A_csr.tocsr()  # rare fallback: materialise

    rows_padded = A_dev.rows_padded
    d = np.zeros(rows_padded, dtype=dtype)
    d[: A_csr.shape[0]] = A_csr.diagonal().astype(dtype)

    if isinstance(config, Jacobi):
        dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 0.0).astype(dtype)
        return JacobiCache(dinv=jnp.asarray(dinv), omega=float(config.omega), iter=config.iter)

    if isinstance(config, (GaussSeidel, SOR)):
        omega = float(config.omega) if isinstance(config, SOR) else 1.0
        fwd = isinstance(config.sweep, (ForwardSweep, SymmetricSweep))
        bwd = isinstance(config.sweep, (BackwardSweep, SymmetricSweep))
        if config.ordering == "multicolor":
            if isinstance(A_dev, ELL):
                return _build_multicolor_cache(A_csr, A_dev, dtype, omega, config.iter, fwd, bwd, sym=sym)
            return _build_masked_multicolor_cache(
                A_csr, rows_padded, dtype, omega, config.iter, fwd, bwd, colors, sym=sym
            )
        if not isinstance(A_dev, ELL):
            raise TypeError("natural-order GS requires the ELL device format")
        return ScanGSCache(
            diag=jnp.asarray(d), omega=omega, iter=config.iter, forward=fwd, backward=bwd
        )
    raise TypeError(f"unknown smoother config {config!r}")


def _build_lattice_nd_smoother_cache(config, A_lnd, A_dev, dtype):
    """O(boundary)-metadata smoother caches for N-D lattice levels:
    periodic torus coloring + host diagonal expansion (the N-D counterpart
    of :func:`_build_lattice_smoother_cache`; device-side expansion can
    follow if the O(n) upload shows up in profiles)."""
    from .lattice_nd import lattice_coloring_nd

    spec = A_lnd.spec
    rows_padded = A_dev.rows_padded
    n = A_lnd.shape[0]
    diag = spec.diagonal()
    active = diag != 0

    if isinstance(config, Jacobi):
        dv = np.zeros(rows_padded, dtype=dtype)
        dv[:n] = np.where(active, 1.0 / np.where(active, diag, 1), 0.0)
        return JacobiCache(dinv=jnp.asarray(dv), omega=float(config.omega), iter=config.iter)

    if isinstance(config, (GaussSeidel, SOR)) and config.ordering == "multicolor":
        got = lattice_coloring_nd(spec)
        if got is None:
            return None
        tab, n_colors = got
        reps = [-(-W // p) for W, p in zip(spec.row_dims, tab.shape)]
        colors = np.tile(tab, reps)[tuple(slice(0, W) for W in spec.row_dims)].ravel()
        omega = float(config.omega) if isinstance(config, SOR) else 1.0
        fwd = isinstance(config.sweep, (ForwardSweep, SymmetricSweep))
        bwd = isinstance(config.sweep, (BackwardSweep, SymmetricSweep))
        color_of = np.full(rows_padded, n_colors, dtype=np.int32)
        color_of[:n] = np.where(active, colors, n_colors)
        dinv = np.zeros(rows_padded, dtype=dtype)
        dinv[:n] = np.where(active, 1.0 / np.where(active, diag, 1), 0.0)
        return MaskedMulticolorCache(
            color_of=jnp.asarray(color_of),
            dinv=jnp.asarray(dinv),
            n_colors=n_colors,
            omega=omega,
            iter=config.iter,
            forward=fwd,
            backward=bwd,
        )
    return None


def _lattice_diag_plane(Td, cx, cy):
    """[Wx, Wy] diagonal plane from the diag-offset class table — one-hot
    matmuls at HIGHEST precision, exact selection (see
    ops/lattice_op.expand_planes_device)."""
    Ex = (cx[:, None] == jnp.arange(Td.shape[0], dtype=cx.dtype)).astype(Td.dtype)
    Ey = (cy[:, None] == jnp.arange(Td.shape[1], dtype=cy.dtype)).astype(Td.dtype)
    return jnp.einsum(
        "xc,cd,yd->xy", Ex, Td, Ey, precision=jax.lax.Precision.HIGHEST
    )


@partial(jax.jit, static_argnames=("rows_padded", "dtype_name"))
def _lattice_jacobi_dinv_jit(Td, cx, cy, *, rows_padded, dtype_name):
    dt = jnp.dtype(dtype_name)
    diag = _lattice_diag_plane(Td, cx, cy)
    dv = jnp.where(diag != 0, 1.0 / jnp.where(diag != 0, diag, 1.0), 0.0)
    dv = dv.astype(dt).ravel()
    return jnp.pad(dv, (0, rows_padded - dv.shape[0]))


@partial(jax.jit, static_argnames=("rows_padded", "n_colors", "dtype_name"))
def _lattice_masked_arrays_jit(Td, cx, cy, grid, *, rows_padded, n_colors, dtype_name):
    """color_of + dinv for a lattice level built ON DEVICE: uploads the tiny
    diag table, two O(W) class vectors and the (a, b) color tile instead of
    two O(n) host arrays."""
    dt = jnp.dtype(dtype_name)
    Wx, Wy = cx.shape[0], cy.shape[0]
    diag = _lattice_diag_plane(Td, cx, cy)
    a, b = grid.shape
    colors = jnp.tile(grid, (-(-Wx // a), -(-Wy // b)))[:Wx, :Wy]
    active = diag != 0
    dinv = jnp.where(active, 1.0 / jnp.where(active, diag, 1.0), 0.0).astype(dt).ravel()
    col = jnp.where(active, colors, n_colors).astype(jnp.int32).ravel()
    nn = Wx * Wy
    return (
        jnp.pad(col, (0, rows_padded - nn), constant_values=n_colors),
        jnp.pad(dinv, (0, rows_padded - nn)),
    )


def _build_lattice_smoother_cache(config, A_lat, A_dev, dtype):
    """O(boundary) smoother caches for lattice levels: periodic torus
    coloring + diagonal expansion, no O(nnz) graph analysis."""
    from .lattice import lattice_coloring

    spec = A_lat.spec
    rows_padded = A_dev.rows_padded
    n = A_lat.shape[0]
    host_expand = (
        np.dtype(spec.table.dtype).kind != "f"
        or os.environ.get("AMG_HOST_EXPAND") == "1"
    )

    def _diag_table():
        try:
            di = spec.offsets.index((0, 0))
        except ValueError:
            di = -1
        comp = np.float32 if jnp.dtype(dtype).itemsize <= 4 else np.dtype(dtype)
        if di >= 0:
            return di, np.asarray(spec.table[di], dtype=comp)
        return di, np.zeros(spec.table.shape[1:], dtype=comp)

    if isinstance(config, Jacobi):
        if host_expand:
            diag = spec.diagonal().astype(dtype)
            dv = np.zeros(rows_padded, dtype=dtype)
            dv[:n] = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1), 0.0)
            dinv = jnp.asarray(dv)
        else:
            cx, cy = spec.row_class_arrays()
            _, Td = _diag_table()
            dinv = _lattice_jacobi_dinv_jit(
                jnp.asarray(Td),
                jnp.asarray(cx.astype(np.int32)),
                jnp.asarray(cy.astype(np.int32)),
                rows_padded=rows_padded,
                dtype_name=jnp.dtype(dtype).name,
            )
        return JacobiCache(dinv=dinv, omega=float(config.omega), iter=config.iter)

    if isinstance(config, (GaussSeidel, SOR)) and config.ordering == "multicolor":
        got = lattice_coloring(spec)
        if got is None:
            return None
        grid, n_colors = got
        omega = float(config.omega) if isinstance(config, SOR) else 1.0
        fwd = isinstance(config.sweep, (ForwardSweep, SymmetricSweep))
        bwd = isinstance(config.sweep, (BackwardSweep, SymmetricSweep))

        if os.environ.get("AMG_BLOCK_GS") == "1":
            # Blocked grid-colored sweep: one matvec-equivalent of memory
            # traffic per sweep in theory, paid for with de-interleave
            # transposes.  Opt-in; not measured on a GPU.
            from ..ops.blockgs import build_blockgs_cache

            return build_blockgs_cache(
                spec, grid, n_colors, dtype, omega, config.iter, fwd, bwd
            )

        a, b = grid.shape
        Wx, Wy = spec.row_dims
        if host_expand:
            diag = spec.diagonal().astype(dtype)
            colors = grid[(np.arange(Wx) % a)[:, None], (np.arange(Wy) % b)[None, :]].ravel()
            color_of = np.full(rows_padded, n_colors, dtype=np.int32)
            active = diag != 0
            color_of[:n] = np.where(active, colors, n_colors)
            dinv = np.zeros(rows_padded, dtype=dtype)
            dinv[:n] = np.where(active, 1.0 / np.where(active, diag, 1), 0.0)
            col_dev, dinv_dev = jnp.asarray(color_of), jnp.asarray(dinv)
        else:
            cx, cy = spec.row_class_arrays()
            _, Td = _diag_table()
            col_dev, dinv_dev = _lattice_masked_arrays_jit(
                jnp.asarray(Td),
                jnp.asarray(cx.astype(np.int32)),
                jnp.asarray(cy.astype(np.int32)),
                jnp.asarray(np.asarray(grid, dtype=np.int32)),
                rows_padded=rows_padded,
                n_colors=n_colors,
                dtype_name=jnp.dtype(dtype).name,
            )
        return MaskedMulticolorCache(
            color_of=col_dev,
            dinv=dinv_dev,
            n_colors=n_colors,
            omega=omega,
            iter=config.iter,
            forward=fwd,
            backward=bwd,
        )
    return None  # natural-order GS etc. → materialise + generic cache


def _build_masked_multicolor_cache(A_csr, rows_padded, dtype, omega, iters, fwd, bwd, colors=None, sym=False):
    n = A_csr.shape[0]
    if colors is None:
        colors = graph_coloring(A_csr, assume_symmetric=sym)
    diag = A_csr.diagonal()
    n_colors = int(colors.max()) + 1 if n else 1
    color_of = np.full(rows_padded, n_colors, dtype=np.int32)
    active = diag != 0
    color_of[:n] = np.where(active, colors, n_colors)
    dinv = np.zeros(rows_padded, dtype=dtype)
    dinv[:n] = np.where(active, 1.0 / np.where(active, diag, 1), 0.0)
    return MaskedMulticolorCache(
        color_of=jnp.asarray(color_of),
        dinv=jnp.asarray(dinv),
        n_colors=n_colors,
        omega=omega,
        iter=iters,
        forward=fwd,
        backward=bwd,
    )


def _build_multicolor_cache(A_csr, A_ell: ELL, dtype, omega, iters, fwd, bwd, sym=False):
    n = A_csr.shape[0]
    colors = graph_coloring(A_csr, assume_symmetric=sym)
    diag = A_csr.diagonal()
    active = diag != 0  # zero-diag rows frozen
    n_colors = int(colors.max()) + 1 if n else 1

    groups = [np.flatnonzero((colors == c) & active) for c in range(n_colors)]
    groups = [g for g in groups if g.size > 0] or [np.zeros(0, dtype=np.int64)]
    n_colors = len(groups)
    cmax = max(max(g.size for g in groups), 1)
    width = A_ell.width
    sentinel = A_ell.rows_padded  # out of range → dropped scatters

    rows = np.full((n_colors, cmax), sentinel, dtype=np.int32)
    data = np.zeros((n_colors, cmax, width), dtype=dtype)
    cols = np.zeros((n_colors, cmax, width), dtype=np.int32)
    dinv = np.zeros((n_colors, cmax), dtype=dtype)

    h_data = np.asarray(A_ell.data)
    h_cols = np.asarray(A_ell.cols)
    for c, g in enumerate(groups):
        rows[c, : g.size] = g
        dd = h_data[g].astype(dtype).copy()
        cc = h_cols[g]
        dd[cc == g[:, None]] = 0  # zero the diagonal slots → rsum is off-diag
        data[c, : g.size] = dd
        cols[c, : g.size] = cc
        dinv[c, : g.size] = 1.0 / diag[g]

    return MulticolorCache(
        rows=jnp.asarray(rows),
        data=jnp.asarray(data),
        cols=jnp.asarray(cols),
        dinv=jnp.asarray(dinv),
        omega=omega,
        iter=iters,
        forward=fwd,
        backward=bwd,
    )


def _build_coarse_cache(ml: MultiLevel, dtype, rows_padded: int) -> CoarseCache:
    cs = ml.coarse_solver
    n = ml.final_A.shape[0]
    zero = jnp.zeros((0, 0), dtype=dtype)
    if isinstance(cs, QRSolver) and not cs._singular and cs.Q is not None:
        return CoarseCache(
            mat=zero,
            qr_q=jnp.asarray(cs.Q.astype(dtype)),
            qr_r=jnp.asarray(cs.R.astype(dtype)),
            kind="qr",
            n=n,
            rows_padded=rows_padded,
        )
    pinvA = cs.pinvA if getattr(cs, "pinvA", None) is not None else np.linalg.pinv(
        ml.final_A.toarray()
    )
    return CoarseCache(
        mat=jnp.asarray(pinvA.astype(dtype)),
        qr_q=zero,
        qr_r=zero,
        kind="pinv",
        n=n,
        rows_padded=rows_padded,
    )


def lower_operator(M, dtype, row_pad: int = 8, dense_threshold: int = 2048, force_ell: bool = False):
    """Lower one host operator to a device format: Lat2D/LatND (lattice
    levels) → SDIA (gather-free strided bands) → block-Toeplitz → Dense
    (small, one matmul) → ELL (gather)."""
    from .lattice import LatticeMatrix
    from .lattice_nd import LatticeMatrixND
    from ..ops.lattice_op import lat2d_from_spec
    from ..ops.lattice_nd_op import latnd_from_spec

    if isinstance(M, LatticeMatrixND):
        if force_ell:
            M = M.tocsr()
        else:
            return latnd_from_spec(M.spec, dtype=dtype, row_pad=row_pad)
    if isinstance(M, LatticeMatrix):
        if force_ell:
            M = M.tocsr()
        else:
            return lat2d_from_spec(M.spec, dtype=dtype, row_pad=row_pad)
    if not force_ell:
        # smaller levels tolerate wider diagonal sets (padding overhead
        # is bounded separately by max_overhead)
        mo = 40 if max(M.shape) > 100_000 else 96
        S = sdia_from_csr(M, dtype=dtype, row_pad=row_pad, max_offsets=mo, max_overhead=8.0)
        if S is not None:
            return S
        B = bt_from_csr(M, dtype=dtype, row_pad=row_pad)
        if B is not None:
            return B
        if max(M.shape) <= dense_threshold:
            return dense_from_csr(M, dtype=dtype, row_pad=row_pad)
    return ell_from_csr(M, dtype=dtype, row_pad=row_pad)


def build_device_hierarchy(
    ml: MultiLevel, dtype=None, row_pad: int = 8, dense_threshold: int = 2048
) -> DeviceHierarchy:
    """Lower a host hierarchy to the static-shape device pytree.

    ``row_pad`` pads every level's row space (the parallel
    tier passes ``8·n_shards`` so row-sharding divides evenly)."""
    if dtype is None:
        dtype = jnp.asarray(np.zeros(0, dtype=ml.dtype)).dtype
    dtype = jnp.dtype(dtype)

    def device_cfg(cfg, n):
        """The smoother config the DEVICE engine runs.  Natural-order GS/SOR
        means the exact lax.scan recurrence over ELL rows — O(n) sequential,
        only sensible for small levels.  On large levels the device engine
        promotes to multicolor ordering (same smoother family; the
        reference contract is convergence, not sweep order — SURVEY §2.8 /
        test/test_smoothers.jl:15-45).  ``AMG_DEVICE_NATURAL_GS=1`` opts
        out and keeps the exact sequential semantics everywhere."""
        if (
            isinstance(cfg, (GaussSeidel, SOR))
            and cfg.ordering == "natural"
            and n > dense_threshold
            and os.environ.get("AMG_DEVICE_NATURAL_GS") != "1"
        ):
            import dataclasses as _dc

            return _dc.replace(cfg, ordering="multicolor")
        return cfg

    def needs_ell(level):
        # natural-order GS/SOR runs the exact lax.scan recurrence over ELL rows
        n = level.A.shape[0]
        for cfg in (level.presmoother_config, level.postsmoother_config):
            if isinstance(device_cfg(cfg, n), (GaussSeidel, SOR)) and device_cfg(cfg, n).ordering == "natural":
                return True
        return False

    def lower(M, target_pad, force_ell=False):
        return lower_operator(M, dtype, target_pad, dense_threshold, force_ell)

    def lower_square(level):
        """Lower a level's A, possibly adopting an RCM-permuted basis for
        the whole level: an ELL level whose RCM order at least halves its
        bandwidth gets ``A[π][:,π]``, so its SpMV gathers read nearby x
        entries.  The caller folds π into P/R and the smoother caches so the
        cycle runs entirely in the permuted basis (solve entry/exit applies
        π once per solve)."""
        from .lattice import LatticeMatrix
        from .lattice_nd import LatticeMatrixND

        M = level.A
        force = needs_ell(level)
        if isinstance(M, (LatticeMatrix, LatticeMatrixND)) or force:
            return lower(M, row_pad, force_ell=force), None, None
        A_dev = lower(M, row_pad)
        if not isinstance(A_dev, ELL):
            return A_dev, None, None
        A_csr = as_csr_cached(M)
        pi = rcm_permutation(A_csr)
        Ap = A_csr[pi][:, pi].tocsr()
        if 2 * bandwidth(Ap) > bandwidth(A_csr):
            return A_dev, None, None
        return ell_from_csr(Ap, dtype=dtype, row_pad=row_pad), pi, Ap

    dev_levels = []
    pad_of_level = []  # canonical padded length of each level's row space
    perm_of_level = []  # RCM basis per level (None = natural order)
    for level in ml.levels:
        A_dev, pi, Ap = lower_square(level)
        pad_of_level.append(A_dev.rows_padded)
        perm_of_level.append(pi)
        dev_levels.append((level, A_dev, Ap))
    perm_of_level.append(None)  # the final (dense-solve) level stays natural

    final_pad = round_up(max(ml.final_A.shape[0], 1), row_pad)
    pad_of_level.append(final_pad)

    def permute_rect(M, prow, pcol):
        """Fold level bases into a transfer operator: rows by this level's
        permutation, columns by the neighbour level's."""
        if prow is None and pcol is None:
            return M
        C = M.tocsr() if hasattr(M, "tocsr") else as_csr_cached(M)
        import scipy.sparse as _sp

        if not _sp.issparse(C):
            C = _sp.csr_matrix(C)
        if prow is not None:
            C = C[prow]
        if pcol is not None:
            C = C[:, pcol]
        return C.tocsr()

    out = []
    sym_hint = type(ml.symmetry).__name__ == "HermitianSymmetry"
    for i, (level, A_dev, Ap) in enumerate(dev_levels):
        # P maps coarse → this level's rows; R maps this level → coarse rows.
        pf, pc = perm_of_level[i], perm_of_level[i + 1]
        P_dev = lower(permute_rect(level.P, pf, pc), pad_of_level[i])
        R_dev = lower(permute_rect(level.R, pc, pf), pad_of_level[i + 1])
        A_host = Ap if Ap is not None else level.A
        n_lvl = level.A.shape[0]
        pre = _build_smoother_cache(device_cfg(level.presmoother_config, n_lvl), A_host, A_dev, dtype, sym=sym_hint)
        post = _build_smoother_cache(device_cfg(level.postsmoother_config, n_lvl), A_host, A_dev, dtype, sym=sym_hint)
        out.append(DeviceLevel(A=A_dev, P=P_dev, R=R_dev, pre=pre, post=post))

    coarse = _build_coarse_cache(ml, dtype, final_pad)
    final_dev = lower(as_csr_cached(ml.final_A), row_pad)

    perm0 = iperm0 = None
    if perm_of_level and perm_of_level[0] is not None:
        pi0 = perm_of_level[0]
        fine_pad = pad_of_level[0]
        pp = np.concatenate([pi0, np.arange(len(pi0), fine_pad)]).astype(np.int32)
        ip = np.concatenate([np.argsort(pi0), np.arange(len(pi0), fine_pad)]).astype(np.int32)
        perm0, iperm0 = jnp.asarray(pp), jnp.asarray(ip)

    return DeviceHierarchy(
        levels=tuple(out), coarse=coarse, final_A=final_dev,
        perm0=perm0, iperm0=iperm0,
    )


# --------------------------------------------------------------------------
# cycling
# --------------------------------------------------------------------------


def _coarse_solve(coarse: CoarseCache, b):
    b_log = b[: coarse.n]
    if coarse.kind == "qr":
        y = jnp.matmul(coarse.qr_q.T.conj(), b_log, precision=jax.lax.Precision.HIGHEST)
        x = jax.scipy.linalg.solve_triangular(coarse.qr_r, y, lower=False)
    else:
        x = jnp.matmul(coarse.mat, b_log, precision=jax.lax.Precision.HIGHEST)
    pad = coarse.rows_padded - coarse.n
    if pad:
        padding = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        x = jnp.pad(x, padding)
    return x


def _cycle(h: DeviceHierarchy, cycle: Cycle, x, b, lvl: int):
    """One cycle at level lvl — structure of multilevel.jl:214-239.

    Phases carry ``jax.named_scope`` annotations (the equivalent of the
    reference's @timeit_debug phase timers, survey §5.1) so profiler traces
    attribute time to presmooth/residual/restrict/coarse_solve/prolong/
    postsmooth per level."""
    level = h.levels[lvl]
    n_here = x.shape[0]
    n_next = (
        h.levels[lvl + 1].A.rows_padded
        if lvl + 1 < len(h.levels)
        else h.coarse.rows_padded
    )

    with jax.named_scope(f"L{lvl}/presmooth"):
        x = _apply_smoother(level.pre, level.A, x, b)

    with jax.named_scope(f"L{lvl}/residual"):
        res = b - fit_len(mat_vec(level.A, x), n_here)
    with jax.named_scope(f"L{lvl}/restrict"):
        coarse_b = fit_len(mat_vec(level.R, res), n_next)

    if lvl == len(h.levels) - 1:
        with jax.named_scope("coarse_solve"):
            coarse_x = _coarse_solve(h.coarse, coarse_b)
    else:
        coarse_x = jnp.zeros_like(coarse_b)
        coarse_x = _next(h, cycle, coarse_x, coarse_b, lvl + 1)

    with jax.named_scope(f"L{lvl}/prolong"):
        x = x + fit_len(mat_vec(level.P, coarse_x), n_here)
    with jax.named_scope(f"L{lvl}/postsmooth"):
        x = _apply_smoother(level.post, level.A, x, b)
    return x


def _next(h, cycle, x, b, lvl):
    if isinstance(cycle, V):
        return _cycle(h, cycle, x, b, lvl)
    if isinstance(cycle, W):
        x = _cycle(h, cycle, x, b, lvl)
        return _cycle(h, cycle, x, b, lvl)
    if isinstance(cycle, F):
        x = _cycle(h, cycle, x, b, lvl)
        return _cycle(h, V(), x, b, lvl)
    raise TypeError(f"unknown cycle {cycle!r}")


def _one_iteration(h: DeviceHierarchy, cycle: Cycle, x, b):
    if h.levels:
        return _cycle(h, cycle, x, b, 0)
    return _coarse_solve(h.coarse, b)


def run_fixed_cycles(h: DeviceHierarchy, x, b, n_cycles: int):
    """``n_cycles`` V-cycles from ``x`` (a ``fori_loop`` over
    :func:`_one_iteration`)."""
    return jax.lax.fori_loop(
        0, n_cycles, lambda i, xx: _one_iteration(h, V(), xx, b), x
    )


def device_cycle_fn(ml: MultiLevel, cycle: Cycle = V(), dtype=None):
    """Return a jitted ``b -> x`` applying exactly one cycle from zero — the
    preconditioner contract (preconditioner.jl:12-19)."""
    h = _get_device_hierarchy(ml, dtype)

    @partial(jax.jit, static_argnames=("cycle",))
    def apply_fn(h, b, cycle):
        # h is a traced pytree argument: keeps level arrays out of the HLO
        # (closed-over arrays become giant baked-in constants)
        wdtype = h.final_A.dtype if not h.levels else h.levels[0].A.dtype
        bp = _pad_to(jnp.asarray(b, dtype=wdtype), h.fine_padded)
        x = jnp.zeros_like(bp)
        x = _one_iteration(h, cycle, x, bp)
        return x[: h.n_fine]

    return lambda b: apply_fn(h, b, cycle)


def _pad_to(v, rows_padded):
    n = v.shape[0]
    if n == rows_padded:
        return v
    pad = [(0, rows_padded - n)] + [(0, 0)] * (v.ndim - 1)
    return jnp.pad(v, pad)


def _get_device_hierarchy(ml: MultiLevel, dtype=None) -> DeviceHierarchy:
    if dtype is None:
        dtype = jnp.asarray(np.zeros(0, dtype=ml.dtype)).dtype
    key = ("hierarchy", jnp.dtype(dtype).name)
    if key not in ml._device_cache:
        ml._device_cache[key] = build_device_hierarchy(ml, dtype)
    return ml._device_cache[key]


# --------------------------------------------------------------------------
# solve driver
# --------------------------------------------------------------------------


def _enter_basis(h: DeviceHierarchy, v):
    """b → the hierarchy's fine-level basis (RCM for unstructured ELL levels)."""
    return v if h.perm0 is None else jnp.take(v, h.perm0, axis=0)


def _exit_basis(h: DeviceHierarchy, v):
    """x back to the caller's natural ordering."""
    return v if h.iperm0 is None else jnp.take(v, h.iperm0, axis=0)


@partial(jax.jit, static_argnames=("cycle", "calculate_residual"))
def _solve_fused(h: DeviceHierarchy, b, maxiter, abstol, cycle, calculate_residual):
    """Fully fused iteration loop: lax.while_loop with the residual norm
    carried on device (multilevel.jl:158-198 semantics)."""
    b = _enter_basis(h, b)
    A = h.levels[0].A if h.levels else h.final_A
    x0 = jnp.zeros_like(b)
    normb = jnp.linalg.norm(b)

    def cond(state):
        x, itr, normres = state
        ok = itr <= maxiter
        if calculate_residual:
            ok = ok & (normres > abstol)
        return ok

    def body(state):
        x, itr, normres = state
        x = _one_iteration(h, cycle, x, b)
        if calculate_residual:
            res = b - fit_len(mat_vec(A, x), b.shape[0])
            normres = jnp.linalg.norm(res)
        return (x, itr + 1, normres)

    x, itr, normres = jax.lax.while_loop(cond, body, (x0, 1, normb))
    return _exit_basis(h, x), itr - 1, normres


# --------------------------------------------------------------------------
# device Krylov + mixed-precision refinement
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cycle",))
def _pcg_fused(h: DeviceHierarchy, b, maxiter, abstol, cycle):
    """Fully jitted preconditioned CG with one AMG cycle (zero initial
    guess, fixed, linear — preconditioner.jl:12-19 contract) per iteration.
    State stays on device; the loop carries ⟨r,z⟩ and the residual norm."""
    b = _enter_basis(h, b)
    A = h.levels[0].A if h.levels else h.final_A
    n_pad = b.shape[0]

    def M(r):
        z = jnp.zeros_like(r)
        return _one_iteration(h, cycle, z, r)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = M(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0, precision=_HI)

    def cond(state):
        x, r, p, rz, itr, normr = state
        return (itr < maxiter) & (normr > abstol)

    def body(state):
        x, r, p, rz, itr, normr = state
        Ap = fit_len(mat_vec(A, p), n_pad)
        alpha = rz / jnp.vdot(p, Ap, precision=_HI)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.vdot(r, z, precision=_HI)
        p = z + (rz_new / rz) * p
        return (x, r, p, rz_new, itr + 1, jnp.linalg.norm(r))

    state = (x0, r0, p0, rz0, 0, jnp.linalg.norm(r0))
    x, r, p, rz, itr, normr = jax.lax.while_loop(cond, body, state)
    return _exit_basis(h, x), itr, normr


def cg_device(
    ml: MultiLevel,
    b,
    cycle: Cycle = V(),
    *,
    tol: float = 1e-8,
    abstol: float = 0.0,
    maxiter: int = 100,
    dtype=None,
    log: bool = False,
):
    """AMG-preconditioned conjugate gradients, fully on device."""
    h = _get_device_hierarchy(ml, dtype)
    wdtype = h.levels[0].A.dtype if h.levels else h.final_A.dtype
    b_arr = jnp.asarray(np.asarray(b), dtype=wdtype)
    n = b_arr.shape[0]
    bp = _pad_to(b_arr, h.fine_padded)
    normb = float(jnp.linalg.norm(b_arr))
    thresh = max(tol * normb, abstol)
    x, itr, normr = _pcg_fused(h, bp, maxiter, thresh, cycle)
    xout = np.asarray(x)[:n]
    return (xout, int(itr), float(normr)) if log else xout


def _get_fine_f64(ml: MultiLevel):
    """f64 device operator for the fine level — the outer-residual carrier of
    :func:`solve_refined`.  Built (and cached) inside a scoped
    ``jax.enable_x64`` so the global x64 flag stays off.  Returns None when
    no gather-free f64 lowering exists (caller falls back to the host loop).
    """
    key = ("fine64",)
    if key in ml._device_cache:
        return ml._device_cache[key]
    from .lattice import LatticeMatrix
    from .lattice_nd import LatticeMatrixND
    from ..ops.lattice_op import lat2d_from_spec
    from ..ops.lattice_nd_op import latnd_from_spec

    A = ml.levels[0].A if ml.levels else ml.final_A
    op = None
    with jax.enable_x64(True):
        if isinstance(A, LatticeMatrix):
            op = lat2d_from_spec(A.spec, dtype=jnp.float64)
        elif isinstance(A, LatticeMatrixND):
            op = latnd_from_spec(A.spec, dtype=jnp.float64)
        else:
            A_csr = as_csr_cached(A)
            op = sdia_from_csr(A_csr, dtype=jnp.float64, max_offsets=40, max_overhead=8.0)
            if op is None and max(A_csr.shape) <= 4096:
                op = dense_from_csr(A_csr, dtype=jnp.float64)
        if op is not None:
            jax.block_until_ready(jax.tree_util.tree_leaves(op))
    ml._device_cache[key] = op
    return op


@jax.jit
def _refine_prep(r64, scale):
    """rhs32 = (r64/scale) as f32 — traced under x64 (callers hold the ctx)."""
    return (r64 / scale).astype(jnp.float32)


@jax.jit
def _refine_update(x64, e32, b64, A64, scale):
    """x64 += scale·e; r64 = b64 − A·x64 (f64); returns (x64, r64, ‖r64‖)."""
    x64 = x64 + scale * e32.astype(jnp.float64)
    r64 = b64 - fit_len(mat_vec(A64, x64), b64.shape[0])
    return x64, r64, jnp.linalg.norm(r64)


def solve_refined(
    ml: MultiLevel,
    b,
    cycle: Cycle = V(),
    *,
    tol: float = 1e-8,
    inner: str = "cg",
    inner_tol: float = 1e-5,
    inner_maxiter: int = 40,
    max_rounds: int = 4,
    dtype="float32",
    log: bool = False,
    return_device: bool = False,
):
    """Mixed-precision iterative refinement: float32 AMG inner solves under
    a float64 outer residual loop.

    A single-precision V-cycle stalls at relative residual ~1e-6 (f32
    rounding floor); refinement reaches f64-grade tolerances while keeping
    every inner FLOP in f32:

        r = b − A·x            (f64, one SpMV per round)
        solve A·e ≈ r in f32   (AMG-PCG or V-cycles to ``inner_tol``)
        x ← x + e              (f64)

    The outer loop runs **entirely on device** when the fine operator has a
    gather-free f64 lowering (Lat2D/SDIA/dense — scoped ``jax.enable_x64``,
    the global flag stays off): per round the host sees one scalar norm, no
    O(n) transfers.  ``b`` may be a device array (skips the upload);
    ``return_device=True`` skips the final download and returns the f64
    device solution.  Falls back to a host outer loop (scipy f64 SpMV)
    otherwise.
    """
    h = _get_device_hierarchy(ml, dtype)
    A64 = _get_fine_f64(ml)
    if A64 is not None:
        return _solve_refined_device(
            ml, h, A64, b, cycle, tol=tol, inner=inner, inner_tol=inner_tol,
            inner_maxiter=inner_maxiter, max_rounds=max_rounds, log=log,
            return_device=return_device,
        )
    A_host = ml.levels[0].A if ml.levels else ml.final_A
    b64 = np.asarray(b, dtype=np.float64)
    n = b64.shape[0]
    normb = float(np.linalg.norm(b64))
    if normb == 0:
        out = np.zeros_like(b64)
        return (out, [0.0]) if log else out

    x64 = np.zeros_like(b64)
    r64 = b64.copy()
    history = [normb]
    for _ in range(max_rounds):
        if history[-1] <= tol * normb:
            break
        scale = float(np.linalg.norm(r64))
        bp = _pad_to(jnp.asarray((r64 / scale), dtype=h.levels[0].A.dtype if h.levels else h.final_A.dtype), h.fine_padded)
        if inner == "cg":
            e, _, _ = _pcg_fused(h, bp, inner_maxiter, inner_tol, cycle)
        else:
            e, _, _ = _solve_fused(h, bp, inner_maxiter, inner_tol, cycle, True)
        x64 += scale * np.asarray(e, dtype=np.float64)[:n]
        r64 = b64 - A_host @ x64  # f64 residual on host (exact carrier)
        history.append(float(np.linalg.norm(r64)))
    return (x64, history) if log else x64


def _solve_refined_device(
    ml, h, A64, b, cycle, *, tol, inner, inner_tol, inner_maxiter,
    max_rounds, log, return_device,
):
    """Device-resident refinement loop (see :func:`solve_refined`).

    The f32 inner PCG/V-cycle jits are invoked OUTSIDE the x64 scope so they
    hit the same compilation-cache entries as every other f32 call; only the
    O(n) f64 prep/update steps trace under ``jax.enable_x64``."""
    n = ml.levels[0].A.shape[0] if ml.levels else ml.final_A.shape[0]
    with jax.enable_x64(True):
        if isinstance(b, jax.Array) and b.dtype == jnp.float64:
            b64 = b
        else:
            b64 = jnp.asarray(np.asarray(b, dtype=np.float64))
        b64 = _pad_to(b64, h.fine_padded)
        normb = float(jnp.linalg.norm(b64))
        if normb == 0:
            out = jnp.zeros_like(b64)[:n]
            out = out if return_device else np.zeros(n, dtype=np.float64)
            return (out, [0.0]) if log else out
        x64 = jnp.zeros_like(b64)
    r64 = b64
    history = [normb]
    for _ in range(max_rounds):
        if history[-1] <= tol * normb:
            break
        scale = history[-1]
        with jax.enable_x64(True):
            bp = _refine_prep(r64, scale)
        if inner == "cg":
            e, _, _ = _pcg_fused(h, bp, inner_maxiter, inner_tol, cycle)
        else:
            e, _, _ = _solve_fused(h, bp, inner_maxiter, inner_tol, cycle, True)
        with jax.enable_x64(True):
            x64, r64, nr = _refine_update(x64, e, b64, A64, scale)
        history.append(float(nr))
    xout = x64[:n] if return_device else np.asarray(x64)[:n]
    return (xout, history) if log else xout


def solve_device(
    ml: MultiLevel,
    b,
    cycle: Cycle = V(),
    *,
    x=None,
    maxiter: int = 100,
    abstol: float = 0.0,
    reltol: Optional[float] = None,
    verbose: bool = False,
    log: bool = False,
    calculate_residual: bool = True,
    dtype=None,
):
    """Device-engine solve (mirrors solve_mg / multilevel.jl:158-198)."""
    h = _get_device_hierarchy(ml, dtype)
    wdtype = h.levels[0].A.dtype if h.levels else h.final_A.dtype
    b_arr = jnp.asarray(np.asarray(b), dtype=wdtype)
    n = b_arr.shape[0]
    bp = _pad_to(b_arr, h.fine_padded)

    if reltol is None:
        reltol = math.sqrt(float(jnp.finfo(wdtype).eps))
    normb = float(jnp.linalg.norm(b_arr))
    if normb != 0:
        abstol = max(reltol * normb, abstol)

    if not (log or verbose):
        xq, iters, normres = _solve_fused(
            h, bp, maxiter, abstol, cycle, calculate_residual
        )
        return np.asarray(xq)[:n]

    # Observed path: one jitted cycle per outer iteration, host-side logging.
    # State lives in the hierarchy's (possibly RCM-permuted) basis.
    bq = _enter_basis(h, bp)

    @partial(jax.jit, static_argnames=("cyc",))
    def _step(h, xx, bb, cyc):
        A = h.levels[0].A if h.levels else h.final_A
        xx = _one_iteration(h, cyc, xx, bb)
        res = bb - fit_len(mat_vec(A, xx), bb.shape[0])
        return xx, jnp.linalg.norm(res)

    def step(xx):
        return _step(h, xx, bq, cycle)

    xq = _pad_to(jnp.zeros_like(b_arr), h.fine_padded) if x is None else _enter_basis(
        h, _pad_to(jnp.asarray(np.asarray(x), dtype=wdtype), h.fine_padded)
    )
    residuals = [normb]
    normres = normb
    itr = 1
    while itr <= maxiter and ((not calculate_residual) or normres > abstol):
        if verbose:
            print(f"Norm of residual at iteration {itr:6d} is {normres:.4e}")
        xq, nr = step(xq)
        normres = float(nr)
        residuals.append(normres)
        itr += 1

    xout = np.asarray(_exit_basis(h, xq))[:n]
    return (xout, residuals) if log else xout
