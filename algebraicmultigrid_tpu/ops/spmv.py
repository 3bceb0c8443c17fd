"""Device SpMV over the padded ELL format.

The solve-phase hot path of the reference is three CSC SpMVs per level per
cycle (residual, restrict, prolong — ``/root/reference/src/multilevel.jl:218-234``)
executed as scalar Julia loops.  Here each SpMV is a gather + multiply + row
reduction over static shapes, which XLA fuses into one loop (the gathered
``[rows, width]`` block is never written out); there is no scalar loop and
no dynamic shape.  It is the format of every level no structured format
(lattice, SDIA, block-Toeplitz, dense) fits: unstructured meshes and graphs.

All ops accept either a vector ``x[n]`` or a multi-RHS block ``x[n, k]``
(the analogue of the reference's ``bs``-blocked workspace,
``/root/reference/src/multilevel.jl:23-59``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .sparse import ELL

__all__ = ["ell_spmv", "ell_diag", "pad_vec", "unpad_vec"]


def pad_vec(x: jax.Array, rows_padded: int) -> jax.Array:
    """Zero-pad the leading (row) axis of ``x`` to ``rows_padded``."""
    n = x.shape[0]
    if n == rows_padded:
        return x
    pad = [(0, rows_padded - n)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad)


def unpad_vec(x: jax.Array, n: int) -> jax.Array:
    return x[:n] if x.shape[0] != n else x


def ell_spmv(A: ELL, x: jax.Array) -> jax.Array:
    """``y = A @ x`` for a padded ELL matrix.

    ``x`` has logical length ``A.shape[1]`` (may carry a trailing RHS axis);
    the result has logical length ``A.shape[0]`` padded to ``A.rows_padded``
    rows (callers slice with :func:`unpad_vec` only at API boundaries — the
    cycle keeps everything padded so shapes stay static).
    """
    # x may arrive padded beyond A.shape[1] (level vectors stay padded inside
    # the cycle); stored column indices are always < A.shape[1] so the gather
    # is in bounds either way. Padding slots read x[0] but are multiplied by a
    # stored value of exactly 0.
    # Multiply-and-sum rather than a dot: it fuses with the gather, and an
    # f32 dot could be lowered to reduced-precision (TF32) tensor-core math.
    gathered = jnp.take(x, A.cols, axis=0)  # [rows_padded, width, ...]
    if x.ndim == 1:
        return jnp.sum(A.data * gathered, axis=1)
    return jnp.sum(A.data.astype(gathered.dtype)[:, :, None] * gathered, axis=1)


def ell_diag(A: ELL) -> jax.Array:
    """Extract the main diagonal as a dense padded vector."""
    n_rows, _ = A.shape
    row_ids = jnp.arange(A.rows_padded, dtype=A.cols.dtype)[:, None]
    mask = (A.cols == row_ids) & (row_ids < n_rows)
    return jnp.sum(jnp.where(mask, A.data, 0), axis=1)
