"""Lat2D — gather-free device operator for lattice-structured levels.

The structured fast path (models/lattice.py) describes every level operator
by a small (offset × boundary-class) coefficient table on a 2-D grid.  On
device that becomes:

    y[ix, iy] = Σ_k  data_k[ix, iy] · X[base_x(ix) + dxₖ, base_y(iy) + dyₖ]

with ``base(i) = (i·W_col)//W_row`` per axis.  Because the per-axis ratio is
1, 2, or 1/2 for every operator StructuredRS produces, each offset k is ONE
static (possibly strided) 2-D slice of the padded input grid — multiply-add
elementwise, no gathers anywhere, fully fusible by XLA.  This generalises the
1-D SDIA format to per-axis strides, covering the x-halved transfer operators
SDIA cannot express.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .sparse import round_up

__all__ = ["Lat2D", "lat2d_from_spec", "expand_planes_device"]


@functools.partial(jax.jit, static_argnames=("ncx", "ncy", "out_dtype"))
def _expand_planes_jit(T, cx, cy, *, ncx, ncy, out_dtype):
    """[n_off, Wx, Wy] planes from the class table: plane[k,i,j] =
    T[k, cx[i], cy[j]] realised as two one-hot matmuls.  Each
    one-hot row has exactly one 1.0, so with HIGHEST precision the matmul
    copies table entries exactly — no gathers, O(W) operands."""
    Ex = (cx[:, None] == jnp.arange(ncx, dtype=cx.dtype)).astype(T.dtype)
    Ey = (cy[:, None] == jnp.arange(ncy, dtype=cy.dtype)).astype(T.dtype)
    planes = jnp.einsum(
        "xc,kcd,yd->kxy", Ex, T, Ey, precision=jax.lax.Precision.HIGHEST
    )
    return planes.astype(out_dtype)


def expand_planes_device(spec, dtype) -> jax.Array:
    """Device-side LatticeSpec.expand_all: uploads the O(K+s) table and two
    O(W) class-index vectors instead of O(n) expanded planes — the O(n)
    host↔device transfer and the O(n) host memset both disappear.
    Falls back to the host path for exotic table dtypes."""
    dt = jnp.dtype(dtype)
    if np.dtype(spec.table.dtype).kind != "f" or dt.kind != "f":
        return jnp.asarray(spec.expand_all(dtype=dtype))
    # convert the (tiny) table to the target dtype on host — identical
    # rounding to the host path's expand(dtype=...); bf16 storage computes
    # in f32 and casts at the end.
    comp = np.float32 if dt.itemsize <= 4 else np.dtype(dtype)
    cx, cy = spec.row_class_arrays()
    n_off, ncx, ncy = spec.table.shape
    T = jnp.asarray(np.asarray(spec.table, dtype=comp))
    return _expand_planes_jit(
        T,
        jnp.asarray(cx.astype(np.int32)),
        jnp.asarray(cy.astype(np.int32)),
        ncx=ncx,
        ncy=ncy,
        out_dtype=dt.name,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Lat2D:
    data: jax.Array  # [n_off, WxR, WyR]
    offsets: Tuple[Tuple[int, int], ...] = dataclasses.field(metadata=dict(static=True))
    row_dims: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    col_dims: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    base_x: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    base_y: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    rows_padded: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.data.dtype


def lat2d_from_spec(spec, dtype, row_pad: int = 8) -> Lat2D:
    """Instantiate a device Lat2D from a host LatticeSpec (O(n) block fills,
    no graph analysis)."""
    WxR, WyR = spec.row_dims
    n_r = WxR * WyR
    return Lat2D(
        data=expand_planes_device(spec, dtype),
        offsets=spec.offsets,
        row_dims=(WxR, WyR),
        col_dims=tuple(spec.col_dims),
        base_x=tuple(spec.base_x),
        base_y=tuple(spec.base_y),
        shape=(n_r, spec.col_dims[0] * spec.col_dims[1]),
        nnz=spec.nnz(),
        rows_padded=round_up(max(n_r, 1), row_pad),
    )


def _axis_take(Xp, axis: int, d: int, m: int, W_row: int, base: Tuple[int, int]):
    """Static slice of the padded grid realising ``(i*p)//q + d`` along one
    axis.  ``Xp`` is padded by ``m`` on each side of ``axis``; returns an
    array of extent ``W_row`` along that axis.
    """
    p, q = base
    start = d + m
    if p == 1 and q == 1:
        return jax.lax.slice_in_dim(Xp, start, start + W_row, axis=axis)
    if p == 1:  # fine rows (prolongation): base = i//q — q rows share a source
        src = (W_row - 1) // q + 1
        s = jax.lax.slice_in_dim(Xp, start, start + src, axis=axis)
        s = jnp.repeat(s, q, axis=axis)
        if src * q != W_row:
            s = jax.lax.slice_in_dim(s, 0, W_row, axis=axis)
        return s
    if q == 1:  # coarse rows (restriction): base = p·i — strided read
        return jax.lax.slice_in_dim(
            Xp, start, start + (W_row - 1) * p + 1, stride=p, axis=axis
        )
    raise ValueError(f"unsupported rational base {base}")


def lat2d_spmv(A: Lat2D, x: jax.Array) -> jax.Array:
    WxR, WyR = A.row_dims
    WxC, WyC = A.col_dims
    n_c = WxC * WyC
    tail = x.shape[1:]

    x_log = x[:n_c] if x.shape[0] >= n_c else jnp.pad(
        x, [(0, n_c - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    )
    X = x_log.reshape((WxC, WyC) + tail)
    mx = max((abs(dx) for dx, _ in A.offsets), default=0)
    my = max((abs(dy) for _, dy in A.offsets), default=0)
    Xp = jnp.pad(X, [(mx, mx), (my, my)] + [(0, 0)] * len(tail))

    y = jnp.zeros((WxR, WyR) + tail, dtype=jnp.result_type(A.data.dtype, x.dtype))
    for k, (dx, dy) in enumerate(A.offsets):
        g = _axis_take(Xp, 0, dx, mx, WxR, A.base_x)
        g = _axis_take(g, 1, dy, my, WyR, A.base_y)
        dk = A.data[k]
        if tail:
            dk = dk[(...,) + (None,) * len(tail)]
        y = y + dk * g

    y = y.reshape((WxR * WyR,) + tail)
    pad = A.rows_padded - WxR * WyR
    if pad > 0:
        y = jnp.pad(y, [(0, pad)] + [(0, 0)] * len(tail))
    return y
