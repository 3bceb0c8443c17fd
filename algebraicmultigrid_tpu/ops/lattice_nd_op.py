"""LatND — gather-free device operator for N-D lattice-structured levels.

The N-axis generalisation of :class:`~.lattice_op.Lat2D`:

    y[i_0,…] = Σ_k data_k[i_0,…] · X[(i_0·p_0)//q_0 + d_0^k, …]

Each offset k is one static (possibly strided/repeated) N-D slice of the
padded input grid — elementwise multiply-add, fully fusible by XLA, no
gathers anywhere.  Covers square level operators (all bases (1,1)) and the
per-axis k-coarsened transfer operators P/R of box aggregation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .sparse import round_up
from .lattice_op import _axis_take

__all__ = ["LatND", "latnd_from_spec", "latnd_spmv"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LatND:
    data: jax.Array  # [n_off, *row_dims]
    offsets: Tuple[Tuple[int, ...], ...] = dataclasses.field(metadata=dict(static=True))
    row_dims: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    col_dims: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    bases: Tuple[Tuple[int, int], ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    rows_padded: int = dataclasses.field(metadata=dict(static=True))
    # working dtype of the level's vectors; ``data`` may be stored narrower
    # (bf16 coefficient planes under AMG_COEF_DTYPE)
    wdtype: str = dataclasses.field(default="float32", metadata=dict(static=True))

    @property
    def dtype(self):
        return jnp.dtype(self.wdtype)


def latnd_from_spec(spec, dtype, row_pad: int = 8) -> LatND:
    """Instantiate a device LatND from a host LatticeSpecND (O(n) block
    fills on host; device-side expansion can come later if upload cost
    shows up).  With ``AMG_COEF_DTYPE=bfloat16`` (the 2-D fused-leg
    convention) and an f32 working dtype the coefficient planes are stored
    bf16 — the stencil apply is HBM-bound on plane traffic, and the f32
    accumulate keeps the smoother a valid preconditioner (the f64 outer
    refinement / PCG absorbs the coefficient rounding)."""
    import os

    n_r = int(np.prod(spec.row_dims))
    store = jnp.dtype(dtype)
    if (
        os.environ.get("AMG_COEF_DTYPE", "") == "bfloat16"
        and store == jnp.float32
    ):
        store = jnp.dtype(jnp.bfloat16)
    comp = np.float32 if jnp.dtype(dtype).itemsize <= 4 else np.dtype(jnp.dtype(dtype).name)
    planes = spec.expand_all(dtype=comp).astype(store.name)
    return LatND(
        data=jnp.asarray(planes),
        offsets=tuple(tuple(int(v) for v in d) for d in spec.offsets),
        row_dims=tuple(spec.row_dims),
        col_dims=tuple(spec.col_dims),
        bases=tuple(tuple(b) for b in spec.bases),
        shape=(n_r, int(np.prod(spec.col_dims))),
        nnz=spec.nnz(),
        rows_padded=max(round_up(n_r, row_pad), row_pad),
        wdtype=jnp.dtype(dtype).name,
    )


def latnd_spmv(A: LatND, x: jax.Array) -> jax.Array:
    N = len(A.row_dims)
    n_c = int(np.prod(A.col_dims))
    tail = x.shape[1:]

    x_log = x[:n_c] if x.shape[0] >= n_c else jnp.pad(
        x, [(0, n_c - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    )
    X = x_log.reshape(tuple(A.col_dims) + tail)
    margins = [
        max((abs(d[a]) for d in A.offsets), default=0) for a in range(N)
    ]
    Xp = jnp.pad(X, [(m, m) for m in margins] + [(0, 0)] * len(tail))

    y = jnp.zeros(tuple(A.row_dims) + tail, dtype=jnp.result_type(A.data.dtype, x.dtype))
    for k, d in enumerate(A.offsets):
        g = Xp
        for a in range(N):
            g = _axis_take(g, a, d[a], margins[a], A.row_dims[a], A.bases[a])
        dk = A.data[k]
        if tail:
            dk = dk[(...,) + (None,) * len(tail)]
        y = y + dk * g

    y = y.reshape((int(np.prod(A.row_dims)),) + tail)
    pad = A.rows_padded - y.shape[0]
    if pad > 0:
        y = jnp.pad(y, [(0, pad)] + [(0, 0)] * len(tail))
    return y
