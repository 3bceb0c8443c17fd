"""Explicit halo-exchange SpMV for slab-sharded lattice operators.

The default multi-chip path lets XLA insert collectives from sharding
annotations (dist.py).  For the fine-level stencil apply that generality is
wasteful: a row-slab shard only needs its neighbours' edge rows — a fixed,
tiny halo — not gathers of arbitrary columns.  This module is the explicit
form (survey §2.13, §5.7): a ``shard_map`` kernel that

1. exchanges ``reach`` boundary rows with the two slab neighbours via
   ``jax.lax.ppermute`` (nearest-neighbour traffic, no all-gather),
2. applies the Lat2D stencil locally on the halo-padded slab.

The collective moves ``2·reach·Wy`` elements per shard per apply —
O(surface) — versus the O(volume) all-gather XLA falls back to when it can't
prove the gather pattern.  Exposed as a standalone op (validated in
``tests/test_multichip.py`` on the virtual mesh); the sharded lattice
cycle (parallel/lattice_cycle.py) uses the same exchange pattern.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.lattice_op import Lat2D

__all__ = ["lat2d_spmv_halo", "shard_slab"]


def shard_slab(x, mesh: Mesh, Wx: int, Wy: int):
    """Place a flat (Wx·Wy) grid vector as x-slabs over the mesh."""
    return jax.device_put(
        x, NamedSharding(mesh, P("shards"))
    )


def lat2d_spmv_halo(A: Lat2D, x, mesh: Mesh, axis: str = "shards"):
    """y = A·x with explicit neighbour halo exchange along the slab axis.

    ``A`` must be square (base (1,1)) with its data slab-sharded on the row
    grid; ``x`` a flat sharded vector of length Wx·Wy (divisible by the mesh
    size along the x grid axis).
    """
    Wx, Wy = A.row_dims
    assert A.base_x == (1, 1) and A.base_y == (1, 1), "square stencils only"
    n_sh = mesh.shape[axis]
    assert Wx % n_sh == 0, "x-slabs must divide the grid"
    reach = max((abs(dx) for dx, _ in A.offsets), default=0)
    my = max((abs(dy) for _, dy in A.offsets), default=0)
    loc = Wx // n_sh

    def kernel(data_slab, x_slab):
        # data_slab: [n_off, loc, Wy]; x_slab: [loc*Wy]
        X = x_slab.reshape(loc, Wy)
        idx = jax.lax.axis_index(axis)
        # exchange edge rows with both neighbours (open boundary: shifts
        # bring zeros in at the chain ends via masking)
        top = X[:reach]       # rows my neighbour below needs
        bot = X[-reach:]      # rows my neighbour above needs
        from_above = jax.lax.ppermute(
            bot, axis, [(i, i + 1) for i in range(n_sh - 1)]
        )
        from_below = jax.lax.ppermute(
            top, axis, [(i + 1, i) for i in range(n_sh - 1)]
        )
        from_above = jnp.where(idx == 0, 0.0, from_above)
        from_below = jnp.where(idx == n_sh - 1, 0.0, from_below)

        Xh = jnp.concatenate([from_above, X, from_below], axis=0)
        Xp = jnp.pad(Xh, ((0, 0), (my, my)))
        y = jnp.zeros((loc, Wy), dtype=jnp.result_type(data_slab.dtype, X.dtype))
        for k, (dx, dy) in enumerate(A.offsets):
            src = jax.lax.slice(
                Xp, (reach + dx, my + dy), (reach + dx + loc, my + dy + Wy)
            )
            y = y + data_slab[k] * src
        return y.reshape(loc * Wy)

    f = jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(None, axis, None), P(axis)),
        out_specs=P(axis),
    )
    data = A.data  # [n_off, Wx, Wy]
    x_log = x[: Wx * Wy]
    return f(data, x_log)
