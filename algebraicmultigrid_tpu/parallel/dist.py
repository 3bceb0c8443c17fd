"""Distributed (multi-chip) tier: row-partitioned hierarchies over a device
mesh.

The reference has **no** distributed execution of any kind (survey §2.13) —
this layer is net-new design.  Architecture (the idiomatic pjit
recipe: pick a mesh, annotate shardings, let XLA insert collectives):

* every level's ELL operator is row-block sharded over a 1-D ``'shards'``
  mesh axis (``P('shards', None)``); level vectors are sharded the same way;
* SpMV gathers of the source vector lower to XLA all-gathers between
  devices — correct at any sparsity.  (The halo-minimised ``shard_map`` +
  ``ppermute`` form lives in the slab tier, parallel/lattice_cycle.py.)
* coarse-level operands and the dense coarse solve are **replicated** — the
  coarse-grid agglomeration policy (survey §5.7): levels shrink geometrically,
  so only the top one or two levels are worth sharding;
* the jitted cycle/while-loop code is byte-identical to the single-chip
  engine — shardings propagate from the input arrays through ``jit``.

Multi-chip correctness is validated on a virtual CPU mesh
(``--xla_force_host_platform_device_count``) in ``tests/test_multichip.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Cycle, V
from ..models.device import (
    CoarseCache,
    DeviceHierarchy,
    DeviceLevel,
    JacobiCache,
    MaskedMulticolorCache,
    MulticolorCache,
    ScanGSCache,
    _pad_to,
    _solve_fused,
    build_device_hierarchy,
)
from ..models.multilevel import MultiLevel
from ..ops.banded import DenseOp, SDIA
from ..ops.sparse import ELL

__all__ = [
    "make_row_mesh",
    "shard_hierarchy",
    "build_sharded_hierarchy",
    "solve_sharded",
]


def make_row_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the row-partition axis ``'shards'``."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return jax.sharding.Mesh(np.array(devices), ("shards",))


def _shard_ell(E, mesh: Mesh, *, replicate: bool = False):
    """Row-block shard any device operator format."""
    rep = NamedSharding(mesh, P())
    if isinstance(E, ELL):
        s = rep if replicate else NamedSharding(mesh, P("shards", None))
        return dataclasses.replace(
            E, data=jax.device_put(E.data, s), cols=jax.device_put(E.cols, s)
        )
    if isinstance(E, SDIA):
        # data is [n_offsets, rows_padded] → shard the row axis
        s = rep if replicate else NamedSharding(mesh, P(None, "shards"))
        return dataclasses.replace(E, data=jax.device_put(E.data, s))
    if isinstance(E, DenseOp):
        s = rep if replicate else NamedSharding(mesh, P("shards", None))
        return dataclasses.replace(E, mat=jax.device_put(E.mat, s))
    from ..ops.lattice_op import Lat2D

    if isinstance(E, Lat2D):
        # data is [n_off, WxR, WyR] → shard the row-grid slab axis (x); the
        # spmv's shifted-slab reads lower to XLA halo collectives
        if replicate or E.row_dims[0] % mesh.devices.size:
            s = rep
        else:
            s = NamedSharding(mesh, P(None, "shards", None))
        return dataclasses.replace(E, data=jax.device_put(E.data, s))
    from ..ops.lattice_nd_op import LatND

    if isinstance(E, LatND):
        # [n_off, W0, W1, …] → shard the leading grid axis
        if replicate or E.row_dims[0] % mesh.devices.size:
            s = rep
        else:
            s = NamedSharding(
                mesh, P(None, "shards", *([None] * (len(E.row_dims) - 1)))
            )
        return dataclasses.replace(E, data=jax.device_put(E.data, s))
    return E


def _shard_smoother(cache, mesh: Mesh, sharded_rows: bool):
    row_spec = P("shards") if sharded_rows else P()
    if isinstance(cache, JacobiCache):
        return dataclasses.replace(
            cache, dinv=jax.device_put(cache.dinv, NamedSharding(mesh, row_spec))
        )
    if isinstance(cache, MulticolorCache):
        # Color blocks replicated for now (small relative to fine A only on
        # coarse levels; round-2: shard the cmax axis with per-shard colors).
        rep = NamedSharding(mesh, P())
        return dataclasses.replace(
            cache,
            rows=jax.device_put(cache.rows, rep),
            data=jax.device_put(cache.data, rep),
            cols=jax.device_put(cache.cols, rep),
            dinv=jax.device_put(cache.dinv, rep),
        )
    if isinstance(cache, MaskedMulticolorCache):
        s = NamedSharding(mesh, row_spec)
        return dataclasses.replace(
            cache,
            color_of=jax.device_put(cache.color_of, s),
            dinv=jax.device_put(cache.dinv, s),
        )
    if isinstance(cache, ScanGSCache):
        return dataclasses.replace(
            cache, diag=jax.device_put(cache.diag, NamedSharding(mesh, row_spec))
        )
    return cache


def shard_hierarchy(
    h: DeviceHierarchy, mesh: Mesh, *, replicate_below: int = 4096
) -> DeviceHierarchy:
    """Annotate a device hierarchy with row-block shardings.

    Levels with fewer than ``replicate_below`` rows are replicated
    (coarse-grid agglomeration: collective latency dominates tiny SpMVs).
    """
    n_shards = mesh.devices.size
    levels = []
    for level in h.levels:
        big = level.A.shape[0] >= replicate_below and level.A.rows_padded % n_shards == 0
        pre, post = level.pre, level.post
        levels.append(
            DeviceLevel(
                A=_shard_ell(level.A, mesh, replicate=not big),
                P=_shard_ell(level.P, mesh, replicate=not big),
                R=_shard_ell(level.R, mesh, replicate=True),
                pre=_shard_smoother(pre, mesh, big),
                post=_shard_smoother(post, mesh, big),
            )
        )
    rep = NamedSharding(mesh, P())
    coarse = dataclasses.replace(
        h.coarse,
        mat=jax.device_put(h.coarse.mat, rep),
        qr_q=jax.device_put(h.coarse.qr_q, rep),
        qr_r=jax.device_put(h.coarse.qr_r, rep),
    )
    final_A = _shard_ell(h.final_A, mesh, replicate=True)
    # the fine-level RCM basis (unstructured ELL hierarchies) rides along
    # replicated — dropping it would silently unpermute entry/exit
    perm0 = None if h.perm0 is None else jax.device_put(h.perm0, rep)
    iperm0 = None if h.iperm0 is None else jax.device_put(h.iperm0, rep)
    return DeviceHierarchy(
        levels=tuple(levels), coarse=coarse, final_A=final_A,
        perm0=perm0, iperm0=iperm0,
    )


def build_sharded_hierarchy(
    ml: MultiLevel, mesh: Mesh, dtype=None, replicate_below: int = 4096
) -> DeviceHierarchy:
    """Build the device hierarchy padded for — and sharded over — ``mesh``."""
    n_shards = mesh.devices.size
    key = ("sharded", jnp.dtype(dtype).name if dtype else "auto", n_shards, replicate_below)
    if key not in ml._device_cache:
        h = build_device_hierarchy(ml, dtype=dtype, row_pad=8 * n_shards)
        ml._device_cache[key] = shard_hierarchy(h, mesh, replicate_below=replicate_below)
    return ml._device_cache[key]


def solve_sharded(
    ml: MultiLevel,
    b,
    cycle: Cycle = V(),
    *,
    mesh: Optional[Mesh] = None,
    maxiter: int = 100,
    abstol: float = 0.0,
    reltol: Optional[float] = None,
    calculate_residual: bool = True,
    dtype=None,
    replicate_below: int = 4096,
):
    """Multi-chip solve: the single-chip fused loop over a sharded hierarchy."""
    import math

    if mesh is None:
        mesh = make_row_mesh()
    h = build_sharded_hierarchy(ml, mesh, dtype=dtype, replicate_below=replicate_below)
    wdtype = h.levels[0].A.dtype if h.levels else h.final_A.dtype
    b_arr = jnp.asarray(np.asarray(b), dtype=wdtype)
    n = b_arr.shape[0]
    bp = _pad_to(b_arr, h.fine_padded)

    fine_sharded = bool(h.levels) and h.levels[0].A.shape[0] >= replicate_below
    spec = P("shards") if fine_sharded else P()
    if bp.ndim > 1:
        spec = P(*spec, *(None,) * (bp.ndim - 1)) if fine_sharded else P()
    bp = jax.device_put(bp, NamedSharding(mesh, spec))

    if reltol is None:
        reltol = math.sqrt(float(jnp.finfo(wdtype).eps))
    normb = float(jnp.linalg.norm(b_arr))
    if normb != 0:
        abstol = max(reltol * normb, abstol)

    xq, iters, normres = _solve_fused(h, bp, maxiter, abstol, cycle, calculate_residual)
    return np.asarray(xq)[:n], int(iters), float(normres)
