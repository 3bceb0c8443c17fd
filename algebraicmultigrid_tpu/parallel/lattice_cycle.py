"""Sharded lattice V-cycle: slab-partitioned multigrid with explicit halo
exchange over a device mesh.

The reference has no distributed execution (survey §2.13); this module is
the design the survey's §5.7/§5.8 call for, applied to the
flagship structured-SA lattice hierarchies:

* every fine level's coefficient planes and vectors are **x-slab sharded**
  over a 1-D ``'shards'`` mesh axis; the y axis stays whole per shard.
  Coefficient slabs are stored with their halo rows baked in at build time
  (they are constants — no runtime exchange ever touches them);
* all cross-slab data motion is **nearest-neighbour**: ``jax.lax.ppermute``
  moves only the edge rows a phase needs (O(surface) per apply, never an
  O(volume) all-gather).  A smoother application exchanges ONCE with a halo
  of ``n_steps·reach`` rows and over-computes the extended slab (halo
  erosion: each step's wrong rows stay inside the shrinking halo ring);
* transfer operators use the factored-prolongator form ``P = (I − diag(s)A)T``
  (survey §2.7, aggregation.jl:10-17): restriction/prolongation are stride-k
  subsamples/upsamples that stay slab-aligned, because padded x-dims are
  chosen top-down as ``Wxp(l+1) = Wxp(l)/k`` with ``Wxp(0)`` a multiple of
  ``k·n_sh``;
* **coarse-grid agglomeration** (survey §5.7): once a level's slab would be
  thinner than its halo (or slab alignment breaks), the hierarchy switches
  to replicated levels — one ``all_gather`` of the tiny restricted residual
  at the boundary, then every device runs the identical tail, ending in a
  replicated dense pinv solve (coarse_solver.jl:9-16 semantics, singular-safe).

``cycle_lattice_sharded`` is one ``shard_map``-ped V-cycle (linear, zero
initial guess available — the preconditioner contract of
preconditioner.jl:12-19); ``solve_lattice_sharded`` wraps it in a jitted PCG
loop whose dot products XLA lowers to ``psum`` over the mesh.  Validated on
the virtual CPU mesh in ``tests/test_sharded_lattice.py``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import GaussSeidel, SOR, SymmetricSweep
from ..models.multilevel import MultiLevel
from ..ops.coloring import color_steps

__all__ = [
    "build_slab_hierarchy",
    "cycle_lattice_sharded",
    "matvec_lattice_sharded",
    "place_slab_hierarchy",
    "solve_lattice_sharded",
]

AXIS = "shards"


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SlabLevel:
    # coefficient slabs with baked halos: sharded → [n_sh, loc+2Hp, Wyp]
    # (A has a trailing offset axis), replicated → [1, Wxp, Wyp]
    A: jax.Array                      # [..., n_off]
    dinv: jax.Array
    T: jax.Array
    S: jax.Array
    offsets: Tuple[Tuple[int, int], ...] = dataclasses.field(metadata=dict(static=True))
    color_tab: Tuple[Tuple[int, ...], ...] = dataclasses.field(metadata=dict(static=True))
    # smoother programs: ("gs", color_steps, ω) or ("jacobi", n_iters, ω)
    pre_sm: Tuple = dataclasses.field(metadata=dict(static=True))
    post_sm: Tuple = dataclasses.field(metadata=dict(static=True))
    k: int = dataclasses.field(metadata=dict(static=True))
    dims: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))   # true (Wx, Wy)
    pdims: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))  # padded (Wxp, Wyp)
    Hp: int = dataclasses.field(metadata=dict(static=True))                 # baked plane halo
    sharded: bool = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SlabHierarchy:
    levels: Tuple[SlabLevel, ...]
    pinv: jax.Array                   # replicated dense coarse-solve operator
    ctrue: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))  # true coarsest grid
    cpad: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))   # padded coarsest grid
    n_sh: int = dataclasses.field(metadata=dict(static=True))

    @property
    def fine_pdims(self):
        return self.levels[0].pdims

    @property
    def fine_dims(self):
        return self.levels[0].dims


def _scale_plane(level, spec) -> Optional[np.ndarray]:
    """Expand the stashed prolongator-smoothing scale ω·D̃⁻¹ to a full
    (Wx, Wy) plane (mirrors models/device._maybe_build_fused_legs)."""
    from ..models.lattice import axis_classes

    s_t = getattr(level, "psmooth_scale", None)
    Wx, Wy = spec.row_dims
    if s_t is None:
        return None
    if isinstance(s_t, tuple) and s_t and s_t[0] == "table":
        _, tbl, (Kx, sx, Ky, sy) = s_t
        cx = axis_classes(np.arange(Wx), Wx, Kx, sx)
        cy = axis_classes(np.arange(Wy), Wy, Ky, sy)
        return np.asarray(tbl, dtype=np.float64)[cx[:, None], cy[None, :]]
    v = np.asarray(s_t, dtype=np.float64)
    if v.size != Wx * Wy:
        return None
    return v.reshape(Wx, Wy)


def build_slab_hierarchy(
    ml: MultiLevel, n_sh: int, dtype="float32", min_loc: int = 8
) -> SlabHierarchy:
    """Lower a structured-SA lattice hierarchy to slab-sharded plane form,
    as host arrays (:func:`place_slab_hierarchy` commits them to a mesh).

    Requires every level to be a LatticeMatrix carrying the
    factored-prolongator stash (single-offset box-k tentative prolongator T
    plus the ω·D̃⁻¹ smoothing scale) — i.e. a ``structured_smoothed_aggregation``
    hierarchy with the reference-default LocalWeighting degree-1 Jacobi
    prolongator smoothing.
    """
    from ..models.lattice import LatticeMatrix, lattice_coloring

    dt = jnp.dtype(dtype)
    meta = []
    truncated_at = None  # level index folded into the dense coarse solve
    max_dense = 16384
    for li, level in enumerate(ml.levels):
        try:
            if not isinstance(level.A, LatticeMatrix):
                raise ValueError("build_slab_hierarchy needs lattice levels")
            spec = level.A.spec
            T_t = getattr(level, "T_tent", None)
            if not isinstance(T_t, LatticeMatrix):
                raise ValueError("level lacks the factored-prolongator stash")
            specT = T_t.spec
            base = specT.base_x
            if base != specT.base_y or base[0] != 1 or base[1] not in (2, 3):
                raise ValueError(f"unsupported transfer base {base}")
            k = base[1]
            got = lattice_coloring(spec)
            if got is None:
                raise ValueError("level not colorable by a periodic table")
            tab, n_colors = got

            def sm_program(cfg):
                """Static smoother program for one config (GS/SOR any
                sweep, or Jacobi) — the full smoother-protocol surface of
                smoother.jl:10-23,92-99,173-180 on the sharded tier."""
                from ..config import (
                    BackwardSweep,
                    ForwardSweep,
                    Jacobi,
                )

                if isinstance(cfg, Jacobi):
                    return ("jacobi", int(cfg.iter), float(cfg.omega))
                if isinstance(cfg, (GaussSeidel, SOR)):
                    om = float(cfg.omega) if isinstance(cfg, SOR) else 1.0
                    fwd = isinstance(cfg.sweep, (ForwardSweep, SymmetricSweep))
                    bwd = isinstance(cfg.sweep, (BackwardSweep, SymmetricSweep))
                    return ("gs", color_steps(n_colors, cfg.iter, fwd, bwd, om), om)
                raise ValueError(f"unsupported slab smoother {cfg!r}")

            pre_sm = sm_program(level.presmoother_config)
            post_sm = sm_program(level.postsmoother_config)
            S_pl = _scale_plane(level, spec)
            if S_pl is None:
                raise ValueError("level lacks the prolongator-smoothing scale")
        except ValueError:
            # agglomerate early: a small non-lattice (or unfactorable) level
            # becomes the replicated dense coarse solve; bigger ones are a
            # hard error (a dense solve there would dominate)
            if meta and level.A.shape[0] <= max_dense:
                truncated_at = li
                break
            raise
        reach = max(
            max((abs(d) for d, _ in spec.offsets), default=1),
            max((abs(d) for _, d in spec.offsets), default=1),
        )

        def sm_len(sm):
            return sm[1] if sm[0] == "jacobi" else len(sm[1])

        Hp = max(sm_len(pre_sm), sm_len(post_sm)) * reach + 2 * reach + k
        meta.append(dict(
            level=level, spec=spec, specT=specT,
            idxT=specT.offsets.index((0, 0)), k=k, tab=tab,
            pre_sm=pre_sm, post_sm=post_sm, S_pl=S_pl, reach=reach, Hp=Hp,
        ))

    pad = lambda v, m: -(-v // m) * m
    L = len(meta)

    # padded dims + sharding decisions, top-down (see module docstring):
    # a sharded level requires Wxp % (k·n_sh) == 0 so its slabs are equal
    # AND its stride-k restriction/prolongation stay slab-aligned
    # (loc_c = loc/k exactly); a sharded child inherits Wxp(parent)/k.
    # Replicated levels always use their own k-multiple padding — transfers
    # adapt by zero re-padding (free on replicated grids).
    for li, m in enumerate(meta):
        Wx, Wy = m["spec"].row_dims
        k = m["k"]
        parent = meta[li - 1] if li else None
        if parent is not None and parent["sharded"]:
            Wxp_sh = parent["pdims"][0] // parent["k"]
        elif parent is None:
            Wxp_sh = pad(Wx, k * n_sh)
        else:
            Wxp_sh = -1  # replicated parent → this level can't shard
        Wyp = pad(Wy, k)
        sharded = (
            Wxp_sh > 0
            and Wxp_sh % (k * n_sh) == 0
            and Wxp_sh // n_sh >= max(min_loc, m["Hp"])
        )
        m["pdims"] = (Wxp_sh, Wyp) if sharded else (pad(Wx, k), Wyp)
        m["sharded"] = sharded

    levels = []
    for m in meta:
        spec, specT = m["spec"], m["specT"]
        Wx, Wy = spec.row_dims
        Wxp, Wyp = m["pdims"]
        Hp, sharded = m["Hp"], m["sharded"]
        loc = Wxp // n_sh

        def halo_slabs(plane):
            """[Wxp, Wyp] plane → baked-halo slabs (or [1, ...] replicated).
            Always copies: ``fit`` below reuses one scratch buffer."""
            if not sharded:
                return plane[None].copy()
            padp = np.zeros((Wxp + 2 * Hp, Wyp), plane.dtype)
            padp[Hp : Hp + Wxp] = plane
            win = np.lib.stride_tricks.sliding_window_view(
                padp, (loc + 2 * Hp, Wyp)
            )[::loc, 0]
            return np.ascontiguousarray(win)

        n_off = len(spec.offsets)
        full = np.zeros((Wxp, Wyp), np.float64)

        def fit(raw):
            full[:] = 0.0
            full[:Wx, :Wy] = raw
            return full

        A_sl = np.stack(
            [halo_slabs(fit(spec.expand(kk, dtype=np.float64))) for kk in range(n_off)],
            axis=-1,
        )
        diag = spec.diagonal().reshape(Wx, Wy)
        dv = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 0.0)
        levels.append(SlabLevel(
            A=A_sl.astype(dt),
            dinv=halo_slabs(fit(dv)).astype(dt),
            T=halo_slabs(fit(specT.expand(m["idxT"], dtype=np.float64))).astype(dt),
            S=halo_slabs(fit(m["S_pl"])).astype(dt),
            offsets=spec.offsets,
            color_tab=tuple(tuple(int(c) for c in row) for row in np.asarray(m["tab"])),
            pre_sm=m["pre_sm"],
            post_sm=m["post_sm"],
            k=m["k"],
            dims=(Wx, Wy),
            pdims=(Wxp, Wyp),
            Hp=Hp,
            sharded=sharded,
        ))

    import scipy.sparse as sp

    if truncated_at is None:
        Af = ml.final_A
    else:
        Af = ml.levels[truncated_at].A.tocsr()
    Af = Af.toarray() if sp.issparse(Af) else np.asarray(Af)
    pinv = np.linalg.pinv(Af).astype(dt)
    kL = meta[-1]["k"]
    WxL, WyL = meta[-1]["pdims"]
    # true coarsest dims from the last kept T spec's column grid
    ctrue = tuple(int(v) for v in meta[-1]["specT"].col_dims)
    cpad = (pad(WxL, kL) // kL, pad(WyL, kL) // kL)
    return SlabHierarchy(
        levels=tuple(levels), pinv=pinv, ctrue=ctrue, cpad=cpad, n_sh=n_sh
    )


# --------------------------------------------------------------------------
# in-kernel pieces (operate on one shard's local slab, inside shard_map)
# --------------------------------------------------------------------------


def _exch(X, H, sharded, n_sh):
    """Extend a local slab by H rows from each slab neighbour via ppermute
    (zeros at the chain ends — open boundary).  Replicated levels just
    zero-pad (the domain boundary)."""
    if H == 0:
        return X
    if not sharded or n_sh == 1:
        return jnp.pad(X, ((H, H), (0, 0)))
    idx = jax.lax.axis_index(AXIS)
    top = X[:H]
    bot = X[-H:]
    from_above = jax.lax.ppermute(bot, AXIS, [(i, i + 1) for i in range(n_sh - 1)])
    from_below = jax.lax.ppermute(top, AXIS, [(i + 1, i) for i in range(n_sh - 1)])
    from_above = jnp.where(idx == 0, 0.0, from_above)
    from_below = jnp.where(idx == n_sh - 1, 0.0, from_below)
    return jnp.concatenate([from_above, X, from_below], axis=0)


def _plane(lv: SlabLevel, arr, H):
    """Local coefficient slab at halo H ≤ Hp.  ``arr`` is the local block of
    a baked-halo slab array ([1, loc+2Hp, Wyp(,n_off)] sharded, or
    [1, Wxp, Wyp(,n_off)] replicated)."""
    a = arr[0]
    if not lv.sharded:
        if H == 0:
            return a
        return jnp.pad(a, ((H, H), (0, 0)) + ((0, 0),) * (a.ndim - 2))
    d = lv.Hp - H
    return a[d : a.shape[0] - d] if d else a


def _stencil(A_h, Xe, offsets):
    """Σ_k A_k ⊙ shift_k(X) on an extended slab.  x-shifts roll within the
    slab (wrap garbage lands in the eroding halo ring); y-shifts read a
    zero-padded margin."""
    my = max((abs(dy) for _, dy in offsets), default=0)
    rows, cols = Xe.shape
    Xp = jnp.pad(Xe, ((0, 0), (my, my)))
    acc = None
    for kk, (dx, dy) in enumerate(offsets):
        src = jax.lax.slice(Xp, (0, my + dy), (rows, my + dy + cols))
        if dx:
            src = jnp.roll(src, -dx, axis=0)
        term = A_h[..., kk] * src
        acc = term if acc is None else acc + term
    return acc


def _colors(lv: SlabLevel, rows: int, H: int, n_sh: int):
    """Color ids for the extended slab's rows (global pattern, periodic)."""
    tab = np.asarray(lv.color_tab)
    a, b = tab.shape
    Wyp = lv.pdims[1]
    if lv.sharded and n_sh > 1:
        loc = lv.pdims[0] // n_sh
        row0 = jax.lax.axis_index(AXIS) * loc - H
    else:
        row0 = -H
    px = (jnp.arange(rows)[:, None] + row0 + 16384 * a) % a
    py = (jnp.arange(Wyp)[None, :] + 16384 * b) % b
    out = jnp.zeros((rows, Wyp), jnp.int32)
    for u in range(a):
        for v in range(b):
            out = jnp.where((px == u) & (py == v), int(tab[u, v]), out)
    return out


def _smooth(lv: SlabLevel, x, b, n_sh, sm):
    """Masked multicolor GS/SOR or weighted Jacobi: ONE halo exchange of
    n_steps·reach rows, then over-computed sweeps on the extended slab."""
    reach = max(max(abs(d) for d, _ in lv.offsets), max(abs(d) for _, d in lv.offsets))
    kind, prog, omega = sm
    n_steps = prog if kind == "jacobi" else len(prog)
    H = n_steps * reach
    Xe = _exch(x, H, lv.sharded, n_sh)
    Be = _exch(b, H, lv.sharded, n_sh)
    A_h = _plane(lv, lv.A, H)
    D_h = _plane(lv, lv.dinv, H)
    if kind == "jacobi":
        for _ in range(prog):
            rsum = _stencil(A_h, Xe, lv.offsets)
            Xe = Xe + omega * D_h * (Be - rsum)
        return Xe[H : Xe.shape[0] - H] if H else Xe
    col = _colors(lv, Xe.shape[0], H, n_sh)
    for c in prog:
        rsum = _stencil(A_h, Xe, lv.offsets)
        upd = Xe + omega * D_h * (Be - rsum)
        Xe = jnp.where(col == c, upd, Xe)
    return Xe[H : Xe.shape[0] - H] if H else Xe


def _restrict(lv: SlabLevel, x, b, n_sh):
    """ts = T ⊙ (r − A(S⊙r)) with r = b − A·x, then the stride-k box sum
    b_c[c,d] = Σ_ρ ts[k·c+ρx, k·d+ρy]  (R = Tᵀ(I − A·diag(s)), the factored
    form).  Returns the ts slab — the caller subsamples (slab-locally or
    after an agglomeration gather)."""
    reach = max(max(abs(d) for d, _ in lv.offsets), max(abs(d) for _, d in lv.offsets))
    H = 2 * reach
    Xe = _exch(x, H, lv.sharded, n_sh)
    Be = _exch(b, H, lv.sharded, n_sh)
    A_h = _plane(lv, lv.A, H)
    S_h = _plane(lv, lv.S, H)
    T_h = _plane(lv, lv.T, H)
    r = Be - _stencil(A_h, Xe, lv.offsets)
    ts = T_h * (r - _stencil(A_h, S_h * r, lv.offsets))
    return ts[H : ts.shape[0] - H]


def _subsample(ts, k):
    """[rows, cols] → [rows//k, cols//k] stride-k box sum (rows, cols padded
    to multiples of k by the caller)."""
    rows, cols = ts.shape
    return ts.reshape(rows // k, k, cols // k, k).sum(axis=(1, 3))


def _fit_cols(g, cols):
    if g.shape[1] == cols:
        return g
    if g.shape[1] > cols:
        return g[:, :cols]
    return jnp.pad(g, ((0, 0), (0, cols - g.shape[1])))


def _fit_rows(g, rows):
    if g.shape[0] == rows:
        return g
    if g.shape[0] > rows:
        return g[:rows]
    return jnp.pad(g, ((0, rows - g.shape[0]), (0, 0)))


def _prolong_corr(lv: SlabLevel, xc_ext, n_sh):
    """corr = T⊙up − S⊙(A·(T⊙up)) on this level's slab, from the child's
    solution ``xc_ext`` already extended by ``Hc`` coarse rows (and at this
    level's y-padding/k columns).  P = (I − diag(s)A)T."""
    k = lv.k
    reach = max(max(abs(d) for d, _ in lv.offsets), max(abs(d) for _, d in lv.offsets))
    Hc = -(-reach // k) + 1
    # upsample: fine row f reads coarse row f//k; xc_ext rows span
    # [−Hc·k, loc+Hc·k) fine rows after repeat
    up = jnp.repeat(xc_ext, k, axis=0)
    up = jnp.repeat(up, k, axis=1)
    H = reach
    lo = k * Hc - H
    rows = (xc_ext.shape[0] - 2 * Hc) * k
    upH = jax.lax.slice(up, (lo, 0), (lo + rows + 2 * H, up.shape[1]))
    upH = _fit_cols(upH, lv.pdims[1])
    A_h = _plane(lv, lv.A, H)
    S_h = _plane(lv, lv.S, H)
    T_h = _plane(lv, lv.T, H)
    Tup = T_h * upH
    corr = Tup - S_h * _stencil(A_h, Tup, lv.offsets)
    return corr[H : corr.shape[0] - H]


def _coarse_solve(h: SlabHierarchy, bc_full):
    """Replicated dense pinv solve on the true coarsest grid
    (coarse_solver.jl:9-16 — singular-safe Moore-Penrose apply)."""
    cW, cH = h.ctrue
    flat = bc_full[:cW, :cH].reshape(cW * cH)
    xg = jnp.matmul(h.pinv, flat, precision=jax.lax.Precision.HIGHEST).reshape(cW, cH)
    return jnp.pad(xg, ((0, h.cpad[0] - cW), (0, h.cpad[1] - cH)))


def _child_cycles(h, li, x0, bc, n_sh, cyc):
    """Recursion policy of multilevel.jl:200-212 applied to the child call:
    V → one cycle; W → two chained W cycles; F → an F cycle then a V."""
    xc = _level_cycle(h, li, x0, bc, n_sh, cyc)
    if cyc == "w":
        xc = _level_cycle(h, li, xc, bc, n_sh, "w")
    elif cyc == "f":
        xc = _level_cycle(h, li, xc, bc, n_sh, "v")
    return xc


def _level_cycle(h: SlabHierarchy, li: int, x, b, n_sh, cyc: str = "v"):
    """One cycle recursion step at level li on local slabs."""
    lv = h.levels[li]
    k = lv.k
    x = _smooth(lv, x, b, n_sh, lv.pre_sm)
    ts = _restrict(lv, x, b, n_sh)

    last = li + 1 >= len(h.levels)
    child = None if last else h.levels[li + 1]
    child_sharded = (child is not None) and child.sharded

    if child_sharded:
        # slab-local subsample: loc divides k by construction
        bc = _subsample(ts, k)
        bc = _fit_cols(bc, child.pdims[1])
        xc = _child_cycles(h, li + 1, jnp.zeros_like(bc), bc, n_sh, cyc)
        # child slabs already aligned: loc_c = loc/k; extend by Hc rows
        reach = max(max(abs(d) for d, _ in lv.offsets), max(abs(d) for _, d in lv.offsets))
        Hc = -(-reach // k) + 1
        xc_ext = _exch(_fit_cols(xc, lv.pdims[1] // k), Hc, True, n_sh)
    else:
        # agglomeration: gather ts to the full grid, subsample replicated
        if lv.sharded and n_sh > 1:
            ts_full = jax.lax.all_gather(ts, AXIS, axis=0, tiled=True)
        else:
            ts_full = ts
        rows = -(-ts_full.shape[0] // k) * k
        cols = -(-ts_full.shape[1] // k) * k
        bc_full = _subsample(
            _fit_rows(_fit_cols(ts_full, cols), rows), k
        )
        if last:
            xcf = _coarse_solve(h, bc_full)
        else:
            bc_full = _fit_rows(_fit_cols(bc_full, child.pdims[1]), child.pdims[0])
            xcf = _child_cycles(h, li + 1, jnp.zeros_like(bc_full), bc_full, n_sh, cyc)
        # slice this shard's coarse rows (+Hc halo) from the replicated grid
        reach = max(max(abs(d) for d, _ in lv.offsets), max(abs(d) for _, d in lv.offsets))
        Hc = -(-reach // k) + 1
        nc_rows = lv.pdims[0] // k  # coarse rows aligned to this level
        xcf = _fit_rows(_fit_cols(xcf, lv.pdims[1] // k), nc_rows)
        if lv.sharded and n_sh > 1:
            loc_c = nc_rows // n_sh
            padded = jnp.pad(xcf, ((Hc, Hc), (0, 0)))
            start = jax.lax.axis_index(AXIS) * loc_c
            xc_ext = jax.lax.dynamic_slice(
                padded,
                (start, jnp.zeros((), start.dtype)),
                (loc_c + 2 * Hc, padded.shape[1]),
            )
        else:
            xc_ext = jnp.pad(xcf, ((Hc, Hc), (0, 0)))

    x = x + _prolong_corr(lv, xc_ext, n_sh)
    x = _smooth(lv, x, b, n_sh, lv.post_sm)
    return x


def _hier_specs(h: SlabHierarchy):
    """shard_map in_specs pytree matching the hierarchy."""
    lv_specs = []
    for lv in h.levels:
        s = P(AXIS, None, None) if lv.sharded else P()
        sA = P(AXIS, None, None, None) if lv.sharded else P()
        lv_specs.append(SlabLevel(
            A=sA, dinv=s, T=s, S=s,
            offsets=lv.offsets, color_tab=lv.color_tab, pre_sm=lv.pre_sm,
            post_sm=lv.post_sm, k=lv.k, dims=lv.dims, pdims=lv.pdims, Hp=lv.Hp,
            sharded=lv.sharded,
        ))
    return SlabHierarchy(
        levels=tuple(lv_specs), pinv=P(),
        ctrue=h.ctrue, cpad=h.cpad, n_sh=h.n_sh,
    )


def _shard_map(kern, mesh, in_specs, out_specs):
    return jax.shard_map(
        kern, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )


def _cycle_tag(cycle) -> str:
    name = type(cycle).__name__.lower() if not isinstance(cycle, str) else cycle.lower()
    if name not in ("v", "w", "f"):
        raise ValueError(f"unknown cycle {cycle!r}")
    return name


def cycle_lattice_sharded(h: SlabHierarchy, x, b, mesh: Mesh, cycle="v"):
    """One V/W/F cycle on slab-sharded grids ([Wxp, Wyp], P('shards', None)).
    Linear in (x, b); call with x = 0 for the preconditioner contract.
    Recursion policy follows multilevel.jl:200-212 exactly."""
    return _cycle_jit(h, x, b, mesh=mesh, cyc=_cycle_tag(cycle))


@partial(jax.jit, static_argnames=("mesh", "cyc"))
def _cycle_jit(h: SlabHierarchy, x, b, mesh: Mesh, cyc: str):
    n_sh = h.n_sh

    def kern(hh, xs, bs):
        return _level_cycle(hh, 0, xs, bs, n_sh, cyc)

    if not h.levels[0].sharded or n_sh == 1:
        return kern(h, x, b)
    f = _shard_map(
        kern, mesh, (_hier_specs(h), P(AXIS, None), P(AXIS, None)), P(AXIS, None)
    )
    return f(h, x, b)


@partial(jax.jit, static_argnames=("mesh",))
def matvec_lattice_sharded(h: SlabHierarchy, x, mesh: Mesh):
    """y = A₀·x on the slab-sharded fine grid (halo-exchange stencil — the
    O(surface) ppermute pattern of parallel/halo.py, on the padded grid)."""
    n_sh = h.n_sh

    def kern(hh, xs):
        lv = hh.levels[0]
        reach = max(max(abs(d) for d, _ in lv.offsets), max(abs(d) for _, d in lv.offsets))
        Xe = _exch(xs, reach, lv.sharded, n_sh)
        A_h = _plane(lv, lv.A, reach)
        y = _stencil(A_h, Xe, lv.offsets)
        return y[reach : y.shape[0] - reach]

    if not h.levels[0].sharded or n_sh == 1:
        return kern(h, x)
    f = _shard_map(kern, mesh, (_hier_specs(h), P(AXIS, None)), P(AXIS, None))
    return f(h, x)


def place_slab_hierarchy(h: SlabHierarchy, mesh: Mesh) -> SlabHierarchy:
    """Commit every slab array onto ``mesh`` with the cycle's shardings:
    sharded levels one slab per device, replicated levels on every device.
    Multi-host: every process holds identical host-side arrays, and this
    makes them global arrays (SURVEY §4 end note)."""
    return jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        h,
        _hier_specs(h),
    )


def solve_lattice_sharded(
    ml: MultiLevel,
    b,
    *,
    mesh: Optional[Mesh] = None,
    n_sh: Optional[int] = None,
    tol: float = 1e-8,
    maxiter: int = 100,
    dtype="float32",
    log: bool = False,
    cycle="v",
):
    """AMG-PCG on the slab-sharded lattice hierarchy: the shard_map cycle as
    preconditioner inside a jitted CG loop (dot products psum over the mesh
    via XLA).  Returns x (+ (iters, relres) with ``log=True``)."""
    if mesh is None:
        devs = jax.devices()
        if n_sh is None:
            n_sh = len(devs)
        mesh = Mesh(np.array(devs[:n_sh]), (AXIS,))
    n_sh = mesh.devices.size

    key = ("slab", jnp.dtype(dtype).name, n_sh)
    if key not in ml._device_cache:
        ml._device_cache[key] = place_slab_hierarchy(
            build_slab_hierarchy(ml, n_sh, dtype=dtype), mesh
        )
    h = ml._device_cache[key]

    Wx, Wy = h.fine_dims
    Wxp, Wyp = h.fine_pdims
    n = Wx * Wy
    dt = jnp.dtype(dtype)
    bg = np.zeros((Wxp, Wyp), dtype=dt)
    bg[:Wx, :Wy] = np.asarray(b, dtype=dt).reshape(Wx, Wy)
    sh = NamedSharding(mesh, P(AXIS, None))
    bg = jax.device_put(bg, sh)

    cyc = _cycle_tag(cycle)
    normb = float(np.linalg.norm(np.asarray(b)))
    x, it, nr = _pcg_sharded(h, bg, tol * normb, maxiter, mesh=mesh, cyc=cyc)
    if jax.process_count() > 1 and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        x_np = np.asarray(multihost_utils.process_allgather(x, tiled=True))
    else:
        x_np = np.asarray(x)
    xout = x_np[:Wx, :Wy].reshape(n)
    if log:
        return xout, int(it), float(nr) / max(normb, 1e-300)
    return xout


@partial(jax.jit, static_argnames=("mesh", "cyc"))
def _pcg_sharded(h: SlabHierarchy, bg, abstol, maxiter, mesh: Mesh, cyc: str):
    """Jitted AMG-PCG on the slab grid (dot products psum over the mesh)."""
    M = lambda r: _cycle_jit(h, jnp.zeros_like(r), r, mesh=mesh, cyc=cyc)
    Amv = lambda v: matvec_lattice_sharded(h, v, mesh)
    hi = jax.lax.Precision.HIGHEST
    x0 = jnp.zeros_like(bg)
    r0 = bg
    z0 = M(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0, precision=hi)

    def cond(st):
        x, r, p, rz, it, nr = st
        return (it < maxiter) & (nr > abstol)

    def body(st):
        x, r, p, rz, it, nr = st
        Ap = Amv(p)
        alpha = rz / jnp.vdot(p, Ap, precision=hi)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz2 = jnp.vdot(r, z, precision=hi)
        p = z + (rz2 / rz) * p
        return (x, r, p, rz2, it + 1, jnp.linalg.norm(r))

    st = (x0, r0, p0, rz0, 0, jnp.linalg.norm(r0))
    x, r, p, rz, it, nr = jax.lax.while_loop(cond, body, st)
    return x, it, nr
