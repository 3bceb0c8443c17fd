"""Structured (proxy-extrapolated) setup drivers — RS and SA.

``structured_ruge_stuben(problem, **kwargs)`` / ``structured_smoothed_
aggregation(problem, **kwargs)`` build the same hierarchies the generic
``ruge_stuben(A, CF=StructuredRS())`` / ``smoothed_aggregation(A,
aggregate=StructuredAggregation())`` would produce on a lattice problem, at
O(boundary) cost instead of O(nnz):

1. run the *generic* setup on a small proxy grid (same stencil, same kwargs
   — strength thresholds, smoother configs etc. all take effect),
2. extract per level the (offset × boundary-class) coefficient tables of
   A/P/R with an exact round-trip check (models/lattice.py),
3. re-instantiate the tables at full size as :class:`LatticeMatrix` levels
   (block fills; the device engine lowers them to gather-free Lat2D ops),
4. below the cut (small levels / incompatible dims / extraction failure)
   assemble the coarse operator to scipy and continue with the untouched
   generic setup.

Congruence requirements for step 3 (checked per level; violations cut):

* per-axis coarsening ratio of the proxy must apply exactly to the full dims
  (same ceil/floor-div by the same k, same remainder class mod k),
* full and proxy widths must agree modulo the extracted interior period `s`
  (so residue phases and right-boundary classes line up).

The SA driver replaces the reference's default ``improve_candidates=
GaussSeidel(iter=4)`` with ``Jacobi(0.5, iter=4)``: natural-order GS
propagates boundary deviations across the whole grid in one sweep (decaying
~4× per cell — never exactly zero), which breaks exact translation
invariance; Jacobi's deviation belt is exactly ``iters × stencil reach``
cells, so extraction stays bitwise.  Pass ``improve_candidates=...``
explicitly to override (falls back to generic assembly if extraction then
fails).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..config import GaussSeidel, Jacobi
from ..utils.symmetry import HermitianSymmetry
from .lattice import LatticeMatrix, axis_classes, extract_spec
from .multilevel import Level, MultiLevel
from .structured import StructuredAggregation, StructuredRS

__all__ = [
    "structured_ruge_stuben",
    "structured_smoothed_aggregation",
    "latticify_tail",
]

_MOD = 12  # lcm of supported interior periods {1,2,3,4,6} and box ratios


def _proxy_dims(
    full: Tuple[int, int], target: int, k: int = 2, depth: int = 5
) -> Tuple[int, int]:
    """Proxy grid dims: capped per axis, congruent to the full axis modulo
    ``k**depth`` so every level of the per-axis ceil-div-k coarsening chain
    has matching raggedness (same ``W mod k``, hence identical boundary-block
    structure) down to ``depth`` levels.  The finer residue-phase congruences
    (mod the extracted interior period ``s``) are checked per level by
    ``_phase_ok`` and cut the fast path safely where they fail."""
    mod = k ** depth
    out = []
    for W in full:
        if W <= target:
            out.append(W)
        else:
            pw = target + ((W - target) % mod)
            out.append(pw if pw <= W // 2 else target + ((W - target) % _MOD))
    return tuple(out)


def _coarse_dim_candidates(dims: Tuple[int, int], n_c: int):
    """Factorizations of n_c reachable from dims by per-axis k-coarsening."""
    Wx, Wy = dims
    xs, ys = [], []
    for k in (1, 2, 3, 4):
        xs += [(Wx + k - 1) // k, Wx // k]
        ys += [(Wy + k - 1) // k, Wy // k]
    cands = []
    for cx in dict.fromkeys(xs):
        for cy in dict.fromkeys(ys):
            if cx >= 1 and cy >= 1 and cx * cy == n_c and (cx, cy) not in cands:
                cands.append((cx, cy))
    return cands


def _axis_ratio(pw: int, pc: int) -> Optional[Tuple[int, str]]:
    """(k, 'ceil'|'floor'|'same') relating a proxy axis to its coarse axis."""
    if pc == pw:
        return (1, "same")
    for k in (2, 3, 4):
        if pc == (pw + k - 1) // k:
            return (k, "ceil")
        if pc == pw // k:
            return (k, "floor")
    return None


def _full_coarse_dims(
    pdims: Tuple[int, int], pdims_c: Tuple[int, int], fdims: Tuple[int, int]
) -> Optional[Tuple[int, int]]:
    """Apply the proxy's per-axis coarsening to the full dims; None if the
    full dims can't follow it exactly (ragged-phase mismatch)."""
    out = []
    for pw, pc, fw in zip(pdims, pdims_c, fdims):
        r = _axis_ratio(pw, pc)
        if r is None:
            return None
        k, mode = r
        if mode == "same":
            out.append(fw)
            continue
        if fw % k != pw % k:  # boundary-block size must match
            return None
        out.append((fw + k - 1) // k if mode == "ceil" else fw // k)
    return tuple(out)


def _phase_ok(spec, fdims, pdims) -> bool:
    """Interior residue phases / right-boundary classes line up iff the
    full and proxy widths agree modulo the extracted periods."""
    return (fdims[0] - pdims[0]) % spec.sx == 0 and (
        fdims[1] - pdims[1]
    ) % spec.sy == 0


def extract_grid_vector(v: np.ndarray, dims, K: int = 8):
    """(table, meta) for a boundary-classed grid function (near-null-space
    candidates); None if rows of the same class disagree.  Picks the
    *minimal* interior period per axis so the congruence requirements on
    re-instantiation are as weak as possible."""
    Wx, Wy = dims
    v = np.asarray(v)
    if v.shape[0] != Wx * Wy:
        return None
    for K_try, s in [(k, s) for k in (K, 6, 4) for s in (1, 2, 3, 4, 6)]:
        Kx = K_try if Wx >= 2 * K_try + s else max((Wx - s) // 2, 0)
        Ky = K_try if Wy >= 2 * K_try + s else max((Wy - s) // 2, 0)
        sx = s if Wx > 1 else 1
        sy = s if Wy > 1 else 1
        if 2 * Kx + sx > Wx or 2 * Ky + sy > Wy:
            continue
        cx = axis_classes(np.arange(Wx), Wx, Kx, sx)
        cy = axis_classes(np.arange(Wy), Wy, Ky, sy)
        flat = cx[:, None] * (2 * Ky + sy) + cy[None, :]
        lo = np.full((2 * Kx + sx) * (2 * Ky + sy), np.inf)
        hi = np.full_like(lo, -np.inf)
        np.minimum.at(lo, flat.ravel(), v)
        np.maximum.at(hi, flat.ravel(), v)
        seen = np.zeros(lo.shape, dtype=bool)
        seen[flat.ravel()] = True
        if np.any(seen & (hi != lo)):
            continue
        table = np.where(seen, lo, 0.0).reshape(2 * Kx + sx, 2 * Ky + sy)
        return table, (Kx, sx, Ky, sy)
    return None


def instantiate_grid_vector(table, meta, dims) -> np.ndarray:
    Wx, Wy = dims
    Kx, sx, Ky, sy = meta
    cx = axis_classes(np.arange(Wx), Wx, Kx, sx)
    cy = axis_classes(np.arange(Wy), Wy, Ky, sy)
    return table[cx[:, None], cy[None, :]].ravel()


# --------------------------------------------------------------------------
# shared level walk
# --------------------------------------------------------------------------


def _extrapolate_levels(
    problem: LatticeMatrix,
    ml_p: MultiLevel,
    pdims: Tuple[int, int],
    fdims: Tuple[int, int],
    *,
    cut_rows: int,
    min_proxy_dim: int,
    max_levels: int,
    max_coarse: int,
    presmoother,
    postsmoother,
    B_per_level=None,
):
    """Walk proxy levels, extracting and re-instantiating while valid.

    Returns (fast_levels, spec_A_cut, cut_pdims, cut_fdims, n_extracted).
    spec_A_cut is the full-size spec of the first level NOT instantiated
    (the generic tail's fine operator).
    """
    fast_levels: List[Level] = []
    spec_A = problem.spec
    cur_pdims, cur_fdims = pdims, fdims
    lvl = 0
    while True:
        n_rows = cur_fdims[0] * cur_fdims[1]
        remaining = max_levels - len(fast_levels)
        if (
            lvl >= len(ml_p.levels)
            or n_rows <= cut_rows
            or n_rows <= max_coarse
            or remaining <= 1
            or min(cur_pdims) < min_proxy_dim
        ):
            break

        P_p = sp.csr_matrix(ml_p.levels[lvl].P)
        R_p = sp.csr_matrix(ml_p.levels[lvl].R)
        A_p = sp.csr_matrix(ml_p.levels[lvl].A)
        n_c = P_p.shape[1]

        found = None
        for cd in _coarse_dim_candidates(cur_pdims, n_c):
            sP = extract_spec(P_p, cur_pdims, cd)
            if sP is None:
                continue
            sR = extract_spec(R_p, cd, cur_pdims)
            if sR is None:
                continue
            found = (cd, sP, sR)
            break
        if found is None:
            break
        cd, sP, sR = found
        sA = spec_A if lvl == 0 else extract_spec(A_p, cur_pdims, cur_pdims)
        if sA is None:
            break
        if lvl + 1 < len(ml_p.levels):
            A_next_p = sp.csr_matrix(ml_p.levels[lvl + 1].A)
        else:
            A_next_p = sp.csr_matrix(ml_p.final_A)
        sA_next = extract_spec(A_next_p, cd, cd)
        if sA_next is None:
            break
        fd_c = _full_coarse_dims(cur_pdims, cd, cur_fdims)
        if fd_c is None:
            break
        if not (
            _phase_ok(sA, cur_fdims, cur_pdims)
            and _phase_ok(sP, cur_fdims, cur_pdims)
            and _phase_ok(sR, fd_c, cd)
            and _phase_ok(sA_next, fd_c, cd)
        ):
            break
        if B_per_level is not None:
            # accepting this level moves the tail to `cd`: the coarse
            # near-null-space must be re-instantiable there
            if lvl + 1 >= len(B_per_level):
                break
            gotB = extract_grid_vector(B_per_level[lvl + 1], cd)
            if gotB is None or not _phase_ok_vec(gotB[1], fd_c, cd):
                break

        A_f = (
            problem
            if lvl == 0
            else LatticeMatrix(spec_A.with_dims(cur_fdims, cur_fdims))
        )
        P_f = LatticeMatrix(sP.with_dims(cur_fdims, fd_c))
        R_f = LatticeMatrix(sR.with_dims(fd_c, cur_fdims))
        lvl_f = Level(
            A=A_f,
            P=P_f,
            R=R_f,
            presmoother_config=presmoother,
            postsmoother_config=postsmoother,
            symmetry=HermitianSymmetry(),
        )
        # factored-prolongator extras (SA only): extrapolate the tentative
        # prolongator T and the ω·D̃⁻¹ smoothing scale alongside P/R so the
        # fused device legs can stream T + s + A instead of P/R planes
        T_p = getattr(ml_p.levels[lvl], "T_tent", None)
        s_p = getattr(ml_p.levels[lvl], "psmooth_scale", None)
        if T_p is not None and s_p is not None:
            sT = extract_spec(sp.csr_matrix(T_p), cur_pdims, cd)
            gotS = extract_grid_vector(np.asarray(s_p), cur_pdims)
            if (
                sT is not None
                and gotS is not None
                and _phase_ok(sT, cur_fdims, cur_pdims)
                and _phase_ok_vec(gotS[1], cur_fdims, cur_pdims)
            ):
                lvl_f.T_tent = LatticeMatrix(sT.with_dims(cur_fdims, fd_c))
                lvl_f.psmooth_scale = ("table", gotS[0], gotS[1])
        fast_levels.append(lvl_f)
        spec_A = sA_next
        cur_pdims, cur_fdims = cd, fd_c
        lvl += 1

    return fast_levels, spec_A, cur_pdims, cur_fdims


def latticify_tail(ml: MultiLevel, max_rows: int = 300_000) -> MultiLevel:
    """Direct (proxy-free) lattice extraction of small generic levels.

    Below the proxy-extrapolation cut the actual scipy matrices exist and
    are small, so ``extract_spec`` runs directly on them (O(nnz), exact
    round-trip verified).  Converted levels lower to gather-free Lat2D
    device operators just like the big ones."""
    from .structured import detect_lattice_dims

    for lvl, level in enumerate(ml.levels):
        if isinstance(level.A, LatticeMatrix) or not sp.issparse(level.A):
            continue
        A = sp.csr_matrix(level.A)
        if A.shape[0] > max_rows or A.shape[0] < 4:
            continue
        det = detect_lattice_dims(sp.csc_matrix(A))
        if det is None:
            continue
        dims = det
        nc = level.P.shape[1]
        cd = None
        # min_margin=0: direct extraction of the real operator with an exact
        # round-trip check — the proxy-extrapolation margin rule (never < 8)
        # protects against extrapolating unseen belts, which cannot happen
        # here; tiny grids need per-position boundary classes, and width-2
        # axes need K=0 with a covering interior period
        for cand in _coarse_dim_candidates(dims, nc):
            sP = extract_spec(sp.csr_matrix(level.P), dims, cand, min_margin=0)
            if sP is None:
                continue
            sR = extract_spec(sp.csr_matrix(level.R), cand, dims, min_margin=0)
            if sR is None:
                continue
            cd = (cand, sP, sR)
            break
        if cd is None:
            continue
        sA = extract_spec(A, dims, dims, min_margin=0)
        if sA is None:
            continue
        cand, sP, sR = cd
        level.A = LatticeMatrix(sA)
        level.P = LatticeMatrix(sP)
        level.R = LatticeMatrix(sR)
        T_t = getattr(level, "T_tent", None)
        if T_t is not None and sp.issparse(T_t):
            sT = extract_spec(sp.csr_matrix(T_t), dims, cand, min_margin=0)
            if sT is not None:
                level.T_tent = LatticeMatrix(sT)
        # psmooth_scale stays a full-size vector — cheap at tail sizes
    return ml


def _splice(problem, fast_levels, tail, dtype):
    ml = MultiLevel(
        levels=fast_levels + tail.levels,
        final_A=tail.final_A,
        coarse_solver=tail.coarse_solver,
        symmetry=HermitianSymmetry(),
        dtype=dtype,
    )
    return latticify_tail(ml)


def _too_small(problem, pdims, cut_rows, min_proxy_dim):
    fdims = tuple(problem.spec.row_dims)
    n_full = fdims[0] * fdims[1]
    return (
        n_full <= 4 * cut_rows
        or min(fdims) < 2 * max(pdims)
        or min(pdims) < min_proxy_dim
    )


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------


def structured_ruge_stuben(
    problem: LatticeMatrix,
    *,
    proxy: int = 128,
    cut_rows: int = 40_000,
    min_proxy_dim: int = 16,
    presmoother=None,
    postsmoother=None,
    CF=None,
    max_levels: int = 10,
    max_coarse: int = 10,
    **kwargs,
) -> MultiLevel:
    """Classical AMG for a lattice problem at O(boundary) setup cost.
    Hierarchies are bitwise-equal to ``ruge_stuben(A, CF=StructuredRS())``;
    falls back to the generic path when extraction fails."""
    from .classical import ruge_stuben  # deferred: circular import

    if presmoother is None:
        presmoother = GaussSeidel(ordering="multicolor")
    if postsmoother is None:
        postsmoother = GaussSeidel(ordering="multicolor")
    if CF is None:
        CF = StructuredRS()

    def generic(A_like, levels_left):
        A_csr = A_like.tocsr() if isinstance(A_like, LatticeMatrix) else A_like
        return ruge_stuben(
            A_csr,
            CF=CF,
            presmoother=presmoother,
            postsmoother=postsmoother,
            max_levels=levels_left,
            max_coarse=max_coarse,
            **kwargs,
        )

    fdims = tuple(problem.spec.row_dims)
    pdims = _proxy_dims(fdims, proxy, k=2, depth=6)
    if _too_small(problem, pdims, cut_rows, min_proxy_dim):
        return generic(problem, max_levels)

    A_proxy = problem.spec.with_dims(pdims, pdims).tocsr()
    ml_p = generic(A_proxy, max_levels)

    fast_levels, spec_A_cut, _, cut_fdims = _extrapolate_levels(
        problem,
        ml_p,
        pdims,
        fdims,
        cut_rows=cut_rows,
        min_proxy_dim=min_proxy_dim,
        max_levels=max_levels,
        max_coarse=max_coarse,
        presmoother=presmoother,
        postsmoother=postsmoother,
    )
    if not fast_levels:
        return generic(problem, max_levels)

    A_cut = LatticeMatrix(spec_A_cut.with_dims(cut_fdims, cut_fdims))
    tail = generic(A_cut, max_levels - len(fast_levels))
    return _splice(problem, fast_levels, tail, problem.dtype)


def structured_smoothed_aggregation(
    problem: LatticeMatrix,
    *,
    proxy: int = 256,
    cut_rows: int = 15_000,
    min_proxy_dim: int = 16,
    B=None,
    presmoother=None,
    postsmoother=None,
    aggregate=None,
    improve_candidates=None,
    max_levels: int = 10,
    max_coarse: int = 10,
    **kwargs,
) -> MultiLevel:
    """Smoothed-aggregation AMG for a lattice problem at O(boundary) setup
    cost, using periodic box aggregation (:class:`StructuredAggregation`).

    Matches ``smoothed_aggregation(A, aggregate=StructuredAggregation(),
    improve_candidates=Jacobi(0.5, 4))`` bitwise on the fast levels (see the
    module docstring for why Jacobi replaces natural-order GS here).  Only
    the default near-null-space ``B=ones`` is supported on the fast path;
    custom B assembles and runs the generic pipeline."""
    from .aggregation import smoothed_aggregation  # deferred

    if presmoother is None:
        presmoother = GaussSeidel(ordering="multicolor")
    if postsmoother is None:
        postsmoother = GaussSeidel(ordering="multicolor")
    if aggregate is None:
        aggregate = StructuredAggregation()
    if improve_candidates is None:
        improve_candidates = Jacobi(omega=0.5, iter=4)

    def generic(A_like, levels_left, B_arg=None):
        A_csr = A_like.tocsr() if isinstance(A_like, LatticeMatrix) else A_like
        return smoothed_aggregation(
            A_csr,
            B=B_arg,
            aggregate=aggregate,
            improve_candidates=improve_candidates,
            presmoother=presmoother,
            postsmoother=postsmoother,
            max_levels=levels_left,
            max_coarse=max_coarse,
            **kwargs,
        )

    fdims = tuple(problem.spec.row_dims)
    box = aggregate.box if isinstance(aggregate, StructuredAggregation) else 3
    pdims = _proxy_dims(fdims, proxy, k=box, depth=4)
    if B is not None or _too_small(problem, pdims, cut_rows, min_proxy_dim):
        return generic(problem, max_levels, B)

    A_proxy = problem.spec.with_dims(pdims, pdims).tocsr()
    ml_p = generic(A_proxy, max_levels)

    B_per_level = getattr(ml_p, "_B_per_level", None)
    fast_levels, spec_A_cut, cut_pdims, cut_fdims = _extrapolate_levels(
        problem,
        ml_p,
        pdims,
        fdims,
        cut_rows=cut_rows,
        min_proxy_dim=min_proxy_dim,
        max_levels=max_levels,
        max_coarse=max_coarse,
        presmoother=presmoother,
        postsmoother=postsmoother,
        B_per_level=B_per_level if B_per_level is not None else [],
    )
    if not fast_levels:
        return generic(problem, max_levels, B)

    # the tail's fine-level near-null-space, re-instantiated at full size
    # (extractability at the cut was enforced inside the walk)
    n_cut = len(fast_levels)
    got = extract_grid_vector(B_per_level[n_cut], cut_pdims)
    B_cut_full = instantiate_grid_vector(got[0], got[1], cut_fdims)

    A_cut = LatticeMatrix(spec_A_cut.with_dims(cut_fdims, cut_fdims))
    tail = generic(A_cut, max_levels - n_cut, B_cut_full)
    return _splice(problem, fast_levels, tail, problem.dtype)


def _phase_ok_vec(meta, fdims, pdims) -> bool:
    Kx, sx, Ky, sy = meta
    return (fdims[0] - pdims[0]) % sx == 0 and (fdims[1] - pdims[1]) % sy == 0
