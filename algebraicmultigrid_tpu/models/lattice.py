"""Proxy-extrapolated structured setup — O(boundary) hierarchy construction.

The generic setup pipeline (strength → splitting → interpolation → Galerkin
RAP, survey §3.1) costs O(nnz) per level on the host.  For lattice problems
(boundary-clipped stencils on an N-D grid — the reference's whole gallery,
``src/gallery.jl``) every level operator produced by
:class:`~.structured.StructuredRS` coarsening is *translation invariant away
from the grid boundary*: its coefficients depend only on

* the geometric offset ``(dx, dy)`` between the row's and column's lattice
  points,
* the row's residue class (``ix mod s_x``, ``iy mod s_y`` for a small period
  ``s`` — e.g. the red/black parity of rotated coarse lattices), and
* the row's *boundary class* (distance from each grid edge, up to a margin
  ``K``) — interior rows all share one class.

None of those depend on the grid size.  So the full hierarchy can be built by

1. running the **real generic setup on a small proxy grid** (e.g. 64×64),
2. extracting, per level and per operator (A, P, R), the finite coefficient
   table indexed by ``(offset, x-class, y-class)``, with an exact round-trip
   check against the proxy matrices, and
3. instantiating the tables at full size — a handful of rectangular block
   fills per operator instead of O(nnz) graph algorithms.

The fast path covers levels while the full-size level dims stay even and
large; the remaining (small) coarse levels are assembled to scipy and fed to
the ordinary generic setup, so semantics below the cut are untouched.  Any
extraction failure falls back to the generic path.

This is the answer to "setup is a sequential host bottleneck": the
per-level cost becomes independent of n (hypre's structured PFMG makes the
same trade, but here the coefficients still come from the *algebraic*
pipeline, so the hierarchy matches the generic one exactly — interior
coefficients bitwise, boundary coefficients bitwise, level sizes exactly).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

__all__ = [
    "LatticeSpec",
    "LatticeMatrix",
    "LatticeProblem",
    "extract_spec",
    "axis_classes",
    "class_populations",
    "lattice_coloring",
]


# --------------------------------------------------------------------------
# axis class machinery
# --------------------------------------------------------------------------
#
# For an axis of width W with boundary margin K and interior period s, the
# class of position c (0 ≤ c < W) is:
#     c            (left boundary)            if c < K
#     K + (c % s)  (interior, by residue)     if K ≤ c < W - K
#     K + s + (c - (W - K))  (right boundary) if c ≥ W - K
# Total classes: K + s + K.  Requires W ≥ 2K + s (so classes don't overlap);
# width-1 axes use K=0, s=1 (a single class).


def axis_classes(coords: np.ndarray, W: int, K: int, s: int) -> np.ndarray:
    c = coords
    inner = K + (c % s)
    right = K + s + (c - (W - K))
    return np.where(c < K, c, np.where(c < W - K, inner, right))


def n_axis_classes(K: int, s: int) -> int:
    return 2 * K + s


def class_populations(W: int, K: int, s: int) -> np.ndarray:
    """How many axis positions map to each class (for exact nnz counts)."""
    pops = np.zeros(n_axis_classes(K, s), dtype=np.int64)
    pops[:K] = 1
    pops[K + s :] = 1
    inner = W - 2 * K
    base, rem = divmod(inner, s)
    pops[K : K + s] = base
    # interior positions start at K: residues K%s, K%s+1, ... get the extras
    for t in range(rem):
        pops[K + (K + t) % s] += 1
    return pops


def _axis_params(W: int, K: int, s: int) -> Tuple[int, int]:
    """Clamp (K, s) to what an axis of width W supports."""
    if W <= 1:
        return 0, 1
    while 2 * K + s > W and K > 0:
        K -= 1
    if 2 * K + s > W:
        s = 1
    return K, s


# --------------------------------------------------------------------------
# spec container
# --------------------------------------------------------------------------


def derive_base(Wr: int, Wc: int) -> Optional[Tuple[int, int]]:
    """Per-axis rational base (p, q): column point of row position ``i`` is
    ``(i*p)//q``.  Covers same-size (1,1), k-fine rows (1,k) — base ``i//k``
    for halving/box-k coarsened columns (exact or ceil-ragged) — and k-coarse
    rows (k,1) — base ``k*i`` for restrictions."""
    if Wc == Wr:
        return (1, 1)
    if Wc < Wr:
        k = round(Wr / Wc)
        if k >= 2 and Wc in ((Wr + k - 1) // k, Wr // k) and (Wr - 1) // k <= Wc - 1:
            return (1, k)
        return None
    k = round(Wc / Wr)
    if k >= 2 and Wr in ((Wc + k - 1) // k, Wc // k) and (Wr - 1) * k <= Wc - 1:
        return (k, 1)
    return None


@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    """Coefficient table of a translation-invariant-with-boundary operator.

    ``table[k, cx, cy]`` is the coefficient of geometric offset
    ``offsets[k] = (dx, dy)`` for rows in x-class ``cx`` / y-class ``cy``.
    Row grid ``row_dims = (WxR, WyR)``; column grid ``col_dims``; the column
    lattice point of row ``(ix, iy)`` at offset ``(dx, dy)`` is
    ``((ix*px)//qx + dx, (iy*py)//qy + dy)`` with the per-axis rational bases
    ``base_x = (px, qx)``, ``base_y = (py, qy)`` (out-of-range → no entry,
    which the table encodes as an explicit 0 at the boundary class).
    """

    offsets: Tuple[Tuple[int, int], ...]
    table: np.ndarray  # [n_off, n_xcls, n_ycls]
    row_dims: Tuple[int, int]
    col_dims: Tuple[int, int]
    Kx: int
    sx: int
    Ky: int
    sy: int
    base_x: Tuple[int, int] = (1, 1)
    base_y: Tuple[int, int] = (1, 1)

    def with_dims(self, row_dims: Tuple[int, int], col_dims: Tuple[int, int]) -> "LatticeSpec":
        # the rational bases are scale-free; validate they still apply
        for (W_r, W_c, b) in (
            (row_dims[0], col_dims[0], self.base_x),
            (row_dims[1], col_dims[1], self.base_y),
        ):
            p, q = b
            assert ((W_r - 1) * p) // q <= W_c - 1, (row_dims, col_dims, b)
        return dataclasses.replace(self, row_dims=tuple(row_dims), col_dims=tuple(col_dims))

    @property
    def dtype(self):
        return self.table.dtype

    # --- exact structural counts -------------------------------------------
    def nnz(self) -> int:
        WxR, WyR = self.row_dims
        WxC, WyC = self.col_dims
        px = class_populations(WxR, self.Kx, self.sx)
        py = class_populations(WyR, self.Ky, self.sy)
        nz = self.table != 0
        # valid range of the column point must also be checked: interior
        # offsets never leave the grid (they'd be 0 at boundary classes by
        # construction of the extraction), so the count is just table-driven.
        return int(np.einsum("kxy,x,y->", nz.astype(np.int64), px, py))

    # --- expansions ----------------------------------------------------------
    def row_class_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        WxR, WyR = self.row_dims
        cx = axis_classes(np.arange(WxR), WxR, self.Kx, self.sx)
        cy = axis_classes(np.arange(WyR), WyR, self.Ky, self.sy)
        return cx, cy

    def _axis_selectors(self, W: int, K: int, s: int):
        """Per-class index selectors along one axis — slices, not gathers."""
        sel = []
        for c in range(K):
            sel.append(c)  # left boundary singleton
        for r in range(s):
            # interior positions p ∈ [K, W-K) with p % s == (K + r) % s...
            # class K+r holds residue r' = (p % s); anchor so class K+(p%s).
            start = K + ((r - K) % s)
            sel.append(slice(start, W - K, s))
        for t in range(K):
            sel.append(W - K + t)  # right boundary singleton
        return sel

    def expand(self, k: int, dtype=None, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Full [WxR, WyR] coefficient grid for offset k via strided block
        fills (O(n) memset-speed writes; no gathers)."""
        WxR, WyR = self.row_dims
        T = self.table[k]
        if dtype is None:
            dtype = T.dtype
        if out is None:
            out = np.empty((WxR, WyR), dtype=dtype)
        sx = self._axis_selectors(WxR, self.Kx, self.sx)
        sy = self._axis_selectors(WyR, self.Ky, self.sy)
        # classes are disjoint → order irrelevant; each cell is one strided
        # rectangular fill (constant rows collapse to a single fill).
        for cx, ix_sel in enumerate(sx):
            row = T[cx]
            if row.size and np.all(row == row[0]):
                out[ix_sel] = row[0]
                continue
            for cy, iy_sel in enumerate(sy):
                out[ix_sel, iy_sel] = row[cy]
        return out

    def expand_all(self, dtype=None) -> np.ndarray:
        WxR, WyR = self.row_dims
        if dtype is None:
            dtype = self.table.dtype
        out = np.empty((len(self.offsets), WxR, WyR), dtype=dtype)
        for k in range(len(self.offsets)):
            self.expand(k, dtype=dtype, out=out[k])
        return out

    def diagonal(self) -> np.ndarray:
        """Row-grid diagonal values (square operators)."""
        for k, (dx, dy) in enumerate(self.offsets):
            if dx == 0 and dy == 0:
                return self.expand(k).ravel()
        WxR, WyR = self.row_dims
        return np.zeros(WxR * WyR, dtype=self.table.dtype)

    # --- scipy instantiation (tail / tests / host engine) --------------------
    def tocsr(self) -> sp.csr_matrix:
        WxR, WyR = self.row_dims
        WxC, WyC = self.col_dims
        n_r, n_c = WxR * WyR, WxC * WyC
        ix = np.arange(WxR)
        iy = np.arange(WyR)
        bx = (ix * self.base_x[0]) // self.base_x[1]
        by = (iy * self.base_y[0]) // self.base_y[1]
        rows_grid = (ix[:, None] * WyR + iy[None, :])
        rows_acc, cols_acc, vals_acc = [], [], []
        for k, (dx, dy) in enumerate(self.offsets):
            V = self.expand(k)
            jx = bx + dx
            jy = by + dy
            okx = (jx >= 0) & (jx < WxC)
            oky = (jy >= 0) & (jy < WyC)
            mask = okx[:, None] & oky[None, :] & (V != 0)
            if not mask.any():
                continue
            cols_grid = np.clip(jx, 0, WxC - 1)[:, None] * WyC + np.clip(jy, 0, WyC - 1)[None, :]
            rows_acc.append(rows_grid[mask])
            cols_acc.append(cols_grid[mask])
            vals_acc.append(V[mask])
        if not rows_acc:
            return sp.csr_matrix((n_r, n_c), dtype=self.table.dtype)
        M = sp.coo_matrix(
            (np.concatenate(vals_acc), (np.concatenate(rows_acc), np.concatenate(cols_acc))),
            shape=(n_r, n_c),
        ).tocsr()
        M.sum_duplicates()
        M.sort_indices()
        return M

    # --- numpy matvec (host engine without materialisation) ------------------
    def matvec(self, x: np.ndarray) -> np.ndarray:
        WxR, WyR = self.row_dims
        WxC, WyC = self.col_dims
        tail = x.shape[1:]
        X = x[: WxC * WyC].reshape((WxC, WyC) + tail)
        mx = max((abs(dx) for dx, _ in self.offsets), default=0)
        my = max((abs(dy) for _, dy in self.offsets), default=0)
        Xp = np.pad(X, [(mx, mx), (my, my)] + [(0, 0)] * len(tail))
        ix = np.arange(WxR)
        iy = np.arange(WyR)
        bx = (ix * self.base_x[0]) // self.base_x[1]
        by = (iy * self.base_y[0]) // self.base_y[1]
        y = np.zeros((WxR, WyR) + tail, dtype=np.result_type(self.table.dtype, x.dtype))
        for k, (dx, dy) in enumerate(self.offsets):
            V = self.expand(k)
            if tail:
                V = V[(...,) + (None,) * len(tail)]
            y += V * Xp[np.ix_(bx + dx + mx, by + dy + my)]
        return y.reshape((WxR * WyR,) + tail)


# --------------------------------------------------------------------------
# extraction from a proxy matrix
# --------------------------------------------------------------------------


def extract_spec(
    M,
    row_dims: Tuple[int, int],
    col_dims: Tuple[int, int],
    *,
    K: int = 6,
    max_offsets: int = 64,
    verify: bool = True,
    min_margin: int = 8,
) -> Optional[LatticeSpec]:
    """Extract the (offset, class) coefficient table of a proxy operator.

    Returns None if the operator is not lattice-structured under these dims
    (too many distinct offsets, or same-class rows disagree).  When
    ``verify``, the extracted spec is round-tripped through :meth:`tocsr`
    and compared exactly against ``M`` — extraction cannot silently corrupt
    an operator.

    ``min_margin`` guards the PROXY-extrapolation path (see SAFETY below);
    callers extracting a full-size operator directly (no extrapolation, round
    trip exact — e.g. fastsetup.latticify_tail) may pass ``min_margin=1`` so
    tiny grids, whose every position can be its own boundary class, still
    extract.
    """
    M = sp.csr_matrix(M)
    if M.nnz and np.count_nonzero(M.data) != M.nnz:
        # cancellation zeros from SpGEMM would break nnz checks
        M = M.copy()
        M.eliminate_zeros()
    M.sort_indices()
    WxR, WyR = row_dims
    WxC, WyC = col_dims
    if M.shape != (WxR * WyR, WxC * WyC) or M.nnz == 0:
        return None

    base_x = derive_base(WxR, WxC)
    base_y = derive_base(WyR, WyC)
    if base_x is None or base_y is None:
        return None

    rows = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
    cols = M.indices
    ix = rows // WyR
    iy = rows % WyR
    jx = cols // WyC
    jy = cols % WyC
    dx = jx - (ix * base_x[0]) // base_x[1]
    dy = jy - (iy * base_y[0]) // base_y[1]

    # offset vocabulary + per-entry offset key in ONE unique pass over packed
    # int64 keys (np.unique with axis= sorts structured views — ~10× slower;
    # and the key is (Kx, sx)-independent, so hoisting it out of _try_extract
    # removes a per-candidate O(nnz) pass)
    packed = dx.astype(np.int64) * (1 << 32) + (dy.astype(np.int64) + (1 << 31))
    # vocabulary from a sample + searchsorted keys: O(nnz·log n_off) instead
    # of a full O(nnz·log nnz) sort.  A lattice operator's few boundary-only
    # offsets all appear within the first few rows' worth of entries and in
    # the strided probe; if the sample missed one, the membership check fails
    # and the full unique runs.
    nnz = packed.shape[0]
    if nnz > 200_000:
        probe = np.concatenate([packed[:65536], packed[:: max(1, nnz // 65536)]])
        uniq = np.unique(probe)
        kidx = np.searchsorted(uniq, packed)
        np.minimum(kidx, len(uniq) - 1, out=kidx)
        if not np.array_equal(uniq[kidx], packed):
            uniq, kidx = np.unique(packed, return_inverse=True)
    else:
        uniq, kidx = np.unique(packed, return_inverse=True)
    if len(uniq) > max_offsets:
        return None
    offs_dx = np.floor_divide(uniq, 1 << 32)  # signed-lex order == unique(axis=0)
    offs_dy = (uniq - offs_dx * (1 << 32)) - (1 << 31)
    offs = np.stack([offs_dx, offs_dy], axis=1)
    dmax_x = int(np.abs(offs_dx).max())
    dmax_y = int(np.abs(offs_dy).max())

    # Interior periods: 2 for red-black-type parities, 3 for box aggregation,
    # products for mixes.  Boundary margins K escalate: candidate-improvement
    # smoothers push deviation belts ~(iters × stencil reach) cells inward.
    #
    # SAFETY: margins are never clamped below ``min_margin`` on an axis wider
    # than 1 — a proxy level too narrow to contain the belt PLUS a genuine
    # interior would pass the on-proxy consistency check while freezing
    # outer-belt values as "interior" constants (observed as ~1e-10 errors in
    # deep instantiated operators).  Too-narrow levels must fail extraction
    # so the driver cuts to the generic tail instead.
    min_margin = max(0, min_margin)
    K_list = [max(K, min_margin), K + 3, K + 6]
    if min_margin < 8:
        # direct-extraction mode: small margins are sound (verified exactly),
        # so sweep down to min_margin for grids too narrow for the defaults
        K_list += list(range(max(K, min_margin) - 1, min_margin - 1, -1))
    for K_try in K_list:
        for s in (1, 2, 3, 4, 6):
            Kx, sx = _axis_params(WxR, K_try, s)
            Ky, sy = _axis_params(WyR, K_try, s)
            if (WxR > 1 and Kx < min_margin) or (WyR > 1 and Ky < min_margin):
                continue
            # margins must also cover the offset reach so clipped entries
            # always land in a boundary class
            if WxR > 1 and Kx < min(dmax_x + 1, (WxR - sx) // 2):
                Kx = min(dmax_x + 1, (WxR - sx) // 2)
            if WyR > 1 and Ky < min(dmax_y + 1, (WyR - sy) // 2):
                Ky = min(dmax_y + 1, (WyR - sy) // 2)
            if 2 * Kx + sx > WxR or 2 * Ky + sy > WyR:
                continue
            spec = _try_extract(
                M, kidx, ix, iy, offs, row_dims, col_dims, Kx, sx, Ky, sy,
                base_x, base_y,
            )
            if spec is None:
                continue
            if verify:
                R = spec.tocsr()
                if R.shape != M.shape or R.nnz != M.nnz:
                    continue
                D = (R - M).tocoo()
                if D.nnz and np.abs(D.data).max() != 0:
                    continue
            return spec
    return None


def _try_extract(
    M, kidx, ix, iy, offs, row_dims, col_dims, Kx, sx, Ky, sy, base_x, base_y
):
    n_off = len(offs)
    nxc = n_axis_classes(Kx, sx)
    nyc = n_axis_classes(Ky, sy)
    WxR, WyR = row_dims

    if np.iscomplexobj(M.data):
        return None  # complex lattices unsupported (SA complex errors anyway)
    vals = M.data

    cxe = axis_classes(ix, WxR, Kx, sx)
    cye = axis_classes(iy, WyR, Ky, sy)
    flat = (kidx * nxc + cxe) * nyc + cye

    # same-class consistency: scatter one representative per cell (last write
    # wins), then every entry must equal its cell's representative — two
    # vectorised passes instead of the (slow) ufunc-.at min/max reductions
    table = np.zeros(n_off * nxc * nyc, dtype=M.data.dtype)
    table[flat] = vals
    if not np.array_equal(table[flat], vals):
        return None
    seen = np.zeros(n_off * nxc * nyc, dtype=bool)
    seen[flat] = True

    # occupancy consistency: within a class, either all rows have the entry
    # or none do.  Count rows per (class pair) and entries per cell.
    cnt = np.bincount(flat, minlength=n_off * nxc * nyc)
    px = class_populations(WxR, Kx, sx)
    py = class_populations(WyR, Ky, sy)
    pop = (px[:, None] * py[None, :]).ravel()  # rows per class pair
    pop_full = np.tile(pop, n_off)
    ok = (cnt == 0) | (cnt == pop_full)
    if not ok.all():
        return None

    table = table.reshape(n_off, nxc, nyc)
    return LatticeSpec(
        offsets=tuple((int(a), int(b)) for a, b in offs),
        table=table,
        row_dims=tuple(row_dims),
        col_dims=tuple(col_dims),
        Kx=Kx,
        sx=sx,
        Ky=Ky,
        sy=sy,
        base_x=base_x,
        base_y=base_y,
    )


# --------------------------------------------------------------------------
# periodic multicolor ordering
# --------------------------------------------------------------------------


def lattice_coloring(spec: LatticeSpec, max_period: int = 6):
    """Minimal periodic proper coloring of a square lattice operator.

    Searches small per-axis periods (a, b) and greedy-colors the a×b torus
    so that no two rows coupled by ANY nonzero offset share a color —
    exactly the independence the multicolor GS sweep needs, at O(1) cost
    (the generic path runs an O(nnz) greedy graph coloring instead).

    Returns ``(color_grid[a, b], n_colors)`` or None if no small period
    works (caller falls back to the generic coloring).
    """
    offs = [
        (dx, dy)
        for k, (dx, dy) in enumerate(spec.offsets)
        if (dx, dy) != (0, 0) and np.any(spec.table[k])
    ]
    if not offs:
        return np.zeros((1, 1), dtype=np.int32), 1
    best = None
    for a in range(1, max_period + 1):
        for b in range(1, max_period + 1):
            if any(dx % a == 0 and dy % b == 0 for dx, dy in offs):
                continue  # an offset maps a cell to itself — uncolorable
            colors = -np.ones((a, b), dtype=np.int32)
            for u in range(a):
                for v in range(b):
                    used = set()
                    for dx, dy in offs:
                        for sxn, syn in ((dx, dy), (-dx, -dy)):
                            w = colors[(u + sxn) % a, (v + syn) % b]
                            if w >= 0:
                                used.add(int(w))
                    c = 0
                    while c in used:
                        c += 1
                    colors[u, v] = c
            nc = int(colors.max()) + 1
            if best is None or nc < best[1] or (nc == best[1] and a * b < best[0].size):
                best = (colors, nc)
    return best


# --------------------------------------------------------------------------
# user-facing lattice operator objects
# --------------------------------------------------------------------------


class LatticeMatrix:
    """Full-size lattice operator defined by a :class:`LatticeSpec`.

    Duck-types the scipy matrix surface the hierarchy machinery touches —
    ``shape``, ``nnz``, ``dtype``, ``@``, ``diagonal()``, ``tocsr()`` — while
    materialising nothing until asked.  The device engine lowers it straight
    to the gather-free Lat2D format without ever forming CSR.
    """

    def __init__(self, spec: LatticeSpec):
        self.spec = spec
        self._csr = None
        self._nnz = None

    @property
    def shape(self):
        WxR, WyR = self.spec.row_dims
        WxC, WyC = self.spec.col_dims
        return (WxR * WyR, WxC * WyC)

    @property
    def dtype(self):
        return self.spec.table.dtype

    @property
    def nnz(self) -> int:
        if self._nnz is None:
            self._nnz = self.spec.nnz()
        return self._nnz

    def __matmul__(self, x):
        return self.spec.matvec(np.asarray(x))

    def dot(self, x):
        return self @ x

    def diagonal(self) -> np.ndarray:
        return self.spec.diagonal()

    def tocsr(self) -> sp.csr_matrix:
        if self._csr is None:
            self._csr = self.spec.tocsr()
        return self._csr

    def tocsc(self) -> sp.csc_matrix:
        return self.tocsr().tocsc()

    def toarray(self) -> np.ndarray:
        return self.tocsr().toarray()

    def __repr__(self):
        return (
            f"LatticeMatrix({self.shape[0]}x{self.shape[1]}, "
            f"{len(self.spec.offsets)} offsets, dims {self.spec.row_dims}"
            f"->{self.spec.col_dims})"
        )


class LatticeProblem(LatticeMatrix):
    """Symbolic boundary-clipped stencil operator on an N-D grid.

    The lattice-native form of :func:`~.gallery.stencil_grid`: holds only the
    stencil and grid dims, so problems far larger than host memory for scipy
    assembly can enter the structured setup directly.
    """

    def __init__(self, stencil: np.ndarray, dims: Sequence[int], dtype=np.float64):
        stencil = np.asarray(stencil, dtype=dtype)
        dims = tuple(int(d) for d in dims)
        if stencil.ndim == 1:
            stencil = stencil[None, :]
        if len(dims) == 1:
            dims = (1,) + dims
        if stencil.ndim != 2 or len(dims) != 2:
            raise ValueError("LatticeProblem supports 1-D and 2-D grids")
        # NOTE index order: gallery.stencil_grid numbers grid points
        # column-major (Julia LinearIndices parity, gallery.jl:14) — linear
        # index i = y*ny... here we use i = ix*Wy + iy with (Wx, Wy) =
        # (dims[1], dims[0]) so that LatticeProblem(st, (nx, ny)).tocsr()
        # equals stencil_grid(st, (nx, ny)).
        nx, ny = dims
        Wx, Wy = ny, nx  # column-major: second axis is the slow (outer) one
        kx, ky = stencil.shape
        ox, oy = (kx + 1) // 2 - 1, (ky + 1) // 2 - 1
        offsets = []
        vals = []
        for a in range(kx):
            for b in range(ky):
                v = stencil[a, b]
                if v == 0:
                    continue
                # stencil axis 0 = grid axis 0 = fast axis (iy here)
                offsets.append((b - oy, a - ox))
                vals.append(v)
        K = max(
            max((abs(d[0]) for d in offsets), default=0),
            max((abs(d[1]) for d in offsets), default=0),
        )
        Kx, sx = _axis_params(Wx, K, 1)
        Ky, sy = _axis_params(Wy, K, 1)
        nxc, nyc = n_axis_classes(Kx, sx), n_axis_classes(Ky, sy)
        table = np.zeros((len(offsets), nxc, nyc), dtype=dtype)
        # boundary clipping: offset (dx, dy) is absent for rows whose column
        # point would leave the grid — zero at the affected boundary classes.
        cx = axis_classes(np.arange(Wx), Wx, Kx, sx)
        cy = axis_classes(np.arange(Wy), Wy, Ky, sy)
        for k, ((dxo, dyo), v) in enumerate(zip(offsets, vals)):
            okx = np.zeros(nxc, dtype=bool)
            oky = np.zeros(nyc, dtype=bool)
            jx = np.arange(Wx) + dxo
            jy = np.arange(Wy) + dyo
            okx_pos = (jx >= 0) & (jx < Wx)
            oky_pos = (jy >= 0) & (jy < Wy)
            # a class is "ok" iff every position in it is ok; extraction-style
            # per-class all-or-nothing holds since margins cover the reach
            for c in range(nxc):
                m = cx == c
                okx[c] = okx_pos[m].all() if m.any() else False
            for c in range(nyc):
                m = cy == c
                oky[c] = oky_pos[m].all() if m.any() else False
            table[k][np.ix_(okx, oky)] = v
        spec = LatticeSpec(
            offsets=tuple(offsets),
            table=table,
            row_dims=(Wx, Wy),
            col_dims=(Wx, Wy),
            Kx=Kx,
            sx=sx,
            Ky=Ky,
            sy=sy,
        )
        super().__init__(spec)
        self.stencil = stencil
        self.dims = dims
