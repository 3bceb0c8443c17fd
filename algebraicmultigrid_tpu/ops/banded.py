"""Gather-free device operator formats: strided-diagonal (SDIA) and dense.

Why this exists: a diagonal-format SpMV (shift + multiply + add) reads x
as contiguous slices and needs no column-index array, so it moves fewer
bytes than the padded-ELL gather form (ops/spmv.py).

AMG hierarchies on grid-like problems are banded exactly where the work is:
2-D Poisson RS levels 0-1 have 5/11 diagonals and hold ~97% of the nnz;
the transfer operators P (n_f×n_c) and R (n_c×n_f) are *rationally-strided*
banded: col ≈ (row·p)/q + offset with a handful of offsets.

:class:`SDIA` represents  y[i] = Σ_k data[k, i] · x[(i·p)//q + off_k]
with static (p, q, offsets).  Evaluation decomposes the row space by
residue r = i mod q: (i·p)//q = m·p + (r·p)//q, so each (offset, residue)
pair is ONE static strided slice of x — elementwise work, fully fusible, no
gather anywhere.  Square banded matrices are the p=q=1 special case.

Small levels fall back to :class:`DenseOp` (one matmul); anything
irregular falls back to gather-ELL (ops/sparse.ELL).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from .sparse import ELL, as_csr, round_up

__all__ = ["SDIA", "DenseOp", "BTOp", "sdia_from_csr", "dense_from_csr", "bt_from_csr", "mat_vec", "op_nnz"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SDIA:
    """Rationally-strided diagonal matrix (see module docstring)."""

    data: jax.Array  # [n_offsets, rows_padded]
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    p: int = dataclasses.field(metadata=dict(static=True))
    q: int = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    rows_padded: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.data.dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseOp:
    """Dense operator for small levels — one matmul per apply."""

    mat: jax.Array  # [rows_padded, cols] (zero rows beyond shape[0])
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    rows_padded: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.mat.dtype


def _candidate_strides(nr: int, nc: int, max_q: int = 8):
    """Candidate rational slopes p/q ≈ nc/nr to probe during detection."""
    seen = []
    ratio = nc / nr
    for q in range(1, max_q + 1):
        p = max(1, round(ratio * q))
        f = Fraction(p, q)
        if (f.numerator, f.denominator) not in seen:
            seen.append((f.numerator, f.denominator))
    return seen


def sdia_from_csr(
    M,
    dtype=None,
    row_pad: int = 8,
    max_offsets: int = 40,
    max_overhead: float = 6.0,
) -> Optional[SDIA]:
    """Try to represent ``M`` as SDIA; None if no candidate stride yields
    ≤ ``max_offsets`` distinct offsets with padding overhead
    (n_offsets·rows/nnz) ≤ ``max_overhead``."""
    M = as_csr(M)
    nr, nc = M.shape
    if nr == 0 or nc == 0 or M.nnz == 0:
        return None
    if dtype is None:
        dtype = M.dtype
    rows = np.repeat(np.arange(nr), np.diff(M.indptr))
    cols = M.indices

    best = None
    for p, q in _candidate_strides(nr, nc):
        base = (rows * p) // q
        offs = cols - base
        uniq = np.unique(offs)
        if len(uniq) > max_offsets:
            continue
        overhead = len(uniq) * nr / M.nnz
        if overhead > max_overhead:
            continue
        if best is None or len(uniq) < best[2]:
            best = (p, q, len(uniq), uniq, offs)
    if best is None:
        return None

    p, q, n_off, uniq, offs = best
    rows_padded = round_up(nr, int(np.lcm(max(row_pad, 1), q)))
    data = np.zeros((n_off, rows_padded), dtype=dtype)
    k_of = {o: k for k, o in enumerate(uniq.tolist())}
    kidx = np.array([k_of[o] for o in offs.tolist()], dtype=np.int64)
    data[kidx, rows] = M.data.astype(dtype)
    return SDIA(
        data=jnp.asarray(data),
        offsets=tuple(int(o) for o in uniq.tolist()),
        p=int(p),
        q=int(q),
        shape=(nr, nc),
        nnz=int(M.nnz),
        rows_padded=int(rows_padded),
    )


def dense_from_csr(M, dtype=None, row_pad: int = 8) -> DenseOp:
    M = as_csr(M)
    nr, nc = M.shape
    if dtype is None:
        dtype = M.dtype
    rows_padded = round_up(max(nr, 1), row_pad)
    mat = np.zeros((rows_padded, nc), dtype=dtype)
    mat[:nr] = M.toarray().astype(dtype)
    return DenseOp(mat=jnp.asarray(mat), shape=(nr, nc), nnz=int(M.nnz), rows_padded=rows_padded)


def _sdia_spmv(A: SDIA, x: jax.Array) -> jax.Array:
    """Σ_k data[k] · x[(i·p)//q + off_k] via static strided slices."""
    p, q = A.p, A.q
    n_rows, n_cols = A.shape
    Mq = A.rows_padded // q  # rows_padded is a multiple of q by construction
    xlen = x.shape[0]

    # Per (offset k, residue r): source index m·p + (r·p)//q + off_k.
    consts = [
        [(r * p) // q + off for r in range(q)] for off in A.offsets
    ]
    flat = [c for row in consts for c in row]
    min_c = min(flat)
    max_src = (Mq - 1) * p + max(flat)
    lo = max(0, -min_c)
    hi = max(0, max_src + 1 - xlen)
    if lo or hi:
        pad = [(lo, hi)] + [(0, 0)] * (x.ndim - 1)
        xp = jnp.pad(x, pad)
    else:
        xp = x

    tail = x.shape[1:]
    y = jnp.zeros((A.rows_padded,) + tail, dtype=jnp.result_type(A.data.dtype, x.dtype))
    for k, off in enumerate(A.offsets):
        dk = A.data[k]
        if x.ndim > 1:
            dk = dk[(...,) + (None,) * (x.ndim - 1)]
        if q == 1:
            c = consts[k][0] + lo
            limit = c + (Mq - 1) * p + 1
            xs = jax.lax.slice(xp, (c,) + (0,) * (x.ndim - 1),
                               (limit,) + tail, (p,) + (1,) * (x.ndim - 1))
            y = y + dk * xs
        else:
            parts = []
            for r in range(q):
                c = consts[k][r] + lo
                limit = c + (Mq - 1) * p + 1
                xs = jax.lax.slice(xp, (c,) + (0,) * (x.ndim - 1),
                                   (limit,) + tail, (p,) + (1,) * (x.ndim - 1))
                parts.append(xs)
            # interleave residues: y_k[m·q + r] = parts[r][m]
            xk = jnp.stack(parts, axis=1).reshape((Mq * q,) + tail)
            y = y + dk * xk
    return y


def _dense_spmv(A: DenseOp, x: jax.Array) -> jax.Array:
    n_cols = A.shape[1]
    return jnp.matmul(A.mat, x[:n_cols], preferred_element_type=A.mat.dtype,
                      precision=jax.lax.Precision.HIGHEST)


def mat_vec(A, x: jax.Array) -> jax.Array:
    """Polymorphic SpMV over the device operator formats."""
    if isinstance(A, SDIA):
        return _sdia_spmv(A, x)
    if isinstance(A, BTOp):
        return _bt_spmv(A, x)
    if isinstance(A, DenseOp):
        return _dense_spmv(A, x)
    if isinstance(A, ELL):
        from .spmv import ell_spmv

        return ell_spmv(A, x)
    from .lattice_op import Lat2D, lat2d_spmv

    if isinstance(A, Lat2D):
        return lat2d_spmv(A, x)
    from .lattice_nd_op import LatND, latnd_spmv

    if isinstance(A, LatND):
        return latnd_spmv(A, x)
    raise TypeError(f"unknown operator format {type(A)}")


def op_nnz(A) -> int:
    return A.nnz


# --------------------------------------------------------------------------
# Block-Toeplitz operators (periodic transfer maps, matmul evaluation)
# --------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BTOp:
    """Block-Toeplitz operator + sparse boundary remainder.

    Structured-coarsening transfer operators P/R repeat with an exact period:
    rows mT+r couple to columns (m+δ)C+c with coefficients B_δ[r, c]
    independent of m (translation invariance of the periodic C-set).  The
    apply is then a handful of small dense matmuls:

        Y[m] = Σ_δ B_δ @ X2[m+δ],   X2 = x reshaped to [·, C]

    — no gathers at all.  Grid-boundary rows deviate from the pattern; the
    difference (actual − block-Toeplitz prediction) is kept as a compacted
    sparse remainder over O(boundary) rows.
    """

    blocks: jax.Array  # [n_delta, T, C]
    rest_rows: jax.Array  # i32[m_rest]
    rest_data: jax.Array  # [m_rest, w]
    rest_cols: jax.Array  # i32[m_rest, w]
    deltas: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    T: int = dataclasses.field(metadata=dict(static=True))
    C: int = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    rows_padded: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.blocks.dtype


def bt_from_csr(
    M,
    dtype=None,
    row_pad: int = 8,
    max_T: int = 2048,
    max_deltas: int = 4,
    max_rest_frac: float = 0.15,
) -> Optional["BTOp"]:
    """Detect an exact block-Toeplitz structure (period from the reduced
    row:col ratio, block coefficients sampled from a mid-domain block-row,
    deviations into the sparse remainder)."""
    M = as_csr(M)
    nr, nc = M.shape
    if nr == 0 or nc == 0 or M.nnz == 0:
        return None
    if dtype is None:
        dtype = M.dtype
    g = int(np.gcd(nr, nc))
    T0, C0 = nr // g, nc // g
    if T0 > max_T or C0 > max_T or g < 4:
        return None
    # The minimal shape-derived period may be a divisor of the true period
    # (boundary-promoted columns, or a semicoarsened axis where the true
    # block is a whole grid column) — probe power-of-two multiples.
    mult = 1
    while True:
        T, C = T0 * mult, C0 * mult
        if T > max_T or C > max_T or nr // T < 4:
            break
        out = _bt_try(M, nr, nc, T, C, dtype, row_pad, max_deltas, max_rest_frac)
        if out is not None:
            return out
        mult *= 2
    return None


def _bt_try(M, nr, nc, T, C, dtype, row_pad, max_deltas, max_rest_frac):
    Mr = nr // T

    rows = np.repeat(np.arange(nr), np.diff(M.indptr))
    cols = M.indices
    m_blk = rows // T
    deltas_all = cols // C - m_blk
    dmin, dmax = int(deltas_all.min()), int(deltas_all.max())
    if dmax - dmin + 1 > max_deltas:
        return None
    deltas = tuple(range(dmin, dmax + 1))

    # Sample block coefficients from a mid-domain block-row.
    m_mid = Mr // 2
    sel = m_blk == m_mid
    blocks = np.zeros((len(deltas), T, C), dtype=dtype)
    r_mid = rows[sel] % T
    d_mid = deltas_all[sel] - dmin
    c_mid = cols[sel] % C
    blocks[d_mid, r_mid, c_mid] = M.data[sel].astype(dtype)

    # Build the predicted operator and the remainder = actual − predicted.
    bd, br, bc = np.nonzero(blocks)
    bv = blocks[bd, br, bc]
    mm = np.arange(Mr)
    # entries: row = m·T + br, col = (m + δ)·C + bc (clipped to valid cols)
    rows_p = (mm[:, None] * T + br[None, :]).ravel()
    cols_p = ((mm[:, None] + bd[None, :] + dmin) * C + bc[None, :]).ravel()
    vals_p = np.broadcast_to(bv[None, :], (Mr, bv.size)).ravel()
    ok = (cols_p >= 0) & (cols_p < nc)
    P_pred = sp.coo_matrix(
        (vals_p[ok], (rows_p[ok], cols_p[ok])), shape=(nr, nc)
    ).tocsr()
    rest = (M - P_pred).tocsr()
    rest.eliminate_zeros()
    if rest.nnz > max_rest_frac * M.nnz:
        return None

    rows_padded = round_up(nr, int(np.lcm(row_pad, T)))

    # Compacted remainder rows.
    rcounts = np.diff(rest.indptr)
    nz_rows = np.flatnonzero(rcounts)
    m_rest = max(int(nz_rows.size), 1)
    w = max(int(rcounts.max()) if rcounts.size else 0, 1)
    rest_rows = np.full(m_rest, rows_padded, dtype=np.int32)  # sentinel
    rest_data = np.zeros((m_rest, w), dtype=dtype)
    rest_cols = np.zeros((m_rest, w), dtype=np.int32)
    for k, i in enumerate(nz_rows):
        lo, hi = rest.indptr[i], rest.indptr[i + 1]
        rest_rows[k] = i
        rest_data[k, : hi - lo] = rest.data[lo:hi].astype(dtype)
        rest_cols[k, : hi - lo] = rest.indices[lo:hi]

    return BTOp(
        blocks=jnp.asarray(blocks),
        rest_rows=jnp.asarray(rest_rows),
        rest_data=jnp.asarray(rest_data),
        rest_cols=jnp.asarray(rest_cols),
        deltas=deltas,
        T=T,
        C=C,
        shape=(nr, nc),
        nnz=int(M.nnz),
        rows_padded=rows_padded,
    )


def _bt_spmv(A: "BTOp", x: jax.Array) -> jax.Array:
    nr, nc = A.shape
    T, C = A.T, A.C
    Mr = A.rows_padded // T
    tail = x.shape[1:]

    # X2[m] = x[mC : (m+1)C]; need block rows m+δ for m in [0, Mr).
    need_lo = -min(min(A.deltas), 0)
    need_hi = max(Mr + max(A.deltas), nc // C) - nc // C
    x_log = x[:nc] if x.shape[0] >= nc else jnp.pad(
        x, [(0, nc - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    )
    Xp = jnp.pad(
        x_log,
        [(need_lo * C, max(need_hi, 0) * C)] + [(0, 0)] * (x.ndim - 1),
    )
    Mc_tot = Xp.shape[0] // C
    X2 = Xp.reshape((Mc_tot, C) + tail)

    # stack shifted views: [Mr, n_delta, C, ...]
    shifted = [
        jax.lax.slice_in_dim(X2, need_lo + d, need_lo + d + Mr, axis=0)
        for d in A.deltas
    ]
    Xs = jnp.stack(shifted, axis=1)
    if x.ndim == 1:
        Y = jnp.einsum(
            "dtc,mdc->mt", A.blocks, Xs, preferred_element_type=A.blocks.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        y = Y.reshape(A.rows_padded)
    else:
        Y = jnp.einsum(
            "dtc,mdck->mtk", A.blocks, Xs, preferred_element_type=A.blocks.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        y = Y.reshape((A.rows_padded,) + tail)

    # boundary remainder: tiny gather + scatter-add
    xg = jnp.take(x_log, A.rest_cols, axis=0)
    if x.ndim == 1:
        contrib = jnp.sum(A.rest_data * xg, axis=1)
    else:
        contrib = jnp.sum(A.rest_data[:, :, None] * xg, axis=1)
    y = y.at[A.rest_rows].add(contrib, mode="drop")
    return y
