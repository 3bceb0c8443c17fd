"""Sparse containers for the AMG framework.

Two tiers:

* Host tier — ``scipy.sparse`` CSC/CSR matrices drive the (run-once) hierarchy
  setup phase.  The reference library stores everything as Julia
  ``SparseMatrixCSC`` (see ``/root/reference/src/AlgebraicMultigrid.jl``);
  scipy's CSC has the identical layout so all setup algorithms carry over
  behaviourally while being vectorised numpy instead of scalar loops.

* Device tier — :class:`ELL` is an immutable, static-shape, padded
  sparse-row format registered as a JAX pytree.  Every row is padded to the
  same width so all solve-phase kernels (SpMV, smoothers) are dense-regular
  gathers/reductions that XLA fuses into one loop; there is no dynamic shape
  anywhere under ``jit``.  Padding entries point at column 0 with value 0, so
  gathers stay in bounds and contribute nothing.

This file intentionally has no counterpart in the reference — the reference
has no device format at all (it is single-threaded CPU Julia; survey §2.13).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

__all__ = [
    "ELL",
    "as_csr",
    "as_csc",
    "ell_from_csr",
    "ell_to_scipy",
    "bandwidth",
    "rcm_permutation",
    "round_up",
]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def as_csr(A: Any) -> sp.csr_matrix:
    """Coerce any array-like / scipy / lattice matrix to canonical CSR
    (sorted, no dupes).  Symbolic lattice operators materialise here (the
    host tier's prerogative; the device tier lowers them without CSR)."""
    if sp.issparse(A):
        M = A.tocsr()
    elif hasattr(A, "tocsr"):
        M = sp.csr_matrix(A.tocsr())
    else:
        M = sp.csr_matrix(np.asarray(A))
    M.sum_duplicates()
    M.sort_indices()
    return M


def as_csc(A: Any) -> sp.csc_matrix:
    """Coerce to canonical CSC (the reference's native layout)."""
    if sp.issparse(A):
        M = A.tocsc()
    elif hasattr(A, "tocsc"):
        M = sp.csc_matrix(A.tocsc())
    else:
        M = sp.csc_matrix(np.asarray(A))
    M.sum_duplicates()
    M.sort_indices()
    return M


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded sparse-row (ELLPACK) matrix — the device solve-phase format.

    ``data[i, k]`` / ``cols[i, k]`` hold the k-th stored entry of row ``i``.
    Rows are padded with ``(col=0, val=0)`` up to ``width``; the row count is
    padded up to a multiple of ``row_pad`` so sharded layouts divide evenly.

    Attributes
    ----------
    data:  float[rows_padded, width] nonzero values (zero on padding slots).
    cols:  int32[rows_padded, width] column index per slot (0 on padding).
    shape: logical (n_rows, n_cols) — static metadata.
    nnz:   logical number of structural nonzeros — static metadata.
    """

    data: jax.Array
    cols: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def rows_padded(self) -> int:
        return self.data.shape[0]


def ell_from_csr(
    A: Any,
    dtype=None,
    row_pad: int = 8,
    min_width: int = 1,
) -> ELL:
    """Convert a host sparse matrix to the padded device :class:`ELL` format.

    ``row_pad`` pads the row count to a multiple (the parallel tier passes
    ``8·n_shards`` so row blocks divide evenly).
    """
    M = as_csr(A)
    n_rows, n_cols = M.shape
    counts = np.diff(M.indptr)
    width = max(int(counts.max()) if counts.size else 0, min_width)
    rows_padded = max(round_up(max(n_rows, 1), row_pad), row_pad)

    if dtype is None:
        dtype = M.dtype
    data = np.zeros((rows_padded, width), dtype=dtype)
    cols = np.zeros((rows_padded, width), dtype=np.int32)
    # Scatter CSR rows into the padded layout (vectorised).
    if M.nnz:
        rows = np.repeat(np.arange(n_rows), counts)
        offs = np.arange(M.nnz) - np.repeat(M.indptr[:-1], counts)
        data[rows, offs] = M.data.astype(dtype)
        cols[rows, offs] = M.indices.astype(np.int32)
    return ELL(
        data=jnp.asarray(data),
        cols=jnp.asarray(cols),
        shape=(n_rows, n_cols),
        nnz=int(M.nnz),
    )


def ell_to_scipy(E: ELL) -> sp.csr_matrix:
    """Lossy inverse of :func:`ell_from_csr` (drops explicit zeros)."""
    n_rows, n_cols = E.shape
    data = np.asarray(E.data)[:n_rows]
    cols = np.asarray(E.cols)[:n_rows]
    rows = np.repeat(np.arange(n_rows), E.width)
    M = sp.coo_matrix(
        (data.ravel(), (rows, cols.ravel())), shape=(n_rows, n_cols)
    ).tocsr()
    M.eliminate_zeros()
    return M


def bandwidth(A) -> int:
    """Largest |col − row| over the stored entries."""
    M = sp.coo_matrix(A)
    return int(np.abs(M.col.astype(np.int64) - M.row).max()) if M.nnz else 0


def rcm_permutation(A) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of the symmetrised pattern: neighbours
    get nearby indices, so an ELL SpMV's gathers of x hit nearby addresses."""
    M = as_csr(A)
    G = (M + M.T).tocsr() if M.shape[0] == M.shape[1] else M
    return np.asarray(
        sp.csgraph.reverse_cuthill_mckee(G, symmetric_mode=True), dtype=np.int64
    )
