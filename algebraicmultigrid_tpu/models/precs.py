"""Preconditioner builders for Krylov-solver integration.

Parity with ``/root/reference/src/precs.jl``: the reference exposes
``RugeStubenPreconBuilder``/``SmoothedAggregationPreconBuilder`` — callables
``(A, p) -> (aspreconditioner(setup(A, Val{blocksize}; kwargs...)), I)``
consumed by LinearSolve.jl's ``precs`` API (precs.jl:7-38).  This package
keeps the same shape so the builders plug into any Krylov loop that takes a
``(left, right)`` preconditioner pair — including the in-repo :func:`cg`
(pass ``builder(A)[0]``) and ``scipy.sparse.linalg``'s ``M=`` argument via
:meth:`Preconditioner.matvec`.
"""

from __future__ import annotations

from typing import Any, Dict

from ..config import Cycle, V
from .aggregation import smoothed_aggregation
from .classical import ruge_stuben
from .preconditioner import Preconditioner, aspreconditioner

__all__ = ["RugeStubenPreconBuilder", "SmoothedAggregationPreconBuilder"]


class _Identity:
    """Right-preconditioner placeholder (the reference returns ``I``)."""

    def apply(self, b):
        return b

    matvec = apply

    def __matmul__(self, b):
        return b

    def __repr__(self):
        return "I"


IdentityOperator = _Identity


class _PreconBuilder:
    """Callable ``(A, p=None) -> (Preconditioner, I)`` (precs.jl:13-18,31-38).

    ``blocksize`` mirrors the reference's ``Val{blocksize}`` multi-RHS block
    parameter; remaining kwargs are forwarded to the setup driver, and
    ``cycle`` (an extension over the reference) selects the applied cycle.
    """

    _setup = None

    def __init__(self, blocksize: int = 1, cycle: Cycle = V(), **kwargs: Any):
        self.blocksize = blocksize
        self.cycle = cycle
        self.kwargs: Dict[str, Any] = kwargs

    def __call__(self, A, p=None):
        ml = type(self)._setup(A, blocksize=self.blocksize, **self.kwargs)
        return aspreconditioner(ml, self.cycle), _Identity()

    def __repr__(self):
        kw = ", ".join(f"{k}={v!r}" for k, v in self.kwargs.items())
        return f"{type(self).__name__}(blocksize={self.blocksize}{', ' + kw if kw else ''})"


def _rs_setup(A, blocksize=1, **kwargs):
    return ruge_stuben(A, blocksize=blocksize, **kwargs)


def _sa_setup(A, blocksize=1, **kwargs):
    return smoothed_aggregation(A, blocksize=blocksize, **kwargs)


class RugeStubenPreconBuilder(_PreconBuilder):
    """precs.jl:26-38 — classical-AMG preconditioner builder."""

    _setup = staticmethod(_rs_setup)


class SmoothedAggregationPreconBuilder(_PreconBuilder):
    """precs.jl:7-24 — smoothed-aggregation preconditioner builder."""

    _setup = staticmethod(_sa_setup)
