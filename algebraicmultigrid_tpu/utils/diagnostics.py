"""Observability utilities: phase timing and roofline accounting.

Equivalents of the reference's auxiliary subsystems (survey §5):

* the reference's ``@timeit_debug`` phase timers (compiled out by default)
  → :class:`PhaseTimer`, an opt-in host-side wall-clock accumulator used by
  the setup drivers, plus ``jax.named_scope`` annotations inside the jitted
  cycle (models/device.py) for profiler traces;
* residual logging / verbose printing live on the solve drivers
  (``log=``/``verbose=`` kwargs, multilevel.jl:158-198 parity);
* :func:`cycle_work` — nnz-based work accounting per cycle.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

__all__ = ["PhaseTimer", "cycle_work", "profile_trace"]


class PhaseTimer:
    """Opt-in accumulator for named setup/solve phases.

    >>> t = PhaseTimer()
    >>> with t.phase("strength"): ...
    >>> t.report()
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase                          total_s   calls"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<30} {tot:8.3f}  {self.counts[name]:6d}")
        return "\n".join(lines)


def cycle_work(ml, cycle: str = "V") -> int:
    """nnz touched by SpMV-class ops in one cycle (smoothers + residual +
    transfer operators).

    A symmetric-GS smoother sweep touches nnz(A) per direction; V visits
    each level once, W twice per recursion level (counted approximately as
    2^depth), F between the two.
    """
    total = 0
    visits = 1
    for level in ml.levels:
        total += visits * (4 * level.A.nnz + level.A.nnz + level.R.nnz + level.P.nnz)
        if cycle == "W":
            visits *= 2
    if ml.levels:
        total += ml.levels[0].A.nnz  # outer residual
    return total


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Wrap a block in a jax.profiler trace (TensorBoard/Perfetto readable)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
