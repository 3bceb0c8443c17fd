"""Benchmark of the solve path on one NVIDIA GPU.

Flagship configuration: structured smoothed aggregation (periodic box-3
aggregates, O(boundary) setup, gather-free Lat2D device operators) on 2-D
Poisson 4096² (16.7M unknowns), solved by mixed-precision iterative
refinement (f32 AMG-PCG inner, f64 outer residual) to 1e-8.

Prints one JSON line per measurement:
  {"metric": ..., "value": ..., "unit": ..., "device": {...}}
where ``device`` names the JAX platform, ``device_kind``, the device count
and the card's name and power limit from nvidia-smi.  Measurements:

* set-up: host setup, device lowering and V-cycle compile seconds;
* ``vcycle_seconds``: one V-cycle, the median over repeated timed calls;
* ``solve_to_1e8_seconds``: a warm ``solve_refined`` call;
* ``level_seconds``: per-level device time of one V-cycle by phase, reduced
  from a ``jax.profiler`` trace through the cycle's ``L{i}/<phase>`` and
  ``coarse_solve`` scopes, with the device's idle share over the window;
* ``color_step``: one masked multicolor GS step at level 0, the bytes it
  must move and its share of 3.35 TB/s, beside a plain copy in the same run;
* ``ell_spmv``: ELL ``mat_vec`` on scrambled Poisson 1024² in its natural
  (scrambled) order and in RCM order.

Every time is taken with ``block_until_ready``.  The script fails when JAX
finds no GPU.  Environment: ``AMG_BENCH_N`` grid edge (default 4096).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import re
import shutil
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
REPEATS = 5


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_time(fn, *args, repeats: int = REPEATS) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


SCOPE = re.compile(r"(L\d+/(?:presmooth|residual|restrict|prolong|postsmooth)|coarse_solve)")
COMPUTATION = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+) .*\{\s*$")
INSTRUCTION = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = ")
OP_NAME = re.compile(r'op_name="([^"]*)"')
CALLS = re.compile(r"calls=%?([\w.\-]+)")


def scope_of_instructions(hlo_text: str) -> dict:
    """HLO instruction name → cycle scope, from the compiled module's
    op_name metadata.  A fusion takes the scope most of its fused
    computation's instructions carry (its own metadata is only its root's,
    or none).  XLA reuses one kernel for identical fusions and fuses across
    phase boundaries, so the split between phases of one level (presmooth
    and postsmooth above all) is approximate; level totals are not."""
    own, calls = {}, {}
    votes = defaultdict(lambda: defaultdict(int))
    comp = None
    for line in hlo_text.splitlines():
        m = INSTRUCTION.match(line)
        if not m:
            c = COMPUTATION.match(line)
            comp = c.group(1) if c else comp
            continue
        name = m.group(1)
        op = OP_NAME.search(line)
        s = SCOPE.search(op.group(1)) if op else None
        if s:
            own[name] = s.group(1)
            votes[comp][s.group(1)] += 1
        c = CALLS.search(line)
        if c:
            calls[name] = c.group(1)
    out = dict(own)
    for name, comp in calls.items():
        if votes[comp]:
            out[name] = max(votes[comp].items(), key=lambda kv: kv[1])[0]
    # GPU kernels are named after their fusion with '.' and '-' made '_'
    out.update({re.sub(r"[.\-]", "_", k): v for k, v in list(out.items())})
    return out


def reduce_trace(trace_dir: str, hlo_text: str, device_prefix: str = "/device:GPU"):
    """Per-scope device seconds and the device idle share from an xplane
    trace.  Device events name their HLO instruction (``hlo_op``) or, inside
    a CUDA graph, carry the fusion's kernel name; the compiled module maps
    either to a cycle scope.  Events of other programs or with no scope
    count as ``other``."""
    import jax

    scopes = scope_of_instructions(hlo_text)
    (path,) = glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb")
    per_scope = defaultdict(float)
    intervals = []
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith(device_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                if ev.duration_ns <= 0:
                    continue
                # kernels replayed from a CUDA graph carry hlo_op
                # "command_buffer"; their own name is the fusion's kernel
                op = dict(ev.stats).get("hlo_op")
                scope = scopes.get(op) or scopes.get(ev.name, "other")
                per_scope[scope] += ev.duration_ns * 1e-9
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        raise RuntimeError("trace holds no device events")
    intervals.sort()
    busy, (cur_lo, cur_hi) = 0.0, intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    window = intervals[-1][1] - intervals[0][0]
    return dict(per_scope), 1.0 - busy / window, window * 1e-9


def main() -> int:
    import os

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: no GPU (JAX platform is {devs[0].platform!r})", file=sys.stderr)
        return 1

    import jax.numpy as jnp
    import scipy.sparse as sp

    import algebraicmultigrid_tpu as amg
    from algebraicmultigrid_tpu.models.device import (
        _get_device_hierarchy,
        _smooth_masked_multicolor,
        run_fixed_cycles,
        solve_refined,
    )
    from algebraicmultigrid_tpu.ops.banded import mat_vec
    from algebraicmultigrid_tpu.ops.sparse import ell_from_csr, rcm_permutation
    from algebraicmultigrid_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(ROOT)
    device = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "card": card_info(),
    }

    def emit(metric, value, unit, **extra):
        print(json.dumps({"metric": metric, "value": value, "unit": unit,
                          **extra, "device": device}), flush=True)

    N = int(os.environ.get("AMG_BENCH_N", 4096))
    n = N * N

    # ---- flagship: set-up, V-cycle, solve to 1e-8 ----
    t0 = time.perf_counter()
    A = amg.poisson((N, N), lattice=True)
    ml = amg.structured_smoothed_aggregation(A, aggregate=amg.StructuredAggregation(box=3))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    h = _get_device_hierarchy(ml, jnp.float32)
    jax.block_until_ready(jax.tree_util.tree_leaves(h))
    lower_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    b_host = A @ rng.standard_normal(n)
    b = jnp.asarray(np.pad(b_host.astype(np.float32), (0, h.fine_padded - n)))
    x0 = jnp.zeros_like(b)
    cycles = 20
    t0 = time.perf_counter()
    run = jax.jit(lambda h, x, b: run_fixed_cycles(h, x, b, cycles)).lower(h, x0, b).compile()
    compile_s = time.perf_counter() - t0
    emit("setup_seconds", round(setup_s, 3), "s", n=n, levels=len(ml),
         lowering_seconds=round(lower_s, 3), vcycle_compile_seconds=round(compile_s, 3))
    emit("vcycle_seconds", median_time(run, h, x0, b) / cycles, "s", n=n, cycles_per_call=cycles)

    b64 = b_host.copy()
    solve_refined(ml, b64, tol=1e-8)  # compiles the inner PCG and the f64 update
    t0 = time.perf_counter()
    x, hist = solve_refined(ml, b64, tol=1e-8, log=True)
    solve_s = time.perf_counter() - t0
    relres = float(np.linalg.norm(b64 - A @ x) / np.linalg.norm(b64))
    emit("solve_to_1e8_seconds", solve_s, "s", n=n, true_relres=relres,
         refine_rounds=len(hist) - 1,
         peak_bytes_in_use=(devs[0].memory_stats() or {}).get("peak_bytes_in_use"))

    # ---- per-level device time of the V-cycle, from one trace ----
    trace_dir = str(ROOT / ".bench_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    jax.block_until_ready(run(h, x0, b))
    jax.profiler.start_trace(trace_dir)
    jax.block_until_ready(run(h, x0, b))
    jax.profiler.stop_trace()
    per_scope, idle, window = reduce_trace(trace_dir, run.as_text())
    emit("level_seconds", {k: v / cycles for k, v in sorted(per_scope.items())}, "s/cycle",
         device_idle_share=idle, window_seconds=window, cycles_traced=cycles)

    # ---- one masked color step at level 0, and a copy ----
    pre = h.levels[0].pre
    sweep = dataclasses.replace(pre, iter=1, forward=True, backward=False)
    sweeps = 20  # in one program, so dispatch is not counted per step
    steps = jax.jit(lambda A, x, b: jax.lax.fori_loop(
        0, sweeps, lambda i, x: _smooth_masked_multicolor(sweep, A, x, b), x))
    t_step = median_time(steps, h.levels[0].A, b, b) / (sweeps * pre.n_colors)
    A0 = h.levels[0].A
    vec = h.fine_padded * 4
    step_bytes = A0.data.size * A0.data.dtype.itemsize + 4 * vec  # planes, x, b, dinv, color_of
    step_bytes += vec  # x written
    big = jnp.zeros(1 << 28, jnp.float32)
    t_copy = median_time(jax.jit(lambda v: v + 1.0), big)
    copy_bw = 2 * big.size * 4 / t_copy
    emit("color_step_seconds", t_step, "s", n=n, n_colors=pre.n_colors,
         operator=type(A0).__name__, bytes=int(step_bytes),
         bytes_per_s=step_bytes / t_step, share_of_3_35TBps=step_bytes / t_step / HBM_BYTES_PER_S,
         copy_bytes_per_s=copy_bw, share_of_copy=step_bytes / t_step / copy_bw)

    # ---- ELL SpMV on scrambled Poisson 1024²: natural vs RCM order ----
    Nu = 1024
    Au = sp.csr_matrix(amg.poisson((Nu, Nu)))
    p = np.random.default_rng(1).permutation(Au.shape[0])
    Au = Au[p][:, p].tocsr()
    pi = rcm_permutation(Au)
    reps = 100
    for order, M in (("natural", Au), ("rcm", Au[pi][:, pi].tocsr())):
        E = ell_from_csr(M, dtype=jnp.float32)
        xv = jnp.asarray(rng.standard_normal(E.rows_padded).astype(np.float32))
        chain = jax.jit(lambda E, v: jax.lax.fori_loop(0, reps, lambda i, u: mat_vec(E, u) * 0.125, v))
        t = median_time(chain, E, xv) / reps
        nbytes = E.data.size * 4 + E.cols.size * 4 + 2 * E.rows_padded * 4
        emit("ell_spmv_seconds", t, "s", order=order, n=M.shape[0], nnz=int(M.nnz),
             width=E.width, bytes=int(nbytes), bytes_per_s=nbytes / t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
