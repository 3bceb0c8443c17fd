"""Smoke test of the solve path on NVIDIA GPUs: the quickest proof that the
package still starts, compiles and solves correctly on the card.

    python chip_smoke.py            # one GPU, five phases
    python chip_smoke.py --multi    # four GPUs, the multi-device tier only

One-GPU phases, at the sizes the README documents:

1. 2-D structured smoothed aggregation on Poisson 4096² (16.7M unknowns):
   level-0 ``mat_vec`` against scipy's CSR product, timed V-cycles, and
   ``solve_refined`` to a true f64 relative residual of 1e-8.
2. The device cycle against the plain reference: one f64 Jacobi V-cycle of
   the device engine against one of the host tier (``models/multilevel.py``)
   on the same hierarchy, to 1e-10.
3. 2-D Ruge–Stüben (``StructuredRS``, multicolor GS) on Poisson 4096²,
   ``cg_device`` to 1e-6.
4. Unstructured: scrambled Poisson 1024² (1.05M rows) through smoothed
   aggregation and the ELL format, ``cg_device`` to 1e-6.
5. 3-D Poisson 256³ through ``structured_smoothed_aggregation_nd``,
   ``cg_device`` to 1e-6.

``--multi`` runs ``solve_lattice_sharded`` on Poisson 8192² over four cards
(one sharded V-cycle against the single-device engine, and the PCG solve) and
``solve_sharded`` on the scrambled 1024² problem against the single-device
solvers.

Every residual check is the true relative residual computed on the host in
f64.  Right-hand sides are ``b = A·x*`` with a seeded random ``x*``: an f32
solution of a rough x* carries rounding error far below 1e-6 of ‖b‖, so
the f32 device solvers can be held to 1e-6 (a smooth x* such as all-ones
would put the rounding floor of the f32 iterate above that).

The script does all JAX work in one process.  It exits non-zero, and prints
no result line, when JAX finds no GPU or any phase fails.  Its last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0


def log(phase: str, **kv) -> None:
    items = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {items}", flush=True)


def card_info() -> str:
    """Name and power limit of every visible card, as nvidia-smi reports them
    (a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def rel_max_err(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def true_relres(A, x, b) -> float:
    """‖b − A·x‖ / ‖b‖ in f64 on the host (A a scipy matrix or a lattice
    operator with a host ``@``)."""
    r = b - A @ np.asarray(x, dtype=np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def check(phase: str, name: str, value: float, limit: float) -> None:
    ok = value <= limit
    log(phase, check=name, value=f"{value:.3e}", limit=f"{limit:.0e}", ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: {name} = {value:.3e} > {limit:.0e}")


def rhs(A, n: int):
    x_star = np.random.default_rng(SEED).standard_normal(n)
    return A @ x_star


def peak_bytes():
    stats = __import__("jax").devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "n/a")


def memory_summary(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ",".join(f"{k.split('_size')[0]}:{getattr(m, k, 'n/a')}" for k in keys)


def timed(fn, *args):
    """(result, seconds) with the result waited for on the device."""
    import jax

    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def lower_hierarchy(phase: str, ml, dtype):
    """Lower ``ml`` to the device (cached on ``ml`` for the solve functions)
    and report the formats and the lowering time."""
    import jax
    from algebraicmultigrid_tpu.models.device import _get_device_hierarchy

    t0 = time.perf_counter()
    h = _get_device_hierarchy(ml, dtype)
    jax.block_until_ready(jax.tree_util.tree_leaves(h))
    log(phase, lower_s=f"{time.perf_counter() - t0:.2f}", levels=len(h.levels),
        formats="/".join(type(lv.A).__name__ for lv in h.levels))
    return h


def check_level0_matvec(phase: str, h, A_csr, limit: float = 1e-6) -> None:
    """Level-0 ``mat_vec`` (in the hierarchy's basis) against scipy's CSR
    product in f64."""
    import jax
    import jax.numpy as jnp
    from algebraicmultigrid_tpu.ops.banded import mat_vec

    n = A_csr.shape[0]
    x = np.random.default_rng(SEED + 1).standard_normal(n).astype(np.float32)
    ref = A_csr @ x.astype(np.float64)
    xq, ref_q = x, ref
    if h.perm0 is not None:
        perm = np.asarray(h.perm0)[:n]
        xq, ref_q = x[perm], ref[perm]
    xp = np.zeros(h.fine_padded, np.float32)
    xp[:n] = xq
    y = jax.jit(mat_vec)(h.levels[0].A, jnp.asarray(xp))
    check(phase, "matvec_vs_scipy", rel_max_err(np.asarray(y)[:n], ref_q), limit)


def time_vcycles(phase: str, h, b, cycles: int) -> None:
    """Compile and time ``cycles`` V-cycles from zero; report the compile,
    the program's memory and the warm time per cycle."""
    import jax
    import jax.numpy as jnp
    from algebraicmultigrid_tpu.models.device import run_fixed_cycles

    bp = np.zeros(h.fine_padded, np.float32)
    bp[: b.shape[0]] = b
    bp = jnp.asarray(bp)
    x0 = jnp.zeros_like(bp)
    t0 = time.perf_counter()
    compiled = (
        jax.jit(lambda h, x, b: run_fixed_cycles(h, x, b, cycles))
        .lower(h, x0, bp)
        .compile()
    )
    compile_s = time.perf_counter() - t0
    x, _ = timed(compiled, h, x0, bp)
    x, dt = timed(compiled, h, x0, bp)
    log(phase, vcycle_compile_s=f"{compile_s:.2f}", vcycle_memory=memory_summary(compiled),
        vcycle_ms=f"{1e3 * dt / cycles:.4f}", cycles=cycles,
        finite=bool(np.isfinite(np.asarray(x)).all()))
    if not np.isfinite(np.asarray(x)).all():
        raise AssertionError(f"{phase}: non-finite V-cycle iterate")


def phase_flagship(n: int = 4096, cycles: int = 10) -> None:
    """2-D structured SA: mat_vec, V-cycles, solve_refined to 1e-8."""
    import algebraicmultigrid_tpu as amg
    from algebraicmultigrid_tpu.models.device import solve_refined

    phase = "flagship"
    t0 = time.perf_counter()
    A = amg.poisson((n, n), lattice=True)
    ml = amg.structured_smoothed_aggregation(
        A, aggregate=amg.StructuredAggregation(box=3)
    )
    log(phase, n=n * n, setup_s=f"{time.perf_counter() - t0:.2f}", levels=len(ml),
        operator_complexity=f"{ml.operator_complexity():.4f}")
    h = lower_hierarchy(phase, ml, "float32")
    A_csr = A.tocsr()
    check_level0_matvec(phase, h, A_csr)
    b = rhs(A_csr, n * n)
    time_vcycles(phase, h, b.astype(np.float32), cycles)
    (x, hist), cold = timed(lambda: solve_refined(ml, b, tol=1e-8, log=True))
    (x, hist), warm = timed(lambda: solve_refined(ml, b, tol=1e-8, log=True))
    log(phase, solve_cold_s=f"{cold:.3f}", solve_warm_s=f"{warm:.4f}",
        rounds=len(hist) - 1, peak_bytes=peak_bytes())
    check(phase, "solve_refined_true_relres", true_relres(A_csr, x, b), 1e-8)


def phase_jacobi_parity(n: int = 4096) -> None:
    """One f64 Jacobi V-cycle: device engine against the host tier."""
    import jax
    import jax.numpy as jnp
    import algebraicmultigrid_tpu as amg
    from algebraicmultigrid_tpu.models.device import _one_iteration, build_device_hierarchy
    from algebraicmultigrid_tpu.models.multilevel import _cycle_host

    phase = "jacobi_parity"
    A = amg.poisson((n, n), lattice=True)
    jac = amg.Jacobi()
    t0 = time.perf_counter()
    ml = amg.structured_smoothed_aggregation(
        A, aggregate=amg.StructuredAggregation(box=3), presmoother=jac, postsmoother=jac
    )
    log(phase, n=n * n, setup_s=f"{time.perf_counter() - t0:.2f}", levels=len(ml))
    b = np.random.default_rng(SEED + 2).standard_normal(n * n)
    with jax.enable_x64(True):
        h = build_device_hierarchy(ml, dtype=jnp.float64)
        bp = jnp.asarray(np.pad(b, (0, h.fine_padded - n * n)))
        cycle = jax.jit(lambda h, b: _one_iteration(h, amg.V(), jnp.zeros_like(b), b))
        x_dev, dt = timed(cycle, h, bp)
        x_dev = np.asarray(x_dev)[: n * n]
    t0 = time.perf_counter()
    x_host = np.zeros(n * n)
    _cycle_host(ml, amg.V(), x_host, b, 0)
    log(phase, device_cycle_cold_s=f"{dt:.2f}", host_cycle_s=f"{time.perf_counter() - t0:.2f}")
    check(phase, "device_vs_host_cycle", rel_max_err(x_dev, x_host), 1e-10)


def phase_rs(n: int = 4096, max_levels: int = 10) -> None:
    """2-D Ruge–Stüben (StructuredRS, multicolor GS), cg_device to 1e-6."""
    import algebraicmultigrid_tpu as amg

    phase = "ruge_stuben"
    gs = amg.GaussSeidel(ordering="multicolor")
    t0 = time.perf_counter()
    A = amg.poisson((n, n), lattice=True)
    ml = amg.ruge_stuben(
        A, CF=amg.StructuredRS(), presmoother=gs, postsmoother=gs, max_levels=max_levels
    )
    log(phase, n=n * n, setup_s=f"{time.perf_counter() - t0:.2f}", levels=len(ml),
        operator_complexity=f"{ml.operator_complexity():.4f}")
    lower_hierarchy(phase, ml, "float32")
    A_csr = A.tocsr()
    pcg(phase, ml, A_csr, rhs(A_csr, n * n))


def pcg(phase: str, ml, A_csr, b, tol: float = 1e-6) -> np.ndarray:
    """cg_device to ``tol`` (cold and warm), judged by the host f64 residual."""
    from algebraicmultigrid_tpu import cg_device

    run = lambda: cg_device(ml, b, tol=tol, maxiter=100, dtype="float32", log=True)
    (x, it, _), cold = timed(run)
    (x, it, _), warm = timed(run)
    log(phase, pcg_iters=it, pcg_cold_s=f"{cold:.3f}", pcg_warm_s=f"{warm:.4f}",
        peak_bytes=peak_bytes())
    check(phase, "pcg_true_relres", true_relres(A_csr, x, b), tol)
    return x


def scrambled_poisson(n: int):
    """2-D Poisson n² with its rows and columns in a seeded random order —
    an unstructured matrix with a known spectrum."""
    import scipy.sparse as sp
    import algebraicmultigrid_tpu as amg

    A = sp.csr_matrix(amg.poisson((n, n)))
    p = np.random.default_rng(1).permutation(A.shape[0])
    return A[p][:, p].tocsr()


def phase_unstructured(n: int = 1024) -> None:
    """Scrambled Poisson through SA and ELL, cg_device to 1e-6."""
    import algebraicmultigrid_tpu as amg
    from algebraicmultigrid_tpu.ops.banded import BTOp, DenseOp, SDIA
    from algebraicmultigrid_tpu.ops.sparse import ELL

    phase = "unstructured"
    A = scrambled_poisson(n)
    t0 = time.perf_counter()
    ml = amg.smoothed_aggregation(A)
    log(phase, n=A.shape[0], setup_s=f"{time.perf_counter() - t0:.2f}", levels=len(ml))
    h = lower_hierarchy(phase, ml, "float32")
    formats = (ELL, SDIA, BTOp, DenseOp)
    for i, lv in enumerate(h.levels):
        for name in ("A", "P", "R"):
            op = getattr(lv, name)
            if not isinstance(op, formats):
                raise AssertionError(f"{phase}: level {i} {name} is {type(op).__name__}")
    if not isinstance(h.levels[0].A, ELL):
        raise AssertionError(f"{phase}: level 0 is {type(h.levels[0].A).__name__}, not ELL")
    log(phase, rcm_basis=h.perm0 is not None)
    check_level0_matvec(phase, h, A)
    pcg(phase, ml, A, rhs(A, A.shape[0]))


def phase_3d(n: int = 256, proxy: int = 47, cut_rows: int = 20000) -> None:
    """3-D Poisson through the N-D lattice tier, cg_device to 1e-6."""
    import algebraicmultigrid_tpu as amg

    phase = "lattice_3d"
    t0 = time.perf_counter()
    A = amg.poisson((n, n, n), lattice=True)
    ml = amg.structured_smoothed_aggregation_nd(A, proxy=proxy, cut_rows=cut_rows)
    log(phase, n=n ** 3, setup_s=f"{time.perf_counter() - t0:.2f}", levels=len(ml))
    lower_hierarchy(phase, ml, "float32")
    A_csr = A.tocsr()
    pcg(phase, ml, A_csr, rhs(A_csr, n ** 3))


def phase_multi(n: int = 8192, n_unstructured: int = 1024, n_devices: int = 4,
                lattice_kw=None) -> None:
    """The multi-device tier on ``n_devices`` cards: the slab-sharded lattice
    cycle and PCG, and the row-sharded ``solve_sharded``.  At 8192² the
    structured setup needs a 512 proxy grid to keep the levels lattice (the
    default 256 leaves level 2 generic), and a 200-row coarsest level: the
    slab hierarchy folds a generic tail level into its dense coarse solve,
    which would make its cycle differ from the single-device cycle."""
    if lattice_kw is None:
        lattice_kw = dict(proxy=512, max_coarse=200)
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import algebraicmultigrid_tpu as amg
    from algebraicmultigrid_tpu.models.device import _one_iteration, build_device_hierarchy, solve_device
    from algebraicmultigrid_tpu.parallel import (
        build_slab_hierarchy, cycle_lattice_sharded, make_row_mesh,
        place_slab_hierarchy, solve_lattice_sharded, solve_sharded,
    )
    from algebraicmultigrid_tpu.parallel.lattice_cycle import AXIS

    phase = "multi_lattice"
    devs = jax.devices()
    if len(devs) < n_devices:
        raise AssertionError(f"{phase}: need {n_devices} devices, have {len(devs)}")
    mesh = Mesh(np.array(devs[:n_devices]), (AXIS,))
    t0 = time.perf_counter()
    A = amg.poisson((n, n), lattice=True)
    ml = amg.structured_smoothed_aggregation(
        A, aggregate=amg.StructuredAggregation(box=3), **lattice_kw
    )
    log(phase, n=n * n, devices=n_devices, setup_s=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    hs = place_slab_hierarchy(build_slab_hierarchy(ml, n_devices), mesh)
    jax.block_until_ready(jax.tree_util.tree_leaves(hs))
    log(phase, slab_build_s=f"{time.perf_counter() - t0:.2f}")
    for i, lv in enumerate(hs.levels):
        log(phase, level=i, sharded=lv.sharded, pdims=lv.pdims,
            device_set=len(lv.A.sharding.device_set))
    if len(hs.levels[0].A.sharding.device_set) != n_devices:
        raise AssertionError(f"{phase}: level 0 does not span {n_devices} devices")
    # the solver below reuses the placed hierarchy
    ml._device_cache[("slab", "float32", n_devices)] = hs

    b = np.random.default_rng(SEED + 3).standard_normal(n * n).astype(np.float32)
    Wx, Wy = hs.fine_dims
    Wxp, Wyp = hs.fine_pdims
    bg = np.zeros((Wxp, Wyp), np.float32)
    bg[:Wx, :Wy] = b.reshape(Wx, Wy)
    bg = jax.device_put(bg, NamedSharding(mesh, P(AXIS, None)))
    xs, dt = timed(lambda: cycle_lattice_sharded(hs, jnp.zeros_like(bg), bg, mesh))
    x_slab = np.asarray(xs)[:Wx, :Wy].reshape(n * n)
    log(phase, sharded_cycle_cold_s=f"{dt:.2f}")

    hd = build_device_hierarchy(ml, dtype=jnp.float32)
    bp = jnp.asarray(np.pad(b, (0, hd.fine_padded - n * n)))
    x_ref, dt = timed(
        jax.jit(lambda h, b: _one_iteration(h, amg.V(), jnp.zeros_like(b), b)), hd, bp
    )
    del hd
    log(phase, single_cycle_cold_s=f"{dt:.2f}")
    check(phase, "sharded_vs_single_cycle", rel_max_err(x_slab, np.asarray(x_ref)[: n * n]), 2e-4)

    bt = rhs(A, n * n)
    (x, it, rr), cold = timed(
        lambda: solve_lattice_sharded(ml, bt, mesh=mesh, tol=1e-6, maxiter=100, log=True)
    )
    (x, it, rr), warm = timed(
        lambda: solve_lattice_sharded(ml, bt, mesh=mesh, tol=1e-6, maxiter=100, log=True)
    )
    log(phase, pcg_iters=it, pcg_cold_s=f"{cold:.3f}", pcg_warm_s=f"{warm:.4f}")
    check(phase, "sharded_pcg_true_relres", true_relres(A, x, bt), 1e-6)
    del ml, hs

    phase = "multi_rows"
    Au = scrambled_poisson(n_unstructured)
    mlu = amg.smoothed_aggregation(Au)
    bu = rhs(Au, Au.shape[0])
    rmesh = make_row_mesh(n_devices)
    (x_sh, it_sh, _), cold = timed(
        lambda: solve_sharded(mlu, bu, mesh=rmesh, reltol=1e-6, dtype="float32")
    )
    hsh = mlu._device_cache[("sharded", "float32", n_devices, 4096)]
    log(phase, iters=it_sh, cold_s=f"{cold:.2f}",
        device_sets="/".join(
            str(len(jax.tree_util.tree_leaves(lv.A)[0].sharding.device_set)) for lv in hsh.levels
        ))
    # the same stationary solver on one device: only the partitioning differs
    x_one = solve_device(mlu, bu, reltol=1e-6, dtype="float32")
    check(phase, "sharded_vs_single_solve", rel_max_err(x_sh, x_one), 1e-4)
    # its stopping test is an f32 residual ≤ 1e-6·‖b‖; allow its f32 rounding
    check(phase, "sharded_true_relres", true_relres(Au, x_sh, bu), 1.1e-6)
    # against cg_device: both residuals ≤ 1e-6·‖b‖, so ‖A(x_sh − x_cg)‖ ≤ 2e-6·‖b‖
    x_cg = pcg(phase, mlu, Au, bu)
    gap = float(np.linalg.norm(Au @ (x_sh.astype(np.float64) - x_cg)) / np.linalg.norm(bu))
    check(phase, "sharded_vs_cg_device_residual", gap, 2e-6)
    log(phase, sharded_vs_cg_device_rel_diff=f"{np.linalg.norm(x_sh - x_cg) / np.linalg.norm(x_cg):.3e}")


ONE_CARD = (phase_flagship, phase_jacobi_parity, phase_rs, phase_unstructured, phase_3d)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the multi-device tier, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform is {devs[0].platform!r})", file=sys.stderr)
        return 1
    from algebraicmultigrid_tpu.native.build import get_native
    from algebraicmultigrid_tpu.utils.compile_cache import enable_compile_cache

    log("env", jax=jax.__version__, platform=devs[0].platform, kind=repr(devs[0].device_kind),
        count=len(devs), compile_cache=enable_compile_cache(ROOT),
        native_setup=get_native() is not None)
    print(card_info(), flush=True)

    phases = [phase_multi] if args.multi else list(ONE_CARD)
    failed = []
    for fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(fn.__name__)
        log("phase", name=fn.__name__, seconds=f"{time.perf_counter() - t0:.1f}",
            ok=fn.__name__ not in failed)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    count = 4 if args.multi else 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
