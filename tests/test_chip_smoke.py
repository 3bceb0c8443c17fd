"""``chip_smoke.py`` and ``bench.py`` on the CPU: every smoke phase at a tiny
size (the same code the card runs at full size), the refusal to run without
a GPU, the compile-cache placement and the bench's trace reduction.  The
``gpu`` test runs the phases on a card and skips without one."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from algebraicmultigrid_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

TINY = {
    "flagship": (chip_smoke.phase_flagship, dict(n=48, cycles=2)),
    "jacobi_parity": (chip_smoke.phase_jacobi_parity, dict(n=48)),
    "ruge_stuben": (chip_smoke.phase_rs, dict(n=24, max_levels=3)),
    "unstructured": (chip_smoke.phase_unstructured, dict(n=48)),
    "lattice_3d": (chip_smoke.phase_3d, dict(n=16, proxy=9, cut_rows=500)),
}


@pytest.mark.parametrize("phase", sorted(TINY))
def test_smoke_phase_tiny(phase, capsys):
    fn, kw = TINY[phase]
    fn(**kw)
    out = capsys.readouterr().out
    assert "ok=True" in out and "ok=False" not in out


@pytest.mark.multichip
def test_smoke_multi_tiny(capsys):
    # the --multi path on 4 of the 8 virtual CPU devices
    chip_smoke.phase_multi(
        n=144, n_unstructured=48, n_devices=4,
        lattice_kw=dict(proxy=72, cut_rows=2000, min_proxy_dim=16),
    )
    out = capsys.readouterr().out
    assert "device_set=4" in out and "ok=False" not in out


def test_smoke_check_raises_past_limit():
    with pytest.raises(AssertionError):
        chip_smoke.check("p", "x", 2e-6, 1e-6)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_fails_without_gpu(script):
    # a CPU-only JAX must give a non-zero exit and no result line
    proc = subprocess.run(
        [sys.executable, str(ROOT / script)], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout and '"metric"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_smoke_main_returns_nonzero_on_cpu():
    assert chip_smoke.main([]) != 0


def test_smoke_alone_fails(tmp_path):
    # chip_smoke.py copied into a directory with nothing else of the repo
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_set(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache(ROOT) == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == before  # nothing else set


def test_compile_cache_default_in_checkout(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache(tmp_path)
    assert path == str(tmp_path.resolve() / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_bench_scope_map_reads_named_scopes():
    @jax.jit
    def f(x):
        with jax.named_scope("L0/presmooth"):
            y = jnp.sin(x) * 2.0
        with jax.named_scope("L1/restrict"):
            y = y[::2] + 1.0
        with jax.named_scope("coarse_solve"):
            return jnp.cumsum(y)

    text = f.lower(jnp.ones(64)).compile().as_text()
    scopes = set(bench.scope_of_instructions(text).values())
    assert {"L0/presmooth", "coarse_solve"} <= scopes


def test_bench_trace_reduction(tmp_path):
    # a recorded CPU trace stands in for the card's: the same reduction reads
    # its XLA op events (on the card: the GPU plane's kernels)
    @jax.jit
    def f(x):
        with jax.named_scope("L0/presmooth"):
            y = jnp.sin(x) * 2.0
        with jax.named_scope("L0/residual"):
            return jnp.cumsum(y) + y.sum()

    x = jnp.ones(1 << 18)
    compiled = f.lower(x).compile()
    jax.block_until_ready(compiled(x))
    jax.profiler.start_trace(str(tmp_path))
    for _ in range(3):
        jax.block_until_ready(compiled(x))
    jax.profiler.stop_trace()
    per_scope, idle, window = bench.reduce_trace(
        str(tmp_path), compiled.as_text(), device_prefix="/host:CPU"
    )
    assert per_scope.get("L0/presmooth", 0) > 0 or per_scope.get("L0/residual", 0) > 0
    assert 0.0 <= idle < 1.0 and window > 0


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    # the one-card phases at reduced sizes, on the card
    for fn, kw in (
        (chip_smoke.phase_flagship, dict(n=512, cycles=5)),
        (chip_smoke.phase_jacobi_parity, dict(n=256)),
        (chip_smoke.phase_rs, dict(n=256)),
        (chip_smoke.phase_unstructured, dict(n=128)),
        (chip_smoke.phase_3d, dict(n=48, proxy=12, cut_rows=2000)),
    ):
        fn(**kw)
    assert jax.devices()[0].platform == "gpu"
