"""Test harness config: 8 virtual CPU devices, 64-bit.

Conformance tests run against the reference's float64 tolerances, so x64 is
enabled; multi-chip tests use the standard JAX CPU-simulation stand-in
(survey §4 end note): ``--xla_force_host_platform_device_count=8``.  The
suite runs on the CPU (``JAX_PLATFORMS=cpu``, the default here); tests
marked ``gpu`` need a card and skip without one (``python -m pytest -m gpu``
on a GPU machine).
"""

import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from algebraicmultigrid_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
# persistent compilation cache (.jax_cache/ in the checkout unless
# JAX_COMPILATION_CACHE_DIR is set): repeated suite runs skip the long XLA
# compiles of the jitted cycle/PCG programs
enable_compile_cache(Path(__file__).resolve().parents[1])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 10.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.sparse as sp  # noqa: E402

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with -m gpu on the card)")
    return devs[0]


def load_csc(name: str) -> sp.csc_matrix:
    z = np.load(FIXTURES / f"{name}.npz")
    return sp.csc_matrix(
        (z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"])
    )


def load_npz(name: str):
    return np.load(FIXTURES / f"{name}.npz")


@pytest.fixture
def graph():
    """100×100 graph fixture (reference test/test.jl)."""
    return load_csc("test")


@pytest.fixture
def ref_S():
    return load_csc("ref_S_test")


@pytest.fixture
def ref_split():
    return np.load(FIXTURES / "ref_split.npy")


@pytest.fixture
def thing():
    """46×46 non-SPD graph (reference test/thing.jl)."""
    return load_csc("thing")


@pytest.fixture
def randlap():
    """100×100 random graph Laplacian (reference test/randlap.jl)."""
    return load_csc("randlap")


@pytest.fixture
def onetoall():
    return load_csc("onetoall")


@pytest.fixture
def ref_R():
    return load_csc("ref_R")


@pytest.fixture
def lin_elastic_2d():
    z = load_npz("lin_elastic_2d")
    A = sp.csc_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
    return A, z["B"], z["b"]


@pytest.fixture
def bug_graph():
    return load_csc("bug_graph")
