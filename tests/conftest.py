"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh (SURVEY.md §4): the forced host
platform device count lets multi-device sharding paths execute without
accelerators. Tests marked ``gpu`` need an NVIDIA GPU; they run their
code in a subprocess with the GPU platform (this process stays pinned to
the CPU) and skip when no GPU answers. Run them with
``python -m pytest -m gpu -p no:xdist tests/`` (one process per card).

This file must configure XLA before any jax import in the test session.
"""

import os
import subprocess
import sys
from pathlib import Path

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ivclab_tpu.utils import fixtures  # noqa: E402


@pytest.fixture(scope="session")
def lena():
    return fixtures.image("lena")


@pytest.fixture(scope="session")
def lena_small():
    return fixtures.image("lena_small")


@pytest.fixture(scope="session")
def sail():
    return fixtures.image("sail")


@pytest.fixture(scope="session")
def satpic1():
    return fixtures.image("satpic1")


@pytest.fixture(scope="session")
def lena_rec():
    return fixtures.degraded("lena")


@pytest.fixture(scope="session")
def foreman():
    return fixtures.video("foreman", num_frames=6)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


REPO = Path(__file__).resolve().parents[1]


def _gpu_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cuda"
    return env


@pytest.fixture(scope="session")
def gpu_present() -> bool:
    """Whether JAX finds a CUDA device, probed in a subprocess."""
    try:
        out = subprocess.run(
            [sys.executable, "-c", "import jax; jax.devices()"],
            env=_gpu_env(), cwd=REPO, capture_output=True, timeout=300,
        )
    except subprocess.TimeoutExpired:
        return False
    return out.returncode == 0


@pytest.fixture
def gpu_python(gpu_present):
    """Run a Python snippet on the GPU; it must exit 0 and print ``..._OK``."""
    if not gpu_present:
        pytest.skip("needs an NVIDIA GPU: python -m pytest -m gpu -p no:xdist tests/")

    def run(code: str, timeout: int = 900) -> str:
        out = subprocess.run(
            [sys.executable, "-c", code], env=_gpu_env(), cwd=REPO,
            capture_output=True, text=True, timeout=timeout,
        )
        assert out.returncode == 0 and "_OK" in out.stdout, out.stderr[-3000:]
        return out.stdout

    return run
