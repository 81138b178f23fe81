"""Test configuration.

Tests run on a virtual 8-device CPU mesh with float64 enabled so parity
fixtures generated by the reference at prec=64 can be matched.  Tests that
need an NVIDIA GPU carry the ``gpu`` marker and skip on the CPU; on a
machine with a card, ``python chip_smoke.py`` runs the same checks.
"""

import os

# the config is updated directly as well: a JAX imported before this file
# would not see the environment variable
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

from flashweave.utils.cache import configure_compile_cache  # noqa: E402

# XLA CPU compiles cost ~1s per distinct shape; cache them across runs
configure_compile_cache(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (the check for "
        "a card runs in the `gpu_device` fixture)")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX sees none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run `python chip_smoke.py` there)")
    return devs[0]

REFERENCE_DATA = "/root/reference/test/data"


def reference_data_path(*parts):
    return os.path.join(REFERENCE_DATA, *parts)


def has_reference_data():
    return os.path.isdir(REFERENCE_DATA)


requires_reference_data = pytest.mark.skipif(
    not has_reference_data(), reason="reference test data not mounted"
)


@pytest.fixture(scope="session")
def hmp_small():
    """The 351x50 HMP gut OTU table used by the reference's learning tests
    (reference: test/learning.jl:9-10)."""
    if not has_reference_data():
        pytest.skip("reference test data not mounted")
    path = reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_small.tsv")
    raw = np.loadtxt(path, delimiter="\t", dtype=str)
    return raw[1:, 1:].astype(np.float64)
