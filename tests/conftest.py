"""
Test configuration: run on an 8-device virtual CPU mesh in fp64 so
golden-parity tests against the reference's float64 pickles are exact.
Env vars must be set before jax / pisa_tpu are first imported.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere (the ``gpu``
fixture decides at run time). Run that lane on a machine with a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# XLA:CPU aborts the process when a collective rendezvous of the virtual
# mesh waits longer than its termination timeout (40 s by default), which
# a loaded host running several test workers at once can exceed.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
    + " --xla_cpu_collective_call_terminate_timeout_seconds=1200"
)
os.environ.setdefault("PISA_TPU_FTYPE", "fp64")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")
    return jax.devices()[0]
