"""Test env: the CPU backend with 8 virtual devices, so mesh/DP semantics
are exercised without accelerators (SURVEY.md section 4 test strategy,
item c). Tests that need a GPU carry the `gpu` marker and skip here."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cpu_devices():
    return jax.devices("cpu")


@pytest.fixture(scope="session")
def mesh8(cpu_devices):
    from open_pandora_tpu.core.config import MeshConfig
    from open_pandora_tpu.parallel.mesh import build_mesh

    return build_mesh(MeshConfig(), devices=cpu_devices)
