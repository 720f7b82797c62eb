"""Test harness configuration: run the whole suite on a simulated 8-device
CPU mesh so sharding/collective logic is exercised without accelerator
hardware, whatever accelerator the machine has. Tests that need the GPU
live in ``gpu_tests/``, outside this conftest's reach.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
