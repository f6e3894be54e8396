"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sharding correctness is validated on XLA's host-platform virtual devices;
what only the GPU can show runs as a phase of chip_smoke.py.  Must run
before jax is first imported anywhere in the test process.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
