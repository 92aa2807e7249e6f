"""Test configuration: force CPU backend with 8 virtual devices.

Multi-chip sharding paths are exercised on a virtual CPU mesh
(xla_force_host_platform_device_count), per the repo's test strategy
(SURVEY.md §4). The GPU is exercised by `python chip_smoke.py`, not by the
tests.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
