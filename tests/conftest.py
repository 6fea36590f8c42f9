"""Test configuration: force JAX onto CPU with 8 virtual devices so sharding
tests exercise a real multi-device mesh without accelerator hardware.

jax_platforms is pinned through jax.config as well as the environment
(backends initialize lazily, so this wins as long as no test touched a
device yet). Tests that need a CUDA GPU carry the ``gpu`` marker and skip
here; ``python chip_smoke.py`` runs the card's path."""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", jax.default_backend()
