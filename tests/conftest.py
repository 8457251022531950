"""Test configuration.

Tests run on a virtual 8-device CPU mesh so that multi-device sharding logic
(visma_tpu.dist) is exercised without GPUs. These env vars must be set
before jax is imported anywhere.
"""
import os

# Force CPU even on a machine with a GPU: tests exercise sharding on
# virtual devices.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compilation cache: the suite is compile-dominated on CPU;
# repeat runs (local dev, CI reruns) skip straight to execution.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache_cpu"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.environ["JAX_COMPILATION_CACHE_DIR"])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
