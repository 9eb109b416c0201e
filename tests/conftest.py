"""Test harness config.

All tests run on a virtual 8-device CPU mesh (no accelerator needed), mirroring the
reference's fake-backend strategy (SURVEY.md §4 item 4: the in-process CPU
provider implements the full AccelProvider trait so GPU-semantics tests run
deterministically with no GPU). GPU runs happen through chip_smoke.py and
the tests marked `gpu`, which skip here.
"""

import os

# Must be set before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["RUNMAT_TPU_PLATFORM"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Pin the platform through jax.config as well, before any backend init, so a
# GPU plugin that is installed is never initialized by the tests.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
