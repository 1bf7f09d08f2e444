"""Test configuration.

Default: run everything on a virtual 8-device CPU mesh.  The platform is
forced through jax.config before the first backend use.

GPU gate: `FLASHE_TESTS_GPU=1 python -m pytest tests/test_gpu_gate.py -m
gpu` keeps JAX's default backend, so the `gpu`-marked tests run on the
card.  Whether a card is there is decided inside those tests' fixture
(tests/test_gpu_gate.py); on the CPU they skip with a reason.
"""

import os

_GPU_GATE = os.environ.get("FLASHE_TESTS_GPU") == "1"

if not _GPU_GATE:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

from flashe_tpu import jaxenv  # noqa: E402

jaxenv.setup(force_cpu=not _GPU_GATE)
if not _GPU_GATE:
    assert jax.devices()[0].platform == "cpu", \
        "tests must run on CPU devices"
    assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"

# keep the job registry / dataset store out of the real home dir unless a
# test overrides them explicitly
import tempfile  # noqa: E402

_state = tempfile.mkdtemp(prefix="flashe_test_state_")
os.environ.setdefault("FLASHE_JOBS_DIR", os.path.join(_state, "jobs"))
os.environ.setdefault("FLASHE_DATA_DIR", os.path.join(_state, "data"))
os.environ.setdefault("FLASHE_MODELS_DIR", os.path.join(_state, "models"))
os.environ.setdefault("FLASHE_PERMISSIONS_PATH",
                      os.path.join(_state, "permissions.json"))
