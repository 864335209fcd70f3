"""Test configuration: run JAX on CPU with 8 virtual devices so sharding
tests exercise a multi-device mesh without accelerator hardware (SURVEY.md
§4.3).  Tests that need the GPU carry the ``gpu`` marker and skip without
one; on a GPU machine they run with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; decides in a fixture and "
        "skips without one")
