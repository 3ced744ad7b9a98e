"""Test configuration.

Tests run on a virtual 8-device CPU backend (SURVEY.md §4.3: multi-device
tests without a cluster): JAX_PLATFORMS defaults to "cpu" here, and
subprocesses the tests start inherit it.

Tests marked ``gpu`` need an NVIDIA card and skip without one. Run them on
the card with the GPU backend visible (chip_smoke.py does this)::

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _card_for_gpu_tests(request):
    """Skip a ``gpu``-marked test unless the default device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest tests -m gpu on the card")
