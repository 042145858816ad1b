"""Test harness configuration.

The platform is JAX's own choice: ``JAX_PLATFORMS=cpu`` runs the suite
on the CPU backend, where 8 virtual devices exercise the multi-device
sharding (the ``shard_map`` programs compile the same way).  Tests
marked ``gpu`` need an NVIDIA card and skip elsewhere; run them on the
card with ``python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import pathlib  # noqa: E402

import pytest  # noqa: E402

REFERENCE_EXAMPLES = pathlib.Path("/root/reference/examples")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's default device is a GPU
    (decided when the test runs, never at import or collection)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: python -m pytest -m gpu tests/ on the card")


@pytest.fixture
def ook_capture() -> pathlib.Path:
    path = REFERENCE_EXAMPLES / "cupboard-superdec.sr400.cf32"
    if not path.exists():
        pytest.skip("reference OOK example capture not available")
    return path


@pytest.fixture
def fsk_capture() -> pathlib.Path:
    path = REFERENCE_EXAMPLES / "fsk-example.sr21M.fc32"
    if not path.exists():
        pytest.skip("reference FSK example capture not available")
    return path
