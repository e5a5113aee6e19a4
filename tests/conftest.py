"""Test configuration: run JAX on CPU with 8 virtual devices so multi-device
sharding paths are exercised without accelerators. Must run before jax
initializes a backend.

Set CANVAS_TEST_DEVICE=1 to run against the real device instead, in ONE
process (no ``-n``: each JAX process reserves most of a GPU's memory):
``CANVAS_TEST_DEVICE=1 python -m pytest tests/ -q -m 'not slow'``.

Tests marked ``gpu`` need a GPU and skip elsewhere; the check runs in a
fixture, never while a module is imported.
"""

import os

_use_device = bool(os.environ.get('CANVAS_TEST_DEVICE'))

# jax.config.update (below) redirects tests onto the virtual 8-device CPU
# platform even when jax was imported before this file ran; XLA_FLAGS is
# still read lazily at first backend init.
if not _use_device:
    _flags = os.environ.get('XLA_FLAGS', '')
    if 'xla_force_host_platform_device_count' not in _flags:
        os.environ['XLA_FLAGS'] = (
            _flags + ' --xla_force_host_platform_device_count=8').strip()
    os.environ['JAX_PLATFORMS'] = 'cpu'

import jax  # noqa: E402

if not _use_device:
    jax.config.update('jax_platforms', 'cpu')

from canvas_tpu import backend as _backend  # noqa: E402

_backend.configure_compile_cache()

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs a GPU; skips on other platforms')


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if (request.node.get_closest_marker('gpu') is not None
            and jax.devices()[0].platform != 'gpu'):
        pytest.skip('needs a GPU (JAX platform is %r)'
                    % jax.devices()[0].platform)


@pytest.fixture
def jax_backend():
    """Force the JAX op path regardless of frame size."""
    from canvas_tpu import backend
    with backend.force_backend('jax'):
        yield


@pytest.fixture
def numpy_backend():
    from canvas_tpu import backend
    with backend.force_backend('numpy'):
        yield


@pytest.fixture(params=['numpy', 'jax'])
def any_backend(request):
    """Parametrize a test over both op backends."""
    from canvas_tpu import backend
    with backend.force_backend(request.param):
        yield request.param
