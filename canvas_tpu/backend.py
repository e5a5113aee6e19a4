"""Array backend dispatch: NumPy for tiny frames, JAX for real ones.

Every pixel op in ``canvas_tpu.ops`` has two implementations with identical
semantics: a NumPy one (which doubles as the golden reference used by the
kernel tests, mirroring the role of the reference's C cprocess code) and a
JAX one. Each device dispatch has a fixed cost, so frames below a pixel
threshold run the NumPy path — the reference's 1×1-pixel test pulls and the
editor's host-side bookkeeping stay fast — while production-size frames run
on the device.

The batched render path (canvas_tpu.render) always uses JAX.

Environment / runtime overrides:
    CANVAS_BACKEND = auto (default) | numpy | jax
"""

import os
import threading

import numpy as np

__all__ = ['get_backend', 'set_backend', 'use_jax_for', 'asnumpy', 'is_jax_array',
           'jax', 'jnp', 'device_pixel_threshold']

# Pixels (per frame) at or above which the JAX path is used in 'auto' mode.
# 2**14 = a 128x128 tile; below that, dispatch overhead beats compute.
device_pixel_threshold = 1 << 14

_state = threading.local()
_DEFAULT = os.environ.get('CANVAS_BACKEND', 'auto')

_jax = None
_jnp = None
_jax_failed = False


def _load_jax():
    global _jax, _jnp, _jax_failed
    if _jax is None and not _jax_failed:
        try:
            import jax as jax_mod
            import jax.numpy as jnp_mod
            _jax, _jnp = jax_mod, jnp_mod
        except Exception:
            _jax_failed = True
    return _jax


class _LazyModule:
    """Attribute access proxy so ``backend.jnp.float16`` works lazily."""

    def __init__(self, getter):
        self._getter = getter

    def __getattr__(self, name):
        mod = self._getter()
        if mod is None:
            raise RuntimeError('JAX is not available')
        return getattr(mod, name)


jax = _LazyModule(_load_jax)
jnp = _LazyModule(lambda: _load_jax() and _jnp)


def jax_available():
    return _load_jax() is not None


_initialized = False
_init_lock = threading.Lock()


def compile_cache_dir():
    """Directory of JAX's persistent compilation cache for every entry
    point (bench, benchmarks, chip_smoke, the tests, the scripts, the
    playback engine): ``JAX_COMPILATION_CACHE_DIR`` when set, else
    ``.jax_cache`` at the root of this checkout (git-ignored). A fixed
    path matters: the path is part of the cache key, so a directory
    that moves never hits."""
    return (os.environ.get('JAX_COMPILATION_CACHE_DIR')
            or os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), '.jax_cache'))


def configure_compile_cache():
    """Point JAX's persistent compilation cache at compile_cache_dir().

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it itself and
    nothing is set here. Goes through jax.config rather than the
    environment, which JAX has already read if it was imported first."""
    if os.environ.get('JAX_COMPILATION_CACHE_DIR') or _load_jax() is None:
        return
    _jax.config.update('jax_compilation_cache_dir', compile_cache_dir())
    _jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)


def ensure_initialized():
    """Initialize the JAX backend from the *calling* thread.

    Engine components that spawn render/prefetch threads call this in
    their constructors (normally on the main thread), so that device
    discovery, client setup and the compile-cache configuration happen
    once, before any worker thread runs JAX, and never race between
    threads. The platform is whatever JAX was configured with; a
    missing device is an error from JAX, never a switch to the CPU."""
    global _initialized
    if _initialized:
        return
    with _init_lock:
        if _initialized:
            return
        if _load_jax() is not None:
            configure_compile_cache()
            _jax.devices()
            _jnp.zeros(8).block_until_ready()
        _initialized = True


def get_backend():
    return getattr(_state, 'backend', _DEFAULT)


def set_backend(name):
    """Set the backend for this thread: 'auto', 'numpy', or 'jax'."""
    if name not in ('auto', 'numpy', 'jax'):
        raise ValueError(name)
    _state.backend = name


class force_backend:
    """Context manager to pin the backend (used heavily in tests)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.saved = get_backend()
        set_backend(self.name)
        return self

    def __exit__(self, *exc):
        set_backend(self.saved)
        return False


def use_jax_for(shape):
    """Decide whether an op over an array of this shape should run on JAX."""
    mode = get_backend()
    if mode == 'numpy':
        return False
    if not jax_available():
        return False
    if mode == 'jax':
        return True
    pixels = 1
    for dim in shape[-2:]:
        pixels *= int(dim)
    return pixels >= device_pixel_threshold


def is_jax_array(arr):
    # load on demand: jax may have been imported outside this module,
    # and a stale None here silently routed device arrays down numpy
    # paths
    jax = _jax if _jax is not None else _load_jax()
    if jax is None:
        return False
    return isinstance(arr, jax.Array)


def asnumpy(arr):
    if arr is None:
        return None
    if isinstance(arr, np.ndarray):
        return arr
    return np.asarray(arr)


# --- staging transfer accounting --------------------------------------------

#: Cumulative host->device staging bytes (frame/plane stacks shipped by
#: the render planner). Tests use this to assert that cached replays
#: transfer zero bytes; benchmarks report it per config.
transfer_stats = {'h2d_bytes': 0, 'h2d_calls': 0}
_stats_lock = threading.Lock()


def stage_to_device(host_array, mesh=None):
    """device_put for STAGED render inputs, with transfer accounting.

    All planner staging (frame stacks, coded plane stacks) goes through
    here so `transfer_stats` reflects real H2D traffic; replicates over
    *mesh* when sharded programs will consume the array."""
    ensure_initialized()
    jax = _load_jax()
    if jax is None:
        raise RuntimeError('JAX is not available')
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        out = jax.device_put(
            host_array, NamedSharding(mesh, PartitionSpec()))
    else:
        out = jax.device_put(host_array)
    # count AFTER device_put succeeds (a failed staging must not leave
    # phantom traffic in the zero-H2D replay assertions), under the
    # stats lock (prepare thread and main thread both stage)
    with _stats_lock:
        transfer_stats['h2d_bytes'] += int(host_array.nbytes)
        transfer_stats['h2d_calls'] += 1
    return out
