"""Window placement ops: fill, shift/re-window, and dtype conversion.

JAX replacement for the reference's per-source scanline loops
(e.g. /root/reference/src/process/SolidColorVideoSource.c:52-101) and the
implicit re-windowing that happens when a frame is pulled into a different
full_window. Frames are channel-planar ``(4, H, W)`` arrays; coordinate
``(x, y)`` maps to array element ``[:, y - full.min.y, x - full.min.x]``.

All ops preserve the zero-outside-current-window invariant.
"""

from functools import partial

import numpy as np

from canvas_tpu import backend
from canvas_tpu.basetypes import box2i, box2i_intersect

__all__ = ['blank', 'fill_solid', 'place', 'convert', 'window_slices']


def blank(window, dtype):
    """Zeros array for a full_window (numpy; promoted lazily by ops)."""
    return np.zeros((4, window.height, window.width), dtype=dtype)


def window_slices(full_window, box):
    """(row_slice, col_slice) of *box* (absolute coords) within *full_window*.

    The caller must ensure box ⊆ full_window (intersect first).
    """
    return (slice(box.min.y - full_window.min.y, box.max.y - full_window.min.y + 1),
            slice(box.min.x - full_window.min.x, box.max.x - full_window.min.x + 1))


# --- fill ---------------------------------------------------------------

def _fill_np(shape, dtype, color, rel_box):
    out = np.zeros(shape, dtype=dtype)
    y0, y1, x0, x1 = rel_box
    out[:, y0:y1 + 1, x0:x1 + 1] = np.asarray(color, dtype=dtype)[:, None, None]
    return out


def _fill_jax_builder():
    jax = backend.jax
    jnp = backend.jnp

    @partial(jax.jit, static_argnames=('shape', 'dtype'))
    def _fill(shape, dtype, color, rel_box):
        # rel_box: (4,) int32 [y0, y1, x0, x1], inclusive, dynamic values.
        H, W = shape[1], shape[2]
        rows = jax.lax.broadcasted_iota(jnp.int32, (1, H, 1), 1)
        cols = jax.lax.broadcasted_iota(jnp.int32, (1, 1, W), 2)
        mask = ((rows >= rel_box[0]) & (rows <= rel_box[1]) &
                (cols >= rel_box[2]) & (cols <= rel_box[3]))
        color = color.astype(jnp.float32)[:, None, None]
        return jnp.where(mask, color, 0.0).astype(dtype)

    return _fill


_fill_jax = None


def fill_solid(full_window, dtype, color, fill_box, force_jax=None):
    """Array for *full_window* holding *color* inside *fill_box*, zero outside.

    fill_box is in absolute coordinates and may be empty or extend beyond
    full_window (it is clipped).
    """
    shape = (4, full_window.height, full_window.width)
    clipped = box2i_intersect(fill_box, full_window)

    use_jax = backend.use_jax_for(shape) if force_jax is None else force_jax

    if clipped.empty():
        if use_jax:
            return backend.jnp.zeros(shape, dtype=dtype)
        return np.zeros(shape, dtype=dtype)

    rel = (clipped.min.y - full_window.min.y, clipped.max.y - full_window.min.y,
           clipped.min.x - full_window.min.x, clipped.max.x - full_window.min.x)

    if use_jax:
        global _fill_jax
        if _fill_jax is None:
            _fill_jax = _fill_jax_builder()
        jnp = backend.jnp
        np_dtype = np.dtype(dtype)
        return _fill_jax(shape, np_dtype.name,
                         jnp.asarray(np.asarray(color, dtype=np.float32)),
                         jnp.asarray(np.asarray(rel, dtype=np.int32)))

    return _fill_np(shape, dtype, color, rel)


# --- place (re-window) ----------------------------------------------------

def place(src, src_window, dst_window, copy_box):
    """Map *src* (full_window=src_window) into a dst_window-sized array.

    copy_box (absolute coords) is the region guaranteed valid — normally
    ``intersect(src_current, dst_window)``. Pixels of dst outside the mapped
    src stay zero; src's own zero-outside-current invariant carries over.
    """
    dst_shape = (4, dst_window.height, dst_window.width)

    if copy_box.empty():
        if backend.is_jax_array(src):
            return backend.jnp.zeros(dst_shape, dtype=src.dtype)
        return np.zeros(dst_shape, dtype=src.dtype)

    if src_window == dst_window:
        # Identity mapping (value-correct under the caller contract:
        # copy_box == intersect(current, dst) and data is zero outside
        # current). Return a COPY for mutable numpy arrays so a pulled
        # frame never aliases a stored one; jax arrays are immutable.
        if isinstance(src, np.ndarray):
            return src.copy()
        return src

    src_sl = window_slices(src_window, copy_box)
    dst_sl = window_slices(dst_window, copy_box)

    if backend.is_jax_array(src):
        jnp = backend.jnp
        out = jnp.zeros(dst_shape, dtype=src.dtype)
        return out.at[:, dst_sl[0], dst_sl[1]].set(src[:, src_sl[0], src_sl[1]])

    out = np.zeros(dst_shape, dtype=src.dtype)
    out[:, dst_sl[0], dst_sl[1]] = src[:, src_sl[0], src_sl[1]]
    return out


# --- dtype conversion -------------------------------------------------------

def convert(arr, dtype):
    if arr.dtype == dtype:
        return arr
    return arr.astype(dtype)
