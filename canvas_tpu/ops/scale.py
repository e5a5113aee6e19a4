"""Separable FIR image scaling as matrix multiplies.

JAX equivalent of the reference's src/cprocess/video_scale.c and
filter.c. The reference builds a triangle FIR per output row (fractional
phase changes every row) and runs scalar accumulation loops. On device the
same math is a pair of matrix multiplies: a resample along an axis is

    out[t] = sum_s W[t, s] * src[s]

where ``W`` encodes every per-row triangle filter at once. We build W
host-side with NumPy (cheap: O(rows x taps)) and contract on device with
``einsum`` — the matmul does the heavy lifting, and XLA fuses the vertical
and horizontal passes.

Filter math (filter_createTriangle, filter.c:24-77), simplified from the
C edge-adjustment logic: taps sit at integer positions j with
|j - center| < width (endpoints at exactly +-width excluded), where
width = factor when upsampling (factor > 1) and 1/factor when
downsampling; coeff(j) = 1 - |j - center| / width, and downsampling
filters are normalized to unit sum over the full support *before* any
window clipping (filter.c:62-75).

Axis mapping (video_scale.c:34-130):
  upsample:    target_center(s) = (s - source_point) * factor + target_point
  downsample:  source_center(t) = (t - target_point) / factor + source_point
Taps are restricted to the source's current_window; an output row is
"touched" (included in the result current_window) iff any tap lands in
the source window.

Lanczos filters (filter_createLanczos, filter.c:79-146) are provided for
API parity via ``lanczos_weights``.
"""

import math

import numpy as np

from canvas_tpu import backend
from canvas_tpu.basetypes import EMPTY_BOX2I, box2i, box2i_intersect

__all__ = ['triangle_weights', 'lanczos_weights', 'axis_matrix',
           'scale_bilinear', 'scale_plan']


def _filter_edges(offset, reach):
    """The C edge dance (filter.c:39-47/87-94) in f32: ceil/floor of
    offset +/- reach, stepped inward when the edge lands exactly on the
    boundary. Returns (n_taps, center)."""
    left_edge = np.float32(np.ceil(offset - reach))
    right_edge = np.float32(np.floor(offset + reach))
    if left_edge == offset - reach:
        left_edge += np.float32(1.0)
    if right_edge == offset + reach:
        right_edge -= np.float32(1.0)
    return int(right_edge) - int(left_edge) + 1, -int(left_edge)


def _normalize_passband(coeff, sub):
    """Divide by the sequential f32 tap sum when downsampling — the same
    left-to-right accumulation the C uses, so normalized taps match its
    bits (a pairwise np.sum can differ in the last ulp)."""
    if sub < np.float32(1.0):
        s = np.float32(0.0)
        for c in coeff:
            s = np.float32(s + c)
        if s != np.float32(0.0):
            coeff = (coeff / s).astype(np.float32)
    return coeff


def triangle_weights(sub, offset):
    """Triangle FIR coefficients + center index, bit-exactly as
    filter_createTriangle (filter.c:24-77): all arithmetic in f32,
    verified against the compiled reference (tests/test_cref_parity.py).

    Returns (coeffs ndarray, center int): tap i applies to position
    (i - center) relative to the (integer) center sample; *offset* is the
    fractional distance of the true center from that sample.
    """
    sub = np.float32(sub)
    offset = np.float32(offset)
    width = np.float32(1.0) / sub if sub < np.float32(1.0) else sub
    n, center = _filter_edges(offset, width)
    i = np.arange(n, dtype=np.float32)
    inv = np.float32(1.0) / width
    coeff = (np.float32(1.0)
             - np.abs(inv * ((i - np.float32(center)) - offset)))
    return _normalize_passband(coeff.astype(np.float32), sub), center


def lanczos_weights(sub, kernel_size, offset):
    """Lanczos FIR coefficients + center, bit-exactly as
    filter_createLanczos (filter.c:79-146): f32 window edges, the tap
    formula in f64 (the C promotes through double sin), truncated back
    to f32 per tap, sequential-f32 normalization."""
    sub = np.float32(sub)
    offset = np.float32(offset)
    width = np.float32(1.0) / sub if sub < np.float32(1.0) else sub
    n, center = _filter_edges(offset, np.float32(kernel_size * width))
    x = ((1.0 / np.float64(width))
         * ((np.arange(n, dtype=np.int64) - center) - np.float64(offset)))
    with np.errstate(divide='ignore', invalid='ignore'):
        num = kernel_size * np.sin(np.pi * x) * np.sin(np.pi * x / kernel_size)
        val = num / (np.pi * np.pi * x * x)
    coeff = np.where(np.isfinite(val), val, 1.0).astype(np.float32)
    coeff = np.where(x == 0.0, np.float32(1.0), coeff)
    coeff = np.where((x <= -kernel_size) | (x >= kernel_size),
                     np.float32(0.0), coeff)
    return _normalize_passband(coeff, sub), center


def axis_matrix(factor, t_lo, t_hi, s_lo, s_hi, t_point, s_point):
    """Resample matrix W of shape (t_hi-t_lo+1, s_hi-s_lo+1) plus the
    "touched" output-row mask.

    t/s ranges are inclusive absolute coordinates: [t_lo, t_hi] is the
    target full_window extent along this axis, [s_lo, s_hi] the source
    *current_window* extent. t_point/s_point are the float anchor points.
    """
    T = t_hi - t_lo + 1
    S = s_hi - s_lo + 1
    if T <= 0 or S <= 0 or factor <= 0.0:
        # guard BEFORE allocation: negative extents (intersections of
        # disjoint boxes) must return the documented empty result, not
        # raise from np.zeros
        return (np.zeros((max(T, 0), max(S, 0)), dtype=np.float32),
                np.zeros(max(T, 0), dtype=bool))
    W = np.zeros((T, S), dtype=np.float32)

    # Both the upsample scatter (one filter per source sample,
    # video_scale.c:62-90) and downsample gather (one filter per target
    # sample, :92-122) reduce to the same gather-form taps; build them
    # vectorized and scatter into W.
    pos, w, touched = axis_taps(factor, t_lo, t_hi, s_lo, s_hi,
                                t_point, s_point)
    t_idx = np.repeat(np.arange(T), pos.shape[1])
    s_idx = (pos - s_lo).ravel()
    np.add.at(W, (t_idx, s_idx), w.ravel())
    return W, touched


def axis_taps(factor, t_lo, t_hi, s_lo, s_hi, t_point, s_point):
    """Gather-form resample taps: (pos (T, K) int32 absolute source
    coords, w (T, K) f32, touched (T,) bool).

    Mathematically identical to :func:`axis_matrix` (the scatter form of
    the upsample case rewrites to a gather with w = 1 - |g - s|, where
    g = (t - t_point)/factor + s_point), but with O(K) state per output
    sample instead of an (T, S) matrix — the right shape when parameters
    animate per frame. Out-of-window taps get weight 0 (after the
    downsample normalization, which the reference computes over the full
    support before clipping, filter.c:62-75).
    """
    T = t_hi - t_lo + 1
    if T <= 0 or factor <= 0.0:
        return (np.zeros((max(T, 0), 1), np.int32),
                np.zeros((max(T, 0), 1), np.float32),
                np.zeros(max(T, 0), bool))
    t = np.arange(t_lo, t_hi + 1, dtype=np.float64)
    width = 1.0 if factor > 1.0 else 1.0 / factor
    # STRICT: the reference normalizes only for sub < 1.0 (filter.c:70);
    # at factor exactly 1.0 with a fractional offset, dividing the
    # (1-f, f) taps by their float32 sum perturbs each by an ulp and
    # breaks bit-parity with triangle_weights-built matrices.
    norm = factor < 1.0
    g = (t - t_point) / factor + s_point
    left = np.floor(g - width).astype(np.int64) + 1
    right = np.ceil(g + width).astype(np.int64) - 1
    K = int(max(1, (right - left).max() + 1))
    pos = left[:, None] + np.arange(K)[None, :]
    in_support = pos <= right[:, None]
    dist = np.abs(pos - g[:, None]) / width
    w_raw = np.where(in_support, 1.0 - dist, 0.0).astype(np.float32)
    w = w_raw
    if norm:
        sums = w.sum(axis=1, keepdims=True)
        w = np.where(sums != 0.0, w / np.where(sums != 0.0, sums, 1.0), 0.0)
    in_window = (pos >= s_lo) & (pos <= s_hi)
    w = np.where(in_window, w, 0.0).astype(np.float32)
    touched = (in_window & (w_raw != 0.0)).any(axis=1)
    pos = np.clip(pos, s_lo, s_hi).astype(np.int32)
    return pos, w, touched


def _touched_range(touched, lo):
    idx = np.nonzero(touched)[0]
    if idx.size == 0:
        return None
    return int(idx[0]) + lo, int(idx[-1]) + lo


def scale_plan(target_window, target_point, source_window, source_point,
               factors):
    """Host-side plan for a bilinear scale: the two axis matrices and the
    resulting current_window.

    target_window: target full_window (box2i); source_window: source
    current_window (box2i); target_point/source_point: v2f-likes;
    factors: v2f-like scale factors. Returns (Wy, Wx, out_window) or
    None if the result is empty.
    """
    if source_window.empty():
        return None
    fx, fy = float(factors[0]), float(factors[1])
    if fx <= 0.0 or fy <= 0.0:
        return None

    Wy, touched_y = axis_matrix(fy, target_window.min.y, target_window.max.y,
                                source_window.min.y, source_window.max.y,
                                float(target_point[1]), float(source_point[1]))
    Wx, touched_x = axis_matrix(fx, target_window.min.x, target_window.max.x,
                                source_window.min.x, source_window.max.x,
                                float(target_point[0]), float(source_point[0]))

    if fy == 1.0 and float(target_point[1]) == float(source_point[1]):
        # Identity on y: current window y = source y clipped to target
        ymin = max(source_window.min.y, target_window.min.y)
        ymax = min(source_window.max.y, target_window.max.y)
        yr = (ymin, ymax) if ymin <= ymax else None
    else:
        yr = _touched_range(touched_y, target_window.min.y)
    if fx == 1.0 and float(target_point[0]) == float(source_point[0]):
        xmin = max(source_window.min.x, target_window.min.x)
        xmax = min(source_window.max.x, target_window.max.x)
        xr = (xmin, xmax) if xmin <= xmax else None
    else:
        xr = _touched_range(touched_x, target_window.min.x)

    if yr is None or xr is None:
        return None
    out_window = box2i(xr[0], yr[0], xr[1], yr[1])
    return Wy, Wx, out_window


def _apply_np(src, Wy, Wx):
    # np.matmul (BLAS) instead of einsum: (Ty,H)@(4,H,W) -> (4,Ty,W),
    # then (4,Ty,W)@(W,Tx) -> (4,Ty,Tx)
    tmp = np.matmul(Wy, src.astype(np.float32))
    return np.matmul(tmp, Wx.T).astype(np.float32)


_jax_apply = None


def _apply_jax():
    global _jax_apply
    if _jax_apply is None:
        jax = backend.jax
        jnp = backend.jnp

        @jax.jit
        def apply(src, Wy, Wx):
            # precision='highest': full f32 (the GPU would otherwise run
            # TF32) so results track the C/NumPy reference within f32
            # rounding.
            src = src.astype(jnp.float32)
            tmp = jnp.einsum('yh,chw->cyw', Wy, src, precision='highest',
                             preferred_element_type=jnp.float32)
            return jnp.einsum('xw,cyw->cyx', Wx, tmp, precision='highest',
                              preferred_element_type=jnp.float32)

        _jax_apply = apply
    return _jax_apply


def scale_bilinear(src_data, src_full_window, src_current_window,
                   target_window, target_point, source_point, factors):
    """Scale (4, H, W) *src_data* into a target_window-sized array.

    Returns (data, current_window); current_window EMPTY_BOX2I with a
    zero array when nothing lands in the target. Equivalent of
    video_scale_bilinear_f32 (video_scale.c:231-286); because the matrix
    contraction has no temp-buffer constraint, both axes are applied in
    one fused pass rather than smaller-factor-first.
    """
    out_shape = (4, target_window.height, target_window.width)

    plan = scale_plan(target_window, target_point, src_current_window,
                      source_point, factors)
    use_jax = backend.is_jax_array(src_data) or backend.use_jax_for(out_shape)
    if plan is None:
        if use_jax:
            return backend.jnp.zeros(out_shape, np.float32), EMPTY_BOX2I
        return np.zeros(out_shape, np.float32), EMPTY_BOX2I

    Wy_full, Wx_full, out_window = plan

    # W was built over the source *current* window; expand to the full
    # source array extent with zero columns so shapes line up.
    def expand(W, s_cur_lo, s_cur_hi, s_full_lo, s_full_hi):
        S_full = s_full_hi - s_full_lo + 1
        out = np.zeros((W.shape[0], S_full), dtype=np.float32)
        a = s_cur_lo - s_full_lo
        out[:, a:a + W.shape[1]] = W
        return out

    Wy = expand(Wy_full, src_current_window.min.y, src_current_window.max.y,
                src_full_window.min.y, src_full_window.max.y)
    Wx = expand(Wx_full, src_current_window.min.x, src_current_window.max.x,
                src_full_window.min.x, src_full_window.max.x)

    if use_jax:
        jnp = backend.jnp
        out = _apply_jax()(jnp.asarray(src_data), jnp.asarray(Wy),
                           jnp.asarray(Wx))
    else:
        out = _apply_np(np.asarray(src_data), Wy, Wx)
    return out, box2i_intersect(out_window, target_window)
