"""Chroma reconstruction and subsampling kernels.

JAX equivalents of the reference's src/cprocess/video_reconstruct.c
and video_subsample.c. The reference runs per-row scalar FIR loops (CPU)
or GLSL shaders (GPU); here each step is expressed as dense linear algebra
so XLA compiles it to fused elementwise passes and matmuls:

* studio-range expansion/compression: elementwise
* chroma up/down-sampling: a fixed resample matrix contracted with the
  chroma planes (a matmul) — built once per geometry and cached
* YCbCr<->RGB: a 3x3 matrix einsum
* transfer curves: the shared f16-LUT gather from canvas_tpu.ops.color

DV geometry (video_reconstruct.c:50-137, video_subsample.c:95-187):
720x480, 4:1:1 chroma co-sited with the left pixel, Rec.709 matrix and
transfer, picture offset (0,-1) so line zero belongs to the first field.

MPEG-2 geometry (video_subsample.c:196-293): 4:2:0 interlaced, chroma
sited per-field with the reference shader's (3,6,3)/16 + (1,2,1)/16
near/far tap pattern, Rec.709 matrix and transfer.
"""

import numpy as np

from canvas_tpu import backend
from canvas_tpu.basetypes import EMPTY_BOX2I, box2i, box2i_intersect
from canvas_tpu.ops import color as color_ops
from canvas_tpu.ops import scale as scale_ops

__all__ = ['DV_FULL_WIDTH', 'DV_FULL_HEIGHT', 'DV_PIC_OFFSET',
           'YCBCR_TO_RGB_REC709', 'RGB_TO_YCBCR_REC709',
           'reconstruct_dv', 'subsample_dv', 'subsample_mpeg2']

DV_FULL_WIDTH = 720
DV_FULL_HEIGHT = 480
DV_PIC_OFFSET = (0, -1)      # video_reconstruct.c:70-71

# Rec. 709 YCbCr -> RGB (Poynton p. 316; video_reconstruct.c:62-66)
# Rec. 601 YCbCr->RGB (Poynton p.305 — the matrix the reference lists
# alongside its 709 choice, video_reconstruct.c:55-60)
YCBCR_TO_RGB_REC601 = np.array([
    [1.0, 0.0, 1.402],
    [1.0, -0.344136, -0.714136],
    [1.0, 1.772, 0.0]], dtype=np.float32)

YCBCR_TO_RGB_REC709 = np.array([
    [1.0, 0.0, 1.5748],
    [1.0, -0.187324, -0.468124],
    [1.0, 1.8556, 0.0]], dtype=np.float32)

# RGB -> Rec. 709 YPbPr (Poynton p. 315; video_subsample.c:103-107)
RGB_TO_YCBCR_REC709 = np.array([
    [0.2126, 0.7152, 0.0722],
    [-0.114572, -0.385428, 0.5],
    [0.5, -0.454153, -0.045847]], dtype=np.float32)


def _studio_luma8_to_float(y):
    return (y - np.float32(16.0)) / np.float32(219.0)


def _studio_chroma8_to_float(c):
    return (c - np.float32(128.0)) / np.float32(224.0)


def _to_u8_trunc(x):
    """C (uint8_t) cast of an in-range float: truncate toward zero (the
    reference never clamps here; we clamp first to stay defined)."""
    x = np.clip(x, 0.0, 255.0)
    return np.trunc(x).astype(np.uint8)


# --- resample matrices (cached per geometry) ---------------------------------

_matrix_cache = {}


def _dv_up_matrix():
    """(720, 180) chroma scatter matrix: triangle filter sub=4, offset 0
    (video_reconstruct.c:85-109). Chroma sample x contributes to luma
    columns 4x-3 .. 4x+3 with weights 1-|i|/4 (not normalized)."""
    key = 'dv_up'
    W = _matrix_cache.get(key)
    if W is None:
        coeff, center = scale_ops.triangle_weights(4.0, 0.0)
        W = np.zeros((DV_FULL_WIDTH, DV_FULL_WIDTH // 4), dtype=np.float32)
        endx = (DV_FULL_WIDTH - 1) // 4
        for x in range(endx + 1):
            for k, w in enumerate(coeff):
                i = x * 4 + (k - center)
                if 0 <= i < DV_FULL_WIDTH:
                    W[i, x] += w
        _matrix_cache[key] = W
    return W


def _dv_down_matrix():
    """(180, 720) chroma gather matrix: normalized triangle sub=1/4
    (video_subsample.c:130-131, 158-171)."""
    key = 'dv_down'
    W = _matrix_cache.get(key)
    if W is None:
        coeff, center = scale_ops.triangle_weights(0.25, 0.0)
        W = np.zeros((DV_FULL_WIDTH // 4, DV_FULL_WIDTH), dtype=np.float32)
        for tx in range(DV_FULL_WIDTH // 4):
            for k, w in enumerate(coeff):
                sx = tx * 4 + (k - center)
                if 0 <= sx < DV_FULL_WIDTH:
                    W[tx, sx] += w
        _matrix_cache[key] = W
    return W


# --- DV reconstruction -------------------------------------------------------

def reconstruct_dv_full(y_plane, cb_plane, cr_plane):
    """Full-frame DV 4:1:1 -> linear RGBA f16, NumPy reference path.

    y: (480, 720) u8; cb/cr: (480, 180) u8. Returns (4, 480, 480x720
    layout) f16 in *image coordinates* (row 0 = image line 0); callers
    apply the (0,-1) picture offset when windowing.
    """
    y = _studio_luma8_to_float(y_plane.astype(np.float32))
    cb = _studio_chroma8_to_float(cb_plane.astype(np.float32))
    cr = _studio_chroma8_to_float(cr_plane.astype(np.float32))

    U = _dv_up_matrix()
    cb_full = cb @ U.T       # (480, 720)
    cr_full = cr @ U.T

    M = YCBCR_TO_RGB_REC709
    ycc = np.stack([y, cb_full, cr_full], axis=0)
    rgb = np.einsum('ij,jhw->ihw', M, ycc)
    alpha = np.ones_like(y)[None]
    # TRUNCATING f32->f16 like the reference's rgba_f32_to_f16
    # (half_convert_from_float rounds toward zero) — keeps the LUT input,
    # and so the decoded pixels, on the C engine's bits
    # (tests/test_cref_parity.py::test_reconstruct_dv).
    rgba16 = color_ops.float_to_half_trunc(
        np.concatenate([rgb, alpha], axis=0))
    return color_ops.transfer_rec709_to_linear_scene(rgba16)


_jax_recon = None


def _jax_reconstruct_dv():
    global _jax_recon
    if _jax_recon is None:
        jax = backend.jax
        jnp = backend.jnp
        lut = color_ops.get_lut('rec709_to_linear_scene')

        @jax.jit
        def recon(y_plane, cb_plane, cr_plane, U, M):
            y = (y_plane.astype(jnp.float32) - 16.0) / 219.0
            cb = (cb_plane.astype(jnp.float32) - 128.0) / 224.0
            cr = (cr_plane.astype(jnp.float32) - 128.0) / 224.0
            cb_full = jnp.einsum('hs,xs->hx', cb, U,
                                 preferred_element_type=jnp.float32, precision='highest')
            cr_full = jnp.einsum('hs,xs->hx', cr, U,
                                 preferred_element_type=jnp.float32, precision='highest')
            ycc = jnp.stack([y, cb_full, cr_full], axis=0)
            rgb = jnp.einsum('ij,jhw->ihw', M, ycc,
                             preferred_element_type=jnp.float32, precision='highest')
            alpha = jnp.ones_like(y)[None]
            # truncating f32->f16 grid (matches the NumPy golden and the
            # reference's rgba_f32_to_f16)
            rgba16 = color_ops.quantize_f16_trunc(
                jnp.concatenate([rgb, alpha], axis=0), jnp, jax
            ).astype(jnp.float16)
            bits = jax.lax.bitcast_convert_type(
                rgba16, jnp.uint16).astype(jnp.int32)
            return jnp.take(jnp.asarray(lut), bits, axis=0)

        _jax_recon = recon
    return _jax_recon


def reconstruct_dv(planes, full_window, use_jax=None):
    """DV 4:1:1 planar -> windowed linear RGBA f16 frame data.

    planes: (y, cb, cr) u8 arrays of shapes (480,720), (480,180),
    (480,180). Returns (data (4,H,W) f16, current_window) for the given
    target *full_window* (video_reconstruct.c:50-137).
    """
    ox, oy = DV_PIC_OFFSET
    image_box = box2i(ox, oy, DV_FULL_WIDTH + ox - 1, DV_FULL_HEIGHT + oy - 1)
    current = box2i_intersect(image_box, full_window)
    shape = (4, full_window.height, full_window.width)
    if current.empty():
        return np.zeros(shape, np.float16), EMPTY_BOX2I

    if use_jax is None:
        use_jax = backend.use_jax_for(shape)

    if use_jax:
        jnp = backend.jnp
        full = _jax_reconstruct_dv()(
            jnp.asarray(planes[0]), jnp.asarray(planes[1]),
            jnp.asarray(planes[2]), jnp.asarray(_dv_up_matrix()),
            jnp.asarray(YCBCR_TO_RGB_REC709))
    else:
        full = reconstruct_dv_full(planes[0], planes[1], planes[2])

    from canvas_tpu.ops import window as window_ops
    data = window_ops.place(full, image_box, full_window, current)
    return data, current


# --- generic planar reconstruction (4:2:0 / 4:2:2 / 4:1:1, any size) --------

def _up_matrix_generic(n_full, n_sub, siting=0.0):
    """(n_full, n_sub) chroma scatter matrix for an integer subsample
    factor (triangle filter — the same filter family the reference's DV
    reconstruct uses, video_reconstruct.c:85-109). Factor 1 is the
    identity.

    *siting* is the chroma sample position offset in full-resolution
    units: 0.0 co-sites chroma with the first luma sample (DV 4:1:1 /
    horizontal MPEG convention); 0.5 centers it between samples (the
    MPEG-2/H.264 vertical 4:2:0 convention). Sited matrices renormalize
    each output row to unit sum so frame edges (where part of the
    triangle support falls outside the plane) keep full chroma weight."""
    key = ('up_generic', n_full, n_sub, float(siting))
    W = _matrix_cache.get(key)
    if W is None:
        if n_sub <= 0:
            raise ValueError('empty chroma plane')
        factor = max(1, round(n_full / n_sub))
        if factor == 1 and siting == 0.0:
            W = np.eye(n_full, n_sub, dtype=np.float32)
            if n_full > n_sub:
                # malformed/cropped geometry rounding to factor 1: the
                # extra luma rows extend the LAST chroma sample instead
                # of decoding desaturated (all-zero weight rows would
                # bypass the triangle branch's edge renormalization)
                W[n_sub:, n_sub - 1] = 1.0
        else:
            coeff, center = scale_ops.triangle_weights(float(factor),
                                                       float(siting))
            W = np.zeros((n_full, n_sub), dtype=np.float32)
            for x in range(n_sub):
                for k, w in enumerate(coeff):
                    i = x * factor + (k - center)
                    if 0 <= i < n_full:
                        W[i, x] += w
            # Renormalize EVERY geometry's edge rows (not just sited
            # ones): co-sited factor>1 matrices lose triangle support
            # past the last chroma sample, which halved Cb/Cr toward
            # gray at the right/bottom edge of decoded 4:2:0/4:2:2
            # frames. (The DV path has its own reference-exact matrix.)
            sums = W.sum(axis=1, keepdims=True)
            W = np.where(sums > 0.0, W / np.where(sums > 0.0, sums, 1.0),
                         W).astype(np.float32)
        _matrix_cache[key] = W
    return W


def _vertical_siting(n_full, n_sub):
    """Vertical chroma siting for a plane geometry: MPEG-2/H.264 4:2:0
    centers chroma between luma rows (offset 0.5); every other common
    geometry (4:2:2, 4:1:1, 4:4:4) is vertically co-sited."""
    factor = max(1, round(n_full / max(1, n_sub)))
    return 0.5 if factor == 2 else 0.0


def ycbcr_matrix(name):
    if name == 'rec601':
        return YCBCR_TO_RGB_REC601
    if name == 'rec709':
        return YCBCR_TO_RGB_REC709
    # raising beats silently decoding with the wrong primaries
    raise ValueError("matrix must be 'rec709' or 'rec601', got %r"
                     % (name,))


def reconstruct_planar_full(y_plane, cb_plane, cr_plane, matrix='rec709'):
    """Full-frame planar YCbCr (any 8-bit subsampling with integer
    factors: 4:2:0, 4:2:2, 4:1:1, 4:4:4) -> linear RGBA f16, NumPy
    reference path. Studio-range expand, separable triangle chroma
    upsample on both axes, Rec.709 matrix, scene transfer — the DV
    reconstruction generalized to arbitrary geometry."""
    yh, yw = y_plane.shape
    ch, cw = cb_plane.shape
    y = _studio_luma8_to_float(y_plane.astype(np.float32))
    cb = _studio_chroma8_to_float(cb_plane.astype(np.float32))
    cr = _studio_chroma8_to_float(cr_plane.astype(np.float32))

    Uh = _up_matrix_generic(yw, cw)
    Uv = _up_matrix_generic(yh, ch, siting=_vertical_siting(yh, ch))
    cb_full = Uv @ cb @ Uh.T
    cr_full = Uv @ cr @ Uh.T

    M = ycbcr_matrix(matrix)
    ycc = np.stack([y, cb_full, cr_full], axis=0)
    rgb = np.einsum('ij,jhw->ihw', M, ycc)
    alpha = np.ones_like(y)[None]
    # truncating f32->f16, matching the reference (see reconstruct_dv_full)
    rgba16 = color_ops.float_to_half_trunc(
        np.concatenate([rgb, alpha], axis=0))
    return color_ops.transfer_rec709_to_linear_scene(rgba16)


_jax_planar_recon = None


def _jax_reconstruct_planar():
    global _jax_planar_recon
    if _jax_planar_recon is None:
        jax = backend.jax
        jnp = backend.jnp
        lut = color_ops.get_lut('rec709_to_linear_scene')

        @jax.jit
        def recon(y_plane, cb_plane, cr_plane, Uh, Uv, M):
            y = (y_plane.astype(jnp.float32) - 16.0) / 219.0
            cb = (cb_plane.astype(jnp.float32) - 128.0) / 224.0
            cr = (cr_plane.astype(jnp.float32) - 128.0) / 224.0

            def up(c):
                c = jnp.einsum('hs,xs->hx', c, Uh,
                               preferred_element_type=jnp.float32,
                               precision='highest')
                return jnp.einsum('sw,hs->hw', c, Uv,
                                  preferred_element_type=jnp.float32,
                                  precision='highest')

            ycc = jnp.stack([y, up(cb), up(cr)], axis=0)
            rgb = jnp.einsum('ij,jhw->ihw', M, ycc,
                             preferred_element_type=jnp.float32,
                             precision='highest')
            alpha = jnp.ones_like(y)[None]
            # truncating f32->f16 grid (matches the NumPy golden)
            rgba16 = color_ops.quantize_f16_trunc(
                jnp.concatenate([rgb, alpha], axis=0), jnp, jax
            ).astype(jnp.float16)
            bits = jax.lax.bitcast_convert_type(
                rgba16, jnp.uint16).astype(jnp.int32)
            return jnp.take(jnp.asarray(lut), bits, axis=0)

        _jax_planar_recon = recon
    return _jax_planar_recon


def reconstruct_planar(planes, full_window, use_jax=None,
                       matrix='rec709'):
    """Planar YCbCr -> windowed linear RGBA f16 frame data.

    planes: (y, cb, cr) u8 arrays; image coordinates start at (0, 0).
    *matrix* selects 'rec709' or 'rec601'. Returns
    (data (4, H, W) f16, current_window)."""
    yh, yw = planes[0].shape
    image_box = box2i(0, 0, yw - 1, yh - 1)
    current = box2i_intersect(image_box, full_window)
    shape = (4, full_window.height, full_window.width)
    if current.empty():
        return np.zeros(shape, np.float16), EMPTY_BOX2I

    if use_jax is None:
        use_jax = backend.use_jax_for(shape)

    if use_jax:
        jnp = backend.jnp
        ch, cw = planes[1].shape
        full = _jax_reconstruct_planar()(
            jnp.asarray(planes[0]), jnp.asarray(planes[1]),
            jnp.asarray(planes[2]),
            jnp.asarray(_up_matrix_generic(yw, cw)),
            jnp.asarray(_up_matrix_generic(
                yh, ch, siting=_vertical_siting(yh, ch))),
            jnp.asarray(ycbcr_matrix(matrix)))
    else:
        full = reconstruct_planar_full(planes[0], planes[1], planes[2],
                                       matrix=matrix)

    from canvas_tpu.ops import window as window_ops
    data = window_ops.place(full, image_box, full_window, current)
    return data, current


# --- DV subsampling ----------------------------------------------------------

_jax_dv_sub = None


def _jax_subsample_dv():
    """Device DV 4:1:1 subsample: same math as the NumPy path below —
    f16 LUT-gather transfer (bit-exact vs the eager contract), matrixed
    YCbCr, triangle 4:1 chroma decimation, C-cast truncation — with
    the window realized as traced masks (one compiled program for any
    current_window) and the three planes PACKED into one u8 buffer so
    an export pays a single fetch (518 KB) instead of shipping the
    whole f16 frame (2.8 MB) to subsample on the host."""
    global _jax_dv_sub
    if _jax_dv_sub is None:
        jax = backend.jax
        jnp = backend.jnp

        @jax.jit
        def sub(img, lut, M, D, row_mask, col_mask, tx_mask):
            bits = jax.lax.bitcast_convert_type(
                img.astype(jnp.float16), jnp.uint16).astype(jnp.int32)
            img709 = jnp.take(lut, bits, axis=0).astype(jnp.float32)
            ycc = jnp.einsum('ij,jhw->ihw', M, img709[:3],
                             preferred_element_type=jnp.float32,
                             precision='highest')
            y = ycc[0] * jnp.float32(219.0) + jnp.float32(16.0)

            def trunc(v):
                return jnp.trunc(jnp.clip(jnp.nan_to_num(v, nan=0.0),
                                          0.0, 255.0)).astype(jnp.uint8)

            ym = row_mask[:, None] * col_mask[None, :]
            y8 = jnp.where(ym > 0, trunc(y), 0)
            cbcr = ycc[1:3] * col_mask[None, None, :]
            cb = jnp.einsum('tx,hx->ht', D, cbcr[0],
                            preferred_element_type=jnp.float32,
                            precision='highest')
            cr = jnp.einsum('tx,hx->ht', D, cbcr[1],
                            preferred_element_type=jnp.float32,
                            precision='highest')
            cm = row_mask[:, None] * tx_mask[None, :]
            cb8 = jnp.where(cm > 0,
                            trunc(cb * jnp.float32(224.0)
                                  + jnp.float32(128.0)), 0)
            cr8 = jnp.where(cm > 0,
                            trunc(cr * jnp.float32(224.0)
                                  + jnp.float32(128.0)), 0)
            return jnp.concatenate([y8.reshape(-1), cb8.reshape(-1),
                                    cr8.reshape(-1)])

        _jax_dv_sub = sub
    return _jax_dv_sub


def subsample_dv(data, full_window, current_window):
    """Linear RGBA f16 frame -> DV 4:1:1 planar u8 (video_subsample.c:95-187).

    data: (4, H, W) f16 at *full_window*. Returns (y, cb, cr) u8 planes of
    shapes (480, 720), (480, 180), (480, 180); rows/columns outside the
    frame's current_window are zero (the reference's alloc0 behavior).
    Device-resident input subsamples ON DEVICE (one packed u8 fetch);
    the NumPy path below is the golden.
    """
    ox, oy = DV_PIC_OFFSET
    image_box = box2i(ox, oy, DV_FULL_WIDTH + ox - 1, DV_FULL_HEIGHT + oy - 1)
    window = box2i_intersect(image_box, current_window)

    y8 = np.zeros((DV_FULL_HEIGHT, DV_FULL_WIDTH), np.uint8)
    cb8 = np.zeros((DV_FULL_HEIGHT, DV_FULL_WIDTH // 4), np.uint8)
    cr8 = np.zeros((DV_FULL_HEIGHT, DV_FULL_WIDTH // 4), np.uint8)
    if window.empty():
        return y8, cb8, cr8

    from canvas_tpu.ops import window as window_ops
    if backend.is_jax_array(data) and backend.get_backend() != 'numpy':
        jnp = backend.jnp
        img_d = window_ops.place(data, full_window, image_box, window)
        lut = color_ops._luts.get('linear_to_rec709',
                                  color_ops.linear_to_rec709)
        key = id(lut)
        got = color_ops._device_tables.get(key)
        if got is None or got[0] is not lut:
            got = (lut, jnp.asarray(lut))
            color_ops._device_tables[key] = got
        row_mask = np.zeros(DV_FULL_HEIGHT, np.float32)
        row_mask[window.min.y - oy:window.max.y - oy + 1] = 1.0
        col_mask = np.zeros(DV_FULL_WIDTH, np.float32)
        col_mask[window.min.x - ox:window.max.x - ox + 1] = 1.0
        tx_mask = np.zeros(DV_FULL_WIDTH // 4, np.float32)
        tx_mask[(window.min.x - ox) // 4:(window.max.x - ox) // 4 + 1] = 1.0
        packed = np.asarray(_jax_subsample_dv()(
            img_d, got[1], RGB_TO_YCBCR_REC709, _dv_down_matrix(),
            row_mask, col_mask, tx_mask))
        n_y = DV_FULL_HEIGHT * DV_FULL_WIDTH
        n_c = DV_FULL_HEIGHT * (DV_FULL_WIDTH // 4)
        y8 = packed[:n_y].reshape(DV_FULL_HEIGHT, DV_FULL_WIDTH)
        cb8 = packed[n_y:n_y + n_c].reshape(DV_FULL_HEIGHT,
                                            DV_FULL_WIDTH // 4)
        cr8 = packed[n_y + n_c:].reshape(DV_FULL_HEIGHT,
                                         DV_FULL_WIDTH // 4)
        return y8, cb8, cr8

    # Re-window to image coordinates and compress the transfer curve.
    img = window_ops.place(backend.asnumpy(data), full_window, image_box,
                           window)
    img709 = color_ops.transfer_linear_to_rec709(
        np.asarray(img, dtype=np.float16)).astype(np.float32)

    M = RGB_TO_YCBCR_REC709
    ycc = np.einsum('ij,jhw->ihw', M, img709[:3])
    y = ycc[0] * np.float32(219.0) + np.float32(16.0)
    # Window the luma: C writes only x/rows inside the window
    rows = slice(window.min.y - oy, window.max.y - oy + 1)
    cols = slice(window.min.x - ox, window.max.x - ox + 1)
    y8_full = _to_u8_trunc(y)
    y8[rows, cols] = y8_full[rows, cols]

    # Chroma: gather with the normalized triangle, taps clipped to the
    # window (data outside is zero anyway), outputs restricted to
    # [window.min.x/4, window.max.x/4] (video_subsample.c:158-171).
    D = _dv_down_matrix()
    mask = np.zeros(DV_FULL_WIDTH, dtype=np.float32)
    mask[cols] = 1.0
    cbcr = ycc[1:3] * mask[None, None, :]
    cb_sub = np.einsum('tx,hx->ht', D, cbcr[0])
    cr_sub = np.einsum('tx,hx->ht', D, cbcr[1])
    tx_lo = (window.min.x - ox) // 4
    tx_hi = (window.max.x - ox) // 4
    tx_cols = slice(tx_lo, tx_hi + 1)
    cb8_full = _to_u8_trunc(cb_sub * np.float32(224.0) + np.float32(128.0))
    cr8_full = _to_u8_trunc(cr_sub * np.float32(224.0) + np.float32(128.0))
    cb8[rows, tx_cols] = cb8_full[rows, tx_cols]
    cr8[rows, tx_cols] = cr8_full[rows, tx_cols]
    return y8, cb8, cr8


# --- MPEG-2 4:2:0 subsampling ------------------------------------------------

_jax_mpeg2 = None


def _jax_subsample_mpeg2():
    global _jax_mpeg2
    if _jax_mpeg2 is None:
        jax = backend.jax
        jnp = backend.jnp

        @jax.jit
        def sub(arr, M):
            H, W = arr.shape[1], arr.shape[2]
            from canvas_tpu.ops import color as color_ops
            x = arr[:3].astype(jnp.float32)
            rgb709 = color_ops.linear_to_rec709_xp(x, jnp)
            ycc = jnp.einsum('ij,jhw->ihw', M, rgb709,
                             preferred_element_type=jnp.float32,
                             precision='highest')
            y = ycc[0] * (219.0 / 255.0) + (16.0 / 255.0)
            y8 = jnp.clip(jnp.round(y * 255.0), 0, 255).astype(jnp.uint8)

            cbcr = ycc[1:3]
            cx = jnp.arange(W // 2) * 2
            left = jnp.clip(cx - 1, 0, W - 1)
            right = jnp.clip(cx + 1, 0, W - 1)

            def hpass(rows):
                return (rows[..., left] + 2.0 * rows[..., cx] +
                        rows[..., right]) / 4.0

            cy = jnp.arange(H // 2)
            even = (cy % 2) == 0
            near = jnp.clip(jnp.where(even, 2 * cy, 2 * cy + 1), 0, H - 1)
            far = jnp.clip(jnp.where(even, 2 * cy + 2, 2 * cy - 1), 0, H - 1)
            subv = (3.0 * hpass(cbcr[:, near, :]) +
                    hpass(cbcr[:, far, :])) / 4.0
            subv = subv * (224.0 / 255.0) + (128.0 / 255.0)
            sub8 = jnp.clip(jnp.round(subv * 255.0), 0, 255).astype(jnp.uint8)
            return y8, sub8[0], sub8[1]

        _jax_mpeg2 = sub
    return _jax_mpeg2


def subsample_mpeg2(data, full_window, current_window=None):
    """Linear RGBA -> MPEG-2 4:2:0 interlaced planar u8.

    Port of the reference's GL shader pair (video_subsample.c:213-293):
    luma full-res; chroma half-res in both axes with field-aware vertical
    siting — even chroma rows read luma rows (2cy, 2cy+2) with weights
    (3,6,3)/16 and (1,2,1)/16 horizontally; odd chroma rows read
    (2cy+1, 2cy-1). Edge taps clamp (GL CLAMP_TO_EDGE). Output u8 uses
    round-to-nearest (GL float->unorm readback), unlike the DV path's
    C-cast truncation.

    data: (4, H, W) with H, W even, in linear light; operates on the full
    window like the GL path (which renders the frame's full texture).
    Returns (y, cb, cr) planes: (H, W), (H/2, W/2), (H/2, W/2).
    """
    if backend.is_jax_array(data) or backend.use_jax_for(data.shape):
        jnp = backend.jnp
        y8, cb8, cr8 = _jax_subsample_mpeg2()(
            jnp.asarray(data), jnp.asarray(RGB_TO_YCBCR_REC709))
        return (backend.asnumpy(y8), backend.asnumpy(cb8),
                backend.asnumpy(cr8))

    arr = backend.asnumpy(data)
    H, W = arr.shape[1], arr.shape[2]

    rgb709 = color_ops.linear_to_rec709(arr[:3].astype(np.float32))
    M = RGB_TO_YCBCR_REC709
    ycc = np.einsum('ij,jhw->ihw', M, rgb709)

    y = ycc[0] * np.float32(219.0 / 255.0) + np.float32(16.0 / 255.0)
    y8 = np.clip(np.rint(y * 255.0), 0, 255).astype(np.uint8)

    cbcr = ycc[1:3]
    # Horizontal taps at luma columns 2cx-1, 2cx, 2cx+1 (clamped)
    cx = np.arange(W // 2) * 2
    left = np.clip(cx - 1, 0, W - 1)
    mid = cx
    right = np.clip(cx + 1, 0, W - 1)

    def hpass(rows):
        # rows: (2, n_rows, W) -> (2, n_rows, W/2) with (1,2,1)/4 taps
        return (rows[..., left] + 2.0 * rows[..., mid] + rows[..., right]) / 4.0

    cy = np.arange(H // 2)
    even = (cy % 2) == 0
    near_row = np.where(even, 2 * cy, 2 * cy + 1)
    far_row = np.where(even, 2 * cy + 2, 2 * cy - 1)
    near_row = np.clip(near_row, 0, H - 1)
    far_row = np.clip(far_row, 0, H - 1)

    near = hpass(cbcr[:, near_row, :])
    far = hpass(cbcr[:, far_row, :])
    sub = (3.0 * near + 1.0 * far) / 4.0      # (12/16 near + 4/16 far)
    sub = sub * np.float32(224.0 / 255.0) + np.float32(128.0 / 255.0)
    sub8 = np.clip(np.rint(sub * 255.0), 0, 255).astype(np.uint8)
    return y8, sub8[0], sub8[1]
