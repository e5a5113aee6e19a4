"""Transfer-function and color-matrix kernels vs reference semantics
(/root/reference/src/cprocess/gammatab.c, color.c)."""

import numpy as np
import pytest

from canvas_tpu import backend
from canvas_tpu.ops import color


def _halves():
    # All finite f16 bit patterns (skip NaN/Inf for formula comparisons)
    bits = np.arange(65536, dtype=np.uint16)
    vals = bits.view(np.float16)
    return vals[np.isfinite(vals)]


def test_scalar_formulas():
    # Known fixed points of the Rec.709 curve
    assert color.rec709_to_linear_scene(np.float32(0.0)) == 0.0
    assert color.linear_to_rec709(np.float32(0.0)) == 0.0
    assert abs(color.linear_to_rec709(np.float32(1.0)) - 1.0) < 1e-6
    assert abs(color.rec709_to_linear_scene(np.float32(1.0)) - 1.0) < 1e-6
    # Round trip through the linear segment
    x = np.float32(0.05)
    rt = color.rec709_to_linear_scene(color.linear_to_rec709(x))
    assert abs(float(rt) - 0.05) < 1e-6
    # Display intent: pure 2.5 power, negatives clamp to 0
    assert color.rec709_to_linear_display(np.float32(-0.5)) == 0.0
    assert abs(color.rec709_to_linear_display(np.float32(0.5)) -
               0.5 ** 2.5) < 1e-7
    # sRGB transition point continuity
    t = np.float32(0.0031308)
    lo = color.linear_to_srgb(t)
    assert abs(float(lo) - 12.92 * 0.0031308) < 1e-6


def test_half_lut_matches_formula_f16():
    """f16 path must agree with building the table by hand: f16 in ->
    f32 -> formula -> TRUNCATING f16 conversion (the C table
    construction; half_convert_from_float rounds toward zero —
    genhalf.py:27-56). The formula itself may differ from libm powf by
    the last f32 ulp on isolated inputs, so allow <=1 f16 bit."""
    h = _halves().astype(np.float16)
    with np.errstate(over='ignore', invalid='ignore'):
        expected = color.float_to_half_trunc(
            color.linear_to_rec709(h.astype(np.float32)))
    got = color.transfer_linear_to_rec709(h)
    assert got.dtype == np.float16
    gb = got.view(np.uint16).astype(np.int32)
    eb = expected.view(np.uint16).astype(np.int32)
    nan = np.isnan(got) & np.isnan(expected)
    diff = np.abs(gb - eb)[~nan]
    assert diff.max() <= 1
    # np.power vs libm powf flips at most a handful of entries
    assert (diff != 0).sum() <= 8


def test_half_lut_jax_matches_numpy():
    jnp = backend.jnp
    h = _halves().astype(np.float16)[:4096]
    want = color.transfer_rec709_to_linear_scene(h)
    got = np.asarray(color.transfer_rec709_to_linear_scene(jnp.asarray(h)))
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_gamma45_ramp():
    ramp = color.gamma45_ramp_u8()
    assert ramp.shape == (65536,)
    assert ramp.dtype == np.uint8
    # 0 -> 0, 1.0 -> 255
    one = np.float16(1.0)
    assert ramp[one.view(np.uint16)] == 255
    assert ramp[np.float16(0.0).view(np.uint16)] == 0
    # mid value matches the formula with C truncation
    x = np.float16(0.25)
    want = int(min(max((float(np.float32(x)) ** 0.45) * 255.0, 0.0), 255.0))
    assert ramp[x.view(np.uint16)] == want
    # apply helper
    arr = np.asarray([0.0, 0.25, 1.0, 2.0], dtype=np.float16)
    out = color.apply_gamma45_u8(arr)
    assert out[3] == 255  # clamped


def test_color_matrix_passes_alpha():
    data = np.random.RandomState(0).rand(4, 8, 8).astype(np.float32)
    out = color.color_matrix(data, color.RGB_TO_XYZ_SDTV)
    np.testing.assert_array_equal(out[3], data[3])
    # spot-check one pixel against the reference's mult_mat_xyz
    r, g, b = data[0, 2, 3], data[1, 2, 3], data[2, 2, 3]
    m = color.RGB_TO_XYZ_SDTV
    want_x = r * m[0, 0] + g * m[0, 1] + b * m[0, 2]
    assert abs(out[0, 2, 3] - want_x) < 1e-5


def test_rgb_to_xyz_sdtv_composition():
    """rgb_to_xyz = scene transfer (all 4 channels) then matrix
    (color.c:104-142): verify the composition by hand."""
    data = np.random.RandomState(3).rand(4, 2, 2).astype(np.float16)
    out = color.rgb_to_xyz_sdtv_frame(data)
    lin = color.transfer_rec709_to_linear_scene(data)
    want = color.color_matrix(lin, color.RGB_TO_XYZ_SDTV)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want))
    # white maps to the matrix row sums (the D65-ish whitepoint)
    white = np.ones((4, 1, 1), dtype=np.float16)
    w = color.rgb_to_xyz_sdtv_frame(white)
    np.testing.assert_allclose(
        np.asarray(w[:3, 0, 0], dtype=np.float64),
        color.RGB_TO_XYZ_SDTV.sum(axis=1), atol=2e-3)


def test_color_matrix_jax_matches_numpy():
    jnp = backend.jnp
    data = np.random.RandomState(1).rand(4, 16, 16).astype(np.float16)
    want = color.xyz_to_srgb_frame(data)
    got = np.asarray(color.xyz_to_srgb_frame(jnp.asarray(data)))
    # Matrix math runs in f32 then rounds to f16 before the LUT; XLA's
    # f32 accumulation order can flip an f16 bit, and the sRGB curve's
    # 12.92x segment amplifies that on out-of-gamut values — allow a few
    # f16 ulps.
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=2e-2, atol=2e-3)


def test_transfer_preserves_zero():
    """Zero-outside-window invariant: all curves map 0 -> 0."""
    z = np.zeros(4, dtype=np.float16)
    for fn in (color.transfer_rec709_to_linear_scene,
               color.transfer_rec709_to_linear_display,
               color.transfer_linear_to_rec709,
               color.transfer_linear_to_srgb):
        np.testing.assert_array_equal(np.asarray(fn(z)), z)


def test_transfer_filter_source():
    from canvas_tpu.basetypes import box2i
    from canvas_tpu.sources import (SolidColorVideoSource,
                                    VideoColorTransferFilter)
    src = SolidColorVideoSource((0.25, 0.5, 1.0, 1.0),
                                window=box2i(0, 0, 3, 3))
    filt = VideoColorTransferFilter(src, 'linear_to_rec709')
    frame = filt.get_frame_f16(0, box2i(0, 0, 7, 7))
    assert frame.current_window == box2i(0, 0, 3, 3)
    px = frame.pixel(0, 0)
    want = color.transfer_linear_to_rec709(
        np.full((1,), 0.25, np.float16))[0]
    assert abs(px.r - float(want)) < 1e-6
    # outside the window: undefined pixel -> None
    assert frame.pixel(5, 5) is None


def test_quantize_f16_matches_cast_pair():
    """ops.color.quantize_f16 must equal the f32->f16->f32 cast pair
    elementwise — including f16 subnormals (reduce_precision alone
    flushes them), negatives, overflow-to-inf, and nan — both eagerly
    and under jit (an XLA backend may FOLD the plain cast pair away
    inside fused programs; the helper is the fold-proof replacement)."""
    from canvas_tpu import backend

    rng = np.random.RandomState(11)
    vals = np.concatenate([
        np.array([0.0, -0.0, 1e-8, -1e-8, 5.96e-8, 6.0e-5, 6.2e-5,
                  2.0 ** -24, 2.0 ** -25, 65504.0, 65520.0, 70000.0,
                  -70000.0, np.inf, -np.inf, np.nan], np.float32),
        np.linspace(-2, 2, 20001, dtype=np.float32),
        (rng.rand(20000).astype(np.float32) * 2.0 ** -14),
        rng.randn(20000).astype(np.float32) * 100.0,
    ])
    want = vals.astype(np.float16).astype(np.float32)
    with backend.force_backend('jax'):
        jnp, jax = backend.jnp, backend.jax
        d = jnp.asarray(vals)
        for got in (np.asarray(color.quantize_f16(d)),
                    np.asarray(jax.jit(color.quantize_f16)(d))):
            both_nan = np.isnan(want) & np.isnan(got)
            assert np.array_equal(want[~both_nan], got[~both_nan])
    # numpy arrays take the plain-cast path
    got_np = color.quantize_f16(vals)
    both_nan = np.isnan(want) & np.isnan(got_np)
    assert np.array_equal(want[~both_nan], got_np[~both_nan])


def test_transfer_f32_jax_matches_formula(jax_backend):
    """f32 JAX inputs take the direct-formula branch (_jax_transfer_fns,
    the non-parity fast path); results match the NumPy formulas."""
    jnp = backend.jnp
    x = np.linspace(-0.2, 1.2, 257, dtype=np.float32)
    for jax_fn, np_fn in [
            (color.transfer_rec709_to_linear_scene,
             color.rec709_to_linear_scene),
            (color.transfer_rec709_to_linear_display,
             color.rec709_to_linear_display),
            (color.transfer_linear_to_rec709, color.linear_to_rec709),
            (color.transfer_linear_to_srgb, color.linear_to_srgb)]:
        got = np.asarray(jax_fn(jnp.asarray(x)))
        want = np_fn(x.copy())
        # 5e-5: the direct-formula branch is the NON-parity fast path;
        # device pow/exp round differently from host libm (by ~1e-6),
        # while a wrong coefficient diverges at 1e-2+
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-5,
                                   err_msg=np_fn.__name__)


def test_transfer_f16_jax_stays_on_lut(jax_backend):
    """f16 inputs keep the 64K-LUT bit-exact contract on the JAX eager
    path too (CLAUDE.md invariant; gammatab.c parity)."""
    jnp = backend.jnp
    x = np.linspace(0.0, 1.0, 4096, dtype=np.float16)
    got = np.asarray(color.transfer_linear_to_rec709(jnp.asarray(x)))
    want = np.asarray(color.transfer_linear_to_rec709(x))
    assert got.dtype == np.float16 and want.dtype == np.float16
    np.testing.assert_array_equal(got.view(np.uint16),
                                  want.view(np.uint16))
