"""Direct unit tests of the compositing passes (canvas_tpu/ops/composite.py)
against plain NumPy references; the render fuzz suite covers them end to
end differentially vs the pull path.
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from canvas_tpu.ops import composite  # noqa: E402


def _case(rng, B, H, W, h, w):
    P = jnp.asarray(rng.rand(B, 3, H, W).astype(np.float32))
    A = jnp.asarray(rng.rand(B, 1, H, W).astype(np.float32))
    color = jnp.asarray(rng.rand(B, 4).astype(np.float32))
    ry = jnp.asarray(rng.rand(B, h).astype(np.float32))
    rx = jnp.asarray(rng.rand(B, w).astype(np.float32))
    return P, A, color, ry, rx


def test_region_over_sep_matches_materialized():
    """region_over_sep(color, ry, rx) == region_over on the explicit
    outer-product layer (within f32 reassociation ulps)."""
    rng = np.random.RandomState(11)
    for (B, H, W, h, w, dy, dx) in [(3, 192, 384, 64, 128, 64, 128),
                                    (2, 256, 512, 128, 256, 0, 256),
                                    (1, 128, 256, 128, 256, 0, 0)]:
        P, A, color, ry, rx = _case(rng, B, H, W, h, w)
        dy0 = jnp.int32(dy)
        dx0 = jnp.int32(dx)
        gP, gA = composite.region_over_sep(jnp, jax, P, A, color,
                                            ry, rx, dy0, dx0)
        layer = (color[:, :, None, None] * ry[:, None, :, None]
                 * rx[:, None, None, :])
        rP, rA = composite.region_over(jnp, jax, P, A, layer, dy0, dx0)
        np.testing.assert_allclose(np.asarray(gP), np.asarray(rP),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(gA), np.asarray(rA),
                                   atol=1e-5)
        # outside the region the accumulator is untouched
        mask = np.zeros((H, W), bool)
        mask[dy:dy + h, dx:dx + w] = True
        np.testing.assert_array_equal(np.asarray(gP)[:, :, ~mask],
                                      np.asarray(P)[:, :, ~mask])


def test_region_over_sep_rejects_unaligned():
    rng = np.random.RandomState(1)
    P, A, color, ry, rx = _case(rng, 1, 128, 256, 60, 128)
    with pytest.raises(ValueError):
        composite.region_over_sep(jnp, jax, P, A, color, ry, rx,
                                   jnp.int32(0), jnp.int32(0))


def _solid_layers(rng, L, B, H, W, empty=False):
    color = rng.uniform(0.0, 1.0, size=(L, B, 4)).astype(np.float32)
    gain = rng.uniform(0.5, 1.5, size=(L, B)).astype(np.float32)
    offset = rng.uniform(-0.2, 0.2, size=(L, B)).astype(np.float32)
    box = np.zeros((L, B, 4), np.int32)
    for l in range(L):
        for b in range(B):
            if empty:
                box[l, b] = (5, 4, 5, 4)          # y1 < y0: empty
                continue
            y0 = rng.integers(0, H - 1)
            x0 = rng.integers(0, W - 1)
            box[l, b] = (y0, rng.integers(y0, H), x0, rng.integers(x0, W))
    return color, box, gain, offset


def _fold_golden(P, A, color, box, gain, offset, H, W):
    """Per-pixel NumPy premultiplied fold (the module docstring's
    equations), f32 throughout."""
    L, B = color.shape[:2]
    if P is None:
        P = np.zeros((B, 3, H, W), np.float32)
        A = np.zeros((B, 1, H, W), np.float32)
    P = P.astype(np.float32).copy()
    A = A.astype(np.float32).copy()
    rows = np.arange(H)[:, None]
    cols = np.arange(W)[None, :]
    for l in range(L):
        for b in range(B):
            y0, y1, x0, x1 = box[l, b]
            m = (rows >= y0) & (rows <= y1) & (cols >= x0) & (cols <= x1)
            a = np.where(m, color[l, b, 3], np.float32(0))
            keep = np.float32(1) - a
            for c in range(3):
                pa = ((color[l, b, c] * gain[l, b] + offset[l, b])
                      * color[l, b, 3])
                P[b, c] = np.where(m, pa, np.float32(0)) + P[b, c] * keep
            A[b, 0] = a + A[b, 0] * keep
    return P, A


@pytest.mark.parametrize('case', ['no_base', 'base', 'finalize',
                                  'base_finalize', 'all_empty', 'acc16'])
def test_solid_fold_matches_numpy_golden(case):
    """The fused fold chain against a per-pixel NumPy fold: with and
    without a base, finalized (un-premultiplied rgba), all-empty boxes
    (base passes through), and bf16 accumulators (quality<=9)."""
    rng = np.random.default_rng(hash(case) % 1000)
    L, B, H, W = 3, 2, 40, 72
    color, box, gain, offset = _solid_layers(rng, L, B, H, W,
                                             empty=case == 'all_empty')
    with_base = case in ('base', 'base_finalize', 'all_empty', 'acc16')
    P = A = None
    if with_base:
        P = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
        A = rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32)
    acc = jnp.bfloat16 if case == 'acc16' else None
    finalize = case.endswith('finalize')
    args = [jnp.asarray(v) for v in (color, box, gain, offset)]
    got = composite.solid_fold(
        jnp, jax, None if P is None else jnp.asarray(P).astype(
            acc or jnp.float32),
        None if A is None else jnp.asarray(A).astype(acc or jnp.float32),
        *args, H, W, finalize=finalize, acc_dtype=acc)
    if acc is not None:
        P = np.asarray(jnp.asarray(P).astype(acc), np.float32)
        A = np.asarray(jnp.asarray(A).astype(acc), np.float32)
    wP, wA = _fold_golden(P, A, color, box, gain, offset, H, W)
    if finalize:
        nz = wA != 0
        rgb = np.where(nz, wP / np.where(nz, wA, 1), 0)
        # P / A can reach ~10 where A is small: a few f32 ulps relative
        # (fma contraction differs between XLA backends)
        np.testing.assert_allclose(np.asarray(got),
                                   np.concatenate([rgb, wA], axis=1),
                                   rtol=1e-6, atol=1e-6)
        return
    gP, gA = got
    # bf16 storage rounds to 8 mantissa bits; f32 within fma ulps
    atol = 2 ** -7 if acc is not None else 1e-6
    if acc is not None:
        assert gP.dtype == jnp.bfloat16 and gA.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(gP, np.float32), wP,
                               rtol=0, atol=atol)
    np.testing.assert_allclose(np.asarray(gA, np.float32), wA,
                               rtol=0, atol=atol)
    if case == 'all_empty':
        np.testing.assert_array_equal(np.asarray(gP), P)


def _region_golden(P, A, layer, dy, dx):
    P = P.astype(np.float32).copy()
    A = A.astype(np.float32).copy()
    H, W = P.shape[2:]
    h = min(layer.shape[2], H - dy)
    w = min(layer.shape[3], W - dx)
    la = layer[:, 3:4, :h, :w].astype(np.float32)
    P[:, :, dy:dy + h, dx:dx + w] = (layer[:, :3, :h, :w] * la
                                     + P[:, :, dy:dy + h, dx:dx + w]
                                     * (1 - la))
    A[:, :, dy:dy + h, dx:dx + w] = la + A[:, :, dy:dy + h, dx:dx + w] * (
        1 - la)
    return P, A


@pytest.mark.parametrize('H, W, dy, dx', [(150, 384, 64, 128),
                                          (200, 300, 128, 128),
                                          (256, 512, 0, 0)])
def test_region_over_matches_numpy_golden(H, W, dy, dx):
    """The region pass blends only the region, including a region that
    overhangs the frame's bottom or right edge (clipped, not slid)."""
    rng = np.random.default_rng(H + W + dy)
    B, h, w = 2, 128, 256
    P = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    A = rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32)
    layer = rng.uniform(0, 1, (B, 4, h, w)).astype(np.float32)
    gP, gA = composite.region_over(jnp, jax, jnp.asarray(P), jnp.asarray(A),
                                   jnp.asarray(layer), jnp.int32(dy),
                                   jnp.int32(dx))
    wP, wA = _region_golden(P, A, layer, dy, dx)
    assert gP.shape == P.shape and gA.shape == A.shape
    np.testing.assert_allclose(np.asarray(gP), wP, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gA), wA, rtol=0, atol=1e-6)


def test_region_over_bf16_accumulators():
    """quality<=9 accumulators stay bf16 through the region pass; the
    blend runs f32 and pixels outside the region are untouched."""
    rng = np.random.default_rng(37)
    B, H, W, h, w = 2, 192, 384, 128, 256
    P = jnp.asarray(rng.uniform(0, 1, (B, 3, H, W)), jnp.bfloat16)
    A = jnp.asarray(rng.uniform(0, 1, (B, 1, H, W)), jnp.bfloat16)
    layer = jnp.asarray(rng.uniform(0, 1, (B, 4, h, w)), jnp.bfloat16)
    gP, gA = composite.region_over(jnp, jax, P, A, layer, jnp.int32(64),
                                   jnp.int32(128))
    assert gP.dtype == jnp.bfloat16 and gA.dtype == jnp.bfloat16
    wP, wA = _region_golden(np.asarray(P, np.float32),
                            np.asarray(A, np.float32),
                            np.asarray(layer, np.float32), 64, 128)
    np.testing.assert_allclose(np.asarray(gP, np.float32), wP, atol=2 ** -7)
    np.testing.assert_array_equal(np.asarray(gP)[:, :, :64],
                                  np.asarray(P)[:, :, :64])


def test_region_over_rejects_unaligned():
    P = jnp.zeros((1, 3, 128, 256), jnp.float32)
    A = jnp.zeros((1, 1, 128, 256), jnp.float32)
    layer = jnp.zeros((1, 4, 64, 100), jnp.float32)
    with pytest.raises(ValueError):
        composite.region_over(jnp, jax, P, A, layer, jnp.int32(0),
                              jnp.int32(0))
