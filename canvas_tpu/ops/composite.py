"""Compositing passes of the batched render planner.

``solid_fold`` composites a run of solid-color layers (with optional
gain/offset) bottom-to-top. It is a POINTWISE function of a handful of
per-layer scalars, written as one elementwise chain that XLA fuses into
a single pass over the output; no per-layer tensor materializes.

Semantics match render._eval's 'solid' + 'gain_offset' + 'over_stack'
chain (itself the batched form of video_mix.c's over compositing +
VideoGainOffsetFilter):

  mask_l = box_l contains (row, col)          [rel coords, inclusive]
  rgb_l  = (color_l.rgb * gain_l + offset_l) * mask_l
  a_l    = color_l.a * mask_l
  P      = rgb_l * a_l + P * (1 - a_l)        [premultiplied fold]
  A      = a_l   +       A * (1 - a_l)
  out    = [P / A (where A != 0), A]

``region_over`` / ``region_over_sep`` composite a damage-region layer
over the premultiplied accumulator at a block-aligned offset as
dynamic_slice -> over -> dynamic_update_slice, which XLA fuses with
the passes around it.
"""

__all__ = ['solid_stack', 'solid_fold', 'region_over',
           'region_over_sep', 'REGION_BLOCK']

#: Placed regions are quantized to this (rows, cols) block grid
#: (sources.py region quantization); region sizes and offsets are
#: multiples of it.
REGION_BLOCK = (64, 128)


def _fold_jnp(jnp, jax, P, A, color, box, gain, offset, H, W):
    """Premultiplied fold of L solid layers over base (P, A), as ONE
    fusable XLA elementwise chain: per-channel unstacked accumulators,
    per-layer scalar math ((c*g+o)*a) broadcast into selects.
    """
    L = color.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.int32, (1, H, 1), 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, 1, W), 2)
    if P is None:
        zero = jnp.zeros((1, H, W), jnp.float32)
        Pc = [zero, zero, zero]
        Ac = zero
    else:
        # base may be 16-bit accumulators (quality<=9); fold math is f32
        Pc = [P[:, c].astype(jnp.float32) for c in range(3)]
        Ac = A[:, 0].astype(jnp.float32)
    for l in range(L):
        b = box[l]                                       # (B, 4) i32
        m = ((rows >= b[:, 0, None, None]) &
             (rows <= b[:, 1, None, None]) &
             (cols >= b[:, 2, None, None]) &
             (cols <= b[:, 3, None, None]))              # (B, H, W)
        a = jnp.where(m, color[l][:, 3, None, None], 0.0)
        keep = 1.0 - a
        for c in range(3):
            pa = (color[l][:, c] * gain[l] + offset[l]) * color[l][:, 3]
            Pc[c] = jnp.where(m, pa[:, None, None], 0.0) + Pc[c] * keep
        Ac = a + Ac * keep
    return Pc, Ac


def solid_fold(jnp, jax, P, A, color, box, gain, offset, H, W,
               finalize=False, out_dtype=None, acc_dtype=None):
    """Fold L solid(+gain) layers over premultiplied base (P, A).

    color/box (L, B, 4), gain/offset (L, B); box is int32
    [y0, y1, x0, x1] inclusive, relative to the output window (empty
    boxes encode y1 < y0). P (B, 3, H, W) / A (B, 1, H, W) may be None
    for an empty base. Returns the updated (P, A) — or, with
    finalize=True, the un-premultiplied (B, 4, H, W) rgba, so the
    divide fuses into the same pass.

    acc_dtype (non-finalize only) sets the STORED dtype of the returned
    accumulators; the fold math always runs f32. The quality<=9 path
    stores bf16, halving accumulator traffic between composite passes.
    """
    B = color.shape[1]
    if acc_dtype is None:
        acc_dtype = jnp.float32
    Pc, Ac = _fold_jnp(jnp, jax, P, A, color, box, gain, offset, H, W)
    if not finalize:
        Ps = jnp.stack(Pc, axis=1).astype(acc_dtype)
        As = Ac[:, None].astype(acc_dtype)
        if Ps.shape[0] != B:         # degenerate all-empty fold
            Ps = jnp.broadcast_to(Ps, (B, 3, H, W))
            As = jnp.broadcast_to(As, (B, 1, H, W))
        return Ps, As
    nonzero = Ac != 0.0
    safe = jnp.where(nonzero, Ac, 1.0)
    rgb = [jnp.where(nonzero, Pc[c] / safe, 0.0) for c in range(3)]
    out = jnp.stack(rgb + [Ac], axis=1)
    if out.shape[0] != B:
        out = jnp.broadcast_to(out, (B, 4, H, W))
    return out.astype(out_dtype) if out_dtype is not None else out


def solid_stack(jnp, jax, color, box, gain, offset, H, W):
    """Standalone composite of L solid(+gain) layers -> (B, 4, H, W)."""
    return solid_fold(jnp, jax, None, None, color, box, gain, offset,
                      H, W, finalize=True)


def _check_region(name, h, w):
    # Offsets are dynamic params, asserted at the host planning site
    # (sources.py region quantization); the static size is checked here.
    if h % REGION_BLOCK[0] or w % REGION_BLOCK[1]:
        raise ValueError(
            '%s region (%d, %d) must be a multiple of the %r block grid'
            % (name, h, w, REGION_BLOCK))


def _blend(jnp, jax, P, A, rgb, la, dy0, dx0):
    """Region blend as dynamic_slice -> over -> dynamic_update_slice.

    The region box may overhang the frame's bottom/right edge
    (quantization rounds sizes up within the frame's block-aligned
    envelope). dynamic_slice/update CLAMP out-of-range starts, which
    would silently SLIDE the box, so the accumulator is padded to the
    envelope first and sliced back."""
    B, _c, h, w = la.shape
    H, W = P.shape[2], P.shape[3]
    Hp = -(-H // REGION_BLOCK[0]) * REGION_BLOCK[0]
    Wp = -(-W // REGION_BLOCK[1]) * REGION_BLOCK[1]
    pad = ((0, 0), (0, 0), (0, Hp - H), (0, Wp - W))
    if Hp != H or Wp != W:
        P = jnp.pad(P, pad)
        A = jnp.pad(A, pad)
    zero = jnp.int32(0)
    subP = jax.lax.dynamic_slice(P, (zero, zero, dy0, dx0),
                                 (B, 3, h, w)).astype(jnp.float32)
    subA = jax.lax.dynamic_slice(A, (zero, zero, dy0, dx0),
                                 (B, 1, h, w)).astype(jnp.float32)
    nP = (rgb * la + subP * (1.0 - la)).astype(P.dtype)
    nA = (la + subA * (1.0 - la)).astype(A.dtype)
    P = jax.lax.dynamic_update_slice(P, nP, (zero, zero, dy0, dx0))
    A = jax.lax.dynamic_update_slice(A, nA, (zero, zero, dy0, dx0))
    if Hp != H or Wp != W:
        P = P[:, :, :H, :W]
        A = A[:, :, :H, :W]
    return P, A


def region_over(jnp, jax, P, A, layer, dy0, dx0):
    """Composite a damage-region *layer* (B, 4, h, w) over the
    premultiplied accumulator (P, A) at block-aligned offsets
    (dy0 % 64 == 0, dx0 % 128 == 0; int32 scalars). Blend math runs
    f32; the accumulators keep their dtype (f32, or bf16 at
    quality<=9)."""
    _check_region('region_over', layer.shape[2], layer.shape[3])
    return _blend(jnp, jax, P, A, layer[:, :3].astype(jnp.float32),
                  layer[:, 3:4].astype(jnp.float32), dy0, dx0)


def region_over_sep(jnp, jax, P, A, color, ry, rx, dy0, dx0):
    """Composite a RANK-1 damage-region layer (a factored scaled solid:
    value[c, y, x] = color[c] * ry[y] * rx[x]) over the premultiplied
    accumulator (P, A) at block-aligned offsets. The outer product is
    written inside the blend, so XLA fuses it there and the
    (B, 4, h, w) layer never materializes.

    color (B, 4) f32; ry (B, h), rx (B, w) f32 with h % 64 == 0 and
    w % 128 == 0 (the placed-region quantization); dy0/dx0 int32
    scalars, block-aligned like region_over.
    """
    _check_region('region_over_sep', ry.shape[1], rx.shape[1])
    layer = (color[:, :, None, None] * ry[:, None, :, None]
             * rx[:, None, None, :])
    return _blend(jnp, jax, P, A, layer[:, :3], layer[:, 3:4], dy0, dx0)
