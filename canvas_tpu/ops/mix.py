"""Compositing kernels: crossfade and over.

JAX equivalents of the reference's src/cprocess/video_mix.c. The
reference splits each blend into outer/inner window-region loops; because
our frames guarantee zero outside ``current_window``, both blends reduce to
a single branch-free pointwise formula over the whole tile, which XLA
fuses. Window metadata algebra lives in the callers (host side).

Colors are stored with *unassociated* alpha; both kernels weight by alpha
and divide back out, exactly like the reference:

  cross (video_mix.c:108-235):
      alpha_a = a.a * (1 - mix_b); alpha_b = b.a * mix_b
  over  (video_mix.c:238-370):
      alpha_b = b.a * mix_b;       alpha_a = under.a * (1 - b.a * mix_b)
  out.a = alpha_a + alpha_b
  out.rgb = (a.rgb * alpha_a + b.rgb * alpha_b) / out.a   (0 where out.a == 0)

All inputs/outputs are float32 ``(4, H, W)`` planes (the reference's f16
path converts to f32 around the blend, src/cprocess/main.c:33-103).
"""

import numpy as np

from canvas_tpu import backend

__all__ = ['cross', 'over', 'over_stack', 'attenuate']


def _combine_np(rgb_a, alpha_a, rgb_b, alpha_b):
    out_a = alpha_a + alpha_b
    with np.errstate(divide='ignore', invalid='ignore'):
        rgb = (rgb_a * alpha_a + rgb_b * alpha_b) / out_a
    rgb = np.where(out_a != 0.0, rgb, 0.0).astype(np.float32)
    return np.concatenate([rgb, out_a[None]], axis=0)


def cross_np(a, b, mix_b):
    mix_b = min(max(np.float32(mix_b), np.float32(0.0)), np.float32(1.0))
    alpha_a = a[3] * (np.float32(1.0) - mix_b)
    alpha_b = b[3] * mix_b
    return _combine_np(a[:3], alpha_a, b[:3], alpha_b)


def over_np(under, b, mix_b):
    mix_b = min(max(np.float32(mix_b), np.float32(0.0)), np.float32(1.0))
    alpha_b = b[3] * mix_b
    alpha_a = under[3] * (np.float32(1.0) - alpha_b)
    return _combine_np(under[:3], alpha_a, b[:3], alpha_b)


def attenuate_np(a, factor):
    """Multiply alpha by factor (video_copy_frame_alpha_f32)."""
    out = a.copy()
    out[3] *= np.float32(factor)
    return out


def over_stack_np(layers):
    """Composite (L, 4, H, W) bottom-to-top with over at mix 1.0."""
    out = layers[0]
    for i in range(1, layers.shape[0]):
        out = over_np(out, layers[i], 1.0)
    return out


# --- JAX implementations -----------------------------------------------------

_jax_fns = None


def _build_jax():
    global _jax_fns
    if _jax_fns is not None:
        return _jax_fns
    jax = backend.jax
    jnp = backend.jnp

    def combine(rgb_a, alpha_a, rgb_b, alpha_b):
        out_a = alpha_a + alpha_b
        num = rgb_a * alpha_a + rgb_b * alpha_b
        rgb = jnp.where(out_a != 0.0, num / jnp.where(out_a != 0.0, out_a, 1.0), 0.0)
        return jnp.concatenate([rgb, out_a[None]], axis=0)

    @jax.jit
    def cross_j(a, b, mix_b):
        mix_b = jnp.clip(mix_b, 0.0, 1.0).astype(jnp.float32)
        return combine(a[:3], a[3] * (1.0 - mix_b), b[:3], b[3] * mix_b)

    @jax.jit
    def over_j(under, b, mix_b):
        mix_b = jnp.clip(mix_b, 0.0, 1.0).astype(jnp.float32)
        alpha_b = b[3] * mix_b
        alpha_a = under[3] * (1.0 - alpha_b)
        return combine(under[:3], alpha_a, b[:3], alpha_b)

    @jax.jit
    def attenuate_j(a, factor):
        return a.at[3].multiply(jnp.float32(factor))

    @jax.jit
    def over_stack_j(layers):
        def body(acc, layer):
            alpha_b = layer[3]
            alpha_a = acc[3] * (1.0 - alpha_b)
            return combine(acc[:3], alpha_a, layer[:3], alpha_b), None

        out, _ = jax.lax.scan(body, layers[0], layers[1:])
        return out

    _jax_fns = dict(cross=cross_j, over=over_j, attenuate=attenuate_j,
                    over_stack=over_stack_j)
    return _jax_fns


# --- dispatch ----------------------------------------------------------------

def _any_jax(*arrs):
    return any(backend.is_jax_array(a) for a in arrs)


def _dispatch2(name, np_fn, a, b, scalar):
    if _any_jax(a, b) or backend.use_jax_for(a.shape):
        fns = _build_jax()
        jnp = backend.jnp
        return fns[name](jnp.asarray(a), jnp.asarray(b), jnp.float32(scalar))
    return np_fn(np.asarray(a), np.asarray(b), scalar)


def cross(a, b, mix_b):
    return _dispatch2('cross', cross_np, a, b, mix_b)


def over(under, b, mix_b):
    return _dispatch2('over', over_np, under, b, mix_b)


def attenuate(a, factor):
    if _any_jax(a) or backend.use_jax_for(a.shape):
        return _build_jax()['attenuate'](backend.jnp.asarray(a),
                                         np.float32(factor))
    return attenuate_np(np.asarray(a), factor)


def over_stack(layers):
    """layers: (L, 4, H, W); composite bottom-to-top at mix 1.0."""
    if layers.shape[0] == 1:
        return layers[0]
    if _any_jax(layers) or backend.use_jax_for(layers.shape):
        return _build_jax()['over_stack'](backend.jnp.asarray(layers))
    return over_stack_np(np.asarray(layers))
