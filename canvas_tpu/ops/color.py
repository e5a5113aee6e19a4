"""Color science: transfer functions, color matrices, half-LUT machinery.

JAX equivalent of the reference's src/cprocess/gammatab.c,
color.c, and half.c. The reference applies every transfer curve as a
65536-entry LUT indexed by the raw f16 bit pattern (half_lookup,
half.c:98-107); we reproduce exactly that — bit-exact f16 parity — by
building the same tables host-side with NumPy and applying them with a
gather:

* NumPy path: ``table[x.view(uint16)]``.
* JAX path: ``jnp.take(table, bitcast(x, uint16))`` — a 64K f16 table is
  128 KB; XLA fuses the gather and the bitcast into the surrounding
  pass.

For float32 data there is no LUT in the reference (the f32 pipeline works
in linear light already); we expose the direct formulas for completeness.

Transfer curves (gammatab.c:38-250):
  rec709_to_linear (scene):   x < 4.5*0.018 ? x/4.5 : ((x+0.099)/1.099)^(1/0.45)
  rec709_to_linear (display): x < 0 ? 0 : x^2.5
  linear_to_rec709:           x < 0.018 ? 4.5x : 1.099*x^0.45 - 0.099
  linear_to_srgb:             x <= 0.0031308 ? 12.92x : 1.055*x^(1/2.4) - 0.055
  gamma45 ramp (u8):          clamp(x^0.45 * 255, 0, 255)  (gammatab.c:8-10)

Color matrices (color.c:104-165) operate on rgb, pass alpha through:
  rgb_to_xyz_sdtv: SMPTE-C primaries / D65 (applied after rec709->linear
                   scene transfer of ALL FOUR channels, color.c:131-133)
  xyz_to_srgb:     Wikipedia XYZ->sRGB (followed by linear->sRGB transfer
                   of all four channels, color.c:160-162)
"""

import numpy as np

from canvas_tpu import backend

__all__ = [
    'rec709_to_linear_scene', 'rec709_to_linear_display',
    'linear_to_rec709', 'linear_to_srgb',
    'transfer_rec709_to_linear_scene', 'transfer_rec709_to_linear_display',
    'transfer_linear_to_rec709', 'transfer_linear_to_srgb',
    'gamma45_ramp_u8', 'apply_gamma45_u8',
    'RGB_TO_XYZ_SDTV', 'XYZ_TO_SRGB',
    'color_matrix', 'rgb_to_xyz_sdtv_frame', 'xyz_to_srgb_frame',
    'build_half_lut', 'apply_half_lut', 'float_to_half_trunc', 'get_lut',
]


def float_to_half_trunc(f):
    """The reference's f32 -> f16 conversion, which TRUNCATES the mantissa.

    half_convert_from_float applies the van der Zijp base/shift tables
    (half.c:36-48 via genhalf.py:27-56):
    ``h = base[bits>>23] + ((bits & 0x7fffff) >> shift[bits>>23])`` —
    round-toward-zero, not round-to-nearest. Every transfer LUT and every
    f32->f16 frame conversion in the C engine uses it, so matching its
    rounding is what makes our tables bit-identical to the reference
    binary's (verified exhaustively in tests/test_cref_parity.py).

    Reproduced here as arithmetic on the bit patterns (vectorized) rather
    than the 512-entry tables. NaN payloads confined to the low 13
    mantissa bits collapse to infinity — the reference's own artifact,
    preserved.
    """
    bits = np.asarray(f, np.float32).view(np.uint32)
    sign = ((bits >> np.uint32(16)) & np.uint32(0x8000)).astype(np.uint32)
    e = ((bits >> np.uint32(23)) & np.uint32(0xff)).astype(np.int32) - 127
    m = (bits & np.uint32(0x007fffff)).astype(np.uint32)

    base = np.zeros_like(bits)
    shift = np.full(bits.shape, 24, np.uint32)

    sub = (e >= -24) & (e < -14)      # half-subnormal range
    sub_amt = np.clip(-14 - e, 0, 31).astype(np.uint32)
    base = np.where(sub, np.uint32(0x0400) >> sub_amt, base)
    shift = np.where(sub, np.clip(-e - 1, 0, 31).astype(np.uint32), shift)

    norm = (e >= -14) & (e <= 15)     # normal range
    base = np.where(norm, (np.clip(e + 15, 0, 31).astype(np.uint32)
                           << np.uint32(10)), base)
    shift = np.where(norm, np.uint32(13), shift)

    big = (e > 15) & (e < 128)        # overflow -> inf
    base = np.where(big, np.uint32(0x7c00), base)
    shift = np.where(big, np.uint32(24), shift)

    infnan = (e == 128)               # inf/NaN keep (shifted) payload
    base = np.where(infnan, np.uint32(0x7c00), base)
    shift = np.where(infnan, np.uint32(13), shift)

    h = (sign | base) + (m >> shift)
    return h.astype(np.uint16).view(np.float16).reshape(np.shape(f))


# libm's powf for LUT construction: the reference builds its tables at
# runtime with powf (gammatab.c), and numpy's float32 power differs from
# glibc powf in the last f32 ulp on a handful of the 65536 inputs — just
# enough to flip one truncated f16 table entry. Table builds are one-time
# and cached, so the per-element ctypes call cost is irrelevant.
_powf = None


def _libm_powf():
    global _powf
    if _powf is None:
        try:
            import ctypes
            import ctypes.util
            libm = ctypes.CDLL(ctypes.util.find_library('m') or 'libm.so.6')
            cf = libm.powf
            cf.restype = ctypes.c_float
            cf.argtypes = [ctypes.c_float, ctypes.c_float]

            def powf_elementwise(x, p):
                x = np.asarray(x, np.float32)
                out = np.empty_like(x)
                flat_in = x.ravel()
                flat_out = out.ravel()
                for i in range(flat_in.size):
                    flat_out[i] = cf(float(flat_in[i]), p)
                return out

            _powf = powf_elementwise
        except Exception:  # pragma: no cover - no libm: keep np.power
            _powf = lambda x, p: np.power(  # noqa: E731
                np.asarray(x, np.float32), np.float32(p))
    return _powf


def _exact_lut_fns():
    """Transfer formulas evaluated with libm powf, for table construction
    only (the fast array paths keep np.power/jnp.power)."""
    powf = _libm_powf()

    def scene(x):
        x = np.asarray(x, np.float32)
        with np.errstate(all='ignore'):
            hi = powf((x + np.float32(0.099)) / np.float32(1.099),
                      1.0 / 0.45)
        return np.where(x < np.float32(4.5) * np.float32(0.018),
                        x / np.float32(4.5), hi).astype(np.float32)

    def display(x):
        x = np.asarray(x, np.float32)
        with np.errstate(all='ignore'):
            hi = powf(x, 2.5)
        return np.where(x < 0.0, np.float32(0.0), hi).astype(np.float32)

    def to709(x):
        x = np.asarray(x, np.float32)
        with np.errstate(all='ignore'):
            hi = (np.float32(1.099) * powf(x, 0.45) - np.float32(0.099))
        return np.where(x < np.float32(0.018),
                        x * np.float32(4.5), hi).astype(np.float32)

    def tosrgb(x):
        x = np.asarray(x, np.float32)
        a = np.float32(0.055)
        with np.errstate(all='ignore'):
            hi = (np.float32(1.0) + a) * powf(x, 1.0 / 2.4) - a
        return np.where(x <= np.float32(0.0031308),
                        x * np.float32(12.92), hi).astype(np.float32)

    return {
        'rec709_to_linear_scene': scene,
        'rec709_to_linear_display': display,
        'linear_to_rec709': to709,
        'linear_to_srgb': tosrgb,
    }


# --- scalar transfer formulas (f32 in, f32 out) ------------------------------

def rec709_to_linear_scene(x):
    x = np.asarray(x, dtype=np.float32)
    transition = np.float32(4.5) * np.float32(0.018)
    with np.errstate(invalid='ignore', divide='ignore', over='ignore'):
        lo = x / np.float32(4.5)
        hi = np.power((x + np.float32(0.099)) / np.float32(1.099),
                      np.float32(1.0) / np.float32(0.45))
    return np.where(x < transition, lo, hi).astype(np.float32)


def rec709_to_linear_display(x):
    x = np.asarray(x, dtype=np.float32)
    with np.errstate(invalid='ignore'):
        hi = np.power(x, np.float32(2.5))
    return np.where(x < 0.0, np.float32(0.0), hi).astype(np.float32)


def linear_to_rec709(x):
    x = np.asarray(x, dtype=np.float32)
    with np.errstate(invalid='ignore'):
        hi = np.float32(1.099) * np.power(x, np.float32(0.45)) - np.float32(0.099)
    return np.where(x < np.float32(0.018),
                    x * np.float32(4.5), hi).astype(np.float32)


def linear_to_rec709_xp(x, xp):
    """linear -> Rec.709 OETF over an explicit array namespace (np or
    jnp) — the ONE traced/golden-shared definition of the curve
    constants (gammatab.c:88-106) for paths that inline the formula
    (chroma subsample); the f32-cast NumPy golden above keeps its
    errstate guards."""
    return xp.where(x < 0.018, x * 4.5,
                    1.099 * xp.power(x, 0.45) - 0.099)


def linear_to_srgb(x):
    x = np.asarray(x, dtype=np.float32)
    a = np.float32(0.055)
    with np.errstate(invalid='ignore'):
        hi = (np.float32(1.0) + a) * np.power(x, np.float32(1.0 / 2.4)) - a
    return np.where(x <= np.float32(0.0031308),
                    x * np.float32(12.92), hi).astype(np.float32)


def _gamma45_u8_of_f32(x):
    """clamp(x**0.45 * 255, 0, 255) truncated to u8 (gammatab.c:8-10).

    NaN (from pow of negative input) maps to 0 like the C clamp+cast does
    on our targets.
    """
    with np.errstate(invalid='ignore'):
        y = np.power(x.astype(np.float32), np.float32(0.45)) * np.float32(255.0)
    y = np.clip(y, 0.0, 255.0)
    return np.nan_to_num(y, nan=0.0).astype(np.uint8)


# --- half-LUT machinery (half.c / gammatab.c table pattern) ------------------

_ALL_HALF_BITS = None


def _all_half_values():
    """float32 value of every one of the 65536 f16 bit patterns."""
    global _ALL_HALF_BITS
    if _ALL_HALF_BITS is None:
        _ALL_HALF_BITS = np.arange(65536, dtype=np.uint16).view(
            np.float16).astype(np.float32)
    return _ALL_HALF_BITS


def build_half_lut(fn, out_dtype=np.float16):
    """65536-entry table: out[bits] = out_dtype(fn(float(half_from_bits))).

    Exactly the table-construction loop the reference uses for every
    transfer curve (gammatab.c:85-105 etc.) — including its f32->f16
    conversion, which TRUNCATES (float_to_half_trunc), so f16 tables come
    out bit-identical to the reference binary's. Inf/NaN half inputs flow
    through the same arithmetic as the C tables; their conversions are
    intentionally unchecked."""
    with np.errstate(invalid='ignore', over='ignore', divide='ignore'):
        out = np.asarray(fn(_all_half_values()))
        if np.dtype(out_dtype) == np.float16:
            return float_to_half_trunc(out.astype(np.float32))
        return out.astype(out_dtype)


_device_tables = {}


def apply_half_lut(arr, table):
    """Gather table[bits(x)] over an f16 array (half_lookup, half.c:98-107).

    NumPy or JAX depending on input type; result dtype = table dtype.
    """
    if backend.is_jax_array(arr):
        jax = backend.jax
        jnp = backend.jnp
        # device-resident table cache: re-uploading the 64K LUT per
        # call would cost a 128 KB H2D on every eager device-path
        # transfer application
        key = id(table)
        got = _device_tables.get(key)
        if got is None or got[0] is not table:
            got = (table, jnp.asarray(table))
            _device_tables[key] = got
        bits = jax.lax.bitcast_convert_type(
            arr.astype(jnp.float16), jnp.uint16).astype(jnp.int32)
        return jnp.take(got[1], bits, axis=0)
    arr = np.asarray(arr, dtype=np.float16)
    return table[arr.view(np.uint16)]


class _LutCache:
    """Lazily-built named transfer LUTs (the reference's g_once statics).

    The four named transfer curves build from the libm-powf exact
    formulas (_exact_lut_fns) so the resulting tables match the
    reference binary's bit-for-bit; ad-hoc tables use the fn given."""

    def __init__(self):
        self._tables = {}

    def get(self, name, fn, out_dtype=np.float16):
        key = (name, np.dtype(out_dtype).name)
        table = self._tables.get(key)
        if table is None:
            exact = _exact_lut_fns().get(name)
            table = build_half_lut(exact if exact is not None else fn,
                                   out_dtype)
            self._tables[key] = table
        return table


_luts = _LutCache()


def get_lut(name, out_dtype=np.float16):
    """Named transfer LUT from the shared cache (bit-identical to the
    reference binary's tables for the four gammatab curves)."""
    fns = {
        'rec709_to_linear_scene': rec709_to_linear_scene,
        'rec709_to_linear_display': rec709_to_linear_display,
        'linear_to_rec709': linear_to_rec709,
        'linear_to_srgb': linear_to_srgb,
        'gamma45_u8': _gamma45_u8_of_f32,
    }
    return _luts.get(name, fns[name],
                     np.uint8 if name.endswith('_u8') else out_dtype)


def _transfer(arr, name, fn):
    """Apply a named transfer curve with reference-exact semantics.

    f16 input -> f16 LUT gather (bit-exact vs the C tables).
    f32 input -> direct formula (float32 math).
    """
    dtype = np.dtype(getattr(arr, 'dtype', np.float32))
    if dtype == np.float16:
        return apply_half_lut(arr, _luts.get(name, fn))
    if backend.is_jax_array(arr):
        return _jax_transfer_fns()[name](arr)
    return fn(np.asarray(arr, dtype=np.float32))


_jax_fns = None


def _jax_transfer_fns():
    """Direct-formula f32 JAX versions (used on the non-parity fast path)."""
    global _jax_fns
    if _jax_fns is not None:
        return _jax_fns
    jnp = backend.jnp

    def scene(x):
        return jnp.where(x < 4.5 * 0.018, x / 4.5,
                         jnp.power((x + 0.099) / 1.099, 1.0 / 0.45))

    def display(x):
        return jnp.where(x < 0.0, 0.0, jnp.power(x, 2.5))

    def to709(x):
        return jnp.where(x < 0.018, x * 4.5,
                         1.099 * jnp.power(x, 0.45) - 0.099)

    def tosrgb(x):
        return jnp.where(x <= 0.0031308, x * 12.92,
                         1.055 * jnp.power(x, 1.0 / 2.4) - 0.055)

    _jax_fns = {
        'rec709_to_linear_scene': scene,
        'rec709_to_linear_display': display,
        'linear_to_rec709': to709,
        'linear_to_srgb': tosrgb,
    }
    return _jax_fns


def transfer_rec709_to_linear_scene(arr):
    return _transfer(arr, 'rec709_to_linear_scene', rec709_to_linear_scene)


def transfer_rec709_to_linear_display(arr):
    return _transfer(arr, 'rec709_to_linear_display', rec709_to_linear_display)


def transfer_linear_to_rec709(arr):
    return _transfer(arr, 'linear_to_rec709', linear_to_rec709)


def transfer_linear_to_srgb(arr):
    return _transfer(arr, 'linear_to_srgb', linear_to_srgb)


def gamma45_ramp_u8():
    """The 65536-entry f16-bits -> u8 display ramp (gammatab.c:12-37)."""
    return _luts.get('gamma45_u8', _gamma45_u8_of_f32, np.uint8)


def apply_gamma45_u8(arr):
    """f16 (or convertible) array -> u8 via the gamma45 ramp."""
    if backend.is_jax_array(arr):
        return apply_half_lut(arr.astype(backend.jnp.float16),
                              gamma45_ramp_u8())
    return apply_half_lut(np.asarray(arr, dtype=np.float16),
                          gamma45_ramp_u8())


def display_ramp_u8(intent):
    """The widget display ramp: 65536-entry f16-bits -> u8 table
    ``lrint(clamp(pow(f, intent) * 255, 0, 255))``
    (widget_gl_set_rendering_intent, widget_gl.c:950-969; default
    intent 1.25)."""
    def fn(x):
        with np.errstate(invalid='ignore'):
            y = np.power(x.astype(np.float32), np.float32(intent))
        y = np.clip(y * np.float32(255.0), 0.0, 255.0)
        return np.rint(np.nan_to_num(y, nan=0.0)).astype(np.uint8)
    return _luts.get('display_u8_%r' % (float(intent),), fn, np.uint8)


def apply_display_u8(arr, intent=1.25):
    """Host/eager widget_gl soft-mode display conversion: linear f16 ->
    sRGB transfer (all 4 channels, the LUT quirk) -> rendering-intent
    ramp -> u8 (widget_gl.c:291-308). Returns u8, same shape."""
    srgb = transfer_linear_to_srgb(arr)
    return apply_half_lut(srgb, display_ramp_u8(intent))


def quantize_f16(x, jnp=None, jax=None):
    """f32 -> f16 -> f32 round-trip quantize that a fusing compiler
    cannot fold away.

    An XLA algebraic simplifier may eliminate
    convert(convert(x, f16), f32) pairs inside fused programs, which
    silently skips the mid-chain quantize the bit-exact contract
    depends on (where it does, a transfer curve under a composite
    diverges from the pull path by one f16 ulp on 25% of pixels; the
    CPU compiler does not fold, so CPU suites cannot catch this).
    ``lax.reduce_precision(5, 10)`` is fold-proof but flushes f16
    subnormals to zero, so |x| below the f16 min normal quantizes on
    the 2^-24 subnormal grid explicitly (round ties-to-even, same as
    the hardware convert; tests/test_color.py checks it elementwise
    against the eager cast over subnormals/negatives/overflow/nan)."""
    if jnp is None:
        jnp, jax = backend.jnp, backend.jax
    if isinstance(x, np.ndarray):
        return x.astype(np.float16).astype(np.float32)
    x = x.astype(jnp.float32)
    rp = jax.lax.reduce_precision(x, 5, 10)
    sub = jnp.round(x * np.float32(2.0 ** 24)) * np.float32(2.0 ** -24)
    return jnp.where(jnp.abs(x) < np.float32(2.0 ** -14), sub, rp)


def quantize_f16_trunc(x, jnp=None, jax=None):
    """f32 -> f16 grid with ROUND-TOWARD-ZERO, fold-proof; result f32.

    The reference's half_convert_from_float truncates the mantissa
    (van der Zijp tables, genhalf.py:27-56), so the reference's f32 ->
    f16 frame conversion before a LUT lookup truncates too; batched
    programs that index a LUT with such values (planar/DV
    reconstruction) must quantize the same way or drift one f16 ulp
    from the eager path on ~30% of values. Device recipe: round-to-nearest onto the grid
    (quantize_f16), then step one grid unit toward zero wherever RN
    overshot |x|; |x| >= 65536 maps to +/-inf exactly as the C base
    table does (e > 15 -> 0x7C00)."""
    if jnp is None:
        jnp, jax = backend.jnp, backend.jax
    if isinstance(x, np.ndarray):
        return float_to_half_trunc(x).astype(np.float32)
    xf = x.astype(jnp.float32)
    q = quantize_f16(xf, jnp, jax)
    h = q.astype(jnp.float16)
    hb = jax.lax.bitcast_convert_type(h, jnp.uint16)
    over = jnp.abs(q) > jnp.abs(xf)
    hb = jnp.where(over, hb - np.uint16(1), hb)
    out = jax.lax.bitcast_convert_type(hb, jnp.float16).astype(jnp.float32)
    big = jnp.abs(xf) >= np.float32(65536.0)
    return jnp.where(big, jnp.where(xf < 0, -np.inf, np.inf), out)


_device_program_cache = {}


def _run_device_conversion(key, make, data, *args):
    """Run an eager device-conversion as ONE compiled program.

    These conversions are chains of ~10 elementwise primitives; called
    eagerly (playback/display/export paths) each primitive dispatches
    and compiles separately — a multi-second first-frame stall on cold
    caches (and every new shape repeats part of it). Jitting the chain
    compiles one fused program, which the persistent compilation cache
    can then keep across processes. Callers already inside a traced
    program (render.py's fused post= programs) inline the math
    directly — nesting a jit there would only add trace overhead."""
    jax = backend.jax
    if isinstance(data, jax.core.Tracer):
        return make(key)(data, *args)
    got = _device_program_cache.get(key)
    if got is None:
        while len(_device_program_cache) > 64:
            # Evict oldest-inserted, not clear(): wiping the whole dict
            # would recompile every hot conversion after one burst of
            # distinct keys.
            _device_program_cache.pop(next(iter(_device_program_cache)))
        got = _device_program_cache[key] = jax.jit(make(key))
    return got(data, *args)


def display_u8_device(data, intent=1.25, order=(2, 1, 0, 3)):
    """(B, 4, H, W) rgba f16 device array -> (B, H, W*4) interleaved u8
    display frames (reshape to (B, H, W, 4) host-side): the widget_gl
    soft-mode conversion computed ON DEVICE — sRGB transfer
    (f16-quantized to match the half-LUT) then the rendering-intent pow
    with lrint rounding, as direct math."""
    # intent stays STATIC in the jit closure (one compiled program per
    # value, bounded by the cache's oldest-eviction + the persistent
    # compile cache across processes). A traced exponent lowers pow to
    # exp*log and loosens host-LUT parity; static 1.25 constant-folds
    # to the exact x*sqrt(sqrt(x)) chain.
    intent = float(intent)
    order = tuple(order)
    return _run_device_conversion(
        ('display_u8', intent, order),
        lambda key: lambda d: _display_u8_math(d, intent, order), data)


def _display_u8_math(data, intent, order):
    jnp = backend.jnp
    x = data.astype(jnp.float32)
    # linear -> sRGB, f16-quantized like a table hit (truncating: the
    # host LUT holds truncated values, see quantize_f16_trunc)
    s = jnp.where(x <= 0.0031308, x * 12.92,
                  1.055 * jnp.power(x, 1.0 / 2.4) - 0.055)
    s = quantize_f16_trunc(s)
    y = jnp.power(s, jnp.float32(intent)) * 255.0
    y = jnp.clip(jnp.nan_to_num(y, nan=0.0), 0.0, 255.0)
    u8 = jnp.rint(y).astype(jnp.uint8)[:, list(order)]
    t = jnp.transpose(u8, (0, 2, 3, 1))
    return t.reshape(t.shape[0], t.shape[1], -1)


def _u8_device(data, order):
    """(B, 4, H, W) rgba f16 device array -> (B, H, W*4) interleaved u8
    device array in the given channel *order*, reshaped to (B, H, W, 4)
    on the host for free. Uses the direct gamma formula (trunc-to-u8
    like the C ramp cast, gammatab.c:8-10); the ramp table itself
    remains the contract for to_argb_string."""
    order = tuple(order)
    return _run_device_conversion(
        ('u8', order), lambda key: lambda d: _u8_math(d, order), data)


def _u8_math(data, order):
    jnp = backend.jnp
    x = data.astype(jnp.float32)
    y = jnp.power(x, 0.45) * 255.0
    y = jnp.clip(jnp.nan_to_num(y, nan=0.0), 0.0, 255.0)
    u8 = jnp.floor(y).astype(jnp.uint8)[:, order]
    t = jnp.transpose(u8, (0, 2, 3, 1))
    return t.reshape(t.shape[0], t.shape[1], -1)


def yuv420_pack_device(data, intent=None):
    """(B, 4, H, W) rgba f16 device array -> (B, H*W + 2*ceil(H/2)*
    ceil(W/2)) packed u8: full-range BT.601 luma at full resolution +
    2x2-mean-subsampled Cb/Cr — the LOSSY low-bandwidth display
    transport (1.5 bytes/px vs BGRA's 4). The RGB values are the same
    display-domain floats _u8_device/display_u8_device quantize, so Y
    of a solid region reconstructs within u8 rounding. intent follows
    render_display: None = gamma45 ramp, float = sRGB + intent pow."""
    intent = None if intent is None else float(intent)
    return _run_device_conversion(
        ('yuv420_pack', intent),
        lambda key: lambda d: _yuv420_pack_math(d, intent), data)


def _yuv420_pack_math(data, intent):
    jnp = backend.jnp
    x = data.astype(jnp.float32)
    if intent is None:
        y = jnp.power(x, 0.45) * 255.0
    else:
        s = jnp.where(x <= 0.0031308, x * 12.92,
                      1.055 * jnp.power(x, 1.0 / 2.4) - 0.055)
        # truncating, like the host sRGB LUT and _display_u8_math's
        # BGRA arm — the two display transports must quantize alike
        s = quantize_f16_trunc(s)
        y = jnp.power(s, jnp.float32(intent)) * 255.0
    y = jnp.clip(jnp.nan_to_num(y, nan=0.0), 0.0, 255.0)
    R, G, Bl = y[:, 0], y[:, 1], y[:, 2]
    Y = 0.299 * R + 0.587 * G + 0.114 * Bl
    Cb = 128.0 + (Bl - Y) * 0.564
    Cr = 128.0 + (R - Y) * 0.713
    B, H, W = Y.shape
    ph, pw = H % 2, W % 2
    if ph or pw:                         # replicate-pad to even dims
        Cb = jnp.pad(Cb, ((0, 0), (0, ph), (0, pw)), mode='edge')
        Cr = jnp.pad(Cr, ((0, 0), (0, ph), (0, pw)), mode='edge')
    h2, w2 = (H + ph) // 2, (W + pw) // 2

    def sub(c):
        c = c.reshape(B, h2, 2, w2, 2)
        return c.mean(axis=(2, 4))

    yq = jnp.rint(Y).astype(jnp.uint8).reshape(B, -1)
    cbq = jnp.rint(jnp.clip(sub(Cb), 0.0, 255.0)).astype(
        jnp.uint8).reshape(B, -1)
    crq = jnp.rint(jnp.clip(sub(Cr), 0.0, 255.0)).astype(
        jnp.uint8).reshape(B, -1)
    return jnp.concatenate([yq, cbq, crq], axis=1)


def yuv420_pack_studio_device(data):
    """(B, 4, H, W) rgba f16 device array -> (B, H*W + 2*ceil(H/2)*
    ceil(W/2)) packed u8: STUDIO-RANGE (BT.601 limited swing, Y 16-235,
    C 16-240) 4:2:0 — the EXPORT transport. The RGB values are first
    floor-quantized through the gamma45 ramp exactly like _u8_device
    (write_video's RGBA parity path), then matrixed with the same
    coefficients swscale applies to that u8 RGBA — so the device pack
    sees the identical u8 RGB swscale would, and diverges from the
    host conversion only by swscale's fixed-point rounding and its
    chroma-phase filter (device uses the 2x2 mean; ±1-2 u8 on detail,
    exact-within-rounding on flat regions). Chroma of odd-sized frames
    edge-replicates the last row/column before the 2x2 mean."""
    return _run_device_conversion(
        ('yuv420_pack_studio',),
        lambda key: _yuv420_pack_studio_math, data)


def _yuv420_pack_studio_math(data):
    jnp = backend.jnp
    x = data.astype(jnp.float32)
    y = jnp.power(x, 0.45) * 255.0
    y = jnp.clip(jnp.nan_to_num(y, nan=0.0), 0.0, 255.0)
    u8f = jnp.floor(y)                   # the exact u8 values sws sees
    R, G, Bl = u8f[:, 0], u8f[:, 1], u8f[:, 2]
    Ey = (0.299 * R + 0.587 * G + 0.114 * Bl) / 255.0   # [0, 1]
    Y = 16.0 + 219.0 * Ey
    Cb = 128.0 + 224.0 * 0.5 / 0.886 * (Bl / 255.0 - Ey)
    Cr = 128.0 + 224.0 * 0.5 / 0.701 * (R / 255.0 - Ey)
    B, H, W = Y.shape
    ph, pw = H % 2, W % 2
    if ph or pw:
        Cb = jnp.pad(Cb, ((0, 0), (0, ph), (0, pw)), mode='edge')
        Cr = jnp.pad(Cr, ((0, 0), (0, ph), (0, pw)), mode='edge')
    h2, w2 = (H + ph) // 2, (W + pw) // 2

    def sub(c):
        c = c.reshape(B, h2, 2, w2, 2)
        return c.mean(axis=(2, 4))

    yq = jnp.rint(jnp.clip(Y, 16.0, 235.0)).astype(
        jnp.uint8).reshape(B, -1)
    cbq = jnp.rint(jnp.clip(sub(Cb), 16.0, 240.0)).astype(
        jnp.uint8).reshape(B, -1)
    crq = jnp.rint(jnp.clip(sub(Cr), 16.0, 240.0)).astype(
        jnp.uint8).reshape(B, -1)
    return jnp.concatenate([yq, cbq, crq], axis=1)


def rgb24_unpack(flat3, order=(2, 1, 0, 3)):
    """Host inverse of the rgb24 display transport: (..., W*3) u8
    color-only rows -> (..., W, 4) u8 in channel *order*, alpha forced
    255. The device packed the color channels in order-minus-alpha, so
    the color bytes land at the non-alpha positions of *order*. Shared
    by render_display and the playback engine so the two lossless
    paths cannot drift."""
    rgb = flat3.reshape(flat3.shape[:-1] + (-1, 3))
    out = np.empty(rgb.shape[:-1] + (4,), np.uint8)
    color_pos = [i for i, c in enumerate(order) if c != 3]
    out[..., color_pos] = rgb
    out[..., order.index(3)] = 255
    return out


def yuv420_unpack(flat, h, w, order=(2, 1, 0, 3)):
    """Host inverse of yuv420_pack_device for ONE frame: (N,) u8 ->
    (h, w, 4) u8 in channel *order*, alpha forced 255."""
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    Y = flat[:h * w].reshape(h, w).astype(np.float32)
    Cb = flat[h * w:h * w + h2 * w2].reshape(h2, w2).astype(np.float32)
    Cr = flat[h * w + h2 * w2:].reshape(h2, w2).astype(np.float32)
    Cb = np.repeat(np.repeat(Cb, 2, axis=0), 2, axis=1)[:h, :w] - 128.0
    Cr = np.repeat(np.repeat(Cr, 2, axis=0), 2, axis=1)[:h, :w] - 128.0
    R = Y + Cr / 0.713
    Bl = Y + Cb / 0.564
    G = (Y - 0.299 * R - 0.114 * Bl) / 0.587
    rgba = np.stack([R, G, Bl, np.full_like(Y, 255.0)], axis=-1)
    out = np.clip(np.rint(rgba), 0, 255).astype(np.uint8)
    return out[:, :, list(order)]


def bgra_u8_device(data):
    """(B, 4, H, W) rgba f16 device array -> (B, H, W*4) BGRA u8 device
    array (reshape to (B, H, W, 4) after the host fetch): the playback
    display conversion computed ON DEVICE, so only u8 crosses the host
    link."""
    return _u8_device(data, (2, 1, 0, 3))


def rgba_u8_device(data):
    """(B, 4, H, W) rgba f16 device array -> (B, H, W*4) RGBA u8 device
    array (export-path variant of bgra_u8_device; reshape host-side)."""
    return _u8_device(data, (0, 1, 2, 3))


# --- color matrices ----------------------------------------------------------

# Rows are output components, columns input components (color.c:35-43 is
# column-major; these are the same matrices expressed row-major).
RGB_TO_XYZ_SDTV = np.array([
    [0.3936, 0.3652, 0.1916],
    [0.2124, 0.7010, 0.0865],
    [0.0187, 0.1119, 0.9582]], dtype=np.float32)

XYZ_TO_SRGB = np.array([
    [3.2410, -1.5374, -0.4986],
    [-0.9692, 1.8760, 0.0416],
    [0.0556, -0.2040, 1.0570]], dtype=np.float32)


def color_matrix(data, matrix):
    """Apply a 3x3 matrix to the rgb planes of (4, H, W) data in f32;
    alpha passes through. Returns same dtype as input (f16 data is
    converted f16->f32->matrix->f16 like color.c:134-141)."""
    dtype = data.dtype
    if backend.is_jax_array(data):
        jnp = backend.jnp
        m = jnp.asarray(matrix, dtype=jnp.float32)
        rgb = data[:3].astype(jnp.float32)
        out = jnp.einsum('ij,jhw->ihw', m, rgb, precision='highest',
                         preferred_element_type=jnp.float32)
        return jnp.concatenate([out.astype(dtype), data[3:]], axis=0)
    m = np.asarray(matrix, dtype=np.float32)
    rgb = np.asarray(data[:3], dtype=np.float32)
    out = np.einsum('ij,jhw->ihw', m, rgb)
    return np.concatenate([out.astype(dtype), data[3:]], axis=0)


def rgb_to_xyz_sdtv_frame(data):
    """video_color_rgb_to_xyz_sdtv (color.c:104-142): rec709->linear scene
    transfer on ALL FOUR channels, then the SDTV RGB->XYZ matrix on rgb.
    data: (4, H, W) f16."""
    lin = transfer_rec709_to_linear_scene(data)
    return color_matrix(lin, RGB_TO_XYZ_SDTV)


def xyz_to_srgb_frame(data):
    """video_color_xyz_to_srgb (color.c:145-168): XYZ->sRGB matrix on rgb,
    then linear->sRGB transfer on all four channels. data: (4, H, W) f16."""
    out = color_matrix(data, XYZ_TO_SRGB)
    return transfer_linear_to_srgb(out)
