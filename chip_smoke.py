#!/usr/bin/env python
"""Smoke test of the batched render path on the GPU, at 1080p.

    python chip_smoke.py          # phases 1-4 on one GPU
    python chip_smoke.py --four   # frame-parallel render over 4 GPUs only

Phases (one GPU):

1. headline: the 10-layer animated 1080p composite (bench.build_timeline)
   through RenderPlanner.iter_batches(batch=128), sampled frames compared
   with the eager pull path on the same device and with the NumPy golden:
   bit-exact outside the scaler layers' footprint, <= 2e-3 inside it.
2. planar: seeded 4:2:0 1080p planes through PlanarReconstructionFilter,
   batched vs pull and vs the NumPy golden (atol 1e-2, >= 99% of values
   bit-exact, the chroma suite's contract).
3. transfer: render._device_transfer on all 65,536 f16 inputs of each
   curve against the host LUTs; 0 mismatches.
4. export: iter_batches(post='rgba_u8' / 'yuv420') against the host
   conversion of the f16 output, within 1 u8.

``--four`` runs render_sharded and iter_batches(mesh=) over a 1-D
('frames',) mesh of 4 GPUs, compares them bit-exact with the one-GPU
planner and prints each device's peak memory.

Each phase raises on a failed comparison, so any failure exits non-zero.
The card's name and power limit are printed before the last line, which
is one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
Without a GPU the script exits non-zero before printing any result.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

FULL_HD = (1920, 1080)


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip()


def _window(size):
    from canvas_tpu.basetypes import box2i
    return box2i(0, 0, size[0] - 1, size[1] - 1)


def _fetch_samples(planner, start, stop, batch, samples, **kw):
    """Stream [start, stop) through iter_batches; return the sampled
    frames on the host and the seconds of the pass (a first pass:
    compiles included)."""
    import jax
    picked = {}
    t0 = time.perf_counter()
    last = None
    for (s, n, out) in planner.iter_batches(start, stop, batch=batch,
                                            **kw):
        for i in samples:
            if s <= i < s + n:
                picked[i] = out[i - s]
        last = out
    jax.block_until_ready(last)
    seconds = time.perf_counter() - t0
    return {i: np.asarray(v) for i, v in picked.items()}, seconds


def _compare(label, got, want, atol, exact_mask=None, min_exact=None):
    """Compare f16 frames; raise on a broken contract. exact_mask marks
    pixels that must match bit for bit."""
    g = got.astype(np.float32)
    w = want.astype(np.float32)
    diff = float(np.max(np.abs(g - w)))
    same = got.view(np.uint16) == want.view(np.uint16)
    line = '%s: max_abs_diff %.3g, %d of %d values differ' % (
        label, diff, int((~same).sum()), same.size)
    ok = diff <= atol
    if exact_mask is not None:
        off = int((~same & exact_mask).sum())
        line += ', %d differ outside the scaler footprint' % off
        ok = ok and off == 0
    if min_exact is not None:
        line += ', exact share %.5f' % same.mean()
        ok = ok and same.mean() >= min_exact
    print(('ok   ' if ok else 'FAIL ') + line, flush=True)
    if not ok:
        raise AssertionError(line)


def _scaler_footprint(ws, i, window):
    """(4, H, W) mask of pixels outside every scaler layer's damage
    box (1 px margin), where the composite must be bit-exact."""
    from canvas_tpu import backend
    from canvas_tpu.sources import VideoScaler
    H, W = window.height, window.width
    exact = np.ones((H, W), bool)
    for item in ws:
        if not isinstance(item.source, VideoScaler):
            continue
        with backend.force_backend('numpy'):
            cw = item.source.get_frame_f16(
                i - item.x + item.offset, window).current_window
        if cw.max.x < cw.min.x or cw.max.y < cw.min.y:
            continue
        y0 = max(cw.min.y - window.min.y - 1, 0)
        x0 = max(cw.min.x - window.min.x - 1, 0)
        exact[y0:cw.max.y - window.min.y + 2,
              x0:cw.max.x - window.min.x + 2] = False
    return np.broadcast_to(exact, (4, H, W))


def phase_headline(size=FULL_HD, batch=128, frames=384):
    """Headline composite: batched vs eager pull on the device and vs
    the NumPy golden."""
    import bench
    from canvas_tpu import backend, render

    window = _window(size)
    ws = bench.build_timeline(max(1024, frames))
    planner = render.RenderPlanner(ws, window)
    planner.plan_cache_segments = 0
    planner.pipeline_chunk = max(planner.pipeline_chunk, batch)
    samples = sorted({0, frames // 3, 2 * frames // 3 + 1, frames - 1})
    got, seconds = _fetch_samples(planner, 0, frames, batch, samples)
    planner.close()
    print('headline %dx%d batch %d: %d frames in %.2f s (first pass, '
          'compiles included)' % (size[0], size[1], batch, frames,
                                  seconds), flush=True)
    for i in samples:
        exact = _scaler_footprint(ws, i, window)
        with backend.force_backend('jax'):
            pull = np.asarray(ws.get_frame_f16(i, window).data, np.float16)
        _compare('headline frame %d vs pull on device' % i, got[i], pull,
                 2e-3, exact_mask=exact)
        with backend.force_backend('numpy'):
            gold = np.asarray(ws.get_frame_f16(i, window).data, np.float16)
        _compare('headline frame %d vs NumPy golden' % i, got[i], gold,
                 2e-3, exact_mask=exact)


def seeded_planes(size, seed=0):
    """A seeded in-memory 4:2:0 coded source (no decoder): studio-range
    random planes, the same for a given (seed, frame)."""
    from canvas_tpu.coded import CodedImage, CodedImageSource

    W, H = size

    class Source(CodedImageSource):
        def get_frame(self, frame_index, quality=0):
            rng = np.random.default_rng(seed + int(frame_index))
            return CodedImage([
                rng.integers(16, 236, (H, W), np.uint8),
                rng.integers(16, 241, (H // 2, W // 2), np.uint8),
                rng.integers(16, 241, (H // 2, W // 2), np.uint8)])

    return Source()


def phase_planar(size=FULL_HD, batch=32, frames=64):
    """4:2:0 reconstruction: batched vs pull on the device and vs the
    NumPy golden."""
    from canvas_tpu import backend, render
    from canvas_tpu.coded import PlanarReconstructionFilter

    window = _window(size)
    filt = PlanarReconstructionFilter(seeded_planes(size, seed=7),
                                      width=size[0], height=size[1])
    planner = render.RenderPlanner(filt, window)
    samples = sorted({0, frames // 2, frames - 1})
    got, seconds = _fetch_samples(planner, 0, frames, batch, samples)
    planner.close()
    print('planar 4:2:0 %dx%d batch %d: %d frames in %.2f s (first pass, '
          'compiles included)' % (size[0], size[1], batch, frames,
                                  seconds), flush=True)
    for i in samples:
        with backend.force_backend('jax'):
            pull = np.asarray(filt.get_frame_f16(i, window).data,
                              np.float16)
        _compare('planar frame %d vs pull on device' % i, got[i], pull,
                 1e-2, min_exact=0.99)
        with backend.force_backend('numpy'):
            gold = np.asarray(filt.get_frame_f16(i, window).data,
                              np.float16)
        _compare('planar frame %d vs NumPy golden' % i, got[i], gold,
                 1e-2, min_exact=0.99)


def phase_transfer():
    """Every f16 input of each transfer curve against the host LUT."""
    import jax
    import jax.numpy as jnp
    from canvas_tpu import render
    from canvas_tpu.ops import color

    x = np.arange(65536, dtype=np.uint16).view(np.float16)
    bad_total = 0
    for name in render._TRANSFER_CURVES:
        fn = jax.jit(lambda v, name=name:
                     render._device_transfer(name, v, jnp, jax))
        got = np.asarray(fn(jnp.asarray(x))).astype(np.float16)
        want = color.get_lut(name)
        bad = ((got.view(np.uint16) != want.view(np.uint16))
               & ~(np.isnan(got) & np.isnan(want)))
        bad_total += int(bad.sum())
        print('transfer %s: %d of 65536 mismatches' % (name, bad.sum()),
              flush=True)
    if bad_total:
        raise AssertionError('%d transfer-curve mismatches' % bad_total)


def _host_yuv420_studio(f16):
    """Plain host reference of the studio-range BT.601 4:2:0 export
    pack: gamma45-ramp u8 RGB, Y at full size, Cb/Cr as the mean of
    each 2x2 block (even frame sizes)."""
    from canvas_tpu.ops import color
    u8 = color.apply_gamma45_u8(f16)[:, :3].astype(np.float64)
    R, G, Bl = u8[:, 0], u8[:, 1], u8[:, 2]
    Ey = (0.299 * R + 0.587 * G + 0.114 * Bl) / 255.0
    Y = np.clip(np.rint(16.0 + 219.0 * Ey), 16, 235)
    Cb = 128.0 + 224.0 * 0.5 / 0.886 * (Bl / 255.0 - Ey)
    Cr = 128.0 + 224.0 * 0.5 / 0.701 * (R / 255.0 - Ey)
    B, H, W = Y.shape

    def sub(c):
        c = c.reshape(B, H // 2, 2, W // 2, 2).mean(axis=(2, 4))
        return np.clip(np.rint(c), 16, 240).reshape(B, -1)

    return np.concatenate([Y.reshape(B, -1), sub(Cb), sub(Cr)],
                          axis=1).astype(np.uint8)


def phase_export(size=FULL_HD, batch=32, frames=32):
    """post='rgba_u8' / 'yuv420' packs vs the host conversion of the
    f16 output of the same range."""
    import bench
    from canvas_tpu import render
    from canvas_tpu.ops import color

    window = _window(size)
    ws = bench.build_timeline(1024)
    planner = render.RenderPlanner(ws, window)
    samples = list(range(frames))
    f16, _t = _fetch_samples(planner, 0, frames, batch, samples)
    f16 = np.stack([f16[i] for i in samples])
    for post, host in (('rgba_u8', lambda f: np.ascontiguousarray(
            color.apply_gamma45_u8(f).transpose(0, 2, 3, 1)).reshape(
                f.shape[0], f.shape[2], -1)),
                       ('yuv420', _host_yuv420_studio)):
        got, _t = _fetch_samples(planner, 0, frames, batch, samples,
                                 post=post)
        got = np.stack([got[i] for i in samples]).astype(np.int16)
        want = host(f16).astype(np.int16)
        if got.shape != want.shape:
            raise AssertionError('%s shape %r, host %r'
                                 % (post, got.shape, want.shape))
        diff = int(np.abs(got - want).max())
        line = ('export %s %dx%d, %d frames vs host conversion: max diff '
                '%d u8, %d of %d bytes differ'
                % (post, size[0], size[1], frames, diff,
                   int((got != want).sum()), got.size))
        print(('ok   ' if diff <= 1 else 'FAIL ') + line, flush=True)
        if diff > 1:
            raise AssertionError(line)
    planner.close()


def phase_four(size=FULL_HD, batch=128, frames=256, n=4):
    """render_sharded and iter_batches(mesh=) over n devices vs the
    one-device planner, bit-exact; per-device peak memory."""
    import jax
    from jax.sharding import Mesh

    import bench
    from canvas_tpu import render

    devices = jax.devices()[:n]
    if len(devices) < n:
        raise RuntimeError('need %d devices, found %d'
                           % (n, len(jax.devices())))
    mesh = Mesh(np.asarray(devices), ('frames',))
    window = _window(size)
    ws = bench.build_timeline(1024)

    t0 = time.perf_counter()
    sharded = render.render_sharded(ws, window, 0, frames, mesh=mesh,
                                    batch=batch)
    print('render_sharded over %d devices, %d frames: %.2f s (compile '
          'included)' % (n, frames, time.perf_counter() - t0), flush=True)
    planner = render.RenderPlanner(ws, window)
    planner.pipeline_chunk = max(planner.pipeline_chunk, batch)
    streamed = [np.asarray(out)[:k] for (_s, k, out) in
                planner.iter_batches(0, frames, batch=batch, mesh=mesh)]
    streamed = np.concatenate(streamed)
    planner.close()
    for d in devices:
        stats = d.memory_stats() or {}
        print('device %d (%s) peak_bytes_in_use %d' % (
            d.id, d.device_kind, stats.get('peak_bytes_in_use', -1)),
            flush=True)

    planner = render.RenderPlanner(ws, window)
    planner.pipeline_chunk = max(planner.pipeline_chunk, batch)
    one = [np.asarray(out)[:k] for (_s, k, out) in
           planner.iter_batches(0, frames, batch=batch)]
    one = np.concatenate(one)
    planner.close()
    for label, got in (('render_sharded', sharded),
                       ('iter_batches(mesh=)', streamed)):
        same = (got.shape == one.shape
                and np.array_equal(got.view(np.uint16),
                                   one.view(np.uint16)))
        line = ('%s over %d devices vs one-device planner, %d frames: '
                'bit-exact %s' % (label, n, frames, same))
        print(('ok   ' if same else 'FAIL ') + line, flush=True)
        if not same:
            raise AssertionError(line)


PHASES = (('headline', phase_headline), ('planar', phase_planar),
          ('transfer', phase_transfer), ('export', phase_export))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four', action='store_true',
                    help='run only the frame-parallel phase on 4 GPUs')
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        print('chip_smoke: no GPU (JAX platform %r)' % devices[0].platform,
              file=sys.stderr)
        return 2
    from canvas_tpu import backend
    backend.configure_compile_cache()

    phases = ((('four', phase_four),) if args.four else PHASES)
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        print('phase %s passed in %.1f s' % (name, time.perf_counter() - t0),
              flush=True)
    if not args.four:
        stats = devices[0].memory_stats() or {}
        print('peak_bytes_in_use %d' % stats.get('peak_bytes_in_use', -1))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform,
        'kind': devices[0].device_kind,
        'count': len(devices)}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
