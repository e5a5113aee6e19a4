#!/usr/bin/env python
"""Full benchmark suite: the BASELINE.md configs, on one GPU.

``bench.py`` prints the single headline line; this script measures the
whole matrix and prints one row per config, then the card's name and
power limit, then one JSON object of all rows. Configs:

1. Single 720p clip pull (solid source -> rec709->linear f16).
2. Two-clip 1080p crossfade.
3. DV 4:1:1 reconstruction (+ pulldown removal) on synthetic coded frames.
4. 10-layer 1080p timeline with affine motion + opacity (the headline),
   plus p50 single-frame and viewport latency through render_display.
5. Frame-parallel export sharding over all local devices, with the
   sharded/unsharded ratio of interleaved passes.
6. 4K export path (u8 RGBA, and the packed 4:2:0 transport in 6b).
7. Mixed content: cold (7), cached replay (7b), replay while editing
   elsewhere (7c).
8. Decoded 1080p through the planar staging path.

Each row is the median of three samples with the min..max spread.
Timings end in block_until_ready. Exits non-zero without a GPU.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np


def median_of(fn, n=3):
    """Median, min and max of n samples of fn()."""
    vals = sorted(float(fn()) for _ in range(n))
    return vals[n // 2], vals[0], vals[-1]


def timeit_batches(planner, batch, n_frames, start=0, max_inflight=None):
    """Steady-state fps through the plan-once streaming path: one warm
    pass over the SAME range (pays compiles), then the timed pass.

    Plan caching is DISABLED for the timed planner: the warm pass
    covers the same range, and a plan-cache hit would silently turn
    the timed pass into replay measurement (config7b measures replay
    explicitly, with caches on)."""
    import jax

    planner.plan_cache_segments = 0
    # Segments must be at least batch-sized or tail padding wastes the
    # batch.
    planner.pipeline_chunk = max(planner.pipeline_chunk, batch)

    def run_range():
        t0 = time.perf_counter()
        last = None
        for (_s, _n, out) in planner.iter_batches(
                start, start + n_frames, batch=batch,
                max_inflight=max_inflight):
            last = out
        jax.block_until_ready(last)
        return n_frames / (time.perf_counter() - t0)

    run_range()
    return run_range()


def config1():
    """720p single clip: solid + rec709->linear transfer."""
    from canvas_tpu import render
    from canvas_tpu.basetypes import box2i
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.sources import (SolidColorVideoSource,
                                    VideoColorTransferFilter)

    src = VideoColorTransferFilter(
        SolidColorVideoSource(LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 1024)),
        'rec709_to_linear_scene')
    planner = render.RenderPlanner(src, box2i(0, 0, 1279, 719))
    return timeit_batches(planner, 128, 512)


def config2():
    """1080p two-clip crossfade."""
    from canvas_tpu import render
    from canvas_tpu.basetypes import box2i
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.sources import SolidColorVideoSource, VideoMixFilter

    mix = VideoMixFilter(
        SolidColorVideoSource(LerpFunc((1, 0, 0, 1), (0, 1, 0, 1), 1024)),
        SolidColorVideoSource(LerpFunc((0, 0, 1, 1), (1, 1, 0, 1), 1024)),
        LerpFunc((0.0,), (1.0,), 1024))
    planner = render.RenderPlanner(mix, box2i(0, 0, 1919, 1079))
    return timeit_batches(planner, 128, 512)


def config3():
    """DV 4:1:1 reconstruction + 2:3 pulldown removal."""
    from canvas_tpu import render
    from canvas_tpu.basetypes import box2i
    from canvas_tpu.coded import (CodedImage, CodedImageSource,
                                  DVReconstructionFilter,
                                  Pulldown23RemovalFilter)

    rng = np.random.RandomState(0)
    y = rng.randint(16, 236, (480, 720)).astype(np.uint8)
    cb = rng.randint(16, 241, (480, 180)).astype(np.uint8)
    cr = rng.randint(16, 241, (480, 180)).astype(np.uint8)

    class Source(CodedImageSource):
        def get_frame(self, frame_index, quality=0):
            return CodedImage([y, cb, cr])

    src = Pulldown23RemovalFilter(DVReconstructionFilter(Source()), 0)
    planner = render.RenderPlanner(src, box2i(0, -1, 719, 478))
    planner.stage_cache_mb = 0       # measure the staging path itself
    return timeit_batches(planner, 16, 128)


def _config4_graph():
    import bench
    from canvas_tpu import render
    from canvas_tpu.basetypes import box2i

    ws = bench.build_timeline()
    return render.RenderPlanner(ws, box2i(0, 0, 1919, 1079))


def config4():
    """10-layer 1080p timeline (the bench.py headline)."""
    planner = _config4_graph()
    return timeit_batches(planner, 128, 512)


def config4_p50(display_size=None, transport='u8'):
    """p50 single-frame pull latency on the headline graph through the
    low-latency display path (render_display — one warm fused program
    rendering + converting to u8 BGRA on device, single u8 fetch; what
    a playback surface waits for). display_size fetches a viewport-
    sized frame (the reference's soft mode paints at widget size,
    widget_gl.c:793-816). transport='yuv420' measures the lossy
    packed scrub transport (1.5 B/px vs 4)."""
    planner = _config4_graph()
    planner.render_display(199, display_size=display_size,
                           transport=transport)   # warm

    def once():
        lat = []
        for i in range(20):
            t0 = time.perf_counter()
            planner.render_display(200 + i, display_size=display_size,
                                   transport=transport)
            lat.append(time.perf_counter() - t0)
        return float(np.percentile(lat, 50) * 1e3)
    return once


#: config5 pairs every sharded sample with an unsharded run of the SAME
#: range taken back-to-back, so the ratio compares passes taken under
#: the same conditions. Each call produces (sharded_fps, ratio); the
#: ratio row consumes the queued companion.
_CONFIG5_RATIOS = []


def config5():
    """Frame-parallel sharded render (all local devices) — since
    round 3 a thin collector over the same streaming executor, so a
    1-device mesh matches plain iter_batches. Also measures an
    UNSHARDED streaming pass over the same range immediately after,
    in the same phase, and queues sharded/unsharded for the ratio row."""
    import bench
    from canvas_tpu import render
    from canvas_tpu.basetypes import box2i

    import jax

    ws = bench.build_timeline()
    window = box2i(0, 0, 1919, 1079)
    n = len(jax.devices())
    # render_sharded returns ONE concatenated array of every frame
    frames = max(256, 128 * n)

    def run_sharded():
        # ONE call over the whole range, like a real export drives it:
        # render_sharded streams internally (plan-ahead + program
        # reuse); per-chunk calls would re-plan per call.
        t0 = time.perf_counter()
        out = render.render_sharded(ws, window, 0, frames,
                                    device_out=True, batch=128)
        jax.block_until_ready(out)
        return frames / (time.perf_counter() - t0)

    plain_planner = render.RenderPlanner(bench.build_timeline(), window)
    plain_planner.plan_cache_segments = 0
    plain_planner.pipeline_chunk = max(plain_planner.pipeline_chunk, 128)

    def run_plain():
        t0 = time.perf_counter()
        last = None
        for (_s, _n, out) in plain_planner.iter_batches(
                0, frames, batch=128, device_out=True):
            last = out
        jax.block_until_ready(last)
        return frames / (time.perf_counter() - t0)

    run_sharded()          # pays compiles
    run_plain()
    # median of three interleaved pairs
    pairs = [(run_sharded(), run_plain()) for _ in range(3)]
    ratios = sorted(s / max(p, 1e-9) for s, p in pairs)
    _CONFIG5_RATIOS.append(ratios[1])
    return sorted(s for s, _ in pairs)[1]


def config5_ratio():
    """Same-phase sharded/unsharded ratio, consuming the companion
    measured inside the config5 sample (or measuring a fresh pair)."""
    if not _CONFIG5_RATIOS:
        config5()
    return _CONFIG5_RATIOS.pop()


def config6():
    """4K (2160p) 10-layer export-shaped path: streaming render +
    device u8 conversion (what write_video fetches per batch)."""
    import jax

    import bench
    from canvas_tpu import render
    from canvas_tpu.basetypes import box2i

    ws = bench.build_timeline()
    planner = render.RenderPlanner(ws, box2i(0, 0, 3839, 2159))
    planner.plan_cache_segments = 0      # measure cold streaming

    def run_range():
        t0 = time.perf_counter()
        last = None
        n = 0
        # post= fuses the u8 conversion into the render program — the
        # write_video export path (no intermediate f16 tensor)
        for (_s, _n, u8) in planner.iter_batches(0, 64, batch=8,
                                                 post='rgba_u8'):
            last = u8
            n += _n
        jax.block_until_ready(last)
        return n / (time.perf_counter() - t0)

    run_range()
    return run_range()


def config6b():
    """config6 with the packed 4:2:0 export transport
    (write_video(transport='yuv420')): same graph, 1.5 bytes/px fetched
    instead of 4 — isolates the D2H-bytes term of export throughput."""
    import bench
    from canvas_tpu import render
    from canvas_tpu.basetypes import box2i

    ws = bench.build_timeline()
    planner = render.RenderPlanner(ws, box2i(0, 0, 3839, 2159))
    planner.plan_cache_segments = 0

    def run_range():
        t0 = time.perf_counter()
        n = 0
        for (_s, _n, packed) in planner.iter_batches(0, 64, batch=8,
                                                     post='yuv420'):
            # host-fetched ndarray (device_out=False): touching one
            # element is free, the fetch already completed
            assert packed[-1, -1] is not None
            n += _n
        return n / (time.perf_counter() - t0)

    run_range()
    return run_range()


def _mixed_timeline(length=256):
    """10-layer 1080p with 3 STAGED coded DV layers (reconstruct ->
    scaler), the rest solids/gain/crossfade; coded planes differ per
    frame (rolled), so every unique frame's planes really cross
    host->device once."""
    import bench
    from canvas_tpu.basetypes import box2i
    from canvas_tpu.coded import (CodedImage, CodedImageSource,
                                  DVReconstructionFilter)
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.sources import VideoScaler

    rng = np.random.RandomState(7)
    y = rng.randint(16, 236, (480, 720)).astype(np.uint8)
    cb = rng.randint(16, 241, (480, 180)).astype(np.uint8)
    cr = rng.randint(16, 241, (480, 180)).astype(np.uint8)

    class Rolled(CodedImageSource):
        def get_frame(self, frame_index, quality=0):
            return CodedImage([np.roll(y, frame_index, axis=0),
                               np.roll(cb, frame_index, axis=0),
                               np.roll(cr, frame_index, axis=0)])

    ws = bench.build_timeline(length)
    for z, (tx, ty) in zip((2, 4, 6), ((0, 0), (640, 120), (960, 480))):
        clip = VideoScaler(
            DVReconstructionFilter(Rolled()),
            target_point=LerpFunc((tx, ty), (tx + 60, ty + 40), length),
            source_point=(0.0, -1.0),
            scale_factors=(1.25, 1.25),
            source_rect=box2i(0, -1, 719, 478))
        for item in [it for it in ws if it.z == z]:
            ws.remove(item)
        ws.add(source=clip, x=0, length=length, z=z)
    return ws


def config7():
    """Mixed-content first pass (every unique coded frame crosses H2D
    once)."""
    from canvas_tpu import render
    from canvas_tpu.basetypes import box2i

    ws = _mixed_timeline()
    planner = render.RenderPlanner(ws, box2i(0, 0, 1919, 1079))
    planner.stage_cache_mb = 0       # force fresh staging per pass
    return timeit_batches(planner, 16, 128)


def config7b():
    """Mixed-content CACHED REPLAY: the second loop over the same range
    hits the persistent device staging cache (zero decode, zero H2D) —
    what a looped or scrubbed-over playback sees (round-3 verdict
    item 3; target >= realtime ~30 fps)."""
    from canvas_tpu import render
    from canvas_tpu.basetypes import box2i

    import jax

    ws = _mixed_timeline()
    planner = render.RenderPlanner(ws, box2i(0, 0, 1919, 1079))

    def run_range():
        t0 = time.perf_counter()
        last = None
        for (_s, _n, out) in planner.iter_batches(0, 128, batch=16):
            last = out
        jax.block_until_ready(last)
        return 128 / (time.perf_counter() - t0)

    run_range()            # first pass: stages everything + compiles
    return run_range       # subsequent passes replay from HBM


def config7c():
    """Mixed-content replay WHILE EDITING ELSEWHERE: before each timed
    pass an edit signal invalidates a range outside the loop
    (frames_updated(500, 600) vs the [0, 128) loop). Ranged
    invalidation keeps the loop's plans and staged stacks — this
    should match config7b; a full-clear regression collapses it to
    config7's cold fps."""
    from canvas_tpu import render
    from canvas_tpu.basetypes import box2i

    import jax

    ws = _mixed_timeline()
    planner = render.RenderPlanner(ws, box2i(0, 0, 1919, 1079))

    def run_range():
        planner.invalidate_display_cache(500, 600)
        t0 = time.perf_counter()
        last = None
        for (_s, _n, out) in planner.iter_batches(0, 128, batch=16):
            last = out
        jax.block_until_ready(last)
        return 128 / (time.perf_counter() - t0)

    run_range()            # first pass: stages everything + compiles
    return run_range


def config8(tmp=None):
    """Real decoded 1080p playback through the planar staging path
    (decode on host -> YCbCr planes staged once per segment to device
    -> reconstruction + transfer on device)."""
    import fractions

    from canvas_tpu import libav, render
    from canvas_tpu.basetypes import box2i
    from canvas_tpu.coded import PlanarReconstructionFilter
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.sources import SolidColorVideoSource

    tmp = tmp or os.path.join(tempfile.gettempdir(),
                              'canvas_bench_1080p.avi')
    if not os.path.exists(tmp):
        src = SolidColorVideoSource(LerpFunc((0, 0, 0, 1), (1, 1, 1, 1),
                                             64))
        libav.write_video(tmp, src, None, 0, 64, frame_size=(1920, 1080),
                          frame_rate=fractions.Fraction(25),
                          video_codec='mpeg4', bit_rate=8_000_000,
                          format='avi')
    filt = PlanarReconstructionFilter(libav.AVVideoDecoder(tmp),
                                      width=1920, height=1080)
    planner = render.RenderPlanner(filt, box2i(0, 0, 1919, 1079))
    planner.stage_cache_mb = 0
    return timeit_batches(planner, 8, 48)


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        print('benchmarks: no GPU (JAX platform %r)' % dev.platform,
              file=sys.stderr)
        return 2
    from canvas_tpu import backend

    import chip_smoke

    backend.configure_compile_cache()
    results = {}

    def measure(key, fn, n=3):
        # Factory rows (config4_p50/config7b/config7c build a planner
        # and pay a warm pass) are passed as (factory,) 1-tuples.
        if isinstance(fn, tuple):
            fn = fn[0]()
        # One config's failure must not abort the whole matrix: record
        # it and keep going.
        try:
            med, lo, hi = median_of(fn, n)
        except Exception as e:
            import traceback
            traceback.print_exc()
            results[key] = 'FAILED: %s' % type(e).__name__
            print('%-44s FAILED (%s)' % (key, e), flush=True)
            return
        results[key] = med
        print('%-44s %10.2f  (%.2f .. %.2f)' % (key, med, lo, hi),
              flush=True)

    measure('config1_720p_single_clip_fps', config1)
    measure('config2_1080p_crossfade_fps', config2)
    measure('config3_dv_reconstruct_pulldown_fps', config3)
    measure('config4_10layer_1080p_fps', config4)
    measure('config4_single_frame_p50_ms', (config4_p50,))
    measure('config4_viewport_960x540_p50_ms',
            (lambda: config4_p50(display_size=(960, 540)),))
    measure('config4_viewport_rgb24_p50_ms',
            (lambda: config4_p50(display_size=(960, 540),
                                 transport='rgb24'),))
    measure('config4_viewport_yuv420_p50_ms',
            (lambda: config4_p50(display_size=(960, 540),
                                 transport='yuv420'),))
    measure('config5_sharded_fps_%d_devices' % len(jax.devices()),
            config5)
    measure('config5_sharded_vs_unsharded_ratio', config5_ratio)
    measure('config6_4k_10layer_export_path_fps', config6)
    measure('config6b_4k_export_yuv420_transport_fps', config6b)
    measure('config7_mixed_content_10layer_fps', config7)
    measure('config7b_mixed_content_cached_replay_fps', (config7b,))
    measure('config7c_replay_while_editing_elsewhere_fps', (config7c,))
    measure('config8_1080p_decoded_planar_fps', config8)

    print(chip_smoke.card_line())
    print(json.dumps({'device': {'platform': dev.platform,
                                 'kind': dev.device_kind,
                                 'count': len(jax.devices())},
                      'rows': results}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
