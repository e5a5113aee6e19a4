#!/usr/bin/env python
"""Canvas headline benchmark: 1080p composited frames/s on one GPU.

BASELINE.md primary metric: 1080p composited frames/sec/chip on a
10-layer timeline (animated opacity + gain + affine motion via scalers),
rendered through the batched device path
(canvas_tpu.render.RenderPlanner.iter_batches) and timed from the
caller's side: wall clock around the streamed range, ending in
block_until_ready. Best of three passes after a warm-up pass.

vs_baseline: ratio against the single-core C reference engine on the same
graph shape (engine10_fps in cbaseline/results.json, measured on a host
CPU), or against a frame-by-frame NumPy pull when that file is missing.

Prints the card's name and power limit, then exactly one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": ...}}
Exits non-zero without a GPU.

    CANVAS_BENCH_BATCH   frames per dispatch (default 128)
    CANVAS_BENCH_FRAMES  timed frames per pass (default max(384, 3*batch))
"""

import json
import os
import sys
import time

import numpy as np


def build_timeline(length=1024):
    """10-layer 1080p timeline: solids with animated windows/colors,
    opacity (gain) animation, and two animated scalers (affine motion)."""
    from canvas_tpu.basetypes import box2i
    from canvas_tpu.framefuncs import LerpFunc, LinearFrameFunc
    from canvas_tpu.sources import (SolidColorVideoSource,
                                    VideoGainOffsetFilter, VideoScaler,
                                    VideoWorkspace)

    ws = VideoWorkspace()
    # Layer 0: full-frame background
    ws.add(source=SolidColorVideoSource((0.1, 0.1, 0.12, 1.0)),
           x=0, length=length, z=0)
    # Layers 1-5: animated color cards at varying windows/opacity
    for i in range(5):
        color = LerpFunc((0.9 - 0.1 * i, 0.1 * i, 0.3, 0.9),
                         (0.1 * i, 0.8, 0.9 - 0.1 * i, 0.4), length)
        win = box2i(60 * i, 40 * i, 60 * i + 900, 40 * i + 600)
        layer = VideoGainOffsetFilter(
            SolidColorVideoSource(color, window=win),
            gain=LinearFrameFunc(0.3 / length, 0.7), offset=0.0)
        ws.add(source=layer, x=0, length=length, z=i + 1)
    # Layers 6-7: animated scalers (affine motion: translate + zoom)
    for i in range(2):
        base = SolidColorVideoSource((0.2, 0.5 + 0.2 * i, 0.8, 0.8),
                                     window=box2i(0, 0, 479, 269))
        sc = VideoScaler(
            base,
            target_point=LerpFunc((200 + 300 * i, 150), (900, 700), length),
            source_point=(0.0, 0.0),
            scale_factors=LerpFunc((1.0, 1.0), (1.8, 1.8), length),
            source_rect=box2i(0, 0, 479, 269))
        ws.add(source=sc, x=0, length=length, z=6 + i)
    # Layers 8-9: crossfading cards
    from canvas_tpu.sources import VideoMixFilter
    mix = VideoMixFilter(
        SolidColorVideoSource((1.0, 0.4, 0.1, 0.6),
                              window=box2i(400, 300, 1500, 900)),
        SolidColorVideoSource((0.1, 0.4, 1.0, 0.6),
                              window=box2i(400, 300, 1500, 900)),
        LerpFunc((0.0,), (1.0,), length))
    ws.add(source=mix, x=0, length=length, z=8)
    ws.add(source=SolidColorVideoSource((1, 1, 1, 0.08),
                                        window=box2i(0, 980, 1919, 1079)),
           x=0, length=length, z=9)
    return ws


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        print('bench: no GPU (JAX platform %r)' % dev.platform,
              file=sys.stderr)
        return 2

    from canvas_tpu import backend, render
    from canvas_tpu.basetypes import box2i

    import chip_smoke

    backend.configure_compile_cache()
    window = box2i(0, 0, 1919, 1079)
    batch = int(os.environ.get('CANVAS_BENCH_BATCH', '128'))
    timed_frames = int(os.environ.get('CANVAS_BENCH_FRAMES',
                                      str(max(384, 3 * batch))))
    # The timeline must cover warm + timed frames: layers end at the
    # timeline length, and a range past it plans EMPTY (near-free zero
    # frames), which would inflate the metric.
    start = batch
    ws = build_timeline(max(1024, start + timed_frames))

    planner = render.RenderPlanner(ws, window)
    # The headline measures COLD streaming (plan + slice + dispatch per
    # pass): plan caching would turn repeated passes over one range into
    # replay measurement.
    planner.plan_cache_segments = 0
    # Batches larger than the pipeline chunk would be tail-padded to the
    # segment length; grow the chunk so big batches measure real work.
    planner.pipeline_chunk = max(planner.pipeline_chunk, batch)

    def stream(lo, hi):
        last = None
        for (_s, _n, out) in planner.iter_batches(lo, hi, batch=batch):
            last = out
        jax.block_until_ready(last)

    # Warm-up: compiles every program the timed range uses (placed
    # region sizes change along the animation, and each size is its own
    # program).
    stream(0, start + timed_frames)
    fps = 0.0
    for _pass in range(3):
        t0 = time.perf_counter()
        stream(start, start + timed_frames)
        fps = max(fps, timed_frames / (time.perf_counter() - t0))
    planner.close()

    results_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                'cbaseline', 'results.json')
    try:
        with open(results_path) as f:
            base_fps = float(json.load(f)['engine10_fps'])
    except (OSError, KeyError, ValueError):
        times = []
        with backend.force_backend('numpy'):
            for i in range(5):
                t0 = time.perf_counter()
                ws.get_frame_f16(500 + i, window)
                times.append(time.perf_counter() - t0)
        base_fps = 1.0 / float(np.median(times))

    print(chip_smoke.card_line())
    print(json.dumps({
        'metric': '1080p_10layer_composite_fps_per_chip',
        'value': round(fps, 2),
        'unit': 'frames/sec',
        'vs_baseline': round(fps / base_fps, 2),
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
