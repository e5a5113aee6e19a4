"""Clocks, pull queue, and playback engine.

Clock tests port the reference suite
(/root/reference/tests/process/SystemPresentationClock.py).
"""

import os
import time
from fractions import Fraction

import numpy as np
import pytest

from canvas_tpu.basetypes import box2i
from canvas_tpu.clock import SystemPresentationClock
from canvas_tpu.pullqueue import VideoPullQueue
from canvas_tpu.sources import SolidColorVideoSource


def test_clock_callback():
    results = []

    def callback(speed, time_ns, data):
        data.append((speed, time_ns))

    clock = SystemPresentationClock()
    handle = clock.register_callback(callback, results)
    clock.play(1)
    assert results[0] == (Fraction(1, 1), 0)

    clock.stop()
    assert results[1][0] == Fraction(0, 1)
    t = results[1][1]

    clock.play(Fraction(-1, 2))
    assert results[2] == (Fraction(-1, 2), t)

    clock.seek(200)
    assert results[3] == (Fraction(-1, 2), 200)

    handle.unregister()
    clock.stop()
    assert len(results) == 4


def test_clock_seek():
    clock = SystemPresentationClock()
    clock.seek(100)
    assert clock.get_presentation_time() == 100


def test_clock_advances():
    clock = SystemPresentationClock()
    clock.set(Fraction(2, 1), 0)
    time.sleep(0.05)
    t = clock.get_presentation_time()
    # 50ms at 2x -> ~100ms of stream time
    assert 50_000_000 < t < 400_000_000
    clock.stop()
    frozen = clock.get_presentation_time()
    time.sleep(0.02)
    assert clock.get_presentation_time() == frozen


def test_clock_negative_speed():
    clock = SystemPresentationClock()
    clock.set(Fraction(-1, 1), 1_000_000_000)
    time.sleep(0.05)
    assert clock.get_presentation_time() < 1_000_000_000


def test_pull_queue():
    queue = VideoPullQueue()
    results = []
    src = SolidColorVideoSource((1, 0, 0, 1))
    for i in range(4):
        queue.enqueue(src, i, box2i(0, 0, 3, 3),
                      lambda idx, frame, data: results.append((idx, data)),
                      data=i * 10)
    deadline = time.time() + 5
    while len(results) < 4 and time.time() < deadline:
        time.sleep(0.01)
    assert sorted(r[0] for r in results) == [0, 1, 2, 3]
    assert sorted(r[1] for r in results) == [0, 10, 20, 30]
    queue.close()


def test_pull_queue_cancel():
    queue = VideoPullQueue()
    results = []
    src = SolidColorVideoSource((1, 0, 0, 1))
    item = queue.enqueue(src, 0, box2i(0, 0, 3, 3),
                         lambda idx, frame, data: results.append(idx))
    item.cancel()
    time.sleep(0.2)
    # cancelled before or after pull; either way no late delivery is
    # guaranteed only if cancel landed before dispatch — just assert no
    # crash and at most one result
    assert len(results) <= 1
    queue.close()


def test_playback_engine_presents_frames():
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.playback import VideoPlaybackEngine

    presented = []
    src = SolidColorVideoSource(LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 100))
    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        src, clock, Fraction(100, 1), box2i(0, 0, 15, 15),
        lambda idx, bgra: presented.append((idx, bgra.shape)))
    try:
        clock.play(1)
        # on a device the first batch includes a slow compile
        budget = 60 if os.environ.get('CANVAS_TEST_DEVICE') else 10
        deadline = time.time() + budget
        while len(presented) < 3 and time.time() < deadline:
            time.sleep(0.02)
        clock.stop()
        # under full-suite CPU load fewer frames may land in time;
        # two descending presents still prove the reverse path
        assert len(presented) >= 2
        idx0, shape = presented[0]
        assert shape == (16, 16, 4)
        # frames advance monotonically during forward playback
        indices = [p[0] for p in presented]
        assert indices == sorted(indices)
    finally:
        engine.stop()


def test_playback_engine_warm_precompiles():
    """warm() renders the first batch synchronously (compiling every
    program playback uses) so a subsequent play starts with the frames
    already in the ring — the first-compile stall fix."""
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.playback import VideoPlaybackEngine

    presented = []
    src = SolidColorVideoSource(LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 100))
    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        src, clock, Fraction(100, 1), box2i(0, 0, 15, 15),
        lambda idx, bgra: presented.append(idx), batch=4)
    try:
        engine.warm(0)
        with engine._lock:
            cached = sorted(engine._cache)
        assert cached[:4] == [0, 1, 2, 3]
        # The paused render thread presents the current frame once it's
        # cached; wait for that so the count below is race-free.
        deadline = time.time() + 5
        while not presented and time.time() < deadline:
            time.sleep(0.01)
        n = len(presented)
        # display_frame of a warmed frame presents from the ring
        # (exactly one more present, no re-render)
        engine.display_frame(0)
        assert len(presented) == n + 1
        assert set(presented) == {0}
    finally:
        engine.stop()


def test_playback_seek_invalidates():
    from canvas_tpu.playback import VideoPlaybackEngine

    presented = []
    src = SolidColorVideoSource((0, 1, 0, 1))
    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        src, clock, Fraction(100, 1), box2i(0, 0, 7, 7),
        lambda idx, bgra: presented.append(idx))
    try:
        clock.seek(0)
        deadline = time.time() + 5
        while not presented and time.time() < deadline:
            time.sleep(0.02)
        clock.seek(50 * 10_000_000)   # frame 50 at 100fps
        deadline = time.time() + 5
        while 50 not in presented and time.time() < deadline:
            time.sleep(0.02)
        assert 50 in presented
    finally:
        engine.stop()


def test_engine_and_queue_lifecycle_no_thread_leak():
    import threading
    from canvas_tpu.pullqueue import VideoPullQueue
    from canvas_tpu.playback import VideoPlaybackEngine
    from canvas_tpu.clock import SystemPresentationClock
    from canvas_tpu.sources import SolidColorVideoSource

    base = threading.active_count()
    src = SolidColorVideoSource((0.5, 0.5, 0.5, 1.0))
    for _ in range(5):
        clock = SystemPresentationClock()
        eng = VideoPlaybackEngine(src, clock, Fraction(30, 1),
                                  box2i(0, 0, 15, 15), lambda *a: None)
        q = VideoPullQueue()
        q.enqueue(src, 0, box2i(0, 0, 15, 15), lambda *a: None)
        q.close()
        eng.stop()
    time.sleep(0.5)
    assert threading.active_count() - base <= 2


def test_display_semantics_par_and_intent():
    """widget_gl display parity (widget_gl.c:818-969): DV 10:11 pixel
    aspect ratio geometry, display window override, rendering-intent
    switching re-renders with the new ramp."""
    from canvas_tpu.playback import VideoPlaybackEngine

    presented = []
    src = SolidColorVideoSource((0.25, 0.5, 0.75, 1.0))
    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        src, clock, Fraction(30000, 1001), box2i(0, -1, 719, 478),
        lambda idx, bgra: presented.append((idx, bgra)))
    try:
        # defaults match the reference
        assert abs(engine.pixel_aspect_ratio - 40.0 / 33.0) < 1e-6
        assert engine.rendering_intent == 1.25

        # DV NTSC 4:3: PAR 10/11 -> display width 720*10/11 = 655
        engine.set_pixel_aspect_ratio(10.0 / 11.0)
        assert engine.display_size() == (655, 480)

        # display window override re-windows the pull
        engine.set_display_window(box2i(0, 0, 99, 79))
        assert engine.display_size() == (91, 80)

        clock.play(1)
        deadline = time.time() + (60 if os.environ.get('CANVAS_TEST_DEVICE')
                                  else 10)
        while not presented and time.time() < deadline:
            time.sleep(0.02)
        clock.stop()
        assert presented
        _, bgra = presented[0]
        assert bgra.shape == (80, 100, 4)

        # conversion is the widget path: sRGB + intent ramp (not gamma45)
        from canvas_tpu.ops import color as color_ops
        lin = np.zeros((4, 1, 1), np.float16)
        lin[0] = 0.25; lin[1] = 0.5; lin[2] = 0.75; lin[3] = 1.0
        want = color_ops.apply_display_u8(lin, 1.25)
        got_px = bgra[40, 50]
        assert tuple(got_px) == (int(want[2, 0, 0]), int(want[1, 0, 0]),
                                 int(want[0, 0, 0]), int(want[3, 0, 0]))

        # intent switch invalidates and re-renders with the new ramp
        presented.clear()
        engine.set_rendering_intent(1.0)
        clock.seek(0)
        clock.play(1)
        deadline = time.time() + (60 if os.environ.get('CANVAS_TEST_DEVICE')
                                  else 10)
        while not presented and time.time() < deadline:
            time.sleep(0.02)
        clock.stop()
        assert presented
        _, bgra1 = presented[0]
        want1 = color_ops.apply_display_u8(lin, 1.0)
        got_px1 = bgra1[40, 50]
        assert tuple(got_px1) == (int(want1[2, 0, 0]), int(want1[1, 0, 0]),
                                  int(want1[0, 0, 0]), int(want1[3, 0, 0]))
        assert tuple(got_px1) != tuple(got_px)
    finally:
        engine.stop()


def test_display_u8_device_matches_host_lut():
    """Device display conversion (direct math) agrees with the
    host 64K-LUT path within 1 code value everywhere."""
    from canvas_tpu import backend
    from canvas_tpu.ops import color as color_ops

    rng = np.random.RandomState(3)
    data = (rng.rand(2, 4, 32, 128) * 1.2 - 0.05).astype(np.float16)
    host = color_ops.apply_display_u8(data, 1.25)
    with backend.force_backend('jax'):
        jnp = backend.jnp
        flat = np.asarray(color_ops.display_u8_device(
            jnp.asarray(data), 1.25, order=(0, 1, 2, 3)))
    dev = flat.reshape(2, 32, 128, 4).transpose(0, 3, 1, 2)
    diff = np.abs(host.astype(int) - dev.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02


def test_reverse_playback_staged_source():
    """Reverse playback against a STAGED (coded DV) source: the engine
    renders batches behind the playhead and presents frames in
    descending order with per-frame content (the reference treats
    reverse as first-class, AVAudioDecoder.c:255-295)."""
    from canvas_tpu.coded import (CodedImage, CodedImageSource,
                                  DVReconstructionFilter)
    from canvas_tpu.playback import VideoPlaybackEngine

    class Coded(CodedImageSource):
        """Luma encodes the frame index (distinguishable content)."""

        def get_frame(self, frame_index, quality=0):
            y = np.full((480, 720), 16 + 2 * (frame_index % 100), np.uint8)
            c = np.full((480, 180), 128, np.uint8)
            return CodedImage([y, c, c])

    from canvas_tpu import process

    src = DVReconstructionFilter(Coded())
    clock = SystemPresentationClock()
    presented = []
    engine = VideoPlaybackEngine(
        src, clock, Fraction(10, 1), box2i(0, -1, 719, 478),
        lambda idx, bgra: presented.append((idx, int(bgra[200, 300, 2]))),
        batch=4)
    try:
        # start at frame 40, play backwards (10 fps so the recon path
        # keeps up; clamp the range so a slow first compile can't let
        # the playhead escape below frame 0 on a device)
        engine.set_frame_range(0, 40)
        # Warm the compiled batch program first: a first compile on a
        # device can take seconds and would outrun any real-time
        # playhead.
        engine._render_batch(37, 41)
        clock.seek(process.get_frame_time(Fraction(10, 1), 40))
        presented.clear()     # drop the paused pre-seek frame
        clock.play(-1)
        deadline = time.time() + (120 if os.environ.get('CANVAS_TEST_DEVICE')
                                  else 40)
        while len(presented) < 3 and time.time() < deadline:
            time.sleep(0.02)
        clock.stop()
        # under full-suite CPU load fewer frames may land in time;
        # two descending presents still prove the reverse path
        assert len(presented) >= 2
        # a stale paused-frame (index 0) present can race the seek;
        # ignore it for the ordering check
        indices = [i for (i, _r) in presented if i != 0]
        assert len(indices) >= 2
        assert indices == sorted(indices, reverse=True), indices
        assert all(0 < i <= 40 for i in indices), indices
        # content follows the frame index: higher frame -> brighter red
        by_idx = dict(presented)
        lo, hi = min(by_idx), max(by_idx)
        if hi > lo:
            assert by_idx[hi] > by_idx[lo]
    finally:
        engine.stop()


def test_playback_source_swap_range_and_display_frame():
    """widget_gl parity: live source swap, first/last frame clamps,
    and display_frame paused preview (widget_gl.c:236-239, 552-554,
    widget_gl_set_video_source)."""
    from canvas_tpu.playback import VideoPlaybackEngine

    presented = []
    red = SolidColorVideoSource((1.0, 0.0, 0.0, 1.0))
    green = SolidColorVideoSource((0.0, 1.0, 0.0, 1.0))
    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        red, clock, Fraction(100, 1), box2i(0, 0, 15, 15),
        lambda idx, bgra: presented.append((idx, tuple(bgra[8, 8]))))
    try:
        engine.set_frame_range(0, 5)
        engine.display_frame(99)       # clamps to frame 5
        deadline = time.time() + 10
        while not presented and time.time() < deadline:
            time.sleep(0.02)
        assert presented
        idx, px = presented[-1]
        assert idx == 5
        assert px[2] > 180 and px[1] < 40      # red, BGRA order

        presented.clear()
        engine.set_video_source(green)
        engine.display_frame(2)
        deadline = time.time() + 10
        while not presented and time.time() < deadline:
            time.sleep(0.02)
        idx, px = presented[-1]
        assert idx == 2
        assert px[1] > 180 and px[2] < 40      # green now
    finally:
        engine.stop()


def test_playback_viewport_fetch():
    """set_viewport: display frames resample on device to the widget
    size before the u8 conversion, so presented buffers are
    viewport-sized (widget_gl soft mode paints at widget size,
    widget_gl.c:793-816; round-3 verdict item 2 applied to playback)."""
    from canvas_tpu.playback import VideoPlaybackEngine

    presented = []
    src = SolidColorVideoSource((0.25, 0.5, 0.75, 1.0))
    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        src, clock, Fraction(24), box2i(0, 0, 639, 479),
        lambda idx, bgra: presented.append((idx, bgra)))
    try:
        engine.set_viewport((160, 120))
        engine.display_frame(3)
        assert presented
        _, bgra = presented[-1]
        assert bgra.shape == (120, 160, 4)
        # constant-color frame: the downscale preserves the color and
        # the conversion matches the widget ramp at the center
        from canvas_tpu.ops import color as color_ops
        lin = np.zeros((4, 1, 1), np.float16)
        lin[0] = 0.25; lin[1] = 0.5; lin[2] = 0.75; lin[3] = 1.0
        want = color_ops.apply_display_u8(lin, 1.25)
        got = bgra[60, 80]
        assert abs(int(got[2]) - int(want[0, 0, 0])) <= 1
        assert abs(int(got[1]) - int(want[1, 0, 0])) <= 1
        assert abs(int(got[0]) - int(want[2, 0, 0])) <= 1

        # back to full size
        presented.clear()
        engine.set_viewport(None)
        engine.display_frame(4)
        assert presented[-1][1].shape == (480, 640, 4)
    finally:
        engine.stop()


def test_playback_replay_uses_persistent_cache():
    """The engine holds ONE planner per (source, window): a replayed
    range (loop/scrub-over) renders from the persistent device staging
    cache with zero re-pulls of the source."""
    from canvas_tpu.frames import VideoSource
    from canvas_tpu.playback import VideoPlaybackEngine

    pulls = []

    class Counting(VideoSource):
        def _render_f16(self, frame_index, frame):
            pulls.append(frame_index)
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[1] = 0.5
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    src = Counting()
    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        src, clock, Fraction(24), box2i(0, 0, 255, 143),
        lambda idx, bgra: None)
    try:
        engine.display_frame(2)
        n1 = len(pulls)
        assert n1 > 0
        # invalidate the u8 ring only (seek does this); the staged
        # device data must survive and replay without re-pulling
        with engine._lock:
            engine._cache.clear()
        engine.display_frame(2)
        assert len(pulls) == n1
    finally:
        engine.stop()


def test_playback_engine_stop_race_with_display_frame():
    """stop() racing concurrent display_frame callers never resurrects
    a planner after teardown and never deadlocks (round-3 review:
    _render_batch checks _quit under the render lock)."""
    import threading

    from canvas_tpu.playback import VideoPlaybackEngine

    for _round in range(3):
        src = SolidColorVideoSource((0.5, 0.2, 0.8, 1.0))
        clock = SystemPresentationClock()
        engine = VideoPlaybackEngine(
            src, clock, Fraction(24), box2i(0, 0, 63, 47),
            lambda idx, bgra: None)

        stop_now = threading.Event()

        def scrubber():
            i = 0
            while not stop_now.is_set():
                try:
                    engine.display_frame(i % 8)
                except Exception:
                    pass
                i += 1

        t = threading.Thread(target=scrubber, daemon=True)
        t.start()
        engine.display_frame(0)      # ensure a planner exists
        engine.stop()
        stop_now.set()
        t.join(timeout=5)
        assert not t.is_alive()
        # a post-stop render refuses to resurrect a planner
        engine._render_batch(0, 1)
        assert engine._planner is None


def test_playback_engine_quality_hint():
    """set_quality: scrub-quality previews render degraded (different
    pixels on a minifying scaler) and restore exactly at quality 10."""
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.playback import VideoPlaybackEngine
    from canvas_tpu.sources import VideoScaler

    base = SolidColorVideoSource(
        LerpFunc((0.8, 0.3, 0.2, 1.0), (0.2, 0.7, 0.9, 1.0), 32),
        window=box2i(0, 0, 127, 95))
    sc = VideoScaler(
        base,
        target_point=LerpFunc((4, 2), (10, 8), 32),
        source_point=(0.0, 0.0),
        scale_factors=LerpFunc((0.4, 0.4), (0.45, 0.5), 32),
        source_rect=box2i(0, 0, 127, 95))

    presented = {}
    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        sc, clock, Fraction(24), box2i(0, 0, 63, 63),
        lambda idx, bgra: presented.__setitem__(idx, bgra.copy()))
    try:
        engine.display_frame(3)
        full = presented.pop(3)

        engine.set_quality(4)
        engine.display_frame(3)
        fast = presented.pop(3)
        assert not np.array_equal(full, fast)    # degraded differs
        # ...but stays a recognizable preview: the lossy 4:2:0 packed
        # transport + bilinear taps land within a few u8 steps on the
        # interior of a solid region
        diff = np.abs(fast[20:40, 20:40, :3].astype(np.int32)
                      - full[20:40, 20:40, :3].astype(np.int32))
        assert diff.max() <= 4, diff.max()

        engine.set_quality(10)
        engine.display_frame(3)
        restored = presented.pop(3)
        np.testing.assert_array_equal(full, restored)
    finally:
        engine.stop()


def test_playback_stall_watchdog(monkeypatch):
    """A render batch exceeding stall_timeout fires on_stall(True) once
    and on_stall(False) when progress resumes (the device-transport
    stall alert — a hung device call blocks the render thread in native
    code, so the app must learn about it from a watchdog)."""
    import threading

    from canvas_tpu.playback import VideoPlaybackEngine

    monkeypatch.setenv('CANVAS_STALL_TIMEOUT', '0.2')
    events = []
    clock = SystemPresentationClock()
    src = SolidColorVideoSource((1.0, 0.0, 0.0, 1.0))
    engine = VideoPlaybackEngine(
        src, clock, Fraction(30, 1), box2i(0, 0, 15, 15),
        lambda i, f: None, on_stall=events.append)
    try:
        assert engine.stall_timeout == 0.2
        release = threading.Event()
        orig = engine._render_batch_inner

        def blocked(start, stop):
            release.wait(5.0)
            return orig(start, stop)

        engine._render_batch_inner = blocked
        clock.play(1)
        deadline = time.time() + 5.0
        while True not in events and time.time() < deadline:
            time.sleep(0.02)
        assert events == [True]
        assert engine.stalled
        release.set()
        engine._render_batch_inner = orig
        deadline = time.time() + 5.0
        while False not in events and time.time() < deadline:
            time.sleep(0.02)
        clock.stop()
        assert events == [True, False]
        assert not engine.stalled
    finally:
        engine.stop()


def test_mainwindow_playback_stall_alert():
    """MainWindow surfaces engine stalls in the alert dock and clears
    them on recovery."""
    import fake_qt
    from canvas_tpu.editor import plugins as plugins_mod
    from canvas_tpu.editor.ui import mainwindow as mw_mod
    from canvas_tpu.editor.ui import qt as qt_mod
    from canvas_tpu.editor.ui.app import EditorApp

    old = qt_mod._qt
    fake_qt.install(qt_mod)
    try:
        app = EditorApp(load_plugins=False)
        window = mw_mod.create_main_window(app)
        try:
            manager = plugins_mod.PluginManager.alert_manager
            window._playback_stall(True)
            assert any(getattr(a, 'key', None) == 'playback-stall'
                       for a in manager._alerts.values()) or \
                'playback-stall' in manager._alerts
            window._playback_stall(False)
            assert 'playback-stall' not in manager._alerts
        finally:
            window.closeEvent(None)
    finally:
        qt_mod._qt = old


def test_reverse_eviction_keeps_upcoming_frames():
    """Ring eviction is direction-aware: in reverse playback the
    HIGHEST (already-played) indices evict, never the lower batch just
    rendered ahead of the playhead — the old lowest-first rule evicted
    each reverse batch immediately after rendering it (permanent
    livelock once the cache passed 2x ring_frames)."""
    from canvas_tpu.playback import VideoPlaybackEngine
    from canvas_tpu.sources import SolidColorVideoSource

    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        SolidColorVideoSource((0.5, 0.2, 0.1, 1.0)), clock,
        Fraction(10, 1), box2i(0, 0, 63, 47),
        lambda idx, bgra: None, batch=4, ring_frames=4)
    try:
        engine._play_dir = -1
        for hi in range(100, 80, -4):         # 100..84 descending batches
            engine._render_batch(hi - 3, hi + 1)
        cached = sorted(engine._cache)
        # the most recent (lowest) reverse batch SURVIVES (the old
        # lowest-first eviction deleted it -> livelock) and eviction
        # trimmed from the HIGH end (frame 100 gone)
        assert {81, 82, 83, 84} <= set(cached), cached
        assert 100 not in cached, cached
        assert len(cached) <= engine.ring_frames * 2

        # forward direction still evicts from the LOW end
        engine._play_dir = 1
        with engine._lock:
            engine._cache.clear()
        for lo in range(0, 20, 4):
            engine._render_batch(lo, lo + 4)
        cached = sorted(engine._cache)
        # the most recent (highest) forward batch survives; low end
        # evicted
        assert {16, 17, 18, 19} <= set(cached), cached
        assert 0 not in cached, cached
        assert len(cached) <= engine.ring_frames * 2
    finally:
        engine.stop()


def test_pull_queue_custom_dispatch_and_failure_delivers_none():
    """Custom *dispatch* marshals callbacks wherever the app wants
    (VideoPullQueue.c:72-97 marshals onto the GLib loop), and a source
    that raises still delivers frame=None so the UI never waits forever."""
    pending = []
    queue = VideoPullQueue(dispatch=pending.append)
    try:
        results = []

        class BoomSource:
            def get_frame_f16(self, frame_index, window):
                raise RuntimeError('decode exploded')

        queue.enqueue(BoomSource(), 3, box2i(0, 0, 3, 3),
                      lambda idx, frame, data: results.append((idx, frame,
                                                               data)),
                      data='d')
        deadline = time.time() + 5
        while not pending and time.time() < deadline:
            time.sleep(0.01)
        assert pending and not results   # marshalled, not yet run
        for fn in pending:
            fn()
        assert results == [(3, None, 'd')]
    finally:
        queue.close()


def test_pull_queue_join_drains_workers():
    queue = VideoPullQueue()
    try:
        results = []
        src = SolidColorVideoSource((0, 1, 0, 1))
        for i in range(3):
            queue.enqueue(src, i, box2i(0, 0, 3, 3),
                          lambda idx, frame, data: results.append(idx))
        queue.join(timeout=5)
        assert sorted(results) == [0, 1, 2]
        # the pool is rebuilt: the queue still works after join()
        queue.enqueue(src, 9, box2i(0, 0, 3, 3),
                      lambda idx, frame, data: results.append(idx))
        deadline = time.time() + 5
        while len(results) < 4 and time.time() < deadline:
            time.sleep(0.01)
        assert 9 in results
    finally:
        queue.close()


def test_pull_queue_closed_rejects_enqueue():
    queue = VideoPullQueue()
    queue.close()
    with pytest.raises(RuntimeError):
        queue.enqueue(SolidColorVideoSource((1, 1, 1, 1)), 0,
                      box2i(0, 0, 3, 3), lambda *a: None)


def test_pull_queue_planned_path_matches_eager(jax_backend):
    """Plannable sources pull through the batched planner inside the
    queue (pullqueue._render); the delivered frame must match the eager
    pull bit-for-bit, including subrect and empty current_windows."""
    from canvas_tpu.sources import VideoWorkspace

    ws = VideoWorkspace()
    solid = SolidColorVideoSource((0.25, 0.5, 0.75, 1.0),
                                  window=box2i(1, 1, 2, 2))
    ws.add(source=solid, x=0, length=4)
    window = box2i(0, 0, 3, 3)
    queue = VideoPullQueue()
    try:
        results = {}
        for i in (0, 2, 10):
            queue.enqueue(ws, i, window,
                          lambda idx, frame, data: results.__setitem__(
                              idx, frame))
        deadline = time.time() + 20
        while len(results) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert sorted(results) == [0, 2, 10]
        # the planner branch actually ran (not the eager fallback)
        assert len(queue._planners) == 1
        for i in (0, 2):
            eager = ws.get_frame_f16(i, window)
            got = results[i]
            assert got.current_window == eager.current_window
            np.testing.assert_array_equal(np.asarray(got.data),
                                          np.asarray(eager.data))
        # frame past the clip: empty window, no pixels
        empty = results[10]
        assert empty.pixel(1, 1) is None
        ew = empty.current_window
        assert ew.max.x < ew.min.x or ew.max.y < ew.min.y
    finally:
        queue.close()


def test_pull_queue_planner_lru_eviction(jax_backend):
    """The per-(source, window) planner cache is a bounded LRU; evicted
    planners are close()d for deterministic device-cache teardown."""
    import threading
    from unittest import mock

    from canvas_tpu import render
    from canvas_tpu.sources import VideoPassThroughFilter

    queue = VideoPullQueue(planner_cache=2)
    try:
        sources = [
            VideoPassThroughFilter(SolidColorVideoSource((i / 8, 0, 0, 1)))
            for i in range(5)
        ]
        orig_close = render.RenderPlanner.close
        with mock.patch.object(render.RenderPlanner, 'close',
                               autospec=True,
                               side_effect=orig_close) as closes:
            for src in sources:
                done = threading.Event()
                queue.enqueue(src, 0, box2i(0, 0, 3, 3),
                              lambda idx, frame, data: done.set())
                assert done.wait(20)
            assert len(queue._planners) <= 3
            assert closes.call_count >= 2
    finally:
        queue.close()


def test_time_get_frame_planner_and_eager(jax_backend):
    """process.time_get_frame (src/process/main.c:120-167): both the
    batched-planner branch and force_eager return elapsed ns > 0."""
    from canvas_tpu.process import time_get_frame
    from canvas_tpu.sources import VideoWorkspace

    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((1, 0, 0, 1)), x=0, length=4)
    window = box2i(0, 0, 15, 15)
    assert time_get_frame(ws, 0, 3, window) > 0
    assert time_get_frame(ws, 0, 3, window, force_eager=True) > 0


def test_playback_viewport_numpy_path(numpy_backend):
    """Viewport downscale on the HOST path (planner returned numpy):
    presented frames are viewport-sized (playback._render_batch_inner
    host einsum branch)."""
    from canvas_tpu.playback import VideoPlaybackEngine

    presented = []
    src = SolidColorVideoSource((0.2, 0.4, 0.6, 1.0))
    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        src, clock, Fraction(100, 1), box2i(0, 0, 15, 15),
        lambda idx, bgra: presented.append(bgra))
    try:
        engine.set_viewport((8, 6))
        clock.play(1)
        deadline = time.time() + 15
        while (not any(f.shape == (6, 8, 4) for f in presented)
               and time.time() < deadline):
            time.sleep(0.02)
        clock.stop()
        # The render thread presents the paused frame as soon as it
        # starts, which can land before set_viewport; from the first
        # viewport-sized frame on, every frame is viewport-sized.
        shapes = [f.shape for f in presented]
        assert (6, 8, 4) in shapes
        first = shapes.index((6, 8, 4))
        assert set(shapes[first:]) == {(6, 8, 4)}
        assert set(shapes[:first]) <= {(16, 16, 4)}
    finally:
        engine.stop()


def test_playback_viewport_reclamps_on_display_window_change():
    from canvas_tpu.playback import VideoPlaybackEngine

    src = SolidColorVideoSource((1, 1, 1, 1))
    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        src, clock, Fraction(30, 1), box2i(0, 0, 15, 15),
        lambda idx, bgra: None)
    try:
        engine.set_viewport((8, 8))
        assert engine._viewport == (8, 8)
        # shrink one axis below the viewport: clamp
        engine.set_display_window(box2i(0, 0, 5, 15))
        assert engine._viewport == (6, 8)
        # shrink to exactly the viewport: full-size, viewport drops
        engine.set_display_window(box2i(0, 0, 5, 7))
        assert engine._viewport is None
    finally:
        engine.stop()


def test_playback_source_swap_rewires_frames_updated():
    """set_video_source disconnects the old source's frames_updated and
    follows the new one (widget_gl_set_video_source role + live-edit
    invalidation)."""
    from canvas_tpu.playback import VideoPlaybackEngine
    from canvas_tpu.signal import Signal

    class SignalledSolid(SolidColorVideoSource):
        def __init__(self, color):
            SolidColorVideoSource.__init__(self, color)
            self.frames_updated = Signal()

    src1 = SignalledSolid((1, 0, 0, 1))
    src2 = SignalledSolid((0, 1, 0, 1))
    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        src1, clock, Fraction(30, 1), box2i(0, 0, 15, 15),
        lambda idx, bgra: None)
    try:
        with engine._lock:
            engine._cache[7] = 'sentinel'
        src1.frames_updated(None, None)
        assert 7 not in engine._cache

        engine.set_video_source(src2)
        with engine._lock:
            engine._cache[9] = 'sentinel'
        src1.frames_updated(None, None)   # old source: disconnected
        assert 9 in engine._cache
        src2.frames_updated(5, 12)        # new source: ranged clear
        assert 9 not in engine._cache
    finally:
        engine.stop()
