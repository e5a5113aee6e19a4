"""Batched device render path vs the per-frame pull path.

The pull path (canvas_tpu.sources) is the behavioral reference; the
batched planner (canvas_tpu.render) must produce the same f16 frames for
every graph it can trace.
"""

import numpy as np
import pytest

from canvas_tpu import render
from canvas_tpu.basetypes import box2i
from canvas_tpu.framefuncs import LerpFunc, LinearFrameFunc
from canvas_tpu.sources import (EmptyVideoSource, SolidColorVideoSource,
                                VideoGainOffsetFilter, VideoMixFilter,
                                VideoPassThroughFilter, VideoScaler,
                                VideoSequence, VideoColorTransferFilter,
                                VideoWorkspace)

WINDOW = box2i(0, 0, 31, 31)


def pull_frames(source, window, start, stop):
    out = []
    wins = []
    for i in range(start, stop):
        frame = source.get_frame_f16(i, window)
        out.append(np.asarray(frame.data, np.float16))
        wins.append(frame.current_window)
    return np.stack(out), wins


def assert_matches_pull(source, window=WINDOW, start=0, stop=4,
                        atol=2e-3):
    want, _ = pull_frames(source, window, start, stop)
    got = render.render_frames(source, window, start, stop)
    assert got.shape == want.shape
    assert got.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=atol)


def test_solid_animated():
    src = SolidColorVideoSource(
        LerpFunc((1, 0, 0, 1), (0, 1, 0, 0.5), 10),
        window=box2i(2, 3, 20, 25))
    assert_matches_pull(src)


def test_empty():
    got = render.render_frames(EmptyVideoSource(), WINDOW, 0, 3)
    assert got.shape == (3, 4, 32, 32)
    assert np.all(got == 0)


def test_pass_through_offset():
    src = VideoPassThroughFilter(
        SolidColorVideoSource(LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 10)),
        offset=3)
    assert_matches_pull(src)


def test_pass_through_range_cuts():
    src = VideoPassThroughFilter(
        SolidColorVideoSource((1, 0, 0, 1)), start_frame=2, end_frame=5)
    assert_matches_pull(src, start=0, stop=8)


def test_mix_crossfade():
    a = SolidColorVideoSource((1, 0, 0, 1))
    b = SolidColorVideoSource((0, 0, 1, 1))
    mix = VideoMixFilter(a, b, LerpFunc((0,), (1,), 8))
    assert_matches_pull(mix, start=0, stop=8)


def test_gain_offset():
    src = VideoGainOffsetFilter(
        SolidColorVideoSource((0.5, 0.5, 0.5, 1.0), window=box2i(4, 4, 12, 12)),
        gain=LinearFrameFunc(0.1, 1.0), offset=0.125)
    assert_matches_pull(src)


def test_sequence_segments():
    seq = VideoSequence([
        (SolidColorVideoSource((1, 0, 0, 1)), 0, 3),
        (SolidColorVideoSource((0, 1, 0, 1)), 5, 4),
    ])
    assert_matches_pull(seq, start=0, stop=9)


def test_workspace_layers():
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((1, 0, 0, 1)), x=0, length=10, z=0)
    ws.add(source=SolidColorVideoSource((0, 0, 1, 0.5),
                                        window=box2i(8, 8, 24, 24)),
           x=2, length=6, z=1)
    assert_matches_pull(ws, start=0, stop=10)


def test_workspace_offsets_and_z():
    ws = VideoWorkspace()
    anim = SolidColorVideoSource(LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 20))
    ws.add(source=anim, x=0, length=20, offset=7, z=0)
    ws.add(source=SolidColorVideoSource((1, 1, 0, 0.25)), x=5, length=5, z=-1)
    assert_matches_pull(ws, start=0, stop=12)


def test_scaler_constant():
    solid = SolidColorVideoSource((0.8, 0.2, 0.1, 1.0),
                                  window=box2i(0, 0, 7, 7))
    sc = VideoScaler(solid, (0.0, 0.0), (0.0, 0.0), (2.0, 2.0),
                     box2i(0, 0, 7, 7))
    assert_matches_pull(sc)


def test_scaler_animated():
    solid = SolidColorVideoSource((0.5, 0.5, 0.5, 1.0),
                                  window=box2i(0, 0, 15, 15))
    sc = VideoScaler(solid, (0.0, 0.0), (0.0, 0.0),
                     LerpFunc((1.0, 1.0), (2.0, 2.0), 8),
                     box2i(0, 0, 15, 15))
    assert_matches_pull(sc, start=0, stop=4, atol=4e-3)


def _plan_ops(source, window, frames=4):
    """Set of node ops in the batched plan of *source*."""
    planner = render.RenderPlanner(source, window)
    ctx = render.PlanContext(planner, np.arange(frames), window)
    planner._stage_cache = {}
    planner._frame_hints = {}
    ops = set()

    def walk(node):
        ops.add(node.op)
        for c in node.children:
            walk(c)

    walk(ctx.plan(source))
    planner.close()
    return ops


def test_scaled_solid_factored():
    """Scaling a solid-color layer plans as the factored outer-product
    node (rank-1 strength reduction), not the einsum pair — and still
    matches the pull path. Static taps, animated taps, and a
    gain/offset-wrapped solid all factor; scaling non-solid content
    must keep the contraction nodes."""
    from canvas_tpu.sources import VideoGainOffsetFilter, VideoScaler

    window = box2i(0, 0, 63, 63)
    solid = SolidColorVideoSource(
        LerpFunc((0.8, 0.3, 0.2, 0.9), (0.2, 0.7, 0.9, 0.5), 16),
        window=box2i(0, 0, 30, 22))

    static_sc = VideoScaler(solid, (2.0, 3.0), (0.0, 0.0), (1.7, 1.3),
                            box2i(0, 0, 30, 22))
    assert 'scale_solid' in _plan_ops(static_sc, window)
    assert_matches_pull(static_sc, window=window, start=0, stop=4)

    anim_sc = VideoScaler(solid,
                          target_point=LerpFunc((2, 2), (20, 16), 16),
                          source_point=(0.0, 0.0),
                          scale_factors=LerpFunc((0.6, 0.8), (1.9, 1.4), 16),
                          source_rect=box2i(0, 0, 30, 22))
    assert 'scale_solid_dyn' in _plan_ops(anim_sc, window)
    assert_matches_pull(anim_sc, window=window, start=0, stop=6, atol=4e-3)

    gained = VideoScaler(
        VideoGainOffsetFilter(solid, gain=LerpFunc((0.5,), (1.5,), 16),
                              offset=0.05),
        target_point=LerpFunc((2, 2), (10, 8), 16),
        source_point=(0.0, 0.0),
        scale_factors=LerpFunc((1.0, 1.0), (1.5, 1.5), 16),
        source_rect=box2i(0, 0, 30, 22))
    assert 'scale_solid_dyn' in _plan_ops(gained, window)
    assert_matches_pull(gained, window=window, start=0, stop=6, atol=4e-3)

    # non-rank-1 child (two offset solids composited): must NOT factor
    inner = VideoWorkspace()
    inner.add(source=SolidColorVideoSource((1, 0, 0, 1),
                                           window=box2i(0, 0, 20, 14)),
              x=0, length=16, z=0)
    inner.add(source=SolidColorVideoSource((0, 0, 1, 0.5),
                                           window=box2i(8, 6, 30, 22)),
              x=0, length=16, z=1)
    mixed = VideoScaler(inner, (0.0, 0.0), (0.0, 0.0), (1.5, 1.5),
                        box2i(0, 0, 30, 22))
    ops = _plan_ops(mixed, window)
    assert 'scale_solid' not in ops and 'scale_solid_dyn' not in ops
    assert ops & {'scale', 'scale_taps_dyn'}
    assert_matches_pull(mixed, window=window, start=0, stop=4)


def test_quality_hint_nonsolid_scaler_keeps_taps_dyn():
    """quality <= 5 on a NON-rank-1 scaler child still plans the
    contraction node with the lq flag (the factored scale_solid path
    must not swallow the einsum lq coverage)."""
    from canvas_tpu.sources import VideoScaler, VideoWorkspace

    window = box2i(0, 0, 63, 63)
    inner = VideoWorkspace()
    inner.add(source=SolidColorVideoSource((0.9, 0.2, 0.1, 1.0),
                                           window=box2i(0, 0, 20, 14)),
              x=0, length=16, z=0)
    inner.add(source=SolidColorVideoSource((0.1, 0.2, 0.9, 0.5),
                                           window=box2i(8, 6, 30, 22)),
              x=0, length=16, z=1)
    sc = VideoScaler(inner,
                     target_point=LerpFunc((2, 2), (10, 8), 16),
                     source_point=(0.0, 0.0),
                     scale_factors=LerpFunc((0.5, 0.5), (0.6, 0.7), 16),
                     source_rect=box2i(0, 0, 30, 22))

    planner = render.RenderPlanner(sc, window, quality=4)
    ctx = render.PlanContext(planner, np.arange(4), window)
    planner._stage_cache = {}
    planner._frame_hints = {}
    node = ctx.plan(sc)
    ops = {}

    def walk(n):
        ops[n.op] = n
        for c in n.children:
            walk(c)

    walk(node)
    assert 'scale_taps_dyn' in ops
    assert ops['scale_taps_dyn'].static[4]          # lq flag
    lo = planner.render(0, 4).astype(np.float32)
    planner.close()

    hi_planner = render.RenderPlanner(sc, window)
    hi = hi_planner.render(0, 4).astype(np.float32)
    hi_planner.close()
    # cheaper filtering differs but approximates the exact result
    assert not np.array_equal(hi, lo)
    assert np.abs(hi - lo).mean() < 0.02


def test_transfer_filter():
    src = VideoColorTransferFilter(
        SolidColorVideoSource((0.25, 0.5, 0.75, 1.0)), 'linear_to_rec709')
    assert_matches_pull(src)


def test_transfer_matrix_filter():
    src = VideoColorTransferFilter(
        SolidColorVideoSource((0.25, 0.5, 0.75, 1.0)), 'xyz_to_srgb')
    assert_matches_pull(src)


def test_stage_fallback():
    """A source without emit() gets host-staged but still renders."""

    class Custom(SolidColorVideoSource.__mro__[1]):  # plain VideoSource
        def _render_f16(self, frame_index, frame):
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[0] = frame_index * 0.01
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    assert_matches_pull(Custom())


def test_dv_recon_batched():
    from canvas_tpu.coded import (CodedImage, CodedImageSource,
                                  DVReconstructionFilter)

    class Source(CodedImageSource):
        def get_frame(self, frame_index, quality=0):
            rng = np.random.RandomState(frame_index)
            return CodedImage([
                rng.randint(16, 236, (480, 720)).astype(np.uint8),
                rng.randint(16, 241, (480, 180)).astype(np.uint8),
                rng.randint(16, 241, (480, 180)).astype(np.uint8)])

    filt = DVReconstructionFilter(Source())
    window = box2i(0, -1, 719, 478)
    want, _ = pull_frames(filt, window, 0, 2)
    got = render.render_frames(filt, window, 0, 2)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=1e-2)
    exact = np.mean(got.view(np.uint16) == want.view(np.uint16))
    assert exact > 0.99


def test_program_cache_reuse():
    """Same structure, different params -> same compiled program."""
    render._program_cache.clear()
    a = SolidColorVideoSource((1, 0, 0, 1))
    render.render_frames(a, WINDOW, 0, 4)
    n = len(render._program_cache)
    b = SolidColorVideoSource((0, 1, 0, 0.5))
    render.render_frames(b, WINDOW, 4, 8)
    assert len(render._program_cache) == n


def test_render_sharded_matches():
    from canvas_tpu import backend
    jax = backend.jax
    if len(jax.devices()) < 2:
        pytest.skip('needs multiple devices')
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource(
        LerpFunc((1, 0, 0, 1), (0, 1, 0, 1), 16)), x=0, length=16, z=0)
    ws.add(source=SolidColorVideoSource((0, 0, 1, 0.5),
                                        window=box2i(4, 4, 20, 20)),
           x=0, length=16, z=1)
    want, _ = pull_frames(ws, WINDOW, 0, 16)
    got = render.render_sharded(ws, WINDOW, 0, 16)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=2e-3)


def test_pulldown_batched_matches_pull():
    """Pulldown removal renders batched, mixing solid and interleaved
    cadence frames in one program."""
    from canvas_tpu.coded import Pulldown23RemovalFilter

    src = SolidColorVideoSource(LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 40))
    filt = Pulldown23RemovalFilter(src, 2)
    window = box2i(0, 0, 15, 15)
    want, _ = pull_frames(filt, window, 0, 12)
    got = render.render_frames(filt, window, 0, 12)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=2e-3)


def test_pulldown_over_scaler_matches_pull():
    """Pulldown of an ANIMATED SCALER: the eager path pulls frame b
    inside a temp frame whose full_window is frame a's current_window
    (Pulldown23RemovalFilter.c:91-96), and the scaler drops taps
    outside its pulled fetch rect WITHOUT renormalizing
    (video_scale.c:103-110, :299-307) — so b's pixel values near its
    window edges depend on a's window. The planner models this via
    per-frame semantic pull windows (PlanContext.sem_windows); without
    them, mixed frames diverged up to ~0.1 at b's clipped edges
    (round-3 fuzz find, seed 1034 frame 11)."""
    from canvas_tpu.coded import Pulldown23RemovalFilter
    from canvas_tpu.framefuncs import ConstFrameFunc
    from canvas_tpu.sources import VideoScaler

    # The exact fuzz-found geometry (seed 1034): frame b's window
    # extends one row past frame a's, and the scaler's fetch-edge tap
    # renormalization makes b's clipped-pull values differ by ~0.09.
    solid = SolidColorVideoSource((0.2, 0.9, 0.4, 1.0))
    scaler = VideoScaler(
        solid,
        target_point=LerpFunc((95.0, 8.0), (83.0, 61.0), 64),
        source_point=ConstFrameFunc((0.0, 0.0)),
        scale_factors=LerpFunc((1.19501412, 0.72751164),
                               (0.59656811, 1.02176046), 64),
        source_rect=ConstFrameFunc((3.0, 1.0, 9.0, 12.0)))
    big = box2i(0, 0, 191, 143)
    filt = Pulldown23RemovalFilter(scaler, 2)
    want, _ = pull_frames(filt, big, 8, 20)
    got = render.render_frames(filt, big, 8, 20)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=8e-3)


def test_render_sharded_spatial_axis_smoke():
    """Frames x rows 2-D sharding on the virtual mesh."""
    from canvas_tpu import backend
    jax = backend.jax
    if len(jax.devices()) < 4:
        pytest.skip('needs >= 4 devices')
    import numpy as onp
    from jax.sharding import Mesh

    devices = onp.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, ('frames', 'space'))

    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource(
        LerpFunc((1, 0, 0, 1), (0, 1, 0, 1), 8)), x=0, length=8, z=0)
    want, _ = pull_frames(ws, WINDOW, 0, 8)
    got = render.render_sharded(ws, WINDOW, 0, 8, mesh=mesh,
                                spatial_axis='space')
    np.testing.assert_allclose(np.asarray(got).astype(np.float32),
                               want.astype(np.float32), atol=2e-3)

    # frame count NOT divisible by the frames axis: the spatial reshard
    # pads with repeat-last and slices back (round-3 review regression)
    want5, _ = pull_frames(ws, WINDOW, 0, 5)
    got5 = render.render_sharded(ws, WINDOW, 0, 5, mesh=mesh,
                                 spatial_axis='space')
    assert np.asarray(got5).shape[0] == 5
    np.testing.assert_allclose(np.asarray(got5).astype(np.float32),
                               want5.astype(np.float32), atol=2e-3)


def test_rgba_decoder_source_batched(tmp_path):
    """Generic decoded video renders batched (u8 staging + device
    linearize) and matches the pull path."""
    libav = pytest.importorskip('canvas_tpu.libav')
    if not libav.available():
        pytest.skip('native canvas_av unavailable')
    from canvas_tpu.editor.plugins.libav_plugin import _RgbaDecoderSource

    path = str(tmp_path / 'ramp.avi')
    with libav.AVMuxer(path) as mux:
        v = mux.add_video_stream('mpeg4', (64, 48), 25, bit_rate=800_000)
        mux.start()
        for i in range(8):
            frame = np.zeros((48, 64, 4), np.uint8)
            frame[:, :, 1] = i * 30
            frame[:, :, 3] = 255
            mux.write_video_frame(v, frame)

    src = _RgbaDecoderSource(libav.AVVideoDecoder(path), 64, 48)
    window = box2i(0, 0, 63, 47)
    want, _ = pull_frames(src, window, 0, 8)
    src2 = _RgbaDecoderSource(libav.AVVideoDecoder(path), 64, 48)
    got = render.render_frames(src2, window, 0, 8)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=2e-3)


def test_iter_batches_matches_render(any_backend):
    """Plan-once/execute-many streaming path (RenderPlanner.iter_batches)
    matches per-batch render(), including tail and multi-segment."""
    from canvas_tpu.render import RenderPlanner
    from canvas_tpu.sources import SolidColorVideoSource, VideoWorkspace
    from canvas_tpu.framefuncs import LerpFunc

    window = box2i(0, 0, 159, 119)
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.2, 0.3, 0.4, 1.0)),
           x=0, length=60, z=0)
    ws.add(source=SolidColorVideoSource(
        LerpFunc((1, 0, 0, 0.5), (0, 1, 0, 0.5), 60),
        window=box2i(10, 10, 80, 80)), x=12, length=30, z=1)

    planner = RenderPlanner(ws, window)
    want = planner.render(0, 50)
    chunks = list(planner.iter_batches(0, 50, batch=8, device_out=False))
    got = np.concatenate([np.asarray(o) for (_s, _n, o) in chunks], axis=0)
    np.testing.assert_array_equal(got, want)
    # frame accounting covers the range exactly, in order
    spans = [(s, n) for (s, n, _o) in chunks]
    covered = []
    for s, n in spans:
        covered.extend(range(s, s + n))
    assert covered == list(range(0, 50))


def test_explain_reports_plan_tree():
    """planner.explain() renders the IR tree with ops, shapes, window
    coverage and cache status — and planning through it must not
    disturb a subsequent render (same caches as a real render)."""
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.render import RenderPlanner
    from canvas_tpu.sources import SolidColorVideoSource, VideoWorkspace

    window = box2i(0, 0, 159, 119)
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource(
        LerpFunc((0.2, 0.3, 0.4, 1.0), (0.4, 0.1, 0.2, 1.0), 40)),
        x=0, length=40, z=0)
    ws.add(source=SolidColorVideoSource((1, 0, 0, 0.5),
                                        window=box2i(5, 5, 90, 90)),
           x=10, length=20, z=1)

    planner = RenderPlanner(ws, window)
    text = planner.explain(0, 40)
    assert 'segment [0, 10)' in text
    assert 'solid' in text
    assert 'cover=' in text
    assert 'stage cache:' in text and 'plan cache:' in text

    out = np.asarray(planner.render(12, 13))[0]
    want = np.asarray(ws.get_frame_f16(12, window).data)
    np.testing.assert_array_equal(out, want)


def test_region_sep_flag_recompiles_and_matches(monkeypatch):
    """CANVAS_REGION_SEP (rank-1 region pass, default ON; 0 materializes
    the region layer) must compile a DISTINCT program per flag arm for
    the same signature — the flag is read at trace time, so keying the
    program cache on it is what keeps an A/B flip from replaying the
    other arm's program — and the arms' outputs must match."""
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.render import RenderPlanner
    from canvas_tpu.sources import (SolidColorVideoSource, VideoScaler,
                                    VideoWorkspace)

    window = box2i(0, 0, 639, 383)
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.1, 0.1, 0.12, 1.0)),
           x=0, length=16, z=0)
    solid = SolidColorVideoSource(
        LerpFunc((0.8, 0.3, 0.2, 0.9), (0.2, 0.7, 0.9, 0.5), 16),
        window=box2i(0, 0, 95, 63))
    ws.add(source=VideoScaler(
        solid,
        target_point=LerpFunc((40, 30), (300, 200), 16),
        source_point=(0.0, 0.0),
        scale_factors=LerpFunc((1.0, 1.0), (1.6, 1.6), 16),
        source_rect=box2i(0, 0, 95, 63)), x=0, length=16, z=1)

    # the graph must actually hit the gated branch: a region-placed
    # factored scaled solid
    ops = _plan_ops(ws, window)
    assert 'placed' in ops and ops & {'scale_solid', 'scale_solid_dyn'}

    monkeypatch.setenv('CANVAS_REGION_SEP', '0')
    base = np.asarray(RenderPlanner(ws, window).render(2, 6))

    cache_before = len(render._program_cache)
    monkeypatch.setenv('CANVAS_REGION_SEP', '1')
    fused = np.asarray(RenderPlanner(ws, window).render(2, 6))
    assert len(render._program_cache) > cache_before, \
        'flag flip must not reuse the flag-off program'
    np.testing.assert_allclose(fused.astype(np.float32),
                               base.astype(np.float32), atol=4e-3)


def test_range_invalidation_keeps_untouched_plans():
    """frames_updated(lo, hi) drops only prepared plans whose segment
    touches the range: an edit on one part of the timeline keeps a
    loop/scrub elsewhere replaying with zero planning, and a re-render
    of the edited range reflects the new content."""
    from canvas_tpu.render import RenderPlanner

    window = box2i(0, 0, 159, 119)
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.1, 0.1, 0.1, 1.0)),
           x=0, length=64, z=0)
    red = ws.add(source=SolidColorVideoSource(
        (1, 0, 0, 0.5), window=box2i(5, 5, 90, 90)),
        x=32, length=32, z=1)

    planner = RenderPlanner(ws, window)
    for (_s, _n, o) in planner.iter_batches(0, 64, batch=8):
        np.asarray(o)
    segs = sorted(k[0] for k in planner._plan_cache)
    assert segs == [(0, 32), (32, 64)]

    # edit touches only [32, 64): plan for [0, 32) must survive
    red.update(source=SolidColorVideoSource((0, 1, 0, 0.5),
                                            window=box2i(5, 5, 90, 90)))
    planner.invalidate_display_cache(32, 63)
    assert sorted(k[0] for k in planner._plan_cache) == [(0, 32)]

    got = {s: np.asarray(o) for (s, _n, o) in
           planner.iter_batches(0, 64, batch=8)}
    for i in (0, 40):
        want = np.asarray(ws.get_frame_f16(i, window).data, np.float16)
        np.testing.assert_array_equal(got[(i // 8) * 8][i % 8], want,
                                      err_msg='frame %d' % i)

    # no-range call clears everything
    planner.invalidate_display_cache()
    assert not planner._plan_cache


def test_iter_batches_max_inflight_matches():
    """max_inflight pacing (bounded dispatch queue for big-batch
    streaming) yields byte-identical batches to the unbounded path,
    across a segment boundary and a tail batch."""
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.render import RenderPlanner
    from canvas_tpu.sources import SolidColorVideoSource, VideoWorkspace

    window = box2i(0, 0, 159, 119)
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource(
        LerpFunc((0.2, 0.3, 0.4, 1.0), (0.4, 0.1, 0.2, 1.0), 60)),
        x=0, length=60, z=0)
    ws.add(source=SolidColorVideoSource((1, 0, 0, 0.5),
                                        window=box2i(5, 5, 90, 90)),
           x=20, length=40, z=1)

    planner = RenderPlanner(ws, window)
    planner.plan_cache_segments = 0
    want = [(s, n, np.asarray(o)) for (s, n, o) in
            planner.iter_batches(0, 50, batch=8, device_out=False)]
    # device_out=True: pacing is only active for device-resident
    # consumers (host-out batches block per batch anyway).
    got = [(s, n, np.asarray(o)) for (s, n, o) in
           planner.iter_batches(0, 50, batch=8, max_inflight=2)]
    assert [(s, n) for (s, n, _o) in got] == [(s, n) for (s, n, _o) in want]
    for (_s, _n, a), (_s2, _n2, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_damage_region_layers(any_backend):
    """Layers covering a small part of the frame are planned at their
    union box and composited by placement ('placed' nodes); results
    match the full-frame pull path exactly."""
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.sources import (SolidColorVideoSource, VideoScaler,
                                    VideoWorkspace)

    window = box2i(0, 0, 319, 239)
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.1, 0.1, 0.2, 1.0)),
           x=0, length=64, z=0)
    base = SolidColorVideoSource((0.9, 0.4, 0.1, 0.8),
                                 window=box2i(0, 0, 39, 29))
    sc = VideoScaler(base,
                     target_point=LerpFunc((10, 10), (60, 50), 64),
                     source_point=(0.0, 0.0),
                     scale_factors=LerpFunc((1.0, 1.0), (1.5, 1.5), 64),
                     source_rect=box2i(0, 0, 39, 29))
    ws.add(source=sc, x=0, length=64, z=1)
    # an all-empty layer must simply drop out
    ws.add(source=SolidColorVideoSource((1, 0, 0, 1),
                                        window=box2i(-500, -500, -400, -400)),
           x=0, length=64, z=2)
    assert_matches_pull(ws, window=window, start=0, stop=6)

    # single reduced layer over nothing
    ws2 = VideoWorkspace()
    ws2.add(source=sc, x=0, length=64, z=0)
    assert_matches_pull(ws2, window=window, start=0, stop=4)


def test_damage_region_overhangs_frame_edge(any_backend):
    """A region layer whose tile-quantized box rounds past the frame's
    bottom/right edge stays REGION-PLACED (the kernels clip the partial
    edge blocks; the XLA fallback pads to the 64x128 envelope) instead
    of dropping the whole batch into the full-frame fused chain. The
    placement must still match the pull path exactly."""
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.render import PlanContext, RenderPlanner
    from canvas_tpu.sources import (SolidColorVideoSource, VideoScaler,
                                    VideoWorkspace)

    # 320x240 frame: envelope 384x256, so a layer near the bottom-right
    # corner quantizes past BOTH edges (cols 256..383 > 319,
    # rows 192..255 > 239).
    window = box2i(0, 0, 319, 239)
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.15, 0.1, 0.2, 1.0)),
           x=0, length=16, z=0)
    corner = VideoScaler(
        SolidColorVideoSource((0.9, 0.3, 0.1, 0.7),
                              window=box2i(0, 0, 39, 29)),
        target_point=LerpFunc((270, 205), (290, 215), 16),
        source_point=(0.0, 0.0),
        scale_factors=LerpFunc((1.4, 1.4), (1.6, 1.6), 16),
        source_rect=box2i(0, 0, 39, 29))
    ws.add(source=corner, x=0, length=16, z=1)

    planner = RenderPlanner(ws, window)
    try:
        ctx = PlanContext(planner, np.arange(0, 8), window)
        node = ctx.plan(ws)
        placed = [c for c in node.children if c.op == 'placed']
        assert placed, 'corner layer must stay region-placed'
        h_box, w_box = placed[0].static
        dy0 = int(placed[0].params['dy0'])
        dx0 = int(placed[0].params['dx0'])
        assert dy0 + h_box > 240 or dx0 + w_box > 320, \
            'box should overhang the frame edge in this geometry'
        assert dy0 + h_box <= 256 and dx0 + w_box <= 384, \
            'quantized box must stay within the aligned envelope'
    finally:
        planner.close()

    assert_matches_pull(ws, window=window, start=0, stop=8)


def test_opaque_hint_prunes_hidden_layers(any_backend):
    """Layers below a provably-opaque full-frame layer drop out of the
    batched program (the planner-time form of the reference's opaque
    media hint, docs/sphinx/feature-proposal/hints.rst)."""
    from canvas_tpu.render import PlanContext, RenderPlanner
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.sources import (SolidColorVideoSource, VideoScaler,
                                    VideoWorkspace)

    window = box2i(0, 0, 159, 119)
    ws = VideoWorkspace()
    # Expensive hidden layer (scaler) under an opaque full-frame card
    hidden = VideoScaler(
        SolidColorVideoSource((1, 0, 0, 1), window=box2i(0, 0, 39, 29)),
        target_point=LerpFunc((10, 10), (60, 50), 32),
        source_point=(0.0, 0.0),
        scale_factors=LerpFunc((1.0, 1.0), (1.5, 1.5), 32),
        source_rect=box2i(0, 0, 39, 29))
    ws.add(source=hidden, x=0, length=32, z=0)
    ws.add(source=SolidColorVideoSource((0.2, 0.4, 0.6, 1.0)),
           x=0, length=32, z=1)
    # Partially transparent card on top stays
    ws.add(source=SolidColorVideoSource((1, 1, 1, 0.5),
                                        window=box2i(10, 10, 60, 60)),
           x=0, length=32, z=2)

    planner = RenderPlanner(ws, window)
    planner._stage_cache = {}
    ctx = PlanContext(planner, np.arange(0, 4, dtype=np.int64),
                      planner.window)
    node = ctx.plan(ws)

    def ops_in(n, acc):
        acc.add(n.op)
        for c in n.children:
            ops_in(c, acc)
        return acc

    ops = ops_in(node, set())
    assert 'scale_taps_dyn' not in ops and 'scale' not in ops, ops

    # and the output still matches the pull path
    assert_matches_pull(ws, window=window, start=0, stop=4)


def test_opaque_hint_not_pruned_when_translucent(any_backend):
    from canvas_tpu.render import PlanContext, RenderPlanner
    from canvas_tpu.sources import SolidColorVideoSource, VideoWorkspace

    window = box2i(0, 0, 63, 63)
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((1, 0, 0, 1),
                                        window=box2i(0, 0, 31, 31)),
           x=0, length=8, z=0)
    ws.add(source=SolidColorVideoSource((0, 0, 1, 0.5)), x=0, length=8, z=1)
    assert_matches_pull(ws, window=window, start=0, stop=4)


def test_iter_batches_sharded_matches(jax_backend):
    """Frame-sharded streaming (mesh over the 8 virtual devices) equals
    the unsharded path."""
    import jax
    from jax.sharding import Mesh
    from canvas_tpu.render import RenderPlanner
    from canvas_tpu.sources import SolidColorVideoSource, VideoWorkspace
    from canvas_tpu.framefuncs import LerpFunc

    if len(jax.devices()) < 2:
        pytest.skip('needs multiple devices')
    mesh = Mesh(np.asarray(jax.devices()), ('frames',))

    window = box2i(0, 0, 127, 95)
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.1, 0.2, 0.3, 1.0)),
           x=0, length=64, z=0)
    ws.add(source=SolidColorVideoSource(
        LerpFunc((1, 0, 0, 0.5), (0, 1, 0, 0.5), 64),
        window=box2i(8, 8, 63, 63)), x=0, length=64, z=1)

    planner = RenderPlanner(ws, window)
    want = planner.render(0, 32)
    chunks = list(planner.iter_batches(0, 32, batch=16, device_out=False,
                                       mesh=mesh))
    got = np.concatenate([np.asarray(o) for (_s, _n, o) in chunks], axis=0)
    np.testing.assert_array_equal(got, want)

    # output really is sharded over the frame axis
    (_s, _n, out) = next(iter(planner.iter_batches(0, 16, batch=16,
                                                   mesh=mesh)))
    assert 'frames' in str(out.sharding)


def test_render_sharded_spatial_axis(jax_backend):
    """frames x space mesh: output rows reshard across the space axis
    (the 4K single-frame split; XLA inserts the collective)."""
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < 4:
        pytest.skip('needs 4+ devices')
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, ('frames', 'space'))

    from canvas_tpu.sources import SolidColorVideoSource, VideoWorkspace
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.2, 0.4, 0.6, 1.0)),
           x=0, length=32, z=0)
    window = box2i(0, 0, 127, 63)

    out = render.render_sharded(ws, window, 0, 4, mesh=mesh, axis='frames',
                                device_out=True, spatial_axis='space')
    assert 'space' in str(out.sharding)
    got = np.asarray(out)
    want = render.render_frames(ws, window, 0, 4)
    np.testing.assert_array_equal(got, want)


def test_replicated_param_dim_coincidence():
    """A replicated param whose dim happens to equal the segment length
    must NOT be sliced per-frame (round-1 advisor finding: the frame
    axis was inferred from a shape coincidence). Here the 'scale' op's
    (Ty, Sy) weight matrix has Ty == 24 == the segment length; batching
    at 8 must still yield 24-row frames."""
    window = box2i(0, 0, 31, 23)        # height 24
    solid = SolidColorVideoSource((0.8, 0.2, 0.1, 1.0),
                                  window=box2i(0, 0, 15, 15))
    sc = VideoScaler(solid, (0.0, 0.0), (0.0, 0.0), (1.5, 1.5),
                     box2i(0, 0, 15, 15))
    planner = render.RenderPlanner(sc, window)
    want, _ = pull_frames(sc, window, 0, 24)
    outs = [np.asarray(out)[:n]
            for (_s, n, out) in planner.iter_batches(0, 24, batch=8,
                                                     device_out=False)]
    got = np.concatenate(outs, axis=0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=2e-3)


def test_replicated_matrix_3frame_segment():
    """(3, 3) color matrix over a 3-frame segment stays replicated
    (same advisor finding, matrix flavor; the padded tail batch would
    have gathered rows of the matrix)."""
    src = VideoColorTransferFilter(
        SolidColorVideoSource(LerpFunc((0.5, 0.25, 0.125, 1.0),
                                       (0.1, 0.9, 0.4, 1.0), 3)),
        'rgb_to_xyz_sdtv')
    window = box2i(0, 0, 15, 15)
    planner = render.RenderPlanner(src, window)
    want, _ = pull_frames(src, window, 0, 3)
    outs = [np.asarray(out)[:n]
            for (_s, n, out) in planner.iter_batches(0, 3, batch=2,
                                                     device_out=False)]
    got = np.concatenate(outs, axis=0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=2e-3)


def test_render_display_single_frame():
    """render_display: one fused program -> u8 BGRA display frame that
    matches rendering + gamma45 conversion done separately."""
    from canvas_tpu.ops import color as color_ops

    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.2, 0.4, 0.6, 1.0)),
           x=0, length=8, z=0)
    ws.add(source=SolidColorVideoSource(
        LerpFunc((1.0, 0.2, 0.1, 0.8), (0.0, 0.9, 0.5, 0.3), 8),
        window=box2i(4, 4, 40, 40)), x=0, length=8, z=1)
    window = box2i(0, 0, 63, 63)
    planner = render.RenderPlanner(ws, window)

    bgra = planner.render_display(3)
    assert bgra.shape == (64, 64, 4) and bgra.dtype == np.uint8

    # reference: rendered f16 frame -> direct gamma45 u8 (same formula
    # as the device conversion)
    f16 = planner.render(3, 4)[0].astype(np.float32)
    y = np.power(np.clip(f16, 0, None), 0.45) * 255.0
    want = np.floor(np.clip(np.nan_to_num(y), 0.0, 255.0)).astype(np.uint8)
    for c_dst, c_src in enumerate((2, 1, 0, 3)):
        np.testing.assert_array_equal(bgra[..., c_dst], want[c_src],
                                      err_msg='channel %d' % c_dst)


def test_render_display_yuv420_transport():
    """transport='yuv420' (lossy low-bandwidth scrub fetch): solid
    regions reconstruct within u8 rounding of the BGRA transport, the
    layout/dtype match, and the packed fetch is ~2.6x smaller."""
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.2, 0.4, 0.6, 1.0)),
           x=0, length=8, z=0)
    ws.add(source=SolidColorVideoSource((0.9, 0.1, 0.3, 0.8),
                                        window=box2i(8, 8, 39, 39)),
           x=0, length=8, z=1)
    window = box2i(0, 0, 63, 63)
    planner = render.RenderPlanner(ws, window)

    exact = planner.render_display(3).astype(np.int32)
    lossy = planner.render_display(3, transport='yuv420')
    assert lossy.shape == (64, 64, 4) and lossy.dtype == np.uint8
    assert np.all(lossy[..., 3] == 255)
    # solid interiors (away from the 2x2 chroma blocks straddling the
    # layer edge): within a couple u8 steps of the exact transport
    inner = np.abs(lossy[:6, :6, :3].astype(np.int32) - exact[:6, :6, :3])
    assert inner.max() <= 2, inner.max()
    inner2 = np.abs(lossy[12:36, 12:36, :3].astype(np.int32)
                    - exact[12:36, 12:36, :3])
    assert inner2.max() <= 2, inner2.max()

    # viewport-sized + odd dimensions exercise the padding path
    vp = planner.render_display(3, display_size=(33, 21),
                                transport='yuv420')
    assert vp.shape == (21, 33, 4) and vp.dtype == np.uint8

    # the packed buffer is 1.5 bytes/px vs BGRA's 4
    from canvas_tpu.ops import color as color_ops
    f = planner.render(3, 4, device_out=True)
    packed = color_ops.yuv420_pack_device(f[:1])
    assert packed.dtype == np.uint8
    assert packed.shape[1] == 64 * 64 + 2 * 32 * 32
    assert packed.shape[1] * 1.0 / (64 * 64 * 4) < 0.4
    planner.close()


def test_render_sharded_segment_cuts_and_tail_padding():
    """Sharded export across structure boundaries with non-divisible
    frame counts: every segment renders sharded with repeat-last-frame
    tail padding; device_out works across cuts (VERDICT round-1
    item 8)."""
    from canvas_tpu import backend
    jax = backend.jax
    if len(jax.devices()) < 2:
        pytest.skip('needs multiple devices')

    # Structure changes at frame 10 (an item appears) and 17 (it ends):
    # range [0, 23) crosses two cuts; 23 % 8 != 0, 10 % 8 != 0...
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource(
        LerpFunc((1, 0, 0, 1), (0, 1, 0, 1), 23)), x=0, length=23, z=0)
    ws.add(source=SolidColorVideoSource((0, 0, 1, 0.5),
                                        window=box2i(4, 4, 20, 20)),
           x=10, length=7, z=1)
    want, _ = pull_frames(ws, WINDOW, 0, 23)

    got = render.render_sharded(ws, WINDOW, 0, 23)
    assert got.shape[0] == 23
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=2e-3)

    # device_out across the cuts
    dev = render.render_sharded(ws, WINDOW, 0, 23, device_out=True)
    assert backend.is_jax_array(dev)
    np.testing.assert_allclose(np.asarray(dev).astype(np.float32),
                               want.astype(np.float32), atol=2e-3)


def test_iter_batches_sharded_small_segment(jax_backend):
    """A mesh-sharded segment smaller than the batch (and not divisible
    by the shard count) pads to the shard count and slices back."""
    import jax
    from jax.sharding import Mesh
    from canvas_tpu.render import RenderPlanner

    if len(jax.devices()) < 2:
        pytest.skip('needs multiple devices')
    mesh = Mesh(np.asarray(jax.devices()), ('frames',))

    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource(
        LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 5)), x=0, length=5, z=0)
    want, _ = pull_frames(ws, WINDOW, 0, 5)

    outs = []
    planner = RenderPlanner(ws, WINDOW)
    for (s, n, out) in planner.iter_batches(0, 5, batch=8, mesh=mesh,
                                            device_out=False):
        outs.append(np.asarray(out)[:n])
    got = np.concatenate(outs, axis=0)
    assert got.shape[0] == 5
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=2e-3)


def test_iter_batches_post_u8():
    """post='rgba_u8' fuses the export u8 conversion into the compiled
    program and matches the separate-dispatch conversion exactly."""
    from canvas_tpu.ops import color as color_ops
    from canvas_tpu import backend

    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource(
        LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 12)), x=0, length=12, z=0)
    planner = render.RenderPlanner(ws, WINDOW)

    fused = []
    for (_s, n, u8) in planner.iter_batches(0, 12, batch=4,
                                            post='rgba_u8'):
        fused.append(np.asarray(u8)[:n])
    fused = np.concatenate(fused, axis=0)

    planner2 = render.RenderPlanner(ws, WINDOW)
    separate = []
    with backend.force_backend('jax'):
        for (_s, n, out) in planner2.iter_batches(0, 12, batch=4):
            separate.append(np.asarray(
                color_ops.rgba_u8_device(out))[:n])
    separate = np.concatenate(separate, axis=0)

    assert fused.dtype == np.uint8
    np.testing.assert_array_equal(fused, separate)

    # sharded + post: fused conversion matches too
    import jax
    from jax.sharding import Mesh
    if len(jax.devices()) >= 2:
        mesh = Mesh(np.asarray(jax.devices()), ('frames',))
        planner3 = render.RenderPlanner(ws, WINDOW)
        sharded = []
        for (_s, n, u8) in planner3.iter_batches(0, 8, batch=8,
                                                 mesh=mesh,
                                                 post='rgba_u8'):
            sharded.append(np.asarray(u8)[:n])
        np.testing.assert_array_equal(np.concatenate(sharded, axis=0),
                                      separate[:8])


def test_render_display_scrub_cache():
    """Consecutive render_display calls slice one cached segment plan;
    results equal per-frame pulls, and edits invalidate the cache."""
    ws = VideoWorkspace()
    item = ws.add(source=SolidColorVideoSource(
        LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 128)), x=0, length=128, z=0)
    window = box2i(0, 0, 31, 31)
    planner = render.RenderPlanner(ws, window)

    frames = [planner.render_display(i) for i in (5, 6, 7, 70, 3)]
    # one segment plan for 3..7, another for 70
    for idx, i in enumerate((5, 6, 7, 70, 3)):
        f16 = planner.render(i, i + 1)[0].astype(np.float32)
        y = np.power(np.clip(f16, 0, None), 0.45) * 255.0
        want = np.floor(np.clip(np.nan_to_num(y), 0, 255)).astype(np.uint8)
        np.testing.assert_array_equal(frames[idx][..., 2], want[0],
                                      err_msg='frame %d' % i)

    # the cached plan is reused: planning again must not re-pull staged
    # sources; emulate by checking the cached segment bounds
    seg = planner._display_seg
    assert seg['lo'] <= 3 < seg['hi']

    # invalidation drops the plan
    planner.invalidate_display_cache()
    assert planner._display_seg is None
    bgra = planner.render_display(5)
    np.testing.assert_array_equal(bgra, frames[0])


def test_generic_stage_dedups_pulldown_pulls():
    """The stage fallback (untraceable sources) shares one device frame
    stack per segment, so pulldown's two children pull each unique
    frame ONCE (round-2: matches the coded path's staging)."""
    from canvas_tpu.coded import Pulldown23RemovalFilter
    from canvas_tpu.frames import VideoSource

    pulls = []

    class Custom(VideoSource):
        def _render_f16(self, frame_index, frame):
            pulls.append(frame_index)
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[0] = (frame_index % 11) * 0.05
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    src = Custom()
    filt = Pulldown23RemovalFilter(src, 1)
    window = box2i(0, 0, 31, 31)
    want, _ = pull_frames(filt, window, 0, 8)
    pulls.clear()
    got = render.render_frames(filt, window, 0, 8)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=2e-3)
    assert len(pulls) == len(set(pulls)), pulls


def test_multi_segment_render_stages_each_frame_once():
    """render() resets the staging caches PER SEGMENT: a multi-segment
    range over an untraceable source pulls each frame exactly once and
    never re-ships a cumulative stack (review regression: a
    call-lifetime cache grew O(N^2))."""
    from canvas_tpu.frames import VideoSource

    pulls = []

    class Custom(VideoSource):
        def _render_f16(self, frame_index, frame):
            pulls.append(frame_index)
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[1] = (frame_index % 7) * 0.1
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    src = Custom()
    window = box2i(0, 0, 15, 15)
    planner = render.RenderPlanner(src, window)
    planner.pipeline_chunk = 8           # force several segments
    out = planner.render(0, 20)
    assert out.shape[0] == 20
    assert sorted(pulls) == list(range(20))


def test_planner_close_disconnects_frames_updated():
    """render_display subscribes to the source's frames_updated;
    close() disconnects eagerly (and the Signal holds the planner only
    weakly, so dropped planners never leak — advisor round-2)."""
    import gc

    from canvas_tpu.signal import Signal
    from canvas_tpu.sources import SolidColorVideoSource

    src = SolidColorVideoSource((0.5, 0.25, 0.125, 1.0))
    src.frames_updated = Signal()
    window = box2i(0, 0, 31, 15)

    planner = render.RenderPlanner(src, window)
    planner.render_display(0)
    assert len(src.frames_updated) == 1
    planner.close()
    assert len(src.frames_updated) == 0

    # weakref path: a dropped planner's slot prunes itself
    planner2 = render.RenderPlanner(src, window)
    planner2.render_display(0)
    assert len(src.frames_updated) == 1
    del planner2
    gc.collect()
    src.frames_updated.fire()
    assert len(src.frames_updated) == 0


def test_render_display_viewport_size():
    """render_display(display_size=): device-side linear-light
    downscale to the viewport before the u8 conversion — only viewport
    bytes cross the link (the reference's soft mode paints at widget
    size, widget_gl.c:793-816)."""
    from canvas_tpu.ops import scale as scale_ops

    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.2, 0.4, 0.6, 1.0)),
           x=0, length=8, z=0)
    ws.add(source=SolidColorVideoSource(
        LerpFunc((1.0, 0.2, 0.1, 0.8), (0.0, 0.9, 0.5, 0.3), 8),
        window=box2i(4, 4, 40, 40)), x=0, length=8, z=1)
    window = box2i(0, 0, 63, 63)
    planner = render.RenderPlanner(ws, window)

    bgra = planner.render_display(3, display_size=(32, 16))
    assert bgra.shape == (16, 32, 4) and bgra.dtype == np.uint8

    # reference: host downscale of the f16 frame with the same triangle
    # matrices, then the gamma45 conversion
    f16 = planner.render(3, 4)[0].astype(np.float32)
    Dy, _ = scale_ops.axis_matrix(16 / 64, 0, 15, 0, 63, 0.0, 0.0)
    Dx, _ = scale_ops.axis_matrix(32 / 64, 0, 31, 0, 63, 0.0, 0.0)
    small = np.einsum('yh,chw->cyw', Dy, f16)
    small = np.einsum('xw,cyw->cyx', Dx, small).astype(np.float16)
    y = np.power(np.clip(small.astype(np.float32), 0, None), 0.45) * 255.0
    want = np.floor(np.clip(np.nan_to_num(y), 0.0, 255.0)).astype(np.uint8)
    for c_dst, c_src in enumerate((2, 1, 0, 3)):
        diff = np.abs(bgra[..., c_dst].astype(int) -
                      want[c_src].astype(int))
        assert diff.max() <= 1, 'channel %d' % c_dst

    # full-size path still exact alongside the viewport program
    full = planner.render_display(3)
    assert full.shape == (64, 64, 4)


def test_persistent_cache_replay_zero_h2d():
    """A second pass over an already-rendered range (loop/scrub-over)
    hits the persistent device staging cache: ZERO source pulls and
    ZERO host->device staging bytes (round-3 verdict item 3 — the
    reference keeps recent frames resident in its render-ahead ring,
    widget_gl.c:25,204-230)."""
    from canvas_tpu import backend
    from canvas_tpu.frames import VideoSource

    pulls = []

    class Custom(VideoSource):
        def _render_f16(self, frame_index, frame):
            pulls.append(frame_index)
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[0] = (frame_index % 5) * 0.2
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    src = Custom()
    window = box2i(0, 0, 15, 15)
    planner = render.RenderPlanner(src, window)
    planner.pipeline_chunk = 8
    first = planner.render(0, 20)
    assert sorted(pulls) == list(range(20))

    pulls.clear()
    before = dict(backend.transfer_stats)
    second = planner.render(0, 20)
    assert pulls == []                       # no host decode
    assert backend.transfer_stats == before  # no H2D staging
    np.testing.assert_array_equal(np.asarray(first), np.asarray(second))

    # a partial overlap (scrub window) also reuses the cached segments
    pulls.clear()
    third = planner.render(8, 16)
    assert pulls == []
    np.testing.assert_array_equal(np.asarray(third),
                                  np.asarray(first[8:16]))


def test_persistent_cache_ranged_edit_keeps_untouched_stages():
    """A ranged frames_updated drops only staged stacks that served
    root segments touching the range: editing one part of the timeline
    keeps loops elsewhere at zero-pull/zero-H2D even when plans must
    re-prepare (plan cache disabled here to isolate the stage cache)."""
    from canvas_tpu import backend
    from canvas_tpu.frames import VideoSource

    pulls = []

    class Custom(VideoSource):
        def _render_f16(self, frame_index, frame):
            pulls.append(frame_index)
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[0] = (frame_index % 5) * 0.2
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    src = Custom()
    window = box2i(0, 0, 15, 15)
    planner = render.RenderPlanner(src, window)
    planner.pipeline_chunk = 8
    planner.plan_cache_segments = 0
    planner.render(0, 24)
    assert sorted(pulls) == list(range(24))

    # edit touching only [16, 24): stages serving [0, 16) survive
    pulls.clear()
    planner.invalidate_display_cache(16, 23)
    before = dict(backend.transfer_stats)
    planner.render(0, 16)
    assert pulls == []
    assert backend.transfer_stats == before

    # the edited range re-pulls (its stage entries dropped)
    planner.render(16, 24)
    assert sorted(set(pulls)) == list(range(16, 24))

    # un-ranged invalidation still clears everything
    pulls.clear()
    planner.invalidate_display_cache()
    planner.render(0, 8)
    assert sorted(set(pulls)) == list(range(0, 8))


def test_invalidation_mid_plan_rejects_stale_inserts():
    """An edit that fires WHILE a segment is being planned must not let
    the in-flight plan/stages enter the caches after the invalidation
    ran (they hold pre-edit content the ranged semantics would then
    keep forever)."""
    from canvas_tpu.frames import VideoSource

    pulls = []
    planner_box = []

    class Custom(VideoSource):
        def _render_f16(self, frame_index, frame):
            pulls.append(frame_index)
            if frame_index == 3 and planner_box:
                # edit lands mid-plan, covering this very segment
                planner_box[0].invalidate_display_cache(0, 7)
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[0] = (frame_index % 5) * 0.2
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    planner = render.RenderPlanner(Custom(), box2i(0, 0, 15, 15))
    planner.pipeline_chunk = 8
    planner_box.append(planner)
    planner.render(0, 8)
    assert sorted(pulls) == list(range(8))

    # nothing stale was cached: the replay must re-pull
    pulls.clear()
    planner_box.clear()
    planner.render(0, 8)
    assert sorted(set(pulls)) == list(range(8))
    assert not getattr(planner, '_plan_cache', None)


def test_invalidation_ignores_bool_args():
    """A trailing positional bool in a frames_updated payload must not
    be mistaken for the range's end (bool is an int subclass); the
    range still parses and invalidates correctly."""
    from canvas_tpu.frames import VideoSource

    pulls = []

    class Custom(VideoSource):
        def _render_f16(self, frame_index, frame):
            pulls.append(frame_index)
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    planner = render.RenderPlanner(Custom(), box2i(0, 0, 15, 15))
    planner.pipeline_chunk = 8
    planner.plan_cache_segments = 0
    planner.render(0, 16)
    pulls.clear()
    planner.invalidate_display_cache(0, 7, True)
    planner.render(0, 16)
    assert sorted(set(pulls)) == list(range(0, 8))   # [8,16) stayed cached


def test_concurrent_edit_storm_no_races():
    """Ranged invalidations firing from another thread while streaming
    must not race the prepare worker's cache access (StageLRU lock +
    generation): no exceptions, correct content, sane byte budget."""
    import threading
    import time as time_mod

    from canvas_tpu.frames import VideoSource

    class Custom(VideoSource):
        def _render_f16(self, frame_index, frame):
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[0] = (frame_index % 7) * 0.1
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    planner = render.RenderPlanner(Custom(), box2i(0, 0, 15, 15))
    planner.pipeline_chunk = 8
    stop = threading.Event()
    errs = []

    def editor():
        rng = np.random.RandomState(0)
        while not stop.is_set():
            try:
                planner.invalidate_display_cache(
                    int(rng.randint(0, 60)), int(rng.randint(60, 120)))
            except Exception as e:       # pragma: no cover - the assert
                errs.append(e)
                return
            time_mod.sleep(0.001)

    t = threading.Thread(target=editor)
    t.start()
    try:
        for _rep in range(4):
            for (_s, _n, o) in planner.iter_batches(0, 120, batch=8):
                np.asarray(o)
    finally:
        stop.set()
        t.join()
    assert not errs, errs
    out = np.asarray(planner.render(13, 14))[0]
    want = np.asarray(planner.source.get_frame_f16(
        13, box2i(0, 0, 15, 15)).data)
    np.testing.assert_array_equal(out, want)
    assert planner.persistent_cache.bytes >= 0


def test_persistent_cache_coded_replay_zero_decode():
    """The coded plane-stack staging is persistent too: a replay skips
    both decode and H2D."""
    from canvas_tpu import backend
    from canvas_tpu.coded import (CodedImage, CodedImageSource,
                                  DVReconstructionFilter)

    decodes = []

    class Source(CodedImageSource):
        def get_frame(self, frame_index, quality=0):
            decodes.append(frame_index)
            rng = np.random.RandomState(frame_index)
            return CodedImage([
                rng.randint(16, 236, (480, 720)).astype(np.uint8),
                rng.randint(16, 241, (480, 180)).astype(np.uint8),
                rng.randint(16, 241, (480, 180)).astype(np.uint8)])

    filt = DVReconstructionFilter(Source())
    window = box2i(0, -1, 719, 478)
    planner = render.RenderPlanner(filt, window)
    first = planner.render(0, 6)
    assert sorted(set(decodes)) == list(range(6))

    decodes.clear()
    before = dict(backend.transfer_stats)
    second = planner.render(0, 6)
    assert decodes == []
    assert backend.transfer_stats == before
    np.testing.assert_array_equal(np.asarray(first), np.asarray(second))


def test_persistent_cache_invalidation_and_eviction():
    """frames_updated clears the persistent stage cache (graph edits
    re-stage); the byte budget evicts LRU."""
    from canvas_tpu.frames import VideoSource
    from canvas_tpu.signal import Signal

    pulls = []

    class Custom(VideoSource):
        def _render_f16(self, frame_index, frame):
            pulls.append(frame_index)
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[2] = 0.5
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    src = Custom()
    src.frames_updated = Signal()
    window = box2i(0, 0, 15, 15)
    planner = render.RenderPlanner(src, window)
    planner.render(0, 4)
    pulls.clear()
    src.frames_updated.fire(0, 4)
    planner.render(0, 4)
    assert sorted(pulls) == list(range(4))    # re-staged after the edit

    # eviction: a zero-budget cache holds nothing -> replay re-pulls
    planner2 = render.RenderPlanner(Custom(), window)
    planner2.stage_cache_mb = 0
    planner2.render(0, 4)
    n = len(planner2.persistent_cache)
    assert n == 0


def test_quality_hint_degrades_scaler():
    """quality <= 5 renders scalers with bilinear taps at default matmul
    precision: visibly close to the exact result but with a smaller
    tap count / cheaper contraction (round-3 verdict item 9; the
    reference's 1-11 hint scale, framework.h:510-513 +
    feature-proposal/hints.rst)."""
    from canvas_tpu.sources import VideoScaler

    base = SolidColorVideoSource(
        LerpFunc((0.8, 0.3, 0.2, 1.0), (0.2, 0.7, 0.9, 1.0), 32),
        window=box2i(0, 0, 127, 95))
    sc = VideoScaler(
        base,
        target_point=LerpFunc((4, 2), (10, 8), 32),
        source_point=(0.0, 0.0),
        scale_factors=LerpFunc((0.4, 0.4), (0.45, 0.5), 32),  # minify
        source_rect=box2i(0, 0, 127, 95))
    window = box2i(0, 0, 63, 63)

    hi_planner = render.RenderPlanner(sc, window)           # quality 10
    lo_planner = render.RenderPlanner(sc, window, quality=4)

    hi = hi_planner.render(0, 8).astype(np.float32)
    lo = lo_planner.render(0, 8).astype(np.float32)

    # different (cheaper filtering) but approximate: interiors agree
    # exactly (normalized bilinear of a constant is the constant); only
    # content-edge pixels see the narrower support
    assert not np.array_equal(hi, lo)
    diff = np.abs(hi - lo)
    assert np.quantile(diff, 0.80) < 1e-3, np.quantile(diff, 0.80)
    assert diff.mean() < 0.01

    # the compiled program carries fewer taps: minifying at ~0.4 needs
    # K=6 at full quality, bilinear K=3 at low quality
    def scale_static(planner):
        ctx = render.PlanContext(planner, np.arange(8), planner.window)
        planner._stage_cache = {}
        planner._frame_hints = {}
        node = ctx.plan(sc)
        while node.op not in ('scale_taps_dyn', 'scale_solid_dyn'):
            node = node.children[0]
        return node.static

    hi_static = scale_static(hi_planner)
    lo_static = scale_static(lo_planner)
    assert lo_static[4] is True or lo_static[4] == 1     # lq flag
    assert lo_static[0] < hi_static[0]                   # fewer y taps
    assert lo_static[1] < hi_static[1]                   # fewer x taps

    # set_quality invalidates cached display plans
    hi_planner.render_display(0)
    assert hi_planner._display_seg is not None
    hi_planner.set_quality(4)
    assert hi_planner._display_seg is None


def test_plan_cache_replay_and_invalidation():
    """iter_batches caches prepared segment plans: a replayed range
    plans ZERO times on the second pass; frames_updated invalidates
    (round-3: matches the staging cache's zero-decode guarantee)."""
    from canvas_tpu.signal import Signal

    plans = []
    orig_plan = render.PlanContext.plan

    def counting_plan(self, source):
        if isinstance(source, VideoWorkspace):
            plans.append(1)
        return orig_plan(self, source)

    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource(
        LerpFunc((1, 0, 0, 1), (0, 1, 0, 1), 64)), x=0, length=64, z=0)
    ws.frames_updated = Signal()
    window = box2i(0, 0, 31, 15)
    planner = render.RenderPlanner(ws, window)

    render.PlanContext.plan = counting_plan
    try:
        out1 = [o for (_s, _n, o) in planner.iter_batches(0, 32, batch=8)]
        n1 = len(plans)
        assert n1 > 0
        out2 = [o for (_s, _n, o) in planner.iter_batches(0, 32, batch=8)]
        assert len(plans) == n1            # replay: zero planning
        for a, b in zip(out1, out2):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        # a graph edit (signalled) re-plans
        ws.frames_updated.fire(0, 32)
        [o for (_s, _n, o) in planner.iter_batches(0, 32, batch=8)]
        assert len(plans) > n1
    finally:
        render.PlanContext.plan = orig_plan


def test_stage_lru_unit():
    """StageLRU mechanics: LRU eviction by bytes, weakref source
    guard against id() reuse, oversized entries skipped."""

    class Src:
        pass

    a, b, c = Src(), Src(), Src()
    lru = render.StageLRU(100)
    lru.put('a', a, 'A', 40)
    lru.put('b', b, 'B', 40)
    assert lru.get('a', a) == 'A'        # refreshes a
    lru.put('c', c, 'C', 40)             # evicts b (LRU)
    assert lru.get('b', b) is None
    assert lru.get('a', a) == 'A'
    assert lru.get('c', c) == 'C'
    assert lru.bytes == 80

    # weakref guard: entry only hits while its source is alive
    d = Src()
    lru.put('d', d, 'D', 10)
    assert lru.get('d', d) == 'D'
    other = Src()
    assert lru.get('d', other) is None   # different object, same key
    assert lru.bytes == 80               # stale entry dropped

    # oversized entries never cached
    lru.put('big', a, 'BIG', 1000)
    assert lru.get('big', a) is None
    assert len(lru) == 2


def test_long_edit_session_soak_caches_bounded(any_backend):
    """Soak: hundreds of interleaved edits, streamed renders, and
    scrubs through ONE planner must leave every cache bounded and
    consistent — the plan cache within its segment cap, the StageLRU
    byte ledger equal to the sum of its entries and within budget,
    the global program cache grown by a small structure-keyed set
    (not per-edit), and exactly one frames_updated subscription (no
    handler leak across the session)."""
    from canvas_tpu.frames import VideoSource
    from canvas_tpu.signal import Signal
    from canvas_tpu.sources import SolidColorVideoSource, VideoWorkspace
    from canvas_tpu.framefuncs import LerpFunc

    rng = np.random.RandomState(42)
    window = box2i(0, 0, 95, 63)

    class Versioned(VideoSource):
        def __init__(self):
            self.versions = {}

        def _render_f16(self, frame_index, frame):
            v = self.versions.get(frame_index, 0)
            r = np.random.RandomState((frame_index * 31 + v * 997 + 1)
                                      % (2 ** 31))
            h, w = frame.full_window.height, frame.full_window.width
            data = (r.rand(4, h, w) * 0.9).astype(np.float16)
            data[3] = np.float16(1.0)
            frame.data = data
            frame.current_window = frame.full_window

    leaf = Versioned()
    ws = VideoWorkspace()
    ws.frames_updated = Signal()
    ws.add(source=leaf, x=0, length=64, z=0)
    ws.add(source=SolidColorVideoSource(
        LerpFunc((0.9, 0.2, 0.1, 0.5), (0.1, 0.2, 0.9, 0.7), 64),
        window=box2i(10, 10, 60, 40)), x=0, length=64, z=1)

    planner = render.RenderPlanner(ws, window)
    planner.pipeline_chunk = 8
    planner.stage_cache_mb = 2          # tiny budget: force evictions
    programs_before = len(render._program_cache)
    try:
        for _round in range(250):
            op = rng.rand()
            if op < 0.35:
                a = int(rng.randint(0, 60))
                b = a + int(rng.randint(0, 6))
                for f in range(a, b + 1):
                    leaf.versions[f] = leaf.versions.get(f, 0) + 1
                ws.frames_updated.fire(a, min(b, 63))
            elif op < 0.75:
                start = int(rng.randint(0, 56))
                for (_s, _n, out) in planner.iter_batches(
                        start, start + int(rng.randint(2, 8)), batch=4):
                    np.asarray(out)
            else:
                planner.render_display(int(rng.randint(0, 63)))

        cache = planner.persistent_cache
        assert cache.budget == 2 * (1 << 20)
        assert cache.bytes <= cache.budget
        assert cache.bytes == sum(e['nbytes']
                                  for e in cache._entries.values()), \
            'StageLRU byte ledger out of sync with entries'
        plans = getattr(planner, '_plan_cache', None)
        if plans is not None:
            assert len(plans) <= planner.plan_cache_segments + 1
        assert len(ws.frames_updated) == 1, \
            'planner must subscribe exactly once across the session'
        grown = len(render._program_cache) - programs_before
        assert grown < 40, \
            'program cache must grow with structures, not rounds (%d)' \
            % grown
    finally:
        planner.close()
    assert len(ws.frames_updated) == 0


def test_iter_batches_yuv420_post_odd_dims():
    """post='yuv420' packs H*W luma + 2 x ceil-dims chroma; odd window
    sizes edge-replicate before the 2x2 mean (shape contract for the
    export transport)."""
    from canvas_tpu.sources import SolidColorVideoSource

    win = box2i(0, 0, 64, 46)           # 65 x 47 — both odd
    src = SolidColorVideoSource((0.3, 0.6, 0.9, 1.0))
    planner = render.RenderPlanner(src, win)
    try:
        outs = [o for (_s, _n, o) in
                planner.iter_batches(0, 4, batch=4, post='yuv420')]
    finally:
        planner.close()
    (flat,) = outs
    h, w = 47, 65
    h2, w2 = 24, 33
    assert flat.shape == (4, h * w + 2 * h2 * w2)
    # flat solid: every luma byte identical, chroma planes constant
    y = flat[:, :h * w]
    assert (y == y[0, 0]).all()
    cb = flat[:, h * w:h * w + h2 * w2]
    assert (cb == cb[0, 0]).all()


def test_scaler_source_rect_crops_like_pull(any_backend):
    """source_rect smaller than the child's content window must CROP in
    the batched path exactly like the eager pull (taps clip to
    content INTERSECT rect; the quantized fetch-union window previously
    leaked cropped-away content — core-invariant regression)."""
    from canvas_tpu.framefuncs import LerpFunc
    from canvas_tpu.sources import SolidColorVideoSource, VideoScaler

    window = box2i(0, 0, 63, 63)
    solid = SolidColorVideoSource((0.8, 0.2, 0.1, 1.0),
                                  window=box2i(0, 0, 29, 29))
    const = VideoScaler(solid, (0.0, 0.0), (0.0, 0.0), (0.25, 0.25),
                        source_rect=box2i(0, 0, 9, 9))
    assert_matches_pull(const, window=window, start=0, stop=2)

    anim = VideoScaler(solid,
                       target_point=LerpFunc((0, 0), (10, 8), 12),
                       source_point=(0.0, 0.0),
                       scale_factors=LerpFunc((0.25, 0.25), (0.8, 0.8), 12),
                       source_rect=box2i(2, 3, 9, 9))
    assert_matches_pull(anim, window=window, start=0, stop=8, atol=4e-3)


def test_transfer_under_composite_bit_exact(any_backend):
    """A transfer curve whose output feeds FURTHER composite math must
    stay f16-quantized mid-program. An XLA backend may fold
    convert(f16)->convert(f32) pairs away inside fused programs (one
    f16 ulp on 25% of pixels where it does), so the planner quantizes
    through the fold-proof ops.color.quantize_f16. Bit-exact, not
    allclose."""
    from canvas_tpu.sources import VideoColorTransferFilter

    base = SolidColorVideoSource((0.2317, 0.4421, 0.613, 1.0))
    xfer = VideoColorTransferFilter(base, 'rgb_to_xyz_sdtv')
    top = SolidColorVideoSource((0.9, 0.1, 0.2, 0.5),
                                window=box2i(100, 100, 180, 160))
    ws = VideoWorkspace()
    ws.add(source=xfer, x=0, length=8, z=0)
    ws.add(source=top, x=0, length=8, z=1)
    win = box2i(0, 0, 255, 255)
    want, _ = pull_frames(ws, win, 2, 4)
    got = render.render_frames(ws, win, 2, 4)
    np.testing.assert_array_equal(got, want)


def test_pulldown_over_staged_scaler_matches_pull(any_backend):
    """Same seed-1034 geometry, but with the scaler wrapped in an
    UNTRACEABLE pass-through so the planner host-stages it: ctx.stage
    must pull each frame at its per-frame SEMANTIC window (pulldown
    pulls frame b inside frame a's window, and the scaler's
    unrenormalized tap clipping is window-sensitive), not at the
    static layout window."""
    from canvas_tpu.coded import Pulldown23RemovalFilter
    from canvas_tpu.frames import VideoSource
    from canvas_tpu.framefuncs import ConstFrameFunc
    from canvas_tpu.sources import VideoScaler

    class Opaque(VideoSource):
        """No emit(): forces ctx.stage for the whole subtree."""

        def __init__(self, src):
            self._src = src

        def _render_f16(self, frame_index, frame):
            self._src.render_f16(frame_index, frame)

        def _render_f32(self, frame_index, frame):
            self._src.render_f32(frame_index, frame)

    solid = SolidColorVideoSource((0.2, 0.9, 0.4, 1.0))
    scaler = VideoScaler(
        solid,
        target_point=LerpFunc((95.0, 8.0), (83.0, 61.0), 64),
        source_point=ConstFrameFunc((0.0, 0.0)),
        scale_factors=LerpFunc((1.19501412, 0.72751164),
                               (0.59656811, 1.02176046), 64),
        source_rect=ConstFrameFunc((3.0, 1.0, 9.0, 12.0)))
    big = box2i(0, 0, 191, 143)
    filt = Pulldown23RemovalFilter(Opaque(scaler), 2)
    want, wins = pull_frames(filt, big, 8, 20)
    got = render.render_frames(filt, big, 8, 20)
    np.testing.assert_array_equal(got, want)


def test_empty_and_reversed_ranges():
    """Empty/reversed ranges are empty results, not internal crashes
    (stack_frames IndexError / negative-length signature)."""
    from canvas_tpu.frames import VideoSource

    class Opaque(VideoSource):
        def _render_f16(self, frame_index, frame):
            SolidColorVideoSource((1, 0, 0, 1)).render_f16(frame_index,
                                                           frame)

    planner = render.RenderPlanner(Opaque(), WINDOW)
    try:
        out = planner.render(10, 10)
        assert out.shape == (0, 4, WINDOW.height, WINDOW.width)
        out, wins = planner.render(10, 5, with_windows=True)
        assert out.shape[0] == 0 and wins.shape == (0, 4)
        assert list(planner.iter_batches(10, 10)) == []
        assert planner.segments(7, 7) == []
    finally:
        planner.close()


def test_iter_batches_honors_batch_above_pipeline_chunk():
    """batch > pipeline_chunk must stream batch-sized dispatches
    (write_video(batch=) was silently capped at the 64-frame default
    chunk)."""
    src = SolidColorVideoSource(LerpFunc((1, 0, 0, 1), (0, 1, 0, 1), 256))
    planner = render.RenderPlanner(src, WINDOW)
    assert planner.pipeline_chunk < 96
    try:
        sizes = [n for (_s, n, _o) in planner.iter_batches(0, 192,
                                                           batch=96)]
        assert sizes == [96, 96]
    finally:
        planner.close()


def test_scaler_identity_frames_in_animated_range(any_backend):
    """Frames where an ANIMATED scaler passes through exact identity
    (factors (1,1), target==source) must bypass source_rect exactly
    like the eager/reference identity short-circuit
    (video_scale.c:295-298) — plan_cuts cuts segments at the
    transitions so a mixed range can't push identity frames down the
    tap path (which clips to source_rect)."""
    from canvas_tpu.framefuncs import ConstFrameFunc
    from canvas_tpu.sources import VideoScaler

    base = SolidColorVideoSource((0.3, 0.7, 0.5, 1.0),
                                 window=box2i(0, 0, 120, 90))
    # factors lerp 1.0 -> 2.0 over 16 frames: frame 0 is exact identity
    sc = VideoScaler(base,
                     target_point=ConstFrameFunc((10.0, 10.0)),
                     source_point=ConstFrameFunc((10.0, 10.0)),
                     scale_factors=LerpFunc((1.0, 1.0), (2.0, 2.0), 16),
                     source_rect=ConstFrameFunc((20.0, 20.0, 60.0, 50.0)))
    win = box2i(0, 0, 191, 143)
    want, _ = pull_frames(sc, win, 0, 8)
    got = render.render_frames(sc, win, 0, 8)
    # frame 0 (identity) must be BIT-exact incl. pixels outside
    # source_rect; scaled frames within the usual scaler tolerance
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=8e-3)


def test_scaler_zero_factor_frames_cut_segments(any_backend):
    """Zero-factor frames inside an animated range emit EMPTY segments
    (plan_cuts transitions) instead of dropping the whole range to the
    host-staging fallback."""
    from canvas_tpu.framefuncs import ConstFrameFunc
    from canvas_tpu.sources import VideoScaler

    base = SolidColorVideoSource((0.3, 0.7, 0.5, 1.0),
                                 window=box2i(0, 0, 60, 40))
    sc = VideoScaler(base,
                     target_point=ConstFrameFunc((10.0, 10.0)),
                     source_point=ConstFrameFunc((0.0, 0.0)),
                     scale_factors=LerpFunc((-0.5, 1.0), (1.5, 1.0), 8),
                     source_rect=ConstFrameFunc((0.0, 0.0, 60.0, 40.0)))
    win = box2i(0, 0, 127, 95)
    want, _ = pull_frames(sc, win, 0, 8)
    got = render.render_frames(sc, win, 0, 8)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=8e-3)
    planner = render.RenderPlanner(sc, win)
    try:
        segs = planner.segments(0, 8)
        assert len(segs) >= 2    # cut at the zero-crossing
    finally:
        planner.close()


def test_mix_dormant_child_not_planned(any_backend):
    """A crossfade pinned at an endpoint never plans (stages/decodes)
    the dormant source — reference's per-frame short-circuit
    (video_mix.c:50-56) realized at plan time."""
    from canvas_tpu.frames import VideoSource
    from canvas_tpu.sources import VideoMixFilter

    pulls = []

    class Counting(VideoSource):
        def _render_f16(self, frame_index, frame):
            pulls.append(frame_index)
            SolidColorVideoSource((1, 0, 0, 1)).render_f16(frame_index,
                                                           frame)

    live = SolidColorVideoSource((0.2, 0.4, 0.8, 1.0))
    mix = VideoMixFilter(live, Counting(), 0.0)
    want, _ = pull_frames(mix, WINDOW, 0, 4)
    got = render.render_frames(mix, WINDOW, 0, 4)
    np.testing.assert_array_equal(got, want)
    assert pulls == []           # dormant b never pulled by the planner

    # and mixed endpoint/mixing ranges still match via segment cuts
    mix2 = VideoMixFilter(live, SolidColorVideoSource((0.9, 0.1, 0, 0.5)),
                          LerpFunc((0.0,), (1.0,), 4))
    want2, _ = pull_frames(mix2, WINDOW, 0, 8)
    got2 = render.render_frames(mix2, WINDOW, 0, 8)
    np.testing.assert_array_equal(got2, want2)


def test_planner_quality_zero_means_best_for_coded_pulls():
    """quality 0 = default-best (framework.h:510-513) on BOTH sides of
    the planner/filter min(): RenderPlanner(quality=0) must not
    override an explicit filter quality down to 0."""
    from canvas_tpu.coded import (CodedImage, CodedImageSource,
                                  DVReconstructionFilter)

    seen = []

    class Source(CodedImageSource):
        def get_frame(self, frame_index, quality=0):
            seen.append(quality)
            y = np.full((480, 720), 128, np.uint8)
            c = np.full((480, 180), 128, np.uint8)
            return CodedImage([y, c, c])

    filt = DVReconstructionFilter(Source(), quality=3)
    win = box2i(0, 0, 719, 479)
    planner = render.RenderPlanner(filt, win, quality=0)
    try:
        planner.render(0, 2)
        assert seen and all(q == 3 for q in seen), seen
    finally:
        planner.close()


def test_coded_stack_grow_decodes_only_new_frames():
    """Growing a staged segment's frame set re-decodes ONLY the missing
    frames: the retained host stacks seed the per-frame cache
    (coded._device_plane_stack grow path)."""
    from canvas_tpu.coded import (CodedImage, CodedImageSource,
                                  PlanarReconstructionFilter)

    decodes = []

    class Source(CodedImageSource):
        def get_frame(self, frame_index, quality=0):
            decodes.append(frame_index)
            rng = np.random.RandomState(frame_index)
            return CodedImage([
                rng.randint(16, 236, (16, 16)).astype(np.uint8),
                rng.randint(16, 241, (8, 8)).astype(np.uint8),
                rng.randint(16, 241, (8, 8)).astype(np.uint8)])

    filt = PlanarReconstructionFilter(Source(), width=16, height=16)
    window = box2i(0, 0, 15, 15)
    planner = render.RenderPlanner(filt, window)
    first = planner.render(0, 4)
    assert sorted(set(decodes)) == list(range(4))

    decodes.clear()
    grown = planner.render(0, 8)
    assert sorted(set(decodes)) == [4, 5, 6, 7]
    np.testing.assert_array_equal(np.asarray(first),
                                  np.asarray(grown[:4]))


def test_hbm_footprint_guard(monkeypatch, caplog):
    """Pre-flight HBM estimate: clearly-over-budget batches refuse
    BEFORE dispatch (an OOM poisons the device client for the rest of
    the process), marginal ones warn, CANVAS_HBM_MB=0 disables.
    Budget tuned so a tiny window exercises all three bands: est =
    (3 in-flight * 8 B/px + 16) * batch * px."""
    import logging

    src = SolidColorVideoSource((0.2, 0.4, 0.6, 1.0))
    window = box2i(0, 0, 191, 107)  # 192x108 = 20736 px
    est_mb = 40 * 8 * 20736 / (1 << 20)  # ~6.3 MB at batch 8

    planner = render.RenderPlanner(src, window)
    monkeypatch.setenv('CANVAS_HBM_MB', str(est_mb * 0.9))
    with pytest.raises(ValueError, match='HBM budget'):
        next(planner.iter_batches(0, 8, batch=8))

    # marginal band (80-100% of budget): warns, still runs
    monkeypatch.setenv('CANVAS_HBM_MB', str(est_mb * 1.1))
    with caplog.at_level(logging.WARNING, logger='canvas_tpu.render'):
        _, n, out = next(planner.iter_batches(0, 8, batch=8))
    assert n == 8 and any('marginal' in r.message for r in caplog.records)

    # bounding max_inflight shrinks the estimate below the same budget
    monkeypatch.setenv('CANVAS_HBM_MB', str(est_mb * 0.9))
    caplog.clear()
    _, n, _ = next(planner.iter_batches(0, 8, batch=8, max_inflight=1))
    assert n == 8

    # 0 disables the check outright
    monkeypatch.setenv('CANVAS_HBM_MB', '0')
    _, n, _ = next(planner.iter_batches(0, 8, batch=8))
    assert n == 8
    planner.close()


def test_hbm_footprint_guard_one_shot_render(monkeypatch):
    """planner.render() compiles one program per segment, so an
    oversize range trips the same pre-flight check at depth 1:
    est = (1 * 8 + 16) * n_frames * px."""
    src = SolidColorVideoSource((0.2, 0.4, 0.6, 1.0))
    window = box2i(0, 0, 191, 107)  # 20736 px
    est_mb = 24 * 16 * 20736 / (1 << 20)

    planner = render.RenderPlanner(src, window)
    monkeypatch.setenv('CANVAS_HBM_MB', str(est_mb * 0.9))
    with pytest.raises(ValueError, match='HBM budget'):
        planner.render(0, 16)
    out = planner.render(0, 8)  # half the frames fits the same budget
    assert out.shape[0] == 8
    planner.close()


def test_hbm_footprint_guard_negative_inflight_is_unbounded(monkeypatch):
    """max_inflight <= 0 means unbounded (iter_batches normalizes it),
    so the guard must use the unbounded depth of 3, not a negative
    multiplier that guts the estimate."""
    src = SolidColorVideoSource((0.2, 0.4, 0.6, 1.0))
    window = box2i(0, 0, 191, 107)
    est_mb = 40 * 8 * 20736 / (1 << 20)
    planner = render.RenderPlanner(src, window)
    monkeypatch.setenv('CANVAS_HBM_MB', str(est_mb * 0.9))
    with pytest.raises(ValueError, match='HBM budget'):
        next(planner.iter_batches(0, 8, batch=8, max_inflight=-1))
    planner.close()


def test_hbm_footprint_guard_malformed_env(monkeypatch, caplog):
    """A non-numeric CANVAS_HBM_MB warns (naming the variable) and
    falls back to device detection instead of crashing the render."""
    import logging

    src = SolidColorVideoSource((0.2, 0.4, 0.6, 1.0))
    window = box2i(0, 0, 191, 107)
    planner = render.RenderPlanner(src, window)
    monkeypatch.setenv('CANVAS_HBM_MB', '16GB')
    with caplog.at_level(logging.WARNING, logger='canvas_tpu.render'):
        _, n, _ = next(planner.iter_batches(0, 8, batch=8))
    assert n == 8
    assert any('CANVAS_HBM_MB' in r.message for r in caplog.records)
    planner.close()


class _FakeDevice:
    platform = 'gpu'
    device_kind = 'Fake GPU'

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize('stats', [None, {}, {'bytes_limit': 0}])
def test_hbm_budget_requires_bytes_limit(monkeypatch, stats):
    """An accelerator that reports no bytes_limit is an error naming the
    override, not an assumed device size."""
    import jax
    monkeypatch.delenv('CANVAS_HBM_MB', raising=False)
    monkeypatch.setattr(jax, 'devices', lambda *a: [_FakeDevice(stats)])
    with pytest.raises(RuntimeError, match='CANVAS_HBM_MB'):
        render._hbm_budget_bytes()


def test_hbm_budget_reads_bytes_limit(monkeypatch):
    """The budget is the device's own bytes_limit; the CPU has none."""
    import jax
    monkeypatch.delenv('CANVAS_HBM_MB', raising=False)
    real = jax.devices()[0]
    monkeypatch.setattr(jax, 'devices',
                        lambda *a: [_FakeDevice({'bytes_limit': 12345})])
    assert render._hbm_budget_bytes() == 12345
    monkeypatch.undo()
    monkeypatch.delenv('CANVAS_HBM_MB', raising=False)
    if real.platform == 'cpu':
        assert render._hbm_budget_bytes() is None
    else:
        assert render._hbm_budget_bytes() == real.memory_stats()[
            'bytes_limit']


def test_hbm_footprint_guard_cumulative_collectors(monkeypatch):
    """Collectors that retain every batch on device (render across
    segments, render_sharded) are checked against the WHOLE range's
    retained footprint — 2 buffers (outs + concatenate) per frame —
    not just one segment's. Sharded, per-device bytes divide by the
    frame-shard count."""
    src = VideoSequence()
    a = SolidColorVideoSource((1, 0, 0, 1))
    b = SolidColorVideoSource((0, 0, 1, 1))
    src.append((a, 0, 8))
    src.append((b, 0, 8))               # segment cut at frame 8
    window = box2i(0, 0, 191, 107)      # 20736 px
    total_mb = 16 * 16 * 20736 / (1 << 20)   # 2 bufs * 8 B/px * 16 f

    planner = render.RenderPlanner(src, window)
    monkeypatch.setenv('CANVAS_HBM_MB', str(total_mb * 0.9))
    with pytest.raises(ValueError, match='HBM budget'):
        planner.render(0, 16)           # each 8-frame segment alone fits
    out = planner.render(0, 7)
    assert out.shape[0] == 7
    planner.close()

    # sharded: 8 devices hold 1/8 of the frames each. At a budget
    # where the unsharded cumulative raises (5.3 MB > 2 MB), the
    # sharded per-device cumulative (0.66 MB) and per-batch working
    # set (0.83 MB at batch 8) both fit. (CPU conftest pins 8 virtual
    # devices; a single-GPU run skips this arm.)
    import jax
    from jax.sharding import Mesh
    monkeypatch.setenv('CANVAS_HBM_MB', '2')
    with pytest.raises(ValueError, match='HBM budget'):
        render.RenderPlanner(src, window).render(0, 16)
    if len(jax.devices()) >= 8:
        mesh = Mesh(np.asarray(jax.devices()[:8]), ('frames',))
        out = render.render_sharded(SolidColorVideoSource((0, 1, 0, 1)),
                                    window, 0, 16, mesh=mesh, batch=8)
        assert out.shape[0] == 16


def test_abandoned_iterator_prepare_drained_before_reuse():
    """Abandoning an iter_batches generator mid-stream can leave its
    prepare thread mutating the planner's staging state (generator
    close deliberately does NOT wait, so it can't hang on a dead
    transport); the NEXT iterator/render/close must drain it before
    touching the same fields, and output must match a fresh planner."""
    import threading

    from canvas_tpu.frames import VideoSource

    in_prepare = threading.Event()
    release = threading.Event()

    class Custom(VideoSource):
        def __init__(self, block_frames=()):
            super().__init__()
            self.block_frames = set(block_frames)

        def _render_f16(self, frame_index, frame):
            if frame_index in self.block_frames:
                in_prepare.set()
                release.wait(timeout=30)
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[1] = (frame_index % 7) * 0.1
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    window = box2i(0, 0, 15, 15)
    # the prepare thread runs one segment ahead: while batch 1 of
    # segment 0 streams, segment 1's staging pull blocks on `release`
    src = Custom(block_frames={8})
    planner = render.RenderPlanner(src, window)
    planner.pipeline_chunk = 8
    it = planner.iter_batches(0, 20, batch=4, device_out=False)
    next(it)
    assert in_prepare.wait(timeout=30)
    it.close()                           # returns without waiting

    def unblock():
        release.set()

    t = threading.Timer(0.2, unblock)
    t.start()
    try:
        # render() drains the in-flight prepare FIRST (this blocks
        # until the timer releases it), then plans fresh
        out = planner.render(0, 20)
    finally:
        t.cancel()
    fresh = render.RenderPlanner(Custom(), window)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(fresh.render(0, 20)))
    fresh.close()
    planner.close()


def test_staged_source_grow_pulls_only_new_frames():
    """Growing a HOST-staged segment's frame range across plans pulls
    ONLY the missing frames: the persistent entry's retained host
    stack seeds the per-frame cache (the stage() twin of the coded
    plane grow path)."""
    from canvas_tpu.frames import VideoSource

    pulls = []

    class Custom(VideoSource):
        def _render_f16(self, frame_index, frame):
            pulls.append(frame_index)
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[2] = (frame_index % 9) * 0.1
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    src = Custom()
    window = box2i(0, 0, 15, 15)
    planner = render.RenderPlanner(src, window)
    first = planner.render(0, 4)
    assert sorted(set(pulls)) == list(range(4))

    pulls.clear()
    grown = planner.render(0, 8)
    assert sorted(set(pulls)) == [4, 5, 6, 7]
    np.testing.assert_array_equal(np.asarray(first),
                                  np.asarray(grown[:4]))
    planner.close()


def test_sequence_forwards_pulldown_hints(monkeypatch):
    """Frame-union hints (pulldown's staging-dedup declaration) forward
    through a VideoSequence retime like they do through a pass-through:
    a staged child reached through a sequence under pulldown pulls each
    unique frame ONCE and ships ONE device stack (without the hint the
    second pulldown child grows the first child's stack and re-ships
    the union)."""
    from canvas_tpu import backend as backend_mod
    from canvas_tpu.coded import Pulldown23RemovalFilter
    from canvas_tpu.frames import VideoSource

    pulls = []

    class Custom(VideoSource):
        def _render_f16(self, frame_index, frame):
            pulls.append(frame_index)
            data = np.zeros((4, frame.full_window.height,
                             frame.full_window.width), np.float16)
            data[0] = (frame_index % 11) * 0.05
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    seq = VideoSequence()
    seq.append((Custom(), 2, 40))        # offset 2: retime is real
    filt = Pulldown23RemovalFilter(seq, 1)
    window = box2i(0, 0, 31, 31)
    want, _ = pull_frames(filt, window, 0, 8)
    pulls.clear()

    ships = []
    real_stage = backend_mod.stage_to_device
    monkeypatch.setattr(backend_mod, 'stage_to_device',
                        lambda host, mesh=None:
                        (ships.append(np.asarray(host).shape),
                         real_stage(host, mesh))[1])
    got = render.render_frames(filt, window, 0, 8)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=2e-3)
    assert len(pulls) == len(set(pulls)), pulls
    # Each unique frame's bytes are transferred exactly ONCE. The
    # stack may ship as several 8-row slabs (pipelined decode->H2D
    # staging overlaps transfer with later pulls), so assert no row is
    # shipped twice rather than a single call: total shipped rows ==
    # one stack's worth.
    assert sum(s[0] for s in ships) == 16, ships  # 10 unique -> 16 padded
    assert all(s[1:] == ships[0][1:] for s in ships), ships


def test_sequence_delitem_range_check():
    """del seq[i] validates like seq[i] = v: an out-of-range negative
    index raises instead of silently deleting the LAST clip."""
    seq = VideoSequence()
    a = SolidColorVideoSource((1, 0, 0, 1))
    for _ in range(3):
        seq.append((a, 0, 5))
    with pytest.raises(IndexError):
        del seq[-4]
    with pytest.raises(IndexError):
        del seq[3]
    assert len(seq) == 3
    del seq[-1]
    assert len(seq) == 2


def test_workspace_sole_item_can_change_z_kind():
    """A single-item workspace can migrate between int and composite
    tuple z (the item's own current z must not anchor the kind)."""
    ws = VideoWorkspace()
    item = ws.add(source=SolidColorVideoSource((1, 0, 0, 1)),
                  x=0, length=10, z=0)
    item.update(z=(0, 1))
    assert item.z == (0, 1)
    item.update(z=3)
    assert item.z == 3
    # with a second item present, mixing still rejects
    ws.add(source=SolidColorVideoSource((0, 1, 0, 1)), x=0, length=10, z=4)
    with pytest.raises(TypeError):
        item.update(z=(1, 2))


def test_render_display_rgb24_transport():
    """transport='rgb24' (lossless 3-byte/px fetch) matches the BGRA
    transport's color channels EXACTLY with alpha padded to 255, for
    both the gamma45 path and an intent conversion, full-size and
    viewport-sized."""
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.2, 0.4, 0.6, 1.0)),
           x=0, length=8, z=0)
    ws.add(source=SolidColorVideoSource(
        LerpFunc((1.0, 0.2, 0.1, 0.8), (0.0, 0.9, 0.5, 0.3), 8),
        window=box2i(4, 4, 40, 40)), x=0, length=8, z=1)
    window = box2i(0, 0, 63, 63)
    planner = render.RenderPlanner(ws, window)

    for kwargs in ({}, {'intent': 1.25},
                   {'display_size': (32, 32)},
                   {'intent': 1.25, 'display_size': (32, 32)}):
        full = planner.render_display(3, **kwargs)
        rgb = planner.render_display(3, transport='rgb24', **kwargs)
        assert rgb.shape == full.shape and rgb.dtype == np.uint8
        np.testing.assert_array_equal(rgb[..., :3], full[..., :3],
                                      err_msg=str(kwargs))
        assert (rgb[..., 3] == 255).all()
