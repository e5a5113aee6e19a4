"""Differential fuzz: random filter graphs, batched planner vs pull path.

The planner (canvas_tpu/render.py) must agree with the eager pull path
for any graph the editor can build. Random workspaces exercise solid
runs (fused fold), damage regions, scalers, mixes, sequences, gaps,
empty layers, and opaque pruning together, across segment boundaries.
"""

import os

import numpy as np
import pytest

# Extended sweeps: CANVAS_FUZZ_SEEDS=200 widens every parametrized
# seed range (CI default stays small).
_SEEDS = int(os.environ.get('CANVAS_FUZZ_SEEDS', '0'))

from canvas_tpu import render
from canvas_tpu.basetypes import box2i
from canvas_tpu.framefuncs import LerpFunc, LinearFrameFunc
from canvas_tpu.sources import (EmptyVideoSource, SolidColorVideoSource,
                                VideoColorTransferFilter,
                                VideoGainOffsetFilter, VideoMixFilter,
                                VideoPassThroughFilter, VideoScaler,
                                VideoSequence, VideoWorkspace)

WINDOW = box2i(0, 0, 191, 143)
LENGTH = 64


def random_color(rng):
    c = rng.rand(4)
    c[3] = rng.choice([1.0, rng.rand()])
    return tuple(float(v) for v in c)


def random_window(rng):
    if rng.rand() < 0.15:
        return None                              # infinite
    x0 = rng.randint(-40, 160)
    y0 = rng.randint(-40, 120)
    return box2i(x0, y0, x0 + rng.randint(8, 180), y0 + rng.randint(8, 140))


def random_leaf(rng):
    kind = rng.rand()
    if kind < 0.1:
        return EmptyVideoSource()
    color = (random_color(rng) if rng.rand() < 0.5 else
             LerpFunc(random_color(rng), random_color(rng), LENGTH))
    return SolidColorVideoSource(color, window=random_window(rng))


def random_source(rng, depth=0):
    r = rng.rand()
    if depth >= 2 or r < 0.35:
        return random_leaf(rng)
    if r < 0.45:
        return VideoPassThroughFilter(
            random_source(rng, depth + 1),
            offset=int(rng.randint(-10, 10)),
            start_frame=(int(rng.randint(0, 10))
                         if rng.rand() < 0.5 else None),
            end_frame=(int(rng.randint(20, 60))
                       if rng.rand() < 0.5 else None))
    if r < 0.5:
        return VideoGainOffsetFilter(
            random_source(rng, depth + 1),
            gain=LinearFrameFunc(float(rng.rand()) / LENGTH,
                                 float(rng.rand())),
            offset=0.0)
    if r < 0.55:
        return VideoColorTransferFilter(
            random_source(rng, depth + 1),
            str(rng.choice(['rec709_to_linear_scene', 'linear_to_rec709',
                            'linear_to_srgb'])))
    if r < 0.62:
        from canvas_tpu.coded import Pulldown23RemovalFilter
        return Pulldown23RemovalFilter(random_source(rng, depth + 1),
                                       int(rng.randint(0, 5)))
    if r < 0.75:
        return VideoMixFilter(random_source(rng, depth + 1),
                              random_source(rng, depth + 1),
                              LerpFunc((0.0,), (1.0,), LENGTH))
    if r < 0.9:
        w = rng.randint(16, 64)
        h = rng.randint(16, 64)
        base = SolidColorVideoSource(random_color(rng),
                                     window=box2i(0, 0, w - 1, h - 1))
        # sometimes CROP with source_rect smaller than the content
        # window — the case that caught the tap-clip divergence
        if rng.rand() < 0.4:
            rect = box2i(int(rng.randint(0, w // 2)),
                         int(rng.randint(0, h // 2)),
                         int(rng.randint(w // 2, w)),
                         int(rng.randint(h // 2, h)))
        else:
            rect = box2i(0, 0, w - 1, h - 1)
        return VideoScaler(
            base,
            target_point=LerpFunc(
                (int(rng.randint(0, 120)), int(rng.randint(0, 90))),
                (int(rng.randint(0, 120)), int(rng.randint(0, 90))),
                LENGTH),
            source_point=(0.0, 0.0),
            scale_factors=LerpFunc(
                (float(0.5 + rng.rand()), float(0.5 + rng.rand())),
                (float(0.5 + rng.rand()), float(0.5 + rng.rand())),
                LENGTH),
            source_rect=rect)
    if r < 0.95:
        seq = VideoSequence()
        for _ in range(rng.randint(1, 4)):
            seq.append((random_leaf(rng), int(rng.randint(0, 5)),
                        int(rng.randint(4, 20))))
        return seq
    # nested workspace (the editor's space-as-asset pattern)
    inner = VideoWorkspace()
    for z in range(rng.randint(1, 3)):
        inner.add(source=random_leaf(rng), x=int(rng.randint(-4, 10)),
                  length=int(rng.randint(8, 40)), z=z)
    return inner


def random_workspace(rng):
    ws = VideoWorkspace()
    for z in range(rng.randint(1, 7)):
        ws.add(source=random_source(rng),
               x=int(rng.randint(-8, 20)),
               length=int(rng.randint(10, LENGTH)),
               offset=int(rng.randint(0, 6)),
               z=z)
    return ws


@pytest.mark.parametrize('seed', range(max(12, _SEEDS)))
def test_random_graph_batched_matches_pull(seed, any_backend):
    rng = np.random.RandomState(seed)
    ws = random_workspace(rng)

    start = int(rng.randint(0, 8))
    stop = start + int(rng.randint(4, 24))
    got = render.render_frames(ws, WINDOW, start, stop)
    for i in range(start, stop):
        want = ws.get_frame_f16(i, WINDOW)
        if want.current_window.empty():
            expect = np.zeros((4, WINDOW.height, WINDOW.width), np.float16)
        else:
            expect = np.asarray(want.data, np.float16)
        np.testing.assert_allclose(
            got[i - start].astype(np.float32), expect.astype(np.float32),
            atol=8e-3, err_msg='seed %d frame %d' % (seed, i))


@pytest.mark.parametrize('seed', range(max(6, _SEEDS // 2)))
def test_random_graph_quality9_close_to_pull(seed, any_backend):
    """The quality<=9 bf16-accumulator fast path over random graphs:
    same structure as the bit-exact fuzz, with the tolerance the 8-bit
    mantissa licenses (values bounded ~[0, 2.5] by construction; one
    bf16 ulp there is ~0.02). Catches acc16 plumbing bugs — a wrong
    dtype at any pass boundary diverges far beyond rounding."""
    rng = np.random.RandomState(10_000 + seed)
    ws = random_workspace(rng)
    start = int(rng.randint(0, 8))
    stop = start + int(rng.randint(4, 16))
    planner = render.RenderPlanner(ws, WINDOW, quality=9)
    got = np.asarray(planner.render(start, stop))
    for i in range(start, stop):
        want = ws.get_frame_f16(i, WINDOW)
        if want.current_window.empty():
            expect = np.zeros((4, WINDOW.height, WINDOW.width),
                              np.float16)
        else:
            expect = np.asarray(want.data, np.float16)
        np.testing.assert_allclose(
            got[i - start].astype(np.float32),
            expect.astype(np.float32),
            atol=3e-2, err_msg='seed %d frame %d' % (seed, i))


def test_coded_layer_in_workspace_matches_pull(any_backend):
    """A staged coded-source chain (DV reconstruct + pulldown removal)
    composited with solid layers: batched planner vs pull."""
    from canvas_tpu.coded import (CodedImage, CodedImageSource,
                                  DVReconstructionFilter,
                                  Pulldown23RemovalFilter)

    rng = np.random.RandomState(7)
    planes = [(rng.randint(16, 236, (480, 720)).astype(np.uint8),
               rng.randint(16, 241, (480, 180)).astype(np.uint8),
               rng.randint(16, 241, (480, 180)).astype(np.uint8))
              for _ in range(12)]

    class Src(CodedImageSource):
        def get_frame(self, i, quality=0):
            return CodedImage(list(planes[i % len(planes)]))

    window = box2i(0, -1, 719, 478)
    ws = VideoWorkspace()
    ws.add(source=Pulldown23RemovalFilter(DVReconstructionFilter(Src()), 2),
           x=0, length=8, z=0)
    ws.add(source=SolidColorVideoSource((1, 0, 0, 0.4),
                                        window=box2i(100, 100, 400, 300)),
           x=0, length=8, z=1)

    got = render.render_frames(ws, window, 0, 6)
    for i in range(6):
        want = ws.get_frame_f16(i, window)
        expect = np.asarray(want.data, np.float16)
        d = np.abs(got[i].astype(np.float32) - expect.astype(np.float32))
        # direct-math transfer vs LUT compounds with the blend: a couple
        # of f16 ulps at DV superwhite magnitudes (>1.0)
        assert d.max() <= 8e-3, (i, d.max())
        assert (d > 1e-3).mean() < 0.02, (i, (d > 1e-3).mean())


def test_edit_churn_reuses_programs(any_backend):
    """Scrub-style editing: 120 random edit/render cycles stay correct
    and reuse a SMALL set of compiled programs (the structure-keyed
    cache working as designed for interactive editing)."""
    import canvas_tpu.render as R
    from canvas_tpu.render import RenderPlanner

    rng = np.random.RandomState(0)
    ws = VideoWorkspace()
    items = []
    for z in range(6):
        it = ws.add(source=SolidColorVideoSource(
            LerpFunc(tuple(rng.rand(4)), tuple(rng.rand(4)), 64),
            window=box2i(int(rng.randint(0, 50)), int(rng.randint(0, 50)),
                         int(rng.randint(60, 150)),
                         int(rng.randint(60, 140)))),
            x=int(rng.randint(0, 10)), length=int(rng.randint(20, 60)), z=z)
        items.append(it)

    window = box2i(0, 0, 159, 119)
    planner = RenderPlanner(ws, window)
    cache_before = len(R._program_cache)
    for step in range(120):
        it = items[rng.randint(len(items))]
        kind = rng.rand()
        if kind < 0.4:
            it.update(x=int(rng.randint(0, 20)))
        elif kind < 0.8:
            it.update(length=int(rng.randint(10, 60)))
        else:
            it.update(z=int(rng.randint(0, 6)))
        lo = int(rng.randint(0, 30))
        out = planner.render(lo, lo + 4)
        want = ws.get_frame_f16(lo + 1, window)
        expect = (np.zeros((4, 120, 160), np.float16)
                  if want.current_window.empty()
                  else np.asarray(want.data, np.float16))
        d = np.abs(out[1].astype(np.float32)
                   - expect.astype(np.float32)).max()
        assert d <= 4e-3, (step, d)
    assert len(R._program_cache) - cache_before < 60


@pytest.mark.parametrize('seed', range(max(6, _SEEDS)))
def test_random_graph_iter_batches_matches_pull(seed, any_backend):
    """The streaming executor (segment planning, pipeline chunks, batch
    slicing, tail padding, optional mesh sharding and fused u8) agrees
    with the pull path on random graphs."""
    import jax

    rng = np.random.RandomState(1000 + seed)
    ws = random_workspace(rng)
    start = int(rng.randint(0, 6))
    stop = start + int(rng.randint(5, 30))
    batch = int(rng.choice([3, 4, 8]))
    use_mesh = bool(rng.rand() < 0.4 and len(jax.devices()) >= 2)

    planner = render.RenderPlanner(ws, WINDOW)
    kwargs = {}
    if use_mesh:
        from jax.sharding import Mesh
        n = len(jax.devices())
        batch = max(batch, n)
        batch -= batch % n
        kwargs['mesh'] = Mesh(np.asarray(jax.devices()), ('frames',))
    if rng.rand() < 0.4:
        # bounded in-flight pacing must be output-invariant
        kwargs['max_inflight'] = int(rng.choice([1, 2, 3]))

    outs = []
    for (_s, n_valid, out) in planner.iter_batches(start, stop,
                                                   batch=batch, **kwargs):
        outs.append(np.asarray(out)[:n_valid])
    got = np.concatenate(outs, axis=0)
    assert got.shape[0] == stop - start

    for i in range(start, stop):
        want = ws.get_frame_f16(i, WINDOW)
        if want.current_window.empty():
            expect = np.zeros((4, WINDOW.height, WINDOW.width), np.float16)
        else:
            expect = np.asarray(want.data, np.float16)
        np.testing.assert_allclose(
            got[i - start].astype(np.float32), expect.astype(np.float32),
            atol=8e-3, err_msg='seed %d frame %d batch %d mesh %s'
            % (seed, i, batch, use_mesh))


@pytest.mark.parametrize('seed', range(max(3, _SEEDS)))
def test_random_graph_with_untraceable_leaves(seed, any_backend):
    """Random graphs containing untraceable sources (device-resident
    stage_rows fallback) still match the pull path."""
    from canvas_tpu.frames import VideoSource

    class Opaque(VideoSource):
        def __init__(self, key):
            self.key = key

        def _render_f16(self, frame_index, frame):
            rng2 = np.random.RandomState(self.key * 1000 +
                                         frame_index % 97)
            h, w = frame.full_window.height, frame.full_window.width
            data = (rng2.rand(4, h, w) * 0.9).astype(np.float16)
            data[3] = np.float16(1.0)
            frame.data = data
            frame.current_window = frame.full_window

    rng = np.random.RandomState(7000 + seed)
    orig = random_leaf

    def leaf(r):
        if r.rand() < 0.4:
            return Opaque(int(r.randint(0, 1000)))
        return orig(r)

    import test_render_fuzz as mod
    mod.random_leaf, saved = leaf, mod.random_leaf
    try:
        ws = random_workspace(rng)
    finally:
        mod.random_leaf = saved

    start = int(rng.randint(0, 6))
    stop = start + int(rng.randint(4, 12))
    planner = render.RenderPlanner(ws, WINDOW)
    outs = []
    for (_s, nv, out) in planner.iter_batches(start, stop, batch=4):
        outs.append(np.asarray(out)[:nv])
    got = np.concatenate(outs, axis=0)
    for i in range(start, stop):
        want = ws.get_frame_f16(i, WINDOW)
        expect = (np.zeros((4, WINDOW.height, WINDOW.width), np.float16)
                  if want.current_window.empty()
                  else np.asarray(want.data, np.float16))
        np.testing.assert_allclose(
            got[i - start].astype(np.float32), expect.astype(np.float32),
            atol=8e-3, err_msg='seed %d frame %d' % (seed, i))


@pytest.mark.parametrize('seed', range(max(4, _SEEDS)))
def test_random_graph_solid_cells_path(seed, any_backend, monkeypatch):
    """The gated cell-table solid fold (CANVAS_SOLID_CELLS=1, a
    measured perf dead end kept correct) agrees with the pull path on
    random workspaces — same differential contract as the default
    solid_stack path."""
    monkeypatch.setenv('CANVAS_SOLID_CELLS', '1')
    rng = np.random.RandomState(1000 + seed)
    ws = random_workspace(rng)

    start = int(rng.randint(0, 8))
    stop = start + int(rng.randint(4, 16))
    got = render.render_frames(ws, WINDOW, start, stop)
    for i in range(start, stop):
        want = ws.get_frame_f16(i, WINDOW)
        if want.current_window.empty():
            expect = np.zeros((4, WINDOW.height, WINDOW.width), np.float16)
        else:
            expect = np.asarray(want.data, np.float16)
        np.testing.assert_allclose(
            got[i - start].astype(np.float32), expect.astype(np.float32),
            atol=8e-3, err_msg='seed %d frame %d' % (seed, i))


@pytest.mark.parametrize('seed', range(max(4, _SEEDS)))
def test_persistent_cache_random_replay_sequences(seed, any_backend):
    """Fuzz the persistent staging cache: random sequences of
    (possibly overlapping) render ranges through ONE planner must
    equal a fresh planner's output every time (cache hits can never
    change pixels)."""
    from canvas_tpu.frames import VideoSource

    rng = np.random.RandomState(2000 + seed)

    class Hashed(VideoSource):
        def _render_f16(self, frame_index, frame):
            r = np.random.RandomState(frame_index * 7 + 1)
            data = (r.rand(4, frame.full_window.height,
                           frame.full_window.width) * 0.9).astype(np.float16)
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    window = box2i(0, 0, 47, 31)
    src = Hashed()
    planner = render.RenderPlanner(src, window)
    planner.pipeline_chunk = 8
    for _round in range(6):
        start = int(rng.randint(0, 24))
        stop = start + int(rng.randint(2, 12))
        got = planner.render(start, stop)
        fresh = render.RenderPlanner(src, window)
        fresh.stage_cache_mb = 0
        want = fresh.render(start, stop)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg='seed %d range %d:%d'
                                      % (seed, start, stop))


@pytest.mark.parametrize('seed', range(max(6, _SEEDS)))
def test_ranged_invalidation_random_edit_replay(seed, any_backend):
    """Fuzz the ranged-invalidation machinery end-to-end: interleave
    random CONTENT edits (mutate an untraceable source's pixels, fire
    ``frames_updated(lo, hi)`` on the root) with replayed renders
    through ONE long-lived planner whose plan cache and persistent
    stage cache stay enabled. Every render must equal a fresh planner
    with all caches off — a cached plan or staged device stack that
    survives an invalidation it should not have can leak pre-edit
    pixels, and an over-dropped cache can only cost speed, never
    pixels. Exercises both the streaming path (iter_batches: prepared
    plans + staged stacks) and the persistent-cache path (render)."""
    from canvas_tpu.frames import VideoSource
    from canvas_tpu.signal import Signal

    rng = np.random.RandomState(3000 + seed)
    window = box2i(0, 0, 127, 95)

    class Versioned(VideoSource):
        """Untraceable leaf whose content depends on (frame, version):
        the stage_rows machinery must re-pull edited frames."""

        def __init__(self, key):
            self.key = key
            self.versions = {}

        def _render_f16(self, frame_index, frame):
            v = self.versions.get(frame_index, 0)
            r = np.random.RandomState(
                (self.key * 131 + frame_index * 31 + v * 7919 + 1)
                % (2 ** 31))
            h, w = frame.full_window.height, frame.full_window.width
            data = (r.rand(4, h, w) * 0.9).astype(np.float16)
            data[3] = np.float16(1.0)
            frame.data = data
            frame.current_window = frame.full_window

    ws = VideoWorkspace()
    ws.frames_updated = Signal()
    edit_targets = []          # (leaf, item_x, item_offset, item_length)
    for z in range(int(rng.randint(2, 5))):
        x = int(rng.randint(0, 8))
        offset = int(rng.randint(0, 4))
        length = int(rng.randint(16, 40))
        if rng.rand() < 0.6:
            leaf = Versioned(z)
            src = leaf
            if rng.rand() < 0.5:
                src = VideoGainOffsetFilter(
                    src, gain=LinearFrameFunc(0.01, 0.8), offset=0.0)
            edit_targets.append((leaf, x, offset, length))
        else:
            src = SolidColorVideoSource(
                LerpFunc(random_color(rng), random_color(rng), LENGTH),
                window=random_window(rng))
        ws.add(source=src, x=x, offset=offset, length=length, z=z)
    if not edit_targets:
        leaf = Versioned(99)
        edit_targets.append((leaf, 0, 0, 24))
        ws.add(source=leaf, x=0, offset=0, length=24, z=10)

    planner = render.RenderPlanner(ws, window)
    planner.pipeline_chunk = 8

    def render_one(p, start, stop, streaming):
        # program structure is range/batch-dependent (plan cuts, fold
        # mode selection), and structurally different programs may
        # differ by an f16 ulp (FMA contraction) — so the fresh arm
        # must mirror the cached arm's path exactly for the
        # bit-equality assertion to isolate CACHE bugs
        if streaming:
            outs = []
            for (_s, nv, out) in p.iter_batches(start, stop, batch=4):
                outs.append(np.asarray(out)[:nv])
            return np.concatenate(outs, axis=0)
        return np.asarray(p.render(start, stop))

    did_edit = False
    for _round in range(10):
        # force an edit by mid-sequence so every seed exercises
        # post-edit replays (a last-round edit would never be rendered)
        if rng.rand() < 0.4 or (_round == 4 and not did_edit):
            # EDIT: bump versions on a leaf frame range, fire the
            # mapped root range (root = leaf + x - offset, hi incl.)
            leaf, x, offset, length = edit_targets[
                int(rng.randint(len(edit_targets)))]
            a = int(rng.randint(0, 30))
            b = a + int(rng.randint(0, 8))
            for f in range(a, b + 1):
                leaf.versions[f] = leaf.versions.get(f, 0) + 1
            lo = max(a + x - offset, x)
            hi = min(b + x - offset, x + length - 1)
            if lo <= hi:
                ws.frames_updated.fire(lo, hi)
            did_edit = True
        else:
            start = int(rng.randint(0, 24))
            stop = start + int(rng.randint(3, 14))
            streaming = bool(rng.rand() < 0.5)
            got = render_one(planner, start, stop, streaming)
            fresh = render.RenderPlanner(ws, window)
            fresh.pipeline_chunk = 8
            fresh.stage_cache_mb = 0
            fresh.plan_cache_segments = 0
            want = render_one(fresh, start, stop, streaming)
            fresh.close()
            np.testing.assert_array_equal(
                got, want, err_msg='seed %d round %d range %d:%d'
                % (seed, _round, start, stop))
    planner.close()
