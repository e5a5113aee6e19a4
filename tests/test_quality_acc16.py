"""quality<=9 bf16-accumulator fast path (round-4 VERDICT item 2a).

The reference's quality-hint scale (framework.h:510-513 and the hints
proposal docs/sphinx/feature-proposal/hints.rst) licenses non-bit-exact
rendering below quality 10. Our planner uses quality<=9 to store the
inter-pass premultiplied accumulators (P, A) in bfloat16 — roughly half
the accumulator memory traffic between composite passes — while all
blend math stays f32 and the output stays f16.  Contracts pinned here:

- quality 10 signatures are UNCHANGED (plain (H, W) over_stack static)
  and stay bit-exact vs the eager pull path;
- quality 9 output is within bf16 rounding of the quality-10 output;
- the 'acc16' tag lives in the node signature, so the program cache
  cannot alias the two quality tiers.
(The compositing passes under bf16 accumulators are pinned in
test_pallas_ops.py.)
"""

import numpy as np

import bench
from canvas_tpu import render
from canvas_tpu.basetypes import box2i


def test_quality9_close_quality10_bit_exact():
    win = box2i(0, 0, 639, 359)
    ws = bench.build_timeline(64)
    p10 = render.RenderPlanner(ws, win, quality=10)
    p9 = render.RenderPlanner(ws, win, quality=9)
    a = np.asarray(p10.render(10, 14)).astype(np.float32)
    b = np.asarray(p9.render(10, 14)).astype(np.float32)
    # bf16 has 8 mantissa bits: values in [0, ~1.5] round within ~2^-8
    assert np.abs(a - b).max() <= 0.01
    assert np.abs(a - b).mean() <= 1e-3
    # quality 10 stays exact vs the eager pull path within the
    # documented contract: solid/composite pixels bit-exact, scaler
    # regions within a couple f16 ulps (einsum accumulation order —
    # docs/api.md; test_render_fuzz enforces this differentially)
    pull = np.asarray(ws.get_frame_f16(10, win).data, np.float32)
    got10 = np.asarray(p10.render(10, 11), np.float32)[0]
    assert np.abs(got10 - pull).max() <= 5e-4
    assert (got10 != pull).mean() <= 1e-3


def test_acc16_tag_in_signature():
    """The program/plan caches key on the signature; the acc16 arm must
    not alias the bit-exact arm."""
    win = box2i(0, 0, 255, 127)
    ws = bench.build_timeline(16)
    frames = np.arange(0, 4, dtype=np.int64)

    def sig(quality):
        planner = render.RenderPlanner(ws, win, quality=quality)
        planner._stage_cache = {}
        planner._frame_hints = {}
        ctx = render.PlanContext(planner, frames, planner.window)
        return ctx.plan(ws).signature()

    s10 = sig(10)
    s9 = sig(9)
    assert s10 != s9
    assert 'acc16' in repr(s9)
    assert 'acc16' not in repr(s10)
