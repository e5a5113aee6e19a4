"""The `process` module: the full engine surface in one namespace.

Mirrors the reference's `fluggo.media.process` C extension module surface
(/root/reference/src/process/main.c:331-407) so code written against the
reference maps one-to-one:

    from canvas_tpu import process
    solid = process.SolidColorVideoSource((1, 0, 0, 1))
    frame = solid.get_frame_f32(0, process.box2i(0, 0, 719, 479))
"""

from canvas_tpu import NS_PER_SEC  # noqa: F401
from canvas_tpu.basetypes import v2i, v2f, box2i, box2f, rgba  # noqa: F401
from canvas_tpu.frames import (  # noqa: F401
    RgbaFrameF16, RgbaFrameF32, VideoSource)
from canvas_tpu.framefuncs import (  # noqa: F401
    FrameFunction, LinearFrameFunc, LerpFunc, AnimationFunc, AnimationPoint,
    FrameFuncPassThroughFilter, POINT_HOLD, POINT_LINEAR)
from canvas_tpu.sources import (  # noqa: F401
    EmptyVideoSource, SolidColorVideoSource, VideoPassThroughFilter,
    VideoMixFilter, VideoGainOffsetFilter, VideoScaler,
    VideoColorTransferFilter, VideoSequence, VideoWorkspace,
    WorkspaceItem)
from canvas_tpu.coded import (  # noqa: F401
    CodecPacketSource, CodedImage, CodedImageSource,
    DVReconstructionFilter, DVSubsampleFilter, PlanarReconstructionFilter,
    MPEG2SubsampleFilter, Pulldown23RemovalFilter)
from canvas_tpu.audio import (  # noqa: F401
    AudioFrame, AudioSource, AudioPassThroughFilter, AudioSequence,
    AudioWorkspace)
from canvas_tpu.clock import (  # noqa: F401
    ClockCallbackHandle, PresentationClock, SystemPresentationClock)
from canvas_tpu.pullqueue import (  # noqa: F401
    VideoPullQueue, VideoPullQueueItem)

# The reference exposes separate item types per workspace kind
# (VideoWorkspace.c:274 / AudioWorkspace.c:230); this build shares one.
VideoWorkspaceItem = WorkspaceItem
AudioWorkspaceItem = WorkspaceItem


class Offscreen:
    """GL-era offscreen rendering context (main.c:193-250). The JAX
    build has no GL path — compiled device programs render offscreen
    by construction — so this name exists only so reference scripts
    import; constructing one is an error."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            'canvas_tpu has no GL path; device programs already render '
            'offscreen (see docs/migration.md)')


def check_context_supported():
    """Device-capability check (the reference verifies its GL context,
    src/process/main.c:193-250). True when an array backend is usable
    (JAX device or the NumPy fallback — the engine runs either way)."""
    return True


def enable_glib_logging(enabled=True):
    """Reference API shim (src/process/main.c:169-329 bridges GLib logs
    into Python logging). This build logs through canvas_tpu.logging /
    stdlib logging natively, so there is nothing to bridge; kept for
    drop-in script compatibility."""
    return None


def _cdiv(a, b):
    """C integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def get_frame_time(frame_rate, frame):
    """Nanosecond presentation time of *frame* at *frame_rate* (a Fraction
    or (n, d)) — src/cprocess/main.c:22-26 (note the +1ns bias the
    reference applies so times land strictly inside the frame)."""
    n, d = _rate(frame_rate)
    return _cdiv(frame * NS_PER_SEC * d, n) + 1


def get_time_frame(frame_rate, time):
    """Frame index containing nanosecond *time* — src/cprocess/main.c:27-31."""
    n, d = _rate(frame_rate)
    return _cdiv(time * n, NS_PER_SEC * d)


def _rate(frame_rate):
    if hasattr(frame_rate, 'numerator'):
        return frame_rate.numerator, frame_rate.denominator
    n, d = frame_rate
    return int(n), int(d)


def time_get_frame(source, min_frame, max_frame, data_window=None,
                   force_eager=False):
    """Pull frames [min_frame, max_frame] and return elapsed nanoseconds —
    the reference's built-in micro-benchmark (src/process/main.c:120-167).

    Measures this engine's production frame-range path: the batched
    planner when the source supports planning (one compiled program per
    structure segment, results fetched to host), else the eager
    per-frame pull. force_eager=True times the eager path regardless.
    """
    import time as _time

    import numpy as np

    from canvas_tpu import backend

    if data_window is None:
        data_window = box2i(0, 0, 719, 479)

    shape = (data_window.max.y - data_window.min.y + 1,
             data_window.max.x - data_window.min.x + 1)
    if (not force_eager and backend.use_jax_for(shape)
            and hasattr(source, 'plan_cuts')):
        from canvas_tpu import render
        planner = render.RenderPlanner(source, data_window)
        start = _time.monotonic_ns()
        for (_s, _n, out) in planner.iter_batches(
                int(min_frame), int(max_frame) + 1, device_out=False):
            pass                      # host fetch forces completion
        return _time.monotonic_ns() - start

    start = _time.monotonic_ns()
    for i in range(int(min_frame), int(max_frame) + 1):
        frame = source.get_frame_f16(i, data_window)
        if backend.is_jax_array(frame.data):
            np.asarray(frame.data)    # host fetch forces completion
    return _time.monotonic_ns() - start
