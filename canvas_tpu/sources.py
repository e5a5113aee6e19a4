"""Video sources, filters, and containers.

JAX equivalents of the reference's `fluggo.media.process` video types
(/root/reference/src/process/): EmptyVideoSource, SolidColorVideoSource,
VideoPassThroughFilter, VideoMixFilter, VideoGainOffsetFilter,
VideoSequence, VideoWorkspace. Pixel work happens in canvas_tpu.ops
(NumPy or JAX per backend dispatch); window algebra stays host-side.
"""

import bisect
import threading

import numpy as np

from canvas_tpu import backend, framefuncs
from canvas_tpu.basetypes import (EMPTY_BOX2I, INFINITE_BOX2I, box2i,
                                  box2i_intersect, box2i_union, v2f)
from canvas_tpu.frames import RgbaFrameF32, VideoSource
from canvas_tpu.ops import mix as mix_ops
from canvas_tpu.ops.composite import REGION_BLOCK
from canvas_tpu.ops import scale as scale_ops
from canvas_tpu.ops import window as window_ops

__all__ = ['EmptyVideoSource', 'SolidColorVideoSource',
           'VideoPassThroughFilter', 'VideoMixFilter',
           'VideoGainOffsetFilter', 'VideoScaler', 'VideoColorTransferFilter',
           'VideoSequence', 'VideoWorkspace', 'WorkspaceItem']


def _union_defined(a, b):
    """Union that treats empty boxes as identity (the C code never unions
    an empty box; it early-returns instead, video_mix.c:114-121)."""
    if a.empty():
        return b
    if b.empty():
        return a
    return box2i_union(a, b)


class EmptyVideoSource(VideoSource):
    """Always-empty frames (src/process/EmptyVideoSource.c)."""

    def _render_f16(self, frame_index, frame):
        frame.current_window = EMPTY_BOX2I

    def _render_f32(self, frame_index, frame):
        frame.current_window = EMPTY_BOX2I


class SolidColorVideoSource(VideoSource):
    """Animated solid color over an animated window
    (src/process/SolidColorVideoSource.c:52-101).

    color, window: constants or frame functions; window defaults to
    infinite (the whole requested frame).
    """

    def __init__(self, color, window=None):
        self._color = framefuncs.as_framefunc(color)
        if window is None:
            self._window = framefuncs.ConstFrameFunc(
                (INFINITE_BOX2I.min.x, INFINITE_BOX2I.min.y,
                 INFINITE_BOX2I.max.x, INFINITE_BOX2I.max.y))
        else:
            self._window = framefuncs.as_framefunc(window)

    def _fill(self, frame_index, frame, dtype):
        window = framefuncs.get_box2i(self._window, frame_index)
        current = box2i_intersect(window, frame.full_window)

        if current.empty():
            frame.current_window = EMPTY_BOX2I
            return

        color = framefuncs.get_rgba_f32(self._color, frame_index)
        frame.data = window_ops.fill_solid(frame.full_window, dtype,
                                           tuple(color), current)
        frame.current_window = current

    def _render_f16(self, frame_index, frame):
        self._fill(frame_index, frame, np.float16)

    def _render_f32(self, frame_index, frame):
        self._fill(frame_index, frame, np.float32)


class VideoPassThroughFilter(VideoSource):
    """Identity/retiming filter (src/process/VideoPassThroughFilter.c):
    shifts frame indices by *offset* and optionally blanks outside
    [start_frame, end_frame)."""

    def __init__(self, source, offset=0, start_frame=None, end_frame=None):
        # Stored privately: editor subclasses (VideoStream, connectors)
        # use their own ``source`` attributes, mirroring the reference
        # where the wrapped source lives in the C struct.
        self._source = source
        self.offset = int(offset)
        self.start_frame = start_frame
        self.end_frame = end_frame

    def set_source(self, source):
        """Replace the wrapped source (live pass-through behavior used by
        the editor's VideoStream wrappers, _source.py:470-487)."""
        self._source = source

    def get_source(self):
        return self._source

    def _in_range(self, frame_index):
        if self.start_frame is not None and frame_index < self.start_frame:
            return False
        if self.end_frame is not None and frame_index >= self.end_frame:
            return False
        return self._source is not None

    def _render_f16(self, frame_index, frame):
        if not self._in_range(frame_index):
            frame.current_window = EMPTY_BOX2I
            return
        self._source.render_f16(frame_index + self.offset, frame)

    def _render_f32(self, frame_index, frame):
        if not self._in_range(frame_index):
            frame.current_window = EMPTY_BOX2I
            return
        self._source.render_f32(frame_index + self.offset, frame)


class VideoMixFilter(VideoSource):
    """Crossfade of two sources by an animated mix factor
    (src/process/VideoMixFilter.c:41-93 + video_mix_cross_f32)."""

    def __init__(self, src_a, src_b, mix_b):
        self.src_a = src_a
        self.src_b = src_b
        self.mix_b = framefuncs.as_framefunc(mix_b)

    def _render_f32(self, frame_index, frame):
        mix_b = min(max(framefuncs.get_f32(self.mix_b, frame_index), 0.0),
                    1.0)

        # Endpoint short-circuits (video_mix.c:50-56): at 0 or 1 only one
        # source is pulled, and the OTHER source's window never affects
        # the output (a gap under a dormant crossfade stays empty).
        if mix_b == 0.0:
            self.src_a.render_f32(frame_index, frame)
            return
        if mix_b == 1.0:
            self.src_b.render_f32(frame_index, frame)
            return

        frame_a = RgbaFrameF32(frame.full_window)
        frame_b = RgbaFrameF32(frame.full_window)
        self.src_a.render_f32(frame_index, frame_a)
        self.src_b.render_f32(frame_index, frame_b)

        awin, bwin = frame_a.current_window, frame_b.current_window
        outer = box2i_intersect(_union_defined(awin, bwin), frame.full_window)

        if outer.empty():
            frame.current_window = EMPTY_BOX2I
            return

        frame.data = mix_ops.cross(frame_a.data, frame_b.data, mix_b)
        frame.current_window = outer


class VideoGainOffsetFilter(VideoSource):
    """color.rgb * gain + offset, alpha unchanged
    (src/process/VideoGainOffsetFilter.c; shader video_filter.c:36-39)."""

    def __init__(self, source, gain=1.0, offset=0.0):
        self.source = source
        self.gain = framefuncs.as_framefunc(gain)
        self.offset = framefuncs.as_framefunc(offset)

    def _render_f32(self, frame_index, frame):
        self.source.render_f32(frame_index, frame)
        if frame.current_window.empty():
            return

        gain = framefuncs.get_f32(self.gain, frame_index)
        offset = framefuncs.get_f32(self.offset, frame_index)

        data = frame.data
        if backend.is_jax_array(data) or backend.use_jax_for(data.shape):
            jnp = backend.jnp
            data = jnp.asarray(data)
            scale = jnp.asarray([gain, gain, gain, 1.0], dtype=jnp.float32)
            shift = jnp.asarray([offset, offset, offset, 0.0], dtype=jnp.float32)
            out = data * scale[:, None, None] + shift[:, None, None]
        else:
            scale = np.asarray([gain, gain, gain, 1.0], dtype=np.float32)
            shift = np.asarray([offset, offset, offset, 0.0], dtype=np.float32)
            out = data * scale[:, None, None] + shift[:, None, None]

        # gain/offset creates nonzero values outside the current window
        # (offset != 0); reclip to preserve the zero-outside invariant.
        if frame.current_window != frame.full_window and offset != 0.0:
            out = _mask_outside(out, frame.full_window, frame.current_window)
        frame.data = out


def _mask_outside(data, full_window, current_window):
    """Zero everything outside current_window (absolute coords)."""
    sl = window_ops.window_slices(full_window,
                                  box2i_intersect(current_window, full_window))
    if backend.is_jax_array(data):
        jnp = backend.jnp
        out = jnp.zeros_like(data)
        return out.at[:, sl[0], sl[1]].set(data[:, sl[0], sl[1]])
    out = np.zeros_like(data)
    out[:, sl[0], sl[1]] = data[:, sl[0], sl[1]]
    return out


def _trunc(x):
    """C-cast truncation toward zero (int() already truncates)."""
    return int(x)


class VideoScaler(VideoSource):
    """Animated bilinear scaler (src/process/VideoScaler.c:38-79 +
    video_scale_bilinear_f32_pull, video_scale.c:288-319).

    All parameters are frame functions (or constants): *target_point* and
    *source_point* anchor the scale (source_point in the source maps to
    target_point in the output), *scale_factors* is the (x, y) zoom, and
    *source_rect* bounds what is fetched from the source.
    """

    def __init__(self, source, target_point, source_point, scale_factors,
                 source_rect):
        self.source = source
        self.target_point = framefuncs.as_framefunc(target_point)
        self.source_point = framefuncs.as_framefunc(source_point)
        self.scale_factors = framefuncs.as_framefunc(scale_factors)
        self.source_rect = framefuncs.as_framefunc(source_rect)

    def _render_f32(self, frame_index, frame):
        if self.source is None:
            frame.current_window = EMPTY_BOX2I
            return

        target_point = framefuncs.get_v2f(self.target_point, frame_index)
        source_point = framefuncs.get_v2f(self.source_point, frame_index)
        factors = framefuncs.get_v2f(self.scale_factors, frame_index)
        source_rect = framefuncs.get_box2i(self.source_rect, frame_index)

        if factors.x == 0.0 or factors.y == 0.0:
            frame.current_window = EMPTY_BOX2I
            return

        if (factors.x == 1.0 and factors.y == 1.0 and
                target_point.x == source_point.x and
                target_point.y == source_point.y):
            self.source.render_f32(frame_index, frame)
            return

        # Source rect needed to cover the target (video_scale.c:299-307).
        full = frame.full_window
        fetch = box2i(
            _trunc(source_point.x - (target_point.x - full.min.x) / factors.x) - 1,
            _trunc(source_point.y - (target_point.y - full.min.y) / factors.y) - 1,
            _trunc(source_point.x + (full.max.x - target_point.x) / factors.x) + 1,
            _trunc(source_point.y + (full.max.y - target_point.y) / factors.y) + 1)
        fetch = box2i_intersect(fetch, source_rect)
        if fetch.empty():
            frame.current_window = EMPTY_BOX2I
            return

        temp = RgbaFrameF32(fetch)
        self.source.render_f32(frame_index, temp)
        if temp.current_window.empty():
            frame.current_window = EMPTY_BOX2I
            return

        frame.data, frame.current_window = scale_ops.scale_bilinear(
            temp.data, temp.full_window, temp.current_window,
            frame.full_window, target_point, source_point, factors)


class VideoColorTransferFilter(VideoSource):
    """Transfer-curve / color-matrix filter over a source.

    Capability equivalent of the in-place frame transforms in
    /root/reference/src/cprocess/color.c (video_color_rgb_to_xyz_sdtv,
    video_color_xyz_to_srgb) and gammatab.c transfer curves, packaged as
    a pull filter. *transform* is one of 'rec709_to_linear_scene',
    'rec709_to_linear_display', 'linear_to_rec709', 'linear_to_srgb',
    'rgb_to_xyz_sdtv', 'xyz_to_srgb'.
    """

    TRANSFORMS = ('rec709_to_linear_scene', 'rec709_to_linear_display',
                  'linear_to_rec709', 'linear_to_srgb',
                  'rgb_to_xyz_sdtv', 'xyz_to_srgb')

    def __init__(self, source, transform):
        from canvas_tpu.ops import color as color_ops
        if transform not in self.TRANSFORMS:
            raise ValueError('unknown transform: %r' % (transform,))
        self.source = source
        self.transform = transform
        self._ops = color_ops

    def _apply(self, data):
        ops = self._ops
        name = self.transform
        if name == 'rgb_to_xyz_sdtv':
            return ops.rgb_to_xyz_sdtv_frame(data)
        if name == 'xyz_to_srgb':
            return ops.xyz_to_srgb_frame(data)
        return getattr(ops, 'transfer_' + name)(data)

    def _render_f16(self, frame_index, frame):
        if self.source is None:
            frame.current_window = EMPTY_BOX2I
            return
        self.source.render_f16(frame_index, frame)
        if frame.current_window.empty():
            return
        frame.data = self._apply(frame.data)


class VideoSequence(VideoSource):
    """Back-to-back list of (source, offset, length) clips
    (src/process/VideoSequence.c). Mutations via list protocol +
    insert/append; ``get_start_frame(i)`` gives a clip's first frame."""

    def __init__(self, items=None):
        self._items = []          # list of (source, offset, length) tuples
        self._starts = []         # parallel prefix sums
        self._lock = threading.RLock()
        if items:
            for item in items:
                self.append(item)

    def _recompute(self, from_index=0):
        start = 0 if from_index == 0 else (
            self._starts[from_index - 1] + self._items[from_index - 1][2])
        for i in range(from_index, len(self._items)):
            if len(self._starts) <= i:
                self._starts.append(0)
            self._starts[i] = start
            start += self._items[i][2]
        del self._starts[len(self._items):]

    @staticmethod
    def _check(value):
        source, offset, length = value
        if length < 0:
            raise ValueError('Length cannot be less than zero.')
        return (source, int(offset), int(length))

    def insert(self, i, value):
        value = self._check(value)
        with self._lock:
            if i < 0:
                i += len(self._items)
            i = max(0, min(i, len(self._items)))
            self._items.insert(i, value)
            self._recompute(i)

    def append(self, value):
        self.insert(len(self._items), value)

    def get_start_frame(self, i):
        with self._lock:
            if i < 0 or i >= len(self._items):
                raise IndexError('Index was out of range.')
            return self._starts[i]

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        with self._lock:
            return self._items[i]

    def __setitem__(self, i, value):
        if isinstance(i, slice):
            # slice assignment, like __getitem__/__delitem__ accept
            # slices (list semantics)
            items = [self._check(v) for v in value]
            with self._lock:
                self._items[i] = items
                self._recompute(0)
            return
        value = self._check(value)
        with self._lock:
            if i < 0:
                # normalize BEFORE _recompute: a raw negative index
                # rebuilt the prefix sums from range(-1, N) — starting
                # the scan from the LAST item's start and corrupting
                # every entry
                i += len(self._items)
            if not 0 <= i < len(self._items):
                raise IndexError('Index was out of range.')
            self._items[i] = value
            self._recompute(i)

    def __delitem__(self, i):
        with self._lock:
            if isinstance(i, int):
                if i < 0:
                    i += len(self._items)
                # same guard as __setitem__: a normalized-but-still-
                # negative index would silently delete the LAST clip
                if not 0 <= i < len(self._items):
                    raise IndexError('Index was out of range.')
            del self._items[i]
            self._recompute(0)

    def _pick(self, frame_index):
        """Return (source, offset, start_frame) for the clip containing
        frame_index, or None (VideoSequence.c:59-84)."""
        with self._lock:
            if frame_index < 0 or not self._items:
                return None
            # binary search over starts: last i with start <= frame_index
            i = bisect.bisect_right(self._starts, frame_index) - 1
            if i < 0:
                i = 0
            source, offset, length = self._items[i]
            if source is None or self._starts[i] + length <= frame_index:
                return None
            return source, offset, self._starts[i]

    def _render_f16(self, frame_index, frame):
        picked = self._pick(frame_index)
        if picked is None:
            frame.current_window = EMPTY_BOX2I
            return
        source, offset, start = picked
        source.render_f16(frame_index - start + offset, frame)

    def _render_f32(self, frame_index, frame):
        picked = self._pick(frame_index)
        if picked is None:
            frame.current_window = EMPTY_BOX2I
            return
        source, offset, start = picked
        source.render_f32(frame_index - start + offset, frame)


def _coerce_z(value):
    """Workspace z: an int like the reference's (workspace.c:62-69), or
    any comparable tuple — the graph layer stacks by a composite
    (lane, z) key. One workspace must not mix the two kinds."""
    return value if isinstance(value, tuple) else int(value)


class WorkspaceItem:
    """An item placed in a workspace: source at [x, x+length) with z-depth,
    source offset, and an arbitrary tag (workspace.c:62-69)."""

    __slots__ = ('_workspace', '_source', '_x', '_length', '_offset', '_z',
                 '_tag', '_seq')

    def __init__(self, workspace, source, x, length, offset, z, tag, seq):
        self._workspace = workspace
        self._source = source
        self._x = int(x)
        self._length = int(length)
        self._offset = int(offset)
        self._z = _coerce_z(z)
        self._tag = tag
        self._seq = seq        # insertion sequence number (z tie-break)

    source = property(lambda self: self._source)
    x = property(lambda self: self._x)
    length = property(lambda self: self._length)
    offset = property(lambda self: self._offset)
    z = property(lambda self: self._z)
    tag = property(lambda self: self._tag)

    def update(self, **kwargs):
        """Atomically update any of source/x/length/offset/z/tag
        (VideoWorkspace.c:412-414)."""
        ws = self._workspace
        if ws is None:
            raise ValueError('Item was removed from its workspace.')
        fields = ('source', 'x', 'length', 'offset', 'z', 'tag')
        unknown = set(kwargs) - set(fields)
        if unknown:
            # validate BEFORE mutating: "atomically" means a bad kwarg
            # must not leave the item half-updated
            raise TypeError('unexpected arguments: %r' % sorted(unknown))
        with ws._lock:
            # validate/coerce EVERYTHING first — "atomically" means a
            # rejected value must not leave the item half-updated
            coerced = {}
            for key in fields:
                if key in kwargs:
                    value = kwargs[key]
                    if key in ('x', 'length', 'offset'):
                        value = int(value)
                    elif key == 'z':
                        value = _coerce_z(value)
                        ws._check_z_kind(value, exclude=self)
                    coerced[key] = value
            for key, value in coerced.items():
                setattr(self, '_' + key, value)

    def __repr__(self):
        return ('WorkspaceItem(x={0._x}, length={0._length}, '
                'offset={0._offset}, z={0._z})'.format(self))


class _ItemSnapshot:
    """Immutable view of a WorkspaceItem's fields, taken under the
    workspace lock (see _composite_items): delivers update()'s
    documented atomicity to concurrent renders/plans."""

    __slots__ = ('_source', '_x', '_length', '_offset', '_z', '_seq')

    def __init__(self, item):
        self._source = item._source
        self._x = item._x
        self._length = item._length
        self._offset = item._offset
        self._z = item._z
        self._seq = item._seq

    source = property(lambda self: self._source)
    x = property(lambda self: self._x)
    length = property(lambda self: self._length)
    offset = property(lambda self: self._offset)
    z = property(lambda self: self._z)


class _WorkspaceBase:
    """Interval container shared by video and audio workspaces
    (src/cprocess/workspace.c). Items are queried by coordinate range;
    composite order is z ascending (higher z on top), later-added items
    below earlier ones at equal z (cmpz + reversal, workspace.c:102-105,
    494-521)."""

    def __init__(self):
        self._items = []
        self._lock = threading.RLock()
        self._next_seq = 0

    def _check_z_kind(self, z, exclude=None):
        """Ints and composite tuple z-keys cannot mix in one workspace:
        the composite sort would fail with an unattributable TypeError
        at render time, so reject at the mutation site instead.
        *exclude* is the item being updated — its own current z must
        not anchor the kind (a sole item could never change kinds)."""
        others = [it for it in self._items if it is not exclude]
        if others:
            existing = isinstance(others[0]._z, tuple)
            if isinstance(z, tuple) != existing:
                raise TypeError(
                    'workspace z must stay one kind: this workspace uses '
                    '%s z values, got %r'
                    % ('tuple' if existing else 'int', z))

    def add(self, source=None, x=0, length=1, offset=0, z=0, tag=None):
        with self._lock:
            self._check_z_kind(z)
            item = WorkspaceItem(self, source, x, length, offset, z, tag,
                                 self._next_seq)
            self._next_seq += 1
            self._items.append(item)
            return item

    def remove(self, item):
        with self._lock:
            self._items.remove(item)
            item._workspace = None

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def _composite_items(self, start, end):
        """Items overlapping [start, end], bottom-to-top, as SNAPSHOTS
        taken under the lock: WorkspaceItem.update() commits its fields
        one setattr at a time (under the lock), so composite/plan paths
        reading several fields from live items off-lock could tear —
        new _x with old _offset pulls the wrong media frame. Items with
        no source (placeholders, unresolvable refs the graph layer adds
        as None) contribute nothing."""
        with self._lock:
            active = [_ItemSnapshot(item) for item in self._items
                      if item._source is not None
                      and item._x <= end and start < item._x + item._length]
        # cmpz sorts descending z (stable in insertion order), then the
        # composite loop walks the list in reverse: ascending z, and for
        # equal z, reverse insertion order (later-added below). Done as
        # two stable passes so composite z-keys (tuples) work too.
        active.sort(key=lambda item: item._seq, reverse=True)
        active.sort(key=lambda item: item._z)
        return active


class VideoWorkspace(_WorkspaceBase, VideoSource):
    """Z-ordered compositing workspace (workspace_get_frame_f32,
    workspace.c:494-550): bottom item pulled directly, every higher item
    pulled into a temp frame and blended with over at full opacity."""

    def __init__(self):
        _WorkspaceBase.__init__(self)

    def _render_f32(self, frame_index, frame):
        items = self._composite_items(frame_index, frame_index)

        if not items:
            frame.current_window = EMPTY_BOX2I
            return

        bottom = items[0]
        bottom.source.render_f32(frame_index - bottom._x + bottom._offset, frame)

        for item in items[1:]:
            temp = RgbaFrameF32(frame.full_window)
            item.source.render_f32(frame_index - item._x + item._offset, temp)

            under_win = frame.current_window
            over_win = temp.current_window

            if under_win.empty():
                frame.data = mix_ops.attenuate(temp.data, 1.0)
                frame.current_window = box2i_intersect(over_win,
                                                       frame.full_window) \
                    if not over_win.empty() else EMPTY_BOX2I
                continue
            if over_win.empty():
                continue

            frame.data = mix_ops.over(frame.data, temp.data, 1.0)
            frame.current_window = box2i_intersect(
                _union_defined(under_win, over_win), frame.full_window)


# --- batched render-plan protocol (canvas_tpu.render) -----------------------
#
# Each source contributes an IR node to the batched device program. All
# frame-function evaluation and window algebra happens here (host side);
# the device program receives per-frame parameter arrays. plan_cuts
# reports frame indices where the *structure* of the graph changes so the
# planner can split ranges into fixed-shape segments.

def _emit_empty(ctx):
    from canvas_tpu.render import Node
    B = len(ctx.frames)
    return Node('empty', static=(B, ctx.window.height, ctx.window.width),
                windows=np.tile(np.asarray([0, 0, -1, -1], np.int64),
                                (B, 1)))


def _solid_emit(self, ctx):
    frames = np.asarray(ctx.frames, dtype=np.float64)
    # astype(np.float32) already copies — safe to clamp in place
    colors = self._color.get_values_array(frames).astype(np.float32)
    # Alpha clamps to [0, 1] at the FRAMEFUNC level, matching the
    # reference (basicframefuncs.c:335-346 clampf on component 3) and
    # the eager path (framefuncs.get_rgba_f32).
    colors[:, 3] = np.clip(colors[:, 3], 0.0, 1.0)
    wins = framefuncs.get_box2i_array(self._window, frames)
    return ctx.solid(colors, wins)


SolidColorVideoSource.emit = _solid_emit
EmptyVideoSource.emit = lambda self, ctx: _emit_empty(ctx)


def _cuts_of(source, start, stop):
    """Child structure cuts; sources without plan_cuts (host-staged
    custom VideoSources) contribute none — matching the hasattr guards
    the sequence/workspace/scaler emitters already use."""
    if source is None or not hasattr(source, 'plan_cuts'):
        return ()
    return source.plan_cuts(start, stop)


def _pass_plan_cuts(self, start, stop):
    cuts = set()
    if self.start_frame is not None:
        cuts.add(int(self.start_frame))
    if self.end_frame is not None:
        cuts.add(int(self.end_frame))
    if self._source is not None:
        for c in _cuts_of(self._source, start + self.offset,
                          stop + self.offset):
            cuts.add(int(c) - self.offset)
    return cuts


def _pass_emit(self, ctx):
    if not self._in_range(int(ctx.frames[0])):
        return _emit_empty(ctx)
    # Forward frame-union hints (pulldown's staging-dedup declaration)
    # through the retime so a coded child behind a pass-through still
    # stages ONE device plane stack for both pulldown children.
    hints = getattr(ctx.planner, '_frame_hints', None)
    if hints is not None and id(self) in hints:
        hints[id(self._source)] = hints[id(self)] + self.offset
    return ctx.with_frames(ctx.frames + self.offset).plan(self._source)


VideoPassThroughFilter.plan_cuts = _pass_plan_cuts
VideoPassThroughFilter.emit = _pass_emit


def _mix_plan_cuts(self, start, stop):
    cuts = set(_cuts_of(self.src_a, start, stop))
    cuts.update(_cuts_of(self.src_b, start, stop))
    if stop > start:
        # Cut at endpoint transitions of the clipped mix factor so a
        # segment is uniformly dormant-at-0, dormant-at-1, or mixing —
        # the emitter can then skip planning (and host-staging/decoding)
        # the source the reference's per-frame short-circuit never
        # pulls (video_mix.c:50-56).
        frames = np.arange(start, stop, dtype=np.float64)
        mix = np.clip(framefuncs.get_f32_array(self.mix_b, frames),
                      0.0, 1.0)
        for flags in (mix <= 0.0, mix >= 1.0):
            idx = np.nonzero(flags[1:] != flags[:-1])[0]
            cuts.update(int(start + 1 + i) for i in idx)
    return cuts


def _window_union_clip(wa, wb, full):
    """Vectorized per-frame window algebra: union of defined windows
    (empty acts as identity), clipped to *full*; both-empty stays empty.
    wa/wb: (B, 4) arrays."""
    from canvas_tpu.render import windows_to_array
    wa = windows_to_array(wa)
    wb = windows_to_array(wb)
    a_empty = (wa[:, 2] < wa[:, 0]) | (wa[:, 3] < wa[:, 1])
    b_empty = (wb[:, 2] < wb[:, 0]) | (wb[:, 3] < wb[:, 1])
    union = np.stack([np.minimum(wa[:, 0], wb[:, 0]),
                      np.minimum(wa[:, 1], wb[:, 1]),
                      np.maximum(wa[:, 2], wb[:, 2]),
                      np.maximum(wa[:, 3], wb[:, 3])], axis=1)
    merged = np.where(a_empty[:, None], wb,
                      np.where(b_empty[:, None], wa, union))
    clipped = np.stack([
        np.maximum(merged[:, 0], full.min.x),
        np.maximum(merged[:, 1], full.min.y),
        np.minimum(merged[:, 2], full.max.x),
        np.minimum(merged[:, 3], full.max.y)], axis=1)
    return np.where((a_empty & b_empty)[:, None],
                    np.asarray([0, 0, -1, -1], np.int64), clipped)


def _mix_emit(self, ctx):
    from canvas_tpu.render import Node, windows_to_array
    mix = np.clip(framefuncs.get_f32_array(self.mix_b, ctx.frames),
                  0.0, 1.0)
    # Whole-batch endpoint short-circuit (per-frame in the reference,
    # video_mix.c:50-56; _mix_plan_cuts cuts segments at transitions):
    # the dormant source is never planned, so a staged/coded child
    # isn't decoded and shipped for frames that contribute nothing.
    if (mix <= 0.0).all():
        return ctx.plan(self.src_a)
    if (mix >= 1.0).all():
        return ctx.plan(self.src_b)
    a = ctx.plan(self.src_a)
    b = ctx.plan(self.src_b)
    # Window metadata honors the endpoint short-circuits
    # (video_mix.c:50-56): at mix 0/1 only one source's window counts.
    wa = windows_to_array(a.windows)
    wb = windows_to_array(b.windows)
    union = _window_union_clip(wa, wb, ctx.window)
    windows = np.where((mix <= 0.0)[:, None], wa,
                       np.where((mix >= 1.0)[:, None], wb, union))

    # Peephole: a crossfade of two solids over IDENTICAL per-frame
    # windows is itself a solid whose color is the cross kernel's
    # associative alpha blend of the two constants (video_mix.c
    # cross: alpha-weighted rgb, NOT a channelwise lerp). This lets
    # the layer join adjacent solid runs in the fused stack kernel.
    if (a.op == 'solid' and b.op == 'solid'
            and np.array_equal(windows_to_array(a.windows),
                               windows_to_array(b.windows))):
        m = mix[:, None]
        ca = a.params['color']
        cb = b.params['color']
        aa = ca[:, 3:4] * (1.0 - m)
        ab = cb[:, 3:4] * m
        alpha = aa + ab
        safe = np.where(alpha != 0.0, alpha, 1.0)
        rgb = np.where(alpha != 0.0,
                       (ca[:, :3] * aa + cb[:, :3] * ab) / safe, 0.0)
        color = np.concatenate([rgb, alpha], axis=1)
        return Node('solid', static=a.static,
                    params={'color': color.astype(np.float32),
                            'box': a.params['box']},
                    windows=a.windows)

    return Node('mix', params={'mix_b': mix}, children=[a, b],
                windows=windows)


VideoMixFilter.plan_cuts = _mix_plan_cuts
VideoMixFilter.emit = _mix_emit


def _gain_plan_cuts(self, start, stop):
    return _cuts_of(self.source, start, stop)


def _gain_emit(self, ctx):
    from canvas_tpu.render import Node
    child = ctx.plan(self.source)
    B = len(ctx.frames)
    gain = framefuncs.get_f32_array(self.gain, ctx.frames)
    offset = framefuncs.get_f32_array(self.offset, ctx.frames)
    from canvas_tpu.render import rel_box_array
    box = rel_box_array(child.windows, ctx.window)
    return Node('gain_offset',
                params={'gain': gain, 'offset': offset, 'box': box},
                children=[child], windows=child.windows)


VideoGainOffsetFilter.plan_cuts = _gain_plan_cuts
VideoGainOffsetFilter.emit = _gain_emit


def _seq_plan_cuts(self, start, stop):
    cuts = set()
    with self._lock:
        for i, (source, offset, length) in enumerate(self._items):
            s = self._starts[i]
            cuts.add(s)
            cuts.add(s + length)
            if source is not None and hasattr(source, 'plan_cuts'):
                lo = max(start, s)
                hi = min(stop, s + length)
                if lo < hi:
                    for c in source.plan_cuts(lo - s + offset,
                                              hi - s + offset):
                        cuts.add(int(c) - offset + s)
    return cuts


def _seq_emit(self, ctx):
    picked = self._pick(int(ctx.frames[0]))
    if picked is None:
        return _emit_empty(ctx)
    source, offset, start = picked
    # forward frame-union hints through the retime, like _pass_emit: a
    # coded child reached through a sequence under pulldown must stage
    # ONE device plane stack for both pulldown children
    hints = getattr(ctx.planner, '_frame_hints', None)
    if hints is not None and id(self) in hints:
        hints[id(source)] = hints[id(self)] - start + offset
    return ctx.with_frames(ctx.frames - start + offset).plan(source)


VideoSequence.plan_cuts = _seq_plan_cuts
VideoSequence.emit = _seq_emit


def _ws_plan_cuts(self, start, stop):
    cuts = set()
    with self._lock:
        # snapshots: reading x/length/offset from live items off-lock
        # races update()'s field-by-field commit (see _composite_items)
        items = [_ItemSnapshot(item) for item in self._items]
    for item in items:
        cuts.add(item._x)
        cuts.add(item._x + item._length)
        if item._source is not None and hasattr(item._source, 'plan_cuts'):
            lo = max(start, item._x)
            hi = min(stop, item._x + item._length)
            if lo < hi:
                for c in item._source.plan_cuts(
                        lo - item._x + item._offset,
                        hi - item._x + item._offset):
                    cuts.add(int(c) - item._offset + item._x)
    return cuts



def _solid_layer_params(node):
    """If *node* is a solid (optionally wrapped in gain_offset-of-solid),
    return (color (B,4), box (B,4) i32 rel, gain (B,), offset (B,),
    windows); else None. These are the layers the fused solid_stack
    kernel can composite pointwise."""
    if node.op == 'solid':
        B = node.params['color'].shape[0]
        return (node.params['color'], node.params['box'],
                np.ones(B, np.float32), np.zeros(B, np.float32),
                node.windows)
    if (node.op == 'gain_offset' and len(node.children) == 1
            and node.children[0].op == 'solid'):
        solid = node.children[0]
        return (solid.params['color'], solid.params['box'],
                node.params['gain'], node.params['offset'],
                node.windows)
    return None


def _solid_cell_tables(colors, boxes, gains, offsets, H, W):
    """Piecewise-constant cell decomposition of an L-layer solid fold.

    The composite of L axis-aligned solid(+gain) boxes is CONSTANT on
    each cell of the grid cut by the boxes' edges — at most
    (2L+1) x (2L+1) cells. The premultiplied fold therefore runs ON
    HOST over cells (O(B * L * cells) scalar numpy f32 ops, same op
    order as the per-pixel math, so bit-identical values), and the
    device program reduces to a one-hot band SELECTION — two tiny
    matmuls ending straight in the output dtype — instead of L masked
    folds over every pixel.

    colors (L, B, 4) f32; boxes (L, B, 4) i32 [y0, y1, x0, x1] relative
    inclusive (empty = y1 < y0); gains/offsets (L, B) f32. Returns
    (ey (B, nb+1) i32, ex (B, nc+1) i32, pt (B, 5, nb, nc) f32) where
    pt stacks [P_r, P_g, P_b (premultiplied), A, T (transmittance
    prod(1-a))] per cell; bands tile [0, H) / [0, W) exactly (empty
    bands allowed — their indicator rows select nothing).
    """
    L, B = colors.shape[0], colors.shape[1]
    y0 = boxes[:, :, 0]
    y1 = boxes[:, :, 1]
    x0 = boxes[:, :, 2]
    x1 = boxes[:, :, 3]
    # Band edges per frame: every box's start and one-past-end, plus
    # the window bounds; sorted (duplicates = empty bands).
    ey = np.concatenate([
        np.zeros((B, 1), np.int64), np.full((B, 1), H, np.int64),
        np.clip(y0.T, 0, H), np.clip(y1.T + 1, 0, H)], axis=1)
    ex = np.concatenate([
        np.zeros((B, 1), np.int64), np.full((B, 1), W, np.int64),
        np.clip(x0.T, 0, W), np.clip(x1.T + 1, 0, W)], axis=1)
    ey = np.sort(ey, axis=1)
    ex = np.sort(ex, axis=1)
    sy = ey[:, :-1]                       # (B, nb) band starts
    sx = ex[:, :-1]                       # (B, nc)

    # Layer coverage per band: bands never straddle a box edge, so a
    # band is inside iff its START is (nonempty bands only; empty ones
    # are unselectable).
    rcov = ((sy[None] >= y0[:, :, None]) & (sy[None] <= y1[:, :, None]))
    ccov = ((sx[None] >= x0[:, :, None]) & (sx[None] <= x1[:, :, None]))

    nb = sy.shape[1]
    nc = sx.shape[1]
    accP = [np.zeros((B, nb, nc), np.float32) for _ in range(3)]
    accA = np.zeros((B, nb, nc), np.float32)
    accT = np.ones((B, nb, nc), np.float32)
    for l in range(L):
        m = rcov[l][:, :, None] & ccov[l][:, None, :]     # (B, nb, nc)
        a_s = colors[l, :, 3].astype(np.float32)
        a = np.where(m, a_s[:, None, None], np.float32(0.0))
        keep = np.float32(1.0) - a
        for c in range(3):
            # same f32 op order as the per-pixel fold: (c*g+o) then *a
            pa = ((colors[l, :, c].astype(np.float32)
                   * gains[l].astype(np.float32)
                   + offsets[l].astype(np.float32))
                  * a_s)
            accP[c] = np.where(m, pa[:, None, None],
                               np.float32(0.0)) + accP[c] * keep
        accA = a + accA * keep
        accT = accT * keep
    pt = np.stack(accP + [accA, accT], axis=1)            # (B, 5, nb, nc)
    return ey.astype(np.int32), ex.astype(np.int32), pt


def _fold_over_windows(window_arrays, full):
    """Fold per-frame window metadata with over semantics, vectorized
    (mirrors VideoWorkspace._render_f32): under empty -> clipped over;
    over empty -> under (unclipped); else clipped union."""
    acc = window_arrays[0]
    for over in window_arrays[1:]:
        under_empty = (acc[:, 2] < acc[:, 0]) | (acc[:, 3] < acc[:, 1])
        over_empty = (over[:, 2] < over[:, 0]) | (over[:, 3] < over[:, 1])
        merged = _window_union_clip(acc, over, full)
        keep_under = (~under_empty) & over_empty
        acc = np.where(keep_under[:, None], acc, merged)
    return acc


def _compress_solid_runs(children, ctx):
    """Replace runs of >= 2 consecutive solid(/gain) layers with one
    fused node: 'solid_stack' (the fused XLA fold, ops/composite.py) by
    default, or the 'solid_cells' cell-table selection with
    CANVAS_SOLID_CELLS=1.

    The cell-table design (_solid_cell_tables) folds per
    piecewise-constant cell on host and selects with one-hot matmuls:
    algorithmically minimal, but the (B, 5, H, W) selection tensor
    materializes between matmul and consumers. It is bit-exact and fully
    tested, and off by default; it has not been timed on the GPU."""
    import os
    from canvas_tpu.render import Node
    use_cells = os.environ.get('CANVAS_SOLID_CELLS', '') == '1'
    out = []
    run = []

    def flush():
        if len(run) < 2:
            out.extend(r[0] for r in run)
            run.clear()
            return
        colors = np.stack([p[0] for (_n, p) in run])
        boxes = np.stack([p[1] for (_n, p) in run]).astype(np.int32)
        gains = np.stack([p[2] for (_n, p) in run])
        offsets = np.stack([p[3] for (_n, p) in run])
        # window metadata: fold the run's windows with over semantics
        full = ctx.window
        acc = _fold_over_windows([p[4] for (_n, p) in run], full)
        if use_cells:
            ey, ex, pt = _solid_cell_tables(colors, boxes, gains,
                                            offsets, full.height,
                                            full.width)
            out.append(Node('solid_cells',
                            static=(full.height, full.width),
                            params={'ey': ey, 'ex': ex, 'pt': pt},
                            windows=acc))
        else:
            out.append(Node('solid_stack',
                            static=(len(run), full.height, full.width),
                            params={'color': colors, 'box': boxes,
                                    'gain': gains, 'offset': offsets},
                            windows=acc))
        run.clear()

    for child in children:
        p = _solid_layer_params(child)
        if p is None:
            flush()
            out.append(child)
        else:
            run.append((child, p))
    flush()
    return out


def _subtree_stages(node):
    """True if the subtree HOST-PULLED data during planning keyed by the
    plan window (ctx.stage): re-planning it at a damage-region window
    would re-pull and re-ship every frame AND change pull semantics for
    window-sensitive children. The coded staging ops (u8_linearize /
    dv_recon* / planar_recon_rows) are deliberately NOT included: their
    decode caches are frame-keyed and window-independent, so a region
    replan is a cache hit — and region placement is a large win for
    small coded layers."""
    if node.op in ('stage', 'stage_rows'):
        return True
    return any(_subtree_stages(c) for c in node.children)



def _statically_opaque_full(node, full):
    """True if *node* provably renders an OPAQUE frame covering the whole
    target window for every frame in the batch — the planner-time form
    of the reference's "opaque" media hint
    (docs/sphinx/feature-proposal/hints.rst): layers beneath such a
    layer contribute nothing and are dropped from the program."""
    from canvas_tpu.render import windows_to_array
    if node.op == 'gain_offset' and node.children[0].op == 'solid':
        node = node.children[0]          # gain/offset leaves alpha alone
    if node.op == 'solid':
        w = windows_to_array(node.windows)
        covers = ((w[:, 0] <= full.min.x) & (w[:, 1] <= full.min.y) &
                  (w[:, 2] >= full.max.x) & (w[:, 3] >= full.max.y)).all()
        return bool(covers and
                    (node.params['color'][:, 3] >= 1.0).all())
    return False

def _ws_emit(self, ctx):
    from canvas_tpu.render import Node, windows_to_array
    f0 = int(ctx.frames[0])
    items = self._composite_items(f0, f0)
    if not items:
        return _emit_empty(ctx)

    children = []
    full = ctx.window
    for item in items:
        sub = ctx.with_frames(ctx.frames - item._x + item._offset)
        child = sub.plan(item._source)

        # Damage-region reduction: a layer whose per-frame content union
        # covers well under the full frame is re-planned into just that
        # box and composited with a static placement — the downstream
        # math (scaler einsums, blends) shrinks to the covered area.
        # Factored scaled solids ('scale_solid*') stay region-placed
        # like any non-solid layer: an unplaced variant folding them
        # into one full-frame fused XLA chain pays every layer's math on
        # every pixel, which the region-limited structure avoids (the
        # two have not been timed against each other on the GPU).
        if (child.op not in ('solid', 'solid_stack', 'empty')
                and not (child.op == 'gain_offset'
                         and child.children[0].op == 'solid')
                and not _subtree_stages(child)):
            w = windows_to_array(child.windows)
            nonempty = (w[:, 2] >= w[:, 0]) & (w[:, 3] >= w[:, 1])
            if not nonempty.any():
                continue                      # contributes nothing
            wn = w[nonempty]
            x0 = max(int(wn[:, 0].min()), full.min.x)
            y0 = max(int(wn[:, 1].min()), full.min.y)
            x1 = min(int(wn[:, 2].max()), full.max.x)
            y1 = min(int(wn[:, 3].max()), full.max.y)
            if x1 < x0 or y1 < y0:
                continue
            # Quantize the box to the region block grid
            # (composite.REGION_BLOCK, rows 64, cols 128): origin aligns
            # DOWN, size rounds UP. Origins ride as dynamic params, so
            # every frame range of the same motion produces identical
            # program geometry (compiled-program reuse). The box may
            # overhang the frame edge; edge blocks clip.
            QR, QC = REGION_BLOCK
            x0 = full.min.x + ((x0 - full.min.x) // QC) * QC
            y0 = full.min.y + ((y0 - full.min.y) // QR) * QR
            w_box = -((x1 - x0 + 1) // -QC) * QC
            h_box = -((y1 - y0 + 1) // -QR) * QR
            x1 = x0 + w_box - 1
            y1 = y0 + h_box - 1
            area = h_box * w_box
            # The quantized box may overhang the frame's bottom/right
            # edge: origin aligns down and size rounds up, but content
            # was clipped to the frame first, so the end always lands
            # within the frame's 64x128-aligned envelope, which the
            # region pass pads to. (Rejecting overhang would drop every
            # motion phase that touches a frame edge into the
            # full-frame fused chain.)
            if area < 0.7 * full.height * full.width:
                dy0 = y0 - full.min.y
                dx0 = x0 - full.min.x
                # region_over requires block-aligned offsets; the
                # quantization above guarantees it — fail loudly here
                # (host side, offsets become dynamic device params) if a
                # future edit breaks the invariant instead of letting
                # the kernel floor them silently.
                assert dy0 % QR == 0 and dx0 % QC == 0, (dy0, dx0)
                # sem='keep': the region box is planner LAYOUT, not a
                # semantic re-window — window-sensitive children (scaler
                # tap clipping) must still follow the original pull
                # windows or the replan changes pixels vs the pull path.
                replanned = sub.with_window(
                    box2i(x0, y0, x1, y1), sem='keep').plan(item._source)
                child = Node('placed',
                             static=(h_box, w_box),
                             params={'dy0': np.int32(dy0),
                                     'dx0': np.int32(dx0)},
                             children=[replanned],
                             windows=replanned.windows)
        children.append(child)

    if not children:
        return _emit_empty(ctx)

    # Opaque-hint pruning: everything below the topmost provably-opaque
    # full-frame layer is invisible — drop it from the program.
    for i in range(len(children) - 1, 0, -1):
        if _statically_opaque_full(children[i], full):
            children = children[i:]
            break

    children = _compress_solid_runs(children, ctx)

    if len(children) == 1 and children[0].op != 'placed':
        return children[0]

    acc = _fold_over_windows([windows_to_array(c.windows)
                              for c in children], full)
    # quality<=9 (reference hint scale, framework.h:510-513 and the
    # hints proposal's "degrade for speed" intent): inter-pass (P, A)
    # accumulators store bf16 between composite passes — ~half the
    # accumulator HBM traffic, within bf16 rounding of the f32 chain.
    # The tag lives in the SIGNATURE so the program cache keys it
    # (quality 10 keeps the plain (H, W) static — identical signatures
    # and bit-exact programs as before).
    acc16 = getattr(ctx.planner, 'quality', 10) <= 9
    return Node('over_stack',
                static=((full.height, full.width, 'acc16') if acc16
                        else (full.height, full.width)),
                children=children, windows=acc)


VideoWorkspace.plan_cuts = _ws_plan_cuts
VideoWorkspace.emit = _ws_emit


def _scaler_plan_cuts(self, start, stop):
    cuts = set()
    if self.source is not None and hasattr(self.source, 'plan_cuts'):
        cuts.update(self.source.plan_cuts(start, stop))
    if self.source is not None and stop > start:
        # Cut where the zero-factor or identity flag flips, so each
        # segment is uniformly zero (EMPTY emit), uniformly identity
        # (child pass-through — the reference's identity short-circuit
        # ignores source_rect, video_scale.c:295-298), or uniformly
        # scaling. Without these cuts a mixed batch either fell back to
        # host staging (zero) or pushed identity frames down the tap
        # path, which CLIPS to source_rect and diverged from the pull
        # path.
        frames = np.arange(start, stop, dtype=np.float64)
        f_arr = framefuncs.get_v2f_array(self.scale_factors, frames)
        tp = framefuncs.get_v2f_array(self.target_point, frames)
        sp = framefuncs.get_v2f_array(self.source_point, frames)
        zero = (f_arr == 0.0).any(axis=1)
        ident = ((f_arr == 1.0).all(axis=1) & (tp == sp).all(axis=1))
        for flags in (zero, ident):
            idx = np.nonzero(flags[1:] != flags[:-1])[0]
            cuts.update(int(start + 1 + i) for i in idx)
    return sorted(cuts)


def _as_scaled_solid(child):
    """If *child* is a single solid layer (optionally gain/offset
    wrapped), return its per-frame (B, 4) f32 color with gain/offset
    folded into rgb — else None.

    A solid's frame is rank-1 separable per axis: color x
    row-indicator x col-indicator of its window (which is exactly
    child.windows, the bounds the scaler clips taps to). Scaling it
    therefore needs only per-axis tap row-sums, not the (T,S)x(S,W)
    contractions — render.py 'scale_solid'/'scale_solid_dyn'. Folding
    (c*g+o) on the host is the same f32 multiply-add the batched
    'gain_offset' op performs on device."""
    import os
    if os.environ.get('CANVAS_SCALE_SOLID', '1') == '0':
        return None                     # A/B gate: keep the einsum path
    g = o = None
    node = child
    if (node.op == 'gain_offset' and len(node.children) == 1
            and node.children[0].op == 'solid'):
        g = node.params['gain']
        o = node.params['offset']
        node = node.children[0]
    if node.op != 'solid' or node.children:
        return None
    color = np.array(node.params['color'], np.float32, copy=True)
    if g is not None:
        color[:, :3] = (color[:, :3] * g[:, None].astype(np.float32)
                        + o[:, None].astype(np.float32))
    return color


def _scaler_emit(self, ctx):
    from canvas_tpu.render import Node
    if self.source is None:
        return _emit_empty(ctx)

    B = len(ctx.frames)
    tp_arr = framefuncs.get_v2f_array(self.target_point, ctx.frames)
    sp_arr = framefuncs.get_v2f_array(self.source_point, ctx.frames)
    f_arr = framefuncs.get_v2f_array(self.scale_factors, ctx.frames)
    rects = framefuncs.get_box2i_array(self.source_rect, ctx.frames)

    zero = (f_arr == 0.0).any(axis=1)
    if zero.any():
        if zero.all():
            return _emit_empty(ctx)
        return ctx.stage(self)      # mixed zero/nonzero inside a segment

    if (f_arr == 1.0).all() and (tp_arr == sp_arr).all():
        return ctx.plan(self.source)

    # Per-frame fetch boxes from the SEMANTIC pull windows (the window
    # the eager chain would hand each frame's pull — usually the layout
    # window, but pulldown hands frame b's pulls frame a's windows):
    # video_scale.c:299-307's target->source map with its ±1 margin,
    # intersected with the per-frame source_rect. These boxes are the
    # eager path's pulled-source bounds, and the reference DROPS taps
    # outside the pulled rect without renormalizing (video_scale.c:
    # 103-110) — so they clip the planner's taps below, or the batched
    # path diverges from the pull path at fetch edges.
    full = ctx.window
    fx_a, fy_a = f_arr[:, 0], f_arr[:, 1]
    tx_a, ty_a = tp_arr[:, 0], tp_arr[:, 1]
    sx_a, sy_a = sp_arr[:, 0], sp_arr[:, 1]
    sem = ctx.sem_array().astype(np.float64)
    b0 = np.trunc(sx_a - (tx_a - sem[:, 0]) / fx_a).astype(np.int64) - 1
    b1 = np.trunc(sy_a - (ty_a - sem[:, 1]) / fy_a).astype(np.int64) - 1
    b2 = np.trunc(sx_a + (sem[:, 2] - tx_a) / fx_a).astype(np.int64) + 1
    b3 = np.trunc(sy_a + (sem[:, 3] - ty_a) / fy_a).astype(np.int64) + 1
    fb_all = np.stack([np.maximum(b0, rects[:, 0]),
                       np.maximum(b1, rects[:, 1]),
                       np.minimum(b2, rects[:, 2]),
                       np.minimum(b3, rects[:, 3])], axis=1)
    # frames whose semantic window is empty pull nothing (the eager
    # path returns an empty frame before fetching)
    fb_all[(sem[:, 2] < sem[:, 0]) | (sem[:, 3] < sem[:, 1])] = (
        0, 0, -1, -1)
    # The FETCH additionally intersects the layout-needed boxes: source
    # pixels actually read by outputs inside the LAYOUT window
    # (ctx.window). Taps live within width = max(1, 1/f) source pixels
    # of an output's center (axis_taps), so the layout map expanded by
    # ceil(width)+1 bounds every tap an in-layout output can read.
    # Without this, region replans (layout ⊂ semantic window) fetched
    # their child at full-frame extent — a measured ~5% device-time
    # regression when sem_windows landed. Taps between this fetch and
    # the semantic bounds are only used by out-of-layout outputs, which
    # the node never materializes.
    wx_f = np.maximum(1.0, 1.0 / fx_a)
    wy_f = np.maximum(1.0, 1.0 / fy_a)
    cx0 = sx_a + (full.min.x - tx_a) / fx_a
    cx1 = sx_a + (full.max.x - tx_a) / fx_a
    cy0 = sy_a + (full.min.y - ty_a) / fy_a
    cy1 = sy_a + (full.max.y - ty_a) / fy_a
    mx = np.ceil(wx_f).astype(np.int64) + 1
    my = np.ceil(wy_f).astype(np.int64) + 1
    fetch_fb = np.stack(
        [np.maximum(fb_all[:, 0],
                    np.floor(np.minimum(cx0, cx1)).astype(np.int64) - mx),
         np.maximum(fb_all[:, 1],
                    np.floor(np.minimum(cy0, cy1)).astype(np.int64) - my),
         np.minimum(fb_all[:, 2],
                    np.ceil(np.maximum(cx0, cx1)).astype(np.int64) + mx),
         np.minimum(fb_all[:, 3],
                    np.ceil(np.maximum(cy0, cy1)).astype(np.int64) + my)],
        axis=1)
    ok = (fetch_fb[:, 2] >= fetch_fb[:, 0]) & (fetch_fb[:, 3] >= fetch_fb[:, 1])
    if not ok.any():
        return _emit_empty(ctx)
    fb = fetch_fb[ok]
    # Quantize the fetch SIZE up to a 64px multiple (origin exact):
    # animated parameters then reuse one compiled program while the
    # fetch region drifts (out-of-window taps carry zero weight, so the
    # extra border never changes values).
    Q = 64
    fx0 = int(fb[:, 0].min())
    fy0 = int(fb[:, 1].min())
    fw = -((int(fb[:, 2].max()) - fx0 + 1) // -Q) * Q
    fh = -((int(fb[:, 3].max()) - fy0 + 1) // -Q) * Q
    fetch = box2i(fx0, fy0, fx0 + fw - 1, fy0 + fh - 1)

    # The child renders at the (quantized) fetch UNION, but its
    # semantic pull windows are the per-frame fetch boxes — a nested
    # scaler must clip ITS taps the way the eager chain's per-frame
    # child pull would.
    child = ctx.with_window(fetch, sem=fb_all).plan(self.source)

    # Low-quality hint (reference scale 1-11, framework.h:510-513):
    # quality <= 5 degrades to bilinear taps + default-precision (TF32
    # on the GPU) contraction on the dynamic path (hints.rst's intent: previews
    # trade exactness for speed; quality >= 10 stays bit-exact).
    lq = getattr(ctx.planner, 'quality', 10) <= 5

    constant = (not lq
                and (tp_arr == tp_arr[0]).all()
                and (sp_arr == sp_arr[0]).all()
                and (f_arr == f_arr[0]).all()
                and (rects == rects[0]).all())

    from canvas_tpu.render import tile_window, windows_to_array
    # Taps clip to content WITHIN each frame's fetch box (fb_all folds
    # in the source_rect): the child is planned over the (quantized)
    # fetch-union window, so its content windows can extend past a
    # frame's rect or fetch bounds — the eager pull sees a
    # fetch-clipped child and DROPS those taps unrenormalized
    # (video_scale.c:103-110), so the planner must too.
    cwin = windows_to_array(child.windows)
    cwin = np.stack([np.maximum(cwin[:, 0], fb_all[:, 0]),
                     np.maximum(cwin[:, 1], fb_all[:, 1]),
                     np.minimum(cwin[:, 2], fb_all[:, 2]),
                     np.minimum(cwin[:, 3], fb_all[:, 3])], axis=1)

    if constant and (cwin == cwin[0]).all():
        cw0 = box2i(int(cwin[0, 0]), int(cwin[0, 1]),
                    int(cwin[0, 2]), int(cwin[0, 3]))
        if cw0.empty():
            return _emit_empty(ctx)
        plan = scale_ops.scale_plan(full, v2f(*tp_arr[0]), cw0,
                                    v2f(*sp_arr[0]), v2f(*f_arr[0]))
        if plan is None:
            return _emit_empty(ctx)
        Wy_cur, Wx_cur, out_window = plan

        def expand(W, lo_cur, hi_cur, lo_full, hi_full):
            out = np.zeros((W.shape[0], hi_full - lo_full + 1), np.float32)
            a = lo_cur - lo_full
            out[:, a:a + W.shape[1]] = W
            return out

        Wy = expand(Wy_cur, cw0.min.y, cw0.max.y, fetch.min.y, fetch.max.y)
        Wx = expand(Wx_cur, cw0.min.x, cw0.max.x, fetch.min.x, fetch.max.x)
        out_window = box2i_intersect(out_window, full)
        solid_color = _as_scaled_solid(child)
        if solid_color is not None:
            # Rank-1 child: the tap matrices contract with a constant
            # within the child window (== the taps' support), so each
            # axis reduces to its row-sums (f64-accumulated on host).
            return Node(
                'scale_solid',
                params={'ry': Wy.sum(axis=1, dtype=np.float64)
                               .astype(np.float32),
                        'rx': Wx.sum(axis=1, dtype=np.float64)
                               .astype(np.float32),
                        'color': solid_color},
                windows=tile_window(out_window, B))
        return Node('scale', params={'wy': Wy, 'wx': Wx}, children=[child],
                    windows=tile_window(out_window, B))

    # Animated: taps are computed ON DEVICE from per-frame scalars
    # (render.py 'scale_taps_dyn'). Host work is just window metadata.
    empty_mask = (cwin[:, 2] < cwin[:, 0]) | (cwin[:, 3] < cwin[:, 1])
    if empty_mask.all():
        return _emit_empty(ctx)

    ylo = np.where(empty_mask, 1, cwin[:, 1]).astype(np.float64)
    yhi = np.where(empty_mask, 0, cwin[:, 3]).astype(np.float64)
    xlo = np.where(empty_mask, 1, cwin[:, 0]).astype(np.float64)
    xhi = np.where(empty_mask, 0, cwin[:, 2]).astype(np.float64)
    fy, fx = f_arr[:, 1], f_arr[:, 0]
    tpy, tpx = tp_arr[:, 1], tp_arr[:, 0]
    spy, spx = sp_arr[:, 1], sp_arr[:, 0]

    # Static K per axis: integers strictly inside a 2*width support
    wy_max = 1.0 if lq else float(np.max(np.where(fy > 1.0, 1.0, 1.0 / fy)))
    wx_max = 1.0 if lq else float(np.max(np.where(fx > 1.0, 1.0, 1.0 / fx)))
    Ky = int(np.ceil(2.0 * wy_max)) + 1
    Kx = int(np.ceil(2.0 * wx_max)) + 1

    # Output windows: t where the filter support can reach the source
    # window — interval algebra, conservative by at most one pixel at
    # each edge (the extra rows/cols carry zero weights, so data is
    # unaffected).
    def out_range(f, tp, sp, lo, hi, t_min, t_max):
        width = (np.ones_like(f) if lq
                 else np.where(f > 1.0, 1.0, 1.0 / f))
        t_low = (lo - width - sp) * f + tp
        t_high = (hi + width - sp) * f + tp
        lo_i = np.maximum(np.floor(t_low) + 1, t_min)
        hi_i = np.minimum(np.ceil(t_high) - 1, t_max)
        return lo_i.astype(np.int64), hi_i.astype(np.int64)

    y0, y1 = out_range(fy, tpy, spy, ylo, yhi, full.min.y, full.max.y)
    x0, x1 = out_range(fx, tpx, spx, xlo, xhi, full.min.x, full.max.x)
    bad = empty_mask | (y1 < y0) | (x1 < x0)
    windows = np.stack([x0, y0, x1, y1], axis=1)
    windows[bad] = (0, 0, -1, -1)

    dyn_params = {
        'tly': np.float32(full.min.y), 'tlx': np.float32(full.min.x),
        'fy': fy.astype(np.float32), 'fx': fx.astype(np.float32),
        'tpy': tpy.astype(np.float32), 'tpx': tpx.astype(np.float32),
        'spy': (spy - fetch.min.y).astype(np.float32),
        'spx': (spx - fetch.min.x).astype(np.float32),
        'yl': (ylo - fetch.min.y).astype(np.float32),
        'yh': (yhi - fetch.min.y).astype(np.float32),
        'xl': (xlo - fetch.min.x).astype(np.float32),
        'xh': (xhi - fetch.min.x).astype(np.float32),
    }
    solid_color = _as_scaled_solid(child)
    if solid_color is not None:
        # Rank-1 child: taps clipped to [yl,yh]/[xl,xh] already encode
        # the solid's per-frame indicator, so the device program only
        # row-sums the (B, T, K) weights — no child, no contractions.
        dyn_params['color'] = solid_color
        return Node('scale_solid_dyn',
                    static=(Ky, Kx, full.height, full.width, lq),
                    params=dyn_params, windows=windows)
    return Node(
        'scale_taps_dyn',
        static=(Ky, Kx, full.height, full.width, lq),
        params=dyn_params,
        children=[child], windows=windows)


VideoScaler.plan_cuts = _scaler_plan_cuts
VideoScaler.emit = _scaler_emit


def _transfer_plan_cuts(self, start, stop):
    return _cuts_of(self.source, start, stop)


def _transfer_emit(self, ctx):
    from canvas_tpu.render import Node
    if self.source is None:
        # the eager path renders empty for a None source; planning must
        # agree instead of raising
        return _emit_empty(ctx)
    child = ctx.plan(self.source)
    windows = child.windows

    def lut_node(name, inner):
        # No 'table' param: the op name in static selects the curve, and
        # render._device_transfer gathers from the same 64K LUT the
        # eager path uses.
        return Node('transfer', static=(name,),
                    children=[inner], windows=windows)

    def matrix_node(m, inner):
        return Node('matrix', params={'m': np.asarray(m, np.float32)},
                    children=[inner], windows=windows)

    name = self.transform
    ops = self._ops
    if name == 'rgb_to_xyz_sdtv':
        node = lut_node('rec709_to_linear_scene', child)
        return matrix_node(ops.RGB_TO_XYZ_SDTV, node)
    if name == 'xyz_to_srgb':
        node = matrix_node(ops.XYZ_TO_SRGB, child)
        return lut_node('linear_to_srgb', node)
    return lut_node(name, child)


VideoColorTransferFilter.plan_cuts = _transfer_plan_cuts
VideoColorTransferFilter.emit = _transfer_emit
