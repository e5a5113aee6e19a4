"""Background frame prefetcher.

JAX equivalent of the reference's src/process/VideoPullQueue.c: a
small thread pool pulls frames (host decode + device render) off the UI
thread and marshals results back through a dispatch callable. The
reference marshals onto the GLib main loop (g_timeout_add_full,
VideoPullQueue.c:72-97); here the *dispatch* argument plugs into whatever
loop the app has (Qt's singleShot, asyncio's call_soon_threadsafe); the
default runs callbacks on a single dispatch thread.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

__all__ = ['VideoPullQueue', 'VideoPullQueueItem']


class VideoPullQueueItem:
    """One queued pull (VideoPullQueue.c item); returned by enqueue()."""
    __slots__ = ('source', 'frame_index', 'window', 'callback', 'data',
                 'cancelled', 'backend_mode')

    def __init__(self, source, frame_index, window, callback, data):
        self.source = source
        self.frame_index = frame_index
        self.window = window
        self.callback = callback
        self.data = data
        self.cancelled = False
        # backend mode is thread-local (backend._state); capture the
        # enqueuing thread's choice so pool workers honor it — without
        # this a force_backend('jax') caller got numpy worker pulls
        from canvas_tpu import backend
        self.backend_mode = backend.get_backend()

    def cancel(self):
        """Best-effort cancel (VideoPullQueue.c:48 volatile flag)."""
        self.cancelled = True


class VideoPullQueue:
    """enqueue(source, frame_index, window, callback, data) -> item.

    callback(frame_index, frame, data) runs via *dispatch* once the
    RgbaFrameF16 is ready. workers=2 mirrors the reference's pool
    (VideoPullQueue.c:110).
    """

    def __init__(self, workers=2, dispatch=None, planner_cache=32):
        from canvas_tpu import backend
        backend.ensure_initialized()  # init on the constructing thread
        self._workers = workers
        self._planner_cache = max(1, int(planner_cache))
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix='canvas-pull')
        if dispatch is None:
            self._dispatch_queue = queue.Queue()
            self._dispatch_thread = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name='canvas-pull-dispatch')
            self._dispatch_thread.start()
            dispatch = self._dispatch_queue.put
        else:
            self._dispatch_queue = None
        self._dispatch = dispatch
        # planner cache: OrderedDict LRU + one lock per planner —
        # RenderPlanner.render mutates shared per-call state
        # (_stage_cache/_frame_hints), so two pool workers pulling the
        # same (source, window) must serialize on it (playback.py
        # documents the same constraint for its _render_lock)
        from collections import OrderedDict
        self._planners = OrderedDict()
        self._planners_lock = threading.Lock()
        self._closed = False

    def _dispatch_loop(self):
        while True:
            fn = self._dispatch_queue.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:
                import traceback
                traceback.print_exc()

    def enqueue(self, source, frame_index, window, callback, data=None):
        if self._closed:
            raise RuntimeError('queue is closed')
        item = VideoPullQueueItem(source, frame_index, window, callback, data)
        self._pool.submit(self._work, item)
        return item

    def _work(self, item):
        if item.cancelled:
            return
        from canvas_tpu import backend
        saved_mode = backend.get_backend()
        backend.set_backend(item.backend_mode)
        try:
            frame = self._render(item)
        except Exception:
            # the future is never read: an escaped exception would be
            # silently swallowed and the callback never fire, leaving
            # the UI waiting forever — deliver None instead
            from canvas_tpu.logging import getLogger
            getLogger(__name__).warning('frame pull failed',
                                        exc_info=True)
            frame = None
        finally:
            backend.set_backend(saved_mode)   # pool threads are reused
        if item.cancelled:
            return

        def deliver():
            if not item.cancelled:
                item.callback(item.frame_index, frame, item.data)

        self._dispatch(deliver)

    def _render(self, item):
        """One frame via the batched planner when the source supports
        planning (a B=1 program reuses the compiled-program cache across
        pulls — one device dispatch instead of the eager per-op pull
        path, which dispatches once per op);
        eager fallback otherwise."""
        from canvas_tpu import backend
        source, window = item.source, item.window
        # size-aware backend choice: 'auto' (the production default)
        # takes the planner for real frame sizes and stays eager/numpy
        # for tiny pulls — the old `== 'jax'` test made the planner
        # branch unreachable outside force_backend('jax')
        shape = (window.max.y - window.min.y + 1,
                 window.max.x - window.min.x + 1)
        if backend.use_jax_for(shape) and hasattr(source, 'plan_cuts'):
            try:
                from canvas_tpu import render
                from canvas_tpu.frames import RgbaFrameF16
                key = (id(source), window)
                with self._planners_lock:
                    entry = self._planners.get(key)
                    if entry is None:
                        while len(self._planners) > self._planner_cache:
                            # evict ONE cold planner (close() for
                            # deterministic device-cache teardown);
                            # wholesale clear dumped every warm one
                            _k, (old_p, _l) = self._planners.popitem(
                                last=False)
                            old_p.close()
                        entry = (render.RenderPlanner(source, window),
                                 threading.Lock())
                        self._planners[key] = entry
                    else:
                        self._planners.move_to_end(key)
                planner, plock = entry
                with plock:
                    data, wins = planner.render(item.frame_index,
                                                item.frame_index + 1,
                                                with_windows=True)
                from canvas_tpu.basetypes import EMPTY_BOX2I, box2i
                frame = RgbaFrameF16(window)
                x0, y0, x1, y1 = (int(v) for v in wins[0])
                if x1 < x0 or y1 < y0:
                    frame.current_window = EMPTY_BOX2I
                else:
                    frame.data = data[0]
                    frame.current_window = box2i(x0, y0, x1, y1)
                return frame
            except Exception:
                from canvas_tpu.logging import getLogger
                getLogger(__name__).debug(
                    'planned pull failed; falling back to eager',
                    exc_info=True)
        return source.get_frame_f16(item.frame_index, window)

    def join(self, timeout=None):
        """Drain workers (test helper; the C version has no join)."""
        self._pool.shutdown(wait=True)
        self._pool = ThreadPoolExecutor(max_workers=self._workers,
                                        thread_name_prefix='canvas-pull')
        if self._dispatch_queue is not None:
            done = threading.Event()
            self._dispatch_queue.put(done.set)
            done.wait(timeout)

    def close(self):
        self._closed = True
        self._pool.shutdown(wait=False)
        with self._planners_lock:
            for (planner, _l) in self._planners.values():
                planner.close()
            self._planners.clear()
        if self._dispatch_queue is not None:
            self._dispatch_queue.put(None)
