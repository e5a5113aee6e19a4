"""Profiling helpers.

The reference's tracing story is a monotonic-ns clock plus the
``time_get_frame`` micro-benchmark (src/process/main.c:120-167,
src/cprocess/clock.c:28-52). This build keeps those
(``canvas_tpu.process.time_get_frame``) and adds:

* :class:`Timer` / :func:`timed` — per-stage wall timers that aggregate
  into a report (the per-stage timers SURVEY.md §5 calls for).
* :func:`trace` — context manager over the JAX profiler; the captured
  trace (TensorBoard format) shows the fused XLA programs the render
  planner emits.
"""

import contextlib
import threading
import time
from collections import defaultdict

__all__ = ['Timer', 'timed', 'trace', 'report', 'reset']

_totals = defaultdict(float)
_counts = defaultdict(int)
# Timers run concurrently on the prepare worker and the dispatch thread
# (render.plan vs render.dispatch); the read-modify-write accumulation
# needs a lock or same-name timers lose counts.
_agg_lock = threading.Lock()


class Timer:
    """Accumulating wall timer: ``with Timer('stage'): ...``"""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        with _agg_lock:
            _totals[self.name] += dt
            _counts[self.name] += 1
        return False


timed = Timer


@contextlib.contextmanager
def trace(log_dir):
    """Capture a JAX profiler trace around a block into *log_dir*."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def report():
    """Aggregated timings: {name: (total_seconds, count, mean_ms)}."""
    with _agg_lock:
        return {name: (total, _counts[name],
                       total / _counts[name] * 1e3 if _counts[name] else 0.0)
                for name, total in _totals.items()}


def reset():
    with _agg_lock:
        _totals.clear()
        _counts.clear()
