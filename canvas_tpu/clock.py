"""Presentation clocks.

JAX equivalent of the reference's src/process/clock.c: a
presentation clock maps wall time to stream time (nanoseconds) at a
rational speed, and notifies registered callbacks on speed/seek changes.
The engine is host-side Python (clock math never touches the device).
"""

import threading
import time
from fractions import Fraction

__all__ = ['PresentationClock', 'SystemPresentationClock', 'ClockCallbackHandle']


def gettime():
    """Monotonic nanoseconds (src/cprocess/clock.c:28-52)."""
    return time.monotonic_ns()


class ClockCallbackHandle:
    """Returned by register_callback; unregister() removes the callback
    (clock.c:23-65)."""

    def __init__(self, clock, func, data):
        self._clock = clock
        self._func = func
        self._data = data

    def unregister(self):
        clock = self._clock
        if clock is not None:
            clock._unregister(self)
            self._clock = None


class PresentationClock:
    """Base clock: get_presentation_time / get_speed / register_callback
    (clock.c:163-187)."""

    def __init__(self):
        self._callbacks = []
        self._cb_lock = threading.RLock()

    def get_presentation_time(self):
        raise NotImplementedError

    def get_speed(self):
        raise NotImplementedError

    def register_callback(self, func, data=None):
        """func(speed, time, data) is called on every set/seek/play/stop
        (argument order per the reference's Python callback,
        tests/process/SystemPresentationClock.py:9-10)."""
        handle = ClockCallbackHandle(self, func, data)
        with self._cb_lock:
            self._callbacks.append(handle)
        return handle

    def _unregister(self, handle):
        with self._cb_lock:
            try:
                self._callbacks.remove(handle)
            except ValueError:
                pass

    def _notify(self, speed, seek_time):
        with self._cb_lock:
            handles = list(self._callbacks)
        for handle in handles:
            handle._func(speed, seek_time, handle._data)


class SystemPresentationClock(PresentationClock):
    """Wall-clock-driven clock: current = seek_time + elapsed * speed
    (clock.c:221-504). Speed is a Fraction; speed 0 = stopped."""

    def __init__(self):
        super().__init__()
        self._mutex = threading.Lock()
        self._seek_time = 0
        self._base_time = gettime()
        self._speed = Fraction(0, 1)

    def _set(self, seek_time, speed):
        with self._mutex:
            self._base_time = gettime()
            seek_time = self._seek_time = int(seek_time)
            speed = self._speed = Fraction(speed)
        # notify with the SNAPSHOT taken inside the lock: re-reading the
        # attributes here could deliver another thread's concurrent
        # _set state twice and drop this one's
        self._notify(speed, seek_time)

    def set(self, speed, time_ns):
        """Set speed and position at once (clock.c:348-363)."""
        self._set(time_ns, speed)

    def play(self, rate):
        """Play at *rate* from the current position (clock.c:365-379)."""
        self._set(self.get_presentation_time(), rate)

    def seek(self, time_ns):
        """Jump to *time_ns*, keeping speed (clock.c:381-391)."""
        self._set(time_ns, self._speed)

    def stop(self):
        """Freeze at the current position (clock.c:393-397)."""
        self._set(self.get_presentation_time(), Fraction(0, 1))

    def get_presentation_time(self):
        with self._mutex:
            if self._speed.numerator == 0:
                return self._seek_time
            elapsed = (gettime() - self._base_time) * self._speed.numerator
            if self._speed.denominator != 1:
                elapsed //= self._speed.denominator
            return self._seek_time + elapsed

    def get_speed(self):
        with self._mutex:
            return self._speed
