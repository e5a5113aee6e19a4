#!/usr/bin/env python
"""Headless playback demo: media file -> decode -> (DV reconstruct +
pulldown) -> workspace -> clock-driven playback engine.

Port of the reference's GTK demo pipeline (/root/reference/main.py:64-98)
without the widget: presents frames to a callback and reports achieved
rate. With --tk (and a display), opens the stdlib-tkinter player window
instead — a real-toolkit run with zero extra dependencies. With --gtk,
runs the REAL GTK 3 toolkit headlessly on a broadwayd display (the
ctypes binding, editor/ui/gtk_ctypes.py) — open the printed
http://127.0.0.1:<port> URL in any browser to watch the playback.

Usage: play_demo.py [--tk | --gtk] INPUT [SECONDS]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get('CANVAS_FORCE_CPU'):
    import jax

    jax.config.update('jax_platforms', 'cpu')

import time
from fractions import Fraction


def main():
    args = [a for a in sys.argv[1:] if a not in ('--tk', '--gtk')]
    use_tk = '--tk' in sys.argv[1:]
    use_gtk = '--gtk' in sys.argv[1:]
    if not args:
        print(__doc__)
        return 1
    path = args[0]
    seconds = float(args[1]) if len(args) > 1 else 3.0

    from canvas_tpu import libav, process
    from canvas_tpu.basetypes import box2i
    from canvas_tpu.clock import SystemPresentationClock
    from canvas_tpu.playback import VideoPlaybackEngine

    container = libav.AVContainer(path)
    video = next(s for s in container.streams if s.type == 'video')
    rate = video.real_frame_rate or Fraction(30000, 1001)
    width, height = video.frame_size
    is_dv = video.codec == 'dvvideo'
    container.close()

    decoder = libav.AVVideoDecoder(path)
    if is_dv:
        source = process.Pulldown23RemovalFilter(
            process.DVReconstructionFilter(decoder), 0)
        window = box2i(0, -1, 719, 478)
    else:
        from canvas_tpu.editor.plugins.libav_plugin import _RgbaDecoderSource
        source = _RgbaDecoderSource(decoder, width, height)
        window = box2i(0, 0, width - 1, height - 1)

    workspace = process.VideoWorkspace()
    workspace.add(source=source, x=0, length=100000)

    if use_tk:
        from canvas_tpu.editor.ui import tkui
        if not tkui.tk_available():
            print('--tk: no display reachable (tkinter.Tk() failed); '
                  'running headless instead')
        else:
            clock = SystemPresentationClock()
            root, widget = tkui.play_window(workspace, clock, rate,
                                            window, title=path)
            widget.engine.warm(0)
            root.mainloop()
            return 0

    if use_gtk:
        from canvas_tpu.editor.ui import gtk_ctypes
        if not gtk_ctypes.broadway_available():
            print('--gtk: broadwayd or GTK 3 libraries missing; '
                  'running headless instead')
        else:
            port = 8085 + os.getpid() % 100
            proc, display = gtk_ctypes.start_broadwayd(port=port)
            try:
                clock = SystemPresentationClock()
                widget = gtk_ctypes.GtkCtypesVideoWidget(
                    workspace, clock, rate, window, display=display)
                widget.engine.warm(0)
                print('REAL GTK on broadway: open '
                      'http://127.0.0.1:%d to watch' % port, flush=True)
                clock.play(1)
                t_end = time.time() + seconds
                while time.time() < t_end:
                    widget.pump(0.1)
                clock.stop()
                print('painted %d frames through the real toolkit'
                      % widget._painted)
                widget.close()
            finally:
                proc.terminate()
                proc.wait()
            return 0

    presented = []

    def present(frame_index, bgra):
        presented.append((time.perf_counter(), frame_index))

    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(workspace, clock, rate, window, present)
    try:
        # Compile the full pipeline BEFORE starting the clock: first
        # compiles cost seconds, and
        # a clock already running skips every frame inside them.
        t0 = time.time()
        engine.warm(0)
        warm_s = time.time() - t0
        if warm_s > 0.5:
            print('warmed pipeline in %.1fs (compiles now cached)'
                  % warm_s)
        presented.clear()
        clock.play(1)
        time.sleep(seconds)
        clock.stop()
    finally:
        engine.stop(timeout=60)

    if len(presented) > 1:
        span = presented[-1][0] - presented[0][0]
        print('presented %d frames in %.2fs (%.1f fps; target %.2f)' % (
            len(presented), span, (len(presented) - 1) / span, float(rate)))
    else:
        print('presented %d frames' % len(presented))
    return 0


if __name__ == '__main__':
    sys.exit(main())
