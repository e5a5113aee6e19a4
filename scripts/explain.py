#!/usr/bin/env python
"""Print a render-plan report for a project's space.

Usage: explain.py PROJECT.yaml [--space NAME] [--start N] [--stop N]
       explain.py --demo          # the bench 10-layer timeline

Loads the project headless (EditorApp without a toolkit), resolves the
space's live video stream through the same graph managers the editor
uses, and prints ``RenderPlanner.explain`` for the range: the IR tree
per segment (ops, static geometry, param shapes, window coverage) and
cache status. Vocabulary: docs/api.md §3.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get('CANVAS_FORCE_CPU'):
    import jax

    jax.config.update('jax_platforms', 'cpu')

from canvas_tpu import backend  # noqa: E402

backend.configure_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('project', nargs='?', help='PROJECT.yaml')
    ap.add_argument('--space', help='space asset name (default: first)')
    ap.add_argument('--start', type=int, default=0)
    ap.add_argument('--stop', type=int, default=None)
    ap.add_argument('--demo', action='store_true',
                    help='explain the bench 10-layer 1080p timeline')
    args = ap.parse_args()

    from canvas_tpu.basetypes import box2i
    from canvas_tpu.render import RenderPlanner

    if args.demo or not args.project:
        from bench import build_timeline
        source = build_timeline(1024)
        window = box2i(0, 0, 1919, 1079)
        stop = args.stop if args.stop is not None else args.start + 64
        planner = RenderPlanner(source, window)
        print(planner.explain(args.start, stop))
        return 0

    from canvas_tpu.editor import model, plugins
    from canvas_tpu.editor.ui.app import EditorApp

    # A headless one-shot: enable every discovered plugin IN MEMORY so
    # media refs resolve without touching the user's persisted plugin
    # choices.
    plugins.PluginManager.enable_all_for_session()

    app = EditorApp()
    app.open_file(args.project)
    names = [name for name, asset in app.asset_list.items()
             if isinstance(asset, model.SpaceAsset)]
    if not names:
        print('no space assets in %s' % args.project, file=sys.stderr)
        return 1
    name = args.space or names[0]
    editor = app.open_space(name)
    fmt = editor.space.video_format
    w, h = fmt.full_frame.width, fmt.full_frame.height
    window = box2i(0, 0, w - 1, h - 1)
    length = max((it.x + it.length for it in editor.space), default=64)
    stop = args.stop if args.stop is not None else min(length, args.start + 64)

    print('space %r  %dx%d  frames [%d, %d)' % (name, w, h, args.start, stop))
    planner = RenderPlanner(editor.video_stream, window)
    try:
        print(planner.explain(args.start, stop))
    finally:
        planner.close()
        app.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
