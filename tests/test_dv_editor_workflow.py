"""Capstone integration: a real DV tape through the whole editor stack.

The reference's real-world loop (qttest.py + main.py): import a DV
file, resolve it through the plugin/codec chain (demux -> dvvideo
decode -> 4:1:1 chroma reconstruction on device), edit it on a
timeline, export, and round-trip the project document. This test runs
that loop end-to-end against real DV media generated in-process.
"""

import os

import numpy as np
import pytest
from fractions import Fraction

from canvas_tpu.basetypes import box2i
from canvas_tpu.editor import model, plugins
from canvas_tpu.editor.plugins import PluginManager
from canvas_tpu.editor.settings import set_settings_path


@pytest.fixture(autouse=True)
def fresh_settings(tmp_path):
    set_settings_path(str(tmp_path / 'settings.json'))
    PluginManager._reset_for_tests()
    yield
    PluginManager._reset_for_tests()


@pytest.fixture(scope='module')
def dv_file(tmp_path_factory):
    libav = pytest.importorskip('canvas_tpu.libav')
    if not libav.available():
        pytest.skip('native canvas_av unavailable')
    path = str(tmp_path_factory.mktemp('dv') / 'tape.avi')
    try:
        mux = libav.AVMuxer(path)
        vstream = mux.add_video_stream('dvvideo', (720, 480),
                                       Fraction(30000, 1001))
    except IOError as e:
        pytest.skip('dvvideo encoder unavailable: %s' % e)
    with mux:
        for i in range(10):
            rgba = np.zeros((480, 720, 4), np.uint8)
            rgba[..., 1] = 40 + 20 * i        # green ramps per frame
            rgba[..., 3] = 255
            mux.write_video_frame(vstream, rgba)
    return path


def _full_plugins_app():
    from canvas_tpu.editor.ui.app import EditorApp
    app = EditorApp()
    for p in PluginManager.find_plugins(enabled_only=False):
        PluginManager.set_plugin_enabled(p, True)
    return app


def test_dv_editor_end_to_end(dv_file, tmp_path):
    import canvas_tpu.libav as libav
    from canvas_tpu.editor.plugins.libav_plugin import DVVideoCodec

    app = _full_plugins_app()
    asset = app.import_file('tape', dv_file)
    assert asset is not None

    # The DV stream resolved through the DV codec (device reconstruction),
    # not the generic RGBA fallback.
    source = asset.get_source()
    source.bring_online()
    assert not source.offline, [str(a) for a in (source.alerts or [])]
    vstream = source.get_stream('0')
    assert vstream.codec is not None and isinstance(vstream.codec,
                                                    DVVideoCodec)

    editor = app.new_space('cut')
    items = app.add_asset_to_space(editor, 'tape', x=0, length=10)
    vclip = next(i for i in items if i.type() == 'video')
    assert vclip.length == 10

    # Pull through the live editor graph: frame i's green ramp decodes
    # to a rising studio-range-expanded green value.
    win = box2i(0, 0, 719, 479)
    greens = []
    for f in (0, 4, 8):
        frame = editor.video_stream.get_frame_f16(f, win)
        px = frame.pixel(360, 240)
        assert px is not None
        greens.append(float(px.g))
        assert float(px.g) > 2.5 * max(float(px.r), float(px.b)), (f, px)
    assert greens[0] < greens[1] < greens[2]

    # Trim the clip with an undoable command (length 10 -> 5); frame 8
    # goes empty.
    editor.undo_stack.push(model.AdjustClipLengthCommand(vclip, -5))
    assert editor.video_stream.get_frame_f16(8, win).current_window.empty()
    editor.undo_stack.undo()
    assert not editor.video_stream.get_frame_f16(8, win).current_window.empty()

    # Export the timeline (batched device render -> mpeg4), then decode
    # the export and check the ramp survived.
    out = str(tmp_path / 'cut.avi')
    libav.write_video(out, editor.video_stream, None, 0, 10,
                      frame_size=(720, 480), frame_rate=Fraction(30000, 1001),
                      video_codec='mpeg4', bit_rate=8_000_000, window=win)
    assert os.path.getsize(out) > 0
    dec = libav.AVVideoDecoder(out)
    try:
        a = dec.get_frame_rgba(1, 720, 480)
        b = dec.get_frame_rgba(8, 720, 480)
        assert int(b[240, 360, 1]) > int(a[240, 360, 1]) + 50
    finally:
        dec.close()

    # Project round trip: save, reopen in a fresh app, re-pull — the
    # decode + reconstruction chain is deterministic, so pixels match.
    want = np.asarray(
        editor.video_stream.get_frame_f16(4, win).data)
    project_path = str(tmp_path / 'cut.yaml')
    app.save_file(project_path)

    PluginManager._reset_for_tests()
    app2 = _full_plugins_app()
    app2.open_file(project_path)
    editor2 = app2.open_space('cut')
    got = np.asarray(editor2.video_stream.get_frame_f16(4, win).data)
    np.testing.assert_array_equal(got, want)
