"""Run the reference project's OWN test suites as acceptance tests.

BASELINE's north star says the Python API is preserved "so the editor,
test_packets.py, and the encode scripts run unchanged".  The strongest
completeness proof available on this rig is therefore executing
``/root/reference/tests/**/*.py`` verbatim (no copies, no edits) against
the ``fluggo.*`` import-compat namespace (``/root/repo/fluggo``), the way
the reference's own ``testrunner.py:64-82`` does: import the file as a
module, load tests with ``unittest.defaultTestLoader``, run, and fail on
any error/failure.

A minimal ``PyQt4`` stand-in is registered first: the suites' only Qt
dependency is ``QUndoCommand`` (asserted via ``isinstance`` on
``manip.finish()`` — ItemManipulator.py:53 etc.), which maps to our
toolkit-free ``canvas_tpu.editor.model.undo.UndoCommand``.

Exclusions (documented per VERDICT r4 item 1; each cited):

* ``tests/process/video/SolidColorVideoSource.py`` sets ``force_gl=True``
  and passes it to ``get_frame_f32`` — accepted and mapped to the device
  path (SURVEY §2.5: the GL renderer's role is taken by the XLA render
  path), so the file runs unmodified.  No file is excluded outright.
* One individual test is excluded (``EXCLUDED``): the reference's own
  unfinished stub ``test_anchors_preserved_to_seqitem_and_back``
  (``/root/reference/tests/canvas/SequenceCommands.py:709-710`` is
  literally ``raise NotImplementedError`` — it fails against the
  reference itself).
"""

import importlib.util
import os
import sys
import types
import unittest

import pytest

REF = '/root/reference'
REF_TESTS = os.path.join(REF, 'tests')

# Every reference test file, relative to /root/reference/tests.
SUITE_FILES = [
    'SortedList.py',
    'basetypes.py',
    'timecode.py',
    'process/frame_func.py',
    'process/SystemPresentationClock.py',
    'process/video/RgbaFrameF16.py',
    'process/video/SolidColorVideoSource.py',
    'process/video/VideoWorkspace.py',
    'canvas/ItemManipulator.py',
    'canvas/SequenceCommands.py',
    'canvas/VideoSourceRefConnector.py',
    'canvas/sequence.py',
]


# (file, test method) pairs that fail against the reference itself.
EXCLUDED = {
    # SequenceCommands.py:709-710 — body is `raise NotImplementedError`.
    ('canvas/SequenceCommands.py', 'test_anchors_preserved_to_seqitem_and_back'),
    # ItemManipulator.py:1298-1301 — body is `raise NotImplementedError`.
    ('canvas/ItemManipulator.py', 'test_anchor_positioning'),
}


def _iter_tests(suite):
    for item in suite:
        if isinstance(item, unittest.TestSuite):
            yield from _iter_tests(item)
        else:
            yield item


def _install_pyqt4_shim():
    """Register a PyQt4 stand-in exposing the undo classes the reference
    suites touch (QtGui.QUndoCommand / QUndoStack)."""
    # The suites predate Python 3.12: they use the long-deprecated
    # `assertEquals` alias (e.g. ItemManipulator.py's
    # test_SequenceItemGroupManipulator).  Restore it so the files run
    # verbatim on this interpreter.
    if not hasattr(unittest.TestCase, 'assertEquals'):
        unittest.TestCase.assertEquals = unittest.TestCase.assertEqual
    if 'PyQt4' in sys.modules:
        return
    from canvas_tpu.editor.model.undo import UndoCommand, UndoStack

    qtgui = types.ModuleType('PyQt4.QtGui')
    qtgui.QUndoCommand = UndoCommand
    qtgui.QUndoStack = UndoStack
    qtcore = types.ModuleType('PyQt4.QtCore')
    pyqt4 = types.ModuleType('PyQt4')
    pyqt4.QtGui = qtgui
    pyqt4.QtCore = qtcore
    pyqt4.__path__ = []
    sys.modules['PyQt4'] = pyqt4
    sys.modules['PyQt4.QtGui'] = qtgui
    sys.modules['PyQt4.QtCore'] = qtcore


def _load_reference_module(relpath):
    """Import a reference test file the way testrunner.py:64-69 does
    (dirname on sys.path), but under a unique module name so same-named
    files (e.g. basetypes.py) can't collide with real packages."""
    _install_pyqt4_shim()
    path = os.path.join(REF_TESTS, relpath)
    modname = 'refsuite_' + relpath[:-3].replace('/', '_').replace('.', '_')
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.dirname(path))
    try:
        sys.modules[modname] = module
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(os.path.dirname(path))
    return module


@pytest.mark.parametrize('relpath', SUITE_FILES,
                         ids=[p.replace('/', '.')[:-3] for p in SUITE_FILES])
def test_reference_suite(relpath):
    module = _load_reference_module(relpath)
    loaded = unittest.defaultTestLoader.loadTestsFromModule(module)
    assert loaded.countTestCases() > 0, 'no tests collected from %s' % relpath

    suite = unittest.TestSuite(
        t for t in _iter_tests(loaded)
        if (relpath, t._testMethodName) not in EXCLUDED)

    result = unittest.TestResult()
    suite.run(result)

    problems = []
    for test, tb in result.errors:
        problems.append('ERROR %s\n%s' % (test, tb))
    for test, tb in result.failures:
        problems.append('FAIL %s\n%s' % (test, tb))
    assert not problems, (
        '%d/%d reference tests failed in %s:\n\n%s'
        % (len(problems), result.testsRun, relpath, '\n'.join(problems)))


# ---------------------------------------------------------------------------
# test_packets.py acceptance: the reference's root-level script
# (/root/reference/test_packets.py:1-13) builds a demux -> dvvideo decode
# -> dvvideo re-encode -> AVMuxer stream-copy pipeline.  Its live lines
# run here verbatim (paths parameterized), and we additionally execute
# muxer.run() — which the reference leaves commented out (line 14) — to
# validate the stream-copy mux end-to-end.

@pytest.fixture(scope='module')
def dv_file(tmp_path_factory):
    np = pytest.importorskip('numpy')
    libav = pytest.importorskip('canvas_tpu.libav')
    if not libav.available():
        pytest.skip('native canvas_av unavailable')
    path = str(tmp_path_factory.mktemp('refpackets') / 'tape.avi')
    try:
        mux = libav.AVMuxer(path)
        vstream = mux.add_video_stream('dvvideo', (720, 480),
                                       __import__('fractions').Fraction(30000, 1001))
    except IOError as e:
        pytest.skip('dvvideo encoder unavailable: %s' % e)
    with mux:
        for i in range(10):
            rgba = np.zeros((480, 720, 4), np.uint8)
            rgba[..., 0] = 30 + 10 * i
            rgba[..., 1] = 40 + 20 * i
            rgba[..., 3] = 255
            mux.write_video_frame(vstream, rgba)
    return path


def test_reference_test_packets_pipeline(dv_file, tmp_path):
    import fractions
    import fluggo  # noqa: F401  (registers the compat namespace)
    from fluggo.media import process, libav  # noqa: F401
    from fluggo.media.basetypes import v2i  # (star import in the original)

    out_path = str(tmp_path / 'test_packet.avi')

    # --- the reference's lines 6-13, verbatim apart from paths/range ---
    packet_source = libav.AVDemuxer(dv_file, 0)
    coded_image = libav.AVVideoDecoder(packet_source, 'dvvideo')
    packet_source = libav.AVVideoEncoder(
        coded_image, 'dvvideo', start_frame=0, end_frame=9,
        frame_size=v2i(720, 480),
        sample_aspect_ratio=fractions.Fraction(33, 40), interlaced=True,
        top_field_first=False, frame_rate=fractions.Fraction(30000 / 1001))

    muxer = libav.AVMuxer(out_path, 'avi')
    muxer.add_video_stream(packet_source, 'dvvideo',
                           frame_rate=fractions.Fraction(30000, 1001),
                           frame_size=v2i(720, 480),
                           sample_aspect_ratio=fractions.Fraction(33, 40))
    # --- beyond the reference: actually run the mux ---
    muxer.run()

    # The stream-copied file must decode back to the same frame count,
    # geometry, and (since dvvideo re-encode of an identical decode is
    # deterministic) pixel content close to the original.
    import numpy as np
    probe = libav.AVContainer(out_path)
    vstreams = [s for s in probe.streams if s.type == 'video']
    assert len(vstreams) == 1
    assert vstreams[0].codec == 'dvvideo'
    assert vstreams[0].sample_aspect_ratio == fractions.Fraction(33, 40)
    dec = libav.AVVideoDecoder(out_path, 'dvvideo')
    ref_dec = libav.AVVideoDecoder(dv_file, 'dvvideo')
    n = 0
    while True:
        img = dec.get_frame(n)
        if img is None:
            break
        ref_img = ref_dec.get_frame(n)
        assert ref_img is not None
        got = np.asarray(img[0], np.int16)
        want = np.asarray(ref_img[0], np.int16)
        assert got.shape == want.shape
        assert np.mean(np.abs(got - want)) < 2.0   # one dv generation
        n += 1
    assert n == 10
