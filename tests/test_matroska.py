"""Matroska muxer: EBML encoding units + files validated by libavformat."""

import io
import math

import numpy as np
import pytest

from canvas_tpu import matroska as mkv


def test_encode_size():
    assert mkv.encode_size(0) == b'\x80'
    assert mkv.encode_size(1) == b'\x81'
    assert mkv.encode_size(126) == b'\xfe'
    # 127 is reserved (all ones) in 1 byte -> 2 bytes
    assert mkv.encode_size(127) == b'\x40\x7f'
    assert mkv.encode_size(128) == b'\x40\x80'
    assert mkv.encode_size(5, 8) == b'\x01\x00\x00\x00\x00\x00\x00\x05'


def test_encode_id():
    assert mkv.encode_id(0x1A45DFA3) == b'\x1a\x45\xdf\xa3'
    assert mkv.encode_id(0xEC) == b'\xec'


def test_uint_int():
    assert mkv.encode_uint(0) == b'\x00'
    assert mkv.encode_uint(255) == b'\xff'
    assert mkv.encode_uint(256) == b'\x01\x00'
    assert mkv.encode_int(-1) == b'\xff'
    assert mkv.encode_int(-129) == b'\xff\x7f'


def test_void():
    v = mkv.make_void(2)
    assert len(v) == 2
    v = mkv.make_void(100)
    assert len(v) == 100
    assert v[0] == 0xEC


def test_simple_element():
    e = mkv.ebml(0x4286, 1)
    assert e.encode() == b'\x42\x86\x81\x01'


def test_nested_element():
    parent = mkv.ebml(0x1A45DFA3, [mkv.ebml(0x4286, 1)])
    enc = parent.encode()
    assert enc.startswith(b'\x1a\x45\xdf\xa3\x84')
    assert enc.endswith(b'\x42\x86\x81\x01')


def test_timecode():
    # 48000 Hz, timescale = 1e9/48000 ns
    ts = math.floor(1e9 / 48000)
    assert mkv.timecode(0, 48000, ts) == 0
    assert mkv.timecode(48000, 48000, ts) > 0


class ToneSource:
    def get_frame(self, min_sample, max_sample, channels):
        from canvas_tpu.audio import AudioFrame
        n = max_sample - min_sample + 1
        t = (np.arange(min_sample, max_sample + 1)) / 8000.0
        data = np.repeat(
            (0.5 * np.sin(2 * math.pi * 440 * t))[:, None], channels, axis=1)
        return AudioFrame(min_sample, max_sample, channels,
                          data=data.astype(np.float32))


def test_pcm_float_mkv_readable_by_libav(tmp_path):
    """Write float PCM MKV, read it back with libavformat."""
    libav = pytest.importorskip('canvas_tpu.libav')
    if not libav.available():
        pytest.skip('native canvas_av unavailable')

    path = str(tmp_path / 'tone.mkv')
    mkv.write_audio_pcm_float(path, ToneSource(), 0, 7999, 8000, 1)

    container = libav.AVContainer(path)
    assert 'matroska' in container.format_name
    audio = next(s for s in container.streams if s.type == 'audio')
    assert audio.sample_rate == 8000
    assert audio.channels == 1
    container.close()

    dec = libav.AVAudioDecoder(path, channels=1)
    frame = dec.get_frame(0, 7999)
    data = np.asarray(frame.data)[:, 0]
    want = (0.5 * np.sin(2 * math.pi * 440 *
                         np.arange(8000) / 8000.0)).astype(np.float32)
    np.testing.assert_allclose(data, want, atol=1e-5)
    dec.close()


def test_video_blocks_mkv_readable_by_libav(tmp_path):
    """Mux raw x264 packets from our native encoder into our MKV writer,
    then decode with libav — the encode_x264_mkv.py pipeline shape
    (scripts/encode_x264_mkv.py:26-38) minus DV input."""
    libav = pytest.importorskip('canvas_tpu.libav')
    if not libav.available():
        pytest.skip('native canvas_av unavailable')

    # Encode mpeg4 into avi with our muxer (native), then demux packets
    import os
    src_path = str(tmp_path / 'src.avi')
    with libav.AVMuxer(src_path) as mux:
        v = mux.add_video_stream('mpeg4', (64, 48), 25, bit_rate=400_000)
        mux.start()
        for i in range(10):
            frame = np.zeros((48, 64, 4), np.uint8)
            frame[:, :, 1] = i * 20
            frame[:, :, 3] = 255
            mux.write_video_frame(v, frame)

    demux = libav.AVDemuxer(src_path, 0)
    packets = []
    while True:
        pkt = demux.get_next_packet()
        if pkt is None:
            break
        packets.append(pkt)
    demux.close()

    # Remux packets into MKV with the pure-Python writer
    path = str(tmp_path / 'remux.mkv')
    with open(path, 'wb') as fd:
        writer = mkv.MatroskaWriter(fd)
        writer.write_start(writing_app='canvas-test', duration=0.0,
                           timecode_scale=1000000)
        writer.write_tracks([mkv.Track(
            number=1, uid=1, type_=mkv.TrackType.VIDEO,
            codec_id='V_MPEG4/ISO/ASP', lacing=False,
            default_duration=40_000_000,
            video=mkv.TrackVideo(64, 48))])
        for i, pkt in enumerate(packets):
            writer.write_simple_block(1, i * 40, pkt.data,
                                      keyframe=pkt.keyframe)
        writer.write_end(duration=float(len(packets) * 40))

    assert os.path.getsize(path) > 100
    container = libav.AVContainer(path)
    assert 'matroska' in container.format_name
    video = next(s for s in container.streams if s.type == 'video')
    assert video.frame_size == (64, 48)
    container.close()

    dec = libav.AVVideoDecoder(path)
    f5 = dec.get_frame_rgba(5, 64, 48)
    assert f5 is not None
    assert 60 < int(f5[24, 32, 1]) < 140  # green ramp ~ 5*20
    dec.close()


def test_write_interleaved_blocks_orders_by_pts():
    """write_interleaved_blocks merges multiple packet streams in
    presentation order (the muxer DTS-interleave, AVMuxer.c:232-245),
    so cluster timecodes never jump backwards."""
    from canvas_tpu.matroska import write_interleaved_blocks

    class Packet:
        def __init__(self, pts, data):
            self.pts = pts
            self.data = data
            self.keyframe = True

    def stream(packets):
        it = iter(packets)
        return lambda: next(it, None)

    written = []

    class Writer:
        def write_simple_block(self, track, pts, data, keyframe=True):
            written.append((pts, track, data))

    video = [Packet(p, b'v%d' % p) for p in range(0, 2000, 40)]
    audio = [Packet(p, b'a%d' % p) for p in range(0, 2000, 21)]
    counts = write_interleaved_blocks(Writer(), [
        (1, stream(video), lambda p: p.pts, lambda p: p.keyframe),
        (2, stream(audio), lambda p: p.pts, lambda p: True),
    ])
    assert counts == {1: len(video), 2: len(audio)}
    assert len(written) == len(video) + len(audio)
    pts_seq = [w[0] for w in written]
    assert pts_seq == sorted(pts_seq)
    # both streams actually interleave (not track-at-a-time)
    tracks = [w[1] for w in written]
    switches = sum(1 for a, b in zip(tracks, tracks[1:]) if a != b)
    assert switches > 10


def test_tags_dates_and_cue_duration(tmp_path):
    """Tags/Target/SimpleTag, DateUTC, interlaced+crop video metadata,
    and CueDuration all encode; libavformat still opens the file
    (matroska.py:331-494 structures)."""
    import datetime

    libav = pytest.importorskip('canvas_tpu.libav')
    if not libav.available():
        pytest.skip('native canvas_av unavailable')

    path = str(tmp_path / 'tagged.mkv')
    with open(path, 'wb') as fd:
        writer = mkv.MatroskaWriter(fd)
        writer.write_start(
            writing_app='canvas-test',
            duration=0.0,
            title='Tagged Movie',
            date_utc=datetime.datetime(2026, 8, 19, 12, 0, 0),
            timecode_scale=1000000)
        writer.add_tag(mkv.Tag(
            [mkv.Target('MOVIE', target_type_value=50)],
            [mkv.SimpleTag('ARTIST', 'Canvas'),
             mkv.SimpleTag('COMMENT', b'\x01\x02\x03',
                           language='eng', is_default_language=False)]))
        writer.write_tracks([mkv.Track(
            number=1, uid=1, type_=mkv.TrackType.VIDEO,
            codec_id='V_UNCOMPRESSED', lacing=False,
            video=mkv.TrackVideo(8, 8, interlaced=True,
                                 pixel_crop=(1, 2, 3, 4),
                                 display_width=16, display_height=8))])
        frame = bytes(8 * 8 * 3)
        for i in range(3):
            writer.write_simple_block(1, i * 40, frame, keyframe=True)
        writer.write_end(duration=120.0)

    raw = open(path, 'rb').read()
    # tag payloads landed in the file
    assert b'ARTIST' in raw and b'Canvas' in raw
    assert b'Tagged Movie' in raw
    container = libav.AVContainer(path)
    assert 'matroska' in container.format_name
    container.close()


def test_cue_point_duration_and_negative_time():
    cp = mkv.CuePoint(100, [mkv.CueTrackPosition(1, 0)], duration=40)
    body = cp.encode()
    assert mkv.ebml(mkv.CuePoint.CueDuration, 40).encode() in body
    with pytest.raises(mkv.Error):
        mkv.CuePoint(-1, [mkv.CueTrackPosition(1, 0)])


def test_cluster_rejects_negative_timecode():
    with pytest.raises(mkv.Error):
        mkv.Cluster(-5)


def test_seek_head_reservation_overflow_and_padding(tmp_path):
    import io
    fd = io.BytesIO()
    head = mkv.SeekHead([], max_count=1)
    head.reserve(fd)
    # 2 entries overflow a 1-entry reservation
    for eid in (0x1254C367, 0x1654AE6B, 0x1C53BB6B):
        head.contents.append(mkv.Seek(eid, 2 ** 40))
    with pytest.raises(mkv.Error):
        head.write(fd)


def test_inplace_rewrite_size_change_rejected():
    import io
    fd = io.BytesIO()
    el = mkv.ebml(0x4489, 1.5)
    el.write(fd)
    el.contents = 'a much longer payload than one float'
    with pytest.raises(mkv.Error):
        el.write(fd)


def test_encode_special_scalar_types():
    # bool, float32 wrapper, date, negative int (signed encode)
    assert mkv.ebml(0x4484, True).encode_body() == b'\x01'
    import struct
    f32 = mkv.ebml(0x4489, mkv._Float32(0.5)).encode_body()
    assert f32 == struct.pack('>f', 0.5)
    assert len(mkv.ebml(0x4461, mkv._Date(10 ** 9)).encode_body()) == 8
    neg = mkv.ebml(0x7BA9, -2).encode_body()
    assert neg == b'\xfe'
