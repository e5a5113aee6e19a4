#!/usr/bin/env python
"""Encode a DV (or any libav-readable) file to H.264 in Matroska.

Port of /root/reference/scripts/encode_x264_mkv.py to the canvas_tpu
stack: native decode -> device DV reconstruction -> libx264 packets -> the
pure-Python Matroska writer.

Usage: encode_x264_mkv.py INPUT [OUTPUT.mkv] [FRAMES]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get('CANVAS_FORCE_CPU'):
    import jax

    jax.config.update('jax_platforms', 'cpu')

import fractions
import sys

from canvas_tpu import libav, matroska, process, x264


def main():
    if len(sys.argv) < 2:
        print(__doc__)
        return 1
    in_path = sys.argv[1]
    out_path = sys.argv[2] if len(sys.argv) > 2 else 'test.mkv'
    n_frames = int(sys.argv[3]) if len(sys.argv) > 3 else 1000

    container = libav.AVContainer(in_path)
    video = next(s for s in container.streams if s.type == 'video')
    is_dv = video.codec == 'dvvideo'
    width, height = video.frame_size
    frame_rate = video.real_frame_rate or fractions.Fraction(30000, 1001)
    container.close()

    decoder = libav.AVVideoDecoder(in_path)
    if is_dv:
        source = process.DVReconstructionFilter(decoder)
        width, height = 720, 480
    else:
        # generic path: decode via RGBA
        from canvas_tpu.editor.plugins.libav_plugin import _RgbaDecoderSource
        source = _RgbaDecoderSource(decoder, width, height)

    params = x264.X264EncoderParams(
        preset='ultrafast', width=width, height=height,
        frame_rate=frame_rate, constant_ratefactor=23.0,
        interlaced=is_dv)
    encoder = x264.X264VideoEncoder(source, 0, n_frames - 1, params)

    ns = 1_000_000_000
    timescale = 1_000_000
    with open(out_path, 'wb') as fd:
        writer = matroska.MatroskaWriter(fd)
        writer.write_start(writing_app='canvas_tpu encode_x264_mkv',
                           duration=0.0, timecode_scale=timescale)
        writer.write_tracks([matroska.Track(
            number=1, uid=1, type_=matroska.TrackType.VIDEO,
            codec_id='V_MPEG4/ISO/AVC', lacing=False,
            default_duration=int(ns / frame_rate),
            codec_private=encoder.get_header(),
            video=matroska.TrackVideo(width, height))])

        count = 0
        while True:
            packet = encoder.get_next_packet()
            if packet is None:
                break
            pts_ms = int(packet.pts * frame_rate.denominator * 1000 /
                         frame_rate.numerator)
            writer.write_simple_block(1, pts_ms, packet.data,
                                      keyframe=packet.keyframe)
            count += 1
        duration = float(count * frame_rate.denominator * 1000 /
                         frame_rate.numerator)
        writer.write_end(duration=duration)
    print('wrote %d frames to %s' % (count, out_path))
    return 0


if __name__ == '__main__':
    sys.exit(main())
