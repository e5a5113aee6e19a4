#!/usr/bin/env python
"""Transcode a DV (or any decodable) file to H.264 + AAC Matroska.

Equivalent of /root/reference/scripts/encode-video.py: argparse surface
with --crf / --preset / --16x9 / --max-bitrate / -f, DV sample aspect
ratio defaults (10:11, or 40:33 widescreen), output path derived from
the input when omitted. Video rides the device reconstruction path
(DVReconstructionFilter) before x264.

Usage: encode_video.py IN.dv [OUT.mkv] [--crf 23] [--preset slow]
       [--16x9] [--max-bitrate KBPS] [-f]
"""

import argparse
import fractions
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get('CANVAS_FORCE_CPU'):
    import jax

    jax.config.update('jax_platforms', 'cpu')

from canvas_tpu import faac, libav, matroska, process, x264


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('in_path')
    parser.add_argument('out_path', default=None, nargs='?')
    parser.add_argument('-f', dest='force', default=False,
                        action='store_true')
    parser.add_argument('--crf', type=float, default=23.0)
    parser.add_argument('--preset', dest='preset', default='slow')
    parser.add_argument('--16x9', dest='wide', default=False,
                        action='store_true')
    parser.add_argument('--max-bitrate', dest='max_bitrate', type=int,
                        default=None)
    parser.add_argument('--frames', type=int, default=None)
    args = parser.parse_args()

    if not args.out_path:
        root = args.in_path.rsplit('.', 1)[0]
        args.out_path = '{0}-crf{1:g}-{2}.mkv'.format(root, args.crf,
                                                      args.preset)
    if os.path.isfile(args.out_path) and not args.force:
        print('The output file already exists. '
              'Will not overwrite without -f.')
        return 1

    container = libav.AVContainer(args.in_path)
    video = next(s for s in container.streams if s.type == 'video')
    has_audio = any(s.type == 'audio' for s in container.streams)
    frame_count = args.frames or video.frame_count or 300
    frame_rate = video.real_frame_rate or fractions.Fraction(30000, 1001)
    is_dv = video.codec == 'dvvideo'
    width, height = video.frame_size
    container.close()

    decoder = libav.AVVideoDecoder(args.in_path)
    if is_dv:
        source = process.DVReconstructionFilter(decoder)
        width, height = 720, 480
    else:
        from canvas_tpu.editor.plugins.libav_plugin import \
            _RgbaDecoderSource
        source = _RgbaDecoderSource(decoder, width, height)

    sar = fractions.Fraction(40, 33) if args.wide \
        else fractions.Fraction(10, 11)
    params = x264.X264EncoderParams(
        preset=args.preset, width=width, height=height,
        frame_rate=frame_rate, constant_ratefactor=args.crf,
        sample_aspect_ratio=sar,
        vbv_max_bitrate=args.max_bitrate)
    vencoder = x264.X264VideoEncoder(source, 0, frame_count - 1, params)

    aencoder = None
    sample_rate = 48000
    if has_audio:
        adec = libav.AVAudioDecoder(args.in_path, channels=2)
        sample_rate = adec.sample_rate
        n_samples = int(frame_count * sample_rate *
                        frame_rate.denominator / frame_rate.numerator)
        aencoder = faac.AACAudioEncoder(adec, 0, n_samples - 1,
                                        sample_rate=sample_rate,
                                        channels=2)

    ns = 1_000_000_000
    with open(args.out_path, 'wb') as fd:
        writer = matroska.MatroskaWriter(fd)
        writer.write_start(writing_app='canvas_tpu encode_video',
                           duration=0.0, timecode_scale=1_000_000)
        tracks = [matroska.Track(
            number=1, uid=1, type_=matroska.TrackType.VIDEO,
            codec_id='V_MPEG4/ISO/AVC', lacing=False,
            default_duration=int(ns / frame_rate),
            codec_private=vencoder.get_header(),
            video=matroska.TrackVideo(width, height))]
        if aencoder is not None:
            tracks.append(matroska.Track(
                number=2, uid=2, type_=matroska.TrackType.AUDIO,
                codec_id='A_AAC', lacing=False,
                codec_private=aencoder.get_header(),
                audio=matroska.TrackAudio(sample_rate, channels=2)))
        writer.write_tracks(tracks)

        streams = [(1, vencoder.get_next_packet,
                    lambda p: p.pts * frame_rate.denominator * 1000 /
                    frame_rate.numerator,
                    lambda p: p.keyframe)]
        if aencoder is not None:
            streams.append((2, aencoder.get_next_packet,
                            lambda p: p.pts * 1000 / sample_rate,
                            lambda p: True))
        counts = matroska.write_interleaved_blocks(writer, streams)
        count = counts[1]
        writer.write_end(duration=float(
            count * frame_rate.denominator * 1000 / frame_rate.numerator))
    print('wrote %d frames to %s' % (count, args.out_path))
    return 0


if __name__ == '__main__':
    sys.exit(main())
