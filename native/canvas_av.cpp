// canvas_av: native media IO for Canvas.
//
// C++ equivalent of the reference's libav module
// (/root/reference/src/libav/: AVDemuxer.c, AVVideoDecoder.c,
// AVAudioDecoder.c, AVVideoEncoder.c, AVMuxer.c, writeVideo.c), built as a
// shared library with a C ABI consumed from Python via ctypes
// (canvas_tpu/libav.py). Design differences from the reference:
//
//  * Decoders own their demuxer (one format context per decoder) instead
//    of crossing the language boundary per packet — the Python side still
//    exposes a packet-source protocol for parity, but the hot decode loop
//    never leaves C++.
//  * The muxer accepts raw RGBA/float buffers and converts with
//    swscale/swresample in-process; the device render path hands it batches.
//
// Frame-accurate seeking follows the reference's strategy
// (AVVideoDecoder.c:182-256): seek to a keyframe at-or-before the target,
// then decode forward until the target presentation time is reached.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

#define CAV_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

void set_err(char *err, int errlen, const std::string &msg) {
    if (err && errlen > 0) {
        snprintf(err, errlen, "%s", msg.c_str());
    }
}

std::string av_errstr(int code) {
    char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
    av_strerror(code, buf, sizeof(buf));
    return std::string(buf);
}

// Options no codec/context AVOption consumed are silently left in the
// dict by avcodec_open2 — a misspelled rate-control knob then no-ops
// without a trace (round-4 audit: the x264 wrapper shipped
// 'vbv-maxrate', an x264-CLI spelling avcodec ignores). Surface the
// leftovers on the ffmpeg log.
void warn_unconsumed_opts(AVDictionary *opts, const char *what) {
    const AVDictionaryEntry *e = nullptr;
    while ((e = av_dict_get(opts, "", e, AV_DICT_IGNORE_SUFFIX)))
        av_log(nullptr, AV_LOG_WARNING,
               "canvas_av: option '%s=%s' not consumed by %s\n",
               e->key, e->value, what);
}

// avcodec defaults to a single thread; frame/slice threading scales
// DV/H.264 decode and mpeg4/x264 encode near-linearly with host cores
// (the decode side feeds device staging — configs 7/8 are
// decode+link-bound cold). Default: hardware cores capped at 8.
// CANVAS_AV_THREADS pins a count (1 restores the old single-threaded
// behavior, 0 = avcodec's own auto). receive-loops already tolerate
// the extra EAGAIN latency frame threading introduces.
void enable_codec_threads(AVCodecContext *ctx) {
    const char *env = getenv("CANVAS_AV_THREADS");
    if (env) {
        ctx->thread_count = atoi(env);
    } else {
        // auto, capped: a mixed timeline runs several decoder
        // instances at once — full-core auto per instance
        // oversubscribes the host and frame threading buffers
        // thread_count frames of latency/memory each.
        unsigned cores = std::thread::hardware_concurrency();
        ctx->thread_count = cores ? (cores > 8 ? 8 : (int)cores) : 4;
    }
    ctx->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
}

}  // namespace

// --------------------------------------------------------------------------
// Container probe (AVContainer.c equivalent)

struct CavStreamInfo {
    int32_t type;           // 0 video, 1 audio, 2 other
    char codec_name[32];
    int32_t width, height;
    char pix_fmt[32];
    int32_t frame_rate_num, frame_rate_den;
    int32_t sar_num, sar_den;
    int32_t time_base_num, time_base_den;
    int64_t duration;       // in time_base units
    int64_t nb_frames;      // container-reported frame count (0 unknown)
    int32_t sample_rate;
    int32_t channels;
    int64_t start_time;
};

struct CavFormat {
    AVFormatContext *ctx = nullptr;
};

CAV_EXPORT CavFormat *cav_open(const char *filename, char *err, int errlen) {
    auto *f = new CavFormat();
    int rc = avformat_open_input(&f->ctx, filename, nullptr, nullptr);
    if (rc < 0) {
        set_err(err, errlen, "open_input: " + av_errstr(rc));
        delete f;
        return nullptr;
    }
    rc = avformat_find_stream_info(f->ctx, nullptr);
    if (rc < 0) {
        set_err(err, errlen, "find_stream_info: " + av_errstr(rc));
        avformat_close_input(&f->ctx);
        delete f;
        return nullptr;
    }
    return f;
}

CAV_EXPORT void cav_close(CavFormat *f) {
    if (!f) return;
    if (f->ctx) avformat_close_input(&f->ctx);
    delete f;
}

CAV_EXPORT int cav_stream_count(CavFormat *f) {
    return f && f->ctx ? (int)f->ctx->nb_streams : 0;
}

CAV_EXPORT const char *cav_format_name(CavFormat *f) {
    return f && f->ctx && f->ctx->iformat ? f->ctx->iformat->name : "";
}

// Container-level metadata (the reference AVContainer's
// format_long_name / mime_type / duration / bit_rate getters,
// src/libav/AVContainer.c:140-180).
struct CavContainerInfo {
    char format_long_name[128];
    char mime_type[64];
    int64_t duration;       // microseconds, AV_NOPTS -> 0
    int64_t bit_rate;
};

CAV_EXPORT int cav_container_info(CavFormat *f, CavContainerInfo *out) {
    if (!f || !f->ctx) return -1;
    memset(out, 0, sizeof(*out));
    const AVInputFormat *in = f->ctx->iformat;
    if (in && in->long_name)
        snprintf(out->format_long_name, sizeof(out->format_long_name),
                 "%s", in->long_name);
    if (in && in->mime_type)
        snprintf(out->mime_type, sizeof(out->mime_type), "%s",
                 in->mime_type);
    out->duration =
        f->ctx->duration == AV_NOPTS_VALUE ? 0 : f->ctx->duration;
    out->bit_rate = f->ctx->bit_rate;
    return 0;
}

// Per-stream extras beyond CavStreamInfo (reference AVStream id /
// bit_rate / encoding getters, AVContainer.c:254-343; 'encoding' is
// the descriptive codec name).
struct CavStreamExtra {
    int32_t id;
    int64_t bit_rate;
    char codec_long_name[96];
};

CAV_EXPORT int cav_stream_extra(CavFormat *f, int idx,
                                CavStreamExtra *out) {
    if (!f || !f->ctx || idx < 0 || idx >= (int)f->ctx->nb_streams)
        return -1;
    AVStream *s = f->ctx->streams[idx];
    memset(out, 0, sizeof(*out));
    out->id = s->id;
    out->bit_rate = s->codecpar->bit_rate;
    const AVCodecDescriptor *desc =
        avcodec_descriptor_get(s->codecpar->codec_id);
    if (desc && desc->long_name)
        snprintf(out->codec_long_name, sizeof(out->codec_long_name),
                 "%s", desc->long_name);
    return 0;
}

CAV_EXPORT int cav_stream_info(CavFormat *f, int idx, CavStreamInfo *out) {
    if (!f || !f->ctx || idx < 0 || idx >= (int)f->ctx->nb_streams) return -1;
    AVStream *s = f->ctx->streams[idx];
    AVCodecParameters *par = s->codecpar;
    memset(out, 0, sizeof(*out));
    switch (par->codec_type) {
        case AVMEDIA_TYPE_VIDEO: out->type = 0; break;
        case AVMEDIA_TYPE_AUDIO: out->type = 1; break;
        default: out->type = 2; break;
    }
    const char *cname = avcodec_get_name(par->codec_id);
    snprintf(out->codec_name, sizeof(out->codec_name), "%s", cname);
    out->width = par->width;
    out->height = par->height;
    if (par->codec_type == AVMEDIA_TYPE_VIDEO) {
        const char *pname = av_get_pix_fmt_name((AVPixelFormat)par->format);
        snprintf(out->pix_fmt, sizeof(out->pix_fmt), "%s", pname ? pname : "");
        AVRational fr = av_guess_frame_rate(f->ctx, s, nullptr);
        out->frame_rate_num = fr.num;
        out->frame_rate_den = fr.den;
        // Demuxers surface the aspect ratio on the stream or the
        // codec parameters depending on the container; prefer the
        // effective one (av_guess_sample_aspect_ratio).
        AVRational sar = av_guess_sample_aspect_ratio(f->ctx, s, nullptr);
        out->sar_num = sar.num;
        out->sar_den = sar.den;
    }
    out->time_base_num = s->time_base.num;
    out->time_base_den = s->time_base.den;
    out->duration = s->duration;
    out->nb_frames = s->nb_frames;
    out->sample_rate = par->sample_rate;
    out->channels = par->ch_layout.nb_channels;
    out->start_time = s->start_time;
    return 0;
}

// --------------------------------------------------------------------------
// Packet-level demux (AVDemuxer.c equivalent)

struct CavPacket {
    uint8_t *data;
    int32_t size;
    int64_t pts, dts, duration;
    int32_t keyframe;
    int32_t stream;
};

CAV_EXPORT int cav_read_packet(CavFormat *f, int stream, CavPacket *out) {
    AVPacket *pkt = av_packet_alloc();
    while (true) {
        int rc = av_read_frame(f->ctx, pkt);
        if (rc == AVERROR_EOF) {
            av_packet_free(&pkt);
            return 0;
        }
        if (rc < 0) {
            av_packet_free(&pkt);
            return rc;
        }
        if (stream < 0 || pkt->stream_index == stream) break;
        av_packet_unref(pkt);
    }
    out->data = (uint8_t *)malloc(pkt->size);
    memcpy(out->data, pkt->data, pkt->size);
    out->size = pkt->size;
    out->pts = pkt->pts;
    out->dts = pkt->dts;
    out->duration = pkt->duration;
    out->keyframe = (pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
    out->stream = pkt->stream_index;
    av_packet_unref(pkt);
    av_packet_free(&pkt);
    return 1;
}

CAV_EXPORT void cav_packet_free(CavPacket *p) {
    if (p && p->data) {
        free(p->data);
        p->data = nullptr;
    }
}

CAV_EXPORT int cav_seek(CavFormat *f, int stream, int64_t ts, int backward) {
    // AVDemuxer.c:126-135
    return av_seek_frame(f->ctx, stream, ts,
                         backward ? AVSEEK_FLAG_BACKWARD : 0);
}

// --------------------------------------------------------------------------
// Video decoder (AVVideoDecoder.c equivalent; owns demux + codec)

struct CavVideoDec {
    AVFormatContext *fmt = nullptr;
    AVCodecContext *codec = nullptr;
    SwsContext *sws = nullptr;
    AVFrame *frame = nullptr;
    AVPacket *pkt = nullptr;
    int stream = -1;
    AVRational frame_rate{};     // frames per second
    AVRational time_base{};
    int64_t next_frame = -1;     // next frame index decode will produce
    bool saw_nopts = false;      // stream has produced a NOPTS frame
    bool eof = false;
    int out_w = 0, out_h = 0;
    int src_w = 0, src_h = 0;    // dims the cached sws was built for
    AVPixelFormat out_fmt = AV_PIX_FMT_NONE;
};

CAV_EXPORT CavVideoDec *cav_video_decoder_open(const char *filename,
                                               int stream, char *err,
                                               int errlen) {
    auto *d = new CavVideoDec();
    int rc = avformat_open_input(&d->fmt, filename, nullptr, nullptr);
    if (rc < 0) {
        set_err(err, errlen, "open_input: " + av_errstr(rc));
        delete d;
        return nullptr;
    }
    avformat_find_stream_info(d->fmt, nullptr);
    if (stream < 0) {
        stream = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                     nullptr, 0);
    }
    if (stream < 0 || stream >= (int)d->fmt->nb_streams ||
        d->fmt->streams[stream]->codecpar->codec_type != AVMEDIA_TYPE_VIDEO) {
        set_err(err, errlen, "no such video stream");
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    d->stream = stream;
    AVStream *s = d->fmt->streams[stream];
    const AVCodec *codec = avcodec_find_decoder(s->codecpar->codec_id);
    if (!codec) {
        set_err(err, errlen, "no decoder for stream codec");
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    d->codec = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(d->codec, s->codecpar);
    enable_codec_threads(d->codec);
    rc = avcodec_open2(d->codec, codec, nullptr);
    if (rc < 0) {
        set_err(err, errlen, "avcodec_open2: " + av_errstr(rc));
        avcodec_free_context(&d->codec);
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    d->frame = av_frame_alloc();
    d->pkt = av_packet_alloc();
    d->frame_rate = av_guess_frame_rate(d->fmt, s, nullptr);
    if (d->frame_rate.num == 0) d->frame_rate = {30000, 1001};
    d->time_base = s->time_base;
    d->next_frame = 0;
    return d;
}

CAV_EXPORT void cav_video_decoder_close(CavVideoDec *d) {
    if (!d) return;
    if (d->sws) sws_freeContext(d->sws);
    if (d->frame) av_frame_free(&d->frame);
    if (d->pkt) av_packet_free(&d->pkt);
    if (d->codec) avcodec_free_context(&d->codec);
    if (d->fmt) avformat_close_input(&d->fmt);
    delete d;
}

CAV_EXPORT void cav_video_decoder_info(CavVideoDec *d, CavStreamInfo *out) {
    // a temp CavFormat view, not a reinterpret_cast of &d->fmt (which
    // silently depended on member order)
    CavFormat view;
    view.ctx = d->fmt;
    cav_stream_info(&view, d->stream, out);
}

// Color metadata for reconstruction-path selection:
// range: AVCOL_RANGE_* (0 unspecified, 1 mpeg/studio, 2 jpeg/full)
// space: AVCOL_SPC_* (1 bt709, 5 bt470bg, 6 smpte170m, 2 unspecified)
CAV_EXPORT void cav_video_decoder_color_info(CavVideoDec *d, int32_t *range,
                                             int32_t *space) {
    AVCodecParameters *par = d->fmt->streams[d->stream]->codecpar;
    *range = (int32_t)par->color_range;
    *space = (int32_t)par->color_space;
}

namespace {

int64_t pts_to_frame(CavVideoDec *d, int64_t pts) {
    if (pts == AV_NOPTS_VALUE) return -1;
    AVStream *s = d->fmt->streams[d->stream];
    int64_t start = s->start_time == AV_NOPTS_VALUE ? 0 : s->start_time;
    // frame = (pts - start) * time_base * frame_rate, rounded
    return av_rescale_q(pts - start, d->time_base, av_inv_q(d->frame_rate));
}

int64_t frame_to_pts(CavVideoDec *d, int64_t frame) {
    AVStream *s = d->fmt->streams[d->stream];
    int64_t start = s->start_time == AV_NOPTS_VALUE ? 0 : s->start_time;
    return start + av_rescale_q(frame, av_inv_q(d->frame_rate), d->time_base);
}

// Decode the next frame into d->frame. 1 ok, 0 eof, <0 error.
int decode_next(CavVideoDec *d) {
    while (true) {
        int rc = avcodec_receive_frame(d->codec, d->frame);
        if (rc == 0) return 1;
        if (rc != AVERROR(EAGAIN) && rc != AVERROR_EOF) return rc;
        if (rc == AVERROR_EOF) return 0;
        rc = av_read_frame(d->fmt, d->pkt);
        if (rc == AVERROR_EOF) {
            avcodec_send_packet(d->codec, nullptr);  // flush
            continue;
        }
        if (rc < 0) return rc;
        if (d->pkt->stream_index != d->stream) {
            av_packet_unref(d->pkt);
            continue;
        }
        rc = avcodec_send_packet(d->codec, d->pkt);
        av_packet_unref(d->pkt);
        if (rc < 0 && rc != AVERROR(EAGAIN)) return rc;
    }
}

// Seek (when going backward or far forward, AVVideoDecoder.c:182-219)
// and decode forward until *frame_index* is in d->frame.
// Returns 1 ok, 0 past-eof, <0 error.
int decode_to_index(CavVideoDec *d, int64_t frame_index) {
    if (frame_index < d->next_frame || frame_index > d->next_frame + 64) {
        if (d->saw_nopts) {
            // Timestamp-less stream (elementary .m2v/.h264): a frame
            // decoded after a mid-stream seek has no identifiable
            // index, so indices only count from the stream head.
            // Rewind for backward targets; decode forward otherwise.
            if (frame_index < d->next_frame) {
                int rc = av_seek_frame(d->fmt, d->stream, 0,
                                       AVSEEK_FLAG_BACKWARD);
                if (rc < 0) return rc;
                avcodec_flush_buffers(d->codec);
                d->next_frame = 0;   // counting restarts at the head
            }
        } else {
            int64_t target_pts = frame_to_pts(d, frame_index);
            int rc = av_seek_frame(d->fmt, d->stream, target_pts,
                                   AVSEEK_FLAG_BACKWARD);
            if (rc < 0) return rc;
            avcodec_flush_buffers(d->codec);
            d->next_frame = -1;  // unknown until first decoded pts
        }
    }
    while (true) {
        int rc = decode_next(d);
        if (rc <= 0) return rc;
        int64_t got = pts_to_frame(d, d->frame->best_effort_timestamp);
        if (got < 0) {
            d->saw_nopts = true;
            got = d->next_frame < 0 ? 0 : d->next_frame;
        }
        d->next_frame = got + 1;
        if (got >= frame_index) return 1;
        av_frame_unref(d->frame);
    }
}

}  // namespace

// Decode frame by index into caller-provided RGBA8 buffer (h*w*4).
// Returns 1 ok, 0 past-eof, <0 error.
CAV_EXPORT int cav_video_decode_rgba(CavVideoDec *d, int64_t frame_index,
                                     uint8_t *out, int out_w, int out_h) {
    int rc = decode_to_index(d, frame_index);
    if (rc <= 0) return rc;

    // Cache key must include the SOURCE dims: media is untrusted input
    // and decoded dimensions can change mid-stream (SPS change); a sws
    // built for the old size fed a taller frame writes past the
    // caller's (h, w, 4) buffer.
    if (!d->sws || d->out_w != out_w || d->out_h != out_h ||
        d->src_w != d->frame->width || d->src_h != d->frame->height ||
        d->out_fmt != (AVPixelFormat)d->frame->format) {
        if (d->sws) sws_freeContext(d->sws);
        d->sws = sws_getContext(d->frame->width, d->frame->height,
                                (AVPixelFormat)d->frame->format, out_w, out_h,
                                AV_PIX_FMT_RGBA, SWS_BILINEAR, nullptr,
                                nullptr, nullptr);
        d->out_w = out_w;
        d->out_h = out_h;
        d->src_w = d->frame->width;
        d->src_h = d->frame->height;
        d->out_fmt = (AVPixelFormat)d->frame->format;
    }
    uint8_t *dst[4] = {out, nullptr, nullptr, nullptr};
    int dst_stride[4] = {out_w * 4, 0, 0, 0};
    sws_scale(d->sws, d->frame->data, d->frame->linesize, 0, d->frame->height,
              dst, dst_stride);
    av_frame_unref(d->frame);
    return 1;
}

// Decode frame by index into caller-provided planar YCbCr buffers.
// Supports planar 8-bit source formats (yuv411p/420p/422p...); fills the
// three planes at their native subsampled sizes. y_cap / c_cap are the
// byte capacities of the luma and each chroma buffer; frames larger than
// the capacities (dimensions can change mid-stream, and media files are
// untrusted input) return -1001 instead of overflowing. Returns plane
// dims via dims[6] = {yw,yh,cw,ch,cw,ch}. 1 ok, 0 eof, <0 error, -1000
// if the decoded format is not planar 8-bit YCbCr, -1001 if a plane
// exceeds its buffer capacity (dims still filled so the caller can
// reallocate and retry).
CAV_EXPORT int cav_video_decode_planar(CavVideoDec *d, int64_t frame_index,
                                       uint8_t *y, uint8_t *cb, uint8_t *cr,
                                       int *dims, int64_t y_cap,
                                       int64_t c_cap) {
    int drc = decode_to_index(d, frame_index);
    if (drc <= 0) return drc;
    const AVPixFmtDescriptor *desc =
        av_pix_fmt_desc_get((AVPixelFormat)d->frame->format);
    // Require truly planar 8-bit YCbCr: semi-planar formats (NV12)
    // pass the descriptor checks but have data[2] == NULL and would
    // crash the chroma copy below.
    if (!desc || desc->nb_components < 3 ||
        desc->comp[0].depth != 8 ||
        (desc->flags & AV_PIX_FMT_FLAG_RGB) ||
        !d->frame->data[1] || !d->frame->data[2] ||
        desc->comp[1].plane == desc->comp[2].plane) {
        av_frame_unref(d->frame);
        return -1000;
    }
    int yw = d->frame->width, yh = d->frame->height;
    int cw = AV_CEIL_RSHIFT(yw, desc->log2_chroma_w);
    int ch = AV_CEIL_RSHIFT(yh, desc->log2_chroma_h);
    dims[0] = yw; dims[1] = yh;
    dims[2] = cw; dims[3] = ch;
    dims[4] = cw; dims[5] = ch;
    if ((int64_t)yw * yh > y_cap || (int64_t)cw * ch > c_cap) {
        av_frame_unref(d->frame);
        return -1001;
    }
    for (int r = 0; r < yh; r++)
        memcpy(y + r * yw, d->frame->data[0] + r * d->frame->linesize[0], yw);
    for (int r = 0; r < ch; r++) {
        memcpy(cb + r * cw, d->frame->data[1] + r * d->frame->linesize[1], cw);
        memcpy(cr + r * cw, d->frame->data[2] + r * d->frame->linesize[2], cw);
    }
    av_frame_unref(d->frame);
    return 1;
}

// --------------------------------------------------------------------------
// Audio decoder (AVAudioDecoder.c equivalent)

struct CavAudioDec {
    AVFormatContext *fmt = nullptr;
    AVCodecContext *codec = nullptr;
    SwrContext *swr = nullptr;
    AVFrame *frame = nullptr;
    AVPacket *pkt = nullptr;
    int stream = -1;
    int channels = 0;
    int sample_rate = 0;
    int64_t next_sample = 0;   // next output sample index decode produces
};

CAV_EXPORT CavAudioDec *cav_audio_decoder_open(const char *filename,
                                               int stream, int channels,
                                               char *err, int errlen) {
    auto *d = new CavAudioDec();
    int rc = avformat_open_input(&d->fmt, filename, nullptr, nullptr);
    if (rc < 0) {
        set_err(err, errlen, "open_input: " + av_errstr(rc));
        delete d;
        return nullptr;
    }
    avformat_find_stream_info(d->fmt, nullptr);
    if (stream < 0)
        stream = av_find_best_stream(d->fmt, AVMEDIA_TYPE_AUDIO, -1, -1,
                                     nullptr, 0);
    if (stream < 0 || stream >= (int)d->fmt->nb_streams ||
        d->fmt->streams[stream]->codecpar->codec_type != AVMEDIA_TYPE_AUDIO) {
        set_err(err, errlen, "no such audio stream");
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    d->stream = stream;
    AVStream *s = d->fmt->streams[stream];
    const AVCodec *codec = avcodec_find_decoder(s->codecpar->codec_id);
    d->codec = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(d->codec, s->codecpar);
    enable_codec_threads(d->codec);
    rc = avcodec_open2(d->codec, codec, nullptr);
    if (rc < 0) {
        set_err(err, errlen, "avcodec_open2: " + av_errstr(rc));
        avcodec_free_context(&d->codec);
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    d->frame = av_frame_alloc();
    d->pkt = av_packet_alloc();
    d->sample_rate = s->codecpar->sample_rate;
    d->channels = channels > 0 ? channels : s->codecpar->ch_layout.nb_channels;

    AVChannelLayout out_layout;
    av_channel_layout_default(&out_layout, d->channels);
    swr_alloc_set_opts2(&d->swr, &out_layout, AV_SAMPLE_FMT_FLT,
                        d->sample_rate, &s->codecpar->ch_layout,
                        (AVSampleFormat)s->codecpar->format, d->sample_rate,
                        0, nullptr);
    swr_init(d->swr);
    av_channel_layout_uninit(&out_layout);
    return d;
}

CAV_EXPORT void cav_audio_decoder_close(CavAudioDec *d) {
    if (!d) return;
    if (d->swr) swr_free(&d->swr);
    if (d->frame) av_frame_free(&d->frame);
    if (d->pkt) av_packet_free(&d->pkt);
    if (d->codec) avcodec_free_context(&d->codec);
    if (d->fmt) avformat_close_input(&d->fmt);
    delete d;
}

CAV_EXPORT int cav_audio_decoder_channels(CavAudioDec *d) {
    return d->channels;
}

CAV_EXPORT int cav_audio_decoder_sample_rate(CavAudioDec *d) {
    return d->sample_rate;
}

// Fill interleaved float32 out[(max-min+1) * channels] with samples
// [min_sample, max_sample]. Missing data is zero. Returns count filled.
CAV_EXPORT int64_t cav_audio_decode(CavAudioDec *d, int64_t min_sample,
                                    int64_t max_sample, float *out) {
    int64_t count = max_sample - min_sample + 1;
    memset(out, 0, sizeof(float) * count * d->channels);

    AVStream *s = d->fmt->streams[d->stream];
    auto do_seek = [&](int64_t target_sample) {
        if (target_sample < 0) target_sample = 0;
        int64_t ts = av_rescale_q(target_sample, {1, d->sample_rate},
                                  s->time_base);
        int64_t start =
            s->start_time == AV_NOPTS_VALUE ? 0 : s->start_time;
        av_seek_frame(d->fmt, d->stream, start + ts, AVSEEK_FLAG_BACKWARD);
        avcodec_flush_buffers(d->codec);
        d->next_sample = -1;
    };
    // Seek when going backward (AVAudioDecoder.c seek-avoidance: small
    // forward distances just decode ahead, :240-295)
    int64_t seek_bias = 0;
    bool just_sought = false;
    if (min_sample < d->next_sample ||
        min_sample > d->next_sample + d->sample_rate * 4) {
        do_seek(min_sample);
        just_sought = true;
    }

    int64_t filled = 0;
    std::vector<float> conv;
    while (true) {
        int rc;
        while ((rc = avcodec_receive_frame(d->codec, d->frame)) ==
               AVERROR(EAGAIN)) {
            rc = av_read_frame(d->fmt, d->pkt);
            if (rc == AVERROR_EOF) {
                avcodec_send_packet(d->codec, nullptr);
                continue;
            }
            // A real mid-stream read error (truncated/corrupt file) is
            // NOT end-of-stream: report it instead of silently handing
            // the caller zero-filled (silent) samples.
            if (rc < 0) return rc;
            if (d->pkt->stream_index != d->stream) {
                av_packet_unref(d->pkt);
                continue;
            }
            avcodec_send_packet(d->codec, d->pkt);
            av_packet_unref(d->pkt);
        }
        if (rc == AVERROR_EOF) return filled;
        if (rc < 0) return rc;

        // Position: prefer pts; fall back to running counter
        int64_t pos;
        if (d->frame->pts != AV_NOPTS_VALUE) {
            int64_t start =
                s->start_time == AV_NOPTS_VALUE ? 0 : s->start_time;
            pos = av_rescale_q(d->frame->pts - start, s->time_base,
                               {1, d->sample_rate});
        } else {
            pos = d->next_sample < 0 ? 0 : d->next_sample;
        }
        // Seek landed PAST the read point (e.g. avformat's dv demuxer
        // rounds a mid-frame target up to the next frame, losing the
        // head of the requested window — the reference's decoders keep
        // a last-frame cache for the same reason, DVAudioDecoder.c
        // "Previous frame contains our read point"): verify the first
        // post-seek frame and re-seek with a growing back-bias.
        if (just_sought && pos > min_sample &&
            seek_bias < 2 * d->sample_rate) {
            seek_bias = seek_bias ? seek_bias * 4 : d->sample_rate / 8;
            av_frame_unref(d->frame);
            do_seek(min_sample - seek_bias);
            continue;
        }
        just_sought = false;

        int n = d->frame->nb_samples;
        d->next_sample = pos + n;

        conv.resize((size_t)n * d->channels);
        uint8_t *outp[1] = {(uint8_t *)conv.data()};
        swr_convert(d->swr, outp, n,
                    (const uint8_t **)d->frame->extended_data, n);
        av_frame_unref(d->frame);

        int64_t lo = pos > min_sample ? pos : min_sample;
        int64_t hi = (pos + n - 1) < max_sample ? (pos + n - 1) : max_sample;
        for (int64_t i = lo; i <= hi; i++) {
            memcpy(out + (i - min_sample) * d->channels,
                   conv.data() + (i - pos) * d->channels,
                   sizeof(float) * d->channels);
        }
        if (hi >= lo) filled += hi - lo + 1;
        if (d->next_sample > max_sample) return filled;
    }
}

// --------------------------------------------------------------------------
// Muxer + encoders (AVMuxer.c / AVVideoEncoder.c / writeVideo.c equivalent)

struct CavMuxStream {
    AVStream *stream = nullptr;
    AVCodecContext *codec = nullptr;
    SwsContext *sws = nullptr;
    SwsContext *sws_planar = nullptr;  // yuv420p input -> codec pix_fmt
    SwrContext *swr = nullptr;
    AVFrame *frame = nullptr;
    int64_t next_pts = 0;
    int is_video = 0;
    // Copy streams (no encoder): original packet timestamp base.
    AVRational copy_in_tb = {0, 1};
    // Interleaved f32 samples not yet forming a full codec frame:
    // fixed-frame-size codecs (aac: 1024) reject a short non-final
    // frame, so call tails buffer here until the next write or finish.
    std::vector<float> pending_audio;
};

struct CavMuxer {
    AVFormatContext *ctx = nullptr;
    std::vector<CavMuxStream *> streams;
    bool header_written = false;
};

// Stream-copy muxing: a stream that receives pre-encoded packets from a
// CodecPacketSource instead of running an encoder — the reference
// AVMuxer's model (src/libav/AVMuxer.c:144-210: streams carry codec
// parameters only; AVMuxer_run pumps packets from the sources).  Copy
// streams have s->codec == nullptr; in_tb remembers the packet
// timestamp base (1/frame_rate) because avformat_write_header may
// rewrite stream->time_base (e.g. avi).
CAV_EXPORT int cav_muxer_add_copy_video(CavMuxer *m, const char *codec_name,
                                        int width, int height, int fps_num,
                                        int fps_den, int sar_num, int sar_den,
                                        char *err, int errlen) {
    const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
    const AVCodecDescriptor *desc =
        codec ? avcodec_descriptor_get(codec->id)
              : avcodec_descriptor_get_by_name(codec_name);
    if (!codec && !desc) {
        set_err(err, errlen, std::string("no codec: ") + codec_name);
        return -1;
    }
    auto *s = new CavMuxStream();
    s->is_video = 1;
    s->stream = avformat_new_stream(m->ctx, nullptr);
    if (!s->stream) {
        set_err(err, errlen, "avformat_new_stream failed");
        delete s;
        return -1;
    }
    s->stream->time_base = {fps_den, fps_num};
    s->stream->avg_frame_rate = {fps_num, fps_den};
    AVCodecParameters *par = s->stream->codecpar;
    par->codec_type = AVMEDIA_TYPE_VIDEO;
    par->codec_id = codec ? codec->id : desc->id;
    par->width = width;
    par->height = height;
    if (sar_num > 0 && sar_den > 0) {
        par->sample_aspect_ratio = {sar_num, sar_den};
        s->stream->sample_aspect_ratio = {sar_num, sar_den};
    }
    s->copy_in_tb = {fps_den, fps_num};
    m->streams.push_back(s);
    return (int)m->streams.size() - 1;
}

// Global header (extradata) for a copy stream; must run before
// cav_muxer_start (AVMuxer.c:219-228 fetches get_header at run()).
CAV_EXPORT int cav_muxer_set_extradata(CavMuxer *m, int stream,
                                       const uint8_t *data, int size) {
    CavMuxStream *s = m->streams[stream];
    AVCodecParameters *par = s->stream->codecpar;
    if (par->extradata) av_freep(&par->extradata);
    par->extradata_size = 0;
    if (size > 0) {
        par->extradata =
            (uint8_t *)av_mallocz(size + AV_INPUT_BUFFER_PADDING_SIZE);
        if (!par->extradata) return AVERROR(ENOMEM);
        memcpy(par->extradata, data, size);
        par->extradata_size = size;
    }
    return 0;
}

// Write one pre-encoded packet to a copy stream (AVMuxer.c:262-290).
// pts/dts/duration are in frame units (1/frame_rate); AV_NOPTS_VALUE
// passes through for unknown timestamps.
CAV_EXPORT int cav_muxer_write_packet(CavMuxer *m, int stream,
                                      const uint8_t *data, int size,
                                      int64_t pts, int64_t dts,
                                      int64_t duration, int keyframe) {
    CavMuxStream *s = m->streams[stream];
    AVPacket *pkt = av_packet_alloc();
    if (!pkt) return AVERROR(ENOMEM);
    int rc = av_new_packet(pkt, size);
    if (rc < 0) {
        av_packet_free(&pkt);
        return rc;
    }
    memcpy(pkt->data, data, size);
    pkt->pts = pts;
    pkt->dts = dts;
    pkt->duration = duration > 0 ? duration : 0;
    if (keyframe) pkt->flags |= AV_PKT_FLAG_KEY;
    av_packet_rescale_ts(pkt, s->copy_in_tb, s->stream->time_base);
    pkt->stream_index = s->stream->index;
    rc = av_interleaved_write_frame(m->ctx, pkt);
    av_packet_free(&pkt);
    return rc;
}

CAV_EXPORT CavMuxer *cav_muxer_create(const char *filename,
                                      const char *format_name, char *err,
                                      int errlen) {
    auto *m = new CavMuxer();
    int rc = avformat_alloc_output_context2(
        &m->ctx, nullptr, format_name && *format_name ? format_name : nullptr,
        filename);
    if (rc < 0 || !m->ctx) {
        set_err(err, errlen, "alloc_output_context: " + av_errstr(rc));
        delete m;
        return nullptr;
    }
    if (!(m->ctx->oformat->flags & AVFMT_NOFILE)) {
        rc = avio_open(&m->ctx->pb, filename, AVIO_FLAG_WRITE);
        if (rc < 0) {
            set_err(err, errlen, "avio_open: " + av_errstr(rc));
            avformat_free_context(m->ctx);
            delete m;
            return nullptr;
        }
    }
    return m;
}

// Extended video stream setup: sample aspect ratio + interlacing flags
// (the reference AVVideoEncoder's sample_aspect_ratio / interlaced /
// top_field_first kwargs, src/libav/AVVideoEncoder.c).
CAV_EXPORT int cav_muxer_add_video_ex(CavMuxer *m, const char *codec_name,
                                      int width, int height, int fps_num,
                                      int fps_den, int64_t bit_rate,
                                      int sar_num, int sar_den,
                                      int interlaced, int top_field_first,
                                      const char *options, char *err,
                                      int errlen) {
    const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
    if (!codec) {
        set_err(err, errlen, std::string("no encoder: ") + codec_name);
        return -1;
    }
    auto *s = new CavMuxStream();
    s->is_video = 1;
    s->codec = avcodec_alloc_context3(codec);
    s->codec->width = width;
    s->codec->height = height;
    s->codec->time_base = {fps_den, fps_num};
    s->codec->framerate = {fps_num, fps_den};
    s->codec->pix_fmt =
        codec->pix_fmts ? codec->pix_fmts[0] : AV_PIX_FMT_YUV420P;
    if (bit_rate > 0) s->codec->bit_rate = bit_rate;
    if (sar_num > 0 && sar_den > 0)
        s->codec->sample_aspect_ratio = {sar_num, sar_den};
    if (interlaced) {
        s->codec->field_order = top_field_first ? AV_FIELD_TT : AV_FIELD_BB;
        s->codec->flags |=
            AV_CODEC_FLAG_INTERLACED_DCT | AV_CODEC_FLAG_INTERLACED_ME;
    }
    s->codec->gop_size = 12;
    if (m->ctx->oformat->flags & AVFMT_GLOBALHEADER)
        s->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;

    enable_codec_threads(s->codec);
    AVDictionary *opts = nullptr;
    if (options && *options) av_dict_parse_string(&opts, options, "=", ":", 0);
    int rc = avcodec_open2(s->codec, codec, &opts);
    if (rc >= 0) warn_unconsumed_opts(opts, codec_name);
    av_dict_free(&opts);
    if (rc < 0) {
        set_err(err, errlen, "avcodec_open2: " + av_errstr(rc));
        avcodec_free_context(&s->codec);
        delete s;
        return -1;
    }
    s->stream = avformat_new_stream(m->ctx, nullptr);
    s->stream->time_base = s->codec->time_base;
    avcodec_parameters_from_context(s->stream->codecpar, s->codec);
    if (sar_num > 0 && sar_den > 0)
        s->stream->sample_aspect_ratio = {sar_num, sar_den};
    s->frame = av_frame_alloc();
    s->frame->format = s->codec->pix_fmt;
    s->frame->width = width;
    s->frame->height = height;
    if (interlaced) {
#if LIBAVUTIL_VERSION_MAJOR >= 58
        s->frame->flags |= AV_FRAME_FLAG_INTERLACED;
        if (top_field_first) s->frame->flags |= AV_FRAME_FLAG_TOP_FIELD_FIRST;
#else
        s->frame->interlaced_frame = 1;
        s->frame->top_field_first = top_field_first ? 1 : 0;
#endif
    }
    av_frame_get_buffer(s->frame, 0);
    s->sws = sws_getContext(width, height, AV_PIX_FMT_RGBA, width, height,
                            s->codec->pix_fmt, SWS_BILINEAR, nullptr, nullptr,
                            nullptr);
    m->streams.push_back(s);
    return (int)m->streams.size() - 1;
}

CAV_EXPORT int cav_muxer_add_video(CavMuxer *m, const char *codec_name,
                                   int width, int height, int fps_num,
                                   int fps_den, int64_t bit_rate,
                                   const char *options, char *err,
                                   int errlen) {
    return cav_muxer_add_video_ex(m, codec_name, width, height, fps_num,
                                  fps_den, bit_rate, 0, 0, 0, 0, options,
                                  err, errlen);
}

CAV_EXPORT int cav_muxer_add_audio(CavMuxer *m, const char *codec_name,
                                   int sample_rate, int channels,
                                   int64_t bit_rate, char *err, int errlen) {
    const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
    if (!codec) {
        set_err(err, errlen, std::string("no encoder: ") + codec_name);
        return -1;
    }
    auto *s = new CavMuxStream();
    s->codec = avcodec_alloc_context3(codec);
    s->codec->sample_rate = sample_rate;
    av_channel_layout_default(&s->codec->ch_layout, channels);
    s->codec->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0]
                                              : AV_SAMPLE_FMT_FLTP;
    s->codec->time_base = {1, sample_rate};
    if (bit_rate > 0) s->codec->bit_rate = bit_rate;
    if (m->ctx->oformat->flags & AVFMT_GLOBALHEADER)
        s->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    int rc = avcodec_open2(s->codec, codec, nullptr);
    if (rc < 0) {
        set_err(err, errlen, "avcodec_open2: " + av_errstr(rc));
        avcodec_free_context(&s->codec);
        delete s;
        return -1;
    }
    s->stream = avformat_new_stream(m->ctx, nullptr);
    s->stream->time_base = s->codec->time_base;
    avcodec_parameters_from_context(s->stream->codecpar, s->codec);
    s->frame = av_frame_alloc();
    s->frame->format = s->codec->sample_fmt;
    s->frame->nb_samples = s->codec->frame_size > 0 ? s->codec->frame_size
                                                    : 1024;
    av_channel_layout_copy(&s->frame->ch_layout, &s->codec->ch_layout);
    s->frame->sample_rate = sample_rate;
    av_frame_get_buffer(s->frame, 0);

    AVChannelLayout in_layout;
    av_channel_layout_default(&in_layout, channels);
    swr_alloc_set_opts2(&s->swr, &s->codec->ch_layout, s->codec->sample_fmt,
                        sample_rate, &in_layout, AV_SAMPLE_FMT_FLT,
                        sample_rate, 0, nullptr);
    swr_init(s->swr);
    av_channel_layout_uninit(&in_layout);
    m->streams.push_back(s);
    return (int)m->streams.size() - 1;
}

CAV_EXPORT int cav_muxer_start(CavMuxer *m, char *err, int errlen) {
    int rc = avformat_write_header(m->ctx, nullptr);
    if (rc < 0) {
        set_err(err, errlen, "write_header: " + av_errstr(rc));
        return rc;
    }
    m->header_written = true;
    return 0;
}

namespace {

int drain_packets(CavMuxer *m, CavMuxStream *s) {
    // DTS-ordered interleave handled by av_interleaved_write_frame
    // (AVMuxer.c:232-245 does this manually; libavformat does it for us)
    AVPacket *pkt = av_packet_alloc();
    int rc;
    while ((rc = avcodec_receive_packet(s->codec, pkt)) == 0) {
        av_packet_rescale_ts(pkt, s->codec->time_base, s->stream->time_base);
        pkt->stream_index = s->stream->index;
        rc = av_interleaved_write_frame(m->ctx, pkt);
        av_packet_unref(pkt);
        if (rc < 0) break;
    }
    av_packet_free(&pkt);
    return (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) ? 0 : rc;
}

}  // namespace

// Encode one RGBA8 video frame (h*w*4, top-down).
CAV_EXPORT int cav_muxer_write_video(CavMuxer *m, int stream,
                                     const uint8_t *rgba) {
    CavMuxStream *s = m->streams[stream];
    av_frame_make_writable(s->frame);
    const uint8_t *src[4] = {rgba, nullptr, nullptr, nullptr};
    int src_stride[4] = {s->codec->width * 4, 0, 0, 0};
    sws_scale(s->sws, src, src_stride, 0, s->codec->height, s->frame->data,
              s->frame->linesize);
    s->frame->pts = s->next_pts++;
    int rc = avcodec_send_frame(s->codec, s->frame);
    if (rc < 0) return rc;
    return drain_packets(m, s);
}

// Encode one pre-subsampled planar YCbCr 4:2:0 frame: y is h*w,
// cb/cr are ceil(h/2)*ceil(w/2), all tightly packed (stride == width).
// The device already did the RGB->YCbCr conversion + 2x2 chroma
// subsample, so when the codec consumes yuv420p (mpeg4/x264's native
// format) the planes copy straight into the frame — no sws pass and
// 2.6x fewer host-link bytes than the RGBA path above.
CAV_EXPORT int cav_muxer_write_video_planar(CavMuxer *m, int stream,
                                            const uint8_t *y,
                                            const uint8_t *cb,
                                            const uint8_t *cr) {
    CavMuxStream *s = m->streams[stream];
    av_frame_make_writable(s->frame);
    const int w = s->codec->width, h = s->codec->height;
    const int w2 = (w + 1) / 2, h2 = (h + 1) / 2;
    if (s->codec->pix_fmt == AV_PIX_FMT_YUV420P) {
        for (int r = 0; r < h; r++)
            memcpy(s->frame->data[0] + (size_t)r * s->frame->linesize[0],
                   y + (size_t)r * w, w);
        for (int r = 0; r < h2; r++) {
            memcpy(s->frame->data[1] + (size_t)r * s->frame->linesize[1],
                   cb + (size_t)r * w2, w2);
            memcpy(s->frame->data[2] + (size_t)r * s->frame->linesize[2],
                   cr + (size_t)r * w2, w2);
        }
    } else {
        if (!s->sws_planar) {
            s->sws_planar = sws_getContext(w, h, AV_PIX_FMT_YUV420P, w, h,
                                           s->codec->pix_fmt, SWS_BILINEAR,
                                           nullptr, nullptr, nullptr);
            if (!s->sws_planar) return -1;
        }
        const uint8_t *src[4] = {y, cb, cr, nullptr};
        int src_stride[4] = {w, w2, w2, 0};
        sws_scale(s->sws_planar, src, src_stride, 0, h, s->frame->data,
                  s->frame->linesize);
    }
    s->frame->pts = s->next_pts++;
    int rc = avcodec_send_frame(s->codec, s->frame);
    if (rc < 0) return rc;
    return drain_packets(m, s);
}

namespace {

// Convert+encode one chunk of interleaved f32 samples (chunk <= the
// frame's allocated nb_samples). Restores frame->nb_samples after.
int mux_send_audio_chunk(CavMuxer *m, CavMuxStream *s, const float *samples,
                         int chunk) {
    av_frame_make_writable(s->frame);
    int full = s->frame->nb_samples;
    const uint8_t *in[1] = {(const uint8_t *)samples};
    int conv = swr_convert(s->swr, s->frame->data, chunk, in, chunk);
    if (conv < 0) return conv;
    s->frame->nb_samples = conv;
    s->frame->pts = s->next_pts;
    s->next_pts += conv;
    int rc = avcodec_send_frame(s->codec, s->frame);
    s->frame->nb_samples = full;
    if (rc < 0) return rc;
    return drain_packets(m, s);
}

}  // namespace

// Encode interleaved float32 audio samples (n_samples * channels).
// Fixed-frame-size codecs (aac) reject short non-final frames, so a
// call tail that doesn't fill a codec frame buffers until the next
// call (or cav_muxer_finish, where a short FINAL frame is legal).
CAV_EXPORT int cav_muxer_write_audio(CavMuxer *m, int stream,
                                     const float *samples, int n_samples) {
    CavMuxStream *s = m->streams[stream];
    int ch = s->codec->ch_layout.nb_channels;
    int fixed = s->codec->frame_size > 0;
    int done = 0;
    if (fixed && !s->pending_audio.empty()) {
        // top up the buffered tail to one full frame
        int need = s->frame->nb_samples -
                   (int)(s->pending_audio.size() / ch);
        if (need > n_samples) need = n_samples;
        s->pending_audio.insert(s->pending_audio.end(), samples,
                                samples + (size_t)need * ch);
        done = need;
        if ((int)(s->pending_audio.size() / ch) < s->frame->nb_samples)
            return 0;                    // still short: keep buffering
        int rc = mux_send_audio_chunk(m, s, s->pending_audio.data(),
                                      s->frame->nb_samples);
        if (rc < 0) return rc;
        s->pending_audio.clear();
    }
    while (done < n_samples) {
        int chunk = s->frame->nb_samples;
        if (chunk > n_samples - done) chunk = n_samples - done;
        if (fixed && chunk < s->frame->nb_samples) {
            s->pending_audio.assign(
                samples + (size_t)done * ch,
                samples + (size_t)n_samples * ch);
            return 0;                    // tail: buffer for later
        }
        int rc = mux_send_audio_chunk(
            m, s, samples + (size_t)done * ch, chunk);
        if (rc < 0) return rc;
        done += chunk;
    }
    return 0;
}

CAV_EXPORT int cav_muxer_finish(CavMuxer *m) {
    int rc = 0;
    for (auto *s : m->streams) {
        if (!s->codec) continue;        // copy stream: nothing to flush
        if (!s->pending_audio.empty()) {
            // a short FINAL audio frame is legal for fixed-size codecs
            mux_send_audio_chunk(
                m, s, s->pending_audio.data(),
                (int)(s->pending_audio.size() /
                      s->codec->ch_layout.nb_channels));
            s->pending_audio.clear();
        }
        avcodec_send_frame(s->codec, nullptr);  // flush
        int drc = drain_packets(m, s);
        if (drc < 0 && rc == 0) rc = drc;   // keep the FIRST failure
    }
    if (m->header_written) {
        int trc = av_write_trailer(m->ctx);
        if (trc < 0 && rc == 0) rc = trc;
    }
    for (auto *s : m->streams) {
        if (s->sws) sws_freeContext(s->sws);
        if (s->sws_planar) sws_freeContext(s->sws_planar);
        if (s->swr) swr_free(&s->swr);
        if (s->frame) av_frame_free(&s->frame);
        if (s->codec) avcodec_free_context(&s->codec);
        delete s;
    }
    if (m->ctx && !(m->ctx->oformat->flags & AVFMT_NOFILE))
        avio_closep(&m->ctx->pb);
    if (m->ctx) avformat_free_context(m->ctx);
    delete m;
    return rc;
}

CAV_EXPORT const char *cav_version() {
    // C++11 magic-static: the buffer is formatted exactly once, under
    // the compiler's init guard — concurrent first calls are safe
    // (the previous write-every-call static was a data race under TSAN)
    static const std::string buf = [] {
        char tmp[128];
        snprintf(tmp, sizeof(tmp), "canvas_av avformat=%u avcodec=%u",
                 avformat_version(), avcodec_version());
        return std::string(tmp);
    }();
    return buf.c_str();
}

// --------------------------------------------------------------------------
// Standalone packet encoders (X264VideoEncoder.c / AACAudioEncoder.c
// equivalents): encode frames pushed from Python into packets pulled by
// Python — feeds the pure-Python Matroska muxer path
// (scripts/encode_x264_mkv.py shape).

struct CavEncoder {
    AVCodecContext *codec = nullptr;
    SwsContext *sws = nullptr;
    SwrContext *swr = nullptr;
    AVFrame *frame = nullptr;
    int64_t next_pts = 0;
    int is_video = 0;
};

// _ex: adds sample aspect ratio + interlacing flags (the reference
// AVVideoEncoder's sample_aspect_ratio / interlaced / top_field_first
// kwargs, src/libav/AVVideoEncoder.c:41-175).
CAV_EXPORT CavEncoder *cav_video_encoder_open_ex(const char *codec_name,
                                                 int width, int height,
                                                 int fps_num, int fps_den,
                                                 int64_t bit_rate,
                                                 int sar_num, int sar_den,
                                                 int interlaced,
                                                 int top_field_first,
                                                 const char *options,
                                                 char *err, int errlen) {
    const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
    if (!codec) {
        set_err(err, errlen, std::string("no encoder: ") + codec_name);
        return nullptr;
    }
    auto *e = new CavEncoder();
    e->is_video = 1;
    e->codec = avcodec_alloc_context3(codec);
    e->codec->width = width;
    e->codec->height = height;
    e->codec->time_base = {fps_den, fps_num};
    e->codec->framerate = {fps_num, fps_den};
    e->codec->pix_fmt = codec->pix_fmts ? codec->pix_fmts[0]
                                        : AV_PIX_FMT_YUV420P;
    if (bit_rate > 0) e->codec->bit_rate = bit_rate;
    if (sar_num > 0 && sar_den > 0)
        e->codec->sample_aspect_ratio = {sar_num, sar_den};
    if (interlaced) {
        e->codec->field_order = top_field_first ? AV_FIELD_TT : AV_FIELD_BB;
        e->codec->flags |=
            AV_CODEC_FLAG_INTERLACED_DCT | AV_CODEC_FLAG_INTERLACED_ME;
    }
    e->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;  // SPS/PPS in extradata

    enable_codec_threads(e->codec);
    AVDictionary *opts = nullptr;
    if (options && *options) av_dict_parse_string(&opts, options, "=", ":", 0);
    int rc = avcodec_open2(e->codec, codec, &opts);
    if (rc >= 0) warn_unconsumed_opts(opts, codec_name);
    av_dict_free(&opts);
    if (rc < 0) {
        set_err(err, errlen, "avcodec_open2: " + av_errstr(rc));
        avcodec_free_context(&e->codec);
        delete e;
        return nullptr;
    }
    e->frame = av_frame_alloc();
    e->frame->format = e->codec->pix_fmt;
    e->frame->width = width;
    e->frame->height = height;
    if (interlaced) {
#if LIBAVUTIL_VERSION_MAJOR >= 58
        e->frame->flags |= AV_FRAME_FLAG_INTERLACED;
        if (top_field_first) e->frame->flags |= AV_FRAME_FLAG_TOP_FIELD_FIRST;
#else
        e->frame->interlaced_frame = 1;
        e->frame->top_field_first = top_field_first ? 1 : 0;
#endif
    }
    av_frame_get_buffer(e->frame, 0);
    e->sws = sws_getContext(width, height, AV_PIX_FMT_RGBA, width, height,
                            e->codec->pix_fmt, SWS_BILINEAR, nullptr, nullptr,
                            nullptr);
    return e;
}

CAV_EXPORT CavEncoder *cav_video_encoder_open(const char *codec_name,
                                              int width, int height,
                                              int fps_num, int fps_den,
                                              int64_t bit_rate,
                                              const char *options, char *err,
                                              int errlen) {
    return cav_video_encoder_open_ex(codec_name, width, height, fps_num,
                                     fps_den, bit_rate, 0, 0, 0, 0, options,
                                     err, errlen);
}

CAV_EXPORT CavEncoder *cav_audio_encoder_open(const char *codec_name,
                                              int sample_rate, int channels,
                                              int64_t bit_rate, char *err,
                                              int errlen) {
    const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
    if (!codec) {
        set_err(err, errlen, std::string("no encoder: ") + codec_name);
        return nullptr;
    }
    auto *e = new CavEncoder();
    e->codec = avcodec_alloc_context3(codec);
    e->codec->sample_rate = sample_rate;
    av_channel_layout_default(&e->codec->ch_layout, channels);
    e->codec->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0]
                                              : AV_SAMPLE_FMT_FLTP;
    e->codec->time_base = {1, sample_rate};
    if (bit_rate > 0) e->codec->bit_rate = bit_rate;
    e->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    int rc = avcodec_open2(e->codec, codec, nullptr);
    if (rc < 0) {
        set_err(err, errlen, "avcodec_open2: " + av_errstr(rc));
        avcodec_free_context(&e->codec);
        delete e;
        return nullptr;
    }
    e->frame = av_frame_alloc();
    e->frame->format = e->codec->sample_fmt;
    e->frame->nb_samples = e->codec->frame_size > 0 ? e->codec->frame_size
                                                    : 1024;
    av_channel_layout_copy(&e->frame->ch_layout, &e->codec->ch_layout);
    e->frame->sample_rate = sample_rate;
    av_frame_get_buffer(e->frame, 0);

    AVChannelLayout in_layout;
    av_channel_layout_default(&in_layout, channels);
    swr_alloc_set_opts2(&e->swr, &e->codec->ch_layout, e->codec->sample_fmt,
                        sample_rate, &in_layout, AV_SAMPLE_FMT_FLT,
                        sample_rate, 0, nullptr);
    swr_init(e->swr);
    av_channel_layout_uninit(&in_layout);
    return e;
}

CAV_EXPORT void cav_encoder_close(CavEncoder *e) {
    if (!e) return;
    if (e->sws) sws_freeContext(e->sws);
    if (e->swr) swr_free(&e->swr);
    if (e->frame) av_frame_free(&e->frame);
    if (e->codec) avcodec_free_context(&e->codec);
    delete e;
}

// Global header bytes (SPS/PPS for H.264; AudioSpecificConfig for AAC) —
// the reference exposes sps/pps/sei on X264VideoEncoder and get_header on
// AACAudioEncoder.
CAV_EXPORT int cav_encoder_extradata(CavEncoder *e, uint8_t *out,
                                     int out_size) {
    if (!e->codec->extradata) return 0;
    int n = e->codec->extradata_size;
    if (out && out_size >= n) memcpy(out, e->codec->extradata, n);
    return n;
}

CAV_EXPORT int cav_encoder_frame_size(CavEncoder *e) {
    return e->codec->frame_size;
}

// Push one RGBA frame (video) — packets retrieved with cav_encoder_packet.
CAV_EXPORT int cav_encoder_send_video(CavEncoder *e, const uint8_t *rgba) {
    av_frame_make_writable(e->frame);
    const uint8_t *src[4] = {rgba, nullptr, nullptr, nullptr};
    int src_stride[4] = {e->codec->width * 4, 0, 0, 0};
    sws_scale(e->sws, src, src_stride, 0, e->codec->height, e->frame->data,
              e->frame->linesize);
    // pts advances only on a SUCCESSFUL send: the Python layer retries
    // on EAGAIN, and incrementing here would skip a pts per retry.
    e->frame->pts = e->next_pts;
    int rc = avcodec_send_frame(e->codec, e->frame);
    if (rc >= 0) e->next_pts++;
    return rc;
}

// Push interleaved float samples (audio). Returns the number of samples
// actually consumed (>= 0) or a negative error. When the codec's output
// queue fills (EAGAIN), the unconsumed tail is NOT encoded — the caller
// must drain packets (cav_encoder_packet) and resend from samples +
// return value; silently dropping the chunk would corrupt the stream.
CAV_EXPORT int cav_encoder_send_audio(CavEncoder *e, const float *samples,
                                      int n_samples) {
    int done = 0;
    while (done < n_samples) {
        int chunk = e->frame->nb_samples;
        if (chunk > n_samples - done) chunk = n_samples - done;
        av_frame_make_writable(e->frame);
        const uint8_t *in[1] = {
            (const uint8_t *)(samples +
                              (size_t)done * e->codec->ch_layout.nb_channels)};
        int conv = swr_convert(e->swr, e->frame->data, chunk, in, chunk);
        if (conv < 0) return conv;
        int saved = e->frame->nb_samples;
        e->frame->nb_samples = conv;
        e->frame->pts = e->next_pts;
        int rc = avcodec_send_frame(e->codec, e->frame);
        e->frame->nb_samples = saved;
        if (rc == AVERROR(EAGAIN)) return done;  // retry tail after drain
        if (rc < 0) return rc;
        e->next_pts += conv;
        done += chunk;
    }
    return done;
}

CAV_EXPORT int cav_encoder_flush(CavEncoder *e) {
    return avcodec_send_frame(e->codec, nullptr);
}

// Pull the next packet: 1 = packet copied (data malloc'd into *out),
// 0 = need more input / flushed dry, <0 = error.
CAV_EXPORT int cav_encoder_packet(CavEncoder *e, CavPacket *out) {
    AVPacket *pkt = av_packet_alloc();
    int rc = avcodec_receive_packet(e->codec, pkt);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) {
        av_packet_free(&pkt);
        return 0;
    }
    if (rc < 0) {
        av_packet_free(&pkt);
        return rc;
    }
    out->data = (uint8_t *)malloc(pkt->size);
    memcpy(out->data, pkt->data, pkt->size);
    out->size = pkt->size;
    out->pts = pkt->pts;
    out->dts = pkt->dts;
    out->duration = pkt->duration;
    out->keyframe = (pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
    out->stream = 0;
    av_packet_unref(pkt);
    av_packet_free(&pkt);
    return 1;
}

// Planar-input video encoder: encode pre-subsampled planar YCbCr (e.g.
// the device DV/MPEG-2 subsample output) without an RGB round trip — the
// reference's X264VideoEncoder/AVVideoEncoder consume coded images the
// same way.
// _ex: sample aspect ratio + interlacing flags, like
// cav_video_encoder_open_ex (reference AVVideoEncoder.c kwargs).
CAV_EXPORT CavEncoder *cav_video_encoder_open_planar_ex(
    const char *codec_name, const char *pix_fmt_name, int width, int height,
    int fps_num, int fps_den, int64_t bit_rate, int sar_num, int sar_den,
    int interlaced, int top_field_first, const char *options,
    char *err, int errlen) {
    const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
    if (!codec) {
        set_err(err, errlen, std::string("no encoder: ") + codec_name);
        return nullptr;
    }
    AVPixelFormat fmt = av_get_pix_fmt(pix_fmt_name);
    if (fmt == AV_PIX_FMT_NONE) {
        set_err(err, errlen, std::string("bad pix_fmt: ") + pix_fmt_name);
        return nullptr;
    }
    auto *e = new CavEncoder();
    e->is_video = 1;
    e->codec = avcodec_alloc_context3(codec);
    e->codec->width = width;
    e->codec->height = height;
    e->codec->time_base = {fps_den, fps_num};
    e->codec->framerate = {fps_num, fps_den};
    e->codec->pix_fmt = fmt;
    if (bit_rate > 0) e->codec->bit_rate = bit_rate;
    if (sar_num > 0 && sar_den > 0)
        e->codec->sample_aspect_ratio = {sar_num, sar_den};
    if (interlaced) {
        e->codec->field_order = top_field_first ? AV_FIELD_TT : AV_FIELD_BB;
        e->codec->flags |=
            AV_CODEC_FLAG_INTERLACED_DCT | AV_CODEC_FLAG_INTERLACED_ME;
    }
    e->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;

    enable_codec_threads(e->codec);
    AVDictionary *opts = nullptr;
    if (options && *options) av_dict_parse_string(&opts, options, "=", ":", 0);
    int rc = avcodec_open2(e->codec, codec, &opts);
    if (rc >= 0) warn_unconsumed_opts(opts, codec_name);
    av_dict_free(&opts);
    if (rc < 0) {
        set_err(err, errlen, "avcodec_open2: " + av_errstr(rc));
        avcodec_free_context(&e->codec);
        delete e;
        return nullptr;
    }
    e->frame = av_frame_alloc();
    e->frame->format = fmt;
    e->frame->width = width;
    e->frame->height = height;
    if (interlaced) {
#if LIBAVUTIL_VERSION_MAJOR >= 58
        e->frame->flags |= AV_FRAME_FLAG_INTERLACED;
        if (top_field_first) e->frame->flags |= AV_FRAME_FLAG_TOP_FIELD_FIRST;
#else
        e->frame->interlaced_frame = 1;
        e->frame->top_field_first = top_field_first ? 1 : 0;
#endif
    }
    av_frame_get_buffer(e->frame, 0);
    return e;
}

CAV_EXPORT CavEncoder *cav_video_encoder_open_planar(
    const char *codec_name, const char *pix_fmt_name, int width, int height,
    int fps_num, int fps_den, int64_t bit_rate, const char *options,
    char *err, int errlen) {
    return cav_video_encoder_open_planar_ex(
        codec_name, pix_fmt_name, width, height, fps_num, fps_den, bit_rate,
        0, 0, 0, 0, options, err, errlen);
}

// Push one planar frame: three contiguous planes with given row strides.
CAV_EXPORT int cav_encoder_send_planar(CavEncoder *e, const uint8_t *y,
                                       int y_stride, int y_rows,
                                       const uint8_t *cb, int cb_stride,
                                       const uint8_t *cr, int cr_stride,
                                       int c_rows) {
    if (y_stride < 0 || cb_stride < 0 || cr_stride < 0) return -1;
    av_frame_make_writable(e->frame);
    const AVPixFmtDescriptor *desc =
        av_pix_fmt_desc_get((AVPixelFormat)e->frame->format);
    int h = e->codec->height;
    int ch = AV_CEIL_RSHIFT(h, desc->log2_chroma_h);
    // Clamp each row copy to BOTH the caller's stride and the frame's
    // plane width: planes wider than the encoder geometry must not
    // write past linesize, and narrower ones must not over-read the
    // caller's buffer (frame sources are untrusted input).
    int yw = e->codec->width;
    int cw = AV_CEIL_RSHIFT(e->codec->width, desc->log2_chroma_w);
    int ny = y_stride < yw ? y_stride : yw;
    int nc = cb_stride < cw ? cb_stride : cw;
    int nr = cr_stride < cw ? cr_stride : cw;
    // Row counts are validated, not clamped: silently encoding short
    // planes would hide a caller geometry bug, and reading past them
    // is the overflow this guard exists to prevent.
    if (y_rows < h || c_rows < ch) return -2;
    for (int r = 0; r < h; r++)
        memcpy(e->frame->data[0] + r * e->frame->linesize[0],
               y + (size_t)r * y_stride, ny);
    for (int r = 0; r < ch; r++) {
        memcpy(e->frame->data[1] + r * e->frame->linesize[1],
               cb + (size_t)r * cb_stride, nc);
        memcpy(e->frame->data[2] + r * e->frame->linesize[2],
               cr + (size_t)r * cr_stride, nr);
    }
    e->frame->pts = e->next_pts;
    int rc = avcodec_send_frame(e->codec, e->frame);
    if (rc >= 0) e->next_pts++;
    return rc;
}
