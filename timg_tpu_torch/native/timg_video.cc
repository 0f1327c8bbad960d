// Video decoding for timg-tpu via libav (role of ref
// src/video-source.cc): demux + frame-threaded decode + pixel-format
// conversion to RGBA/YUV planes at native resolution. Scaling happens
// on the TPU (ops/resize.py), unlike the reference which scales on
// host with sws; sws here only converts formats.
//
// Split from timg_native.cc so the one-shot still library
// (libtimg_still.so) can omit libav: dlopen of the libav dependency
// chain costs ~50 ms, which dominates the interactive latency budget
// (BASELINE.md config #1).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <mutex>
#include <thread>
#include <cstdlib>
#include <dlfcn.h>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

// ---------------------------------------------------------------------------
// Video decode
// ---------------------------------------------------------------------------

namespace {

void dummy_log(void *, int, const char *, va_list) {}

struct VideoHandle {
    AVFormatContext *format = nullptr;
    AVCodecContext *codec = nullptr;
    SwsContext *sws = nullptr;
    SwsContext *sws_scaled = nullptr;  // --resample=sws read path
    AVFrame *frame = nullptr;
    AVPacket *packet = nullptr;
    int stream_index = -1;
    int width = 0, height = 0;
    double fps = 0.0;
    bool draining = false;
};

// YUVJ remap + full-range detection shared by every sws setup
// (behavior of ref video-source.cc:59-89).
AVPixelFormat remap_yuvj(AVPixelFormat pix, int color_range,
                         bool *full_range) {
    *full_range = color_range == AVCOL_RANGE_JPEG;
    switch (pix) {
    case AV_PIX_FMT_YUVJ420P: *full_range = true; return AV_PIX_FMT_YUV420P;
    case AV_PIX_FMT_YUVJ422P: *full_range = true; return AV_PIX_FMT_YUV422P;
    case AV_PIX_FMT_YUVJ444P: *full_range = true; return AV_PIX_FMT_YUV444P;
    case AV_PIX_FMT_YUVJ440P: *full_range = true; return AV_PIX_FMT_YUV440P;
    default: return pix;
    }
}

void apply_full_range(SwsContext *ctx) {
    int *inv_table, *table, in_full, out_full, brightness, contrast, sat;
    if (sws_getColorspaceDetails(ctx, &inv_table, &in_full, &table,
                                 &out_full, &brightness, &contrast,
                                 &sat) != -1 &&
        !in_full) {
        sws_setColorspaceDetails(ctx, inv_table, 1, table, out_full,
                                 brightness, contrast, sat);
    }
}

// Context converting pixel format `fmt_in` at `src_w x src_h` to RGBA
// at the open-time stream size, cached on the handle and rebuilt on
// mid-stream format OR resolution changes (a new SPS can resize the
// stream mid-play; output buffers are sized at open, so changed frames
// are rescaled to the open dims instead of over-reading).  Applies the
// YUVJ -> YUV range fix (behavior of ref video-source.cc:59-89:
// deprecated J formats carry full range) and honors an explicit
// AVCOL_RANGE_JPEG tag on non-J formats.
SwsContext *sws_for_format(VideoHandle *v, int fmt_in, int color_range,
                           int src_w, int src_h) {
    bool full_range;
    AVPixelFormat pix = remap_yuvj((AVPixelFormat)fmt_in, color_range,
                                   &full_range);
    // Returns the existing context unchanged when parameters match.
    v->sws = sws_getCachedContext(v->sws, src_w, src_h, pix,
                                  v->width, v->height, AV_PIX_FMT_RGBA,
                                  SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!v->sws) return nullptr;
    if (full_range) apply_full_range(v->sws);
    return v->sws;
}

bool init_sws(VideoHandle *v) {
    return sws_for_format(v, v->codec->pix_fmt, v->codec->color_range,
                          v->width, v->height) != nullptr;
}

// Shared read/drain state machine (ref video-source.cc:313-365),
// identical for the RGBA and raw-plane read paths.  Returns
// avcodec_receive_frame's status: 0 = decoded frame in v->frame,
// AVERROR_EOF = end of stream, other negative = error.
int decode_next_frame(VideoHandle *v) {
    for (;;) {
        int ret = avcodec_receive_frame(v->codec, v->frame);
        if (ret != AVERROR(EAGAIN)) return ret;  // frame, EOF, or error
        if (v->draining) return AVERROR_EOF;

        // feed more packets
        for (;;) {
            ret = av_read_frame(v->format, v->packet);
            if (ret < 0) {
                v->draining = true;
                avcodec_send_packet(v->codec, nullptr);  // start drain
                break;
            }
            if (v->packet->stream_index == v->stream_index) {
                ret = avcodec_send_packet(v->codec, v->packet);
                av_packet_unref(v->packet);
                if (ret < 0 && ret != AVERROR(EAGAIN)) return ret;
                break;
            }
            av_packet_unref(v->packet);
        }
    }
}

}  // namespace

extern "C" {

// v4l2 / device capture: the reference enables it by calling
// avdevice_register_all() when built with HAVE_AVDEVICE (ref
// video-source.cc:100-102, src/CMakeLists.txt:102).  Here the gate is
// at runtime: dlopen libavdevice if present (registers the v4l2
// demuxer so `timg-tpu /dev/video0` opens like any input), silently
// absent otherwise -- the same graceful degradation as a build
// without the define.  Returns 1 when device capture is available.
static int probe_avdevice() {
    const char *names[] = {"libavdevice.so.61", "libavdevice.so.60",
                           "libavdevice.so.59", "libavdevice.so.58",
                           "libavdevice.so"};
    for (const char *name : names) {
        void *lib = dlopen(name, RTLD_NOW | RTLD_GLOBAL);
        if (!lib) continue;
        void (*reg)() = (void (*)())dlsym(lib, "avdevice_register_all");
        if (reg) {
            reg();
            return 1;
        }
        break;
    }
    return 0;
}

static int register_avdevice() {
    // Magic static: thread-safe one-time probe (the CLI's loader pool
    // opens several videos concurrently through ctypes without the GIL).
    static const int available = probe_avdevice();
    return available;
}

int timg_video_device_capture_available() { return register_avdevice(); }

void *timg_video_open(const char *filename) {
    // One-time global libav init, safe under concurrent opens from the
    // CLI's loader pool (a plain static bool was a data race).
    static std::once_flag init_once;
    std::call_once(init_once, [] {
        register_avdevice();
        avformat_network_init();
        av_log_set_callback(dummy_log);
    });
    VideoHandle *v = new VideoHandle();
    if (avformat_open_input(&v->format, filename, nullptr, nullptr) != 0) {
        delete v;
        return nullptr;
    }
    if (avformat_find_stream_info(v->format, nullptr) < 0) goto fail;

    {
        const AVCodec *decoder = nullptr;
        for (unsigned i = 0; i < v->format->nb_streams; ++i) {
            AVCodecParameters *par = v->format->streams[i]->codecpar;
            const AVCodec *c = avcodec_find_decoder(par->codec_id);
            if (c && par->codec_type == AVMEDIA_TYPE_VIDEO) {
                v->stream_index = (int)i;
                decoder = c;
                break;
            }
        }
        if (!decoder || v->stream_index < 0) goto fail;

        AVStream *stream = v->format->streams[v->stream_index];
        AVRational rate = av_guess_frame_rate(v->format, stream, nullptr);
        v->fps = rate.den ? (double)rate.num / rate.den : 25.0;

        v->codec = avcodec_alloc_context3(decoder);
        // Frame-threaded decode, <=4 threads (ref video-source.cc:194-199).
        if (decoder->capabilities & AV_CODEC_CAP_FRAME_THREADS &&
            std::thread::hardware_concurrency() > 1) {
            v->codec->thread_type = FF_THREAD_FRAME;
            v->codec->thread_count =
                std::min(4u, std::thread::hardware_concurrency());
        }
        if (avcodec_parameters_to_context(v->codec, stream->codecpar) < 0)
            goto fail;
        if (avcodec_open2(v->codec, decoder, nullptr) < 0 ||
            v->codec->width <= 0 || v->codec->height <= 0)
            goto fail;
        v->width = v->codec->width;
        v->height = v->codec->height;
        if (!init_sws(v)) goto fail;
        v->frame = av_frame_alloc();
        v->packet = av_packet_alloc();
    }
    return v;

fail:
    if (v->codec) avcodec_free_context(&v->codec);
    if (v->format) avformat_close_input(&v->format);
    delete v;
    return nullptr;
}

void timg_video_info(void *handle, int *width, int *height, double *fps) {
    VideoHandle *v = (VideoHandle *)handle;
    *width = v->width;
    *height = v->height;
    *fps = v->fps;
}

// Returns 1 on frame decoded into rgba_out (width*height*4 bytes),
// 0 on end of stream, -1 on error. Read/drain state machine
// (behavior of ref video-source.cc:313-365).
int timg_video_read_frame(void *handle, uint8_t *rgba_out) {
    VideoHandle *v = (VideoHandle *)handle;
    int ret = decode_next_frame(v);
    if (ret == AVERROR_EOF) return 0;
    if (ret < 0) return -1;
    // Keyed on the actual frame format AND dimensions: a mid-stream
    // pixel-format or resolution change (new SPS) must not feed the
    // old context or read past the decoded frame's buffers.
    SwsContext *sws =
        sws_for_format(v, v->frame->format, v->frame->color_range,
                       v->frame->width, v->frame->height);
    if (!sws) {
        av_frame_unref(v->frame);
        return -1;
    }
    uint8_t *dst[1] = {rgba_out};
    int dst_stride[1] = {v->width * 4};
    sws_scale(sws, v->frame->data, v->frame->linesize, 0, v->frame->height,
              dst, dst_stride);
    av_frame_unref(v->frame);
    return 1;
}

// Pixel-format info for the raw-plane fast path.  Bit 0: the decoded
// stream is 8-bit 4:2:0 planar (YUV420P / YUVJ420P) so frames can ship
// as raw planes (1.5 B/px over the host->device link instead of 4 B/px
// RGBA, with color conversion done device-side).  Bit 1: full-range
// ("J" format, or limited format tagged AVCOL_RANGE_JPEG; note y4m's
// C420jpeg/C420mpeg2 tags denote chroma *siting*, not range -- this
// libav leaves y4m range unspecified, so bit 1 stays 0 there).
// The reference always converts on host via swscale (ref
// video-source.cc:352-354); the raw-plane path is the TPU-native
// replacement for that conversion.
int timg_video_pix_info(void *handle) {
    VideoHandle *v = (VideoHandle *)handle;
    AVPixelFormat pix = v->codec->pix_fmt;
    int info = 0;
    if (pix == AV_PIX_FMT_YUV420P || pix == AV_PIX_FMT_YUVJ420P) info |= 1;
    AVColorRange range = v->codec->color_range;
    if (range == AVCOL_RANGE_UNSPECIFIED)
        // some demuxers (e.g. y4m C420jpeg) only tag the stream params
        range = v->format->streams[v->stream_index]->codecpar->color_range;
    if (pix == AV_PIX_FMT_YUVJ420P || range == AVCOL_RANGE_JPEG) info |= 2;
    return info;
}

// Raw-plane read: like timg_video_read_frame but hands the decoded
// 4:2:0 planes directly (y: h*w, u/v: ceil(h/2)*ceil(w/2) bytes, pitch
// removed).  Returns 1 = YUV planes written; 2 = the frame was not
// 4:2:0 after all (mid-stream format change) and was sws-converted to
// RGBA into rgba_fallback instead; 0 = end of stream; -1 = error.
int timg_video_read_frame_yuv(void *handle, uint8_t *y_out, uint8_t *u_out,
                              uint8_t *v_out, uint8_t *rgba_fallback) {
    VideoHandle *v = (VideoHandle *)handle;
    int ret = decode_next_frame(v);
    if (ret == AVERROR_EOF) return 0;
    if (ret < 0) return -1;
    const int fmt = v->frame->format;
    if ((fmt == AV_PIX_FMT_YUV420P || fmt == AV_PIX_FMT_YUVJ420P) &&
        v->frame->width == v->width && v->frame->height == v->height) {
        const int w = v->width, h = v->height;
        const int cw = (w + 1) / 2, ch = (h + 1) / 2;
        for (int r = 0; r < h; ++r)
            memcpy(y_out + (size_t)r * w,
                   v->frame->data[0] + (size_t)r * v->frame->linesize[0],
                   w);
        for (int r = 0; r < ch; ++r) {
            memcpy(u_out + (size_t)r * cw,
                   v->frame->data[1] + (size_t)r * v->frame->linesize[1],
                   cw);
            memcpy(v_out + (size_t)r * cw,
                   v->frame->data[2] + (size_t)r * v->frame->linesize[2],
                   cw);
        }
        av_frame_unref(v->frame);
        return 1;
    }
    // Mid-stream change: the stream opened as 4:2:0 but this frame is
    // a different format OR a different resolution (new SPS) -- the
    // raw copy above would read past the decoded buffers.  Convert and
    // rescale via the shared helper, keyed on the actual frame format
    // and dims incl. the J/range handling.
    SwsContext *sws = sws_for_format(v, fmt, v->frame->color_range,
                                     v->frame->width, v->frame->height);
    if (!sws) {
        av_frame_unref(v->frame);
        return -1;
    }
    uint8_t *dst[1] = {rgba_fallback};
    int dst_stride[1] = {v->width * 4};
    sws_scale(sws, v->frame->data, v->frame->linesize, 0, v->frame->height,
              dst, dst_stride);
    av_frame_unref(v->frame);
    return 2;
}

// --resample=sws read path: decode + swscale SWS_BILINEAR straight to
// the display size in ONE sws_scale call -- colorspace conversion and
// resize together, exactly the reference's video pipeline
// (ref video-source.cc:59-89 CreateSWSContext sized to display dims +
// :352-354 per-frame sws_scale).  Output bytes match a full reference
// build linked against the same libswscale by construction.
// Returns 1 on frame written (out_w*out_h*4), 0 on EOF, -1 on error.
int timg_video_read_frame_scaled(void *handle, uint8_t *rgba_out,
                                 int out_w, int out_h) {
    VideoHandle *v = (VideoHandle *)handle;
    if (out_w <= 0 || out_h <= 0) return -1;
    int ret = decode_next_frame(v);
    if (ret == AVERROR_EOF) return 0;
    if (ret < 0) return -1;
    bool full_range;
    AVPixelFormat pix =
        remap_yuvj((AVPixelFormat)v->frame->format, v->frame->color_range,
                   &full_range);
    v->sws_scaled = sws_getCachedContext(
        v->sws_scaled, v->frame->width, v->frame->height, pix, out_w,
        out_h, AV_PIX_FMT_RGBA, SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!v->sws_scaled) {
        av_frame_unref(v->frame);
        return -1;
    }
    if (full_range) apply_full_range(v->sws_scaled);
    uint8_t *dst[1] = {rgba_out};
    int dst_stride[1] = {out_w * 4};
    sws_scale(v->sws_scaled, v->frame->data, v->frame->linesize, 0,
              v->frame->height, dst, dst_stride);
    av_frame_unref(v->frame);
    return 1;
}

// Standalone sws-bilinear scalers (test oracles + the SWS ImageScaler
// role, ref image-scaler.cc:45-73).  ``bitexact`` adds SWS_BITEXACT:
// the platform-independent C algorithm a device reimplementation can
// target (the reference does NOT set it, so its exact output bytes are
// CPU-dispatch-dependent -- parity with any given build comes from
// calling the same library, above).
static int sws_scale_once(AVPixelFormat src_fmt, int full_range,
                          const uint8_t *const src_data[4],
                          const int src_stride[4], int in_w, int in_h,
                          int out_w, int out_h, int bitexact,
                          uint8_t *rgba_out) {
    if (in_w <= 0 || in_h <= 0 || out_w <= 0 || out_h <= 0) return -1;
    const int flags = SWS_BILINEAR | (bitexact ? SWS_BITEXACT : 0);
    SwsContext *ctx =
        sws_getContext(in_w, in_h, src_fmt, out_w, out_h,
                       AV_PIX_FMT_RGBA, flags, nullptr, nullptr, nullptr);
    if (!ctx) return -1;
    if (full_range) apply_full_range(ctx);
    uint8_t *dst[1] = {rgba_out};
    int dst_stride[1] = {out_w * 4};
    sws_scale(ctx, src_data, src_stride, 0, in_h, dst, dst_stride);
    sws_freeContext(ctx);
    return 0;
}

int timg_sws_scale_rgba(const uint8_t *rgba_in, int in_w, int in_h,
                        int out_w, int out_h, int bitexact,
                        uint8_t *rgba_out) {
    const uint8_t *src[4] = {rgba_in, nullptr, nullptr, nullptr};
    const int stride[4] = {in_w * 4, 0, 0, 0};
    return sws_scale_once(AV_PIX_FMT_RGBA, 0, src, stride, in_w, in_h,
                          out_w, out_h, bitexact, rgba_out);
}

int timg_sws_scale_yuv420(const uint8_t *y, const uint8_t *u,
                          const uint8_t *v, int in_w, int in_h,
                          int full_range, int out_w, int out_h,
                          int bitexact, uint8_t *rgba_out) {
    const uint8_t *src[4] = {y, u, v, nullptr};
    const int cw = (in_w + 1) / 2;
    const int stride[4] = {in_w, cw, cw, 0};
    return sws_scale_once(AV_PIX_FMT_YUV420P, full_range, src, stride,
                          in_w, in_h, out_w, out_h, bitexact, rgba_out);
}

// Rewind for looping (ref video-source.cc:302-307).
int timg_video_rewind(void *handle) {
    VideoHandle *v = (VideoHandle *)handle;
    if (av_seek_frame(v->format, v->stream_index, 0,
                      AVSEEK_FLAG_BACKWARD) < 0)
        return 0;
    avcodec_flush_buffers(v->codec);
    v->draining = false;
    return 1;
}

void timg_video_close(void *handle) {
    VideoHandle *v = (VideoHandle *)handle;
    if (v->packet) av_packet_free(&v->packet);
    if (v->frame) av_frame_free(&v->frame);
    if (v->sws) sws_freeContext(v->sws);
    if (v->sws_scaled) sws_freeContext(v->sws_scaled);
    if (v->codec) avcodec_free_context(&v->codec);
    if (v->format) avformat_close_input(&v->format);
    delete v;
}

const char *timg_video_version() {
    static char buf[64];
    snprintf(buf, sizeof(buf), "libavformat %d.%d.%d",
             LIBAVFORMAT_VERSION_MAJOR, LIBAVFORMAT_VERSION_MINOR,
             LIBAVFORMAT_VERSION_MICRO);
    return buf;
}

}  // extern "C"
