// Native video decode loader: libavformat demux -> libavcodec decode ->
// libswscale RGB24, exposed through a C ABI for ctypes (no pybind11 in
// the image). This is the framework's own data-loader — the reference
// rides the native decoders inside mmcv/cv2 (SURVEY.md §2 component 3,
// L3 layer); here the loop itself is ours, which buys one structural
// win cv2's read() cannot offer: grab/retrieve separation at the C
// level, so frames a sampler skips are decoded but never color-converted
// (uni_12 over a 120-frame clip converts 12 frames, not 120).
//
// Sequential-exact by construction (frame counter increments per decoded
// frame, like cv2's sequential read). Random access stays with the
// Python cv2 seek path — pts->index mapping is container-dependent and
// the sparse case is rare (io/video.py's 1-in-16 crossover).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 decoder.cpp
//        -lavformat -lavcodec -lswscale -lavutil  (see native/__init__.py)

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/display.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstring>

namespace {

struct VfDec {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* dec = nullptr;
    SwsContext* sws = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    AVFrame* rgb = nullptr;    // swscale destination, aligned and padded
    int stream = -1;
    int w = 0, h = 0;
    double fps = 0.0;
    int64_t nframes = 0;   // container estimate; 0 when unknown
    int64_t index = -1;    // index of the frame currently held
    bool draining = false;
    bool have_frame = false;
};

void vf_free(VfDec* d) {
    if (!d) return;
    if (d->sws) sws_freeContext(d->sws);
    if (d->frame) av_frame_free(&d->frame);
    if (d->rgb) av_frame_free(&d->rgb);
    if (d->pkt) av_packet_free(&d->pkt);
    if (d->dec) avcodec_free_context(&d->dec);
    if (d->fmt) avformat_close_input(&d->fmt);
    delete d;
}

// Pull the next decoded frame into d->frame. Returns 1 on success, 0 at
// end of stream, <0 on error.
int vf_next_frame(VfDec* d) {
    while (true) {
        int r = avcodec_receive_frame(d->dec, d->frame);
        if (r == 0) return 1;
        if (r == AVERROR_EOF) return 0;
        if (r != AVERROR(EAGAIN)) return r;
        if (d->draining) return 0;
        while (true) {
            r = av_read_frame(d->fmt, d->pkt);
            if (r == AVERROR_EOF) {
                d->draining = true;
                avcodec_send_packet(d->dec, nullptr);  // flush
                break;
            }
            if (r < 0) return r;
            const bool ours = d->pkt->stream_index == d->stream;
            if (ours) r = avcodec_send_packet(d->dec, d->pkt);
            av_packet_unref(d->pkt);
            if (ours) {
                if (r < 0 && r != AVERROR(EAGAIN)) return r;
                break;
            }
        }
    }
}

}  // namespace

extern "C" {

void* vfdec_open(const char* path) {
    auto* d = new VfDec();
    if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
        vf_free(d);
        return nullptr;
    }
    if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
        vf_free(d);
        return nullptr;
    }
    const AVCodec* codec = nullptr;
    d->stream =
        av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
    if (d->stream < 0 || !codec) {
        vf_free(d);
        return nullptr;
    }
    AVStream* st = d->fmt->streams[d->stream];
    d->dec = avcodec_alloc_context3(codec);
    if (!d->dec || avcodec_parameters_to_context(d->dec, st->codecpar) < 0 ||
        avcodec_open2(d->dec, codec, nullptr) < 0) {
        vf_free(d);
        return nullptr;
    }
    d->pkt = av_packet_alloc();
    d->frame = av_frame_alloc();
    d->w = d->dec->width;
    d->h = d->dec->height;
    AVRational r = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
    d->fps = r.den ? static_cast<double>(r.num) / r.den : 0.0;
    d->nframes = st->nb_frames;
    if (d->nframes == 0 && d->fps > 0.0) {
        // containers without per-stream counts (MKV/WebM): estimate from
        // duration x fps, the same arithmetic cv2's CAP_PROP_FRAME_COUNT
        // uses for them
        if (st->duration > 0) {
            d->nframes = llround(st->duration * av_q2d(st->time_base) * d->fps);
        } else if (d->fmt->duration > 0) {
            d->nframes = llround(
                d->fmt->duration / static_cast<double>(AV_TIME_BASE) * d->fps);
        }
    }
    // Rotated streams (display-matrix side data): cv2 auto-rotates them,
    // this loader does not — refuse to open so the 'auto' backend falls
    // back to cv2 instead of silently decoding a different orientation.
    if (const uint8_t* sd = av_stream_get_side_data(
            st, AV_PKT_DATA_DISPLAYMATRIX, nullptr)) {
        const double theta =
            av_display_rotation_get(reinterpret_cast<const int32_t*>(sd));
        if (theta == theta && theta != 0.0) {  // non-NaN, non-zero
            vf_free(d);
            return nullptr;
        }
    }
    if (!d->pkt || !d->frame || d->w <= 0 || d->h <= 0) {
        vf_free(d);
        return nullptr;
    }
    return d;
}

void vfdec_probe(void* h, int* w, int* ht, double* fps, int64_t* nframes) {
    auto* d = static_cast<VfDec*>(h);
    *w = d->w;
    *ht = d->h;
    *fps = d->fps;
    *nframes = d->nframes;
}

// Advance to the next frame WITHOUT color conversion.
// Returns the new frame index, or -1 at end of stream / error.
int64_t vfdec_grab(void* h) {
    auto* d = static_cast<VfDec*>(h);
    int r = vf_next_frame(d);
    if (r != 1) {
        d->have_frame = false;
        return -1;
    }
    d->have_frame = true;
    return ++d->index;
}

// Convert the currently-held frame to packed RGB24 into out (h*w*3).
// swscale writes into the decoder's own aligned, padded RGB frame (its
// SIMD paths store whole vectors past the last pixel of a row, and take
// a different path for the tail columns of an unaligned destination);
// the h rows of 3*w bytes are then copied out.
// Returns 0 on success, -1 if no frame is held or conversion fails.
int vfdec_retrieve(void* h, uint8_t* out) {
    auto* d = static_cast<VfDec*>(h);
    if (!d->have_frame) return -1;
    d->sws = sws_getCachedContext(
        d->sws, d->frame->width, d->frame->height,
        static_cast<AVPixelFormat>(d->frame->format), d->w, d->h,
        AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!d->sws) return -1;
    if (!d->rgb) {
        d->rgb = av_frame_alloc();
        if (!d->rgb) return -1;
        d->rgb->format = AV_PIX_FMT_RGB24;
        d->rgb->width = d->w;
        d->rgb->height = d->h;
        if (av_frame_get_buffer(d->rgb, 64) < 0) {
            av_frame_free(&d->rgb);
            return -1;
        }
    }
    const int rows = sws_scale(d->sws, d->frame->data, d->frame->linesize, 0,
                               d->frame->height, d->rgb->data,
                               d->rgb->linesize);
    if (rows != d->h) return -1;
    const size_t row_bytes = static_cast<size_t>(3) * d->w;
    for (int y = 0; y < d->h; ++y)
        std::memcpy(out + y * row_bytes,
                    d->rgb->data[0] + static_cast<size_t>(y) * d->rgb->linesize[0],
                    row_bytes);
    return 0;
}

void vfdec_close(void* h) { vf_free(static_cast<VfDec*>(h)); }

}  // extern "C"
