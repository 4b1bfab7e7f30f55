// First-party video decode core: libavformat/libavcodec/libswscale -> RGB24.
//
// The second decode backend the reference gets from torchvision's
// read_video (reference dataloader.py:41-43, itself an ffmpeg wrapper) —
// here a direct first-party integration of the same codec libraries, which
// decodes every container/codec ffmpeg knows (the real dataset's H.264 as
// well as the mp4v clips the e2e tests write). OpenCV's videoio FFMPEG
// path and this shim share libavcodec underneath, exactly like the
// reference's two backends, so decode parity is byte-exact on I/P content
// (tests/test_torch_native.py::test_ffmpeg_backend_matches_opencv).
//
// Build: picklebot_tpu_torch/data/native.py through utils/build.py (g++
// -shared, linked against the system libav*, into picklebot_tpu_torch/
// _build/); reported unavailable when the libs aren't installed.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

struct DecodeCtx {
    AVFormatContext *fmt = nullptr;
    AVCodecContext *dec = nullptr;
    SwsContext *sws = nullptr;
    AVFrame *frame = nullptr;
    AVFrame *rgb = nullptr;
    AVPacket *pkt = nullptr;

    ~DecodeCtx() {
        if (pkt) av_packet_free(&pkt);
        if (rgb) av_frame_free(&rgb);
        if (frame) av_frame_free(&frame);
        if (sws) sws_freeContext(sws);
        if (dec) avcodec_free_context(&dec);
        if (fmt) avformat_close_input(&fmt);
    }
};

}  // namespace

extern "C" {

// Decode up to max_frames (<=0: all) KEPT video frames of `path` into one
// malloc'd (t, h, w, 3) uint8 RGB24 buffer. Returns 0 on success and fills
// out/t/h/w; negative av error or -1000-series shim error otherwise.
//
// sample_fps > 0 enables frame-rate sampling (config.sample_fps): only
// every round(container_fps / sample_fps)-th decoded frame is converted
// and kept — dropped frames skip the sws_scale color convert and the copy
// (the codec still decodes them; inter-frame codecs can't seek cheaply).
// Unknown container rate -> keep everything (never guess a rate).
int pb_decode_video_fps(const char *path, int64_t max_frames,
                        double sample_fps, uint8_t **out,
                        int64_t *t, int64_t *h, int64_t *w) {
    DecodeCtx c;
    int ret = avformat_open_input(&c.fmt, path, nullptr, nullptr);
    if (ret < 0) return ret;
    ret = avformat_find_stream_info(c.fmt, nullptr);
    if (ret < 0) return ret;

    const AVCodec *codec = nullptr;
    int stream = av_find_best_stream(c.fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                     &codec, 0);
    if (stream < 0 || codec == nullptr) return -1001;

    c.dec = avcodec_alloc_context3(codec);
    if (!c.dec) return -1002;
    ret = avcodec_parameters_to_context(c.dec, c.fmt->streams[stream]->codecpar);
    if (ret < 0) return ret;
    c.dec->thread_count = 0;  // auto frame/slice threading (0 = ncpu)
    ret = avcodec_open2(c.dec, codec, nullptr);
    if (ret < 0) return ret;

    c.frame = av_frame_alloc();
    c.rgb = av_frame_alloc();
    c.pkt = av_packet_alloc();
    if (!c.frame || !c.rgb || !c.pkt) return -1003;

    int64_t stride = 1;
    if (sample_fps > 0) {
        AVRational r = c.fmt->streams[stream]->avg_frame_rate;
        if (r.num <= 0 || r.den <= 0) r = c.fmt->streams[stream]->r_frame_rate;
        double fps = (r.num > 0 && r.den > 0) ? (double)r.num / r.den : 0.0;
        if (fps > 0) {
            stride = (int64_t)(fps / sample_fps + 0.5);
            if (stride < 1) stride = 1;
        }
    }

    std::vector<uint8_t> frames;
    int64_t width = 0, height = 0, count = 0, decoded = 0;
    bool flushing = false;
    bool pending = false;  // a read packet the decoder hasn't accepted yet

    while (true) {
        if (!flushing) {
            if (!pending) {
                ret = av_read_frame(c.fmt, c.pkt);
                if (ret == AVERROR_EOF) {
                    flushing = true;
                    avcodec_send_packet(c.dec, nullptr);  // drain
                } else if (ret < 0) {
                    return ret;
                } else if (c.pkt->stream_index != stream) {
                    av_packet_unref(c.pkt);
                    continue;
                } else {
                    pending = true;
                }
            }
            if (pending) {
                ret = avcodec_send_packet(c.dec, c.pkt);
                if (ret == AVERROR(EAGAIN)) {
                    // decoder output queue full (FFmpeg contract): keep
                    // the packet, drain receive_frame below, re-send this
                    // same packet next iteration — dropping it here would
                    // silently lose frames on buffering decoders
                } else {
                    av_packet_unref(c.pkt);
                    pending = false;
                    if (ret < 0) return ret;
                }
            }
        }
        while (true) {
            ret = avcodec_receive_frame(c.dec, c.frame);
            if (ret == AVERROR(EAGAIN)) break;
            if (ret == AVERROR_EOF) goto done;
            if (ret < 0) return ret;

            if (width == 0) {
                width = c.frame->width;
                height = c.frame->height;
            } else if (c.frame->width != width ||
                       c.frame->height != height) {
                av_frame_unref(c.frame);
                return -1004;  // mid-stream resolution change unsupported
            }
            if (decoded++ % stride != 0) {
                av_frame_unref(c.frame);
                continue;
            }
            c.sws = sws_getCachedContext(
                c.sws, width, height, (AVPixelFormat)c.frame->format,
                width, height, AV_PIX_FMT_RGB24, SWS_BILINEAR,
                nullptr, nullptr, nullptr);
            if (!c.sws) return -1005;

            size_t off = frames.size();
            frames.resize(off + (size_t)height * width * 3);
            uint8_t *dst[1] = {frames.data() + off};
            int dst_stride[1] = {(int)(width * 3)};
            sws_scale(c.sws, c.frame->data, c.frame->linesize, 0, height,
                      dst, dst_stride);
            av_frame_unref(c.frame);
            ++count;
            if (max_frames > 0 && count >= max_frames) goto done;
        }
        if (flushing) break;
    }

done:
    if (count == 0) return -1006;
    uint8_t *buf = (uint8_t *)std::malloc(frames.size());
    if (!buf) return -1007;
    std::memcpy(buf, frames.data(), frames.size());
    *out = buf;
    *t = count;
    *h = height;
    *w = width;
    return 0;
}

int pb_decode_video(const char *path, int64_t max_frames, uint8_t **out,
                    int64_t *t, int64_t *h, int64_t *w) {
    return pb_decode_video_fps(path, max_frames, 0.0, out, t, h, w);
}

void pb_video_free(uint8_t *p) { std::free(p); }

}  // extern "C"
