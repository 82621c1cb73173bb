// Native video I/O shim (libavformat/libavcodec/libswscale).
//
// The PyTorch port's copy of the JAX package's shim: an in-process
// decoder/encoder delivering RGB24 frames straight into caller-owned
// buffers (NumPy arrays via ctypes), with no subprocess, no pipe copies,
// and no per-frame Python work.  A background decode thread keeps a small
// ring of frames ready so host decode overlaps device compute.
//
// C ABI (consumed by pgtformer_tpu_torch/io/native.py through ctypes):
//   reader:  vr_open / vr_info / vr_read / vr_close
//   writer:  vw_open / vw_open2 / vw_write / vw_write_yuv420 / vw_close
//
// Build: io/native.py runs g++ with pkg-config's flags at first use, into
// build/native/libvideoio.so at the root of the checkout.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

namespace {

struct Reader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  int stream_index = -1;
  int width = 0, height = 0;
  double fps = 0.0;
  int64_t nframes = 0;

  // background decode ring
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<std::vector<uint8_t>> ring;
  size_t ring_cap = 8;
  bool eof = false;
  std::atomic<bool> stop{false};

  ~Reader() {
    stop = true;
    cv_put.notify_all();
    cv_get.notify_all();
    if (worker.joinable()) worker.join();
    if (sws) sws_freeContext(sws);
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
  }

  bool decode_loop() {
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    uint8_t* dst_data[4];
    int dst_linesize[4];
    std::vector<uint8_t> rgb((size_t)width * height * 3);

    auto push_frame = [&](AVFrame* f) {
      dst_data[0] = rgb.data();
      dst_linesize[0] = width * 3;
      sws_scale(sws, f->data, f->linesize, 0, height, dst_data, dst_linesize);
      std::unique_lock<std::mutex> lk(mu);
      cv_put.wait(lk, [&] { return ring.size() < ring_cap || stop; });
      if (stop) return false;
      ring.emplace_back(rgb);
      cv_get.notify_one();
      return true;
    };

    bool ok = true;
    while (ok && !stop && av_read_frame(fmt, pkt) >= 0) {
      if (pkt->stream_index == stream_index) {
        if (avcodec_send_packet(codec, pkt) >= 0) {
          while (ok && avcodec_receive_frame(codec, frame) >= 0) {
            ok = push_frame(frame);
          }
        }
      }
      av_packet_unref(pkt);
    }
    // flush
    if (ok && !stop) {
      avcodec_send_packet(codec, nullptr);
      while (ok && avcodec_receive_frame(codec, frame) >= 0) {
        ok = push_frame(frame);
      }
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      eof = true;
      cv_get.notify_all();
    }
    av_frame_free(&frame);
    av_packet_free(&pkt);
    return ok;
  }
};

struct Writer {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  AVStream* stream = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  int width = 0, height = 0;
  int64_t pts = 0;
};

}  // namespace

extern "C" {

void* vr_open(const char* path) {
  auto* r = new Reader();
  if (avformat_open_input(&r->fmt, path, nullptr, nullptr) < 0) {
    delete r;
    return nullptr;
  }
  if (avformat_find_stream_info(r->fmt, nullptr) < 0) {
    delete r;
    return nullptr;
  }
  const AVCodec* dec = nullptr;
  r->stream_index =
      av_find_best_stream(r->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (r->stream_index < 0) {
    delete r;
    return nullptr;
  }
  AVStream* st = r->fmt->streams[r->stream_index];
  r->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(r->codec, st->codecpar);
  if (avcodec_open2(r->codec, dec, nullptr) < 0) {
    delete r;
    return nullptr;
  }
  r->width = r->codec->width;
  r->height = r->codec->height;
  AVRational fr = st->avg_frame_rate;
  r->fps = fr.den ? (double)fr.num / fr.den : 25.0;
  r->nframes = st->nb_frames;
  r->sws = sws_getContext(r->width, r->height, r->codec->pix_fmt, r->width,
                          r->height, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                          nullptr, nullptr);
  r->worker = std::thread([r] { r->decode_loop(); });
  return r;
}

int vr_info(void* h, int* w, int* ht, double* fps, int64_t* nframes) {
  auto* r = static_cast<Reader*>(h);
  *w = r->width;
  *ht = r->height;
  *fps = r->fps;
  *nframes = r->nframes;
  return 0;
}

// Copies the next RGB24 frame into `out` (w*h*3 bytes). 1 = frame, 0 = EOF.
int vr_read(void* h, uint8_t* out) {
  auto* r = static_cast<Reader*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_get.wait(lk, [&] { return !r->ring.empty() || r->eof || r->stop; });
  if (r->ring.empty()) return 0;
  std::memcpy(out, r->ring.front().data(), r->ring.front().size());
  r->ring.pop_front();
  r->cv_put.notify_one();
  return 1;
}

void vr_close(void* h) { delete static_cast<Reader*>(h); }

void* vw_open2(const char* path, int w, int h, double fps,
               const char* codec_name);

// Legacy entry: codec auto-pick.
void* vw_open(const char* path, int w, int h, double fps) {
  return vw_open2(path, w, h, fps, "auto");
}

// codec_name: "libx265" (reference parity: -c:v libx265 -crf 18 -tag:v hvc1,
// inference.py:30-35), "libx264", "mpeg4", or "auto" (= x265 -> x264 -> mpeg4).
// An optional ":preset=<name>" suffix (e.g. "libx265:preset=superfast")
// overrides the encoder speed preset (default "fast").
// An optional ":params=k=v,k=v" suffix (must come last) passes extra
// encoder private options: for libx265 they are appended to x265-params
// (commas become the ':' separators x265 expects, e.g.
// "libx265:preset=superfast:params=pools=1,frame-threads=2"); for other
// encoders each k=v is set via av_opt_set on priv_data.
// An explicitly requested codec that is unavailable FAILS (nullptr) instead
// of silently substituting another encoder.
void* vw_open2(const char* path, int w, int h, double fps,
               const char* codec_name) {
  auto* wr = new Writer();
  wr->width = w;
  wr->height = h;
  avformat_alloc_output_context2(&wr->fmt, nullptr, nullptr, path);
  if (!wr->fmt) {
    delete wr;
    return nullptr;
  }
  std::string name = codec_name ? codec_name : "auto";
  std::string preset = "fast";
  std::string extra;  // comma-separated k=v list from ":params="
  const auto pcolon = name.find(":params=");
  if (pcolon != std::string::npos) {
    extra = name.substr(pcolon + 8);
    name = name.substr(0, pcolon);
  }
  const auto colon = name.find(":preset=");
  if (colon != std::string::npos) {
    preset = name.substr(colon + 8);
    name = name.substr(0, colon);
  }
  const AVCodec* enc = nullptr;
  const bool autopick = name.empty() || name == "auto";
  if (autopick) {
    enc = avcodec_find_encoder_by_name("libx265");
    if (!enc) enc = avcodec_find_encoder_by_name("libx264");
    if (!enc) enc = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  } else {
    enc = name == "mpeg4" ? avcodec_find_encoder(AV_CODEC_ID_MPEG4)
                          : avcodec_find_encoder_by_name(name.c_str());
  }
  if (!enc) {
    delete wr;
    return nullptr;
  }
  wr->stream = avformat_new_stream(wr->fmt, enc);
  wr->codec = avcodec_alloc_context3(enc);
  wr->codec->width = w;
  wr->codec->height = h;
  wr->codec->pix_fmt = AV_PIX_FMT_YUV420P;
  wr->codec->time_base = av_d2q(1.0 / fps, 100000);
  wr->stream->time_base = wr->codec->time_base;
  wr->codec->gop_size = 12;
  if (enc->id == AV_CODEC_ID_H264) {
    av_opt_set(wr->codec->priv_data, "crf", "18", 0);
    av_opt_set(wr->codec->priv_data, "preset", preset.c_str(), 0);
    // no B-frames: streaming-friendly and avoids the mp4 edit-list
    // last-frame drop some demuxers exhibit with reordered streams
    wr->codec->max_b_frames = 0;
  } else if (enc->id == AV_CODEC_ID_HEVC) {
    av_opt_set(wr->codec->priv_data, "crf", "18", 0);
    av_opt_set(wr->codec->priv_data, "preset", preset.c_str(), 0);
    std::string x265p = "log-level=error:bframes=0";
    if (!extra.empty()) {
      // x265-params separates options with ':'; the codec string uses
      // ',' so it can nest inside our ':'-delimited suffix syntax
      std::string conv = extra;
      for (auto& c : conv)
        if (c == ',') c = ':';
      x265p += ":" + conv;
    }
    av_opt_set(wr->codec->priv_data, "x265-params", x265p.c_str(), 0);
    wr->codec->max_b_frames = 0;
  } else {
    wr->codec->bit_rate = (int64_t)w * h * 8;  // generous for mpeg4
  }
  if (enc->id != AV_CODEC_ID_HEVC && !extra.empty()) {
    // apply each k=v from ":params=" to the encoder's private options
    // (best-effort: unknown keys are ignored rather than failing open)
    size_t start = 0;
    while (start < extra.size()) {
      size_t end = extra.find(',', start);
      if (end == std::string::npos) end = extra.size();
      std::string kv = extra.substr(start, end - start);
      const auto eq = kv.find('=');
      if (eq != std::string::npos)
        av_opt_set(wr->codec->priv_data, kv.substr(0, eq).c_str(),
                   kv.substr(eq + 1).c_str(), 0);
      start = end + 1;
    }
  }
  if (wr->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    wr->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(wr->codec, enc, nullptr) < 0) {
    delete wr;
    return nullptr;
  }
  avcodec_parameters_from_context(wr->stream->codecpar, wr->codec);
  if (enc->id == AV_CODEC_ID_HEVC) {
    // Apple-compatible sample entry, like the reference's -tag:v hvc1
    wr->stream->codecpar->codec_tag = MKTAG('h', 'v', 'c', '1');
  }
  if (!(wr->fmt->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&wr->fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
      delete wr;
      return nullptr;
    }
  }
  AVDictionary* mux_opts = nullptr;
  // moov atom up front for streaming - replaces the reference's bundled
  // qt-faststart binary (ffmpeg_lib/qt-faststart)
  av_dict_set(&mux_opts, "movflags", "+faststart", 0);
  int hdr_rc = avformat_write_header(wr->fmt, &mux_opts);
  av_dict_free(&mux_opts);
  if (hdr_rc < 0) {
    delete wr;
    return nullptr;
  }
  wr->sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, AV_PIX_FMT_YUV420P,
                           SWS_BILINEAR, nullptr, nullptr, nullptr);
  wr->frame = av_frame_alloc();
  wr->frame->format = AV_PIX_FMT_YUV420P;
  wr->frame->width = w;
  wr->frame->height = h;
  av_frame_get_buffer(wr->frame, 0);
  return wr;
}

static void write_pkt(Writer* wr) {
  AVPacket* pkt = av_packet_alloc();
  while (avcodec_receive_packet(wr->codec, pkt) >= 0) {
    av_packet_rescale_ts(pkt, wr->codec->time_base, wr->stream->time_base);
    pkt->stream_index = wr->stream->index;
    if (pkt->duration == 0) {
      // without a duration the mov muxer writes an edit list that trims
      // the final sample from playback
      pkt->duration =
          av_rescale_q(1, wr->codec->time_base, wr->stream->time_base);
    }
    av_interleaved_write_frame(wr->fmt, pkt);
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
}

int vw_write(void* h, const uint8_t* rgb) {
  auto* wr = static_cast<Writer*>(h);
  const uint8_t* src[1] = {rgb};
  int src_linesize[1] = {wr->width * 3};
  av_frame_make_writable(wr->frame);
  sws_scale(wr->sws, src, src_linesize, 0, wr->height, wr->frame->data,
            wr->frame->linesize);
  wr->frame->pts = wr->pts++;
  if (avcodec_send_frame(wr->codec, wr->frame) < 0) return -1;
  write_pkt(wr);
  return 0;
}

// Pre-converted YUV420P planes (tightly packed: y [h][w], u/v [h/2][w/2]).
// The device does the BT.601 colorspace math + chroma subsampling
// (pipeline.py), so the host skips swscale entirely and the device->host
// transfer shrinks from 3 to 1.5 bytes/pixel.
int vw_write_yuv420(void* h, const uint8_t* y, const uint8_t* u,
                    const uint8_t* v) {
  auto* wr = static_cast<Writer*>(h);
  const int w = wr->width, hh = wr->height;
  if ((w | hh) & 1) return -1;
  av_frame_make_writable(wr->frame);
  for (int row = 0; row < hh; ++row)
    memcpy(wr->frame->data[0] + (size_t)row * wr->frame->linesize[0],
           y + (size_t)row * w, w);
  for (int row = 0; row < hh / 2; ++row) {
    memcpy(wr->frame->data[1] + (size_t)row * wr->frame->linesize[1],
           u + (size_t)row * (w / 2), w / 2);
    memcpy(wr->frame->data[2] + (size_t)row * wr->frame->linesize[2],
           v + (size_t)row * (w / 2), w / 2);
  }
  wr->frame->pts = wr->pts++;
  if (avcodec_send_frame(wr->codec, wr->frame) < 0) return -1;
  write_pkt(wr);
  return 0;
}

void vw_close(void* h) {
  auto* wr = static_cast<Writer*>(h);
  avcodec_send_frame(wr->codec, nullptr);
  write_pkt(wr);
  av_write_trailer(wr->fmt);
  if (!(wr->fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&wr->fmt->pb);
  if (wr->sws) sws_freeContext(wr->sws);
  av_frame_free(&wr->frame);
  avcodec_free_context(&wr->codec);
  avformat_free_context(wr->fmt);
  delete wr;
}

}  // extern "C"
