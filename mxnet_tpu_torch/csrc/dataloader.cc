// The port's native image data loader: RecordIO scan + parallel JPEG/PNG
// decode + augment, a copy of the JAX package's loader
// (mxtpu_dataloader.cc) with the same record scan, resize, crop,
// mirror, normalisation, layouts and per-sample seeds.  The analog of
// the reference's ImageRecordIOParser2 (src/io/iter_image_recordio_2.cc:
// OMP decode threads) + default augmenter (src/io/image_aug_default.cc:
// resize, random/center crop, mirror, mean/std normalize).
//
// Design: mxt_loader_next() fills the caller's batch buffer with a
// parallel-for over samples on an internal thread pool — decode
// parallelism without Python's GIL.  The buffer is the caller's, so a
// caller can have a batch decoded straight into pinned memory.
//
// Record container: dmlc RecordIO (magic 0xced7230a, 29-bit length,
// pad-to-4) holding IRHeader{u32 flag, f32 label, u64 id, u64 id2}
// (+ flag extra f32 labels when flag>0) + JPEG/PNG payload — identical
// bytes to the reference and to mxnet_tpu_torch/recordio.py.
//
// Output layout: float32 CHW, channels in BGR order (the reference's
// OpenCV convention) — or channels-last HWC via
// mxt_loader_set_layout(h, 1), decoded straight into place.
//
// JPEG decode has two routes, chosen when the library is built
// (mxnet_tpu_torch/_native.py):
//   * libjpeg (the default): the JAX package's decoder, bit for bit;
//   * nvJPEG (-DMXT_NVJPEG, where libjpeg's headers are missing): each
//     pool thread decodes into a device buffer of its own with the CUDA
//     toolkit's nvJPEG and copies the RGB pixels back, then resizes,
//     crops and mirrors on the host as the libjpeg route does.  Its IDCT
//     and chroma upsampling differ from libjpeg's, so its pixels are
//     close to, not equal to, the libjpeg route's.
// PNG decode needs libpng (-DMXT_PNG); without it a PNG record fails to
// decode and is counted by mxt_loader_failures.

#include <fcntl.h>
#include <setjmp.h>
#include <unistd.h>

#include <cstdio>  // jpeglib.h needs FILE
#ifdef MXT_NVJPEG
#include <cuda_runtime.h>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#endif
#ifdef MXT_PNG
#include <png.h>
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

struct Image {
  int h = 0, w = 0;            // decoded size
  std::vector<uint8_t> rgb;    // HWC, RGB
};

// ---------------------------------------------------------------- JPEG
#ifdef MXT_NVJPEG
// one nvJPEG handle per process; a decode state, stream and device
// buffer per pool thread (a state serves one decode at a time)
nvjpegHandle_t NvHandle() {
  static nvjpegHandle_t handle = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    if (nvjpegCreateSimple(&handle) != NVJPEG_STATUS_SUCCESS) handle = nullptr;
  });
  return handle;
}

struct NvThreadState {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t *dbuf = nullptr;
  size_t cap = 0;
  std::vector<uint8_t> host, up_cb, up_cr;  // planes copied back, upsampled
  bool ok = false;
  NvThreadState() {
    nvjpegHandle_t h = NvHandle();
    ok = h && nvjpegJpegStateCreate(h, &state) == NVJPEG_STATUS_SUCCESS &&
         cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) ==
             cudaSuccess;
  }
  ~NvThreadState() {
    if (dbuf) cudaFree(dbuf);
    if (stream) cudaStreamDestroy(stream);
    if (state) nvjpegJpegStateDestroy(state);
  }
};

// libjpeg's YCbCr -> RGB tables (jdcolor.c, build_ycc_rgb_table)
struct YccTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  YccTables() {
    const long half = 1L << 15;
    auto fix = [](double v) { return long(v * (1L << 16) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      long x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

inline uint8_t Clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// libjpeg's fancy (triangle) upsampling of one chroma plane by 2
// horizontally and 1 or 2 vertically (jdsample.c h2v1_fancy_upsample,
// h2v2_fancy_upsample), the edge rows replicated as libjpeg's context
// rows are; a plane at most 2 samples wide is replicated, as libjpeg does
void UpsampleChroma(const uint8_t *in, int iw, int ih, size_t pitch,
                    int vfactor, std::vector<uint8_t> *out) {
  const int ow = 2 * iw, oh = vfactor * ih;
  out->resize(size_t(ow) * oh);
  for (int oy = 0; oy < oh; ++oy) {
    const int iy = oy / vfactor;
    const uint8_t *r0 = in + size_t(iy) * pitch;
    uint8_t *o = out->data() + size_t(oy) * ow;
    if (iw <= 2) {
      for (int x = 0; x < ow; ++x) o[x] = r0[x / 2];
      continue;
    }
    if (vfactor == 1) {
      o[0] = r0[0];
      o[1] = uint8_t((r0[0] * 3 + r0[1] + 2) >> 2);
      for (int j = 1; j < iw - 1; ++j) {
        const int v = r0[j] * 3;
        o[2 * j] = uint8_t((v + r0[j - 1] + 1) >> 2);
        o[2 * j + 1] = uint8_t((v + r0[j + 1] + 2) >> 2);
      }
      o[2 * iw - 2] = uint8_t((r0[iw - 1] * 3 + r0[iw - 2] + 1) >> 2);
      o[2 * iw - 1] = r0[iw - 1];
      continue;
    }
    // the upper output row of a pair blends the row above, the lower one
    // the row below
    const int ny = (oy % 2 == 0) ? std::max(iy - 1, 0)
                                 : std::min(iy + 1, ih - 1);
    const uint8_t *r1 = in + size_t(ny) * pitch;
    int last = 0, cur = r0[0] * 3 + r1[0], next = r0[1] * 3 + r1[1];
    o[0] = uint8_t((cur * 4 + 8) >> 4);
    o[1] = uint8_t((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
    for (int j = 1; j < iw - 1; ++j) {
      next = r0[j + 1] * 3 + r1[j + 1];
      o[2 * j] = uint8_t((cur * 3 + last + 8) >> 4);
      o[2 * j + 1] = uint8_t((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
    }
    o[2 * iw - 2] = uint8_t((cur * 3 + last + 8) >> 4);
    o[2 * iw - 1] = uint8_t((cur * 4 + 7) >> 4);
  }
}

bool NvDecode(const uint8_t *buf, size_t len, nvjpegOutputFormat_t fmt,
              const int *widths, const int *heights, int planes,
              NvThreadState *ts, nvjpegImage_t *img) {
  size_t need = 0, off[3];
  for (int c = 0; c < planes; ++c) {
    off[c] = need;
    need += size_t(widths[c]) * heights[c] * (planes == 1 && fmt ==
                                              NVJPEG_OUTPUT_RGBI ? 3 : 1);
  }
  if (need > ts->cap) {
    if (ts->dbuf) cudaFree(ts->dbuf);
    ts->dbuf = nullptr;
    ts->cap = 0;
    if (cudaMalloc(&ts->dbuf, need) != cudaSuccess) return false;
    ts->cap = need;
  }
  nvjpegImage_t dimg;
  std::memset(&dimg, 0, sizeof(dimg));
  std::memset(img, 0, sizeof(*img));
  for (int c = 0; c < planes; ++c) {
    dimg.channel[c] = ts->dbuf + off[c];
    dimg.pitch[c] = size_t(widths[c]) * (fmt == NVJPEG_OUTPUT_RGBI ? 3 : 1);
  }
  if (nvjpegDecode(NvHandle(), ts->state, buf, len, fmt, &dimg,
                   ts->stream) != NVJPEG_STATUS_SUCCESS)
    return false;
  ts->host.resize(need);
  if (cudaMemcpyAsync(ts->host.data(), ts->dbuf, need,
                      cudaMemcpyDeviceToHost, ts->stream) != cudaSuccess ||
      cudaStreamSynchronize(ts->stream) != cudaSuccess)
    return false;
  for (int c = 0; c < planes; ++c) {
    img->channel[c] = ts->host.data() + off[c];
    img->pitch[c] = dimg.pitch[c];
  }
  return true;
}

// nvJPEG's IDCT, then libjpeg's own chroma upsampling and colour
// conversion for 4:4:4, 4:2:2 and 4:2:0 images, so the pixels differ
// from the libjpeg route's by the IDCTs alone; other layouts (grey,
// 4:4:0, 4:1:1, 4:1:0) take nvJPEG's own RGB conversion
bool DecodeJpeg(const uint8_t *buf, size_t len, Image *out) {
  thread_local NvThreadState ts;
  if (!ts.ok) return false;
  static const YccTables ycc;
  int ncomp = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(NvHandle(), buf, len, &ncomp, &sub, widths,
                         heights) != NVJPEG_STATUS_SUCCESS)
    return false;
  const int w = widths[0], hgt = heights[0];
  out->w = w;
  out->h = hgt;
  out->rgb.resize(size_t(w) * hgt * 3);
  nvjpegImage_t img;
  int vfactor = 0;  // 0: no upsampling
  if (ncomp == 3 && sub == NVJPEG_CSS_420) vfactor = 2;
  else if (ncomp == 3 && sub == NVJPEG_CSS_422) vfactor = 1;
  else if (!(ncomp == 3 && sub == NVJPEG_CSS_444)) {
    if (!NvDecode(buf, len, NVJPEG_OUTPUT_RGBI, widths, heights, 1, &ts,
                  &img))
      return false;
    for (int y = 0; y < hgt; ++y)
      std::memcpy(out->rgb.data() + size_t(y) * w * 3,
                  img.channel[0] + size_t(y) * img.pitch[0], size_t(w) * 3);
    return true;
  }
  if (!NvDecode(buf, len, NVJPEG_OUTPUT_YUV, widths, heights, 3, &ts, &img))
    return false;
  const uint8_t *cb = img.channel[1], *cr = img.channel[2];
  size_t cpitch = img.pitch[1];
  if (vfactor) {
    UpsampleChroma(img.channel[1], widths[1], heights[1], img.pitch[1],
                   vfactor, &ts.up_cb);
    UpsampleChroma(img.channel[2], widths[2], heights[2], img.pitch[2],
                   vfactor, &ts.up_cr);
    cb = ts.up_cb.data();
    cr = ts.up_cr.data();
    cpitch = size_t(2) * widths[1];
  }
  for (int y = 0; y < hgt; ++y) {
    const uint8_t *yr = img.channel[0] + size_t(y) * img.pitch[0];
    const uint8_t *br = cb + size_t(y) * cpitch, *rr = cr + size_t(y) * cpitch;
    uint8_t *o = out->rgb.data() + size_t(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int yy = yr[x], b = br[x], r = rr[x];
      o[3 * x] = Clamp255(yy + ycc.cr_r[r]);
      o[3 * x + 1] = Clamp255(yy + int((ycc.cb_g[b] + ycc.cr_g[r]) >> 16));
      o[3 * x + 2] = Clamp255(yy + ycc.cb_b[b]);
    }
  }
  return true;
}
#else
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void JpegErrExit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr *>(cinfo->err)->jb, 1);
}

bool DecodeJpeg(const uint8_t *buf, size_t len, Image *out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrExit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t *row = out->rgb.data() + size_t(cinfo.output_scanline) *
                                         out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

#endif  // MXT_NVJPEG

// ----------------------------------------------------------------- PNG
#ifdef MXT_PNG
bool DecodePng(const uint8_t *buf, size_t len, Image *out) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, buf, len)) return false;
  img.format = PNG_FORMAT_RGB;
  out->w = img.width;
  out->h = img.height;
  out->rgb.resize(PNG_IMAGE_SIZE(img));
  if (!png_image_finish_read(&img, nullptr, out->rgb.data(), 0, nullptr)) {
    png_image_free(&img);
    return false;
  }
  return true;
}
#else
bool DecodePng(const uint8_t *, size_t, Image *) { return false; }
#endif  // MXT_PNG

bool Decode(const uint8_t *buf, size_t len, Image *out) {
  if (len >= 8 && buf[0] == 0x89 && buf[1] == 'P' && buf[2] == 'N' &&
      buf[3] == 'G')
    return DecodePng(buf, len, out);
  return DecodeJpeg(buf, len, out);
}

// ------------------------------------------------------------ augment
// bilinear resize RGB HWC -> (nh, nw)
void Resize(const Image &src, int nh, int nw, Image *dst) {
  dst->h = nh;
  dst->w = nw;
  dst->rgb.resize(size_t(nh) * nw * 3);
  const float sy = float(src.h) / nh, sx = float(src.w) / nw;
  for (int y = 0; y < nh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = std::max(0, std::min(src.h - 1, int(std::floor(fy))));
    int y1 = std::min(src.h - 1, y0 + 1);
    float wy = fy - y0;
    for (int x = 0; x < nw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = std::max(0, std::min(src.w - 1, int(std::floor(fx))));
      int x1 = std::min(src.w - 1, x0 + 1);
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float p00 = src.rgb[(size_t(y0) * src.w + x0) * 3 + c];
        float p01 = src.rgb[(size_t(y0) * src.w + x1) * 3 + c];
        float p10 = src.rgb[(size_t(y1) * src.w + x0) * 3 + c];
        float p11 = src.rgb[(size_t(y1) * src.w + x1) * 3 + c];
        float v = p00 * (1 - wy) * (1 - wx) + p01 * (1 - wy) * wx +
                  p10 * wy * (1 - wx) + p11 * wy * wx;
        dst->rgb[(size_t(y) * nw + x) * 3 + c] =
            uint8_t(std::max(0.f, std::min(255.f, v + 0.5f)));
      }
    }
  }
}

// pixel store: float output applies the (v - mean)/std * scale
// normalization; uint8 output is the raw decoded byte — only offered
// when the normalization is identity (enforced by the python layer), so
// a consumer can upload quarter-size batches and normalize on-device
inline void StorePx(float *p, uint8_t v, float m, float s, float sc) {
  *p = (float(v) - m) / s * sc;
}
inline void StorePx(uint8_t *p, uint8_t v, float, float, float) { *p = v; }

// ------------------------------------------------------------- loader
struct Loader {
  int fd = -1;
  std::vector<uint64_t> records;  // logical-record start offsets
  std::vector<uint32_t> order;
  size_t cursor = 0;

  int batch, channels, height, width, label_width;
  bool channels_last = false;  // HWC output (NHWC batches)
  bool shuffle, rand_crop, rand_mirror;
  int resize_short;
  float scale;
  float mean[3] = {0, 0, 0}, stdv[3] = {1, 1, 1};
  std::mt19937 rng;
  uint32_t seed;
  int epoch = 0;

  // thread pool.  Each ParallelFor publishes one immutable BatchWork;
  // stragglers from a previous batch still hold their own shared_ptr and
  // can only claim indices from that (exhausted) batch's counter, so a
  // new batch can never race with an old worker (no shared mutable
  // task/counter across generations).
  struct BatchWork {
    std::function<void(int)> fn;
    std::atomic<int> next{0};
    std::atomic<int> done{0};
    int n = 0;
  };
  std::vector<std::thread> threads;
  std::shared_ptr<BatchWork> batch_work;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  bool stop_pool = false;
  uint64_t generation = 0;
  std::atomic<int64_t> failures{0};

  std::string error;

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop_pool = true;
      ++generation;
    }
    cv_work.notify_all();
    for (auto &t : threads) t.join();
    if (fd >= 0) close(fd);
  }

  void StartPool(int n) {
    for (int i = 0; i < n; ++i) {
      threads.emplace_back([this]() {
        uint64_t seen_gen = 0;
        for (;;) {
          std::shared_ptr<BatchWork> work;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv_work.wait(lk, [&] {
              return stop_pool || generation != seen_gen;
            });
            if (stop_pool) return;
            seen_gen = generation;
            work = batch_work;
          }
          if (!work) continue;
          for (;;) {
            int i = work->next.fetch_add(1);
            if (i >= work->n) break;
            work->fn(i);
            if (work->done.fetch_add(1) + 1 == work->n) {
              std::lock_guard<std::mutex> lk(mu);
              cv_done.notify_all();
            }
          }
        }
      });
    }
  }

  void ParallelFor(int n, std::function<void(int)> fn) {
    if (threads.empty()) {
      for (int i = 0; i < n; ++i) fn(i);
      return;
    }
    auto work = std::make_shared<BatchWork>();
    work->fn = std::move(fn);
    work->n = n;
    {
      std::lock_guard<std::mutex> lk(mu);
      batch_work = work;
      ++generation;
    }
    cv_work.notify_all();
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return work->done.load() >= work->n; });
  }

  bool ScanOffsets() {
    // walk the record stream; multi-part records (cflag 1/2/3) belong to
    // one logical record starting at the first part
    uint64_t pos = 0;
    off_t size = lseek(fd, 0, SEEK_END);
    std::vector<uint8_t> head(8);
    bool in_multi = false;
    uint64_t start = 0;
    while (pos + 8 <= uint64_t(size)) {
      if (pread(fd, head.data(), 8, pos) != 8) break;
      uint32_t magic, lrec;
      std::memcpy(&magic, head.data(), 4);
      std::memcpy(&lrec, head.data() + 4, 4);
      if (magic != kMagic) {
        error = "bad record magic";
        return false;
      }
      uint32_t cflag = lrec >> 29, length = lrec & ((1u << 29) - 1);
      if (cflag == 0 || cflag == 1) {
        start = pos;
        in_multi = (cflag == 1);
        if (cflag == 0)
          records.push_back(start);
      } else if ((cflag == 3) && in_multi) {
        records.push_back(start);
        in_multi = false;
      }
      pos += 8 + length + ((4 - (length & 3)) & 3);
    }
    return true;
  }

  // read the full (possibly multi-part) logical record payload at
  // offset.  Multi-part records are payloads that contained the escaped
  // magic word: the writer split at each occurrence, so the reader
  // re-inserts the magic between parts (recordio.py read(),
  // mxtpu_runtime.cc MXTRecordReaderNext do the same).
  bool ReadRecord(uint64_t pos, std::vector<uint8_t> *payload) {
    payload->clear();
    uint8_t head[8];
    bool first = true;
    for (;;) {
      if (pread(fd, head, 8, pos) != 8) return false;
      uint32_t lrec;
      std::memcpy(&lrec, head + 4, 4);
      uint32_t cflag = lrec >> 29, length = lrec & ((1u << 29) - 1);
      if (!first) {
        const uint32_t magic = kMagic;
        size_t old = payload->size();
        payload->resize(old + 4);
        std::memcpy(payload->data() + old, &magic, 4);
      }
      size_t old = payload->size();
      payload->resize(old + length);
      if (pread(fd, payload->data() + old, length, pos + 8) !=
          ssize_t(length))
        return false;
      pos += 8 + length + ((4 - (length & 3)) & 3);
      if (cflag == 0 || cflag == 3) return true;
      first = false;
    }
  }

  // decode + augment one sample into the batch buffers.  T is the
  // output pixel type: float (normalized) or uint8_t (raw bytes)
  template <typename T>
  bool LoadOne(const std::vector<uint8_t> &payload, uint32_t sample_seed,
               T *data_out, float *label_out) {
    if (payload.size() < 24) return false;
    uint32_t flag;
    float single_label;
    std::memcpy(&flag, payload.data(), 4);
    std::memcpy(&single_label, payload.data() + 4, 4);
    size_t off = 24;
    if (flag > 0) {
      // corrupt headers must not drive reads past the payload
      if (size_t(flag) > (payload.size() - off) / 4) return false;
      for (int i = 0; i < label_width; ++i) {
        float v = 0;
        if (i < int(flag)) std::memcpy(&v, payload.data() + off + 4 * i, 4);
        label_out[i] = v;
      }
      off += size_t(flag) * 4;
    } else {
      for (int i = 0; i < label_width; ++i) label_out[i] = single_label;
    }
    if (off >= payload.size()) return false;
    Image img;
    if (!Decode(payload.data() + off, payload.size() - off, &img))
      return false;

    std::mt19937 srng(sample_seed);
    // resize short edge
    if (resize_short > 0 && std::min(img.h, img.w) != resize_short) {
      float r = float(resize_short) / std::min(img.h, img.w);
      Image tmp;
      Resize(img, std::max(height, int(img.h * r + 0.5f)),
             std::max(width, int(img.w * r + 0.5f)), &tmp);
      img = std::move(tmp);
    }
    if (img.h < height || img.w < width) {
      Image tmp;
      Resize(img, std::max(img.h, height), std::max(img.w, width), &tmp);
      img = std::move(tmp);
    }
    int y0, x0;
    if (rand_crop) {
      y0 = int(srng() % uint32_t(img.h - height + 1));
      x0 = int(srng() % uint32_t(img.w - width + 1));
    } else {
      y0 = (img.h - height) / 2;
      x0 = (img.w - width) / 2;
    }
    bool mirror = rand_mirror && (srng() & 1);
    if (channels_last) {
      // HWC float, BGR order, normalize — same math as the CHW loop,
      // written channels-innermost so an NHWC batch needs no transpose
      for (int y = 0; y < height; ++y) {
        const uint8_t *row =
            img.rgb.data() + (size_t(y0 + y) * img.w + x0) * 3;
        T *orow = data_out + size_t(y) * width * channels;
        for (int x = 0; x < width; ++x) {
          int sx = mirror ? (width - 1 - x) : x;
          for (int c = 0; c < channels; ++c) {
            int src_c = channels == 3 ? 2 - c : 0;  // BGR out of RGB
            StorePx(orow + size_t(x) * channels + c,
                    row[size_t(sx) * 3 + src_c], mean[c], stdv[c], scale);
          }
        }
      }
      return true;
    }
    // CHW, BGR order
    for (int c = 0; c < channels; ++c) {
      int src_c = channels == 3 ? 2 - c : 0;  // BGR out of RGB decode
      float m = mean[c], s = stdv[c];
      T *plane = data_out + size_t(c) * height * width;
      for (int y = 0; y < height; ++y) {
        const uint8_t *row =
            img.rgb.data() + (size_t(y0 + y) * img.w + x0) * 3;
        T *orow = plane + size_t(y) * width;
        for (int x = 0; x < width; ++x) {
          int sx = mirror ? (width - 1 - x) : x;
          StorePx(orow + x, row[size_t(sx) * 3 + src_c], m, s, scale);
        }
      }
    }
    return true;
  }
};

// Fill one batch into T-typed pixel storage.  Returns the number of
// fresh (non-wrapped) samples: == batch mid-epoch, < batch for the
// final padded batch, 0 at epoch end.  Corrupt records are zero-filled
// and counted (mxt_loader_failures) but never end the epoch early —
// the reference parser likewise skips bad records and keeps going.
template <typename T>
int NextImpl(Loader *L, T *data, float *label) {
  size_t n = L->order.size();
  if (L->cursor >= n || n == 0) return 0;
  int fresh = int(std::min<size_t>(L->batch, n - L->cursor));
  size_t plane = size_t(L->channels) * L->height * L->width;
  uint32_t epoch_seed = L->seed * 2654435761u + uint32_t(L->epoch);
  L->ParallelFor(L->batch, [&, n](int i) {
    size_t idx = L->order[(L->cursor + i) % n];  // wrap-pad to epoch start
    bool ok = false;
    try {
      std::vector<uint8_t> payload;
      ok = L->ReadRecord(L->records[idx], &payload) &&
           L->LoadOne(payload, epoch_seed + uint32_t(idx) * 2246822519u,
                      data + size_t(i) * plane,
                      label + size_t(i) * L->label_width);
    } catch (const std::exception &) {
      ok = false;  // corrupt header driving a huge alloc etc.
    }
    if (!ok) {
      std::memset(data + size_t(i) * plane, 0, plane * sizeof(T));
      std::memset(label + size_t(i) * L->label_width, 0,
                  L->label_width * sizeof(float));
      L->failures.fetch_add(1);
    }
  });
  L->cursor += fresh;
  return fresh;
}

}  // namespace

extern "C" {

void *mxt_loader_create(const char *rec_path, int batch, int channels,
                        int height, int width, int label_width,
                        int shuffle, int rand_crop, int rand_mirror,
                        int resize_short, float scale, const float *mean3,
                        const float *std3, int num_threads, uint32_t seed,
                        int part_index, int num_parts) {
  auto *L = new Loader();
  L->fd = open(rec_path, O_RDONLY);
  if (L->fd < 0) {
    delete L;
    return nullptr;
  }
  L->batch = batch;
  L->channels = channels;
  L->height = height;
  L->width = width;
  L->label_width = std::max(1, label_width);
  L->shuffle = shuffle != 0;
  L->rand_crop = rand_crop != 0;
  L->rand_mirror = rand_mirror != 0;
  L->resize_short = resize_short;
  L->scale = scale;
  if (mean3)
    for (int i = 0; i < 3; ++i) L->mean[i] = mean3[i];
  if (std3)
    for (int i = 0; i < 3; ++i) L->stdv[i] = std3[i];
  L->seed = seed;
  L->rng.seed(seed);
  if (!L->ScanOffsets()) {
    delete L;
    return nullptr;
  }
  // shard for data parallelism (num_parts/part_index contract)
  if (num_parts > 1) {
    size_t n = L->records.size() / num_parts;
    std::vector<uint64_t> shard(
        L->records.begin() + part_index * n,
        L->records.begin() + (part_index + 1) * n);
    L->records.swap(shard);
  }
  L->order.resize(L->records.size());
  for (size_t i = 0; i < L->order.size(); ++i) L->order[i] = uint32_t(i);
  if (L->shuffle)
    std::shuffle(L->order.begin(), L->order.end(), L->rng);
  L->StartPool(std::max(1, num_threads));
  return L;
}

int64_t mxt_loader_count(void *h) {
  return int64_t(static_cast<Loader *>(h)->records.size());
}

void mxt_loader_reset(void *h) {
  auto *L = static_cast<Loader *>(h);
  L->cursor = 0;
  ++L->epoch;
  if (L->shuffle) {
    L->rng.seed(L->seed + uint32_t(L->epoch));
    std::shuffle(L->order.begin(), L->order.end(), L->rng);
  }
}

// Fill one float batch (normalized); see NextImpl for the contract.
int mxt_loader_next(void *h, float *data, float *label) {
  return NextImpl(static_cast<Loader *>(h), data, label);
}

// Fill one raw-uint8 batch — same decode/augment chain, quarter the
// bytes.  The caller must have created the loader with identity
// normalization (mean 0 / std 1 / scale 1); the python layer enforces
// this before choosing the u8 path.
int mxt_loader_next_u8(void *h, uint8_t *data, float *label) {
  return NextImpl(static_cast<Loader *>(h), data, label);
}

// cumulative count of records that failed to read/decode (zero-filled)
int64_t mxt_loader_failures(void *h) {
  return static_cast<Loader *>(h)->failures.load();
}

// 1 = channels-last (HWC per sample, NHWC batches); 0 = CHW (default)
void mxt_loader_set_layout(void *h, int channels_last) {
  static_cast<Loader *>(h)->channels_last = channels_last != 0;
}

void mxt_loader_free(void *h) { delete static_cast<Loader *>(h); }

// which JPEG decoder this build uses: "libjpeg" or "nvjpeg"; and
// whether it decodes PNG
const char *mxt_loader_jpeg_route() {
#ifdef MXT_NVJPEG
  return "nvjpeg";
#else
  return "libjpeg";
#endif
}

int mxt_loader_has_png() {
#ifdef MXT_PNG
  return 1;
#else
  return 0;
#endif
}

}  // extern "C"
