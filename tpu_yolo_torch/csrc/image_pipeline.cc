// Host data path of tpu_yolo_torch: JPEG decode (libjpeg), resize and
// letterbox into fixed-size batch buffers, in a thread pool that never
// holds the GIL (callers use ctypes). A copy of the JAX package's host
// pipeline with the same C ABI and the same arithmetic, built at first
// use by tpu_yolo_torch/ops/cuda_build.py::build_host, and the reference
// of the card's data path (csrc/image_card.cu, ops/image_cuda.py).
//
// Built without -march and with -ffp-contract=off: no product is fused
// into a sum, so every float and double operation rounds as the source
// writes it, on any host, and the card's kernels (built with
// -fmad=false) and the plain versions in ops/image_cuda.py repeat it
// bit for bit.
//
// Letterbox geometry contract (data/image.py::letterbox, frozen against
// the reference's rounding):
//   r = min(size/h, size/w), clamped to <=1 for eval;
//   new = round(dim*r); pad split with the round(x -/+ 0.1) trick.
//
// C ABI (ctypes): see tpu_yolo_torch/data/native_loader.py.

#include <cstddef>
#include <cstdio>
// jpeglib.h needs size_t/FILE declared first.
#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// JPEG decode (libjpeg) -> RGB uint8.
// ---------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

bool decode_jpeg_rgb(const uint8_t* data, size_t len, std::vector<uint8_t>* out,
                     int* out_w, int* out_h, bool bgr = false) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  // BGR: the host-augment train loader (data/native_train.py) works in
  // OpenCV's BGR until its final output conversion; emitting BGR here
  // makes every downstream paste a contiguous memcpy. libjpeg-turbo
  // decodes extended colorspaces at identical cost; plain libjpeg
  // builds fall back to an in-place swap.
#ifdef JCS_EXTENSIONS
  cinfo.out_color_space = bgr ? JCS_EXT_BGR : JCS_RGB;
  const bool post_swap = false;
#else
  cinfo.out_color_space = JCS_RGB;
  const bool post_swap = bgr;
#endif
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  out->resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (post_swap) {
    uint8_t* p = out->data();
    for (size_t i = 0, n = static_cast<size_t>(w) * h; i < n; ++i, p += 3) {
      uint8_t t = p[0];
      p[0] = p[2];
      p[2] = t;
    }
  }
  *out_w = w;
  *out_h = h;
  return true;
}

// ---------------------------------------------------------------------
// Bilinear resize, RGB uint8, half-pixel centers (cv2.INTER_LINEAR
// convention: src = (dst + 0.5) * scale - 0.5).
// ---------------------------------------------------------------------

// Separable two-pass fixed-point bilinear (11-bit coefficients, the
// cv2 INTER_LINEAR convention) with a two-slot horizontal-row cache:
// the horizontal interpolation of each source row is computed once and
// reused by every output row that blends it (y0 is nondecreasing, so
// two slots suffice). Replaces a per-output-pixel float kernel that
// profiled 2.5 ms per 640-long-side image — the single largest cost of
// the staging paths after the JPEG decode itself. Max intermediate:
// 255*2048 per pass, accumulated 255*2048*2048 < 2^31; rounding via
// +2^21 before the >>22 keeps results within 1 LSB of exact bilinear
// (well inside the decoder-tolerance contract the loaders pin).
void resize_bilinear_rgb(const uint8_t* src, int sw, int sh, uint8_t* dst,
                         int dw, int dh) {
  constexpr int kBits = 11, kOne = 1 << kBits;
  const double sx = static_cast<double>(sw) / dw;
  const double sy = static_cast<double>(sh) / dh;
  std::vector<int> x0s(dw), x1s(dw), ifx(dw);
  for (int x = 0; x < dw; ++x) {
    double fx = (x + 0.5) * sx - 0.5;
    if (fx < 0) fx = 0;
    int x0 = static_cast<int>(fx);
    if (x0 > sw - 1) x0 = sw - 1;
    int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
    x0s[x] = x0 * 3;
    x1s[x] = x1 * 3;
    ifx[x] = static_cast<int>((fx - x0) * kOne + 0.5);
  }
  const int row_len = dw * 3;
  std::vector<int32_t> cache(2 * static_cast<size_t>(row_len));
  int cached[2] = {-1, -1};
  auto hrow = [&](int syi) -> const int32_t* {
    for (int s = 0; s < 2; ++s)
      if (cached[s] == syi) return cache.data() + s * row_len;
    const int s = (cached[0] <= cached[1]) ? 0 : 1;  // evict older row
    cached[s] = syi;
    int32_t* out = cache.data() + s * row_len;
    const uint8_t* srow = src + static_cast<size_t>(syi) * sw * 3;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* p0 = srow + x0s[x];
      const uint8_t* p1 = srow + x1s[x];
      const int f = ifx[x], g = kOne - f;
      out[x * 3 + 0] = p0[0] * g + p1[0] * f;
      out[x * 3 + 1] = p0[1] * g + p1[1] * f;
      out[x * 3 + 2] = p0[2] * g + p1[2] * f;
    }
    return out;
  };
  for (int y = 0; y < dh; ++y) {
    double fy = (y + 0.5) * sy - 0.5;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > sh - 1) y0 = sh - 1;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const int fyi = static_cast<int>((fy - y0) * kOne + 0.5);
    const int gyi = kOne - fyi;
    const int32_t* r0 = hrow(y0);
    const int32_t* r1 = (y1 == y0) ? r0 : hrow(y1);
    uint8_t* drow = dst + static_cast<size_t>(y) * row_len;
    for (int i = 0; i < row_len; ++i) {
      const int32_t v = r0[i] * gyi + r1[i] * fyi + (1 << (2 * kBits - 1));
      drow[i] = static_cast<uint8_t>(v >> (2 * kBits));
    }
  }
}

// ---------------------------------------------------------------------
// Generic separable resampler with float weights — the RANDOM-INTERP
// train prescale (cv2 _TRAIN_INTERPS: nearest/linear/cubic/area/
// lanczos4, data/image.py:21-38; reference dataset.py:95-103 draws one
// per decode). Weight formulas follow cv2's conventions (half-pixel
// centers for linear/cubic/lanczos4, floor mapping for nearest, cell
// overlap for area-shrink; area falls back to linear when either axis
// enlarges, as cv2.resize does). Index clamp = BORDER_REPLICATE.
// Interp codes are cv2's enum values.
// ---------------------------------------------------------------------

enum { kNearest = 0, kLinear = 1, kCubic = 2, kArea = 3, kLanczos4 = 4 };

// Per-output-coordinate taps: first source index + `support` weights.
static void make_taps(int interp, int src, int dst, int* support,
                      std::vector<int>* first, std::vector<float>* w) {
  const double scale = static_cast<double>(src) / dst;
  if (interp == kArea && scale >= 1.0) {
    // exact cell-overlap weights; support <= ceil(scale) + 1
    const int sup = static_cast<int>(std::ceil(scale)) + 1;
    *support = sup;
    first->assign(dst, 0);
    w->assign(static_cast<size_t>(dst) * sup, 0.0f);
    for (int x = 0; x < dst; ++x) {
      const double lo = x * scale, hi = (x + 1) * scale;
      int f = static_cast<int>(std::floor(lo));
      if (f > src - 1) f = src - 1;
      (*first)[x] = f;
      for (int t = 0; t < sup; ++t) {
        const int sx = f + t;
        if (sx >= src) break;
        const double cell_lo = sx, cell_hi = sx + 1;
        const double ov = std::min(hi, cell_hi) - std::max(lo, cell_lo);
        if (ov > 0) (*w)[static_cast<size_t>(x) * sup + t] =
            static_cast<float>(ov / scale);
      }
    }
    return;
  }
  if (interp == kNearest) {
    *support = 1;
    first->assign(dst, 0);
    w->assign(dst, 1.0f);
    for (int x = 0; x < dst; ++x) {
      int sx = static_cast<int>(std::floor(x * scale));  // cv2 nearest
      if (sx > src - 1) sx = src - 1;
      (*first)[x] = sx;
    }
    return;
  }
  int sup;
  if (interp == kCubic) sup = 4;
  else if (interp == kLanczos4) sup = 8;
  else sup = 2;  // linear (also area-enlarge fallback)
  *support = sup;
  first->assign(dst, 0);
  w->assign(static_cast<size_t>(dst) * sup, 0.0f);
  const double kPi = 3.14159265358979323846;
  for (int x = 0; x < dst; ++x) {
    double fx = (x + 0.5) * scale - 0.5;
    int x0 = static_cast<int>(std::floor(fx));
    const double d = fx - x0;
    float* wr = w->data() + static_cast<size_t>(x) * sup;
    if (sup == 2) {
      (*first)[x] = x0;
      wr[0] = static_cast<float>(1.0 - d);
      wr[1] = static_cast<float>(d);
    } else if (sup == 4) {
      (*first)[x] = x0 - 1;
      const double A = -0.75;  // cv2 interpolateCubic
      wr[0] = static_cast<float>(((A * (d + 1) - 5 * A) * (d + 1) + 8 * A)
                                 * (d + 1) - 4 * A);
      wr[1] = static_cast<float>(((A + 2) * d - (A + 3)) * d * d + 1);
      wr[2] = static_cast<float>(((A + 2) * (1 - d) - (A + 3)) * (1 - d)
                                 * (1 - d) + 1);
      wr[3] = 1.0f - wr[0] - wr[1] - wr[2];
    } else {
      (*first)[x] = x0 - 3;
      // cv2 interpolateLanczos4: cos-table form, normalized
      double sum = 0.0;
      double wd[8];
      if (d < 1e-12) {
        for (int t = 0; t < 8; ++t) wd[t] = 0.0;
        wd[3] = 1.0;
        sum = 1.0;
      } else {
        for (int t = 0; t < 8; ++t) {
          const double dx = d - (t - 3);
          const double px = kPi * dx;
          wd[t] = std::sin(px) * std::sin(px / 4.0) * 16.0 / (px * px);
          sum += wd[t];
        }
      }
      for (int t = 0; t < 8; ++t)
        wr[t] = static_cast<float>(wd[t] / sum);
    }
  }
}

// Separable two-pass float resampler; `interp` as above.
void resize_generic_rgb(const uint8_t* src, int sw, int sh, uint8_t* dst,
                        int dw, int dh, int interp) {
  if (interp == kLinear) {  // fast fixed-point path
    resize_bilinear_rgb(src, sw, sh, dst, dw, dh);
    return;
  }
  if (interp == kArea &&
      !(sw >= dw && sh >= dh)) {  // cv2: area-enlarge -> linear
    resize_bilinear_rgb(src, sw, sh, dst, dw, dh);
    return;
  }
  int sup_x, sup_y;
  std::vector<int> fx, fy;
  std::vector<float> wx, wy;
  make_taps(interp, sw, dw, &sup_x, &fx, &wx);
  make_taps(interp, sh, dh, &sup_y, &fy, &wy);

  // horizontal pass into a float intermediate (dh rows on demand would
  // need a sup_y-deep cache; sh*dw floats is fine at these sizes)
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float acc0 = 0, acc1 = 0, acc2 = 0;
      const float* wr = wx.data() + static_cast<size_t>(x) * sup_x;
      for (int t = 0; t < sup_x; ++t) {
        int sx = fx[x] + t;
        if (sx < 0) sx = 0;
        if (sx > sw - 1) sx = sw - 1;
        const uint8_t* p = srow + sx * 3;
        const float wgt = wr[t];
        acc0 += wgt * p[0];
        acc1 += wgt * p[1];
        acc2 += wgt * p[2];
      }
      trow[x * 3 + 0] = acc0;
      trow[x * 3 + 1] = acc1;
      trow[x * 3 + 2] = acc2;
    }
  }
  for (int y = 0; y < dh; ++y) {
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
    const float* wr = wy.data() + static_cast<size_t>(y) * sup_y;
    for (int i = 0; i < dw * 3; ++i) {
      float acc = 0;
      for (int t = 0; t < sup_y; ++t) {
        int sy = fy[y] + t;
        if (sy < 0) sy = 0;
        if (sy > sh - 1) sy = sh - 1;
        acc += wr[t] * tmp[static_cast<size_t>(sy) * dw * 3 + i];
      }
      const float v = acc + 0.5f;
      drow[i] = v <= 0 ? 0 : (v >= 255.0f ? 255
                              : static_cast<uint8_t>(v));
    }
  }
}

// Letterbox geometry identical to data/image.py::letterbox.
struct LetterboxGeom {
  int new_w, new_h, top, left;
  float ratio, pad_w, pad_h;
};

LetterboxGeom letterbox_geom(int w, int h, int size, bool allow_upscale) {
  float r = static_cast<float>(size) / (h > w ? h : w);
  float rw = static_cast<float>(size) / w;
  float rh = static_cast<float>(size) / h;
  r = rw < rh ? rw : rh;
  if (!allow_upscale && r > 1.0f) r = 1.0f;
  LetterboxGeom g;
  g.ratio = r;
  g.new_w = static_cast<int>(std::lroundf(w * r));
  g.new_h = static_cast<int>(std::lroundf(h * r));
  g.pad_w = (size - g.new_w) / 2.0f;
  g.pad_h = (size - g.new_h) / 2.0f;
  g.top = static_cast<int>(std::lroundf(g.pad_h - 0.1f));
  g.left = static_cast<int>(std::lroundf(g.pad_w - 0.1f));
  return g;
}

// Decode -> (optional pre-shrink to long side<=size happens implicitly
// via direct resize to letterboxed dims) -> letterbox into out
// (size*size*3, zero-padded borders). Returns geometry for box rescale.
bool load_letterboxed(const uint8_t* bytes, size_t len, int size,
                      bool allow_upscale, uint8_t* out, float* ratio,
                      float* pad_w, float* pad_h, int* orig_w, int* orig_h) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_jpeg_rgb(bytes, len, &rgb, &w, &h)) return false;
  LetterboxGeom g = letterbox_geom(w, h, size, allow_upscale);

  std::vector<uint8_t> resized(static_cast<size_t>(g.new_w) * g.new_h * 3);
  if (g.new_w == w && g.new_h == h) {
    std::memcpy(resized.data(), rgb.data(), resized.size());
  } else {
    resize_bilinear_rgb(rgb.data(), w, h, resized.data(), g.new_w, g.new_h);
  }

  std::memset(out, 0, static_cast<size_t>(size) * size * 3);
  for (int y = 0; y < g.new_h; ++y) {
    std::memcpy(out + (static_cast<size_t>(y + g.top) * size + g.left) * 3,
                resized.data() + static_cast<size_t>(y) * g.new_w * 3,
                static_cast<size_t>(g.new_w) * 3);
  }
  *ratio = g.ratio;
  *pad_w = g.pad_w;
  *pad_h = g.pad_h;
  *orig_w = w;
  *orig_h = h;
  return true;
}

// ---------------------------------------------------------------------
// Thread pool + bounded batch queue.
// ---------------------------------------------------------------------

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { Run(); });
  }
  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void Submit(std::function<void()> fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      tasks_.push_back(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void Run() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
        if (stop_ && tasks_.empty()) return;
        fn = std::move(tasks_.front());
        tasks_.pop_front();
      }
      fn();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::function<void()>> tasks_;
  std::vector<std::thread> workers_;
  bool stop_;
};

struct Pipeline {
  explicit Pipeline(int threads, int size, bool allow_upscale)
      : pool(threads), size(size), allow_upscale(allow_upscale) {}
  ThreadPool pool;
  int size;
  bool allow_upscale;
};

}  // namespace

extern "C" {

// Opaque pipeline handle.
void* ip_create(int threads, int size, int allow_upscale) {
  return new Pipeline(threads, size, allow_upscale != 0);
}

void ip_destroy(void* p) { delete static_cast<Pipeline*>(p); }

// Decode+letterbox one in-memory JPEG synchronously into `out`
// (size*size*3 bytes). meta = [ratio, pad_w, pad_h, orig_w, orig_h].
int ip_load_one(void* p, const uint8_t* bytes, int64_t len, uint8_t* out,
                float* meta) {
  Pipeline* pl = static_cast<Pipeline*>(p);
  float r, pw, ph;
  int ow, oh;
  if (!load_letterboxed(bytes, static_cast<size_t>(len), pl->size,
                        pl->allow_upscale, out, &r, &pw, &ph, &ow, &oh))
    return -1;
  meta[0] = r;
  meta[1] = pw;
  meta[2] = ph;
  meta[3] = static_cast<float>(ow);
  meta[4] = static_cast<float>(oh);
  return 0;
}

// Decode a batch of n files in parallel into a RAW top-left-anchored
// staging buffer `out` (n*stage*stage*3) WITHOUT letterboxing — the
// device-side letterbox path (ops/letterbox.py): the geometry
// runs on the device next to the model; the host only decodes. Images
// whose long side exceeds `stage` are pre-shrunk (bilinear) so the long
// side == stage. dims is (n, 4): [staged_h, staged_w, orig_h, orig_w];
// failed slots are zeroed with dims[0] = -1. Returns failure count.
// scale_mode 0: shrink only when larger, lround dims (serving staging).
// scale_mode 1: always resize so the long side == stage, truncated
//   dims (matches data/image.py::load_image: r = stage/max(h,w),
//   new = int(dim*r)) — the train-augment staging contract.
// scale_mode 2: scale_mode-1 resize, then CENTERED placement with the
//   letterbox round(pad -/+ 0.1) split — the full eval image contract
//   (data/image.py::load_image + letterbox(augment=False), reference
//   utils/dataset.py:95-103 + 292-313 composed): at eval the letterbox
//   ratio is always exactly 1 (the pre-scale already set the long side
//   == stage), so eval letterboxing is purely this centered pad.
static int load_batch_staged(Pipeline* pl, const char** paths, int n,
                             int stage, int scale_mode, uint8_t* out,
                             float* dims, bool bgr = false,
                             const int* interps = nullptr) {
  const size_t stride = static_cast<size_t>(stage) * stage * 3;
  std::atomic<int> failures{0};
  int done = 0;
  std::mutex mu;
  std::condition_variable cv;

  for (int i = 0; i < n; ++i) {
    pl->pool.Submit([&, i] {
      bool ok = false;
      std::vector<uint8_t> rgb;
      int w = 0, h = 0;
      FILE* f = fopen(paths[i], "rb");
      if (f) {
        fseek(f, 0, SEEK_END);
        long sz = ftell(f);
        fseek(f, 0, SEEK_SET);
        std::vector<uint8_t> buf(sz);
        if (fread(buf.data(), 1, sz, f) == static_cast<size_t>(sz))
          ok = decode_jpeg_rgb(buf.data(), sz, &rgb, &w, &h, bgr);
        fclose(f);
      }
      uint8_t* slot = out + stride * i;
      std::memset(slot, 0, stride);
      if (ok) {
        int sh = h, sw = w;
        const bool resize = scale_mode != 0 ? ((h > w ? h : w) != stage)
                                            : (h > stage || w > stage);
        std::vector<uint8_t> scaled;
        const uint8_t* src = rgb.data();
        if (resize) {
          // double, not float: the Python-side mirrors (load_image,
          // device_augment._scan_staged_dims) compute the ratio in
          // float64, and int(532 * (640.f/532)) = 639 != 640 — a
          // one-pixel dims divergence for ~2.5% of long-side values.
          const double d = static_cast<double>(stage) / (h > w ? h : w);
          if (scale_mode != 0) {
            sh = static_cast<int>(h * d);
            sw = static_cast<int>(w * d);
          } else {
            sh = static_cast<int>(std::lround(h * d));
            sw = static_cast<int>(std::lround(w * d));
          }
          if (sh > stage) sh = stage;
          if (sw > stage) sw = stage;
          if (sh < 1) sh = 1;
          if (sw < 1) sw = 1;
          scaled.resize(static_cast<size_t>(sw) * sh * 3);
          resize_generic_rgb(rgb.data(), w, h, scaled.data(), sw, sh,
                             interps ? interps[i] : kLinear);
          src = scaled.data();
        }
        int top = 0, left = 0;
        if (scale_mode == 2) {
          // data/image.py::letterbox center split: round(pad - 0.1)
          top = static_cast<int>(std::lroundf((stage - sh) / 2.0f - 0.1f));
          left = static_cast<int>(std::lroundf((stage - sw) / 2.0f - 0.1f));
        }
        for (int y = 0; y < sh; ++y)
          std::memcpy(slot + (static_cast<size_t>(y + top) * stage + left) * 3,
                      src + static_cast<size_t>(y) * sw * 3,
                      static_cast<size_t>(sw) * 3);
        dims[i * 4 + 0] = static_cast<float>(sh);
        dims[i * 4 + 1] = static_cast<float>(sw);
        dims[i * 4 + 2] = static_cast<float>(h);
        dims[i * 4 + 3] = static_cast<float>(w);
      } else {
        dims[i * 4 + 0] = -1.0f;
        dims[i * 4 + 1] = dims[i * 4 + 2] = dims[i * 4 + 3] = 0.0f;
        failures.fetch_add(1);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (++done == n) cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done == n; });
  return failures.load();
}

int ip_load_batch_raw(void* p, const char** paths, int n, int stage,
                      uint8_t* out, float* dims) {
  return load_batch_staged(static_cast<Pipeline*>(p), paths, n, stage,
                           /*scale_mode=*/0, out, dims);
}

// Train-augment staging: every image resized so its long side == stage
// (up or down, bilinear), truncated dims — the load_image contract the
// host mosaic math uses (data/image.py:26-38).
int ip_load_batch_scaled(void* p, const char** paths, int n, int stage,
                         uint8_t* out, float* dims) {
  return load_batch_staged(static_cast<Pipeline*>(p), paths, n, stage,
                           /*scale_mode=*/1, out, dims);
}

// Same contract as ip_load_batch_scaled but emitting BGR channel order
// (the host-augment train loader's working order, data/native_train.py)
// — decoded directly to BGR, so the swap costs nothing.
int ip_load_batch_scaled_bgr(void* p, const char** paths, int n, int stage,
                             uint8_t* out, float* dims) {
  return load_batch_staged(static_cast<Pipeline*>(p), paths, n, stage,
                           /*scale_mode=*/1, out, dims, /*bgr=*/true);
}

// Train staging with a PER-IMAGE interpolation draw — the reference's
// random-interp prescale (utils/dataset.py:95-103 resample();
// data/image.py _TRAIN_INTERPS). `interps` are cv2 enum codes
// (0 nearest, 1 linear, 2 cubic, 3 area, 4 lanczos4), one per path.
int ip_load_batch_scaled_interp(void* p, const char** paths, int n,
                                int stage, const int* interps, int bgr,
                                uint8_t* out, float* dims) {
  return load_batch_staged(static_cast<Pipeline*>(p), paths, n, stage,
                           /*scale_mode=*/1, out, dims, bgr != 0,
                           interps);
}

// Eval staging: the full eval image contract in one native pass —
// load_image resize (long side == stage, truncated dims) + centered
// letterbox pad (reference eval loader, main.py:232-234). dims is the
// scaled contract's [staged_h, staged_w, orig_h, orig_w]; the label
// geometry (pads) derives from it on the Python side.
int ip_load_batch_eval(void* p, const char** paths, int n, int stage,
                       uint8_t* out, float* dims) {
  return load_batch_staged(static_cast<Pipeline*>(p), paths, n, stage,
                           /*scale_mode=*/2, out, dims);
}

// Decode+letterbox a batch of n files in parallel into `out`
// (n*size*size*3) and metas (n*5). paths is an array of n C strings.
// Returns number of failures (failed slots are zeroed, meta[0]=-1).
int ip_load_batch(void* p, const char** paths, int n, uint8_t* out,
                  float* metas) {
  Pipeline* pl = static_cast<Pipeline*>(p);
  const size_t stride = static_cast<size_t>(pl->size) * pl->size * 3;
  std::atomic<int> failures{0};
  // done is guarded by mu (not atomic): the increment and the notify
  // happen under one lock so the waiter cannot pass the wait predicate
  // (and destroy mu/cv on return) while a worker still holds them.
  int done = 0;
  std::mutex mu;
  std::condition_variable cv;

  for (int i = 0; i < n; ++i) {
    pl->pool.Submit([&, i] {
      FILE* f = fopen(paths[i], "rb");
      bool ok = false;
      if (f) {
        fseek(f, 0, SEEK_END);
        long sz = ftell(f);
        fseek(f, 0, SEEK_SET);
        std::vector<uint8_t> buf(sz);
        if (fread(buf.data(), 1, sz, f) == static_cast<size_t>(sz)) {
          float r, pw, ph;
          int ow, oh;
          ok = load_letterboxed(buf.data(), sz, pl->size, pl->allow_upscale,
                                out + stride * i, &r, &pw, &ph, &ow, &oh);
          if (ok) {
            metas[i * 5 + 0] = r;
            metas[i * 5 + 1] = pw;
            metas[i * 5 + 2] = ph;
            metas[i * 5 + 3] = static_cast<float>(ow);
            metas[i * 5 + 4] = static_cast<float>(oh);
          }
        }
        fclose(f);
      }
      if (!ok) {
        std::memset(out + stride * i, 0, stride);
        metas[i * 5] = -1.0f;
        failures.fetch_add(1);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (++done == n) cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done == n; });
  return failures.load();
}

}  // extern "C"
