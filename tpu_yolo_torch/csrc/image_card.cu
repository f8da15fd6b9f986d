// The card's image data path: JPEG decode with nvJPEG into device memory,
// and hand-written placement kernels that compute what the host C++
// (csrc/image_pipeline.cc) computes, written straight into the (N, S, S,
// 3) uint8 batch on the card.
//
// Counterparts of host C++ functions, not of a TPU kernel:
//   ycc_rgb_kernel           <- libjpeg's decode after its IDCT, as the
//                               host copy's decode_jpeg_rgb runs it:
//                               jdsample.c's fancy upsampling and
//                               jdcolor.c's YCbCr -> RGB
//   resize_bilinear_kernel   <- image_pipeline.cc::resize_bilinear_rgb
//   resample_rows/_cols      <- image_pipeline.cc::resize_generic_rgb
//   place_kernel             <- the zeroed slot and row copies of
//                               load_letterboxed and load_batch_staged
// The wrappers, the plain versions and the host geometry are in
// tpu_yolo_torch/ops/image_cuda.py; the decode threads, streams and
// pinned buffers in data/native_loader.py::CardPipeline.
//
// Exactness. Built with -fmad=false: no product is fused into a sum, so
// each float and double operation rounds as the C++ source writes it,
// as the host copy (built with -ffp-contract=off) does. The bilinear
// resize is integer arithmetic on coefficients computed in double, so
// it equals the host bit for bit; the float resampler takes its taps
// from the host (ops/image_cuda.py::make_taps, libm's sin for lanczos4)
// and sums them tap by tap in the C++'s order, so it does too.
//
// Bound: bytes. Each kernel reads its source and writes its output
// once (a 1080x1920 source is 6.2 MB, a 640x640 slot 1.2 MB: some 2-3
// microseconds at 3.35 TB/s); one block per output row, a loop over the
// row's bytes, no shared memory (the colour kernel reads each chroma
// sample of its two rows from L1 up to four times). They are simple and right first: a
// later change fuses the resize and the fill into one launch.
//
// Decode. nvJPEG's own colour output upsamples the chroma of a 4:2:0 or
// 4:2:2 JPEG by replication, where libjpeg (and so the host copy and
// cv2) interpolates it ("fancy" upsampling): on photo-like images that
// alone moves the pixels by 6 levels on average. So a 4:4:4, 4:2:2 or
// 4:2:0 JPEG is decoded to nvJPEG's planar YCbCr (the IDCT's output,
// before any upsampling) and ycc_rgb_kernel does libjpeg's upsampling
// and colour conversion in its integer arithmetic; what is left between
// the two decoders is their IDCTs' rounding. A grayscale JPEG and the
// other subsamplings take nvJPEG's interleaved RGB as it is.
//
// C ABI (ctypes), every function returning 0 or an error code:
//   ic_ycc_rgb, ic_resize_bilinear, ic_resize_generic, ic_place: a
//   cudaError_t from the launch; ic_decoder_create/_destroy,
//   ic_image_info, ic_decode, ic_decode_planes: nvJPEG's status, or
//   1000 + a cudaError_t.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBits = 11, kOne = 1 << kBits;

// jdcolor.c's ycc_rgb_convert tables, computed: x = sample - 128,
// FIX(v) = (int)(v * 65536 + 0.5), arithmetic right shifts.
constexpr int kCrR = 91881, kCbB = 116130, kCrG = -46802, kCbG = -22554;
constexpr int kHalf = 1 << 15;

__device__ __forceinline__ uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One chroma sample of output column x of a row whose nearer chroma row
// is r0 and farther one r1 (jdsample.c, the edge columns and rows their
// own neighbours, as libjpeg's context rows are): h2v2 weighs rows 3:1,
// then those column sums 3:1, rounding with +8 and +7 alternately; h2v1
// weighs columns 3:1 with +1 and +2; h1v1 takes the sample. Chroma two
// samples wide or less is replicated, as libjpeg-turbo does.
__device__ __forceinline__ int fancy(const uint8_t* r0, const uint8_t* r1,
                                     int x, int cw, int hs, int vs) {
  if (hs == 1) return r0[x];
  const int c = x >> 1;
  if (cw <= 2) return r0[c];
  const int odd = x & 1;
  int n = odd ? c + 1 : c - 1;
  n = n < 0 ? 0 : (n > cw - 1 ? cw - 1 : n);
  if (vs == 2)
    return ((r0[c] * 3 + r1[c]) * 3 + r0[n] * 3 + r1[n] + 8 - odd) >> 4;
  return (r0[c] * 3 + r0[n] + 1 + odd) >> 2;
}

// One block per output row: per pixel the upsampled Cb and Cr and the
// fixed-point colour conversion. `bgr` swaps R and B.
__global__ void ycc_rgb_kernel(const uint8_t* __restrict__ yp, int ypitch,
                               const uint8_t* __restrict__ cbp,
                               const uint8_t* __restrict__ crp, int cpitch,
                               int cw, int ch, int w, int hs, int vs, int bgr,
                               uint8_t* __restrict__ dst, int pitch) {
  const int y = blockIdx.x;
  const int c0 = vs == 2 ? y >> 1 : y;
  int c1 = c0;
  if (vs == 2) {
    c1 = (y & 1) ? c0 + 1 : c0 - 1;
    c1 = c1 < 0 ? 0 : (c1 > ch - 1 ? ch - 1 : c1);
  }
  const size_t o0 = static_cast<size_t>(c0) * cpitch;
  const size_t o1 = static_cast<size_t>(c1) * cpitch;
  const uint8_t* yrow = yp + static_cast<size_t>(y) * ypitch;
  uint8_t* out = dst + static_cast<size_t>(y) * pitch;
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    const int cb = fancy(cbp + o0, cbp + o1, x, cw, hs, vs) - 128;
    const int cr = fancy(crp + o0, crp + o1, x, cw, hs, vs) - 128;
    const int l = yrow[x];
    const uint8_t r = clamp255(l + ((kCrR * cr + kHalf) >> 16));
    const uint8_t g = clamp255(l + ((kCbG * cb + kHalf + kCrG * cr) >> 16));
    const uint8_t b = clamp255(l + ((kCbB * cb + kHalf) >> 16));
    out[x * 3 + 0] = bgr ? b : r;
    out[x * 3 + 1] = g;
    out[x * 3 + 2] = bgr ? r : b;
  }
}

// One output coordinate's source pair and 11-bit weight, in double as
// resize_bilinear_rgb computes them (half-pixel centres, clamped).
__device__ __forceinline__ void bilinear_axis(int i, double scale, int n,
                                              int* i0, int* i1, int* f) {
  double v = (i + 0.5) * scale - 0.5;
  if (v < 0) v = 0;
  int a = static_cast<int>(v);
  if (a > n - 1) a = n - 1;
  *i0 = a;
  *i1 = a + 1 < n ? a + 1 : n - 1;
  *f = static_cast<int>((v - a) * kOne + 0.5);
}

// One block per output row. The two passes of the host (a horizontal
// blend of rows y0 and y1, then the vertical one) are exact integers,
// so computing both per output pixel gives the host's values.
__global__ void resize_bilinear_kernel(const uint8_t* __restrict__ src, int sw,
                                       int sh, uint8_t* __restrict__ dst,
                                       int pitch, int dw, int dh) {
  const int y = blockIdx.x;
  int y0, y1, fy;
  bilinear_axis(y, static_cast<double>(sh) / dh, sh, &y0, &y1, &fy);
  const int gy = kOne - fy;
  const double sx = static_cast<double>(sw) / dw;
  const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * 3;
  const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * 3;
  uint8_t* out = dst + static_cast<size_t>(y) * pitch;
  for (int x = threadIdx.x; x < dw; x += blockDim.x) {
    int x0, x1, fx;
    bilinear_axis(x, sx, sw, &x0, &x1, &fx);
    const int gx = kOne - fx;
    for (int c = 0; c < 3; ++c) {
      const int h0 = r0[x0 * 3 + c] * gx + r0[x1 * 3 + c] * fx;
      const int h1 = r1[x0 * 3 + c] * gx + r1[x1 * 3 + c] * fx;
      const int v = h0 * gy + h1 * fy + (1 << (2 * kBits - 1));
      out[x * 3 + c] = static_cast<uint8_t>(v >> (2 * kBits));
    }
  }
}

// The float resampler's horizontal pass: source row y -> tmp row y.
__global__ void resample_rows(const uint8_t* __restrict__ src, int sw,
                              float* __restrict__ tmp, int dw,
                              const int* __restrict__ first,
                              const float* __restrict__ w, int sup) {
  const int y = blockIdx.x;
  const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
  float* trow = tmp + static_cast<size_t>(y) * dw * 3;
  for (int x = threadIdx.x; x < dw; x += blockDim.x) {
    float a0 = 0, a1 = 0, a2 = 0;
    const float* wr = w + static_cast<size_t>(x) * sup;
    for (int t = 0; t < sup; ++t) {
      int s = first[x] + t;
      if (s < 0) s = 0;
      if (s > sw - 1) s = sw - 1;
      const uint8_t* p = srow + s * 3;
      const float g = wr[t];
      a0 += g * p[0];
      a1 += g * p[1];
      a2 += g * p[2];
    }
    trow[x * 3 + 0] = a0;
    trow[x * 3 + 1] = a1;
    trow[x * 3 + 2] = a2;
  }
}

// The vertical pass: tmp -> output row y, +0.5, clamped, truncated.
__global__ void resample_cols(const float* __restrict__ tmp, int sh, int dw,
                              uint8_t* __restrict__ dst, int pitch,
                              const int* __restrict__ first,
                              const float* __restrict__ w, int sup) {
  const int y = blockIdx.x;
  const float* wr = w + static_cast<size_t>(y) * sup;
  uint8_t* out = dst + static_cast<size_t>(y) * pitch;
  for (int i = threadIdx.x; i < dw * 3; i += blockDim.x) {
    float acc = 0;
    for (int t = 0; t < sup; ++t) {
      int s = first[y] + t;
      if (s < 0) s = 0;
      if (s > sh - 1) s = sh - 1;
      acc += wr[t] * tmp[static_cast<size_t>(s) * dw * 3 + i];
    }
    const float v = acc + 0.5f;
    out[i] = v <= 0 ? 0 : (v >= 255.0f ? 255 : static_cast<uint8_t>(v));
  }
}

// The fill of one (rows, cols, 3) slot, one block a row: zero outside
// the (h, w) image at (top, left); inside, a copy of src, or nothing when
// src is null (a resize kernel writes it).
__global__ void place_kernel(const uint8_t* __restrict__ src, int h, int w,
                             uint8_t* __restrict__ dst, int cols, int top,
                             int left) {
  const int y = blockIdx.x;
  uint8_t* row = dst + static_cast<size_t>(y) * cols * 3;
  const bool in_rows = y >= top && y < top + h;
  const uint8_t* srow =
      in_rows && src ? src + static_cast<size_t>(y - top) * w * 3 : nullptr;
  for (int i = threadIdx.x; i < cols * 3; i += blockDim.x) {
    const int x = i / 3;
    if (in_rows && x >= left && x < left + w) {
      if (srow) row[i] = srow[i - left * 3];
    } else {
      row[i] = 0;
    }
  }
}

struct Decoder {
  nvjpegHandle_t handle;
  nvjpegJpegState_t state;
};

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// Planar Y (h, w) and Cb, Cr (ch, cw), subsampled (hs, vs) in (1, 1),
// (2, 1) or (2, 2), into interleaved RGB (or BGR) rows `pitch` apart.
int ic_ycc_rgb(const uint8_t* yp, int ypitch, const uint8_t* cb,
               const uint8_t* cr, int cpitch, int cw, int ch, int w, int h,
               int hs, int vs, int bgr, uint8_t* dst, int pitch,
               cudaStream_t stream) {
  ycc_rgb_kernel<<<h, kThreads, 0, stream>>>(yp, ypitch, cb, cr, cpitch,
                                                  cw, ch, w, hs, vs, bgr, dst,
                                                  pitch);
  return launched();
}

int ic_resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst,
                       int pitch, int dw, int dh, cudaStream_t stream) {
  resize_bilinear_kernel<<<dh, kThreads, 0, stream>>>(src, sw, sh, dst, pitch,
                                                      dw, dh);
  return launched();
}

// Two launches: rows into `tmp` (sh, dw, 3) f32, then columns into dst.
int ic_resize_generic(const uint8_t* src, int sw, int sh, uint8_t* dst,
                      int pitch, int dw, int dh, const int* fx,
                      const float* wx, int sup_x, const int* fy,
                      const float* wy, int sup_y, float* tmp,
                      cudaStream_t stream) {
  resample_rows<<<sh, kThreads, 0, stream>>>(src, sw, tmp, dw, fx, wx, sup_x);
  int err = launched();
  if (err) return err;
  resample_cols<<<dh, kThreads, 0, stream>>>(tmp, sh, dw, dst, pitch, fy, wy,
                                             sup_y);
  return launched();
}

int ic_place(const uint8_t* src, int h, int w, uint8_t* dst, int rows, int cols,
             int top, int left, cudaStream_t stream) {
  place_kernel<<<rows, kThreads, 0, stream>>>(src, h, w, dst, cols, top, left);
  return launched();
}

// One decode thread's nvJPEG handle and state (default backend); null
// with *status set when nvJPEG refuses.
void* ic_decoder_create(int* status) {
  Decoder* d = new Decoder();
  nvjpegStatus_t s = nvjpegCreateSimple(&d->handle);
  if (s == NVJPEG_STATUS_SUCCESS) {
    s = nvjpegJpegStateCreate(d->handle, &d->state);
    if (s != NVJPEG_STATUS_SUCCESS) nvjpegDestroy(d->handle);
  }
  *status = static_cast<int>(s);
  if (s != NVJPEG_STATUS_SUCCESS) {
    delete d;
    return nullptr;
  }
  return d;
}

void ic_decoder_destroy(void* p) {
  Decoder* d = static_cast<Decoder*>(p);
  nvjpegJpegStateDestroy(d->state);
  nvjpegDestroy(d->handle);
  delete d;
}

// The header's size and component count, and for a 3-component 4:4:4,
// 4:2:2 or 4:2:0 JPEG its chroma subsampling (*hs, *vs) and chroma plane
// size (*cw, *ch) (else *hs = *vs = 0: nvJPEG's interleaved output).
int ic_image_info(void* p, const uint8_t* data, size_t len, int* w, int* h,
                  int* components, int* hs, int* vs, int* cw, int* ch) {
  Decoder* d = static_cast<Decoder*>(p);
  int widths[NVJPEG_MAX_COMPONENT] = {}, heights[NVJPEG_MAX_COMPONENT] = {};
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  *components = 0;
  nvjpegStatus_t s = nvjpegGetImageInfo(d->handle, data, len, components, &css,
                                        widths, heights);
  *w = widths[0];
  *h = heights[0];
  *hs = *vs = 0;
  if (s == NVJPEG_STATUS_SUCCESS && *components == 3) {
    if (css == NVJPEG_CSS_444) *hs = *vs = 1;
    if (css == NVJPEG_CSS_422) *hs = 2, *vs = 1;
    if (css == NVJPEG_CSS_420) *hs = *vs = 2;
  }
  *cw = widths[1];
  *ch = heights[1];
  if (*hs && (widths[2] != *cw || heights[2] != *ch ||
              *cw != (*w + *hs - 1) / *hs || *ch != (*h + *vs - 1) / *vs))
    *hs = *vs = 0;
  return static_cast<int>(s);
}

// Decode into dst, interleaved RGB (or BGR), rows `pitch` bytes apart, on
// `stream`. The host part (the entropy decode) runs in this call.
int ic_decode(void* p, const uint8_t* data, size_t len, int bgr, uint8_t* dst,
              int pitch, cudaStream_t stream) {
  Decoder* d = static_cast<Decoder*>(p);
  nvjpegImage_t img = {};
  img.channel[0] = dst;
  img.pitch[0] = static_cast<size_t>(pitch);
  nvjpegStatus_t s = nvjpegDecode(d->handle, d->state, data, len,
                                  bgr ? NVJPEG_OUTPUT_BGRI : NVJPEG_OUTPUT_RGBI,
                                  &img, stream);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  const int err = launched();
  return err ? 1000 + err : 0;
}

// Decode into planar Y (rows `ypitch` apart) and Cb, Cr (rows `cpitch`
// apart) at the JPEG's own subsampling, on `stream`.
int ic_decode_planes(void* p, const uint8_t* data, size_t len, uint8_t* yp,
                     int ypitch, uint8_t* cb, uint8_t* cr, int cpitch,
                     cudaStream_t stream) {
  Decoder* d = static_cast<Decoder*>(p);
  nvjpegImage_t img = {};
  img.channel[0] = yp;
  img.channel[1] = cb;
  img.channel[2] = cr;
  img.pitch[0] = static_cast<size_t>(ypitch);
  img.pitch[1] = img.pitch[2] = static_cast<size_t>(cpitch);
  nvjpegStatus_t s = nvjpegDecode(d->handle, d->state, data, len,
                                  NVJPEG_OUTPUT_YUV, &img, stream);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  const int err = launched();
  return err ? 1000 + err : 0;
}

// Whether an nvJPEG status means the bytes are not a JPEG that nvJPEG
// reads (their file then goes through cv2), rather than a fault.
int ic_undecodable(int status) {
  switch (static_cast<nvjpegStatus_t>(status)) {
    case NVJPEG_STATUS_BAD_JPEG:
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED:
    case NVJPEG_STATUS_INCOMPLETE_BITSTREAM:
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED:
      return 1;
    default:
      return 0;
  }
}

}  // extern "C"
