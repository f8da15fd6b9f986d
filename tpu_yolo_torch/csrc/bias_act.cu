// Bias, activation and residual of a folded convolution, in one pass, for
// Hopper.
//
// Replaces no TPU kernel: on the TPU, XLA fuses a convolution's bias, SiLU
// and residual add into the convolution's output. On the card PyTorch runs
// a float convolution through cuDNN without its bias, then adds the bias
// (`output.add_(bias.view(1, C, 1, 1))`), applies the activation and adds
// the residual, three elementwise kernels that each read and write the
// whole map. This kernel is those three in one:
//
//   out[n, h, w, c] = r[n, h, w, c] + s[c] * act(bf16(y[n, h, w, c] + b[c]))
//
// y is the convolution's output without its bias, NHWC and contiguous
// (channels_last); b is the bias in y's type; act is SiLU or the identity;
// s, optional, is a per-channel scale of the activated output in y's type
// (YOLO12's layer scale, which follows the activation and so cannot be
// folded into the convolution); r, optional, is a residual in NHWC order whose pixels lie `r_stride`
// elements apart (a `chunk` slice of channels needs no copy); out is NHWC
// and contiguous; or, given out2, the channels are split in two halves,
// out and out2, each NHWC and contiguous (the halves that a C3k2 or PSA
// block takes of its first conv's output: the convs that read one then
// need no copy of it). Types: bf16 or f32, all alike.
//
// Bit-equal to PyTorch's three (four) kernels: each step is computed in f32
// and rounded to the type as PyTorch's TensorIterator rounds it, in its
// order: v = float(y) + float(b), rounded; SiLU as v / (1 + expf(-v)) in f32
// (expf, not __expf: PyTorch builds without fast math), rounded; float(s) *
// that, rounded; then float(r) + that, rounded. The scale's product is
// __fmul_rn, which the compiler never contracts with the residual's add
// into an FMA (in f32 nothing rounds between them).
//
// Bound on the H100: bytes. y and r are read once and out written once
// (the bias, C values, stays in L1); v11-x's serving batch of 128 moves
// 71.2 GB through it, 21.3 ms at 3.35 TB/s. What the design does about it:
//   * 16-byte loads and stores (8 bf16 or 4 f32) where C times the element
//     size is a multiple of 16 (of 32 for two halves) and y, b, s, r, the
//     outputs and r's pixel stride are 16-byte aligned; one element at a
//     time otherwise (a head with one class). The host function picks the
//     form from what it is given;
//   * a grid-stride loop over (pixel, vector of channels) with as many
//     blocks of 512 threads as the SMs hold at once (the occupancy the
//     compiler's registers allow: 1,024-2,048 threads an SM); the pixel
//     and channel of a vector are advanced by additions, so the loop
//     divides nothing. Over a whole v11-x batch's 173 maps the pass runs
//     at about 80% of 3.35 TB/s, where a copy's mix of reads and writes
//     levels off on the card: unrolling 2-8 vectors a thread, 128-512
//     threads a block, streaming loads or stores and a grid of one pass
//     all measured within 26.4-27.6 ms against the 21.25 ms bound
//     (PERF.md, section 6);
//   * a map with no elements (a spatial rank that holds no row) launches
//     nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int IDENTITY = 0, SILU = 1;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N elements of T, moved as one load or store of N * sizeof(T) bytes.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int ACT, bool RES, bool SCALE>
__device__ __forceinline__ T epilogue(T y, T b, T r, T s) {
  float v = widen(narrow<T>(widen(y) + widen(b)));
  if (ACT == SILU) v = v / (1.0f + expf(-v));
  if (SCALE) v = __fmul_rn(widen(s), widen(narrow<T>(v)));
  if (!RES) return narrow<T>(v);
  return narrow<T>(widen(r) + widen(narrow<T>(v)));
}

// `vectors` = pixels * cv packs of N elements; pack i is pixel i / cv,
// channels (i % cv) * N onward. With HALVES the packs of channels C/2
// onward go to out2.
template <typename T, int N, int ACT, bool RES, bool HALVES, bool SCALE>
__global__ void __launch_bounds__(THREADS) bias_act_kernel(
    const T* __restrict__ y, const T* __restrict__ b, const T* __restrict__ r,
    const T* __restrict__ s, T* __restrict__ out, T* __restrict__ out2, long long vectors,
    int cv, long long r_stride) {
  using P = Pack<T, N>;
  const P* y_p = reinterpret_cast<const P*>(y);
  const P* b_p = reinterpret_cast<const P*>(b);
  const P* s_p = reinterpret_cast<const P*>(s);
  P* out_p = reinterpret_cast<P*>(out);
  P* out2_p = reinterpret_cast<P*>(out2);
  const long long step = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long pixel = i / cv;
  int c = (int)(i - pixel * cv);
  const long long step_pixels = step / cv;
  const int step_c = (int)(step - step_pixels * cv);
  for (; i < vectors; i += step) {
    const P yv = y_p[i];
    const P bv = b_p[c];
    P rv = yv, sv = yv;
    if (RES) rv = *reinterpret_cast<const P*>(r + pixel * r_stride + (long long)c * N);
    if (SCALE) sv = s_p[c];
    P o;
#pragma unroll
    for (int e = 0; e < N; ++e)
      o.v[e] = epilogue<T, ACT, RES, SCALE>(yv.v[e], bv.v[e], rv.v[e], sv.v[e]);
    if (HALVES) {
      const int half = cv / 2;
      if (c < half)
        out_p[pixel * half + c] = o;
      else
        out2_p[pixel * half + (c - half)] = o;
    } else {
      out_p[i] = o;
    }
    pixel += step_pixels;
    c += step_c;
    if (c >= cv) {
      c -= cv;
      ++pixel;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return -1;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  if (dev < 64) cached[dev] = sms;
  return sms;
}

template <typename T, int N, int ACT, bool RES, bool HALVES, bool SCALE>
int launch(const void* y, const void* b, const void* r, const void* sc, void* out, void* out2,
           long long pixels, int c, long long r_stride, cudaStream_t stream) {
  // as many blocks as the card holds at once, no more than the work needs
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bias_act_kernel<T, N, ACT, RES, HALVES, SCALE>, THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  const long long vectors = pixels * (c / N);
  const long long want = (vectors + THREADS - 1) / THREADS;
  const long long most = (long long)sms * per_sm;
  bias_act_kernel<T, N, ACT, RES, HALVES, SCALE>
      <<<(int)(want < most ? want : most), THREADS, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(b), static_cast<const T*>(r),
      static_cast<const T*>(sc), static_cast<T*>(out), static_cast<T*>(out2), vectors, c / N,
      r_stride);
  return static_cast<int>(cudaGetLastError());
}

// a scale comes with one output map (the caller refuses it with halves)
template <typename T, int N, int ACT>
int dispatch_act(const void* y, const void* b, const void* r, const void* sc, void* out,
                 void* out2, long long pixels, int c, long long r_stride, cudaStream_t s) {
  if (sc)
    return r ? launch<T, N, ACT, true, false, true>(y, b, r, sc, out, out2, pixels, c, r_stride, s)
             : launch<T, N, ACT, false, false, true>(y, b, r, sc, out, out2, pixels, c, r_stride,
                                                     s);
  if (r)
    return out2
               ? launch<T, N, ACT, true, true, false>(y, b, r, sc, out, out2, pixels, c, r_stride, s)
               : launch<T, N, ACT, true, false, false>(y, b, r, sc, out, out2, pixels, c, r_stride,
                                                       s);
  return out2
             ? launch<T, N, ACT, false, true, false>(y, b, r, sc, out, out2, pixels, c, r_stride, s)
             : launch<T, N, ACT, false, false, false>(y, b, r, sc, out, out2, pixels, c, r_stride,
                                                      s);
}

template <typename T, int N>
int dispatch(const void* y, const void* b, const void* r, const void* sc, void* out, void* out2,
             long long pixels, int c, long long r_stride, int act, cudaStream_t s) {
  return act == SILU
             ? dispatch_act<T, N, SILU>(y, b, r, sc, out, out2, pixels, c, r_stride, s)
             : dispatch_act<T, N, IDENTITY>(y, b, r, sc, out, out2, pixels, c, r_stride, s);
}

}  // namespace

// 1 where the pass moves 16-byte vectors for these arguments, 0 where it
// moves one element at a time.
extern "C" int bias_act_form(const void* y, const void* b, const void* r, const void* sc,
                             const void* out, const void* out2, int c, long long r_stride,
                             int is_bf16) {
  const long long size = is_bf16 ? 2 : 4;
  return (c * size) % (out2 ? 32 : 16) == 0 && aligned16(y) && aligned16(b) &&
         (sc == nullptr || aligned16(sc)) && aligned16(out) &&
         (out2 == nullptr || aligned16(out2)) &&
         (r == nullptr || (aligned16(r) && (r_stride * size) % 16 == 0));
}

// y: (pixels, c) contiguous; b: (c,); r: null or (pixels, c) with its
// pixels r_stride elements apart; sc: null or (c,); out: (pixels, c)
// contiguous, or, with out2 not null (c even, sc null), out and out2
// (pixels, c / 2) each, the first and the second half of the channels; act
// 0 (identity) or 1 (SiLU); all bf16 (is_bf16 != 0) or all f32. Launches on
// `stream` (nothing where pixels * c is 0) and returns the launch's CUDA
// error, 0 if none.
extern "C" int bias_act(const void* y, const void* b, const void* r, const void* sc, void* out,
                        void* out2, long long pixels, int c, long long r_stride, int act,
                        int is_bf16, void* stream) {
  if (pixels <= 0 || c <= 0) return 0;
  if ((act != IDENTITY && act != SILU) || (out2 && (c % 2 || sc)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = bias_act_form(y, b, r, sc, out, out2, c, r_stride, is_bf16);
  if (is_bf16)
    return vec ? dispatch<__nv_bfloat16, 8>(y, b, r, sc, out, out2, pixels, c, r_stride, act, s)
               : dispatch<__nv_bfloat16, 1>(y, b, r, sc, out, out2, pixels, c, r_stride, act, s);
  return vec ? dispatch<float, 4>(y, b, r, sc, out, out2, pixels, c, r_stride, act, s)
             : dispatch<float, 1>(y, b, r, sc, out, out2, pixels, c, r_stride, act, s);
}
