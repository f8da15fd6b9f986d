// Top-k selection mask of the task-aligned assigner, for Hopper.
//
// Replaces the TPU kernel tpu_yolo/ops/topk_pallas.py::topk_mask
// (_topk_mask_kernel). For each row of a (rows, A) f32 metric it marks the
// k largest entries, ties going to the lower index: k rounds of "largest
// value not yet taken, at its lowest index; take it". Only comparisons
// touch the values, so the mask is exact. -0.0 and +0.0 compare equal, as
// in the TPU kernel's `v == m`. A taken entry is set to -inf in the block's
// copy and stays a candidate at that value, as in the TPU kernel's
// where(ban, -inf, x): once everything left is -inf (a row shorter than k,
// or -inf inputs) the pick is index 0, which changes nothing when 0 is
// taken already. NaN is out of contract: the metric is a product of
// clipped finite terms.
//
// Bound on the H100: bytes. x is read once and the mask written once,
// 5 bytes per entry: 172 MB, about 0.05 ms at 3.35 TB/s, for
// (64, 64, 8400). What the design does about it:
//   * one block per row; the row is copied once into shared memory
//     (16-byte loads when A is a multiple of 4), so the k rounds never go
//     back to device memory. 33.6 KB at A=8400 lets six blocks share an SM;
//     above 48 KB the launch opts in to dynamic shared memory, up to the
//     227 KB a block can have (A <= 58,080; the wrapper refuses more);
//   * each thread keeps the (value, index) maximum of its strided share in
//     registers. A round reduces these pairs over the block, ordered by
//     value first and index second in every step (a warp shuffle, then the
//     eight warp results read by every thread), with one barrier a round
//     (the warp results are double-buffered). Only the thread whose share
//     held the winner scans again, so rounds 2..k cost one thread's pass
//     over A/256 entries instead of the block's pass over A;
//   * the mask row is zeroed with 16-byte stores at the start (when A is a
//     multiple of 16) and the k winners are set after the last round, so
//     each output byte is written once or twice, into the storage of the
//     bool tensor that the wrapper allocated.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// (v, i) ranks before (bv, bi): larger value, or equal value at a lower index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS) topk_mask_kernel(
    const float* __restrict__ x, uint8_t* __restrict__ out, int a, int k) {
  extern __shared__ __align__(16) float row[];
  __shared__ float warp_v[2][WARPS];
  __shared__ int warp_i[2][WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* src = x + (size_t)blockIdx.x * a;
  uint8_t* dst = out + (size_t)blockIdx.x * a;

  if ((a & 3) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* row4 = reinterpret_cast<float4*>(row);
    for (int i = tid; i < a / 4; i += THREADS) row4[i] = src4[i];
  } else {
    for (int i = tid; i < a; i += THREADS) row[i] = src[i];
  }
  if ((a & 15) == 0) {
    uint4* dst16 = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < a / 16; i += THREADS) dst16[i] = make_uint4(0, 0, 0, 0);
  } else {
    for (int i = tid; i < a; i += THREADS) dst[i] = 0;
  }
  __syncthreads();

  float best = -CUDART_INF_F;
  int best_i = INT_MAX;  // "nothing above -inf in my share"
  int mine = -1;         // thread r keeps round r's winner
  bool rescan = true;
  for (int r = 0; r < k; ++r) {
    if (rescan) {
      best = -CUDART_INF_F;
      best_i = INT_MAX;
      for (int i = tid; i < a; i += THREADS) {
        const float v = row[i];
        if (v > best) {  // ascending i: strict > keeps the lowest index
          best = v;
          best_i = i;
        }
      }
    }
    float v = best;
    int i = best_i;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (beats(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    const int buf = r & 1;
    if (lane == 0) {
      warp_v[buf][warp] = v;
      warp_i[buf][warp] = i;
    }
    // One barrier a round: round r+1 writes the other buffer, whose last
    // readers (round r-1) have all passed this barrier.
    __syncthreads();
    v = warp_v[buf][0];
    i = warp_i[buf][0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float ov = warp_v[buf][w];
      const int oi = warp_i[buf][w];
      if (beats(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    // Everything left is -inf: the lowest index at the maximum is 0.
    const int win = (i == INT_MAX) ? 0 : i;
    if (tid == r) mine = win;
    // Entry `win` is read by its owner only, so taking it needs no barrier.
    rescan = (win % THREADS) == tid;
    if (rescan) row[win] = -CUDART_INF_F;
  }
  // The zeros were stored before the first round's barrier, so these
  // stores come after them.
  if (mine >= 0) dst[mine] = 1;
}

}  // namespace

// x (rows, a) f32 and out (rows, a) bytes, both contiguous; 1 <= k <= 256;
// a * 4 bytes of dynamic shared memory. Returns the launch's CUDA error.
extern "C" int topk_mask(const void* x, void* out, int rows, int a, int k, void* stream) {
  const size_t smem = (size_t)a * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  topk_mask_kernel<<<rows, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(out), a, k);
  return static_cast<int>(cudaGetLastError());
}
