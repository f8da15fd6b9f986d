// Exact sorted-greedy NMS keep mask for Hopper.
//
// Replaces the TPU kernel tpu_yolo/ops/nms_pallas.py::greedy_keep_pallas
// (_nms_keep_kernel). The TPU kernel builds a (K, K) bf16 suppression mask
// in VMEM and iterates keep = valid ∧ ¬any(mask·keep) to its fixpoint with
// matrix-vector products. Its result is the sequential greedy solution,
// which is unique because suppression only flows from a higher rank to a
// lower one. Here:
//   1. nms_mask_kernel writes the mask as bits, (B, K, ceil(K/32)) u32:
//      bit i of row j is IoU(j, i) > thr ∧ cls_j == cls_i ∧ j < i ∧ valid_j.
//      One warp computes one 32-victim word with one lane per victim (the
//      victims' boxes load coalesced) and packs it with a ballot.
//   2. nms_walk_kernel, one block per image, walks the rows in rank order
//      32 at a time with a "removed" bitset in shared memory: one thread
//      settles the 32 rows of a word from that word's diagonal entries,
//      then the block ORs the kept rows into the rest of the bitset.
//
// Bit-identical IoU: the f32 operations are those of tpu_yolo/ops/nms.py::
// _pair_iou_mask, in its order, ((area_a + area_b) - inter) + 1e-12, each
// rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn; the file is
// also compiled with -fmad=false), and compared with thr as a float. A
// contracted FMA would flip IoUs that sit at thr.
//
// Bound on the H100: the mask is about 14 f32 operations per same-class
// pair with a valid killer, about 1 GFLOP at B=128, K=1024 (15 us at the
// f32 rate); inputs and outputs are 3 MB. The walk is a chain of K/32
// dependent steps per image (loads of mask words and two block barriers
// each), so it is latency-bound; images run in parallel, one per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MASK_WARPS = 8;
constexpr int WALK_THREADS = 256;

__device__ __forceinline__ float clip0(float x) { return fmaxf(x, 0.f); }

__global__ void __launch_bounds__(MASK_WARPS * 32) nms_mask_kernel(
    const float4* __restrict__ boxes, const int* __restrict__ cls,
    const uint8_t* __restrict__ valid, uint32_t* __restrict__ mask, int k, int words,
    float thr) {
  const int j = blockIdx.x;  // killer
  const size_t base = (size_t)blockIdx.y * k;
  const int lane = threadIdx.x & 31;
  const bool vj = valid[base + j] != 0;
  const float4 a = boxes[base + j];
  const int cj = cls[base + j];
  const float area_a = __fmul_rn(clip0(__fsub_rn(a.z, a.x)), clip0(__fsub_rn(a.w, a.y)));
  uint32_t* row = mask + (base + j) * words;

  for (int w = threadIdx.x >> 5; w < words; w += MASK_WARPS) {
    const int i = w * 32 + lane;  // victim
    bool hit = false;
    if (vj && i > j && i < k && cls[base + i] == cj) {
      const float4 b = boxes[base + i];
      const float iw = clip0(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)));
      const float ih = clip0(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)));
      const float inter = __fmul_rn(iw, ih);
      const float area_b = __fmul_rn(clip0(__fsub_rn(b.z, b.x)), clip0(__fsub_rn(b.w, b.y)));
      const float denom = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-12f);
      hit = __fdiv_rn(inter, denom) > thr;
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) row[w] = bits;
  }
}

__global__ void __launch_bounds__(WALK_THREADS) nms_walk_kernel(
    const uint32_t* __restrict__ mask, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ keep, int k, int words) {
  extern __shared__ uint32_t removed[];
  __shared__ uint32_t kept_word;
  const size_t b = blockIdx.x;
  const uint32_t* mb = mask + b * k * words;
  const uint8_t* vb = valid + b * k;
  uint8_t* kb = keep + b * k;

  for (int w = threadIdx.x; w < words; w += WALK_THREADS) removed[w] = 0;
  for (int c = 0; c < words; ++c) {
    __syncthreads();  // removed[c] holds every earlier kept row's bits
    const int r0 = c * 32;
    const int n = min(32, k - r0);
    if (threadIdx.x == 0) {
      uint32_t diag[32];
      uint32_t vbits = 0;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        diag[t] = t < n ? mb[(size_t)(r0 + t) * words + c] : 0u;
        vbits |= (t < n && vb[r0 + t] != 0) ? (1u << t) : 0u;
      }
      uint32_t r = removed[c];
      uint32_t kw = 0;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if (((vbits & ~r) >> t) & 1u) {
          kw |= 1u << t;
          r |= diag[t];
        }
      }
      kept_word = kw;
    }
    __syncthreads();
    const uint32_t kw = kept_word;
    if (threadIdx.x < n) kb[r0 + threadIdx.x] = (kw >> threadIdx.x) & 1u;
    for (int w = c + 1 + threadIdx.x; w < words; w += WALK_THREADS) {
      uint32_t acc = 0;
      for (uint32_t bits = kw; bits; bits &= bits - 1) {
        acc |= mb[(size_t)(r0 + __ffs(bits) - 1) * words + w];
      }
      removed[w] |= acc;
    }
  }
}

}  // namespace

// boxes (b, k, 4) f32 xyxy, score-descending; cls (b, k) i32; valid (b, k)
// bool; mask scratch (b, k, ceil(k/32)) u32; keep (b, k) bool out. All
// contiguous, boxes 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int nms_greedy_keep(const void* boxes, const void* cls, const void* valid,
                               void* mask, void* keep, int b, int k, float thr,
                               void* stream) {
  const int words = (k + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(k, b), MASK_WARPS * 32, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(cls),
      static_cast<const uint8_t*>(valid), static_cast<uint32_t*>(mask), k, words, thr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_walk_kernel<<<b, WALK_THREADS, words * sizeof(uint32_t), s>>>(
      static_cast<const uint32_t*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, words);
  return static_cast<int>(cudaGetLastError());
}
