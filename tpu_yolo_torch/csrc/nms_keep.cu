// Exact sorted-greedy NMS keep mask for Hopper: one fused kernel, one block
// per image, nothing but the inputs and the keep mask in device memory.
//
// Replaces the TPU kernel tpu_yolo/ops/nms_pallas.py::greedy_keep_pallas
// (_nms_keep_kernel). The TPU kernel builds a (K, K) bf16 suppression mask
// in VMEM and iterates keep = valid ∧ ¬any(mask·keep) to its fixpoint with
// matrix-vector products. Its result is the sequential greedy solution,
// which is unique because suppression only flows from a higher rank to a
// lower one. Here a block copies its image's boxes and classes into shared
// memory (26 bytes a candidate with the words below: 27 KB at K=1024,
// 213 KB at K=8192) and walks the candidates in rank order, 32 at a time,
// with a "removed" bitset in shared memory:
//   0. before the walk: (a) diag[i], which candidates of i's own 32-chunk
//      would suppress i, for every valid i (one warp a chunk, one lane a
//      victim); (b) the valid candidates in the order of a counting sort
//      by class (mod 64), cut into words of 32 with a 64-bit set of each
//      word's classes. Both depend on the inputs only, so they are off the
//      chain of dependent steps.
//   1. one warp settles chunk c: lane i holds diag[c·32+i], and
//      keep = alive ∧ ¬{i : diag[i] ∧ keep} is iterated with a ballot a
//      round to its fixpoint, two or three rounds for most chunks; a chunk
//      with a longer chain of suppressions is settled rank by rank.
//   2. only the kept candidates of the chunk (at most 32) are tested, only
//      against candidates of later chunks that are not yet removed, one
//      thread a victim, one warp a class-sorted word of victims; the hits
//      are OR-ed into the bitset. With every warp of the block at work the
//      walk is bound by the instructions of these tests, so a kept
//      candidate is tested against a word only if its class occurs there
//      (one ballot against the word's set: a sorted word holds one or two
//      classes, so most drop out), four tests are unrolled side by side
//      without a branch between them, and the division runs only where a
//      pair of one class overlaps. The all-invalid tail of the image is
//      never walked.
//   3. two block barriers a chunk, around the settling of the next one.
// IoU tests fall from K²/2 an image to about (kept candidates) x (live
// later candidates), and a step of the chain touches shared memory only.
//
// Bit-identical IoU: the f32 operations are those of tpu_yolo/ops/nms.py::
// _pair_iou_mask, in its order, ((area_a + area_b) - inter) + 1e-12, each
// rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn; the file is
// also compiled with -fmad=false), and compared with thr as a float. A
// contracted FMA would flip IoUs that sit at thr.
//
// Bound on the H100: inputs and output are 22 bytes a candidate, 2.9 MB at
// B=128, K=1024 (0.9 us at 3.35 TB/s). What the byte bound does not see is
// the chain: K/32 dependent steps an image, each two barriers, a few
// ballots and the pair tests of the chunk's kept candidates, with the
// images of a batch in parallel, one per SM. Measured times: PERF.md, section 6.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float clip0(float x) { return fmaxf(x, 0.f); }

__device__ __forceinline__ float box_area(const float4& b) {
  return __fmul_rn(clip0(__fsub_rn(b.z, b.x)), clip0(__fsub_rn(b.w, b.y)));
}

constexpr int GROUP = 4;  // killers tested side by side against one 32-victim word

// The next GROUP set bits of `rel` (bit t: candidate base + t), taken out of
// it: their indices in j (base where there are fewer) and a bit each in the
// returned mask.
__device__ __forceinline__ uint32_t take_group(uint32_t& rel, int base, int (&j)[GROUP]) {
  uint32_t active = 0u;
#pragma unroll
  for (int e = 0; e < GROUP; ++e) {
    j[e] = base + (rel ? __ffs(rel) - 1 : 0);
    if (rel) active |= 1u << e;
    rel &= rel - 1;
  }
  return active;
}

// Which of the killers j[0..GROUP) (those with their bit in `active`)
// suppress this lane's victim: box b, class cb, rank i, `live` if it is
// to be tested at all. A killer suppresses only later ranks. The GROUP
// intersections are unrolled side by side with no branch between them, so
// their shared-memory loads and arithmetic overlap. Few pairs of one class
// overlap at all, so the areas and the division come after a warp-wide
// vote, and there each lane takes its own next overlapping killer, so a
// round serves up to 32 different pairs; where the intersection is zero
// the quotient is exactly zero. With ALL, every suppressor gets its bit;
// without, a lane stops at its first. Every lane of the warp must call it.
template <bool ALL>
__device__ __forceinline__ uint32_t suppressors(const float4* sbox, const int* scls,
                                                const int (&j)[GROUP], uint32_t active,
                                                const float4& b, int cb, int i, bool live,
                                                float thr) {
  float inter[GROUP];
  uint32_t overlap = 0u, hits = 0u;
#pragma unroll
  for (int e = 0; e < GROUP; ++e) {
    const float4 a = sbox[j[e]];
    const float iw = clip0(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)));
    const float ih = clip0(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)));
    inter[e] = __fmul_rn(iw, ih);
    const bool same = live && ((active >> e) & 1u) && i > j[e] && scls[j[e]] == cb;
    if (same && inter[e] > 0.f) overlap |= 1u << e;
    if (same && !(inter[e] > 0.f) && 0.f > thr) hits |= 1u << e;
  }
  if (!ALL && hits) overlap = 0u;
  if (__any_sync(FULL, overlap != 0u)) {
    const float area_b = box_area(b);
    do {
      if (overlap) {
        const int e = __ffs(overlap) - 1;
        overlap &= overlap - 1;
        int je = j[0];
        float ie = inter[0];
#pragma unroll
        for (int x = 1; x < GROUP; ++x) {
          if (e == x) {
            je = j[x];
            ie = inter[x];
          }
        }
        const float denom =
            __fadd_rn(__fsub_rn(__fadd_rn(box_area(sbox[je]), area_b), ie), 1e-12f);
        if (__fdiv_rn(ie, denom) > thr) {
          hits |= 1u << e;
          if (!ALL) overlap = 0u;
        }
      }
    } while (__any_sync(FULL, overlap != 0u));
  }
  return hits;
}

__global__ void __launch_bounds__(MAX_THREADS) nms_keep_kernel(
    const float4* __restrict__ boxes, const int* __restrict__ cls,
    const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_chunks;  // chunks up to the last one with a valid candidate
  __shared__ int n_valid;
  __shared__ int bucket[64];  // the counting sort's counts, then offsets
  const int words = (k + 31) >> 5;
  const int kp = words * 32;
  float4* sbox = reinterpret_cast<float4*>(smem);          // [kp]
  int* scls = reinterpret_cast<int*>(sbox + kp);           // [kp]
  uint32_t* diag = reinterpret_cast<uint32_t*>(scls + kp); // [kp]
  uint32_t* vbits = diag + kp;                             // [words]
  uint32_t* removed = vbits + words;                       // [words]
  uint32_t* kept = removed + words;                        // [words]
  uint2* clsset = reinterpret_cast<uint2*>(kept + words + (words & 1));  // [words]
  uint16_t* perm = reinterpret_cast<uint16_t*>(clsset + words);          // [kp]

  const size_t base = (size_t)blockIdx.x * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  if (threadIdx.x == 0) n_chunks = 0;
  for (int x = threadIdx.x; x < 64; x += blockDim.x) bucket[x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < kp; i += blockDim.x) {  // whole warps: kp % 32 == 0
    const bool in = i < k;
    sbox[i] = in ? boxes[base + i] : make_float4(0.f, 0.f, 0.f, 0.f);
    const int ci = in ? cls[base + i] : -1;
    scls[i] = ci;
    const bool live = in && valid[base + i] != 0;
    const uint32_t bits = __ballot_sync(FULL, live);
    if (live) atomicAdd(&bucket[ci & 63], 1);
    if (lane == 0) {
      vbits[i >> 5] = bits;
      removed[i >> 5] = 0u;
      kept[i >> 5] = 0u;
      if (bits) atomicMax(&n_chunks, (i >> 5) + 1);
    }
  }
  __syncthreads();
  const int n = n_chunks;

  // The valid candidates in the order of a counting sort by (class mod 64):
  // perm[] lists their ranks, 0xffff past the last. The walk takes its
  // victims from this list, 32 at a time, so that a word of victims holds
  // one or two classes and most kept candidates have none of theirs in it.
  if (warp == 0) {
    const int c0 = bucket[lane], c1 = bucket[lane + 32];
    int s0 = c0, s1 = c1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u0 = __shfl_up_sync(FULL, s0, off), u1 = __shfl_up_sync(FULL, s1, off);
      if (lane >= off) {
        s0 += u0;
        s1 += u1;
      }
    }
    const int t0 = __shfl_sync(FULL, s0, 31);
    bucket[lane] = s0 - c0;
    bucket[lane + 32] = t0 + s1 - c1;
    if (lane == 31) n_valid = t0 + s1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kp; i += blockDim.x) {
    if ((vbits[i >> 5] >> (i & 31)) & 1u) perm[atomicAdd(&bucket[scls[i] & 63], 1)] = i;
  }
  __syncthreads();
  const int pwords = (n_valid + 31) >> 5;
  for (int u = warp; u < pwords; u += nwarps) {
    const int at = u * 32 + lane;
    const bool live = at < n_valid;
    if (!live) perm[at] = 0xffffu;
    // the word's classes as a set of (class mod 64)
    const int h = scls[live ? perm[at] : 0] & 63;
    const uint32_t lo = __reduce_or_sync(FULL, live && h < 32 ? 1u << h : 0u);
    const uint32_t hi = __reduce_or_sync(FULL, live && h >= 32 ? 1u << (h - 32) : 0u);
    if (lane == 0) clsset[u] = make_uint2(lo, hi);
  }

  // 0. diagonal words, one warp a chunk, one lane a victim: diag[i] has a
  // bit for each candidate of i's chunk that would suppress i. Only a
  // candidate with a later valid one of its class in the chunk can kill.
  for (int cc = warp; cc < n; cc += nwarps) {
    const uint32_t vw = vbits[cc];
    const int i = cc * 32 + lane;
    const float4 b = sbox[i];
    const int cb = scls[i];
    const bool live = (vw >> lane) & 1u;
    const uint32_t peers = __match_any_sync(FULL, cb) & vw;
    uint32_t rel = __ballot_sync(FULL, live && (peers >> lane) > 1u);
    uint32_t killers = 0u;
    while (rel) {
      int j[GROUP];
      const uint32_t active = take_group(rel, cc * 32, j);
      const uint32_t hits = suppressors<true>(sbox, scls, j, active, b, cb, i, live, thr);
#pragma unroll
      for (int e = 0; e < GROUP; ++e)
        if ((hits >> e) & 1u) killers |= 1u << (j[e] & 31);
    }
    diag[i] = killers;
  }
  __syncthreads();

  // 1. one warp settles a chunk: keep = alive & ~{i : diag[i] & keep}, iterated
  // with a ballot a round; its fixpoint is the greedy solution and most
  // chunks reach it in two or three rounds. A chunk with a long chain (a
  // suppresses b, b would have suppressed c, ...) needs a round a link, so
  // after three rounds the 32 ranks are settled one by one instead, each
  // lane running the same short chain on the chunk's 32 words.
  auto settle = [&](int c) {
    const uint32_t alive = vbits[c] & ~removed[c];
    const uint32_t killers = diag[c * 32 + lane];
    const bool mine = (alive >> lane) & 1u;
    uint32_t kw = alive;
    bool settled = false;
    for (int round = 0; round < 3 && !settled; ++round) {
      const uint32_t next = __ballot_sync(FULL, mine && !(killers & kw));
      settled = next == kw;
      kw = next;
    }
    if (!settled) {
      const uint4* words = reinterpret_cast<const uint4*>(diag + c * 32);
      uint32_t of[32];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 x = words[q];
        of[4 * q] = x.x;
        of[4 * q + 1] = x.y;
        of[4 * q + 2] = x.z;
        of[4 * q + 3] = x.w;
      }
      kw = 0u;
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (((alive >> r) & 1u) && !(of[r] & kw)) kw |= 1u << r;
    }
    if (lane == 0) kept[c] = kw;
  };
  if (warp == 0 && n > 0) settle(0);
  __syncthreads();

  for (int c = 0; c < n; ++c) {
    // 2. the chunk's kept candidates against the later live ones, one warp a
    // word of 32 class-sorted victims. One ballot picks the kept candidates
    // whose class is in the word's set: most are not, and cost nothing more.
    const uint32_t kw = kept[c];
    if (kw) {
      const int kh = scls[c * 32 + lane] & 63;  // this lane's candidate of chunk c
      const int first = (c + 1) * 32;           // the first rank of a later chunk
      for (int u = warp; u < pwords; u += nwarps) {
        const uint2 set = clsset[u];
        uint32_t rel = __ballot_sync(
            FULL, ((kw >> lane) & 1u) && (((kh < 32 ? set.x >> kh : set.y >> (kh - 32))) & 1u));
        if (!rel) continue;
        const int at = perm[u * 32 + lane];
        const int i = at == 0xffff ? 0 : at;
        const bool live =
            at != 0xffff && i >= first && !((removed[i >> 5] >> (i & 31)) & 1u);
        if (!__any_sync(FULL, live)) continue;
        const float4 b = sbox[i];
        const int cb = scls[i];
        uint32_t hits = 0u;
        while (rel) {
          int j[GROUP];
          const uint32_t active = take_group(rel, c * 32, j);
          hits |= suppressors<false>(sbox, scls, j, active, b, cb, i, live && !hits, thr);
        }
        if (hits) atomicOr(&removed[i >> 5], 1u << (i & 31));
      }
    }
    __syncthreads();  // removed[c + 1] is final
    if (warp == 0 && c + 1 < n) settle(c + 1);
    __syncthreads();  // 3. kept[c + 1] is written
  }

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    keep[base + i] = (kept[i >> 5] >> (i & 31)) & 1u;
  }
}

}  // namespace

// boxes (b, k, 4) f32 xyxy, score-descending; cls (b, k) i32; valid (b, k)
// bool; keep (b, k) bool out. All contiguous, boxes 16-byte aligned,
// 1 <= k <= 8192 (the shared memory of one block holds an image). Launches
// on `stream` and returns the first CUDA error, 0 if none.
extern "C" int nms_greedy_keep(const void* boxes, const void* cls, const void* valid,
                               void* keep, int b, int k, float thr, void* stream) {
  const int words = (k + 31) / 32;
  const int kp = words * 32;
  const size_t smem = (size_t)kp * (16 + 4 + 4 + 2) + (size_t)words * (12 + 8) + 4;
  static size_t allowed = 48 * 1024;  // grows to the largest k seen
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  nms_keep_kernel<<<b, kp < MAX_THREADS ? kp : MAX_THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(cls),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}
