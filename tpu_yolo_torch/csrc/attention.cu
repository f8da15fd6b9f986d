// PSA attention for Hopper: out = softmax(q·kᵀ·scale)·v.
//
// Replaces the TPU kernel tpu_yolo/ops/attention_pallas.py::fused_attention
// (_attn_kernel). That kernel holds all of K and V in VMEM and takes a
// full-row softmax. Here K+V of one head at T=1600 in bf16 is 300 KB, more
// than the 227 KB of shared memory a block gets, so K/V stream through
// shared memory in tiles of 64 keys with a running (online) max and sum.
//
// Casts follow the TPU kernel: scores and the softmax in f32, each p
// rounded to v's type before the PV product, PV accumulated in f32, the
// output written in v's type. (p is rounded before it is normalized: the
// online form learns the row's sum only at the end.)
//
// Bound on the H100: at the serving shape (BH=256, T=400, dk=32, dh=64,
// bf16) the function moves 39 MB and does 7.9 GFLOP, so its bound is the
// memory (about 12 us), and the tensor cores must carry the products to
// approach it. The bf16 kernel runs both products as mma.sync m16n8k16
// tiles (bf16 in, f32 accumulate): four warps of 16 query rows each, with
// the QKᵀ accumulators reused in registers as the A operand of PV, so the
// scores never leave registers. K is kept row-major and V transposed in
// shared memory, padded so that the fragment loads are free of bank
// conflicts. The f32 kernel (tests, f32 serving) does its products with
// plain f32 FMAs, one query row per thread.
//
// Layout: q, k (BH, T, 32), v and out (BH, T, 64), contiguous, 16-byte
// aligned. One block per (bh, tile of 64 queries); the ragged edge of T is
// masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DK = 32;
constexpr int DH = 64;
constexpr int BQ = 64;   // queries per block
constexpr int BKV = 64;  // keys per shared-memory tile

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync), 4 warps x 16 query rows.
// ---------------------------------------------------------------------------

constexpr int WARPS = BQ / 16;
constexpr int KS_STRIDE = DK + 8;    // bf16 per K row in shared memory
constexpr int VT_STRIDE = BKV + 8;   // bf16 per transposed-V row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__global__ void __launch_bounds__(WARPS * 32) attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int t,
    float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[BKV * KS_STRIDE];  // [key][dim]
  __shared__ __align__(16) __nv_bfloat16 vt[DH * VT_STRIDE];   // [dim][key]

  const size_t bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;  // fragment row group, column pair
  const int row0 = blockIdx.y * BQ + warp * 16;
  const __nv_bfloat16* kb = k + bh * t * DK;
  const __nv_bfloat16* vb = v + bh * t * DH;

  // Q as A fragments: rows row0+g and row0+g+8, two k-steps of 16 dims
  uint32_t qa[2][4];
  {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + bh * t * DK);
    const int r_lo = row0 + g, r_hi = row0 + g + 8;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int col = (kk * 16 + 2 * c) / 2;  // in bf16 pairs
      qa[kk][0] = r_lo < t ? q32[(size_t)r_lo * (DK / 2) + col] : 0u;
      qa[kk][1] = r_hi < t ? q32[(size_t)r_hi * (DK / 2) + col] : 0u;
      qa[kk][2] = r_lo < t ? q32[(size_t)r_lo * (DK / 2) + col + 4] : 0u;
      qa[kk][3] = r_hi < t ? q32[(size_t)r_hi * (DK / 2) + col + 4] : 0u;
    }
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, rows g and g+8
  float l_lo = 0.f, l_hi = 0.f;              // this thread's share of the sums

  for (int k0 = 0; k0 < t; k0 += BKV) {
    __syncthreads();  // the previous tile is consumed
    // K tile: 64 keys x 32 dims, 16 bytes per copy, zero past t
    for (int e = threadIdx.x; e < BKV * DK / 8; e += WARPS * 32) {
      const int j = e / (DK / 8), d = (e % (DK / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + j < t) val = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + j) * DK + d);
      *reinterpret_cast<uint4*>(&ks[j * KS_STRIDE + d]) = val;
    }
    // V tile, transposed: vt[dim][key]
    for (int e = threadIdx.x; e < BKV * DH / 8; e += WARPS * 32) {
      const int j = e / (DH / 8), d = (e % (DH / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + j < t) val = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + j) * DH + d);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(d + i) * VT_STRIDE + j] = h[i];
    }
    __syncthreads();

    // S = Q Kᵀ: 16 rows x 64 keys per warp, as 8 accumulator tiles of 8 keys
    float s[BKV / 8][4];
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const uint32_t* krow = reinterpret_cast<const uint32_t*>(&ks[(n * 8 + g) * KS_STRIDE]);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_bf16(s[n], qa[kk], krow[kk * 8 + c], krow[kk * 8 + c + 4]);
    }

    float tmax_lo = -INFINITY, tmax_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + 2 * c + (i & 1);
        s[n][i] = key < t ? s[n][i] * scale : -INFINITY;
      }
      tmax_lo = fmaxf(tmax_lo, fmaxf(s[n][0], s[n][1]));
      tmax_hi = fmaxf(tmax_hi, fmaxf(s[n][2], s[n][3]));
    }
    // the four lanes of a quad hold one row between them
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      tmax_lo = fmaxf(tmax_lo, __shfl_xor_sync(0xffffffffu, tmax_lo, off));
      tmax_hi = fmaxf(tmax_hi, __shfl_xor_sync(0xffffffffu, tmax_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, tmax_lo), mn_hi = fmaxf(m_hi, tmax_hi);
    const float corr_lo = expf(m_lo - mn_lo), corr_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= corr_lo;
    l_hi *= corr_hi;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      acc[n][0] *= corr_lo;
      acc[n][1] *= corr_lo;
      acc[n][2] *= corr_hi;
      acc[n][3] *= corr_hi;
    }

    // P (rounded to bf16) as A fragments: keys 16kk..16kk+15 are the
    // accumulator tiles 2kk and 2kk+1
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h][0] = expf(s[2 * kk + h][0] - m_lo);
        p[h][1] = expf(s[2 * kk + h][1] - m_lo);
        p[h][2] = expf(s[2 * kk + h][2] - m_hi);
        p[h][3] = expf(s[2 * kk + h][3] - m_hi);
        l_lo += p[h][0] + p[h][1];
        l_hi += p[h][2] + p[h][3];
      }
      pa[kk][0] = pack_bf16(p[0][0], p[0][1]);
      pa[kk][1] = pack_bf16(p[0][2], p[0][3]);
      pa[kk][2] = pack_bf16(p[1][0], p[1][1]);
      pa[kk][3] = pack_bf16(p[1][2], p[1][3]);
    }

    // O += P V: B fragments from the transposed V tile
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const uint32_t* vrow = reinterpret_cast<const uint32_t*>(&vt[(n * 8 + g) * VT_STRIDE]);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        mma_bf16(acc[n], pa[kk], vrow[kk * 8 + c], vrow[kk * 8 + c + 4]);
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
  uint32_t* o32 = reinterpret_cast<uint32_t*>(out + bh * t * DH);
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int col = (n * 8 + 2 * c) / 2;
    if (r_lo < t)
      o32[(size_t)r_lo * (DH / 2) + col] = pack_bf16(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    if (r_hi < t)
      o32[(size_t)r_hi * (DH / 2) + col] = pack_bf16(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs, one query row per thread.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BQ) attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int t, float scale) {
  __shared__ float ks[BKV][DK];
  __shared__ float vs[BKV][DH];

  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * BQ + threadIdx.x;
  const bool live = row < t;
  const float* qb = q + bh * t * DK;
  const float* kb = k + bh * t * DK;
  const float* vb = v + bh * t * DH;

  float qr[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) qr[d] = live ? qb[(size_t)row * DK + d] : 0.f;

  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = -INFINITY;  // running row max of the scaled scores
  float l = 0.f;        // running sum of exp(s - m)

  for (int k0 = 0; k0 < t; k0 += BKV) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < BKV * DK; e += BQ) {
      const int j = k0 + e / DK;
      ks[e / DK][e % DK] = j < t ? kb[(size_t)j * DK + e % DK] : 0.f;
    }
    for (int e = threadIdx.x; e < BKV * DH; e += BQ) {
      const int j = k0 + e / DH;
      vs[e / DH][e % DH] = j < t ? vb[(size_t)j * DH + e % DH] : 0.f;
    }
    __syncthreads();

    const int n = min(BKV, t - k0);
    float s[BKV];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      s[j] = j < n ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);  // finite: every tile has a key
    const float corr = expf(m - m_new);      // 0 on the first tile
    l *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float p = expf(s[j] - m_new);  // 0 past the ragged edge
      l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (live) {
    const float inv = 1.f / l;
    float* ob = out + (bh * t + row) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) ob[d] = acc[d] * inv;
  }
}

}  // namespace

// q, k: (bh, t, 32); v, out: (bh, t, 64); all bf16 (is_bf16 != 0) or all
// f32, contiguous and 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int psa_attention(const void* q, const void* k, const void* v, void* out,
                             int bh, int t, float scale, int is_bf16, void* stream) {
  const dim3 grid(bh, (t + BQ - 1) / BQ);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    attention_bf16_kernel<<<grid, WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), t, scale);
  } else {
    attention_f32_kernel<<<grid, BQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), t, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
