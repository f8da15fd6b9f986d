// Attention for Hopper: out = softmax(q·kᵀ·scale)·v, for YOLO11's PSA block
// (q/k 32 wide, v 64) and YOLO12's area attention (q, k and v 32 wide).
//
// Replaces the TPU kernel tpu_yolo/ops/attention_pallas.py::fused_attention
// (_attn_kernel); the JAX package has no YOLO12, and the 32-wide form is the
// same kernel at another value width. That kernel holds all of K and V of a head in VMEM and
// takes a full-row softmax. Casts follow it: scores and the softmax in f32,
// each p rounded to v's type before the PV product, PV accumulated in f32,
// the output written in v's type. (p is rounded before it is normalized:
// the online form learns the row's sum only at the end.)
//
// Bound on the H100: at the serving shape (BH=256, T=400, dk=32, dh=64,
// bf16) the function moves 39 MB (12 us at 3.35 TB/s) and does 7.9 GFLOP
// (8 us at the bf16 tensor-core rate), and its 41 M exponentials are 11 us
// of the special-function units' time. All three are of one size, so K/V
// must be read once, the tensor cores fed without detours and the three
// overlapped. What is left above them is the latency of one warpgroup's
// chain (product, maxima, exponentials, product) with four warpgroups an
// SM to hide it. Measured times: PERF.md, section 6.
//
// The bf16 kernel:
//   * Both products are wgmma (warpgroup MMA, f32 accumulate), one
//     warpgroup to a tile of 64 queries. S = Q·Kᵀ is m64n80k16 with Q as
//     the A operand in registers and K, as stored ([key][32], 64-byte
//     rows), as the K-major B operand in the 64-byte swizzle. O += P·V is
//     m64n64k16 with P taken from the S accumulators in registers
//     (exponentiated, rounded to bf16) and V, as stored ([key][64],
//     128-byte rows), as the MN-major B operand in the 128-byte swizzle
//     (the transpose-B bit). Nothing is transposed by a copy.
//   * K/V arrive in tiles of 80 keys (400 = 5·80 and 1600 = 20·80: no
//     padded keys at either serving size) by 16-byte cp.async copies that
//     write the swizzled addresses, three tiles in flight ahead of the one
//     being multiplied (commit groups, wait_group, one block barrier a
//     tile).
//   * Two forms of the one kernel, chosen by the shape alone. K/V resident:
//     a block owns a head, its ring has a stage for every tile (77 KB at
//     T=400, two blocks an SM), and its two warpgroups walk the head's query
//     tiles; K/V are read from device memory once, and the copies of later
//     tiles overlap the first query tiles' products. K/V streamed (a head
//     whose tiles would leave an SM room for one block only, T > 560, or
//     fewer heads than SMs): a block owns 128 queries and K/V pass through
//     a ring of four stages.
//   * exp2 with scale·log2(e) folded in as one FMA a score; each 16-key
//     k-step of P·V is issued as soon as its exponentials are done and runs
//     under the next one's. Keys past T are copied as zeros and masked, rows
//     past T are never stored. The next query tile's Q fragments are
//     loaded under the epilogue of the one before.
// The f32 kernel (tests, f32 serving) does its products with plain f32
// FMAs, one query row per thread, K/V in tiles of 64 keys; each tile's
// sums are taken on their own and added to the running ones.
//
// Values 32 wide (YOLO12, forms named attention_v32_*): P·V is m64n32k16
// and a V tile is 80 rows of 64 bytes in the 64-byte swizzle, as K's; a
// stage is 10 KB, so the resident form takes heads of up to 10 tiles (T <=
// 800) at two blocks an SM, and at T = 400 an SM's shared memory holds four.
// At YOLO12-x's P4 (BH = 6144, T = 400) a call moves 629 MB (0.19 ms) and
// does 126 GFLOP (0.13 ms).
//
// Layout: the 64-wide forms take q, k (BH, T, 32), v and out (BH, T, 64),
// contiguous. In the 32-wide forms head i of q, k, v and out is sequence g
// = i / heads, head h = i % heads, and its row r starts at g·batch +
// h·head + r·row elements (the Layout's `in` strides for q, k and v, its
// `out` strides for out; the last dimension is contiguous): the area
// attention reads q, k and v in place from the qkv conv's NHWC map (row
// 3C, head 96, q, k, v at offsets 0, 32, 64) and writes out as an NHWC map
// (row C, head 32); contiguous (BH, T, 32) tensors are heads 1. bf16:
// every row and head offset a multiple of 8 elements and the pointers
// 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DK = 32;
constexpr int BQ = 64;   // queries per tile: wgmma's M (bf16), a block's rows (f32)
constexpr int BKV = 64;  // keys per shared-memory tile of the f32 kernel

// Where head i's rows lie (module comment): element strides.
struct Strides {
  long long batch, head, row;
};
struct Layout {
  Strides in, out;
  int heads;
};

__device__ __forceinline__ long long head_offset(const Strides& s, int heads, long long i) {
  return (i / heads) * s.batch + (i % heads) * s.head;
}

// ---------------------------------------------------------------------------
// bf16: wgmma, cp.async ring, two warpgroups of 64 query rows each.
// ---------------------------------------------------------------------------

constexpr int BN = 80;                 // keys per tile: wgmma's N for S, 5 k-steps for PV
constexpr int WGS = 2;                 // warpgroups per block
constexpr int THREADS = WGS * 128;
constexpr int PREFETCH = 3;            // key tiles in flight ahead of the products
constexpr int RING = PREFETCH + 1;     // stages of the streamed form
constexpr int K_TILE_BYTES = BN * DK * 2;
constexpr int SMEM_ALIGN = 1024;       // the 128-byte swizzle repeats every 1024 bytes

// The value width's shapes: a V tile's bytes (a multiple of 1024), a
// stage's, and the resident form's most stages at two blocks an SM.
template <int DH>
struct VForm {
  static constexpr int V_TILE_BYTES = BN * DH * 2;
  static constexpr int STAGE_BYTES = K_TILE_BYTES + V_TILE_BYTES;  // 15 KB (64), 10 KB (32)
  static constexpr int MAX_RESIDENT = DH == 64 ? 7 : 10;             // T <= 560, T <= 800
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// volatile: the exponentials of a k-step stay between the wgmmas they are
// written between, so that they run while the earlier k-steps multiply
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, asynchronously; zeros when !live
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  const int n = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// makes shared-memory writes of this thread visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins accumulators between ordinary code and the asynchronous wgmma that
// writes them: the compiler must not move their reads or writes across.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: address, leading and stride byte
// offsets in 16-byte units, swizzle mode (1: 128 bytes, 2: 64 bytes)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

// d (64 x 80, f32) = or += a (64 x 16 bf16, registers) · bᵀ, b K-major in shared memory
__device__ __forceinline__ void wgmma_m64n80k16(float (&d)[40], const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += a (64 x 16 bf16, registers) · b, b MN-major in shared memory
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32, f32) += a (64 x 16 bf16, registers) · b, b MN-major in shared memory
__device__ __forceinline__ void wgmma_pv(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// c_log2e is |scale|·log2(e), folded into the exponent with one FMA a score,
// so the maxima are taken of the raw scores; a negative scale flips the sign
// bits of Q instead (q_sign 0x80008000), which is exact. The caller keeps
// c_log2e above zero (1e-30 for scale 0: every p is then 1, as it should be)
// so that a masked score of -inf stays -inf.
// grid (bh, query groups): with one query group (the resident form, stages ==
// ntiles) a warpgroup walks the query tiles wg, wg + 2, ...; otherwise (the
// streamed form, stages == RING) a block has one query tile a warpgroup.
// The body of both bf16 kernels (one a value width, so that a trace tells
// them apart by name).
template <int DH>
__device__ __forceinline__ void attention_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int t, int ntiles,
    int stages, float c_log2e, uint32_t q_sign, const Layout& L) {
  using F = VForm<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem0 = ((uint32_t)__cvta_generic_to_shared(smem_raw) + SMEM_ALIGN - 1) &
                         ~(uint32_t)(SMEM_ALIGN - 1);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // fragment row group, column pair
  // the 64-wide form takes contiguous (BH, T, d) tensors: its strides are
  // the compiler's constants, and its code the same as before the 32-wide
  // form came (L is read by the 32-wide form alone)
  constexpr bool CONTIG = DH == 64;
  const size_t bh = blockIdx.x;
  const size_t qk_row = CONTIG ? DK : L.in.row, v_row = CONTIG ? DH : L.in.row;
  const size_t q_row32 = qk_row / 2, o_row32 = (CONTIG ? DH : L.out.row) / 2;  // bf16 pairs
  const __nv_bfloat16* kb = k + (CONTIG ? bh * t * DK : head_offset(L.in, L.heads, bh));
  const __nv_bfloat16* vb = v + (CONTIG ? bh * t * DH : head_offset(L.in, L.heads, bh));
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(
      q + (CONTIG ? bh * t * DK : head_offset(L.in, L.heads, bh)));
  uint32_t* o32 = reinterpret_cast<uint32_t*>(
      out + (CONTIG ? bh * t * DH : head_offset(L.out, L.heads, bh)));

  // tile -> its stage, in wgmma's swizzled layouts: the 16-byte chunk ch of
  // row r lands at chunk ch ^ ((r >> 1) & 3) of a 64-byte row (K, and V 32
  // wide) and at chunk ch ^ (r & 7) of a 128-byte row (V 64 wide)
  auto load_tile = [&](int tile) {
    const uint32_t kdst = smem0 + (tile % stages) * F::STAGE_BYTES;
    const uint32_t vdst = kdst + K_TILE_BYTES;
    const int k0 = tile * BN;
    for (int e = tid; e < BN * 4; e += THREADS) {
      const int r = e >> 2, ch = e & 3;
      const bool live = k0 + r < t;
      cp_async16(kdst + r * 64 + ((ch ^ ((r >> 1) & 3)) << 4),
                 kb + (size_t)(live ? k0 + r : 0) * qk_row + ch * 8, live);
    }
    constexpr int V_CHUNKS = DH / 8;  // 16-byte chunks a V row
    for (int e = tid; e < BN * V_CHUNKS; e += THREADS) {
      const int r = e / V_CHUNKS, ch = e % V_CHUNKS;
      const bool live = k0 + r < t;
      const int swz = DH == 64 ? ch ^ (r & 7) : ch ^ ((r >> 1) & 3);
      cp_async16(vdst + r * (DH * 2) + (swz << 4),
                 vb + (size_t)(live ? k0 + r : 0) * v_row + ch * 8, live);
    }
  };

  for (int s = 0; s < PREFETCH; ++s) {
    if (s < ntiles) load_tile(s);
    cp_async_commit();
  }

  // Q as A fragments: rows g and g+8 of this warp's 16, two k-steps of 16
  // dims; zeros past t
  auto load_q = [&](int qt, uint32_t (&qf)[2][4]) {
    const int r_lo = qt * BQ + warp * 16 + g, r_hi = r_lo + 8;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int col = kk * 8 + c;  // in bf16 pairs
      qf[kk][0] = r_lo < t ? q32[(size_t)r_lo * q_row32 + col] ^ q_sign : 0u;
      qf[kk][1] = r_hi < t ? q32[(size_t)r_hi * q_row32 + col] ^ q_sign : 0u;
      qf[kk][2] = r_lo < t ? q32[(size_t)r_lo * q_row32 + col + 4] ^ q_sign : 0u;
      qf[kk][3] = r_hi < t ? q32[(size_t)r_hi * q_row32 + col + 4] ^ q_sign : 0u;
    }
  };
  const int q_step = WGS * gridDim.y;
  uint32_t qn[2][4];  // the next query tile's fragments, loaded a pass ahead
  load_q(blockIdx.y * WGS + wg, qn);

  const int nq = (t + BQ - 1) / BQ;
  // The first pass of every warpgroup runs the copy pipeline and its block
  // barriers, also where it has no live query tile; in the resident form
  // the later passes find every tile in shared memory.
  bool piped = true;
  for (int qt = blockIdx.y * WGS + wg; piped || qt < nq; qt += q_step) {
    const int r_lo = qt * BQ + warp * 16 + g, r_hi = r_lo + 8;
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[kk][e] = qn[kk][e];

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, rows g and g+8
    float l_lo = 0.f, l_hi = 0.f;              // this thread's share of the sums

    for (int i = 0; i < ntiles; ++i) {
      if (piped) {
        cp_async_wait<PREFETCH - 1>();  // this thread's copies of tile i have landed
        fence_proxy_async();
        __syncthreads();  // everyone's have, and tile i-1's stage is free
        if (i + PREFETCH < ntiles) load_tile(i + PREFETCH);
        cp_async_commit();
      }
      const uint32_t kaddr = smem0 + (i % stages) * F::STAGE_BYTES;
      const uint64_t kdesc = smem_desc(kaddr, 16, 512, 2);
      // V: MN-major, 8-row groups 8 rows apart (SBO); one 16-key k-step is
      // 16 rows (128 or 64 in 16-byte units)
      const uint64_t vdesc = DH == 64 ? smem_desc(kaddr + K_TILE_BYTES, 1024, 1024, 1)
                                      : smem_desc(kaddr + K_TILE_BYTES, 512, 512, 2);
      constexpr int V_KSTEP = 16 * DH * 2 / 16;

      // S = Q Kᵀ: 64 rows x 80 keys a warpgroup (the first k-step overwrites s)
      float s[BN / 2];
      wgmma_fence();
      wgmma_m64n80k16(s, qa[0], kdesc, 0);
      wgmma_m64n80k16(s, qa[1], kdesc + 2, 1);  // dims 16..31: 32 bytes on
      wgmma_commit();
      wgmma_wait();
      pin(s);

      // the tile's row maxima, of the raw scores; keys past t count as -inf
      // (c_log2e > 0, so their p is exp2(-inf) = 0)
      const int k0 = i * BN;
      if (k0 + BN > t) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e)
          if (k0 + (e >> 2) * 8 + 2 * c + (e & 1) >= t) s[e] = -INFINITY;
      }
      float tmax_lo = -INFINITY, tmax_hi = -INFINITY;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        tmax_lo = fmaxf(tmax_lo, fmaxf(s[4 * n], s[4 * n + 1]));
        tmax_hi = fmaxf(tmax_hi, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      // the four lanes of a quad hold one row between them
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        tmax_lo = fmaxf(tmax_lo, __shfl_xor_sync(0xffffffffu, tmax_lo, off));
        tmax_hi = fmaxf(tmax_hi, __shfl_xor_sync(0xffffffffu, tmax_hi, off));
      }
      // finite: every tile has a live key
      const float mn_lo = fmaxf(m_lo, tmax_lo), mn_hi = fmaxf(m_hi, tmax_hi);
      const float corr_lo = i ? ex2((m_lo - mn_lo) * c_log2e) : 0.f;
      const float corr_hi = i ? ex2((m_hi - mn_hi) * c_log2e) : 0.f;
      m_lo = mn_lo;
      m_hi = mn_hi;
      l_lo *= corr_lo;
      l_hi *= corr_hi;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[4 * n] *= corr_lo;
        o[4 * n + 1] *= corr_lo;
        o[4 * n + 2] *= corr_hi;
        o[4 * n + 3] *= corr_hi;
      }
      pin(o);

      // O += P V, 16 keys (16 V rows) a k-step. P = exp2(s·c - m·c), rounded
      // to bf16, goes from the S accumulators to the A fragments: keys
      // 16kk..16kk+15 are this thread's columns 8kk..8kk+7. Each k-step's
      // product is issued as soon as its P is made, and runs under the next
      // k-step's exponentials.
      const float mc_lo = m_lo * c_log2e, mc_hi = m_hi * c_log2e;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          p[e] = ex2(fmaf(s[8 * kk + e], c_log2e, -((e & 2) ? mc_hi : mc_lo)));
        }
        l_lo += (p[0] + p[1]) + (p[4] + p[5]);
        l_hi += (p[2] + p[3]) + (p[6] + p[7]);
        uint32_t pa[4];
        pa[0] = pack_bf16(p[0], p[1]);
        pa[1] = pack_bf16(p[2], p[3]);
        pa[2] = pack_bf16(p[4], p[5]);
        pa[3] = pack_bf16(p[6], p[7]);
        wgmma_fence();
        wgmma_pv(o, pa, vdesc + kk * V_KSTEP);
        wgmma_commit();
      }
      wgmma_wait();
      pin(o);
    }

    load_q(qt + q_step, qn);  // in flight under this tile's epilogue
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = n * 4 + c;  // in bf16 pairs
      if (r_lo < t)
        o32[(size_t)r_lo * o_row32 + col] = pack_bf16(o[4 * n] * inv_lo, o[4 * n + 1] * inv_lo);
      if (r_hi < t)
        o32[(size_t)r_hi * o_row32 + col] =
            pack_bf16(o[4 * n + 2] * inv_hi, o[4 * n + 3] * inv_hi);
    }
    piped = false;
  }
}

__global__ void __launch_bounds__(THREADS, 2) attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int t, int ntiles,
    int stages, float c_log2e, uint32_t q_sign, Layout L) {
  attention_bf16<64>(q, k, v, out, t, ntiles, stages, c_log2e, q_sign, L);
}

__global__ void __launch_bounds__(THREADS, 2) attention_v32_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int t, int ntiles,
    int stages, float c_log2e, uint32_t q_sign, Layout L) {
  attention_bf16<32>(q, k, v, out, t, ntiles, stages, c_log2e, q_sign, L);
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs, one query row per thread.
// ---------------------------------------------------------------------------

template <int DH>
__device__ __forceinline__ void attention_f32(const float* __restrict__ q,
                                              const float* __restrict__ k,
                                              const float* __restrict__ v,
                                              float* __restrict__ out, int t, float scale,
                                              const Layout& L) {
  __shared__ float ks[BKV][DK];
  __shared__ float vs[BKV][DH];

  constexpr bool CONTIG = DH == 64;  // as the bf16 kernel's
  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * BQ + threadIdx.x;
  const bool live = row < t;
  const size_t qk_row = CONTIG ? DK : L.in.row, v_row = CONTIG ? DH : L.in.row;
  const float* qb = q + (CONTIG ? bh * t * DK : head_offset(L.in, L.heads, bh));
  const float* kb = k + (CONTIG ? bh * t * DK : head_offset(L.in, L.heads, bh));
  const float* vb = v + (CONTIG ? bh * t * DH : head_offset(L.in, L.heads, bh));

  float qr[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) qr[d] = live ? qb[(size_t)row * qk_row + d] : 0.f;

  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = -INFINITY;  // running row max of the scaled scores
  float l = 0.f;        // running sum of exp(s - m)

  for (int k0 = 0; k0 < t; k0 += BKV) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < BKV * DK; e += BQ) {
      const int j = k0 + e / DK;
      ks[e / DK][e % DK] = j < t ? kb[(size_t)j * qk_row + e % DK] : 0.f;
    }
    for (int e = threadIdx.x; e < BKV * DH; e += BQ) {
      const int j = k0 + e / DH;
      vs[e / DH][e % DH] = j < t ? vb[(size_t)j * v_row + e % DH] : 0.f;
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
    // The tile's sums on their own, then one rescale-and-add into the
    // running ones: chains of 64 terms and one a tile, where a single
    // chain over the row (1,600 keys at 1280 px) rounds up to 3x further
    // from the exact result than the plain version does.
    float part_l = 0.f;
    float part[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) part[d] = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float p = expf(s[j] - m_new);  // 0 past the ragged edge
      part_l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) part[d] = fmaf(p, vs[j][d], part[d]);
    }
    l = fmaf(l, corr, part_l);
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = fmaf(acc[d], corr, part[d]);
    m = m_new;
  }

  if (live) {
    const float inv = 1.f / l;
    float* ob = out + (CONTIG ? (bh * t + row) * DH
                              : head_offset(L.out, L.heads, bh) + row * L.out.row);
#pragma unroll
    for (int d = 0; d < DH; ++d) ob[d] = acc[d] * inv;
  }
}

__global__ void __launch_bounds__(BQ) attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int t, float scale, Layout L) {
  attention_f32<64>(q, k, v, out, t, scale, L);
}

__global__ void __launch_bounds__(BQ) attention_v32_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int t, float scale, Layout L) {
  attention_f32<32>(q, k, v, out, t, scale, L);
}

template <int DH>
int form_of(int bh, int t) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return ((t + BN - 1) / BN <= VForm<DH>::MAX_RESIDENT && bh >= sms) ? 0 : 1;
}

template <int DH>
int launch_bf16(decltype(attention_bf16_kernel)* kernel, const void* q, const void* k,
                const void* v, void* out, int bh, int t, float scale, const Layout& L,
                cudaStream_t s) {
  using F = VForm<DH>;
  const int form = form_of<DH>(bh, t);
  if (form < 0) return static_cast<int>(cudaErrorUnknown);
  const int ntiles = (t + BN - 1) / BN;
  const int nq = (t + BQ - 1) / BQ;
  const int stages = form == 0 ? ntiles : RING;
  const dim3 grid(bh, form == 0 ? 1 : (nq + WGS - 1) / WGS);
  static bool configured = false;  // shared memory above 48 KB is an opt-in
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           F::MAX_RESIDENT * F::STAGE_BYTES + SMEM_ALIGN);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  kernel<<<grid, THREADS, stages * F::STAGE_BYTES + SMEM_ALIGN, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), t, ntiles, stages,
      fmaxf(fabsf(scale) * 1.4426950408889634f, 1e-30f), scale < 0.f ? 0x80008000u : 0u, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The form the bf16 kernel takes at (bh, t) for values dh wide: 0, K/V
// resident (a block owns a head), where a head's tiles fit a block's shared
// memory and there is a head for every SM; 1, K/V streamed, otherwise. The
// f32 kernel has one form.
extern "C" int psa_attention_form(int bh, int t, int dh) {
  return dh == 32 ? form_of<32>(bh, t) : form_of<64>(bh, t);
}

// q, k: 32 wide; v, out: dh (32 or 64) wide; all bf16 (is_bf16 != 0) or
// all f32; at dh 32, head i's rows where `strides` says (module comment:
// q/k/v's and out's batch, head and row strides in elements, in that
// order, and `heads`); at dh 64 contiguous, and `strides` and `heads`
// unread.
// Launches on `stream` and returns the first CUDA error, 0 if none.
extern "C" int psa_attention(const void* q, const void* k, const void* v, void* out, int bh,
                             int t, int dh, int heads, const long long* strides, float scale,
                             int is_bf16, void* stream) {
  if ((dh != 32 && dh != 64) || heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L{{strides[0], strides[1], strides[2]},
                 {strides[3], strides[4], strides[5]},
                 heads};
  if (is_bf16)
    return dh == 64 ? launch_bf16<64>(attention_bf16_kernel, q, k, v, out, bh, t, scale, L, s)
                    : launch_bf16<32>(attention_v32_bf16_kernel, q, k, v, out, bh, t, scale,
                                      L, s);
  const dim3 grid(bh, (t + BQ - 1) / BQ);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  if (dh == 64)
    attention_f32_kernel<<<grid, BQ, 0, s>>>(qf, kf, vf, of, t, scale, L);
  else
    attention_v32_f32_kernel<<<grid, BQ, 0, s>>>(qf, kf, vf, of, t, scale, L);
  return static_cast<int>(cudaGetLastError());
}
