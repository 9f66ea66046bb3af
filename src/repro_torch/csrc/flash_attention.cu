// flash_attention: causal or full online-softmax attention on the tensor
// cores, one launch per call, in two routes chosen by dtype.
//
// Replaces the Pallas kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (body `_attn_kernel`).
//
// What it computes, for q, k, v (BH, S, D) of bfloat16 or float32, D a
// multiple of 16 up to 128 (the wrapper pads D with zero columns): each
// query row's softmax-weighted sum of the value rows over the keys it may
// see (all, or those up to its own position when `causal`), accumulated in
// float32 tile by tile with the running (max, sum, acc) rescaled from a
// start of max = -1e30 (the reference's NEG_INF), the sum floored at
// 1e-30, the result stored in the inputs' type.  Keys >= S and keys the
// causal mask hides get probability 0, as the reference's -1e30 gives.
//
// What bounds it on an H100: operations.  2*2*S*S*D per head (halved when
// causal) against 4*S*D elements moved: at S = 2048, D = 128 that is
// about 1,000 operations per byte, far above the card's ~295 (bf16 on the
// tensor cores, 989 TFLOP/s over 3.35 TB/s).  So both routes put the two
// products on the tensor cores and keep everything between them on chip.
//
// bf16 route (`attn_bf16_kernel`): wgmma fed by TMA, warp-specialised.
//  * A CTA owns kBr = 128 query rows of one head: warpgroups 0 and 1
//    consume, 64 rows each; the first thread of warpgroup 2 loads.
//    setmaxnreg gives the consumers 240 registers, the loader 24.
//  * TMA copies Q once and K, V tiles of kBc = 128 keys into a 2-stage ring
//    of mbarriers (full: bytes arrived; empty: all 256 consumer threads
//    done).  The tensor maps view each tensor as (D, S, BH), so a box
//    never runs into the next head: rows past S and columns past D arrive
//    as zeros.  With the 128-byte swizzle a box is 64 columns wide, so a
//    D = 128 tile is two boxes.  Shared memory at D = 128: Q 32 KB + 2 x
//    (K 32 KB + V 32 KB) = 160 KB.
//  * S = Q K^T: wgmma m64n128k16, both operands from shared memory (K as
//    stored, (keys, D), is the K-major B operand), D/16 steps.
//  * Softmax in registers: row max and sum across the 4 lanes of a quad,
//    p = exp2(s * c - m * c) with c = scale * log2(e) folded into one FMA.
//  * O += P V: P packed to bf16 in registers is the A operand of wgmma
//    m64n{64,128}k16; V as stored, (keys, D), is the MN-major B operand
//    (transpose-B), 8 steps of 16 keys.
//  * Causal CTAs stop at the key tile holding their last row and mask
//    only where a tile crosses the diagonal or the end of S; q tiles are
//    launched longest first (grid (BH, q tiles), y reversed).
//
// float32 route (`attn_f32_kernel`): split TF32 on mma.sync m16n8k8.
//  * One TF32 product misses the 3e-5 tolerance (it keeps 11 bits), so
//    each operand is split x = big + small, big = tf32(x), small =
//    tf32(x - big) (tf32: round to nearest, ties away, as cvt.rna), and a
//    product is small*big + big*small + big*big (three MMAs, the small
//    terms first).  tf32 wgmma takes only K-major
//    operands, which V is not; mma.sync loads fragments in any layout.
//  * A CTA owns 64 query rows (4 warps x 16); K and V tiles of 32 keys are
//    double-buffered with cp.async, rows padded to D + 4 floats so the
//    fragment loads hit 32 distinct banks.  Q's fragments are split as
//    they are read, K, V and P as they are used.
//  * P needs no shuffle: the C fragment of S holds keys 2t and 2t + 1 of
//    lane t's quad, and P V takes its keys in that order (A's column t is
//    key 2t, column t + 4 key 2t + 1; V's B fragment rows follow).
//
// Where the rounding departs from the reference (which scales q before
// the product and takes exp of float32 logits): the scale is applied to
// the float32 logits after the product, exp is exp2 with the scale and
// log2(e) folded into one constant (ex2.approx, about 2 ulp), and the bf16
// route rounds P to bf16 before P V (its row sums stay float32).  These
// stay inside chip_smoke.py's FLASH_TOL (bf16 rtol 1e-2, atol 4e-3;
// float32 3e-5): tests/test_torch_attention.py emulates each route's
// rounding on the CPU and holds it to the reference.
//
// The scale c must be > 0 (the wrapper folds a sign or a zero into q).
#include <cuda.h>  // CUtensorMap and the encoder's types; the encoder itself
                   // comes from the runtime (cudaGetDriverEntryPoint), no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF: the running max's start
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// online softmax over one tile, shared by both routes
// ---------------------------------------------------------------------------
// A warp's fragment covers 16 rows.  Each thread holds 2 of them (r and
// r + 8) and, for every chunk of 8 keys, keys 2t and 2t + 1 of the chunk
// (t = lane % 4): s[4i + 0, 1] row r, s[4i + 2, 3] row r + 8.  wgmma's
// accumulator and mma.sync's C fragment both have this layout.

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// s: the tile's raw logits q.k -> probabilities exp2(s c - m c), 0 where
// masked (key >= S, or key > row when causal; `mask` says whether any key
// of the tile may be).  m (raw units) and l (this thread's share of each
// row's sum) move on; alpha gets each row's rescale factor for acc.
// key0: this thread's first key; row0: its first row (both global).
template <int NC>
__device__ __forceinline__ void softmax_tile(float (&s)[4 * NC], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c, int key0, int row0,
                                             int S, bool causal, bool mask) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * i + (e & 1);
        if (key >= S || (causal && key > row0 + 8 * (e >> 1))) s[4 * i + e] = -INFINITY;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int i = 0; i < NC; ++i) mx = fmaxf(mx, fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
    mx = quad_max(mx);
    alpha[h] = ex2((m[h] - mx) * c);
    m[h] = mx;
    const float mc = mx * c;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ex2(fmaf(s[4 * i + 2 * h + j], c, -mc));
        s[4 * i + 2 * h + j] = p;
        sum += p;
      }
    }
    l[h] = fmaf(l[h], alpha[h], sum);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// bf16 route: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------

constexpr int kBr = 128;               // query rows per CTA (2 consumer warpgroups x 64)
constexpr int kBc = 128;               // keys per K/V tile
constexpr int kStages = 2;             // K/V ring depth
constexpr int kBoxBytes = 128 * 128;   // one TMA box: 128 rows x 64 bf16, swizzled
constexpr int kBf16Threads = 384;      // warpgroups 0, 1 consume; 2 loads
constexpr int kConsumers = 256;        // arrivals that free a K or V stage

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 3-D tensor map at (column, row, head) into shared memory;
// its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ---- wgmma, as PTX: 64 rows x N columns, bf16 in, float32 accumulate ----

// d (64 x 128) = A * B (+ d when scale_d): A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128) += A * B: A (64 x 16) from registers, B from shared memory,
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A * B: A (64 x 16) from registers, B from shared memory,
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// kDB: 64-column boxes per row (1 for D <= 64, 2 for D <= 128).
template <int kDB>
__global__ void __launch_bounds__(kBf16Threads, 1)
attn_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
                 int D, float c, int causal) {
  constexpr int kTile = kDB * kBoxBytes;  // bytes of a Q, K or V tile
  constexpr int kOut = kDB * 32;          // O accumulator registers (64 x 64 kDB)
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;
  const uint32_t sk = sq + kTile;                  // stage st at sk + st * kTile
  const uint32_t sv = sk + kStages * kTile;
  const uint32_t bars = sv + kStages * kTile;      // 1 + 4 * kStages barriers of 8 bytes
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8 * (1 + 3 * kStages + st); };

  const int bh = blockIdx.x;
  const int qt = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y) : static_cast<int>(blockIdx.y);
  const int q0 = qt * kBr;
  const int n_k = (S + kBc - 1) / kBc;
  const int n_tiles = causal ? min(n_k, (q0 + kBr + kBc - 1) / kBc) : n_k;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), kConsumers);
      mbar_init(v_empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- loader: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, kTile);
      for (int b = 0; b < kDB; ++b) tma_load(sq + b * kBoxBytes, &tq, q_full, 64 * b, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const uint32_t ph = (t / kStages) & 1;
        mbar_wait(k_empty(st), ph ^ 1);
        mbar_expect_tx(k_full(st), kTile);
        for (int b = 0; b < kDB; ++b)
          tma_load(sk + st * kTile + b * kBoxBytes, &tk, k_full(st), 64 * b, t * kBc, bh);
        mbar_wait(v_empty(st), ph ^ 1);
        mbar_expect_tx(v_full(st), kTile);
        for (int b = 0; b < kDB; ++b)
          tma_load(sv + st * kTile + b * kBoxBytes, &tv, v_full(st), 64 * b, t * kBc, bh);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's first row
    const uint32_t qa = sq + wg * 64 * 128;                 // the warpgroup's 64 rows of Q
    float acc[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      const int k0 = t * kBc;

      // S = Q K^T over D in steps of 16 columns (32 bytes inside a box)
      float s[64];
      mbar_wait(k_full(st), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * kDB; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(s, sdesc(qa + off, 16, 1024), sdesc(sk + st * kTile + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      mbar_arrive(k_empty(st));

      float alpha[2];
      const bool mask = k0 + kBc > S || (causal && k0 + kBc - 1 > q0 + 64 * wg);
      softmax_tile<16>(s, m, l, alpha, c, k0 + 2 * (lane % 4), row0, S, causal != 0, mask);
      rescale(acc, alpha);
      // P as wgmma's A fragments: step kk takes keys 16 kk .. 16 kk + 15
      uint32_t p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

      // O += P V over the tile's keys in steps of 16 rows of V (2048 bytes)
      mbar_wait(v_full(st), ph);
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        const uint64_t db = sdesc(sv + st * kTile + kk * 2048, kBoxBytes, 1024);
        if constexpr (kDB == 2) {
          wgmma_rs_n128(acc, a, db);
        } else {
          wgmma_rs_n64(acc, a, db);
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      fence_regs(p);
      mbar_arrive(v_empty(st));
    }

    const size_t head = static_cast<size_t>(bh) * S * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float denom = fmaxf(quad_sum(l[h]), 1e-30f);
      const int row = row0 + 8 * h;
      if (row >= S) continue;
      __nv_bfloat16* out = o + head + static_cast<size_t>(row) * D;
#pragma unroll
      for (int i = 0; i < kOut / 4; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        if (col < D) {
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(acc[4 * i + 2 * h] / denom, acc[4 * i + 2 * h + 1] / denom);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 route: split TF32 on mma.sync
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;   // query rows per CTA: 4 warps x 16
constexpr int kF32Keys = 32;   // keys per K/V tile
constexpr int kF32Threads = 128;

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding (inf and NaN stay so), as an integer
// add and mask.  The cvt itself compiles to a longer sequence of compares
// and selects, and this route is bound by issue slots.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d (16 x 8) += a (16 x 8) b (8 x 8), TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32: the two small cross terms first, then big * big
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                     uint32_t bb0, uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// 16 bytes global -> shared, zeros when !ok
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// kD: the head dim rounded up to 64 or 128 (columns past D load as zeros).
template <int kD>
__global__ void __launch_bounds__(kF32Threads, 2)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int S, int D, float c,
                int causal) {
  constexpr int kStride = kD + 4;  // floats per staged row: 32 distinct banks per fragment
  constexpr int kChunks = kD / 4;  // 16-byte chunks per row
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // (kF32Rows, kStride)
  float* ks = qs + kF32Rows * kStride;            // 2 stages of (kF32Keys, kStride)
  float* vs = ks + 2 * kF32Keys * kStride;

  const int bh = blockIdx.x;
  const int qt = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y) : static_cast<int>(blockIdx.y);
  const int q0 = qt * kF32Rows;
  const size_t head = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;

  for (int i = tid; i < kF32Rows * kChunks; i += kF32Threads) {
    const int r = i / kChunks, col = (i % kChunks) * 4;
    const bool ok = q0 + r < S && col < D;
    cp16(qs + r * kStride + col, ok ? q + head + static_cast<size_t>(q0 + r) * D + col : q, ok);
  }
  auto load_kv = [&](int t, int st) {
    const int k0 = t * kF32Keys;
    for (int i = tid; i < kF32Keys * kChunks; i += kF32Threads) {
      const int r = i / kChunks, col = (i % kChunks) * 4;
      const bool ok = k0 + r < S && col < D;
      const size_t at = head + static_cast<size_t>(k0 + r) * D + col;
      cp16(ks + (st * kF32Keys + r) * kStride + col, ok ? k + at : k, ok);
      cp16(vs + (st * kF32Keys + r) * kStride + col, ok ? v + at : v, ok);
    }
  };
  const int n_k = (S + kF32Keys - 1) / kF32Keys;
  const int n_tiles = causal ? min(n_k, (q0 + kF32Rows + kF32Keys - 1) / kF32Keys) : n_k;
  load_kv(0, 0);
  cp_commit();

  const int wrow = 16 * warp;     // the warp's first row in the CTA
  const int row0 = q0 + wrow + g;  // this thread's first row
  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv(t + 1, (t + 1) % 2);
    cp_commit();
    cp_wait_all_but_one();  // tile t (and Q) have landed
    __syncthreads();
    const int k0 = t * kF32Keys;
    // a warp whose rows all come before the tile's first key gets nothing from it
    if (!causal || k0 <= q0 + wrow + 15) {
      const float* kt = ks + (t % 2) * kF32Keys * kStride;
      const float* vt = vs + (t % 2) * kF32Keys * kStride;
      float s[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kD / 8; ++kk) {
        const float* qa = qs + (wrow + g) * kStride + 8 * kk + tg;
        uint32_t ab[4], as[4];
        split(qa[0], ab[0], as[0]);
        split(qa[8 * kStride], ab[1], as[1]);
        split(qa[4], ab[2], as[2]);
        split(qa[8 * kStride + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < kF32Keys / 8; ++j) {
          const float* kb = kt + (8 * j + g) * kStride + 8 * kk + tg;
          uint32_t bb0, bs0, bb1, bs1;
          split(kb[0], bb0, bs0);
          split(kb[4], bb1, bs1);
          mma3(&s[4 * j], ab, as, bb0, bb1, bs0, bs1);
        }
      }

      float alpha[2];
      const bool mask = k0 + kF32Keys > S || (causal && k0 + kF32Keys - 1 > q0 + wrow);
      softmax_tile<kF32Keys / 8>(s, m, l, alpha, c, k0 + 2 * tg, row0, S, causal != 0, mask);
      rescale(acc, alpha);

      // O += P V, 8 keys a step: A's column tg is key 2 tg, column tg + 4 key 2 tg + 1
#pragma unroll
      for (int j = 0; j < kF32Keys / 8; ++j) {
        uint32_t pb[4], ps[4];
        split(s[4 * j], pb[0], ps[0]);
        split(s[4 * j + 2], pb[1], ps[1]);
        split(s[4 * j + 1], pb[2], ps[2]);
        split(s[4 * j + 3], pb[3], ps[3]);
        const float* vb = vt + (8 * j + 2 * tg) * kStride + g;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          uint32_t bb0, bs0, bb1, bs1;
          split(vb[8 * n], bb0, bs0);
          split(vb[kStride + 8 * n], bb1, bs1);
          mma3(&acc[4 * n], pb, ps, bb0, bb1, bs0, bs1);
        }
      }
    }
    __syncthreads();  // the stage is read before the next prefetch overwrites it
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float denom = fmaxf(quad_sum(l[h]), 1e-30f);
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    float* out = o + head + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int col = 8 * n + 2 * tg;
      if (col < D) {
        *reinterpret_cast<float2*>(out + col) =
            make_float2(acc[4 * n + 2 * h] / denom, acc[4 * n + 2 * h + 1] / denom);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (BH, S, D) bf16 tensor as (D, S, BH), in boxes of 64 columns x 128
// rows x 1 head with the 128-byte swizzle; out-of-range elements read as 0.
bool head_map(EncodeTiled encode, CUtensorMap* map, const void* x, int BH, int S, int D) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raises the kernel's dynamic shared memory limit once (above 48 KB it
// must be asked for).
template <typename Kernel>
int opt_in(Kernel kernel, int smem, bool& done) {
  if (done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done = true;
  return static_cast<int>(err);
}

template <int kDB>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
                float c, int causal, cudaStream_t s) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!head_map(encode, &tq, q, BH, S, D) || !head_map(encode, &tk, k, BH, S, D) ||
      !head_map(encode, &tv, v, BH, S, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = attn_bf16_kernel<kDB>;
  // the tiles, 1024 bytes to align them, the barriers
  const int smem = (1 + 2 * kStages) * kDB * kBoxBytes + 1024 + 8 * (1 + 4 * kStages);
  static bool opted = false;
  if (const int err = opt_in(kernel, smem, opted)) return err;
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>((S + kBr - 1) / kBr));
  kernel<<<grid, kBf16Threads, smem, s>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, D, c,
                                          causal);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
               float c, int causal, cudaStream_t s) {
  const auto kernel = attn_f32_kernel<kD>;
  const int smem = static_cast<int>(sizeof(float)) * (kF32Rows + 4 * kF32Keys) * (kD + 4);
  static bool opted = false;
  if (const int err = opt_in(kernel, smem, opted)) return err;
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((S + kF32Rows - 1) / kF32Rows));
  kernel<<<grid, kF32Threads, smem, s>>>(static_cast<const float*>(q),
                                         static_cast<const float*>(k),
                                         static_cast<const float*>(v), static_cast<float*>(o),
                                         S, D, c, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (BH, S, D) contiguous, 16-byte aligned, float32 (bf16 = 0)
// or bfloat16 (bf16 = 1); D a multiple of 16 up to 128; scale > 0.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int S, int D, float scale, int causal, int bf16,
                                      void* stream) {
  if (D <= 0 || D > 128 || D % 16 != 0 || !(scale > 0.0f) || BH <= 0 || S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float c = scale * kLog2e;
  if (bf16) {
    if (D <= 64) return launch_bf16<1>(q, k, v, o, BH, S, D, c, causal, s);
    return launch_bf16<2>(q, k, v, o, BH, S, D, c, causal, s);
  }
  if (D <= 64) return launch_f32<64>(q, k, v, o, BH, S, D, c, causal, s);
  return launch_f32<128>(q, k, v, o, BH, S, D, c, causal, s);
}
