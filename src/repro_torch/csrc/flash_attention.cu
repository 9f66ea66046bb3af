// flash_attention: causal or full online-softmax attention on the tensor
// cores, one launch per call, in routes chosen by dtype and head dim.
//
// Replaces the Pallas kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (body `_attn_kernel`).
//
// What it computes, for q, k, v (BH, S, D) of bfloat16, float16 or
// float32, D a multiple of 16 (the wrapper pads D with zero columns):
// each query row's softmax-weighted sum of the value rows over the keys it
// may see (all, or those up to its own position when `causal`),
// accumulated in float32 tile by tile with the running (max, sum, acc)
// rescaled from a start of max = -1e30 (the reference's NEG_INF), the sum
// floored at 1e-30, the result stored in the inputs' type.  Keys >= S and
// keys the causal mask hides get probability 0, as the reference's -1e30
// gives.
//
// What bounds it on an H100: operations.  2*2*S*S*D per head (halved when
// causal) against 4*S*D elements moved: at S = 2048, D = 128 that is
// about 1,000 operations per byte, far above the card's ~295 (bf16 or f16
// on the tensor cores, 989 TFLOP/s over 3.35 TB/s).  So every route puts
// the two products on the tensor cores and keeps everything between them
// on chip.
//
// 16-bit route, D <= 128 (`attn_half_kernel<T, kDB>`, T bf16 or f16): wgmma
// fed by TMA, warp-specialised.
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
//  * O += P V: P packed to T in registers is the A operand of wgmma
//    m64n{64,128}k16; V as stored, (keys, D), is the MN-major B operand
//    (transpose-B), 8 steps of 16 keys.
//  * Causal CTAs stop at the key tile holding their last row and mask
//    only where a tile crosses the diagonal or the end of S; q tiles are
//    launched longest first (grid (BH, q tiles), y reversed).
//  * bf16 and f16 differ only in the wgmma's operand type (.bf16 / .f16),
//    the tensor maps' element type and how P and the output are rounded.
//
// 16-bit route, D > 128 (`attn_half_wide_kernel<T>`): a CTA owns all the
// columns of a 256-column slice of O (the grid's z: ceil(D / 256) slices,
// one for D <= 256) for kBr = 128 query rows, in the narrow CTA's shape
// (warpgroups 0 and 1 consume 64 rows each, one thread of warpgroup 2
// loads; setmaxnreg 240 / 24).
//  * TMA loads Q once: 128 rows x 256 columns = 64 KB, four 64-column
//    boxes.  K and V come in tiles of kWideKeys = 64 keys (32 KB each at
//    D = 256; boxes of 64 keys x 64 columns) through the 2-stage ring:
//    64 KB + 2 x 64 KB = 192 KB and the barriers, one CTA (12 warps) an SM.
//  * S = Q K^T once a key tile: wgmma m64n64k16 from shared memory, 4 steps
//    a 64-column box (a box partly past D reads zeros), S 32 registers a
//    thread.
//  * O += P V: wgmma m64n256k16, P from registers, V the MN-major B
//    operand, 4 steps of 16 keys; O 128 registers a thread.
//  * Above D = 256 each slice's CTA computes the whole score tile, over
//    ceil(D / 256) chunks of 256 columns: Q's chunk then comes through the
//    ring with K's, each once the consumers are done with the chunk before.
//  * Causal: longest q tiles first; masks only where a tile crosses the
//    diagonal or the end of S; warpgroup 0 skips the key tile past its
//    last row (it waits and frees the stages all the same).
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
//  * D > 128 (`attn_f32_wide_kernel`): a CTA owns a 256-column slice of O
//    (grid z: ceil(D / 256) slices) for 64 query rows with 16 warps: the
//    four warps w, w + 4, w + 8, w + 12 share the 16 rows of group w % 4.
//    Each forms the partial Q K^T over its quarter of D's columns
//    (`part_steps`); the four add their partials through shared memory (2
//    KB a warp a tile) in one order, (x0 + x1) + (x2 + x3), so all hold
//    the same scores, run the same online softmax, and do P V for their
//    own quarter of the slice's columns (at most 64: 32 accumulator
//    registers a thread).  Q is staged once (64 rows x 260 floats, 65 KB),
//    K and V tiles of 32 keys are double-buffered by cp.async (130 KB),
//    the partials take 32 KB: 232,448 bytes, all a block may have; one CTA
//    of 16 warps an SM, 4 a scheduler, which hide the latency of the
//    fragment loads and of the chained products that 8 warps (two a row
//    group) left bare.  Q's fragments are split as they are read, as in
//    the narrow kernel: its big and small halves staged once would need
//    another 65 KB.  Above D = 256, Q K^T sums chunks of 256 columns: Q's
//    chunk is staged for each (key tile, chunk) item once the item before
//    is done with it.
//
// Where the rounding departs from the reference (which scales q before
// the product and takes exp of float32 logits): the scale is applied to
// the float32 logits after the product, exp is exp2 with the scale and
// log2(e) folded into one constant (ex2.approx, about 2 ulp), and the
// 16-bit routes round P to T before P V (its row sums stay float32).
// These stay inside chip_smoke.py's FLASH_TOL (bf16 rtol 1e-2, atol 4e-3;
// f16 2e-3, 2e-3; float32 3e-5): tests/test_torch_attention.py emulates
// each route's rounding on the CPU and holds it to the reference.
//
// The scale c must be > 0 (the wrapper folds a sign or a zero into q).
#include <cuda.h>  // CUtensorMap and the encoder's types; the encoder itself
                   // comes from the runtime (cudaGetDriverEntryPoint), no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
// 16-bit routes (bf16, f16): TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------

constexpr int kBr = 128;               // query rows per CTA (2 consumer warpgroups x 64)
constexpr int kBc = 128;               // keys per K/V tile
constexpr int kStages = 2;             // K/V ring depth
constexpr int kBoxBytes = 128 * 128;   // one TMA box: 128 rows x 64 bf16, swizzled
constexpr int kHalfThreads = 384;      // warpgroups 0, 1 consume; 2 loads
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

// T's two values of a 32-bit register, rounded to nearest
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>) {
    const __half2 p = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  } else {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
}

// ---- wgmma, as PTX: 64 rows x N columns, T (bf16 or f16) in, float32 accumulate ----
// AB is the operands' PTX type; the accumulator d is operands %0 ... %(N/2 - 1).

#define WG_REGS32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS64 WG_REGS32 \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_OUT32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_OUT64(d) WG_OUT32(d), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WG_REGS128 WG_REGS64 \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79" \
  ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" \
  ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111" \
  ", %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define WG_OUT128(d) WG_OUT64(d), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x 128) = A * B (+ d when scale_d): A and B from shared memory, both K-major.
#define WGMMA_SS_N128(AB)                                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" WG_REGS64 \
               "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                   \
               : WG_OUT64(d) : "l"(da), "l"(db), "r"(scale_d))
// d (64 x 64) = A * B (+ d when scale_d): both from shared memory, K-major.
#define WGMMA_SS_N64(AB)                                                           \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {" WG_REGS32  \
               "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                   \
               : WG_OUT32(d) : "l"(da), "l"(db), "r"(scale_d))
// d (64 x N) += A * B: A (64 x 16) from registers, B from shared memory,
// MN-major (transposed).
#define WGMMA_RS_N128(AB)                                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                         \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" WG_REGS64 \
               "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                      \
               : WG_OUT64(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define WGMMA_RS_N64(AB)                                                           \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                         \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {" WG_REGS32  \
               "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
               : WG_OUT32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define WGMMA_RS_N256(AB)                                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." AB "." AB " {" WG_REGS128 \
               "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                 \
               : WG_OUT128(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  if constexpr (std::is_same_v<T, __half>) {
    WGMMA_SS_N128("f16");
  } else {
    WGMMA_SS_N128("bf16");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  if constexpr (std::is_same_v<T, __half>) {
    WGMMA_SS_N64("f16");
  } else {
    WGMMA_SS_N64("bf16");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (std::is_same_v<T, __half>) {
    WGMMA_RS_N128("f16");
  } else {
    WGMMA_RS_N128("bf16");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (std::is_same_v<T, __half>) {
    WGMMA_RS_N64("f16");
  } else {
    WGMMA_RS_N64("bf16");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (std::is_same_v<T, __half>) {
    WGMMA_RS_N256("f16");
  } else {
    WGMMA_RS_N256("bf16");
  }
}

// s (64 x 128) = Q K^T over kSteps steps of 16 columns (32 bytes inside a
// box of 64 columns), plus s when `accumulate`: Q's 64 rows at qa and K's
// 128 keys at kb, in boxes of kBoxBytes.  The count is a constant: a
// wgmma skipped at run time would make the compiler move the accumulator
// between products and serialise them.
template <typename T, int kSteps>
__device__ __forceinline__ void qk_steps(float (&s)[64], uint32_t qa, uint32_t kb,
                                         bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n128<T>(s, sdesc(qa + off, 16, 1024), sdesc(kb + off, 16, 1024),
                     accumulate || kk > 0);
  }
}

// acc (64 x 64 kDB) += P V over a tile's 128 keys in steps of 16 rows of V
// (2048 bytes a step); V's kDB boxes at sv, P's packed A fragments in p.
template <typename T, int kDB>
__device__ __forceinline__ void pv_steps(float (&acc)[kDB * 32], const uint32_t (&p)[32],
                                         uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    const uint64_t db = sdesc(sv + kk * 2048, kBoxBytes, 1024);
    if constexpr (kDB == 2) {
      wgmma_rs_n128<T>(acc, a, db);
    } else {
      wgmma_rs_n64<T>(acc, a, db);
    }
  }
}

// One consumer thread's share of a key tile after its scores s: the
// online softmax, acc rescaled, P packed to T, then acc += P V from V's
// stage at sv once v_full has completed its phase; frees the stage.
template <typename T, int kDB>
__device__ __forceinline__ void tile_softmax_pv(float (&s)[64], float (&acc)[kDB * 32],
                                                float (&m)[2], float (&l)[2], float c,
                                                int key0, int row0, int S, int causal,
                                                bool mask, uint32_t v_full, uint32_t ph,
                                                uint32_t v_empty, uint32_t sv) {
  float alpha[2];
  softmax_tile<16>(s, m, l, alpha, c, key0, row0, S, causal != 0, mask);
  rescale(acc, alpha);
  // P as wgmma's A fragments: step kk takes keys 16 kk .. 16 kk + 15
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack2<T>(s[2 * i], s[2 * i + 1]);
  mbar_wait(v_full, ph);
  fence_regs(acc);
  fence_regs(p);
  wgmma_fence();
  pv_steps<T, kDB>(acc, p, sv);
  wgmma_commit();
  wgmma_wait();
  fence_regs(acc);
  fence_regs(p);
  mbar_arrive(v_empty);
}

// The thread's two rows of O = acc / l, columns col0 + (0 .. 64 kDB) below
// D, in T; o points at the head's (S, D) output.  kDB: 64-column boxes (4 in
// the wide kernel).
template <typename T, int kDB>
__device__ __forceinline__ void store_rows(T* __restrict__ o, const float (&acc)[kDB * 32],
                                           const float (&l)[2], int row0, int S, int D,
                                           int col0, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float denom = fmaxf(quad_sum(l[h]), 1e-30f);
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    T* out = o + static_cast<size_t>(row) * D + col0;
#pragma unroll
    for (int i = 0; i < kDB * 8; ++i) {
      const int col = 8 * i + 2 * (lane % 4);
      if (col0 + col < D) {
        *reinterpret_cast<uint32_t*>(out + col) =
            pack2<T>(acc[4 * i + 2 * h] / denom, acc[4 * i + 2 * h + 1] / denom);
      }
    }
  }
}

// kDB: 64-column boxes per row (1 for D <= 64, 2 for D <= 128).
template <typename T, int kDB>
__global__ void __launch_bounds__(kHalfThreads, 1)
attn_half_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, T* __restrict__ o, int S, int D,
                 float c, int causal) {
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

      // S = Q K^T over D in steps of 16 columns
      float s[64];
      mbar_wait(k_full(st), ph);
      wgmma_fence();
      qk_steps<T, 4 * kDB>(s, qa, sk + st * kTile, false);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      mbar_arrive(k_empty(st));

      const bool mask = k0 + kBc > S || (causal && k0 + kBc - 1 > q0 + 64 * wg);
      tile_softmax_pv<T, kDB>(s, acc, m, l, c, k0 + 2 * (lane % 4), row0, S, causal, mask,
                              v_full(st), ph, v_empty(st), sv + st * kTile);
    }
    store_rows<T, kDB>(o + static_cast<size_t>(bh) * S * D, acc, l, row0, S, D, 0, lane);
  }
}

// ---- the wide tile (D > 128) ----

constexpr int kWideCols = 256;             // columns of a slice of O and of a chunk of D
constexpr int kWideKeys = 64;              // keys per K/V tile
constexpr int kKeyBox = 64 * 128;          // one TMA box of K or V: 64 keys x 64 bf16, swizzled
constexpr int kWideQ = 4 * kBoxBytes;      // Q: 128 rows x 256 columns
constexpr int kWideTile = 4 * kKeyBox;     // K or V: 64 keys x 256 columns

// s (64 x 64) = Q K^T over kSteps steps of 16 columns, plus s when
// `accumulate`: Q's 64 rows at qa in boxes of kBoxBytes (128 rows), K's 64
// keys at kb in boxes of kKeyBox.  A constant count, as in qk_steps.
template <typename T, int kSteps>
__device__ __forceinline__ void qk_wide_steps(float (&s)[32], uint32_t qa, uint32_t kb,
                                              bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_n64<T>(s, sdesc(qa + (kk / 4) * kBoxBytes + col, 16, 1024),
                    sdesc(kb + (kk / 4) * kKeyBox + col, 16, 1024), accumulate || kk > 0);
  }
}

// qk_wide_steps over `boxes` (1 ... 4) 64-column boxes
template <typename T>
__device__ __forceinline__ void qk_wide(float (&s)[32], uint32_t qa, uint32_t kb, int boxes,
                                        bool accumulate) {
  switch (boxes) {
    case 1: qk_wide_steps<T, 4>(s, qa, kb, accumulate); break;
    case 2: qk_wide_steps<T, 8>(s, qa, kb, accumulate); break;
    case 3: qk_wide_steps<T, 12>(s, qa, kb, accumulate); break;
    default: qk_wide_steps<T, 16>(s, qa, kb, accumulate); break;
  }
}

// acc (64 x 256) += P V over a tile's 64 keys: P's A fragments in p (step
// kk takes keys 16 kk .. 16 kk + 15), V's stage at sv.
template <typename T>
__device__ __forceinline__ void pv_wide(float (&acc)[128], uint32_t (&p)[16], uint32_t sv) {
  fence_regs(acc);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_rs_n256<T>(acc, a, sdesc(sv + kk * 2048, kKeyBox, 1024));
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(acc);
  fence_regs(p);
}

// The 64-column boxes a chunk or slice of `cols` columns (clamped to 256) spans
__device__ __forceinline__ int wide_boxes(int cols) {
  return (min(kWideCols, cols) + 63) / 64;
}

// D > 128: one CTA a (head, q tile, 256-column slice of O), blockIdx.z the
// slice.  Ring item i is (key tile i / nc, chunk i % nc) of nc = ceil(D /
// 256) chunks of Q K^T: a K stage holds the chunk of the tile's 64 keys
// (and, when nc > 1, Q's chunk comes with it); a V stage the tile's keys in
// the CTA's slice.  When nc == 1 Q is loaded once, on q_full.
template <typename T>
__global__ void __launch_bounds__(kHalfThreads, 1)
attn_half_wide_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, T* __restrict__ o, int S, int D,
                      float c, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;          // Q: 4 boxes of 128 rows
  const uint32_t sk = sq + kWideQ;                     // K stage st at sk + st * kWideTile
  const uint32_t sv = sk + kStages * kWideTile;        // V stage st at sv + st * kWideTile
  const uint32_t bars = sv + kStages * kWideTile;      // 2 + 4 * kStages barriers of 8 bytes
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int st) { return bars + 8 * (2 + st); };
  auto v_full = [&](int st) { return bars + 8 * (2 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8 * (2 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8 * (2 + 3 * kStages + st); };

  const int bh = blockIdx.x;
  const int qt = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y) : static_cast<int>(blockIdx.y);
  const int col0 = kWideCols * static_cast<int>(blockIdx.z);  // this CTA's slice of O and V
  const int q0 = qt * kBr;
  const int n_k = (S + kWideKeys - 1) / kWideKeys;
  const int n_tiles = causal ? min(n_k, (q0 + kBr + kWideKeys - 1) / kWideKeys) : n_k;
  const int nc = (D + kWideCols - 1) / kWideCols;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      if (nc == 1) {
        const int boxes = wide_boxes(D);
        mbar_expect_tx(q_full, boxes * kBoxBytes);
        for (int b = 0; b < boxes; ++b) tma_load(sq + b * kBoxBytes, &tq, q_full, 64 * b, q0, bh);
      }
      int i = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int cc = 0; cc < nc; ++cc, ++i) {
          const int st = i % kStages;
          const int boxes = wide_boxes(D - kWideCols * cc);
          const uint32_t at = sk + st * kWideTile;
          mbar_wait(k_empty(st), ((i / kStages) & 1) ^ 1);
          if (nc > 1) {
            // Q's chunk replaces the last one once every consumer is done with it
            mbar_wait(q_empty, (i & 1) ^ 1);
            mbar_expect_tx(k_full(st), boxes * (kKeyBox + kBoxBytes));
            for (int b = 0; b < boxes; ++b)
              tma_load(sq + b * kBoxBytes, &tq, k_full(st), kWideCols * cc + 64 * b, q0, bh);
          } else {
            mbar_expect_tx(k_full(st), boxes * kKeyBox);
          }
          for (int b = 0; b < boxes; ++b)
            tma_load(at + b * kKeyBox, &tk, k_full(st), kWideCols * cc + 64 * b, t * kWideKeys,
                     bh);
        }
        // V's slice; a box wholly past D is not loaded (its stale columns
        // reach only columns of O that are not stored)
        const int st = t % kStages;
        const int boxes = wide_boxes(D - col0);
        mbar_wait(v_empty(st), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(v_full(st), boxes * kKeyBox);
        for (int b = 0; b < boxes; ++b)
          tma_load(sv + st * kWideTile + b * kKeyBox, &tv, v_full(st), col0 + 64 * b,
                   t * kWideKeys, bh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's first row
    const uint32_t qa = sq + wg * 64 * 128;                 // the warpgroup's 64 rows of Q
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    if (nc == 1) mbar_wait(q_full, 0);

    int i = 0;  // ring items (key tile, chunk) taken
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kWideKeys;
      // causal: the warpgroup's rows all come before the tile's first key
      const bool live = !causal || k0 <= q0 + 64 * wg + 63;
      float s[32];
      for (int cc = 0; cc < nc; ++cc, ++i) {
        const int st = i % kStages;
        mbar_wait(k_full(st), (i / kStages) & 1);
        if (live) {
          wgmma_fence();
          qk_wide<T>(s, qa, sk + st * kWideTile, wide_boxes(D - kWideCols * cc), cc > 0);
          wgmma_commit();
          wgmma_wait();
          fence_regs(s);
        }
        mbar_arrive(k_empty(st));
        if (nc > 1) mbar_arrive(q_empty);
      }
      const int st = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      if (live) {
        float alpha[2];
        const bool mask = k0 + kWideKeys > S || (causal && k0 + kWideKeys - 1 > q0 + 64 * wg);
        softmax_tile<8>(s, m, l, alpha, c, k0 + 2 * (lane % 4), row0, S, causal != 0, mask);
        rescale(acc, alpha);
        uint32_t p[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) p[j] = pack2<T>(s[2 * j], s[2 * j + 1]);
        mbar_wait(v_full(st), ph);
        pv_wide<T>(acc, p, sv + st * kWideTile);
      } else {
        mbar_wait(v_full(st), ph);  // the stage's phase must pass before it is freed
      }
      mbar_arrive(v_empty(st));
    }
    store_rows<T, 4>(o + static_cast<size_t>(bh) * S * D, acc, l, row0, S, D, col0, lane);
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

// D > 128 in float32: one CTA a (head, q tile, 256-column slice of O),
// blockIdx.z the slice, 16 warps (see the header).  Item i of the cp.async
// pipeline is (key tile i / nc, chunk i % nc) of nc = ceil(D / 256): K's
// chunk of the tile's 32 keys into K's stage i % 2; a tile's first item
// also brings V's slice of its keys into V's stage t % 2.  Q's chunk is
// staged once when nc == 1, else at the start of each item.
constexpr int kF32Parts = 4;  // warps sharing a row group, each its part of D
constexpr int kF32WideThreads = 128 * kF32Parts;  // 4 row groups of 16 rows: 16 warps
constexpr int kF32WideStride = kWideCols + 4;  // floats a staged row: 32 banks a fragment
constexpr int kPartial = 16 * kF32Keys;    // floats of a warp's partial score tile
constexpr int kPartSteps = kWideCols / 8 / kF32Parts;  // most 8-column steps of a part

// The 8-column steps [first, first + count) of `cols` columns that part
// `part` takes: the steps split as evenly as they go, the first parts the
// larger.
__device__ __forceinline__ void part_steps(int cols, int part, int& first, int& count) {
  const int steps = cols / 8, per = (steps + kF32Parts - 1) / kF32Parts;
  first = min(steps, part * per);
  count = min(steps, first + per) - first;
}

__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(32 * kF32Parts) : "memory");
}

__global__ void __launch_bounds__(kF32WideThreads, 1)
attn_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int S, int D, float c,
                     int causal) {
  constexpr int kStride = kF32WideStride;
  constexpr int kChunks = kWideCols / 4;  // 16-byte chunks per row of a chunk of D
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // (kF32Rows, kStride)
  float* ks = qs + kF32Rows * kStride;            // 2 stages of (kF32Keys, kStride)
  float* vs = ks + 2 * kF32Keys * kStride;        // 2 stages of (kF32Keys, kStride)
  float* xs = vs + 2 * kF32Keys * kStride;        // each warp's partial scores, kPartial each

  const int bh = blockIdx.x;
  const int qt = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y) : static_cast<int>(blockIdx.y);
  const int q0 = qt * kF32Rows;
  const int col0 = kWideCols * static_cast<int>(blockIdx.z);
  const int nc = (D + kWideCols - 1) / kWideCols;
  const size_t head = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int group = warp % 4, part = warp / 4;  // rows 16 group ..; part of D's columns

  auto load_q = [&](int cc) {
    for (int j = tid; j < kF32Rows * kChunks; j += kF32WideThreads) {
      const int r = j / kChunks, col = (j % kChunks) * 4, at = kWideCols * cc + col;
      const bool ok = q0 + r < S && at < D;
      cp16(qs + r * kStride + col, ok ? q + head + static_cast<size_t>(q0 + r) * D + at : q, ok);
    }
  };
  auto load_item = [&](int i) {
    const int t = i / nc, cc = i % nc, k0 = t * kF32Keys;
    float* kt = ks + (i % 2) * kF32Keys * kStride;
    float* vt = vs + (t % 2) * kF32Keys * kStride;
    for (int j = tid; j < kF32Keys * kChunks; j += kF32WideThreads) {
      const int r = j / kChunks, col = (j % kChunks) * 4;
      const size_t at = head + static_cast<size_t>(k0 + r) * D;
      const bool ok = k0 + r < S && kWideCols * cc + col < D;
      cp16(kt + r * kStride + col, ok ? k + at + kWideCols * cc + col : k, ok);
      if (cc == 0) {
        const bool v_ok = k0 + r < S && col0 + col < D;
        cp16(vt + r * kStride + col, v_ok ? v + at + col0 + col : v, v_ok);
      }
    }
  };
  const int n_k = (S + kF32Keys - 1) / kF32Keys;
  const int n_tiles = causal ? min(n_k, (q0 + kF32Rows + kF32Keys - 1) / kF32Keys) : n_k;
  const int n_items = n_tiles * nc;
  if (nc == 1) load_q(0);
  load_item(0);
  cp_commit();

  const int wrow = 16 * group;     // the group's first row in the CTA
  const int row0 = q0 + wrow + g;  // this thread's first row
  // P V: this part of the slice's columns, in blocks of 8
  int pv_first, pv_blocks;
  part_steps(min(kWideCols, D - col0), part, pv_first, pv_blocks);
  const int cv = 8 * pv_first;
  float acc[4 * kPartSteps];
#pragma unroll
  for (int i = 0; i < 4 * kPartSteps; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float s[16];

  for (int i = 0; i < n_items; ++i) {
    const int t = i / nc, cc = i % nc, k0 = t * kF32Keys;
    if (nc > 1) {  // the item before is done with Q's last chunk
      load_q(cc);
      cp_commit();
    }
    if (i + 1 < n_items) load_item(i + 1);
    cp_commit();
    cp_wait_all_but_one();  // item i (and Q's chunk) have landed
    __syncthreads();
    // a group whose rows all come before the tile's first key gets nothing from it
    if (!causal || k0 <= q0 + wrow + 15) {
      const float* kt = ks + (i % 2) * kF32Keys * kStride;
      if (cc == 0) {
#pragma unroll
        for (int j = 0; j < 16; ++j) s[j] = 0.0f;
      }
      // Q K^T over this warp's part of the chunk's columns
      int first, steps;
      part_steps(min(kWideCols, D - kWideCols * cc), part, first, steps);
      const int cq = 8 * first;
#pragma unroll
      for (int kk = 0; kk < kPartSteps; ++kk) {
        if (kk < steps) {
          const float* qa = qs + (wrow + g) * kStride + cq + 8 * kk + tg;
          uint32_t ab[4], as[4];
          split(qa[0], ab[0], as[0]);
          split(qa[8 * kStride], ab[1], as[1]);
          split(qa[4], ab[2], as[2]);
          split(qa[8 * kStride + 4], ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < kF32Keys / 8; ++j) {
            const float* kb = kt + (8 * j + g) * kStride + cq + 8 * kk + tg;
            uint32_t bb0, bs0, bb1, bs1;
            split(kb[0], bb0, bs0);
            split(kb[4], bb1, bs1);
            mma3(&s[4 * j], ab, as, bb0, bb1, bs0, bs1);
          }
        }
      }
      if (cc == nc - 1) {
        // the group's four partial sums, added in one order by each of its
        // warps: (x0 + x1) + (x2 + x3)
#pragma unroll
        for (int j = 0; j < 16; ++j) xs[warp * kPartial + 32 * j + lane] = s[j];
        group_sync(1 + group);
        const float* x = xs + group * kPartial + lane;  // part p's at x + 4 p kPartial
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float* xj = x + 32 * j;
          s[j] = (xj[0] + xj[4 * kPartial]) + (xj[8 * kPartial] + xj[12 * kPartial]);
        }

        const float* vt = vs + (t % 2) * kF32Keys * kStride;
        float alpha[2];
        const bool mask = k0 + kF32Keys > S || (causal && k0 + kF32Keys - 1 > q0 + wrow);
        softmax_tile<kF32Keys / 8>(s, m, l, alpha, c, k0 + 2 * tg, row0, S, causal != 0, mask);
        rescale(acc, alpha);
        // O += P V over this warp's columns, 8 keys a step (as attn_f32_kernel)
#pragma unroll
        for (int j = 0; j < kF32Keys / 8; ++j) {
          uint32_t pb[4], ps[4];
          split(s[4 * j], pb[0], ps[0]);
          split(s[4 * j + 2], pb[1], ps[1]);
          split(s[4 * j + 1], pb[2], ps[2]);
          split(s[4 * j + 3], pb[3], ps[3]);
          const float* vb = vt + (8 * j + 2 * tg) * kStride + cv + g;
#pragma unroll
          for (int n = 0; n < kPartSteps; ++n) {
            if (n < pv_blocks) {
              uint32_t bb0, bs0, bb1, bs1;
              split(vb[8 * n], bb0, bs0);
              split(vb[kStride + 8 * n], bb1, bs1);
              mma3(&acc[4 * n], pb, ps, bb0, bb1, bs0, bs1);
            }
          }
        }
      }
    }
    __syncthreads();  // the stages are read before the next prefetch overwrites them
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float denom = fmaxf(quad_sum(l[h]), 1e-30f);
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    float* out = o + head + static_cast<size_t>(row) * D + col0 + cv;
#pragma unroll
    for (int n = 0; n < kPartSteps; ++n) {
      if (n < pv_blocks) {
        *reinterpret_cast<float2*>(out + 8 * n + 2 * tg) =
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

// A (BH, S, D) tensor of 2-byte elements (`type` bf16 or f16) as (D, S,
// BH), in boxes of 64 columns x `rows` rows x 1 head with the 128-byte
// swizzle; out-of-range elements read as 0.
bool head_map(EncodeTiled encode, CUtensorMap* map, CUtensorMapDataType type, const void* x,
              int BH, int S, int D, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
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

// kDB 1 or 2: the narrow kernel; 0: the wide one (D > 128)
template <typename T, int kDB>
int launch_half(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
                float c, int causal, cudaStream_t s) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUtensorMapDataType type = std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // the wide kernel's K and V tiles are 64 keys; every other tile 128 rows
  const int kv_rows = kDB == 0 ? kWideKeys : kBc;
  CUtensorMap tq, tk, tv;
  if (!head_map(encode, &tq, type, q, BH, S, D, kBr) ||
      !head_map(encode, &tk, type, k, BH, S, D, kv_rows) ||
      !head_map(encode, &tv, type, v, BH, S, D, kv_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted = false;
  const unsigned q_tiles = static_cast<unsigned>((S + kBr - 1) / kBr);
  if constexpr (kDB == 0) {
    const auto kernel = attn_half_wide_kernel<T>;
    // Q, two K and two V stages, 1024 bytes to align them, the barriers
    const int smem = kWideQ + 2 * kStages * kWideTile + 1024 + 8 * (2 + 4 * kStages);
    if (const int err = opt_in(kernel, smem, opted)) return err;
    const dim3 grid(static_cast<unsigned>(BH), q_tiles,
                    static_cast<unsigned>((D + kWideCols - 1) / kWideCols));
    kernel<<<grid, kHalfThreads, smem, s>>>(tq, tk, tv, static_cast<T*>(o), S, D, c, causal);
  } else {
    const auto kernel = attn_half_kernel<T, kDB>;
    // the tiles, 1024 bytes to align them, the barriers
    const int smem = (1 + 2 * kStages) * kDB * kBoxBytes + 1024 + 8 * (1 + 4 * kStages);
    if (const int err = opt_in(kernel, smem, opted)) return err;
    const dim3 grid(static_cast<unsigned>(BH), q_tiles);
    kernel<<<grid, kHalfThreads, smem, s>>>(tq, tk, tv, static_cast<T*>(o), S, D, c, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_half_any(const void* q, const void* k, const void* v, void* o, int BH, int S,
                    int D, float c, int causal, cudaStream_t s) {
  if (D <= 64) return launch_half<T, 1>(q, k, v, o, BH, S, D, c, causal, s);
  if (D <= 128) return launch_half<T, 2>(q, k, v, o, BH, S, D, c, causal, s);
  return launch_half<T, 0>(q, k, v, o, BH, S, D, c, causal, s);
}

// kD 64 or 128: the narrow kernel; 0: the wide one (D > 128)
template <int kD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
               float c, int causal, cudaStream_t s) {
  const auto kernel = [] {
    if constexpr (kD == 0) {
      return attn_f32_wide_kernel;
    } else {
      return attn_f32_kernel<kD>;
    }
  }();
  // narrow: Q and two K and V stages; wide: the same at 256 columns and
  // the sixteen warps' partial scores
  const int smem = kD ? static_cast<int>(sizeof(float)) * (kF32Rows + 4 * kF32Keys) * (kD + 4)
                      : static_cast<int>(sizeof(float)) *
                            ((kF32Rows + 4 * kF32Keys) * kF32WideStride + 4 * kF32Parts * kPartial);
  static bool opted = false;
  if (const int err = opt_in(kernel, smem, opted)) return err;
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>((S + kF32Rows - 1) / kF32Rows),
                  kD ? 1u : static_cast<unsigned>((D + kWideCols - 1) / kWideCols));
  kernel<<<grid, kD ? kF32Threads : kF32WideThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, D, c, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (BH, S, D) contiguous, 16-byte aligned, of `dtype` 0
// (float32), 1 (bfloat16) or 2 (float16); D a multiple of 16; scale > 0.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int S, int D, float scale, int causal, int dtype,
                                      void* stream) {
  if (D <= 0 || D % 16 != 0 || (D + kWideCols - 1) / kWideCols > 65535 || !(scale > 0.0f) ||
      BH <= 0 || S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float c = scale * kLog2e;
  switch (dtype) {
    case 0:
      if (D <= 64) return launch_f32<64>(q, k, v, o, BH, S, D, c, causal, s);
      if (D <= 128) return launch_f32<128>(q, k, v, o, BH, S, D, c, causal, s);
      return launch_f32<0>(q, k, v, o, BH, S, D, c, causal, s);
    case 1:
      return launch_half_any<__nv_bfloat16>(q, k, v, o, BH, S, D, c, causal, s);
    case 2:
      return launch_half_any<__half>(q, k, v, o, BH, S, D, c, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
