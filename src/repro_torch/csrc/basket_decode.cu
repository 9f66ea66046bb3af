// basket_decode: decode of the `bitpack` basket codec, one launch per
// fetch round.
//
// Replaces the Pallas kernel `basket_decode` of
// src/repro/kernels/basket_decode.py (body `_decode_kernel`).
//
// What it computes, per basket: the codes from n_bits bit-planes of W
// uint32 words (code i is bit i%32 of word i/32 of every plane, plane j
// giving bit j), then the inverse transform of the codec kind:
//   kind 0 (int)   inverse zigzag, then a wrap-exact uint32 inclusive
//                  prefix sum seeded with `first`;
//   kind 1 (float) inclusive prefix xor seeded with `first` (the host
//                  reads the bits as float32);
//   kind 2 (bool)  the codes themselves.
// Kind 3 (raw literals) never reaches the card.  Each value is stored at
// the output's own width: 4 bytes (int32, float32 bits), 2 or 1 (the low
// bytes, as a narrowing integer cast), or a bool byte (value != 0).
//
// What bounds it on an H100: bytes.  It reads each plane word once and
// writes one value per code with a few integer operations each, so the
// least time is (planes + output) over 3.35 TB/s.  On the main path a
// round holds one 4096-value basket per branch of a fetch round (tens of
// KiB in all), so the launch dominates: the design's first aim is one
// launch per round instead of one per branch.
//
// Design:
//  * A round is a flat list of baskets of any kinds, widths and output
//    types: one 8-int descriptor per basket (kDesc* below), the firsts,
//    and the plane words of every basket back to back.  The host packs
//    all of it into one page-locked buffer, uploaded by one copy.
//  * Grid = the round's baskets, one CTA of 1024 threads (32 warps) each:
//    a basket is a dependent chain of warp instructions per word, and
//    with 4 warps (one per scheduler) a 4096-value basket took 14 us on
//    the card; 32 warps of 4 words each hide that latency.
//  * The basket's plane block (n_bits planes, `stride` words apart) comes
//    into shared memory by one 1-D bulk copy (cp.async.bulk, completing
//    on an mbarrier) when it fits one chunk of kChunkWords words a plane
//    and is 16-byte aligned and padded, as the host's staging makes it.
//    Otherwise (a basket wider than a chunk, or planes from a caller's
//    (N, B, W) tensor) each chunk comes in by 4-byte cp.async.
//  * The host gives planes an odd stride, so lane j reading plane j's
//    word w hits bank (j*stride + w) % 32: 32 lanes, 32 banks.
//  * Codes by warp ballots: for word w, lane j holds plane j's word (0
//    for j >= n_bits); ballot i of bit i over the lanes has bit j = bit
//    i of plane j's word, which is code 32w+i, and lane i keeps it.  One
//    load a lane a word, where a per-code rebuild would load n_bits words
//    for every code.
//  * Each warp owns 4 consecutive words of a chunk and keeps their 128
//    values in registers: each word scanned with shuffles on its own (the
//    words overlap: nothing is carried from one to the next), then the
//    words' totals scanned across the warp, the warps' totals across the
//    block through shared memory: one __syncthreads per chunk of up to
//    4096 values.
//  * All arithmetic is uint32 (the reference's sum wraps; signed
//    overflow would be undefined), `code >> 1` is logical, and float
//    payloads never pass through a float operation, so -0.0 and NaN bit
//    patterns come through exact.  Stores are coalesced at the output's
//    own width.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkWords = 128;             // words a plane a chunk: 4096 values
constexpr int kWarps = 32;                   // a CTA of 1024 threads
constexpr int kThreads = kWarps * 32;
constexpr int kWordsPerWarp = kChunkWords / kWarps;
constexpr int kSmemStride = kChunkWords + 1;  // odd: no bank conflicts

// descriptor fields (int32 each)
enum { kDescPlaneOff, kDescW, kDescStride, kDescBits, kDescKind, kDescOutOff,
       kDescStore, kDescN, kDescFields };
// kDescStore: out_bytes | kStoreBool | kStorePadded
constexpr int kStoreBool = 1 << 8;     // 1-byte output holding value != 0
constexpr int kStorePadded = 1 << 9;   // plane block padded to 16 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b, int kind) {
  return kind == 0 ? a + b : a ^ b;
}

// inclusive scan of x over the warp's lanes, by `kind`'s combine
__device__ __forceinline__ uint32_t warp_scan(uint32_t x, int lane, int kind) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = combine(y, x, kind);
  }
  return x;
}

// The warp's codes of one word: lane j holds plane j's word (0 past
// n_bits); ballot i of bit i over the lanes is code 32w+i, whose bit j
// is bit i of lane j's word, and lane i keeps it.
__device__ __forceinline__ uint32_t warp_codes(uint32_t x, int lane) {
  uint32_t code = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const uint32_t b = __ballot_sync(0xffffffffu, (x >> i) & 1u);
    code = lane == i ? b : code;
  }
  return code;
}

__device__ __forceinline__ void put(uint8_t* o, long long v, uint32_t x,
                                    int out_bytes, bool as_bool) {
  if (out_bytes == 4) {
    reinterpret_cast<uint32_t*>(o)[v] = x;
  } else if (out_bytes == 2) {
    reinterpret_cast<uint16_t*>(o)[v] = static_cast<uint16_t>(x);
  } else {
    o[v] = as_bool ? (x != 0u) : static_cast<uint8_t>(x);
  }
}

__global__ void __launch_bounds__(kThreads)
basket_decode_kernel(const int* __restrict__ descs,
                     const uint32_t* __restrict__ firsts,
                     const uint32_t* __restrict__ planes,
                     uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t sm[32 * kSmemStride];
  __shared__ __align__(8) uint64_t bar;
  __shared__ uint32_t warp_total[kWarps];

  const int* d = descs + (long long)blockIdx.x * kDescFields;
  const long long n = d[kDescN];
  const int W = d[kDescW], S = d[kDescStride], kind = d[kDescKind];
  const int n_bits = d[kDescBits] < 32 ? d[kDescBits] : 32;
  const int out_bytes = d[kDescStore] & 0xff;
  const bool as_bool = (d[kDescStore] & kStoreBool) != 0;
  if (n == 0 || W == 0) return;
  const uint32_t* src = planes + (unsigned)d[kDescPlaneOff];
  uint8_t* o = out + (unsigned)d[kDescOutOff];
  const uint32_t first = firsts[blockIdx.x];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // one bulk copy of the whole block: one chunk, 16-byte aligned, and
  // padded (or an exact multiple of 16 bytes) so the copy reads nothing
  // past the block's storage
  const unsigned block_bytes = (unsigned)n_bits * (unsigned)S * 4u;
  const unsigned bulk_bytes = (block_bytes + 15u) & ~15u;
  const bool bulk =
      n_bits > 0 && W <= kChunkWords && S <= kSmemStride &&
      (reinterpret_cast<uintptr_t>(src) & 15u) == 0 &&
      ((d[kDescStore] & kStorePadded) != 0 || bulk_bytes == block_bytes);
  const uint32_t bar_a = smem_u32(&bar);
  if (bulk) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar_a), "r"(1)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar_a), "r"(bulk_bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(smem_u32(sm)),
          "l"(reinterpret_cast<uint64_t>(src)), "r"(bulk_bytes),
          "r"(bar_a) : "memory");
    }
    __syncthreads();  // the barrier is initialised before anyone waits
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar_a), "r"(0) : "memory");
    }
  }

  uint32_t carry = 0;  // combine of every value of the earlier chunks
  for (int w0 = 0; w0 < W; w0 += kChunkWords) {
    const int cw = min(kChunkWords, W - w0);
    const int stride = bulk ? S : kSmemStride;
    if (!bulk) {
      for (int i = threadIdx.x; i < n_bits * cw; i += kThreads) {
        const int j = i / cw, w = i - j * cw;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         smem_u32(sm + j * kSmemStride + w)),
                     "l"(reinterpret_cast<uint64_t>(src + (long long)j * S + w0 + w))
                     : "memory");
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
    }
    // each word's 32 values, scanned within the word; the words of a warp
    // are independent here (no carried value), so their shuffles overlap
    const int wb = warp * kWordsPerWarp;
    uint32_t vals[kWordsPerWarp];
#pragma unroll
    for (int k = 0; k < kWordsPerWarp; ++k) {
      uint32_t x = 0;
      if (wb + k < cw) {  // uniform over the warp
        const uint32_t word = lane < n_bits ? sm[lane * stride + wb + k] : 0u;
        const uint32_t code = warp_codes(word, lane);
        x = kind == 0 ? (code >> 1) ^ (0u - (code & 1u)) : code;
        if (kind != 2) {
          if (w0 + wb + k == 0 && lane == 0) x = first;
          x = warp_scan(x, lane, kind);
        }
      }
      vals[k] = x;
    }
    if (kind != 2) {
      // the words' totals, lane k holding word k's, scanned over the
      // warp's words; the warps' totals scanned over the block
      uint32_t tot = 0;
#pragma unroll
      for (int k = 0; k < kWordsPerWarp; ++k) {
        const uint32_t t = __shfl_sync(0xffffffffu, vals[k], 31);
        if (lane == k) tot = t;
      }
      const uint32_t incl = warp_scan(tot, lane, kind);
      uint32_t excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0;
      if (lane == 31) warp_total[warp] = incl;
      __syncthreads();
      const uint32_t block =
          warp_scan(lane < kWarps ? warp_total[lane] : 0u, lane, kind);
      uint32_t before = __shfl_up_sync(0xffffffffu, block, 1);
      before = __shfl_sync(0xffffffffu, lane == 0 ? 0u : before, warp);
      const uint32_t prefix = combine(carry, before, kind);
      carry = combine(carry, __shfl_sync(0xffffffffu, block, 31), kind);
#pragma unroll
      for (int k = 0; k < kWordsPerWarp; ++k)
        vals[k] = combine(combine(prefix, __shfl_sync(0xffffffffu, excl, k), kind),
                          vals[k], kind);
    }
#pragma unroll
    for (int k = 0; k < kWordsPerWarp; ++k) {
      const long long v = (long long)(w0 + wb + k) * 32 + lane;
      if (wb + k < cw && v < n) put(o, v, vals[k], out_bytes, as_bool);
    }
    if (w0 + kChunkWords < W) __syncthreads();  // shared memory is reused
  }
}

}  // namespace

// descs (N, 8) int32, firsts (N,) uint32, planes and out as the
// descriptors address them; every pointer on the card, the stream's own
extern "C" int basket_decode_launch(const int* descs, const uint32_t* firsts,
                                    const uint32_t* planes, void* out, int N,
                                    void* stream) {
  if (N <= 0) return 0;
  basket_decode_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      descs, firsts, planes, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
