// compact.cuh: single-pass stable stream compaction by decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016), shared by skim_fused.cu and stream_compact.cu.
//
// A tile of events learns where its survivors go (the survivors of every
// tile before it) in the same launch that finds them:
//  * take_ticket: a tile takes its ordinal in its window from an
//    atomicAdd ticket, not from blockIdx.x, so every tile it waits on has
//    been scheduled already and the look-back cannot deadlock.  The tile
//    that takes the last ticket sets the counter back to 0.
//  * look_back (the tile's first warp): publish the tile's survivor count
//    as a flagged 64-bit status word (flag A), then read the predecessors'
//    words 32 at a time, summing aggregates back to the nearest inclusive
//    prefix (flag P), and publish the tile's own inclusive prefix.
//    Release stores and acquire loads at GPU scope order each tile's
//    earlier writes before what a later tile does after reading its word.
//  * Status words carry the call's epoch in their high bits: a word left
//    by an earlier call reads as "not published", so nothing is cleared
//    between calls (the host's workspace hands out the epochs,
//    repro_torch/kernels/skim_fused.py `Workspace`).
//
// The zero tail needs no second pass either: each tile zeroes its own
// range of output rows before it publishes.  A survivor lands at a row no
// later than its own event, so a row of tile t's range is only ever
// written by tile t or a later one, and a later one writes only after
// acquiring a prefix that covers t: a chain of release/acquire pairs back
// to t's publish, which the zeroes precede (same CTA, __syncthreads).
// Rows below the window's total are thus zeroed, then overwritten by
// exactly one survivor each.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// status word: epoch << 34 | flag << 32 | count
constexpr int kEpochShift = 34;
constexpr unsigned long long kFlagAggregate = 1ull << 32;
constexpr unsigned long long kFlagPrefix = 2ull << 32;

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(reinterpret_cast<uint64_t>(p)),
               "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(reinterpret_cast<uint64_t>(p)) : "memory");
  return v;
}

// this tile's ordinal in its window (one counter a window)
__device__ __forceinline__ int take_ticket(unsigned* ticket, int n_tiles) {
  const unsigned t = atomicAdd(ticket, 1u);
  if (t == (unsigned)n_tiles - 1u) atomicExch(ticket, 0u);
  return (int)t;
}

// Every lane of one warp calls it, after the block's writes that must
// precede the publish (a __syncthreads between).  `st` holds the window's
// status words, one a tile; `total` is this tile's survivor count.
// Returns the survivors of the tiles before this one, in every lane.
__device__ __forceinline__ int look_back(unsigned long long* st, int tile, int total,
                                         unsigned epoch) {
  const int lane = threadIdx.x & 31;
  const unsigned long long tag = (unsigned long long)epoch << kEpochShift;
  if (tile == 0) {
    if (lane == 0) store_release(st, tag | kFlagPrefix | (unsigned)total);
    return 0;
  }
  if (lane == 0) store_release(st + tile, tag | kFlagAggregate | (unsigned)total);
  int excl = 0;
  for (int j = tile - 1;; j -= 32) {  // j: the nearest tile not yet summed
    const int k = j - lane;
    unsigned long long s = 0;
    unsigned flag = 0;
    if (k >= 0) {
      do {
        s = load_acquire(st + k);
        flag = (s >> kEpochShift) == epoch ? (unsigned)(s >> 32) & 3u : 0u;
      } while (flag == 0);
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, flag == 2u);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    int v = (k >= 0 && lane <= stop) ? (int)(s & 0xffffffffu) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    excl += v;
    if (prefixes) break;  // tile 0 always publishes a prefix
  }
  if (lane == 0) store_release(st + tile, tag | kFlagPrefix | (unsigned)(excl + total));
  return excl;
}

}  // namespace
