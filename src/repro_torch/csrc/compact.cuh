// compact.cuh: stable stream compaction by warp ballot and popcount.
//
// The whole of stream_compact.cu.  (skim_fused.cu compacts in one pass,
// by decoupled look-back, and no longer uses it.)
//
// Two passes over tiles of kTile events, one thread per event:
//  * pass 1 (ballot_tile, at the end of the caller's own kernel): the
//    warp ballots its 32 keep bits into one word (bit j of word w is
//    event w*32+j) and the block writes its tile's survivor count;
//  * pass 2 (compact_tile): each block sums the counts of the tiles
//    before its own, each survivor adds the popcounts of the words
//    before its bit, and the row is copied to that rank as raw bits of
//    the element's width U, so every payload value (NaN payloads, -0.0,
//    integers of any size) comes through exact.  Rows at or past the
//    total are zeroed.
//
// The TPU kernel instead moves each tile through a float32 one-hot
// matmul; nothing here passes a payload value through a float op.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;  // events per block
constexpr int kWarps = kTile / 32;

// pass 1's epilogue: every thread of the block calls it with its own
// event's keep bit (false past E).  `words` and `tile_count` are the
// window's ballot words and this tile's count slot.
__device__ __forceinline__ void ballot_tile(bool keep, long long e, long long E,
                                            uint32_t* __restrict__ words,
                                            int* __restrict__ tile_count,
                                            int* warp_counts) {
  const uint32_t ballot = __ballot_sync(0xffffffffu, keep);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_counts[warp] = __popc(ballot);
    if (e < E) words[e >> 5] = ballot;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    *tile_count = total;
  }
}

// sum of v over the block (every thread gets it)
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  return total;
}

// pass 2 for tile blockIdx.x of one window: place each survivor's row at
// (survivors of the tiles before) + (rank in the tile); zero every row at
// or past the window's total, which tile 0 writes to *total_out.
template <typename U>
__device__ __forceinline__ void compact_tile(const U* __restrict__ payload,
                                             const uint32_t* __restrict__ words,
                                             const int* __restrict__ tile_counts,
                                             int n_tiles, long long E, int D,
                                             U* __restrict__ out,
                                             int* __restrict__ total_out,
                                             int* scratch, int* warp_rank) {
  const int tile = blockIdx.x;
  int before = 0, all = 0;
  for (int t = threadIdx.x; t < n_tiles; t += kTile) {
    const int c = tile_counts[t];
    all += c;
    if (t < tile) before += c;
  }
  before = block_sum(before, scratch);
  all = block_sum(all, scratch);
  const long long e = (long long)tile * kTile + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t word = e < E ? words[e >> 5] : 0u;
  if (lane == 0) warp_rank[warp] = __popc(word);
  __syncthreads();
  int rank = __popc(word & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += warp_rank[w];
  if (e < E && ((word >> lane) & 1u)) {
    const long long dst = (long long)(before + rank) * D;
    for (int d = 0; d < D; ++d) out[dst + d] = payload[e * D + d];
  }
  if (e < E && e >= all) {
    for (int d = 0; d < D; ++d) out[e * D + d] = U(0);
  }
  if (tile == 0 && threadIdx.x == 0) *total_out = all;
}

}  // namespace
