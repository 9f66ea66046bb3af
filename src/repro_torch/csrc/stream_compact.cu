// stream_compact: stable compaction of the rows of a payload where a mask
// is set.
//
// Replaces the Pallas kernel `stream_compact` of
// src/repro/kernels/stream_compact.py (body `_compact_kernel`, tiles
// stitched by the `jax.lax.scan` after it).
//
// What it computes: the rows e of payload (E, D) with mask[e] != 0
// packed to the front in event order, every later row zeroed, and the
// count.  Any E (the last tile's ragged edge is masked), any D >= 1, any
// element width of 1, 2, 4 or 8 bytes (bool, bfloat16, float32, int32,
// int64, float64 ...), a bool or int32 mask.
//
// What bounds it on an H100: bytes.  It reads the payload and the mask
// once and writes the packed payload once; per element it does no
// arithmetic at all, so the least time is those bytes over 3.35 TB/s.
// This first kernel is simple and right, not tuned: one thread copies its
// own row element by element, so the stores of a warp are strided by D.
//
// Design: the ballot-and-popcount compaction of compact.cuh, shared with
// skim_fused.cu.  Pass 1 ballots `mask[e] != 0` into 32-bit words and
// counts per tile; pass 2 ranks and copies.  Rows move as raw bits of
// their element width: the TPU kernel moves them through a float32 one-hot
// matmul instead, which spreads a NaN over its tile, turns -0.0 into +0.0
// and rounds integers at or above 2^24.  This kernel follows the JAX
// oracle `ref.stream_compact_ref`, which keeps every bit, and keeps rows
// where the mask is nonzero, as the oracle does (the Pallas kernel keeps
// mask > 0).
#include "compact.cuh"

namespace {

template <typename M>
__global__ void compact_mask_kernel(const M* __restrict__ mask, long long E,
                                    uint32_t* words, int* tile_counts) {
  __shared__ int warp_counts[kWarps];
  const long long e = (long long)blockIdx.x * kTile + threadIdx.x;
  const bool keep = e < E && mask[e] != M(0);
  ballot_tile(keep, e, E, words, tile_counts + blockIdx.x, warp_counts);
}

template <typename U>
__global__ void compact_rows_kernel(const U* __restrict__ payload,
                                    const uint32_t* __restrict__ words,
                                    const int* __restrict__ tile_counts,
                                    int n_tiles, long long E, int D,
                                    U* __restrict__ out, int* total) {
  __shared__ int scratch[kWarps];
  __shared__ int warp_rank[kWarps];
  compact_tile<U>(payload, words, tile_counts, n_tiles, E, D, out, total,
                  scratch, warp_rank);
}

template <typename U>
cudaError_t launch_rows(const void* payload, const uint32_t* words,
                        const int* tile_counts, int n_tiles, long long E, int D,
                        void* out, int* total, cudaStream_t s) {
  compact_rows_kernel<U><<<n_tiles, kTile, 0, s>>>(
      static_cast<const U*>(payload), words, tile_counts, n_tiles, E, D,
      static_cast<U*>(out), total);
  return cudaGetLastError();
}

}  // namespace

// mask_bytes: 1 (bool) or 4 (int32); elem_bytes: 1, 2, 4 or 8.  Returns
// a CUDA error code, or cudaErrorInvalidValue for another width.
extern "C" int stream_compact_launch(const void* payload, const void* mask,
                                     int mask_bytes, long long E, int D,
                                     int elem_bytes, uint32_t* words,
                                     int* tile_counts, void* out, int* total,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (int)((E + kTile - 1) / kTile);
  if (mask_bytes == 1) {
    compact_mask_kernel<uint8_t><<<n_tiles, kTile, 0, s>>>(
        static_cast<const uint8_t*>(mask), E, words, tile_counts);
  } else if (mask_bytes == 4) {
    compact_mask_kernel<int32_t><<<n_tiles, kTile, 0, s>>>(
        static_cast<const int32_t*>(mask), E, words, tile_counts);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (elem_bytes) {
    case 1: err = launch_rows<uint8_t>(payload, words, tile_counts, n_tiles, E, D, out, total, s); break;
    case 2: err = launch_rows<uint16_t>(payload, words, tile_counts, n_tiles, E, D, out, total, s); break;
    case 4: err = launch_rows<uint32_t>(payload, words, tile_counts, n_tiles, E, D, out, total, s); break;
    case 8: err = launch_rows<uint64_t>(payload, words, tile_counts, n_tiles, E, D, out, total, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
