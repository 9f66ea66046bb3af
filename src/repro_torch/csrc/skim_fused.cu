// skim_fused: one-pass predicate evaluation + stable stream compaction,
// over a batch of windows.
//
// Replaces the Pallas kernels `skim_fused` and `skim_fused_batch` of
// src/repro/kernels/skim_fused.py (bodies `_fused_kernel` and
// `_fused_kernel_batched`, tiles stitched by `stitch_tiles`): the
// single-window kernel is the B = 1 launch of this one.
//
// What it computes, per window b: the compiled predicate program over
// window b's slices of the padded inputs terms (B,T,E,K), valid/weights
// (B,G,E,K), then its payload rows (B,E,D) of the surviving events
// packed to the front of its own output slice in event order, the tail
// zeroed, and its survivor count.
//
// What bounds it on an H100: bytes.  Each input element is read once and
// used in a handful of float32 compares; the work per byte is far below
// the card's compute/bandwidth ratio, so the least time is the bytes over
// 3.35 TB/s.  At the main path's shapes (E = 4096, D = 1) the inputs are
// tens of KiB and the launch dominates; making it fast is later work.
//
// Design:
//  * The program is data, not code: the host flattens the frozen Program
//    into small int32/float32 descriptor arrays (see
//    repro_torch/kernels/skim_fused.py), so this one build serves every
//    cascade stage and every padded E.  The reference instead specializes
//    its kernel per program.
//  * One thread per event, a (ceil(E/512), B) grid of 512-thread blocks:
//    blockIdx.y is the window.  Each thread runs eval_event, the
//    predicate this kernel shares with predicate_eval.cu (predicate.cuh).
//  * Compaction without the TPU's one-hot matmul (compact.cuh, shared
//    with stream_compact.cu): pass 1 writes each warp's ballot word and
//    each tile's survivor count; pass 2 gives each survivor its row from
//    the popcounts of the words before it and the counts of the window's
//    own tiles before it, and copies the row as 32-bit words, so the f32
//    event index in payload column 0 comes through exact.
//  * No tile constraint on E: the reference asserts E % tile == 0; here
//    each window's ragged last tile is masked.
#include "compact.cuh"
#include "predicate.cuh"

namespace {

// pass 1: the predicate -> window b's ballot words and tile counts
__global__ void skim_eval_kernel(Program p, Inputs batch, int T, uint32_t* words,
                                 int* tile_counts) {
  __shared__ int warp_counts[kWarps];
  const long long b = blockIdx.y;
  const long long e = (long long)blockIdx.x * kTile + threadIdx.x;
  const bool pass =
      e < batch.E && eval_event(p, e, window_inputs(batch, b, T, p.G));
  const long long n_words = (batch.E + 31) >> 5;
  ballot_tile(pass, e, batch.E, words + b * n_words,
              tile_counts + b * gridDim.x + blockIdx.x, warp_counts);
}

// pass 2: window b's rows, ranked within the window
__global__ void skim_compact_kernel(const uint32_t* __restrict__ payload,
                                    const uint32_t* __restrict__ words,
                                    const int* __restrict__ tile_counts,
                                    int n_tiles, long long E, int D,
                                    uint32_t* __restrict__ out, int* totals) {
  __shared__ int scratch[kWarps];
  __shared__ int warp_rank[kWarps];
  const long long b = blockIdx.y;
  const long long rows = b * E * D;
  compact_tile<uint32_t>(payload + rows, words + b * ((E + 31) >> 5),
                         tile_counts + b * n_tiles, n_tiles, E, D, out + rows,
                         totals + b, scratch, warp_rank);
}

}  // namespace

extern "C" int skim_fused_launch(
    const float* terms, const float* valid, const float* weights,
    const float* payload, int B, int T, int G, long long E, int K, int D,
    const int* groups, const int* term_ids, const int* ops, const float* thrs,
    const float* cmp_thrs, const int* rpn_op, const int* rpn_term,
    const float* rpn_const, uint32_t* words, int* tile_counts, float* out,
    int* totals, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (int)((E + kTile - 1) / kTile);
  const dim3 grid((unsigned)n_tiles, (unsigned)B);
  Program p{groups, term_ids, ops, thrs, cmp_thrs, rpn_op, rpn_term, rpn_const, G};
  Inputs batch{terms, valid, weights, E, K};
  skim_eval_kernel<<<grid, kTile, 0, s>>>(p, batch, T, words, tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  skim_compact_kernel<<<grid, kTile, 0, s>>>(
      reinterpret_cast<const uint32_t*>(payload), words, tile_counts, n_tiles,
      E, D, reinterpret_cast<uint32_t*>(out), totals);
  return (int)cudaGetLastError();
}
