// skim_fused: one-pass predicate evaluation + stable stream compaction.
//
// Replaces the Pallas kernel `skim_fused` of src/repro/kernels/skim_fused.py
// (body `_fused_kernel`, tiles stitched by `stitch_tiles`).
//
// What it computes, per window: the compiled predicate program over the
// padded inputs terms (T,E,K), valid/weights (G,E,K), then the payload
// rows (E,D) of the surviving events packed to the front in event order,
// the tail zeroed, and the survivor count.
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
//  * One thread per event, one 512-thread block per tile.  Each thread
//    runs eval_event, the predicate this kernel shares with
//    predicate_eval.cu (predicate.cuh).
//  * Compaction without the TPU's one-hot matmul: pass 1 writes each
//    warp's ballot word and each tile's survivor count; pass 2 gives each
//    survivor its row from the popcounts of the words before it and the
//    counts of the tiles before it, and copies the row as 32-bit words,
//    so the f32 event index in payload column 0 comes through exact.
#include "predicate.cuh"

namespace {

constexpr int kTile = 512;
constexpr int kWarps = kTile / 32;

// pass 1: the predicate -> ballot words (bit j of word w = event w*32+j)
// and one survivor count per tile
__global__ void skim_eval_kernel(Program p, Inputs in, uint32_t* words,
                                 int* tile_counts) {
  __shared__ int warp_counts[kWarps];
  const long long e = (long long)blockIdx.x * kTile + threadIdx.x;
  const bool pass = e < in.E && eval_event(p, e, in);
  const uint32_t ballot = __ballot_sync(0xffffffffu, pass);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_counts[warp] = __popc(ballot);
    if (e < in.E) words[e >> 5] = ballot;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    tile_counts[blockIdx.x] = total;
  }
}

// sum of v over the block (every thread gets it)
__device__ int block_sum(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  return total;
}

// pass 2: place each survivor's row at (tiles before) + (rank in tile);
// zero every row at or past the total
__global__ void skim_compact_kernel(const uint32_t* __restrict__ payload,
                                    const uint32_t* __restrict__ words,
                                    const int* __restrict__ tile_counts,
                                    int n_tiles, long long E, int D,
                                    uint32_t* __restrict__ out, int* total_out) {
  __shared__ int scratch[kWarps];
  __shared__ int warp_rank[kWarps];
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
    for (int d = 0; d < D; ++d) out[e * D + d] = 0u;
  }
  if (tile == 0 && threadIdx.x == 0) *total_out = all;
}

}  // namespace

extern "C" int skim_fused_launch(
    const float* terms, const float* valid, const float* weights,
    const float* payload, int T, int G, long long E, int K, int D,
    const int* groups, const int* term_ids, const int* ops, const float* thrs,
    const float* cmp_thrs, const int* rpn_op, const int* rpn_term,
    const float* rpn_const, uint32_t* words, int* tile_counts, float* out,
    int* total, void* stream) {
  (void)T;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (int)((E + kTile - 1) / kTile);
  Program p{groups, term_ids, ops, thrs, cmp_thrs, rpn_op, rpn_term, rpn_const, G};
  Inputs in{terms, valid, weights, E, K};
  skim_eval_kernel<<<n_tiles, kTile, 0, s>>>(p, in, words, tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  skim_compact_kernel<<<n_tiles, kTile, 0, s>>>(
      reinterpret_cast<const uint32_t*>(payload), words, tile_counts, n_tiles,
      E, D, reinterpret_cast<uint32_t*>(out), total);
  return (int)cudaGetLastError();
}
