// skim_fused: one-pass predicate evaluation + stable stream compaction,
// over a batch of windows, in one kernel.
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
// tens of KiB and the launch dominates: the design's aim is one launch
// per call, where the two-pass compaction took two.
//
// Design:
//  * The program is data, not code: the host flattens the frozen Program
//    into small int32/float32 descriptor arrays (see
//    repro_torch/kernels/skim_fused.py), so this one build serves every
//    cascade stage and every padded E.  The reference instead specializes
//    its kernel per program.
//  * One thread per event, a (ceil(E/512), B) grid of 512-thread tiles:
//    blockIdx.y is the window.  Each thread runs eval_event
//    (predicate.cuh), the predicate for one event read from device
//    memory; predicate_eval.cu evaluates the same program from shared
//    memory with lanes over the slots instead.
//  * Single-pass stable compaction by decoupled look-back, the one copy in
//    compact.cuh (stream_compact.cu runs it too): a tile takes its
//    ordinal from a ticket, zeroes its own output rows, ballots its keep
//    bits, and its first warp publishes its count and looks back for the
//    survivors before it; its survivors' rows then go to (exclusive
//    prefix + rank in the tile) as raw 32-bit words, so the f32 event
//    index in payload column 0 comes through exact.  The window's last
//    tile writes its total.  compact.cuh argues why zeroing before the
//    publish leaves every row below the total written once by a survivor.
//  * Status words and tickets live in the per-(device, stream) grow-only
//    workspace both compaction kernels share; each window has its own
//    ticket counter and its own run of status words.  (A cudaMemsetAsync
//    for the zero tail is one more device operation a call, and measured
//    slower on the card.)
//  * No tile constraint on E: the reference asserts E % tile == 0; here
//    each window's ragged last tile is masked.
#include "compact.cuh"
#include "predicate.cuh"

namespace {

constexpr int kTile = 512;  // events per tile
constexpr int kWarps = kTile / 32;

__global__ void __launch_bounds__(kTile)
skim_fused_kernel(Program p, Inputs batch, int T,
                  const uint32_t* __restrict__ payload, int D,
                  uint32_t* __restrict__ out, int* __restrict__ totals,
                  unsigned long long* __restrict__ status,
                  unsigned* __restrict__ tickets, unsigned epoch, int n_tiles) {
  __shared__ int warp_counts[kWarps];
  __shared__ int s_tile, s_excl;
  const long long b = blockIdx.y;
  const long long E = batch.E;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = take_ticket(tickets + b, n_tiles);
  __syncthreads();
  const int tile = s_tile;
  const long long e = (long long)tile * kTile + threadIdx.x;
  if (e < E) {  // the zero tail: this tile's own rows, before it publishes
    uint32_t* row = out + (b * E + e) * D;
    for (int d = 0; d < D; ++d) row[d] = 0u;
  }
  const bool keep = e < E && eval_event(p, e, window_inputs(batch, b, T, p.G));
  const uint32_t ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;  // survivors of the warps before; of the tile
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_counts[w];
    before += w < warp ? c : 0;
    total += c;
  }

  if (warp == 0) {  // the zeroes and the ballots precede the publish
    const int excl = look_back(status + b * n_tiles, tile, total, epoch);
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const int excl = s_excl;
  if (keep) {
    const long long rank = excl + before + __popc(ballot & ((1u << lane) - 1u));
    const uint32_t* src = payload + (b * E + e) * D;
    uint32_t* dst = out + (b * E + rank) * D;
    for (int d = 0; d < D; ++d) dst[d] = src[d];
  }
  if (tile == n_tiles - 1 && threadIdx.x == 0) totals[b] = excl + total;
}

}  // namespace

// `status` holds B * ceil(E/512) words carrying epochs below `epoch` (or
// 0) only, `tickets` B counters at 0; `out` is (B, E, D) rows and
// `totals` (B,) counts
extern "C" int skim_fused_launch(
    const float* terms, const float* valid, const float* weights,
    const float* payload, int B, int T, int G, long long E, int K, int D,
    const int* groups, const int* term_ids, const int* ops, const float* thrs,
    const float* cmp_thrs, const int* rpn_op, const int* rpn_term,
    const float* rpn_const, unsigned long long* status, unsigned* tickets,
    unsigned epoch, float* out, int* totals,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epoch == 0 || epoch >= (1u << 30)) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((E + kTile - 1) / kTile);
  Program p{groups, term_ids, ops, thrs, cmp_thrs, rpn_op, rpn_term, rpn_const, G};
  Inputs batch{terms, valid, weights, E, K};
  skim_fused_kernel<<<dim3((unsigned)n_tiles, (unsigned)B), kTile, 0, s>>>(
      p, batch, T, reinterpret_cast<const uint32_t*>(payload), D,
      reinterpret_cast<uint32_t*>(out), totals, status, tickets, epoch, n_tiles);
  return (int)cudaGetLastError();
}
