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
// zeroed, and its survivor count.  The payload is of any type of 1, 2, 4
// or 8 bytes (bool, uint8, int16, float16, bf16, int32, float32, int64,
// float64): its rows move as raw bits of that width.
//
// What bounds it on an H100: bytes.  Each input element is read once and
// used in a handful of compares (float64 ones for the group values); the
// work per byte is far below
// the card's compute/bandwidth ratio, so the least time is the bytes over
// 3.35 TB/s.  At the main path's shapes (E = 4096, D = 1) the inputs are
// tens of KiB and the launch dominates: the design's aim is one launch
// per call, where the two-pass compaction took two.
//
// Design:
//  * The program is data, not code: the host flattens the frozen Program
//    and its planes' kinds into small int32/float64 descriptor arrays (see
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
//    prefix + rank in the tile) as raw bits of the payload's width (the
//    kernel is a template on an unsigned integer of that width), so the
//    f32 event index in payload column 0 comes through exact, and so do
//    NaN, -0.0 and integers at or above 2^24, as in the JAX oracle
//    `ref.skim_fused_ref`; the TPU kernel's float32 one-hot matmul would
//    not keep them.  The window's last tile writes its total.  compact.cuh argues why zeroing before the
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

// U: an unsigned integer of the payload's element width
template <typename U>
__global__ void __launch_bounds__(kTile)
skim_fused_kernel(Program p, Inputs batch, int T,
                  const U* __restrict__ payload, int D,
                  U* __restrict__ out, int* __restrict__ totals,
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
    U* row = out + (b * E + e) * D;
    for (int d = 0; d < D; ++d) row[d] = U(0);
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
    const U* src = payload + (b * E + e) * D;
    U* dst = out + (b * E + rank) * D;
    for (int d = 0; d < D; ++d) dst[d] = src[d];
  }
  if (tile == n_tiles - 1 && threadIdx.x == 0) totals[b] = excl + total;
}

template <typename U>
cudaError_t launch(const Program& p, const Inputs& batch, int B, int T, const void* payload,
                   int D, void* out, int* totals, unsigned long long* status,
                   unsigned* tickets, unsigned epoch, int n_tiles, cudaStream_t s) {
  skim_fused_kernel<U><<<dim3((unsigned)n_tiles, (unsigned)B), kTile, 0, s>>>(
      p, batch, T, static_cast<const U*>(payload), D, static_cast<U*>(out), totals, status,
      tickets, epoch, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// `status` holds B * ceil(E/512) words carrying epochs below `epoch` (or
// 0) only, `tickets` B counters at 0; `payload` and `out` are (B, E, D)
// rows of `elem_bytes` (1, 2, 4 or 8) an element and `totals` (B,)
// counts; `kinds` the T term slots' plane kinds, then each term's aligned
// with `term_ids` (kernels/skim_fused.py::flatten_program).  Returns a CUDA
// error code, or cudaErrorInvalidValue for another width or epoch.
extern "C" int skim_fused_launch(
    const float* terms, const float* valid, const float* weights,
    const void* payload, int B, int T, int G, long long E, int K, int D, int elem_bytes,
    const int* groups, const int* term_ids, const int* ops, const int* kinds,
    const double* thrs, const double* cmp_thrs, const int* rpn_op, const int* rpn_term,
    const double* rpn_const, unsigned long long* status, unsigned* tickets,
    unsigned epoch, void* out, int* totals,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epoch == 0 || epoch >= (1u << 30)) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((E + kTile - 1) / kTile);
  Program p{groups, term_ids, ops, kinds + T, kinds, thrs, cmp_thrs, rpn_op, rpn_term,
            rpn_const, G};
  Inputs batch{terms, valid, weights, E, K};
  switch (elem_bytes) {
    case 1: return (int)launch<uint8_t>(p, batch, B, T, payload, D, out, totals, status,
                                        tickets, epoch, n_tiles, s);
    case 2: return (int)launch<uint16_t>(p, batch, B, T, payload, D, out, totals, status,
                                         tickets, epoch, n_tiles, s);
    case 4: return (int)launch<uint32_t>(p, batch, B, T, payload, D, out, totals, status,
                                         tickets, epoch, n_tiles, s);
    case 8: return (int)launch<uint64_t>(p, batch, B, T, payload, D, out, totals, status,
                                         tickets, epoch, n_tiles, s);
  }
  return (int)cudaErrorInvalidValue;
}
