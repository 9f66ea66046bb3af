// predicate_eval: the predicate program over a batch of windows, and the
// batched cascade stage with its epilogue fused in.
//
// Replaces the Pallas kernel `predicate_eval_batch` of
// src/repro/kernels/predicate_eval.py (body `_predicate_kernel_batched`)
// together with the jnp epilogue of `_cascade_stage_impl`
// (src/repro/kernels/ops.py), and `predicate_eval` of the same file
// (body `_predicate_kernel`) as its B = 1 case.
//
// What it computes:
//  * cascade_stage_launch, the batched cascade's stage step: for window b
//    and event e, alive = bit e of the carried mask packed[b] AND the
//    program over window b's slices of terms (B,T,E,K), valid/weights
//    (B,G,E,K).  The new bits overwrite packed[b] in place (bit j of
//    word w is event w*32+j, the reference's layout and the ballot's lane
//    order); out[b, 0:nb] gets 1 at every basket ordinal seg_ids[b,e] of
//    a surviving event and out[b, nb] the window's survivor count.  Only
//    that (B, nb+1) buffer has to cross back to the host per stage; the
//    event mask stays on the card.
//  * predicate_eval_launch: the (B, E) int32 mask alone.
//
// What bounds it on an H100: bytes.  Each input element is read once and
// feeds a few float32 compares, far below the card's compute/bandwidth
// ratio, so the least time is 4*B*((T+2G)*E*K + E + 2*E/32 + nb + 1)
// bytes over 3.35 TB/s.  At the batched path's shapes (B = 16, E = 4096)
// the inputs are a few MiB; this first kernel is simple and right, not
// tuned (no shared-memory staging of the slices, no TMA).
//
// Design:
//  * One thread per event, a (ceil(E/512), B) grid of 512-thread blocks;
//    thread (b, e) runs eval_event (predicate.cuh, shared with
//    skim_fused.cu) on window b's slices.  An event already dead in the
//    carried mask is not evaluated: the AND would drop it anyway.
//  * The epilogue stays in registers: the warp ballots its 32 survivor
//    bits into one word, popcounts it, the block sums the warps in shared
//    memory and adds its total to the window's count with one atomicAdd;
//    a surviving event sets its basket bit with atomicOr, skipped when
//    the bit is already visibly set (a stale read only costs a redundant
//    atomic).  Integer atomics are exact and commute, so the outputs do
//    not depend on the order blocks run in.  The launch zeroes `out`
//    with cudaMemsetAsync on the same stream first.
//  * No tile constraint on E: the reference asserts E % 1024 == 0, while
//    this kernel masks its own ragged edge.  The cascade stage needs
//    E % 32 == 0 (whole mask words; the wrapper checks), the mask launch
//    takes any E.
#include "predicate.cuh"

namespace {

constexpr int kTile = 512;
constexpr int kWarps = kTile / 32;

__global__ void cascade_stage_kernel(Program p, Inputs batch, int T,
                                     uint32_t* __restrict__ packed,
                                     const int* __restrict__ seg_ids, int nb,
                                     int* __restrict__ out) {
  __shared__ int warp_counts[kWarps];
  const long long b = blockIdx.y;
  const long long e = (long long)blockIdx.x * kTile + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in_range = e < batch.E;
  uint32_t* word = packed + b * (batch.E >> 5) + (e >> 5);
  bool alive = in_range && ((*word >> lane) & 1u);
  if (alive) alive = eval_event(p, e, window_inputs(batch, b, T, p.G));
  const uint32_t ballot = __ballot_sync(0xffffffffu, alive);
  int* row = out + b * (nb + 1);
  if (lane == 0) {
    warp_counts[warp] = __popc(ballot);
    if (in_range) *word = ballot;  // every lane has read it: the ballot
                                   // waited for their loads
  }
  if (alive) {
    const int s = seg_ids[b * batch.E + e];
    if (s >= 0 && s < nb && row[s] == 0) atomicOr(row + s, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    if (total) atomicAdd(row + nb, total);
  }
}

__global__ void predicate_eval_kernel(Program p, Inputs batch, int T,
                                      int* __restrict__ out) {
  const long long b = blockIdx.y;
  const long long e = (long long)blockIdx.x * kTile + threadIdx.x;
  if (e >= batch.E) return;
  out[b * batch.E + e] =
      eval_event(p, e, window_inputs(batch, b, T, p.G)) ? 1 : 0;
}

dim3 grid_of(int B, long long E) {
  return dim3((unsigned)((E + kTile - 1) / kTile), (unsigned)B);
}

}  // namespace

extern "C" int cascade_stage_launch(
    const float* terms, const float* valid, const float* weights, int B,
    int T, int G, long long E, int K, const int* groups, const int* term_ids,
    const int* ops, const float* thrs, const float* cmp_thrs,
    const int* rpn_op, const int* rpn_term, const float* rpn_const,
    uint32_t* packed, const int* seg_ids, int nb, int* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(int) * (size_t)B * (size_t)(nb + 1), s);
  if (err != cudaSuccess) return (int)err;
  Program p{groups, term_ids, ops, thrs, cmp_thrs, rpn_op, rpn_term, rpn_const, G};
  Inputs batch{terms, valid, weights, E, K};
  cascade_stage_kernel<<<grid_of(B, E), kTile, 0, s>>>(p, batch, T, packed,
                                                      seg_ids, nb, out);
  return (int)cudaGetLastError();
}

extern "C" int predicate_eval_launch(
    const float* terms, const float* valid, const float* weights, int B,
    int T, int G, long long E, int K, const int* groups, const int* term_ids,
    const int* ops, const float* thrs, const float* cmp_thrs,
    const int* rpn_op, const int* rpn_term, const float* rpn_const, int* out,
    void* stream) {
  Program p{groups, term_ids, ops, thrs, cmp_thrs, rpn_op, rpn_term, rpn_const, G};
  Inputs batch{terms, valid, weights, E, K};
  predicate_eval_kernel<<<grid_of(B, E), kTile, 0,
                          static_cast<cudaStream_t>(stream)>>>(p, batch, T, out);
  return (int)cudaGetLastError();
}
