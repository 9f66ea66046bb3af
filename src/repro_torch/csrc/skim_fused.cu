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
//    blockIdx.y is the window.  Each thread runs eval_event, the
//    predicate this kernel shares with predicate_eval.cu (predicate.cuh).
//  * Single-pass stable compaction by decoupled look-back (Merrill &
//    Garland, "Single-pass Parallel Prefix Scan with Decoupled
//    Look-back", 2016).  A tile takes its ordinal in its window from an
//    atomicAdd ticket, not from blockIdx.x, so every tile it waits on has
//    been scheduled already.  It ballots its keep bits, publishes its
//    survivor count as a flagged 64-bit status word (flag A), and its
//    first warp looks back over its predecessors 32 at a time: aggregates
//    are summed until the nearest inclusive prefix (flag P).  It then
//    publishes its own inclusive prefix and copies its survivors' rows to
//    (exclusive prefix + rank in the tile) as raw 32-bit words, so the
//    f32 event index in payload column 0 comes through exact.
//  * Status words and tickets live in a per-(device, stream) grow-only
//    workspace.  Status words carry the call's epoch in their high bits:
//    a word of another call reads as "not published", so nothing is
//    cleared between calls; the last tile to take a window's ticket sets
//    its counter back to 0.
//  * The zero tail, in the kernel: each tile zeroes its own range of
//    output rows before it publishes its status.  A survivor lands at a
//    row no later than its own event, so a row of tile t's range is only
//    ever written by tile t or a later one, and a later one writes only
//    after acquiring a prefix that covers t: a chain of release/acquire
//    pairs back to t's publish, which the zeroes precede (same CTA,
//    __syncthreads).  Rows below the window's total are thus zeroed,
//    then overwritten by exactly one survivor each.  (A cudaMemsetAsync
//    before the kernel does the same as one more device operation a
//    call, and measured slower on the card.)  The window's last tile
//    writes its total.
//  * No tile constraint on E: the reference asserts E % tile == 0; here
//    each window's ragged last tile is masked.
//  * The two-pass compaction (compact.cuh) stays for stream_compact.cu.
#include "predicate.cuh"

namespace {

constexpr int kTile = 512;  // events per tile
constexpr int kWarps = kTile / 32;

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

// this tile's ordinal in its window.  The tile that takes the window's
// last ticket sets the counter back to 0 for the next launch: every
// other tile of the window has taken its ticket by then.
__device__ __forceinline__ int take_ticket(unsigned* ticket, int n_tiles) {
  const unsigned t = atomicAdd(ticket, 1u);
  if (t == (unsigned)n_tiles - 1u) atomicExch(ticket, 0u);
  return (int)t;
}

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

  unsigned long long* st = status + b * n_tiles;
  const unsigned long long tag = (unsigned long long)epoch << kEpochShift;
  if (warp == 0) {
    int excl = 0;
    if (tile == 0) {
      if (lane == 0) store_release(st, tag | kFlagPrefix | (unsigned)total);
    } else {
      if (lane == 0) store_release(st + tile, tag | kFlagAggregate | (unsigned)total);
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
        if (prefixes) break;
      }
      if (lane == 0)
        store_release(st + tile, tag | kFlagPrefix | (unsigned)(excl + total));
    }
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
