// stream_compact: stable compaction of the rows of a payload where a mask
// is set, in one kernel.
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
// What bounds it on an H100: bytes.  It reads the mask and the kept rows
// once and writes the whole output once (kept rows, then the zero tail);
// per element it does no arithmetic at all, so the least time is those
// bytes over 3.35 TB/s.  At a low keep rate the output's zeroes are most
// of them: the kernel is a memset with a scan in it.
//
// Design: one launch, one pass, by the decoupled look-back of
// compact.cuh (shared with skim_fused.cu).  A block of 512 threads (four
// blocks an SM) takes a tile of 2048 events by ticket, then
//  * zeroes its own output rows, [tile*2048, +2048) x D x width bytes, in
//    16-byte stores (single bytes past the last whole 16);
//  * reads its mask 16 bytes a lane where the mask is 16-byte aligned
//    (16 bool or 4 int32 entries), element by element otherwise, and ORs
//    the lanes' keep bits into 32-bit words (bit j of word w is event
//    w*32+j of the tile);
//  * ranks the kept events by a scan of the words' popcounts and lists
//    them in shared memory in rank order;
//  * publishes its count and looks back (its first warp) for the
//    survivors of the tiles before it;
//  * moves its survivors by the block: thread f of the flat range
//    [0, kept x R) writes unit f of the tile's packed rows, so
//    consecutive threads write consecutive output.  A unit is 16 bytes
//    where a row is a multiple of 16 bytes and both buffers are 16-byte
//    aligned (R = D*width/16), else one element (R = D).
// Rows move as raw bits of their width: the TPU kernel moves them through
// a float32 one-hot matmul instead, which spreads a NaN over its tile,
// turns -0.0 into +0.0 and rounds integers at or above 2^24.  This kernel
// follows the JAX oracle `ref.stream_compact_ref`, which keeps every bit,
// and keeps rows where the mask is nonzero, as the oracle does (the
// Pallas kernel keeps mask > 0).
#include "compact.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kTile = 2048;  // events a tile
constexpr int kWords = kTile / 32;
static_assert(kWords % 32 == 0 && kTile % 512 == 0 && kTile <= 65536,
              "whole words a lane, whole 16-byte mask reads a warp, 16-bit ranks");

// zero the bytes [0, n) at p, which is 16-byte aligned (the output is a
// fresh allocation and a tile's rows start at a multiple of 2048 rows),
// with the block's threads: 16-byte stores, then single bytes at the end
__device__ __forceinline__ void zero_bytes(char* p, long long n) {
  uint4* body = reinterpret_cast<uint4*>(p);
  const long long n_vec = n >> 4;
  for (long long i = threadIdx.x; i < n_vec; i += kThreads) body[i] = make_uint4(0, 0, 0, 0);
  for (long long i = (n_vec << 4) + threadIdx.x; i < n; i += kThreads) p[i] = 0;
}

// The tile's keep bits (mask != 0) into words[0, kWords).  A warp reads
// 512 bytes of mask at once, V entries a lane (16 bytes) where `vec` (the
// mask is 16-byte aligned) and the lane's entries all lie below E; the
// 32 / V lanes of one word OR their bits together by shuffles.
template <typename M>
__device__ __forceinline__ void load_mask(const M* __restrict__ mask, long long e0,
                                          long long E, bool vec, uint32_t* words) {
  constexpr int V = 16 / sizeof(M);  // entries a lane
  constexpr int kGroup = 32 / V;     // lanes a word
  constexpr int kChunks = kTile / (32 * V);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < kChunks; c += kThreads / 32) {
    const int first = (c * 32 + lane) * V;  // the lane's first entry in the tile
    const long long e = e0 + first;
    uint32_t bits = 0;
    if (vec && e + V <= E) {
      const uint4 x = *reinterpret_cast<const uint4*>(mask + e);
      const M* m = reinterpret_cast<const M*>(&x);
#pragma unroll
      for (int j = 0; j < V; ++j) bits |= (uint32_t)(m[j] != M(0)) << j;
    } else {
      for (int j = 0; j < V && e + j < E; ++j) bits |= (uint32_t)(mask[e + j] != M(0)) << j;
    }
    bits <<= first & 31;
#pragma unroll
    for (int off = 1; off < kGroup; off <<= 1) bits |= __shfl_xor_sync(kFull, bits, off);
    if (lane % kGroup == 0) words[first >> 5] = bits;
  }
}

// The tile's kept rows, in rank order, to dst: R units of type T a row,
// `kept[j]` the tile-local event of survivor j.  Thread f writes unit f;
// (j, r) = divmod(f, R) advances by (kThreads / R, kThreads % R) a step.
template <typename T>
__device__ __forceinline__ void copy_rows(const T* __restrict__ src, T* __restrict__ dst,
                                          const unsigned short* kept, int count,
                                          long long R) {
  const long long n = count * R;
  if (threadIdx.x >= n) return;
  long long j = threadIdx.x / R, r = threadIdx.x % R;
  const long long dj = kThreads / R, dr = kThreads % R;
  for (long long f = threadIdx.x; f < n; f += kThreads) {
    dst[f] = src[kept[j] * R + r];
    j += dj;
    r += dr;
    if (r >= R) {
      r -= R;
      ++j;
    }
  }
}

// four blocks an SM (at most 32 registers a thread): every tile of
// 1,000,000 events is resident at once, with no second, part-empty wave
template <typename M, typename U>
__global__ void __launch_bounds__(kThreads, 4)
stream_compact_kernel(const U* __restrict__ payload, const M* __restrict__ mask,
                      long long E, int D, bool vec_mask, bool vec_rows,
                      U* __restrict__ out, int* __restrict__ total,
                      unsigned long long* __restrict__ status,
                      unsigned* __restrict__ ticket, unsigned epoch, int n_tiles) {
  __shared__ uint32_t words[kWords];
  __shared__ int before[kWords];         // kept events of the tile's words before
  __shared__ unsigned short kept[kTile];  // tile-local kept events, rank order
  __shared__ int s_tile, s_count, s_excl;
  if (threadIdx.x == 0) s_tile = take_ticket(ticket, n_tiles);
  __syncthreads();
  const int tile = s_tile;
  const long long e0 = (long long)tile * kTile;
  const long long n = min((long long)kTile, E - e0);
  // the zero tail: this tile's own rows, before it publishes
  zero_bytes(reinterpret_cast<char*>(out + e0 * D), n * D * (long long)sizeof(U));
  load_mask<M>(mask, e0, E, vec_mask, words);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {  // exclusive scan of the words' counts, kWords/32 a lane
    constexpr int kPer = kWords / 32;
    int c[kPer], mine = 0;
#pragma unroll
    for (int w = 0; w < kPer; ++w) mine += c[w] = __popc(words[kPer * lane + w]);
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    int run = incl - mine;
#pragma unroll
    for (int w = 0; w < kPer; ++w) {
      before[kPer * lane + w] = run;
      run += c[w];
    }
    if (lane == 31) s_count = incl;
  }
  __syncthreads();
  const int count = s_count;
  if (threadIdx.x < 32) {  // the zeroes precede the publish
    const int excl = look_back(status, tile, count, epoch);
    if (lane == 0) s_excl = excl;
  } else {
    for (int i = threadIdx.x - 32; i < kTile; i += kThreads - 32) {
      const uint32_t w = words[i >> 5];
      const uint32_t below = w & ((1u << (i & 31)) - 1u);
      if ((w >> (i & 31)) & 1u) kept[before[i >> 5] + __popc(below)] = (unsigned short)i;
    }
  }
  __syncthreads();
  const long long excl = s_excl;
  const U* src = payload + e0 * D;
  U* dst = out + excl * D;
  if (vec_rows) {
    const long long R = D * (long long)sizeof(U) / 16;
    copy_rows<uint4>(reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst),
                     kept, count, R);
  } else {
    copy_rows<U>(src, dst, kept, count, D);
  }
  if (tile == n_tiles - 1 && threadIdx.x == 0) *total = (int)excl + count;
}

template <typename M, typename U>
cudaError_t launch(const void* payload, const void* mask, long long E, int D,
                   unsigned long long* status, unsigned* ticket, unsigned epoch,
                   void* out, int* total, cudaStream_t s) {
  const int n_tiles = (int)((E + kTile - 1) / kTile);
  const bool vec_mask = ((uintptr_t)mask & 15u) == 0;
  const bool vec_rows = (((uintptr_t)payload | (uintptr_t)out) & 15u) == 0 &&
                        (D * sizeof(U)) % 16 == 0;
  stream_compact_kernel<M, U><<<n_tiles, kThreads, 0, s>>>(
      static_cast<const U*>(payload), static_cast<const M*>(mask), E, D, vec_mask,
      vec_rows, static_cast<U*>(out), total, status, ticket, epoch, n_tiles);
  return cudaGetLastError();
}

template <typename M>
cudaError_t launch_width(int elem_bytes, const void* payload, const void* mask,
                         long long E, int D, unsigned long long* status,
                         unsigned* ticket, unsigned epoch, void* out, int* total,
                         cudaStream_t s) {
  switch (elem_bytes) {
    case 1: return launch<M, uint8_t>(payload, mask, E, D, status, ticket, epoch, out, total, s);
    case 2: return launch<M, uint16_t>(payload, mask, E, D, status, ticket, epoch, out, total, s);
    case 4: return launch<M, uint32_t>(payload, mask, E, D, status, ticket, epoch, out, total, s);
    case 8: return launch<M, uint64_t>(payload, mask, E, D, status, ticket, epoch, out, total, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// mask_bytes: 1 (bool) or 4 (int32); elem_bytes: 1, 2, 4 or 8; E >= 1.
// `status` holds ceil(E/2048) words carrying epochs below `epoch` (or 0)
// only, `ticket` one counter at 0 (the kernel leaves it at 0).  Returns a
// CUDA error code, or cudaErrorInvalidValue for another width or epoch.
extern "C" int stream_compact_launch(const void* payload, const void* mask,
                                     int mask_bytes, long long E, int D,
                                     int elem_bytes, unsigned long long* status,
                                     unsigned* ticket, unsigned epoch, void* out,
                                     int* total, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epoch == 0 || epoch >= (1u << 30) || E < 1) return (int)cudaErrorInvalidValue;
  if (mask_bytes == 1)
    return (int)launch_width<uint8_t>(elem_bytes, payload, mask, E, D, status, ticket,
                                      epoch, out, total, s);
  if (mask_bytes == 4)
    return (int)launch_width<int32_t>(elem_bytes, payload, mask, E, D, status, ticket,
                                      epoch, out, total, s);
  return (int)cudaErrorInvalidValue;
}
