// basket_decode: decode of the `bitpack` basket codec.
//
// Replaces the Pallas kernel `basket_decode` of
// src/repro/kernels/basket_decode.py (body `_decode_kernel`).
//
// What it computes, per basket: the codes from B bit-planes of W uint32
// words (code i is bit i%32 of word i/32 of every plane, plane j giving
// bit j), then the inverse transform of the codec kind:
//   kind 0 (int)   inverse zigzag, then a wrap-exact uint32 inclusive
//                  prefix sum seeded with `first`;
//   kind 1 (float) inclusive prefix xor seeded with `first` (the wrapper
//                  reads the bits as float32);
//   kind 2 (bool)  the codes themselves.
// Kind 3 (raw literals) never reaches the card.  Each value is stored at
// the output's own width: 4 bytes (int32, float32 bits), 2 or 1 (the low
// bytes, as a narrowing integer cast), or a bool byte (value != 0).
//
// What bounds it on an H100: bytes.  It reads each plane word once and
// writes one value per code with a few integer operations each, so the
// least time is (planes + output) over 3.35 TB/s.  On the main path a
// call decodes one 4096-value basket, and the launch dominates.
//
// Design: one 1024-thread block per basket, walking the basket in chunks
// of 1024 codes.  Each warp rebuilds the 32 codes of one word (lane j
// reads bit j), then a block-wide scan: warp shuffles, warp totals in
// shared memory, and a carry from the previous chunk.  All arithmetic is
// uint32 (signed overflow would be undefined; the reference's sum wraps),
// and float payloads never pass through a float operation, so -0.0 and
// NaN bit patterns come through exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b, int kind) {
  return kind == 0 ? a + b : a ^ b;
}

// value v of the block's basket, at the output's width
__device__ __forceinline__ void put(void* o, int v, uint32_t x, int out_bytes,
                                    bool as_bool) {
  if (out_bytes == 4) {
    static_cast<uint32_t*>(o)[v] = x;
  } else if (out_bytes == 2) {
    static_cast<uint16_t*>(o)[v] = static_cast<uint16_t>(x);
  } else {
    static_cast<uint8_t*>(o)[v] = as_bool ? (x != 0u) : static_cast<uint8_t>(x);
  }
}

__global__ void basket_decode_kernel(const uint32_t* __restrict__ planes,
                                     const uint32_t* __restrict__ firsts,
                                     uint8_t* __restrict__ out, int B, int W,
                                     int n_bits, int kind, int out_bytes,
                                     bool as_bool) {
  __shared__ uint32_t warp_total[kWarps];
  const long long n = blockIdx.x;
  const uint32_t* p = planes + n * B * W;
  const int V = W * 32;
  void* o = out + n * V * out_bytes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t carry = 0;  // inclusive result of every earlier chunk
  for (int base = 0; base < V; base += kBlock) {
    const int v = base + threadIdx.x;  // v % 32 == lane
    uint32_t code = 0;
    if (v < V) {
      const int w = v >> 5;
      for (int j = 0; j < n_bits; ++j) code |= ((p[j * W + w] >> lane) & 1u) << j;
    }
    if (kind == 2) {
      if (v < V) put(o, v, code, out_bytes, as_bool);
      continue;
    }
    uint32_t x = kind == 0 ? (code >> 1) ^ (0u - (code & 1u)) : code;
    if (v == 0) x = firsts[n];
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x = combine(y, x, kind);
    }
    if (lane == 31) warp_total[warp] = x;
    __syncthreads();
    if (warp == 0) {
      uint32_t t = warp_total[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, t, off);
        if (lane >= off) t = combine(y, t, kind);
      }
      warp_total[lane] = t;
    }
    __syncthreads();
    const uint32_t prefix = warp ? warp_total[warp - 1] : 0u;
    if (v < V)
      put(o, v, combine(combine(carry, prefix, kind), x, kind), out_bytes,
          as_bool);
    carry = combine(carry, warp_total[kWarps - 1], kind);
    __syncthreads();  // warp_total is rewritten by the next chunk
  }
}

}  // namespace

// out_bytes is 4, 2 or 1; as_bool (with out_bytes 1) stores value != 0
extern "C" int basket_decode_launch(const uint32_t* planes,
                                    const uint32_t* firsts, void* out, int N,
                                    int B, int W, int n_bits, int kind,
                                    int out_bytes, int as_bool, void* stream) {
  if (out_bytes != 4 && out_bytes != 2 && out_bytes != 1)
    return (int)cudaErrorInvalidValue;
  basket_decode_kernel<<<N, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, firsts, static_cast<uint8_t*>(out), B, W, n_bits, kind,
      out_bytes, as_bool != 0);
  return (int)cudaGetLastError();
}
