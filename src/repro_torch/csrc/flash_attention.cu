// flash_attention: causal or full online-softmax attention, accumulated in
// float32 on the CUDA cores.
//
// Replaces the Pallas kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (body `_attn_kernel`).
//
// What it computes, for q, k, v (BH, S, D) of float32 or bfloat16: each
// query row's softmax-weighted sum of the value rows, with q upcast and
// scaled by `scale` before the product, the keys after the row's own
// position left out when `causal`, the running (max, sum, acc) rescaled
// tile by tile from a start of max = -1e30 (the reference's NEG_INF), the
// sum floored at 1e-30, and the result stored in the inputs' type.  A key
// the reference masks with -1e30 gets exp(-1e30 - m) = 0 there; here it is
// skipped, which adds the same 0.
//
// What bounds it on an H100: operations.  2*2*S*S*D per head (halved when
// causal) against 4*S*D elements moved: at S = 2048, D = 128 that is
// about 1,000 operations per byte in float32, far above the card's
// 67 TFLOP/s / 3.35 TB/s = 20, so the least time is the operations over
// the float32 rate (989 TFLOP/s for bf16 on the tensor cores).  This
// first kernel is simple and right, not fast: float32 products stay in
// float32 on the CUDA cores (TF32 would miss the reference's 3e-5
// tolerance), and the bf16 tensor-core route (mma.sync / wgmma) is later
// work.
//
// Design:
//  * One 256-thread block per (head, tile of kRows = 32 query rows); each
//    of its 8 warps owns 4 rows, so every staged key is used by 32 rows.
//  * The block's q rows (scaled) and a tile of 32 key and value rows sit
//    in dynamic shared memory as float32, rows padded to an odd stride so
//    lane j's walk over key row j hits 32 distinct banks; at D = 128 that
//    is 49.5 KB, above the 48 KB default, so the launch raises the limit
//    with cudaFuncSetAttribute first (227 KB is the most a block may use).
//  * Q·K: lane j computes the logit of key j of the tile for each of its
//    warp's rows, one product per element in order d = 0..D-1; one
//    shuffle reduction per row and tile gives the tile's max.
//  * P·V: lane i owns output columns i, i+32, ... (kDpl of them, D <= 128)
//    and takes each key's probability from its lane by shuffle.  Each lane
//    keeps a partial row sum; all lanes share the rescaling factor, so
//    the sum over lanes at the end is the row's denominator.
//  * Causal blocks stop at the key tile holding their last row: tiles
//    above the diagonal are never loaded.
//  * Built with --fmad=false like every kernel here; products and sums go
//    through __fmul_rn / __fadd_rn, so each rounds on its own.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per staged tile, one per lane
constexpr float kNegInf = -1e30f;             // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float mad(float a, float b, float c) {
  return __fadd_rn(__fmul_rn(a, b), c);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename T, int kDpl>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int D,
                       float scale, int causal) {
  extern __shared__ float smem[];
  const int stride = D | 1;
  float* qs = smem;                  // (kRows, stride), q * scale
  float* ks = qs + kRows * stride;   // (kKeys, stride)
  float* vs = ks + kKeys * stride;   // (kKeys, stride)
  const long long head = (long long)blockIdx.y * S * D;
  const int q0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    qs[r * stride + d] =
        row < S ? __fmul_rn(to_f32(q[head + (long long)row * D + d]), scale) : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDpl];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[r][i] = 0.0f;
  }
  const int row0 = q0 + warp * kRowsPerWarp;
  const float* qw = qs + warp * kRowsPerWarp * stride;
  const int n_keys = causal ? min(S, q0 + kRows) : S;

  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    __syncthreads();  // q is staged; the previous tile is consumed
    for (int i = threadIdx.x; i < kKeys * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const bool in = k0 + j < S;
      const long long at = head + (long long)(k0 + j) * D + d;
      ks[j * stride + d] = in ? to_f32(k[at]) : 0.0f;
      vs[j * stride + d] = in ? to_f32(v[at]) : 0.0f;
    }
    __syncthreads();

    // Q·K: this lane's key against each of the warp's rows
    const int key = k0 + lane;
    const float* krow = ks + lane * stride;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = mad(qw[r * stride + d], kd, s[r]);
    }

    // online softmax over the tile
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool ok = key < S && (!causal || key <= row0 + r);
      const float m_new = fmaxf(m[r], warp_max(ok ? s[r] : -INFINITY));
      const float alpha = expf(m[r] - m_new);
      p[r] = ok ? expf(s[r] - m_new) : 0.0f;
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha), p[r]);
#pragma unroll
      for (int i = 0; i < kDpl; ++i) acc[r][i] = __fmul_rn(acc[r][i], alpha);
      m[r] = m_new;
    }

    // P·V: this lane's output columns
    for (int j = 0; j < kKeys; ++j) {
      float vj[kDpl];
#pragma unroll
      for (int i = 0; i < kDpl; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < D ? vs[j * stride + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < kDpl; ++i) acc[r][i] = mad(pj, vj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float denom = fmaxf(warp_sum(l[r]), 1e-30f);
    const int row = row0 + r;
    if (row >= S) continue;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) {
      const int d = lane + 32 * i;
      if (d < D) store(o + head + (long long)row * D + d, __fdiv_rn(acc[r][i], denom));
    }
  }
}

template <typename T, int kDpl>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
           int D, float scale, int causal, cudaStream_t s) {
  const auto kernel = flash_attention_kernel<T, kDpl>;
  const int smem = (int)sizeof(float) * (kRows + 2 * kKeys) * (D | 1);
  static int opted_in = 48 * 1024;  // bytes this instantiation may use
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const dim3 grid((unsigned)((S + kRows - 1) / kRows), (unsigned)BH);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(o), S, D,
                                      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dpl(const void* q, const void* k, const void* v, void* o, int BH, int S,
               int D, float scale, int causal, cudaStream_t s) {
  if (D <= 32) return launch<T, 1>(q, k, v, o, BH, S, D, scale, causal, s);
  if (D <= 64) return launch<T, 2>(q, k, v, o, BH, S, D, scale, causal, s);
  if (D <= 128) return launch<T, 4>(q, k, v, o, BH, S, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: (BH, S, D) contiguous, float32 (bf16 = 0) or bfloat16
// (bf16 = 1); D <= 128.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int BH, int S, int D, float scale,
                                      int causal, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_dpl<__nv_bfloat16>(q, k, v, o, BH, S, D, scale, causal, s);
  return launch_dpl<float>(q, k, v, o, BH, S, D, scale, causal, s);
}
