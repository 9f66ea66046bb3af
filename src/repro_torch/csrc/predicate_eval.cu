// predicate_eval: the batched cascade stage with its epilogue fused in,
// and the predicate program over a batch of windows.
//
// Replaces the Pallas kernel `predicate_eval_batch` of
// src/repro/kernels/predicate_eval.py (body `_predicate_kernel_batched`)
// together with the jnp epilogue of `_cascade_stage_impl`
// (src/repro/kernels/ops.py), and `predicate_eval` of the same file
// (body `_predicate_kernel`) as its B = 1 case.
//
// What it computes, by one kernel (stage_kernel) with two epilogues:
//  * cascade_stage_launch, the batched cascade's stage step, over the
//    windows the stage runs ("staged"): for staged window s, its batch row
//    b = rows[s] (s itself when rows is null) and event e, alive = bit e
//    of the carried mask packed[b] AND the program over window s's planes
//    (T term planes, then G valid and G weights planes, each (E, K)
//    float32).  The new bits overwrite packed[b] in place (bit j of word w
//    is event w*32+j, the reference's layout and the ballot's lane order);
//    out[b, 0:nb] gets 1 at every basket ordinal seg_ids[b,e] of a
//    surviving event and out[b, nb] the window's survivor count.  Rows no
//    staged window maps to keep their packed words and get zero rows in
//    `out`.  Only that (B, nb+1) buffer has to cross back to the host per
//    stage; the event mask stays on the card.
//  * predicate_eval_launch: the program alone over a dense (B, T, E, K)
//    batch, every window staged (rows null, strides T*E*K and G*E*K) and
//    every event live: the (B, E) int32 mask.  Any E.
//
// What bounds it on an H100: bytes.  Each input element is read once and
// feeds a few float32 compares, far below the card's compute/bandwidth
// ratio, so the least time is the bytes the program needs over 3.35 TB/s:
// the K slots of every plane it reads (for the stage, of the live events
// only, with their mask words and seg_ids), and the outputs.
//
// Design:
//  * A block takes one window and one tile of `tile` events (grid: tiles
//    x windows, 256 threads).  The host stages the stage's windows each
//    window's planes back to back, and a dense batch is that layout, so a
//    tile of one plane is one contiguous run of n*K floats.
//  * The stage reads the tile's carried mask words first.  With no live
//    event it returns: no copy is issued and nothing is written (the row in
//    `out` is the launch's memset zero, the words stay zero).  The mask
//    launch has no carried mask: every event is live.
//  * The planes the program reads (every term plane, the valid planes of
//    COUNT/HT/MASS/ΔR groups, the weights planes of HT groups) come into
//    shared memory by one 1-D bulk copy each (cp.async.bulk, completing on
//    one mbarrier), when every plane is 16-byte aligned and E*K a multiple
//    of 4 (so a ragged last tile is whole 16-byte units too); by 4-byte
//    cp.async otherwise.  The host picks the tile by K so that the (T + 2G)
//    planes of a tile fit its shared-memory budget (mode 0 or 1,
//    kernels/predicate_eval.py `stage_plan`); where even 32 events do not
//    fit (mode 2), the block reads its planes from device memory in the
//    same coalesced order.  The mask launch also reads device memory for
//    a program with an ANY, EXPR or pair group, which reads a slot or two
//    of most of its planes (kernels/predicate_eval.py `mask_plan`).  Each
//    epilogue's kernel opts in once to the most dynamic shared memory the
//    host may ask for.
//  * Lanes go over the K slots: an event takes L lanes (32/L events a
//    warp at once), each lane its slots k = lane%L, +L, ...: the stage
//    L = min(K, 32), the mask about 8 slots a lane (L = 1 up to K = 8),
//    where every event is live and a lane's share of an event's scalar
//    work costs more than its slots.  A
//    warp's 32 lanes read 32 consecutive words of a plane: no bank
//    conflicts.  Per-object flags are computed in parallel and a count is
//    __popc of the flags' ballot.  Sums in slot order (HT's w[k]*obj,
//    EXPR's sum()) go left to right, one shuffle and one add a slot, in
//    every lane of the event: the reference's float32 order, with no tree.
//    A pair group's leading slot is the same ordered scan.  Built with
//    --fmad=false, every product and sum rounds as the reference's.
//    In the stage, a program with a mass or ΔR group at K <= 8 takes L = 1
//    instead (an event a lane, the same code, a tile of at least 256
//    events so every warp has events): its per-event four-vectors and trig
//    would otherwise run once in every lane of the event, and its slot
//    reads conflict at most K-way.
//  * The stage's epilogue: one thread an event, the warp ballots its 32
//    survivor bits into one word and popcounts it, the block sums the warps
//    and adds its total to the window's count with one atomicAdd; a
//    surviving event sets its basket bit with atomicOr, skipped when the
//    bit is already visibly set.  Integer atomics are exact and commute, so
//    the outputs do not depend on the order blocks run in.  The launch
//    zeroes `out` with cudaMemsetAsync on the same stream first.  The
//    stage takes E % 32 == 0 (whole mask words; the wrapper checks); the
//    last tile of a window may be short.
//  * The mask epilogue: one thread an event writes its 0/1 int32, 256
//    consecutive words a block step; the ragged last tile (and its last
//    warp) stop at E.  No memset, no atomics.
#include "predicate.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 512;  // events a block at most (also the mask launch's)
enum { kModeBulk = 0, kModeAsync4 = 1, kModeDirect = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The staged windows: window s's term planes at terms + s*t_stride, its
// valid and weights planes at valid / weights + s*g_stride; plane q of a
// window is (E, K) float32.
struct Stage {
  const float* terms;
  const float* valid;
  const float* weights;
  long long t_stride, g_stride;
  const int* rows;  // staged window -> batch row; null: the identity
  long long E;
  int T, K, tile, mode;
  int lanes;  // lanes an event takes: min(K, 32), or 1 (see the launch)
  unsigned long long planes_read;  // bit q: the program reads plane q
};

// plane q (T term planes, then G valid, then G weights) of window s
__device__ __forceinline__ const float* window_plane(const Stage& st, int G,
                                                     long long s, int q) {
  const long long plane = st.E * st.K;
  if (q < st.T) return st.terms + s * st.t_stride + q * plane;
  if (q < st.T + G) return st.valid + s * st.g_stride + (q - st.T) * plane;
  return st.weights + s * st.g_stride + (q - st.T - G) * plane;
}

// whether the program reads plane q at all (the host's bit mask: every
// term plane, the valid planes of COUNT/HT/MASS/ΔR groups, the weights
// planes of HT groups; planes past 64 are always read)
__device__ __forceinline__ bool plane_read(const Stage& st, int q) {
  return q >= 64 || ((st.planes_read >> q) & 1ull);
}

// This block's tile as the evaluator reads it: the row of tile-local
// event i in plane q starts at at(q, i); lanes of an event read its slots.
struct Tile {
  const float* base;  // the planes in shared memory (not in kModeDirect)
  long long stride;   // floats between two planes there
  Stage st;
  long long s, e0;    // the staged window, the tile's first event
  int G, K;
  __device__ __forceinline__ const float* at(int q, int i) const {
    if (st.mode == kModeDirect) return window_plane(st, G, s, q) + (e0 + i) * K;
    return base + q * stride + (long long)i * K;
  }
};

// The lanes of one event: it takes L lanes from `lead`, lane `sub` of them
// holding slots sub, sub + L, ... (J chunks of L slots).
struct Lanes {
  int L, J, sub, lead;
  unsigned mask;  // the event's lanes, for ballots
  __device__ __forceinline__ int width(int j, int K) const { return min(L, K - j * L); }
};

// acc plus x over W slots of the event, slot by slot in slot order, left
// to right (x is the lane's value for its slot; every lane of the event
// gets the sum).  The shuffles do not wait for the sum, so the unrolled
// loop issues them all before the chain of adds.
template <int W>
__device__ __forceinline__ float add_slots(float acc, float x, int lead) {
  float v[W];
#pragma unroll
  for (int kk = 0; kk < W; ++kk) v[kk] = __shfl_sync(kFull, x, lead + kk);
#pragma unroll
  for (int kk = 0; kk < W; ++kk) acc = acc + v[kk];
  return acc;
}

// add_slots over one chunk of w slots (w = L but for a short last chunk)
__device__ __forceinline__ float add_chunk(float acc, float x, const Lanes& ln, int w) {
  switch (w) {
    case 32: return add_slots<32>(acc, x, ln.lead);
    case 16: return add_slots<16>(acc, x, ln.lead);
    case 8: return add_slots<8>(acc, x, ln.lead);
    case 4: return add_slots<4>(acc, x, ln.lead);
    case 1: return acc + x;
  }
  for (int kk = 0; kk < w; ++kk) acc = acc + __shfl_sync(kFull, x, ln.lead + kk);
  return acc;
}

// first maximal slot of pt among the valid ones (lead_slot's argmax: NaN
// is maximal, ties and an all-invalid row go to the lowest slot), scanned
// in slot order by every lane of the event
__device__ int lead_slot_lanes(const float* pt, const float* vg, bool second,
                               int exclude, const Lanes& ln, int K) {
  float best = -INFINITY;
  int idx = 0;
  for (int j = 0; j < ln.J; ++j) {
    const int k = j * ln.L + ln.sub;
    float x = -INFINITY;
    if (k < K) {
      const bool v = second ? (vg[k] >= 2.0f) : (floor_mod(vg[k], 2.0f) >= 1.0f);
      if (v && k != exclude) x = pt[k];
    }
    const int w = ln.width(j, K);
#pragma unroll 8
    for (int kk = 0; kk < w; ++kk) {
      const float y = __shfl_sync(kFull, x, ln.lead + kk);
      if (!isnan(best) && (isnan(y) || y > best)) {
        best = y;
        idx = j * ln.L + kk;
      }
    }
  }
  return idx;
}

__device__ int count_valid_lanes(const float* vg, bool second, const Lanes& ln, int K) {
  int n = 0;
  for (int j = 0; j < ln.J; ++j) {
    const int k = j * ln.L + ln.sub;
    const bool v = k < K && (second ? (vg[k] >= 2.0f) : (floor_mod(vg[k], 2.0f) >= 1.0f));
    n += __popc(__ballot_sync(kFull, v) & ln.mask);
  }
  return n;
}

__device__ bool pair_lanes(const Program& p, int g, const Tile& t, int i,
                           const Lanes& ln) {
  const int* gd = p.groups + g * kGroupFields;
  const int* ids = p.term_ids + gd[GD_TERM_OFF];
  const int T = t.st.T, K = t.K;
  const bool same = gd[GD_SAME] != 0;
  const int half = gd[GD_N_TERMS] / 2;
  const float* vg = t.at(T + g, i);
  const float* pt_a = t.at(ids[0], i);
  const float* pt_b = t.at(ids[half], i);
  const int i1 = lead_slot_lanes(pt_a, vg, false, -1, ln, K);
  int i2;
  bool ok;
  if (same) {
    i2 = lead_slot_lanes(pt_a, vg, false, i1, ln, K);
    ok = count_valid_lanes(vg, false, ln, K) >= 2;
  } else {
    i2 = lead_slot_lanes(pt_b, vg, true, -1, ln, K);
    const int n1 = count_valid_lanes(vg, false, ln, K);
    const int n2 = count_valid_lanes(vg, true, ln, K);
    ok = n1 >= 1 && n2 >= 1;
  }
  if (!ok) return false;
  auto sel = [&](int term, int slot) { return t.at(ids[term], i)[slot]; };
  if (gd[GD_KIND] == G_MASS) {
    float px1, py1, pz1, e1, px2, py2, pz2, e2;
    p4(sel(0, i1), sel(1, i1), sel(2, i1), sel(3, i1), &px1, &py1, &pz1, &e1);
    p4(sel(4, i2), sel(5, i2), sel(6, i2), sel(7, i2), &px2, &py2, &pz2, &e2);
    float se = e1 + e2, sx = px1 + px2, sy = py1 + py2, sz = pz1 + pz2;
    float m2 = se * se - sx * sx - sy * sy - sz * sz;
    float m = sqrtf(isnan(m2) ? m2 : fmaxf(m2, 0.0f));
    const float* thr = p.cmp_thrs + 2 * g;
    return m >= thr[0] && m <= thr[1];
  }
  float deta = sel(1, i1) - sel(4, i2);
  float dphi = floor_mod(sel(2, i1) - sel(5, i2) + kPi, 2.0f * kPi) - kPi;
  float dr = sqrtf(deta * deta + dphi * dphi);
  return apply_op(dr, gd[GD_CMP_OP], p.cmp_thrs[2 * g]);
}

__device__ bool expr_lanes(const Program& p, int g, const Tile& t, int i,
                           const Lanes& ln) {
  const int* gd = p.groups + g * kGroupFields;
  float stack[kMaxStack];
  int sp = 0;
  const int off = gd[GD_RPN_OFF];
  for (int r = 0; r < gd[GD_RPN_LEN]; ++r) {
    const int op = p.rpn_op[off + r];
    if (op == RPN_BRANCH) {
      stack[sp++] = t.at(p.rpn_term[off + r], i)[0];
    } else if (op == RPN_SUM) {
      const float* x = t.at(p.rpn_term[off + r], i);
      float acc = 0.0f;
      for (int j = 0; j < ln.J; ++j) {
        const int k = j * ln.L + ln.sub;
        acc = add_chunk(acc, k < t.K ? x[k] : 0.0f, ln, ln.width(j, t.K));
      }
      stack[sp++] = acc;
    } else if (op == RPN_CONST) {
      stack[sp++] = p.rpn_const[off + r];
    } else if (op == RPN_NEG) {
      stack[sp - 1] = -stack[sp - 1];
    } else if (op == RPN_ABS) {
      stack[sp - 1] = fabsf(stack[sp - 1]);
    } else {
      const float b = stack[--sp];
      const float a = stack[sp - 1];
      float r2;
      switch (op) {
        case RPN_ADD: r2 = a + b; break;
        case RPN_SUB: r2 = a - b; break;
        case RPN_MUL: r2 = a * b; break;
        case RPN_DIV: r2 = a / b; break;
        case RPN_MIN: r2 = nan_min(a, b); break;
        default: r2 = nan_max(a, b); break;
      }
      stack[sp - 1] = r2;
    }
  }
  return apply_op(stack[sp - 1], gd[GD_CMP_OP], p.cmp_thrs[2 * g]);
}

// The program for tile-local event i, evaluated by the event's lanes;
// every lane of the warp calls it (it shuffles and ballots).  Every
// group is evaluated (the AND is the same; an event's lanes share the
// warp with other events, so none returns early).
__device__ bool eval_lanes(const Program& p, const Tile& t, int i, const Lanes& ln) {
  const int T = t.st.T, K = t.K;
  bool all = true;
  for (int g = 0; g < p.G; ++g) {
    const int* gd = p.groups + g * kGroupFields;
    const int kind = gd[GD_KIND];
    const int off = gd[GD_TERM_OFF];
    const int nt = gd[GD_N_TERMS];
    bool pass;
    if (kind == G_ANY) {
      pass = false;
      for (int q = 0; q < nt; ++q)
        pass |= apply_op(t.at(p.term_ids[off + q], i)[0], p.ops[off + q], p.thrs[off + q]);
    } else if (kind == G_MASS || kind == G_DR) {
      pass = pair_lanes(p, g, t, i, ln);
    } else if (kind == G_EXPR) {
      pass = expr_lanes(p, g, t, i, ln);
    } else {  // G_COUNT / G_HT: per-object AND of the terms, then reduce
      const float* vg = t.at(T + g, i);
      const float* w = t.at(T + p.G + g, i);
      int count = 0;
      float ht = 0.0f;
      for (int j = 0; j < ln.J; ++j) {
        const int k = j * ln.L + ln.sub;
        bool obj = k < K;
        for (int q = 0; q < nt && obj; ++q)
          obj = apply_op(t.at(p.term_ids[off + q], i)[k], p.ops[off + q], p.thrs[off + q]);
        obj = obj && (vg[k] > 0.0f);
        count += __popc(__ballot_sync(kFull, obj) & ln.mask);
        if (kind == G_HT)
          ht = add_chunk(ht, k < K ? w[k] * (obj ? 1.0f : 0.0f) : 0.0f, ln,
                         ln.width(j, K));
      }
      pass = kind == G_COUNT ? count >= gd[GD_MIN_COUNT]
                             : apply_op(ht, gd[GD_CMP_OP], p.cmp_thrs[2 * g]);
    }
    all = all && pass;
  }
  return all;
}

// kMask: the mask launch (every event live; out is the (B, E) int32
// mask; packed and seg_ids unused); otherwise the cascade stage
template <bool kMask>
__global__ void __launch_bounds__(kThreads)
stage_kernel(Program p, Stage st, uint32_t* __restrict__ packed,
             const int* __restrict__ seg_ids, int nb, int* __restrict__ out) {
  extern __shared__ __align__(128) float planes[];
  __shared__ uint32_t carried[kMaxTile / 32];
  __shared__ uint8_t flags[kMaxTile];
  __shared__ int warp_counts[kWarps];
  __shared__ __align__(8) uint64_t bar;

  const long long s = blockIdx.y;
  const long long b = st.rows ? st.rows[s] : s;
  const long long e0 = (long long)blockIdx.x * st.tile;
  const int n = (int)min((long long)st.tile, st.E - e0);  // stage: a multiple of 32
  uint32_t* words = nullptr;
  int seg[kMaxTile / kThreads];
  if constexpr (!kMask) {
    words = packed + b * (st.E >> 5) + (e0 >> 5);
    uint32_t word = 0;
    if (threadIdx.x < (n >> 5)) {
      word = words[threadIdx.x];
      carried[threadIdx.x] = word;
    }
    if (!__syncthreads_or(word != 0u)) return;  // no live event: no copy, no write

    // the seg ids of this thread's events in the epilogue, for the ones
    // live now (only they can survive): loaded while the planes arrive
    const long long seg0 = b * st.E + e0;
#pragma unroll
    for (int m = 0; m < kMaxTile / kThreads; ++m) {
      const int i = threadIdx.x + m * kThreads;
      seg[m] = (i < n && ((carried[i >> 5] >> (i & 31)) & 1u)) ? seg_ids[seg0 + i] : -1;
    }
  }

  const int P = st.T + 2 * p.G;
  const long long stride = (long long)st.tile * st.K;  // floats a plane in shared memory
  const unsigned slice = (unsigned)n * (unsigned)st.K;  // floats a plane in this tile
  if (st.mode == kModeBulk) {
    const uint32_t bar_a = smem_u32(&bar);
    if (threadIdx.x == 0) {
      unsigned bytes = 0;
      for (int q = 0; q < P; ++q)
        if (plane_read(st, q)) bytes += 4u * slice;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar_a), "r"(1)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar_a), "r"(bytes) : "memory");
      for (int q = 0; q < P; ++q) {
        if (!plane_read(st, q)) continue;
        const float* src = window_plane(st, p.G, s, q) + e0 * st.K;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];" ::"r"(smem_u32(planes + q * stride)),
            "l"(reinterpret_cast<uint64_t>(src)), "r"(4u * slice), "r"(bar_a)
            : "memory");
      }
    }
    __syncthreads();  // the barrier is initialised before anyone waits
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar_a), "r"(0) : "memory");
    }
  } else if (st.mode == kModeAsync4) {
    for (int q = 0; q < P; ++q) {
      if (!plane_read(st, q)) continue;
      const float* src = window_plane(st, p.G, s, q) + e0 * st.K;
      for (unsigned x = threadIdx.x; x < slice; x += kThreads)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         smem_u32(planes + q * stride + x)),
                     "l"(reinterpret_cast<uint64_t>(src + x))
                     : "memory");
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  }

  // evaluate: each warp takes 32/L events at once
  const Tile tile{planes, stride, st, s, e0, p.G, st.K};
  Lanes ln;
  ln.L = st.lanes;
  ln.J = (st.K + ln.L - 1) / ln.L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ln.sub = lane % ln.L;
  ln.lead = lane - ln.sub;
  ln.mask = ln.L == 32 ? kFull : (((1u << ln.L) - 1u) << ln.lead);
  const int per_warp = 32 / ln.L;  // events a warp takes at once
  for (int first = warp * per_warp; first < n; first += kWarps * per_warp) {
    const int i = first + lane / ln.L;
    const bool here = lane < per_warp * ln.L && i < n;
    const int row = here ? i : first;  // idle lanes read a row of the tile
    bool live = here && (kMask || ((carried[row >> 5] >> (row & 31)) & 1u));
    if (__any_sync(kFull, live)) live = eval_lanes(p, tile, row, ln) && live;
    if (here && ln.sub == 0) flags[i] = live;
  }
  __syncthreads();

  if constexpr (kMask) {  // the mask: one thread an event, up to E
    int* mask_row = out + b * st.E + e0;
    for (int i = threadIdx.x; i < n; i += kThreads) mask_row[i] = flags[i];
    return;
  }
  // the stage's epilogue: one thread an event
  int* out_row = out + b * (nb + 1);
  int total = 0;
#pragma unroll
  for (int m = 0; m < kMaxTile / kThreads; ++m) {
    const int i = threadIdx.x + m * kThreads;
    if (i >= n) break;  // whole warps: n % 32 == 0
    const bool alive = flags[i] != 0;
    const uint32_t ballot = __ballot_sync(kFull, alive);
    if (lane == 0) {
      words[i >> 5] = ballot;
      total += __popc(ballot);
    }
    const int sg = seg[m];
    if (alive && sg >= 0 && sg < nb && out_row[sg] == 0) atomicOr(out_row + sg, 1);
  }
  if (lane == 0) warp_counts[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += warp_counts[w];
    if (sum) atomicAdd(out_row + nb, sum);
  }
}

// The planes' shared memory a launch may ask for at most (the host's
// SMEM_MAX; kernels/predicate_eval.py)
constexpr int kSmemMax = 200 * 1024;

template <bool kMask>
cudaError_t launch_stage(const Program& p, const Stage& st, int S, int smem_bytes,
                         uint32_t* packed, const int* seg_ids, int nb, int* out,
                         cudaStream_t cs) {
  // each instantiation's own opt-in to dynamic shared memory past 48 KiB
  // (static + dynamic may not pass 48 KiB by default), made once, to the
  // most any launch asks for
  static const cudaError_t allowed = cudaFuncSetAttribute(
      stage_kernel<kMask>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (allowed != cudaSuccess) return allowed;
  if (smem_bytes > kSmemMax) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((st.E + st.tile - 1) / st.tile), (unsigned)S);
  stage_kernel<kMask><<<grid, kThreads, smem_bytes, cs>>>(p, st, packed, seg_ids, nb, out);
  return cudaGetLastError();
}

}  // namespace

// The cascade stage over S staged windows (see the top of this file).
// tile (a multiple of 32, at most 512) and mode (0 bulk copies, 1 4-byte
// cp.async, 2 device memory) are the host's choice; smem_bytes is the
// planes' shared memory (P*tile*K*4; 0 in mode 2).  B rows of `out` are
// zeroed first.
extern "C" int cascade_stage_launch(
    const float* terms, const float* valid, const float* weights,
    long long t_stride, long long g_stride, const int* rows, int S, int T,
    int G, long long E, int K, int tile, int mode, int smem_bytes, int lanes,
    unsigned long long planes_read,
    const int* groups, const int* term_ids, const int* ops, const float* thrs,
    const float* cmp_thrs, const int* rpn_op, const int* rpn_term,
    const float* rpn_const, uint32_t* packed, const int* seg_ids, int nb,
    int* out, int B, void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(int) * (size_t)B * (size_t)(nb + 1), cs);
  if (err != cudaSuccess || S == 0 || E == 0) return (int)err;
  Program p{groups, term_ids, ops, thrs, cmp_thrs, rpn_op, rpn_term, rpn_const, G};
  Stage st{terms, valid, weights, t_stride, g_stride, rows, E, T, K, tile, mode, lanes,
           planes_read};
  return (int)launch_stage<false>(p, st, S, smem_bytes, packed, seg_ids, nb, out, cs);
}

// The (B, E) int32 mask of a dense batch: window b's term planes at
// terms + b*t_stride, its valid and weights planes at valid / weights +
// b*g_stride; tile, mode, smem_bytes and lanes as for the stage.
extern "C" int predicate_eval_launch(
    const float* terms, const float* valid, const float* weights,
    long long t_stride, long long g_stride, int B, int T, int G, long long E, int K,
    int tile, int mode, int smem_bytes, int lanes, unsigned long long planes_read,
    const int* groups, const int* term_ids, const int* ops, const float* thrs,
    const float* cmp_thrs, const int* rpn_op, const int* rpn_term,
    const float* rpn_const, int* out, void* stream) {
  if (B == 0 || E == 0) return (int)cudaSuccess;
  Program p{groups, term_ids, ops, thrs, cmp_thrs, rpn_op, rpn_term, rpn_const, G};
  Stage st{terms, valid, weights, t_stride, g_stride, nullptr, E, T, K, tile, mode, lanes,
           planes_read};
  return (int)launch_stage<true>(p, st, B, smem_bytes, nullptr, nullptr, 0, out,
                                 static_cast<cudaStream_t>(stream));
}
