// predicate.cuh: the compiled predicate program, evaluated for one event.
//
// The device half of src/repro/kernels/ref.py::predicate_mask, the body
// every Pallas predicate kernel of the JAX package shares.  Both kernel
// sources include it (skim_fused.cu, predicate_eval.cu) for the program's
// layout and its scalar operations; skim_fused.cu evaluates an event with
// eval_event (one thread an event, its rows read from device memory),
// predicate_eval.cu with its own evaluator over the same operations
// (lanes over the slots, the tile in shared memory).
//
// The program reaches the card as data: the host flattens the frozen
// Program into small int32/float32 descriptor arrays
// (repro_torch/kernels/skim_fused.py::flatten_program).  eval_event walks
// the groups and the K slots in order; HT and sum() accumulate slot by
// slot, left to right, as the reference's float32 reduction does.  Built
// without FMA contraction (--fmad=false) and without fast math, every
// product and sum rounds as it does in the reference.
//
// Each kernel source builds into its own library, so every includer gets
// its own copy of these internal-linkage functions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxStack = 16;  // RPN stack depth (checked on the host)
constexpr int kGroupFields = 8;

enum { OP_GT, OP_GE, OP_LT, OP_LE, OP_EQ, OP_NE, OP_ABSLT, OP_ABSGT };
enum { G_COUNT, G_HT, G_ANY, G_MASS, G_DR, G_EXPR };
enum {
  RPN_BRANCH, RPN_SUM, RPN_CONST, RPN_ADD, RPN_SUB, RPN_MUL, RPN_DIV,
  RPN_NEG, RPN_ABS, RPN_MIN, RPN_MAX
};
// group descriptor row (int32)
enum { GD_KIND, GD_TERM_OFF, GD_N_TERMS, GD_MIN_COUNT, GD_CMP_OP, GD_SAME,
       GD_RPN_OFF, GD_RPN_LEN };

// float32(pi), the reference's jnp.float32(np.pi)
constexpr float kPi = 3.14159274101257324f;

struct Program {
  const int* groups;      // (G, kGroupFields)
  const int* term_ids;    // flat, per group at GD_TERM_OFF
  const int* ops;         // aligned with term_ids
  const float* thrs;      // aligned with term_ids
  const float* cmp_thrs;  // (G, 2): cmp_thr, cmp_thr2
  const int* rpn_op;      // flat, per group at GD_RPN_OFF
  const int* rpn_term;    // term slot of RPN_BRANCH / RPN_SUM
  const float* rpn_const; // value of RPN_CONST
  int G;
};

struct Inputs {
  const float* terms;    // (T, E, K)
  const float* valid;    // (G, E, K)
  const float* weights;  // (G, E, K)
  long long E;
  int K;
};

// window b of a batch laid out (B, T, E, K) / (B, G, E, K): the same
// Inputs, each base moved to the window's slice (terms at b*T*E*K,
// valid and weights at b*G*E*K)
__device__ __forceinline__ Inputs window_inputs(const Inputs& batch,
                                                long long b, int T, int G) {
  const long long plane = batch.E * batch.K;
  return Inputs{batch.terms + b * T * plane, batch.valid + b * G * plane,
                batch.weights + b * G * plane, batch.E, batch.K};
}

__device__ __forceinline__ bool apply_op(float x, int op, float thr) {
  switch (op) {
    case OP_GT: return x > thr;
    case OP_GE: return x >= thr;
    case OP_LT: return x < thr;
    case OP_LE: return x <= thr;
    case OP_EQ: return x == thr;
    case OP_NE: return x != thr;
    case OP_ABSLT: return fabsf(x) < thr;
    case OP_ABSGT: return fabsf(x) > thr;
  }
  return false;
}

// floor modulo, as jnp.mod / torch.remainder: fmodf, then moved to the
// divisor's sign
__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r += y;
  return r;
}

// NaN-propagating min/max, as jnp.minimum / torch.minimum
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ const float* row(const float* base, int plane,
                                            long long e, const Inputs& in) {
  return base + ((long long)plane * in.E + e) * in.K;
}

// first maximal slot of pt among the valid ones (argmax semantics: NaN is
// maximal, ties and an all-invalid row go to the lowest slot)
__device__ int lead_slot(const float* pt, const float* vg, int K, bool second,
                         int exclude) {
  float best = -INFINITY;
  int idx = 0;
  for (int k = 0; k < K; ++k) {
    bool v = second ? (vg[k] >= 2.0f) : (floor_mod(vg[k], 2.0f) >= 1.0f);
    float x = (v && k != exclude) ? pt[k] : -INFINITY;
    if (!isnan(best) && (isnan(x) || x > best)) {
      best = x;
      idx = k;
    }
  }
  return idx;
}

__device__ int count_valid(const float* vg, int K, bool second) {
  int n = 0;
  for (int k = 0; k < K; ++k)
    n += second ? (vg[k] >= 2.0f) : (floor_mod(vg[k], 2.0f) >= 1.0f);
  return n;
}

__device__ void p4(float pt, float eta, float phi, float mass, float* px,
                   float* py, float* pz, float* e) {
  *px = pt * cosf(phi);
  *py = pt * sinf(phi);
  *pz = pt * sinhf(eta);
  float ch = coshf(eta);
  *e = sqrtf(mass * mass + pt * pt * ch * ch);
}

__device__ bool eval_pair(const Program& p, int g, long long e,
                          const Inputs& in) {
  const int* gd = p.groups + g * kGroupFields;
  const int* ids = p.term_ids + gd[GD_TERM_OFF];
  const int kind = gd[GD_KIND];
  const bool same = gd[GD_SAME] != 0;
  const int half = gd[GD_N_TERMS] / 2;
  const float* vg = row(in.valid, g, e, in);
  const int K = in.K;
  const float* pt_a = row(in.terms, ids[0], e, in);
  const float* pt_b = row(in.terms, ids[half], e, in);
  int i1 = lead_slot(pt_a, vg, K, false, -1);
  int i2;
  bool ok;
  if (same) {
    i2 = lead_slot(pt_a, vg, K, false, i1);
    ok = count_valid(vg, K, false) >= 2;
  } else {
    i2 = lead_slot(pt_b, vg, K, true, -1);
    ok = count_valid(vg, K, false) >= 1 && count_valid(vg, K, true) >= 1;
  }
  if (!ok) return false;
  auto sel = [&](int t, int slot) { return row(in.terms, ids[t], e, in)[slot]; };
  if (kind == G_MASS) {
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

__device__ bool eval_expr(const Program& p, int g, long long e,
                          const Inputs& in) {
  const int* gd = p.groups + g * kGroupFields;
  float stack[kMaxStack];
  int sp = 0;
  const int off = gd[GD_RPN_OFF];
  for (int i = 0; i < gd[GD_RPN_LEN]; ++i) {
    const int op = p.rpn_op[off + i];
    if (op == RPN_BRANCH) {
      stack[sp++] = row(in.terms, p.rpn_term[off + i], e, in)[0];
    } else if (op == RPN_SUM) {
      const float* x = row(in.terms, p.rpn_term[off + i], e, in);
      float acc = 0.0f;
      for (int k = 0; k < in.K; ++k) acc = acc + x[k];
      stack[sp++] = acc;
    } else if (op == RPN_CONST) {
      stack[sp++] = p.rpn_const[off + i];
    } else if (op == RPN_NEG) {
      stack[sp - 1] = -stack[sp - 1];
    } else if (op == RPN_ABS) {
      stack[sp - 1] = fabsf(stack[sp - 1]);
    } else {
      const float b = stack[--sp];
      const float a = stack[sp - 1];
      float r;
      switch (op) {
        case RPN_ADD: r = a + b; break;
        case RPN_SUB: r = a - b; break;
        case RPN_MUL: r = a * b; break;
        case RPN_DIV: r = a / b; break;
        case RPN_MIN: r = nan_min(a, b); break;
        default: r = nan_max(a, b); break;
      }
      stack[sp - 1] = r;
    }
  }
  return apply_op(stack[sp - 1], gd[GD_CMP_OP], p.cmp_thrs[2 * g]);
}

__device__ bool eval_event(const Program& p, long long e, const Inputs& in) {
  for (int g = 0; g < p.G; ++g) {
    const int* gd = p.groups + g * kGroupFields;
    const int kind = gd[GD_KIND];
    const int off = gd[GD_TERM_OFF];
    const int nt = gd[GD_N_TERMS];
    bool pass;
    if (kind == G_ANY) {
      pass = false;
      for (int i = 0; i < nt; ++i)
        pass |= apply_op(row(in.terms, p.term_ids[off + i], e, in)[0],
                         p.ops[off + i], p.thrs[off + i]);
    } else if (kind == G_MASS || kind == G_DR) {
      pass = eval_pair(p, g, e, in);
    } else if (kind == G_EXPR) {
      pass = eval_expr(p, g, e, in);
    } else {  // G_COUNT / G_HT: per-object AND of the terms, then reduce
      const float* vg = row(in.valid, g, e, in);
      const float* w = row(in.weights, g, e, in);
      int count = 0;
      float ht = 0.0f;
      for (int k = 0; k < in.K; ++k) {
        bool obj = true;
        for (int i = 0; i < nt; ++i)
          obj = obj && apply_op(row(in.terms, p.term_ids[off + i], e, in)[k],
                                p.ops[off + i], p.thrs[off + i]);
        obj = obj && (vg[k] > 0.0f);
        count += obj;
        ht = ht + w[k] * (obj ? 1.0f : 0.0f);
      }
      pass = kind == G_COUNT ? count >= gd[GD_MIN_COUNT]
                             : apply_op(ht, gd[GD_CMP_OP], p.cmp_thrs[2 * g]);
    }
    if (!pass) return false;
  }
  return true;
}

}  // namespace
