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
// Program into small int32/float32/float64 descriptor arrays
// (repro_torch/kernels/skim_fused.py::flatten_program).  eval_event walks
// the groups and the K slots in order.
//
// It decides an event as the host evaluator does
// (repro_torch/core/neardata.py::program_eval_np, the staged semantics):
// per-object cuts compare the float32 value with the float32 cut; the
// group values (MASS, ΔR, HT, EXPR) are evaluated in `Real`, float64, from
// the float32 planes widened exactly, in the host's operation order, and
// meet the float64 cut.  HT and sum() accumulate slot by slot, left to
// right, from +0.0, as the host's bincount does.  Built without FMA
// contraction (--fmad=false) and without fast math, every product and sum
// rounds as the host's does, so ΔR, HT and EXPR are the host's bit for
// bit; MASS's cos, sin, sinh and cosh are CUDA's (2, 2, 2 and 1 ulp at
// most), the one place the card's value can differ from the host's.
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

// the type of the group values: the host evaluator's float64
using Real = double;
constexpr Real kPi = 3.141592653589793;  // np.pi

struct Program {
  const int* groups;       // (G, kGroupFields)
  const int* term_ids;     // flat, per group at GD_TERM_OFF
  const int* ops;          // aligned with term_ids
  const float* thrs;       // aligned with term_ids
  const double* cmp_thrs;  // (G, 2): cmp_thr, cmp_thr2
  const int* rpn_op;       // flat, per group at GD_RPN_OFF
  const int* rpn_term;     // term slot of RPN_BRANCH / RPN_SUM
  const double* rpn_const; // value of RPN_CONST
  int G;
  // group g's cut (i = 0) or upper cut (i = 1) of a MASS window
  __device__ __forceinline__ Real cut(int g, int i = 0) const {
    return static_cast<Real>(cmp_thrs[2 * g + i]);
  }
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

// a comparison, in float32 for a per-object cut, in Real for a group's
template <typename T>
__device__ __forceinline__ bool apply_op(T x, int op, T thr) {
  switch (op) {
    case OP_GT: return x > thr;
    case OP_GE: return x >= thr;
    case OP_LT: return x < thr;
    case OP_LE: return x <= thr;
    case OP_EQ: return x == thr;
    case OP_NE: return x != thr;
    case OP_ABSLT: return fabs(x) < thr;
    case OP_ABSGT: return fabs(x) > thr;
  }
  return false;
}

// floor modulo, as numpy's remainder: fmod, moved by one period where its
// sign differs from the divisor's, and a zero with the divisor's sign
template <typename T>
__device__ __forceinline__ T floor_mod(T x, T y) {
  T r = fmod(x, y);
  if (r != T(0)) {
    if ((r < T(0)) != (y < T(0))) r += y;
  } else {
    r = copysign(T(0), y);
  }
  return r;
}

// min/max as the host evaluator's np.minimum / np.maximum: NaN if either
// is NaN, else a if it is strictly smaller (larger), else b, so of two
// equal zeros the second wins (fmin leaves the sign of zero open)
__device__ __forceinline__ Real nan_min(Real a, Real b) {
  return (isnan(a) || isnan(b)) ? a + b : (a < b ? a : b);
}
__device__ __forceinline__ Real nan_max(Real a, Real b) {
  return (isnan(a) || isnan(b)) ? a + b : (a > b ? a : b);
}

// a binary RPN operation on two group values
__device__ __forceinline__ Real rpn_binary(int op, Real a, Real b) {
  switch (op) {
    case RPN_ADD: return a + b;
    case RPN_SUB: return a - b;
    case RPN_MUL: return a * b;
    case RPN_DIV: return a / b;
    case RPN_MIN: return nan_min(a, b);
  }
  return nan_max(a, b);
}

__device__ __forceinline__ const float* row(const float* base, int plane,
                                            long long e, const Inputs& in) {
  return base + ((long long)plane * in.E + e) * in.K;
}

// whether candidate x displaces the leader so far (none yet: idx < 0) in
// the host evaluator's order (core/expr.py::_leading_indices): pt
// descending, NaN after every number (-inf included), ties to the lower
// slot, which is scanned first
__device__ __forceinline__ bool leads(float x, float best, int idx) {
  return idx < 0 || (!isnan(x) && (isnan(best) || x > best));
}

// the leading slot of pt among the valid ones but `exclude`, in leads()'s
// order; a row with no such slot takes slot 0
__device__ int lead_slot(const float* pt, const float* vg, int K, bool second,
                         int exclude) {
  float best = 0.0f;
  int idx = -1;
  for (int k = 0; k < K; ++k) {
    const bool v = second ? (vg[k] >= 2.0f) : (floor_mod(vg[k], 2.0f) >= 1.0f);
    if (v && k != exclude && leads(pt[k], best, idx)) {
      best = pt[k];
      idx = k;
    }
  }
  return idx < 0 ? 0 : idx;
}

__device__ int count_valid(const float* vg, int K, bool second) {
  int n = 0;
  for (int k = 0; k < K; ++k)
    n += second ? (vg[k] >= 2.0f) : (floor_mod(vg[k], 2.0f) >= 1.0f);
  return n;
}

// the four-vector of one object, as core/expr.py::leading_pair_mass's p4
__device__ void p4(Real pt, Real eta, Real phi, Real mass, Real* px, Real* py,
                   Real* pz, Real* e) {
  *px = pt * cos(phi);
  *py = pt * sin(phi);
  *pz = pt * sinh(eta);
  const Real ch = cosh(eta);
  *e = sqrt(mass * mass + pt * pt * ch * ch);
}

// the invariant mass of the pair (slot i1 of terms 0-3, slot i2 of terms
// 4-7; sel(t, slot) reads one), as leading_pair_mass computes it
template <typename Sel>
__device__ Real pair_mass(const Sel& sel, int i1, int i2) {
  Real px1, py1, pz1, e1, px2, py2, pz2, e2;
  p4(sel(0, i1), sel(1, i1), sel(2, i1), sel(3, i1), &px1, &py1, &pz1, &e1);
  p4(sel(4, i2), sel(5, i2), sel(6, i2), sel(7, i2), &px2, &py2, &pz2, &e2);
  const Real se = e1 + e2, sx = px1 + px2, sy = py1 + py2, sz = pz1 + pz2;
  const Real m2 = se * se - sx * sx - sy * sy - sz * sz;
  return sqrt(isnan(m2) ? m2 : fmax(m2, Real(0)));
}

// ΔR of the pair (slot i1 of terms 0-2, slot i2 of terms 3-5), as
// core/expr.py::leading_delta_r computes it
template <typename Sel>
__device__ Real pair_delta_r(const Sel& sel, int i1, int i2) {
  const Real deta = sel(1, i1) - sel(4, i2);
  const Real dphi = floor_mod(sel(2, i1) - sel(5, i2) + kPi, 2 * kPi) - kPi;
  return sqrt(deta * deta + dphi * dphi);
}

// whether group g (MASS or ΔR) passes with value v
__device__ __forceinline__ bool pair_passes(const Program& p, int g, int kind, int op,
                                            Real v) {
  if (kind == G_MASS) return v >= p.cut(g, 0) && v <= p.cut(g, 1);
  return apply_op(v, op, p.cut(g));
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
  auto sel = [&](int t, int slot) -> Real { return row(in.terms, ids[t], e, in)[slot]; };
  const Real v = kind == G_MASS ? pair_mass(sel, i1, i2) : pair_delta_r(sel, i1, i2);
  return pair_passes(p, g, kind, gd[GD_CMP_OP], v);
}

__device__ bool eval_expr(const Program& p, int g, long long e,
                          const Inputs& in) {
  const int* gd = p.groups + g * kGroupFields;
  Real stack[kMaxStack];
  int sp = 0;
  const int off = gd[GD_RPN_OFF];
  for (int i = 0; i < gd[GD_RPN_LEN]; ++i) {
    const int op = p.rpn_op[off + i];
    if (op == RPN_BRANCH) {
      stack[sp++] = row(in.terms, p.rpn_term[off + i], e, in)[0];
    } else if (op == RPN_SUM) {
      const float* x = row(in.terms, p.rpn_term[off + i], e, in);
      Real acc = 0;
      for (int k = 0; k < in.K; ++k) acc = acc + x[k];
      stack[sp++] = acc;
    } else if (op == RPN_CONST) {
      stack[sp++] = p.rpn_const[off + i];
    } else if (op == RPN_NEG) {
      stack[sp - 1] = -stack[sp - 1];
    } else if (op == RPN_ABS) {
      stack[sp - 1] = fabs(stack[sp - 1]);
    } else {
      const Real b = stack[--sp];
      stack[sp - 1] = rpn_binary(op, stack[sp - 1], b);
    }
  }
  return apply_op(stack[sp - 1], gd[GD_CMP_OP], p.cut(g));
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
      Real ht = 0;
      for (int k = 0; k < in.K; ++k) {
        bool obj = true;
        for (int i = 0; i < nt; ++i)
          obj = obj && apply_op(row(in.terms, p.term_ids[off + i], e, in)[k],
                                p.ops[off + i], p.thrs[off + i]);
        obj = obj && (vg[k] > 0.0f);
        count += obj;
        ht = ht + Real(w[k]) * Real(obj ? 1 : 0);
      }
      pass = kind == G_COUNT ? count >= gd[GD_MIN_COUNT]
                             : apply_op(ht, gd[GD_CMP_OP], p.cut(g));
    }
    if (!pass) return false;
  }
  return true;
}

}  // namespace
