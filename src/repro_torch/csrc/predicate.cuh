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
// Program and its planes' kinds into small int32/float64 descriptor arrays
// (repro_torch/kernels/skim_fused.py::flatten_program).  eval_event walks
// the groups and the K slots in order.
//
// A plane slot is 4 bytes of one of two kinds (kernels/program.py
// KIND_*): a float32 value, or an integer or bool branch's value widened
// on the host to int32 and kept as its bits, exact where float32 would
// round above 2^24.
//
// It decides an event as the host evaluator does
// (repro_torch/core/neardata.py::program_eval_np, the staged semantics):
// a per-object cut compares a float32 value with the cut read in float32
// (numpy's read of a Python float beside a float32 column), an integer in
// float64 (numpy promotes an integer column beside a Python float; exact),
// with abs as numpy's integer abs, which leaves the type's least value
// negative; an ANY term is nonzero (numpy's bool: NaN true, ±0 false); the
// group values (MASS, ΔR, HT, EXPR) are evaluated in `Real`, float64, from
// the planes widened exactly, in the host's operation order, and meet the
// float64 cut.  HT and sum() accumulate slot by slot, left to
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
constexpr int kGroupFields = 9;

enum { OP_GT, OP_GE, OP_LT, OP_LE, OP_EQ, OP_NE, OP_ABSLT, OP_ABSGT };
enum { KIND_F32, KIND_I32, KIND_I16, KIND_I8, KIND_UINT };  // a plane's values
enum { G_COUNT, G_HT, G_ANY, G_MASS, G_DR, G_EXPR };
enum {
  RPN_BRANCH, RPN_SUM, RPN_CONST, RPN_ADD, RPN_SUB, RPN_MUL, RPN_DIV,
  RPN_NEG, RPN_ABS, RPN_MIN, RPN_MAX
};
// group descriptor row (int32)
enum { GD_KIND, GD_TERM_OFF, GD_N_TERMS, GD_MIN_COUNT, GD_CMP_OP, GD_SAME,
       GD_RPN_OFF, GD_RPN_LEN, GD_WEIGHT_KIND };

// the type of the group values: the host evaluator's float64
using Real = double;
constexpr Real kPi = 3.141592653589793;  // np.pi

struct Program {
  const int* groups;       // (G, kGroupFields)
  const int* term_ids;     // flat, per group at GD_TERM_OFF
  const int* ops;          // aligned with term_ids
  const int* kinds;        // each term's plane kind, aligned with term_ids
  const int* slot_kinds;   // (T): each term slot's plane kind (RPN leaves)
  const double* thrs;      // aligned with term_ids
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

// a comparison, in float32 for a float32 per-object cut, in Real otherwise
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

// a slot's value in Real: a float32 widened, an integer's int32 bits
// widened; both exact
__device__ __forceinline__ Real as_real(float x, int kind) {
  return kind == KIND_F32 ? Real(x) : Real(__float_as_int(x));
}

// a per-object cut on a slot of `kind` (see the top of this file); an
// integer's abs is taken in float64, which cannot overflow, except at the
// type's least value, which numpy's integer abs leaves as it is
__device__ __forceinline__ bool object_cut(float x, int op, double thr, int kind) {
  if (kind == KIND_F32) return apply_op(x, op, static_cast<float>(thr));
  const int v = __float_as_int(x);
  if (op == OP_ABSLT || op == OP_ABSGT) {
    const int least = kind == KIND_I32 ? -2147483647 - 1
                    : kind == KIND_I16 ? -32768 : kind == KIND_I8 ? -128 : 0;
    const Real a = v == least ? Real(v) : fabs(Real(v));
    return op == OP_ABSLT ? a < Real(thr) : a > Real(thr);
  }
  return apply_op(Real(v), op, Real(thr));
}

// an ANY term: the slot read as bool, whatever the compiled op
__device__ __forceinline__ bool nonzero(float x, int kind) {
  return kind == KIND_F32 ? x != 0.0f : __float_as_int(x) != 0;
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
// the host evaluator's order (core/expr.py::_leading_indices, in float64,
// which orders float32 values as float32 and int32 values as int32): pt
// descending, NaN after every number (-inf included), ties to the lower
// slot, which is scanned first.  V is float or int, a slot's value by its
// kind (an int is never NaN).
__device__ __forceinline__ bool is_nan(float x) { return isnan(x); }
__device__ __forceinline__ bool is_nan(int) { return false; }

template <typename V>
__device__ __forceinline__ bool leads(V x, V best, int idx) {
  return idx < 0 || (!is_nan(x) && (is_nan(best) || x > best));
}

template <typename V>
__device__ int lead_slot_of(const V* pt, const float* vg, int K, bool second,
                            int exclude) {
  V best = 0;
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

// the leading slot of pt (of `kind`) among the valid ones but `exclude`,
// in leads()'s order; a row with no such slot takes slot 0
__device__ int lead_slot(const float* pt, int kind, const float* vg, int K, bool second,
                         int exclude) {
  if (kind == KIND_F32) return lead_slot_of(pt, vg, K, second, exclude);
  return lead_slot_of(reinterpret_cast<const int*>(pt), vg, K, second, exclude);
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
  const int* kinds = p.kinds + gd[GD_TERM_OFF];
  const float* pt_a = row(in.terms, ids[0], e, in);
  const float* pt_b = row(in.terms, ids[half], e, in);
  const int ka = kinds[0], kb = kinds[half];
  int i1 = lead_slot(pt_a, ka, vg, K, false, -1);
  int i2;
  bool ok;
  if (same) {
    i2 = lead_slot(pt_a, ka, vg, K, false, i1);
    ok = count_valid(vg, K, false) >= 2;
  } else {
    i2 = lead_slot(pt_b, kb, vg, K, true, -1);
    ok = count_valid(vg, K, false) >= 1 && count_valid(vg, K, true) >= 1;
  }
  if (!ok) return false;
  auto sel = [&](int t, int slot) -> Real {
    return as_real(row(in.terms, ids[t], e, in)[slot], kinds[t]);
  };
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
      const int t = p.rpn_term[off + i];
      stack[sp++] = as_real(row(in.terms, t, e, in)[0], p.slot_kinds[t]);
    } else if (op == RPN_SUM) {
      const int t = p.rpn_term[off + i], kind = p.slot_kinds[t];
      const float* x = row(in.terms, t, e, in);
      Real acc = 0;
      for (int k = 0; k < in.K; ++k) acc = acc + as_real(x[k], kind);
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
        pass |= nonzero(row(in.terms, p.term_ids[off + i], e, in)[0], p.kinds[off + i]);
    } else if (kind == G_MASS || kind == G_DR) {
      pass = eval_pair(p, g, e, in);
    } else if (kind == G_EXPR) {
      pass = eval_expr(p, g, e, in);
    } else {  // G_COUNT / G_HT: per-object AND of the terms, then reduce
      const float* vg = row(in.valid, g, e, in);
      const float* w = row(in.weights, g, e, in);
      const int wkind = gd[GD_WEIGHT_KIND];
      int count = 0;
      Real ht = 0;
      for (int k = 0; k < in.K; ++k) {
        bool obj = true;
        for (int i = 0; i < nt; ++i)
          obj = obj && object_cut(row(in.terms, p.term_ids[off + i], e, in)[k],
                                  p.ops[off + i], p.thrs[off + i], p.kinds[off + i]);
        obj = obj && (vg[k] > 0.0f);
        count += obj;
        ht = ht + as_real(w[k], wkind) * Real(obj ? 1 : 0);
      }
      pass = kind == G_COUNT ? count >= gd[GD_MIN_COUNT]
                             : apply_op(ht, gd[GD_CMP_OP], p.cut(g));
    }
    if (!pass) return false;
  }
  return true;
}

}  // namespace
