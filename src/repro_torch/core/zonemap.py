"""Zone-map predicate pushdown: interval analysis over the query AST.

The fastest byte is the one never moved — and with per-basket statistics
(:class:`~repro_torch.data.store.BasketMeta` ``vmin``/``vmax``/``n_true``,
DESIGN.md §9) whole basket windows can be *proved* out before any fetch
or decode happens.  This module classifies each window against a parsed
:class:`~repro_torch.core.query.Query`:

  * ``PRUNE``      — no event in the window can survive the selection:
    phase 1 *and* phase 2 are skipped entirely,
  * ``ACCEPT_ALL`` — every event provably survives: predicate evaluation
    is skipped and the window goes straight to phase 2,
  * ``SCAN``       — undecidable from stats; run the normal executor.

Correctness contract (pinned by tests/test_zonemap.py property tests):
a window classified PRUNE never contains a survivor and ACCEPT_ALL never
contains a failure, for every AST shape — so pruned runs are bit-identical
to the reference ``prune=False`` path.

Two semantics details make the analysis exact rather than merely
heuristic:

  * **float32 comparison semantics** — the evaluator compares float32
    branch data against the query threshold at float32 precision (NumPy
    weak promotion), so thresholds are rounded through float32 before the
    interval test whenever the branch stores float32.  Stats are exact
    float64 embeddings of the stored values, so interval endpoints compare
    exactly.
  * **HT accumulation slack** — HT sums are float64 accumulations whose
    rounding the interval bound cannot reproduce term-for-term; the HT
    interval is widened by a rigorous slack before claiming ALWAYS/NEVER.

Unknown statistics (legacy stores, non-finite data) always degrade to
SCAN.

The derived-expression tier (DESIGN.md §10) classifies through **interval
arithmetic over the expression tree**: +, −, ×, ÷ (nonzero divisor),
abs/neg/min/max propagate window bounds exactly (float64 endpoint ops are
monotone; one-ulp outward rounding is applied anyway as slack), ``sum()``
reductions reuse the HT accumulation-slack bound, and the nonlinear
leading-pair nodes (invariant mass, ΔR) degrade to SCAN.  Trigger-OR
branches *absent from the store* contribute constant-False — mirroring
the evaluator's era-robust ``AnyOf`` semantics bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.expr import (
    RPN_ABS,
    RPN_ADD,
    RPN_BRANCH,
    RPN_CONST,
    RPN_DIV,
    RPN_MAX,
    RPN_MIN,
    RPN_MUL,
    RPN_NEG,
    RPN_SUB,
    RPN_SUM,
    counts_name,
)
from repro_torch.core.query import (
    AnyOf,
    Cut,
    DeltaRCut,
    ExprCut,
    HTCut,
    MassWindow,
    ObjectSelection,
    Query,
)

# window decisions
PRUNE = "prune"
ACCEPT_ALL = "accept_all"
SCAN = "scan"

# node tri-states ("does an event pass this node?")
ALWAYS = 1
NEVER = -1
MAYBE = 0


@dataclass(frozen=True)
class WindowDecision:
    """One window's pruning decision plus the priced savings.

    ``p1_bytes``/``p1_baskets`` are the phase-1 filter-branch fetch a
    PRUNE avoids; ``extra_bytes``/``extra_baskets`` are the filter-only
    (non-output) branches an ACCEPT_ALL never moves at all.  SCAN windows
    carry zeros.

    Pricing model: savings are priced against the **preloading** executor
    (the default fused/pipelined path, which fetches the full filter set
    per window) — exact there, pinned by tests.  The staged ``fused=False``
    reference hierarchically early-discards, so for a window it would have
    killed at stage 1 it fetches less than ``p1_bytes``; against that
    path the ledger is an upper bound.
    """

    start: int
    stop: int
    decision: str  # PRUNE | ACCEPT_ALL | SCAN
    p1_bytes: int = 0
    p1_baskets: int = 0
    extra_bytes: int = 0
    extra_baskets: int = 0


def _effective_threshold(value: float, dtype: np.dtype) -> float:
    """The threshold as the evaluator actually compares it.

    float32 branch vs python-float threshold compares at float32 (NumPy
    weak promotion), so the threshold is rounded through float32 first;
    every other dtype promotes to float64, where the python float is
    exact.  The result is returned as float64 (the exact embedding), so
    comparisons against float64 stat endpoints reproduce the evaluator.
    """
    if dtype == np.float32:
        return float(np.float32(value))
    return float(value)


def _cmp_interval(lo: float, hi: float, op: str, value: float) -> int:
    """Tri-state of ``x <op> value`` for all x in ``[lo, hi]``."""
    if op == ">":
        return ALWAYS if lo > value else (NEVER if hi <= value else MAYBE)
    if op == ">=":
        return ALWAYS if lo >= value else (NEVER if hi < value else MAYBE)
    if op == "<":
        return ALWAYS if hi < value else (NEVER if lo >= value else MAYBE)
    if op == "<=":
        return ALWAYS if hi <= value else (NEVER if lo > value else MAYBE)
    if op == "==":
        if lo == hi == value:
            return ALWAYS
        return NEVER if (value < lo or value > hi) else MAYBE
    if op == "!=":
        if value < lo or value > hi:
            return ALWAYS
        return NEVER if lo == hi == value else MAYBE
    if op in ("abs<", "abs>"):
        alo, ahi = _abs_interval(lo, hi)
        return _cmp_interval(alo, ahi, op[3:], value)
    return MAYBE  # unknown op: never prune on guesswork


def _abs_interval(lo: float, hi: float) -> tuple[float, float]:
    if lo >= 0.0:
        return lo, hi
    if hi <= 0.0:
        return -hi, -lo
    return 0.0, max(-lo, hi)


# ---------------------------------------------------------------------------
# per-node classification
# ---------------------------------------------------------------------------


def _branch_interval(stats_of, branch: str, store):
    """(lo, hi, dtype) of a branch over the window, or None if unknown."""
    st = stats_of(branch)
    if st is None or st.lo is None or st.hi is None:
        return None
    return st.lo, st.hi, store.branches[branch].np_dtype()


def _classify_cut(node: Cut, stats_of, store) -> int:
    iv = _branch_interval(stats_of, node.branch, store)
    if iv is None:
        return MAYBE
    lo, hi, dt = iv
    return _cmp_interval(lo, hi, node.op, _effective_threshold(node.value, dt))


def _classify_anyof(node: AnyOf, stats_of, store) -> int:
    """OR of boolean branches: ALWAYS if some branch is all-true in the
    window, NEVER only if every branch is provably all-false.

    A branch *absent from the store* is constant-False by the evaluator's
    era-robust semantics — it contributes nothing and cannot block a
    NEVER.  A branch that is present but lacks stats might fire."""
    all_false = True
    for name in node.names:
        if name not in store.branches:
            continue  # absent trigger: definitively all-false
        st = stats_of(name)
        if st is None or st.n_true is None:
            all_false = False  # unknown stats might fire
            continue
        if st.n_values > 0 and st.n_true == st.n_values:
            return ALWAYS
        if st.n_true > 0:
            all_false = False
    return NEVER if all_false else MAYBE


def _object_cut_states(collection: str, cuts, stats_of, store) -> list[int]:
    """Tri-state of each object-level cut over ALL objects in the window."""
    states = []
    for c in cuts:
        iv = _branch_interval(stats_of, f"{collection}_{c.var}", store)
        if iv is None:
            states.append(MAYBE)
            continue
        lo, hi, dt = iv
        states.append(
            _cmp_interval(lo, hi, c.op, _effective_threshold(c.value, dt))
        )
    return states


def _counts_bounds(collection: str, stats_of) -> tuple[int | None, int | None]:
    st = stats_of(f"n{collection}")
    if st is None or st.lo is None or st.hi is None:
        return None, None
    return int(st.lo), int(st.hi)


def _classify_object(node: ObjectSelection, stats_of, store) -> int:
    if node.min_count <= 0:
        return ALWAYS  # count >= 0 holds vacuously
    cmin, cmax = _counts_bounds(node.collection, stats_of)
    if cmax is not None and cmax < node.min_count:
        return NEVER  # covers cmax == 0: no objects at all in the window
    states = _object_cut_states(node.collection, node.cuts, stats_of, store)
    if any(s == NEVER for s in states):
        # no object anywhere in the window passes that cut -> per-event
        # passing count is 0 < min_count, whatever the counts are
        return NEVER
    if all(s == ALWAYS for s in states) and cmin is not None:
        if cmin >= node.min_count:
            return ALWAYS
    return MAYBE


def _classify_ht(node: HTCut, stats_of, store) -> int:
    cmin, cmax = _counts_bounds(node.collection, stats_of)
    states = _object_cut_states(node.collection, node.object_cuts, stats_of, store)
    zero_ht = cmax == 0 or any(s == NEVER for s in states)
    if zero_ht:
        # HT is exactly 0.0 for every event in the window
        return _cmp_interval(0.0, 0.0, node.op, float(node.value))
    iv = _branch_interval(stats_of, f"{node.collection}_{node.var}", store)
    if iv is None or cmax is None:
        return MAYBE
    vlo, vhi, _ = iv
    if all(s == ALWAYS for s in states) and cmin is not None:
        # every object contributes: per-event count in [cmin, cmax]
        ht_lo = min(cmin * vlo, cmax * vlo)
        ht_hi = max(cmin * vhi, cmax * vhi)
    else:
        # passing subset unknown: anywhere from none to all objects
        ht_lo = min(0.0, cmax * vlo)
        ht_hi = max(0.0, cmax * vhi)
    # float64 accumulation slack: the evaluator's per-event sum of up to
    # cmax float64 terms carries rounding error bounded by
    # (n-1)*u*sum|x| <= cmax^2 * max|v| * u (u = 2^-52); widen by that
    # bound with a 32x safety factor plus an absolute floor
    maxabs = max(abs(vlo), abs(vhi))
    slack = max(1e-12, 32 * 1.11e-16 * cmax * cmax * maxabs)
    ht_lo, ht_hi = ht_lo - slack, ht_hi + slack
    if node.op in ("==", "!="):
        # interval endpoints carry slack; only the NEVER side is provable
        state = _cmp_interval(ht_lo, ht_hi, node.op, float(node.value))
        return state if state == NEVER else MAYBE
    return _cmp_interval(ht_lo, ht_hi, node.op, float(node.value))


# ---------------------------------------------------------------------------
# expression interval arithmetic (DESIGN.md §10)
# ---------------------------------------------------------------------------

# float64 unit roundoff; the HT/sum accumulation-slack constant
_ULP = 1.11e-16


def _outward(lo: float, hi: float) -> tuple[float, float]:
    """One-ulp outward rounding slack after an inexact float64 op.

    Endpoint arithmetic is already conservative (IEEE rounding is
    monotone, so pointwise float64 results stay inside the float64
    endpoint interval), but the extra ulp keeps the bound safe against
    any non-monotone refactor of the evaluator."""
    return float(np.nextafter(lo, -np.inf)), float(np.nextafter(hi, np.inf))


def _sum_interval(branch: str, stats_of, store):
    """Bounds of the per-event float64 ``sum(branch)`` reduction, or None.

    Mirrors the HT bound: per-event count in [cmin, cmax], every value in
    [vlo, vhi], widened by the rigorous float64 accumulation slack."""
    cst = stats_of(counts_name(branch))
    if cst is None or cst.lo is None or cst.hi is None:
        return None
    cmin, cmax = int(cst.lo), int(cst.hi)
    if cmax == 0:
        return 0.0, 0.0  # no objects anywhere: the sum is exactly 0.0
    iv = _branch_interval(stats_of, branch, store)
    if iv is None:
        return None
    vlo, vhi, _ = iv
    cands = (cmin * vlo, cmax * vlo, cmin * vhi, cmax * vhi)
    maxabs = max(abs(vlo), abs(vhi))
    slack = max(1e-12, 32 * _ULP * cmax * cmax * maxabs)
    return min(cands) - slack, max(cands) + slack


def _expr_interval(rpn, stats_of, store):
    """(lo, hi) bounds of a branch-name RPN over the window, or None.

    Any unknown input (missing stats, absent branch), a divisor interval
    straddling zero, or a non-finite endpoint poisons the whole
    expression — degrading to SCAN, never to a wrong skip."""
    stack: list[tuple[float, float]] = []
    for op, arg in rpn:
        if op == RPN_BRANCH:
            iv = _branch_interval(stats_of, str(arg), store)
            if iv is None:
                return None
            stack.append((iv[0], iv[1]))
        elif op == RPN_SUM:
            iv = _sum_interval(str(arg), stats_of, store)
            if iv is None:
                return None
            stack.append(iv)
        elif op == RPN_CONST:
            stack.append((float(arg), float(arg)))
        elif op == RPN_NEG:
            lo, hi = stack.pop()
            stack.append((-hi, -lo))
        elif op == RPN_ABS:
            stack.append(_abs_interval(*stack.pop()))
        else:
            blo, bhi = stack.pop()
            alo, ahi = stack.pop()
            if op == RPN_ADD:
                lo, hi = _outward(alo + blo, ahi + bhi)
            elif op == RPN_SUB:
                lo, hi = _outward(alo - bhi, ahi - blo)
            elif op == RPN_MUL:
                c = (alo * blo, alo * bhi, ahi * blo, ahi * bhi)
                lo, hi = _outward(min(c), max(c))
            elif op == RPN_DIV:
                if blo <= 0.0 <= bhi:
                    return None  # divisor may vanish: unbounded
                c = (alo / blo, alo / bhi, ahi / blo, ahi / bhi)
                lo, hi = _outward(min(c), max(c))
            elif op == RPN_MIN:
                lo, hi = min(alo, blo), min(ahi, bhi)
            elif op == RPN_MAX:
                lo, hi = max(alo, blo), max(ahi, bhi)
            else:
                return None  # unknown op: never skip on guesswork
            stack.append((lo, hi))
        lo, hi = stack[-1]
        if not (np.isfinite(lo) and np.isfinite(hi)):
            return None
    (result,) = stack
    return result


def _classify_expr(node: ExprCut, stats_of, store) -> int:
    iv = _expr_interval(node.rpn, stats_of, store)
    if iv is None:
        return MAYBE
    # the evaluator compares the float64 expression value against the
    # python-float threshold exactly — no float32 threshold rounding here
    return _cmp_interval(iv[0], iv[1], node.op, float(node.value))


def classify_node(node, stats_of, store) -> int:
    """Tri-state of one AST node over a window described by ``stats_of``
    (a callable ``branch -> ZoneStats | None``)."""
    if isinstance(node, Cut):
        return _classify_cut(node, stats_of, store)
    if isinstance(node, AnyOf):
        return _classify_anyof(node, stats_of, store)
    if isinstance(node, ObjectSelection):
        return _classify_object(node, stats_of, store)
    if isinstance(node, HTCut):
        return _classify_ht(node, stats_of, store)
    if isinstance(node, ExprCut):
        return _classify_expr(node, stats_of, store)
    if isinstance(node, (MassWindow, DeltaRCut)):
        # nonlinear leading-pair kinematics: window bounds on pt/eta/phi
        # do not bound the pair observable tightly enough to skip safely
        return MAYBE
    return MAYBE  # unknown node types never authorize a skip


# ---------------------------------------------------------------------------
# window classification
# ---------------------------------------------------------------------------


def classify_span(query: Query, store, start: int, stop: int) -> str:
    """Classify one event span.  Stages are AND-semantic, so one NEVER
    node prunes the span and the span is accept-all only when every node
    is ALWAYS (a selection-free query is accept-all by construction)."""
    cache: dict[str, object] = {}

    def stats_of(branch: str):
        if branch not in cache:
            cache[branch] = (
                store.window_stats(branch, start, stop)
                if branch in store.branches
                else None
            )
        return cache[branch]

    all_always = True
    for _, stage in query.stages():
        for node in stage:
            state = classify_node(node, stats_of, store)
            if state == NEVER:
                return PRUNE
            if state != ALWAYS:
                all_always = False
    return ACCEPT_ALL if all_always else SCAN


def classify_windows(
    query: Query, store, spans: "list[tuple[int, int]]"
) -> list[str]:
    """Per-window decisions for a list of ``[start, stop)`` spans."""
    return [classify_span(query, store, a, b) for a, b in spans]


__all__ = [
    "ACCEPT_ALL",
    "ALWAYS",
    "MAYBE",
    "NEVER",
    "PRUNE",
    "SCAN",
    "WindowDecision",
    "classify_node",
    "classify_span",
    "classify_windows",
]
