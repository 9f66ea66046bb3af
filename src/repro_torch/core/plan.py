"""Cascaded phase-1 physical plan: cost-based stage IR + executor (DESIGN.md §11).

The two-phase model moves only the bytes a skim needs — but phase 1
still paid the *full* filter-branch set for every scanned window, even
when the first cheap scalar cut kills 99% of the events.  This module
lowers a compiled :class:`~repro_torch.core.query.Query` into an ordered
**cascade** of phase-1 stages:

  * each :class:`CascadeStage` names one predicate node's branch set, its
    compiled sub-program (``kernels.program.compile_query`` over a
    single-node query, so the fused kernel path evaluates per-stage
    sub-programs exactly like the monolithic program), and a cost
    estimate;
  * a **cost model seeded from zone-map basket stats** prices each stage:
    ``vmin``/``vmax``/``n_true`` give an estimated selectivity (uniform
    density over the observed interval; trigger true-rates are exact),
    ``range_comp_bytes`` gives the fetch cost; stages run
    cheapest-and-most-selective-first (rank = bytes / (1 − selectivity),
    the classic predicate-ordering rule);
  * **per-window observed selectivities adapt the order** as the scan
    progresses (:class:`CascadeState`): once a stage has seen events, its
    observed pass rate replaces the estimate in the rank.  The *head*
    stage is pinned to the static cost-model choice so the double-buffered
    prefetcher's load set is identical across ``pipeline`` modes
    (serial == threaded accounting invariance, DESIGN.md §4b).

The executor (:class:`CascadeExecutor`) evaluates stage *k* **only over
the basket spans still alive** after stage *k−1*'s mask — dead baskets
are never fetched, dead windows stop the cascade, and a per-window
basket ledger guarantees every ``(branch, basket)`` pair is paid at most
once per window across phase 1 *and* phase 2 (the decoded-basket LRU
absorbs the decode side of stage overlap).  The final mask is
bit-identical to the single-pass reference for ANY stage order, because
every predicate node is a per-event function of its own branches and
stages combine with logical AND.

``cascade=False`` on the engines keeps the PR-4 preload path, exactly
like ``prune=False`` keeps the unpruned reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.branchmap import with_counts_branches
from repro_torch.core.query import (
    AnyOf,
    Cut,
    HTCut,
    ObjectSelection,
    Query,
)
from repro_torch.core.zonemap import ACCEPT_ALL, PRUNE, SCAN
from repro_torch.data.store import FetchStats, coalesced_requests
from repro_torch.obs.trace import active

# selectivity the cost model assumes when statistics prove nothing
# (HT / mass / ΔR / expression nodes, unknown stats)
DEFAULT_SELECTIVITY = 0.5
# rank = est_bytes / max(1 - selectivity, _MIN_KILL): bounds the rank of
# near-accept-all stages instead of dividing by zero
_MIN_KILL = 1e-3


@dataclass(frozen=True)
class CascadeStage:
    """One phase-1 stage: a predicate node, its fetch set, and its price."""

    index: int  # position in the reference (query-order) cascade
    tier: str  # originating stage name (preselection/object/event)
    nodes: tuple  # AST nodes this stage evaluates (currently one)
    branches: tuple[str, ...]  # fetch set, counts branches included
    est_selectivity: float  # cost-model pass-rate estimate in [0, 1]
    est_bytes: int  # whole-store compressed fetch cost of `branches`
    program: object = None  # compiled sub-Program (lazy, see CascadePlan)

    @property
    def rank(self) -> float:
        """Static cost-model rank: cheaper and more selective is smaller."""
        return self.est_bytes / max(1.0 - self.est_selectivity, _MIN_KILL)


# predicate-node class -> stage kind label.  The calibration loop keys
# priced-vs-observed byte ratios by this (DESIGN.md §13): pricing errors
# are systematic per node *kind* (trigger true-rates are exact, ΔR/mass
# selectivities are guesses), not per individual stage.
_NODE_KIND = {
    "Cut": "cut",
    "AnyOf": "trigger",
    "ObjectSelection": "object",
    "HTCut": "ht",
    "MassWindow": "mass",
    "DeltaRCut": "deltaR",
    "ExprCut": "expr",
}


def stage_kind(stage: CascadeStage) -> str:
    """Stable kind label for a cascade stage (its predicate-node class)."""
    if not stage.nodes:
        return "const"
    return _NODE_KIND.get(type(stage.nodes[0]).__name__, "other")


@dataclass
class CascadePlan:
    """Ordered cascade IR for one (query, store) pair.

    ``static_order`` is the cost model's execution order (stage indices
    into ``stages``); ``static_order[0]`` is the pinned head stage the
    prefetcher loads.  The runtime order may permute the tail
    (:class:`CascadeState`) — any permutation is bit-identical on
    survivors, only the byte ledger changes.
    """

    stages: list[CascadeStage]
    static_order: list[int]

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def head(self) -> CascadeStage:
        return self.stages[self.static_order[0]]

    def describe(self) -> str:
        parts = []
        for i in self.static_order:
            s = self.stages[i]
            parts.append(
                f"{'/'.join(sorted(b for b in s.branches)[:2]) or '<const>'}"
                f"(sel~{s.est_selectivity:.2f},{s.est_bytes / 1e3:.0f}kB)"
            )
        return " -> ".join(parts)


# ---------------------------------------------------------------------------
# cost model: zone-map statistics -> estimated selectivity
# ---------------------------------------------------------------------------


def _uniform_frac(lo: float, hi: float, op: str, value: float) -> float:
    """Pass fraction of ``x <op> value`` assuming x uniform on [lo, hi].

    Estimation only — never used for correctness decisions (that is the
    zone-map's exact interval analysis).  Degenerate intervals evaluate
    the comparison at the point.
    """
    if hi <= lo:
        from repro_torch.core.query import OPS

        try:
            return 1.0 if bool(OPS[op](lo, value)) else 0.0
        except KeyError:
            return DEFAULT_SELECTIVITY
    w = hi - lo
    if op in (">", ">="):
        return min(max((hi - value) / w, 0.0), 1.0)
    if op in ("<", "<="):
        return min(max((value - lo) / w, 0.0), 1.0)
    if op == "==":
        return 0.05 if lo <= value <= hi else 0.0
    if op == "!=":
        return 0.95 if lo <= value <= hi else 1.0
    if op in ("abs<", "abs>"):
        a = max(lo, -abs(value))
        b = min(hi, abs(value))
        inside = max(b - a, 0.0) / w
        return inside if op == "abs<" else 1.0 - inside
    return DEFAULT_SELECTIVITY


def _poisson_tail(lam: float, min_count: int) -> float:
    """P(N >= min_count) for N ~ Poisson(lam)."""
    if min_count <= 0:
        return 1.0
    if lam <= 0.0:
        return 0.0
    cdf = 0.0
    term = math.exp(-lam)
    for k in range(min_count):
        cdf += term
        term *= lam / (k + 1)
    return min(max(1.0 - cdf, 0.0), 1.0)


def estimate_node_selectivity(node, stats_of, store) -> float:
    """Estimated pass rate of one AST node from zone-map statistics.

    ``stats_of`` maps branch -> :class:`~repro_torch.data.store.ZoneStats` or
    ``None``.  Unknown statistics and nodes the stats cannot speak about
    (HT, mass, ΔR, expressions) fall back to ``DEFAULT_SELECTIVITY``.
    """
    if isinstance(node, Cut):
        st = stats_of(node.branch)
        if st is None or st.lo is None or st.hi is None:
            return DEFAULT_SELECTIVITY
        if st.n_true is not None and st.n_values:
            # boolean branch: the true-rate is exact
            frac_true = st.n_true / st.n_values
            passes_true = _uniform_frac(1.0, 1.0, node.op, float(node.value))
            passes_false = _uniform_frac(0.0, 0.0, node.op, float(node.value))
            return frac_true * passes_true + (1.0 - frac_true) * passes_false
        return _uniform_frac(st.lo, st.hi, node.op, float(node.value))
    if isinstance(node, AnyOf):
        miss_all = 1.0
        any_present = False
        for name in node.names:
            if name not in store.branches:
                continue  # absent trigger: constant-False, contributes 0
            any_present = True
            st = stats_of(name)
            rate = (
                st.n_true / st.n_values
                if st is not None and st.n_true is not None and st.n_values
                else 0.3
            )
            miss_all *= 1.0 - rate
        return 1.0 - miss_all if any_present else 0.0
    if isinstance(node, ObjectSelection):
        if node.min_count <= 0:
            return 1.0
        p_obj = 1.0
        mean_count = None
        for c in node.cuts:
            st = stats_of(f"{node.collection}_{c.var}")
            if st is None or st.lo is None or st.hi is None:
                p_obj *= DEFAULT_SELECTIVITY
                continue
            if st.n_entries:
                mean_count = st.n_values / st.n_entries
            p_obj *= _uniform_frac(st.lo, st.hi, c.op, float(c.value))
        if mean_count is None:
            cst = stats_of(f"n{node.collection}")
            if cst is None or cst.lo is None or cst.hi is None:
                return DEFAULT_SELECTIVITY
            mean_count = (cst.lo + cst.hi) / 2.0
        return _poisson_tail(mean_count * p_obj, node.min_count)
    if isinstance(node, HTCut):
        return DEFAULT_SELECTIVITY
    return DEFAULT_SELECTIVITY  # mass / ΔR / expr: stats say nothing


# ---------------------------------------------------------------------------
# lowering: Query -> CascadePlan
# ---------------------------------------------------------------------------


def _stage_query(tier: str, node) -> Query:
    """Single-node query wrapping one AST node (the compile_query input
    for a per-stage sub-program; the tier placement is semantic only)."""
    kw = {"preselection": (), "object_stage": (), "event_stage": ()}
    key = {
        "preselection": "preselection",
        "object": "object_stage",
        "event": "event_stage",
    }[tier]
    kw[key] = (node,)
    return Query(input="", output="", branches=(), force_all=False, **kw)


def _stage_branches(node, store) -> tuple[str, ...]:
    """Fetch set of one node: its branches (present-only for trigger ORs,
    whose absent names are constant-False) plus the counts branches any
    jagged member needs."""
    names = node.branches()
    if isinstance(node, AnyOf):
        names = {n for n in names if n in store.branches}
    return tuple(with_counts_branches(sorted(names), store))


def build_cascade(query: Query, store) -> CascadePlan | None:
    """Lower a query to a :class:`CascadePlan`, or ``None`` when there is
    nothing to cascade (no predicate nodes — constant programs keep the
    engines' dedicated constant path).
    """
    from repro_torch.kernels.program import compile_query

    cache: dict[str, object] = {}

    def stats_of(branch: str):
        if branch not in cache:
            cache[branch] = (
                store.window_stats(branch, 0, store.n_events)
                if branch in store.branches
                else None
            )
        return cache[branch]

    stages: list[CascadeStage] = []
    for tier, stage in query.stages():
        for node in stage:
            branches = _stage_branches(node, store)
            stages.append(
                CascadeStage(
                    index=len(stages),
                    tier=tier,
                    nodes=(node,),
                    branches=branches,
                    est_selectivity=float(
                        min(max(estimate_node_selectivity(node, stats_of, store), 0.0), 1.0)
                    ),
                    est_bytes=store.compressed_bytes(branches),
                    program=compile_query(_stage_query(tier, node)),
                )
            )
    if not stages:
        return None
    static_order = sorted(range(len(stages)), key=lambda i: (stages[i].rank, i))
    return CascadePlan(stages=stages, static_order=static_order)


# ---------------------------------------------------------------------------
# admission pricing: whole-plan byte estimate BEFORE anything runs
# ---------------------------------------------------------------------------


def estimate_plan_bytes(
    plan, store, window_events: int, calibration: dict | None = None
) -> dict:
    """Price a :class:`~repro_torch.core.planner.SkimPlan`'s fetch bytes before
    executing it — the admission-control currency (DESIGN.md §12).

    Pure metadata: basket sizes come from ``range_comp_bytes``, pass
    rates from the cascade stages' zone-map-seeded selectivity estimates
    (stage independence assumed), window skips from the plan's zone-map
    decisions.  **Nothing is fetched or decoded** — a service can reject
    a query on this price with zero bytes moved.

    Per window: PRUNE windows cost nothing; ACCEPT_ALL windows pay the
    one phase-2 output round; scanned windows pay the head stage in
    full, each later cascade stage scaled by the estimated alive
    fraction after its predecessors, and the phase-2 output-only set
    scaled by the probability the window keeps a survivor.  Without a
    cascade the full filter set is priced per window (the preload path).

    ``calibration`` is an optional ``{stage_kind: ratio}`` prior of
    observed/priced byte ratios (from
    :meth:`repro_torch.obs.metrics.MetricsRegistry.calibration_priors` — the
    admission feedback loop): each stage's priced bytes scale by its
    kind's ratio, phase 2 by the ``"phase2"`` ratio.  Ratios clamp to
    [0.05, 20] so a few anomalous jobs cannot collapse or explode the
    price; ``None`` (the default) prices exactly as before.

    Returns ``{"phase1", "phase2", "total", "requests", "per_stage",
    "per_stage_kinds", "est_selectivity", "n_windows",
    "n_windows_pruned"}`` — bytes as ints, ``per_stage`` keyed by
    cascade stage index in static order, ``per_stage_kinds`` mapping
    those indices to kind labels.
    """

    def _scale(kind: str) -> float:
        if not calibration:
            return 1.0
        ratio = calibration.get(kind)
        if ratio is None:
            return 1.0
        return min(max(float(ratio), 0.05), 20.0)

    n = store.n_events
    spans = [
        (s, min(s + window_events, n)) for s in range(0, n, window_events)
    ]
    decisions = plan.window_decisions
    cplan = plan.cascade
    per_stage: dict[int, float] = (
        {s.index: 0.0 for s in cplan.stages} if cplan is not None else {}
    )
    stage_kinds: dict[int, str] = (
        {s.index: stage_kind(s) for s in cplan.stages}
        if cplan is not None
        else {}
    )
    phase1 = phase2 = 0.0
    requests = 0
    pruned = 0
    passed_est = 0.0
    for wi, (a, b) in enumerate(spans):
        kind = decisions[wi].decision if decisions is not None else SCAN
        m = b - a
        if kind == PRUNE:
            pruned += 1
            continue
        if kind == ACCEPT_ALL:
            nbytes, nb = store.range_comp_bytes(plan.output_branches, a, b)
            phase2 += nbytes * _scale("phase2")
            requests += coalesced_requests(nbytes, nb, True)
            passed_est += m
            continue
        if cplan is not None:
            # the alive fraction prices later stages in the *correlated*
            # limit (whole baskets live or die together) — the right
            # prior for era-correlated HEP data, where conditions are
            # constant within a basket; the independent limit would
            # price every stage at its full preload cost
            alive = 1.0
            for si in cplan.static_order:
                stage = cplan.stages[si]
                nbytes, _ = store.range_comp_bytes(stage.branches, a, b)
                # truncate per window so per_stage sums exactly to phase1
                est = int(nbytes * alive * _scale(stage_kinds[si]))
                per_stage[si] += est
                phase1 += est
                if est:
                    requests += coalesced_requests(est, 0, True)
                alive *= stage.est_selectivity
            sel = alive
        else:
            nbytes, _ = store.range_comp_bytes(plan.filter_branches, a, b)
            phase1 += nbytes
            if nbytes:
                requests += coalesced_requests(nbytes, 0, True)
            sel = DEFAULT_SELECTIVITY ** max(
                sum(len(stage) for _, stage in plan.query.stages()), 1
            )
        sel = min(max(sel, 0.0), 1.0)
        passed_est += sel * m
        # phase 2 moves the output-only set iff >= 1 event survives
        p_alive = 1.0 - (1.0 - sel) ** max(m, 1)
        nbytes, _ = store.range_comp_bytes(plan.output_only_branches, a, b)
        phase2 += nbytes * p_alive * _scale("phase2")
        if nbytes and p_alive > 0.5:
            requests += coalesced_requests(nbytes, 0, True)
    return {
        "phase1": int(phase1),
        "phase2": int(phase2),
        "total": int(phase1 + phase2),
        "requests": int(requests),
        "per_stage": {si: int(v) for si, v in per_stage.items()},
        "per_stage_kinds": stage_kinds,
        "est_selectivity": passed_est / max(n, 1),
        "n_windows": len(spans),
        "n_windows_pruned": pruned,
    }


# ---------------------------------------------------------------------------
# runtime state: observed selectivities adapt the order
# ---------------------------------------------------------------------------


@dataclass
class _StageLedger:
    events_in: int = 0
    events_out: int = 0
    bytes_fetched: int = 0
    windows: int = 0
    windows_skipped: int = 0  # windows dead before this stage ran


class CascadeState:
    """Per-run mutable cascade state: observed pass rates + byte ledger.

    ``order()`` returns the execution order for the next window: the head
    stage is pinned (static cost model), the tail re-ranks with observed
    selectivities once a stage has seen events.  Updates happen strictly
    in window order on the consumer side, so the order sequence — and
    with it the byte accounting — is identical across ``pipeline`` modes.
    """

    def __init__(self, cplan: CascadePlan, adaptive: bool = True):
        self.cplan = cplan
        self.adaptive = adaptive
        self.ledgers = [_StageLedger() for _ in cplan.stages]

    def observed_selectivity(self, i: int) -> float | None:
        led = self.ledgers[i]
        if led.events_in <= 0:
            return None
        return led.events_out / led.events_in

    def _blended(self, i: int) -> float:
        obs = self.observed_selectivity(i)
        return obs if obs is not None else self.cplan.stages[i].est_selectivity

    def order(self) -> list[int]:
        head, *tail = self.cplan.static_order
        if self.adaptive and tail:
            tail = sorted(
                tail,
                key=lambda i: (
                    self.cplan.stages[i].est_bytes
                    / max(1.0 - self._blended(i), _MIN_KILL),
                    i,
                ),
            )
        return [head, *tail]

    def observe(self, i: int, n_in: int, n_out: int, nbytes: int) -> None:
        led = self.ledgers[i]
        led.events_in += int(n_in)
        led.events_out += int(n_out)
        led.bytes_fetched += int(nbytes)
        led.windows += 1

    def skip(self, i: int) -> None:
        self.ledgers[i].windows_skipped += 1

    def report(self) -> list[dict]:
        """Per-stage extras ledger, in current execution order."""
        out = []
        for i in self.order():
            s, led = self.cplan.stages[i], self.ledgers[i]
            out.append(
                {
                    "stage": i,
                    "tier": s.tier,
                    "kind": stage_kind(s),
                    "branches": list(s.branches),
                    "est_selectivity": s.est_selectivity,
                    "observed_selectivity": self.observed_selectivity(i),
                    "bytes_fetched": led.bytes_fetched,
                    "windows": led.windows,
                    "windows_skipped": led.windows_skipped,
                    "events_in": led.events_in,
                    "events_out": led.events_out,
                }
            )
        return out


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


def _alive_spans(
    mask: np.ndarray, start: int, stop: int, basket_events: int
) -> list[tuple[int, int]]:
    """Maximal contiguous event spans of baskets with >= 1 alive event.

    The basket grid is global (multiples of ``basket_events``); spans are
    clipped to the window.  Baskets whose events are all dead never
    appear — they are exactly the baskets the next stage must not fetch.
    """
    spans: list[list[int]] = []
    grid0 = start - start % basket_events
    for gb in range(grid0, stop, basket_events):
        a, b = max(gb, start), min(gb + basket_events, stop)
        if not mask[a - start : b - start].any():
            continue
        if spans and spans[-1][1] == a:
            spans[-1][1] = b
        else:
            spans.append([a, b])
    return [(a, b) for a, b in spans]


def account_fetch(
    store,
    names,
    start: int,
    stop: int,
    ledger: dict[str, set],
    stats: FetchStats | None,
    coalesce: bool = True,
) -> int:
    """Account one fetch round for ``names`` over ``[start, stop)``,
    charging only baskets not yet in ``ledger`` (and marking them).

    Mirrors :meth:`EventStore.fetch_window`'s request model on the *new*
    bytes: bulk requests of at most the TTreeCache size when coalescing,
    one seek per basket otherwise.  Returns the newly accounted bytes.
    """
    new_bytes = new_baskets = 0
    per_branch: dict[str, int] = {}
    with active().span("account_fetch", kind="ledger"):
        for name in names:
            seen = ledger.setdefault(name, set())
            for i in store.basket_ids_for_range(name, start, stop):
                if i in seen:
                    continue
                seen.add(i)
                nb = store.basket_meta(name, i).comp_bytes
                per_branch[name] = per_branch.get(name, 0) + nb
                new_bytes += nb
                new_baskets += 1
        if stats is not None and new_bytes:
            stats.bytes_fetched += new_bytes
            stats.requests += coalesced_requests(new_bytes, new_baskets, coalesce)
            for k, v in per_branch.items():
                stats.by_branch[k] = stats.by_branch.get(k, 0) + v
    return new_bytes


def mark_fetched(store, names, start: int, stop: int, ledger: dict[str, set]) -> None:
    """Mark baskets as already accounted (no stats) — the caller fetched
    them through another path (e.g. the prefetcher's load stage)."""
    with active().span("mark_fetched", kind="ledger"):
        for name in names:
            seen = ledger.setdefault(name, set())
            seen.update(store.basket_ids_for_range(name, start, stop))


def unfetched_bytes(
    store, names, start: int, stop: int, ledger: dict[str, set]
) -> int:
    """Bytes of ``names``' window baskets the ledger never saw — the
    exact cascade savings once BOTH phases have run (a basket phase 2
    re-fetched is in the ledger and does not count as skipped)."""
    skipped = 0
    with active().span("unfetched_bytes", kind="ledger"):
        for name in names:
            seen = ledger.get(name, ())
            for i in store.basket_ids_for_range(name, start, stop):
                if i not in seen:
                    skipped += store.basket_meta(name, i).comp_bytes
    return skipped


def _slot_attrs(slots: list | None) -> dict:
    """A ``cascade_stage`` span's slot counters for a detailed tracer:
    ``plane_slots``, the events × K of the padded planes the stage laid
    out, and ``object_slots``, the real objects in them; {} without."""
    if slots is None:
        return {}
    return {"plane_slots": int(slots[0]), "object_slots": int(slots[1])}


@dataclass
class WindowOutcome:
    """One window's cascade result: the survivor mask plus ledgers."""

    mask: np.ndarray
    full_loaded: dict  # branch -> full-window decoded array
    stage_bytes: int  # on-demand phase-1 bytes (beyond the head preload)
    stages_run: int


class CascadeExecutor:
    """Shared cascaded phase-1 executor (engine / shared-scan / cluster).

    One instance per skim run; holds the adaptive :class:`CascadeState`.
    The caller owns window iteration, zone-map decisions, phase 2, and
    output assembly — the executor owns stage ordering, alive-span
    fetch/decode, sub-program evaluation, and the basket ledger.
    """

    def __init__(
        self,
        plan,  # SkimPlan with .cascade set
        store,
        coalesce: bool = True,
        adaptive: bool = True,
        order: list[int] | None = None,
        tracer=None,
        backend: str | None = None,
        device=None,
    ):
        if plan.cascade is None:
            raise ValueError("plan has no cascade (plan_skim(cascade=True))")
        from repro_torch.obs.trace import NULL_TRACER

        self.plan = plan
        self.cplan: CascadePlan = plan.cascade
        self.store = store
        self.coalesce = coalesce
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._forced_order = list(order) if order is not None else None
        self.state = CascadeState(self.cplan, adaptive=adaptive and order is None)
        self._backend: str | None = backend  # resolved on first evaluation
        self.device = device  # where "cuda"/"torch" stages evaluate
        # batched-dispatch shape buckets (DESIGN.md §16): grow-only so a
        # late large window re-buckets once instead of re-warming per batch
        self._pad_E: int = 0
        self._stage_K: dict[int, int] = {}

    # -- plan queries --------------------------------------------------------

    def order(self) -> list[int]:
        return self._forced_order or self.state.order()

    @property
    def head_branches(self) -> list[str]:
        """The pinned head stage's fetch set — what the prefetcher loads.

        Reads only immutable plan state (never the adaptive ledgers): the
        prefetch worker calls this concurrently with consumer-side
        ``observe`` updates, and the load set must be identical across
        pipeline modes anyway (DESIGN.md §4b)."""
        head = (self._forced_order or self.cplan.static_order)[0]
        return list(self.cplan.stages[head].branches)

    # -- stage evaluation ----------------------------------------------------

    def _resolve_backend(self) -> str:
        """The stage backend: as given, else the kernel on the card and the
        host interpreter on the CPU (resolved once per run)."""
        if self._backend is None:
            from repro_torch.device import resolve_device

            self._backend = (
                "cuda" if resolve_device(self.device).type == "cuda" else "host"
            )
        return self._backend

    def _eval_stage(
        self, stage: CascadeStage, data: dict, n: int, slots: list | None = None
    ) -> np.ndarray:
        """Evaluate one sub-program over a decoded span (fused path):
        the CUDA kernel on the card, the compiled-program interpreter on
        the CPU — resolved once per run (this is the per-span hot
        path).  ``slots`` ([plane slots, object slots]) gains the padded
        planes' events × K laid out for the span and the objects in them;
        the host interpreter lays out none."""
        from repro_torch.core import neardata as nd

        if not stage.branches:
            # constant sub-program (trigger OR over absent-era branches)
            return nd.program_eval_np({}, stage.program, n)
        if self._resolve_backend() == "host":
            with active().span("program_eval_np", kind="evaluate"):
                return nd.program_eval_np(data, stage.program, n)
        K = nd.window_pad_K(data, stage.program, self.store)
        mask, _ = nd.fused_window_skim(
            data, stage.program, self.store, K=K, backend=self._backend,
            device=self.device,
        )
        if slots is not None:
            slots[0] += nd.padded_events(n) * K
            slots[1] += nd.object_slots(data, stage.program, self.store, n, K)
        return mask

    # -- the per-window cascade ---------------------------------------------

    def run_window(
        self,
        start: int,
        stop: int,
        head_data: dict | None,
        breakdown,
        stats: FetchStats,
        ledger: dict[str, set] | None = None,
        timer_breakdown=None,
    ) -> WindowOutcome:
        """Run the cascade over one window; returns the survivor mask.

        ``head_data`` holds the head stage's branches decoded over the
        full window (the prefetcher's load payload) — its fetch must
        already be accounted and marked in ``ledger`` by the caller (or
        pass ``None`` to let the executor fetch it here).  Later stages
        fetch **only alive basket spans**, charging ``stats`` through the
        dedup ledger.  ``breakdown`` receives decode timings,
        ``timer_breakdown`` (default: same) the filter timings.
        """
        from repro_torch.core.engine import _decode_branches, _Timer

        store = self.store
        timer_breakdown = timer_breakdown if timer_breakdown is not None else breakdown
        m = stop - start
        mask = np.ones(m, dtype=bool)
        ledger = {} if ledger is None else ledger
        full_loaded: dict = {}
        order = self.order()
        stage_bytes_total = 0
        stages_run = 0

        for pos, si in enumerate(order):
            stage = self.cplan.stages[si]
            alive_in = int(mask.sum())
            if alive_in == 0:
                # dead window: remaining stages never fetch a byte
                for rest in order[pos:]:
                    self.state.skip(rest)
                break
            stages_run += 1
            ssid = self.tracer.begin(
                f"stage[{si}]", kind="cascade_stage", stage=si,
                node=stage_kind(stage), tier=stage.tier,
            )
            slots = [0, 0] if self.tracer.detail else None
            stage_bytes = 0
            if pos == 0 and head_data is not None:
                spans = [(start, stop)]
            else:
                spans = _alive_spans(mask, start, stop, store.basket_events)
            for a, b in spans:
                if pos == 0 and head_data is not None:
                    sdata, n_local, off = head_data, m, 0
                else:
                    stage_bytes += account_fetch(
                        store, stage.branches, a, b, ledger, stats, self.coalesce
                    )
                    sdata = _decode_branches(
                        store, list(stage.branches), a, b, breakdown,
                        FetchStats(), self.coalesce, tracer=self.tracer,
                    )
                    n_local, off = b - a, a - start
                with _Timer(timer_breakdown, "filter"):
                    smask = self._eval_stage(stage, sdata, n_local, slots)
                mask[off : off + n_local] &= smask
                if n_local == m:
                    # full-window decode: reusable by phase 2 as-is
                    full_loaded.update(sdata)
            stage_bytes_total += stage_bytes
            alive_out = int(mask.sum())
            self.tracer.end(
                ssid, alive_in=alive_in, alive_out=alive_out, bytes=stage_bytes,
                **_slot_attrs(slots),
            )
            self.state.observe(si, alive_in, alive_out, stage_bytes)
        return WindowOutcome(
            mask=mask,
            full_loaded=full_loaded,
            stage_bytes=stage_bytes_total,
            stages_run=stages_run,
        )

    # -- the batched cascade (one device dispatch per stage per batch) -------

    @staticmethod
    def _bits_to_spans(
        bits, start: int, stop: int, basket_events: int
    ) -> list[tuple[int, int]]:
        """Alive-basket bits (window-local ordinals on the global basket
        grid) -> merged contiguous event spans, clipped to the window.
        The batched mirror of :func:`_alive_spans`, driven by the (B, nb)
        basket-alive planes the device step returns instead of the full
        event mask (which stays device-resident)."""
        grid0 = start - start % basket_events
        spans: list[list[int]] = []
        for j, bit in enumerate(bits):
            if not bit:
                continue
            a = max(grid0 + j * basket_events, start)
            b = min(grid0 + (j + 1) * basket_events, stop)
            if a >= b:
                continue
            if spans and spans[-1][1] == a:
                spans[-1][1] = b
            else:
                spans.append([a, b])
        return [(a, b) for a, b in spans]

    def run_window_batch(
        self,
        entries: list[tuple],
        pad_B: int | None = None,
    ) -> list[WindowOutcome]:
        """Run the cascade over a batch of windows with ONE device
        dispatch per stage (DESIGN.md §16).

        ``entries`` is a list of ``(start, stop, head_data, breakdown,
        stats, ledger)`` tuples — the same per-window arguments as
        :meth:`run_window`; returns one :class:`WindowOutcome` per entry,
        in order, bit-identical to running each window through
        :meth:`run_window` with the batch's (frozen) stage order.

        Mechanics: windows are staged into stable-shaped batch tensors
        (event axis padded to a grow-only ``pad_E`` bucket, batch axis to
        ``pad_B`` with dead windows, per-stage object capacity ``K`` in
        grow-only pow2 buckets).  The survivor masks live on the stage's
        device as bit-packed int32 words between stages, and each stage
        updates them in place (the JAX package donates the buffer
        instead).  Per stage only the windows with a live event are
        staged (:class:`repro_torch.kernels.ops.CascadeInputs`: their
        ``terms``/``valid``/``weights`` planes and a row table, in one
        page-locked buffer on the card) and go up in one copy, and one
        (B, nb + 1) buffer of basket-alive bits and counts comes back — it
        drives the *next* stage's alive-span fetch, so dead baskets are
        never re-staged.  The full event masks cross back exactly once, at
        the window-ledger boundary (batch end).  Fetch accounting is per
        window through each entry's own stats + ledger, identical to the
        per-window path.

        Backends: ``"cuda"`` runs the CUDA kernel on the executor's
        device, ``"torch"`` its plain version there, ``"host"`` the plain
        version on the CPU.
        """
        import time as _time

        import torch

        from repro_torch.analysis.verify import maybe_verify_device_batch
        from repro_torch.core import neardata as nd
        from repro_torch.core.engine import _decode_branches
        from repro_torch.device import resolve_device
        from repro_torch.kernels import ops

        if not entries:
            return []

        store = self.store
        be = store.basket_events
        B_real = len(entries)
        Bn = max(int(pad_B or 0), B_real)
        sizes = [stop - start for (start, stop, *_r) in entries]
        quantum = nd._WINDOW_QUANTUM
        self._pad_E = max(
            self._pad_E, -(-max(sizes) // quantum) * quantum
        )
        pad_E = self._pad_E
        nb = pad_E // be + 2
        backend = self._resolve_backend()
        device = (
            torch.device("cpu") if backend == "host"
            else resolve_device(self.device)
        )

        # initial masks: real events alive, batch/event padding dead —
        # phantom events can never surface in a survivor set
        tr = active()
        with tr.span("batch", kind="pack"):
            init = np.zeros((Bn, pad_E), dtype=bool)
            seg = np.zeros((Bn, pad_E), dtype=np.int32)
            for b, (start, stop, *_r) in enumerate(entries):
                init[b, : stop - start] = True
                grid0 = start - start % be
                ids = (start + np.arange(pad_E, dtype=np.int64) - grid0) // be
                seg[b] = np.clip(ids, 0, nb - 1).astype(np.int32)
            words0 = ops.pack_mask(init).view(np.int32)
        with tr.span("batch", kind="launch"):
            packed = ops.to_device(words0, device)
            seg_ids = ops.to_device(seg, device)
        maybe_verify_device_batch(
            [(s, t) for (s, t, *_r) in entries],
            pad_E, Bn, nb, be, int(packed.shape[1]),
        )

        order = self.order()  # frozen for the batch (any order is
        # bit-identical on survivors; the adaptive re-rank applies
        # between batches, exactly as it applies between windows)
        bsid = self.tracer.begin(
            "device_batch", kind="device_batch",
            windows=B_real, pad_windows=Bn, pad_events=pad_E,
        )

        counts_host = np.array(sizes + [0] * (Bn - B_real), dtype=np.int64)
        basket_bits: np.ndarray | None = None  # (Bn, nb) after a stage
        full_loaded: list[dict] = [{} for _ in entries]
        stage_bytes_total = [0] * B_real
        stages_run = [0] * B_real

        for pos, si in enumerate(order):
            stage = self.cplan.stages[si]
            alive = [b for b in range(B_real) if counts_host[b] > 0]
            for b in range(B_real):
                if counts_host[b] == 0:
                    self.state.skip(si)
            if not alive:
                continue  # whole batch dead: no staging, no dispatch
            for b in alive:
                stages_run[b] += 1
            ssid = self.tracer.begin(
                f"stage[{si}]", kind="cascade_stage", stage=si,
                node=stage_kind(stage), tier=stage.tier, batch=len(alive),
            )

            # -- fetch + decode alive spans (host side, per window) ------
            staged: list[list[tuple[int, int, dict]]] = [
                [] for _ in range(B_real)
            ]
            stage_bytes = [0] * B_real
            K_req = 1
            for b in alive:
                start, stop, head_data, breakdown, stats, ledger = entries[b]
                if not stage.branches:
                    continue  # constant sub-program: zero staging pages
                    # evaluate it exactly (absent-trigger ANY is
                    # constant-False on zeros, as on the host)
                if pos == 0 and head_data is not None:
                    spans = [(start, stop)]
                elif basket_bits is None:
                    spans = [(start, stop)]
                else:
                    spans = self._bits_to_spans(
                        basket_bits[b], start, stop, be
                    )
                for a, z in spans:
                    if pos == 0 and head_data is not None:
                        sdata = head_data
                    else:
                        stage_bytes[b] += account_fetch(
                            store, stage.branches, a, z, ledger, stats,
                            self.coalesce,
                        )
                        sdata = _decode_branches(
                            store, list(stage.branches), a, z, breakdown,
                            FetchStats(), self.coalesce, tracer=self.tracer,
                        )
                    staged[b].append((a - start, z - a, sdata))
                    if z - a == stop - start:
                        full_loaded[b].update(sdata)
                    K_req = max(
                        K_req, nd.window_pad_K(sdata, stage.program, store)
                    )
            K_b = max(self._stage_K.get(si, 1), K_req)
            self._stage_K[si] = K_b

            # warm the step per shape bucket OUTSIDE the stage timers:
            # measured filter time is steady-state dispatch
            T, G = stage.program.n_terms, stage.program.n_groups
            kinds = nd.program_kinds(stage.program, store)
            ops.warm_cascade_stage(
                stage.program, (Bn, T, pad_E, K_b), nb,
                backend=backend, device=device, kinds=kinds,
            )

            # -- stage the windows the stage runs, straight into the
            # (page-locked, on the card) buffer the step uploads: a
            # window's planes are zeroed, then its alive spans filled
            with tr.span("stage", kind="pack"):
                inputs = ops.CascadeInputs((Bn, T, pad_E, K_b), G, alive, device)
                for s, b in enumerate(alive):
                    inputs.planes[s] = 0.0
                    t_s, v_s, w_s = inputs.window(s)
                    for off, n, sdata in staged[b]:
                        nd.build_padded_inputs(
                            sdata, stage.program, store, K=K_b, to_device=False,
                            out=(t_s[:, off : off + n], v_s[:, off : off + n],
                                 w_s[:, off : off + n]),
                            kinds=kinds,
                        )
                slots = None
                if self.tracer.detail:
                    slots = [len(alive) * pad_E * K_b, sum(
                        nd.object_slots(sdata, stage.program, store, n, K_b)
                        for b in alive for _off, n, sdata in staged[b]
                    )]

            t0 = _time.perf_counter()
            packed, summary = ops.cascade_stage_step_staged(
                inputs, packed, seg_ids,
                stage.program, nb, backend=backend, device=device, kinds=kinds,
            )
            basket_bits, counts_new = ops.stage_summary_host(summary)
            elapsed = _time.perf_counter() - t0
            share = elapsed / len(alive)

            batch_in = batch_out = 0
            for b in alive:
                _s, _t, _h, breakdown, _st, _l = entries[b]
                breakdown.filter += share
                alive_in = int(counts_host[b])
                alive_out = int(counts_new[b])
                self.state.observe(si, alive_in, alive_out, stage_bytes[b])
                stage_bytes_total[b] += stage_bytes[b]
                batch_in += alive_in
                batch_out += alive_out
            counts_host = counts_new
            self.tracer.end(
                ssid, alive_in=batch_in, alive_out=batch_out,
                bytes=sum(stage_bytes), **_slot_attrs(slots),
            )

        # the one host round trip for event-level masks: batch boundary
        words = ops.to_host(packed)
        outcomes = []
        with tr.span("batch", kind="unpack"):
            for b, (start, stop, *_r) in enumerate(entries):
                mask = ops.unpack_mask(words[b], pad_E)[: stop - start].copy()
                outcomes.append(
                    WindowOutcome(
                        mask=mask,
                        full_loaded=full_loaded[b],
                        stage_bytes=stage_bytes_total[b],
                        stages_run=stages_run[b],
                    )
                )
        self.tracer.end(bsid, stages=len(order))
        return outcomes

    # -- phase 2 through the same ledger -------------------------------------

    def fetch_full(
        self,
        names,
        start: int,
        stop: int,
        breakdown,
        stats: FetchStats,
        ledger: dict[str, set],
        known: dict | None = None,
    ) -> dict:
        """Full-window columnar data for ``names``, charging only baskets
        the ledger has not seen (phase 2 of a cascaded window: branches a
        stage already moved are not paid again; the decoded-basket LRU
        absorbs the re-decode).  ``known`` supplies branches already
        decoded over the full window (head data, full-window stages)."""
        from repro_torch.core.engine import _decode_branches

        known = known or {}
        need = [n for n in names if n not in known]
        account_fetch(
            self.store, need, start, stop, ledger, stats, self.coalesce
        )
        data = _decode_branches(
            self.store, need, start, stop, breakdown, FetchStats(),
            self.coalesce, preloaded=dict(known), tracer=self.tracer,
        )
        return data


__all__ = [
    "DEFAULT_SELECTIVITY",
    "CascadeExecutor",
    "CascadePlan",
    "CascadeStage",
    "CascadeState",
    "WindowOutcome",
    "account_fetch",
    "build_cascade",
    "estimate_node_selectivity",
    "estimate_plan_bytes",
    "mark_fetched",
    "stage_kind",
]
