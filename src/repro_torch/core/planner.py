"""Two-phase execution planning (paper §3.1–3.2).

Splits the branch universe into:

  * **filter-criteria branches** — read in phase 1 for every event
    (the paper's 27-of-1749 set), staged presel -> object -> event, and
  * **output-only branches** — read in phase 2 only for baskets that
    contain at least one passing event (the paper's 89-branch output set).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.branchmap import expand_branches, with_counts_branches
from repro_torch.core.expr import validate_rpn
from repro_torch.core.query import ExprCut, Query
from repro_torch.core.zonemap import SCAN, WindowDecision, classify_windows


@dataclass
class SkimPlan:
    query: Query
    filter_branches: list[str]
    output_branches: list[str]  # full output set (includes filter branches kept)
    output_only_branches: list[str]  # phase-2 fetch set
    stage_order: list[str] = field(
        default_factory=lambda: ["preselection", "object", "event"]
    )
    excluded_by_optimization: list[str] = field(default_factory=list)
    # flat float32 branches in both the filter and output sets: the fused
    # device path compacts these alongside the survivor indices, so their
    # output columns come straight off the kernel (DESIGN.md §4).
    payload_branches: list[str] = field(default_factory=list)
    # zone-map pruning decisions, one per basket window of the executor's
    # chunking (DESIGN.md §9).  ``None`` when planning ran without
    # pruning; the engine then scans every window (the reference path).
    window_decisions: list[WindowDecision] | None = None
    # cascaded phase-1 physical plan (DESIGN.md §11): the cost-ordered
    # stage IR the cascade executor runs.  ``None`` when planning ran
    # without cascading (or there is nothing to cascade); the engines
    # then preload the full filter set per window (the PR-4 path).
    cascade: object = None  # repro_torch.core.plan.CascadePlan | None
    _program: object = None

    def compiled_program(self):
        """Device predicate program, compiled once per skim (lazy — host-only
        paths never pull in the kernel stack).  A program attached to the
        query's ``meta`` (the cluster coordinator's compile-once fan-out,
        DESIGN.md §5b) short-circuits per-plan compilation."""
        if self._program is None:
            self._program = self.query.meta.get("_compiled_program")
        if self._program is None:
            from repro_torch.kernels.program import compile_query

            self._program = compile_query(self.query)
        return self._program

    def describe(self) -> str:
        """One-line physical-plan summary: branch sets, the zone-map
        window decisions (prune / accept-all / scan counts), and the
        cascade stage order — the three pushdown levers, together."""
        pruned = accept = scan = 0
        for d in self.window_decisions or ():
            pruned += d.decision == "prune"
            accept += d.decision == "accept_all"
            scan += d.decision == "scan"
        windows = (
            f"windows[prune={pruned}, accept_all={accept}, scan={scan}]"
            if self.window_decisions is not None
            else "windows=unpruned"
        )
        cascade = (
            f"cascade[{self.cascade.n_stages} stages: {self.cascade.describe()}]"
            if self.cascade is not None
            else "cascade=off"
        )
        return (
            f"SkimPlan(filter={len(self.filter_branches)} branches, "
            f"output={len(self.output_branches)}, "
            f"phase2={len(self.output_only_branches)}, "
            f"excluded={len(self.excluded_by_optimization)}, "
            f"{windows}, {cascade})"
        )


def _decide_windows(
    query: Query,
    store,
    window_events: int,
    filter_branches: list[str],
    output_branches: list[str],
) -> list[WindowDecision]:
    """Classify every basket window and price what each skip saves.

    PRUNE saves the whole phase-1 filter fetch for the window; ACCEPT_ALL
    saves only the filter branches the output does not keep (the rest
    still moves, just in the phase-2 round).  Pure metadata — nothing is
    fetched or decoded here.
    """
    spans = [
        (s, min(s + window_events, store.n_events))
        for s in range(0, store.n_events, window_events)
    ]
    kinds = classify_windows(query, store, spans)
    out_set = set(output_branches)
    extra_branches = [b for b in filter_branches if b not in out_set]
    decisions = []
    for (a, b), kind in zip(spans, kinds):
        p1_bytes = p1_baskets = extra_bytes = extra_baskets = 0
        if kind == "prune":
            p1_bytes, p1_baskets = store.range_comp_bytes(filter_branches, a, b)
        elif kind == "accept_all":
            extra_bytes, extra_baskets = store.range_comp_bytes(
                extra_branches, a, b
            )
        decisions.append(
            WindowDecision(a, b, kind, p1_bytes, p1_baskets,
                           extra_bytes, extra_baskets)
        )
    return decisions


def plan_skim(
    query: Query,
    store,
    window_events: int | None = None,
    prune: bool = False,
    cascade: bool = False,
) -> SkimPlan:
    available = store.branch_names()

    filter_set = {b for b in query.filter_branches() if b in available}
    missing = query.filter_branches() - filter_set
    # trigger-OR names are optional unless the query is strict: menus
    # differ across data-taking eras, and an absent HLT branch evaluates
    # as constant-False (mirrored by the zone-map AnyOf analysis)
    hard_missing = missing - query.optional_branches()
    # kind mismatches (bare jagged ref, sum() of a flat branch) first:
    # they subsume the missing-counts KeyError with a specific message
    for _, stage in query.stages():
        for node in stage:
            if isinstance(node, ExprCut):
                validate_rpn(node.rpn, store, node.source)
    if hard_missing:
        raise KeyError(
            f"selection references unknown branches: {sorted(hard_missing)}"
        )
    filter_branches = with_counts_branches(sorted(filter_set), store)

    selected, excluded = expand_branches(
        query.branches, available, force_all=query.force_all,
        extra_required=set(filter_branches),
    )
    output_branches = with_counts_branches(selected, store)
    output_only = [b for b in output_branches if b not in set(filter_branches)]

    payload = [
        b
        for b in output_branches
        if b in set(filter_branches)
        and not store.branches[b].jagged
        and store.branches[b].np_dtype() == "float32"
    ]

    decisions = None
    if prune and window_events:
        decisions = _decide_windows(
            query, store, window_events, filter_branches, output_branches
        )
        if all(d.decision == SCAN for d in decisions):
            decisions = None  # nothing provable: identical to no pruning

    cascade_plan = None
    if cascade and filter_branches:
        from repro_torch.core.plan import build_cascade

        cascade_plan = build_cascade(query, store)

    return SkimPlan(
        query=query,
        filter_branches=filter_branches,
        output_branches=output_branches,
        output_only_branches=output_only,
        excluded_by_optimization=excluded,
        payload_branches=payload,
        window_decisions=decisions,
        cascade=cascade_plan,
    )
