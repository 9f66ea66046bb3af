"""Static verifier for compiled skim artifacts (DESIGN.md §15).

The lint half of skimlint proves *source-level* invariants; this module
proves what lints cannot see — properties of the compiled
:class:`~repro_torch.kernels.program.Program` and the lowered
:class:`~repro_torch.core.planner.SkimPlan` that, if violated, break the
repo's signature bit-identity invariant or crash mid-scan after bytes
have already moved:

``verify_program``
    RPN stack-depth balance, term-slot bounds, valid group collection
    wiring, known opcodes — for every compiled Program.
``verify_plan``
    each cascade stage's fetch set covers **exactly** what its
    sub-Program reads (a missed branch is a KeyError after the prefetch
    already chose its load set; an extra branch is silent over-fetch
    that corrupts the byte ledger), the pinned-head invariant the
    double-buffered prefetcher relies on, sane prices, window-decision
    coverage, and the cache-key field coverage below.
``verify_cache_key_coverage``
    every :class:`~repro_torch.core.query.Query` field is accounted for by the
    canonical query form recorded for the current ``CACHE_KEY_VERSION``
    — adding a query field without bumping the version is a *static*
    error here, not a silent stale-cache-hit in production.

Verification is hooked into ``compile_query`` and ``plan_skim`` behind
``REPRO_VERIFY=1`` (on in the test suite's conftest, off in benchmarks;
when off the hook costs one environment lookup).  Every rejection is a
typed :class:`VerifyError` carrying ``invariant``, the machine-readable
name of the broken invariant.
"""

from __future__ import annotations

import dataclasses
import math
import os

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
from repro_torch.core.query import Query
from repro_torch.kernels.program import (
    GROUP_ANY,
    GROUP_COUNT,
    GROUP_DR,
    GROUP_EXPR,
    GROUP_HT,
    GROUP_MASS,
    OP_IDS,
)

_KNOWN_KINDS = frozenset(
    (GROUP_COUNT, GROUP_HT, GROUP_ANY, GROUP_MASS, GROUP_DR, GROUP_EXPR)
)
_KNOWN_OPS = frozenset(OP_IDS.values())
_RPN_PUSH = frozenset((RPN_BRANCH, RPN_SUM, RPN_CONST))
_RPN_UNARY = frozenset((RPN_NEG, RPN_ABS))
_RPN_BINARY = frozenset((RPN_ADD, RPN_SUB, RPN_MUL, RPN_DIV, RPN_MIN, RPN_MAX))

#: the Query dataclass fields accounted for by the canonical query form
#: (cluster/cache.canonical_query) at each CACHE_KEY_VERSION.  `input`,
#: `output`, and `meta` are deliberately excluded from the canonical
#: form (paths and free-form metadata cannot change a result); every
#: other field feeds it.  Adding a Query field requires bumping
#: CACHE_KEY_VERSION in cluster/cache.py AND recording the new field
#: set here — until both happen, verification fails statically.
CANONICAL_QUERY_FIELDS: dict[int, frozenset[str]] = {
    4: frozenset(
        {
            "input", "output", "branches", "force_all", "preselection",
            "object_stage", "event_stage", "strict", "cascade", "meta",
        }
    ),
}


class VerifyError(Exception):
    """A compiled artifact violates a static invariant.

    ``invariant`` is the machine-readable name (e.g.
    ``"rpn-stack-balance"``); the message says what and where.
    """

    def __init__(self, invariant: str, message: str):
        super().__init__(f"[{invariant}] {message}")
        self.invariant = invariant


def verify_enabled() -> bool:
    """True when ``REPRO_VERIFY`` asks for verification (default: off)."""
    return os.environ.get("REPRO_VERIFY", "0").lower() not in ("", "0", "false", "off")


# ---------------------------------------------------------------------------
# Program verification
# ---------------------------------------------------------------------------


def _check_terms(where: str, term_ids, n_terms: int) -> None:
    for t in term_ids:
        if not isinstance(t, int) or not 0 <= t < n_terms:
            raise VerifyError(
                "term-slot-bounds",
                f"{where}: term slot {t!r} outside [0, {n_terms})",
            )


def _check_rpn(where: str, rpn, n_terms: int) -> None:
    """Prove the stack program is balanced and reads only valid slots."""
    if not rpn:
        raise VerifyError("rpn-stack-balance", f"{where}: empty RPN program")
    depth = 0
    for i, (op, arg) in enumerate(rpn):
        if op in (RPN_BRANCH, RPN_SUM):
            _check_terms(f"{where} rpn[{i}]", (arg,), n_terms)
            depth += 1
        elif op == RPN_CONST:
            if not isinstance(arg, (int, float)) or not math.isfinite(float(arg)):
                raise VerifyError(
                    "rpn-constant", f"{where} rpn[{i}]: non-finite constant {arg!r}"
                )
            depth += 1
        elif op in _RPN_UNARY:
            if depth < 1:
                raise VerifyError(
                    "rpn-stack-balance",
                    f"{where} rpn[{i}]: unary op {op} on empty stack",
                )
        elif op in _RPN_BINARY:
            if depth < 2:
                raise VerifyError(
                    "rpn-stack-balance",
                    f"{where} rpn[{i}]: binary op {op} with stack depth {depth}",
                )
            depth -= 1
        else:
            raise VerifyError("rpn-opcode", f"{where} rpn[{i}]: unknown opcode {op!r}")
    if depth != 1:
        raise VerifyError(
            "rpn-stack-balance",
            f"{where}: program leaves stack depth {depth}, want exactly 1",
        )


def verify_program(program) -> None:
    """Prove a compiled :class:`Program`'s structural invariants.

    Raises :class:`VerifyError` naming the broken invariant; returns
    ``None`` on success.  Store-independent (compilation is too).
    """
    n_terms = program.n_terms
    n_groups = program.n_groups
    if len(program.group_collections) != n_groups or len(program.group_weights) != n_groups:
        raise VerifyError(
            "group-wiring",
            f"group_collections/group_weights length != {n_groups} groups",
        )
    colls2 = program.group_collections2
    if colls2 and len(colls2) != n_groups:
        raise VerifyError(
            "group-wiring",
            f"group_collections2 has {len(colls2)} entries for {n_groups} groups",
        )
    for name in program.term_branches:
        if not isinstance(name, str) or not name:
            raise VerifyError("term-branch", f"bad term branch name {name!r}")
    for g, grp in enumerate(program.groups):
        where = f"group[{g}]"
        if grp.kind not in _KNOWN_KINDS:
            raise VerifyError("group-opcode", f"{where}: unknown group kind {grp.kind!r}")
        _check_terms(where, grp.term_ids, n_terms)
        if grp.kind in (GROUP_COUNT, GROUP_HT, GROUP_ANY):
            if len(grp.ops) != len(grp.term_ids) or len(grp.thrs) != len(grp.term_ids):
                raise VerifyError(
                    "group-shape",
                    f"{where}: {len(grp.term_ids)} terms but {len(grp.ops)} ops / "
                    f"{len(grp.thrs)} thresholds",
                )
            for op in grp.ops:
                if op not in _KNOWN_OPS:
                    raise VerifyError("group-opcode", f"{where}: unknown term op {op!r}")
        if grp.kind in (GROUP_HT, GROUP_DR, GROUP_EXPR) and grp.cmp_op not in _KNOWN_OPS:
            raise VerifyError("group-opcode", f"{where}: unknown cmp op {grp.cmp_op!r}")
        if grp.kind == GROUP_COUNT and grp.min_count < 0:
            raise VerifyError("group-shape", f"{where}: negative min_count {grp.min_count}")
        if grp.kind == GROUP_HT:
            if not grp.term_ids:
                raise VerifyError("group-shape", f"{where}: HT group with no terms")
            if program.group_weights[g] is None or program.group_collections[g] is None:
                raise VerifyError(
                    "group-wiring", f"{where}: HT group needs a collection and a weight branch"
                )
        if grp.kind in (GROUP_MASS, GROUP_DR):
            want = 8 if grp.kind == GROUP_MASS else 6
            if len(grp.term_ids) != want:
                raise VerifyError(
                    "group-shape",
                    f"{where}: pair group wants {want} kinematic terms, "
                    f"has {len(grp.term_ids)}",
                )
            coll2 = colls2[g] if g < len(colls2) else None
            if program.group_collections[g] is None or coll2 is None:
                raise VerifyError(
                    "group-wiring", f"{where}: pair group needs both collections wired"
                )
        if grp.kind == GROUP_EXPR:
            _check_rpn(where, grp.rpn, n_terms)


# ---------------------------------------------------------------------------
# Plan verification
# ---------------------------------------------------------------------------


def program_reads(program, store) -> set[str]:
    """Branches a compiled sub-Program reads when evaluated over ``store``.

    Derived from the Program itself (NOT from the query node it was
    lowered from — that independence is what makes the coverage check a
    real cross-check): term branches present in the store, counts
    branches of every wired collection and jagged read, HT weight
    branches, and the counts feeding ``sum()`` RPN slots.
    """
    reads: set[str] = set()
    for name in program.term_branches:
        if name in store.branches:
            reads.add(name)
    colls2 = program.group_collections2
    for g, grp in enumerate(program.groups):
        coll = program.group_collections[g]
        if coll is not None:
            reads.add(f"n{coll}")
        coll2 = colls2[g] if g < len(colls2) else None
        if coll2 is not None:
            reads.add(f"n{coll2}")
        weight = program.group_weights[g]
        if weight is not None:
            reads.add(weight)
        for op, slot in grp.rpn:
            if op == RPN_SUM:
                reads.add(counts_name(program.term_branches[int(slot)]))
    for name in sorted(reads):
        br = store.branches.get(name)
        if br is not None and br.jagged:
            reads.add(br.counts_branch)
    return reads


def _verify_cascade(plan, store) -> None:
    cplan = plan.cascade
    n = cplan.n_stages
    order = list(cplan.static_order)
    if sorted(order) != list(range(n)):
        raise VerifyError(
            "pinned-head",
            f"static_order {order} is not a permutation of 0..{n - 1}",
        )
    for i, stage in enumerate(cplan.stages):
        where = f"stage[{i}]"
        if stage.index != i:
            raise VerifyError("stage-index", f"{where}: index {stage.index} != position {i}")
        if not (0.0 <= stage.est_selectivity <= 1.0) or not math.isfinite(
            stage.est_selectivity
        ):
            raise VerifyError(
                "stage-price",
                f"{where}: est_selectivity {stage.est_selectivity!r} outside [0, 1]",
            )
        if stage.est_bytes < 0:
            raise VerifyError(
                "stage-price", f"{where}: negative est_bytes {stage.est_bytes}"
            )
        if stage.program is None:
            raise VerifyError("stage-program", f"{where}: no compiled sub-Program")
        verify_program(stage.program)
        reads = program_reads(stage.program, store)
        fetch = set(stage.branches)
        missing = reads - fetch
        if missing:
            raise VerifyError(
                "stage-fetch-coverage",
                f"{where}: sub-Program reads {sorted(missing)} but the stage "
                f"fetch set {sorted(fetch)} does not include them — the "
                "cascade would KeyError mid-scan (or silently mis-evaluate)",
            )
        extra = fetch - reads
        if extra:
            raise VerifyError(
                "stage-fetch-coverage",
                f"{where}: fetch set includes {sorted(extra)} the sub-Program "
                "never reads — over-fetch corrupts the byte ledger",
            )
    # after the per-stage checks so a bad price reports as "stage-price",
    # not as the order drift it causes
    expected = sorted(range(n), key=lambda i: (cplan.stages[i].rank, i))
    if order != expected:
        raise VerifyError(
            "pinned-head",
            f"static_order {order} != cost-model order {expected} — the "
            "prefetcher's head load set would differ across pipeline modes",
        )


def verify_plan(plan, store) -> None:
    """Prove a lowered :class:`SkimPlan`'s invariants against its store.

    Raises :class:`VerifyError` naming the broken invariant.  Pure
    metadata — nothing is fetched, decoded, or evaluated.
    """
    available = set(store.branch_names())
    for kind, names in (
        ("filter", plan.filter_branches),
        ("output", plan.output_branches),
        ("phase2", plan.output_only_branches),
    ):
        if len(set(names)) != len(names):
            raise VerifyError("plan-branch-partition", f"duplicate {kind} branches")
        unknown = [b for b in names if b not in available]
        if unknown:
            raise VerifyError(
                "plan-branch-partition",
                f"{kind} set names branches the store lacks: {unknown}",
            )
    want_phase2 = [
        b for b in plan.output_branches if b not in set(plan.filter_branches)
    ]
    if plan.output_only_branches != want_phase2:
        raise VerifyError(
            "plan-branch-partition",
            "output_only_branches is not output minus filter — phase 2 "
            "would re-fetch or drop branches",
        )
    if plan.window_decisions is not None:
        pos = 0
        for i, d in enumerate(plan.window_decisions):
            if d.start != pos or d.stop <= d.start:
                raise VerifyError(
                    "window-decisions",
                    f"decision[{i}] spans [{d.start}, {d.stop}) but the scan "
                    f"cursor is at {pos} — windows must tile the store",
                )
            pos = d.stop
        if pos != store.n_events:
            raise VerifyError(
                "window-decisions",
                f"decisions end at event {pos}, store has {store.n_events}",
            )
    if plan.cascade is not None:
        _verify_cascade(plan, store)
    verify_cache_key_coverage()
    # every AST node in the query must render a canonical node doc — a
    # node type without one cannot be content-addressed
    from repro_torch.cluster.cache import canonical_query

    try:
        canonical_query(plan.query)
    except TypeError as exc:
        raise VerifyError(
            "canonical-node-doc",
            f"query contains a node the canonical form cannot render: {exc}",
        ) from exc


def verify_cache_key_coverage() -> None:
    """Prove the canonical query form accounts for every Query field.

    The recorded field set for the current ``CACHE_KEY_VERSION`` must
    equal ``Query``'s actual dataclass fields: a new field that can
    change results MUST enter ``canonical_query`` with a version bump,
    and even a result-irrelevant field must be recorded as such here.
    """
    from repro_torch.cluster.cache import CACHE_KEY_VERSION

    recorded = CANONICAL_QUERY_FIELDS.get(CACHE_KEY_VERSION)
    if recorded is None:
        raise VerifyError(
            "cache-key-version",
            f"CACHE_KEY_VERSION={CACHE_KEY_VERSION} has no recorded canonical "
            "field set in repro_torch.analysis.verify.CANONICAL_QUERY_FIELDS — "
            "record it alongside the version bump",
        )
    actual = {f.name for f in dataclasses.fields(Query)}
    if actual != recorded:
        added = sorted(actual - recorded)
        removed = sorted(recorded - actual)
        raise VerifyError(
            "cache-key-coverage",
            f"Query fields changed without a cache-key version bump: "
            f"added={added} removed={removed} — update canonical_query, bump "
            "CACHE_KEY_VERSION in cluster/cache.py, and record the new field "
            "set in CANONICAL_QUERY_FIELDS",
        )


def verify_device_batch(
    spans,
    pad_E: int,
    pad_B: int,
    nb: int,
    basket_events: int,
    mask_words: int,
) -> None:
    """Prove one window-batch's tiling invariants (DESIGN.md §16).

    The batched cascade stages windows into a single (B, ..., pad_E, K)
    tensor and carries survivor masks as (B, pad_E/32) uint32 words; a
    pad shape that fails to cover a member window silently truncates its
    tail events, and a basket-axis (``nb``) too small for the window's
    global basket grid folds distinct baskets onto one alive bit —
    phase 2 would then re-fetch (or worse, skip) the wrong baskets.
    """
    if pad_E % 32 != 0:
        raise VerifyError(
            "batch-pad-alignment",
            f"pad_E={pad_E} is not a multiple of 32 — the bit-packed "
            "survivor words cannot tile the event axis",
        )
    if mask_words * 32 != pad_E:
        raise VerifyError(
            "batch-mask-width",
            f"packed mask carries {mask_words} words = {mask_words * 32} "
            f"events but the batch is padded to pad_E={pad_E}",
        )
    if len(spans) > pad_B:
        raise VerifyError(
            "batch-window-overflow",
            f"{len(spans)} member windows exceed the padded batch "
            f"size pad_B={pad_B}",
        )
    for start, stop in spans:
        m = stop - start
        if m > pad_E:
            raise VerifyError(
                "batch-pad-coverage",
                f"window [{start}, {stop}) has {m} events but the batch "
                f"is padded to pad_E={pad_E} — tail events would be "
                "silently truncated",
            )
        grid0 = start - start % basket_events
        last_id = (stop - 1 - grid0) // basket_events
        if last_id >= nb:
            raise VerifyError(
                "batch-basket-coverage",
                f"window [{start}, {stop}) spans basket ordinal "
                f"{last_id} on the global grid but the alive-bit axis "
                f"holds only nb={nb} baskets",
            )


# ---------------------------------------------------------------------------
# env-gated hooks (compile_query / plan_skim call these)
# ---------------------------------------------------------------------------


def maybe_verify_device_batch(
    spans, pad_E, pad_B, nb, basket_events, mask_words
) -> None:
    """``verify_device_batch`` iff ``REPRO_VERIFY`` is on."""
    if verify_enabled():
        verify_device_batch(spans, pad_E, pad_B, nb, basket_events, mask_words)


def maybe_verify_program(program) -> None:
    """``verify_program`` iff ``REPRO_VERIFY`` is on (one env lookup off)."""
    if verify_enabled():
        verify_program(program)


def maybe_verify_plan(plan, store) -> None:
    """``verify_plan`` iff ``REPRO_VERIFY`` is on (one env lookup off)."""
    if verify_enabled():
        verify_plan(plan, store)
