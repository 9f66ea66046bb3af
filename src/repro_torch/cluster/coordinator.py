"""Scatter-gather skim coordinator (DESIGN.md §5b).

One logical dataset, striped over N storage nodes: the coordinator
parses and compiles a query **once**, fans it out to every node (a
serially-deterministic loop or a thread pool), and gathers the per-shard
results back into ONE skim result that is bit-identical to running the
query on the unsharded store — same survivor rows in the same order,
same counts, same output bytes.

The merge works at basket-window granularity.  Every node reports its
per-window survivor ledger (``extras["window_rows"]``, the mergeable
result contract from ``core/engine.py``); the coordinator splits each
shard's concatenated output back into per-window column chunks and
reassembles them in **global window order**, which is exactly the order
the single-node executor produced them in.  Accounting merges with
``FetchStats.merged`` / ``Breakdown.merged`` — for aligned shards the
cluster's fetched bytes and request counts equal the single-node run's.

Failures (DESIGN.md §14): a shard that raises :class:`NodeFailure`,
:class:`~repro_torch.data.store.CorruptBasket`, or blows its deadline is
re-issued under the per-query :class:`~repro_torch.cluster.retry.RetryPolicy`
(replica first, deterministic modeled backoff); stragglers stretch the
modeled makespan unless a :class:`~repro_torch.cluster.retry.HedgePolicy`
hedges them onto the replica — the coordinator takes the faster
*bit-identical* response (mismatch raises :class:`IntegrityError`,
never a silent pick).  ``allow_partial=True`` turns shards that exhaust
their budget into an explicit :class:`DegradedResult` whose error
manifest accounts every missing window; the default refuses.  Repeat
queries: the coordinator consults the content-addressed
:class:`~repro_torch.cluster.cache.SkimResultCache` per (query, shard) before
scattering, so warm shards skip phase 1 (and everything else) entirely.
Before either, zone-map pushdown (DESIGN.md §9): shard-level aggregate
stats that prove a shard empty let the coordinator answer it without
any RPC at all (single-query path; batches rely on the nodes'
window-level pruning).

Time is reported in both currencies (DESIGN.md §2c): modeled cluster
wall-clock = ``max`` over nodes of the node-local modeled pipeline bound
(+ injected straggle) plus the measured merge, next to the realized
wall-clock on this host.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.cluster.cache import SkimResultCache, query_hash, versioned_key
from repro_torch.cluster.node import BatchResponse, NodeFailure, NodeResponse, StorageNode
from repro_torch.cluster.retry import (
    DEFAULT_RETRY_POLICY,
    HedgePolicy,
    RetryEvent,
    RetryPolicy,
    classify_fault,
)
from repro_torch.core.engine import Breakdown, SkimResult, _skipped_requests, drain
from repro_torch.core.planner import plan_skim
from repro_torch.core.query import Query, parse_query
from repro_torch.core.zonemap import PRUNE, classify_span
from repro_torch.data.store import CorruptBasket, EventStore, FetchStats
from repro_torch.obs.schema import SkimReport, make_extras
from repro_torch.obs.trace import NULL_TRACER, Tracer

CONCURRENCY_MODES = ("serial", "threads")

#: exceptions the retry policy covers — one more attempt, not an abort
RETRYABLE = (NodeFailure, CorruptBasket)


class ClusterError(RuntimeError):
    """A shard could not be served within its retry budget."""


class NodeTimeout(ClusterError):
    """A shard blew its per-shard deadline and no retry target could
    cover for it.  Without a deadline a straggling node without a
    replica hangs the whole gather forever — ``shard_timeout_s`` turns
    that into this error (or a replica retry) instead.  In threads mode
    the deadline is wall-clock (``Future.result(timeout=...)``); in
    serial mode it is enforced against the *modeled* clock
    (``NodeResponse.modeled_s``), since a serial in-process gather
    cannot be preempted by wall time.

    Leak semantics (threads mode): the worker thread that timed out is
    deliberately NOT joined — it still holds the hung node's request and
    parks its eventual result (or exception) in an abandoned future.
    The pool is shut down with ``wait=False``, gather threads are named
    ``skim-gather-*`` so leaked workers are identifiable in thread
    dumps, and a fresh pool per gather means a subsequent query on the
    same coordinator is unaffected (pinned by tests/test_faults.py)."""


class IntegrityError(RuntimeError):
    """Two executions of the same shard disagreed bit-for-bit.

    Raised when a hedged replica response does not match the primary's
    (output manifest hash, survivor counts, or window ledger) — the one
    fault the coordinator must never paper over, because picking either
    side silently would be exactly the corruption this layer exists to
    prevent.  Deliberately NOT a :class:`ClusterError`: ``allow_partial``
    degrades budget-exhausted shards, never integrity violations."""


@dataclass
class ClusterSkimResult:
    """Merged scatter-gather result; the cluster-level ``SkimResult``."""

    output: EventStore
    n_input: int
    n_passed: int
    breakdown: Breakdown  # cluster-wide work: sum over shards
    stats: FetchStats  # cluster-wide bytes/requests: sum over shards
    responses: list[NodeResponse]  # per shard, shard order
    retries: list[tuple[int, int, int]]  # (shard_id, failed_node, used_node)
    modeled_total_s: float  # max-over-nodes pipeline bound + merge
    merge_s: float
    wall_s: float
    extras: dict = field(default_factory=dict)

    @property
    def selectivity(self) -> float:
        return self.n_passed / max(self.n_input, 1)

    @property
    def cache_hits(self) -> int:
        return sum(1 for r in self.responses if r.cached)

    @property
    def pruned_shards(self) -> list[int]:
        """Shards answered from zone-map stats without any RPC."""
        return [r.shard_id for r in self.responses if r.pruned]

    @property
    def degraded(self) -> bool:
        return False


@dataclass(frozen=True)
class ShardError:
    """One shard's terminal failure inside a degraded gather: which
    windows are missing and why (DESIGN.md §14)."""

    shard_id: int
    node_id: int
    kind: str  # "fail" | "timeout" | "corrupt"
    message: str
    window_ids: list[int]
    # global event spans of the missing windows, [start, stop)
    spans: list[tuple[int, int]]

    @property
    def missing_events(self) -> int:
        return sum(b - a for a, b in self.spans)


@dataclass
class DegradedResult(ClusterSkimResult):
    """A partial cluster result: every surviving window bit-identical to
    the reference, every missing window explicitly accounted.

    Only produced under ``allow_partial=True`` after a shard exhausts
    its retry budget; ``errors`` is the per-shard error manifest.  A
    degraded result is **never cached** — the per-shard result cache
    only ever stores complete shard responses, and the merged object
    carries no cache entry of its own.
    """

    errors: list[ShardError] = field(default_factory=list)

    @property
    def degraded(self) -> bool:
        return True

    @property
    def missing_windows(self) -> list[int]:
        return sorted(w for e in self.errors for w in e.window_ids)


@dataclass
class _Gather:
    """Per-gather fault ledger (one per ``iter_run`` invocation; list
    appends are atomic under the GIL, so the threads gather shares it
    without a lock)."""

    retries: list[tuple[int, int, int]] = field(default_factory=list)
    events: list[RetryEvent] = field(default_factory=list)
    hedges: list[tuple[int, str]] = field(default_factory=list)  # (shard, outcome)
    samples: list[float] = field(default_factory=list)  # modeled_s, hedge input
    errors: list[ShardError] = field(default_factory=list)
    corrupts: list[int] = field(default_factory=list)  # shard per CorruptBasket

    @property
    def backoff_s(self) -> float:
        return sum(e.backoff_s for e in self.events)

    def hedge_count(self, outcome: str) -> int:
        return sum(1 for _, o in self.hedges if o == outcome)


@dataclass
class ClusterBatchResult:
    """Scatter-gather over a shared-scan tenant batch."""

    results: list[ClusterSkimResult]  # per tenant, request order
    shared_phase1_bytes: int  # sum of the nodes' shared passes
    naive_phase1_bytes: int  # N independent cluster scans
    modeled_total_s: float
    wall_s: float
    cached_tenants: list[int] = field(default_factory=list)

    @property
    def amortization(self) -> float:
        return self.naive_phase1_bytes / max(self.shared_phase1_bytes, 1)


# ---------------------------------------------------------------------------
# per-window split + global-order merge
# ---------------------------------------------------------------------------


def _split_windows(response: NodeResponse) -> dict[int, dict[str, np.ndarray]]:
    """Split a shard's concatenated output into per-GLOBAL-window chunks.

    The i-th entry of the node's window ledger corresponds to the i-th
    ascending global window this shard owns (window-aligned shards keep
    local and global window order identical).
    """
    result = response.result
    rows = result.extras.get("window_rows")
    if rows is None:
        raise ValueError(
            "node result lacks extras['window_rows'] — not a mergeable result"
        )
    if len(rows) != len(response.window_ids):
        raise ValueError(
            f"shard {response.shard_id}: ledger has {len(rows)} windows, "
            f"shard owns {len(response.window_ids)}"
        )
    out_store = response.result.output
    ks = np.array([k for _, _, k in rows], dtype=np.int64)
    bounds = np.concatenate([[0], np.cumsum(ks)])
    chunks: dict[int, dict[str, np.ndarray]] = {
        w: {} for w in response.window_ids
    }
    flat_cache: dict[str, np.ndarray] = {}
    for name, br in out_store.branches.items():
        if br.jagged:
            continue
        arr = out_store.read_flat(name)
        flat_cache[name] = arr
        for i, w in enumerate(response.window_ids):
            chunks[w][name] = arr[bounds[i] : bounds[i + 1]]
    for name, br in out_store.branches.items():
        if not br.jagged:
            continue
        values = out_store.read_jagged(name)[0]
        counts = flat_cache[br.counts_branch].astype(np.int64)
        voffsets = np.concatenate([[0], np.cumsum(counts)])
        for i, w in enumerate(response.window_ids):
            chunks[w][name] = values[
                voffsets[bounds[i]] : voffsets[bounds[i + 1]]
            ]
    return chunks


def merge_responses(
    responses: list[NodeResponse],
    basket_events: int,
    codec: str,
) -> tuple[EventStore, int, int]:
    """Reassemble shard outputs in global window order.

    Returns ``(output_store, n_input, n_passed)``.  The concatenation
    order — per branch, per global window, survivors in window order —
    is exactly the single-node executor's, and the store is rebuilt with
    the same basketing and codec, so rows, counts, and output bytes are
    bit-identical to the unsharded run.
    """
    template = max(
        (r for r in responses if r.result.output.branches),
        key=lambda r: r.result.output.n_events,
        default=None,
    )
    if template is None:
        raise ValueError("no shard produced an output schema")
    out_branches = template.result.output.branches
    jagged = {
        n: b.counts_branch for n, b in out_branches.items() if b.jagged
    }

    per_window: dict[int, dict[str, np.ndarray]] = {}
    for r in responses:
        per_window.update(_split_windows(r))

    order = sorted(per_window)
    columns: dict[str, np.ndarray] = {}
    for name, br in out_branches.items():
        parts = [per_window[w][name] for w in order if name in per_window[w]]
        columns[name] = (
            np.concatenate(parts)
            if parts
            else np.empty(0, dtype=br.np_dtype())
        )
    # the merged output decodes where the shards' outputs do
    merged = EventStore.from_arrays(
        columns, jagged=jagged, basket_events=basket_events, codec=codec,
        device=template.result.output.device,
    )
    n_input = sum(r.result.n_input for r in responses)
    n_passed = sum(r.result.n_passed for r in responses)
    return merged, n_input, n_passed


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------


class ClusterCoordinator:
    """Scatter a query to N storage nodes, gather one merged result.

    ``replicas`` maps shard_id -> a standby :class:`StorageNode` holding
    the same shard; a primary that raises a retryable fault is re-issued
    there under ``retry_policy`` (default: the historical one-replica
    retry).  ``hedge`` (optional :class:`HedgePolicy`) re-issues shards
    whose modeled time sits in the straggler tail.  ``cache`` (optional)
    is consulted per (query, shard manifest) before any node executes.
    ``metrics`` (optional :class:`~repro_torch.obs.metrics.MetricsRegistry`)
    counts retries, hedges, and quarantined baskets.
    ``allow_partial`` sets the default degradation stance for
    :meth:`run` / :meth:`iter_run` (refused unless enabled).
    """

    def __init__(
        self,
        nodes: list[StorageNode],
        replicas: dict[int, StorageNode] | None = None,
        cache: SkimResultCache | None = None,
        concurrency: str = "serial",
        basket_events: int | None = None,
        codec: str | None = None,
        prune: bool = True,
        shard_timeout_s: float | None = None,
        retry_policy: RetryPolicy = DEFAULT_RETRY_POLICY,
        hedge: HedgePolicy | None = None,
        metrics=None,
        allow_partial: bool = False,
    ):
        if not nodes:
            raise ValueError("need at least one storage node")
        if concurrency not in CONCURRENCY_MODES:
            raise ValueError(
                f"concurrency must be one of {CONCURRENCY_MODES}, "
                f"got {concurrency!r}"
            )
        self.nodes = list(nodes)
        self.replicas = dict(replicas or {})
        self.cache = cache
        self.concurrency = concurrency
        # consult shard-level aggregate zone-map stats before any RPC
        # (DESIGN.md §9): a shard whose manifest proves zero survivors is
        # answered by the coordinator itself — no node, no cache traffic.
        self.prune = prune
        if shard_timeout_s is not None and shard_timeout_s <= 0:
            raise ValueError("shard_timeout_s must be positive (or None)")
        # per-shard deadline: wall-clock in threads mode, modeled in
        # serial mode; None = wait forever
        self.shard_timeout_s = shard_timeout_s
        self.retry_policy = retry_policy
        self.hedge = hedge
        self.metrics = metrics
        self.allow_partial = allow_partial
        ref = nodes[0].shard.store
        self.basket_events = basket_events or ref.basket_events
        self.codec = codec or ref.codec
        self.total_events = sum(n.shard.n_events for n in self.nodes)

    # -- single query ---------------------------------------------------------

    def _compile_once(self, query: Query | dict | str) -> tuple[Query, str]:
        """Parse + compile the query once for the whole fan-out.

        Works on a private copy of a caller-supplied ``Query`` so the
        attached program can never go stale if the caller mutates and
        reuses their object elsewhere."""
        if isinstance(query, Query):
            q = replace(query, meta=dict(query.meta))
        else:
            q = parse_query(query)
        qh = query_hash(q)
        from repro_torch.kernels.program import compile_query

        # every node's planner picks this up instead of recompiling
        # (SkimPlan.compiled_program checks the query's meta)
        q.meta["_compiled_program"] = compile_query(q)
        return q, qh

    @staticmethod
    def _hit_response(hit: NodeResponse, node: StorageNode) -> NodeResponse:
        """Rebind a cached response to the serving node.  A hit pays only
        output transfer; everything else (phase 1, decode, filter,
        phase 2, write) is skipped."""
        return replace(
            hit,
            node_id=node.node_id,
            shard_id=node.shard.shard_id,
            window_ids=list(node.shard.window_ids),
            modeled_s=hit.result.breakdown.output_transfer,
            straggle_s=0.0,
            wall_s=0.0,
            cached=True,
            trace=None,  # a replay has no execution of its own to trace
        )

    def _pruned_response(self, node: StorageNode, query: Query) -> NodeResponse | None:
        """Answer a shard from its manifest alone, or ``None``.

        Consults the shard-level aggregate zone-map stats
        (:meth:`Shard.zone_stats` via :func:`classify_span` over the whole
        shard): when they prove no event of the shard can survive, the
        coordinator synthesizes the node's answer — an empty output with
        the full per-window ledger, exactly what the node's executor
        would have produced (zero survivors emit no jagged map, matching
        the engine's empty-output convention) — and the StorageNode is
        never contacted.  Shards the aggregate cannot prove still get
        window-level pruning inside the node's engine.
        """
        shard = node.shard
        st = shard.store
        if st.n_events == 0:
            return None  # empty shards execute trivially; keep one path
        if classify_span(query, st, 0, st.n_events) != PRUNE:
            return None
        # the aggregate interval proved the shard; every window prunes a
        # fortiori (window stats are subsets of the shard hull), so price
        # the skip per window directly — no re-classification needed, and
        # the per-window request model matches what the node's executor
        # would have ledgered
        plan = plan_skim(query, st)
        spans = [
            (s, min(s + shard.window_events, st.n_events))
            for s in range(0, st.n_events, shard.window_events)
        ]
        stats = FetchStats()
        for a, bnd in spans:
            nbytes, nb = st.range_comp_bytes(plan.filter_branches, a, bnd)
            stats.skip(nbytes, _skipped_requests(nbytes, nb, True))
        cols = {
            name: np.empty(0, dtype=st.branches[name].np_dtype())
            for name in plan.output_branches
        }
        out = EventStore.from_arrays(
            cols, jagged={}, basket_events=st.basket_events, codec=st.codec,
            device=st.device,
        )
        report = SkimReport(
            mode="near_data",
            fused=False,
            pipelined=False,
            prune=True,
            output_bytes=out.compressed_bytes(),
            window_rows=[(a, b, 0) for a, b in spans],
            pruned_windows=[(a, b, PRUNE) for a, b in spans],
            shard_pruned=True,
        )
        result = SkimResult(
            mode="near_data",
            output=out,
            n_input=st.n_events,
            n_passed=0,
            breakdown=Breakdown(),
            stats=stats,
            plan=plan,
            busy_fraction=0.0,
            extras=report.legacy_extras(),
            report=report,
        )
        return NodeResponse(
            node_id=node.node_id,
            shard_id=shard.shard_id,
            window_ids=list(shard.window_ids),
            result=result,
            modeled_s=0.0,
            straggle_s=0.0,
            wall_s=0.0,
            pruned=True,
        )

    @staticmethod
    def _node_tracer(tracer, node: StorageNode):
        """A fresh node-local tracer per execution attempt (same clock and
        host-detail setting as the coordinator's) — its spans ride back on
        the response for :meth:`Tracer.adopt`.  ``None`` when tracing is
        off keeps the node on the NULL_TRACER fast path."""
        if tracer is None or not tracer.enabled:
            return None
        return Tracer(clock=tracer.clock, name=f"node-{node.node_id}",
                      detail=getattr(tracer, "detail", False))

    def _execute_node(self, node: StorageNode, query: Query, tracer=None):
        """One execution attempt on one node.  The tracer kwarg is passed
        only when tracing — fault-injection tests stub ``execute`` with
        plain callables."""
        ntr = self._node_tracer(tracer, node)
        return (
            node.execute(query, tracer=ntr)
            if ntr is not None
            else node.execute(query)
        )

    def _inc(self, name: str, **labels) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, **labels)

    @staticmethod
    def _responses_identical(a: NodeResponse, b: NodeResponse) -> bool:
        """Bit-identity of two executions of the same shard: survivor
        counts, the per-window ledger, and the content address of the
        output baskets (manifest hash covers every blob digest)."""
        ra, rb = a.result, b.result
        return (
            ra.n_passed == rb.n_passed
            and ra.n_input == rb.n_input
            and list(ra.extras.get("window_rows", []))
            == list(rb.extras.get("window_rows", []))
            and ra.output.manifest_hash() == rb.output.manifest_hash()
        )

    def _terminal_error(
        self, node: StorageNode, kind: str, attempts: int
    ) -> ClusterError:
        sid = node.shard.shard_id
        verb = "returned corrupt data" if kind == "corrupt" else "failed"
        if attempts == 0:
            exc = ClusterError(
                f"shard {sid}: primary node {node.node_id} {verb} "
                "and no replica is configured"
            )
        else:
            exc = ClusterError(
                f"shard {sid}: primary and replica both failed "
                f"(retry budget {self.retry_policy.budget} exhausted, "
                f"last fault: {kind})"
            )
        exc.kind = kind
        return exc

    def _maybe_hedge(
        self,
        node: StorageNode,
        resp: NodeResponse,
        query: Query,
        g: _Gather,
        tracer=None,
    ) -> NodeResponse:
        """Hedge a modeled straggler onto its replica (DESIGN.md §14).

        Operates on the modeled clock: when the completed response's
        modeled time exceeds the hedge delay (fixed or quantile of the
        gather's completed shards), the shard is re-issued to the
        replica and the faster of the two modeled finishes wins —
        primary at ``modeled_s``, replica at ``delay + modeled_s`` —
        after the two responses are proven bit-identical
        (:class:`IntegrityError` otherwise, never a silent pick)."""
        if self.hedge is None or resp.cached or resp.pruned:
            return resp
        replica = self.replicas.get(node.shard.shard_id)
        if replica is None or resp.node_id == replica.node_id:
            return resp
        delay = self.hedge.delay(list(g.samples))
        if resp.modeled_s <= delay:
            return resp
        sid = node.shard.shard_id
        try:
            hresp = self._execute_node(replica, query, tracer=tracer)
        except RETRYABLE:
            # the hedge itself faulted: keep the primary's response
            g.hedges.append((sid, "cancelled"))
            self._inc("cluster_hedges_total", outcome="cancelled")
            return resp
        if not self._responses_identical(resp, hresp):
            raise IntegrityError(
                f"shard {sid}: hedged replica {replica.node_id} disagrees "
                f"with node {resp.node_id} bit-for-bit — refusing to pick"
            )
        # the guard keeps the race deterministic: modeled times carry
        # measured components that jitter run-to-run, and switching
        # between bit-identical responses on sub-jitter margins would
        # make the ledger (and modeled_total_s) nondeterministic
        effective = delay + hresp.modeled_s
        if effective < resp.modeled_s * (1.0 - self.hedge.jitter_guard):
            g.hedges.append((sid, "won"))
            self._inc("cluster_hedges_total", outcome="won")
            return replace(hresp, modeled_s=effective)
        g.hedges.append((sid, "lost"))
        self._inc("cluster_hedges_total", outcome="lost")
        return resp

    def _serve_shard(
        self,
        node: StorageNode,
        query: Query,
        qh: str,
        g: _Gather,
        tracer=None,
    ) -> NodeResponse:
        """Prune consult -> cache consult -> primary -> retry loop under
        the :class:`RetryPolicy` -> hedge consult."""
        if self.prune:
            pruned = self._pruned_response(node, query)
            if pruned is not None:
                return pruned
        key = versioned_key(qh, node.shard.manifest_hash)
        if self.cache is not None:
            hit = self.cache.get(key)
            if hit is not None:
                return self._hit_response(hit, node)
        policy = self.retry_policy
        replica = self.replicas.get(node.shard.shard_id)
        targets = policy.targets(node, replica)
        sid = node.shard.shard_id
        current = node
        attempt = 0
        backoff_total = 0.0
        while True:
            try:
                resp = self._execute_node(current, query, tracer=tracer)
                break
            except RETRYABLE as exc:
                kind = classify_fault(exc)
                if kind == "corrupt":
                    g.corrupts.append(sid)
                    self._inc("cluster_corrupt_baskets_total")
                if attempt >= len(targets):
                    raise self._terminal_error(node, kind, attempt) from exc
                nxt = targets[attempt]
                attempt += 1
                backoff = policy.backoff_s(attempt, sid)
                backoff_total += backoff
                g.events.append(
                    RetryEvent(
                        sid, attempt, kind,
                        current.node_id, nxt.node_id, backoff,
                    )
                )
                g.retries.append((sid, current.node_id, nxt.node_id))
                self._inc("cluster_retries_total", error=kind)
                current = nxt
        if backoff_total:
            # backoff is modeled, never slept: it stretches the shard's
            # modeled time (and therefore the cluster makespan) exactly
            resp = replace(resp, modeled_s=resp.modeled_s + backoff_total)
        resp = self._maybe_hedge(node, resp, query, g, tracer=tracer)
        if not (resp.cached or resp.pruned):
            g.samples.append(resp.modeled_s)
        if self.cache is not None:
            # strip the span list: a future replay of this entry must not
            # re-adopt this execution's spans into an unrelated tree
            self.cache.put(
                key,
                replace(resp, trace=None),
                nbytes=resp.result.extras.get(
                    "output_bytes", resp.result.output.compressed_bytes()
                ),
                fetch_bytes=resp.result.stats.bytes_fetched,
            )
        return resp

    def _timeout_fallback(
        self,
        node: StorageNode,
        query: Query,
        qh: str,
        g: _Gather,
        tracer=None,
        modeled: bool = False,
    ) -> NodeResponse:
        """A primary blew the shard deadline (wall-clock in threads mode,
        modeled in serial mode): re-issue under the retry policy, or
        raise :class:`NodeTimeout`.  Retries run on the gather thread —
        a second wall deadline would need its own pool — and a fallback
        that is *itself* over the modeled deadline still times out."""
        sid = node.shard.shard_id
        replica = self.replicas.get(sid)
        targets = self.retry_policy.targets(node, replica)
        if not targets:
            raise NodeTimeout(
                f"shard {sid}: node {node.node_id} "
                f"exceeded the {self.shard_timeout_s}s shard deadline "
                "and no replica is configured"
            )
        policy = self.retry_policy
        failed = node
        resp = None
        last: Exception | None = None
        backoff_total = 0.0
        for attempt, nxt in enumerate(targets, start=1):
            backoff = policy.backoff_s(attempt, sid)
            backoff_total += backoff
            g.events.append(
                RetryEvent(
                    sid, attempt, "timeout" if attempt == 1 else
                    classify_fault(last), failed.node_id, nxt.node_id,
                    backoff,
                )
            )
            g.retries.append((sid, failed.node_id, nxt.node_id))
            self._inc("cluster_retries_total", error="timeout")
            try:
                resp = self._execute_node(nxt, query, tracer=tracer)
                break
            except RETRYABLE as exc:
                if classify_fault(exc) == "corrupt":
                    g.corrupts.append(sid)
                    self._inc("cluster_corrupt_baskets_total")
                last = exc
                failed = nxt
        if resp is None:
            exc = NodeTimeout(
                f"shard {sid}: node {node.node_id} "
                f"exceeded the {self.shard_timeout_s}s shard deadline "
                "and the replica failed"
            )
            exc.kind = "timeout"
            raise exc from last
        resp = replace(resp, modeled_s=resp.modeled_s + backoff_total)
        if modeled and self._deadline_blown(resp):
            exc = NodeTimeout(
                f"shard {sid}: retry target node {resp.node_id} also "
                f"exceeded the {self.shard_timeout_s}s modeled shard "
                "deadline"
            )
            exc.kind = "timeout"
            raise exc
        if self.cache is not None:
            self.cache.put(
                versioned_key(qh, node.shard.manifest_hash),
                replace(resp, trace=None),
                nbytes=resp.result.extras.get(
                    "output_bytes", resp.result.output.compressed_bytes()
                ),
                fetch_bytes=resp.result.stats.bytes_fetched,
            )
        return resp

    def _deadline_blown(self, resp: NodeResponse) -> bool:
        """Modeled-clock deadline check — serial mode only.  Threads
        mode keeps the deadline in the wall currency (the two are not
        comparable: a modeled straggler resolves instantly on this
        host, and a wall hang has no modeled time at all)."""
        return (
            self.shard_timeout_s is not None
            and not resp.cached
            and not resp.pruned
            and resp.modeled_s > self.shard_timeout_s
        )

    def _shard_error(self, node: StorageNode, exc: Exception) -> ShardError:
        """Fold one terminal shard failure into the degradation
        manifest: every window the shard owned, with its global event
        span, is explicitly missing."""
        kind = getattr(exc, "kind", None) or (
            "timeout" if isinstance(exc, NodeTimeout) else "fail"
        )
        we = node.shard.window_events
        spans = [
            (w * we, min(w * we + we, self.total_events))
            for w in node.shard.window_ids
        ]
        self._inc("cluster_degraded_shards_total", error=kind)
        return ShardError(
            shard_id=node.shard.shard_id,
            node_id=node.node_id,
            kind=kind,
            message=str(exc),
            window_ids=list(node.shard.window_ids),
            spans=spans,
        )

    def _gather_serial(
        self, query: Query, qh: str, g: _Gather, tracer, allow_partial: bool
    ):
        """Serially-deterministic gather.  ``shard_timeout_s`` is
        enforced against the modeled clock (a serial in-process loop has
        no wall-clock preemption point) — a shard whose modeled time
        exceeds the deadline is re-issued exactly like a threads-mode
        wall timeout."""
        for node in self.nodes:
            try:
                resp = self._serve_shard(node, query, qh, g, tracer=tracer)
                if self._deadline_blown(resp):
                    resp = self._timeout_fallback(
                        node, query, qh, g, tracer=tracer, modeled=True
                    )
            except ClusterError as exc:
                if not allow_partial:
                    raise
                g.errors.append(self._shard_error(node, exc))
                continue
            yield resp

    def _gather_threads(
        self, query: Query, qh: str, g: _Gather, tracer, allow_partial: bool
    ):
        """Scatter to the pool, yield responses in shard order as they
        resolve, each bounded by ``shard_timeout_s``.  With a deadline
        configured the pool is NOT joined on exit — a hung worker must
        not block the gather that just timed it out (see
        :class:`NodeTimeout` for the leak semantics); gather threads are
        named ``skim-gather-*`` so a leaked one is identifiable."""
        ex = ThreadPoolExecutor(
            max_workers=len(self.nodes), thread_name_prefix="skim-gather"
        )
        try:
            futs = [
                ex.submit(self._serve_shard, node, query, qh, g, tracer)
                for node in self.nodes
            ]
            for node, fut in zip(self.nodes, futs):
                try:
                    try:
                        resp = fut.result(timeout=self.shard_timeout_s)
                    except FutureTimeout:
                        resp = self._timeout_fallback(
                            node, query, qh, g, tracer=tracer
                        )
                except ClusterError as exc:
                    if not allow_partial:
                        raise
                    g.errors.append(self._shard_error(node, exc))
                    continue
                yield resp
        finally:
            ex.shutdown(
                wait=self.shard_timeout_s is None, cancel_futures=True
            )

    def run(
        self,
        query: Query | dict | str,
        tracer=None,
        allow_partial: bool | None = None,
    ) -> ClusterSkimResult:
        return drain(
            self.iter_run(query, tracer=tracer, allow_partial=allow_partial)
        )

    def iter_run(
        self,
        query: Query | dict | str,
        tracer=None,
        allow_partial: bool | None = None,
    ):
        """Streaming form of :meth:`run`: a generator yielding each
        shard's :class:`NodeResponse` (with its per-window survivor
        ledger) as the gather progresses, in shard order, and returning
        the merged :class:`ClusterSkimResult` as the generator's value
        (``drain()`` recovers it).  Closing the generator between
        shards abandons the remaining gather — the service layer's
        cancellation point.

        ``allow_partial`` (default: the coordinator's stance) degrades
        shards that exhaust their retry budget into a
        :class:`DegradedResult` instead of raising — unless *every*
        shard failed, which always raises.  :class:`IntegrityError`
        always propagates regardless.

        ``tracer`` records the cluster span tree: a ``cluster_query``
        root, the one-shot plan/compile, and — under the ``merge``
        umbrella — one ``shard`` span per response with the node's own
        spans adopted beneath it (exactly once; cached and pruned
        responses have none), plus one ``retry`` / ``hedge`` span per
        fault-layer event."""
        if allow_partial is None:
            allow_partial = self.allow_partial
        tr = tracer if tracer is not None else NULL_TRACER
        t0 = time.perf_counter()
        qsid = tr.begin(
            "cluster_query",
            kind="query",
            n_nodes=len(self.nodes),
            concurrency=self.concurrency,
        )
        plan_t0 = tr.now()
        q, qh = self._compile_once(query)
        tr.add_span(
            "plan", kind="plan", t0=plan_t0, t1=tr.now(),
            parent=qsid, query_hash=qh,
        )
        g = _Gather()

        if self.concurrency == "threads":
            gather = self._gather_threads(q, qh, g, tracer, allow_partial)
        else:
            gather = self._gather_serial(q, qh, g, tracer, allow_partial)
        # the merge span is the umbrella for the whole gather: every
        # shard span (and the node spans adopted under it) re-parents
        # here, so the export shows scatter + reassembly as one phase
        msid = tr.begin("merge", kind="merge")
        responses: list[NodeResponse] = []
        for resp in gather:
            ssid = tr.begin(
                f"shard[{resp.shard_id}]",
                kind="shard",
                shard=resp.shard_id,
                node=resp.node_id,
                cached=resp.cached,
                pruned=resp.pruned,
            )
            if resp.trace:
                tr.adopt(resp.trace, parent=ssid)
            tr.end(ssid, n_passed=resp.result.n_passed)
            responses.append(resp)
            try:
                yield resp
            except GeneratorExit:
                tr.end(msid, cancelled=True)
                tr.end(qsid, cancelled=True)
                raise
        for ev in g.events:
            tr.add_span(
                f"retry[shard {ev.shard_id}]", kind="retry",
                t0=tr.now(), t1=tr.now(), parent=msid,
                shard=ev.shard_id, attempt=ev.attempt, error=ev.error,
                failed_node=ev.failed_node, next_node=ev.next_node,
                backoff_s=ev.backoff_s,
            )
        for sid, outcome in g.hedges:
            tr.add_span(
                f"hedge[shard {sid}]", kind="hedge",
                t0=tr.now(), t1=tr.now(), parent=msid,
                shard=sid, outcome=outcome,
            )
        if not responses:
            tr.end(msid, failed=True)
            tr.end(qsid, failed=True)
            errs = "; ".join(e.message for e in g.errors) or "no shards"
            raise ClusterError(f"every shard failed: {errs}")

        t_merge = time.perf_counter()
        output, n_input, n_passed = merge_responses(
            responses, self.basket_events, self.codec
        )
        merge_s = time.perf_counter() - t_merge
        tr.end(msid, merge_s=merge_s)

        breakdown = Breakdown.merged([r.result.breakdown for r in responses])
        stats = FetchStats.merged([r.result.stats for r in responses])
        slowest = max((r.modeled_s for r in responses), default=0.0)
        tr.end(qsid, n_passed=n_passed, bytes=stats.bytes_fetched)
        extras = make_extras(
            output_bytes=output.compressed_bytes(),
            n_nodes=len(self.nodes),
            concurrency=self.concurrency,
            query_hash=qh,
            pruned_shards=[r.shard_id for r in responses if r.pruned],
            prune_saved_bytes=stats.bytes_skipped,
            retry_attempts=len(g.events),
            retry_backoff_s=g.backoff_s,
            corrupt_baskets=len(g.corrupts),
        )
        if self.hedge is not None:
            extras.update(
                make_extras(
                    hedges_won=g.hedge_count("won"),
                    hedges_lost=g.hedge_count("lost"),
                    hedges_cancelled=g.hedge_count("cancelled"),
                )
            )
        common = dict(
            output=output,
            n_input=n_input,
            n_passed=n_passed,
            breakdown=breakdown,
            stats=stats,
            responses=responses,
            retries=g.retries,
            modeled_total_s=slowest + merge_s,
            merge_s=merge_s,
            wall_s=time.perf_counter() - t0,
            extras=extras,
        )
        if g.errors:
            result = DegradedResult(**common, errors=list(g.errors))
            extras.update(
                make_extras(
                    degraded=True,
                    missing_windows=result.missing_windows,
                )
            )
            return result
        return ClusterSkimResult(**common)

    # -- tenant batches (shared scan per node) --------------------------------

    def run_batch(
        self, queries: list[Query | dict | str]
    ) -> ClusterBatchResult:
        """Scatter a tenant batch: each node runs ONE shared scan for all
        non-cached tenants; per-tenant results merge exactly like single
        queries.  A tenant is served from cache only when *every* shard
        hits (partial hits re-run with the batch — the shared pass is one
        fetch either way)."""
        t0 = time.perf_counter()
        compiled = [self._compile_once(qdoc) for qdoc in queries]

        cached_responses: dict[int, list[NodeResponse]] = {}
        if self.cache is not None:
            for ti, (_q, qh) in enumerate(compiled):
                keys = [
                    versioned_key(qh, node.shard.manifest_hash)
                    for node in self.nodes
                ]
                hits = self.cache.get_many(keys)  # atomic all-or-nothing
                if hits is not None:
                    cached_responses[ti] = [
                        self._hit_response(hit, node)
                        for hit, node in zip(hits, self.nodes)
                    ]
        live = [ti for ti in range(len(compiled)) if ti not in cached_responses]

        batch_responses: list[BatchResponse] = []
        retries: list[tuple[int, int, int]] = []
        if live:
            live_queries = [compiled[ti][0] for ti in live]

            def scan(node: StorageNode) -> BatchResponse:
                """Shared scan under the same retry policy as single
                queries: re-issue on any RETRYABLE fault, walking the
                policy's target list."""
                sid = node.shard.shard_id
                replica = self.replicas.get(sid)
                targets = self.retry_policy.targets(node, replica)
                current, attempt = node, 0
                while True:
                    try:
                        return current.execute_batch(live_queries)
                    except RETRYABLE as exc:
                        kind = classify_fault(exc)
                        if attempt >= len(targets):
                            if attempt == 0:
                                raise ClusterError(
                                    f"shard {sid}: primary failed "
                                    "and no replica is configured"
                                ) from exc
                            raise ClusterError(
                                f"shard {sid}: primary and "
                                "replica both failed"
                            ) from exc
                        nxt = targets[attempt]
                        attempt += 1
                        retries.append((sid, current.node_id, nxt.node_id))
                        self._inc("cluster_retries_total", error=kind)
                        current = nxt

            if self.concurrency == "threads":
                with ThreadPoolExecutor(
                    max_workers=len(self.nodes), thread_name_prefix="skim-batch"
                ) as ex:
                    batch_responses = list(ex.map(scan, self.nodes))
            else:
                batch_responses = [scan(node) for node in self.nodes]

            if self.cache is not None:
                for br in batch_responses:
                    for li, resp in enumerate(br.responses):
                        _, qh = compiled[live[li]]
                        node = next(
                            n for n in self.nodes
                            if n.shard.shard_id == br.shard_id
                        )
                        self.cache.put(
                            versioned_key(qh, node.shard.manifest_hash),
                            resp,
                            nbytes=resp.result.extras.get("output_bytes", 0),
                            fetch_bytes=resp.result.stats.bytes_fetched,
                        )

        results: list[ClusterSkimResult] = []
        merge_s_total = 0.0
        for ti in range(len(compiled)):
            if ti in cached_responses:
                responses = cached_responses[ti]
            else:
                li = live.index(ti)
                responses = [br.responses[li] for br in batch_responses]
            t_m = time.perf_counter()
            output, n_input, n_passed = merge_responses(
                responses, self.basket_events, self.codec
            )
            merge_s = time.perf_counter() - t_m
            merge_s_total += merge_s
            results.append(
                ClusterSkimResult(
                    output=output,
                    n_input=n_input,
                    n_passed=n_passed,
                    breakdown=Breakdown.merged(
                        [r.result.breakdown for r in responses]
                    ),
                    stats=FetchStats.merged(
                        [r.result.stats for r in responses]
                    ),
                    responses=responses,
                    retries=[r for r in retries],
                    modeled_total_s=max(
                        (r.modeled_s for r in responses), default=0.0
                    )
                    + merge_s,
                    merge_s=merge_s,
                    wall_s=0.0,
                    extras=make_extras(
                        output_bytes=output.compressed_bytes(),
                        tenant=ti,
                        query_hash=compiled[ti][1],
                    ),
                )
            )

        shared_bytes = sum(
            br.shared.shared_stats.bytes_fetched for br in batch_responses
        )
        naive_bytes = sum(
            br.shared.naive_phase1_bytes for br in batch_responses
        )
        # cluster bound: the slowest live shared scan, or — fully warm —
        # the slowest cached shard's output transfer (same currency as
        # run()'s warm path)
        slowest = max(
            (br.modeled_s for br in batch_responses),
            default=0.0,
        )
        slowest = max(
            [slowest]
            + [r.modeled_s for rs in cached_responses.values() for r in rs]
        )
        return ClusterBatchResult(
            results=results,
            shared_phase1_bytes=shared_bytes,
            naive_phase1_bytes=naive_bytes,
            modeled_total_s=slowest + merge_s_total,
            wall_s=time.perf_counter() - t0,
            cached_tenants=sorted(cached_responses),
        )


# ---------------------------------------------------------------------------
# convenience builder
# ---------------------------------------------------------------------------


def build_cluster(
    store: EventStore,
    n_nodes: int,
    policy: str = "round_robin",
    window_events: int | None = None,
    replication: bool = True,
    cache: SkimResultCache | None = None,
    concurrency: str = "serial",
    prune: bool = True,
    cascade: bool = True,
    shard_timeout_s: float | None = None,
    retry_policy: RetryPolicy = DEFAULT_RETRY_POLICY,
    hedge: HedgePolicy | None = None,
    metrics=None,
    allow_partial: bool = False,
    **node_kw,
) -> ClusterCoordinator:
    """Partition ``store`` over ``n_nodes`` storage nodes and wire up a
    coordinator.  ``replication=True`` places a standby replica node per
    shard (sharing the shard's baskets — replication is free in-process);
    ``node_kw`` passes link tiers / executor flags to every node.
    ``prune`` controls zone-map pushdown at every level: the
    coordinator's pre-RPC shard skip AND the nodes' window-level
    pruning (DESIGN.md §9).  ``cascade`` controls the nodes' cascaded
    phase-1 executor (DESIGN.md §11); ``False`` restores the
    full-preload accounting reference."""
    from repro_torch.cluster.shard import partition_store

    shards = partition_store(
        store, n_nodes, policy=policy, window_events=window_events
    )
    nodes = [
        StorageNode(sh, prune=prune, cascade=cascade, **node_kw)
        for sh in shards
    ]
    replicas = (
        {
            sh.shard_id: StorageNode(
                sh, node_id=n_nodes + sh.shard_id, prune=prune,
                cascade=cascade, **node_kw
            )
            for sh in shards
        }
        if replication
        else {}
    )
    return ClusterCoordinator(
        nodes,
        replicas=replicas,
        cache=cache,
        concurrency=concurrency,
        basket_events=store.basket_events,
        codec=store.codec,
        prune=prune,
        shard_timeout_s=shard_timeout_s,
        retry_policy=retry_policy,
        hedge=hedge,
        metrics=metrics,
        allow_partial=allow_partial,
    )
