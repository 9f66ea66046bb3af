"""Storage node: one shard behind a small request API (DESIGN.md §5b).

A :class:`StorageNode` is the cluster's unit of placement and failure —
the near-storage server (DPU analogue) that owns one shard and runs the
single-node fast path against it: a per-shard
:class:`~repro_torch.core.engine.SkimEngine` for single queries and a
:class:`~repro_torch.serve.engine.SharedScanEngine` for multi-tenant batches.
Its link tiers are its own (``near_input_link`` for the storage-side
fetch the prefetcher hides, ``output_link`` for survivors crossing back
to the client), so a cluster can model heterogeneous fleets.

Failure realism is injectable and deterministic: ``inject_fault("fail")``
makes the next request(s) raise :class:`NodeFailure` (the coordinator
retries under its :class:`~repro_torch.cluster.retry.RetryPolicy`);
``inject_fault("straggle", delay_s=...)`` adds modeled seconds to the
response so tail-latency behavior is visible in the cluster schedule
without sleeping the host; ``inject_fault("corrupt")`` flips bits on the
node's read path for the next request — the store's integrity digests
catch it (:class:`~repro_torch.data.store.CorruptBasket`), the node
quarantines the (shard, branch, basket) in :attr:`StorageNode.quarantine`,
and the blob is restored afterwards (transient read corruption, so the
replica — which shares the baskets in-process — re-fetches clean bytes).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.cluster.shard import Shard
from repro_torch.core.engine import PCIE_128G, NetworkModel, SkimEngine, SkimResult, WAN_1G
from repro_torch.core.query import Query, parse_query
from repro_torch.data.store import CorruptBasket
from repro_torch.serve.engine import SharedScanEngine, SharedScanResult

FAULT_KINDS = ("fail", "straggle", "corrupt")


class NodeFailure(RuntimeError):
    """A storage node refused or dropped a request (crash/timeout model)."""


@dataclass
class _Fault:
    kind: str  # "fail" | "straggle" | "corrupt"
    remaining: int  # requests still affected
    delay_s: float = 0.0
    # corrupt faults: which basket to damage; branch=None picks the
    # query's first filter branch (guaranteed to be fetched for any
    # non-pruned window)
    branch: str | None = None
    basket: int = 0


@dataclass
class NodeResponse:
    """One shard's answer to one query."""

    node_id: int
    shard_id: int
    window_ids: list[int]
    result: SkimResult
    modeled_s: float  # node-local modeled time (pipeline bound + straggle)
    straggle_s: float = 0.0
    wall_s: float = 0.0  # realized time on this host
    cached: bool = False  # filled by the coordinator on cache hits
    pruned: bool = False  # synthesized by the coordinator from zone-map
    # stats — the node was never contacted (DESIGN.md §9)
    # node-local span list (repro_torch.obs.trace.Span); the coordinator adopts
    # these into its own tree, and they are stripped before cache.put —
    # a replayed response must not re-adopt a stale execution's spans
    trace: list | None = None


@dataclass
class BatchResponse:
    """One shard's answer to a shared-scan tenant batch."""

    node_id: int
    shard_id: int
    responses: list[NodeResponse]  # per tenant, request order
    shared: SharedScanResult
    modeled_s: float  # one shared phase 1 + all tenants' private work


def modeled_node_seconds(result: SkimResult) -> float:
    """The node's modeled wall-clock for one skim: the exact
    double-buffered schedule when the executor pipelined, the serial
    stage sum otherwise."""
    return result.extras.get("pipeline_total", result.breakdown.total())


class StorageNode:
    """One shard + the engines that serve it.

    ``device`` is where both engines run: the card unless the caller asks
    for the CPU (``device="cpu"``); with no card present ``None`` raises.
    The shard's store decodes on its own device."""

    def __init__(
        self,
        shard: Shard,
        node_id: int | None = None,
        near_input_link: NetworkModel = PCIE_128G,
        output_link: NetworkModel = WAN_1G,
        fused: bool = True,
        pipeline: bool | str = True,
        prune: bool = True,
        cascade: bool = True,
        device_batch: int | None = None,
        fused_backend: str | None = None,
        device=None,
    ):
        self.shard = shard
        self.node_id = shard.shard_id if node_id is None else node_id
        self.near_input_link = near_input_link
        self.output_link = output_link
        self.prune = prune
        self.cascade = cascade
        self.engine = SkimEngine(
            shard.store,
            input_link=output_link,
            output_link=output_link,
            chunk_events=shard.window_events,
            fused=fused,
            pipeline=pipeline,
            near_input_link=near_input_link,
            prune=prune,
            cascade=cascade,
            device_batch=device_batch,
            fused_backend=fused_backend,
            device=device,
        )
        self.shared_engine = SharedScanEngine(
            shard.store,
            input_link=near_input_link,
            output_link=output_link,
            chunk_events=shard.window_events,
            fused=fused,
            prune=prune,
            cascade=cascade,
            device_batch=device_batch,
            fused_backend=fused_backend,
            device=self.engine.device,
        )
        self._faults: list[_Fault] = []
        self.requests_served = 0
        # node-local quarantine of baskets that failed their integrity
        # digest on this node's read path: {(shard_id, branch, basket)}.
        # The coordinator ledgers its size (extras["corrupt_baskets"])
        # and re-fetches the shard from the replica (DESIGN.md §14).
        self.quarantine: set[tuple[int, str, int]] = set()

    # -- fault injection -----------------------------------------------------

    def inject_fault(
        self,
        kind: str,
        n: int = 1,
        delay_s: float = 0.0,
        branch: str | None = None,
        basket: int = 0,
    ) -> None:
        """Arm a deterministic fault for the next ``n`` requests.
        ``branch``/``basket`` pick the corruption target for
        ``kind="corrupt"`` (default: the query's first filter branch,
        basket 0)."""
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (want {FAULT_KINDS})")
        self._faults.append(
            _Fault(kind, max(int(n), 1), delay_s, branch=branch, basket=basket)
        )

    def _consume_fault(self) -> tuple[float, _Fault | None]:
        """Apply at most one armed fault; returns ``(straggle_s,
        corrupt_fault_or_None)``."""
        straggle = 0.0
        for f in list(self._faults):
            if f.remaining <= 0:
                self._faults.remove(f)
                continue
            f.remaining -= 1
            if f.remaining <= 0:
                self._faults.remove(f)
            if f.kind == "fail":
                raise NodeFailure(
                    f"node {self.node_id} (shard {self.shard.shard_id}): "
                    "injected failure"
                )
            if f.kind == "corrupt":
                return 0.0, f
            straggle += f.delay_s
            break  # one fault per request
        return straggle, None

    def _arm_corruption(self, query, fault: _Fault):
        """Damage the fault's target blob on this node's store; returns
        the ``restore()`` callable (transient read-path corruption)."""
        store = self.shard.store
        branch = fault.branch
        if branch is None:
            from repro_torch.core.planner import plan_skim

            q = query if isinstance(query, Query) else parse_query(query)
            plan = plan_skim(q, store)
            branch = plan.filter_branches[0]
        basket = min(fault.basket, max(store.n_baskets(branch) - 1, 0))
        return store.corrupt_blob(branch, basket)

    # -- request API ---------------------------------------------------------

    def execute(self, query: Query | dict | str, tracer=None) -> NodeResponse:
        """Run one skim over this node's shard (near-data mode).

        ``tracer`` is a node-local :class:`~repro_torch.obs.trace.Tracer`; its
        recorded spans travel back on ``NodeResponse.trace`` for the
        coordinator to adopt into the query-level tree."""
        straggle, corrupt = self._consume_fault()
        restore = (
            self._arm_corruption(query, corrupt) if corrupt is not None else None
        )
        t0 = time.perf_counter()
        try:
            result = self.engine.run(query, mode="near_data", tracer=tracer)
        except CorruptBasket as exc:
            self.quarantine.add(
                (self.shard.shard_id, exc.branch, exc.basket_id)
            )
            raise
        finally:
            if restore is not None:
                restore()
        self.requests_served += 1
        return NodeResponse(
            node_id=self.node_id,
            shard_id=self.shard.shard_id,
            window_ids=list(self.shard.window_ids),
            result=result,
            modeled_s=modeled_node_seconds(result) + straggle,
            straggle_s=straggle,
            wall_s=time.perf_counter() - t0,
            trace=tracer.spans() if tracer is not None else None,
        )

    def execute_batch(
        self, queries: list[Query | dict | str], tracer=None
    ) -> BatchResponse:
        """Run a tenant batch as ONE shared scan over this node's shard."""
        straggle, corrupt = self._consume_fault()
        restore = (
            self._arm_corruption(queries[0], corrupt)
            if corrupt is not None and queries
            else None
        )
        t0 = time.perf_counter()
        try:
            batch = self.shared_engine.run_batch(queries, tracer=tracer)
        except CorruptBasket as exc:
            self.quarantine.add(
                (self.shard.shard_id, exc.branch, exc.basket_id)
            )
            raise
        finally:
            if restore is not None:
                restore()
        self.requests_served += 1
        wall = time.perf_counter() - t0
        responses = [
            NodeResponse(
                node_id=self.node_id,
                shard_id=self.shard.shard_id,
                window_ids=list(self.shard.window_ids),
                result=r,
                modeled_s=r.breakdown.total() + straggle,
                straggle_s=straggle,
                wall_s=wall,
            )
            for r in batch.results
        ]
        modeled = (
            batch.shared_breakdown.total()
            + sum(r.breakdown.total() for r in batch.results)
            + straggle
        )
        return BatchResponse(
            node_id=self.node_id,
            shard_id=self.shard.shard_id,
            responses=responses,
            shared=batch,
            modeled_s=modeled,
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (
            f"StorageNode(id={self.node_id}, shard={self.shard.shard_id}, "
            f"windows={len(self.shard.window_ids)}, "
            f"events={self.shard.n_events})"
        )
