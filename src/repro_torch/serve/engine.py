"""Serving layer: shared-scan skim batching (DESIGN.md §4c).

:class:`SharedScanEngine` is the skim service path: N concurrent tenant
queries execute over ONE pass of the same dataset.  With the cascaded
executor (DESIGN.md §11) the shared pass is demand-driven: the
double-buffered load stage fetches only the union of the tenants' pinned
*head* stages, each tenant's remaining cascade stages fetch alive
baskets on demand through a window-shared basket ledger, and phase 2
flows through the same ledger — so every ``(branch, basket)`` pair moves
at most once per window across the whole batch.  I/O and decode amortize
across tenants — the paper's interactive-rate multi-user skimming
regime — while each tenant still gets a private phase-2 output and its
own :class:`~repro_torch.core.engine.SkimResult`, bit-identical to running the
query alone.  ``cascade=False`` restores the union-preload pass.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.engine import (
    PCIE_128G,
    Breakdown,
    NetworkModel,
    SkimResult,
    WindowPartial,
    _concat_output,
    _decode_branches,
    _select_columns,
    _skipped_requests,
    _Timer,
    _warm_kernels,
    _window_phase2,
    _write_output,
    drain,
)
from repro_torch.core.planner import plan_skim
from repro_torch.core.query import Query, parse_query
from repro_torch.core.zonemap import ACCEPT_ALL, PRUNE, SCAN
from repro_torch.data.store import EventStore, FetchStats, WindowPrefetcher
from repro_torch.device import resolve_device
from repro_torch.obs.schema import SkimReport
from repro_torch.obs.trace import NULL_TRACER

# ---------------------------------------------------------------------------
# shared-scan skim service
# ---------------------------------------------------------------------------


@dataclass
class BatchWindowPartial:
    """One basket window of a shared scan, streamed per tenant.

    ``tenants[i]`` is tenant *i*'s :class:`~repro_torch.core.engine.WindowPartial`
    for this window — survivor columns exactly as they will land in that
    tenant's final output, so per-tenant unions of streamed partials are
    bit-identical to the batch result by construction (DESIGN.md §12).
    """

    index: int
    start: int
    stop: int
    tenants: list  # per tenant, request order: WindowPartial


@dataclass
class SharedScanResult:
    """Batch result of one shared scan over N tenant queries."""

    results: list[SkimResult]  # per-query, in request order
    shared_stats: FetchStats  # the single phase-1 pass (union branches)
    shared_breakdown: Breakdown  # fetch/decode of that pass (+ modeled link)
    naive_phase1_bytes: int  # what N independent scans would have fetched
    wall_s: float = 0.0

    @property
    def n_queries(self) -> int:
        return len(self.results)

    @property
    def saved_bytes(self) -> int:
        """Phase-1 bytes the shared scan avoided vs N independent skims."""
        return self.naive_phase1_bytes - self.shared_stats.bytes_fetched

    @property
    def amortization(self) -> float:
        """naive/shared phase-1 byte ratio (>= 1; ~N for similar queries)."""
        return self.naive_phase1_bytes / max(self.shared_stats.bytes_fetched, 1)


class SharedScanEngine:
    """Multi-tenant skim executor: N queries, one pass over the dataset.

    Phase 1 runs once per basket window for the whole batch: the load
    stage fetches + decodes the union of the tenants' phase-1 head sets
    (prefetched double-buffered, like the single-query pipelined
    executor), then every tenant's cascade evaluates against the shared
    decoded window, pulling later-stage branches on demand through a
    window-shared basket ledger.  Phase 2 stays per-tenant: only baskets
    holding that tenant's survivors move, into that tenant's private
    output.  Per-query outputs are bit-identical to running each query
    alone through ``SkimEngine.run(..., mode="near_data")``.

    ``device`` and ``fused_backend`` follow
    :class:`~repro_torch.core.engine.SkimEngine`: the card unless the
    caller asks for the CPU (``device="cpu"``; with no card present
    ``None`` raises), and ``"cuda"`` (the hand-written kernels, the
    default on the card), ``"torch"`` (their plain PyTorch versions) or
    ``"host"`` (the jagged-layout interpreter, the default on the CPU).
    """

    def __init__(
        self,
        store: EventStore,
        input_link: NetworkModel = PCIE_128G,
        output_link: NetworkModel | None = None,
        chunk_events: int | None = None,
        fused: bool = True,
        pipeline: bool | str = False,
        prune: bool = True,
        cascade: bool = True,
        device_batch: int | None = None,
        fused_backend: str | None = None,
        device=None,
    ):
        self.store = store
        self.device = resolve_device(device)
        self.input_link = input_link
        self.output_link = output_link or input_link
        self.chunk_events = chunk_events or store.basket_events
        self.fused = fused
        # zone-map pushdown (DESIGN.md §9): per-tenant window decisions;
        # the shared union fetch skips a window only when EVERY tenant
        # prunes it.  ``False`` is the reference path.
        self.prune = prune
        # cascaded phase 1 (DESIGN.md §11); ``False`` restores the
        # union-preload pass.  Applies to the fused path only.
        self.cascade = cascade
        # False = serial window loop; "threads" = real WindowPrefetcher
        # worker.  (The modeled pipeline schedule is a single-query
        # SkimEngine feature; the shared scan's win is byte amortization.)
        if pipeline not in (False, "threads"):
            raise ValueError(
                f"pipeline must be False or 'threads', got {pipeline!r}"
            )
        self.pipeline = pipeline
        # device-resident batched cascade (DESIGN.md §16): group this
        # many shared-scan windows per tenant cascade dispatch.  Applies
        # only to all-cascade batches; mixed batches keep the per-window
        # path (their ledger semantics differ per tenant anyway).
        if device_batch is not None and int(device_batch) < 1:
            raise ValueError(f"device_batch must be >= 1, got {device_batch}")
        self.device_batch = int(device_batch) if device_batch else None
        # fused-evaluator backend: the CUDA kernel on the card, the host
        # interpreter on the CPU, unless the caller forces one
        if fused_backend not in (None, "cuda", "torch", "host"):
            raise ValueError(f"unknown fused backend {fused_backend!r}")
        if fused_backend is None:
            fused_backend = "cuda" if self.device.type == "cuda" else "host"
        if fused_backend == "cuda" and self.device.type != "cuda":
            raise ValueError("fused_backend='cuda' needs a CUDA device")
        self.fused_backend = fused_backend

    def run_batch(
        self, queries: list[Query | dict | str], tracer=None
    ) -> SharedScanResult:
        return drain(self.iter_batch(queries, tracer=tracer))

    def iter_batch(self, queries: list[Query | dict | str], tracer=None):
        """Streaming form of :meth:`run_batch`: a generator yielding one
        :class:`BatchWindowPartial` per basket window (every tenant's
        ledger entry for that window together, since the scan is shared)
        and returning the final :class:`SharedScanResult`.  Window
        boundaries are the job service's cancellation points; a tenant
        cancelled mid-batch simply stops collecting its partials — the
        shared pass is one fetch either way (DESIGN.md §12)."""
        from repro_torch.core.neardata import fused_window_skim, window_pad_K
        from repro_torch.core.plan import CascadeExecutor, mark_fetched, unfetched_bytes

        store, chunk = self.store, self.chunk_events
        n = store.n_events
        t0 = time.perf_counter()
        tr = tracer if tracer is not None else NULL_TRACER

        bsid = tr.begin(
            "batch", kind="query", n_tenants=len(queries), n_events=n
        )
        plan_t0 = tr.now()
        parsed = [q if isinstance(q, Query) else parse_query(q) for q in queries]

        def _wants_cascade(q: Query) -> bool:
            flag = q.cascade if q.cascade is not None else self.cascade
            return bool(flag) and self.fused

        plans = [
            plan_skim(
                q, store, window_events=chunk, prune=self.prune,
                cascade=_wants_cascade(q),
            )
            for q in parsed
        ]
        programs = [p.compiled_program() if self.fused else None for p in plans]
        executors = [
            CascadeExecutor(
                p, store, tracer=tr, backend=self.fused_backend,
                device=self.device,
            )
            if p.cascade is not None
            else None
            for p in plans
        ]
        tr.add_span("plan", kind="plan", t0=plan_t0, t1=tr.now())
        # one-time warm-up outside the stage timers, as SkimEngine does
        _warm_kernels(store, self.device, self.fused)

        # full union of filter branches, first-seen order: the pricing /
        # amortization reference (what the union preload moved)
        union: list[str] = []
        seen: set[str] = set()
        for plan in plans:
            for br in plan.filter_branches:
                if br not in seen:
                    seen.add(br)
                    union.append(br)
        # what the load stage actually fetches per window: each tenant's
        # pinned head stage when cascading, its full filter set otherwise
        load_union: list[str] = []
        seen_load: set[str] = set()
        for plan, ex in zip(plans, executors):
            for br in (ex.head_branches if ex is not None else plan.filter_branches):
                if br not in seen_load:
                    seen_load.add(br)
                    load_union.append(br)

        shared_b, shared_stats = Breakdown(), FetchStats()

        # per-tenant zone-map decisions (DESIGN.md §9)
        decisions = [p.window_decisions for p in plans]

        def _tenant_kind(i: int, wi: int) -> str:
            return decisions[i][wi].decision if decisions[i] is not None else SCAN

        # the shared union fetch is skipped only when EVERY tenant prunes
        # the window: accept-all tenants still want the union decoded
        # (their phase 2 reuses it — dropping the shared pass would make
        # each of them re-fetch the overlap privately and cost MORE bytes
        # than the unpruned reference)
        n_windows = -(-n // chunk) if n else 0
        load_windows = {
            wi
            for wi in range(n_windows)
            if any(_tenant_kind(i, wi) != PRUNE for i in range(len(plans)))
        }

        def load_window(start: int, stop: int):
            if start // chunk not in load_windows:
                # every tenant proved this window empty: the shared union
                # fetch never happens and no tenant runs phase 2 either
                # (skip priced against the full-union preload reference)
                ls = FetchStats()
                nbytes, nb = store.range_comp_bytes(union, start, stop)
                ls.skip(nbytes, _skipped_requests(nbytes, nb, coalesce=True))
                return None, Breakdown(), ls
            lb, ls = Breakdown(), FetchStats()
            # prefetch worker threads never touch the consumer span stack
            ltr = NULL_TRACER if self.pipeline == "threads" else tr
            lsid = ltr.begin("load_window", kind="fetch", window=start // chunk)
            data = _decode_branches(
                store, load_union, start, stop, lb, ls, coalesce=True,
                tracer=ltr,
            )
            ltr.end(lsid, bytes=ls.bytes_fetched)
            return data, lb, ls

        # per-query accumulation state
        per_b = [Breakdown() for _ in plans]
        per_stats = [FetchStats() for _ in plans]
        out_cols = [{k: [] for k in p.output_branches} for p in plans]
        jagged_maps: list[dict[str, str]] = [{} for _ in plans]
        n_passed = [0] * len(plans)
        pad_K = [0] * len(plans)  # monotonic per-query pad shapes
        # per-tenant (start, stop, k) ledger — same mergeable-result
        # contract as the single-query executor (DESIGN.md §5)
        window_rows: list[list[tuple[int, int, int]]] = [[] for _ in plans]

        src = WindowPrefetcher(
            n, chunk, load_window, enabled=(self.pipeline == "threads")
        )

        # device-batched shared scan (DESIGN.md §16): group loaded
        # windows, run each tenant's cascade ONCE per group through
        # run_window_batch, and replay the outcomes through the unchanged
        # per-tenant ledger loop below.  Windows every tenant pruned
        # (data is None) pass through unbatched.
        G = (
            self.device_batch
            if executors and all(ex is not None for ex in executors)
            else None
        )
        pending_out: dict[tuple[int, int], object] = {}
        window_ledgers: dict[int, dict] = {}

        def scan_items():
            numbered = enumerate(src)
            if not G or G <= 1:
                for wi_, (start_, stop_, payload_) in numbered:
                    yield wi_, start_, stop_, payload_
                return
            buf: list = []

            def flush():
                if not buf:
                    return
                for wi_, start_, stop_, (data_, _lb, _ls) in buf:
                    led: dict[str, set] = {}
                    if data_ is not None:
                        mark_fetched(store, load_union, start_, stop_, led)
                    window_ledgers[wi_] = led
                for i_, ex_ in enumerate(executors):
                    sel = [
                        w for w in buf
                        if w[3][0] is not None
                        and _tenant_kind(i_, w[0]) == SCAN
                    ]
                    if not sel:
                        continue
                    entries = [
                        (
                            start_, stop_, data_, per_b[i_], shared_stats,
                            window_ledgers[wi_],
                        )
                        for wi_, start_, stop_, (data_, _lb, _ls) in sel
                    ]
                    outs = ex_.run_window_batch(entries, pad_B=G)
                    for (wi_, *_rest), out in zip(sel, outs):
                        pending_out[(i_, wi_)] = out
                items = list(buf)
                buf.clear()
                yield from items

            for wi_, (start_, stop_, payload_) in numbered:
                if payload_[0] is not None:
                    buf.append((wi_, start_, stop_, payload_))
                    if len(buf) == G:
                        yield from flush()
                else:
                    yield from flush()
                    yield (wi_, start_, stop_, payload_)
            yield from flush()

        for wi, start, stop, (data, lb, ls) in scan_items():
            shared_b.merge(lb)
            shared_stats.merge(ls)
            wsid = tr.begin(f"window[{wi}]", kind="window", index=wi)
            m = stop - start
            # window-shared basket ledger (DESIGN.md §11): every
            # (branch, basket) pair moves at most once per window across
            # all tenants and both phases
            ledger: dict[str, set] | None = window_ledgers.pop(wi, None)
            if ledger is None:
                ledger = {}
                if data is not None:
                    mark_fetched(store, load_union, start, stop, ledger)
            tenant_parts: list[WindowPartial] = [
                WindowPartial(
                    index=wi, start=start, stop=stop, n_passed=0,
                    cols={}, jagged={}, decision=_tenant_kind(i, wi),
                )
                for i in range(len(plans))
            ]
            for i, plan in enumerate(plans):
                b = per_b[i]
                ex = executors[i]
                dev_cols: dict[str, np.ndarray] = {}
                full_loaded: dict = {}
                kind = _tenant_kind(i, wi)
                if kind == PRUNE:
                    # provably no survivor for this tenant: no filter
                    # eval, no phase 2
                    window_rows[i].append((start, stop, 0))
                    continue
                if kind == SCAN and ex is not None and data is not None:
                    # cascaded phase 1: head evaluates from the shared
                    # decoded window, later stages fetch alive baskets on
                    # demand — bytes charged to the SHARED pass (they are
                    # reusable by every tenant through the ledger), eval
                    # and decode time to this tenant
                    outcome = pending_out.pop((i, wi), None)
                    if outcome is None:
                        outcome = ex.run_window(
                            start, stop, data, b, shared_stats, ledger=ledger
                        )
                    mask = outcome.mask
                    full_loaded = outcome.full_loaded
                elif kind == ACCEPT_ALL and ex is not None and data is not None:
                    # provably all survive: no predicate eval; the cascade
                    # tenant's phase 2 below flows through the ledger (the
                    # fused payload shortcut needs the full filter preload
                    # the cascade deliberately no longer does)
                    mask = np.ones(m, dtype=bool)
                else:
                    with _Timer(b, "filter"):
                        if (
                            kind == ACCEPT_ALL
                            and self.fused
                            and data is not None
                            and plan.filter_branches  # selection-free: no data
                        ):
                            # provably all survive: the fused executor's
                            # decision short-circuit skips predicate eval and
                            # passes the payload columns through whole
                            mask, dev_cols = fused_window_skim(
                                data, programs[i], store,
                                payload_branches=plan.payload_branches,
                                decision=ACCEPT_ALL,
                                backend=self.fused_backend, device=self.device,
                            )
                        elif kind == ACCEPT_ALL:
                            mask = np.ones(m, dtype=bool)
                        elif not plan.filter_branches:
                            # constant predicate: a selection-free projection
                            # passes everything, an OR over absent-era triggers
                            # passes nothing (DESIGN.md §10)
                            if self.fused:
                                from repro_torch.core.neardata import program_eval_np

                                mask = program_eval_np(
                                    data if data is not None else {},
                                    programs[i], m,
                                )
                            else:
                                from repro_torch.core.query import eval_stage

                                mask = np.ones(m, dtype=bool)
                                for _, stage in plan.query.stages():
                                    if stage:
                                        mask &= eval_stage(
                                            stage, data if data is not None
                                            else {}, m,
                                        )
                        elif self.fused:
                            pad_K[i] = max(
                                pad_K[i], window_pad_K(data, programs[i], store)
                            )
                            mask, dev_cols = fused_window_skim(
                                data, programs[i], store,
                                payload_branches=plan.payload_branches,
                                K=pad_K[i],
                                pad_to=chunk,
                                backend=self.fused_backend, device=self.device,
                            )
                        else:
                            from repro_torch.core.query import eval_stage

                            mask = np.ones(m, dtype=bool)
                            for _, stage in plan.query.stages():
                                if stage and mask.any():
                                    mask &= eval_stage(stage, data, m)
                k = int(mask.sum())
                window_rows[i].append((start, stop, k))
                tenant_parts[i].n_passed = k
                if k == 0:
                    continue
                n_passed[i] += k
                p2sid = tr.begin("phase2", kind="fetch", tenant=i, window=wi)
                if ex is not None and data is not None:
                    # phase 2 through the shared ledger: baskets any stage
                    # (or an earlier tenant) already moved are not re-paid
                    known = {**data, **full_loaded}
                    full = ex.fetch_full(
                        plan.output_branches, start, stop, b, per_stats[i],
                        ledger, known=known,
                    )
                    with _Timer(b, "deserialize"):
                        cols, jagged = _select_columns(
                            {k2: full[k2] for k2 in plan.output_branches},
                            mask, store,
                        )
                else:
                    cols, jagged = _window_phase2(
                        store, plan, start, stop, mask, dev_cols,
                        data if data is not None else {}, b,
                        per_stats[i], coalesce=True, tracer=tr,
                    )
                tr.end(p2sid, bytes=per_stats[i].bytes_fetched)
                jagged_maps[i].update(jagged)
                for k2, v in cols.items():
                    out_cols[i][k2].append(v)
                tenant_parts[i].cols = cols
                tenant_parts[i].jagged = jagged
            if data is not None and executors and all(
                ex is not None for ex in executors
            ):
                # cascaded-batch savings vs the union-preload reference,
                # ledgered AFTER every tenant's phase 2 (which flows
                # through the same ledger): a union basket counts as
                # skipped only if nothing in the batch ever moved it.
                # Mixed batches skip the ledger — non-cascade tenants'
                # phase 2 bypasses it, so 0 is the honest floor.
                shared_stats.cascade_bytes_skipped += unfetched_bytes(
                    store, union, start, stop, ledger
                )
            tr.end(wsid, n_passed=sum(p.n_passed for p in tenant_parts))
            try:
                yield BatchWindowPartial(
                    index=wi, start=start, stop=stop, tenants=tenant_parts
                )
            except GeneratorExit:
                tr.end(bsid, cancelled=True)
                raise

        # phase-1 link time is paid once for the whole batch
        shared_b.fetch = self.input_link.transfer_time(
            shared_stats.bytes_fetched, shared_stats.requests
        )

        results: list[SkimResult] = []
        for i, plan in enumerate(plans):
            b = per_b[i]
            cat = _concat_output(out_cols[i], n_passed[i], plan, store)
            out = _write_output(cat, jagged_maps[i], store, b)
            b.fetch = self.input_link.transfer_time(
                per_stats[i].bytes_fetched, per_stats[i].requests
            )
            out_bytes = out.compressed_bytes()
            b.output_transfer = self.output_link.transfer_time(out_bytes, 1)
            report = SkimReport(
                mode="shared_scan",
                fused=self.fused,
                pipelined=self.pipeline == "threads",
                prune=decisions[i] is not None,
                cascade=executors[i] is not None,
                output_bytes=out_bytes,
                window_rows=window_rows[i],
                pruned_windows=[
                    (d.start, d.stop, d.decision)
                    for d in decisions[i] or ()
                    if d.decision != SCAN
                ],
                shared_scan=True,
            )
            if executors[i] is not None:
                report.cascade_order = executors[i].order()
                report.cascade_stages = executors[i].state.report()
            results.append(
                SkimResult(
                    "shared_scan", out, n, n_passed[i], b, per_stats[i], plan,
                    extras=report.legacy_extras(),
                    report=report,
                )
            )
        tr.end(bsid, n_passed=sum(n_passed))

        naive = sum(
            store.compressed_bytes(p.filter_branches) for p in plans
        )
        return SharedScanResult(
            results=results,
            shared_stats=shared_stats,
            shared_breakdown=shared_b,
            naive_phase1_bytes=naive,
            wall_s=time.perf_counter() - t0,
        )
