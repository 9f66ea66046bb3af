"""Skim execution engine — reproduces the paper's four compared systems.

Modes (Fig. 4/5 of the paper):

  * ``client_plain``    — legacy client-side filtering: every selected
    branch's baskets cross the network for every event; everything is
    decompressed and deserialized before filtering (Fig. 2b).
  * ``client_opt``      — client-side with SkimROOT's two-phase model
    ("Client Opt"): phase 1 moves only filter branches; phase 2 moves
    output-only baskets for surviving ranges.
  * ``server_side``     — two-phase filtering on the storage server
    itself: no network for input baskets, but local reads are
    per-basket/on-demand (no TTreeCache batching — paper §4), adding
    request latency and stalling the decode pipeline.
  * ``near_data``       — SkimROOT: two-phase filtering next to storage
    (DPU analogue), coalesced high-bandwidth fetches, hardware-class
    (vectorized bitplane) decode, survivor-only output over the WAN.

``near_data`` additionally runs the **pipelined fused executor** by
default (DESIGN.md §4): the coalesced fetch + decode of basket window
*i+1* overlaps filtering of window *i* (double-buffered; modeled from
exact per-window records by default, realized by the
:class:`repro_torch.data.store.WindowPrefetcher` worker thread with
``pipeline="threads"``), and phase 1 evaluates the query as a compiled
predicate program fused with stream compaction — the CUDA kernel
``repro_torch.kernels.skim_fused`` on the card, the jagged-layout program
interpreter on the CPU.  ``fused=False`` / ``pipeline=False`` select
the reference two-pass serial path; all paths produce bit-identical
survivor sets and outputs.

Compute stages (decompress / deserialize / filter / write) are *measured*
on the host that runs the engine; link stages are *modeled* from accounted bytes via
:class:`NetworkModel` — the container has no real 1/10/100 Gb/s WAN, so the
byte accounting is exact and the time model is explicit (DESIGN.md §2c).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.planner import SkimPlan, plan_skim
from repro_torch.core.query import Query, eval_stage, parse_query
from repro_torch.core.zonemap import ACCEPT_ALL, PRUNE, SCAN
from repro_torch.data.store import (
    TTREECACHE_BYTES,  # noqa: F401  (re-export; serve + tests import via engine)
    EventStore,
    FetchStats,
    WindowPrefetcher,
    coalesced_requests,
)
from repro_torch.device import resolve_device
from repro_torch.obs.schema import SkimReport
from repro_torch.obs.trace import NULL_TRACER


@dataclass
class NetworkModel:
    """Analytic link-time model: serialization + per-request round trips."""

    bandwidth_gbps: float = 1.0
    rtt_s: float = 0.001

    def transfer_time(self, nbytes: int, n_requests: int = 1) -> float:
        return nbytes * 8.0 / (self.bandwidth_gbps * 1e9) + n_requests * self.rtt_s


# Link tiers used throughout the evaluation (paper §4; DESIGN.md §2c).
WAN_1G = NetworkModel(1.0, rtt_s=0.010)
LAN_10G = NetworkModel(10.0, rtt_s=0.001)
LAN_100G = NetworkModel(100.0, rtt_s=0.0005)
PCIE_128G = NetworkModel(128.0, rtt_s=0.00002)  # DPU<->host PCIe Gen3 x16
LOCAL_DISK = NetworkModel(16.0, rtt_s=0.0005)  # on-demand local reads, seek-y


@dataclass
class Breakdown:
    """Per-operation seconds; mirrors Fig. 4b / 5a."""

    fetch: float = 0.0  # input basket movement (modeled link / disk time)
    decompress: float = 0.0  # measured
    deserialize: float = 0.0  # measured
    filter: float = 0.0  # measured
    write: float = 0.0  # measured
    output_transfer: float = 0.0  # modeled (filtered file -> client)

    def total(self) -> float:
        return (
            self.fetch
            + self.decompress
            + self.deserialize
            + self.filter
            + self.write
            + self.output_transfer
        )

    def as_dict(self) -> dict:
        return {
            "fetch": self.fetch,
            "decompress": self.decompress,
            "deserialize": self.deserialize,
            "filter": self.filter,
            "write": self.write,
            "output_transfer": self.output_transfer,
            "total": self.total(),
        }

    def merge(self, other: "Breakdown") -> None:
        """Accumulate another breakdown (per-window accounting merge)."""
        self.fetch += other.fetch
        self.decompress += other.decompress
        self.deserialize += other.deserialize
        self.filter += other.filter
        self.write += other.write
        self.output_transfer += other.output_transfer

    @classmethod
    def merged(cls, parts: "list[Breakdown]") -> "Breakdown":
        """Sum a sequence of breakdowns into a fresh object (the cluster
        coordinator's gather contract — inputs are left untouched)."""
        out = cls()
        for p in parts:
            out.merge(p)
        return out


@dataclass
class SkimResult:
    mode: str
    output: EventStore
    n_input: int
    n_passed: int
    breakdown: Breakdown
    stats: FetchStats
    plan: SkimPlan
    busy_fraction: float = 1.0  # compute_time / total -> Fig. 5b proxy
    extras: dict = field(default_factory=dict)
    # structured form of `extras` (repro_torch.obs.schema.SkimReport); extras
    # is rendered FROM it via the compatibility shim and stays the
    # read-side contract for existing callers
    report: object = None

    @property
    def selectivity(self) -> float:
        return self.n_passed / max(self.n_input, 1)


@dataclass
class WindowPartial:
    """One basket window's completed ledger entry, streamed mid-skim.

    The executor yields one of these per window, in window order, as soon
    as that window's phase 2 finishes (DESIGN.md §12).  ``cols`` holds the
    window's survivor columns exactly as they will be concatenated into
    the final output — so the union of a run's partials is bit-identical
    to the synchronous result by construction.  ``n_passed == 0`` windows
    still stream (empty ``cols``): the ledger entry is the progress
    signal.
    """

    index: int  # window ordinal (0-based, ascending)
    start: int
    stop: int
    n_passed: int
    cols: dict  # branch -> survivor array ({} when nothing passed)
    jagged: dict  # jagged branch -> counts branch, for `cols`
    decision: str = SCAN  # zone-map kind this window resolved as


def drain(gen):
    """Drive a partial-yielding executor generator to its final result.

    The streaming executors are generators that yield
    :class:`WindowPartial` (or the shared-scan batch equivalent) per
    window and *return* the final result object — ``drain`` is the
    synchronous caller's one-liner to discard the stream and keep the
    result.
    """
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


class _Timer:
    def __init__(self, breakdown: Breakdown, key: str):
        self.b, self.k = breakdown, key

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        setattr(self.b, self.k, getattr(self.b, self.k) + time.perf_counter() - self.t0)


def _decode_branches(
    store: EventStore,
    names: list[str],
    start: int,
    stop: int,
    breakdown: Breakdown,
    stats: FetchStats,
    coalesce: bool,
    preloaded: dict[str, np.ndarray] | None = None,
    tracer=None,
) -> dict[str, np.ndarray]:
    """Fetch+decode a branch set for an event range; returns columnar data.

    Jagged branches come back as flat value arrays; counts branches carry
    the structure (the evaluator uses ``n<Coll>``).  ``preloaded`` supplies
    counts branches already decoded in an earlier stage.
    """
    tr = tracer if tracer is not None else NULL_TRACER
    data: dict[str, np.ndarray] = dict(preloaded or {})
    # counts branches must decode before jagged values they describe
    order = sorted(names, key=lambda n: 0 if not store.branches[n].jagged else 1)
    # one coalesced read round for the whole branch set (TTreeCache model;
    # the store owns the request accounting — DESIGN.md §2b)
    fsid = tr.begin("fetch", kind="fetch", branches=len(order))
    window = store.fetch_window(order, start, stop, stats=stats, coalesce=coalesce)
    tr.end(fsid, bytes=stats.bytes_fetched)
    # decode spans name their tier: "decode_device" when the store's
    # backend-selected batch decode runs on the accelerator (bitpack
    # planes crossing the host->device boundary compressed, DESIGN.md §16)
    dkind = (
        "decode_device"
        if store.resolved_decode_backend() == "device"
        and store.codec == "bitpack"
        else "decode"
    )
    dsid = tr.begin("decode", kind=dkind)
    # the round replays the JAX package's decode calls in its order, so
    # the decoded-basket LRU sees the same lookups: each branch's
    # baskets, then, for a jagged basket that starts before `start`, the
    # read of its leading counts (read_flat: one call per counts basket)
    calls: list = []
    first: dict[str, int] = {}  # branch -> its call
    leads: dict = {}  # (branch, basket start) -> (first call, counts baskets)
    for name in order:
        first[name] = len(calls)
        calls.append((name, [blob for _, blob in window[name]]))
        br = store.branches[name]
        for meta, _ in window[name] if br.jagged else ():
            if meta.first_entry < start:
                lead = store.fetch_range(br.counts_branch, meta.first_entry, start)
                leads[(name, meta.first_entry)] = (len(calls), lead)
                calls.extend((br.counts_branch, [blob]) for _, blob in lead)
    # the whole round decodes at once: one kernel launch on the card
    with _Timer(breakdown, "decompress"):
        decoded_calls = store.decode_calls(calls)
    for name in order:
        blobs = window[name]
        parts = []
        decoded = decoded_calls[first[name]]
        with _Timer(breakdown, "deserialize"):
            br = store.branches[name]
            for (meta, _), vals in zip(blobs, decoded):
                if not br.jagged:
                    lo = max(start - meta.first_entry, 0)
                    hi = min(stop - meta.first_entry, meta.n_entries)
                    parts.append(vals[lo:hi])
                else:
                    counts = data[br.counts_branch]
                    # basket-local event slice using already-decoded counts
                    b0 = max(start, meta.first_entry)
                    b1 = min(stop, meta.first_entry + meta.n_entries)
                    gc = counts[b0 - start : b1 - start].astype(np.int64)
                    # leading events of this basket that precede `start`
                    lead = 0
                    if meta.first_entry < start:
                        c, lead_baskets = leads[(name, meta.first_entry)]
                        for k, (m, _) in enumerate(lead_baskets):
                            lo = max(meta.first_entry - m.first_entry, 0)
                            hi = min(start - m.first_entry, m.n_entries)
                            lead += int(decoded_calls[c + k][0][lo:hi]
                                        .astype(np.int64).sum())
                    parts.append(vals[lead : lead + gc.sum()])
            data[name] = (
                np.concatenate(parts)
                if parts
                else np.empty(0, dtype=store.branches[name].np_dtype())
            )
    tr.end(dsid)
    return data


def _warm_kernels(store, device, fused: bool) -> None:
    """One-time warm-up (kernel build/load + CUDA context) outside the
    stage timers, when a run on the card launches kernels: the fused skim,
    or the decode rounds of a store that decodes there.  Measured stages
    then report steady-state compute, not start-up (DESIGN.md §2c)."""
    if device.type != "cuda":
        return
    if fused or store.resolved_decode_backend() == "device":
        import torch

        from repro_torch.kernels import ops

        ops.load_kernels()
        torch.cuda.init()


def _skipped_requests(nbytes: int, n_baskets: int, coalesce: bool) -> int:
    """Requests a skipped fetch round would have issued — the store's
    TTreeCache request model (:func:`repro_torch.data.store.coalesced_requests`),
    re-exported under the pricing-side name."""
    return coalesced_requests(nbytes, n_baskets, coalesce)


def _pipeline_schedule(
    records: list[dict], link: NetworkModel, depth: int = 2
) -> float:
    """Exact event-driven schedule of the double-buffered executor.

    One load worker (modeled link fetch + measured decode per window)
    runs ahead of one process worker (measured filter + phase-2 fetch and
    compute), with at most ``depth`` windows in flight — load of window
    ``i`` cannot start before window ``i - depth`` finished processing.
    Returns the makespan of the window loop; the serial equivalent is the
    plain sum of all stage terms (DESIGN.md §4b).
    """
    load_free = 0.0  # when the load worker is next available
    proc_free = 0.0  # when the process worker is next available
    done: list[float] = []  # per-window processing completion times
    for i, r in enumerate(records):
        load_t = (
            link.transfer_time(r["load_bytes"], r["load_requests"])
            + r["load_compute"]
        )
        start = load_free if i < depth else max(load_free, done[i - depth])
        load_done = start + load_t
        proc_t = r.get("proc_compute", 0.0) + link.transfer_time(
            r.get("p2_bytes", 0), r.get("p2_requests", 0)
        )
        proc_free = max(proc_free, load_done) + proc_t
        done.append(proc_free)
        load_free = load_done
    return proc_free


def _window_phase2(
    store,
    plan: SkimPlan,
    start: int,
    stop: int,
    mask: np.ndarray,
    dev_cols: dict,
    loaded: dict,
    breakdown: Breakdown,
    stats: FetchStats,
    coalesce: bool,
    tracer=None,
) -> tuple[dict, dict]:
    """Phase 2 for one surviving window: fetch the output-only branches and
    select survivor columns (shared by the single-query executor and the
    shared-scan service — the two must stay bit-identical).

    The fetch set is every output branch not already decoded: for scanned
    windows ``loaded`` holds the filter branches, so this is exactly the
    output-only set; for zone-map *accept-all* windows nothing was loaded
    in phase 1 and the whole output set moves here in one round
    (DESIGN.md §9)."""
    need2 = [x for x in plan.output_branches if x not in loaded]
    data2 = _decode_branches(
        store, need2, start, stop, breakdown, stats, coalesce, preloaded=loaded,
        tracer=tracer,
    )
    full = {**loaded, **data2}
    with _Timer(breakdown, "deserialize"):
        cols, jagged = _select_columns(
            {k2: full[k2] for k2 in plan.output_branches if k2 not in dev_cols},
            mask,
            store,
        )
        # payload columns come straight off the fused kernel, already
        # survivor-compacted (bit-identical to arr[mask])
        cols.update(dev_cols)
    return cols, jagged


def _concat_output(out_cols: dict, n_passed: int, plan: SkimPlan, store) -> dict:
    """Concatenate per-window survivor columns (empty-output dtype fallback
    included)."""
    if n_passed:
        return {
            k2: np.concatenate(v) if v else np.empty(0)
            for k2, v in out_cols.items()
        }
    return {
        k2: np.empty(0, dtype=store.branches[k2].np_dtype())
        for k2 in plan.output_branches
    }


def _rows_materialize(data: dict[str, np.ndarray], store, n: int) -> list:
    """Legacy deserialization: per-event row objects (the C++-object analogue).

    This is what makes unoptimized client-side filtering CPU-bound: every
    branch of every event becomes a Python-level object before the filter
    runs (paper: 240.4 s deserialize for LZ4 client-side).
    """
    offsets = {}
    for name in data:
        br = store.branches.get(name)
        if br is not None and br.jagged:
            counts = data[br.counts_branch].astype(np.int64)
            offsets[name] = np.concatenate([[0], np.cumsum(counts)])
    rows = []
    for i in range(n):
        row = {}
        for name, arr in data.items():
            br = store.branches.get(name)
            if br is not None and br.jagged:
                off = offsets[name]
                row[name] = arr[off[i] : off[i + 1]]
            else:
                row[name] = arr[i]
        rows.append(row)
    return rows


def _select_columns(
    data: dict[str, np.ndarray], mask: np.ndarray, store
) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Apply an event mask to columnar data -> (columns, jagged map)."""
    cols: dict[str, np.ndarray] = {}
    jagged: dict[str, str] = {}
    for name, arr in data.items():
        br = store.branches.get(name)
        if br is not None and br.jagged:
            counts = data[br.counts_branch].astype(np.int64)
            obj_mask = np.repeat(mask, counts)
            cols[name] = arr[obj_mask]
            jagged[name] = br.counts_branch
        else:
            cols[name] = arr[mask]
    return cols, jagged


def _write_output(
    cols: dict, jagged: dict, store: EventStore, breakdown: Breakdown
) -> EventStore:
    with _Timer(breakdown, "write"):
        out = EventStore.from_arrays(
            cols, jagged=jagged, basket_events=store.basket_events,
            codec=store.codec, device=store.device,
        )
    return out


class SkimEngine:
    """Runs a :class:`Query` against an :class:`EventStore` in one of the
    paper's four execution modes.

    ``fused`` / ``pipeline`` control the ``near_data`` executor only (the
    DPU analogue is where the fast path lives): ``fused=True`` evaluates
    the compiled predicate + stream compaction as one pass per window on
    the backend's best executor, and ``pipeline`` double-buffers window
    fetch+decode behind filtering — ``True`` runs the serial schedule and
    computes the exact double-buffered makespan from per-window records
    (``extras["pipeline_total"]``; compute stages stay cleanly
    measurable), ``"threads"`` additionally runs the real
    :class:`~repro_torch.data.store.WindowPrefetcher` worker (wall-clock
    overlap on hosts with spare cores; stage timings then include
    contention).  The other three modes always run the reference serial
    paths so the paper comparison stays honest.

    Note: any fused or pipelined configuration preloads *all* filter
    branches per window (one coalesced TTreeCache round), trading the
    staged evaluator's early-discard byte savings for batched I/O — so
    byte accounting differs slightly from the lazy staged path when
    whole windows die at an early stage.  The seed-exact reference for
    accounting comparisons is ``fused=False, pipeline=False``.

    ``device`` is where the fused path evaluates: the card unless the
    caller asks for the CPU (``device="cpu"``); with no card present,
    ``None`` raises rather than run on the CPU.  ``fused_backend`` is
    ``"cuda"`` (the hand-written kernel, the default on the card),
    ``"torch"`` (its plain PyTorch version over the same padded layout)
    or ``"host"`` (the jagged-layout interpreter, the default on the
    CPU).  Stores decode on their own device (see
    :class:`~repro_torch.data.store.EventStore`).
    """

    def __init__(
        self,
        store: EventStore,
        input_link: NetworkModel = WAN_1G,
        output_link: NetworkModel | None = None,
        chunk_events: int | None = None,
        decode_fn=None,
        fused: bool = True,
        pipeline: bool | str = True,
        near_input_link: NetworkModel = PCIE_128G,
        prune: bool = True,
        cascade: bool = True,
        tracer=None,
        device_batch: int | None = None,
        fused_backend: str | None = None,
        device=None,
    ):
        self.store = store
        self.device = resolve_device(device)
        self.input_link = input_link
        self.output_link = output_link or input_link
        self.chunk_events = chunk_events or store.basket_events
        # near-data mode may plug in a custom decoder
        self.decode_fn = decode_fn
        self.fused = fused
        self.pipeline = pipeline
        # what the DPU analogue reads its input baskets over: PCIe Gen3
        # x16 by default, or an SSD-class tier (e.g. LOCAL_DISK) to model
        # near-storage fetch that the prefetcher actually has to hide
        self.near_input_link = near_input_link
        # zone-map predicate pushdown (DESIGN.md §9): classify each basket
        # window from encode-time stats and skip fetch+decode for windows
        # provably empty (or provably all-surviving).  ``False`` is the
        # reference path every pruned run must stay bit-identical to.
        self.prune = prune
        # cascaded phase-1 execution (DESIGN.md §11): run the fused
        # near-data phase 1 as a cost-ordered cascade of per-node stages,
        # fetching each stage's branches only for baskets still alive.
        # ``False`` restores the PR-4 full-preload path (the accounting
        # reference), bit-identical on survivors either way.
        self.cascade = cascade
        # default span sink (repro_torch.obs.trace); the no-op tracer unless a
        # caller opts in — per-call ``tracer=`` overrides take precedence
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # device-resident batched cascade (DESIGN.md §16): group this many
        # cascaded SCAN windows per device dispatch — O(windows/B) stage
        # dispatches instead of O(windows), with survivor masks living on
        # the device between stages.  ``None``/1 keeps the per-window path.
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

    # -- public API ----------------------------------------------------------

    def run(
        self,
        query: Query | dict | str,
        mode: str = "near_data",
        fused: bool | None = None,
        pipeline: bool | str | None = None,
        prune: bool | None = None,
        cascade: bool | None = None,
        tracer=None,
    ) -> SkimResult:
        plan, args = self._prepare(
            query, mode, fused, pipeline, prune, cascade, tracer
        )
        if args is None:  # client_plain: the one-pass legacy path
            return self._run_client_plain(plan)
        return drain(self._iter_two_phase(plan, **args))

    def iter_run(
        self,
        query: Query | dict | str,
        mode: str = "near_data",
        fused: bool | None = None,
        pipeline: bool | str | None = None,
        prune: bool | None = None,
        cascade: bool | None = None,
        tracer=None,
    ):
        """Streaming form of :meth:`run`: a generator yielding one
        :class:`WindowPartial` per basket window as its ledger entry
        completes, and *returning* the final :class:`SkimResult` (via
        ``StopIteration.value``; :func:`drain` recovers it).

        This is the cooperative execution surface the async job service
        schedules on (DESIGN.md §12): window boundaries are the
        cancellation points, and the stream of partials is the partial-
        result feed.  Identical accounting and output to :meth:`run` by
        construction — ``run`` is ``drain(iter_run(...))``.
        ``client_plain`` has no window loop and cannot stream.
        """
        plan, args = self._prepare(
            query, mode, fused, pipeline, prune, cascade, tracer
        )
        if args is None:
            raise ValueError("client_plain is a one-pass mode; nothing to stream")
        return self._iter_two_phase(plan, **args)

    def _prepare(
        self,
        query: Query | dict | str,
        mode: str,
        fused: bool | None,
        pipeline: bool | str | None,
        prune: bool | None,
        cascade: bool | None,
        tracer=None,
    ) -> tuple[SkimPlan, dict | None]:
        """Shared argument resolution + planning for run / iter_run.

        Returns ``(plan, two_phase_kwargs)``; ``None`` kwargs means
        client_plain (the legacy one-pass path)."""
        tr = tracer if tracer is not None else self.tracer
        if not isinstance(query, Query):
            query = parse_query(query)
        do_prune = (self.prune if prune is None else bool(prune)) and (
            mode != "client_plain"  # full-scan legacy mode: nothing to push down
        )
        use_fused = self.fused if fused is None else fused
        # cascade resolution: explicit call arg > query flag > engine
        # default; the cascade lives on the near-data fused fast path
        # only (the other modes are the paper's fixed comparison points)
        if cascade is None:
            cascade = query.cascade if query.cascade is not None else self.cascade
        do_cascade = bool(cascade) and mode == "near_data" and use_fused
        plan_t0 = tr.now()
        plan = plan_skim(
            query, self.store, window_events=self.chunk_events, prune=do_prune,
            cascade=do_cascade,
        )
        plan_t = (plan_t0, tr.now())
        if mode == "client_plain":
            return plan, None
        if mode == "client_opt":
            return plan, dict(
                mode=mode, link=self.input_link, coalesce=True,
                tracer=tr, plan_t=plan_t,
            )
        if mode == "server_side":
            return plan, dict(
                mode=mode, link=LOCAL_DISK, coalesce=False,
                tracer=tr, plan_t=plan_t,
            )
        if mode == "near_data":
            prefetch = self.pipeline if pipeline is None else pipeline
            if prefetch not in (False, True, "threads"):
                raise ValueError(
                    f"pipeline must be False, True, or 'threads', got {prefetch!r}"
                )
            return plan, dict(
                mode=mode, link=self.near_input_link, coalesce=True,
                fused=use_fused, prefetch=prefetch,
                tracer=tr, plan_t=plan_t,
            )
        raise ValueError(f"unknown mode {mode}")

    # -- legacy client-side (Fig. 2b) -----------------------------------------

    def _run_client_plain(self, plan: SkimPlan) -> SkimResult:
        store, b, stats = self.store, Breakdown(), FetchStats()
        n = store.n_events
        _warm_kernels(store, self.device, fused=False)

        data = _decode_branches(
            store, plan.output_branches, 0, n, b, stats, coalesce=True
        )
        # legacy deserialization: build per-event rows for EVERY branch
        with _Timer(b, "deserialize"):
            rows = _rows_materialize(data, store, n)

        with _Timer(b, "filter"):
            mask = np.ones(n, dtype=bool)
            for _, stage in plan.query.stages():
                mask &= eval_stage(stage, data, n)
            del rows

        cols, jagged = _select_columns(data, mask, store)
        out = _write_output(cols, jagged, store, b)

        b.fetch = self.input_link.transfer_time(stats.bytes_fetched, stats.requests)
        b.output_transfer = 0.0  # filtering ran at the client already
        compute = b.decompress + b.deserialize + b.filter + b.write
        return SkimResult(
            "client_plain", out, n, int(mask.sum()), b, stats, plan,
            busy_fraction=compute / max(b.total(), 1e-12),
        )

    # -- two-phase model (client_opt / server_side / near_data) ---------------

    def _iter_two_phase(
        self,
        plan: SkimPlan,
        mode: str,
        link: NetworkModel,
        coalesce: bool,
        fused: bool = False,
        prefetch: bool | str = False,
        tracer=None,
        plan_t: tuple | None = None,
    ):
        """Generator core of the two-phase executor: yields a
        :class:`WindowPartial` per window, returns the :class:`SkimResult`."""
        tracer = tracer if tracer is not None else NULL_TRACER
        store, b, stats = self.store, Breakdown(), FetchStats()
        n = store.n_events
        chunk = self.chunk_events

        # the query root span stays open across the whole generator; each
        # child span closes before the window's partial yields, so a
        # consumer observing the stream never sees a half-open child
        qsid = tracer.begin(
            "query", kind="query", mode=mode, n_events=n, fused=fused
        )
        if plan_t is not None:
            tracer.add_span("plan", kind="plan", t0=plan_t[0], t1=plan_t[1])

        out_cols: dict[str, list] = {k: [] for k in plan.output_branches}
        jagged_map: dict[str, str] = {}
        n_passed = 0
        phase2_stats = FetchStats()

        program = plan.compiled_program() if fused else None
        _warm_kernels(store, self.device, fused)
        # cascaded phase 1 (DESIGN.md §11): one executor per run owns the
        # adaptive stage order; the prefetcher loads only the pinned head
        # stage, later stages fetch alive baskets on demand
        cascade_exec = None
        dispatches0 = None
        if fused:
            from repro_torch.kernels.ops import dispatch_stats

            dispatches0 = dispatch_stats()["dispatches"]
        if fused and plan.cascade is not None:
            from repro_torch.core.plan import CascadeExecutor, mark_fetched

            cascade_exec = CascadeExecutor(
                plan, store, coalesce=coalesce, tracer=tracer,
                backend=self.fused_backend, device=self.device,
            )
        use_threads = prefetch == "threads"
        preload = fused or bool(prefetch)
        # zone-map decisions (DESIGN.md §9): one per chunk window, or None
        # when pruning is off / nothing was provable
        decisions = plan.window_decisions
        # per-window load/process records feeding the explicit pipeline
        # schedule model (DESIGN.md §4b)
        win_records: list[dict] = []

        def load_window(start: int, stop: int):
            """Fetch + decode one window's filter branches (in "threads"
            mode this runs in the prefetch worker; all accounting is
            window-local and merged in window order by the consumer, so
            pipelined byte/request stats are identical to the serial
            schedule).  Zone-map decided windows (DESIGN.md §9): *prune*
            never touches the store at all; *accept-all* loads the full
            output set instead — every event survives, so the one
            coalesced round that phase 2 would pay moves into the load
            stage and keeps the double-buffered overlap."""
            kind = (
                decisions[start // chunk].decision
                if decisions is not None
                else SCAN
            )
            if kind == PRUNE:
                return None, Breakdown(), FetchStats()
            if kind != SCAN:
                names = plan.output_branches
            elif cascade_exec is not None:
                # cascaded phase 1: prefetch ONLY the pinned head stage;
                # the remaining stages fetch alive baskets on demand in
                # the process step (DESIGN.md §11)
                names = cascade_exec.head_branches
            else:
                names = plan.filter_branches
            lb, ls = Breakdown(), FetchStats()
            # the prefetch worker thread must not touch the consumer's
            # span stack; its loads go untraced in "threads" mode (the
            # serial schedules trace them as load_window spans)
            ltr = NULL_TRACER if use_threads else tracer
            lsid = ltr.begin("load_window", kind="fetch", window=start // chunk)
            data = _decode_branches(
                store, names, start, stop, lb, ls, coalesce, tracer=ltr
            )
            ltr.end(lsid, bytes=ls.bytes_fetched)
            return data, lb, ls

        def windows():
            if preload:
                # all filter branches move in one coalesced round per
                # window (the paper's TTreeCache batching); in "threads"
                # mode the prefetcher decodes window i+1 while window i
                # filters
                src = WindowPrefetcher(n, chunk, load_window, enabled=use_threads)
                for start, stop, (data, lb, ls) in src:
                    b.merge(lb)
                    stats.merge(ls)
                    win_records.append(
                        {
                            "load_bytes": ls.bytes_fetched,
                            "load_requests": ls.requests,
                            "load_compute": lb.decompress + lb.deserialize,
                        }
                    )
                    yield start, stop, data
            else:
                for start in range(0, n, chunk):
                    yield start, min(start + chunk, n), None

        # device-batched cascade grouping (DESIGN.md §16): consume SCAN
        # windows in groups of ``device_batch``, run the cascade ONCE per
        # group (one device dispatch per stage per group, survivor masks
        # device-resident between stages), then replay the precomputed
        # outcomes through the unchanged per-window ledger loop below.
        # Zone-map decided windows pass through unbatched — they never
        # evaluate the cascade at all.
        batch_n = self.device_batch if cascade_exec is not None else None
        pending: dict[int, tuple] = {}

        def window_items():
            src = enumerate(windows())
            if not batch_n or batch_n <= 1:
                yield from src
                return
            buf: list = []

            def flush():
                if not buf:
                    return
                entries, metas = [], []
                for _wi, (start_, stop_, preloaded_) in buf:
                    wb_, w1s_, ledger_ = Breakdown(), FetchStats(), {}
                    mark_fetched(
                        store, cascade_exec.head_branches, start_, stop_,
                        ledger_,
                    )
                    entries.append(
                        (start_, stop_, preloaded_, wb_, w1s_, ledger_)
                    )
                    metas.append((wb_, w1s_, ledger_))
                outs = cascade_exec.run_window_batch(entries, pad_B=batch_n)
                for (_wi, _win), out, meta in zip(buf, outs, metas):
                    pending[_wi] = (out, *meta)
                items = list(buf)
                buf.clear()
                yield from items

            for item in src:
                kind_ = (
                    decisions[item[0]].decision
                    if decisions is not None
                    else SCAN
                )
                if kind_ == SCAN:
                    buf.append(item)
                    if len(buf) == batch_n:
                        yield from flush()
                else:
                    yield from flush()
                    yield item
            yield from flush()

        # per-window survivor ledger: (start, stop, n_passed) for EVERY
        # window, survivors or not — the mergeable-result contract the
        # cluster coordinator splits shard outputs with (DESIGN.md §5)
        window_rows: list[tuple[int, int, int]] = []
        t_phase = time.perf_counter()
        pad_K = 0  # grows monotonically so padded shapes (and compiled
        # kernels) stay stable across windows once the max multiplicity
        # has been seen
        for wi, (start, stop, preloaded) in window_items():
            m = stop - start
            dec = decisions[wi] if decisions is not None else None
            kind = dec.decision if dec is not None else SCAN
            wsid = tracer.begin(
                f"window[{wi}]", kind="window", index=wi, decision=kind
            )
            dev_cols: dict[str, np.ndarray] = {}
            # window-local processing breakdown/stats (merged into the
            # run totals below; also feeds the pipeline schedule model)
            wb, w2s = Breakdown(), FetchStats()
            # cascade per-window state: the basket dedup ledger and the
            # window outcome (None on the non-cascaded paths)
            ledger: dict[str, set] = {}
            outcome = None
            w1s = FetchStats()
            if kind == PRUNE:
                # provably no survivor: phase 1 AND phase 2 never happen;
                # account what the skipped fetch round would have moved
                stats.skip(
                    dec.p1_bytes,
                    _skipped_requests(dec.p1_bytes, dec.p1_baskets, coalesce),
                )
                loaded = {}
                mask = np.zeros(m, dtype=bool)
            elif kind == ACCEPT_ALL:
                # provably all survive: skip predicate fetch+eval — the
                # output set moves in ONE round (preloaded in the load
                # stage when pipelining, fetched by phase 2 below
                # otherwise); filter-only branches never move at all
                stats.skip(
                    dec.extra_bytes,
                    0 if coalesce else dec.extra_baskets,
                )
                loaded = preloaded if preloaded is not None else {}
                mask = np.ones(m, dtype=bool)
            elif cascade_exec is not None:
                # ---- phase 1 (cascaded path, DESIGN.md §11): stages run
                # cheapest-and-most-selective-first; stage k fetches its
                # branches only for baskets still alive after stage k-1 ----
                loaded = {}
                if wi in pending:
                    # batched path: the cascade already ran for this
                    # window's group — adopt its outcome and per-window
                    # ledgers (byte/time accounting is window-local in
                    # the batch too, so totals match the per-window path)
                    outcome, cwb, w1s, ledger = pending.pop(wi)
                    wb.merge(cwb)
                else:
                    mark_fetched(
                        store, cascade_exec.head_branches, start, stop, ledger
                    )
                    outcome = cascade_exec.run_window(
                        start, stop, preloaded, wb, w1s, ledger=ledger
                    )
                mask = outcome.mask
                stats.merge(w1s)
            elif fused:
                # ---- phase 1 (fused path): one pass evaluates the
                # compiled predicate AND compacts [index]+payload rows ----
                from repro_torch.core.neardata import (
                    fused_window_skim,
                    program_eval_np,
                    window_pad_K,
                )

                loaded = preloaded
                if not plan.filter_branches:
                    # no present branch feeds the predicate: the program is
                    # constant — all-true for a selection-free projection,
                    # all-false when only absent-era trigger ORs remain
                    mask = program_eval_np(loaded or {}, program, m)
                else:
                    pad_K = max(pad_K, window_pad_K(loaded, program, store))
                    ksid = tracer.begin("kernel", kind="kernel", window=wi)
                    with _Timer(wb, "filter"):
                        mask, dev_cols = fused_window_skim(
                            loaded, program, store,
                            payload_branches=plan.payload_branches,
                            K=pad_K,
                            pad_to=chunk,
                            backend=self.fused_backend,
                            device=self.device,
                        )
                    tracer.end(ksid)
            else:
                # ---- phase 1: staged filter over filter-criteria branches ----
                mask = np.ones(m, dtype=bool)
                loaded = dict(preloaded) if preloaded is not None else {}
                for stage_name, stage in plan.query.stages():
                    if not stage:
                        continue
                    if not mask.any():
                        break  # hierarchical early discard: skip later stages
                    need = [
                        x
                        for x in sorted(plan.query.stage_branches(stage_name))
                        if x not in loaded and x in store.branches
                    ]
                    from repro_torch.core.branchmap import with_counts_branches

                    need = [
                        x for x in with_counts_branches(need, store) if x not in loaded
                    ]
                    loaded.update(
                        _decode_branches(
                            store, need, start, stop, wb, stats, coalesce,
                            preloaded=loaded,
                        )
                    )
                    with _Timer(wb, "filter"):
                        mask &= eval_stage(stage, loaded, m)

            k = int(mask.sum())
            window_rows.append((start, stop, k))
            part_cols: dict = {}
            part_jagged: dict = {}
            if k:
                n_passed += k
                p2sid = tracer.begin("phase2", kind="fetch", window=wi)
                if outcome is not None:
                    # ---- phase 2 (cascaded window): the basket ledger
                    # dedups against phase 1, so filter∩output branches a
                    # stage already moved are not paid again ----
                    known = {**(preloaded or {}), **outcome.full_loaded}
                    full = cascade_exec.fetch_full(
                        plan.output_branches, start, stop, wb, w2s, ledger,
                        known=known,
                    )
                    with _Timer(wb, "deserialize"):
                        cols, jagged = _select_columns(
                            {k2: full[k2] for k2 in plan.output_branches},
                            mask, store,
                        )
                else:
                    # ---- phase 2: output-only branches, survivors only ----
                    cols, jagged = _window_phase2(
                        store, plan, start, stop, mask, dev_cols, loaded, wb,
                        w2s, coalesce, tracer=tracer,
                    )
                tracer.end(p2sid, bytes=w2s.bytes_fetched)
                jagged_map.update(jagged)
                for k2, v in cols.items():
                    out_cols[k2].append(v)
                part_cols, part_jagged = cols, jagged
            if outcome is not None:
                # savings vs the preloading reference, ledgered AFTER both
                # phases: a filter-branch basket counts as skipped only if
                # neither a cascade stage nor phase 2 ever moved it (phase
                # 2 re-fetches dead baskets of filter∩output branches for
                # surviving windows, which must not be credited)
                from repro_torch.core.plan import unfetched_bytes

                stats.cascade_bytes_skipped += unfetched_bytes(
                    store, plan.filter_branches, start, stop, ledger
                )
            b.merge(wb)
            phase2_stats.merge(w2s)
            if win_records:
                # indexed by window (not [-1]): batched grouping consumes
                # load records ahead of the processing loop
                win_records[wi].update(
                    {
                        "proc_compute": wb.decompress + wb.deserialize + wb.filter,
                        # cascaded stage fetches are non-overlapped fetch in
                        # the schedule, same currency as phase 2
                        "p2_bytes": w2s.bytes_fetched + w1s.bytes_fetched,
                        "p2_requests": w2s.requests + w1s.requests,
                    }
                )
            # the window's ledger entry is complete: stream it.  A caller
            # that stops consuming here (cancellation) has paid exactly
            # the windows it saw — the accounting above is window-local.
            tracer.end(wsid, n_passed=k)
            try:
                yield WindowPartial(
                    index=wi, start=start, stop=stop, n_passed=k,
                    cols=part_cols, jagged=part_jagged, decision=kind,
                )
            except GeneratorExit:
                # cancelled mid-stream: close the root so the partial
                # trace still exports as a well-formed tree
                tracer.end(qsid, cancelled=True, n_passed=n_passed)
                raise
        phase_wall = time.perf_counter() - t_phase

        phase1_bytes = stats.bytes_fetched  # pre-merge: phase-1 only
        stats.merge(phase2_stats)

        osid = tracer.begin("write", kind="write")
        with _Timer(b, "write"):
            cat = _concat_output(out_cols, n_passed, plan, store)
        out = _write_output(cat, jagged_map, store, b)
        tracer.end(osid)

        b.fetch = link.transfer_time(stats.bytes_fetched, stats.requests)
        out_bytes = out.compressed_bytes()
        if mode in ("server_side", "near_data"):
            # the filtered file crosses the WAN back to the client
            b.output_transfer = self.output_link.transfer_time(out_bytes, 1)
        compute = b.decompress + b.deserialize + b.filter + b.write
        # double-buffered basket prefetch (the paper's "advanced data
        # prefetching" future work, implemented for near_data): with fetch
        # of window i+1 overlapping compute of window i, the pipeline
        # bound is max(fetch, compute) instead of their sum.
        overlap_total = (
            max(b.fetch, b.decompress + b.deserialize + b.filter)
            + b.write
            + b.output_transfer
        )
        report = SkimReport(
            mode=mode,
            fused=fused,
            pipelined=bool(prefetch),
            prune=decisions is not None,
            # cascaded phase-1 ledger (DESIGN.md §11)
            cascade=cascade_exec is not None,
            output_bytes=out_bytes,
            window_rows=window_rows,
            # zone-map pruning ledger (DESIGN.md §9): every window the
            # analysis decided without fetching, plus the priced savings
            # mirrored in stats.bytes_skipped / requests_skipped
            pruned_windows=[
                (d.start, d.stop, d.decision)
                for d in decisions or ()
                if d.decision != SCAN
            ],
            overlap_total_s=overlap_total,
            phase_wall_s=phase_wall,
            # phase split of stats.bytes_fetched (accept-all windows fold
            # their single output round into phase 1 when preloading)
            phase1_bytes=phase1_bytes,
            phase2_bytes=phase2_stats.bytes_fetched,
        )
        if cascade_exec is not None:
            report.cascade_order = cascade_exec.order()
            report.cascade_stages = cascade_exec.state.report()
            report.cascade_bytes_skipped = stats.cascade_bytes_skipped
        if dispatches0 is not None:
            from repro_torch.kernels.ops import dispatch_stats

            report.device_dispatches = (
                dispatch_stats()["dispatches"] - dispatches0
            )
            report.decode_backend = store.resolved_decode_backend()
            if batch_n:
                report.device_batch = batch_n
        if win_records:
            # exact double-buffered schedule from the per-window records
            # (what the threaded prefetcher realizes on capable hosts)
            report.pipeline_total_s = (
                _pipeline_schedule(win_records, link)
                + b.write
                + b.output_transfer
            )
        tracer.end(qsid, n_passed=n_passed, bytes=stats.bytes_fetched)
        return SkimResult(
            mode, out, n, n_passed, b, stats, plan,
            busy_fraction=compute / max(b.total(), 1e-12),
            extras=report.legacy_extras(),
            report=report,
        )


def run_skim(
    store: EventStore,
    query: Query | dict | str,
    mode: str = "near_data",
    input_link: NetworkModel = WAN_1G,
    output_link: NetworkModel | None = None,
    fused: bool | None = None,
    pipeline: bool | str | None = None,
    prune: bool | None = None,
    cascade: bool | None = None,
    device_batch: int | None = None,
    fused_backend: str | None = None,
    device=None,
) -> SkimResult:
    return SkimEngine(
        store, input_link, output_link,
        device_batch=device_batch, fused_backend=fused_backend, device=device,
    ).run(
        query, mode, fused=fused, pipeline=pipeline, prune=prune,
        cascade=cascade,
    )
