"""The port's host-detail spans and transfer counters, on the CPU.

A skim traced by a detailed ``Tracer()`` records a leaf span for each
host step (``fetch``, ``ledger``, ``pack``, ``launch``, ``device_wait``,
``unpack``, ``evaluate``, ``decompress``, ``deserialize``) inside its
``query`` span.  Here a small store goes through the per-window cascade,
the batched cascade (``device_batch=3``) and the fused path without a
cascade, on the kernels' plain versions (``fused_backend="torch"``,
``decode_backend="device"``), and through the host interpreter.  A
tracer that asks for no detail records the JAX package's tree, byte for
byte.  Copies to a card do not happen here; where a test needs copies,
it notes one for each call of a kernel-tier entry point.
"""

import itertools
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the quickstart query)
import repro.obs.trace as jtrace  # noqa: E402
from repro.core import SkimEngine as JEngine  # noqa: E402
from repro.data.synth import make_nanoaod_like as j_make  # noqa: E402
from repro_torch.core import SkimEngine  # noqa: E402
from repro_torch.core.engine import drain  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

N = 12_000
BASKET = 2048
QUERY = chip_smoke.QUICKSTART_QUERY
LEAF_KINDS = {"fetch", "ledger", "pack", "launch", "device_wait", "unpack", "evaluate",
              "decompress", "deserialize"}

# route -> (engine keywords, run keywords, leaf kinds its work runs)
ROUTES = {
    "window": ({"fused_backend": "torch"}, {},
               {"fetch", "ledger", "pack", "launch", "device_wait", "unpack",
                "decompress", "deserialize"}),
    "batched": ({"fused_backend": "torch", "device_batch": 3}, {},
                {"fetch", "ledger", "pack", "launch", "device_wait", "unpack",
                 "decompress", "deserialize"}),
    "fused": ({"fused_backend": "torch"}, {"cascade": False},
              {"fetch", "pack", "launch", "device_wait", "unpack", "decompress",
               "deserialize"}),
    "host": ({}, {}, {"fetch", "ledger", "evaluate", "decompress", "deserialize"}),
}


class Tick:
    """A clock that moves one second a reading: exact sums in float64."""

    def __init__(self):
        self.t = itertools.count(1)

    def now(self) -> float:
        return float(next(self.t))


def _store(decode: str | None):
    store = make_nanoaod_like(N, n_hlt=8, n_filler=2, basket_events=BASKET, device="cpu")
    store.decode_backend = decode
    return store


@pytest.fixture(scope="module")
def stores():
    return {"device": _store("device"), "host": _store("host")}


def _run(stores, route: str, tracer=None):
    eng_kw, run_kw, _ = ROUTES[route]
    store = stores["host" if route == "host" else "device"]
    engine = SkimEngine(store, device="cpu", **eng_kw)
    return engine.run(QUERY, "near_data", tracer=tracer, **run_kw)


@pytest.fixture(scope="module")
def traced(stores):
    """Each route traced by ``Tracer()`` on its own clock,
    ``time.perf_counter``, which ticks one second a reading here (exact
    sums in float64)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "perf_counter", Tick().now)
        for route in ROUTES:
            tr = trace.Tracer()
            out[route] = (_run(stores, route, tr), tr.spans())
    return out


def _children(spans) -> dict:
    kids = {}
    for sp in spans:
        kids.setdefault(sp.parent, []).append(sp)
    return kids


def _query(spans):
    (q,) = [sp for sp in spans if sp.kind == "query"]
    return q


@pytest.mark.parametrize("route", list(ROUTES))
def test_each_leaf_kind_appears_where_its_work_runs(traced, route):
    res, spans = traced[route]
    assert res.n_passed > 0
    kinds = {sp.kind for sp in spans}
    assert kinds & LEAF_KINDS == ROUTES[route][2]
    kids = _children(spans)
    for sp in spans:  # fetch is the store read alone, never a parent
        if sp.kind == "fetch":
            assert sp.name == "fetch" and sp.sid not in kids
    assert {"load_window", "phase2"} <= kinds


@pytest.mark.parametrize("route", list(ROUTES))
def test_leaves_on_one_thread_never_overlap(traced, route):
    _, spans = traced[route]
    kids = _children(spans)
    childless = sorted((sp.t0, sp.t1) for sp in spans if sp.sid not in kids)
    for (_, b), (c, _) in itertools.pairwise(childless):
        assert b <= c
    # a leaf kind with children (a decode round inside decompress) holds
    # them whole: leaf-kind spans are disjoint or nested
    leaves = [sp for sp in spans if sp.kind in LEAF_KINDS]
    for x, y in itertools.combinations(leaves, 2):
        disjoint = x.t1 <= y.t0 or y.t1 <= x.t0
        nested = (x.t0 <= y.t0 and y.t1 <= x.t1) or (y.t0 <= x.t0 and x.t1 <= y.t1)
        assert disjoint or nested, (x, y)


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_leaf_lies_inside_its_query_span(traced, route):
    _, spans = traced[route]
    q = _query(spans)
    by_id = {sp.sid: sp for sp in spans}
    for sp in spans:
        if sp.kind not in LEAF_KINDS:
            continue
        assert q.t0 <= sp.t0 <= sp.t1 <= q.t1
        root = sp
        while root.parent is not None:
            root = by_id[root.parent]
        assert root is q


@pytest.mark.parametrize("route", list(ROUTES))
def test_stage_spans_sum_to_the_breakdown_exactly(traced, route):
    res, spans = traced[route]
    for kind in ("decompress", "deserialize"):
        total = sum(sp.t1 - sp.t0 for sp in spans if sp.kind == kind)
        assert total == getattr(res.breakdown, kind) > 0


@pytest.mark.parametrize("route", list(ROUTES))
def test_selection_spans_count_the_indexes_and_their_columns(traced, stores, route):
    """Each phase 2's selection builds one object index a collection
    written and gathers every jagged column of the output with it."""
    res, spans = traced[route]
    store = stores["host" if route == "host" else "device"]
    jagged = [b for b in res.output.branch_names() if store.branches[b].jagged]
    collections = {store.branches[b].counts_branch for b in jagged}
    assert collections == {"nElectron", "nMuon", "nJet"}
    by_id = {sp.sid: sp for sp in spans}
    selections = [sp for sp in spans if "jagged_indexes" in sp.attrs]
    phase2 = [sp for sp in spans if sp.kind == "phase2"]
    assert len(selections) == len(phase2) > 0
    for sp in selections:
        assert sp.kind == "deserialize" and by_id[sp.parent].kind == "phase2"
        assert sp.attrs == {"jagged_indexes": len(collections),
                            "jagged_columns": len(jagged)}


@pytest.mark.parametrize("route", ["window", "host"])
def test_an_injected_clock_times_spans_and_no_breakdown_field(stores, route):
    """The ``Breakdown`` fields read ``time.perf_counter`` whatever the
    tracer's clock: a clock that moves 1,000 s a reading moves the spans
    alone."""
    class Slow:
        def __init__(self):
            self.t = itertools.count(1)

        def now(self) -> float:
            return 1000.0 * next(self.t)

    tr = trace.Tracer(clock=Slow())
    res = _run(stores, route, tr)
    spans = tr.spans()
    for kind in ("decompress", "deserialize"):
        assert sum(sp.t1 - sp.t0 for sp in spans if sp.kind == kind) >= 1000.0
        assert 0 < getattr(res.breakdown, kind) < 1000.0
    assert 0 < res.busy_fraction <= 1


@pytest.mark.parametrize("route", list(ROUTES))
def test_query_span_ends_with_the_clock_and_the_transfers(traced, route):
    _, spans = traced[route]
    attrs = _query(spans).attrs
    assert isinstance(attrs["clock_ns"], int)
    # the CPU moves nothing between a host and a card
    assert {k: attrs[k] for k in ("h2d_bytes", "h2d_copies", "d2h_bytes", "d2h_copies")} \
        == dict.fromkeys(("h2d_bytes", "h2d_copies", "d2h_bytes", "d2h_copies"), 0)


def _result_print(res) -> tuple:
    return (res.n_passed, res.report.window_rows, res.output.manifest_hash(),
            res.output._blobs, res.stats.bytes_fetched, res.stats.requests,
            res.stats.cascade_bytes_skipped)


@pytest.mark.parametrize("route", list(ROUTES))
def test_the_result_is_identical_traced_or_not(stores, traced, route):
    want = _result_print(traced[route][0])
    for tracer in (None, trace.NULL_TRACER, trace.Tracer(detail=False)):
        assert _result_print(_run(stores, route, tracer)) == want
    assert trace.active() is trace.NULL_TRACER


def _shape(spans) -> list:
    return [(sp.sid, sp.parent, sp.name, sp.kind) for sp in spans]


def test_interleaved_generators_keep_their_own_spans():
    """Two skims advanced in turns on one thread, as the job service
    advances its jobs: each tracer holds exactly the tree it holds alone.
    (No decoded-basket LRU: its hits would change which rounds decode.)"""
    store = _store("device")
    store.decode_cache_baskets = 0
    runs = [(SkimEngine(store, device="cpu", fused_backend="torch"), QUERY),
            (SkimEngine(store, device="cpu", fused_backend="torch", device_batch=2),
             chip_smoke.zee_query(N))]
    solo = []
    for engine, query in runs:
        tr = trace.Tracer(clock=Tick())
        solo.append((_result_print(drain(engine.iter_run(query, tracer=tr))),
                     _shape(tr.spans())))
    tracers = [trace.Tracer(clock=Tick()) for _ in runs]
    gens = [engine.iter_run(query, tracer=tr) for (engine, query), tr in zip(runs, tracers)]
    results = [None, None]
    while any(r is None for r in results):
        for i, gen in enumerate(gens):
            if results[i] is not None:
                continue
            try:
                next(gen)
                assert trace.active() is trace.NULL_TRACER
            except StopIteration as stop:
                results[i] = stop.value
    for (want_result, want_shape), res, tr in zip(solo, results, tracers):
        assert _result_print(res) == want_result
        assert _shape(tr.spans()) == want_shape


def test_a_cancelled_generator_closes_its_tree_and_its_activation(stores):
    tr = trace.Tracer(clock=Tick())
    gen = SkimEngine(stores["device"], device="cpu", fused_backend="torch").iter_run(
        QUERY, tracer=tr)
    next(gen)
    gen.close()
    assert trace.active() is trace.NULL_TRACER
    q = _query(tr.spans())
    assert q.attrs["cancelled"] and q.t1 is not None


@pytest.mark.parametrize("cfg", [{}, {"cascade": False}, {"device_batch": 3}])
def test_a_tracer_without_detail_records_the_jax_tree(cfg):
    """``detail=False`` records the tree the JAX package records, byte for
    byte under one injected clock (the service's job tracers are such)."""
    jstore = j_make(N, n_hlt=8, n_filler=2, basket_events=BASKET)
    tstore = make_nanoaod_like(N, n_hlt=8, n_filler=2, basket_events=BASKET, device="cpu")
    run_kw = {k: v for k, v in cfg.items() if k != "device_batch"}
    eng_kw = {k: v for k, v in cfg.items() if k == "device_batch"}
    jtr = jtrace.Tracer(clock=Tick())
    JEngine(jstore, **eng_kw).run(QUERY, "near_data", tracer=jtr, **run_kw)
    ttr = trace.Tracer(clock=Tick(), detail=False)
    SkimEngine(tstore, device="cpu", **eng_kw).run(QUERY, "near_data", tracer=ttr, **run_kw)
    assert trace.trace_json(ttr.chrome_trace()) == jtrace.trace_json(jtr.chrome_trace())


def _noting(monkeypatch, name: str, way: str):
    """``ops.<name>`` noting one copy of 4 bytes ``way`` at each call,
    on the calling thread, as a copy to or from a card is noted."""
    fn = getattr(ops, name)

    def noted(*args, **kwargs):
        _build.note_copy(way, 4)
        return fn(*args, **kwargs)

    monkeypatch.setattr(ops, name, noted)


def test_concurrent_skims_count_only_their_own_copies():
    """Two skims' generators on two threads at once, each handing a
    worker thread work: each query's counts are its own, and the
    process-wide counts hold both."""
    start = threading.Barrier(2)
    got = {}

    def skim(n):
        for _ in range(200):
            _build.note_copy("h2d", n)
            yield
        worker = threading.Thread(target=trace.carried(lambda: _build.note_copy("d2h", n)))
        worker.start()
        worker.join()
        return trace.active_tally().counts()

    def run(n):
        start.wait()
        got[n] = drain(trace.activated(skim(n), trace.Tracer()))

    before = ops.transfer_stats()
    threads = [threading.Thread(target=run, args=(n,)) for n in (3, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for n in (3, 5):
        assert got[n] == {"h2d_copies": 200, "h2d_bytes": 200 * n,
                          "d2h_copies": 1, "d2h_bytes": n}
    after = ops.transfer_stats()
    assert {k: after[k] - before[k] for k in after} == {
        "h2d_copies": 400, "h2d_bytes": 1600, "d2h_copies": 2, "d2h_bytes": 8}
    assert trace.active_tally() is None


def test_a_prefetch_workers_copies_count_to_its_skim(monkeypatch):
    """``pipeline="threads"`` decodes in a worker thread: its copies
    count to the skim, as the same skim's do on one thread."""
    _noting(monkeypatch, "basket_decode_round", "h2d")
    store = _store("device")
    store.decode_cache_baskets = 0
    engine = SkimEngine(store, device="cpu", fused_backend="torch")
    counts = {}
    for pipeline in (True, "threads"):
        tr = trace.Tracer()
        engine.run(QUERY, "near_data", tracer=tr, pipeline=pipeline)
        attrs = _query(tr.spans()).attrs
        counts[pipeline] = (attrs["h2d_copies"], attrs["h2d_bytes"])
    assert counts["threads"] == counts[True] and counts[True][0] > 0


def test_cluster_nodes_on_threads_count_only_their_own_copies(monkeypatch):
    """Nodes skimming at once on the coordinator's threads: each node's
    ``query`` span counts what that node counts when the nodes run one
    after another, and the nodes' counts add up to the process's."""
    from repro_torch.cluster.coordinator import build_cluster

    _noting(monkeypatch, "to_host", "d2h")
    store = make_nanoaod_like(N, n_hlt=8, n_filler=2, basket_events=BASKET, device="cpu")
    counts = {}
    for concurrency in ("serial", "threads"):
        cluster = build_cluster(store, 3, device="cpu", fused_backend="torch",
                                concurrency=concurrency, replication=False)
        tr = trace.Tracer()
        before = ops.transfer_stats()
        cluster.run(QUERY, tracer=tr)
        after = ops.transfer_stats()
        nodes = sorted((sp.attrs["n_events"], sp.attrs["d2h_copies"], sp.attrs["d2h_bytes"])
                       for sp in tr.spans() if sp.kind == "query" and sp.name == "query")
        assert len(nodes) == 3
        assert sum(c for _, c, _ in nodes) == after["d2h_copies"] - before["d2h_copies"]
        counts[concurrency] = nodes
    assert counts["threads"] == counts["serial"]
    assert all(c > 0 for _, c, _ in counts["serial"])


def test_transfer_counters_count_only_copies_to_and_from_a_card():
    before = ops.transfer_stats()
    t = ops.to_device(np.arange(8, dtype=np.int32), "cpu")
    assert ops.to_host(t).tolist() == list(range(8))
    assert ops.transfer_stats() == before
    ops.reset_transfer_stats()
    assert set(ops.transfer_stats().values()) == {0}
