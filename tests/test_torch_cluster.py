"""The cluster (shard, retry, node, coordinator): the PyTorch port against
the JAX package, on the CPU.

Byte-identical stores (one seed) are partitioned and served by
``repro.cluster`` and ``repro_torch.cluster`` (nodes with
``device="cpu"``).  Shard manifests, the merged output (every basket
byte), the per-shard responses and ledgers, the retry/hedge/corruption
ledgers and degradation manifests must be equal; only values measured on
the wall clock may differ.  Hedge outcomes are decided by an injected
straggle many times any measured time, so no test races two measured
times.  The chaos sweep replays the 18 seeds of ``tests/test_chaos.py``
(schedules from ``tests/chaos.py``) on both packages.
"""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import repro.cluster as jcluster  # noqa: E402
import repro.obs as j_obs  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.cluster as tcluster  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.data.synth import make_nanoaod_like as j_make  # noqa: E402
from repro_torch.core import run_skim as t_run_skim  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like as t_make  # noqa: E402
from tests.chaos import draw_schedule  # noqa: E402
from tests.test_chaos import CHAOS_SEEDS  # noqa: E402
from tests.test_query import QUERY  # noqa: E402
from tests.test_service import QUERY_B  # noqa: E402
from tests.test_torch_service import scrub  # noqa: E402  (wall-clock keys out)

N_EVENTS = 10_000
BASKET = 2048


class Side:
    """One package's cluster stack over its own copy of the store."""

    def __init__(self, cluster, serve, obs, store, **node_kw):
        self.cluster, self.serve, self.obs = cluster, serve, obs
        self.store = store
        self.node_kw = node_kw  # the port's device="cpu"

    def build(self, n=3, **kw):
        return self.cluster.build_cluster(self.store, n, **kw, **self.node_kw)

    def coord(self, shards=None, replication=True, replica_base=100,
              prune=True, cascade=True, **kw):
        """A coordinator over hand-placed nodes, as the JAX tests build it."""
        shards = shards or self.cluster.partition_store(self.store, 3)
        node = self.cluster.StorageNode
        nodes = [node(sh, prune=prune, cascade=cascade, **self.node_kw)
                 for sh in shards]
        replicas = {
            sh.shard_id: node(sh, node_id=replica_base + sh.shard_id,
                              prune=prune, cascade=cascade, **self.node_kw)
            for sh in shards
        } if replication else {}
        return self.cluster.ClusterCoordinator(
            nodes, replicas=replicas, basket_events=self.store.basket_events,
            codec=self.store.codec, prune=prune, **kw)


@pytest.fixture(scope="module")
def sides():
    js = j_make(N_EVENTS, n_hlt=16, n_filler=8, basket_events=BASKET)
    ts = t_make(N_EVENTS, n_hlt=16, n_filler=8, basket_events=BASKET, device="cpu")
    assert js.manifest_hash() == ts.manifest_hash()
    return (Side(jcluster, jserve, j_obs, js),
            Side(tcluster, tserve, tobs, ts, device="cpu"))


def result_print(res) -> dict:
    """A SkimResult: survivors, every output byte, ledgers, report."""
    return {
        "n": (res.n_input, res.n_passed),
        "manifest": res.output.manifest_hash(),
        "blobs": res.output._blobs,
        "stats": dataclasses.asdict(res.stats),
        "extras": res.extras,
    }


def cluster_print(res) -> dict:
    """A merged cluster result and every shard response behind it."""
    out = {
        "type": type(res).__name__,
        **result_print(res),
        "retries": list(res.retries),
        "cache_hits": res.cache_hits,
        "pruned": res.pruned_shards,
        "degraded": res.degraded,
        "responses": [
            {"node": r.node_id, "shard": r.shard_id, "windows": r.window_ids,
             "cached": r.cached, "pruned": r.pruned, "straggle": r.straggle_s,
             "traced": r.trace is not None, **result_print(r.result)}
            for r in res.responses
        ],
    }
    if res.degraded:
        out["errors"] = [dataclasses.asdict(e) for e in res.errors]
        out["missing"] = res.missing_windows
    return out


def node_print(coord) -> dict:
    return {
        "served": [n.requests_served for n in coord.nodes],
        "replicas": {k: n.requests_served for k, n in coord.replicas.items()},
        "quarantine": [sorted(n.quarantine) for n in coord.nodes],
    }


def _same(t, j):
    assert scrub(t) == scrub(j)


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------


def shard_print(sh) -> dict:
    return {
        "id": sh.shard_id, "windows": sh.window_ids, "spans": sh.spans,
        "window_events": sh.window_events, "manifest_hash": sh.manifest_hash,
        "comp_bytes": sh.comp_bytes, "n_events": sh.n_events,
        "blobs": sh.store._blobs,
        "manifest": {b: [dataclasses.asdict(m) for m in ms]
                     for b, ms in sh.manifest().items()},
    }


@pytest.mark.parametrize("n_nodes", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("policy", ["round_robin", "size_balanced"])
def test_partition_store_matches_jax(sides, policy, n_nodes):
    jside, tside = sides
    js = jcluster.partition_store(jside.store, n_nodes, policy=policy)
    ts = tcluster.partition_store(tside.store, n_nodes, policy=policy)
    assert [shard_print(s) for s in ts] == [shard_print(s) for s in js]
    assert all(s.store.device == "cpu" for s in ts)  # the store's device
    jm = jcluster.ShardMap.build(js, jside.store.n_events)
    tm = tcluster.ShardMap.build(ts, tside.store.n_events)
    assert (tm.window_events, tm.n_events, tm.owner) == (
        jm.window_events, jm.n_events, jm.owner)


def test_partition_rejects_like_jax(sides):
    jside, tside = sides
    for args in ((0,), (3, "bogus"), (3, "round_robin", 1000)):
        with pytest.raises(ValueError) as je:
            jcluster.partition_store(jside.store, *args)
        with pytest.raises(ValueError) as te:
            tcluster.partition_store(tside.store, *args)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# scatter-gather
# ---------------------------------------------------------------------------

BUILDS = {
    "serial-3": (3, {}),
    "threads-3": (3, {"concurrency": "threads"}),
    "serial-1": (1, {}),
    "threads-5": (5, {"concurrency": "threads"}),
    "size-balanced-2": (2, {"policy": "size_balanced"}),
    "no-prune-no-cascade": (3, {"prune": False, "cascade": False}),
    "batch-3": (3, {"device_batch": 3}),
    "threads-batch-2": (3, {"device_batch": 2, "concurrency": "threads"}),
    "torch-batch-3": (3, {"device_batch": 3, "port": {"fused_backend": "torch"}}),
}


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_build_cluster_matches_jax(sides, build):
    n, kw = BUILDS[build]
    kw = dict(kw)
    port_kw = kw.pop("port", {})
    jside, tside = sides
    jc, tc = jside.build(n, **kw), tside.build(n, **kw, **port_kw)
    for q in (QUERY, QUERY_B):
        j, t = jc.run(q), tc.run(q)
        tp, jp = cluster_print(t), cluster_print(j)
        # dispatches are compared where both run one backend serially: the
        # JAX side's host interpreter notes none where the port's "torch"
        # does, and a node's count is a delta of the process-wide ledger,
        # which concurrent nodes add to in threads mode (in both packages)
        if port_kw or kw.get("concurrency") == "threads":
            for doc in [tp, jp] + tp["responses"] + jp["responses"]:
                doc["extras"] = {k: v for k, v in doc["extras"].items()
                                 if k != "device_dispatches"}
        _same(tp, jp)
        solo = t_run_skim(tside.store, q, device="cpu")
        assert t.n_passed == solo.n_passed
        assert t.output.manifest_hash() == solo.output.manifest_hash()
    _same(node_print(tc), node_print(jc))


def test_cluster_batch_matches_jax(sides):
    jside, tside = sides
    jc, tc = jside.build(3), tside.build(3)
    j = jc.run_batch([QUERY, QUERY_B, QUERY])
    t = tc.run_batch([QUERY, QUERY_B, QUERY])
    _same([cluster_print(r) for r in t.results],
          [cluster_print(r) for r in j.results])
    assert (t.shared_phase1_bytes, t.naive_phase1_bytes, t.cached_tenants) == (
        j.shared_phase1_bytes, j.naive_phase1_bytes, j.cached_tenants)
    assert t.amortization == j.amortization > 1


def test_warm_cache_matches_jax(sides):
    jside, tside = sides
    runs = {}
    for side in (jside, tside):
        cache = side.cluster.SkimResultCache()
        coord = side.build(3, cache=cache, concurrency="threads")
        cold = coord.run(QUERY)
        coord.nodes[0].inject_fault("fail")  # a warm cache never asks it
        warm = coord.run(QUERY)
        runs[side] = (cluster_print(cold), cluster_print(warm),
                      dataclasses.asdict(cache.stats), len(cache),
                      node_print(coord))
    _same(runs[tside], runs[jside])
    assert runs[tside][1]["cache_hits"] == 3


# ---------------------------------------------------------------------------
# faults: replica retry, corruption, straggle, degradation, hedging
# ---------------------------------------------------------------------------


def fx_fail_replica(side):
    m = side.obs.MetricsRegistry()
    coord = side.coord(metrics=m)
    coord.nodes[1].inject_fault("fail")
    return coord, coord.run(QUERY), m


def fx_corrupt_quarantine(side):
    m = side.obs.MetricsRegistry()
    coord = side.coord(prune=False, cascade=False, metrics=m)
    coord.nodes[1].inject_fault("corrupt")
    return coord, coord.run(QUERY), m


def fx_corrupt_branch_basket(side):
    coord = side.coord(prune=False, cascade=False, concurrency="threads")
    coord.nodes[2].inject_fault("corrupt", branch="Muon_pt", basket=1)
    return coord, coord.run(QUERY), None


def fx_straggle(side):
    m = side.obs.MetricsRegistry()
    coord = side.coord(replication=False, metrics=m)
    coord.nodes[0].inject_fault("straggle", delay_s=42.0)
    return coord, coord.run(QUERY), m


def fx_retry_budget(side):
    coord = side.coord(retry_policy=side.cluster.RetryPolicy(budget=2, seed=3))
    coord.nodes[1].inject_fault("fail", n=2)
    coord.replicas[1].inject_fault("fail", n=1)
    return coord, coord.run(QUERY), None


def fx_degraded(side):
    m = side.obs.MetricsRegistry()
    coord = side.coord(replication=False, metrics=m)
    coord.nodes[1].inject_fault("fail")
    return coord, coord.run(QUERY, allow_partial=True), m


def fx_degraded_batch_member(side):
    coord = side.coord(replication=False, allow_partial=True,
                       prune=False, cascade=False)
    coord.nodes[0].inject_fault("corrupt")
    coord.nodes[2].inject_fault("fail")
    return coord, coord.run(QUERY_B), None


# A straggle of 1,000 modeled seconds (any measured time here is well
# under one second) decides each race: with a 1 s hedge delay the
# replica finishes at about 1 s and wins; with a 900 s delay it finishes
# at about 900 s, not under 0.75 of the primary's ~1,000 s, and loses; a
# replica that fails cancels the hedge.
def fx_hedge_won(side):
    m = side.obs.MetricsRegistry()
    coord = side.coord(hedge=side.cluster.HedgePolicy(delay_s=1.0), metrics=m)
    coord.nodes[1].inject_fault("straggle", delay_s=1000.0)
    return coord, coord.run(QUERY), m


def fx_hedge_lost(side):
    m = side.obs.MetricsRegistry()
    coord = side.coord(hedge=side.cluster.HedgePolicy(delay_s=900.0), metrics=m)
    coord.nodes[1].inject_fault("straggle", delay_s=1000.0)
    return coord, coord.run(QUERY), m


def fx_hedge_cancelled(side):
    m = side.obs.MetricsRegistry()
    coord = side.coord(hedge=side.cluster.HedgePolicy(delay_s=1.0), metrics=m)
    coord.nodes[1].inject_fault("straggle", delay_s=1000.0)
    coord.replicas[1].inject_fault("fail")
    return coord, coord.run(QUERY), m


FAULTS = {name[3:]: fn for name, fn in globals().items() if name.startswith("fx_")}
HEDGE_OUTCOMES = {"hedge_won": (1, 0, 0), "hedge_lost": (0, 1, 0),
                  "hedge_cancelled": (0, 0, 1)}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_fault_matches_jax(sides, name):
    jside, tside = sides
    out = {}
    for side in (jside, tside):
        coord, res, metrics = FAULTS[name](side)
        out[side] = (cluster_print(res), node_print(coord),
                     metrics.snapshot() if metrics is not None else None)
    _same(out[tside], out[jside])
    res = out[tside][0]
    if name in HEDGE_OUTCOMES:
        ex = res["extras"]
        assert (ex["hedges_won"], ex["hedges_lost"],
                ex["hedges_cancelled"]) == HEDGE_OUTCOMES[name]
    if not res["degraded"]:
        solo = t_run_skim(tside.store, QUERY_B if "batch" in name else QUERY,
                          device="cpu")
        assert res["manifest"] == solo.output.manifest_hash()


@pytest.mark.parametrize("case", ["no-replica", "both-fail", "corrupt-no-replica",
                                  "every-shard"])
def test_terminal_faults_match_jax(sides, case):
    jside, tside = sides
    msgs = {}
    for side in (jside, tside):
        if case == "no-replica":
            coord = side.coord(replication=False)
            coord.nodes[1].inject_fault("fail")
            run = lambda c=coord: c.run(QUERY)  # noqa: E731
        elif case == "both-fail":
            coord = side.coord(retry_policy=side.cluster.RetryPolicy(budget=2))
            coord.nodes[1].inject_fault("fail", n=3)
            coord.replicas[1].inject_fault("fail", n=2)
            run = lambda c=coord: c.run(QUERY)  # noqa: E731
        elif case == "corrupt-no-replica":
            coord = side.coord(replication=False, prune=False, cascade=False)
            coord.nodes[0].inject_fault("corrupt")
            run = lambda c=coord: c.run(QUERY)  # noqa: E731
        else:
            coord = side.coord(replication=False, prune=False, cascade=False)
            for node in coord.nodes:
                node.inject_fault("fail")
            run = lambda c=coord: c.run(QUERY, allow_partial=True)  # noqa: E731
        with pytest.raises(side.cluster.ClusterError) as exc:
            run()
        msgs[side] = (type(exc.value).__name__, str(exc.value),
                      getattr(exc.value, "kind", None), node_print(coord))
    assert msgs[tside] == msgs[jside]


def test_cluster_without_a_card_raises(sides, monkeypatch):
    """Nodes built with ``device=None`` mean the card: with none present
    they raise, naming ``device="cpu"``."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tside = sides
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcluster.build_cluster(tside.store, 2)


def test_service_over_cluster_matches_jax(sides):
    jside, tside = sides
    out = {}
    for side in (jside, tside):
        svc = side.serve.SkimService(side.serve.ClusterBackend(side.build(3)),
                                     clock=side.serve.ManualClock())
        job = svc.submit(QUERY_B, "t")
        svc.run_until_idle()
        out[side] = (job.state, [(p.start, p.stop, p.n_passed, p.meta)
                                 for p in job.partials],
                     cluster_print(job.result))
    _same(out[tside], out[jside])
    assert out[tside][0] == "DONE"


# ---------------------------------------------------------------------------
# the chaos sweep of tests/test_chaos.py, on both packages
# ---------------------------------------------------------------------------


def _chaos_cluster(side, schedule):
    """tests/chaos.py's cluster for ``schedule``, in ``side``'s package."""
    replicated = schedule.scenario != "degraded"
    shards = side.cluster.partition_store(side.store, 3)
    coord = side.coord(
        shards, replication=replicated, prune=False, cascade=False,
        concurrency="serial",
        retry_policy=side.cluster.RetryPolicy(seed=schedule.seed),
        allow_partial=not replicated,
    )
    for node_idx, kind, delay in schedule.faults:
        coord.nodes[node_idx].inject_fault(kind, delay_s=delay)
    return coord


def _chaos_crash(side, schedule):
    """tests/chaos.py's journaled crash-restart, in ``side``'s package."""
    serve = side.serve

    def service(**kw):
        return serve.SkimService(serve.EngineBackend(side.store, **side.node_kw),
                                 clock=serve.ManualClock(), **kw)

    ref_svc = service(journal=serve.JobJournal())
    ref_job = ref_svc.result(ref_svc.submit(QUERY, tenant="chaos").job_id)
    journal = serve.JobJournal()
    svc = service(journal=journal)
    job = svc.submit(QUERY, tenant="chaos")
    streamed, skips = 0, []
    for point in schedule.crash_points:
        streamed += point
        while len(job.partials) < point:
            assert svc.step(), "service stalled before the crash point"
        svc = serve.SkimService.recover(
            journal, serve.EngineBackend(side.store, **side.node_kw),
            clock=serve.ManualClock())
        job = svc.jobs[job.job_id]
        skips.append(job.resume_skip)
    done = svc.result(job.job_id)
    assert done.state == "DONE"
    assert done.windows_streamed() == ref_job.windows_streamed()[streamed:]
    assert done.result.output.manifest_hash() == ref_job.result.output.manifest_hash()
    return {"skips": skips, "streamed": done.windows_streamed(),
            "n": [p.n_passed for p in done.partials],
            "manifest": done.result.output.manifest_hash(),
            "journal": journal.records()}


def run_chaos(side, seed):
    schedule = draw_schedule(seed)
    if schedule.scenario == "crash":
        return schedule.describe(), _chaos_crash(side, schedule)
    coord = _chaos_cluster(side, schedule)
    res = coord.run(QUERY)
    return schedule.describe(), (cluster_print(res), node_print(coord))


@pytest.mark.chaos
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_seed_matches_jax(sides, seed):
    jside, tside = sides
    j, t = run_chaos(jside, seed), run_chaos(tside, seed)
    _same(t, j)
    schedule = draw_schedule(seed)
    if schedule.scenario == "crash":
        return
    res = t[1][0]
    solo = t_run_skim(tside.store, QUERY, device="cpu")
    if schedule.scenario == "degraded":
        # an explicit degradation naming exactly the failed shards' windows
        assert res["degraded"]
        assert sorted(e["shard_id"] for e in res["errors"]) == sorted(
            n for n, _, _ in schedule.faults)
    else:
        assert not res["degraded"]
        assert res["manifest"] == solo.output.manifest_hash()
        recoverable = [f for f in schedule.faults if f[1] in ("fail", "corrupt")]
        assert len(res["retries"]) == len(recoverable)
