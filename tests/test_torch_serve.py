"""The shared scan and the metrics registry: the PyTorch port against the
JAX package, on the CPU.

Byte-identical stores (one seed) go through ``repro.serve`` and
``repro_torch.serve`` with ``device="cpu"``.  Per tenant the survivors,
every output basket byte, the fetch ledger, the report and the streamed
``BatchWindowPartial`` sequence must be equal; so must the shared pass's
ledger.  Only wall-clock fields may differ.  The port's
``fused_backend="torch"`` runs the kernels' plain PyTorch versions over
the padded layout where the JAX side runs its host interpreter, so its
dispatch counts are not compared.
"""

import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the quickstart and Z->ee queries)
import repro.cluster as jcluster  # noqa: E402
import repro.obs as j_obs  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.cluster as tcluster  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.core import run_skim as j_run_skim  # noqa: E402
from repro.data.synth import make_nanoaod_like as j_make  # noqa: E402
from repro_torch.core import SkimEngine as TEngine  # noqa: E402
from repro_torch.core import run_skim as t_run_skim  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like as t_make  # noqa: E402

N = 12_000
SHAPE = dict(n_hlt=16, n_filler=4, basket_events=2048)

QUICKSTART = chip_smoke.QUICKSTART_QUERY
ZEE = chip_smoke.zee_query(N)
NONE = {  # zero survivors
    "branches": ["Electron_*", "MET_*"],
    "selection": {"event": [
        {"type": "cut", "branch": "MET_pt", "op": ">", "value": 1e9}]},
}
EMPTY = {"branches": ["MET_*"], "selection": {}}  # a pure projection
TENANTS = [QUICKSTART, ZEE, NONE, EMPTY]
CASCADE_TENANTS = [QUICKSTART, ZEE, NONE]  # every tenant has a cascade

ALL = N // SHAPE["basket_events"] + 1  # every window in one batch
# (port-only keywords, keywords both engines take, tenants)
CONFIGS = {
    "default": ({}, {}, TENANTS),
    "torch": ({"fused_backend": "torch"}, {}, TENANTS),
    "no-cascade": ({}, {"cascade": False}, TENANTS),
    "no-prune": ({}, {"prune": False}, TENANTS),
    "unfused": ({}, {"fused": False}, TENANTS),
    "threads": ({}, {"pipeline": "threads"}, TENANTS),
    "chunk-777": ({}, {"chunk_events": 777}, TENANTS),
    "batch-1": ({}, {"device_batch": 1}, CASCADE_TENANTS),
    "batch-3": ({}, {"device_batch": 3}, CASCADE_TENANTS),
    "batch-all": ({}, {"device_batch": ALL}, CASCADE_TENANTS),
    "torch-batch-3": ({"fused_backend": "torch"}, {"device_batch": 3},
                      CASCADE_TENANTS),
    "torch-batch-3-chunk-777": ({"fused_backend": "torch"},
                                {"device_batch": 3, "chunk_events": 777},
                                CASCADE_TENANTS),
}
TIMING_KEYS = {"overlap_total", "phase_wall_s", "pipeline_total"}


@pytest.fixture(scope="module")
def stores():
    js, ts = j_make(N, **SHAPE), t_make(N, **SHAPE, device="cpu")
    assert js.manifest_hash() == ts.manifest_hash()
    return js, ts


def collect(gen):
    """Drive a streaming executor: (the yielded partials, its result)."""
    parts = []
    while True:
        try:
            parts.append(next(gen))
        except StopIteration as stop:
            return parts, stop.value


def assert_same_result(t, j, same_backend=True):
    """One tenant's SkimResult, port against JAX: survivors, every output
    byte, the fetch ledger, the report (wall-clock fields aside)."""
    assert t.n_passed == j.n_passed and t.n_input == j.n_input
    assert t.output.branch_names() == j.output.branch_names()
    assert t.output._blobs == j.output._blobs
    assert t.output.manifest_hash() == j.output.manifest_hash()
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    skip = TIMING_KEYS | (set() if same_backend else {"device_dispatches"})
    assert set(t.extras) == set(j.extras)
    for k in set(j.extras) - skip:
        assert t.extras[k] == j.extras[k], k
    if j.report is not None:
        tr, jr = t.report.as_dict(), j.report.as_dict()
        for k in set(jr) - {"overlap_total_s", "phase_wall_s",
                            "pipeline_total_s"} - (
                set() if same_backend else {"device_dispatches"}):
            assert tr[k] == jr[k], k
    assert t.plan.describe() == j.plan.describe()


def assert_same_partial(t, j):
    """A streamed window, port against JAX, every tenant's columns bit for
    bit (dtype included)."""
    assert (t.index, t.start, t.stop) == (j.index, j.start, j.stop)
    assert len(t.tenants) == len(j.tenants)
    for tp, jp in zip(t.tenants, j.tenants):
        assert (tp.index, tp.start, tp.stop, tp.n_passed, tp.decision) == (
            jp.index, jp.start, jp.stop, jp.n_passed, jp.decision)
        assert tp.jagged == jp.jagged
        assert sorted(tp.cols) == sorted(jp.cols)
        for name, arr in jp.cols.items():
            got = tp.cols[name]
            assert got.dtype == arr.dtype, name
            assert got.tobytes() == arr.tobytes(), name


def assert_same_batch(t, j, same_backend=True):
    assert t.n_queries == j.n_queries
    for tr, jr in zip(t.results, j.results):
        assert_same_result(tr, jr, same_backend)
    assert dataclasses.asdict(t.shared_stats) == dataclasses.asdict(j.shared_stats)
    assert t.naive_phase1_bytes == j.naive_phase1_bytes
    assert t.saved_bytes == j.saved_bytes
    assert t.amortization == j.amortization
    tb, jb = t.shared_breakdown.as_dict(), j.shared_breakdown.as_dict()
    assert tb["fetch"] == jb["fetch"]  # modeled from the shared ledger


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_shared_scan_matches_jax(stores, config):
    port_kw, kw, tenants = CONFIGS[config]
    js, ts = stores
    jparts, j = collect(jserve.SharedScanEngine(js, **kw).iter_batch(tenants))
    tparts, t = collect(tserve.SharedScanEngine(
        ts, device="cpu", **port_kw, **kw).iter_batch(tenants))
    assert_same_batch(t, j, same_backend="fused_backend" not in port_kw)
    assert len(tparts) == len(jparts) > 1
    for tp, jp in zip(tparts, jparts):
        assert_same_partial(tp, jp)
    n = [r.n_passed for r in t.results]
    assert 0 < n[0] < N and 0 < n[1] < N and n[2] == 0
    if len(tenants) == 4:
        assert n[3] == N  # the projection passes every event


@pytest.mark.parametrize("config", ["default", "torch", "batch-3", "chunk-777"])
def test_shared_equals_solo_run_skim(stores, config):
    """Each tenant of the port's shared scan equals the port's solo
    ``run_skim`` of its query (survivors and every output byte)."""
    port_kw, kw, tenants = CONFIGS[config]
    _, ts = stores
    batch = tserve.SharedScanEngine(ts, device="cpu", **port_kw, **kw).run_batch(
        tenants)
    solo_engine = TEngine(ts, device="cpu", **port_kw, **kw)
    for q, res in zip(tenants, batch.results):
        solo = solo_engine.run(q, "near_data")
        assert res.n_passed == solo.n_passed
        assert res.output._blobs == solo.output._blobs
    assert batch.amortization > 1


def test_cancelled_stream_stops_at_a_window(stores):
    """Closing the stream after a window ends the shared pass there, in
    both packages alike."""
    js, ts = stores
    jit = jserve.SharedScanEngine(js).iter_batch(CASCADE_TENANTS)
    tit = tserve.SharedScanEngine(ts, device="cpu").iter_batch(CASCADE_TENANTS)
    for _ in range(2):
        assert_same_partial(next(tit), next(jit))
    jit.close()
    tit.close()
    with pytest.raises(StopIteration):
        next(tit)


def test_shared_scan_validates_like_jax(stores):
    _, ts = stores
    with pytest.raises(ValueError):
        tserve.SharedScanEngine(ts, device="cpu", device_batch=0)
    with pytest.raises(ValueError):
        tserve.SharedScanEngine(ts, device="cpu", pipeline="bogus")
    with pytest.raises(ValueError):
        tserve.SharedScanEngine(ts, device="cpu", fused_backend="pallas")
    with pytest.raises(ValueError):  # the kernel needs the card
        tserve.SharedScanEngine(ts, device="cpu", fused_backend="cuda")
    eng = tserve.SharedScanEngine(ts, device="cpu")
    assert eng.fused_backend == "host" and eng.device.type == "cpu"


def test_shared_scan_without_a_card_raises(stores, monkeypatch):
    """``device=None`` means the card: with none present the engine
    raises, naming ``device="cpu"``, rather than run on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ts = stores
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.SharedScanEngine(ts)


# ---------------------------------------------------------------------------
# public names: the port mirrors the JAX modules name for name
# ---------------------------------------------------------------------------

MODULES = [
    "obs", "obs.metrics", "serve", "serve.engine", "serve.jobs",
    "serve.journal", "serve.service", "cluster", "cluster.shard",
    "cluster.retry", "cluster.node", "cluster.coordinator",
]


def _public(mod) -> set:
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    # no __all__: the public names the module itself defines
    return {
        name for name, v in vars(mod).items()
        if not name.startswith("_") and not isinstance(v, type(mod))
        and getattr(v, "__module__", mod.__name__) == mod.__name__
    }


@pytest.mark.parametrize("name", MODULES)
def test_public_names_match_jax(name):
    jm = importlib.import_module(f"repro.{name}")
    tm = importlib.import_module(f"repro_torch.{name}")
    assert hasattr(tm, "__all__") == hasattr(jm, "__all__")
    assert _public(tm) == _public(jm)
    for sym in _public(jm):
        assert hasattr(tm, sym), sym


# ---------------------------------------------------------------------------
# metrics: the registry, the unified cache report, priced/observed bytes
# ---------------------------------------------------------------------------


def _registry_script(m):
    """The MetricsRegistry cases of tests/test_obs.py, in one sequence."""
    m.inc("jobs", state="DONE")
    m.inc("jobs", state="DONE")
    m.inc("jobs", state="FAILED")
    m.set_gauge("depth", 4)
    for v in (1.0, 3.0, 0.0, 17.5, 0.25):
        m.observe("wait_s", v)
    m.observe("first_partial_s", 2.0, tenant="a")
    m.record_price_ratio("cut", 100, 50)
    m.record_price_ratio("cut", 100, 70)
    m.record_price_ratio("trigger", 0, 10)
    return {
        "counter": (m.counter("jobs", state="DONE"), m.counter("absent")),
        "gauge": (m.gauge("depth"), m.gauge("absent")),
        "hist": (m.histogram("wait_s"), m.histogram("absent")),
        "summary": m.calibration_summary(),
        "priors": (m.calibration_priors(), m.calibration_priors(min_samples=2)),
        "snapshot": m.snapshot(),
    }


def test_metrics_registry_matches_jax():
    t = _registry_script(tobs.MetricsRegistry())
    j = _registry_script(j_obs.MetricsRegistry())
    assert t == j
    assert t["snapshot"]["counters"]["jobs{state=DONE}"] == 2
    assert t["priors"][1] == {"cut": pytest.approx(0.6)}


def test_unified_cache_report_matches_jax():
    def report(make, obs, cluster, **kw):
        st = make(4_000, n_hlt=4, basket_events=1024, **kw)
        st.read_flat("MET_pt")
        st.read_flat("MET_pt")  # the second read hits
        st.read_jagged("Electron_pt")
        cache = cluster.SkimResultCache()
        cache.get("absent")
        m = obs.MetricsRegistry()
        rep = obs.collect_cache_metrics(m, store=st, result_cache=cache)
        return rep, m.snapshot(), obs.unified_cache_report(store=st)

    t = report(t_make, tobs, tcluster, device="cpu")
    j = report(j_make, j_obs, jcluster)
    assert t == j
    assert t[0]["decode"]["hits"] > 0 and t[0]["result"]["misses"] == 1


@pytest.mark.parametrize("qname", ["quickstart", "zee", "none"])
def test_priced_and_observed_stage_bytes_match_jax(stores, qname):
    q = {"quickstart": QUICKSTART, "zee": ZEE, "none": NONE}[qname]
    js, ts = stores
    jest = jserve.price_query(q, js)
    t_est = tserve.price_query(q, ts)
    assert dataclasses.asdict(t_est) == dataclasses.asdict(jest)
    assert tobs.priced_stage_bytes(t_est) == j_obs.priced_stage_bytes(jest)
    jr = j_run_skim(js, q)
    tr = t_run_skim(ts, q, device="cpu")
    assert tobs.observed_stage_bytes(tr) == j_obs.observed_stage_bytes(jr)
    assert tobs.observed_phase2_bytes(tr) == j_obs.observed_phase2_bytes(jr)
    # a cluster result sums its shards' responses
    jc = jcluster.build_cluster(js, 2, replication=False).run(q)
    tc = tcluster.build_cluster(ts, 2, replication=False, device="cpu").run(q)
    assert tobs.observed_stage_bytes(tc) == j_obs.observed_stage_bytes(jc)
    assert tobs.observed_phase2_bytes(tc) == j_obs.observed_phase2_bytes(jc)
    # shared-scan tenants report no phase split
    tb = tserve.SharedScanEngine(ts, device="cpu").run_batch([q])
    assert tobs.observed_phase2_bytes(tb.results[0]) is None
    np.testing.assert_equal(tobs.observed_stage_bytes(tb.results[0]),
                            j_obs.observed_stage_bytes(
                                jserve.SharedScanEngine(js).run_batch([q]).results[0]))
