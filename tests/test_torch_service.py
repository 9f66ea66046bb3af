"""The job service (jobs, journal, service): the PyTorch port against the
JAX package, on the CPU.

Each scenario drives ``repro.serve.SkimService`` and
``repro_torch.serve.SkimService`` over byte-identical stores (one seed),
the port's backends with ``device="cpu"``, under an injected
:class:`ManualClock`, and compares everything the service knows: every
job's state, cause, priced estimate, timestamps, fair-queue keys and
streamed partials (columns bit for bit), the result's output bytes and
fetch ledger, the replay trace of the :class:`DeterministicExecutor`,
the metrics snapshot, tenant accounting, journal records and the
exported Chrome trace (byte for byte).  Nothing here reads a wall clock.
"""

import dataclasses
import json
import random
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import repro.cluster as jcluster  # noqa: E402
import repro.obs as jobs_obs  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.cluster as tcluster  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.data.synth import make_nanoaod_like as j_make  # noqa: E402
from repro_torch.core import SkimEngine as TEngine  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like as t_make  # noqa: E402
from tests import test_service_props as props  # noqa: E402
from tests.test_query import QUERY  # noqa: E402
from tests.test_service import QUERY_B  # noqa: E402
from tools.skimlint import lint_paths  # noqa: E402

N_EVENTS = 10_000
BASKET = 2048

CHEAP = {
    "input": "in.skim",
    "output": "out.skim",
    "branches": ["nMuon"],
    "selection": {"preselection": [{"branch": "nMuon", "op": ">=", "value": 100}]},
}
MALFORMED = {
    "branches": ["event"],
    "selection": {"preselection": [{"branch": "NoSuchBranch", "op": ">", "value": 1}]},
}


class Side:
    """One package's service stack over its own copy of the store."""

    def __init__(self, serve, cluster, obs, store, **engine_kw):
        self.serve, self.cluster, self.obs = serve, cluster, obs
        self.store = store
        self.engine_kw = engine_kw  # the port's device="cpu"

    def backend(self, store=None):
        return self.serve.EngineBackend(store or self.store, **self.engine_kw)

    def service(self, store=None, **kw):
        kw.setdefault("clock", self.serve.ManualClock())
        return self.serve.SkimService(self.backend(store), **kw)

    def recover(self, journal, store=None, **kw):
        return self.serve.SkimService.recover(journal, self.backend(store), **kw)

    def build_cluster(self, n, **kw):
        return self.cluster.build_cluster(self.store, n, **kw, **self.engine_kw)


def _sides(n_events, basket):
    js = j_make(n_events, n_hlt=16, n_filler=8, basket_events=basket)
    ts = t_make(n_events, n_hlt=16, n_filler=8, basket_events=basket, device="cpu")
    assert js.manifest_hash() == ts.manifest_hash()
    return (Side(jserve, jcluster, jobs_obs, js),
            Side(tserve, tcluster, tobs, ts, device="cpu"))


@pytest.fixture(scope="module")
def sides():
    return _sides(N_EVENTS, BASKET)


@pytest.fixture(scope="module")
def prop_sides():
    return _sides(props.N_EVENTS, props.BASKET)


def _cols(cols: dict) -> dict:
    return {k: (v.dtype.str, v.shape, v.tobytes()) for k, v in sorted(cols.items())}


def _result(res):
    if res is None:
        return None
    return {
        "n_passed": res.n_passed, "n_input": res.n_input,
        "manifest": res.output.manifest_hash(),
        "blobs": res.output._blobs,
        "stats": dataclasses.asdict(res.stats),
    }


def job_print(job) -> dict:
    """Everything the service records for a job (no wall-clock value)."""
    return {
        "id": job.job_id, "tenant": job.tenant, "state": job.state,
        "error": job.error, "cancel": job.cancel_requested,
        "estimate": dataclasses.asdict(job.estimate) if job.estimate else None,
        "times": (job.submitted_at, job.started_at, job.finished_at),
        "vfinish": job.vfinish, "seq": job.seq, "resume_skip": job.resume_skip,
        "partials": [
            (p.job_id, p.seq, p.start, p.stop, p.n_passed, _cols(p.cols),
             p.jagged, p.meta)
            for p in job.partials
        ],
        "union": (lambda cols, jagged: (_cols(cols), jagged))(*job_union(job)),
        "result": _result(job.result),
    }


def job_union(job):
    """The job's streamed union, by its own package's ``union_columns``."""
    port = type(job).__module__.startswith("repro_torch.")
    return (tserve if port else jserve).union_columns(job)


def service_print(svc) -> dict:
    tenants = sorted({j.tenant for j in svc.jobs.values()})
    out = {
        "jobs": [job_print(svc.jobs[k]) for k in sorted(svc.jobs)],
        "trace": list(svc.trace),
        "quanta": svc.executor.quanta,
        "metrics": svc.metrics.snapshot(),
        "calibration": svc.calibration_summary(),
        "usage": {t: svc.tenant_usage(t) for t in tenants},
        "queue_depth": svc.queue_depth(),
        "describe": svc.describe(),
    }
    if svc.journal is not None:
        out["journal"] = svc.journal.records()
    return out


# ---------------------------------------------------------------------------
# scenarios: each drives one side and returns what to compare
# ---------------------------------------------------------------------------


def sc_lifecycle(side):
    clock = side.serve.ManualClock()
    svc = side.service(clock=clock)
    clock.advance(5.0)
    job = svc.submit(QUERY, tenant="alice")
    states = [job.state]
    clock.advance(1.0)
    svc.step()
    states.append(job.state)
    clock.advance(2.0)
    svc.run_until_idle()
    states.append(job.state)
    return {"states": states, "svc": service_print(svc)}


def sc_stream(side):
    svc = side.service()
    job = svc.submit(QUERY)
    parts = list(svc.stream(job.job_id))
    return {"n": len(parts), "svc": service_print(svc)}


def sc_fifo_and_fairness(side):
    svc = side.service(quotas={"w": side.serve.TenantQuota(weight=4.0)})
    svc.submit(QUERY, "heavy")
    svc.submit(QUERY, "heavy")
    svc.submit(CHEAP, "light")
    svc.submit(QUERY_B, "w")
    svc.submit(QUERY, "t")
    svc.submit(QUERY, "t")
    svc.run_until_idle()
    return service_print(svc)


def sc_quotas(side):
    svc = side.service(quotas={
        "bob": side.serve.TenantQuota(byte_budget=10.0),
        "slow": side.serve.TenantQuota(wall_budget_s=1e-9),
    })
    svc.submit(QUERY, "bob")
    svc.submit(QUERY, "slow")
    svc.submit(MALFORMED, "x")
    stepped = svc.step()
    return {"stepped": stepped, "svc": service_print(svc)}


def sc_observed_spend(side):
    ref = side.service()
    ref.result(ref.submit(QUERY, "t").job_id)
    budget = ref.jobs[1].result.stats.bytes_fetched * 1.2
    svc = side.service(quotas={"t": side.serve.TenantQuota(byte_budget=budget)})
    svc.submit(QUERY, "t")
    svc.run_until_idle()
    svc.submit(QUERY, "t")  # spent + the new estimate is over the budget
    return service_print(svc)


def sc_cancel(side):
    svc = side.service()
    svc.submit(QUERY, "a")
    j2 = svc.submit(QUERY, "b")
    j3 = svc.submit(QUERY_B, "c")
    first = svc.cancel(j2.job_id)  # before it runs
    stream = svc.stream(j3.job_id)
    got = [next(stream), next(stream)]
    svc.cancel(j3.job_id)  # mid-stream
    rest = list(stream)
    svc.run_until_idle()
    again = svc.cancel(j2.job_id)  # already terminal
    return {"first": first, "again": again, "got": len(got), "rest": rest,
            "idle": svc.step(), "svc": service_print(svc)}


def sc_batching(side):
    svc = side.service(batching=True)
    svc.submit(QUERY, "a")
    svc.submit(QUERY_B, "b")
    svc.submit(QUERY, "c")
    svc.run_until_idle()
    return service_print(svc)


def sc_batch_member_cancel(side):
    svc = side.service(batching=True)
    svc.submit(QUERY, "a")
    j2 = svc.submit(QUERY_B, "b")
    svc.step()
    svc.cancel(j2.job_id)
    svc.run_until_idle()
    return service_print(svc)


def sc_calibration(side):
    svc = side.service(calibrate=True, tracing=True)
    svc.submit(QUERY, "a")
    svc.run_until_idle()
    svc.submit(QUERY, "a")  # priced through the settled job's priors
    svc.submit(QUERY_B, "b")
    svc.run_until_idle()
    return {"priors": svc.metrics.calibration_priors(), "svc": service_print(svc)}


def sc_traced_drain(side):
    svc = side.service(tracing=True, calibrate=True)
    for i in range(4):
        svc.submit(QUERY, tenant=f"t{i % 2}")
    svc.submit(MALFORMED, "t9")
    svc.run_until_idle()
    return {"trace": side.obs.trace_json(svc.export_trace()),
            "svc": service_print(svc)}


def sc_traced_batch(side):
    svc = side.service(tracing=True, batching=True)
    for i in range(3):
        svc.submit(QUERY if i != 1 else QUERY_B, tenant=f"t{i}")
    svc.run_until_idle()
    return {"trace": side.obs.trace_json(svc.export_trace()),
            "svc": service_print(svc)}


def sc_cluster_backend(side):
    svc = side.serve.SkimService(
        side.serve.ClusterBackend(side.build_cluster(3)),
        clock=side.serve.ManualClock(), tracing=True)
    svc.submit(QUERY, "a")
    svc.submit(QUERY_B, "b")
    svc.run_until_idle()
    return {"trace": side.obs.trace_json(svc.export_trace()),
            "svc": service_print(svc)}


def sc_cluster_fault(side):
    coord = side.build_cluster(3, replication=False)
    coord.nodes[1].inject_fault("fail")  # only the first job meets it
    svc = side.serve.SkimService(side.serve.ClusterBackend(coord),
                                 clock=side.serve.ManualClock())
    svc.submit(QUERY, "a")
    svc.submit(QUERY, "b")
    svc.run_until_idle()
    return service_print(svc)


def sc_journal(side):
    svc = side.service(journal=side.serve.JobJournal(), batching=True)
    svc.submit(QUERY, "a")
    svc.submit(QUERY_B, "b")
    j3 = svc.submit(QUERY, "c")
    svc.step()
    svc.cancel(j3.job_id)
    svc.run_until_idle()
    return service_print(svc)


def _crash_after(side, journal, n_windows, **kw):
    svc = side.service(journal=journal, **kw)
    job = svc.submit(QUERY, tenant="t")
    while len(job.partials) < n_windows:
        assert svc.step()
    return svc, job


def sc_recover(side):
    journal = side.serve.JobJournal()
    crashed_svc, crashed = _crash_after(side, journal, 2)
    before = service_print(crashed_svc)
    metrics = side.obs.MetricsRegistry()
    svc2 = side.recover(journal, metrics=metrics, tracing=True,
                        clock=side.serve.ManualClock())
    job2 = svc2.jobs[crashed.job_id]
    done = svc2.result(job2.job_id)
    newer = svc2.submit(QUERY, tenant="u")  # ids continue after recovery
    svc2.run_until_idle()
    return {"before": before, "resume": job2.resume_skip, "state": done.state,
            "newer": newer.job_id,
            "trace": side.obs.trace_json(svc2.export_trace()),
            "svc": service_print(svc2)}


def sc_recover_twice(side):
    journal = side.serve.JobJournal()
    _, crashed = _crash_after(side, journal, 1)
    svc2 = side.recover(journal, clock=side.serve.ManualClock())
    job2 = svc2.jobs[crashed.job_id]
    while len(job2.partials) < 1:
        assert svc2.step()
    svc3 = side.recover(journal, clock=side.serve.ManualClock())
    svc3.result(crashed.job_id)
    return service_print(svc3)


def sc_recover_mixed(side):
    journal = side.serve.JobJournal()
    quotas = {"t": side.serve.TenantQuota(byte_budget=10**12),
              "broke": side.serve.TenantQuota(byte_budget=1)}
    svc = side.service(journal=journal, quotas=quotas)
    svc.result(svc.submit(QUERY, tenant="t").job_id)
    svc.submit(QUERY, tenant="broke")
    svc.submit(QUERY, tenant="t")
    before = service_print(svc)
    svc2 = side.recover(journal, quotas=quotas, clock=side.serve.ManualClock())
    mid = service_print(svc2)
    svc2.run_until_idle()
    return {"before": before, "mid": mid, "svc": service_print(svc2)}


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


#: values measured on the wall clock: a settled job's or a node's
#: modeled seconds (its measured compute included), a tenant's spend of
#: them, the coordinator's merge and gather times, a run's pipeline times
WALL_KEYS = {"spent_wall_s", "modeled_s", "merge_s", "wall_s", "modeled_total_s",
             "pipeline_total", "overlap_total", "phase_wall_s"}


def scrub(x):
    """``x`` with every wall-clock value replaced by None."""
    if isinstance(x, dict):
        return {k: None if k in WALL_KEYS else scrub(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(scrub(v) for v in x)
    return x


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_service_scenario_matches_jax(sides, name):
    jside, tside = sides
    j = SCENARIOS[name](jside)
    t = SCENARIOS[name](tside)
    if isinstance(j.get("trace"), str):
        if "merge_s" not in j["trace"]:
            # under the ManualClock the export holds no wall-clock value:
            # byte for byte (a cluster job's spans carry merge_s)
            assert t["trace"] == j["trace"]
        j["trace"], t["trace"] = json.loads(j["trace"]), json.loads(t["trace"])
    assert scrub(t) == scrub(j)


def test_scenarios_reach_every_state(sides):
    """The scenarios above are not vacuous: the port's jobs end in every
    terminal state, and a streamed union equals the port's solo run."""
    _, tside = sides
    seen = set()
    for name in ("quotas", "cancel", "cluster_fault"):
        seen |= {j["state"] for j in _jobs(SCENARIOS[name](tside))}
    assert seen == {"DONE", "REJECTED", "CANCELLED", "FAILED"}
    svc = tside.service()
    job = svc.submit(QUERY)
    svc.run_until_idle()
    solo = TEngine(tside.store, device="cpu").run(QUERY, "near_data")
    cols, _ = tserve.union_columns(job)
    assert job.n_passed == solo.n_passed > 0
    for name in solo.output.branch_names():
        br = solo.output.branches[name]
        want = (solo.output.read_jagged(name)[0] if br.jagged
                else solo.output.read_flat(name))
        assert cols[name].tobytes() == want.tobytes(), name


def _jobs(doc):
    svc = doc["svc"] if "svc" in doc else doc
    return svc["jobs"]


def test_traced_export_parses_and_holds_the_span_kinds(sides):
    _, tside = sides
    doc = json.loads(sc_traced_drain(tside)["trace"])
    kinds = {e.get("cat") for e in doc["traceEvents"]}
    assert {"job", "admission", "queue", "query", "window", "fetch",
            "decode", "settle"} <= kinds


def test_service_without_a_card_raises(sides, monkeypatch):
    """A bare store means an ``EngineBackend`` on the card: with none
    present the service raises, naming ``device="cpu"``."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tside = sides
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.SkimService(tside.store)
    backend = tserve.EngineBackend(tside.store, device="cpu")
    assert backend.shared.device.type == "cpu"
    assert backend.shared.fused_backend == backend.engine.fused_backend == "host"


# ---------------------------------------------------------------------------
# admission prices
# ---------------------------------------------------------------------------

CALIBRATIONS = {"none": None, "scaled": {"cut": 0.5, "trigger": 2.0, "total": 1.5}}


@pytest.mark.parametrize("calib", sorted(CALIBRATIONS))
@pytest.mark.parametrize("qname", ["query", "query_b", "cheap"])
def test_price_query_matches_jax(sides, qname, calib):
    q = {"query": QUERY, "query_b": QUERY_B, "cheap": CHEAP}[qname]
    jside, tside = sides
    kw = dict(calibration=CALIBRATIONS[calib], window_events=BASKET)
    j = jserve.price_query(q, jside.store, **kw)
    t = tserve.price_query(q, tside.store, **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    # the cheap query's cut is provably empty in every window
    assert (t.est_bytes > 0) == (qname != "cheap")


def test_malformed_query_priced_like_jax(sides):
    jside, tside = sides
    with pytest.raises(Exception) as je:
        jserve.price_query(MALFORMED, jside.store)
    with pytest.raises(Exception) as te:
        tserve.price_query(MALFORMED, tside.store)
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)


def test_journal_matches_jax(tmp_path):
    """The journal alone: validation, records, persistence, reopening."""
    def script(serve, path):
        jr = serve.JobJournal(str(path))
        jr.append("submit", 1, 0.0, tenant="t", query={"a": 1})
        jr.append("window", 1, 1.5, seq=0)
        errors = []
        for event, fields in (("explode", {}), ("submit", {"query": object()})):
            with pytest.raises((ValueError, TypeError)) as exc:
                jr.append(event, 1, 0.0, **fields)
            errors.append((type(exc.value).__name__, str(exc.value)))
        jr.close()
        reopened = serve.JobJournal(str(path))
        reopened.append("settle", 1, 2.0, state="DONE")
        reopened.close()
        return (serve.JOURNAL_VERSION, serve.JOURNAL_EVENTS, errors,
                serve.JobJournal(str(path)).records(),
                serve.JobJournal(str(path)).records("window"),
                path.read_text())

    t = script(tserve, tmp_path / "t.journal")
    assert t == script(jserve, tmp_path / "j.journal")
    assert len(t[3]) == 3


# ---------------------------------------------------------------------------
# the seeds of tests/test_service_props.py
# ---------------------------------------------------------------------------


def _interleave(side, actions):
    svc = side.service(batching=False)
    submitted = []
    for op, arg in actions:
        if op == "submit":
            submitted.append(svc.submit(props.QUERIES[arg], tenant=f"t{arg}"))
        elif op == "cancel" and submitted:
            svc.cancel(submitted[arg % len(submitted)].job_id)
        elif op == "step":
            for _ in range(arg):
                if not svc.step():
                    break
    svc.run_until_idle()
    return svc


HAND_SCRIPT = [("submit", 0), ("step", 2), ("submit", 1), ("cancel", 0),
               ("submit", 0), ("cancel", 1), ("step", 1)]


@pytest.mark.parametrize("seed", [*range(12), "hand"])
def test_service_props_seed_matches_jax(prop_sides, seed):
    if seed == "hand":
        actions = HAND_SCRIPT
    else:
        rng = random.Random(seed)
        actions = props._random_actions(rng, rng.randrange(3, 14))
    jside, tside = prop_sides
    j, t = _interleave(jside, actions), _interleave(tside, actions)
    assert scrub(service_print(t)) == scrub(service_print(j))
    for job in t.jobs.values():  # the invariants the JAX sweep holds
        assert job.terminal
        spans = job.windows_streamed()
        if job.state == "DONE":
            assert spans == props.SPANS
        elif job.state == "CANCELLED":
            assert spans == props.SPANS[: len(spans)]


# ---------------------------------------------------------------------------
# lint: the port's serving plane follows the repo's rules
# ---------------------------------------------------------------------------


def test_port_serving_plane_lints_clean():
    paths = [str(ROOT / "src" / "repro_torch" / d) for d in ("serve", "cluster")]
    paths.append(str(ROOT / "src" / "repro_torch" / "obs" / "metrics.py"))
    res = lint_paths(paths)
    assert res.findings == [], [f.render() for f in res.findings]
    assert res.files >= 11
