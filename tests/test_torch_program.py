"""The PyTorch port's query IR against the JAX package's.

Parsing, expression lowering, ``compile_query`` and planning are numpy
code that the port keeps its own copy of; every comparison here is
exact.  The guard at the end runs the port in a subprocess where
importing ``jax`` or ``repro`` fails.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the quickstart and Z->ee queries)
from repro.core.planner import plan_skim as j_plan_skim  # noqa: E402
from repro.core.query import eval_stage as j_eval_stage  # noqa: E402
from repro.core.query import parse_query as j_parse_query  # noqa: E402
from repro.data.synth import make_nanoaod_like as j_make  # noqa: E402
from repro.kernels.predicate_eval import compile_query as j_compile  # noqa: E402
from repro_torch.core import SkimEngine, run_skim  # noqa: E402
from repro_torch.core.planner import plan_skim as t_plan_skim  # noqa: E402
from repro_torch.core.query import eval_stage as t_eval_stage  # noqa: E402
from repro_torch.core.query import parse_query as t_parse_query  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like as t_make  # noqa: E402
from repro_torch.kernels.program import compile_query as t_compile  # noqa: E402
from repro_torch.kernels.program import program_from_fields  # noqa: E402
from tools.skimlint.fixtures import FIXTURE_QUERIES  # noqa: E402

# tests/test_query.py's QUERY and tests/test_expr.py's ZQUERY and
# interpreter queries, copied
TEST_QUERY = {
    "branches": ["Electron_*", "Muon_*", "Jet_*", "MET_*", "HLT_*", "Filler_*",
                 "PV_npvs", "run", "event", "luminosityBlock"],
    "selection": {
        "preselection": [{"branch": "nElectron", "op": ">=", "value": 1}],
        "object": [{"collection": "Electron",
                    "cuts": [{"var": "pt", "op": ">", "value": 20.0},
                             {"var": "eta", "op": "abs<", "value": 2.4}],
                    "min_count": 1}],
        "event": [
            {"type": "ht", "collection": "Jet", "var": "pt",
             "object_cuts": [{"var": "pt", "op": ">", "value": 30.0}],
             "op": ">", "value": 100.0},
            {"type": "any", "branches": ["HLT_IsoMu24"]},
            {"type": "cut", "branch": "MET_pt", "op": ">", "value": 20.0},
        ],
    },
}
Z_QUERY = {
    "branches": ["Electron_*", "Jet_pt", "MET_*", "luminosityBlock"],
    "selection": {"event": [
        {"type": "mass", "collections": ["Electron", "Electron"],
         "window": [5.0, 120.0]},
        {"type": "deltaR", "collections": ["Electron", "Jet"], "op": ">",
         "value": 0.4},
        {"type": "expr", "expr": "MET_pt + 0.5*sum(Jet_pt)", "op": ">",
         "value": 60.0},
    ]},
}
EXPR_QUERIES = [
    {"branches": ["MET_*"], "selection": {"event": [
        {"type": "expr", "expr": "abs(MET_pt - 30)", "op": "<", "value": 10.0}]}},
    {"branches": ["MET_*"], "selection": {"event": [
        {"type": "expr", "expr": "min(MET_pt, sum(Jet_pt))", "op": ">",
         "value": 25.0}]}},
    {"branches": ["Electron_*"], "selection": {"event": [
        {"type": "mass", "collections": ["Electron", "Electron"],
         "window": [0.0, 60.0]}]}},
    {"branches": ["Electron_*"], "selection": {"event": [
        {"type": "deltaR", "collections": ["Electron", "Muon"], "op": "<",
         "value": 2.0}]}},
    {"branches": ["Electron_*"], "selection": {"event": [
        {"type": "deltaR", "collections": ["Jet", "Jet"], "op": ">",
         "value": 1.0}]}},
]

QUERIES = {
    **{f"fixture-{d['name']}": {k: v for k, v in d.items() if k != "name"}
       for d in FIXTURE_QUERIES},
    "test_query": TEST_QUERY,
    "test_expr-zquery": Z_QUERY,
    **{f"test_expr-{i}": q for i, q in enumerate(EXPR_QUERIES)},
    "quickstart": chip_smoke.QUICKSTART_QUERY,
    "zee": chip_smoke.zee_query(20_000),
}


@pytest.fixture(scope="module")
def stores():
    return j_make(4096, n_hlt=8, basket_events=512, seed=7), t_make(
        4096, n_hlt=8, basket_events=512, seed=7, device="cpu"
    )


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_parse_and_compile_equal(name):
    doc = QUERIES[name]
    jq, tq = j_parse_query(doc), t_parse_query(doc)
    assert dataclasses.astuple(tq) == dataclasses.astuple(jq)
    jp, tp = j_compile(jq), t_compile(tq)
    assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
    assert program_from_fields(dataclasses.astuple(jp)) == tp


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_plans_and_stage_masks_equal(name, stores):
    """Window decisions, the cascade IR and the staged evaluator's masks."""
    js, ts = stores
    doc = QUERIES[name]
    jq, tq = j_parse_query(doc), t_parse_query(doc)
    kw = dict(window_events=1024, prune=True, cascade=doc.get("cascade", True))
    jplan, tplan = j_plan_skim(jq, js, **kw), t_plan_skim(tq, ts, **kw)
    assert tplan.describe() == jplan.describe()
    assert [dataclasses.astuple(d) for d in tplan.window_decisions or ()] == [
        dataclasses.astuple(d) for d in jplan.window_decisions or ()
    ]
    assert tplan.filter_branches == jplan.filter_branches
    assert tplan.output_branches == jplan.output_branches
    assert tplan.payload_branches == jplan.payload_branches
    data = {}
    for b in jplan.filter_branches:
        if b not in js.branches:
            continue
        data[b] = js.read_jagged(b)[0] if js.branches[b].jagged else js.read_flat(b)
    for (_, jstage), (_, tstage) in zip(jq.stages(), tq.stages()):
        np.testing.assert_array_equal(
            t_eval_stage(tstage, data, js.n_events),
            j_eval_stage(jstage, data, js.n_events),
        )


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = t_make(512, n_hlt=4, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_skim(store, chip_smoke.QUICKSTART_QUERY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SkimEngine(store)
    lazy = t_make(512, n_hlt=4)  # building and hashing needs no device
    assert lazy.manifest_hash() == store.manifest_hash()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lazy.resolved_decode_backend()
    eng = SkimEngine(store, device="cpu")
    assert eng.fused_backend == "host"
    assert store.resolved_decode_backend() == "host"


@pytest.mark.parametrize(
    "kw,exc",
    [
        (dict(fused_backend="cuda"), ValueError),
        (dict(fused_backend="pallas"), ValueError),
        (dict(device_batch=2), NotImplementedError),
        (dict(device="mps"), ValueError),
    ],
)
def test_engine_rejects_what_this_device_cannot_run(kw, exc):
    store = t_make(512, n_hlt=4, device="cpu")
    kw.setdefault("device", "cpu")
    with pytest.raises(exc):
        SkimEngine(store, **kw)


GUARD = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    import repro_torch
    from repro_torch.core import run_skim
    from repro_torch.data.synth import make_nanoaod_like
    store = make_nanoaod_like(3000, n_hlt=8, n_filler=2, device="cpu")
    q = {"branches": ["Electron_*", "MET_*"], "selection": {
        "object": [{"collection": "Electron",
                    "cuts": [{"var": "pt", "op": ">", "value": 20.0}]}],
        "event": [{"type": "cut", "branch": "MET_pt", "op": ">", "value": 15.0}]}}
    res = run_skim(store, q, device="cpu", fused_backend="torch")
    assert 0 < res.n_passed < 3000, res.n_passed
    bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro."))]
    assert not [m for m in bad if sys.modules[m] is not None], bad
    print("ok", res.n_passed)
    """
)


def test_port_runs_with_jax_and_the_jax_package_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", GUARD], capture_output=True, text=True,
        timeout=120, env=env, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok ")
