"""The slice as a whole: the PyTorch port's skim engine against the JAX
package's, on the CPU.

The same store (same seed, byte-identical) and the same query go
through ``repro.core`` and ``repro_torch.core`` with ``device="cpu"``.
Survivors, every output column's bytes, the fetch ledger, the cascade
ledgers and the set of ``extras`` keys must be equal; only wall-clock
values may differ.  The port's ``fused_backend="torch"`` runs the
kernels' plain PyTorch versions over the padded layout, and
``decode_backend="device"`` the decode kernel's plain version.
"""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the quickstart and Z->ee queries)
from repro.core import SkimEngine as JEngine  # noqa: E402
from repro.data.synth import make_nanoaod_like as j_make  # noqa: E402
from repro_torch.core import SkimEngine as TEngine  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like as t_make  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

N = 20_000
SHAPE = dict(n_hlt=16, n_filler=4)

QUERIES = {
    "quickstart": chip_smoke.QUICKSTART_QUERY,
    "zee": chip_smoke.zee_query(N),
    "none": {
        "branches": ["Electron_*", "MET_*"],
        "selection": {"event": [
            {"type": "cut", "branch": "MET_pt", "op": ">", "value": 1e9}]},
    },
}

# (port-only keywords, keywords both engines take)
CONFIGS = {
    "default-host": ({}, {}),
    "default-torch": ({"fused_backend": "torch"}, {}),
    "torch-no-cascade-no-prune": (
        {"fused_backend": "torch"}, {"cascade": False, "prune": False}),
    "host-no-cascade": ({}, {"cascade": False}),
    "staged-serial": ({}, {"fused": False, "pipeline": False}),
    "torch-threads": ({"fused_backend": "torch"}, {"pipeline": "threads"}),
    "torch-device-decode": ({"fused_backend": "torch", "decode": "device"}, {}),
}
TIMING_KEYS = {"overlap_total", "phase_wall_s", "pipeline_total"}


@pytest.fixture(scope="module")
def stores():
    return {}


def _store_pair(cache, decode):
    if decode not in cache:
        js, ts = j_make(N, **SHAPE), t_make(N, **SHAPE, device="cpu")
        if decode:
            js.decode_backend = ts.decode_backend = decode
        cache[decode] = (js, ts)
    return cache[decode]


def assert_same_result(t, j, same_backend=True):
    assert t.n_passed == j.n_passed and t.n_input == j.n_input
    assert t.output.branch_names() == j.output.branch_names()
    assert t.output._blobs == j.output._blobs
    assert t.output.manifest_hash() == j.output.manifest_hash()
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert set(t.extras) == set(j.extras)
    # the JAX side runs its host interpreter where the port runs "torch";
    # dispatch counts are compared where both run a padded-layout backend
    skip = TIMING_KEYS | (set() if same_backend else {"device_dispatches"})
    for k in set(j.extras) - skip:
        assert t.extras[k] == j.extras[k], k
    assert t.plan.describe() == j.plan.describe()


@pytest.mark.parametrize("chunk", [4096, 777])
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_engine_matches_jax(stores, qname, config, chunk):
    port_kw, run_kw = CONFIGS[config]
    port_kw = dict(port_kw)
    js, ts = _store_pair(stores, port_kw.pop("decode", None))
    q = QUERIES[qname]
    j = JEngine(js, chunk_events=chunk).run(q, "near_data", **run_kw)
    t = TEngine(ts, chunk_events=chunk, device="cpu", **port_kw).run(
        q, "near_data", **run_kw)
    assert_same_result(t, j, same_backend="fused_backend" not in port_kw)
    if qname == "none":
        assert t.n_passed == 0
    else:
        assert 0 < t.n_passed < N


@pytest.mark.parametrize("mode", ["client_plain", "client_opt", "server_side",
                                  "near_data"])
def test_every_mode_matches_jax(stores, mode):
    js, ts = _store_pair(stores, None)
    q = QUERIES["quickstart"]
    j = JEngine(js).run(q, mode)
    t = TEngine(ts, device="cpu").run(q, mode)
    assert_same_result(t, j)
    assert t.breakdown.as_dict().keys() == j.breakdown.as_dict().keys()


def test_torch_backend_dispatches_like_the_jax_ledger(stores):
    """The fused path on the padded layout notes one dispatch per cascade
    stage evaluation, as the JAX package's jitted backend does."""
    js, ts = _store_pair(stores, None)
    j = JEngine(js, fused_backend="xla").run(QUERIES["zee"])
    tops.reset_dispatch_stats()
    t = TEngine(ts, device="cpu", fused_backend="torch").run(QUERIES["zee"])
    assert_same_result(t, j)
    stages_run = sum(s["windows"] for s in t.extras["cascade_stages"])
    assert tops.dispatch_stats()["dispatches"] == stages_run > 0
    assert set(tops.launch_counts().values()) == {0}


@pytest.mark.parametrize("backend", ["torch", "host"])
@pytest.mark.parametrize("qname", ["quickstart", "zee"])
def test_fused_window_skim_matches_jax(qname, backend):
    """One whole-store window through ``fused_window_skim``: the port's
    padded-layout and host backends against the JAX package's host
    interpreter, mask and compacted payload columns."""
    from repro.core.neardata import fused_window_skim as j_fused
    from repro.core.planner import plan_skim as j_plan
    from repro.core.query import parse_query as j_parse
    from repro_torch.core.neardata import fused_window_skim as t_fused
    from repro_torch.core.planner import plan_skim as t_plan
    from repro_torch.core.query import parse_query as t_parse

    js = j_make(6_000, n_hlt=8, n_filler=2, basket_events=1024)
    ts = t_make(6_000, n_hlt=8, n_filler=2, basket_events=1024, device="cpu")
    q = QUERIES[qname]
    jplan, tplan = j_plan(j_parse(q), js), t_plan(t_parse(q), ts)
    data = {}
    for b in jplan.filter_branches:
        data[b] = js.read_jagged(b)[0] if js.branches[b].jagged else js.read_flat(b)
    want_mask, want_cols = j_fused(data, jplan.compiled_program(), js,
                                   payload_branches=jplan.payload_branches)
    got_mask, got_cols = t_fused(data, tplan.compiled_program(), ts, backend=backend,
                                 payload_branches=tplan.payload_branches, device="cpu")
    assert got_mask.tobytes() == want_mask.tobytes() and 0 < got_mask.sum()
    assert got_cols.keys() == want_cols.keys()
    for k in want_cols:
        assert got_cols[k].tobytes() == want_cols[k].tobytes(), k
