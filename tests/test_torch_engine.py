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
from types import SimpleNamespace

import numpy as np
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


# ---------------------------------------------------------------------------
# the phase-2 selection: survivor indices built once a counts branch
# ---------------------------------------------------------------------------

VALUE_TYPES = (np.float32, np.int32, np.uint8, np.bool_)


def _values(rng, dtype, n):
    if dtype is np.bool_:
        return rng.random(n) < 0.5
    if dtype is np.float32:
        return rng.standard_normal(n).astype(np.float32)
    return rng.integers(0, 100, n).astype(dtype)


def _selection_window(n, lams, counts_dtype=np.int32, per_coll=6, mask="ragged",
                      flat=3, zero_every=0):
    """Columnar data of ``n`` events: one collection a multiplicity in
    ``lams``, each with ``per_coll`` columns cycling through
    ``VALUE_TYPES``, its counts branch among the columns; ``flat`` event
    columns; every ``zero_every``-th event holds no objects."""
    rng = np.random.default_rng(17 + n + len(lams))
    data, branches = {}, {}
    for ci, lam in enumerate(lams):
        coll = f"C{ci}"
        counts = rng.poisson(lam, n)
        if zero_every:
            counts[::zero_every] = 0
        data[f"n{coll}"] = counts.astype(counts_dtype)
        branches[f"n{coll}"] = SimpleNamespace(jagged=False, counts_branch=None)
        for j in range(per_coll):
            name = f"{coll}_v{j}"
            data[name] = _values(rng, VALUE_TYPES[j % 4], int(counts.sum()))
            branches[name] = SimpleNamespace(jagged=True, counts_branch=f"n{coll}")
    for j in range(flat):
        data[f"F_{j}"] = _values(rng, VALUE_TYPES[j % 4], n)
        branches[f"F_{j}"] = SimpleNamespace(jagged=False, counts_branch=None)
    keep = {"ragged": rng.random(n) < 0.3,
            "none": np.zeros(n, dtype=bool),
            "all": np.ones(n, dtype=bool),
            "blocks": (np.arange(n) // 7) % 3 == 1}[mask]
    return data, keep, SimpleNamespace(branches=branches)


SELECTIONS = {
    "three-collections-many-columns": dict(n=500, lams=(0.4, 0.5, 4.0), per_coll=12),
    "counts-branch-is-output": dict(n=300, lams=(2.0,), per_coll=2, flat=0),
    "mask-all-false": dict(n=300, lams=(1.0, 3.0), mask="none"),
    "mask-all-true": dict(n=300, lams=(1.0, 3.0), mask="all"),
    "mask-in-blocks": dict(n=300, lams=(1.0, 3.0), mask="blocks"),
    "events-with-zero-objects": dict(n=300, lams=(0.2, 3.0), zero_every=3),
    "counts-int32": dict(n=200, lams=(2.0,), counts_dtype=np.int32),
    "counts-uint8": dict(n=200, lams=(2.0,), counts_dtype=np.uint8),
    "counts-int64": dict(n=200, lams=(2.0,), counts_dtype=np.int64),
    "value-types": dict(n=200, lams=(1.5,), per_coll=8, flat=4),
    "empty-window": dict(n=0, lams=(0.4, 4.0)),
}


@pytest.mark.parametrize("case", list(SELECTIONS))
def test_select_columns_matches_jax(case):
    """Values, dtype and the jagged map bit for bit as the JAX package's
    ``arr[mask]`` / ``arr[np.repeat(mask, counts)]``, each column a
    fresh array."""
    from repro.core.engine import _select_columns as j_select
    from repro_torch.core.engine import _select_columns as t_select

    data, mask, store = _selection_window(**SELECTIONS[case])
    want_cols, want_jagged = j_select(data, mask, store)
    got_cols, got_jagged = t_select(data, mask, store)
    assert got_jagged == want_jagged
    assert list(got_cols) == list(want_cols)
    for k, want in want_cols.items():
        got = got_cols[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k
        assert not np.shares_memory(got, data[k]), k


@pytest.mark.parametrize("fault", ["flat-too-long", "jagged-too-short",
                                   "jagged-too-long", "counts-too-short"])
def test_select_columns_raises_on_a_length_mismatch(fault):
    from repro.core.engine import _select_columns as j_select
    from repro_torch.core.engine import _select_columns as t_select

    data, mask, store = _selection_window(n=100, lams=(2.0,), per_coll=2, flat=1)
    if fault == "flat-too-long":
        data["F_0"] = np.append(data["F_0"], data["F_0"][:1])
    elif fault == "jagged-too-short":
        data["C0_v1"] = data["C0_v1"][:-1]
    elif fault == "jagged-too-long":
        data["C0_v0"] = np.append(data["C0_v0"], data["C0_v0"][:1])
    else:
        data["nC0"] = data["nC0"][:-1]
    with pytest.raises(Exception) as want:
        j_select(data, mask, store)
    with pytest.raises(want.type):
        t_select(data, mask, store)


@pytest.mark.parametrize("device_batch", [None, 3])
def test_windows_across_baskets_match_jax(device_batch):
    """Windows of 64 events over baskets of 100: most windows cut a jagged
    basket after its start, so every column of a collection slices it past
    its leading counts."""
    js = j_make(3_000, n_hlt=8, n_filler=2, basket_events=100)
    ts = t_make(3_000, n_hlt=8, n_filler=2, basket_events=100, device="cpu")
    q = QUERIES["quickstart"]
    kw = dict(chunk_events=64, device_batch=device_batch)
    j = JEngine(js, **kw).run(q, "near_data")
    t = TEngine(ts, device="cpu", **kw).run(q, "near_data")
    assert_same_result(t, j)
    assert 0 < t.n_passed < 3_000
    assert t.extras["cascade_stages"] == j.extras["cascade_stages"]
    assert ts.decode_cache_stats() == js.decode_cache_stats()
    assert ts.decode_cache_stats()["hits"] > 0
