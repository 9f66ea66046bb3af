"""Non-finite values (NaN, ±inf, -0.0) through every route of the port,
held to the JAX package's staged run (``run_skim(..., fused=False)``).

The store is ``make_nanoaod_like(6000, n_hlt=8, n_filler=2)`` with
``len // 50`` entries of every float branch set in turn to NaN, +inf,
-inf and -0.0 (``chip_smoke.nonfinite_columns``, seed 1), built in each
package with ``EventStore.from_arrays``.  The queries are the skimlint
corpus, three queries that reach the rules below, quickstart and Z->ee
(``chip_smoke.nonfinite_queries``), at ``chunk_events`` 4096 and 777.

Every route of the port returns the staged run's survivors and output
bytes; its fetch, cascade and decode ledgers equal the JAX package's run
of the same configuration on its host evaluator (the staged semantics).
The padded evaluation follows the host evaluator:

* the leading object of a pair is the first valid slot in the order of
  ``core.expr._leading_indices``: pt descending, NaN after every number;
* HT keeps IEEE products, so a NaN or infinite weight on a slot that
  fails its cut makes the sum NaN;
* ``min`` / ``max`` are numpy's: of two equal zeros the second operand.

The JAX package's padded route (``fused_backend="xla"`` and its batched
path off a TPU) departs from its own staged route on all three (an
``argmax`` lead, XLA's rewrite of the HT product into a select under
``jit``, IEEE ``jnp.minimum``): ROADMAP's quirks of the reference.  These
tests assert the port's numbers and the staged ones, never XLA's.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the non-finite stores and queries)
from repro.core import SkimEngine as JEngine  # noqa: E402
from repro.core.expr import _leading_indices  # noqa: E402
from repro.core.neardata import fused_window_skim as j_fused  # noqa: E402
from repro.core.planner import plan_skim as j_plan  # noqa: E402
from repro.core.query import parse_query as j_parse  # noqa: E402
from repro.data.store import EventStore as JStore  # noqa: E402
from repro.data.synth import make_nanoaod_like as j_make  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import SkimEngine as TEngine  # noqa: E402
from repro_torch.core.neardata import fused_window_skim as t_fused  # noqa: E402
from repro_torch.core.planner import plan_skim as t_plan  # noqa: E402
from repro_torch.core.query import parse_query as t_parse  # noqa: E402
from repro_torch.data.store import EventStore as TStore  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_engine import assert_same_result  # noqa: E402

N = 6000
CHUNKS = (4096, 777)
QUERIES = chip_smoke.nonfinite_queries(N)

# route -> (the port's engine keywords, run keywords, decode backend); the
# JAX package's run of the same configuration takes the same run keywords
# and decode backend on its host evaluator
ROUTES = {
    "host": ({"fused_backend": "host"}, {}, None),
    "torch": ({"fused_backend": "torch"}, {}, None),
    "torch-no-cascade": ({"fused_backend": "torch"}, {"cascade": False}, None),
    "device-batch-2": ({"device_batch": 2}, {}, None),
    "device-decode": ({"fused_backend": "torch"}, {}, "device"),
    "staged": ({}, {"fused": False}, None),
}


@pytest.fixture(scope="module")
def columns():
    return chip_smoke.nonfinite_columns(j_make(N, **chip_smoke.NONFINITE_SHAPE))


def _stores(columns, decode=None):
    cols, jagged = columns
    js = JStore.from_arrays(cols, jagged=jagged, decode_backend=decode)
    ts = TStore.from_arrays(cols, jagged=jagged, decode_backend=decode, device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def runs(columns):
    """Store pairs by decode backend and the JAX package's runs, cached."""
    cache = {}

    def stores(decode):
        if ("stores", decode) not in cache:
            cache["stores", decode] = _stores(columns, decode)
        return cache["stores", decode]

    def jax_run(qname, chunk, decode=None, **run_kw):
        key = (qname, chunk, decode, tuple(sorted(run_kw.items())))
        if key not in cache:
            js = stores(decode)[0]
            backend = {} if run_kw.get("fused") is False else {"fused_backend": "host"}
            cache[key] = JEngine(js, chunk_events=chunk, **backend).run(
                QUERIES[qname], "near_data", **run_kw)
        return cache[key]

    return stores, jax_run


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("qname", sorted(QUERIES))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_route_returns_the_staged_survivors(runs, route, qname, chunk):
    stores, jax_run = runs
    port_kw, run_kw, decode = ROUTES[route]
    ts = stores(decode)[1]
    t = TEngine(ts, chunk_events=chunk, device="cpu", **port_kw).run(
        QUERIES[qname], "near_data", **run_kw)
    staged = jax_run(qname, chunk, fused=False)
    assert t.n_passed == staged.n_passed and t.n_input == staged.n_input == N
    assert t.output._blobs == staged.output._blobs
    assert t.output.manifest_hash() == staged.output.manifest_hash()
    if "device_batch" in port_kw:
        _check_batched_ledgers(runs, t, qname, chunk)
        return
    same = jax_run(qname, chunk, decode, **run_kw)
    assert_same_result(t, same, same_backend=route == "staged")


# Queries with no HT, pair or min / max group, where the JAX package's
# padded route cannot depart from its staged route: there its batched run
# (which is that route) is the reference for the batched ledgers.
BATCH_LEDGER_QUERIES = {"cascade-off-variant", "expr", "object-selection",
                        "presel-flat-cut", "quickstart", "strict-variant",
                        "trigger-or", "trigger-or-era-absent"}


def _check_batched_ledgers(runs, t, qname, chunk):
    """A batch runs its windows in one stage order, frozen before it; the
    per-window run re-ranks the stages after every window, so their stage
    ledgers differ once the order moves.  Every batched run keeps the
    preload run's bytes; the ledgers are held to the JAX package's batched
    run where its route is the staged one."""
    stores, jax_run = runs
    preload = jax_run(qname, chunk, cascade=False)
    assert (t.stats.bytes_fetched + t.stats.cascade_bytes_skipped
            == preload.stats.bytes_fetched)
    if qname in BATCH_LEDGER_QUERIES:
        j = JEngine(stores(None)[0], chunk_events=chunk, device_batch=2).run(
            QUERIES[qname], "near_data")
        assert_same_result(t, j)


# Survivors at chunk_events=4096 where the JAX package's padded route departs
# from its staged route on this store (the port's fault before the repair,
# in brackets, on its "torch" route): the staged numbers, which every route
# of the port returns.
STAGED_SURVIVORS = {
    "ht-cut": 865,  # HT: a NaN or infinite weight on a slot failing pt > 30
    "delta-r": 1847,  # the leading electron or jet where a pt is NaN (1846)
    "kitchen-sink": 61,  # HT with no object cut, beside other groups
    "mass-jets": 1623,  # the two leading jets
    "delta-r-jets": 1699,
}


@pytest.mark.parametrize("qname", sorted(STAGED_SURVIVORS))
def test_staged_survivors_on_the_nonfinite_store(runs, qname):
    stores, jax_run = runs
    t = TEngine(stores(None)[1], device="cpu", fused_backend="torch").run(
        QUERIES[qname], "near_data")
    assert t.n_passed == jax_run(qname, 4096, fused=False).n_passed
    assert t.n_passed == STAGED_SURVIVORS[qname]


@pytest.mark.parametrize("route", ["host", "staged"])
@pytest.mark.parametrize("qname", ["quickstart", "zee", "kitchen-sink", "delta-r"])
def test_decode_cache_and_dispatch_ledgers(columns, route, qname):
    """Fresh stores: the decode LRU's and the dispatch ledgers after one run
    equal the JAX package's."""
    port_kw, run_kw, _ = ROUTES[route]
    js, ts = _stores(columns)
    backend = {} if route == "staged" else {"fused_backend": "host"}
    jops.reset_dispatch_stats()
    j = JEngine(js, **backend).run(QUERIES[qname], "near_data", **run_kw)
    j_dispatch = jops.dispatch_stats()
    tops.reset_dispatch_stats()
    t = TEngine(ts, device="cpu", **port_kw).run(QUERIES[qname], "near_data", **run_kw)
    assert_same_result(t, j)
    assert tops.dispatch_stats() == j_dispatch
    assert ts.decode_cache_stats() == js.decode_cache_stats()
    assert ts.decode_backend_stats() == js.decode_backend_stats()


def test_nonfinite_basket_statistics_match(columns):
    """A basket holding NaN or ±inf carries no zone-map statistics, so its
    windows are scanned: every basket's metadata and the plan of every
    query equal the JAX package's."""
    js, ts = _stores(columns)
    for name in js.branches:
        for b in range(js.n_baskets(name)):
            assert (dataclasses.asdict(ts.basket_meta(name, b))
                    == dataclasses.asdict(js.basket_meta(name, b))), (name, b)
    assert ts.basket_meta("Jet_pt", 0).vmin is None
    for q in QUERIES.values():
        assert t_plan(t_parse(q), ts).describe() == j_plan(j_parse(q), js).describe()


@pytest.mark.parametrize("decode", [None, "device"])
def test_output_baskets_keep_nan_and_negative_zero_bits(columns, decode):
    """A skim that keeps every event writes the float columns back bit for
    bit: NaN payloads and -0.0 included."""
    cols, _ = columns
    ts = _stores(columns, decode)[1]
    q = {"branches": ["MET_*", "Filler_*"], "selection": {}}
    t = TEngine(ts, device="cpu", fused_backend="torch").run(q, "near_data")
    assert t.n_passed == N
    for name in ("MET_pt", "MET_phi", "Filler_000", "Filler_001"):
        got = t.output.read_flat(name)
        assert got.view(np.int32).tobytes() == cols[name].view(np.int32).tobytes()
        assert np.isnan(got).any() and np.signbit(got[got == 0]).any()


# ---------------------------------------------------------------------------
# the plain versions on the cases one at a time (chip_smoke.nonfinite_window)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def window():
    cols, jagged = chip_smoke.nonfinite_window()
    n = len(cols["MET_pt"])
    js = JStore.from_arrays(cols, jagged=jagged, basket_events=n)
    ts = TStore.from_arrays(cols, jagged=jagged, basket_events=n, device="cpu")
    return cols, js, ts


def _padded(cols, coll, K):
    counts = cols[f"n{coll}"]
    valid = np.arange(K)[None, :] < counts[:, None]
    pt = np.zeros((len(counts), K), np.float32)
    pt[valid] = cols[f"{coll}_pt"]
    return torch.from_numpy(pt), torch.from_numpy(valid), counts


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("pair", [("Electron", "Electron"), ("Electron", "Jet"),
                                  ("Jet", "Jet")])
def test_leading_slots_follow_the_host_order(window, pair, K):
    """``_pair_slots`` picks the host evaluator's leading objects: a NaN pt
    among valid slots, every pt NaN, no object, a valid -inf beside
    padding, two zeros of opposite sign, equal pts."""
    cols = window[0]
    pt_a, va, ca = _padded(cols, pair[0], K)
    pt_b, vb, cb = _padded(cols, pair[1], K)
    same = pair[0] == pair[1]
    i1, i2, ok = tref._pair_slots(pt_a, va, pt_b, vb, same)
    i1, i2 = i1[:, 0].numpy(), i2[:, 0].numpy()

    def host(coll, counts, k):
        idxs, has = _leading_indices(cols[f"{coll}_pt"], counts, k)
        starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        return [i - starts for i in idxs], has

    if same:
        (h1, h2), (_, has2) = host(pair[0], ca, 2)
        want_ok = has2
    else:
        (h1,), (ha,) = host(pair[0], ca, 1)
        (h2,), (hb,) = host(pair[1], cb, 1)
        want_ok = ha & hb
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(i1[ca > 0], h1[ca > 0])
    np.testing.assert_array_equal(i2[want_ok], h2[want_ok])
    assert (i1[ca == 0] == 0).all()  # no valid slot: slot 0


@pytest.mark.parametrize("K", [None, 8])
@pytest.mark.parametrize("qname", sorted(chip_smoke.NONFINITE_WINDOW_QUERIES))
def test_window_masks_match_the_host_evaluator(window, qname, K):
    """Each group kind over the eight cases, on the padded layout at the
    K the engine picks and at K = 8: the mask of the JAX package's host
    evaluator."""
    cols, js, ts = window
    q = chip_smoke.NONFINITE_WINDOW_QUERIES[qname]
    jplan, tplan = j_plan(j_parse(q), js), t_plan(t_parse(q), ts)
    data = {b: cols[b] for b in jplan.filter_branches}
    want, _ = j_fused(data, jplan.compiled_program(), js, backend="host")
    for backend in ("torch", "host"):
        got, _ = t_fused(data, tplan.compiled_program(), ts, backend=backend, K=K,
                         device="cpu")
        assert got.tobytes() == want.tobytes(), (backend, got, want)
    assert 0 < want.sum() < len(want)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("qname", sorted(chip_smoke.NONFINITE_WINDOW_QUERIES))
def test_window_store_routes_match_staged(window, qname, route):
    cols, js, ts = window
    port_kw, run_kw, _ = ROUTES[route]
    q = chip_smoke.NONFINITE_WINDOW_QUERIES[qname]
    staged = JEngine(js).run(q, "near_data", fused=False)
    t = TEngine(ts, device="cpu", **port_kw).run(q, "near_data", **run_kw)
    assert t.n_passed == staged.n_passed
    assert t.output._blobs == staged.output._blobs


def test_expr_min_max_take_the_second_of_two_zeros():
    """The plain EXPR group's min / max are numpy's on every length:
    ``torch.minimum`` returns the first of two equal zeros on its scalar
    path and the second on its vector path."""
    a = torch.tensor([-0.0, 0.0] * 9)
    b = -a
    for n in (1, 3, 18):
        for take, np_fn in ((a[:n] < b[:n], np.minimum), (a[:n] > b[:n], np.maximum)):
            got = tref._np_minmax(a[:n], b[:n], take).numpy()
            want = np_fn(a[:n].numpy(), b[:n].numpy())
            assert got.view(np.int32).tobytes() == want.view(np.int32).tobytes()
