"""Float32 cut edges through every route of the port, held to the JAX
package's staged run and host evaluator bit for bit.

The window is ``chip_smoke.edge_window()``: 64 events, four baskets of
16, with events found by a seeded search that a float32 evaluation of a
group value and the host's float64 formulas decide differently:

* MASS (``mass-jets``, the window [60, 120]) at each end: collinear jets at
  eta = phi = 0, where the mass is a difference of large squares;
* ΔR under ``<`` and ``>`` 0.4 (``delta-r-lt``, ``delta-r-gt``): float32 π
  and float32 rounding against float64;
* HT against 200.3, a cut float32 cannot hold (``ht``);
* EXPR with ``sum()`` (``expr-sum``) and with the constant 0.1
  (``expr-const``);
* and ``object-cut``: a jet of pt float32(20.3) under ``pt >= 20.3``,
  which the host compares in float32 (numpy reads the Python float beside
  a float32 column in float32), so it keeps the jet where a float64
  comparison would not.

The port evaluates the group values in float64 as the host does, on every
route: the ``host`` backend, the padded route through the kernels' plain
versions (``torch``, with and without the cascade, with the batched
cascade, with the decode tier's device codec), the staged route, and the
four kernel entry points of ``ops``.  The JAX package's padded route
(``fused_backend="xla"``) evaluates them in float32 and departs from its
own staged run at these events; one test records by how much, asserting
nothing of it.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the edge window and its queries)
from repro.core import SkimEngine as JEngine  # noqa: E402
from repro.core.neardata import program_eval_np as j_program_eval_np  # noqa: E402
from repro.core.planner import plan_skim as j_plan  # noqa: E402
from repro.core.query import ObjectSelection, eval_node  # noqa: E402
from repro.core.query import parse_query as j_parse  # noqa: E402
from repro.data.store import EventStore as JStore  # noqa: E402
from repro_torch.core import SkimEngine as TEngine  # noqa: E402
from repro_torch.core.neardata import build_padded_inputs, window_pad_K  # noqa: E402
from repro_torch.core.planner import plan_skim as t_plan  # noqa: E402
from repro_torch.core.query import parse_query as t_parse  # noqa: E402
from repro_torch.data.store import EventStore as TStore  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_torch_engine import assert_same_result  # noqa: E402

N = chip_smoke.EDGE_EVENTS
QUERIES = chip_smoke.EDGE_QUERIES
CHUNKS = (16, 32)  # windows of one basket and of two

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
def window():
    return chip_smoke.edge_window()


@pytest.fixture(scope="module")
def runs(window):
    """Store pairs by decode backend and the JAX package's runs, cached."""
    columns, jagged, _ = window
    cache = {}

    def stores(decode):
        if ("stores", decode) not in cache:
            kw = {"jagged": jagged, "basket_events": chip_smoke.EDGE_BASKET,
                  "decode_backend": decode}
            cache["stores", decode] = (JStore.from_arrays(columns, **kw),
                                       TStore.from_arrays(columns, **kw, device="cpu"))
        return cache["stores", decode]

    def jax_run(qname, chunk, decode=None, **run_kw):
        key = (qname, chunk, decode, tuple(sorted(run_kw.items())))
        if key not in cache:
            backend = {} if run_kw.get("fused") is False else {"fused_backend": "host"}
            cache[key] = JEngine(stores(decode)[0], chunk_events=chunk, **backend).run(
                QUERIES[qname], "near_data", **run_kw)
        return cache[key]

    return stores, jax_run


def _host_mask(js, qname):
    """The JAX package's host evaluator over the whole window as one."""
    plan = j_plan(j_parse(QUERIES[qname]), js)
    data = {b: js.read_jagged(b)[0] if js.branches[b].jagged else js.read_flat(b)
            for b in plan.filter_branches}
    return j_program_eval_np(data, plan.compiled_program(), N)


def test_edge_window_holds_every_case(window, runs):
    """Every query has edge events, MASS at both ends and ΔR and HT both
    ways; the JAX package's host evaluator and staged run keep exactly the
    edge events the float64 formulas keep."""
    _, _, edges = window
    stores, jax_run = runs
    js = stores(None)[0]
    assert len(edges["mass-jets"]) == 8
    for qname in ("delta-r-lt", "delta-r-gt", "ht"):
        assert sorted(kept for _, kept in edges[qname]) == [False, False, True, True]
    for qname, cases in edges.items():
        assert cases, qname
        host = _host_mask(js, qname)
        for event, kept in cases:
            assert host[event] == kept, (qname, event)
        assert jax_run(qname, 16, fused=False).n_passed == int(host.sum())


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("qname", sorted(QUERIES))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_route_returns_the_staged_run_at_float32_edges(runs, route, qname, chunk):
    """Survivors and output bytes equal the JAX package's staged run; the
    fetch, cascade and decode ledgers equal its run of the same
    configuration on its host evaluator.  A batch freezes its stage order
    (the per-window run re-ranks after every window) and the JAX batched
    run is its float32 route, so the batched run keeps the preload run's
    bytes instead."""
    stores, jax_run = runs
    port_kw, run_kw, decode = ROUTES[route]
    t = TEngine(stores(decode)[1], chunk_events=chunk, device="cpu", **port_kw).run(
        QUERIES[qname], "near_data", **run_kw)
    staged = jax_run(qname, chunk, fused=False)
    assert t.n_passed == staged.n_passed and t.n_input == staged.n_input == N
    assert t.n_passed == int(_host_mask(stores(None)[0], qname).sum())
    assert t.output._blobs == staged.output._blobs
    assert t.output.manifest_hash() == staged.output.manifest_hash()
    if "device_batch" in port_kw:
        preload = jax_run(qname, chunk, cascade=False)
        assert (t.stats.bytes_fetched + t.stats.cascade_bytes_skipped
                == preload.stats.bytes_fetched)
        return
    assert_same_result(t, jax_run(qname, chunk, decode, **run_kw),
                       same_backend=route == "staged")


def _padded(ts, qname):
    """The port's padded inputs of the whole window as one, at the K that
    truncates no object, the event index as the payload."""
    plan = t_plan(t_parse(QUERIES[qname]), ts)
    program = plan.compiled_program()
    data = {b: ts.read_jagged(b)[0] if ts.branches[b].jagged else ts.read_flat(b)
            for b in plan.filter_branches}
    pb = build_padded_inputs(data, program, ts, K=window_pad_K(data, program, ts),
                             include_index=True, to_device=False)
    return program, [torch.from_numpy(np.asarray(x))
                     for x in (pb.terms, pb.valid, pb.weights, pb.payload)]


def _kept(packed, count):
    mask = np.zeros(N, bool)
    mask[packed[: int(count), 0].numpy().astype(np.int64)] = True
    return mask


ENTRIES = ("predicate_eval", "cascade_stage_step", "skim_fused", "fused_skim_batch")


@pytest.mark.parametrize("qname", sorted(QUERIES))
@pytest.mark.parametrize("entry", ENTRIES)
def test_kernel_entries_equal_the_host_evaluator(runs, entry, qname):
    """The four entry points of ``ops`` that run the predicate, on the
    window's padded inputs: masks, counts and basket bits bit for bit
    those of the JAX package's host evaluator."""
    stores, _ = runs
    js, ts = stores(None)
    want = _host_mask(js, qname)
    program, (t, v, w, p) = _padded(ts, qname)
    if entry == "predicate_eval":
        got = tops.predicate_eval(t, v, w, program, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().astype(bool), want)
    elif entry == "cascade_stage_step":
        nb = N // chip_smoke.EDGE_BASKET
        packed = tops.pack_mask(np.ones((1, N), bool))
        seg = (np.arange(N, dtype=np.int32) // chip_smoke.EDGE_BASKET)[None]
        words, alive, counts = tops.cascade_stage_step(
            t[None], v[None], w[None], torch.from_numpy(packed.view(np.int32)),
            torch.from_numpy(seg), program, nb, device="cpu")
        np.testing.assert_array_equal(tops.unpack_mask(words.numpy(), N)[0], want)
        np.testing.assert_array_equal(alive.numpy()[0],
                                      want.reshape(nb, -1).any(axis=1).astype(np.int32))
        assert counts.tolist() == [int(want.sum())]
    elif entry == "skim_fused":
        packed, count = tops.skim_fused(t, v, w, p, program, device="cpu")
        np.testing.assert_array_equal(_kept(packed, count), want)
    else:
        packed, counts = tops.fused_skim_batch(t[None], v[None], w[None], p[None],
                                               program, device="cpu")
        np.testing.assert_array_equal(_kept(packed[0], counts[0]), want)


def test_host_compares_object_cuts_in_float32(window, runs):
    """A per-object cut meets a float32 column: numpy reads the Python
    float in float32, so ``pt >= 20.3`` keeps a jet of pt float32(20.3),
    which is below 20.3 in float64.  The padded route's per-object cuts
    stay in float32 for that reason."""
    _, _, edges = window
    stores, _ = runs
    js, ts = stores(None)
    ((event, kept),) = edges["object-cut"]
    assert kept and float(np.float32(20.3)) < 20.3
    sel = j_parse(QUERIES["object-cut"]).object_stage[0]
    assert isinstance(sel, ObjectSelection)
    data = {b: js.read_jagged(b)[0] if js.branches[b].jagged else js.read_flat(b)
            for b in ("nJet", "Jet_pt")}
    assert eval_node(sel, data, N)[event]
    assert not (data["Jet_pt"].astype(np.float64) >= 20.3)[
        np.cumsum(data["nJet"])[event] - 1]
    program, (t, v, w, _) = _padded(ts, "object-cut")
    assert tops.predicate_eval(t, v, w, program, device="cpu")[event] == 1


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_jax_padded_route_at_float32_edges(runs, qname, record_property):
    """Records, asserting nothing of it, how far the JAX package's padded
    route (``fused_backend="xla"``, float32) departs from its staged run at
    these events: the survivors each keeps."""
    stores, jax_run = runs
    xla = JEngine(stores(None)[0], chunk_events=16, fused_backend="xla").run(
        QUERIES[qname], "near_data")
    staged = jax_run(qname, 16, fused=False)
    record_property("survivors_xla_staged", (xla.n_passed, staged.n_passed))
    assert xla.n_input == N
