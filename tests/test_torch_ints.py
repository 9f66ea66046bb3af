"""Integer branches and ANY over non-bool branches through every route of
the port, held to the JAX package's staged run bit for bit.

The window is ``chip_smoke.int_window()``: 64 events in four baskets of
16, whose ``event`` numbers lie on both sides of 2^24 and above 10^8, an
int32 word holding -2^31 and 2^31 - 1, a jagged int32 ``Jet_id`` in
[2^24 - 20, 2^24 + 20] and trigger words ``HLT_i`` (int32: -3, -1, 0, 1,
2) and ``HLT_f`` (float32: -1, -0.0, +0.0, 0.3, 1, NaN).  The queries are
``chip_smoke.INT_QUERIES``: event picks, cuts and an expression on
``event``, ``abs<`` / ``abs>`` across -2^31, ``Jet_id`` as a COUNT cut,
an HT object cut, an HT weight and a ``sum()``, and ANY over the trigger
words, one of them absent.

The staged evaluator compares an integer column in float64 against a
Python float (exactly against an int), takes numpy's integer abs, reads
HT weights and expression leaves as float64, and reads an ANY branch as
bool.  A float32 plane rounds every such number here, and ANY's compiled
``>= 0.5`` fails -3, -1, 0.3 and NaN: the port's padded route carries
each integer branch's int32 bits with its kind, and every route reads ANY
as nonzero.  The JAX package's padded route and its fused host evaluator
depart from its staged run here; one test records by how much, asserting
nothing of it.
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

import chip_smoke  # noqa: E402  (the int window and its queries)
from repro.core import SkimEngine as JEngine  # noqa: E402
from repro.core.neardata import skim_mask as j_skim_mask  # noqa: E402
from repro.core.planner import plan_skim as j_plan  # noqa: E402
from repro.core.query import eval_stage  # noqa: E402
from repro.core.query import parse_query as j_parse  # noqa: E402
from repro.data.store import EventStore as JStore  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import SkimEngine as TEngine  # noqa: E402
from repro_torch.core.neardata import (  # noqa: E402
    build_padded_inputs,
    program_kinds,
    skim_mask,
    window_pad_K,
)
from repro_torch.core.planner import plan_skim as t_plan  # noqa: E402
from repro_torch.core.query import parse_query as t_parse  # noqa: E402
from repro_torch.data.store import EventStore as TStore  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import predicate_eval as tpe  # noqa: E402
from repro_torch.kernels import program as tprog  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import skim_fused as tsf  # noqa: E402
from test_torch_engine import assert_same_result  # noqa: E402

N = chip_smoke.INT_EVENTS
BASKET = chip_smoke.INT_BASKET
QUERIES = chip_smoke.INT_QUERIES
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

# the JAX package's staged run's survivors on the window, at both chunks
STAGED_SURVIVORS = {
    "event-pick": 1, "event-gt": 4, "event-expr": 35, "run-lumi-event": 1,
    "abs-lt": 63, "abs-gt": 1, "jet-id": 5, "ht-id-cut": 37, "ht-of-id": 28,
    "expr-sum-id": 28, "any-nonbool": 56, "any-absent": 44,
}

# the queries with an ANY group: the JAX package's fused host evaluator
# reads ANY as its compiled ">= 0.5" and keeps other survivors, so the
# port's ledgers are held to it only where they cannot depend on them
ANY_QUERIES = {"any-nonbool", "any-absent"}


@pytest.fixture(scope="module")
def window():
    return chip_smoke.int_window()


@pytest.fixture(scope="module")
def runs(window):
    """Store pairs by decode backend and the JAX package's runs, cached."""
    columns, jagged = window
    cache = {}

    def stores(decode):
        if ("stores", decode) not in cache:
            kw = {"jagged": jagged, "basket_events": BASKET, "decode_backend": decode}
            cache["stores", decode] = (JStore.from_arrays(columns, **kw),
                                       TStore.from_arrays(columns, **kw, device="cpu"))
        return cache["stores", decode]

    def jax_run(qname, chunk, decode=None, backend="host", **run_kw):
        key = (qname, chunk, decode, backend, tuple(sorted(run_kw.items())))
        if key not in cache:
            kw = {} if run_kw.get("fused") is False else {"fused_backend": backend}
            cache[key] = JEngine(stores(decode)[0], chunk_events=chunk, **kw).run(
                QUERIES[qname], "near_data", **run_kw)
        return cache[key]

    return stores, jax_run


def _staged_mask(js, qname):
    """The JAX package's staged evaluator over the whole window as one."""
    plan = j_plan(j_parse(QUERIES[qname]), js)
    data = {b: js.read_jagged(b)[0] if js.branches[b].jagged else js.read_flat(b)
            for b in plan.filter_branches}
    mask = np.ones(N, bool)
    for _, stage in plan.query.stages():
        mask &= eval_stage(stage, data, N)
    return mask


def _padded(ts, qname, kinds=True):
    """The port's padded inputs of the whole window as one (the engine's
    layout with the plane kinds, or the JAX package's float32 one), the
    event index as the payload."""
    plan = t_plan(t_parse(QUERIES[qname]), ts)
    program = plan.compiled_program()
    data = {b: ts.read_jagged(b)[0] if ts.branches[b].jagged else ts.read_flat(b)
            for b in plan.filter_branches}
    k = program_kinds(program, ts) if kinds else None
    pb = build_padded_inputs(data, program, ts, K=window_pad_K(data, program, ts),
                             include_index=True, to_device=False, kinds=k)
    return program, k, [torch.from_numpy(np.asarray(x))
                        for x in (pb.terms, pb.valid, pb.weights, pb.payload)]


def test_int_window_holds_every_case(window, runs):
    """The window's values are the ones the queries are about, and the
    staged run keeps the pinned survivors at both chunks."""
    columns, _ = window
    stores, jax_run = runs
    ev = columns["event"]
    assert (ev < 1 << 24).any() and (ev > 1 << 24).any() and (ev > 10**8).any()
    assert {-(1 << 31), (1 << 31) - 1} <= set(columns["Word_i32"].tolist())
    ids = columns["Jet_id"]
    assert ids.min() >= (1 << 24) - 20 and ids.max() <= (1 << 24) + 20
    assert set(chip_smoke.INT_HLT_I) == set(columns["HLT_i"].tolist())
    f = columns["HLT_f"]
    assert np.isnan(f).any() and (np.signbit(f) & (f == 0)).any()
    assert {-1.0, 0.0, 0.3, 1.0} <= set(np.float64(f[~np.isnan(f)]).round(6).tolist())
    assert set(QUERIES) == set(STAGED_SURVIVORS)
    for qname, want in STAGED_SURVIVORS.items():
        for chunk in CHUNKS:
            assert jax_run(qname, chunk, fused=False).n_passed == want, (qname, chunk)
        assert int(_staged_mask(stores(None)[0], qname).sum()) == want


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("qname", sorted(QUERIES))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_route_returns_the_staged_run_on_ints(runs, route, qname, chunk):
    """Survivors and output bytes equal the JAX package's staged run; the
    fetch, cascade and decode ledgers equal its run of the same
    configuration on its host evaluator (with ANY, every ledger but the
    survivors and the output, which that evaluator decides otherwise).  A
    batch freezes its stage order, so the batched run keeps the preload
    run's bytes instead."""
    stores, jax_run = runs
    port_kw, run_kw, decode = ROUTES[route]
    t = TEngine(stores(decode)[1], chunk_events=chunk, device="cpu", **port_kw).run(
        QUERIES[qname], "near_data", **run_kw)
    staged = jax_run(qname, chunk, fused=False)
    assert t.n_passed == staged.n_passed == STAGED_SURVIVORS[qname]
    assert t.n_input == staged.n_input == N
    assert t.output._blobs == staged.output._blobs
    assert t.output.manifest_hash() == staged.output.manifest_hash()
    if "device_batch" in port_kw:
        preload = jax_run(qname, chunk, cascade=False)
        assert (t.stats.bytes_fetched + t.stats.cascade_bytes_skipped
                == preload.stats.bytes_fetched)
        return
    j = jax_run(qname, chunk, decode, **run_kw)
    if route == "staged" or qname not in ANY_QUERIES:
        assert_same_result(t, j, same_backend=route == "staged")
        return
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t.plan.describe() == j.plan.describe()
    assert t.extras.get("cascade_order") == j.extras.get("cascade_order")

    def fetches(res):  # each stage's ledger but the survivors it counted
        return [{k: v for k, v in st.items()
                 if k not in ("events_out", "observed_selectivity")}
                for st in res.extras.get("cascade_stages", [])]

    assert fetches(t) == fetches(j)


ENTRIES = ("predicate_eval", "predicate_eval_batch", "cascade_stage", "skim_fused",
           "skim_fused_batch")


def _kept(packed, count):
    mask = np.zeros(N, bool)
    mask[packed[: int(count), 0].numpy().astype(np.int64)] = True
    return mask


@pytest.mark.parametrize("qname", sorted(QUERIES))
@pytest.mark.parametrize("entry", ENTRIES)
def test_kernel_wrappers_with_kinds_equal_the_staged_evaluator(runs, entry, qname):
    """The kernel wrappers the engine's routes call, on the window's padded
    inputs with their plane kinds (a CPU tensor takes the plain version):
    masks, counts and basket bits bit for bit those of the JAX package's
    staged evaluator."""
    stores, _ = runs
    js, ts = stores(None)
    want = _staged_mask(js, qname)
    program, kinds, (t, v, w, p) = _padded(ts, qname)
    assert any(k != tprog.KIND_F32 for k in kinds) or qname == "any-absent"
    if entry == "predicate_eval":
        got = tpe.predicate_eval(t, v, w, program, kinds).numpy().astype(bool)
    elif entry == "predicate_eval_batch":
        got = tpe.predicate_eval_batch(t[None], v[None], w[None], program,
                                       kinds)[0].numpy().astype(bool)
    elif entry == "cascade_stage":
        nb = N // BASKET
        packed = torch.from_numpy(tops.pack_mask(np.ones((1, N), bool)).view(np.int32))
        seg = torch.from_numpy((np.arange(N, dtype=np.int32) // BASKET)[None])
        words, out = tpe.cascade_stage(t[None], v[None], w[None], packed, seg, program,
                                       nb, kinds)
        got = tops.unpack_mask(words.numpy(), N)[0]
        np.testing.assert_array_equal(out[0, :nb].numpy(),
                                      want.reshape(nb, -1).any(axis=1).astype(np.int32))
        assert int(out[0, nb]) == int(want.sum())
    elif entry == "skim_fused":
        got = _kept(*tsf.skim_fused(t, v, w, p, program, kinds))
    else:
        packed, counts = tsf.skim_fused_batch(t[None], v[None], w[None], p[None],
                                              program, kinds)
        got = _kept(packed[0], counts[0])
    np.testing.assert_array_equal(got, want)


def _any_read_as_bool(program, terms):
    """``terms`` with each ANY term's plane as 0/1 (its nonzero slots):
    the JAX kernels' compiled ``>= 0.5`` reads that plane as the port and
    the staged evaluator read the original."""
    terms = terms.clone()
    for grp in program.groups:
        if grp.kind == tprog.GROUP_ANY:
            for t in grp.term_ids:
                terms[t] = (terms[t] != 0).to(terms.dtype)
    return terms


# flat and per-object cuts only: the port's group values (HT, EXPR) are
# float64 since the float32 cut-edge repair (ROADMAP C8), the JAX kernels'
# float32, so there the port departs from them on purpose
FLOAT32_FORM_QUERIES = ("abs-gt", "abs-lt", "event-gt", "event-pick", "jet-id",
                        "run-lumi-event")


@pytest.mark.parametrize("qname", FLOAT32_FORM_QUERIES + tuple(sorted(ANY_QUERIES)))
def test_public_forms_read_float32_planes_as_the_jax_kernels_do(runs, qname):
    """``ops.predicate_eval`` and ``ops.skim_fused``, the JAX package's
    forms, read every plane as float32: on the JAX package's float32
    layout they equal its Pallas kernels in interpret mode bit for bit,
    with ANY read as nonzero on both sides."""
    stores, _ = runs
    _, ts = stores(None)
    program, kinds, (t, v, w, p) = _padded(ts, qname, kinds=False)
    assert kinds is None
    jt = _any_read_as_bool(program, t).numpy()
    want = jops.predicate_eval(jt, v.numpy(), w.numpy(), program, interpret=True)
    got = tops.predicate_eval(t, v, w, program)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_p, want_n = jops.skim_fused(jt, v.numpy(), w.numpy(), p.numpy(), program,
                                     interpret=True)
    got_p, got_n = tops.skim_fused(t, v, w, p, program)
    assert int(got_n) == int(want_n)
    assert got_p.numpy().tobytes() == np.asarray(want_p).tobytes()


def test_mesh_skim_keeps_the_jax_form_on_float32_planes(runs):
    """The mesh skim's ``skim_mask`` takes caller-built float32 planes, as
    the JAX package's does, and equals it bit for bit there: it rounds the
    integers as the JAX form does, which departs from the staged run (the
    open remainder of ROADMAP C9)."""
    stores, _ = runs
    js, ts = stores(None)
    departs = 0
    for qname in FLOAT32_FORM_QUERIES:  # the mesh skim reads ANY as nonzero
        program, _, (t, v, w, _) = _padded(ts, qname, kinds=False)
        got = skim_mask(t, v, w, program).numpy()
        want = np.asarray(j_skim_mask(t.numpy(), v.numpy(), w.numpy(), program))
        np.testing.assert_array_equal(got, want, err_msg=qname)
        departs += int((got != _staged_mask(js, qname)).any())
    assert departs == len(FLOAT32_FORM_QUERIES)


def test_integer_planes_hold_int32_bits_by_kind(runs):
    """``program_kinds`` names each term's and weights plane's type from
    the store; ``build_padded_inputs`` with the kinds writes an integer's
    int32 bits, without them its float32 value; the descriptors carry the
    kinds (each term slot's, then each term's beside its id, the weights
    plane's in the group row) and every threshold in float64."""
    stores, _ = runs
    _, ts = stores(None)
    program, kinds, (t, _, w, _) = _padded(ts, "ht-of-id")
    assert kinds == (tprog.KIND_I32, tprog.KIND_I32)  # Jet_id's term, its weights
    _, none, (t32, _, w32, _) = _padded(ts, "ht-of-id", kinds=False)
    valid_ids = t.view(torch.int32)[0][t.view(torch.int32)[0] != 0]
    assert int(valid_ids.min()) >= (1 << 24) - 20
    assert torch.equal(t32[0], t.view(torch.int32)[0].to(torch.float32))
    assert torch.equal(w.view(torch.int32), t.view(torch.int32))
    ints, doubles, off = tsf.flatten_program(program, kinds)
    T, (grp,) = program.n_terms, program.groups
    assert ints[off["kinds"]: off["kinds"] + T].tolist() == list(kinds[:T])
    n = len(grp.term_ids)
    assert (ints[off["term_kinds"]: off["term_kinds"] + n].tolist()
            == [kinds[t] for t in grp.term_ids])
    assert ints[off["groups"] + 8] == kinds[T]  # the weights plane's, in the row
    assert doubles[off["thrs"]] == grp.thrs[0]
    program, kinds, _ = _padded(ts, "any-nonbool")
    assert kinds == (tprog.KIND_I32, tprog.KIND_F32, tprog.KIND_F32)
    assert tprog.value_kind(np.bool_) == tprog.value_kind(np.uint16) == tprog.KIND_UINT
    assert tprog.value_kind(np.float64) == tprog.KIND_F32


@pytest.mark.parametrize("dtype,least", [(np.int32, -(1 << 31)), (np.int16, -(1 << 15)),
                                         (np.int8, -(1 << 7)), (np.uint16, 0)])
def test_integer_abs_wraps_at_the_type_least_value_as_numpy(dtype, least):
    """``abs<`` / ``abs>`` on an integer plane take numpy's abs of the
    branch's own type, which leaves its least value negative, then compare
    in float64; other ops compare the value in float64, so ``100 >=
    100.000001`` is false where float32 would call it true."""
    info = np.iinfo(dtype)
    x = np.array([least, least + 1, info.max, 0, 100, 7], dtype)
    plane = torch.from_numpy(x.astype(np.int32)).view(torch.float32)
    kind = tprog.value_kind(dtype)
    for op, thr in (("abs<", float(info.max)), ("abs>", float(info.max) - 0.5),
                    (">=", 100.000001), ("==", 7.0), ("<", float(least) + 0.5)):
        got = tref.term_cut(plane, tprog.OP_IDS[op], thr, kind).numpy()
        a = np.abs(x) if op.startswith("abs") else x
        want = {"<": np.less, ">": np.greater, ">=": np.greater_equal,
                "==": np.equal}[op.removeprefix("abs")](a, thr)
        np.testing.assert_array_equal(got, want, err_msg=f"{dtype.__name__} {op}")


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_jax_departures_on_ints(runs, qname, record_property):
    """Records, asserting nothing of it, how far the JAX package's padded
    route (``fused_backend="xla"``) and its fused host evaluator
    (``program_eval_np``, which reads ANY as ``>= 0.5``) depart from its
    staged run here: the survivors each keeps."""
    _, jax_run = runs
    staged = jax_run(qname, BASKET, fused=False)
    xla = jax_run(qname, BASKET, backend="xla")
    host = jax_run(qname, BASKET)
    record_property("survivors_xla_host_staged",
                    (xla.n_passed, host.n_passed, staged.n_passed))
    assert xla.n_input == host.n_input == N
