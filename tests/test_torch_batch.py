"""The PyTorch port's batched cascade against the JAX package's, on the CPU.

The second slice of the port: ``run_skim(..., device_batch=B)`` runs the
cascade one stage per window-batch (``CascadeExecutor.run_window_batch``
→ ``ops.cascade_stage_step_staged``).  On the CPU the port's stage step
takes its plain version (``ref.cascade_stage_ref``).  The public
``ops.cascade_stage_step`` is held here against the JAX package's (its
vmapped jnp version), called with the same arguments; the batched
predicate against ``predicate_eval_batch`` (Pallas, interpret mode); and
the engine against the JAX engine on the store and query of
``tests/test_device_batch.py``.
The verifier and the cache's content address, which the batched path and
the planner call, are held against the JAX package's as well.

Tolerances: exact everywhere, except the mass and ΔR groups, whose masks
may differ only at a cut's edge (``test_torch_kernels.py`` states the
tolerance and why).
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import chip_smoke  # noqa: E402  (the sweep programs and inputs the card checks use)
from repro.analysis import verify as jverify  # noqa: E402
from repro.cluster import cache as jcache  # noqa: E402
from repro.core.engine import Breakdown as JBreakdown  # noqa: E402
from repro.core.engine import run_skim as j_run_skim  # noqa: E402
from repro.core.plan import CascadeExecutor as JExecutor  # noqa: E402
from repro.core.planner import plan_skim as j_plan_skim  # noqa: E402
from repro.core.query import parse_query as j_parse_query  # noqa: E402
from repro.core.zonemap import WindowDecision as JWindowDecision  # noqa: E402
from repro.data.store import EventStore as JStore  # noqa: E402
from repro.data.store import FetchStats as JFetchStats  # noqa: E402
from repro.data.synth import make_nanoaod_like as j_make  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import predicate_eval as jpe  # noqa: E402
from repro_torch.analysis import verify as tverify  # noqa: E402
from repro_torch.cluster import cache as tcache  # noqa: E402
from repro_torch.core.engine import Breakdown as TBreakdown  # noqa: E402
from repro_torch.core.engine import SkimEngine  # noqa: E402
from repro_torch.core.engine import run_skim as t_run_skim  # noqa: E402
from repro_torch.core.expr import RPN_ADD, RPN_CONST  # noqa: E402
from repro_torch.core.plan import CascadeExecutor as TExecutor  # noqa: E402
from repro_torch.core.planner import plan_skim as t_plan_skim  # noqa: E402
from repro_torch.core.query import parse_query as t_parse_query  # noqa: E402
from repro_torch.core.zonemap import WindowDecision as TWindowDecision  # noqa: E402
from repro_torch.data.store import EventStore as TStore  # noqa: E402
from repro_torch.data.store import FetchStats as TFetchStats  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like as t_make  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import predicate_eval as tpe  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.program import GROUP_DR, GROUP_MASS  # noqa: E402
from test_device_batch import BASKET, N_EVENTS, QUERY  # noqa: E402
from test_torch_kernels import SWEEP, _assert_masks_agree, _jax_program  # noqa: E402
from tools.skimlint.fixtures import (  # noqa: E402
    FIXTURE_QUERIES,
    FIXTURE_STORE,
    FIXTURE_WINDOW_EVENTS,
)

# ---------------------------------------------------------------------------
# the stage step and the batched predicate
# ---------------------------------------------------------------------------


def _has_pair_group(program) -> bool:
    return any(g.kind in (GROUP_MASS, GROUP_DR) for g in program.groups)


def stage_inputs(rng, program, B, E, K, basket_events):
    """``chip_smoke.batch_inputs`` with the carried mask as uint32 words."""
    *arrays, packed, seg, nb = chip_smoke.batch_inputs(
        rng, program, B, E, K, basket_events)
    return (*arrays, packed.view(np.uint32), seg, nb)


def _side_by_side(x):
    """(B, P, E, K) -> (P, B*E, K): a batch as one long window."""
    B, P, E, K = x.shape
    return np.ascontiguousarray(x.transpose(1, 0, 2, 3).reshape(P, B * E, K))


@pytest.mark.parametrize("backend", ["host", "torch"])
@pytest.mark.parametrize("name", sorted(SWEEP))
def test_cascade_stage_ref_matches_jax(name, backend):
    """The two packages' ``ops.cascade_stage_step``, called with the same
    arguments (the JAX package's without Pallas and without donation):
    new_packed, basket_alive and counts bit-identical, except mass/ΔR
    events at a cut's edge, and the same dispatch ledger."""
    prog = SWEEP[name]
    B, E, K, be = 3, 1024, 4, 256
    terms, valid, weights, packed, seg, nb = stage_inputs(
        np.random.default_rng(21), prog, B, E, K, be
    )
    jops.reset_dispatch_stats()
    jp, jb, jc = jops.cascade_stage_step(
        terms, valid, weights, packed, seg, _jax_program(prog), nb,
        use_pallas=False, donate=False,
    )
    tops.reset_dispatch_stats()
    tp, tb, tc = tops.cascade_stage_step(
        terms, valid, weights, packed, seg, prog, nb, backend=backend, device="cpu",
    )
    assert tops.dispatch_stats() == jops.dispatch_stats()
    assert tops.dispatch_stats() == {"dispatches": 1, "compiles": 1, "warmups": 0}
    want = [np.asarray(jp).view(np.int32), np.asarray(jb), np.asarray(jc)]
    got = [tp.numpy(), tb.numpy(), tc.numpy()]
    assert [g.dtype for g in got] == [np.int32] * 3
    assert got[2][1] == 0 and got[1][1].sum() == 0  # the all-dead window
    if not _has_pair_group(prog):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return
    m_got = tops.unpack_mask(got[0], E).reshape(-1)
    m_want = tops.unpack_mask(want[0], E).reshape(-1)
    alive = tops.unpack_mask(packed, E).reshape(-1)
    _assert_masks_agree(prog, _side_by_side(terms), _side_by_side(valid),
                        m_got | ~alive, m_want | ~alive)
    for side, (words, bits, counts) in (("port", got), ("jax", want)):
        mask = tops.unpack_mask(words, E)
        np.testing.assert_array_equal(counts, mask.sum(axis=1), err_msg=side)
        for b in range(B):
            expect = np.zeros(nb, np.int32)
            expect[np.unique(seg[b][mask[b]])] = 1
            np.testing.assert_array_equal(bits[b], expect, err_msg=side)


@pytest.mark.parametrize("name", sorted(SWEEP))
def test_predicate_eval_batch_ref_matches_pallas_interpret(name):
    prog = SWEEP[name]
    terms, valid, weights, *_ = stage_inputs(
        np.random.default_rng(22), prog, 2, 1024, 4, 256
    )
    want = np.asarray(jpe.predicate_eval_batch(
        jnp.asarray(terms), jnp.asarray(valid), jnp.asarray(weights),
        program=_jax_program(prog), interpret=True, event_tile=512,
    ))
    got = tpe.predicate_eval_batch(
        *(torch.from_numpy(x) for x in (terms, valid, weights)), prog
    ).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    _assert_masks_agree(prog, _side_by_side(terms), _side_by_side(valid),
                        got.reshape(-1) > 0, want.reshape(-1) > 0)


@pytest.mark.parametrize("E", [1, 300, 4097])
@pytest.mark.parametrize("name", ["count", "ht", "any", "expr"])
def test_predicate_eval_ragged_matches_pallas_interpret(name, E):
    """``ops.predicate_eval`` pads nothing; the JAX package's pads to its
    tile and slices back."""
    prog = SWEEP[name]
    terms, valid, weights, _ = chip_smoke.sweep_inputs(
        np.random.default_rng(E), prog, E, 4, 1
    )
    want = np.asarray(jops.predicate_eval(
        terms, valid, weights, _jax_program(prog), interpret=True
    ))
    got = tops.predicate_eval(terms, valid, weights, prog, device="cpu").numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_pack_bits_is_pack_mask_including_bit_31():
    rng = np.random.default_rng(3)
    mask = rng.random((3, 256)) < 0.5
    mask[:, 31::32] = True  # bit 31 of every word: the sign bit of int32
    words = tref.pack_bits(torch.from_numpy(mask))
    assert words.dtype == torch.int32
    assert words.numpy().tobytes() == tops.pack_mask(mask).tobytes()
    assert (words < 0).all()
    np.testing.assert_array_equal(tref.unpack_bits(words, 256).numpy(), mask)
    np.testing.assert_array_equal(tref.unpack_bits(words, 200).numpy(), mask[:, :200])


@pytest.mark.parametrize("backend", ["host", "torch"])
def test_stage_step_updates_the_mask_in_place_and_reads_back_once(backend):
    prog = SWEEP["count"]
    terms, valid, weights, packed, seg, nb = stage_inputs(
        np.random.default_rng(4), prog, 3, 512, 4, 128
    )
    carried = torch.from_numpy(packed.view(np.int32).copy())
    seg_t = torch.from_numpy(seg)
    want = tref.cascade_stage_ref(
        *(torch.from_numpy(x) for x in (terms, valid, weights)),
        carried.clone(), seg_t, prog, nb,
    )
    inputs = tops.CascadeInputs(terms.shape, prog.n_groups, range(3))
    for s in range(3):
        for part, dense in zip(inputs.window(s), (terms, valid, weights)):
            part[...] = dense[s]
    tops.reset_dispatch_stats()
    out, summary = tops.cascade_stage_step_staged(
        inputs, carried, seg_t, prog, nb, backend=backend, device="cpu",
    )
    assert out is carried and torch.equal(carried, want[0])
    assert summary.shape == (3, nb + 1) and summary.dtype == torch.int32
    host_bits, host_counts = tops.stage_summary_host(summary)
    np.testing.assert_array_equal(host_bits, want[1].numpy().astype(bool))
    np.testing.assert_array_equal(host_counts, want[2].numpy())
    assert tops.dispatch_stats() == {"dispatches": 1, "compiles": 1, "warmups": 0}
    with pytest.raises(ValueError):
        tops.cascade_stage_step_staged(inputs, carried, seg_t, prog, nb,
                                       backend="pallas", device="cpu")


@pytest.mark.parametrize("backend", ["host", "torch"])
@pytest.mark.parametrize("name", ["count", "ht", "dr_pair", "expr"])
def test_public_stage_step_on_tensors_equals_it_on_numpy(name, backend):
    """Tensors are read where they are and the carried tensor is updated
    in place; a numpy mask is copied.  Both give the same words, and the
    basket bits and counts are views of one (B, nb + 1) buffer."""
    prog = SWEEP[name]
    arrays = stage_inputs(np.random.default_rng(6), prog, 3, 1024, 4, 256)
    terms, valid, weights, packed, seg, nb = arrays
    before = packed.copy()
    want = tops.cascade_stage_step(*arrays[:5], prog, nb, backend=backend,
                                   device="cpu")
    np.testing.assert_array_equal(packed, before)
    carried = torch.from_numpy(packed.view(np.int32).copy())
    tops.reset_dispatch_stats()
    got = tops.cascade_stage_step(
        *(torch.from_numpy(x) for x in (terms, valid, weights)), carried,
        torch.from_numpy(seg), prog, nb, backend=backend, device="cpu")
    assert tops.dispatch_stats() == {"dispatches": 1, "compiles": 1, "warmups": 0}
    assert got[0] is carried
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    bits, counts = got[1], got[2]
    assert bits.shape == (3, nb) and counts.shape == (3,)
    assert bits.data_ptr() == counts.data_ptr() - 4 * nb  # one summary buffer


def test_public_stage_step_rejects_what_it_cannot_run(monkeypatch):
    prog = SWEEP["count"]
    terms, valid, weights, packed, seg, nb = stage_inputs(
        np.random.default_rng(7), prog, 2, 512, 4, 128)
    step = tops.cascade_stage_step
    with pytest.raises(ValueError):  # a CUDA stage on the CPU
        step(terms, valid, weights, packed, seg, prog, nb, backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        step(terms, valid, weights, packed, seg, prog, nb, backend="pallas",
             device="cpu")
    with pytest.raises(ValueError):  # a term plane short
        step(terms[:, 1:], valid, weights, packed, seg, prog, nb, device="cpu")
    with pytest.raises(ValueError):
        step(terms, valid[:, :, :256], weights, packed, seg, prog, nb, device="cpu")
    with pytest.raises(ValueError):  # tensors elsewhere than the stage
        step(*(torch.from_numpy(x).to("meta") for x in (terms, valid, weights)),
             packed, seg, prog, nb, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        step(terms, valid, weights, packed, seg, prog, nb)


def test_cascade_stage_rejects_what_the_kernel_does_not_take():
    prog = SWEEP["count"]
    terms, valid, weights, packed, seg, nb = stage_inputs(
        np.random.default_rng(5), prog, 2, 512, 4, 128
    )
    t, v, w = (torch.from_numpy(x) for x in (terms, valid, weights))
    p, s = torch.from_numpy(packed.view(np.int32)), torch.from_numpy(seg)
    bad = [
        (t[:, :, :500], v[:, :, :500], w[:, :, :500], p, s[:, :500]),  # E % 32
        (t, v, w, p.to(torch.int64), s),
        (t, v, w, p[:, :-1], s),
        (t, v, w, p, s.to(torch.int64)),
        (t.double(), v, w, p, s),
        (t, v[:, :, :256], w, p, s),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tpe.cascade_stage(*args, prog, nb)
    with pytest.raises(ValueError):
        tpe.cascade_stage(t, v, w, p, s, prog, 0)


# ---------------------------------------------------------------------------
# the engine: port against the JAX package
# ---------------------------------------------------------------------------

ALL = N_EVENTS // BASKET + 1


@pytest.fixture(scope="module")
def stores():
    kw = dict(n_hlt=16, n_filler=8, basket_events=BASKET)
    return j_make(N_EVENTS, **kw), t_make(N_EVENTS, device="cpu", **kw)


def _fetch(stats) -> dict:
    return {k: getattr(stats, k) for k in (
        "bytes_fetched", "requests", "bytes_skipped", "requests_skipped",
        "cascade_bytes_skipped")} | {"by_branch": dict(stats.by_branch)}


def _assert_runs_equal(tr, jr):
    assert tr.n_passed == jr.n_passed > 0
    assert tr.n_input == jr.n_input
    assert tr.output.manifest_hash() == jr.output.manifest_hash()
    assert tr.output._blobs == jr.output._blobs
    assert _fetch(tr.stats) == _fetch(jr.stats)
    for key in ("cascade_order", "cascade_stages", "device_batch",
                "device_dispatches"):
        assert tr.extras[key] == jr.extras[key], key


@pytest.mark.parametrize("device_batch", [1, 3, ALL])
@pytest.mark.parametrize("pipeline", [False, "threads"])
def test_batched_engine_matches_jax(stores, device_batch, pipeline):
    js, ts = stores
    kw = dict(mode="near_data", pipeline=pipeline, prune=False, cascade=True,
              device_batch=device_batch)
    jr = j_run_skim(js, QUERY, **kw)
    tr = t_run_skim(ts, QUERY, device="cpu", **kw)
    _assert_runs_equal(tr, jr)


def test_batched_engine_torch_backend_matches_jax(stores):
    """The plain version over the padded layout (``fused_backend="torch"``)
    against the JAX package's jnp stage step."""
    js, ts = stores
    kw = dict(mode="near_data", pipeline=False, prune=False, cascade=True,
              device_batch=3)
    jr = j_run_skim(js, QUERY, fused_backend="xla", **kw)
    tr = t_run_skim(ts, QUERY, device="cpu", fused_backend="torch", **kw)
    _assert_runs_equal(tr, jr)


@pytest.mark.parametrize("device_batch", [1, 3, ALL])
def test_batched_engine_ledger_exact(stores, device_batch):
    """fetched + skipped == the preload run's fetched bytes."""
    _, ts = stores
    kw = dict(mode="near_data", pipeline=False, prune=False, device="cpu")
    preload = t_run_skim(ts, QUERY, cascade=False, **kw)
    res = t_run_skim(ts, QUERY, cascade=True, device_batch=device_batch, **kw)
    assert (
        res.stats.bytes_fetched + res.stats.cascade_bytes_skipped
        == preload.stats.bytes_fetched
    )


def test_device_batch_validated(stores):
    _, ts = stores
    for bad in (0, -2):
        with pytest.raises(ValueError):
            SkimEngine(ts, device_batch=bad, device="cpu")
    assert SkimEngine(ts, device_batch=4, device="cpu").device_batch == 4


# ---------------------------------------------------------------------------
# the dispatch ledger: compiles and warm-ups equal the JAX package's
# ---------------------------------------------------------------------------


def _spiky_columns():
    """tests/test_device_batch.py's spiky store: the last window's electron
    multiplicity is ~8x the rest, so ``pad_K`` grows on the last batch."""
    rng = np.random.default_rng(5)
    n = 8 * BASKET
    lam = np.where(np.arange(n) < n - BASKET, 1.2, 10.0)
    n_el = rng.poisson(lam).astype(np.int32)
    tot = int(n_el.sum())
    cols = {
        "nElectron": n_el,
        "Electron_pt": (rng.exponential(25.0, tot) + 3.0).astype(np.float32),
        "Electron_eta": rng.uniform(-2.5, 2.5, tot).astype(np.float32),
        "MET_pt": (rng.exponential(30.0, n) + 1.0).astype(np.float32),
        "HLT_IsoMu24": rng.random(n) < 0.3,
        "event": np.arange(n, dtype=np.int32),
        "luminosityBlock": (np.arange(n) // 1000).astype(np.int32),
    }
    jagged = {"Electron_pt": "nElectron", "Electron_eta": "nElectron"}
    return cols, jagged


def _sweeps(pkg):
    """(stats after one sweep, stats after two, masks of both sweeps)."""
    Store, plan_skim, parse_query, Executor, Breakdown, FetchStats, ops, backend, kw = pkg
    cols, jagged = _spiky_columns()
    store = Store.from_arrays(cols, jagged=jagged, basket_events=BASKET, **kw)
    plan = plan_skim(parse_query(QUERY), store, cascade=True)
    ex = Executor(plan, store, adaptive=False, backend=backend,
                  **({"device": "cpu"} if kw else {}))
    windows = [(a, min(a + BASKET, store.n_events))
               for a in range(0, store.n_events, BASKET)]
    ops.reset_dispatch_stats()
    stats, masks = [], []
    for _ in range(2):
        for i in range(0, len(windows), 3):
            entries = [(a, b, None, Breakdown(), FetchStats(), {})
                       for a, b in windows[i: i + 3]]
            masks.extend(o.mask for o in ex.run_window_batch(entries, pad_B=3))
        stats.append(ops.dispatch_stats())
    return stats, masks


JAX_PKG = (JStore, j_plan_skim, j_parse_query, JExecutor, JBreakdown,
           JFetchStats, jops, "xla", {})
PORT_PKG = (TStore, t_plan_skim, t_parse_query, TExecutor, TBreakdown,
            TFetchStats, tops, "torch", {"device": "cpu"})


@pytest.fixture(scope="module")
def spiky_sweeps():
    return _sweeps(JAX_PKG), _sweeps(PORT_PKG)


def test_recompile_count_pinned_with_late_growing_pad_k(spiky_sweeps):
    (j_stats, j_masks), (t_stats, t_masks) = spiky_sweeps
    assert t_stats[0]["compiles"] > 0
    assert t_stats[1]["compiles"] == t_stats[0]["compiles"]
    assert t_stats[1]["dispatches"] > t_stats[0]["dispatches"] > 0
    for s_t, s_j in zip(t_stats, j_stats):
        assert s_t == s_j
    for m_t, m_j in zip(t_masks, j_masks):
        np.testing.assert_array_equal(m_t, m_j)


def test_warmups_ledgered_outside_dispatches(spiky_sweeps):
    (j_stats, _), (t_stats, _) = spiky_sweeps
    assert t_stats[0]["warmups"] > 0 and t_stats[0]["dispatches"] > 0
    assert t_stats[1]["warmups"] == t_stats[0]["warmups"]
    assert [s["warmups"] for s in t_stats] == [s["warmups"] for s in j_stats]


# ---------------------------------------------------------------------------
# the verifier and the cache's content address
# ---------------------------------------------------------------------------

DEVICE_BATCH_CASES = {
    # (spans, pad_E, pad_B, nb, basket_events, mask_words) -> rule code
    "batch-pad-alignment": ([(0, 100)], 500, 1, 3, 256, 15),
    "batch-mask-width": ([(0, 100)], 512, 1, 4, 256, 15),
    "batch-window-overflow": ([(0, 100), (100, 200)], 512, 1, 4, 256, 16),
    "batch-pad-coverage": ([(0, 600)], 512, 1, 4, 256, 16),
    "batch-basket-coverage": ([(300, 800)], 512, 1, 2, 256, 16),
}


@pytest.mark.parametrize("code", sorted(DEVICE_BATCH_CASES))
def test_verify_device_batch_rule_codes(code):
    args = DEVICE_BATCH_CASES[code]
    for mod in (jverify, tverify):
        with pytest.raises(mod.VerifyError) as exc:
            mod.verify_device_batch(*args)
        assert exc.value.invariant == code
    for mod in (jverify, tverify):
        mod.verify_device_batch([(0, 512), (512, 1000)], 512, 2, 4, 256, 16)


KITCHEN_SINK = next(d for d in FIXTURE_QUERIES if d["name"] == "kitchen-sink")


def _replace_group(program, g, **kw):
    groups = list(program.groups)
    groups[g] = dataclasses.replace(groups[g], **kw)
    return dataclasses.replace(program, groups=tuple(groups))


def _expr_g(program):
    return next(i for i, g in enumerate(program.groups) if g.rpn)


def _count_g(program):
    return next(i for i, g in enumerate(program.groups) if g.kind == 0)


# tests/test_verify.py's corruptions of the kitchen-sink program (the
# RPN opcodes have the same values in both packages)
PROGRAM_CASES = {
    "baseline": lambda p: p,
    "term-slot": lambda p: _replace_group(p, 0, term_ids=(999,)),
    "group-kind": lambda p: _replace_group(p, 0, kind=42),
    "term-op": lambda p: _replace_group(p, 0, ops=(99,) * len(p.groups[0].ops)),
    "wiring": lambda p: dataclasses.replace(
        p, group_collections=p.group_collections[:-1]),
    "min-count": lambda p: _replace_group(p, _count_g(p), min_count=-1),
    "rpn-opcode": lambda p: _replace_group(
        p, _expr_g(p), rpn=((99, p.groups[_expr_g(p)].rpn[0][1]),
                            *p.groups[_expr_g(p)].rpn[1:])),
    "rpn-unbalanced": lambda p: _replace_group(
        p, _expr_g(p), rpn=p.groups[_expr_g(p)].rpn + ((RPN_CONST, 1.0),)),
    "rpn-underflow": lambda p: _replace_group(
        p, _expr_g(p), rpn=((RPN_CONST, 1.0), (RPN_ADD, 0))),
    "rpn-constant": lambda p: _replace_group(
        p, _expr_g(p), rpn=((RPN_CONST, float("nan")),)),
}


def _invariant(mod, fn):
    try:
        fn()
    except mod.VerifyError as exc:
        return exc.invariant
    return None


@pytest.fixture(scope="module")
def kitchen():
    doc = {k: v for k, v in KITCHEN_SINK.items() if k != "name"}
    out = {}
    for name, (make, parse, plan_skim, mod) in {
        "jax": (j_make, j_parse_query, j_plan_skim, jverify),
        "port": (t_make, t_parse_query, t_plan_skim, tverify),
    }.items():
        kw = {"device": "cpu"} if name == "port" else {}
        store = make(**FIXTURE_STORE, **kw)
        query = parse(doc)
        out[name] = (store, query, plan_skim, mod)
    return out


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_verify_program_cases_match(kitchen, case):
    from repro.kernels.predicate_eval import compile_query as j_compile
    from repro_torch.kernels.program import compile_query as t_compile

    codes = {}
    for name, compile_query in (("jax", j_compile), ("port", t_compile)):
        _store, query, _plan, mod = kitchen[name]
        bad = PROGRAM_CASES[case](compile_query(query))
        codes[name] = _invariant(mod, lambda: mod.verify_program(bad))
    assert codes["port"] == codes["jax"]
    assert (codes["jax"] is None) == (case == "baseline")


WINDOW_DECISION = {JStore.__module__: JWindowDecision, TStore.__module__: TWindowDecision}


def _stage_with_two_branches(plan):
    return next(i for i, s in enumerate(plan.cascade.stages) if len(s.branches) > 1)


def _set_stage(plan, i, **kw):
    plan.cascade.stages[i] = dataclasses.replace(plan.cascade.stages[i], **kw)


PLAN_CASES = {
    "baseline": lambda plan, store: None,
    "missing-fetch": lambda plan, store: _set_stage(
        plan, _stage_with_two_branches(plan),
        branches=plan.cascade.stages[_stage_with_two_branches(plan)].branches[:-1]),
    "overfetch": lambda plan, store: _set_stage(
        plan, 0, branches=plan.cascade.stages[0].branches + (next(
            b for b in store.branch_names()
            if b not in set(plan.cascade.stages[0].branches)),)),
    "unpinned-head": lambda plan, store: setattr(
        plan.cascade, "static_order", list(reversed(plan.cascade.static_order))),
    "non-permutation": lambda plan, store: setattr(
        plan.cascade, "static_order", [0] * plan.cascade.n_stages),
    "selectivity": lambda plan, store: _set_stage(plan, 0, est_selectivity=1.5),
    "negative-bytes": lambda plan, store: _set_stage(plan, 0, est_bytes=-1),
    "partition": lambda plan, store: setattr(
        plan, "output_only_branches", plan.output_only_branches[:-1]),
    "unknown-branch": lambda plan, store: setattr(
        plan, "filter_branches", [*plan.filter_branches, "NoSuch_branch"]),
    "window-tiling": lambda plan, store: setattr(
        plan, "window_decisions",
        [WINDOW_DECISION[type(store).__module__](0, store.n_events // 2, "scan",
                                                 0, 0, 0, 0)]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_verify_plan_cases_match(kitchen, case):
    codes = {}
    for name in ("jax", "port"):
        store, query, plan_skim, mod = kitchen[name]
        plan = plan_skim(query, store, window_events=FIXTURE_WINDOW_EVENTS,
                         prune=True, cascade=True)
        PLAN_CASES[case](plan, store)
        codes[name] = _invariant(mod, lambda: mod.verify_plan(plan, store))
    assert codes["port"] == codes["jax"]
    assert (codes["jax"] is None) == (case == "baseline")


@pytest.mark.parametrize("doc", FIXTURE_QUERIES, ids=lambda d: d["name"])
def test_query_hash_and_versioned_key_match(doc):
    q = {k: v for k, v in doc.items() if k != "name"}
    assert tcache.canonical_query(q) == jcache.canonical_query(q)
    h = tcache.query_hash(q)
    assert h == jcache.query_hash(q)
    assert tcache.CACHE_KEY_VERSION == jcache.CACHE_KEY_VERSION
    assert tcache.versioned_key(h, "abc") == jcache.versioned_key(h, "abc")
    assert tcache.cache_key(q, "abc") == jcache.cache_key(q, "abc")


def test_result_cache_accounts_as_the_jax_package():
    stats = []
    for mod in (jcache, tcache):
        cache = mod.SkimResultCache(budget_bytes=100)
        cache.put("a", 1, 60, fetch_bytes=7)
        cache.put("a", 1, 60)
        cache.put("b", 2, 50)
        cache.get("b")
        cache.get("a")
        cache.get_many(["b", "c"])
        assert not cache.put("huge", 3, 101)
        stats.append(cache.stats.as_dict())
    assert stats[0] == stats[1]


def test_compile_and_plan_gates_reject_in_the_port(monkeypatch, kitchen):
    """``compile_query`` and ``plan_skim`` call the verify gates (on in
    the test suite): a corrupted cascade fails at plan time."""
    from repro_torch.core import plan as tplan

    store, query, plan_skim, mod = kitchen["port"]
    assert mod.verify_enabled()
    real = tplan.build_cascade

    def bad_cascade(q, s):
        cp = real(q, s)
        cp.static_order = [0] * cp.n_stages
        return cp

    monkeypatch.setattr(tplan, "build_cascade", bad_cascade)
    with pytest.raises(mod.VerifyError) as exc:
        plan_skim(query, store, window_events=FIXTURE_WINDOW_EVENTS, cascade=True)
    assert exc.value.invariant == "pinned-head"


# ---------------------------------------------------------------------------
# the build: headers are part of every library's name
# ---------------------------------------------------------------------------


def test_lib_path_changes_when_a_shared_header_changes(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build._CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = {name: _build.lib_path(name) for name in _build.SOURCES}
    assert before["predicate_eval"] != before["skim_fused"]
    header = csrc / "predicate.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.lib_path(name) for name in _build.SOURCES}
    for name in ("skim_fused", "predicate_eval", "basket_decode"):
        assert after[name] != before[name], name
    header.write_text(header.read_text().replace("\n// edited\n", ""))
    assert {name: _build.lib_path(name) for name in _build.SOURCES} == before
