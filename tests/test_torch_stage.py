"""The batched cascade stage over the windows it runs, on the CPU.

``run_window_batch`` stages only the windows a stage runs, each window's
planes back to back in one buffer with a row table
(``ops.CascadeInputs``), and ``ops.cascade_stage_step_staged`` uploads
that buffer in one copy and runs the stage over the staged windows only.
On the CPU the step takes the plain version over the same layout
(``predicate_eval.cascade_stage_windows_plain``); these tests hold it
against ``ref.cascade_stage_ref`` on the dense batch the staged windows
stand for, and the batched engine's ledgers against the JAX package's.
Inputs come from numpy seeds.  Every comparison is exact.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import chip_smoke  # noqa: E402  (the staged batches the card checks use)
from benchmarks.bench_cascade import QUERY as ERA_QUERY  # noqa: E402
from benchmarks.bench_cascade import _make_store as j_make_era  # noqa: E402
from repro.core.engine import run_skim as j_run_skim  # noqa: E402
from repro.data.synth import make_nanoaod_like as j_make  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.engine import run_skim as t_run_skim  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like as t_make  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import predicate_eval as tpe  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SWEEP = dict(chip_smoke.sweep_programs())

# staged rows of a batch of 6: all, some, one, none
SUBSETS = {"all": range(6), "some": (0, 2, 5), "one": (3,), "none": ()}


def _dense_ref(inputs, packed, seg, program, nb):
    """``ref.cascade_stage_ref`` on the dense batch the staged windows
    stand for, as one (B, nb + 1) buffer."""
    dense = [torch.from_numpy(x) for x in chip_smoke.dense_batch(inputs)]
    words, bits, counts = tref.cascade_stage_ref(
        *dense, torch.from_numpy(packed.copy()), torch.from_numpy(seg), program, nb)
    return words, torch.cat([bits, counts[:, None]], dim=1)


@pytest.mark.parametrize("backend", ["host", "torch"])
@pytest.mark.parametrize("subset", sorted(SUBSETS))
@pytest.mark.parametrize("name", ["count", "ht", "any", "expr", "dr_pair"])
def test_staged_step_equals_the_dense_batch(name, subset, backend):
    """The step over the staged windows equals the dense reference, with
    live spans that start inside a mask word and a run of dead tiles."""
    prog = SWEEP[name]
    rows = SUBSETS[subset]
    inputs, packed, seg, nb = chip_smoke.staged_batch(
        np.random.default_rng(len(name)), prog, 6, 2048, 8, 512, rows, start=37)
    want_words, want_out = _dense_ref(inputs, packed, seg, prog, nb)
    carried = torch.from_numpy(packed.copy())
    tops.reset_dispatch_stats()
    words, out = tops.cascade_stage_step_staged(inputs, carried, torch.from_numpy(seg),
                                                prog, nb, backend=backend, device="cpu")
    assert words is carried
    assert torch.equal(words, want_words)
    assert torch.equal(out, want_out)
    if subset == "none":
        assert not out.any()
    else:
        assert out[:, -1].sum() > 0
    # the ledger notes the dense batch's shape, whatever is staged
    assert tops.dispatch_stats() == {"dispatches": 1, "compiles": 1, "warmups": 0}
    assert tops._cascade_sig(prog, (6, prog.n_terms, 2048, 8), nb, backend) in \
        tops._SEEN_SIGNATURES


@pytest.mark.parametrize("K", [1, 16, 64])
def test_staged_windows_at_every_object_capacity(K):
    prog = SWEEP["ht"]
    inputs, packed, seg, nb = chip_smoke.staged_batch(
        np.random.default_rng(K), prog, 4, 1024, K, 256, (1, 2), start=5)
    want_words, want_out = _dense_ref(inputs, packed, seg, prog, nb)
    words, out = tops.cascade_stage_step_staged(
        inputs, torch.from_numpy(packed.copy()), torch.from_numpy(seg), prog, nb,
        backend="host")
    assert torch.equal(words, want_words) and torch.equal(out, want_out)


def test_rows_not_staged_keep_their_words():
    """A row no staged window maps to keeps its carried words, live or
    not, and gets a zero row of bits and count."""
    prog = SWEEP["count"]
    inputs, packed, seg, nb = chip_smoke.staged_batch(
        np.random.default_rng(8), prog, 5, 1024, 4, 256, (0, 3), keep=(2,))
    before = packed.copy()
    assert before[2].any()
    words, out = tops.cascade_stage_step_staged(
        inputs, torch.from_numpy(packed.copy()), torch.from_numpy(seg), prog, nb,
        backend="host")
    for b in (1, 2, 4):
        np.testing.assert_array_equal(words[b].numpy(), before[b])
        assert not out[b].any()
    assert out[0, -1] > 0 and out[3, -1] > 0


def test_staged_layout_is_what_the_kernel_reads():
    """The buffer: the row table padded to 16 bytes, then each staged
    window's T term planes, G valid and G weights planes; the staged
    rows' planes are the dense batch's."""
    prog = SWEEP["mass_pair"]
    inputs, *_ = chip_smoke.staged_batch(np.random.default_rng(2), prog, 7, 512,
                                         4, 128, (6, 1, 4))
    raw = inputs.host.numpy()
    T, G = prog.n_terms, prog.n_groups
    assert inputs.head == 4 and raw[:3].tolist() == [6, 1, 4]
    assert inputs.nbytes == 4 * (4 + 3 * (T + 2 * G) * 512 * 4)
    planes, rows = inputs.views(inputs.host)
    assert rows.tolist() == [6, 1, 4]
    assert planes.data_ptr() == inputs.host.data_ptr() + 16
    terms, valid, weights = chip_smoke.dense_batch(inputs)
    for s, b in enumerate((6, 1, 4)):
        np.testing.assert_array_equal(planes[s, :T].numpy(), terms[b])
        np.testing.assert_array_equal(planes[s, T:T + G].numpy(), valid[b])
        np.testing.assert_array_equal(planes[s, T + G:].numpy(), weights[b])
    assert not terms[0].any() and not valid[5].any()
    with pytest.raises(ValueError):
        tops.CascadeInputs((4, T, 512, 4), G, (1, 1))
    with pytest.raises(ValueError):
        tops.CascadeInputs((4, T, 512, 4), G, (4,))


def test_stage_windows_rejects_what_the_kernel_does_not_take():
    prog = SWEEP["count"]
    inputs, packed, seg, nb = chip_smoke.staged_batch(
        np.random.default_rng(5), prog, 3, 512, 4, 128, (0, 2))
    planes, rows = inputs.views(inputs.host)
    p, s = torch.from_numpy(packed), torch.from_numpy(seg)
    bad = [
        (planes[:, 1:], rows, p, s),  # a plane short
        (planes.double(), rows, p, s),
        (planes, rows.long(), p, s),
        (planes, rows[:1], p, s),
        (planes, rows, p[:, :-1], s),
        (planes[:, :, :500], rows, p, s),  # E % 32
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tpe.cascade_stage_windows(*args, prog, nb)


@pytest.mark.parametrize(
    "n_planes, K, lanes, aligned, want",
    [(3, 1, 1, True, (512, tpe.MODE_BULK, 6144)),
     (3, 64, 32, True, (64, tpe.MODE_BULK, 49152)),
     (3, 64, 32, False, (64, tpe.MODE_ASYNC4, 49152)),
     (10, 16, 16, True, (64, tpe.MODE_BULK, 40960)),
     (10, 64, 32, True, (32, tpe.MODE_BULK, 81920)),
     (10, 8, 1, True, (256, tpe.MODE_BULK, 81920)),
     (10, 256, 32, True, (32, tpe.MODE_DIRECT, 0))],
)
def test_stage_plan_fits_the_tile_to_shared_memory(n_planes, K, lanes, aligned, want):
    assert tpe.stage_plan(n_planes, K, lanes, aligned) == want


@pytest.mark.parametrize("name, K, want", [("ht", 64, 32), ("ht", 8, 8), ("count", 1, 1),
                                            ("mass_pair", 8, 1), ("mass_pair", 16, 16),
                                            ("dr_same", 64, 32), ("expr", 16, 16)])
def test_event_lanes(name, K, want):
    """Lanes over the slots, but an event a lane for a pair group at
    small K."""
    assert tpe.event_lanes(SWEEP[name], K) == want


def _stage_log(monkeypatch):
    """Record each stage step's staged rows and dense shape."""
    calls = []
    step = tops.cascade_stage_step_staged

    def record(inputs, packed, *a, **k):
        counts = tref.unpack_bits(packed, inputs.shape[2]).sum(dim=1)
        calls.append((inputs.rows.tolist(), inputs.shape, inputs.n_groups,
                      np.nonzero(counts.numpy())[0].tolist(), inputs.nbytes))
        return step(inputs, packed, *a, **k)

    monkeypatch.setattr(tops, "cascade_stage_step_staged", record)
    return calls


def test_batched_run_stages_only_windows_with_a_live_event(monkeypatch):
    """On the era store, windows the electron stage kills are not staged
    for the HT stage; every staged window has a live event and every
    window with one is staged."""
    store = chip_smoke.make_era_store(32_768, basket_events=1024, device="cpu")
    calls = _stage_log(monkeypatch)
    res = t_run_skim(store, ERA_QUERY, device="cpu", device_batch=8)
    assert res.n_passed > 0 and calls
    staged = dense = 0
    for rows, (Bn, T, E, K), G, live, nbytes in calls:
        assert rows == live
        staged += nbytes
        dense += 4 * Bn * (T + 2 * G) * E * K
    assert any(len(rows) < shape[0] for rows, shape, *_ in calls)
    assert staged < dense


@pytest.mark.parametrize("cell", ["era", "quickstart"])
def test_batched_cells_keep_the_jax_dispatch_ledger(cell):
    """The batched path's survivors, output bytes and ``dispatch_stats()``
    equal the JAX package's on the era and quickstart stores."""
    if cell == "era":
        js = j_make_era(32_768, basket_events=1024)
        ts = chip_smoke.make_era_store(32_768, basket_events=1024, device="cpu")
        query = ERA_QUERY
    else:
        kw = dict(n_hlt=16, n_filler=8, basket_events=1024)
        js, ts = j_make(24_000, **kw), t_make(24_000, device="cpu", **kw)
        query = chip_smoke.QUICKSTART_QUERY
    jops.reset_dispatch_stats()
    tops.reset_dispatch_stats()
    jr = j_run_skim(js, query, device_batch=8)
    tr = t_run_skim(ts, query, device="cpu", device_batch=8)
    assert tr.n_passed == jr.n_passed > 0
    assert tr.output._blobs == jr.output._blobs
    assert tops.dispatch_stats() == jops.dispatch_stats()
    assert tops.dispatch_stats()["warmups"] > 0
