"""The port's CUDA kernels on the card, held against their plain versions.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The tests marked ``cuda`` skip without a card.  Every comparison is
exact: the kernels are built without fast math and without FMA
contraction, so they round as the plain versions' separate ops do.
"""

import ast
import os
import subprocess
import sys
import threading
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the card checks and the queries)
from repro_torch.core import run_skim  # noqa: E402
from repro_torch.core.neardata import compact_jnp, skim_mask  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import basket_decode as bd  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import predicate_eval as pe  # noqa: E402
from repro_torch.kernels import skim_fused as sf  # noqa: E402
from repro_torch.kernels import stream_compact as sc  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels run only there")
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    prog = dict(chip_smoke.sweep_programs())["count"]
    host = chip_smoke.sweep_inputs(np.random.default_rng(1), prog, 512, 4, 2)
    t = [torch.from_numpy(x) for x in host]
    planes = torch.from_numpy(
        np.random.default_rng(2).integers(0, 1 << 31, (2, 3, 4)).astype(np.int32))
    firsts = torch.tensor([5, -7], dtype=torch.int32)
    ops.reset_launch_counts()
    got, n = sf.skim_fused(*t, prog)
    want, want_n = ref.skim_fused_ref(*t, prog)
    assert int(n) == int(want_n) and torch.equal(got, want)
    dec = bd.basket_decode(planes, firsts, kind=0, n_bits=3, out_dtype=torch.int32)
    assert torch.equal(dec, ref.basket_decode_ref(planes, firsts, 0, 128, torch.int32))
    batch = [x[None] for x in t[:3]]
    mask = pe.predicate_eval_batch(*batch, prog)
    assert torch.equal(mask, ref.predicate_eval_batch_ref(*batch, prog))
    assert torch.equal(pe.predicate_eval(*t[:3], prog), mask[0])
    packed = torch.full((1, 16), -1, dtype=torch.int32)
    seg = torch.zeros((1, 512), dtype=torch.int32)
    _, out = pe.cascade_stage(*batch, packed, seg, prog, 1)
    count = int(out[0, 1])
    assert count == int(mask.sum()) and int(out[0, 0]) == int(count > 0)
    got, counts = sf.skim_fused_batch(*batch, t[3][None], prog)
    assert int(counts[0]) == int(n) and torch.equal(got[0], want)
    packed, m = sc.stream_compact(t[3], mask[0] > 0)
    assert int(m) == int(n) and torch.equal(packed, want)
    q = t[0][None, :, :, :2].contiguous()
    assert torch.equal(fa.flash_attention(q, q, q), ref.flash_attention_ref(q, q, q))
    keep = skim_mask(*t[:3], prog)
    assert torch.equal(keep, ref.predicate_eval_ref(*t[:3], prog))
    packed, m = compact_jnp(t[3], keep)
    assert int(m) == int(n) and torch.equal(packed, want)
    assert ops.launch_counts() == {
        "skim_fused": 0, "skim_fused_batch": 0, "basket_decode": 0,
        "cascade_stage": 0, "predicate_eval_batch": 0, "predicate_eval": 0,
        "stream_compact": 0, "flash_attention": 0,
    }


LAUNCH_NAMES = ("skim_fused", "skim_fused_batch", "basket_decode", "cascade_stage",
                "predicate_eval_batch", "predicate_eval", "stream_compact",
                "flash_attention")


@pytest.mark.parametrize("case", ["threads", "reset", "keys"])
def test_the_launch_counter(case):
    """One counter under one lock: threads counting at once under one name
    give the exact total; a reset zeroes every name; the names are the
    eight wrapper entries, and no other is counted."""
    ops.reset_launch_counts()
    if case == "threads":
        # more threads than cores, switching often: a lost update shows
        n_threads, each = 2 * len(os.sched_getaffinity(0)) + 1, 5_000
        start = threading.Barrier(n_threads)

        def count():
            start.wait(timeout=30)
            for _ in range(each):
                _build.count_launch("cascade_stage")

        threads = [threading.Thread(target=count, name=f"count-{i}")
                   for i in range(n_threads)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(th.is_alive() for th in threads)
        assert ops.launch_counts() == dict.fromkeys(LAUNCH_NAMES, 0) | {
            "cascade_stage": n_threads * each}
    elif case == "reset":
        for i, name in enumerate(LAUNCH_NAMES):
            for _ in range(i + 1):
                _build.count_launch(name)
        assert list(ops.launch_counts().values()) == list(range(1, 9))
        ops.reset_launch_counts()
        assert ops.launch_counts() == dict.fromkeys(LAUNCH_NAMES, 0)
    else:
        assert tuple(ops.launch_counts()) == LAUNCH_NAMES
        with pytest.raises(KeyError):
            _build.count_launch("skim")
        assert tuple(ops.launch_counts()) == LAUNCH_NAMES


def test_no_kernel_module_imports_ops():
    """The kernel tier's arrows point down: ``ops`` over the wrappers over
    ``_build``.  No module under ``kernels/`` but the package's
    ``__init__`` imports ``ops``, at its top or inside a function."""
    kdir = ROOT / "src" / "repro_torch" / "kernels"
    found = []
    for path in sorted(kdir.glob("*.py")):
        if path.name == "__init__.py":
            continue
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    base = "repro_torch.kernels" + (f".{base}" if base else "")
                names = [base, *(f"{base}.{a.name}" for a in node.names)]
            else:
                continue
            if "repro_torch.kernels.ops" in names:
                found.append(f"{path.name}:{node.lineno}")
    assert len(list(kdir.glob("*.py"))) > 5 and not found


@pytest.mark.cuda
def test_cuda_staged_round_trips_are_counted_once_each_way(cuda_device):
    """A decode round, a staged stage step and a numpy ``ops.fused_skim``
    each add one host-to-device copy of their staged bytes, one
    device-to-host copy of their output (none for the stage step, whose
    summary ``stage_summary_host`` reads) and one launch of their kernel."""
    from repro_torch.data.codecs import bitpack_raw_parts

    def delta(fn):
        torch.cuda.synchronize()
        before = ops.transfer_stats()
        ops.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        after = ops.transfer_stats()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        return {k: after[k] - before[k] for k in after}, launches

    blobs, dtypes, _ = chip_smoke.round_blobs(np.random.default_rng(9))
    parts = {n: [bitpack_raw_parts(b) for b in bs] for n, bs in blobs.items()}
    layout = ops.plan_round([(p, ops.torch_dtype(dtypes[n])) for n, ps in parts.items()
                             for p in ps if p["n"] and p["kind"] != 3])
    assert delta(lambda: ops.basket_decode_round(parts, dtypes, cuda_device)) == (
        {"h2d_copies": 1, "h2d_bytes": 4 * layout["n_in"],
         "d2h_copies": 1, "d2h_bytes": layout["out_bytes"]}, {"basket_decode": 1})

    prog = dict(chip_smoke.sweep_programs())["ht"]
    staged, packed, seg, nb = chip_smoke.staged_batch(
        np.random.default_rng(3), prog, 16, 4096, 64, 4096, (0, 4, 8, 12))
    inputs = ops.CascadeInputs(staged.shape, prog.n_groups, staged.rows, cuda_device)
    inputs.host.copy_(staged.host)
    carried = torch.from_numpy(packed).to(cuda_device)
    seg_t = torch.from_numpy(seg).to(cuda_device)
    ops.warm_cascade_stage(prog, inputs.shape, nb, device=cuda_device)
    assert delta(lambda: ops.cascade_stage_step_staged(
        inputs, carried, seg_t, prog, nb, device=cuda_device)) == (
        {"h2d_copies": 1, "h2d_bytes": inputs.nbytes, "d2h_copies": 0, "d2h_bytes": 0},
        {"cascade_stage": 1})

    host = chip_smoke.sweep_inputs(np.random.default_rng(4), prog, 4096, 8, 3)
    ops.fused_skim(*host, prog, device=cuda_device)  # the program's descriptors go up
    planes = sum(np.asarray(a, np.float32).size for a in host[:3])
    rows = -(-host[3].nbytes // 4)
    assert delta(lambda: ops.fused_skim(*host, prog, device=cuda_device)) == (
        {"h2d_copies": 1, "h2d_bytes": 4 * (((planes + 3) & ~3) + rows),
         "d2h_copies": 1, "d2h_bytes": 4 * (sf.header_words(1) + rows)},
        {"skim_fused": 1})


@pytest.mark.cuda
def test_cuda_basket_decode_matches_plain(cuda_device):
    chip_smoke.check_basket_decode(np.random.default_rng(0), cuda_device)


@pytest.mark.cuda
def test_cuda_skim_fused_matches_plain(cuda_device):
    _, edge = chip_smoke.check_skim_fused(np.random.default_rng(0), cuda_device)
    assert edge == 0


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    prog = dict(chip_smoke.sweep_programs())["count"]
    host = chip_smoke.sweep_inputs(np.random.default_rng(1), prog, 512, 4, 2)
    t = [torch.from_numpy(x).to(cuda_device) for x in host]
    with pytest.raises(ValueError):
        sf.skim_fused(t[0].double(), *t[1:], prog)
    with pytest.raises(ValueError):
        sf.skim_fused(t[0], t[1][:, :256], *t[2:], prog)
    planes = torch.zeros((1, 2, 4), dtype=torch.int64, device=cuda_device)
    firsts = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        bd.basket_decode(planes, firsts, kind=0, n_bits=2)


@pytest.mark.cuda
@pytest.mark.parametrize("qname", ["quickstart", "zee"])
def test_cuda_main_path_matches_the_host(cuda_device, qname):
    q = {"quickstart": chip_smoke.QUICKSTART_QUERY,
         "zee": chip_smoke.zee_query(20_000)}[qname]
    store = make_nanoaod_like(20_000, n_hlt=16, n_filler=4)
    host = make_nanoaod_like(20_000, n_hlt=16, n_filler=4, device="cpu")
    ops.reset_launch_counts()
    res = run_skim(store, q)
    launches = ops.launch_counts()
    want = run_skim(host, q, device="cpu")
    assert launches["skim_fused"] > 0 and launches["basket_decode"] > 0
    dec = store.decode_backend_stats()
    assert dec["backend"] == "device" and dec["device_baskets"] > 0
    assert dec["fallbacks"] == 0
    assert res.n_passed == want.n_passed > 0
    assert res.output._blobs == want.output._blobs
    assert chip_smoke.fetch_row(res.stats) == chip_smoke.fetch_row(want.stats)
    assert res.extras["cascade_stages"] == want.extras["cascade_stages"]


@pytest.mark.cuda
def test_cuda_cascade_stage_and_predicate_eval_match_plain(cuda_device):
    rng = np.random.default_rng(0)
    names = ("count", "ht", "mass_pair", "expr")
    assert chip_smoke.check_cascade_stage(rng, cuda_device, names) == (0.0, 0)
    assert chip_smoke.check_predicate_eval(rng, cuda_device, names) == (0.0, 0)


@pytest.mark.cuda
def test_cuda_cascade_stage_windows_match_plain(cuda_device):
    """The kernel over staged windows only, bit for bit: K = 1, 8, 16, 64,
    ragged E, B up to 16 with a subset staged, dead tiles, every copy mode."""
    names = ("count", "ht", "mass_pair", "expr")
    assert chip_smoke.check_cascade_stage_windows(
        np.random.default_rng(0), cuda_device, names) == (0.0, 0)


@pytest.mark.cuda
def test_cuda_stage_step_is_one_pinned_upload(cuda_device):
    """``ops.cascade_stage_step_staged`` moves the staged buffer in one
    page-locked copy and launches one kernel over the staged windows."""
    prog = dict(chip_smoke.sweep_programs())["ht"]
    staged, packed, seg, nb = chip_smoke.staged_batch(
        np.random.default_rng(3), prog, 16, 4096, 64, 4096, (0, 4, 8, 12))
    inputs = ops.CascadeInputs(staged.shape, prog.n_groups, staged.rows, cuda_device)
    inputs.host.copy_(staged.host)
    assert inputs.host.is_pinned()
    carried = torch.from_numpy(packed).to(cuda_device)
    seg_t = torch.from_numpy(seg).to(cuda_device)
    want_p, want = pe.cascade_stage_windows_plain(
        *staged.views(staged.host.to(cuda_device)), carried.clone(), seg_t, prog, nb)
    # as the executor does: the warm-up (outside the step) loads the
    # library and uploads the program's descriptors
    ops.reset_dispatch_stats()
    assert ops.warm_cascade_stage(prog, inputs.shape, nb, device=cuda_device)
    uploads, restore = chip_smoke.count_uploads()
    ops.reset_launch_counts()
    try:
        got_p, got = ops.cascade_stage_step_staged(inputs, carried, seg_t, prog, nb,
                                                   device=cuda_device)
    finally:
        restore()
    torch.cuda.synchronize()
    assert ops.launch_counts()["cascade_stage"] == 1
    assert (uploads["calls"], uploads["step_uploads"], uploads["step_pageable"]) == (1, 1, 0)
    assert uploads["step_bytes"] == inputs.nbytes
    assert torch.equal(got_p, want_p) and torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_public_stage_step_launches_the_kernel(cuda_device):
    """``ops.cascade_stage_step``, the JAX package's form, on a dense batch
    of numpy and of card tensors: one ``cascade_stage`` launch a call,
    bit for bit ``ref.cascade_stage_ref``'s words, basket bits and counts."""
    names = ("count", "ht", "mass_pair", "expr")
    assert chip_smoke.check_cascade_stage_public(
        np.random.default_rng(5), cuda_device, names) == 0.0


@pytest.mark.cuda
def test_cuda_stage_with_no_live_event_writes_nothing(cuda_device):
    """Staged windows whose mask words are all zero: the kernel launches,
    every tile returns before its copies, the words stay zero and a row no
    window is staged to keeps its live words."""
    prog = dict(chip_smoke.sweep_programs())["count"]
    inputs, packed, seg, nb = chip_smoke.staged_batch(
        np.random.default_rng(4), prog, 4, 2048, 8, 512, (0, 1, 3), keep=(2,))
    words = torch.from_numpy(packed).to(cuda_device)
    words[[0, 1, 3]] = 0
    before = words.clone()
    planes, rows = inputs.views(inputs.host.to(cuda_device))
    ops.reset_launch_counts()
    _, out = pe.cascade_stage_windows(planes, rows, words,
                                      torch.from_numpy(seg).to(cuda_device), prog, nb)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cascade_stage"] == 1
    assert torch.equal(words, before) and before[2].any()
    assert not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,E", [(0, 512), (2, 0)])
def test_cuda_cascade_stage_with_no_events_launches_nothing(cuda_device, B, E):
    prog = dict(chip_smoke.sweep_programs())["count"]
    T, G = prog.n_terms, prog.n_groups
    t = torch.zeros((B, T, E, 4), device=cuda_device)
    v = torch.zeros((B, G, E, 4), device=cuda_device)
    packed = torch.full((B, E // 32), -1, dtype=torch.int32, device=cuda_device)
    seg = torch.zeros((B, E), dtype=torch.int32, device=cuda_device)
    ops.reset_launch_counts()
    _, out = pe.cascade_stage(t, v, v.clone(), packed, seg, prog, 3)
    assert ops.launch_counts()["cascade_stage"] == 0
    assert torch.equal(out, torch.zeros((B, 4), dtype=torch.int32, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("qname", ["quickstart", "zee"])
def test_cuda_batched_path_matches_the_host(cuda_device, qname):
    q = {"quickstart": chip_smoke.QUICKSTART_QUERY,
         "zee": chip_smoke.zee_query(20_000)}[qname]
    store = make_nanoaod_like(20_000, n_hlt=16, n_filler=4)
    host = make_nanoaod_like(20_000, n_hlt=16, n_filler=4, device="cpu")
    ops.reset_launch_counts()
    res = run_skim(store, q, device_batch=3)
    launches = ops.launch_counts()
    want = run_skim(host, q, device="cpu", device_batch=3)
    assert launches["cascade_stage"] > 0 and launches["skim_fused"] == 0
    assert res.n_passed == want.n_passed > 0
    assert res.output._blobs == want.output._blobs
    assert chip_smoke.fetch_row(res.stats) == chip_smoke.fetch_row(want.stats)
    for key in ("cascade_stages", "cascade_order"):
        assert res.extras[key] == want.extras[key], key


@pytest.mark.cuda
def test_cuda_stream_compact_matches_plain(cuda_device):
    err = chip_smoke.check_stream_compact(np.random.default_rng(0), cuda_device,
                                          Es=(1, 300, 4097))
    assert err == 0.0


@pytest.mark.cuda
def test_cuda_skim_fused_batch_matches_plain(cuda_device):
    names = ("count", "ht", "mass_pair", "expr", "empty", "full")
    assert chip_smoke.check_skim_fused_batch(
        np.random.default_rng(0), cuda_device, names) == (0.0, 0)


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain(cuda_device):
    chip_smoke.check_flash_attention(np.random.default_rng(0), cuda_device,
                                     chip_smoke.FLASH_SHAPES[:2] + ((1, 2, 200, 48),)
                                     + chip_smoke.FLASH_EDGE_SHAPES)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [False, True])
def test_cuda_skim_kernels_move_payloads_of_every_width(cuda_device, batch):
    """int32, float16, uint8, int64 and bool payloads: one launch a call,
    bit for bit the plain compaction by the same survivors."""
    assert chip_smoke.check_skim_payloads(np.random.default_rng(4), cuda_device, batch) > 0


@pytest.mark.cuda
def test_cuda_numpy_entries_read_numpy_as_jax_does(cuda_device):
    """The ops entries on numpy through the card (the per-window skim's
    staged route among them) equal the host's in type and bytes."""
    assert chip_smoke.check_numpy_entries(np.random.default_rng(5), cuda_device) > 0


@pytest.mark.cuda
def test_cuda_flash_attention_in_float16_and_past_d_128(cuda_device):
    """float16 beside float32 and bf16, causal and full, one launch a call,
    at the wide kernels' edges: D = 136, 144 (one box past 128), 192, 256
    (one 256-column tile, also at a ragged 64-key tile), 264 (a second
    chunk of Q K^T and a second slice of 16 columns) and 520 (three)."""
    chip_smoke.check_flash_attention(
        np.random.default_rng(6), cuda_device,
        ((1, 2, 200, 64), (1, 2, 200, 144), (1, 2, 1000, 256), (1, 2, 256, 264),
         (1, 1, 130, 520)) + chip_smoke.FLASH_WIDE_SHAPES[:3])


@pytest.mark.cuda
def test_cuda_new_entry_points_launch_their_kernels(cuda_device):
    rng = np.random.default_rng(3)
    prog = dict(chip_smoke.sweep_programs())["count"]
    host = chip_smoke.batch_sweep_inputs(rng, prog, 3, 1000, 4)
    ops.reset_launch_counts()
    got, counts = ops.fused_skim_batch(*host, prog)
    packed, n = ops.stream_compact(host[3][0], host[0][0, 0, :, 0] > 20)
    q = rng.normal(size=(1, 2, 64, 16)).astype(np.float32)
    out = ops.flash_attention(q, q, q)
    assert got.is_cuda and packed.is_cuda and out.is_cuda
    # single-pass compaction: one kernel a call
    assert ops.launch_counts()["skim_fused_batch"] == 1
    assert ops.launch_counts()["stream_compact"] == 1
    assert ops.launch_counts()["flash_attention"] == 1


@pytest.mark.cuda
def test_cuda_new_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros((8, 2), device=cuda_device)
    with pytest.raises(ValueError):
        sc.stream_compact(x, torch.zeros(8, dtype=torch.float32, device=cuda_device))
    with pytest.raises(ValueError):
        sc.stream_compact(x.t(), torch.zeros(2, dtype=torch.bool, device=cuda_device))
    q = torch.zeros((1, 1, 8, 160), device=cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention(q.double(), q.double(), q.double())  # no float64 route
    with pytest.raises(ValueError):
        fa.flash_attention(q.int(), q.int(), q.int())
    prog = dict(chip_smoke.sweep_programs())["count"]
    host = chip_smoke.batch_sweep_inputs(np.random.default_rng(1), prog, 2, 512, 4)
    t = [torch.from_numpy(a).to(cuda_device) for a in host]
    with pytest.raises(ValueError):  # 16-byte elements: no row width the kernel moves
        sf.skim_fused_batch(t[0], t[1], t[2], t[3].to(torch.complex128), prog)
    with pytest.raises(ValueError):
        sf.skim_fused_batch(t[0], t[1], t[2],
                            t[3].transpose(1, 2).contiguous().transpose(1, 2), prog)


@pytest.mark.cuda
def test_cuda_mixed_round_matches_plain(cuda_device):
    """One launch decodes a round of every kind, width and output type
    (a basket wider than the 4096-value chunk among them), byte for byte
    as the plain version of the round on the same staged layout."""
    rng = np.random.default_rng(11)
    baskets = chip_smoke.random_round(rng, 40)
    layout = ops.plan_round(baskets)
    staged = torch.empty(layout["n_in"], dtype=torch.int32)
    ops.fill_round(staged.numpy(), layout)
    want = ref.basket_decode_round_ref(*ops.round_views(staged, layout),
                                       layout["out_bytes"])
    got = torch.zeros(layout["out_bytes"], dtype=torch.uint8, device=cuda_device)
    ops.reset_launch_counts()
    bd.decode_round(*ops.round_views(staged.to(cuda_device), layout), got)
    torch.cuda.synchronize()
    assert ops.launch_counts()["basket_decode"] == 1
    got = got.cpu()
    for (part, _), (o, store) in zip(baskets, layout["stores"]):
        nb = part["n"] * store.itemsize
        assert torch.equal(got[o: o + nb], want[o: o + nb]), (part["kind"], part["n"])


@pytest.mark.cuda
def test_cuda_skim_fused_single_pass_at_every_size(cuda_device):
    """The look-back across up to 1,954 tiles and a ragged last tile, one
    launch per call, tail and count included."""
    assert chip_smoke.check_skim_fused_sizes(np.random.default_rng(2), cuda_device) == 0.0


@pytest.mark.cuda
def test_cuda_skim_fused_is_one_launch_per_call(cuda_device):
    prog = dict(chip_smoke.sweep_programs())["ht"]
    host = chip_smoke.sweep_inputs(np.random.default_rng(4), prog, 4096, 8, 1)
    t = [torch.from_numpy(x).to(cuda_device) for x in host]
    ops.reset_launch_counts()
    for _ in range(5):
        sf.skim_fused(*t, prog)
    packed, k = ops.fused_skim(*host, prog, device=cuda_device)
    want, n = ref.skim_fused_ref(*t, prog)
    assert ops.launch_counts()["skim_fused"] == 6
    assert k == int(n) and packed.tobytes() == want.cpu().numpy().tobytes()


@pytest.mark.cuda
def test_cuda_two_threads_decode_rounds_at_once(cuda_device):
    """Rounds decoded from two threads at once (as the prefetcher and the
    consumer do) each get their own values: per-thread staging buffers,
    each round waiting on its own event."""
    blobs, dtypes, arrays = chip_smoke.round_blobs(np.random.default_rng(9))
    from repro_torch.data.codecs import bitpack_raw_parts

    halves = [{n: blobs[n] for n in list(blobs)[i::2]} for i in range(2)]
    errors = []

    def work(half):
        parts = {n: [bitpack_raw_parts(b) for b in bs] for n, bs in half.items()}
        for _ in range(50):
            got = ops.basket_decode_round(parts, dtypes, device=cuda_device)
            for n in half:
                if [g.tobytes() for g in got[n]] != [a.tobytes() for a in arrays[n]]:
                    errors.append(n)

    threads = [threading.Thread(target=work, args=(h,), name=f"decode-{i}")
               for i, h in enumerate(halves)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors


@pytest.mark.cuda
def test_cuda_stream_compact_is_one_launch_per_call(cuda_device):
    rng = np.random.default_rng(6)
    payload = chip_smoke.compact_payload(rng, "float32", 100_000, 8).to(cuda_device)
    mask = chip_smoke.compact_mask(rng, 100_000, 0.03, as_int=False).to(cuda_device)
    want, n = ref.stream_compact_ref(payload, mask)
    ops.reset_launch_counts()
    for _ in range(5):
        got, count = sc.stream_compact(payload, mask)
    torch.cuda.synchronize()
    assert ops.launch_counts()["stream_compact"] == 5
    assert int(count) == int(n) and chip_smoke.bit_err(got, want) == 0.0


@pytest.mark.cuda
def test_cuda_two_streams_compact_at_once(cuda_device):
    """Two threads, each on its own stream (so each with its own look-back
    workspace), compacting at once: every result bit for bit the plain
    version's."""
    rng = np.random.default_rng(7)
    work = []
    for E, D, kind in ((300_000, 8, "float32"), (200_001, 3, "int64")):
        payload = chip_smoke.compact_payload(rng, kind, E, D).to(cuda_device)
        mask = chip_smoke.compact_mask(rng, E, 0.2, as_int=kind == "int64").to(cuda_device)
        work.append((payload, mask, *ref.stream_compact_ref(payload, mask)))
    torch.cuda.synchronize()
    errors = []

    def run(payload, mask, want, n):
        stream = torch.cuda.Stream(cuda_device)
        with torch.cuda.stream(stream):
            for _ in range(30):
                got, count = sc.stream_compact(payload, mask)
                stream.synchronize()
                if int(count) != int(n) or chip_smoke.bit_err(got, want) != 0.0:
                    errors.append(tuple(payload.shape))

    threads = [threading.Thread(target=run, args=w, name=f"compact-{i}")
               for i, w in enumerate(work)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors


@pytest.mark.cuda
def test_cuda_skim_fused_and_stream_compact_share_one_workspace(cuda_device):
    """Launches of the two compaction kernels interleaved on one stream
    draw their epochs from one workspace; each stays bit for bit its plain
    version (``skim_fused`` with the look-back now in compact.cuh)."""
    rng = np.random.default_rng(8)
    prog = dict(chip_smoke.sweep_programs())["ht"]
    host = chip_smoke.sweep_inputs(rng, prog, 70_000, 4, 2)
    t = [torch.from_numpy(x).to(cuda_device) for x in host]
    skim_want, skim_n = ref.skim_fused_ref(*t, prog)
    payload = chip_smoke.compact_payload(rng, "int32", 70_000, 4).to(cuda_device)
    mask = chip_smoke.compact_mask(rng, 70_000, 0.5, as_int=True).to(cuda_device)
    comp_want, comp_n = ref.stream_compact_ref(payload, mask)
    key = (payload.device, torch.cuda.current_stream(cuda_device).cuda_stream)
    epochs = []
    for _ in range(10):
        got, n = sf.skim_fused(*t, prog)
        packed, count = sc.stream_compact(payload, mask)
        epochs.append(sf.Workspace._all[key].epoch)
        torch.cuda.synchronize()
        assert int(n) == int(skim_n) and chip_smoke.bit_err(got, skim_want) == 0.0
        assert int(count) == int(comp_n) and chip_smoke.bit_err(packed, comp_want) == 0.0
    assert all(b - a == 2 for a, b in zip(epochs, epochs[1:]))


@pytest.mark.cuda
def test_cuda_predicate_eval_in_every_copy_mode(cuda_device):
    """The mask launch at ragged E in its three copy modes: bulk copies
    (bench_kernels' program, E*K % 4 == 0), 4-byte cp.async (E*K % 4 != 0;
    a buffer one float off 16 bytes) and device memory (K = 512; a program
    with a pair group), each equal to the plain version."""
    rng = np.random.default_rng(9)
    bench, *bench_planes = chip_smoke.bench_predicate(rng, 4096 + 37, cuda_device)
    cases = [(bench, [x[None] for x in bench_planes], pe.MODE_BULK)]
    for name, B, E, K, shift, mode in (("count", 2, 4097, 1, 0, pe.MODE_ASYNC4),
                                       ("ht", 3, 1000, 8, 1, pe.MODE_ASYNC4),
                                       ("count", 2, 40, 512, 0, pe.MODE_DIRECT),
                                       ("dr_pair", 2, 301, 3, 0, pe.MODE_DIRECT)):
        prog = dict(chip_smoke.sweep_programs())[name]
        host = chip_smoke.batch_inputs(rng, prog, B, E, K, 128)
        cases.append((prog, [chip_smoke.shifted(torch.from_numpy(x).to(cuda_device), shift)
                             for x in host[:3]], mode))
    for prog, (t, v, w), mode in cases:
        B, T, E, K = t.shape
        plan = pe.mask_plan((t, v, w), (T * E * K, v.shape[1] * E * K), E, K, prog)
        assert plan[1] == mode
        ops.reset_launch_counts()
        got = pe.predicate_eval_batch(t, v, w, prog)
        one = pe.predicate_eval(t[0], v[0], w[0], prog)
        torch.cuda.synchronize()
        assert ops.launch_counts()["predicate_eval_batch"] == 1
        assert ops.launch_counts()["predicate_eval"] == 1
        want = ref.predicate_eval_batch_ref(t, v, w, prog)
        assert torch.equal(got, want) and torch.equal(one, want[0])


# ---------------------------------------------------------------------------
# the serving plane on the card: shared scan and cluster
# ---------------------------------------------------------------------------


def _serving_stores():
    store = make_nanoaod_like(20_000, n_hlt=16, n_filler=4)
    host = make_nanoaod_like(20_000, n_hlt=16, n_filler=4, device="cpu")
    return store, host


@pytest.mark.cuda
@pytest.mark.parametrize("device_batch", [None, 3])
def test_cuda_shared_scan_matches_the_host(cuda_device, device_batch):
    from repro_torch.serve import SharedScanEngine

    store, host = _serving_stores()
    tenants = [chip_smoke.QUICKSTART_QUERY, chip_smoke.zee_query(20_000)]
    ops.reset_launch_counts()
    got = SharedScanEngine(store, device_batch=device_batch).run_batch(tenants)
    launches = ops.launch_counts()
    want = SharedScanEngine(host, device="cpu",
                            device_batch=device_batch).run_batch(tenants)
    assert launches["basket_decode"] > 0
    if device_batch:
        assert launches["cascade_stage"] > 0 and launches["skim_fused"] == 0
    else:
        assert launches["skim_fused"] > 0
    assert chip_smoke.fetch_row(got.shared_stats) == chip_smoke.fetch_row(
        want.shared_stats)
    assert got.amortization == want.amortization > 1
    for res, ref_ in zip(got.results, want.results):
        assert res.n_passed == ref_.n_passed > 0
        assert res.output._blobs == ref_.output._blobs
        assert chip_smoke.fetch_row(res.stats) == chip_smoke.fetch_row(ref_.stats)
        for key in ("cascade_stages", "cascade_order"):
            assert res.extras[key] == ref_.extras[key], key


@pytest.mark.cuda
def test_cuda_threaded_cluster_matches_the_host(cuda_device):
    """Three nodes' skims run from pool threads onto one card."""
    from repro_torch.cluster import build_cluster

    store, host = _serving_stores()
    q = chip_smoke.QUICKSTART_QUERY
    ops.reset_launch_counts()
    got = build_cluster(store, 3, concurrency="threads").run(q)
    launches = ops.launch_counts()
    want = build_cluster(host, 3, device="cpu").run(q)
    assert launches["skim_fused"] > 0 and launches["basket_decode"] > 0
    assert got.n_passed == want.n_passed > 0
    assert got.output.manifest_hash() == want.output.manifest_hash()
    assert got.output._blobs == want.output._blobs
    assert chip_smoke.fetch_row(got.stats) == chip_smoke.fetch_row(want.stats)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["count", "any", "mass_pair", "dr_same", "expr"])
def test_cuda_skim_mask_and_compact_jnp_launch_their_kernels(cuda_device, name):
    """On CUDA tensors the mesh skim's two steps launch one kernel each and
    equal their plain versions on the card bit for bit."""
    prog = dict(chip_smoke.sweep_programs())[name]
    host = chip_smoke.sweep_inputs(np.random.default_rng(4), prog, 4097, 8, 3)
    t, v, w, p = (torch.from_numpy(x).to(cuda_device) for x in host)
    ops.reset_launch_counts()
    mask = skim_mask(t, v, w, prog)
    packed, n = compact_jnp(p, mask)
    torch.cuda.synchronize()
    launches = {k: c for k, c in ops.launch_counts().items() if c}
    assert launches == {"predicate_eval": 1, "stream_compact": 1}
    assert mask.dtype == torch.bool and mask.is_cuda
    assert torch.equal(mask, ref.predicate_eval_ref(t, v, w, prog))
    want, want_n = ref.stream_compact_ref(p, mask)
    assert n.dtype == torch.int32 and int(n) == int(want_n)
    assert torch.equal(packed.view(torch.int32), want.view(torch.int32))


NCCL_WORLD1 = textwrap.dedent(
    """
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import chip_smoke
    from repro_torch.core.neardata import sharded_skim
    from repro_torch.kernels import ops, ref

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    prog = dict(chip_smoke.sweep_programs())["ht"]
    host = chip_smoke.sweep_inputs(np.random.default_rng(6), prog, 5000, 8, 2)
    ops.reset_launch_counts()
    packed, mask, total = sharded_skim(mesh, prog)(*host)
    torch.cuda.synchronize()
    launches = {k: c for k, c in ops.launch_counts().items() if c}
    assert launches == {"predicate_eval": 1, "stream_compact": 1}, launches
    t = [torch.from_numpy(x).cuda() for x in host]
    want = ref.predicate_eval_ref(*t[:3], prog)
    want_packed, want_n = ref.stream_compact_ref(t[3], want)
    assert packed.is_cuda and mask.dtype == torch.int32 and total.dtype == torch.int32
    assert torch.equal(mask, want.to(torch.int32))
    assert torch.equal(packed.view(torch.int32), want_packed.view(torch.int32))
    assert int(total) == int(want_n) > 0
    dist.destroy_process_group()
    print("ok", int(total))
    """
)


@pytest.mark.cuda
def test_cuda_sharded_skim_over_nccl_at_world_size_1(cuda_device):
    """The mesh skim on a ``"cuda"`` mesh, NCCL at world size 1 from a
    ``HashStore`` (no port), in its own process: one launch of each kernel,
    equal to the plain versions on the card."""
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", NCCL_WORLD1], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok ")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["quickstart", "skim_expr", "skim_service",
                                  "skim_service_async", "skim_cluster"])
def test_cuda_example_matches_the_host(cuda_device, name):
    """``repro_torch.examples.<name>`` at its default size on the card and
    with ``--device cpu``: every line equal once the wall-clock values are
    masked, ``basket_decode`` and ``skim_fused`` launched on the card."""
    pair = chip_smoke.example_pair(name)
    assert pair["lines"] > 0
    assert pair["launches"]["basket_decode"] > 0
    assert pair["launches"]["skim_fused"] > 0
    assert not any(pair["host"]["launches"].values())


@pytest.mark.cuda
def test_cuda_nonfinite_inputs_match_plain(cuda_device):
    """predicate_eval, cascade_stage, skim_fused, skim_fused_batch and
    stream_compact bit for bit against their plain versions where a tenth
    of every term plane is NaN, +inf, -inf or -0.0 (the sweep programs and
    an EXPR group whose min / max meet zeros of opposite sign)."""
    assert chip_smoke.check_nonfinite_kernels(np.random.default_rng(1), cuda_device) == 0.0


@pytest.mark.cuda
def test_cuda_nonfinite_window_matches_the_host(cuda_device):
    """The eight cases of ``chip_smoke.nonfinite_window`` through the CUDA
    skim: a NaN pt among valid objects, every pt NaN, no object, a valid
    -inf pt, zeros of opposite sign, equal pts, HT with NaN and ±inf on
    slots failing their cut, min / max of two zeros; each query's mask
    equal to the host evaluator's."""
    masks = chip_smoke.check_nonfinite_window("cuda", cuda_device)
    assert masks["delta-r"] and masks["mass-jets"] and masks["ht"]


@pytest.mark.cuda
def test_cuda_nonfinite_store_matches_the_host(cuda_device):
    """Phase 3g at 20,000 events: every query of
    ``chip_smoke.nonfinite_queries`` per window and batched on the card,
    equal to the host runs through the plain versions, which equal the
    staged run (MASS events within the residue excepted and checked)."""
    out = chip_smoke.run_nonfinite_path(cuda_device, n_events=20_000)
    assert out["launches"]["skim_fused"] > 0 and out["launches"]["cascade_stage"] > 0
    for name, runs in out["survivors"].items():
        if name not in out["residues"]:
            assert len(set(runs.values())) == 1, (name, runs)


@pytest.mark.cuda
def test_cuda_edge_window_matches_the_host(cuda_device):
    """``chip_smoke.edge_window``'s events at float32 cut edges (MASS at
    both ends of its window, ΔR under < and >, HT against 200.3, EXPR with
    sum() and with 0.1) through predicate_eval, cascade_stage, skim_fused
    and skim_fused_batch: equal to their plain versions and to the host
    evaluator (MASS events within the residue excepted and checked)."""
    assert chip_smoke.check_edge_kernels(cuda_device) == 0.0


@pytest.mark.cuda
def test_cuda_int_window_matches_the_host(cuda_device):
    """``chip_smoke.int_window``'s integer branches (event numbers past
    2^24 and 10^8, an int32 word across -2^31, Jet_id beside 2^24) and ANY
    over int32 and non-bool float32 words, with the planes' kinds, through
    predicate_eval, predicate_eval_batch, cascade_stage, skim_fused and
    skim_fused_batch: equal to their plain versions and to the host
    evaluator bit for bit."""
    assert chip_smoke.check_int_kernels(cuda_device) == 0.0


@pytest.mark.cuda
def test_cuda_int_store_matches_the_staged_run(cuda_device):
    """Phase 3h at 20,000 events: every query of ``chip_smoke.int_queries``
    through ``run_skim`` on the card, per window and batched, decode on
    the card, equal to the staged run in survivors and output bytes."""
    out = chip_smoke.run_int_path(cuda_device, n_events=20_000)
    assert out["launches"]["skim_fused"] > 0 and out["launches"]["cascade_stage"] > 0
    assert out["survivors"]["event-pick"]["per window"] == 1
