#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; the first failure stops the run with a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, then the build of every kernel from ``src/`` and,
   beside it, of the earlier designs of ``cascade_stage``,
   ``predicate_eval`` and ``stream_compact`` the script keeps as timing
   baselines (:data:`PARENT_CU`), and the attention
   library's SASS (``cuobjdump``): its bf16 route must hold ``HGMMA``
   (wgmma) and its float32 route tf32 ``HMMA`` (mma.sync).
2. Kernels against their plain PyTorch versions, on the card:
   ``basket_decode`` bit for bit (same-shaped batches, mixed-kind rounds
   in one launch each, rounds of real blobs through
   ``ops.basket_decode_round``), ``skim_fused`` over every op and group
   kind and at E from 1 to 1,000,000 (the single-pass look-back over
   many tiles, one launch a call), ``cascade_stage`` and
   ``predicate_eval`` over every op and group kind (``cascade_stage``
   also over staged windows only: K = 1/8/16/64, a short last tile,
   subsets of a batch staged, dead tiles, every copy mode, bit for bit;
   ``predicate_eval`` at ragged E, in every copy mode and at
   bench_kernels' E = 2^17 and 2^20), ``stream_compact`` bit for bit
   over every payload width (NaN payloads, -0.0, integers past 2^24),
   rows of a multiple of 16 bytes and not, buffers off 16-byte
   alignment, ``skim_fused_batch`` over every op and group kind, and
   ``flash_attention`` at the JAX tests' shapes and at its edges (ragged
   S, a padded D, many heads), 3e-5 in float32, a few ulps in bf16.
   Then each skim kernel's median time beside its plain version's and
   its bound, at the shapes the main path gives it (window 0's decode
   rounds and skim calls; the batch of the first 16 windows), with the
   host-to-host time of a whole decode round, of a window's skim and of a
   cascade stage step; ``cascade_stage`` and ``predicate_eval`` beside
   their earlier designs on the same inputs, the stage's earlier step
   (three pageable uploads), and ``predicate_eval`` also at
   bench_kernels' shapes.
3. The main path: ``run_skim`` with every default on two 1,000,000-event
   stores — NanoAOD-like (98 branches) for the quickstart query and the
   Z->ee mass/ΔR/expression query, and the conditions-era store of
   ``benchmarks/bench_cascade.py`` for its HT query — each held against
   the port's own host runs of the same store, with one ``basket_decode``
   launch per decode round that sends a bitpack miss to the card and one
   ``skim_fused`` launch per window skim.  Then the batched cascade,
   ``run_skim(..., device_batch=16)``, on the same three, held against
   the staged reference, the per-window card run and the host batched
   run, with one page-locked host-to-device copy per stage step
   (:func:`count_uploads`); and the device busy share of each
   (``torch.profiler``).
   Then the ops entry points of the four kernels no skim calls, at full
   size, each with the launch counts set to 0 before it and read after:
   ``ops.predicate_eval`` on each window of each cell's first cascade
   stage over its first 16 windows, ``ops.fused_skim_batch`` on the same
   batches (equal per window to ``ops.fused_skim``),
   ``ops.stream_compact`` of eight float32 branches by the quickstart
   cell's 1,000,000-event survivor mask, and ``ops.flash_attention`` at
   StarCoder2-7B's head layout (1, 36, 2048, 128) in float32 and bf16;
   then their times, beside one PyTorch call each where there is one
   (and the kernels ``torch.profiler`` saw that call run);
   ``stream_compact`` also beside its earlier design, at bench_kernels'
   shapes, and step by step through its wrapper.
   Then phase 3d, the serving plane, on the NanoAOD-like store, each step
   with the launch counts set to 0 before it and read after: the shared
   scan (``SharedScanEngine``) of the tenants quickstart, Z->ee and
   quickstart, per window and with ``device_batch=16``, each tenant equal
   in survivors and output bytes to its solo card run of phase 3, the
   shared and per-tenant ledgers equal to the port's host run of the same
   shared scan, with one ``basket_decode`` launch per decode round that
   sends a bitpack miss to the card, one ``skim_fused`` launch per window
   skim and one page-locked upload per stage step; the job service
   (three tenants batched, columns equal to the solo runs, a job
   cancelled after its first window keeping a prefix, the Chrome trace's
   span kinds, a journaled service stopped and recovered streaming the
   same partials); the cluster (4 nodes with replicas, serially and from
   pool threads, a failed node served by its replica, then the same with
   ``device_batch=16`` nodes, and a job through ``ClusterBackend``).
   Then phase 3e, the mesh skim (``neardata.sharded_skim``) on the whole
   NanoAOD-like store, padded at the K that truncates no object, for the
   quickstart and Z->ee queries: (a) NCCL at world size 1, mesh (1, 1, 1)
   (``pod``, ``data``, ``model``), the group started from a ``HashStore``:
   the total equals phase 3's survivors, the mask and the packed rows equal
   the plain versions on the same tensors bit for bit, one
   ``predicate_eval`` and one ``stream_compact`` launch a call; then the
   step's host-to-host time, each kernel's device time beside its bound
   and the ``all_reduce``'s time; (b) four ranks on the one card over gloo
   (NCCL takes one rank a card), mesh (2, 2, 1), spawned and met through a
   ``FileStore``, each mapping (a)'s saved arrays and reading only its
   block: each block equals the plain compaction of its slice of (a)'s
   mask, each total (a)'s, one launch of each kernel a rank.
   Then phase 3f, the five examples (``repro_torch.examples``), each run
   in this process at its default size on the card and with ``--device
   cpu``: every printed line but the device line equal once the
   wall-clock values (``examples.CLOCK_FIELDS``) are masked,
   ``basket_decode`` and ``skim_fused`` launched on the card (counted from
   0 around each run, ``build_cluster``'s decode launches apart), none by
   the host run; then the paper's four placements from ``skim_service``'s
   table, each mode's ``Breakdown`` total and ``busy_fraction`` at 1, 10
   and 100 Gb/s (modeled links), card and host.
4. One JSON line listing each kernel (its launches those of every main
   path, the serving plane's, the mesh skim's and the examples' included),
   then the device line last.

It imports ``repro_torch`` only (never JAX or the JAX package), needs one
card, and exits non-zero without a result where there is no card or no
``src/repro_torch`` beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 on the tensor cores, dense
N_EVENTS = 1_000_000

QUICKSTART_QUERY = {  # examples/quickstart.py
    "input": "events.skim",
    "output": "skimmed.skim",
    "branches": ["Electron_*", "Muon_*", "Jet_*", "MET_*", "HLT_*"],
    "selection": {
        "preselection": [{"branch": "nElectron", "op": ">=", "value": 1}],
        "object": [
            {
                "collection": "Electron",
                "cuts": [
                    {"var": "pt", "op": ">", "value": 20.0},
                    {"var": "eta", "op": "abs<", "value": 2.4},
                ],
                "min_count": 1,
            }
        ],
        "event": [
            {"type": "any", "branches": ["HLT_IsoMu24", "HLT_Ele32_WPTight_Gsf"]},
            {"type": "cut", "branch": "MET_pt", "op": ">", "value": 15.0},
        ],
    },
}


def zee_query(n_events: int) -> dict:
    """benchmarks/bench_expr.py: Z->ee mass window AND ΔR AND a run-range
    expression keeping ~10% of luminosity blocks."""
    lumi_cut = max((n_events // 1000) // 10, 1)
    return {
        "input": "bench.skim",
        "output": "bench_zee.skim",
        "branches": ["Electron_*", "Jet_pt", "MET_*", "run", "event",
                     "luminosityBlock"],
        "selection": {
            "event": [
                {"type": "mass", "collections": ["Electron", "Electron"],
                 "window": [80.0, 100.0]},
                {"type": "deltaR", "collections": ["Electron", "Jet"],
                 "op": ">", "value": 0.4},
                {"type": "expr", "expr": "2*luminosityBlock + 0.01*MET_pt",
                 "op": "<", "value": 2.0 * lumi_cut},
            ],
        },
    }


ERA_QUERY = {  # benchmarks/bench_cascade.py
    "input": "bench.skim",
    "output": "bench_cascade_out.skim",
    "branches": ["Electron_*", "MET_*", "event", "luminosityBlock"],
    "selection": {
        "preselection": [{"branch": "nElectron", "op": ">=", "value": 1}],
        "object": [
            {
                "collection": "Electron",
                "cuts": [
                    {"var": "pt", "op": ">", "value": 20.0},
                    {"var": "eta", "op": "abs<", "value": 2.4},
                    {"var": "mvaId", "op": ">=", "value": 0.5},
                ],
                "min_count": 1,
            }
        ],
        "event": [
            {
                # the heavy stage: ~25 tracks/event feed the HT sum
                "type": "ht", "collection": "Track", "var": "pt",
                "object_cuts": [{"var": "pt", "op": ">", "value": 1.0}],
                "op": ">", "value": 20.0,
            },
            {"type": "any", "branches": [
                "HLT_IsoMu24", "HLT_Ele32_WPTight_Gsf",
            ]},
            {"type": "cut", "branch": "MET_pt", "op": ">", "value": 10.0},
        ],
    },
}


def make_era_store(n_events: int, seed: int = 7, basket_events: int = 4096,
                   device=None):
    """benchmarks/bench_cascade.py's conditions-era store: window w is a
    good era iff w % 4 == 0; bad-era electrons have ``mvaId == (pt <= 20)``,
    so no object passes the ID+pt selection there while every basket's
    statistics stay undecidable.  ~25 tracks per event feed the HT stage."""
    import numpy as np

    from repro_torch.data.store import EventStore

    rng = np.random.default_rng(seed)
    era_good = (np.arange(n_events) // basket_events) % 4 == 0

    cols: dict = {}
    jagged: dict = {}

    n_el = rng.poisson(1.2, n_events).astype(np.int32)
    tot = int(n_el.sum())
    el_pt = (rng.exponential(25.0, tot) + 3.0).astype(np.float32)
    el_eta = rng.uniform(-2.5, 2.5, tot).astype(np.float32)
    obj_good = np.repeat(era_good, n_el)
    el_mva = np.where(obj_good, rng.random(tot) > 0.3, el_pt <= 20.0)
    cols["nElectron"] = n_el
    for name, arr in [("Electron_pt", el_pt), ("Electron_eta", el_eta),
                      ("Electron_mvaId", el_mva)]:
        cols[name] = arr
        jagged[name] = "nElectron"

    n_trk = rng.poisson(25.0, n_events).astype(np.int32)
    cols["nTrack"] = n_trk
    cols["Track_pt"] = (
        rng.exponential(5.0, int(n_trk.sum())) + 0.5
    ).astype(np.float32)
    jagged["Track_pt"] = "nTrack"

    cols["MET_pt"] = (rng.exponential(30.0, n_events) + 1.0).astype(np.float32)
    cols["MET_phi"] = rng.uniform(-np.pi, np.pi, n_events).astype(np.float32)
    cols["HLT_IsoMu24"] = rng.random(n_events) < 0.3
    cols["HLT_Ele32_WPTight_Gsf"] = rng.random(n_events) < 0.2
    cols["event"] = np.arange(n_events, dtype=np.int32)
    cols["luminosityBlock"] = (np.arange(n_events) // 1000).astype(np.int32)

    return EventStore.from_arrays(
        cols, jagged=jagged, basket_events=basket_events, codec="bitpack",
        device=device,
    )


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def stream_ms(fn, calls: int = 50) -> float:
    """Time per call of ``calls`` calls back to back between two CUDA
    events: the stream's view, so it holds the kernels and any gap the
    host leaves between them."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def host_ms(fn, calls: int = 200) -> float:
    """Host time per call of ``calls`` calls of a function that returns its
    results on the host (it waits for its own work)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e3


def device_ms(fn, calls: int = 20, reps: int = 7) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    the graph replayed between two CUDA events, the median of ``reps``
    replays over ``calls``.  No host work lies between the launches."""
    import torch

    fn()  # builds, loads and uploads what the wrapper caches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def bound_times(nbytes: float, ops: float,
                ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, float]:
    """(ms to move ``nbytes`` at the card's memory rate, ms to do ``ops``
    operations at ``ops_per_s``: by default its float32 rate outside the
    tensor cores)."""
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3


def attention_ops_ms(ops: float, bf16: bool) -> float:
    """The least time for ``ops`` operations of attention.  bf16: the
    tensor cores' bf16 rate.  float32: the lesser of the two ways to a
    float32-exact product, the CUDA cores at their float32 rate and split
    TF32 on the tensor cores (three TF32 products per product at the TF32
    rate), which is the lesser: 3 / 495 < 1 / 67."""
    if bf16:
        return ops / BF16_OPS_PER_S * 1e3
    return min(ops / FP32_OPS_PER_S, 3 * ops / TF32_OPS_PER_S) * 1e3


def profiled_kernels(fn) -> list[str] | str:
    """The names of the device kernels (not memsets) a call of ``fn`` ran,
    from ``torch.profiler``, or "not measured" where it saw none.  Some
    sessions see no device events at all: it tries three, with more calls
    each time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: a first call may set up what later calls reuse
    for calls in (1, 3, 10):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = sorted({ev.key for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CUDA
                        and not ev.key.startswith("Memset")})
        if names:
            return names
    return "not measured"


def check_tensor_core_sass() -> dict:
    """Counts, in the SASS of the attention library, the bf16 route's wgmma
    (``HGMMA``) and the float32 route's tf32 mma.sync (``HMMA`` ... ``TF32``);
    fails if either is 0 or ``cuobjdump`` is missing."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    check(Path(tool).exists(), "cuobjdump not found: the tensor-core check cannot run")
    lib = _build.lib_path("flash_attention")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120)
    check(sass.returncode == 0, f"cuobjdump -sass {lib.name} failed: {sass.stderr.strip()}")
    lines = sass.stdout.splitlines()
    counts = {"HGMMA": sum("HGMMA" in ln for ln in lines),
              "HMMA_TF32": sum("HMMA" in ln and "TF32" in ln for ln in lines)}
    log(f"  flash_attention SASS: {counts['HGMMA']} HGMMA (bf16 route, wgmma), "
        f"{counts['HMMA_TF32']} tf32 HMMA (float32 route, mma.sync)")
    check(counts["HGMMA"] > 0, "flash_attention: no HGMMA in the bf16 route's SASS")
    check(counts["HMMA_TF32"] > 0, "flash_attention: no tf32 HMMA in the float32 route's SASS")
    return counts


# ---------------------------------------------------------------------------
# phase 2a: basket_decode against its plain version
# ---------------------------------------------------------------------------


def bit_err(got, want) -> float:
    """Largest |got - want| over the values' bit patterns, each read as an
    integer of the value's own width (0.0 when they are bit-identical;
    NaN payloads and -0.0 compare by their bits)."""
    import numpy as np
    import torch

    if isinstance(got, np.ndarray):
        got, want = torch.from_numpy(got), torch.from_numpy(want)
    if got.numel() == 0:
        return 0.0
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    g = got.view(as_int[got.element_size()]).double()
    w = want.view(as_int[want.element_size()]).double()
    return float((g - w).abs().max())


# the output types each kind is decoded to: the store's (int32, bool,
# float32), the narrower integers the kernel stores itself, and the wider
# types it widens to after the launch
DECODE_OUT_DTYPES = {
    0: ("int32", "int16", "int8", "int64"),
    1: ("float32", "float64"),
    2: ("bool", "int32"),
}


def check_basket_decode(rng, device) -> float:
    """The kernel against its plain version, bit for bit.  Returns the
    largest :func:`bit_err` seen."""
    import numpy as np
    import torch

    from repro_torch.data.codecs import bitpack_encode, bitpack_raw_parts
    from repro_torch.kernels import basket_decode as bd
    from repro_torch.kernels import ops, ref

    cases = 0
    max_err = 0.0
    # (a) random plane words: every kind, widths 1..32, ragged n, every
    # output width
    for kind in (0, 1, 2):
        for n in (1, 31, 4095, 4096, 4097):
            W = -(-n // 32)
            widths = [1] * 3 if kind == 2 else rng.integers(1, 33, 3).tolist()
            B = max(widths)
            planes = np.zeros((3, B, W), np.uint32)
            for i, w in enumerate(widths):
                planes[i, :w] = rng.integers(0, 1 << 32, (w, W), dtype=np.uint64)
            firsts = rng.integers(0, 1 << 32, 3, dtype=np.uint64).astype(np.uint32)
            p_t = torch.from_numpy(planes.view(np.int32)).to(device)
            f_t = torch.from_numpy(firsts.view(np.int32)).to(device)
            for name in DECODE_OUT_DTYPES[kind]:
                out_dtype = getattr(torch, name)
                got = bd.basket_decode(p_t, f_t, kind=kind, n_bits=B,
                                       out_dtype=out_dtype)
                want = ref.basket_decode_ref(p_t, f_t, kind, W * 32, out_dtype)
                torch.cuda.synchronize()
                check(got.dtype == out_dtype,
                      f"basket_decode kind={kind} gave {got.dtype}, not {out_dtype}")
                err = bit_err(got[:, :n], want[:, :n])
                max_err = max(max_err, err)
                check(err == 0.0,
                      f"basket_decode kind={kind} n={n} widths={widths} {name}: "
                      f"values differ from the plain version (max |bits| {err})")
                cases += 1
    # (b) the codec round trip: ints whose uint32 prefix sum wraps (deltas
    # stay inside int32, the codec's domain), -0.0 and NaN payloads
    arrays = [
        np.array([-5, 10, -(1 << 30), (1 << 30) - 1, 0, -1] * 700, np.int32),
        rng.integers(-(1 << 30), 1 << 30, 4097).astype(np.int32),
        np.array([0x80000000, 0x80000001, 0x80000000, 0x80000003] * 1024,
                 np.uint32).view(np.float32),  # -0.0 and negative denormals
        (np.uint32(0x7FC00000) | rng.integers(0, 1 << 16, 4096).astype(np.uint32)
         ).view(np.float32),  # NaN payloads
        rng.random(31) < 0.3,
        rng.random(4097) < 0.5,
    ]
    for arr in arrays:
        part = bitpack_raw_parts(bitpack_encode(arr))
        check(part["kind"] != 3, f"test array {arr.dtype} fell back to raw literals")
        (got,) = ops.basket_decode_batch([part], arr.dtype, device=device)
        check(got.dtype == arr.dtype and got.shape == arr.shape,
              f"basket_decode round trip of {arr.dtype} gave {got.dtype} {got.shape}")
        err = bit_err(got, arr)
        max_err = max(max_err, err)
        check(err == 0.0, f"basket_decode round trip of {arr.dtype} (kind "
              f"{part['kind']}) is not bit-identical (max |bits| {err})")
        cases += 1
    # (c) whole rounds: mixed kinds, widths and output types in one launch,
    # against the plain version of the round on the same staged layout
    for seed in range(4):
        baskets = random_round(rng, 24)
        layout = ops.plan_round(baskets)
        staged = torch.empty(layout["n_in"], dtype=torch.int32)
        ops.fill_round(staged.numpy(), layout)
        want = ref.basket_decode_round_ref(*ops.round_views(staged, layout),
                                           layout["out_bytes"])
        dev = staged.to(device)
        got = torch.zeros(layout["out_bytes"], dtype=torch.uint8, device=device)
        ops.reset_launch_counts()
        bd.decode_round(*ops.round_views(dev, layout), got)
        torch.cuda.synchronize()
        check(ops.launch_counts()["basket_decode"] == 1,
              "basket_decode: a round took more than one launch")
        got = got.cpu()
        for (p, _), (o, store) in zip(baskets, layout["stores"]):
            nb = p["n"] * store.itemsize
            err = bit_err(got[o: o + nb].view(store), want[o: o + nb].view(store))
            max_err = max(max_err, err)
            check(err == 0.0, f"basket_decode round {seed}: kind {p['kind']} "
                  f"n={p['n']} bits={p['bits']} -> {store} differs from the plain "
                  f"version (max |bits| {err})")
        cases += 1
    # (d) rounds of real blobs through ops.basket_decode_round, against the
    # host codec: several branches, every kind, raw literals, empty baskets
    blobs, dtypes, arrays = round_blobs(rng)
    for _ in range(2):
        ops.reset_launch_counts()
        got = ops.basket_decode_round(
            {name: [bitpack_raw_parts(b) for b in bs] for name, bs in blobs.items()},
            dtypes, device=device)
        check(ops.launch_counts()["basket_decode"] == 1,
              "ops.basket_decode_round took more than one launch")
        for name, arrs in arrays.items():
            for g, a in zip(got[name], arrs):
                check(g.dtype == a.dtype and g.tobytes() == a.tobytes(),
                      f"ops.basket_decode_round {name}: not the encoded values")
        cases += 1
    log(f"  basket_decode: {cases} cases bit-identical to the plain version "
        "(kinds 0/1/2, widths 0-32, n in 1/31/4095/4096/4097/10000, outputs "
        "int32/int16/int8/int64, float32/float64, bool; wrap-around, -0.0, "
        "NaN payloads; 4 mixed rounds of 24 baskets in one launch each; 2 rounds "
        f"of real blobs, raw literals and empty baskets among them); max |bits| "
        f"{max_err}")
    return max_err


def random_round(rng, n: int):
    """``n`` baskets for one decode round as (bitpack_raw_parts-style dict,
    torch output dtype): random kinds, plane words and firsts, widths 0, 1,
    31, 32 or any, value counts with ragged tails and one wider than the
    kernel's 4096-value chunk, every output type of
    :data:`DECODE_OUT_DTYPES`."""
    import numpy as np
    import torch

    out = []
    for i in range(n):
        kind = int(rng.integers(0, 3))
        size = int(rng.choice([1, 31, 32, 33, 4095, 4096, 4097, 10000]))
        W = -(-size // 32)
        bits = 1 if kind == 2 else int(rng.choice([0, 1, 31, 32, rng.integers(1, 33)]))
        planes = np.zeros((max(bits, 1), W), np.uint32)
        planes[:bits] = rng.integers(0, 1 << 32, (bits, W), dtype=np.uint64)
        names = DECODE_OUT_DTYPES[kind]
        out.append(({"kind": kind, "n": size, "bits": bits, "n_pad": W * 32,
                     "first": int(rng.integers(0, 1 << 32, dtype=np.uint64)),
                     "planes": planes.reshape(-1)},
                    getattr(torch, names[i % len(names)])))
    return out


def round_blobs(rng):
    """A fetch round of real blobs: ({branch: [blob, ...]}, {branch: dtype},
    {branch: [the encoded arrays]}), with int32, int16, bool, xor-coded and
    raw-literal float32 branches, empty and ragged baskets."""
    import numpy as np

    from repro_torch.data.codecs import bitpack_encode

    gens = {
        "nJet": lambda n: rng.integers(0, 9, n).astype(np.int32),
        "run_id": lambda n: rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32),
        "charge": lambda n: rng.choice(np.array([-1, 1], np.int16), n),
        "HLT_bit": lambda n: rng.random(n) < 0.3,
        "discrete": lambda n: rng.choice(np.array([1.0, 1.25, -0.0], np.float32), n),
        "smooth": lambda n: (rng.exponential(30, n) + 1).astype(np.float32),
    }
    blobs, dtypes, arrays = {}, {}, {}
    for name, gen in gens.items():
        arrs = [gen(n) for n in (4096, 0, 1, 4097, 300)]
        blobs[name] = [bitpack_encode(a) for a in arrs]
        dtypes[name] = arrs[0].dtype
        arrays[name] = arrs
    return blobs, dtypes, arrays


# ---------------------------------------------------------------------------
# phase 2a: skim_fused against its plain version
# ---------------------------------------------------------------------------


def sweep_programs():
    """(name, Program, collection per term) covering all 8 ops and all six
    group kinds."""
    from repro_torch.core.expr import (
        RPN_ABS, RPN_ADD, RPN_BRANCH, RPN_CONST, RPN_DIV, RPN_MAX, RPN_MIN,
        RPN_MUL, RPN_NEG, RPN_SUB, RPN_SUM,
    )
    from repro_torch.kernels.program import (
        GROUP_ANY, GROUP_COUNT, GROUP_DR, GROUP_EXPR, GROUP_HT, GROUP_MASS,
        OP_IDS, Group, Program,
    )

    O = OP_IDS
    kin = ("pt", "eta", "phi", "mass")
    progs = [
        ("count", Program(
            (Group(GROUP_COUNT, (0, 1), (O[">"], O["abs<"]), (20.0, 2.4)),
             Group(GROUP_COUNT, (2, 3), (O["<"], O["abs>"]), (60.0, 0.5),
                   min_count=2)),
            ("A_pt", "A_eta", "B_pt", "B_eta"), ("A", "B"), (None, None))),
        ("ht", Program(
            (Group(GROUP_HT, (0,), (O[">="],), (10.0,), cmp_op=O[">"],
                   cmp_thr=100.0),
             Group(GROUP_HT, (1,), (O["<="],), (50.0,), cmp_op=O["<="],
                   cmp_thr=80.0)),
            ("B_pt", "B_eta"), ("B", "B"), ("B_pt", "B_pt"))),
        ("any", Program(
            (Group(GROUP_ANY, (0, 1), (O[">="], O["=="]), (0.5, 1.0)),
             Group(GROUP_COUNT, (2,), (O["!="],), (3.0,))),
            ("F_t1", "F_t2", "F_n"), (None, None), (None, None))),
        ("mass_same", Program(
            (Group(GROUP_MASS, tuple(range(8)), (), (), cmp_thr=20.0,
                   cmp_thr2=60.0),),
            tuple(f"A_{v}" for v in kin) * 2, ("A",), (None,), ("A",))),
        ("mass_pair", Program(
            (Group(GROUP_MASS, tuple(range(8)), (), (), cmp_thr=15.0,
                   cmp_thr2=70.0),),
            tuple(f"A_{v}" for v in kin) + tuple(f"B_{v}" for v in kin),
            ("A",), (None,), ("B",))),
        ("dr_same", Program(
            (Group(GROUP_DR, tuple(range(6)), (), (), cmp_op=O[">"],
                   cmp_thr=1.5),),
            tuple(f"A_{v}" for v in kin[:3]) * 2, ("A",), (None,), ("A",))),
        ("dr_pair", Program(
            (Group(GROUP_DR, tuple(range(6)), (), (), cmp_op=O["<"],
                   cmp_thr=2.0),),
            tuple(f"A_{v}" for v in kin[:3]) + tuple(f"B_{v}" for v in kin[:3]),
            ("A",), (None,), ("B",))),
        ("expr", Program(
            (Group(GROUP_EXPR, (0, 1, 2), (), (), cmp_op=O["<"], cmp_thr=40.0,
                   rpn=((RPN_BRANCH, 0), (RPN_SUM, 1), (RPN_CONST, 0.5),
                        (RPN_MUL, None), (RPN_ADD, None), (RPN_BRANCH, 2),
                        (RPN_NEG, None), (RPN_ABS, None), (RPN_CONST, 3.0),
                        (RPN_ADD, None), (RPN_DIV, None), (RPN_BRANCH, 0),
                        (RPN_MIN, None), (RPN_CONST, 1.0), (RPN_MAX, None),
                        (RPN_CONST, 2.0), (RPN_SUB, None))),),
            ("F_x", "B_pt", "F_y"), (None,), (None,))),
        ("empty", Program(
            (Group(GROUP_COUNT, (0,), (O[">"],), (1e30,)),),
            ("A_pt",), ("A",), (None,))),
        ("full", Program(
            (Group(GROUP_ANY, (0,), (O[">="],), (float("-inf"),)),),
            ("F_x",), (None,), (None,))),
    ]
    return progs


def sweep_inputs(rng, program, E: int, K: int, D: int):
    """Physics-shaped padded inputs for ``program``: collections A and B
    with Poisson multiplicities, flat terms in slot 0 only."""
    import numpy as np

    from repro_torch.kernels.program import GROUP_DR, GROUP_MASS

    counts = {c: np.minimum(rng.poisson(2.0, E), K) for c in ("A", "B")}
    valid_of = {
        c: (np.arange(K)[None, :] < counts[c][:, None]).astype(np.float32)
        for c in counts
    }
    flat = np.zeros((E, K), np.float32)
    flat[:, 0] = 1.0

    def values(branch):
        var = branch.split("_", 1)[1]
        n = (E, K)
        if var == "pt":
            v = rng.exponential(25.0, n) + 3.0
        elif var == "eta":
            v = rng.uniform(-2.5, 2.5, n)
        elif var == "phi":
            v = rng.uniform(-np.pi, np.pi, n)
        elif var == "mass":
            v = np.abs(rng.normal(5.0, 3.0, n))
        elif var in ("t1", "t2"):
            v = (rng.random(n) < 0.3).astype(np.float64)
        elif var == "n":
            v = rng.integers(0, 6, n).astype(np.float64)
        else:
            v = rng.normal(10.0, 20.0, n)
        coll = branch.split("_", 1)[0]
        mask = valid_of[coll] if coll in valid_of else flat
        return (v * mask).astype(np.float32)

    T, G = program.n_terms, program.n_groups
    terms = np.stack([values(b) for b in program.term_branches])
    valid = np.zeros((G, E, K), np.float32)
    weights = np.zeros((G, E, K), np.float32)
    for g, grp in enumerate(program.groups):
        c1 = program.group_collections[g]
        if grp.kind in (GROUP_MASS, GROUP_DR):
            c2 = program.group_collections2[g]
            valid[g] = valid_of[c1] + 2.0 * valid_of[c2]
        elif c1 is not None:
            valid[g] = valid_of[c1]
        else:
            valid[g] = flat
        if program.group_weights[g] is not None:
            weights[g] = terms[grp.term_ids[0]]
    payload = rng.normal(size=(E, D)).astype(np.float32)
    payload[:, 0] = np.arange(E, dtype=np.float32)
    return terms, valid, weights, payload


def edge_events(program, terms, valid, events) -> bool:
    """True when every event of ``events`` has a mass/ΔR value within 2 ulp
    of one of its group's cuts (the plain version's value)."""
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.program import GROUP_DR, GROUP_MASS

    near = np.zeros(len(events), bool)
    for g, grp in enumerate(program.groups):
        if grp.kind not in (GROUP_MASS, GROUP_DR):
            continue
        v, _ = ref.pair_group_value(program, g, terms, valid)
        v = v.cpu().numpy()[events]
        for cut in (grp.cmp_thr, grp.cmp_thr2) if grp.kind == GROUP_MASS else (grp.cmp_thr,):
            c = np.float32(cut)
            near |= np.abs(v - c) <= 2 * np.spacing(c)
    return bool(near.all())


def packed_edges(what, program, t, v, got, count, want, want_count) -> int:
    """Events kept by one of two packed outputs (payload column 0 the
    event index) and not the other; fails unless there are some and every
    one lies within 2 ulp of a mass/ΔR cut.  Returns how many."""
    import numpy as np

    E = got.shape[0]
    m_got = np.zeros(E, bool)
    m_got[got[: int(count), 0].long().cpu().numpy()] = True
    m_want = np.zeros(E, bool)
    m_want[want[: int(want_count), 0].long().cpu().numpy()] = True
    diff = np.nonzero(m_got != m_want)[0]
    check(len(diff) > 0 and edge_events(program, t, v, diff),
          f"{what}: kernel and plain version disagree ({int(count)} vs "
          f"{int(want_count)} survivors)")
    log(f"  {what}: {len(diff)} events differ within 2 ulp of a mass/ΔR cut: "
        f"{diff[:8].tolist()}")
    return len(diff)


def check_skim_fused(rng, device) -> tuple[float, int]:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import skim_fused as sf

    cases = edge = 0
    max_err = 0.0
    for name, program in sweep_programs():
        for E in (512, 4096, 4608):
            for K in (1, 4, 16):
                for D in (1, 5):
                    host = sweep_inputs(rng, program, E, K, D)
                    t, v, w, p = (torch.from_numpy(x).to(device) for x in host)
                    got, count = sf.skim_fused(t, v, w, p, program)
                    want, want_count = ref.skim_fused_ref(t, v, w, p, program)
                    torch.cuda.synchronize()
                    cases += 1
                    max_err = max(max_err, float((got - want).abs().max()))
                    if int(count) == int(want_count) and torch.equal(
                        got.view(torch.int32), want.view(torch.int32)
                    ):
                        if name == "empty":
                            check(int(count) == 0, "empty mask: survivors found")
                        if name == "full":
                            check(int(count) == E, "full mask: events lost")
                        continue
                    edge += packed_edges(f"skim_fused {name} E={E} K={K} D={D}",
                                         program, t, v, got, count, want, want_count)
    log(f"  skim_fused: {cases} cases (all 8 ops, COUNT/HT/ANY/MASS/ΔR/EXPR, "
        f"E in 512/4096/4608, K in 1/4/16, D in 1/5, empty and full masks); "
        f"packed and count equal to the plain version except {edge} events "
        "at a mass/ΔR cut's edge")
    max_err = max(max_err, check_skim_fused_sizes(rng, device))
    return max_err, edge


SKIM_SIZES = (1, 300, 512, 4097, 65_536, 1_000_000)


def check_skim_fused_sizes(rng, device, Es=SKIM_SIZES) -> float:
    """The single-pass compaction across many tiles and a ragged last tile:
    ``skim_fused`` at each E of ``Es`` (1,954 tiles of look-back at 10^6)
    equal to the plain version bit for bit, zero tail and count included,
    in one launch per call; twice per E, so the second call meets the
    first call's status words under an older epoch."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import skim_fused as sf

    progs = dict(sweep_programs())
    cases = 0
    for E in Es:
        for name in ("count", "ht", "full"):
            program = progs[name]
            host = sweep_inputs(rng, program, E, 4, 2)
            t, v, w, p = (torch.from_numpy(x).to(device) for x in host)
            want, want_count = ref.skim_fused_ref(t, v, w, p, program)
            for _ in range(2):
                ops.reset_launch_counts()
                got, count = sf.skim_fused(t, v, w, p, program)
                torch.cuda.synchronize()
                check(ops.launch_counts()["skim_fused"] == 1,
                      f"skim_fused E={E}: {ops.launch_counts()['skim_fused']} "
                      "launches for one call")
                check(int(count) == int(want_count) and torch.equal(
                    got.view(torch.int32), want.view(torch.int32)),
                    f"skim_fused {name} E={E}: {int(count)} survivors vs "
                    f"{int(want_count)}, or the packed rows or zero tail differ")
                cases += 1
            del t, v, w, p, got, want
    log(f"  skim_fused at E in {'/'.join(map(str, Es))} (count, ht, full; twice "
        f"each): {cases} calls, one launch each, packed rows, zero tail and "
        "count equal to the plain version bit for bit")
    return 0.0


# ---------------------------------------------------------------------------
# phase 2a: the batched predicate and the cascade stage
# ---------------------------------------------------------------------------


def batch_inputs(rng, program, B: int, E: int, K: int, basket_events: int):
    """A window-batch staged as ``run_window_batch`` stages it: sweep inputs
    per window, a random carried mask (window 1 all dead), and ``seg_ids``
    from window starts that are not aligned to a basket.  Returns numpy
    (terms, valid, weights, packed (B, E/32) int32, seg_ids (B, E) int32,
    nb)."""
    import numpy as np

    from repro_torch.kernels import ops

    per = [sweep_inputs(rng, program, E, K, 1)[:3] for _ in range(B)]
    terms, valid, weights = (np.stack([w[i] for w in per]) for i in range(3))
    alive = rng.random((B, E)) < 0.7
    alive[min(1, B - 1)] = False
    nb = E // basket_events + 2
    seg = np.zeros((B, E), np.int32)
    for b in range(B):
        start = int(rng.integers(0, 8 * basket_events))
        grid0 = start - start % basket_events
        ids = (start + np.arange(E, dtype=np.int64) - grid0) // basket_events
        seg[b] = np.clip(ids, 0, nb - 1)
    packed = ops.pack_mask(alive).view(np.int32)
    return terms, valid, weights, packed, seg, nb


def dense_batch(inputs):
    """The dense (Bn,T,E,K), (Bn,G,E,K), (Bn,G,E,K) numpy batch that the
    windows staged in ``inputs`` (``ops.CascadeInputs``) stand for: zeros
    in every row no window is staged to."""
    import numpy as np

    Bn, T, E, K = inputs.shape
    G = inputs.n_groups
    out = [np.zeros((Bn, n, E, K), np.float32) for n in (T, G, G)]
    for s, b in enumerate(inputs.rows):
        for dense, part in zip(out, inputs.window(s)):
            dense[b] = part
    return tuple(out)


def staged_batch(rng, program, B: int, E: int, K: int, basket_events: int, rows,
                 start: int = 0, keep=()):
    """A window-batch staged for one cascade stage as ``run_window_batch``
    stages it: :func:`batch_inputs`' windows, with only ``rows`` staged
    (``ops.CascadeInputs``, host memory) and every other row's mask words
    zero, as a window with no live event has, except the rows in ``keep``,
    which keep live words the stage must leave alone.  In every staged
    window the events before ``start`` are dead with zero planes (a live
    span that starts inside a mask word), and so are the events of one
    512-event run (tiles with no live event).  Returns (inputs, packed
    (B, E/32) int32, seg_ids (B, E) int32, nb)."""
    import numpy as np

    from repro_torch.kernels import ops

    terms, valid, weights, packed, seg, nb = batch_inputs(
        rng, program, B, E, K, basket_events)
    alive = ops.unpack_mask(packed, E)
    dead = np.zeros(E, bool)
    dead[:start] = True
    if E >= 2048:
        dead[1024:1536] = True
    for b in range(B):
        if b in rows:
            alive[b, dead] = False
        elif b not in keep:
            alive[b] = False
    inputs = ops.CascadeInputs(terms.shape, program.n_groups, rows)
    for s, b in enumerate(inputs.rows):
        for part, dense in zip(inputs.window(s), (terms, valid, weights)):
            part[...] = dense[b]
            part[:, dead] = 0.0
    return inputs, ops.pack_mask(alive).view(np.int32), seg, nb


def _mask_edges(program, t, v, got, want) -> int:
    """Events where two (B, E) masks differ; every one must lie within
    2 ulp of a mass/ΔR cut (checked), else the run fails."""
    import numpy as np

    diff = (got != want).cpu().numpy()
    n = 0
    for b in np.nonzero(diff.any(axis=1))[0]:
        events = np.nonzero(diff[b])[0]
        check(edge_events(program, t[b], v[b], events),
              f"{program.term_branches}: window {b} differs at events "
              f"{events[:8].tolist()}, away from any mass/ΔR cut")
        n += len(events)
    return n


def check_cascade_stage(rng, device, names=None) -> tuple[float, int]:
    """``cascade_stage`` against its plain version: the new mask (in place),
    the basket bits and the counts, over the sweep programs, B in 1/3/16,
    E in 512/4096.  Where the masks differ (only at a mass/ΔR cut's edge),
    the kernel's basket bits and counts must be those of its own mask.
    Returns (max |kernel - plain| over mask bits, basket bits and counts;
    events that differ at a mass/ΔR cut's edge)."""
    import torch

    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref

    cases = edge = 0
    max_err = 0.0
    for name, program in sweep_programs():
        if names and name not in names:
            continue
        for B in (1, 3, 16):
            for E, be in ((512, 128), (4096, 1024)):
                for K in (1, 8):
                    host = batch_inputs(rng, program, B, E, K, be)
                    t, v, w, packed, seg = (torch.from_numpy(x).to(device)
                                            for x in host[:5])
                    nb = host[5]
                    w_packed, *w_out = ref.cascade_stage_ref(
                        t, v, w, packed, seg, program, nb)
                    want = torch.cat([w_out[0], w_out[1][:, None]], dim=1)
                    got_packed, got = pe.cascade_stage(t, v, w, packed, seg, program, nb)
                    torch.cuda.synchronize()
                    check(got_packed.data_ptr() == packed.data_ptr(),
                          "cascade_stage did not update the carried mask in place")
                    m_got, m_want = ref.unpack_bits(got_packed, E), ref.unpack_bits(w_packed, E)
                    err = max(float((m_got.int() - m_want.int()).abs().max()),
                              float((got - want).abs().max()))
                    max_err = max(max_err, err)
                    cases += 1
                    if err == 0.0:
                        continue
                    n = _mask_edges(program, t, v, m_got, m_want)
                    check(n > 0, f"cascade_stage {name} B={B} E={E} K={K}: basket "
                          "bits or counts differ where the masks agree")
                    edge += n
                    # the kernel's basket bits and counts follow its own mask
                    own = torch.zeros((B, nb), dtype=torch.int32, device=device)
                    own.scatter_reduce_(1, seg.long(), m_got.int(), "amax")
                    check(torch.equal(got[:, :nb], own),
                          f"cascade_stage {name}: basket bits do not follow the mask")
                    check(torch.equal(got[:, nb], m_got.sum(dim=1, dtype=torch.int32)),
                          f"cascade_stage {name}: counts do not follow the mask")
                    log(f"  cascade_stage {name} B={B} E={E} K={K}: events "
                        "differ within 2 ulp of a mass/ΔR cut")
    log(f"  cascade_stage: {cases} cases (all 8 ops, COUNT/HT/ANY/MASS/ΔR/EXPR, "
        "B in 1/3/16, E in 512/4096, K in 1/8, random carried masks with an "
        "all-dead window, unaligned window starts); mask, basket bits and "
        f"counts equal to the plain version except {edge} events at a "
        f"mass/ΔR cut's edge; max |err| {max_err}")
    return max_err, edge


def check_cascade_stage_windows(rng, device, names=None) -> tuple[float, int]:
    """``cascade_stage_windows`` (the kernel over the staged windows only,
    as ``ops.cascade_stage_step`` launches it) against its plain version,
    bit for bit: every sweep program at K in 1/8/16/64, E in 512/4000
    (4000: a short last tile), B in 1/5/16 with all, some, one or no
    windows staged, live spans that start inside a mask word, a run of
    tiles with no live event, and a row not staged whose live words must
    stay as they are; then a misaligned buffer (4-byte ``cp.async``) and a
    shape too large for shared memory (read from device memory).
    Returns (max |kernel - plain| over words and the (B, nb+1) buffer;
    events that differ at a mass/ΔR cut's edge)."""
    import torch

    from repro_torch.kernels import predicate_eval as pe

    cases = edge = 0
    max_err = 0.0
    modes = set()

    def one(label, program, planes, rows, packed, seg, nb):
        nonlocal cases, edge, max_err
        want_p, want = pe.cascade_stage_windows_plain(
            planes, rows, packed.clone(), seg, program, nb)
        got_p = packed.clone()
        _, got = pe.cascade_stage_windows(planes, rows, got_p, seg, program, nb)
        torch.cuda.synchronize()
        E = seg.shape[1]
        err = max(float((got_p != want_p).any()), float((got - want).abs().max()))
        max_err = max(max_err, err)
        cases += 1
        if err:
            # only mass/ΔR events at a cut's edge may differ; the kernel's
            # bits and counts then follow its own mask
            from repro_torch.kernels import ref

            m_got, m_want = ref.unpack_bits(got_p, E), ref.unpack_bits(want_p, E)
            dense = [torch.zeros((packed.shape[0], n, E, planes.shape[3]),
                                 device=device)
                     for n in (program.n_terms, program.n_groups)]
            dense[0][rows.long()] = planes[:, :program.n_terms]
            dense[1][rows.long()] = planes[:, program.n_terms:program.n_terms
                                           + program.n_groups]
            n = _mask_edges(program, dense[0], dense[1], m_got, m_want)
            check(n > 0, f"cascade_stage_windows {label}: bits or counts differ "
                  "where the masks agree")
            own = torch.zeros_like(got[:, :nb])
            own.scatter_reduce_(1, seg.long(), m_got.int(), "amax")
            check(torch.equal(got[:, :nb], own) and torch.equal(
                got[:, nb], m_got.sum(dim=1, dtype=torch.int32)),
                f"cascade_stage_windows {label}: bits or counts do not follow "
                "the kernel's own mask")
            edge += n

    for name, program in sweep_programs():
        if names and name not in names:
            continue
        for K in (1, 8, 16, 64):
            for B in (1, 5, 16):
                subsets = {"all": range(B), "none": ()}
                if B > 1:
                    subsets.update(some=range(0, B, 3), one=(B // 2,))
                for E in (512, 4000):
                    for subset, rows in subsets.items():
                        keep = (1,) if B > 1 and 1 not in rows else ()
                        inputs, packed, seg, nb = staged_batch(
                            rng, program, B, E, K, 1024, tuple(rows), start=37,
                            keep=keep)
                        planes, r = inputs.views(inputs.host.to(device))
                        one(f"{name} K={K} B={B} E={E} {subset}", program, planes,
                            r, torch.from_numpy(packed).to(device),
                            torch.from_numpy(seg).to(device), nb)
                        modes.add(pe.stage_plan(planes.shape[1], K,
                                                pe.event_lanes(program, K), True)[1])
        # a misaligned buffer: 4-byte cp.async; K = 512: device memory
        for K, shift in ((8, 1), (512, 0)):
            inputs, packed, seg, nb = staged_batch(rng, program, 3, 512, K, 128,
                                                   (0, 2), start=5)
            raw = torch.zeros(inputs.host.numel() + 4, dtype=torch.int32,
                              device=device)
            dev = raw[shift: shift + inputs.host.numel()]
            dev.copy_(inputs.host)
            planes, r = inputs.views(dev)
            aligned = planes.data_ptr() % 16 == 0
            modes.add(pe.stage_plan(planes.shape[1], K, pe.event_lanes(program, K),
                                    aligned)[1])
            one(f"{name} K={K} shift={shift}", program, planes, r,
                torch.from_numpy(packed).to(device), torch.from_numpy(seg).to(device),
                nb)
    check(modes == {pe.MODE_BULK, pe.MODE_ASYNC4, pe.MODE_DIRECT},
          f"cascade_stage_windows: copy modes {sorted(modes)} run, not all three")
    log(f"  cascade_stage_windows: {cases} cases (every sweep program, K in "
        "1/8/16/64, E in 512/4000, B in 1/5/16 with all/some/one/no windows "
        "staged, spans from event 37, a dead 512-event run, a live row not "
        "staged; bulk copies, 4-byte cp.async on a misaligned buffer, device "
        f"memory at K = 512); equal to the plain version except {edge} events "
        f"at a mass/ΔR cut's edge; max |err| {max_err}")
    return max_err, edge


# (B, E, K, shift) of check_predicate_eval's dense batches: ragged E, the
# three copy modes (bulk where E*K % 4 == 0 and the buffer is aligned,
# 4-byte cp.async where E*K % 4 != 0 or the buffer is shifted by a float,
# device memory where a tile of the planes passes 200 KiB at K = 512)
PREDICATE_CASES = ((1, 1, 4, 0), (1, 300, 4, 0), (1, 4097, 4, 0), (3, 300, 4, 0),
                   (16, 4097, 4, 0), (2, 4097, 1, 0), (2, 301, 3, 0), (3, 1000, 8, 1),
                   (2, 40, 512, 0))
# benchmarks/bench_kernels.py's predicate benchmark: E = 2^17, K = 8, one
# COUNT group pt > 20 and |eta| < 2.4 (T = 2, G = 1); and the same at the
# 1,000,000-event store's scale
PREDICATE_BENCH_E = (1 << 17, 1 << 20)


def bench_predicate(rng, E: int, device):
    """bench_kernels.py's predicate program and inputs at E events, K = 8:
    (program, terms (2, E, 8), valid (1, E, 8), weights (1, E, 8))."""
    import numpy as np
    import torch

    from repro_torch.kernels.program import GROUP_COUNT, OP_IDS, Group, Program

    K = 8
    program = Program(
        (Group(GROUP_COUNT, (0, 1), (OP_IDS[">"], OP_IDS["abs<"]), (20.0, 2.4)),),
        ("pt", "eta"), ("X",), (None,))
    terms = rng.normal(20, 15, (2, E, K)).astype(np.float32)
    valid = (rng.random((1, E, K)) < 0.4).astype(np.float32)
    return program, *(torch.from_numpy(x).to(device)
                      for x in (terms, valid, np.zeros((1, E, K), np.float32)))


def shifted(x, shift: int):
    """A contiguous copy of ``x`` that starts ``shift`` elements into its
    allocation (so 4 * shift bytes off 16-byte alignment for float32)."""
    raw = x.new_empty(x.numel() + shift)
    out = raw[shift:].view(x.shape)
    out.copy_(x)
    return out


def check_predicate_eval(rng, device, names=None) -> tuple[float, int]:
    """``predicate_eval`` (one window) and ``predicate_eval_batch`` against
    the plain versions over every sweep program at
    :data:`PREDICATE_CASES` (ragged E; bulk copies, 4-byte cp.async on a
    misaligned plane stride or buffer, device memory), then
    bench_kernels' program at E = 2^17 and 2^20.  Fails unless all three
    copy modes ran."""
    import torch

    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref

    cases = edge = 0
    max_err = 0.0
    modes = set()

    def one(program, t, v, w):
        nonlocal cases, edge, max_err
        B, T, E, K = t.shape
        G = v.shape[1]
        modes.add(pe.mask_plan((t, v, w), (T * E * K, G * E * K), E, K, program)[1])
        if B == 1:
            got = pe.predicate_eval(t[0], v[0], w[0], program)[None]
        else:
            got = pe.predicate_eval_batch(t, v, w, program)
        want = ref.predicate_eval_batch_ref(t, v, w, program)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and got.shape == want.shape,
              f"predicate_eval {program.term_branches}: {got.dtype} {tuple(got.shape)}")
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        cases += 1
        if err:
            edge += _mask_edges(program, t, v, got, want)

    for name, program in sweep_programs():
        if names and name not in names:
            continue
        for B, E, K, shift in PREDICATE_CASES:
            host = batch_inputs(rng, program, B, E, K, 128)
            one(program, *(shifted(torch.from_numpy(x).to(device), shift)
                           for x in host[:3]))
    for E in PREDICATE_BENCH_E:
        program, t, v, w = bench_predicate(rng, E, device)
        one(program, t[None], v[None], w[None])
    check(modes == {pe.MODE_BULK, pe.MODE_ASYNC4, pe.MODE_DIRECT},
          f"predicate_eval: copy modes {sorted(modes)} run, not all three")
    log(f"  predicate_eval: {cases} cases (every sweep program, one window and "
        "batches of 2/3/16 at E = 1/40/300/301/1000/4097, K = 1/3/4/8/512: bulk "
        "copies, 4-byte cp.async on a misaligned stride or a shifted buffer, device "
        "memory; bench_kernels' program at E = 2^17 and 2^20, K = 8); equal to the "
        f"plain version except {edge} events at a mass/ΔR cut's edge; max |err| "
        f"{max_err}")
    return max_err, edge


# ---------------------------------------------------------------------------
# the earlier designs of three kernels, kept as the baselines the redesigned
# ones are timed against in the same run, each with a plain C interface:
#  * parent_stage_launch: the cascade stage with one thread an event reading
#    its own K-slot rows of dense (B, T, E, K) inputs from device memory
#    (csrc/predicate_eval.cu before the staged-window redesign);
#  * parent_mask_launch: the (B, E) mask the same way, one thread an event
#    (predicate_eval_launch before it took the stage kernel's evaluator);
#  * parent_compact_launch: stream_compact in two kernels, a ballot pass
#    and a copy pass in which every block sums every tile's count and one
#    thread copies its own row (csrc/stream_compact.cu before the
#    single-pass redesign; its compact.cuh inlined here)
# ---------------------------------------------------------------------------

PARENT_CU = r"""
#include "predicate.cuh"
namespace {
constexpr int kTile = 512;
constexpr int kWarps = kTile / 32;
__global__ void cascade_stage_kernel(Program p, Inputs batch, int T,
                                     uint32_t* __restrict__ packed,
                                     const int* __restrict__ seg_ids, int nb,
                                     int* __restrict__ out) {
  __shared__ int warp_counts[kWarps];
  const long long b = blockIdx.y;
  const long long e = (long long)blockIdx.x * kTile + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in_range = e < batch.E;
  uint32_t* word = packed + b * (batch.E >> 5) + (e >> 5);
  bool alive = in_range && ((*word >> lane) & 1u);
  if (alive) alive = eval_event(p, e, window_inputs(batch, b, T, p.G));
  const uint32_t ballot = __ballot_sync(0xffffffffu, alive);
  int* row = out + b * (nb + 1);
  if (lane == 0) {
    warp_counts[warp] = __popc(ballot);
    if (in_range) *word = ballot;
  }
  if (alive) {
    const int s = seg_ids[b * batch.E + e];
    if (s >= 0 && s < nb && row[s] == 0) atomicOr(row + s, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    if (total) atomicAdd(row + nb, total);
  }
}
__global__ void predicate_eval_kernel(Program p, Inputs batch, int T,
                                      int* __restrict__ out) {
  const long long b = blockIdx.y;
  const long long e = (long long)blockIdx.x * kTile + threadIdx.x;
  if (e >= batch.E) return;
  out[b * batch.E + e] =
      eval_event(p, e, window_inputs(batch, b, T, p.G)) ? 1 : 0;
}
template <typename M>
__global__ void compact_mask_kernel(const M* __restrict__ mask, long long E,
                                    uint32_t* words, int* tile_counts) {
  __shared__ int warp_counts[kWarps];
  const long long e = (long long)blockIdx.x * kTile + threadIdx.x;
  const bool keep = e < E && mask[e] != M(0);
  const uint32_t ballot = __ballot_sync(0xffffffffu, keep);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_counts[warp] = __popc(ballot);
    if (e < E) words[e >> 5] = ballot;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    tile_counts[blockIdx.x] = total;
  }
}
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  return total;
}
template <typename U>
__global__ void compact_rows_kernel(const U* __restrict__ payload,
                                    const uint32_t* __restrict__ words,
                                    const int* __restrict__ tile_counts,
                                    int n_tiles, long long E, int D,
                                    U* __restrict__ out, int* total_out) {
  __shared__ int scratch[kWarps];
  __shared__ int warp_rank[kWarps];
  const int tile = blockIdx.x;
  int before = 0, all = 0;
  for (int t = threadIdx.x; t < n_tiles; t += kTile) {
    const int c = tile_counts[t];
    all += c;
    if (t < tile) before += c;
  }
  before = block_sum(before, scratch);
  all = block_sum(all, scratch);
  const long long e = (long long)tile * kTile + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t word = e < E ? words[e >> 5] : 0u;
  if (lane == 0) warp_rank[warp] = __popc(word);
  __syncthreads();
  int rank = __popc(word & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += warp_rank[w];
  if (e < E && ((word >> lane) & 1u)) {
    const long long dst = (long long)(before + rank) * D;
    for (int d = 0; d < D; ++d) out[dst + d] = payload[e * D + d];
  }
  if (e < E && e >= all) {
    for (int d = 0; d < D; ++d) out[e * D + d] = U(0);
  }
  if (tile == 0 && threadIdx.x == 0) *total_out = all;
}
template <typename U>
cudaError_t launch_rows(const void* payload, const uint32_t* words,
                        const int* tile_counts, int n_tiles, long long E, int D,
                        void* out, int* total, cudaStream_t s) {
  compact_rows_kernel<U><<<n_tiles, kTile, 0, s>>>(
      static_cast<const U*>(payload), words, tile_counts, n_tiles, E, D,
      static_cast<U*>(out), total);
  return cudaGetLastError();
}
}  // namespace
extern "C" int parent_stage_launch(
    const float* terms, const float* valid, const float* weights, int B,
    int T, int G, long long E, int K, const int* groups, const int* term_ids,
    const int* ops, const float* thrs, const float* cmp_thrs,
    const int* rpn_op, const int* rpn_term, const float* rpn_const,
    uint32_t* packed, const int* seg_ids, int nb, int* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(int) * (size_t)B * (size_t)(nb + 1), s);
  if (err != cudaSuccess) return (int)err;
  Program p{groups, term_ids, ops, thrs, cmp_thrs, rpn_op, rpn_term, rpn_const, G};
  Inputs batch{terms, valid, weights, E, K};
  dim3 grid((unsigned)((E + kTile - 1) / kTile), (unsigned)B);
  cascade_stage_kernel<<<grid, kTile, 0, s>>>(p, batch, T, packed, seg_ids, nb, out);
  return (int)cudaGetLastError();
}
extern "C" int parent_mask_launch(
    const float* terms, const float* valid, const float* weights, int B,
    int T, int G, long long E, int K, const int* groups, const int* term_ids,
    const int* ops, const float* thrs, const float* cmp_thrs,
    const int* rpn_op, const int* rpn_term, const float* rpn_const, int* out,
    void* stream) {
  Program p{groups, term_ids, ops, thrs, cmp_thrs, rpn_op, rpn_term, rpn_const, G};
  Inputs batch{terms, valid, weights, E, K};
  const dim3 grid((unsigned)((E + kTile - 1) / kTile), (unsigned)B);
  predicate_eval_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      p, batch, T, out);
  return (int)cudaGetLastError();
}
extern "C" int parent_compact_launch(const void* payload, const void* mask,
                                     int mask_bytes, long long E, int D,
                                     int elem_bytes, uint32_t* words,
                                     int* tile_counts, void* out, int* total,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (int)((E + kTile - 1) / kTile);
  if (mask_bytes == 1) {
    compact_mask_kernel<uint8_t><<<n_tiles, kTile, 0, s>>>(
        static_cast<const uint8_t*>(mask), E, words, tile_counts);
  } else {
    compact_mask_kernel<int32_t><<<n_tiles, kTile, 0, s>>>(
        static_cast<const int32_t*>(mask), E, words, tile_counts);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (elem_bytes) {
    case 1: return (int)launch_rows<uint8_t>(payload, words, tile_counts, n_tiles, E, D, out, total, s);
    case 2: return (int)launch_rows<uint16_t>(payload, words, tile_counts, n_tiles, E, D, out, total, s);
    case 4: return (int)launch_rows<uint32_t>(payload, words, tile_counts, n_tiles, E, D, out, total, s);
    default: return (int)launch_rows<uint64_t>(payload, words, tile_counts, n_tiles, E, D, out, total, s);
  }
}
"""


def start_parent_build():
    """Start ``nvcc`` on :data:`PARENT_CU` (beside the package's builds,
    which run at the same time); returns (process, library path)."""
    import hashlib

    from repro_torch.kernels import _build

    digest = hashlib.sha256(PARENT_CU.encode() + (
        _build._CSRC / "predicate.cuh").read_bytes()).hexdigest()[:16]
    lib = _build.build_dir() / f"parent-{digest}.so"
    if lib.exists():
        return None, lib
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    src = lib.with_suffix(".cu")
    src.write_text(PARENT_CU)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC), "-o",
           str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), lib


def finish_parent_build(proc, lib):
    """Wait for :func:`start_parent_build`; returns the three baselines,
    each called as the wrapper it stood behind was, wrapper work and all:
    ``.stage(terms, valid, weights, packed, seg_ids, program, nb) -> out``
    (``packed`` updated in place), ``.mask(terms, valid, weights, program)
    -> (B, E) int32`` and ``.compact(payload, mask) -> (packed, count)``
    (four allocations a call, as its wrapper made; its argument checks,
    the same as today's, left out)."""
    import ctypes
    from types import SimpleNamespace

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels.skim_fused import program_args

    if proc is not None:
        out, err = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on the parent's kernels:\n{out}{err}")
    lib = ctypes.CDLL(str(lib))
    pv, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dense = [pv, pv, pv, i, i, i, ll, i, *([pv] * 8)]
    lib.parent_stage_launch.argtypes = [*dense, pv, pv, i, pv, pv]
    lib.parent_mask_launch.argtypes = [*dense, pv, pv]
    lib.parent_compact_launch.argtypes = [pv, pv, i, ll, i, i, pv, pv, pv, pv, pv]
    for fn in (lib.parent_stage_launch, lib.parent_mask_launch, lib.parent_compact_launch):
        fn.restype = ctypes.c_int
    p = _build.ptr

    def stream_of(device):  # as the earlier wrappers looked the stream up
        return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

    def stage(t, v, w, packed, seg, program, nb):
        B, T, E, K = t.shape
        out = torch.empty((B, nb + 1), dtype=torch.int32, device=t.device)
        rc = lib.parent_stage_launch(
            p(t), p(v), p(w), B, T, program.n_groups, E, K,
            *program_args(program, t.device), p(packed), p(seg), nb, p(out),
            stream_of(t.device))
        _build.check_launch("parent cascade_stage", rc)
        return out

    def mask(t, v, w, program):
        B, T, E, K = pe._check_inputs("predicate_eval", t, v, w, program)
        out = torch.empty((B, E), dtype=torch.int32, device=t.device)
        with torch.cuda.device(t.device):
            rc = lib.parent_mask_launch(
                p(t), p(v), p(w), B, T, program.n_groups, E, K,
                *program_args(program, t.device), p(out), stream_of(t.device))
        _build.check_launch("parent predicate_eval", rc)
        return out

    def compact(payload, keep):
        device = payload.device
        E, D = payload.shape
        out = torch.empty_like(payload)
        total = torch.empty(1, dtype=torch.int32, device=device)
        words = torch.empty(-(-E // 32), dtype=torch.int32, device=device)
        tile_counts = torch.empty(-(-E // 512), dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            rc = lib.parent_compact_launch(
                p(payload), p(keep), keep.element_size(), E, D, payload.element_size(),
                p(words), p(tile_counts), p(out), p(total), stream_of(device))
        _build.check_launch("parent stream_compact", rc)
        return out, total[0]

    return SimpleNamespace(stage=stage, mask=mask, compact=compact)


def count_uploads(step_name: str = "cascade_stage_step"):
    """Count, until the returned ``restore()``, every host-to-device copy
    made by ``Tensor.copy_`` or ``Tensor.to`` (any thread): copies, bytes
    and how many came from pageable memory, in total and inside
    ``ops.<step_name>`` (on its caller's thread), with that function's
    calls.  Returns (counts, restore)."""
    import torch

    from repro_torch.kernels import ops

    counts = {"calls": 0, "uploads": 0, "bytes": 0, "pageable": 0,
              "step_uploads": 0, "step_bytes": 0, "step_pageable": 0}
    lock, local = threading.Lock(), threading.local()
    step, copy_, to = getattr(ops, step_name), torch.Tensor.copy_, torch.Tensor.to

    def note(src, dst_cuda):
        if not dst_cuda or src.is_cuda:
            return
        nbytes, pageable = src.numel() * src.element_size(), not src.is_pinned()
        with lock:
            counts["uploads"] += 1
            counts["bytes"] += nbytes
            counts["pageable"] += pageable
            if getattr(local, "in_step", False):
                counts["step_uploads"] += 1
                counts["step_bytes"] += nbytes
                counts["step_pageable"] += pageable

    def counting_copy(self, src, *a, **k):
        if isinstance(src, torch.Tensor):
            note(src, self.is_cuda)
        return copy_(self, src, *a, **k)

    def counting_to(self, *a, **k):
        out = to(self, *a, **k)
        if out is not self:
            note(self, out.is_cuda)
        return out

    def counting_step(*a, **k):
        with lock:
            counts["calls"] += 1
        local.in_step = True
        try:
            return step(*a, **k)
        finally:
            local.in_step = False

    torch.Tensor.copy_, torch.Tensor.to = counting_copy, counting_to
    setattr(ops, step_name, counting_step)

    def restore():
        torch.Tensor.copy_, torch.Tensor.to = copy_, to
        setattr(ops, step_name, step)

    return counts, restore


# ---------------------------------------------------------------------------
# phase 2a: stream_compact, skim_fused_batch and flash_attention
# ---------------------------------------------------------------------------

COMPACT_KINDS = ("float32", "int32", "bfloat16", "int64", "bool")


def compact_payload(rng, kind: str, E: int, D: int):
    """An (E, D) host payload of ``kind``: float32 and bfloat16 with NaNs
    (random payload bits) and -0.0 mixed in, int32 at and above 2^24 (and
    negative), int64 across its range, random bools."""
    import numpy as np
    import torch

    n = E * D
    if kind in ("float32", "bfloat16"):
        x = rng.normal(size=n).astype(np.float32)
        nan = (np.uint32(0x7FC00000) | rng.integers(0, 1 << 22, n).astype(np.uint32))
        special = rng.random(n)
        x = np.where(special < 0.05, nan.view(np.float32), x)
        x = np.where((special >= 0.05) & (special < 0.1), np.float32(-0.0), x)
        t = torch.from_numpy(x.reshape(E, D))
        return t.to(torch.bfloat16) if kind == "bfloat16" else t
    if kind == "int32":
        big = rng.integers((1 << 24) - 3, (1 << 31) - 1, n)
        sign = np.where(rng.random(n) < 0.3, -1, 1)
        return torch.from_numpy((big * sign).astype(np.int32).reshape(E, D))
    if kind == "int64":
        return torch.from_numpy(
            rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64).reshape(E, D))
    return torch.from_numpy(rng.random((E, D)) < 0.5)


def compact_mask(rng, E: int, rate: float, as_int: bool):
    """(E,) keep mask at ``rate``: bool, or int32 whose kept entries are
    nonzero values of either sign (the kernel keeps ``mask != 0``)."""
    import numpy as np
    import torch

    keep = rng.random(E) < rate
    if not as_int:
        return torch.from_numpy(keep)
    vals = rng.choice(np.array([1, 7, -1, -5], np.int32), E)
    return torch.from_numpy(np.where(keep, vals, 0).astype(np.int32))


def check_stream_compact(rng, device, Es=(1, 300, 512, 4097, N_EVENTS)) -> float:
    """``stream_compact`` against its plain version, bit for bit: every E
    of ``Es``, D in 1/3/4/8/16 (rows of a multiple of 16 bytes, copied in
    16-byte units, and of others, copied by the element), rates
    0/0.13/0.5/1, every payload kind of :data:`COMPACT_KINDS`, bool and
    int32 masks; then payloads and masks shifted off 16-byte alignment
    (:func:`shifted`), which take the element-wise paths.  Returns the
    largest :func:`bit_err` seen."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_compact as sc

    cases = 0
    max_err = 0.0

    def one(payload, mask, what):
        nonlocal cases, max_err
        got, count = sc.stream_compact(payload, mask)
        want, want_count = ref.stream_compact_ref(payload, mask)
        torch.cuda.synchronize()
        err = bit_err(got, want)
        max_err = max(max_err, err)
        cases += 1
        check(int(count) == int(want_count) == int((mask != 0).sum()),
              f"stream_compact {what}: count {int(count)} vs {int(want_count)}")
        check(err == 0.0, f"stream_compact {what}: rows differ from the plain "
              f"version (max |bits| {err})")

    for E in Es:
        for D in (1, 3, 4, 8, 16):
            for kind in COMPACT_KINDS:
                payload = compact_payload(rng, kind, E, D).to(device)
                for i, rate in enumerate((0.0, 0.13, 0.5, 1.0)):
                    mask = compact_mask(rng, E, rate, as_int=bool(i % 2)).to(device)
                    one(payload, mask, f"E={E} D={D} {kind} rate={rate}")
    for E in (300, 4097, 70_000):
        for D, kind in ((4, "float32"), (8, "bfloat16"), (2, "int64"), (3, "int32")):
            payload = compact_payload(rng, kind, E, D).to(device)
            for as_int in (False, True):
                mask = compact_mask(rng, E, 0.3, as_int).to(device)
                for p_shift, m_shift in ((1, 0), (0, 1), (1, 3)):
                    one(shifted(payload, p_shift), shifted(mask, m_shift),
                        f"E={E} D={D} {kind} shifted by {p_shift}/{m_shift}")
    log(f"  stream_compact: {cases} cases bit-identical to the plain version "
        f"(E in {'/'.join(map(str, Es))}, D in 1/3/4/8/16, rates 0/0.13/0.5/1, "
        "float32 and bf16 with NaN payloads and -0.0, int32 at and above 2^24, "
        "int64, bool; bool and int32 masks; payloads and masks off 16-byte "
        f"alignment at E = 300/4097/70000); max |bits| {max_err}")
    return max_err


def batch_sweep_inputs(rng, program, B: int, E: int, K: int, D: int = 2):
    """A (B, ...) batch of :func:`sweep_inputs` windows: numpy terms,
    valid, weights and payload (column 0 the local event index)."""
    import numpy as np

    per = [sweep_inputs(rng, program, E, K, D) for _ in range(B)]
    return tuple(np.stack([w[i] for w in per]) for i in range(4))


def check_skim_fused_batch(rng, device, names=None) -> tuple[float, int]:
    """``skim_fused_batch`` against its plain version over the sweep
    programs, B in 1/3/16, E in 512/4096, K in 1/8: packed rows and counts
    bit for bit, except events at a mass/ΔR cut's edge (as
    :func:`check_skim_fused`).  Returns (max |kernel - plain|, edge
    events)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import skim_fused as sf

    cases = edge = 0
    max_err = 0.0
    for name, program in sweep_programs():
        if names and name not in names:
            continue
        for B in (1, 3, 16):
            for E in (512, 4096):
                for K in (1, 8):
                    host = batch_sweep_inputs(rng, program, B, E, K)
                    t, v, w, p = (torch.from_numpy(x).to(device) for x in host)
                    got, counts = sf.skim_fused_batch(t, v, w, p, program)
                    want, want_counts = ref.skim_fused_batch_ref(t, v, w, p, program)
                    torch.cuda.synchronize()
                    cases += 1
                    check(got.shape == want.shape and counts.dtype == torch.int32,
                          f"skim_fused_batch {name}: {tuple(got.shape)} {counts.dtype}")
                    max_err = max(max_err, float((got - want).abs().max()),
                                  float((counts - want_counts).abs().max()))
                    if torch.equal(counts, want_counts) and torch.equal(
                        got.view(torch.int32), want.view(torch.int32)
                    ):
                        if name == "empty":
                            check(int(counts.sum()) == 0, "empty mask: survivors found")
                        if name == "full":
                            check(int(counts.sum()) == B * E, "full mask: events lost")
                        continue
                    for b in range(B):
                        n, wn = int(counts[b]), int(want_counts[b])
                        if n == wn and torch.equal(got[b].view(torch.int32),
                                                   want[b].view(torch.int32)):
                            continue
                        edge += packed_edges(
                            f"skim_fused_batch {name} B={B} E={E} K={K} window {b}",
                            program, t[b], v[b], got[b], n, want[b], wn)
    log(f"  skim_fused_batch: {cases} cases (every sweep program, B in 1/3/16, "
        f"E in 512/4096, K in 1/8); packed rows and counts equal to the plain "
        f"version except {edge} events at a mass/ΔR cut's edge; max |err| {max_err}")
    return max_err, edge


FLASH_SHAPES = ((1, 1, 128, 32), (2, 3, 256, 64), (1, 2, 512, 128))  # tests/test_kernels.py
# the kernel's edges: S a multiple of neither key tile (32, 128), a D the
# wrapper pads to 48, B*H = 72 heads over several waves of CTAs
FLASH_EDGE_SHAPES = ((1, 2, 200, 128), (1, 2, 2049, 128), (1, 2, 200, 40), (2, 36, 384, 128))
# (rtol, atol) against the plain version on the card.  float32: the JAX
# tests' 3e-5.  bf16: kernel and plain version both accumulate in float32
# and round once to bf16, so they differ by at most about one bf16 ulp
# (2^-8 of the value); 1e-2 relative plus 4e-3 absolute allows a few, far
# under the JAX tests' 0.05, which is as large as a typical output at
# S = 2048.
FLASH_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (1e-2, 4e-3)}


def attention_close(got, want, dtype_name: str, what: str) -> float:
    """Fails unless |got - want| <= atol + rtol * |want| everywhere (in
    float32 for float32 inputs; for bf16 both are bf16, compared in the
    working type's values).  Returns max |got - want|."""
    import torch

    rtol, atol = FLASH_TOL[dtype_name]
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    diff = (g - w).abs()
    over = diff > atol + rtol * w.abs()
    check(not bool(over.any()),
          f"{what}: {int(over.sum())} values outside rtol {rtol}, atol {atol} "
          f"(max |err| {float(diff.max())})")
    return float(diff.max())


def attention_inputs(rng, shape, dtype, device):
    import torch

    return [torch.from_numpy(rng.normal(size=shape).astype("float32"))
            .to(device=device, dtype=dtype) for _ in range(3)]


def check_flash_attention(rng, device, shapes=FLASH_SHAPES + FLASH_EDGE_SHAPES) -> float:
    """``flash_attention`` against its plain version at the JAX tests'
    shapes and :data:`FLASH_EDGE_SHAPES`, causal and not, within
    :data:`FLASH_TOL`.
    Returns the largest |kernel - plain| over all cases."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    cases = 0
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for shape in shapes:
        for causal in (True, False):
            for dtype_name in errs:
                dtype = getattr(torch, dtype_name)
                q, k, v = attention_inputs(rng, shape, dtype, device)
                got = fa.flash_attention(q, k, v, causal=causal)
                want = ref.flash_attention_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err = attention_close(got, want, dtype_name,
                                      f"flash_attention {shape} causal={causal} "
                                      f"{dtype_name}")
                errs[dtype_name] = max(errs[dtype_name], err)
                cases += 1
    log(f"  flash_attention: {cases} cases (shapes {list(shapes)}, causal and "
        f"not, float32 and bf16) within (rtol, atol) {FLASH_TOL} of the plain "
        f"version; max |err| float32 {errs['float32']}, "
        f"bf16 {errs['bfloat16']}")
    return max(errs.values())


# ---------------------------------------------------------------------------
# phase 2b: the main path's shapes, timed
# ---------------------------------------------------------------------------


def path_skim_cases(store, queries, device):
    """Every cascade stage's padded inputs over window 0, staged by the
    main path's own helpers (``build_padded_inputs``, ``pad_window``)."""
    import torch

    from repro_torch.core.engine import Breakdown, _decode_branches
    from repro_torch.core.neardata import build_padded_inputs, pad_window, window_pad_K
    from repro_torch.core.planner import plan_skim
    from repro_torch.core.query import parse_query
    from repro_torch.data.store import FetchStats

    cases = []
    stop = min(store.basket_events, store.n_events)
    for q in queries:
        plan = plan_skim(parse_query(q), store, window_events=store.basket_events,
                         prune=False, cascade=True)
        for stage in plan.cascade.stages:
            data = _decode_branches(store, list(stage.branches), 0, stop,
                                    Breakdown(), FetchStats(), True)
            K = window_pad_K(data, stage.program, store)
            pb = build_padded_inputs(data, stage.program, store, K=K,
                                     include_index=True, to_device=False)
            arrays = pad_window(pb)
            cases.append((stage.program,
                          [torch.from_numpy(a).to(device) for a in arrays], arrays))
    return cases


def path_stage_cases(store, queries, device, batch: int = 16):
    """Every cascade stage's inputs for the batch of the first ``batch``
    windows of each query, as ``run_window_batch`` hands them to
    ``ops.cascade_stage_step`` (recorded on the way through, the carried
    mask as it was before the stage): (program, nb, the dense batch the
    staged windows stand for (terms, valid, weights) on the card, packed,
    seg_ids, and a dict of the staged form: ``planes`` and ``rows`` on the
    card, ``host`` a copy of the staged buffer, ``shape``, ``n_groups``)."""
    import torch

    from repro_torch.core.engine import Breakdown
    from repro_torch.core.plan import CascadeExecutor, mark_fetched
    from repro_torch.core.planner import plan_skim
    from repro_torch.core.query import parse_query
    from repro_torch.data.store import FetchStats
    from repro_torch.kernels import ops

    cases = []
    step = ops.cascade_stage_step

    def record(inputs, packed, seg_ids, program, nb, **kw):
        host = inputs.host.clone()  # the staging buffer serves the next stage
        planes, rows = inputs.views(host.to(device))
        cases.append((program, nb, [torch.from_numpy(x).to(device)
                                    for x in dense_batch(inputs)],
                      packed.clone(), seg_ids.clone(),
                      {"planes": planes, "rows": rows, "host": host,
                       "shape": inputs.shape, "n_groups": inputs.n_groups,
                       "row_list": inputs.rows.tolist()}))
        return step(inputs, packed, seg_ids, program, nb, **kw)

    be = store.basket_events
    ops.cascade_stage_step = record
    for q in queries:
        plan = plan_skim(parse_query(q), store, window_events=be, prune=False,
                         cascade=True)
        ex = CascadeExecutor(plan, store, device=device)
        entries = []
        for start in range(0, min(batch * be, store.n_events), be):
            stop = min(start + be, store.n_events)
            ledger: dict = {}
            mark_fetched(store, ex.head_branches, start, stop, ledger)
            entries.append((start, stop, None, Breakdown(), FetchStats(), ledger))
        ex.run_window_batch(entries, pad_B=batch)
    ops.cascade_stage_step = step
    return cases


def path_decode_cases(store, queries, device):
    """The decode rounds of window 0 of each (label, query) (a window is one basket
    on the main path): one round per cascade stage's fetch set, and one for
    the output branches no stage read, each basket decoded to its branch's
    own dtype.  Each case: (label, parts {branch: [part]}, dtypes, plan_round
    layout, the staged round on ``device``, an output buffer there)."""
    import torch

    from repro_torch.core.planner import plan_skim
    from repro_torch.core.query import parse_query
    from repro_torch.data.codecs import bitpack_raw_parts
    from repro_torch.kernels import ops

    cases = []
    for label, q in queries:
        plan = plan_skim(parse_query(q), store, window_events=store.basket_events,
                         prune=False, cascade=True)
        rounds = [list(stage.branches) for stage in plan.cascade.stages]
        seen = {b for r in rounds for b in r}
        rounds.append([b for b in plan.output_branches if b not in seen])
        for i, names in enumerate(rounds):
            parts = {n: [bitpack_raw_parts(store._blobs[n][0])] for n in names}
            dtypes = {n: store.branches[n].np_dtype() for n in names}
            baskets = [(ps[0], ops.torch_dtype(dtypes[n])) for n, ps in parts.items()
                       if ps[0]["kind"] != 3 and ps[0]["n"]]
            if not baskets:
                continue
            layout = ops.plan_round(baskets)
            staged = torch.empty(layout["n_in"], dtype=torch.int32)
            ops.fill_round(staged.numpy(), layout)
            cases.append((f"{label} round {i}", parts, dtypes, layout,
                          staged.to(device),
                          torch.empty(layout["out_bytes"], dtype=torch.uint8,
                                      device=device)))
    return cases


def _summary(rows) -> dict | None:
    """Mean over the path's cases of each time and of the bound; the bound
    is by bytes or by operations as the larger of the two sums says.
    ``library_ms`` is null unless every case timed a library call."""
    if not rows:
        return None
    n = len(rows)
    t_bytes = sum(r["t_bytes"] for r in rows)
    t_ops = sum(r["t_ops"] for r in rows)
    libs = [r.get("library_ms") for r in rows]
    return {
        "ms": sum(r["ms"] for r in rows) / n,
        "plain_ms": sum(r["plain_ms"] for r in rows) / n,
        "bound_ms": sum(max(r["t_bytes"], r["t_ops"]) for r in rows) / n,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "stream_ms": sum(r["stream_ms"] for r in rows) / n,
        "library_ms": None if None in libs else sum(libs) / n,
    }


def bounds(summary: dict) -> dict:
    return {k: summary[k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "by_dtype",
                      "per_basket_ms", "round_ms", "window_ms", "dense_ms", "parent_ms",
                      "step_ms", "parent_step_ms", "staged_bytes", "dense_bytes",
                      "parent_stream_ms", "shapes", "wrapper_us")
            if k in summary}


def time_predicate(program, t, v, w, parent) -> dict:
    """``predicate_eval`` on one window (T, E, K) beside its earlier design
    (``parent.mask``) and its plain version.  The bound reads the K slots
    of the planes the program reads (``predicate_eval.planes_read``) once
    and writes the (E,) mask once."""
    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref

    T, E, K = t.shape
    G = v.shape[0]
    n_read = bin(pe.planes_read(program) & ((1 << (T + 2 * G)) - 1)).count("1")
    t_bytes, t_ops = bound_times(4 * (n_read * E * K + E), E * K * (T + 4 * G))
    tb, vb, wb = t[None], v[None], w[None]
    row = {
        "E": E, "K": K,
        "ms": device_ms(lambda: pe.predicate_eval(t, v, w, program)),
        "stream_ms": stream_ms(lambda: pe.predicate_eval(t, v, w, program)),
        "parent_ms": device_ms(lambda: parent.mask(tb, vb, wb, program)),
        "parent_stream_ms": stream_ms(lambda: parent.mask(tb, vb, wb, program)),
        "plain_ms": stream_ms(lambda: ref.predicate_mask(program, t, v, w), calls=5),
        "t_bytes": t_bytes, "t_ops": t_ops,
    }
    log(f"  predicate_eval T={T} G={G} E={E} K={K}, {n_read} planes read: kernel "
        f"{row['ms']:.5f} ms on the device (earlier design {row['parent_ms']:.5f}), "
        f"{row['stream_ms']:.5f} ms per call from the host (earlier design "
        f"{row['parent_stream_ms']:.5f}); plain {row['plain_ms']:.5f} ms; bound "
        f"{max(t_bytes, t_ops):.7f} ms")
    return row


def compact_wrapper_steps(payload, mask, calls: int = 2000) -> dict:
    """Host microseconds a call of each step of ``stream_compact``'s wrapper
    on the card, each timed alone over ``calls`` calls: its argument
    checks, the two allocations (packed rows, count), the current stream's
    raw handle, the workspace's status words and epoch, the ``ctypes``
    call that launches the kernel (with a fresh epoch each, the
    workspace's time subtracted), the launch counter; the whole wrapper;
    and two steps the earlier wrapper took on every call: the current
    stream as a Stream object, and entering the device context (this one
    enters it only where another card is current)."""
    import ctypes

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import stream_compact as sc
    from repro_torch.kernels.skim_fused import Workspace

    device = payload.device
    E, D = payload.shape
    n_status = -(-E // sc.EVENT_TILE)
    stream = torch.cuda.current_stream(device).cuda_stream
    out = torch.empty_like(payload)
    total = torch.empty((), dtype=torch.int32, device=device)
    fn, p, lock = sc._fn(), _build.ptr, threading.Lock()
    n = [0]

    def checks():
        return (mask.dtype in sc.MASK_DTYPES and payload.dim() == 2 and mask.dim() == 1
                and mask.shape[0] == payload.shape[0] and payload.is_cuda
                and mask.device == device and payload.is_contiguous()
                and mask.is_contiguous() and payload.element_size())

    def reserve():
        return Workspace.reserve(device, stream, n_status, 1)

    def launch():
        status, ticket, epoch = reserve()
        return fn(p(payload), p(mask), mask.element_size(), E, D, payload.element_size(),
                  p(status), p(ticket), epoch, p(out), p(total), ctypes.c_void_p(stream))

    def context():
        with torch.cuda.device(device):
            pass

    def count():
        with lock:
            n[0] += 1

    def each(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    steps = {
        "checks": each(checks),
        "alloc_out": each(lambda: torch.empty_like(payload)),
        "alloc_count": each(lambda: torch.empty((), dtype=torch.int32, device=device)),
        "current_stream": each(lambda: _build.stream_id(device)),
        "current_stream_object": each(lambda: torch.cuda.current_stream(device).cuda_stream),
        "workspace": each(reserve),
        "pointers": each(lambda: (p(payload), p(mask), p(out), p(total))),
        "launch_and_workspace": each(launch),
        "count": each(count),
        "whole_wrapper": each(lambda: sc.stream_compact(payload, mask)),
        "device_context": each(context),
    }
    steps["launch"] = steps["launch_and_workspace"] - steps["workspace"]
    log("  stream_compact's wrapper, host us a call by step: " + json.dumps(
        {k: round(v, 3) for k, v in steps.items()}))
    return steps


def time_kernels(skim_cases=(), decode_cases=(), stage_cases=(), batch_cases=(),
                 compact_cases=(), attn_cases=(), pred_cases=(), parent=None) -> dict:
    """Each kernel at the shapes its path gives it: its device time (CUDA
    graph replay), its time per call as the stream sees it from the host,
    the plain version's time per call, the bound (decoded values counted
    at each branch's own width) and, where one PyTorch call computes the
    same function, that call's time per call from the host
    (``library_ms``).  ``cascade_stage``, ``predicate_eval`` and
    ``stream_compact`` are timed beside their earlier designs (``parent``,
    from :func:`finish_parent_build`) on the same inputs.
    ``predicate_eval`` also at ``pred_cases`` (program, terms, valid,
    weights: bench_kernels' shapes) and ``stream_compact`` at every case
    (label, payload, mask), the mean over those labelled "path" as its
    row; each shape is listed under ``shapes``.  Only the kernels given
    cases are timed."""
    import torch

    from repro_torch.kernels import basket_decode as bd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref
    from repro_torch.kernels import skim_fused as sf
    from repro_torch.kernels import stream_compact as sc

    out = {}
    rows = []
    for program, (t, v, w, p), arrays in skim_cases:
        T, E, K = t.shape
        G, D = v.shape[0], p.shape[1]
        # read terms, valid, weights and payload once; write the packed
        # rows (zero tail included) and the count once
        nbytes = 4 * (T * E * K + 2 * G * E * K + 2 * E * D + 1)
        ops = E * K * (T + 4 * G)  # a compare per term slot, the group's AND/sum
        t_bytes, t_ops = bound_times(nbytes, ops)
        row = {
            "ms": device_ms(lambda: sf.skim_fused(t, v, w, p, program)),
            "stream_ms": stream_ms(lambda: sf.skim_fused(t, v, w, p, program)),
            "plain_ms": stream_ms(lambda: ref.skim_fused_ref(t, v, w, p, program)),
            # the path's whole call: numpy in, one upload, the launch, one
            # readback of counts and rows
            "window_ms": host_ms(lambda: kops.fused_skim(*arrays, program,
                                                         device=t.device)),
            "t_bytes": t_bytes, "t_ops": t_ops,
        }
        rows.append(row)
        log(f"  skim_fused T={T} G={G} E={E} K={K} D={D}: kernel {row['ms']:.5f} ms "
            f"on the device, {row['stream_ms']:.5f} ms per call from the host; "
            f"numpy to packed rows (ops.fused_skim) {row['window_ms']:.5f} "
            f"ms; plain {row['plain_ms']:.5f} ms; bound {max(t_bytes, t_ops):.7f} ms")
    out["skim_fused"] = _summary(rows)
    if rows:
        out["skim_fused"]["window_ms"] = sum(r["window_ms"] for r in rows) / len(rows)
    rows = []
    for label, parts, dtypes, layout, staged, dev_out in decode_cases:
        views = kops.round_views(staged, layout)
        descs = layout["descs"]
        N = len(descs)
        W, bits, n = descs[:, 1], descs[:, 3], descs[:, 7]
        # read each basket's planes (n_bits planes of W words) and its
        # first once; write each value once at its branch's own width.
        # The staging's stride and alignment padding and the descriptors
        # are not work the decode needs.
        nbytes = 4 * (int((bits * W).sum()) + N) + sum(
            int(k) * store.itemsize for k, (_, store) in zip(n, layout["stores"]))
        ops = int((W * 32 * (3 * bits + 6)).sum())  # rebuild a code, transform, scan
        t_bytes, t_ops = bound_times(nbytes, ops)
        row = {
            "ms": device_ms(lambda: bd.decode_round(*views, dev_out)),
            "stream_ms": stream_ms(lambda: bd.decode_round(*views, dev_out)),
            "plain_ms": stream_ms(lambda: ref.basket_decode_round_ref(
                *views, layout["out_bytes"]), calls=5),
            # the path's whole call: blob parts in, one upload, the launch,
            # one readback, numpy arrays out
            "round_ms": host_ms(lambda: kops.basket_decode_round(parts, dtypes,
                                                                 staged.device)),
            "t_bytes": t_bytes, "t_ops": t_ops,
        }
        row["per_basket_ms"] = row["ms"] / N
        rows.append(row)
        log(f"  basket_decode {label}: {N} baskets ({sorted(set(descs[:, 4].tolist()))} "
            f"kinds) in one launch: kernel {row['ms']:.5f} ms on the device "
            f"({row['per_basket_ms']:.6f} ms a basket), {row['stream_ms']:.5f} ms per "
            f"call from the host; parts to arrays (ops.basket_decode_round) "
            f"{row['round_ms']:.5f} ms; plain {row['plain_ms']:.5f} ms; bound "
            f"{max(t_bytes, t_ops):.7f} ms")
    out["basket_decode"] = _summary(rows)
    if rows:
        out["basket_decode"]["per_basket_ms"] = (
            sum(r["per_basket_ms"] for r in rows) / len(rows))
        out["basket_decode"]["round_ms"] = sum(r["round_ms"] for r in rows) / len(rows)

    rows, single = [], []
    for program, nb, (t, v, w), packed0, seg, st in stage_cases:
        B, T, E, K = t.shape
        G = v.shape[1]
        planes, stage_rows = st["planes"], st["rows"]
        S = len(st["row_list"])
        # the least the stage must move at this run's data: for each event
        # live in the carried mask of a staged window, its K slots of every
        # plane the program reads; the staged windows' mask words read and
        # written, the live events' seg_ids, the (B, nb + 1) output
        live = int(ref.unpack_bits(packed0[stage_rows.long()], E).sum())
        n_read = bin(pe.planes_read(program)).count("1")
        nbytes = 4 * (live * K * n_read + 2 * S * E // 32 + live + B * (nb + 1))
        t_bytes, t_ops = bound_times(nbytes, live * K * (T + 4 * G))
        pk = packed0.clone()

        def restore():
            return pk.copy_(packed0)

        def kernel():  # the path's launch: the staged windows only
            restore()
            return pe.cascade_stage_windows(planes, stage_rows, pk, seg, program, nb)

        def dense():  # the same kernel, every window of the batch staged
            restore()
            return pe.cascade_stage(t, v, w, pk, seg, program, nb)

        def parent_kernel():  # the earlier design, dense inputs
            restore()
            return parent.stage(t, v, w, pk, seg, program, nb)

        # the stage step from the host, as the path calls it: this tree's
        # (one page-locked upload of the staged buffer, the launch, the
        # summary back) against the parent's (three pageable uploads of the
        # dense batch, its launch, the summary back)
        inputs = kops.CascadeInputs(st["shape"], st["n_groups"], st["row_list"],
                                    t.device)
        inputs.host.copy_(st["host"])
        dense_np = dense_batch(inputs)

        def step():
            restore()
            kops.stage_summary_host(kops.cascade_stage_step(
                inputs, pk, seg, program, nb, device=t.device)[1])

        def parent_step():
            restore()
            up = [torch.as_tensor(x).to(t.device) for x in dense_np]
            kops.stage_summary_host(parent.stage(*up, pk, seg, program, nb))

        copy_ms = device_ms(restore)
        copy_stream = stream_ms(restore)
        row = {
            "ms": device_ms(kernel) - copy_ms,
            "dense_ms": device_ms(dense) - copy_ms,
            "parent_ms": device_ms(parent_kernel) - copy_ms,
            "stream_ms": stream_ms(kernel) - copy_stream,
            "parent_stream_ms": stream_ms(parent_kernel) - copy_stream,
            "plain_ms": stream_ms(lambda: (restore(), pe.cascade_stage_windows_plain(
                planes, stage_rows, pk, seg, program, nb))) - copy_stream,
            "step_ms": host_ms(step, calls=20),
            "parent_step_ms": host_ms(parent_step, calls=20),
            "staged_bytes": inputs.nbytes,
            "dense_bytes": 4 * B * (T + 2 * G) * E * K,
            "t_bytes": t_bytes, "t_ops": t_ops,
        }
        rows.append(row)
        log(f"  cascade_stage B={B} staged {S} T={T} G={G} E={E} K={K} nb={nb}, "
            f"{live} live events: kernel {row['ms']:.5f} ms on the device (every "
            f"window staged {row['dense_ms']:.5f}; the parent's kernel "
            f"{row['parent_ms']:.5f}), {row['stream_ms']:.5f} ms per call from the "
            f"host (parent {row['parent_stream_ms']:.5f}); the step from the host "
            f"{row['step_ms']:.5f} ms, {row['staged_bytes']} bytes in one pinned "
            f"upload (parent {row['parent_step_ms']:.5f} ms, "
            f"{row['dense_bytes']} bytes in three pageable uploads); plain "
            f"{row['plain_ms']:.5f} ms; bound {max(t_bytes, t_ops):.7f} ms")
        # predicate_eval: window 0 of the same batch, the mask alone
        single.append(time_predicate(program, t[0], v[0], w[0], parent))
    out["predicate_eval_batch"] = _summary(rows)
    if rows:
        for key in ("dense_ms", "parent_ms", "parent_stream_ms", "step_ms",
                    "parent_step_ms", "staged_bytes", "dense_bytes"):
            out["predicate_eval_batch"][key] = sum(r[key] for r in rows) / len(rows)
    out["predicate_eval"] = _summary(single)
    if single:
        for key in ("parent_ms", "parent_stream_ms"):
            out["predicate_eval"][key] = sum(r[key] for r in single) / len(single)
        out["predicate_eval"]["shapes"] = [  # bench_kernels' program
            {k: r[k] for k in ("E", "K", "ms", "stream_ms", "parent_ms", "parent_stream_ms",
                               "plain_ms")}
            | {"bound_ms": max(r["t_bytes"], r["t_ops"])}
            for r in (time_predicate(*case, parent) for case in pred_cases)]
    rows = []
    for program, t, v, w, p in batch_cases:
        B, T, E, K = t.shape
        G, D = v.shape[1], p.shape[2]
        # B windows of skim_fused's bytes and operations
        nbytes = 4 * B * (T * E * K + 2 * G * E * K + 2 * E * D + 1)
        t_bytes, t_ops = bound_times(nbytes, B * E * K * (T + 4 * G))
        row = {
            "ms": device_ms(lambda: sf.skim_fused_batch(t, v, w, p, program)),
            "stream_ms": stream_ms(lambda: sf.skim_fused_batch(t, v, w, p, program)),
            "plain_ms": stream_ms(
                lambda: ref.skim_fused_batch_ref(t, v, w, p, program)),
            "t_bytes": t_bytes, "t_ops": t_ops, "library_ms": None,
        }
        rows.append(row)
        log(f"  skim_fused_batch B={B} T={T} G={G} E={E} K={K} D={D}: kernel "
            f"{row['ms']:.5f} ms on the device, {row['stream_ms']:.5f} ms per call "
            f"from the host; plain {row['plain_ms']:.5f} ms; bound "
            f"{max(t_bytes, t_ops):.7f} ms")
    out["skim_fused_batch"] = _summary(rows)
    rows = []
    for label, payload, mask in compact_cases:
        E, D = payload.shape
        # read the mask once and the survivors' rows once; write the
        # packed rows, the zero tail and the count once; one test of the
        # mask per row
        row_bytes = D * payload.element_size()
        survivors = int(torch.count_nonzero(mask))
        nbytes = E * mask.element_size() + survivors * row_bytes + E * row_bytes + 4
        t_bytes, t_ops = bound_times(nbytes, E)
        row = {
            "label": label, "E": E, "D": D, "kept": survivors,
            "ms": device_ms(lambda: sc.stream_compact(payload, mask)),
            "stream_ms": stream_ms(lambda: sc.stream_compact(payload, mask)),
            "parent_ms": device_ms(lambda: parent.compact(payload, mask)),
            "parent_stream_ms": stream_ms(lambda: parent.compact(payload, mask)),
            "plain_ms": stream_ms(lambda: ref.stream_compact_ref(payload, mask)),
            # the same survivors in the same order, without the zero tail
            "library_ms": stream_ms(lambda: payload[mask]),
            "t_bytes": t_bytes, "t_ops": t_ops,
        }
        rows.append(row)
        log(f"  stream_compact {label} E={E} D={D} {payload.dtype}, {survivors} kept: "
            f"kernel {row['ms']:.5f} ms on the device (earlier design "
            f"{row['parent_ms']:.5f}), {row['stream_ms']:.5f} ms per call from the "
            f"host (earlier design {row['parent_stream_ms']:.5f}); plain "
            f"{row['plain_ms']:.5f} ms; payload[mask] {row['library_ms']:.5f} ms (no "
            f"zero tail); bound {max(t_bytes, t_ops):.7f} ms")
    if rows:
        path = [r for r in rows if r["label"] == "path"]
        out["stream_compact"] = _summary(path)
        out["stream_compact"]["parent_ms"] = sum(r["parent_ms"] for r in path) / len(path)
        out["stream_compact"]["wrapper_us"] = compact_wrapper_steps(*compact_cases[0][1:])
        out["stream_compact"]["shapes"] = [
            {k: r[k] for k in ("label", "E", "D", "kept", "ms", "stream_ms", "parent_ms",
                               "parent_stream_ms", "plain_ms", "library_ms")}
            | {"bound_ms": max(r["t_bytes"], r["t_ops"])} for r in rows]
    rows = []
    for q, k, v in attn_cases:
        B, H, S, D = q.shape
        bf16 = q.dtype == torch.bfloat16
        # q, k, v read once and the output written once; 2 products of
        # 2 operations per (row, key, column) the causal mask keeps
        t_bytes, _ = bound_times(4 * q.numel() * q.element_size(), 0)
        t_ops = attention_ops_ms(2 * 2 * B * H * D * S * (S + 1) / 2, bf16)
        scale = ref.attention_scale(D)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)

        row = {
            "dtype": str(q.dtype).removeprefix("torch."),
            "library_kernels": profiled_kernels(sdpa),
            "ms": device_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
            "stream_ms": stream_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
            "plain_ms": stream_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True)),
            "library_ms": stream_ms(sdpa),
            "library_device_ms": device_ms(sdpa),
            "t_bytes": t_bytes, "t_ops": t_ops,
        }
        rows.append(row)
        log(f"  flash_attention {tuple(q.shape)} causal {q.dtype}: kernel "
            f"{row['ms']:.5f} ms on the device, {row['stream_ms']:.5f} ms per call from "
            f"the host; plain {row['plain_ms']:.5f} ms; scaled_dot_product_attention "
            f"{row['library_ms']:.5f} ms per call from the host, "
            f"{row['library_device_ms']:.5f} ms on the device, kernels "
            f"{row['library_kernels']}; bound {max(t_bytes, t_ops):.7f} ms "
            f"({'bf16 tensor cores' if bf16 else 'split TF32 on the tensor cores'})")
    out["flash_attention"] = _summary(rows)
    if rows:
        out["flash_attention"]["by_dtype"] = {
            r["dtype"]: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                         "library_ms": r["library_ms"],
                         "library_device_ms": r["library_device_ms"],
                         "library_kernels": r["library_kernels"],
                         "bound_ms": max(r["t_bytes"], r["t_ops"])}
            for r in rows}
    return {name: v for name, v in out.items() if v is not None}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def fetch_row(stats) -> dict:
    return {
        "bytes_fetched": stats.bytes_fetched, "requests": stats.requests,
        "by_branch": dict(stats.by_branch), "bytes_skipped": stats.bytes_skipped,
        "requests_skipped": stats.requests_skipped,
        "cascade_bytes_skipped": stats.cascade_bytes_skipped,
    }


def count_calls(store):
    """Count, until the returned function is called, the decode rounds of
    ``store`` that send a bitpack miss to the card (a miss the card
    decodes: not empty, not raw literals) and the calls of
    ``ops.fused_skim``.  Returns (counts, restore)."""
    from repro_torch.data.codecs import bitpack_raw_parts
    from repro_torch.kernels import ops

    counts = {"device_rounds": 0, "window_skims": 0}
    uncached, window = store._decode_round_uncached, ops.fused_skim
    lock = threading.Lock()  # the prefetcher decodes on its own thread

    def on_card(blob) -> bool:
        part = bitpack_raw_parts(blob)
        return part["n"] > 0 and part["kind"] != 3

    def counting_decode(calls):
        # a round's calls, [(branch, blobs), ...] ({branch: blobs} before
        # the round replayed the JAX package's calls)
        pairs = calls.items() if isinstance(calls, dict) else calls
        if (store.codec == "bitpack" and store.resolved_decode_backend() == "device"
                and any(on_card(b) for _, bs in pairs for b in bs)):
            with lock:
                counts["device_rounds"] += 1
        return uncached(calls)

    def counting_window(*a, **k):
        with lock:
            counts["window_skims"] += 1
        return window(*a, **k)

    store._decode_round_uncached = counting_decode
    ops.fused_skim = counting_window

    def restore():
        del store._decode_round_uncached
        ops.fused_skim = window

    return counts, restore


def run_main_path(label, query, store, host_store) -> dict:
    """``run_skim`` with every default on the card: survivors and output
    columns held against the staged reference and the host cascade, the
    fetch ledger against the host cascade of the same plan (the staged
    reference fetches per query stage, not per cascade stage)."""
    import torch

    from repro_torch.core import run_skim
    from repro_torch.kernels import ops

    stats0 = store.decode_backend_stats()
    counts, restore = count_calls(store)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_skim(store, query)  # every default, on the card
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    restore()
    dec = store.decode_backend_stats()

    staged = run_skim(host_store, query, fused=False, pipeline=False, device="cpu")
    host = run_skim(host_store, query, device="cpu")

    plan = res.plan
    kinds = [d.decision for d in plan.window_decisions or ()]
    n_win = -(-store.n_events // store.basket_events)
    windows = (
        {"prune": kinds.count("prune"), "accept_all": kinds.count("accept_all"),
         "scan": kinds.count("scan")} if kinds else {"scan": n_win}
    )
    log(f"  [{label}] {res.n_passed}/{res.n_input} events passed in {wall:.3f} s "
        f"wall ({res.n_input / wall:,.0f} events/s); windows {windows}; "
        f"cascade order {res.extras.get('cascade_order')}")
    log(f"  [{label}] launches on the main path: {launches}; decode tier "
        f"{dec['backend']}: {dec['device_baskets'] - stats0['device_baskets']} "
        f"device baskets, {dec['fallbacks'] - stats0['fallbacks']} fallbacks")
    log(f"  [{label}] fetch: card {fetch_row(res.stats)['bytes_fetched']} B in "
        f"{res.stats.requests} requests; staged reference "
        f"{staged.stats.bytes_fetched} B in {staged.stats.requests} requests "
        "(one request per query stage, not per cascade stage); host cascade "
        f"{host.stats.bytes_fetched} B in {host.stats.requests} requests")

    log(f"  [{label}] decode rounds with a bitpack miss {counts['device_rounds']}, "
        f"per-window skim calls {counts['window_skims']}")
    check(launches["skim_fused"] > 0, f"{label}: skim_fused never launched")
    check(launches["basket_decode"] > 0, f"{label}: basket_decode never launched")
    check(launches["basket_decode"] == counts["device_rounds"],
          f"{label}: {launches['basket_decode']} decode launches for "
          f"{counts['device_rounds']} rounds with a bitpack miss")
    check(launches["skim_fused"] == counts["window_skims"],
          f"{label}: {launches['skim_fused']} skim_fused launches for "
          f"{counts['window_skims']} calls")
    check(dec["backend"] == "device", f"{label}: decode tier is {dec['backend']}")
    check(dec["device_baskets"] > stats0["device_baskets"],
          f"{label}: no basket decoded on the card")
    check(dec["fallbacks"] == 0, f"{label}: {dec['fallbacks']} decode fallbacks")
    for ref_name, ref in (("staged reference", staged), ("host cascade", host)):
        check(res.n_passed == ref.n_passed,
              f"{label}: {res.n_passed} survivors vs {ref.n_passed} ({ref_name})")
        check(res.output.manifest_hash() == ref.output.manifest_hash()
              and res.output._blobs == ref.output._blobs,
              f"{label}: output columns differ from the {ref_name}")
    check(fetch_row(res.stats) == fetch_row(host.stats),
          f"{label}: FetchStats differ from the host cascade of the same plan")
    check(res.extras["cascade_stages"] == host.extras["cascade_stages"]
          and res.extras["cascade_order"] == host.extras["cascade_order"],
          f"{label}: cascade ledgers differ from the host cascade")
    log(f"  [{label}] stage times (s): " + json.dumps(res.breakdown.as_dict()))
    log(f"  [{label}] survivors and output columns (every basket byte) equal "
        "the staged reference and the host cascade; FetchStats and the "
        "stage ledgers equal the host cascade")
    return {"wall_s": wall, "events_per_s": res.n_input / wall,
            "n_passed": res.n_passed, "launches": launches, "res": res,
            "staged": staged}


def run_batched_path(label, query, store, host_store, per_window, batch=16) -> dict:
    """The batched cascade: ``run_skim(..., device_batch=batch)`` on the
    card, held against the staged reference and the per-window card run
    (survivors, every output byte), the port's own host run of the
    batched path (FetchStats, cascade ledgers), and the preload run's
    bytes (fetched + cascade-skipped == preload fetched).  Dispatches are
    logged, not compared: the card's count also holds the device decode
    tier's, which the host store does not run."""
    import torch

    from repro_torch.core import run_skim
    from repro_torch.kernels import ops

    counts, restore = count_calls(store)
    uploads, restore_uploads = count_uploads()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_skim(store, query, device_batch=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    restore()
    restore_uploads()

    host = run_skim(host_store, query, device="cpu", device_batch=batch)
    preload = run_skim(host_store, query, device="cpu", cascade=False)
    pw = per_window["res"]
    log(f"  [{label}, device_batch={batch}] {res.n_passed}/{res.n_input} events "
        f"passed in {wall:.3f} s wall ({res.n_input / wall:,.0f} events/s; "
        f"per-window run {per_window['wall_s']:.3f} s, "
        f"{per_window['events_per_s']:,.0f} events/s); device_dispatches "
        f"{res.extras['device_dispatches']} (per-window run "
        f"{pw.extras['device_dispatches']}); launches {launches}")
    log(f"  [{label}, device_batch={batch}] fetch {res.stats.bytes_fetched} B in "
        f"{res.stats.requests} requests, cascade-skipped "
        f"{res.stats.cascade_bytes_skipped} B; preload run fetched "
        f"{preload.stats.bytes_fetched} B")

    check(launches["cascade_stage"] > 0, f"{label}: cascade_stage never launched")
    check(launches["basket_decode"] > 0, f"{label}: basket_decode never launched")
    check(launches["basket_decode"] == counts["device_rounds"],
          f"{label}: {launches['basket_decode']} decode launches for "
          f"{counts['device_rounds']} rounds with a bitpack miss")
    check(res.extras["device_batch"] == batch, f"{label}: device_batch not reported")
    # launches also hold the warm-ups of shapes first seen in this run
    check(0 < uploads["calls"] <= launches["cascade_stage"]
          and uploads["step_uploads"] == uploads["calls"]
          and uploads["step_pageable"] == 0,
          f"{label}: {uploads['step_uploads']} host-to-device copies "
          f"({uploads['step_pageable']} pageable) in {uploads['calls']} stage "
          f"steps ({launches['cascade_stage']} launches): not one page-locked "
          "copy a step")
    log(f"  [{label}, device_batch={batch}] host-to-device: "
        f"{uploads['step_uploads']} page-locked copies of {uploads['step_bytes']} "
        f"bytes in {uploads['calls']} stage steps; {uploads['uploads']} copies of "
        f"{uploads['bytes']} bytes in the whole run ({uploads['pageable']} pageable)")
    for ref_name, ref in (("staged reference", per_window["staged"]),
                          ("per-window card run", pw)):
        check(res.n_passed == ref.n_passed,
              f"{label}: {res.n_passed} survivors vs {ref.n_passed} ({ref_name})")
        check(res.output.manifest_hash() == ref.output.manifest_hash()
              and res.output._blobs == ref.output._blobs,
              f"{label}: batched output columns differ from the {ref_name}")
    check(fetch_row(res.stats) == fetch_row(host.stats),
          f"{label}: batched FetchStats differ from the host batched run")
    for key in ("cascade_order", "cascade_stages"):
        check(res.extras[key] == host.extras[key],
              f"{label}: batched {key} differs from the host batched run")
    check(res.stats.bytes_fetched + res.stats.cascade_bytes_skipped
          == preload.stats.bytes_fetched,
          f"{label}: fetched + cascade-skipped != the preload run's fetched")
    log(f"  [{label}, device_batch={batch}] survivors and output columns equal "
        "the staged reference and the per-window card run; FetchStats and the "
        "cascade ledgers equal the host batched run; fetched + cascade-skipped "
        "equals the preload run's fetched bytes")
    log(f"  [{label}, device_batch={batch}] stage times (s): "
        + json.dumps(res.breakdown.as_dict()))
    return {"wall_s": wall, "events_per_s": res.n_input / wall,
            "n_passed": res.n_passed, "launches": launches, "uploads": uploads,
            "device_dispatches": res.extras["device_dispatches"],
            "per_window_dispatches": pw.extras["device_dispatches"]}


# ---------------------------------------------------------------------------
# phase 3c: the entry points of the kernels no skim calls
# ---------------------------------------------------------------------------

# eight float32 branches of the NanoAOD-like store (n_filler=8)
COMPACT_BRANCHES = ("MET_pt", "MET_phi") + tuple(f"Filler_{i:03d}" for i in range(6))
# StarCoder2-7B's attention (attic/repro/configs/starcoder2_7b.py): 36 heads
# of head dim 4608/36 = 128, over its attn_chunk of 2048 positions
STARCODER2_7B_ATTN = (1, 36, 2048, 128)


def run_fused_batch_path(label, stage_case, device) -> dict:
    """``ops.fused_skim_batch`` on the first cascade stage's inputs for
    the first 16 padded windows of a cell (as ``run_window_batch`` stages
    them), payload column 0 the local event index.  Each window must equal
    ``ops.fused_skim`` (the per-window kernel) on the same window, bit for
    bit: the reference's own contract.  Each window is also held against
    the plain version on the same tensors, bit for bit but for events at a
    mass/ΔR cut's edge (as :func:`check_skim_fused_batch`)."""
    import torch

    from repro_torch.kernels import ops, ref

    program, _nb, (t, v, w), *_ = stage_case
    B, T, E, K = t.shape
    payload = torch.arange(E, dtype=torch.float32, device=device).repeat(B, 1)
    payload = payload[:, :, None].contiguous()
    ops.reset_launch_counts()
    packed, counts = ops.fused_skim_batch(t, v, w, payload, program)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["skim_fused_batch"]
    check(launches > 0, f"{label}: skim_fused_batch never launched")
    for b in range(B):
        one, n = ops.fused_skim(t[b], v[b], w[b], payload[b], program)
        torch.cuda.synchronize()
        check(int(n) == int(counts[b]) and torch.equal(
            one.view(torch.int32), packed[b].view(torch.int32)),
            f"{label}: fused_skim_batch window {b} differs from fused_skim "
            f"({int(counts[b])} vs {int(n)} survivors)")
    want, want_counts = ref.skim_fused_batch_ref(t, v, w, payload, program)
    torch.cuda.synchronize()
    max_err = max(float((packed - want).abs().max()),
                  float((counts - want_counts).abs().max()))
    edge = 0
    for b in range(B):
        n, wn = int(counts[b]), int(want_counts[b])
        if n == wn and torch.equal(packed[b].view(torch.int32), want[b].view(torch.int32)):
            continue
        edge += packed_edges(f"{label}: fused_skim_batch window {b} vs the plain version",
                             program, t[b], v[b], packed[b], n, want[b], wn)
    log(f"  [{label}] fused_skim_batch B={B} T={T} E={E} K={K}: survivors per "
        f"window {counts.tolist()}; every window equals fused_skim bit for bit "
        f"and the plain version but for {edge} events at a mass/ΔR cut's edge; "
        f"launches {launches}")
    return {"launches": launches, "max_abs_err": max_err,
            "case": (program, t, v, w, payload)}


def run_compact_path(store, host_store, n_passed: int, device) -> dict:
    """``ops.stream_compact`` on a whole store: the quickstart cell's
    1,000,000-event survivor mask over eight float32 branches.  The mask
    comes from the main path on the card with ``event`` added to the
    output branches (the quickstart query does not write it), which must
    keep the same ``n_passed``.  The packed rows must be the survivors'
    rows of those branches, bit for bit, and the count ``n_passed``."""
    import numpy as np
    import torch

    from repro_torch.core import run_skim
    from repro_torch.kernels import ops

    query = dict(QUICKSTART_QUERY, branches=QUICKSTART_QUERY["branches"] + ["event"])
    res = run_skim(store, query)
    check(res.n_passed == n_passed,
          f"quickstart with event: {res.n_passed} survivors vs {n_passed}")
    mask_host = np.zeros(store.n_events, bool)
    mask_host[res.output.read_flat("event")] = True
    check(int(mask_host.sum()) == n_passed, "quickstart: event indices repeat")
    payload_host = np.stack([host_store.read_flat(b) for b in COMPACT_BRANCHES], axis=1)
    check(payload_host.dtype == np.float32, f"payload is {payload_host.dtype}")
    payload = torch.from_numpy(payload_host).to(device)
    mask = torch.from_numpy(mask_host).to(device)
    ops.reset_launch_counts()
    packed, count = ops.stream_compact(payload, mask)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["stream_compact"]
    check(launches > 0, "stream_compact never launched")
    got = packed.cpu().numpy()
    n = int(count)
    check(n == n_passed, f"stream_compact counted {n}, the skim passed {n_passed}")
    check(got[:n].tobytes() == payload_host[mask_host].tobytes(),
          "stream_compact: packed rows are not the survivors' rows")
    check(not got[n:].view(np.uint32).any(), "stream_compact: tail not zero")
    log(f"  [quickstart] stream_compact of {payload_host.shape} float32 "
        f"({', '.join(COMPACT_BRANCHES)}) by the survivor mask: {n} rows, equal "
        f"to the survivors' rows bit for bit, tail zero; launches {launches}")
    return {"launches": launches, "case": ("path", payload, mask)}


def bench_compact(rng, E: int, device):
    """benchmarks/bench_kernels.py's compaction: (E, 16) float32 rows, 5%
    kept by a bool mask."""
    import torch

    payload = torch.from_numpy(rng.normal(size=(E, 16)).astype("float32")).to(device)
    return payload, torch.from_numpy(rng.random(E) < 0.05).to(device)


def run_predicate_path(label, stage_case, device) -> dict:
    """``ops.predicate_eval`` on each window of a cell's first cascade stage
    over its first 16 windows (as ``run_window_batch`` stages them), one
    call a window, held against the plain version: bit for bit but for
    events at a mass/ΔR cut's edge (:func:`_mask_edges`)."""
    import torch

    from repro_torch.kernels import ops, ref

    program, _nb, (t, v, w), *_ = stage_case
    B, T, E, K = t.shape
    ops.reset_launch_counts()
    got = torch.stack([ops.predicate_eval(t[b], v[b], w[b], program) for b in range(B)])
    torch.cuda.synchronize()
    launches = ops.launch_counts()["predicate_eval"]
    check(launches == B, f"{label}: {launches} predicate_eval launches for {B} windows")
    want = ref.predicate_eval_batch_ref(t, v, w, program)
    err = float((got - want).abs().max())
    edge = _mask_edges(program, t, v, got, want) if err else 0
    log(f"  [{label}] predicate_eval on each of the first stage's {B} windows (T={T} "
        f"E={E} K={K}): {int(got.sum())} events pass, equal to the plain version but "
        f"for {edge} events at a mass/ΔR cut's edge; launches {launches}")
    return {"launches": launches, "max_abs_err": err}


def run_attention_path(rng, device) -> dict:
    """``ops.flash_attention`` at StarCoder2-7B's head layout, causal, in
    float32 and bf16, held against the plain version (:data:`FLASH_TOL`)."""
    import torch

    from repro_torch.kernels import ops, ref

    launches, cases, errs = 0, [], {}
    for dtype_name in FLASH_TOL:
        q, k, v = attention_inputs(rng, STARCODER2_7B_ATTN, getattr(torch, dtype_name),
                                   device)
        ops.reset_launch_counts()
        out = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        n = ops.launch_counts()["flash_attention"]
        check(n > 0, f"flash_attention {dtype_name} never launched")
        launches += n
        want = ref.flash_attention_ref(q, k, v, causal=True)
        errs[dtype_name] = attention_close(
            out, want, dtype_name, f"flash_attention {STARCODER2_7B_ATTN} {dtype_name}")
        cases.append((q, k, v))
        del out, want
    log(f"  flash_attention {STARCODER2_7B_ATTN} causal (StarCoder2-7B): within "
        f"tolerance of the plain version, max |err| {errs}; launches {launches}")
    return {"launches": launches, "cases": cases, "max_abs_err": max(errs.values())}


# ---------------------------------------------------------------------------
# phase 3d: the serving plane (shared scan, job service, cluster)
# ---------------------------------------------------------------------------


def output_columns(out) -> dict:
    """Every branch of an output store as one array (jagged: its values)."""
    return {name: (out.read_jagged(name)[0] if br.jagged else out.read_flat(name))
            for name, br in out.branches.items()}


def same_output(got, want) -> bool:
    """Every output basket byte equal (the manifest hashes every blob)."""
    return (got.manifest_hash() == want.manifest_hash()
            and got._blobs == want._blobs)


def same_columns(cols: dict, want: dict) -> bool:
    return (sorted(cols) == sorted(want)
            and all(cols[k].dtype == want[k].dtype
                    and cols[k].tobytes() == want[k].tobytes() for k in want))


def count_staging_allocs():
    """Count, until the returned ``restore()``, the buffers the kernels'
    per-thread staging (``ops._Staging``) allocates anew, on any thread,
    how many are page-locked, and the seconds those allocations take.
    Returns (counts, restore)."""
    from repro_torch.kernels import ops

    counts = {"allocs": 0, "pinned": 0, "seconds": 0.0}
    lock, buffer = threading.Lock(), ops._Staging.buffer

    def counting(self, device, name, n, dtype, pinned=False):
        before = self.buffers.get((device, name))
        t0 = time.perf_counter()
        out = buffer(self, device, name, n, dtype, pinned)
        if self.buffers.get((device, name)) is not before:
            with lock:
                counts["allocs"] += 1
                counts["pinned"] += pinned
                counts["seconds"] += time.perf_counter() - t0
        return out

    ops._Staging.buffer = counting

    def restore():
        ops._Staging.buffer = buffer

    return counts, restore


class Launches:
    """The launch counts and the dispatch ledger of one step: set to 0 on
    entry, read on exit (``.launches``, ``.dispatches``)."""

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops

        self._ops = ops
        self._d0 = ops.dispatch_stats()["dispatches"]
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.launches = self._ops.launch_counts()
        self.dispatches = self._ops.dispatch_stats()["dispatches"] - self._d0
        return False


def shared_scan_step(label, store, host_store, tenants, solo, batch=None,
                     per_window=None) -> dict:
    """``SharedScanEngine(store).run_batch(tenants)`` on the card: each
    tenant's survivors and output bytes held against its solo card run
    (phase 3), the shared ledger and each tenant's ledgers against the
    port's host run of the same shared scan; one ``basket_decode`` launch
    per decode round with a bitpack miss and, per window, one
    ``skim_fused`` launch per window skim; with ``batch``, stage steps of
    one page-locked upload each, and outputs equal to the per-window
    shared scan."""
    from repro_torch.serve import SharedScanEngine

    queries = [q for _, q in tenants]
    stats0 = store.decode_backend_stats()
    counts, restore = count_calls(store)
    uploads, restore_uploads = count_uploads()
    try:
        with Launches() as step:
            res = SharedScanEngine(store, device_batch=batch).run_batch(queries)
    finally:
        restore()
        restore_uploads()
    dec = store.decode_backend_stats()
    t0 = time.perf_counter()
    host = SharedScanEngine(host_store, device="cpu",
                            device_batch=batch).run_batch(queries)
    host_s = time.perf_counter() - t0
    launches, name = step.launches, f"shared scan, {label}"
    n_events = store.n_events * len(tenants)
    log(f"  [{name}] {[r.n_passed for r in res.results]} survivors of "
        f"{store.n_events:,} events x {len(tenants)} tenants in "
        f"{step.wall_s:.3f} s wall ({n_events / step.wall_s:,.0f} tenant-events/s); "
        f"amortization {res.amortization:.4f}, saved {res.saved_bytes} B "
        f"(shared {res.shared_stats.bytes_fetched} B, naive "
        f"{res.naive_phase1_bytes} B); launches {launches}; device_dispatches "
        f"{step.dispatches}; decode rounds with a bitpack miss "
        f"{counts['device_rounds']}, window skims {counts['window_skims']}; "
        f"the host run {host_s:.3f} s")
    check(launches["basket_decode"] > 0, f"{name}: basket_decode never launched")
    check(launches["basket_decode"] == counts["device_rounds"],
          f"{name}: {launches['basket_decode']} decode launches for "
          f"{counts['device_rounds']} rounds with a bitpack miss")
    check(launches["skim_fused"] == counts["window_skims"],
          f"{name}: {launches['skim_fused']} skim_fused launches for "
          f"{counts['window_skims']} calls")
    check(dec["fallbacks"] == stats0["fallbacks"],
          f"{name}: {dec['fallbacks'] - stats0['fallbacks']} decode fallbacks")
    if batch:
        check(launches["cascade_stage"] > 0, f"{name}: cascade_stage never launched")
        check(0 < uploads["calls"] <= launches["cascade_stage"]
              and uploads["step_uploads"] == uploads["calls"]
              and uploads["step_pageable"] == 0,
              f"{name}: {uploads['step_uploads']} host-to-device copies "
              f"({uploads['step_pageable']} pageable) in {uploads['calls']} "
              "stage steps: not one page-locked copy a step")
    else:
        check(launches["skim_fused"] > 0, f"{name}: skim_fused never launched")
    check(res.amortization > 1, f"{name}: amortization {res.amortization} <= 1")
    check(fetch_row(res.shared_stats) == fetch_row(host.shared_stats),
          f"{name}: shared_stats differ from the host shared scan")
    for i, ((tenant, _), got, ref_) in enumerate(zip(tenants, res.results, host.results)):
        want = solo[tenant]
        check(got.n_passed == want.n_passed,
              f"{name}: tenant {i} ({tenant}) {got.n_passed} survivors vs "
              f"{want.n_passed} solo")
        check(same_output(got.output, want.output),
              f"{name}: tenant {i} ({tenant}) output differs from its solo card run")
        check(fetch_row(got.stats) == fetch_row(ref_.stats),
              f"{name}: tenant {i} FetchStats differ from the host shared scan")
        for key in ("cascade_stages", "cascade_order"):
            check(got.extras.get(key) == ref_.extras.get(key),
                  f"{name}: tenant {i} {key} differs from the host shared scan")
        if per_window is not None:
            check(same_output(got.output, per_window.results[i].output),
                  f"{name}: tenant {i} output differs from the per-window shared scan")
    log(f"  [{name}] every tenant's survivors and output bytes equal its solo card "
        "run; shared_stats, each tenant's FetchStats and cascade ledgers equal "
        "the host shared scan")
    return {"wall_s": step.wall_s, "tenant_events_per_s": n_events / step.wall_s,
            "amortization": res.amortization, "saved_bytes": res.saved_bytes,
            "launches": launches, "device_dispatches": step.dispatches,
            "host_s": host_s, "res": res}


def service_step(store, tenants, solo) -> dict:
    """The job service on the card: three tenants batched into one shared
    pass, every job DONE with the solo card run's columns; a fourth job
    cancelled after its first window keeps a prefix of the stream; the
    Chrome trace holds the lifecycle and engine spans; a journaled
    service stopped mid-run and recovered streams the same partials as
    one that ran through."""
    from repro_torch.obs import trace_json
    from repro_torch.serve import (
        EngineBackend,
        JobJournal,
        ManualClock,
        SkimService,
        union_columns,
    )

    with Launches() as step:
        svc = SkimService(EngineBackend(store), clock=ManualClock(), batching=True,
                          tracing=True, calibrate=True)
        jobs = [svc.submit(q, tenant=f"t{i}") for i, (_, q) in enumerate(tenants)]
        svc.run_until_idle()
    quanta = svc.executor.quanta
    for i, ((tenant, _), job) in enumerate(zip(tenants, jobs)):
        check(job.state == "DONE", f"service: job {job.job_id} ended {job.state}")
        cols, _ = union_columns(job)
        check(same_columns(cols, solo[tenant + "_cols"]),
              f"service: job {job.job_id} ({tenant}) columns differ from its solo "
              "card run")
        check(same_output(job.result.output, solo[tenant].output),
              f"service: job {job.job_id} ({tenant}) output differs from its solo "
              "card run")

    # cancelled after its first streamed window: a prefix of the stream
    first = jobs[0]
    late = svc.submit(tenants[0][1], tenant="late")
    stream = svc.stream(late.job_id)
    next(stream)
    svc.cancel(late.job_id)
    rest = list(stream)
    check(late.state == "CANCELLED" and not rest and len(late.partials) == 1,
          f"service: the cancelled job ended {late.state} with "
          f"{len(late.partials)} partials")
    for got, want in zip(late.partials, first.partials):
        check((got.start, got.stop, got.n_passed) == (want.start, want.stop,
                                                     want.n_passed)
              and same_columns(got.cols, want.cols),
              "service: the cancelled job's partials are not a prefix of the "
              "solo run's windows")

    doc = json.loads(trace_json(svc.export_trace()))
    kinds = {e.get("cat") for e in doc["traceEvents"]}
    need = {"job", "admission", "queue", "query", "window", "fetch"}
    check(need <= kinds, f"service: the trace lacks span kinds {sorted(need - kinds)}")
    # a decode span names its tier: "decode_device" where the card decodes
    check("decode_device" in kinds,
          f"service: the trace holds no card decode span: {sorted(kinds - {None})}")

    # stop a journaled service after two windows, recover it, compare
    query = tenants[1][1]
    ref_svc = SkimService(EngineBackend(store), clock=ManualClock(),
                          journal=JobJournal())
    ref_job = ref_svc.result(ref_svc.submit(query, tenant="r").job_id)
    journal = JobJournal()
    crashed = SkimService(EngineBackend(store), clock=ManualClock(), journal=journal)
    job = crashed.submit(query, tenant="r")
    while len(job.partials) < 2:
        check(crashed.step(), "service: stalled before the crash point")
    recovered = SkimService.recover(journal, EngineBackend(store), clock=ManualClock())
    done = recovered.result(job.job_id)
    check(done.state == "DONE" and done.resume_skip == 2,
          f"service: the recovered job ended {done.state}, skip {done.resume_skip}")
    check(done.windows_streamed() == ref_job.windows_streamed()[2:]
          and all(a.n_passed == b.n_passed and same_columns(a.cols, b.cols)
                  for a, b in zip(done.partials, ref_job.partials[2:]))
          and same_output(done.result.output, ref_job.result.output),
          "service: the recovered stream differs from the uninterrupted one")
    log(f"  [service] {len(jobs)} batched jobs DONE in {step.wall_s:.3f} s wall "
        f"({store.n_events * len(jobs) / step.wall_s:,.0f} tenant-events/s), "
        f"{quanta} quanta; launches {step.launches}; device_dispatches "
        f"{step.dispatches}; columns equal the solo card runs; the cancelled job "
        f"kept {len(late.partials)} partial (a prefix); the trace holds "
        f"{sorted(kinds - {None})}; the recovered job streamed "
        f"{len(done.partials)} partials equal to the uninterrupted run's suffix")
    return {"wall_s": step.wall_s, "quanta": quanta, "launches": step.launches,
            "device_dispatches": step.dispatches,
            "tenant_events_per_s": store.n_events * len(jobs) / step.wall_s}


def cluster_step(store, tenants, solo, batch=None, shards=None) -> dict:
    """A 4-node cluster with replicas on the card: ``build_cluster(store,
    4, replication=True, concurrency="threads")`` (or, with ``batch``,
    nodes over the same ``shards`` that batch ``batch`` windows a cascade
    stage); the merged output of each query equal to its solo card run,
    from pool threads and serially (a serial coordinator over the same
    nodes), then with node 1 failed (the replica serves, the retry
    ledgered), then one job through ``SkimService(ClusterBackend(...))``.
    The build's launches (re-basketing the shards reads every basket) are
    counted apart from the runs'."""
    from repro_torch.cluster import ClusterCoordinator, StorageNode, build_cluster
    from repro_torch.serve import ClusterBackend, ManualClock, SkimService

    name = "cluster" + (f", device_batch={batch}" if batch else "")
    queries = dict(tenants)
    with Launches() as build:
        if shards is None:
            coord = build_cluster(store, 4, replication=True, concurrency="threads")
        else:
            n = len(shards)
            coord = ClusterCoordinator(
                [StorageNode(sh, device_batch=batch) for sh in shards],
                replicas={sh.shard_id: StorageNode(sh, node_id=n + sh.shard_id,
                                                   device_batch=batch)
                          for sh in shards},
                concurrency="threads", basket_events=store.basket_events,
                codec=store.codec)
    serial = ClusterCoordinator(coord.nodes, replicas=coord.replicas,
                                concurrency="serial",
                                basket_events=store.basket_events, codec=store.codec)
    walls, allocs = {}, {}
    with Launches() as step:
        for conc, c in (("serial", serial), ("threads", coord)):
            allocs[conc], restore = count_staging_allocs()
            t0 = time.perf_counter()
            try:
                for tenant, q in queries.items():
                    res = c.run(q)
                    check(res.n_passed == solo[tenant].n_passed
                          and same_output(res.output, solo[tenant].output),
                          f"{name} ({conc}): {tenant} output differs from its "
                          "solo card run")
            finally:
                restore()
            walls[conc] = time.perf_counter() - t0
        coord.nodes[1].inject_fault("fail")
        failed = coord.run(queries["quickstart"])
        check(same_output(failed.output, solo["quickstart"].output),
              f"{name}: output with node 1 failed differs from the solo card run")
        check(failed.retries and failed.retries[0][0] == 1
              and failed.extras["retry_attempts"] >= 1,
              f"{name}: the replica retry is not ledgered: {failed.retries}, "
              f"{failed.extras.get('retry_attempts')}")
        svc = SkimService(ClusterBackend(coord), clock=ManualClock())
        job = svc.submit(queries["zee"], tenant="c")
        svc.run_until_idle()
        check(job.state == "DONE" and same_output(job.result.output,
                                                  solo["zee"].output),
              f"{name}: the service job over the cluster ended {job.state}")
    launches = step.launches
    # batched nodes run every stage of an all-cascade query as cascade_stage
    kernels = ("basket_decode", "cascade_stage") if batch else (
        "basket_decode", "skim_fused")
    for kernel in kernels:
        check(launches[kernel] > 0, f"{name}: {kernel} never launched")
    log(f"  [{name}] built in {build.wall_s:.3f} s (launches {build.launches}); "
        f"4 nodes + 4 replicas: both queries equal their solo card runs, from "
        f"pool threads in {walls['threads']:.3f} s and serially in "
        f"{walls['serial']:.3f} s wall (staging buffers allocated: threads "
        f"{allocs['threads']}, serial {allocs['serial']}); node 1 failed: retries "
        f"{failed.retries}, "
        f"retry_attempts {failed.extras['retry_attempts']}, output equal; a service "
        f"job over the cluster DONE; launches {launches}; device_dispatches "
        f"{step.dispatches} (threads add to one process-wide ledger)")
    total = {k: launches[k] + build.launches[k] for k in launches}
    return {"serial_s": walls["serial"], "threads_s": walls["threads"],
            "build_s": build.wall_s, "wall_s": step.wall_s, "launches": total,
            "staging_allocs": allocs,
            "build_launches": build.launches, "device_dispatches": step.dispatches,
            "shards": [node.shard for node in coord.nodes]}


def run_serving_plane(store, host_store, results) -> dict:
    """Phase 3d at full size on the NanoAOD-like store: tenants quickstart,
    Z->ee and quickstart again, each held against its solo card run of
    phase 3 (itself held there against the staged reference)."""
    tenants = [("quickstart", QUICKSTART_QUERY), ("zee", zee_query(store.n_events)),
               ("quickstart", QUICKSTART_QUERY)]
    solo = {}
    for label in ("quickstart", "zee"):
        solo[label] = results[label]["res"]
        solo[label + "_cols"] = output_columns(solo[label].output)
    out = {"shared": shared_scan_step("per window", store, host_store, tenants, solo)}
    out["shared_batched"] = shared_scan_step(
        "device_batch=16", store, host_store, tenants, solo, batch=16,
        per_window=out["shared"]["res"])
    out["service"] = service_step(store, tenants, solo)
    out["cluster"] = cluster_step(store, tenants, solo)
    out["cluster_batched"] = cluster_step(store, tenants, solo, batch=16,
                                          shards=out["cluster"]["shards"])
    return out


# ---------------------------------------------------------------------------
# phase 3e: the mesh skim (sharded_skim over torch.distributed)
# ---------------------------------------------------------------------------

MESH_NAMES = ("pod", "data", "model")
MESH_RANKS = (2, 2, 1)  # four ranks on the one card, over gloo
MESH_ARRAYS = ("terms", "valid", "weights", "payload")
MESH_RANK_TIMEOUT_S = 300


def mesh_inputs(query, host_store):
    """The whole store's padded inputs for ``query``'s filter branches (host
    numpy), at the K that truncates no object (``window_pad_K``), the
    payload the event index and ``MET_pt``."""
    from repro_torch.core import parse_query
    from repro_torch.core.neardata import build_padded_inputs, compile_query, window_pad_K

    q = parse_query(query)
    program = compile_query(q)
    data = {}
    for b in sorted(set(q.filter_branches())):
        br = host_store.branches.get(b)
        if br is None:
            continue  # an absent trigger branch: the zero page
        if br.jagged:
            data[b], data[br.counts_branch] = host_store.read_jagged(b)
        else:
            data[b] = host_store.read_flat(b)
    K = window_pad_K(data, program, host_store)
    pb = build_padded_inputs(data, program, host_store, K=K, include_index=True,
                             payload_branches=["MET_pt"], to_device=False)
    return program, pb


def mesh_shard(mesh, names, axes=("pod", "data")) -> tuple[int, int]:
    """(this rank's shard, the number of shards): row-major over the data
    axes of the mesh, the first outermost (``sharded_skim``'s layout)."""
    shard, n = 0, 1
    for d, a in enumerate(names):
        if a in axes:
            shard = shard * mesh.size(d) + mesh.get_local_rank(d)
            n *= mesh.size(d)
    return shard, n


def run_mesh_world1(cases, results, device, tmp) -> dict:
    """Phase 3e (a): ``sharded_skim`` at world size 1, mesh (1, 1, 1), NCCL
    (gloo for a CPU rehearsal), the group started from a ``HashStore``: no
    port is opened.  Per query: the total equals phase 3's survivors, the
    mask and the packed rows equal the plain versions on the same tensors
    bit for bit, one ``predicate_eval`` and one ``stream_compact`` launch a
    call; then the step's host-to-host time, each kernel's device time at
    the shard's shapes beside its bound, and the all_reduce's time.  Saves
    each query's arrays and mask to ``tmp`` for (b)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.neardata import sharded_skim
    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_compact as sc

    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    out = {}
    try:
        mesh = init_device_mesh(device.type, (1, 1, 1), mesh_dim_names=MESH_NAMES)
        for label, program, pb in cases:
            arrays = [getattr(pb, name) for name in MESH_ARRAYS]
            (T, E, K), G, D = pb.terms.shape, pb.valid.shape[0], pb.payload.shape[1]
            fn = sharded_skim(mesh, program)
            with Launches() as step:
                packed, mask, total = fn(*arrays)
            n = int(total)
            launches = {k: v for k, v in step.launches.items() if v}
            check(n == results[label]["n_passed"],
                  f"mesh skim [{label}]: total {n}, phase 3 passed "
                  f"{results[label]['n_passed']}")
            check(launches == {"predicate_eval": 1, "stream_compact": 1},
                  f"mesh skim [{label}]: launches {launches}, not one predicate_eval "
                  "and one stream_compact")
            t, v, w, p = (torch.from_numpy(x).to(device) for x in arrays)
            want = ref.predicate_eval_ref(t, v, w, program)
            want_packed, want_n = ref.stream_compact_ref(p, want)
            mask_err = float((mask - want.to(torch.int32)).abs().max())
            check(mask_err == 0 and mask.dtype == torch.int32,
                  f"mesh skim [{label}]: the mask differs from predicate_eval_ref")
            check(int(want_n) == n and torch.equal(packed.view(torch.int32),
                                                   want_packed.view(torch.int32)),
                  f"mesh skim [{label}]: packed rows differ from stream_compact_ref")
            check(packed[:n, 0].to(torch.int64).equal(torch.nonzero(want).squeeze(1)),
                  f"mesh skim [{label}]: the packed event indices are not the survivors")
            (tmp / label).mkdir()
            for name, x in zip(MESH_ARRAYS, arrays):
                np.save(tmp / label / f"{name}.npy", x)
            np.save(tmp / label / "mask.npy", mask.cpu().numpy())

            def call():
                return int(fn(*arrays)[2])

            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                call()
                walls.append((time.perf_counter() - t0) * 1e3)
            fn_ms = sorted(walls)[len(walls) // 2]
            keep = mask != 0
            n_read = bin(pe.planes_read(program) & ((1 << (T + 2 * G)) - 1)).count("1")
            pe_bound = bound_times(4 * (n_read * E * K + E), E * K * (T + 4 * G))
            row_bytes = 4 * D
            sc_bound = bound_times(E * keep.element_size() + n * row_bytes
                                   + E * row_bytes + 4, E)
            count = torch.zeros((), dtype=torch.int32, device=device)
            group = mesh.get_group(MESH_NAMES.index("data"))

            def reduce():
                dist.all_reduce(count, group=group)
                torch.cuda.synchronize()

            row = {
                "T": T, "G": G, "E": E, "K": K, "D": D, "total": n,
                "launches": launches, "mask_err": mask_err,
                "fn_ms": fn_ms, "fn_walls_ms": walls,
                "predicate_eval_ms": device_ms(lambda: pe.predicate_eval(t, v, w, program)),
                "predicate_eval_bound_ms": max(pe_bound),
                "stream_compact_ms": device_ms(lambda: sc.stream_compact(p, keep)),
                "stream_compact_bound_ms": max(sc_bound),
                "all_reduce_ms": host_ms(reduce, calls=50),
            }
            out[label] = row
            log(f"  [{label}] (a) world size 1, mesh (1, 1, 1) {MESH_NAMES}, "
                f"{dist.get_backend()}: T={T} G={G} E={E} K={K} D={D}; total {n} "
                f"(phase 3: {results[label]['n_passed']}); mask and packed rows equal "
                f"predicate_eval_ref and stream_compact_ref on the same tensors bit "
                f"for bit; launches {launches}")
            log(f"  [{label}] (a) fn host to host {fn_ms:.3f} ms (median of 5: numpy "
                f"in, the shard uploaded, the total read back; {[round(x, 3) for x in walls]}); "
                f"predicate_eval {row['predicate_eval_ms']:.5f} ms on the device (bound "
                f"{row['predicate_eval_bound_ms']:.5f}: {n_read} planes read); "
                f"stream_compact {row['stream_compact_ms']:.5f} ms (bound "
                f"{row['stream_compact_bound_ms']:.5f}); all_reduce of the count "
                f"{row['all_reduce_ms']:.5f} ms host to host")
            del t, v, w, p, want, want_packed, packed, mask, keep
    finally:
        dist.destroy_process_group()
    return out


def mesh_rank(rank, n, tmp, cases, device_type, shape) -> None:
    """One rank of phase 3e (b), spawned: the group over gloo from a
    ``FileStore`` in ``tmp``, ``sharded_skim`` over ``shape`` on each
    query's arrays mapped from (a)'s files (only this rank's block is
    read).  Writes ``rank<r>.json``: its launches, whether its block equals
    the plain compaction of its slice of (a)'s mask, its total."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import parse_query
    from repro_torch.core.neardata import compile_query, sharded_skim
    from repro_torch.kernels import ops, ref

    tmp = Path(tmp)
    on_card = device_type == "cuda"
    if on_card:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "rendezvous"), n),
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=MESH_RANK_TIMEOUT_S))
    try:
        mesh = init_device_mesh(device_type, shape, mesh_dim_names=MESH_NAMES)
        shard, n_shards = mesh_shard(mesh, MESH_NAMES)
        device = torch.device("cuda", 0) if on_card else torch.device("cpu")
        report = {"rank": rank, "shard": shard, "n_shards": n_shards}
        for label, query in cases:
            program = compile_query(parse_query(query))
            arrays = [np.load(tmp / label / f"{name}.npy", mmap_mode="r")
                      for name in MESH_ARRAYS]
            fn = sharded_skim(mesh, program)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            packed, mask, total = fn(*arrays)
            if on_card:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            size = arrays[3].shape[0] // n_shards
            rows = slice(shard * size, (shard + 1) * size)
            want_mask = torch.from_numpy(
                np.load(tmp / label / "mask.npy", mmap_mode="r")[rows].copy()).to(device)
            payload = torch.from_numpy(np.array(arrays[3][rows])).to(device)
            want, want_n = ref.stream_compact_ref(payload, want_mask)
            report[label] = {
                "launches": launches, "total": int(total), "wall_ms": wall_ms,
                "rows": [rows.start, rows.stop], "kept": int(want_n),
                "mask_equal": bool(torch.equal(mask, want_mask)),
                "packed_equal": bool(torch.equal(packed.view(torch.int32),
                                                 want.view(torch.int32))),
            }
        (tmp / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def run_mesh_ranks(cases, world1, device, tmp) -> dict:
    """Phase 3e (b): four ranks on one card over gloo (NCCL refuses two
    ranks on one GPU), mesh (2, 2, 1), spawned with ``torch.multiprocessing``
    and met through a ``FileStore``; each rank's block must equal the plain
    compaction of its slice of (a)'s mask, its total (a)'s, with one launch
    of each kernel a call.  A rank that fails, or does not end within
    :data:`MESH_RANK_TIMEOUT_S`, fails the phase; every rank is stopped."""
    import torch.multiprocessing as mp

    n = MESH_RANKS[0] * MESH_RANKS[1] * MESH_RANKS[2]
    ctx = mp.start_processes(
        mesh_rank, args=(n, str(tmp), [(label, query) for label, query in cases],
                         device.type, MESH_RANKS),
        nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_RANK_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"mesh skim (b): the ranks did not end within {MESH_RANK_TIMEOUT_S} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
        raise SmokeFailure(f"mesh skim (b): a rank failed: {exc}") from exc
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(10)
    reports = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(n)]
    shards = sorted(r["shard"] for r in reports)
    check(shards == list(range(4)) and all(r["n_shards"] == 4 for r in reports),
          f"mesh skim (b): shards {shards}")
    launches = dict.fromkeys(("predicate_eval", "stream_compact"), 0)
    for label, _ in cases:
        for r in reports:
            got = r[label]
            check(got["launches"] == {"predicate_eval": 1, "stream_compact": 1},
                  f"mesh skim (b) [{label}] rank {r['rank']}: launches {got['launches']}")
            check(got["mask_equal"] and got["packed_equal"],
                  f"mesh skim (b) [{label}] rank {r['rank']}: its block differs from "
                  "the plain compaction of its slice of (a)'s mask")
            check(got["total"] == world1[label]["total"],
                  f"mesh skim (b) [{label}] rank {r['rank']}: total {got['total']}, "
                  f"(a) {world1[label]['total']}")
            for k in launches:
                launches[k] += got["launches"].get(k, 0)
        kept = {r["shard"]: r[label]["kept"] for r in reports}
        check(sum(kept.values()) == world1[label]["total"],
              f"mesh skim (b) [{label}]: the shards keep {kept}")
        log(f"  [{label}] (b) 4 ranks on one card over gloo, mesh {MESH_RANKS}: every "
            f"rank's total {world1[label]['total']} equals (a)'s; each block equals the "
            f"plain compaction of its slice of (a)'s mask bit for bit; kept per shard "
            f"{[kept[s] for s in sorted(kept)]}; one launch of each kernel a rank; "
            f"first-call walls {[round(r[label]['wall_ms'], 1) for r in reports]} ms")
    return {"launches": launches, "reports": reports}


def run_mesh_skim(host_store, results, device) -> dict:
    """Phase 3e: the mesh skim on the whole NanoAOD-like store, for the
    quickstart and Z->ee queries: (a) at world size 1, then (b) four ranks."""
    import tempfile

    queries = [("quickstart", QUICKSTART_QUERY), ("zee", zee_query(host_store.n_events))]
    with tempfile.TemporaryDirectory(prefix="mesh_skim_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        cases = [(label, *mesh_inputs(query, host_store)) for label, query in queries]
        log(f"  the store read and padded for both queries in "
            f"{time.perf_counter() - t0:.1f} s")
        world1 = run_mesh_world1(cases, results, device, tmp)
        del cases
        ranks = run_mesh_ranks(queries, world1, device, tmp)
    launches = {k: len(world1) + v for k, v in ranks["launches"].items()}
    return {"world1": world1, "ranks": ranks["reports"], "launches": launches,
            "max_abs_err": max(r["mask_err"] for r in world1.values())}


# ---------------------------------------------------------------------------
# phase 3f: the five examples, on the card and on the host
# ---------------------------------------------------------------------------


def run_example(name: str, device: str) -> dict:
    """``repro_torch.examples.<name>.main(["--device", device])`` in this
    process at its default size: its stdout, wall time and launches
    (counted from 0), each ``SkimEngine.run`` it made (mode, input link,
    the unrounded ``Breakdown``, ``busy_fraction``) and the
    ``basket_decode`` launches of each ``build_cluster`` call.  The module's
    ``SkimEngine`` and ``build_cluster`` are wrapped for the run only, and
    the wrappers return what the real ones return."""
    import contextlib
    import importlib
    import io

    from repro_torch.kernels import ops

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    runs, builds, wrapped = [], [], {}
    if hasattr(mod, "SkimEngine"):
        class RecordingEngine(mod.SkimEngine):
            def run(self, query, mode="near_data", **kw):
                res = super().run(query, mode, **kw)
                runs.append({"mode": mode, "gbps": self.input_link.bandwidth_gbps,
                             "breakdown": res.breakdown.as_dict(),
                             "busy_fraction": res.busy_fraction})
                return res

        wrapped["SkimEngine"] = RecordingEngine
    if hasattr(mod, "build_cluster"):
        build = mod.build_cluster

        def counted_build(*args, **kw):
            before = ops.launch_counts()["basket_decode"]
            coord = build(*args, **kw)
            builds.append(ops.launch_counts()["basket_decode"] - before)
            return coord

        wrapped["build_cluster"] = counted_build
    saved = {k: getattr(mod, k) for k in wrapped}
    buf = io.StringIO()
    try:
        for k, v in wrapped.items():
            setattr(mod, k, v)
        with Launches() as step, contextlib.redirect_stdout(buf):
            mod.main(["--device", device])
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)
    return {"text": buf.getvalue(), "wall_s": step.wall_s, "launches": step.launches,
            "runs": runs, "builds": builds}


def example_pair(name: str) -> dict:
    """One example on the card, then on the host: every line but the device
    line equal once the wall-clock values (``examples.CLOCK_FIELDS``) are
    masked, ``basket_decode`` and ``skim_fused`` launched on the card, and
    nothing launched by the host run."""
    from repro_torch.examples import mask_clock

    card = run_example(name, "cuda")
    host = run_example(name, "cpu")
    lines, masked = mask_clock(name, card["text"])
    host_lines, host_masked = mask_clock(name, host["text"])
    check(lines[0].startswith("device: cuda") and host_lines[0] == "device: cpu",
          f"example {name}: device lines {lines[0]!r} / {host_lines[0]!r}")
    diff = [(a, b) for a, b in zip(lines[1:], host_lines[1:]) if a != b]
    check(len(lines) == len(host_lines) and not diff,
          f"example {name}: {len(diff)} lines differ between the card and the host "
          f"({len(lines)} / {len(host_lines)} lines), first {diff[:2]}")
    check(masked == host_masked, f"example {name}: masked {masked} / {host_masked}")
    for kernel in ("basket_decode", "skim_fused"):
        check(card["launches"][kernel] > 0,
              f"example {name}: no {kernel} launch on the card")
    check(not any(host["launches"].values()),
          f"example {name}: the host run launched {host['launches']}")
    return {"card": card, "host": host, "lines": len(lines) - 1, "masked": sorted(masked),
            "launches": card["launches"]}


PLACEMENTS = ("client_plain", "client_opt", "server_side", "near_data")  # skim_service.MODES
PLACEMENT_GBPS = (1, 10, 100)


def placement_table(pair) -> dict:
    """The paper's four placements from ``skim_service``'s table: per mode
    and link, the ``Breakdown`` total (measured stages + the modeled link)
    and ``busy_fraction``, on the card and on the host, unrounded."""
    table = {}
    for side in ("card", "host"):
        runs = pair[side]["runs"]
        check(len(runs) == len(PLACEMENTS) * len(PLACEMENT_GBPS) + 1,
              f"skim_service made {len(runs)} SkimEngine runs")
        for run, (mode, gbps) in zip(runs, [(m, g) for m in PLACEMENTS
                                            for g in PLACEMENT_GBPS]):
            check((run["mode"], run["gbps"]) == (mode, float(gbps)),
                  f"skim_service ran {run['mode']} at {run['gbps']} Gb/s in {mode}'s place")
            table.setdefault(mode, {}).setdefault(side, {})[f"{gbps} Gb/s"] = {
                "total_s": run["breakdown"]["total"],
                "busy_fraction": run["busy_fraction"], "breakdown": run["breakdown"]}
        table.setdefault("near_data breakdown", {})[side] = runs[-1]["breakdown"]
    for mode in PLACEMENTS:
        log(f"  placement [{mode}] Breakdown.total() s at 1 / 10 / 100 Gb/s (links "
            "modeled): card " + " / ".join(
                str(table[mode]["card"][f"{g} Gb/s"]["total_s"]) for g in PLACEMENT_GBPS)
            + ", host " + " / ".join(
                str(table[mode]["host"][f"{g} Gb/s"]["total_s"]) for g in PLACEMENT_GBPS)
            + "; busy_fraction card " + " / ".join(
                str(table[mode]["card"][f"{g} Gb/s"]["busy_fraction"])
                for g in PLACEMENT_GBPS)
            + ", host " + " / ".join(
                str(table[mode]["host"][f"{g} Gb/s"]["busy_fraction"])
                for g in PLACEMENT_GBPS))
    return table


def run_examples() -> tuple[dict, dict]:
    """Phase 3f: each of the five examples at its default size, on the card
    and on the host (:func:`example_pair`), then the placement table."""
    from repro_torch.examples import EXAMPLES

    out = {}
    for name in EXAMPLES:
        pair = example_pair(name)
        log(f"  [{name}] card {pair['card']['wall_s']:.3f} s, host "
            f"{pair['host']['wall_s']:.3f} s; {pair['lines']} lines equal, masked "
            f"{pair['masked']}; launches on the card "
            + json.dumps({k: v for k, v in pair["launches"].items() if v}, sort_keys=True)
            + (f", of them basket_decode in build_cluster {pair['card']['builds']}"
               if pair["card"]["builds"] else ""))
        out[name] = pair
    return out, placement_table(out["skim_service"])


def device_busy(label, query, store, **kw) -> None:
    """One more run of the main path under ``torch.profiler``: the device
    time of every kernel over the run's wall time, and the kernels that
    took the most.  The profiler's own cost lengthens the wall time, so
    the share is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import run_skim

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_skim(store, query, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}  # device-side events only (kernels and copies): the
    # host ops that launched them carry the same time again
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            by_name[ev.key] = (us, ev.count)
    device_s = sum(us for us, _ in by_name.values()) / 1e6
    if device_s == 0:
        log(f"  [{label}] device busy share: not measured (the profiler saw no "
            "device time)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    log(f"  [{label}] profiled run: wall {wall:.4f} s, device busy {device_s:.6f} s "
        f"= {device_s / wall:.4%} of the wall; by kernel (us, count): "
        + json.dumps({k[:60]: [round(us, 1), n] for k, (us, n) in top}))


# ---------------------------------------------------------------------------


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SmokeFailure("src/repro_torch is not beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no card")
    device = torch.device("cuda")
    # the plain attention's products in full float32 (PyTorch's default,
    # stated): TF32 would miss the 3e-5 tolerance
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    log("== 1. device ==")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    parent_build = start_parent_build()
    build_s = _build.build_all()
    ops.load_kernels()
    parent = finish_parent_build(*parent_build)
    log(f"  kernels built in {build_s:.1f} s into {_build.build_dir()}; with the "
        f"earlier designs (the timing baselines) {time.perf_counter() - t0:.1f} s")
    check_tensor_core_sass()

    log("== 2. kernels against their plain versions ==")
    rng = np.random.default_rng(0)
    decode_err = check_basket_decode(rng, device)
    skim_err, _ = check_skim_fused(rng, device)
    stage_err = max(check_cascade_stage(rng, device)[0],
                    check_cascade_stage_windows(rng, device)[0])
    pred_err, _ = check_predicate_eval(rng, device)
    compact_err = check_stream_compact(rng, device)
    batch_err, _ = check_skim_fused_batch(rng, device)
    flash_err = check_flash_attention(rng, device)

    log(f"== building the {N_EVENTS:,}-event stores ==")
    from repro_torch.data.synth import make_nanoaod_like

    t0 = time.perf_counter()
    store = make_nanoaod_like(N_EVENTS, n_hlt=64, n_filler=8, seed=0)
    host_store = make_nanoaod_like(N_EVENTS, n_hlt=64, n_filler=8, seed=0,
                                   device="cpu")
    log(f"  NanoAOD-like: {len(store.branch_names())} branches, "
        f"{store.compressed_bytes() / 1e6:.1f} MB compressed, built twice "
        f"(card store, host store) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    era_store = make_era_store(N_EVENTS)
    era_host = make_era_store(N_EVENTS, device="cpu")
    log(f"  conditions-era: {len(era_store.branch_names())} branches, "
        f"{era_store.compressed_bytes() / 1e6:.1f} MB compressed, built twice "
        f"in {time.perf_counter() - t0:.1f} s")
    cells = [("quickstart", QUICKSTART_QUERY, store, host_store),
             ("zee", zee_query(N_EVENTS), store, host_store),
             ("era", ERA_QUERY, era_store, era_host)]

    log("== 2b. timing at the main path's shapes (window 0; the batch of the "
        "first 16 windows) ==")
    stage_cases = {label: path_stage_cases(st, [q], device)
                   for label, q, st, _ in cells}
    timing = time_kernels(
        path_skim_cases(store, [q for _, q, *_ in cells[:2]], device),
        path_decode_cases(store, [(label, q) for label, q, *_ in cells[:2]], device),
        [c for cases in stage_cases.values() for c in cases],
        pred_cases=[bench_predicate(rng, E, device) for E in PREDICATE_BENCH_E],
        parent=parent,
    )

    log("== 3. main path: run_skim with every default, on the card ==")
    totals = dict.fromkeys(ops.launch_counts(), 0)
    results = {}
    for label, query, st, host in cells:
        results[label] = run_main_path(label, query, st, host)
        for k, v in results[label]["launches"].items():
            totals[k] += v

    log("== 3a. the batched cascade: run_skim(..., device_batch=16) ==")
    batched = {}
    for label, query, st, host in cells:
        batched[label] = run_batched_path(label, query, st, host, results[label])
        for k, v in batched[label]["launches"].items():
            totals[k] += v

    log("== 3b. where the device time goes (torch.profiler) ==")
    for label, query, st, _ in cells[:2]:
        device_busy(label, query, st)
    for label, query, st, _ in cells:
        device_busy(f"{label}, device_batch=16", query, st, device_batch=16)

    log("== 3c. the entry points no skim calls, at full size: "
        "ops.predicate_eval, ops.fused_skim_batch, ops.stream_compact, "
        "ops.flash_attention ==")
    log(f"  launches of the four kernels on the run_skim paths above: "
        f"predicate_eval {totals['predicate_eval']}, skim_fused_batch "
        f"{totals['skim_fused_batch']}, stream_compact {totals['stream_compact']}, "
        f"flash_attention {totals['flash_attention']}")
    predicate = {label: run_predicate_path(label, stage_cases[label][0], device)
                 for label, *_ in cells}
    fused_batch = {label: run_fused_batch_path(label, stage_cases[label][0], device)
                   for label, *_ in cells}
    compact = run_compact_path(store, host_store, results["quickstart"]["n_passed"],
                               device)
    attention = run_attention_path(rng, device)
    log("== 3c. timing of the three at their paths' shapes (stream_compact also "
        "at bench_kernels' shapes) ==")
    timing.update(time_kernels(
        batch_cases=[r["case"] for r in fused_batch.values()],
        compact_cases=[compact["case"]] + [
            (f"bench E={E}", *bench_compact(rng, E, device)) for E in PREDICATE_BENCH_E],
        attn_cases=attention["cases"],
        parent=parent,
    ))

    log("== 3d. the serving plane: shared scan, job service, cluster, on the "
        f"{N_EVENTS:,}-event NanoAOD-like store ==")
    t0 = time.perf_counter()
    serving = run_serving_plane(store, host_store, results)
    serving_s = time.perf_counter() - t0
    for step in serving.values():
        for k, v in step["launches"].items():
            totals[k] += v
    log(f"  phase 3d took {serving_s:.1f} s ({card})")

    log("== 3e. the mesh skim: sharded_skim on the whole NanoAOD-like store, "
        "predicate_eval and stream_compact per shard, the count summed over the "
        "mesh ==")
    t0 = time.perf_counter()
    mesh = run_mesh_skim(host_store, results, device)
    mesh_s = time.perf_counter() - t0
    log(f"  phase 3e took {mesh_s:.1f} s ({card})")

    log("== 3f. the five examples (repro_torch.examples), each on the card and "
        "on the host ==")
    t0 = time.perf_counter()
    examples, placements = run_examples()
    examples_s = time.perf_counter() - t0
    for pair in examples.values():
        for k, v in pair["launches"].items():
            totals[k] += v
    log(f"  phase 3f took {examples_s:.1f} s ({card})")

    kernels = [
        {"name": "skim_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/skim_fused.cu",
         "replaces": "src/repro/kernels/skim_fused.py:151",
         "launches": totals["skim_fused"], "max_abs_err": skim_err,
         **bounds(timing["skim_fused"])},
        {"name": "basket_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/basket_decode.cu",
         "replaces": "src/repro/kernels/basket_decode.py:135",
         "launches": totals["basket_decode"], "max_abs_err": decode_err,
         **bounds(timing["basket_decode"])},
        {"name": "predicate_eval_batch", "route": "cuda",
         "source": "src/repro_torch/csrc/predicate_eval.cu",
         "replaces": "src/repro/kernels/predicate_eval.py:270",
         "launches": totals["cascade_stage"] + totals["predicate_eval_batch"],
         "max_abs_err": max(stage_err, pred_err),
         **bounds(timing["predicate_eval_batch"])},
        # the four below have no caller in run_skim: their launches are
        # those of their own paths, the ops entry points of phase 3c and,
        # for predicate_eval and stream_compact, the mesh skim of phase 3e
        {"name": "predicate_eval", "route": "cuda",
         "source": "src/repro_torch/csrc/predicate_eval.cu",
         "replaces": "src/repro/kernels/predicate_eval.py:304",
         "launches": sum(r["launches"] for r in predicate.values())
         + mesh["launches"]["predicate_eval"],
         "max_abs_err": max([pred_err, mesh["max_abs_err"]]
                            + [r["max_abs_err"] for r in predicate.values()]),
         **bounds(timing["predicate_eval"])},
        {"name": "skim_fused_batch", "route": "cuda",
         "source": "src/repro_torch/csrc/skim_fused.cu",
         "replaces": "src/repro/kernels/skim_fused.py:119",
         "launches": sum(r["launches"] for r in fused_batch.values()),
         "max_abs_err": max([batch_err] + [r["max_abs_err"] for r in fused_batch.values()]),
         **bounds(timing["skim_fused_batch"])},
        {"name": "stream_compact", "route": "cuda",
         "source": "src/repro_torch/csrc/stream_compact.cu",
         "replaces": "src/repro/kernels/stream_compact.py:58",
         "launches": compact["launches"] + mesh["launches"]["stream_compact"],
         "max_abs_err": compact_err,
         **bounds(timing["stream_compact"])},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:93",
         "launches": attention["launches"],
         "max_abs_err": max(flash_err, attention["max_abs_err"]),
         **bounds(timing["flash_attention"])},
    ]
    log("kernel means over the path's shapes (ms; stream_ms is per call from "
        "the host): " + json.dumps(timing))
    log(f"== done in {time.perf_counter() - t_start:.1f} s ==")
    log("main path: " + json.dumps(
        {k: {"wall_s": r["wall_s"], "events_per_s": r["events_per_s"],
             "n_passed": r["n_passed"]} for k, r in results.items()}))
    log("batched path (device_batch=16): " + json.dumps(
        {k: {"wall_s": r["wall_s"], "events_per_s": r["events_per_s"],
             "n_passed": r["n_passed"], "device_dispatches": r["device_dispatches"],
             "per_window_dispatches": r["per_window_dispatches"],
             "stage_upload_bytes": r["uploads"]["step_bytes"],
             "upload_bytes": r["uploads"]["bytes"]}
         for k, r in batched.items()}))
    log("serving plane (" + card + "): " + json.dumps(
        {k: {f: v for f, v in r.items() if f not in ("res", "shards")}
         for k, r in serving.items()}))
    log("mesh skim (" + card + "): " + json.dumps(
        {"seconds": mesh_s, "launches": mesh["launches"], **{
            label: {k: r[k] for k in ("total", "fn_ms", "predicate_eval_ms",
                                      "predicate_eval_bound_ms", "stream_compact_ms",
                                      "stream_compact_bound_ms", "all_reduce_ms")}
            for label, r in mesh["world1"].items()}}))
    log("examples (" + card + "): " + json.dumps(
        {"seconds": examples_s, **{
            name: {"card_s": p["card"]["wall_s"], "host_s": p["host"]["wall_s"],
                   "launches": {k: v for k, v in p["launches"].items() if v},
                   "build_cluster_basket_decode": p["card"]["builds"]}
            for name, p in examples.items()}}, sort_keys=True))
    log("placements (" + card + "; links modeled): " + json.dumps(placements, sort_keys=True))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
