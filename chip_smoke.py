#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; the first failure stops the run with a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, then the build of every kernel from ``src/``.
2. Kernels against their plain PyTorch versions, on the card:
   ``basket_decode`` bit for bit, ``skim_fused`` over every op and group
   kind.  Then each kernel's median time beside its plain version's and
   its bound, at the shapes the main path gives it.
3. The main path: ``run_skim`` with every default on a 1,000,000-event
   NanoAOD-like store (98 branches), for the quickstart query and the
   Z->ee mass/ΔR/expression query, each held against the port's own
   host runs of the same store.
4. One JSON line listing each kernel, then the device line last.

It imports ``repro_torch`` only (never JAX or the JAX package), needs one
card, and exits non-zero without a result where there is no card or no
``src/repro_torch`` beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
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


def bound_times(nbytes: float, ops: float) -> tuple[float, float]:
    """(ms to move ``nbytes`` at the card's memory rate, ms to do ``ops``
    32-bit operations at its float32 rate outside the tensor cores)."""
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3


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
    log(f"  basket_decode: {cases} cases bit-identical to the plain version "
        "(kinds 0/1/2, widths 1-32, n in 1/31/4095/4096/4097, outputs "
        "int32/int16/int8/int64, float32/float64, bool; wrap-around, -0.0, "
        f"NaN payloads); max |bits| {max_err}")
    return max_err


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


def check_skim_fused(rng, device) -> tuple[float, int]:
    import numpy as np
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
                    m_got = np.zeros(E, bool)
                    m_got[got[: int(count), 0].long().cpu().numpy()] = True
                    m_want = np.zeros(E, bool)
                    m_want[want[: int(want_count), 0].long().cpu().numpy()] = True
                    diff = np.nonzero(m_got != m_want)[0]
                    check(len(diff) > 0 and edge_events(program, t, v, diff),
                          f"skim_fused {name} E={E} K={K} D={D}: kernel and "
                          f"plain version disagree ({int(count)} vs "
                          f"{int(want_count)} survivors)")
                    edge += len(diff)
                    log(f"  skim_fused {name} E={E} K={K} D={D}: {len(diff)} "
                        "events differ within 2 ulp of a mass/ΔR cut: "
                        f"{diff[:8].tolist()}")
    log(f"  skim_fused: {cases} cases (all 8 ops, COUNT/HT/ANY/MASS/ΔR/EXPR, "
        f"E in 512/4096/4608, K in 1/4/16, D in 1/5, empty and full masks); "
        f"packed and count equal to the plain version except {edge} events "
        "at a mass/ΔR cut's edge")
    return max_err, edge


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
            cases.append((stage.program,
                          [torch.from_numpy(a).to(device) for a in pad_window(pb)]))
    return cases


def path_decode_cases(store, names, device):
    """One basket per branch (a window is one basket on the main path),
    staged by ``ops.stage_planes`` and decoded to the branch's own dtype,
    as ``ops.basket_decode_batch`` does."""
    import numpy as np
    import torch

    from repro_torch.data.codecs import bitpack_raw_parts
    from repro_torch.kernels import ops

    cases = []
    for name in names:
        part = bitpack_raw_parts(store._blobs[name][0])
        if part["kind"] == 3:
            continue  # raw literals never reach the card
        planes, firsts, bits = ops.stage_planes([part])
        dtype = ops.torch_dtype(store.branches[name].np_dtype())
        cases.append((name, part["kind"], bits, dtype,
                      torch.from_numpy(planes.view(np.int32)).to(device),
                      torch.from_numpy(firsts.view(np.int32)).to(device)))
    return cases


def _summary(rows) -> dict:
    """Mean over the path's cases of each time and of the bound; the bound
    is by bytes or by operations as the larger of the two sums says."""
    n = len(rows)
    t_bytes = sum(r["t_bytes"] for r in rows)
    t_ops = sum(r["t_ops"] for r in rows)
    return {
        "ms": sum(r["ms"] for r in rows) / n,
        "plain_ms": sum(r["plain_ms"] for r in rows) / n,
        "bound_ms": sum(max(r["t_bytes"], r["t_ops"]) for r in rows) / n,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "stream_ms": sum(r["stream_ms"] for r in rows) / n,
    }


def bounds(summary: dict) -> dict:
    return {k: summary[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}


def time_kernels(skim_cases, decode_cases) -> dict:
    """Each kernel at the main path's shapes: its device time (CUDA graph
    replay), its time per call as the stream sees it from the host, the
    plain version's time per call, and the bound (decoded values counted
    at each branch's own width)."""
    from repro_torch.kernels import basket_decode as bd
    from repro_torch.kernels import ref
    from repro_torch.kernels import skim_fused as sf

    out = {}
    rows = []
    for program, (t, v, w, p) in skim_cases:
        T, E, K = t.shape
        G, D = v.shape[0], p.shape[1]
        # read terms, valid, weights and payload once; write the packed
        # rows, the count, the ballot words and the tile counts once
        nbytes = 4 * (T * E * K + 2 * G * E * K + 2 * E * D + E // 32 + E // 512 + 1)
        ops = E * K * (T + 4 * G)  # a compare per term slot, the group's AND/sum
        t_bytes, t_ops = bound_times(nbytes, ops)
        row = {
            "ms": device_ms(lambda: sf.skim_fused(t, v, w, p, program)),
            "stream_ms": stream_ms(lambda: sf.skim_fused(t, v, w, p, program)),
            "plain_ms": stream_ms(lambda: ref.skim_fused_ref(t, v, w, p, program)),
            "t_bytes": t_bytes, "t_ops": t_ops,
        }
        rows.append(row)
        log(f"  skim_fused T={T} G={G} E={E} K={K} D={D}: kernel {row['ms']:.5f} ms "
            f"on the device, {row['stream_ms']:.5f} ms per call from the host; "
            f"plain {row['plain_ms']:.5f} ms; bound {max(t_bytes, t_ops):.7f} ms")
    out["skim_fused"] = _summary(rows)
    rows = []
    for name, kind, bits, dt, planes, firsts in decode_cases:
        N, B, W = planes.shape
        # read the planes and firsts once; write each value once at the
        # branch's own width
        nbytes = 4 * (N * B * W + N) + N * W * 32 * dt.itemsize
        ops = N * W * 32 * (3 * bits + 6)  # rebuild a code, transform, scan
        t_bytes, t_ops = bound_times(nbytes, ops)

        def kernel():
            return bd.basket_decode(planes, firsts, kind=kind, n_bits=bits, out_dtype=dt)

        row = {
            "ms": device_ms(kernel),
            "stream_ms": stream_ms(kernel),
            "plain_ms": stream_ms(
                lambda: ref.basket_decode_ref(planes, firsts, kind, W * 32, dt)),
            "t_bytes": t_bytes, "t_ops": t_ops,
        }
        rows.append(row)
        log(f"  basket_decode {name} N={N} B={B} W={W} kind={kind} -> {dt}: kernel "
            f"{row['ms']:.5f} ms on the device, {row['stream_ms']:.5f} ms per call "
            f"from the host; plain {row['plain_ms']:.5f} ms; bound "
            f"{max(t_bytes, t_ops):.7f} ms")
    out["basket_decode"] = _summary(rows)
    return out


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


def run_main_path(label, query, store, host_store) -> dict:
    import torch

    from repro_torch.core import run_skim
    from repro_torch.kernels import ops

    stats0 = store.decode_backend_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_skim(store, query)  # every default, on the card
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
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

    check(launches["skim_fused"] > 0, f"{label}: skim_fused never launched")
    check(launches["basket_decode"] > 0, f"{label}: basket_decode never launched")
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
        check(res.stats.bytes_fetched == ref.stats.bytes_fetched,
              f"{label}: bytes_fetched {res.stats.bytes_fetched} vs "
              f"{ref.stats.bytes_fetched} ({ref_name})")
        check(res.stats.cascade_bytes_skipped == ref.stats.cascade_bytes_skipped,
              f"{label}: cascade_bytes_skipped differs from the {ref_name}")
    check(fetch_row(res.stats) == fetch_row(host.stats),
          f"{label}: FetchStats differ from the host cascade of the same plan")
    check(res.extras["cascade_stages"] == host.extras["cascade_stages"]
          and res.extras["cascade_order"] == host.extras["cascade_order"],
          f"{label}: cascade ledgers differ from the host cascade")
    log(f"  [{label}] stage times (s): " + json.dumps(res.breakdown.as_dict()))
    log(f"  [{label}] survivors, output columns (every basket byte), "
        "bytes_fetched and cascade_bytes_skipped equal the staged reference "
        "and the host cascade; requests and the stage ledgers equal the "
        "host cascade")
    return {"wall_s": wall, "events_per_s": res.n_input / wall,
            "n_passed": res.n_passed, "launches": launches}


def device_busy(label, query, store) -> None:
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
        run_skim(store, query)
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

    build_s = _build.build_all()
    ops.load_kernels()
    log(f"  kernels built in {build_s:.1f} s into {_build.build_dir()}")

    log("== 2. kernels against their plain versions ==")
    rng = np.random.default_rng(0)
    decode_err = check_basket_decode(rng, device)
    skim_err, edge = check_skim_fused(rng, device)

    log(f"== building the {N_EVENTS:,}-event store ==")
    from repro_torch.data.synth import make_nanoaod_like

    t0 = time.perf_counter()
    store = make_nanoaod_like(N_EVENTS, n_hlt=64, n_filler=8, seed=0)
    host_store = make_nanoaod_like(N_EVENTS, n_hlt=64, n_filler=8, seed=0,
                                   device="cpu")
    log(f"  {len(store.branch_names())} branches, "
        f"{store.compressed_bytes() / 1e6:.1f} MB compressed, built twice "
        f"(card store, host store) in {time.perf_counter() - t0:.1f} s")
    queries = [("quickstart", QUICKSTART_QUERY), ("zee", zee_query(N_EVENTS))]

    log("== 2b. timing at the main path's shapes (window 0) ==")
    timing = time_kernels(
        path_skim_cases(store, [q for _, q in queries], device),
        path_decode_cases(store, ["nElectron", "Electron_charge", "HLT_IsoMu24",
                                  "Electron_mvaId", "luminosityBlock"], device),
    )

    log("== 3. main path: run_skim with every default, on the card ==")
    totals = {"skim_fused": 0, "basket_decode": 0}
    results = {}
    for label, query in queries:
        results[label] = run_main_path(label, query, store, host_store)
        for k, v in results[label]["launches"].items():
            totals[k] += v

    log("== 3b. where the device time goes (torch.profiler) ==")
    for label, query in queries:
        device_busy(label, query, store)

    kernels = [
        {"name": "skim_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/skim_fused.cu",
         "replaces": "src/repro/kernels/skim_fused.py:151",
         "launches": totals["skim_fused"], "max_abs_err": skim_err,
         **bounds(timing["skim_fused"]), "library_ms": None},
        {"name": "basket_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/basket_decode.cu",
         "replaces": "src/repro/kernels/basket_decode.py:135",
         "launches": totals["basket_decode"], "max_abs_err": decode_err,
         **bounds(timing["basket_decode"]), "library_ms": None},
    ]
    log(f"== done in {time.perf_counter() - t_start:.1f} s ==")
    log("main path: " + json.dumps(
        {k: {"wall_s": r["wall_s"], "events_per_s": r["events_per_s"],
             "n_passed": r["n_passed"]} for k, r in results.items()}))
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
