"""Run the port's cells in one source tree and print what they measure.

    python3 src/repro_torch/ab_cells.py [--src DIR] [--label NAME] [--out FILE]
                                        [--cells NAME,...]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured
(default: this file's own tree), so one command can measure a parent
commit unpacked beside the change: run it on the parent, the change, the
change and the parent, each in its own process, on one card.  The cells
are ``chip_smoke.py``'s (taken from this file's tree): the quickstart and
Z->ee queries on the 1,000,000-event NanoAOD-like store and the HT query
on the conditions-era store, each per window and with ``device_batch=16``
(cells ``quickstart``, ``quickstart-batched``, ``zee``, ``zee-batched``,
``era``, ``era-batched``; ``--cells`` runs only the ones it names, so a
process can run one cell alone).  Stores are built from their seeds once
and saved under ``--stores``; the next process loads them.

Per cell it reports the medians of ``--reps`` runs' ``Breakdown`` stages
(decompress, deserialize, filter, write) and wall, and the survivors;
after every cell's timed runs, from one more run, untimed,
``ops.launch_counts()``, ``ops.dispatch_stats()``, the fetch rounds and
(in a tree that decodes by rounds) the rounds that sent a bitpack miss to
the card, the host-to-device copies and bytes of that run, in all and
inside the cascade stage steps (``chip_smoke.count_uploads``), and the
host-to-device and device-to-host copies ``torch.profiler`` saw in one
run more.  When every cell runs, then the per-window skim's cost per
call at window 0 of the quickstart query's first stage:
``neardata.fused_window_skim`` from decoded columns to survivor rows, the
kernel wrapper alone, and the parts of the wrapper timed one at a time.  One JSON object per line goes to
``--out``; needs one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def per_call_us(fn, calls: int = 2000) -> float:
    """Host time per call of ``calls`` calls, the device drained after."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def copy_counts(fn) -> dict:
    """Device-side copy events of one call of ``fn``, by profiler name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and "Memcpy" in ev.key}


def stores(cs, path: Path):
    """(NanoAOD-like store, conditions-era store), on the card."""
    from repro_torch.data.store import EventStore
    from repro_torch.data.synth import make_nanoaod_like

    nano, era = path / "nanoaod.skim", path / "era.skim"
    if not (nano.exists() and era.exists()):
        path.mkdir(parents=True, exist_ok=True)
        make_nanoaod_like(cs.N_EVENTS, n_hlt=64, n_filler=8, seed=0,
                          device="cpu").save(str(nano))
        cs.make_era_store(cs.N_EVENTS, device="cpu").save(str(era))
    return EventStore.load(str(nano)), EventStore.load(str(era))


def time_cell(query, store, reps: int, **kw) -> dict:
    """Medians of ``reps`` runs' stage seconds and wall, and the survivors."""
    import torch

    from repro_torch.core import run_skim

    rows = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_skim(store, query, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows.append(dict(res.breakdown.as_dict(), wall=wall))
    keys = ("wall", "decompress", "deserialize", "filter", "write")
    return {"n_passed": res.n_passed,
            "median_s": {k: statistics.median(r[k] for r in rows) for k in keys}}


def ledger_cell(cs, query, store, **kw) -> dict:
    """One untimed run's launches, dispatch ledger and rounds, and one
    profiled run's copies."""
    from repro_torch.core import run_skim
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    ops.reset_dispatch_stats()
    fetch = count_fetches(store)
    by_round = hasattr(store, "_decode_round_uncached")  # the parent has none
    if by_round:
        counts, restore = cs.count_calls(store)
    uploads, restore_uploads = cs.count_uploads()
    run_skim(store, query, **kw)
    restore_uploads()
    launches, dispatch = ops.launch_counts(), ops.dispatch_stats()
    del store.fetch_window
    rounds = {"fetch": fetch["rounds"],
              "device_decode": counts["device_rounds"] if by_round else None}
    if by_round:
        restore()
    return {"launches": {k: v for k, v in launches.items() if v},
            "dispatch_stats": dispatch, "rounds": rounds, "uploads": uploads,
            "copies": copy_counts(lambda: run_skim(store, query, **kw))}


def count_fetches(store) -> dict:
    """Counts ``store``'s fetch rounds until ``del store.fetch_window``."""
    counts = {"rounds": 0}
    fetch = store.fetch_window

    def counting_fetch(*a, **k):
        counts["rounds"] += 1
        return fetch(*a, **k)

    store.fetch_window = counting_fetch
    return counts


def wrapper_costs(cs, store) -> dict:
    """The per-window skim's cost per call, and its wrapper's parts, at
    window 0 of the quickstart query's first cascade stage."""
    import torch

    from repro_torch.core.engine import Breakdown, _decode_branches
    from repro_torch.core.neardata import (
        build_padded_inputs, fused_window_skim, pad_window, window_pad_K,
    )
    from repro_torch.core.planner import plan_skim
    from repro_torch.core.query import parse_query
    from repro_torch.data.store import FetchStats
    from repro_torch.kernels import _build
    from repro_torch.kernels import skim_fused as sf

    device = torch.device("cuda", torch.cuda.current_device())

    def device_context():
        with torch.cuda.device(device):
            pass

    plan = plan_skim(parse_query(cs.QUICKSTART_QUERY), store,
                     window_events=store.basket_events, prune=False, cascade=True)
    stage = plan.cascade.stages[0]
    data = _decode_branches(store, list(stage.branches), 0, store.basket_events,
                            Breakdown(), FetchStats(), True)
    program = stage.program
    K = window_pad_K(data, program, store)
    pb = build_padded_inputs(data, program, store, K=K, include_index=True,
                             to_device=False)
    arrays = pad_window(pb)
    t, v, w, p = (torch.from_numpy(a).to(device) for a in arrays)
    out = {
        "shape": {"T": t.shape[0], "E": t.shape[1], "K": t.shape[2], "D": p.shape[1]},
        "fused_window_skim_us": per_call_us(
            lambda: fused_window_skim(data, program, store, backend="cuda",
                                      device=device), 500),
        "skim_fused_wrapper_us": per_call_us(lambda: sf.skim_fused(t, v, w, p, program)),
        "descriptor_lookup_us": per_call_us(lambda: sf.program_descriptor(program, device)),
        "hash_program_us": per_call_us(lambda: hash(program)),
        "device_context_us": per_call_us(device_context),
        "stream_of_us": per_call_us(lambda: _build.stream_of(device)),
        "empty_x1_us": per_call_us(
            lambda: torch.empty(p.shape, dtype=torch.float32, device=device)),
        "check_x4_us": per_call_us(lambda: [
            sf._check("skim_fused", "terms", t[None], (1, *t.shape), device)
            for _ in range(4)]),
    }

    def up():  # the parent's upload: one pageable copy per array
        return [torch.from_numpy(a).to(device) for a in arrays]

    out["upload_x4_pageable_us"] = per_call_us(up, 500)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--stores", default=str(ROOT / "_local" / "stores"))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "ab_cells.jsonl"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cells", default=None,
                    help="comma-separated cells to run (default: all six)")
    args = ap.parse_args()
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [x for x in sys.path if x != here]
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, args.src)
    import torch

    import chip_smoke as cs
    import repro_torch

    if not torch.cuda.is_available():
        print("ab_cells: no card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    _build.build_all()
    nano, era = stores(cs, Path(args.stores))
    cells = [("quickstart", cs.QUICKSTART_QUERY, nano),
             ("zee", cs.zee_query(cs.N_EVENTS), nano),
             ("era", cs.ERA_QUERY, era)]
    runs = [(label, query, store, kw) for label, query, store in cells
            for kw in ({}, {"device_batch": 16})]
    if args.cells:
        want = args.cells.split(",")
        names = [label + ("-batched" if kw else "") for label, _q, _s, kw in runs]
        unknown = set(want) - set(names)
        if unknown:
            ap.error(f"unknown cells {sorted(unknown)}: choose from {names}")
        runs = [r for r, name in zip(runs, names) if name in want]
    # every timed run first: a profiler session (copy counts) or the
    # ledger's counting wrappers before a timed run can change its timing
    records = [{"cell": label, "path": "batched" if kw else "per-window",
                **time_cell(query, store, args.reps, **kw)}
               for label, query, store, kw in runs]
    if not args.cells:
        records.append({"wrapper": wrapper_costs(cs, nano)})
    for rec, (_, query, store, kw) in zip(records, runs):
        rec.update(ledger_cell(cs, query, store, **kw))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    head = {"label": args.label, "package": str(Path(repro_torch.__file__).parent),
            "card": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for rec in records:
            line = json.dumps({**head, **rec})
            f.write(line + "\n")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
