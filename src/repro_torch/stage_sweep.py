"""Time the batched cascade's stage kernel at the main path's stage shapes.

    python3 src/repro_torch/stage_sweep.py [--budgets 12,24,48,96] [--out FILE]

On one card, for every cascade stage of the first 16-window batch of
``chip_smoke.py``'s three cells (quickstart and Z->ee on the NanoAOD-like
store, the HT query on the conditions-era store), as ``run_window_batch``
stages it: the device time of the kernel's earlier design
(``parent_stage_launch`` of ``chip_smoke.PARENT_CU``, dense inputs), of the kernel with every
event of the staged windows dead (the launch's fixed cost: the zeroing of
the summary, the launch, the mask read), and of the kernel under each
shared-memory budget (``--budgets``, KiB: the tile ``stage_plan`` picks)
and each lanes policy (``pair-1``: ``predicate_eval.event_lanes``;
``slots``: min(K, 32) lanes an event always).  Device time is
``chip_smoke.device_ms`` with the carried mask restored before each call
(a device copy, timed alone and subtracted).  One JSON object per line
goes to ``--out`` and to standard output; needs one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budgets", default="12,24,48,96")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "stage_sweep.jsonl"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.data.synth import make_nanoaod_like
    from repro_torch.kernels import _build
    from repro_torch.kernels import predicate_eval as pe

    if not torch.cuda.is_available():
        print("stage_sweep: no card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    build = cs.start_parent_build()
    _build.build_all()
    parent = cs.finish_parent_build(*build)
    nano = make_nanoaod_like(cs.N_EVENTS, n_hlt=64, n_filler=8, seed=0)
    era = cs.make_era_store(cs.N_EVENTS)
    cases = []
    for query, store in ((cs.QUICKSTART_QUERY, nano), (cs.zee_query(cs.N_EVENTS), nano),
                         (cs.ERA_QUERY, era)):
        cases += cs.path_stage_cases(store, [query], device)

    def timed(fn, packed0, pk):
        def restore():
            return pk.copy_(packed0)

        return (cs.device_ms(lambda: (restore(), fn(pk)))
                - cs.device_ms(restore))

    def sweep(label, fn, dead=False) -> dict:
        row = []
        for c in cases:
            packed0 = torch.zeros_like(c[3]) if dead else c[3]
            row.append(timed(lambda pk, c=c: fn(c, pk), packed0, packed0.clone()))
        return {"variant": label, "mean_ms": sum(row) / len(row), "ms": row}

    def staged(c, pk):
        return pe.cascade_stage_windows(c[5]["planes"], c[5]["rows"], pk, c[4], c[0], c[1])

    lanes, budget = pe.event_lanes, pe.SMEM_BUDGET
    records = [
        {"shapes": [[*c[2][0].shape, len(c[5]["row_list"])] for c in cases]},
        sweep("parent", lambda c, pk: parent.stage(*c[2], pk, c[4], c[0], c[1])),
        sweep("all dead", staged, dead=True),
    ]
    try:
        for kib in (int(x) for x in args.budgets.split(",")):
            pe.SMEM_BUDGET = kib * 1024
            for policy, fn in (("pair-1", lanes), ("slots", lambda p, K: min(K, 32))):
                pe.event_lanes = fn
                records.append(sweep(f"{kib} KiB, {policy}", staged))
    finally:
        pe.event_lanes, pe.SMEM_BUDGET = lanes, budget
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    with open(args.out, "a") as f:
        for rec in records:
            line = json.dumps({"card": card, **rec}, sort_keys=True)
            f.write(line + "\n")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
