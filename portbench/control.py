"""The control of the comparison that decides ``correct``: the reference put
in the program's place, computed one step below the configuration's stated
precision (float32 columns through bfloat16, float64 group values in
float32), judged as a run judges the program's skims.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--events N]

For each seed it builds the cell's files as a run does and prints one JSON
line: the numbers the control reads, beside those of the reference judged
against itself (all 0).  The benchmark's runs never run it.  Needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def stand_in(ref, file: int):
    """A skim record of ``ref``'s survivors and output, as the program's."""
    from portbench import codec, reference

    values = reference.expected_output(ref.query, ref.cols, ref.mask, ref.basket_events)
    counts = reference.window_counts(ref.mask, ref.basket_events)
    n = len(ref.mask)
    rows = [(s, min(s + ref.basket_events, n), int(k))
            for s, k in zip(range(0, n, ref.basket_events), counts)]
    return SimpleNamespace(file=file, n_passed=int(ref.mask.sum()), window_rows=rows,
                           blobs={k: [codec.encode(v) for v in vs] for k, vs in values.items()})


def readings(workload: str, seed: int, overrides: dict | None = None) -> dict:
    from portbench import judge, manifest, window

    bench = manifest.load()
    cell = manifest.cell(bench, workload)
    config = {**manifest.config(bench, cell["config"]), **(overrides or {})}
    traffic = manifest.traffic(cell["traffic"])
    files = window.make_files(config, seed, traffic["files"])
    refs = [judge.FileReference(traffic["query"], c, j, config["basket_events"]) for c, j in files]
    lower = [judge.FileReference(traffic["query"], c, j, config["basket_events"], "lower")
             for c, j in files]
    return {"workload": workload, "seed": seed, "events": config["n_events"],
            "control": judge.judge([stand_in(r, f) for f, r in enumerate(lower)], refs),
            "reference": judge.judge([stand_in(r, f) for f, r in enumerate(refs)], refs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--events", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).parent]
    sys.path[:0] = [str(ROOT)]
    overrides = {"n_events": args.events} if args.events else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(args.workload, seed, overrides)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
