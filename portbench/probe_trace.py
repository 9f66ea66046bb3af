"""Per-skim host detail of a cell on the card, for `PERF.md`'s "Where the
time goes": the leaf kinds' seconds, the program's copies against the
profiler's, and the cost of tracing.

    python3 portbench/probe_trace.py --cells nanoaod-1m.quickstart,nanoaod-1m.zee \\
        --seed 3100000003 --cost-skims 6 --out probe.jsonl

For each cell it builds the cell's files from the seed, warms each file's
engine with one skim, then writes one JSON line a file for one traced skim
under `torch.profiler` (the leaf kinds' summed seconds, the spans, the
query span's counters beside the profiler's `Memcpy HtoD` and `Memcpy
DtoH` counts, the card's busy milliseconds inside the query span,
`unattributed_share`), and one line of the skim walls of `--cost-skims`
untraced and as many traced skims in turns (off, on, on, off, ...) with
no profiler.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from portbench import devtrace, manifest, spans, window  # noqa: E402
from portbench.metrics import unattributed_share  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402


def profiled(engine, traffic, f, sync) -> dict:
    """One traced skim of file ``f`` under the profiler."""
    dt = devtrace.DeviceTrace()
    dt.start()
    s = window.skim(engine, traffic, f, tracer=Tracer(), sync=sync)
    dt.stop()
    q = spans.query_span(s.spans)
    t0, t1 = q.attrs["clock_ns"], q.attrs["clock_ns"] + int((q.t1 - q.t0) * 1e9)
    kinds: dict[str, float] = {}
    for sp in s.spans:
        kinds[sp.kind] = kinds.get(sp.kind, 0.0) + (sp.t1 - sp.t0)
    busy = devtrace.union((max(a, t0), min(b, t1)) for _n, a, b in dt.events
                          if b > t0 and a < t1)
    return {
        "file": f, "query_s": q.t1 - q.t0, "n_spans": len(s.spans),
        **{k: q.attrs[k] for k in ("h2d_copies", "h2d_bytes", "d2h_copies", "d2h_bytes")},
        "profiler_h2d_copies": sum(1 for n, _a, _b in dt.events if n.startswith("Memcpy HtoD")),
        "profiler_d2h_copies": sum(1 for n, _a, _b in dt.events if n.startswith("Memcpy DtoH")),
        "busy_ms_in_query": sum(b - a for a, b in busy) / 1e6,
        "unattributed_share": unattributed_share.read(SimpleNamespace(skims=[s])),
        "kinds_s": kinds,
    }


def cost(engines, traffic, n, sync) -> dict:
    """Skim walls untraced and traced, in turns over the files."""
    walls: dict[str, list] = {"off": [], "on": []}
    for i in range(n):
        f = i % len(engines)
        for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
            tracer = Tracer() if mode == "on" else None
            s = window.skim(engines[f], traffic, f, tracer=tracer, sync=sync)
            walls[mode].append(s.t1 - s.t0)
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True, help="comma-separated cell names")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost-skims", type=int, default=6)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    bench = manifest.load()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as out:
        for name in args.cells.split(","):
            cell = manifest.cell(bench, name)
            config = manifest.config(bench, cell["config"])
            traffic = manifest.traffic(cell["traffic"])
            files = window.make_files(config, args.seed, traffic["files"])
            engines = window.open_engines(config, traffic, files, device)
            for f, engine in enumerate(engines):
                window.skim(engine, traffic, f, sync=sync)
            lines = [{"cell": name, **profiled(e, traffic, f, sync)}
                     for f, e in enumerate(engines)]
            walls = cost(engines, traffic, args.cost_skims, sync)
            lines.append({"cell": name, "walls": walls,
                          "median_off_s": statistics.median(walls["off"]),
                          "median_on_s": statistics.median(walls["on"])})
            for line in lines:
                print(json.dumps(line), flush=True)
                out.write(json.dumps(line) + "\n")
            del engines, files
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
