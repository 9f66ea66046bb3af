"""Run one cell of the port's benchmark on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's files from the seed, opens the port's engines and
skims each file once; the window then skims the files in turn for
``--seconds``.  With ``--trace 0`` the last stdout line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read under
the port's tracer and ``torch.profiler``.  Once the window has closed every
skim's output is held to the plain reference (``portbench/judge.py``); the
numbers compared, each beside its limit, are the last lines on stderr and
the result's last key.  Exits 2 without a card, 3 when JAX, the JAX
package or its harness was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# what no process of the benchmark may load, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke")


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else smi.stderr.strip()


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, overrides: dict | None = None) -> dict:
    """One run of a cell on ``device``: the result line's object, with the
    compared numbers under ``checks``."""
    import torch

    from portbench import context, devtrace, judge, manifest, window

    bench = manifest.load()
    cell = manifest.cell(bench, workload)
    config = {**manifest.config(bench, cell["config"]), **(overrides or {})}
    traffic = manifest.traffic(cell["traffic"])
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else None

    t = time.perf_counter()
    files = window.make_files(config, seed, traffic["files"])
    t_gen = time.perf_counter() - t
    engines = window.open_engines(config, traffic, files, device)
    t_store = time.perf_counter() - t - t_gen
    # one skim of each file: the first skim of a file pays its first-use
    # costs, which belong to set-up, not to the window
    warm = [window.skim(e, traffic, f, sync=sync) for f, e in enumerate(engines)]
    log(f"set-up: generate {t_gen:.3f} s, encode {t_store:.3f} s, warm-up skims "
        + ", ".join(f"{w.t1 - w.t0:.3f} s ({w.n_passed} of {w.n_input} events)" for w in warm))
    del warm

    tracer_cls = dev = None
    if trace:
        from repro_torch.obs.trace import Tracer

        tracer_cls = Tracer
        if on_card:
            dev = devtrace.DeviceTrace()
            dev.start()
    clock = devtrace.clock_pair()
    setup_s = clock[0] - t_start
    loop = window.closed_loop(engines, traffic, seconds, first=0,
                              tracer_cls=tracer_cls, sync=sync)
    end_ns = clock[1] + int((loop["t1"] - clock[0]) * 1e9)
    if dev is not None:
        dev.stop()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    skims = loop["skims"]
    window_s = loop["t1"] - loop["t0"]
    events = sum(s.n_input for s in skims)
    log(f"window: {len(skims)} skims, {events} events in {window_s:.6f} s; skim walls "
        + " ".join(f"{s.t1 - s.t0:.4f}" for s in skims))
    if on_card:
        from repro_torch.kernels import ops

        log(f"launches (set-up and window): {ops.launch_counts()}")

    for s in skims:
        s.read_output()
    del engines
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    refs = [judge.FileReference(traffic["query"], cols, jagged, config["basket_events"])
            for cols, jagged in files]
    verdict = judge.judge(skims, refs)
    log(f"reference and comparison: {time.perf_counter() - t:.3f} s")

    result = {"correct": verdict["correct"], "attempted": len(skims),
              "failed": verdict["failed"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    if not trace:
        values = {
            "skim_events_per_s": events / window_s,
            "host_cpu_s_per_Mevent": loop["cpu_s"] / (events / 1e6),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.metrics_of(bench, workload, "end_to_end")}
    else:
        wt = devtrace.WindowTrace(dev.events, clock[1], end_ns) if dev is not None else None
        ctx = context.Context(cell=cell, config=config, traffic=traffic, skims=skims,
                              trace=wt, refs=refs)
        metrics, t = {}, time.perf_counter()
        for m in manifest.metrics_of(bench, workload, "per_layer"):
            value = manifest.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if wt is not None:
            device_info.update(busy_s=wt.busy_s, window_s=wt.window_s)
            spans = [sp for s in skims for sp in s.spans]
            result["breakdown"] = {"device_ops": wt.device_ops(),
                                   "idle_gaps": wt.idle_gaps(spans, clock)}
        log(f"per-layer metrics and breakdown read in {time.perf_counter() - t:.3f} s")
    result.update(metrics=metrics, device=device_info)
    numbers = verdict["numbers"]
    log(f"run: {time.perf_counter() - t_start:.3f} s from process start")
    result["checks"] = {k: {"value": numbers[k], "limit": lim}
                        for k, lim in judge.LIMITS.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda-cache"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton-cache"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).parent]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import manifest

    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0), T_START)
    loaded = forbidden_modules()
    if loaded:
        log(f"loaded what the benchmark may not: {loaded}")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
