"""The system under test and the measured window.

A run builds its configuration's files from the seed (file ``i`` from
``seed + i``), encodes each with the port's ``EventStore.from_arrays`` and
opens one ``SkimEngine`` a file, as ``run_skim`` does.  The window is a
closed loop of ``SkimEngine.run(query, "near_data")`` over the files in
turn, back to back; the skim in progress when the time is up completes
and counts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from portbench import manifest


@dataclass
class Skim:
    """What the harness keeps of one skim: its counts and timers, the
    spans it needs, and the output file to judge once the window closes."""

    file: int
    n_input: int
    n_passed: int
    window_rows: list
    breakdown: dict
    bytes_fetched: int
    windows_scanned: int
    windows: int
    t0: float
    t1: float
    output: object = None
    spans: list = field(default_factory=list)
    blobs: dict = field(default_factory=dict)

    @property
    def plan_s(self) -> float | None:
        plans = [s.duration for s in self.spans if s.kind == "plan"]
        return sum(plans) if plans else None

    def read_output(self) -> None:
        """Take the output file's baskets and let the file go."""
        out = self.output
        self.blobs = {name: [blob for _, blob in out.fetch_range(name, 0, out.n_events)]
                      for name in out.branches}
        self.output = None


def make_files(config: dict, seed: int, n_files: int) -> list:
    gen = manifest.generator(config["generator"])
    return [gen.columns(config, (seed + i) % (1 << 64)) for i in range(n_files)]


def open_engines(config: dict, traffic: dict, files: list, device) -> list:
    from repro_torch.core.engine import SkimEngine
    from repro_torch.data.store import EventStore

    engines = []
    for cols, jagged in files:
        store = EventStore.from_arrays(
            cols, jagged=jagged, basket_events=config["basket_events"],
            codec=config["codec"], device=device)
        engines.append(SkimEngine(store, device_batch=traffic["device_batch"], device=device))
    return engines


def skim(engine, traffic: dict, file: int, tracer=None, sync=None) -> Skim:
    t0 = time.perf_counter()
    res = engine.run(traffic["query"], traffic["mode"], tracer=tracer)
    if sync is not None:
        sync()
    t1 = time.perf_counter()
    decisions = res.plan.window_decisions
    n_windows = len(res.report.window_rows)
    scanned = (n_windows if decisions is None
               else sum(1 for d in decisions if d.decision == "scan"))
    return Skim(file=file, n_input=res.n_input, n_passed=res.n_passed,
                window_rows=list(res.report.window_rows),
                breakdown=res.breakdown.as_dict(), bytes_fetched=res.stats.bytes_fetched,
                windows_scanned=scanned, windows=n_windows, t0=t0, t1=t1,
                output=res.output, spans=tracer.spans() if tracer is not None else [])


def closed_loop(engines: list, traffic: dict, seconds: float, first: int = 0,
                tracer_cls=None, sync=None) -> dict:
    """Skims back to back over the files in turn, from file ``first``, until
    ``seconds`` have passed; the last one completes and counts."""
    skims = []
    cpu0, t0 = time.process_time(), time.perf_counter()
    i = first
    while True:
        f = i % len(engines)
        skims.append(skim(engines[f], traffic, f,
                          tracer_cls() if tracer_cls is not None else None, sync))
        i += 1
        if skims[-1].t1 - t0 >= seconds:
            break
    t1, cpu1 = skims[-1].t1, time.process_time()
    return {"skims": skims, "t0": t0, "t1": t1, "cpu_s": cpu1 - cpu0}
