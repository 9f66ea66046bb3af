"""NanoAOD-like events: Electron, Muon and Jet collections, MET, primary
vertices, run/event/lumi numbers, trigger bits and filler branches.

A frozen NumPy copy of the port's ``data/synth.py::make_nanoaod_like`` as
it stood when the benchmark was written, driven by the configuration's
numbers: the same draws in the same order, so a seed gives the same
events as that generator gave.  After those draws come the configuration's
``published`` branches: the rest of each group's published branch set, in
its published type, so that an output pattern such as ``Electron_*``
matches as many branches as in a real file.
"""

from __future__ import annotations

import numpy as np


def _kinematic(rng: np.random.Generator, var: str, n: int) -> np.ndarray:
    if var == "pt":
        return (rng.exponential(25.0, n) + 3.0).astype(np.float32)
    if var == "eta":
        return rng.uniform(-2.5, 2.5, n).astype(np.float32)
    if var == "phi":
        return rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    if var == "mass":
        return np.abs(rng.normal(5.0, 3.0, n)).astype(np.float32)
    if var == "charge":
        return rng.choice(np.array([-1, 1], dtype=np.int32), n)
    if var in ("mvaId", "tightId"):
        return rng.random(n) > 0.3
    if var == "btagDeepB":
        return rng.beta(0.5, 2.0, n).astype(np.float32)
    return rng.normal(0.0, 1.0, n).astype(np.float32)


def columns(config: dict, seed: int) -> tuple[dict, dict]:
    n = int(config["n_events"])
    rng = np.random.default_rng(seed)
    cols: dict[str, np.ndarray] = {}
    jagged: dict[str, str] = {}
    for coll, (mean, variables) in config["collections"].items():
        counts = rng.poisson(mean, n).astype(np.int32)
        total = int(counts.sum())
        cols[f"n{coll}"] = counts
        for var in variables:
            cols[f"{coll}_{var}"] = _kinematic(rng, var, total)
            jagged[f"{coll}_{var}"] = f"n{coll}"

    cols["MET_pt"] = (rng.exponential(30.0, n) + 1.0).astype(np.float32)
    cols["MET_phi"] = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    cols["PV_npvs"] = rng.poisson(35.0, n).astype(np.int32)
    cols["run"] = np.full(n, config["run"], dtype=np.int32)
    cols["event"] = np.arange(n, dtype=np.int64).astype(np.int32)
    cols["luminosityBlock"] = (np.arange(n) // config["events_per_lumi"]).astype(np.int32)

    named = config["triggers"]
    for i in range(int(config["n_hlt"])):
        name = named[i] if i < len(named) else f"HLT_path{i:03d}"
        rate = config["named_trigger_rate"] if i < len(named) else config["other_trigger_rate"]
        cols[name] = rng.random(n) < rate

    for i in range(int(config["n_filler"])):
        cols[f"Filler_{i:03d}"] = rng.normal(0, 1, n).astype(np.float32)

    for group, by_type in config.get("published", {}).items():
        counts = cols.get(f"n{group}")
        size = n if counts is None else int(counts.sum())
        for dtype, names in by_type.items():
            for var in names:
                name = f"{group}_{var}"
                cols[name] = _published(rng, dtype, size)
                if counts is not None:
                    jagged[name] = f"n{group}"
    return cols, jagged


def _published(rng: np.random.Generator, dtype: str, n: int) -> np.ndarray:
    if dtype == "float32":
        return rng.standard_normal(n, dtype=np.float32)
    if dtype == "int32":
        return rng.integers(-1, 8, n, dtype=np.int32)
    if dtype == "uint8":
        return rng.integers(0, 4, n, dtype=np.uint8)
    if dtype == "bool":
        return rng.random(n, dtype=np.float32) < 0.5
    raise ValueError(f"no published branch type {dtype!r}")
