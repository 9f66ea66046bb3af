"""A NanoAOD file at its published width: every branch group of a
NanoAODv9 data file, each jagged group with its ``n<group>`` counts
branch, and trigger menus that bring the file to the configuration's
``n_branches``.

The Electron, Muon, Jet and MET groups, the primary-vertex count, the
run/event/lumi numbers and the configuration's named triggers come from
``nanoaod_like`` (its draws, in its order, with no filler branch).  After
them, in this order: the rest of the HLT menu and the L1 menu (bits firing
at ``other_trigger_rate``; names from ``hlt_menu`` and ``l1_menu``, the
rest numbered), the ``flat`` branches by type, then each of ``groups``:
its counts from a Poisson draw at the group's mean, then its branches by
type.  Every value after ``nanoaod_like``'s is drawn as its
``_published`` draws it.

Each of those branches is drawn from a stream of its own, seeded from the
seed and the branch's place in that order (each group's counts from the
group's place among the groups), so that the draws run on a pool of
threads (NumPy's generators let go of the GIL while they fill) and give
the same columns whatever the pool's size.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench.generators import nanoaod_like


def menu(prefix: str, named: list, total: int) -> list[str]:
    """``total`` trigger names of one menu: ``named`` first, then numbered."""
    numbered = "path" if prefix == "HLT" else "seed"
    return list(named) + [f"{prefix}_{numbered}{i:03d}" for i in range(total - len(named))]


def _stream(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([seed, *key])


def _draw(rng: np.random.Generator, dtype: str, size: int, rate: float) -> np.ndarray:
    if dtype == "trigger":
        return rng.random(size, dtype=np.float32) < rate
    return nanoaod_like._published(rng, dtype, size)


def columns(config: dict, seed: int) -> tuple[dict, dict]:
    n = int(config["n_events"])
    named = list(config["triggers"])
    base = {**config, "n_hlt": len(named), "n_filler": 0}
    cols, jagged = nanoaod_like.columns(base, seed)

    # nanoaod_like's generator stays where its draws left it: each draw
    # after it has a stream of its own, seeded from the same seed
    hlt = menu("HLT", config["hlt_menu"], int(config["n_hlt"]) - len(named))
    l1 = menu("L1", config["l1_menu"], int(config["n_l1"]))
    draws = [(name, "trigger", n) for name in hlt + l1]
    draws += [(name, dtype, n) for dtype, names in config["flat"].items() for name in names]
    groups = config["groups"]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        counts = dict(zip(groups, pool.map(
            lambda g: _stream(seed, 2, g[0]).poisson(g[1], n).astype(np.int32),
            enumerate(mean for mean, _ in groups.values()))))
        order = [name for name, _, _ in draws]
        for group, (_mean, by_type) in groups.items():
            order.append(f"n{group}")
            total = int(counts[group].sum())
            for dtype, names in by_type.items():
                for var in names:
                    draws.append((f"{group}_{var}", dtype, total))
                    order.append(f"{group}_{var}")
                    jagged[f"{group}_{var}"] = f"n{group}"
        rate = config["other_trigger_rate"]
        drawn = dict(zip((name for name, _, _ in draws), pool.map(
            lambda i: _draw(_stream(seed, 1, i), *draws[i][1:], rate), range(len(draws)))))
    drawn.update((f"n{group}", c) for group, c in counts.items())
    cols.update((name, drawn[name]) for name in order)

    if len(cols) != int(config["n_branches"]):
        raise ValueError(f"{config['name']}: {len(cols)} branches, the configuration "
                         f"states {config['n_branches']}")
    return cols, jagged
