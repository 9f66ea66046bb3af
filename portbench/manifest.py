"""``BENCHMARK.json`` and the files it names, found by name.

A cell names its configuration (``configs[].file``) and its traffic mix
(``traffic/<mix>.json``); a per-layer metric is read by
``metrics/<metric>.py``; a configuration's events come from
``generators/<generator>.py``.  Adding any of them adds a file and an
entry: no file that is there changes.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def generator(name: str):
    return importlib.import_module(f"portbench.generators.{name}")


def reader(metric: str):
    return importlib.import_module(f"portbench.metrics.{metric}")


def metrics_of(manifest: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
