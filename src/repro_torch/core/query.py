"""JSON query format -> predicate AST (paper §3.1, Fig. 2c).

A query replaces the hand-written C++/Python filtering script with a
declarative JSON document::

    {
      "input":  "events.skim",
      "output": "skimmed.skim",
      "branches": ["Electron_*", "Jet_pt", "HLT_*", "MET_*"],
      "force_all": false,
      "selection": {
        "preselection": [
          {"branch": "nElectron", "op": ">=", "value": 1}
        ],
        "object": [
          {"collection": "Electron",
           "cuts": [{"var": "pt",  "op": ">",    "value": 20.0},
                    {"var": "eta", "op": "abs<", "value": 2.4}],
           "min_count": 1}
        ],
        "event": [
          {"type": "ht", "collection": "Jet", "var": "pt",
           "object_cuts": [{"var": "pt", "op": ">", "value": 30.0}],
           "op": ">", "value": 200.0},
          {"type": "any", "branches": ["HLT_IsoMu24"]},
          {"type": "cut", "branch": "MET_pt", "op": ">", "value": 40.0},
          {"type": "mass", "collections": ["Electron", "Electron"],
           "window": [80.0, 100.0]},
          {"type": "deltaR", "collections": ["Electron", "Jet"],
           "op": ">", "value": 0.4},
          {"type": "expr", "expr": "MET_pt + 0.5*sum(Jet_pt)",
           "op": ">", "value": 150.0}
        ]
      }
    }

The three selection tiers map to the paper's hierarchical model:
*preselection* (cheap single-branch cuts), *object-level* (per-particle
kinematic cuts over jagged collections), *event-level* (composite derived
variables such as HT, trigger ORs, and the derived-kinematics tier:
leading-pair invariant-mass windows, ΔR, and arithmetic expressions over
flat branches and ``sum()`` reductions — DESIGN.md §10).  Stages run in
order and events are discarded as early as possible (basket-granular
short-circuiting in the engine).

Trigger menus differ across data-taking eras, so ``any`` nodes treat
branches absent from a store as constant-False by default;
``parse_query(..., strict=True)`` restores hard validation.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.expr import (
    KINEMATIC_VARS,
    compile_expr,
    eval_expr_np,
    leading_delta_r,
    leading_pair_mass,
    rpn_branches,
)

OPS = {
    ">": lambda x, v: x > v,
    ">=": lambda x, v: x >= v,
    "<": lambda x, v: x < v,
    "<=": lambda x, v: x <= v,
    "==": lambda x, v: x == v,
    "!=": lambda x, v: x != v,
    "abs<": lambda x, v: abs(x) < v,
    "abs>": lambda x, v: abs(x) > v,
}


@dataclass(frozen=True)
class Cut:
    """Flat-branch comparison (preselection / event tier)."""

    branch: str
    op: str
    value: float

    def branches(self) -> set[str]:
        return {self.branch}


@dataclass(frozen=True)
class VarCut:
    """Comparison on one variable of a collection member."""

    var: str
    op: str
    value: float


@dataclass(frozen=True)
class ObjectSelection:
    """Object tier: count collection members passing all cuts >= min_count."""

    collection: str
    cuts: tuple[VarCut, ...]
    min_count: int = 1

    def branches(self) -> set[str]:
        out = {f"n{self.collection}"}
        for c in self.cuts:
            out.add(f"{self.collection}_{c.var}")
        return out


@dataclass(frozen=True)
class HTCut:
    """Event tier: scalar sum of ``var`` over passing objects, compared."""

    collection: str
    var: str
    object_cuts: tuple[VarCut, ...]
    op: str
    value: float

    def branches(self) -> set[str]:
        out = {f"n{self.collection}", f"{self.collection}_{self.var}"}
        for c in self.object_cuts:
            out.add(f"{self.collection}_{c.var}")
        return out


@dataclass(frozen=True)
class AnyOf:
    """Event tier: OR of boolean branches (trigger conditions).

    Branches absent from the store under evaluation contribute
    constant-False (menus differ across eras); ``Query.strict`` restores
    the hard ``KeyError``.  The zone-map analysis mirrors the same
    semantics so pruning stays bit-identical.
    """

    names: tuple[str, ...]

    def branches(self) -> set[str]:
        return set(self.names)


@dataclass(frozen=True)
class MassWindow:
    """Event tier: leading-pair invariant mass inside ``[lo, hi]``.

    The pair is the two highest-``pt`` objects of a same-collection pair,
    or each collection's leading object otherwise; events without a full
    pair fail.  Bounds are inclusive."""

    collections: tuple[str, str]
    lo: float
    hi: float

    def branches(self) -> set[str]:
        out: set[str] = set()
        for c in set(self.collections):
            out.add(f"n{c}")
            out |= {f"{c}_{v}" for v in KINEMATIC_VARS["mass"]}
        return out


@dataclass(frozen=True)
class DeltaRCut:
    """Event tier: ΔR between the leading pair, compared to a threshold.

    Events without a full pair fail regardless of the operator."""

    collections: tuple[str, str]
    op: str
    value: float

    def branches(self) -> set[str]:
        out: set[str] = set()
        for c in set(self.collections):
            out.add(f"n{c}")
            out |= {f"{c}_{v}" for v in KINEMATIC_VARS["deltaR"]}
        return out


@dataclass(frozen=True)
class ExprCut:
    """Event tier: arithmetic expression over flat branches and ``sum()``
    reductions, compared to a threshold (float64 host semantics;
    ``repro_torch.core.expr``)."""

    source: str  # original expression text (repr / error messages)
    rpn: tuple  # branch-name stack program from expr.compile_expr
    op: str
    value: float

    def branches(self) -> set[str]:
        return rpn_branches(self.rpn)


Stage = tuple  # tuple of AST nodes evaluated with logical AND


@dataclass
class Query:
    input: str
    output: str
    branches: tuple[str, ...]  # output branch patterns (wildcards allowed)
    force_all: bool
    preselection: tuple = ()
    object_stage: tuple = ()
    event_stage: tuple = ()
    # strict=True restores the hard KeyError for trigger-OR branches the
    # store does not carry (the pre-era-robustness behavior)
    strict: bool = False
    # cascaded phase-1 execution (DESIGN.md §11): ``True``/``False``
    # forces the cascade on or off for this query, ``None`` defers to the
    # executing engine's default.  Part of the canonical query form (the
    # executor flag changes a cached result's accounting payload).
    cascade: bool | None = None
    meta: dict = field(default_factory=dict)

    def stages(self) -> list[tuple[str, tuple]]:
        return [
            ("preselection", self.preselection),
            ("object", self.object_stage),
            ("event", self.event_stage),
        ]

    def filter_branches(self) -> set[str]:
        """Branches the selection criteria read (the paper's O(10) set)."""
        out: set[str] = set()
        for _, stage in self.stages():
            for node in stage:
                out |= node.branches()
        return out

    def stage_branches(self, stage_name: str) -> set[str]:
        for name, stage in self.stages():
            if name == stage_name:
                out: set[str] = set()
                for node in stage:
                    out |= node.branches()
                return out
        raise KeyError(stage_name)

    def optional_branches(self) -> set[str]:
        """Branches a store may legitimately lack: trigger-OR names, which
        evaluate as constant-False when absent (unless ``strict``)."""
        if self.strict:
            return set()
        out: set[str] = set()
        for _, stage in self.stages():
            for node in stage:
                if isinstance(node, AnyOf):
                    out |= set(node.names)
        return out


def _parse_varcuts(items) -> tuple[VarCut, ...]:
    return tuple(VarCut(c["var"], c["op"], c["value"]) for c in items)


def parse_query(doc: dict | str, strict: bool = False) -> Query:
    """Parse a JSON query document (dict or JSON string) into a :class:`Query`.

    ``strict=True`` (or ``"strict": true`` in the document) makes trigger
    branches listed in ``any`` nodes but absent from the target store a
    hard planning error instead of constant-False.
    """
    if isinstance(doc, str):
        doc = json.loads(doc)
    sel = doc.get("selection", {})

    presel = tuple(
        Cut(c["branch"], c["op"], c["value"]) for c in sel.get("preselection", [])
    )
    objs = tuple(
        ObjectSelection(
            o["collection"], _parse_varcuts(o.get("cuts", [])), o.get("min_count", 1)
        )
        for o in sel.get("object", [])
    )
    events: list = []
    for e in sel.get("event", []):
        kind = e.get("type", "cut")
        if kind == "cut":
            events.append(Cut(e["branch"], e["op"], e["value"]))
        elif kind == "any":
            events.append(AnyOf(tuple(e["branches"])))
        elif kind == "ht":
            events.append(
                HTCut(
                    e["collection"],
                    e.get("var", "pt"),
                    _parse_varcuts(e.get("object_cuts", [])),
                    e["op"],
                    e["value"],
                )
            )
        elif kind == "mass":
            colls = tuple(e["collections"])
            if len(colls) != 2:
                raise ValueError("mass node needs exactly two collections")
            lo, hi = e["window"]
            events.append(MassWindow(colls, float(lo), float(hi)))
        elif kind == "deltaR":
            colls = tuple(e["collections"])
            if len(colls) != 2:
                raise ValueError("deltaR node needs exactly two collections")
            events.append(DeltaRCut(colls, e.get("op", ">"), float(e["value"])))
        elif kind == "expr":
            events.append(
                ExprCut(e["expr"], compile_expr(e["expr"]), e["op"],
                        float(e["value"]))
            )
        else:
            raise ValueError(f"unknown event-cut type: {kind}")

    for op_node in presel + tuple(events):
        if isinstance(op_node, (Cut, DeltaRCut, ExprCut)) and op_node.op not in OPS:
            raise ValueError(f"unknown op {op_node.op}")

    return Query(
        input=doc.get("input", ""),
        output=doc.get("output", ""),
        branches=tuple(doc.get("branches", [])),
        force_all=bool(doc.get("force_all", False)),
        preselection=presel,
        object_stage=objs,
        event_stage=tuple(events),
        strict=bool(doc.get("strict", strict)),
        cascade=(None if doc.get("cascade") is None else bool(doc["cascade"])),
        meta={k: v for k, v in doc.items() if k not in
              ("input", "output", "branches", "force_all", "selection",
               "strict", "cascade")},
    )


# ---------------------------------------------------------------------------
# numpy evaluator (host path; the device path lives in repro_torch.kernels)
# ---------------------------------------------------------------------------


def _event_ids(counts: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(len(counts)), counts)


def eval_node(node, data: dict, n_events: int | None = None) -> np.ndarray:
    """Evaluate one AST node -> boolean mask over events.

    ``data`` maps flat branch name -> (n_events,) array and jagged branch
    name -> values array, with counts available under the ``n<Collection>``
    name.  ``any`` names missing from ``data`` contribute constant-False
    (absent-era triggers); ``n_events`` sizes the mask when *every* name
    is missing (``eval_stage`` always passes it).
    """
    if isinstance(node, Cut):
        return np.asarray(OPS[node.op](data[node.branch], node.value), dtype=bool)
    if isinstance(node, AnyOf):
        present = [n for n in node.names if n in data]
        if not present:
            if n_events is None:
                raise KeyError(
                    f"AnyOf{node.names}: no branch present and n_events unknown"
                )
            return np.zeros(n_events, dtype=bool)
        mask = np.zeros_like(np.asarray(data[present[0]], dtype=bool))
        for n in present:
            mask |= np.asarray(data[n], dtype=bool)
        return mask
    if isinstance(node, MassWindow):
        m, ok = leading_pair_mass(data, *node.collections)
        return ok & (m >= node.lo) & (m <= node.hi)
    if isinstance(node, DeltaRCut):
        dr, ok = leading_delta_r(data, *node.collections)
        return ok & np.asarray(OPS[node.op](dr, node.value), dtype=bool)
    if isinstance(node, ExprCut):
        val = eval_expr_np(node.rpn, data)
        return np.asarray(OPS[node.op](val, node.value), dtype=bool)
    if isinstance(node, ObjectSelection):
        counts = np.asarray(data[f"n{node.collection}"], dtype=np.int64)
        passing = None
        for c in node.cuts:
            vals = data[f"{node.collection}_{c.var}"]
            m = np.asarray(OPS[c.op](vals, c.value), dtype=bool)
            passing = m if passing is None else (passing & m)
        if passing is None:
            passing = np.ones(int(counts.sum()), dtype=bool)
        # integer accumulation: count semantics are exact and match the
        # fused kernel's int32 path (float64 counting was exact too, but
        # only incidentally — the comparison belongs in integers)
        per_event = np.bincount(
            _event_ids(counts)[passing], minlength=len(counts)
        )
        return per_event >= node.min_count
    if isinstance(node, HTCut):
        counts = np.asarray(data[f"n{node.collection}"], dtype=np.int64)
        vals = np.asarray(data[f"{node.collection}_{node.var}"], dtype=np.float64)
        passing = np.ones(len(vals), dtype=bool)
        for c in node.object_cuts:
            v = data[f"{node.collection}_{c.var}"]
            passing &= np.asarray(OPS[c.op](v, c.value), dtype=bool)
        ht = np.bincount(
            _event_ids(counts), weights=vals * passing, minlength=len(counts)
        )
        return np.asarray(OPS[node.op](ht, node.value), dtype=bool)
    raise TypeError(f"unknown node {type(node)}")


def eval_stage(stage: tuple, data: dict, n_events: int) -> np.ndarray:
    mask = np.ones(n_events, dtype=bool)
    for node in stage:
        mask &= eval_node(node, data, n_events)
    return mask
