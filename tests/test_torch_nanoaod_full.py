"""The paper's full-width NanoAOD file (``nanoaod-1749``) under the HT
search preselection of CMS SUS-19-006 (``ht-batched``), and the cascade's
padded-slot counters.

* ``portbench/generators/nanoaod_full.py`` gives the configuration's 1,749
  branches in their types, every jagged group with its counts, and the
  same columns for the same seed;
* the port's ``near_data`` route, per window and with ``device_batch=16``,
  matches the plain reference (``portbench/reference.py``) in survivors
  and output bytes, with events whose HT falls on the 300 GeV cut;
* a detailed ``cascade_stage`` span carries ``plane_slots`` and
  ``object_slots``, the ``plan`` span the store's and the plan's branch
  counts; a tracer without detail records neither;
* the readers ``ht_stage_s_per_skim`` and ``padded_slot_share``.

This file imports neither JAX nor the JAX package; its ``cuda`` test runs
the reference comparison on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_nanoaod_full.py
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import judge, manifest, window  # noqa: E402
from portbench.context import Context  # noqa: E402
from portbench.generators import nanoaod_full  # noqa: E402
from portbench.metrics import ht_stage_s_per_skim, padded_slot_share  # noqa: E402
from repro_torch.core import SkimEngine  # noqa: E402
from repro_torch.data.store import EventStore  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

CELL = "nanoaod-1749.ht-batched"
# three whole baskets and a short one
N_EVENTS = 3 * 4096 + 617
SEED = 2**33 + 5


def _config(n_events=N_EVENTS):
    bench = manifest.load()
    return {**manifest.config(bench, manifest.cell(bench, CELL)["config"]),
            "n_events": n_events}


def _types(config) -> dict:
    """Every branch the configuration states, with its type."""
    kinematic = {"pt": "float32", "eta": "float32", "phi": "float32", "mass": "float32",
                 "btagDeepB": "float32", "charge": "int32", "mvaId": "bool",
                 "tightId": "bool"}
    out = {"run": "int32", "event": "int32", "luminosityBlock": "int32",
           "PV_npvs": "int32", "MET_pt": "float32", "MET_phi": "float32"}
    for coll, (_mean, variables) in config["collections"].items():
        out[f"n{coll}"] = "int32"
        out.update({f"{coll}_{v}": kinematic[v] for v in variables})
    for group, by_type in config["published"].items():
        out.update({f"{group}_{v}": t for t, vs in by_type.items() for v in vs})
    for group, (_mean, by_type) in config["groups"].items():
        out[f"n{group}"] = "int32"
        out.update({f"{group}_{v}": t for t, vs in by_type.items() for v in vs})
    out.update({name: t for t, names in config["flat"].items() for name in names})
    hlt = nanoaod_full.menu("HLT", config["triggers"] + config["hlt_menu"], config["n_hlt"])
    l1 = nanoaod_full.menu("L1", config["l1_menu"], config["n_l1"])
    out.update(dict.fromkeys(hlt + l1, "bool"))
    return out


def test_generator_gives_the_configured_branches_in_their_types():
    config = _config(2 * 4096)
    cols, jagged = nanoaod_full.columns(config, SEED)
    types = _types(config)
    assert len(cols) == len(types) == config["n_branches"] == 1749
    assert {name: str(cols[name].dtype) for name in cols} == types
    groups = set(config["collections"]) | set(config["groups"])
    assert set(jagged.values()) == {f"n{g}" for g in groups}
    for name, counts in jagged.items():
        assert name.split("_", 1)[0] in groups and counts == "n" + name.split("_", 1)[0]
        assert len(cols[name]) == int(cols[counts].sum())
    flat = [name for name in cols if name not in jagged]
    assert {len(cols[name]) for name in flat} == {config["n_events"]}
    for group, (mean, _types_) in config["groups"].items():
        assert abs(cols[f"n{group}"].mean() - mean) < 0.1 * mean + 0.05


def test_generator_gives_the_same_columns_for_the_same_seed():
    config = _config(4096)
    a, ja = nanoaod_full.columns(config, SEED)
    b, jb = nanoaod_full.columns(config, SEED)
    c, _ = nanoaod_full.columns(config, SEED + 1)
    assert ja == jb and list(a) == list(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["Photon_pt"], c["Photon_pt"])
    assert not np.array_equal(a["L1_seed000"], c["L1_seed000"])


def test_generator_gives_the_same_columns_on_any_number_of_threads(monkeypatch):
    config = _config(4096)
    a, ja = nanoaod_full.columns(config, SEED)
    monkeypatch.setattr(nanoaod_full.os, "cpu_count", lambda: 1)
    b, jb = nanoaod_full.columns(config, SEED)
    assert ja == jb and list(a) == list(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def _jets_of(cols, e):
    start = int(cols["nJet"][:e].sum())
    return slice(start, start + int(cols["nJet"][e]))


def edge_file():
    """One file of the configuration with three hand-set events in its first
    basket: HT of the passing jets exactly 300 (fails ``> 300``), one
    float32 step above (passes), and exactly 300 once a jet outside
    |eta| < 2.4 is left out (fails); each fires ``HLT_PFHT1050``."""
    config = _config()
    cols, jagged = nanoaod_full.columns(config, SEED)
    events = [int(e) for e in np.flatnonzero(cols["nJet"][:4096] >= 4)[:3]]
    third = np.nextafter(np.float32(100), np.float32(200))
    for e, pts, etas in zip(events, ([100, 100, 100], [100, 100, third], [150, 150, 90]),
                            ([0.5, -1.0, 2.0], [0.5, -1.0, 2.0], [0.1, -0.1, 2.45])):
        jets = _jets_of(cols, e)
        pt, eta = cols["Jet_pt"][jets], cols["Jet_eta"][jets]
        pt[:] = 10.0  # every other jet of the event fails pt > 30
        pt[:3], eta[:3] = np.asarray(pts, np.float32), np.asarray(etas, np.float32)
        cols["HLT_PFHT1050"][e] = True
    return config, cols, jagged, events


def _skim(config, traffic, cols, jagged, device, fused_backend=None, tracer=None):
    store = EventStore.from_arrays(cols, jagged=jagged, basket_events=config["basket_events"],
                                   codec=config["codec"], device=device)
    engine = SkimEngine(store, device_batch=traffic["device_batch"],
                        fused_backend=fused_backend, device=device)
    skim = window.skim(engine, traffic, 0, tracer=tracer)
    skim.read_output()
    return skim


def _held_to_the_reference(device, device_batch, fused_backend=None):
    config, cols, jagged, edges = edge_file()
    traffic = {**manifest.traffic("ht-batched"), "device_batch": device_batch}
    skim = _skim(config, traffic, cols, jagged, device, fused_backend)
    ref = judge.FileReference(traffic["query"], cols, jagged, config["basket_events"])
    assert [bool(ref.mask[e]) for e in edges] == [False, True, False]
    verdict = judge.judge([skim], [ref])
    assert verdict["correct"], verdict["numbers"]
    assert skim.n_passed == int(ref.mask.sum()) > len(edges)
    assert set(skim.blobs) == set(ref.output()[2])
    assert {"Photon_pt", "IsoTrack_pt", "nPhoton", "nIsoTrack"} <= set(skim.blobs)


@pytest.mark.parametrize("device_batch, fused_backend",
                         [(None, None), (None, "torch"), (16, None), (16, "torch")])
def test_port_matches_the_reference_on_the_full_width_file(device_batch, fused_backend):
    _held_to_the_reference("cpu", device_batch, fused_backend)


@pytest.mark.cuda
@pytest.mark.parametrize("device_batch", [None, 16])
def test_cuda_port_matches_the_reference_on_the_full_width_file(device_batch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels run only there")
    _held_to_the_reference(torch.device("cuda", 0), device_batch)


# -- the slot counters ------------------------------------------------------

# two windows of 8 events; Jet counts 0..7 in the first, up to 3 in the second
COUNTS = np.array([0, 1, 2, 3, 4, 5, 6, 7, 1, 1, 2, 2, 3, 3, 0, 0], np.int32)
SLOT_QUERY = {
    "branches": ["Jet_*", "run"],
    "selection": {"event": [
        {"type": "any", "branches": ["HLT_a"]},
        {"type": "ht", "collection": "Jet", "var": "pt", "op": ">", "value": 50.0},
    ]},
}


def _slot_store():
    n_obj = int(COUNTS.sum())
    cols = {"run": np.full(16, 1, np.int32), "PV_npvs": np.arange(16, dtype=np.int32),
            "HLT_a": np.ones(16, bool), "nJet": COUNTS,
            "Jet_pt": np.full(n_obj, 100.0, np.float32),
            "Jet_eta": np.zeros(n_obj, np.float32)}
    return EventStore.from_arrays(cols, jagged={"Jet_pt": "nJet", "Jet_eta": "nJet"},
                                  basket_events=8, device="cpu")


def _stages(tracer):
    """Each node's stage spans' attributes, one span a window or a batch."""
    out: dict = {}
    for sp in tracer.spans():
        if sp.kind == "cascade_stage":
            out.setdefault(sp.attrs["node"], []).append(sp.attrs)
    return out


def _slots(tracer):
    return {node: (sum(a["plane_slots"] for a in spans), sum(a["object_slots"] for a in spans))
            for node, spans in _stages(tracer).items()}


# (node) -> (plane_slots, object_slots), counted by hand: the trigger's
# planes hold one slot an event (K = 1); HT's hold K slots an event, K the
# window's largest Jet count rounded up to a power of two (8 and 4) per
# window, the batch's (8) on the batched route; every window padded to the
# kernel's 512-event tile; objects: one an event for the trigger, the Jet
# counts for HT (28 + 12)
PER_WINDOW = {"trigger": (2 * 512 * 1, 16), "ht": (512 * 8 + 512 * 4, 40)}
BATCHED = {"trigger": (2 * 512 * 1, 16), "ht": (2 * 512 * 8, 40)}


@pytest.mark.parametrize("device_batch, want", [(None, PER_WINDOW), (2, BATCHED)],
                         ids=["per-window", "batched"])
def test_stage_spans_count_the_padded_slots_by_hand(device_batch, want):
    tracer = Tracer()
    res = SkimEngine(_slot_store(), device_batch=device_batch, fused_backend="torch",
                     device="cpu").run(SLOT_QUERY, "near_data", tracer=tracer)
    assert res.n_passed == 13
    assert _slots(tracer) == want


def test_the_host_interpreter_lays_out_no_planes_and_the_plan_counts_branches():
    tracer = Tracer()
    SkimEngine(_slot_store(), device="cpu").run(SLOT_QUERY, "near_data", tracer=tracer)
    assert _slots(tracer) == {"trigger": (0, 0), "ht": (0, 0)}
    (plan,) = [sp for sp in tracer.spans() if sp.kind == "plan"]
    # the store's 6; the plan reads Jet_pt, Jet_eta, nJet, run and HLT_a
    assert plan.attrs == {"store_branches": 6, "matched_branches": 5}


@pytest.mark.parametrize("device_batch", [None, 2])
def test_a_tracer_without_detail_records_no_counters(device_batch):
    tracer = Tracer(detail=False)
    SkimEngine(_slot_store(), device_batch=device_batch, fused_backend="torch",
               device="cpu").run(SLOT_QUERY, "near_data", tracer=tracer)
    stages = _stages(tracer)
    assert set(stages) == {"trigger", "ht"}
    assert not any("plane_slots" in a or "object_slots" in a
                   for spans in stages.values() for a in spans)
    assert not any(sp.attrs for sp in tracer.spans() if sp.kind == "plan")


# -- the readers ------------------------------------------------------------

def _span(kind, t0, t1, **attrs):
    return SimpleNamespace(kind=kind, t0=t0, t1=t1, attrs=attrs)


def _ctx(*span_lists):
    return Context(cell={}, config={}, traffic={},
                   skims=[SimpleNamespace(spans=s) for s in span_lists])


SKIM_A = [_span("query", 0.0, 10.0),
          _span("cascade_stage", 1.0, 1.5, node="trigger", plane_slots=1024, object_slots=1024),
          _span("cascade_stage", 2.0, 4.0, node="ht", plane_slots=4096, object_slots=1024),
          _span("cascade_stage", 5.0, 5.25, node="ht", plane_slots=2048, object_slots=0)]
SKIM_B = [_span("query", 20.0, 24.0),
          _span("cascade_stage", 21.0, 22.0, node="ht", plane_slots=1000, object_slots=500),
          _span("cascade_stage", 22.0, 23.0, node="object", plane_slots=1000, object_slots=500)]


def test_ht_stage_seconds_a_skim():
    assert ht_stage_s_per_skim.read(_ctx(SKIM_A)) == pytest.approx(2.25)
    assert ht_stage_s_per_skim.read(_ctx(SKIM_A, SKIM_B)) == pytest.approx((2.25 + 1.0) / 2)
    no_ht = [sp for sp in SKIM_A if sp.attrs.get("node") != "ht"]
    assert ht_stage_s_per_skim.read(_ctx(no_ht)) is None
    assert ht_stage_s_per_skim.read(_ctx()) is None


def test_padded_slot_share_a_skim():
    # skim a: 1 - 2048 / 7168; skim b: 1 - 1000 / 2000
    assert padded_slot_share.read(_ctx(SKIM_A)) == pytest.approx(1 - 2048 / 7168)
    assert padded_slot_share.read(_ctx(SKIM_A, SKIM_B)) == pytest.approx(
        ((1 - 2048 / 7168) + 0.5) / 2)
    bare = [_span(sp.kind, sp.t0, sp.t1, node=sp.attrs.get("node")) for sp in SKIM_A]
    assert padded_slot_share.read(_ctx(bare)) is None
    assert padded_slot_share.read(_ctx()) is None
