#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py [--parent DIR]

``--parent`` names a copy of the parent commit's tree (``git archive
<parent> | tar -x -C DIR``): rows 1, 3, 4 and 6 are then also timed beside
its kernels and wrappers (phase 3c).  Phases, in order; the first failure stops the run with a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, then the build of every kernel from ``src/``, and
   the attention library's SASS (``cuobjdump``): its 16-bit routes must hold ``HGMMA``
   (wgmma) and its float32 route tf32 ``HMMA`` (mma.sync); ptxas's
   registers and spills of the attention, skim and predicate kernels, and,
   with ``--parent``, of the parent tree's skim and predicate kernels,
   built beside them as a timing baseline.
2. Kernels against their plain PyTorch versions, on the card:
   ``basket_decode`` bit for bit (same-shaped batches, mixed-kind rounds
   in one launch each, rounds of real blobs through
   ``ops.basket_decode_round``), ``skim_fused`` over every op and group
   kind and at E from 1 to 1,000,000 (the single-pass look-back over
   many tiles, one launch a call), ``cascade_stage`` and
   ``predicate_eval`` over every op and group kind (``cascade_stage``
   also through the public ``ops.cascade_stage_step``, the JAX package's
   form, on a dense batch of numpy and of card tensors, bit for bit
   against ``ref.cascade_stage_ref`` with one launch a call, and over
   staged windows only: K = 1/8/16/64, a short last tile,
   subsets of a batch staged, dead tiles, every copy mode, bit for bit;
   ``predicate_eval`` at ragged E, in every copy mode and at
   bench_kernels' E = 2^17 and 2^20), ``stream_compact`` bit for bit
   over every payload width (NaN payloads, -0.0, integers past 2^24),
   rows of a multiple of 16 bytes and not, buffers off 16-byte
   alignment, ``skim_fused_batch`` over every op and group kind, both
   skim kernels with payloads of 1, 2, 4 and 8 bytes (int32, float16,
   uint8, int64, bool) bit for bit, ``flash_attention`` at the JAX tests'
   shapes, at its edges (ragged S, a padded D, many heads) and past D =
   128 (136, 192, 256, Gemma-7B's layout), 3e-5 in float32, a few ulps in
   bf16 and float16, one launch a call; then the ``ops`` entries on numpy
   as the JAX package reads it (float64 as float32, int64 as int32, a
   float or int64 mask through int32) through the card, equal in type and
   bytes to the host's, the per-window skim's staged route among them;
   then ``predicate_eval``, ``cascade_stage``, ``skim_fused``,
   ``skim_fused_batch`` and ``stream_compact`` bit for bit on inputs with
   a tenth of every term plane NaN, +inf, -inf or -0.0
   (:func:`check_nonfinite_kernels`); then the four that evaluate the
   program on :func:`edge_window`'s events at float32 cut edges, against
   their plain versions and the host evaluator (:func:`check_edge_kernels`:
   equal but for MASS events within :data:`MASS_RESIDUE_N`), and on
   :func:`int_window`'s integer branches and non-bool ANY words with the
   planes' kinds, bit for bit (:func:`check_int_kernels`).
   Then each skim kernel's median time beside its plain version's and
   its bound, at the shapes the main path gives it (window 0's decode
   rounds and skim calls; the batch of the first 16 windows), with the
   host-to-host time of a whole decode round, of a window's skim and of a
   cascade stage step (the staged step the path calls, and the public
   form on the dense numpy batch); both skim kernels also at int32 and
   uint8 rows, and ``predicate_eval`` also at bench_kernels' shapes.
3. The main path: ``run_skim`` with every default on two 1,000,000-event
   stores — NanoAOD-like (98 branches) for the quickstart query and the
   Z->ee mass/ΔR/expression query, and the conditions-era store of
   ``benchmarks/bench_cascade.py`` for its HT query — each held against
   the port's own host runs of the same store, with one ``basket_decode``
   launch per decode round that sends a bitpack miss to the card and one
   ``skim_fused`` launch per window skim.  Then the batched cascade,
   ``run_skim(..., device_batch=16)``, on the same three, held against
   the staged reference, the per-window card run and the host batched
   run, with one page-locked host-to-device copy per stage step
   (:func:`count_uploads`); and the device busy share of each
   (``torch.profiler``).
   Then the ops entry points of the four kernels no skim calls, at full
   size, each with the launch counts set to 0 before it and read after:
   ``ops.predicate_eval`` on each window of each cell's first cascade
   stage over its first 16 windows, ``ops.fused_skim_batch`` on the same
   batches (equal per window to ``ops.fused_skim``),
   ``ops.stream_compact`` of eight float32 branches by the quickstart
   cell's 1,000,000-event survivor mask, and ``ops.flash_attention`` at
   StarCoder2-7B's head layout (1, 36, 2048, 128) and Gemma-7B's (1, 16,
   2048, 256) in float32, bf16 and float16;
   then their times, beside one PyTorch call each where there is one
   (and the kernels ``torch.profiler`` saw that call run);
   ``stream_compact`` also at bench_kernels' shapes, and step by step
   through its wrapper.
   Then phase 3d, the serving plane, on the NanoAOD-like store, each step
   with the launch counts set to 0 before it and read after: the shared
   scan (``SharedScanEngine``) of the tenants quickstart, Z->ee and
   quickstart, per window and with ``device_batch=16``, each tenant equal
   in survivors and output bytes to its solo card run of phase 3, the
   shared and per-tenant ledgers equal to the port's host run of the same
   shared scan, with one ``basket_decode`` launch per decode round that
   sends a bitpack miss to the card, one ``skim_fused`` launch per window
   skim and one page-locked upload per stage step; the job service
   (three tenants batched, columns equal to the solo runs, a job
   cancelled after its first window keeping a prefix, the Chrome trace's
   span kinds, a journaled service stopped and recovered streaming the
   same partials); the cluster (4 nodes with replicas, serially and from
   pool threads, a failed node served by its replica, then the same with
   ``device_batch=16`` nodes, and a job through ``ClusterBackend``).
   Then phase 3e, the mesh skim (``neardata.sharded_skim``) on the whole
   NanoAOD-like store, padded at the K that truncates no object, for the
   quickstart and Z->ee queries: (a) NCCL at world size 1, mesh (1, 1, 1)
   (``pod``, ``data``, ``model``), the group started from a ``HashStore``:
   the total equals phase 3's survivors, the mask and the packed rows equal
   the plain versions on the same tensors bit for bit, one
   ``predicate_eval`` and one ``stream_compact`` launch a call; then the
   step's host-to-host time, each kernel's device time beside its bound
   and the ``all_reduce``'s time; (b) four ranks on the one card over gloo
   (NCCL takes one rank a card), mesh (2, 2, 1), spawned and met through a
   ``FileStore``, each mapping (a)'s saved arrays and reading only its
   block: each block equals the plain compaction of its slice of (a)'s
   mask, each total (a)'s, one launch of each kernel a rank.
   Then phase 3f, the five examples (``repro_torch.examples``), each run
   in this process at its default size on the card and with ``--device
   cpu``: every printed line but the device line equal once the
   wall-clock values (``examples.CLOCK_FIELDS``) are masked,
   ``basket_decode`` and ``skim_fused`` launched on the card (counted from
   0 around each run, ``build_cluster``'s decode launches apart), none by
   the host run; then the paper's four placements from ``skim_service``'s
   table, each mode's ``Breakdown`` total and ``busy_fraction`` at 1, 10
   and 100 Gb/s (modeled links), card and host.
   With ``--parent``, phase 3c also times ``skim_fused``,
   ``cascade_stage``, ``predicate_eval`` and ``skim_fused_batch`` beside
   the parent tree's kernels and wrappers on the same cases, in turns
   (:func:`time_parent_ab`).
   Then phase 3g, non-finite values: the eight cases of
   :func:`nonfinite_window` through the CUDA skim against the host
   evaluator, then a 200,000-event NanoAOD-like store with 2% of every
   float branch NaN, +inf, -inf or -0.0 through ``run_skim`` on the card,
   per window and with ``device_batch=16``, decode on the card, for the
   skimlint corpus, three pair and expression queries, quickstart and
   Z->ee: each host run through the plain versions equal to the staged
   reference, each card run to the host run of its path, except MASS
   events within the residue (:data:`MASS_RESIDUE_N`; checked, logged).
   Then phase 3h, integer branches and ANY over non-bool words: a
   200,000-event NanoAOD-like store whose ``event`` is 1,234,567,890 plus a
   seeded permutation (:func:`make_int_stores`), through ``run_skim`` on
   the card per window and with ``device_batch=16``, decode on the card,
   for every query of :func:`int_queries`, each equal to the port's staged
   run in survivors and output bytes, the picks keeping their one event.
4. One JSON line listing each kernel (its launches those of every main
   path, the serving plane's, the mesh skim's, the examples', the
   non-finite store's and the int store's included),
   then the device line last.

It imports ``repro_torch`` and the query corpus of
``tools/skimlint/fixtures.py`` (plain data) only, never JAX or the JAX
package, needs one card, and exits non-zero without a result where there is no card or no
``src/repro_torch`` beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 and fp16 on the tensor cores, dense
N_EVENTS = 1_000_000

QUICKSTART_QUERY = {  # examples/quickstart.py
    "input": "events.skim",
    "output": "skimmed.skim",
    "branches": ["Electron_*", "Muon_*", "Jet_*", "MET_*", "HLT_*"],
    "selection": {
        "preselection": [{"branch": "nElectron", "op": ">=", "value": 1}],
        "object": [
            {
                "collection": "Electron",
                "cuts": [
                    {"var": "pt", "op": ">", "value": 20.0},
                    {"var": "eta", "op": "abs<", "value": 2.4},
                ],
                "min_count": 1,
            }
        ],
        "event": [
            {"type": "any", "branches": ["HLT_IsoMu24", "HLT_Ele32_WPTight_Gsf"]},
            {"type": "cut", "branch": "MET_pt", "op": ">", "value": 15.0},
        ],
    },
}


def zee_query(n_events: int) -> dict:
    """benchmarks/bench_expr.py: Z->ee mass window AND ΔR AND a run-range
    expression keeping ~10% of luminosity blocks."""
    lumi_cut = max((n_events // 1000) // 10, 1)
    return {
        "input": "bench.skim",
        "output": "bench_zee.skim",
        "branches": ["Electron_*", "Jet_pt", "MET_*", "run", "event",
                     "luminosityBlock"],
        "selection": {
            "event": [
                {"type": "mass", "collections": ["Electron", "Electron"],
                 "window": [80.0, 100.0]},
                {"type": "deltaR", "collections": ["Electron", "Jet"],
                 "op": ">", "value": 0.4},
                {"type": "expr", "expr": "2*luminosityBlock + 0.01*MET_pt",
                 "op": "<", "value": 2.0 * lumi_cut},
            ],
        },
    }


ERA_QUERY = {  # benchmarks/bench_cascade.py
    "input": "bench.skim",
    "output": "bench_cascade_out.skim",
    "branches": ["Electron_*", "MET_*", "event", "luminosityBlock"],
    "selection": {
        "preselection": [{"branch": "nElectron", "op": ">=", "value": 1}],
        "object": [
            {
                "collection": "Electron",
                "cuts": [
                    {"var": "pt", "op": ">", "value": 20.0},
                    {"var": "eta", "op": "abs<", "value": 2.4},
                    {"var": "mvaId", "op": ">=", "value": 0.5},
                ],
                "min_count": 1,
            }
        ],
        "event": [
            {
                # the heavy stage: ~25 tracks/event feed the HT sum
                "type": "ht", "collection": "Track", "var": "pt",
                "object_cuts": [{"var": "pt", "op": ">", "value": 1.0}],
                "op": ">", "value": 20.0,
            },
            {"type": "any", "branches": [
                "HLT_IsoMu24", "HLT_Ele32_WPTight_Gsf",
            ]},
            {"type": "cut", "branch": "MET_pt", "op": ">", "value": 10.0},
        ],
    },
}


def make_era_store(n_events: int, seed: int = 7, basket_events: int = 4096,
                   device=None):
    """benchmarks/bench_cascade.py's conditions-era store: window w is a
    good era iff w % 4 == 0; bad-era electrons have ``mvaId == (pt <= 20)``,
    so no object passes the ID+pt selection there while every basket's
    statistics stay undecidable.  ~25 tracks per event feed the HT stage."""
    import numpy as np

    from repro_torch.data.store import EventStore

    rng = np.random.default_rng(seed)
    era_good = (np.arange(n_events) // basket_events) % 4 == 0

    cols: dict = {}
    jagged: dict = {}

    n_el = rng.poisson(1.2, n_events).astype(np.int32)
    tot = int(n_el.sum())
    el_pt = (rng.exponential(25.0, tot) + 3.0).astype(np.float32)
    el_eta = rng.uniform(-2.5, 2.5, tot).astype(np.float32)
    obj_good = np.repeat(era_good, n_el)
    el_mva = np.where(obj_good, rng.random(tot) > 0.3, el_pt <= 20.0)
    cols["nElectron"] = n_el
    for name, arr in [("Electron_pt", el_pt), ("Electron_eta", el_eta),
                      ("Electron_mvaId", el_mva)]:
        cols[name] = arr
        jagged[name] = "nElectron"

    n_trk = rng.poisson(25.0, n_events).astype(np.int32)
    cols["nTrack"] = n_trk
    cols["Track_pt"] = (
        rng.exponential(5.0, int(n_trk.sum())) + 0.5
    ).astype(np.float32)
    jagged["Track_pt"] = "nTrack"

    cols["MET_pt"] = (rng.exponential(30.0, n_events) + 1.0).astype(np.float32)
    cols["MET_phi"] = rng.uniform(-np.pi, np.pi, n_events).astype(np.float32)
    cols["HLT_IsoMu24"] = rng.random(n_events) < 0.3
    cols["HLT_Ele32_WPTight_Gsf"] = rng.random(n_events) < 0.2
    cols["event"] = np.arange(n_events, dtype=np.int32)
    cols["luminosityBlock"] = (np.arange(n_events) // 1000).astype(np.int32)

    return EventStore.from_arrays(
        cols, jagged=jagged, basket_events=basket_events, codec="bitpack",
        device=device,
    )


# ---------------------------------------------------------------------------
# non-finite values (NaN, ±inf, -0.0): the stores and queries of phase 3g
# ---------------------------------------------------------------------------

NONFINITE_VALUES = (float("nan"), float("inf"), float("-inf"), -0.0)
NONFINITE_EVENTS = 200_000
NONFINITE_SHAPE = {"n_hlt": 8, "n_filler": 2}  # make_nanoaod_like's shape


def _event_query(*selections) -> dict:
    return {"branches": ["MET_pt"], "selection": {"event": list(selections)}}


# beyond the skimlint corpus: pairs with no object cuts whose leading
# objects a NaN pt moves (a same-collection mass and ΔR over jets), and
# expressions whose min / max meet two zeros of opposite sign
NONFINITE_EXTRA_QUERIES = {
    "mass-jets": _event_query({"type": "mass", "collections": ["Jet", "Jet"],
                               "window": [60.0, 120.0]}),
    "delta-r-jets": _event_query({"type": "deltaR", "collections": ["Jet", "Jet"],
                                  "op": "<", "value": 2.0}),
    "expr-signed-zero": _event_query(
        {"type": "expr", "expr": "MET_pt / min(MET_phi - MET_phi, Filler_000)",
         "op": ">", "value": 0.0},
        {"type": "expr", "expr": "MET_pt / max(Filler_001, MET_phi - MET_phi)",
         "op": ">", "value": 0.0}),
}


def nonfinite_queries(n_events: int) -> dict:
    """Phase 3g's queries by name: the skimlint corpus
    (``tools/skimlint/fixtures.py``, plain data), :data:`NONFINITE_EXTRA_QUERIES`,
    and the quickstart and Z->ee queries."""
    from tools.skimlint.fixtures import FIXTURE_QUERIES

    queries = {d["name"]: {k: v for k, v in d.items() if k != "name"}
               for d in FIXTURE_QUERIES}
    return queries | NONFINITE_EXTRA_QUERIES | {
        "quickstart": QUICKSTART_QUERY, "zee": zee_query(n_events)}


def nonfinite_columns(store, seed: int = 1, every: int = 50):
    """``store``'s columns read back, with ``len // every`` entries of each
    float branch set in turn to NaN, +inf, -inf and -0.0 (positions drawn
    without replacement from ``default_rng(seed)``, branch by branch in
    ``store.branches`` order).  Takes a store of either package; returns
    (columns, jagged) for ``EventStore.from_arrays``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    columns, jagged = {}, {}
    for name, br in store.branches.items():
        if br.jagged:
            values = np.array(store.read_jagged(name)[0])
            jagged[name] = br.counts_branch
        else:
            values = np.array(store.read_flat(name))
        if values.dtype.kind == "f":
            pos = rng.choice(len(values), len(values) // every, replace=False)
            values[pos] = np.resize(np.array(NONFINITE_VALUES, values.dtype), len(pos))
        columns[name] = values
    return columns, jagged


def make_nonfinite_stores(n_events: int) -> list:
    """``make_nanoaod_like(n_events, n_hlt=8, n_filler=2)`` through
    :func:`nonfinite_columns`, built again on the card and on the host."""
    from repro_torch.data.store import EventStore
    from repro_torch.data.synth import make_nanoaod_like

    base = make_nanoaod_like(n_events, **NONFINITE_SHAPE, device="cpu")
    columns, jagged = nonfinite_columns(base)
    return [EventStore.from_arrays(columns, jagged=jagged,
                                   basket_events=base.basket_events, device=d)
            for d in (None, "cpu")]


def nonfinite_window():
    """Eight events, each a case of the leading-object, HT and min / max
    rules on non-finite values, as (columns, jagged) for
    ``EventStore.from_arrays``: Electron and Jet objects (pt, eta, phi,
    mass) and the flat MET_pt, MET_phi, Filler_000 and Filler_001."""
    import numpy as np

    nan, inf = float("nan"), float("inf")
    electrons = [  # (pt, eta, phi, mass) per object, per event
        [(nan, 0.5, -1.0, 0.0), (30.0, -0.5, -2.0, 0.0), (50.0, 1.1, 0.4, 0.0)],
        [(nan, 0.2, 0.1, 0.0), (nan, -1.0, 2.5, 0.0)],  # every pt NaN
        [],  # no object
        [(-inf, 0.4, 0.3, 0.0), (25.0, 0.9, -1.2, 0.0)],  # a valid -inf pt
        [(-0.0, 1.5, 2.0, 0.0), (0.0, -1.5, -2.0, 0.0), (10.0, 0.0, 0.0, 0.0)],
        [(20.0, 0.1, 0.2, 0.0), (nan, 0.1, 0.2, 0.0), (20.0, -0.7, -0.3, 0.0)],
        [(35.0, inf, 1.0, 0.0)],  # an infinite eta
        [(15.0, 0.2, -0.6, 0.0), (60.0, -0.4, 2.9, 0.0)],
    ]
    jets = [
        [(40.0, 0.5, -1.0, 5.0)],
        [(nan, 0.0, 0.0, 5.0)],
        [],
        [(-inf, 1.0, 1.0, 5.0), (60.0, 0.2, 0.8, 6.0)],  # HT: -inf fails pt > 30
        [(inf, 0.2, 0.3, 5.0), (5.0, 0.1, 0.1, 5.0)],
        [(nan, 1.0, 1.0, 5.0), (45.0, 0.3, -2.0, 8.0), (45.0, -0.3, 2.0, 8.0)],
        [(10.0, 0.1, 0.2, 5.0), (nan, 0.0, 0.0, 5.0), (70.0, 1.2, -0.4, 4.0)],
        [(50.0, 0.6, 1.5, 9.0), (40.0, -0.6, -1.5, 7.0), (inf, 2.0, 0.0, 1.0)],
    ]
    columns = {
        "MET_pt": np.array([50, 60, 70, 80, 90, 100, 110, 120], np.float32),
        "MET_phi": np.array([0.1, nan, 0.3, inf, 0.5, -0.0, 0.7, 0.8], np.float32),
        "Filler_000": np.array([-0.0, 1.0, -0.0, -2.0, 0.0, -0.0, 3.0, -0.0],
                               np.float32),
        "Filler_001": np.array([0.0, -0.0, 2.0, -0.0, -1.0, 0.0, -0.0, 1.0],
                               np.float32),
    }
    jagged = {}
    for coll, objs in (("Electron", electrons), ("Jet", jets)):
        columns[f"n{coll}"] = np.array([len(o) for o in objs], np.int32)
        flat = np.array([x for o in objs for x in o], np.float32).reshape(-1, 4)
        for i, var in enumerate(("pt", "eta", "phi", "mass")):
            columns[f"{coll}_{var}"] = np.ascontiguousarray(flat[:, i])
            jagged[f"{coll}_{var}"] = f"n{coll}"
    return columns, jagged


# the queries :func:`nonfinite_window`'s events are run through
NONFINITE_WINDOW_QUERIES = {
    "delta-r": _event_query({"type": "deltaR", "collections": ["Electron", "Jet"],
                             "op": ">", "value": 0.4}),
    "delta-r-same": _event_query({"type": "deltaR", "collections": [
        "Electron", "Electron"], "op": ">", "value": 0.5}),
    "mass-same": _event_query({"type": "mass", "collections": [
        "Electron", "Electron"], "window": [0.0, 1000.0]}),
    "mass-jets": _event_query({"type": "mass", "collections": ["Jet", "Jet"],
                               "window": [0.0, 1000.0]}),
    "ht": _event_query({"type": "ht", "collection": "Jet", "var": "pt",
                        "object_cuts": [{"var": "pt", "op": ">", "value": 30.0}],
                        "op": ">", "value": 40.0}),
    "ht-eta": _event_query({"type": "ht", "collection": "Jet", "var": "pt",
                            "object_cuts": [{"var": "eta", "op": "abs<", "value": 1.0}],
                            "op": ">", "value": 40.0}),
    "count": {"branches": ["MET_pt"], "selection": {"object": [
        {"collection": "Electron", "min_count": 1, "cuts": [
            {"var": "pt", "op": ">", "value": 20.0},
            {"var": "eta", "op": "abs<", "value": 2.4}]}]}},
    "expr-signed-zero": NONFINITE_EXTRA_QUERIES["expr-signed-zero"],
}


# ---------------------------------------------------------------------------
# float32 cut edges: events a float32 evaluation of the group values decides
# otherwise than the host evaluator's float64 (ROADMAP C8)
# ---------------------------------------------------------------------------

EDGE_EVENTS = 64  # the edge window's events, edge and ordinary ones mixed
EDGE_BASKET = 16  # its basket size: four baskets

# the queries of the edge window, each with a cut float32 evaluation can
# decide otherwise: MASS at both ends, ΔR under < and >, HT against a cut
# float32 cannot hold, EXPR with sum() and with a constant float32 cannot
# hold; "object-cut" keeps an object float32 keeps and float64 would not
EDGE_QUERIES = {
    "mass-jets": _event_query({"type": "mass", "collections": ["Jet", "Jet"],
                               "window": [60.0, 120.0]}),
    "delta-r-lt": _event_query({"type": "deltaR", "collections": ["Electron", "Jet"],
                                "op": "<", "value": 0.4}),
    "delta-r-gt": _event_query({"type": "deltaR", "collections": ["Electron", "Jet"],
                                "op": ">", "value": 0.4}),
    "ht": _event_query({"type": "ht", "collection": "Jet", "var": "pt",
                        "object_cuts": [{"var": "pt", "op": ">", "value": 20.0}],
                        "op": ">", "value": 200.3}),
    "expr-sum": _event_query({"type": "expr", "expr": "MET_pt + 0.5*sum(Jet_pt)",
                              "op": ">", "value": 150.3}),
    "expr-const": _event_query({"type": "expr", "expr": "0.1*MET_pt", "op": ">",
                                "value": 3.3}),
    "object-cut": {"branches": ["MET_pt"], "selection": {"object": [
        {"collection": "Jet", "min_count": 1,
         "cuts": [{"var": "pt", "op": ">=", "value": 20.3}]}]}},
}


def _f32_mass(j1, j2):
    """The invariant mass of two (pt, eta, phi, mass) float32 tensors of
    objects, in float32 as the padded route's plain version computed it
    before float64 (PyTorch's CPU float32 functions)."""
    import torch

    def p4(pt, eta, phi, mass):
        ch = torch.cosh(eta)
        return (pt * torch.cos(phi), pt * torch.sin(phi), pt * torch.sinh(eta),
                torch.sqrt(mass * mass + pt * pt * ch * ch))

    (x1, y1, z1, e1), (x2, y2, z2, e2) = p4(*j1), p4(*j2)
    m2 = ((e1 + e2) * (e1 + e2) - (x1 + x2) * (x1 + x2) - (y1 + y2) * (y1 + y2)
          - (z1 + z2) * (z1 + z2))
    return torch.sqrt(torch.maximum(m2, torch.zeros_like(m2)))


def _f32_delta_r(eta1, phi1, eta2, phi2):
    """ΔR in float32 as the earlier plain version computed it."""
    import numpy as np
    import torch

    pi = torch.tensor(np.float32(np.pi))
    dphi = torch.remainder(phi1 - phi2 + pi, 2.0 * pi) - pi
    deta = eta1 - eta2
    return torch.sqrt(deta * deta + dphi * dphi)


def float32_edge_events(seed: int = 0) -> list:
    """Events at float32 cut edges, by a seeded search: for each case of
    :data:`EDGE_QUERIES`, up to two events each way (float64 keeps and
    float32 drops, and the other way round) whose decision the float32
    evaluation (:func:`_f32_mass`, :func:`_f32_delta_r`, float32 sums and
    constants) and the host's float64 formulas (``core.expr``) differ on.
    MASS's pairs are collinear jets at eta = phi = 0, where every cos, sin,
    sinh and cosh is exact, so the card's value is the host's too.  Returns
    [(query, kept by the host, {"met": (pt, phi), "electrons": [...],
    "jets": [...]})], each object (pt, eta, phi, mass) in float32."""
    import numpy as np
    import torch

    from repro_torch.core.expr import leading_delta_r, leading_pair_mass

    rng = np.random.default_rng(seed)
    f32 = np.float32
    n = 100_000
    found = []

    def take(query, keep64, keep32, build):
        for want in (True, False):
            idx = np.nonzero((keep64 == want) & (keep32 != want))[0][:2]
            found.extend((query, want, build(i)) for i in idx)

    def pairs(data_a, data_b, count_a, count_b):
        data = {"nA": count_a, "nB": count_b}
        data |= {f"A_{k}": v for k, v in data_a.items()}
        data |= {f"B_{k}": v for k, v in data_b.items()}
        return data

    # MASS: collinear jets, velocities matched so m ~ m1 + m2 at each end
    for lo_end, target in ((True, 60.0), (False, 120.0)):
        m1 = rng.uniform(0.3, 0.7, n) * target
        m2 = target - m1 + rng.uniform(-2e-3, 2e-3, n)
        pt1 = rng.uniform(150.0, 600.0, n)
        pt2 = pt1 * m2 / m1 * rng.uniform(0.98, 1.02, n)
        j1 = [x.astype(f32) for x in (pt1, np.zeros(n), np.zeros(n), m1)]
        j2 = [x.astype(f32) for x in (pt2, np.zeros(n), np.zeros(n), m2)]
        m32 = _f32_mass([torch.from_numpy(x) for x in j1],
                        [torch.from_numpy(x) for x in j2]).numpy()
        ones = np.ones(n, np.int64)
        m64, _ = leading_pair_mass(
            pairs(dict(zip(("pt", "eta", "phi", "mass"), j1)),
                  dict(zip(("pt", "eta", "phi", "mass"), j2)), ones, ones), "A", "B")
        if lo_end:
            keep64, keep32 = m64 >= target, m32 >= f32(target)
        else:
            keep64, keep32 = m64 <= target, m32 <= f32(target)
        take("mass-jets", keep64, keep32, lambda i, j1=j1, j2=j2: {
            "jets": [tuple(x[i] for x in j1), tuple(x[i] for x in j2)]})

    # ΔR: an electron and a jet 0.4 apart, to within 1e-6
    eta1 = rng.uniform(-2.0, 2.0, n).astype(f32)
    phi1 = rng.uniform(-np.pi, np.pi, n).astype(f32)
    theta = rng.uniform(0.0, 2.0 * np.pi, n)
    r = 0.4 + rng.uniform(-1e-6, 1e-6, n)
    eta2 = (eta1 + r * np.cos(theta)).astype(f32)
    phi2 = np.remainder(phi1 + r * np.sin(theta) + np.pi, 2.0 * np.pi) - np.pi
    phi2 = phi2.astype(f32)
    dr32 = _f32_delta_r(*(torch.from_numpy(x) for x in (eta1, phi1, eta2, phi2))).numpy()
    ones = np.ones(n, np.int64)
    dr64, _ = leading_delta_r(pairs({"pt": np.full(n, 30.0, f32), "eta": eta1, "phi": phi1},
                                    {"pt": np.full(n, 40.0, f32), "eta": eta2, "phi": phi2},
                                    ones, ones), "A", "B")

    def dr_event(i):
        return {"electrons": [(f32(30.0), eta1[i], phi1[i], f32(0.000511))],
                "jets": [(f32(40.0), eta2[i], phi2[i], f32(5.0))]}

    take("delta-r-lt", dr64 < 0.4, dr32 < f32(0.4), dr_event)
    take("delta-r-gt", dr64 > 0.4, dr32 > f32(0.4), dr_event)

    # HT: four jets passing pt > 20 whose pts sum to 200.3, to within 5e-5
    pts = rng.uniform(21.0, 55.0, (n, 4))
    pts[:, 3] = 200.3 - pts[:, :3].sum(axis=1) + rng.uniform(-5e-5, 5e-5, n)
    pts = pts.astype(f32)
    ht32 = ((pts[:, 0] + pts[:, 1]) + pts[:, 2]) + pts[:, 3]
    ht64 = ((pts[:, 0].astype(np.float64) + pts[:, 1]) + pts[:, 2]) + pts[:, 3]

    def jets_event(i, met=(f32(40.0), f32(0.5))):
        return {"met": met, "jets": [(p, f32(0.3 * k - 0.5), f32(k - 1.5), f32(5.0))
                                     for k, p in enumerate(pts[i])]}

    take("ht", ht64 > 200.3, ht32 > f32(200.3), jets_event)

    # EXPR with sum(): MET_pt + 0.5 * sum(Jet_pt) at 150.3, to within 2e-5
    pts = rng.uniform(20.0, 80.0, (n, 3)).astype(f32)
    s32 = (pts[:, 0] + pts[:, 1]) + pts[:, 2]
    s64 = (pts[:, 0].astype(np.float64) + pts[:, 1]) + pts[:, 2]
    met = (150.3 - 0.5 * s64 + rng.uniform(-2e-5, 2e-5, n)).astype(f32)
    take("expr-sum", met.astype(np.float64) + 0.5 * s64 > 150.3,
         met + f32(0.5) * s32 > f32(150.3),
         lambda i: jets_event(i, (met[i], f32(0.5))))

    # EXPR with a constant: 0.1 * MET_pt at 3.3
    met = (33.0 + rng.uniform(-1e-5, 1e-5, n)).astype(f32)
    take("expr-const", 0.1 * met.astype(np.float64) > 3.3, f32(0.1) * met > f32(3.3),
         lambda i: {"met": (met[i], f32(-0.5))})

    # a jet of pt float32(20.3), which pt >= 20.3 keeps in float32 and not in
    # float64
    found.append(("object-cut", True, {"jets": [(f32(20.3), f32(0.0), f32(1.0), f32(5.0))]}))
    return found


def edge_window(seed: int = 0):
    """:data:`EDGE_EVENTS` events, :func:`float32_edge_events` among ordinary ones
    at seeded positions, as (columns, jagged, edges) for
    ``EventStore.from_arrays`` (Electron and Jet objects, MET_pt and
    MET_phi); ``edges`` maps each query of :data:`EDGE_QUERIES` to its
    edge events' [(index, kept by the host evaluator)]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = np.float32
    cases = float32_edge_events(seed)
    slots = rng.permutation(EDGE_EVENTS)[: len(cases)]
    events = []
    for _ in range(EDGE_EVENTS):
        objs = {c: [(f32(rng.uniform(5, 100)), f32(rng.uniform(-2.5, 2.5)),
                     f32(rng.uniform(-np.pi, np.pi)), f32(m))
                    for _ in range(rng.integers(0, n_max + 1))]
                for c, n_max, m in (("electrons", 2, 0.000511), ("jets", 4, 6.0))}
        events.append({"met": (f32(rng.uniform(10, 100)), f32(rng.uniform(-3, 3))),
                       **objs})
    edges = {q: [] for q in EDGE_QUERIES}
    for slot, (query, kept, event) in zip(slots.tolist(), cases):
        events[slot] = {"met": (f32(50.0), f32(0.5)), "electrons": [], "jets": [],
                        **event}
        edges[query].append((slot, kept))
    columns = {"MET_pt": np.array([e["met"][0] for e in events], f32),
               "MET_phi": np.array([e["met"][1] for e in events], f32)}
    jagged = {}
    for coll, key in (("Electron", "electrons"), ("Jet", "jets")):
        columns[f"n{coll}"] = np.array([len(e[key]) for e in events], np.int32)
        flat = np.array([x for e in events for o in e[key] for x in o], f32).reshape(-1, 4)
        for i, var in enumerate(("pt", "eta", "phi", "mass")):
            columns[f"{coll}_{var}"] = np.ascontiguousarray(flat[:, i])
            jagged[f"{coll}_{var}"] = f"n{coll}"
    return columns, jagged, edges


# ---------------------------------------------------------------------------
# integer branches and ANY over non-bool branches: events float32 planes and
# ANY's compiled ">= 0.5" decide otherwise than the staged evaluator (ROADMAP
# C9)
# ---------------------------------------------------------------------------

INT_EVENTS = 64  # the int window's events
INT_BASKET = 16  # its basket size: four baskets
INT_BASE = 123_456_789  # the window's event numbers in NanoAOD's range start here
INT_ID = 1 << 24  # Jet_id lies in [2^24 - 20, 2^24 + 20], float32's first gap
INT_HLT_I = (-3, -1, 0, 0, 1, 2)  # the int32 trigger word's values
INT_HLT_F = (-1.0, -0.0, 0.0, 0.3, 1.0, float("nan"))  # the float32 one's
INT_STORE_BASE = 1_234_567_890  # phase 3h's first event number
INT_STORE_EVENTS = 200_000


def int_queries(base: int, n_base: int) -> dict:
    """The integer and ANY queries over a store whose events include the
    numbers ``base + [0, n_base)`` and the branches of :func:`int_columns`:
    picks by ``event`` (alone and with ``run`` and ``luminosityBlock``),
    cuts above and below it and an expression of it, ``abs<`` / ``abs>`` on
    an int32 word across -2^31, an int32 object id beside 2^24 as a COUNT
    cut, an HT object cut, an HT weight and a ``sum()``, and ANY over an
    int32 and a float32 word, and over an absent branch and the float32
    one.  Float32 rounds every such number but the ANY branches, and ANY's
    compiled ``>= 0.5`` fails -3, -1, 0.3 and NaN, which are true."""
    out = ["MET_pt", "event"]

    def presel(*cuts):
        return {"branches": out, "selection": {"preselection": [
            {"branch": b, "op": op, "value": v} for b, op, v in cuts]}}

    def event(*sel):
        return {"branches": out, "selection": {"event": list(sel)}}

    def jets(*cuts):
        return {"branches": out, "selection": {"object": [
            {"collection": "Jet", "min_count": 1,
             "cuts": [{"var": v, "op": op, "value": x} for v, op, x in cuts]}]}}

    return {
        "event-pick": presel(("event", "==", base + n_base // 2 + 1)),
        "event-gt": presel(("event", ">", base + n_base - n_base // 8 - 0.5)),
        "event-expr": event({"type": "expr", "expr": f"event - {base}", "op": "<",
                             "value": 3}),
        "run-lumi-event": presel(("run", "==", 362104),
                                 ("luminosityBlock", "==", (base + 5) // 100),
                                 ("event", "==", base + 5)),
        "abs-lt": presel(("Word_i32", "abs<", 2147483647.0)),
        "abs-gt": presel(("Word_i32", "abs>", 2147483646.5)),
        "jet-id": jets(("id", "==", INT_ID + 1)),
        "ht-id-cut": event({"type": "ht", "collection": "Jet", "var": "pt",
                            "object_cuts": [{"var": "id", "op": ">", "value": INT_ID + 0.5}],
                            "op": ">", "value": 10.0}),
        "ht-of-id": event({"type": "ht", "collection": "Jet", "var": "id", "op": ">",
                           "value": 2 * INT_ID + 0.5}),
        "expr-sum-id": event({"type": "expr", "expr": f"sum(Jet_id) - {2 * INT_ID}",
                              "op": ">", "value": 0.5}),
        "any-nonbool": event({"type": "any", "branches": ["HLT_i", "HLT_f"]}),
        "any-absent": event({"type": "any", "branches": ["HLT_absent", "HLT_f"]}),
    }


# the int window's queries (its events include INT_BASE + [0, 32))
INT_QUERIES = int_queries(INT_BASE, INT_EVENTS // 2)


def int_columns(rng, n: int, n_jets: int) -> dict:
    """The integer and trigger-word branches :func:`int_queries` reads
    beyond ``event``, ``run`` and ``luminosityBlock``: ``Word_i32`` (int32,
    uniform, with -2^31, -2^31 + 1, 2^31 - 1 and 0 among the first 16
    events: one basket, which the zone map cannot accept whole), ``HLT_i``
    (int32 of :data:`INT_HLT_I`), ``HLT_f`` (float32 of :data:`INT_HLT_F`)
    and ``Jet_id`` (``n_jets`` int32 in [2^24 - 20, 2^24 + 20])."""
    import numpy as np

    word = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    word[rng.permutation(min(n, 16))[:4]] = [-(1 << 31), -(1 << 31) + 1, (1 << 31) - 1, 0]
    return {
        "Word_i32": word,
        "HLT_i": rng.choice(np.array(INT_HLT_I, np.int32), n),
        "HLT_f": rng.choice(np.array(INT_HLT_F, np.float32), n),
        "Jet_id": rng.integers(INT_ID - 20, INT_ID + 21, n_jets).astype(np.int32),
    }


def int_window(seed: int = 0):
    """:data:`INT_EVENTS` events as (columns, jagged) for
    ``EventStore.from_arrays``: ``event`` a seeded permutation of
    2^24 - 16 + [0, 32) and :data:`INT_BASE` + [0, 32), ``luminosityBlock``
    ``event // 100``, ``run`` 362104, ``MET_pt``, Jets (0-3 an event; pt
    float32, id int32), and :func:`int_columns`, the first two events of two
    jets given the ids (2^24 + 1, 2^24) and (2^24 + 1, 2^24 + 1), whose
    sums float32 rounds to 2^25."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, half = INT_EVENTS, INT_EVENTS // 2
    event = rng.permutation(np.concatenate(
        [INT_ID - half // 2 + np.arange(half), INT_BASE + np.arange(half)])).astype(np.int32)
    n_jet = rng.integers(0, 4, n).astype(np.int32)
    columns = {
        "MET_pt": rng.uniform(0, 100, n).astype(np.float32),
        "run": np.full(n, 362104, np.int32),
        "event": event,
        "luminosityBlock": event // 100,
        "nJet": n_jet,
        "Jet_pt": rng.uniform(5, 100, int(n_jet.sum())).astype(np.float32),
    }
    columns.update(int_columns(rng, n, int(n_jet.sum())))
    first = np.cumsum(n_jet) - n_jet  # each event's first jet
    for e, ids in zip(np.flatnonzero(n_jet == 2), ((INT_ID + 1, INT_ID),
                                                   (INT_ID + 1, INT_ID + 1))):
        columns["Jet_id"][first[e]:first[e] + 2] = ids
    return columns, {"Jet_pt": "nJet", "Jet_id": "nJet"}


def make_int_stores(n_events: int = INT_STORE_EVENTS, seed: int = 3) -> list:
    """Phase 3h's store, built on the card and on the host:
    ``make_nanoaod_like(n_events, n_hlt=8, n_filler=2)`` with ``event``
    :data:`INT_STORE_BASE` plus a seeded permutation of [0, n_events),
    ``luminosityBlock`` ``event // 100``, and :func:`int_columns` (its
    ``Jet_id`` over the store's jets)."""
    import numpy as np

    from repro_torch.data.store import EventStore
    from repro_torch.data.synth import make_nanoaod_like

    base = make_nanoaod_like(n_events, **NONFINITE_SHAPE, device="cpu")
    columns, jagged = {}, {}
    for name, br in base.branches.items():
        if br.jagged:
            columns[name] = np.array(base.read_jagged(name)[0])
            jagged[name] = br.counts_branch
        else:
            columns[name] = np.array(base.read_flat(name))
    rng = np.random.default_rng(seed)
    columns["event"] = (INT_STORE_BASE + rng.permutation(n_events)).astype(np.int32)
    columns["luminosityBlock"] = columns["event"] // 100
    columns.update(int_columns(rng, n_events, int(columns["nJet"].sum())))
    jagged["Jet_id"] = "nJet"
    return [EventStore.from_arrays(columns, jagged=jagged,
                                   basket_events=base.basket_events, device=d)
            for d in (None, "cpu")]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def stream_ms(fn, calls: int = 50) -> float:
    """Time per call of ``calls`` calls back to back between two CUDA
    events: the stream's view, so it holds the kernels and any gap the
    host leaves between them."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def host_ms(fn, calls: int = 200) -> float:
    """Host time per call of ``calls`` calls of a function that returns its
    results on the host (it waits for its own work)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e3


def device_ms(fn, calls: int = 20, reps: int = 7) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    the graph replayed between two CUDA events, the median of ``reps``
    replays over ``calls``.  No host work lies between the launches."""
    import torch

    fn()  # builds, loads and uploads what the wrapper caches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def bound_times(nbytes: float, ops: float,
                ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, float]:
    """(ms to move ``nbytes`` at the card's memory rate, ms to do ``ops``
    operations at ``ops_per_s``: by default its float32 rate outside the
    tensor cores)."""
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3


def attention_ops_ms(ops: float, half: bool) -> float:
    """The least time for ``ops`` operations of attention.  ``half`` (bf16
    or float16): the tensor cores' 16-bit rate, the same for both.
    float32: the lesser of the two ways to a float32-exact product, the
    CUDA cores at their float32 rate and split TF32 on the tensor cores
    (three TF32 products per product at the TF32 rate), which is the
    lesser: 3 / 495 < 1 / 67."""
    if half:
        return ops / BF16_OPS_PER_S * 1e3
    return min(ops / FP32_OPS_PER_S, 3 * ops / TF32_OPS_PER_S) * 1e3


def profiled_kernels(fn) -> list[str] | str:
    """The names of the device kernels (not memsets) a call of ``fn`` ran,
    from ``torch.profiler``, or "not measured" where it saw none.  Some
    sessions see no device events at all: it tries three, with more calls
    each time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: a first call may set up what later calls reuse
    for calls in (1, 3, 10):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = sorted({ev.key for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CUDA
                        and not ev.key.startswith("Memset")})
        if names:
            return names
    return "not measured"


PTXAS_KERNELS = ("flash_attention", "skim_fused", "predicate_eval")


def start_ptxas_report():
    """Start ``nvcc -Xptxas -v`` on the sources of :data:`PTXAS_KERNELS`
    beside the builds (into libraries of their own that nothing loads):
    ptxas's report of each kernel's registers and spills, and of wgmma it
    serialises (warning C7515).  Returns [(kernel, process)]."""
    from repro_torch.kernels import _build

    _build.build_dir().mkdir(parents=True, exist_ok=True)
    return [(name, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build._CSRC),
         "-o", str(_build.build_dir() / f"{name}-ptxas-report.so"),
         str(_build._CSRC / _build.SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name in PTXAS_KERNELS]


def ptxas_entries(text: str) -> dict:
    """ptxas's ``-v`` report -> {entry function: its registers, shared
    memory and spill lines, joined}."""
    report, entry = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
        elif entry and ("registers" in ln or "spill" in ln):
            report[entry] = (report.get(entry, "") + " " + ln.split(":", 1)[-1].strip()).strip()
    return report


def finish_ptxas_report(procs) -> dict:
    """Wait for :func:`start_ptxas_report`; logs the registers and spills
    of each kernel and fails on a C7515 warning in the attention kernels
    (a wgmma issued where ptxas cannot pipeline it: the products run one at
    a time).  Returns {kernel: {entry function: report line}}."""
    from repro_torch.kernels import _build

    reports = {}
    for name, proc in procs:
        out, err = proc.communicate()
        source = _build.SOURCES[name]
        check(proc.returncode == 0, f"nvcc -Xptxas -v failed on {source}:\n{out}{err}")
        reports[name] = ptxas_entries(out + err)
        for entry, line in sorted(reports[name].items()):
            log(f"  ptxas {name} {entry}: {line}")
        if name == "flash_attention":
            serialised = [ln.strip() for ln in (out + err).splitlines() if "C7515" in ln]
            log(f"  {source}: {len(serialised)} C7515 warnings (serialised wgmma)")
            check(not serialised, f"ptxas serialised wgmma in {source}: "
                  + "; ".join(serialised))
    return reports


def check_tensor_core_sass() -> dict:
    """Counts, in the SASS of the attention library, the 16-bit routes' wgmma
    (``HGMMA``) and the float32 route's tf32 mma.sync (``HMMA`` ... ``TF32``);
    fails if either is 0 or ``cuobjdump`` is missing."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    check(Path(tool).exists(), "cuobjdump not found: the tensor-core check cannot run")
    lib = _build.lib_path("flash_attention")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120)
    check(sass.returncode == 0, f"cuobjdump -sass {lib.name} failed: {sass.stderr.strip()}")
    lines = sass.stdout.splitlines()
    counts = {"HGMMA": sum("HGMMA" in ln for ln in lines),
              "HMMA_TF32": sum("HMMA" in ln and "TF32" in ln for ln in lines)}
    log(f"  flash_attention SASS: {counts['HGMMA']} HGMMA (16-bit routes, wgmma), "
        f"{counts['HMMA_TF32']} tf32 HMMA (float32 route, mma.sync)")
    check(counts["HGMMA"] > 0, "flash_attention: no HGMMA in the 16-bit routes' SASS")
    check(counts["HMMA_TF32"] > 0, "flash_attention: no tf32 HMMA in the float32 route's SASS")
    return counts


# ---------------------------------------------------------------------------
# phase 2a: basket_decode against its plain version
# ---------------------------------------------------------------------------


def bit_err(got, want) -> float:
    """Largest |got - want| over the values' bit patterns, each read as an
    integer of the value's own width (0.0 when they are bit-identical;
    NaN payloads and -0.0 compare by their bits)."""
    import numpy as np
    import torch

    if isinstance(got, np.ndarray):
        got, want = torch.from_numpy(got), torch.from_numpy(want)
    if got.numel() == 0:
        return 0.0
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    g = got.view(as_int[got.element_size()]).double()
    w = want.view(as_int[want.element_size()]).double()
    return float((g - w).abs().max())


# the output types each kind is decoded to: the store's (int32, bool,
# float32), the narrower integers the kernel stores itself, and the wider
# types it widens to after the launch
DECODE_OUT_DTYPES = {
    0: ("int32", "int16", "int8", "int64"),
    1: ("float32", "float64"),
    2: ("bool", "int32"),
}


def check_basket_decode(rng, device) -> float:
    """The kernel against its plain version, bit for bit.  Returns the
    largest :func:`bit_err` seen."""
    import numpy as np
    import torch

    from repro_torch.data.codecs import bitpack_encode, bitpack_raw_parts
    from repro_torch.kernels import basket_decode as bd
    from repro_torch.kernels import ops, ref

    cases = 0
    max_err = 0.0
    # (a) random plane words: every kind, widths 1..32, ragged n, every
    # output width
    for kind in (0, 1, 2):
        for n in (1, 31, 4095, 4096, 4097):
            W = -(-n // 32)
            widths = [1] * 3 if kind == 2 else rng.integers(1, 33, 3).tolist()
            B = max(widths)
            planes = np.zeros((3, B, W), np.uint32)
            for i, w in enumerate(widths):
                planes[i, :w] = rng.integers(0, 1 << 32, (w, W), dtype=np.uint64)
            firsts = rng.integers(0, 1 << 32, 3, dtype=np.uint64).astype(np.uint32)
            p_t = torch.from_numpy(planes.view(np.int32)).to(device)
            f_t = torch.from_numpy(firsts.view(np.int32)).to(device)
            for name in DECODE_OUT_DTYPES[kind]:
                out_dtype = getattr(torch, name)
                got = bd.basket_decode(p_t, f_t, kind=kind, n_bits=B,
                                       out_dtype=out_dtype)
                want = ref.basket_decode_ref(p_t, f_t, kind, W * 32, out_dtype)
                torch.cuda.synchronize()
                check(got.dtype == out_dtype,
                      f"basket_decode kind={kind} gave {got.dtype}, not {out_dtype}")
                err = bit_err(got[:, :n], want[:, :n])
                max_err = max(max_err, err)
                check(err == 0.0,
                      f"basket_decode kind={kind} n={n} widths={widths} {name}: "
                      f"values differ from the plain version (max |bits| {err})")
                cases += 1
    # (b) the codec round trip: ints whose uint32 prefix sum wraps (deltas
    # stay inside int32, the codec's domain), -0.0 and NaN payloads
    arrays = [
        np.array([-5, 10, -(1 << 30), (1 << 30) - 1, 0, -1] * 700, np.int32),
        rng.integers(-(1 << 30), 1 << 30, 4097).astype(np.int32),
        np.array([0x80000000, 0x80000001, 0x80000000, 0x80000003] * 1024,
                 np.uint32).view(np.float32),  # -0.0 and negative denormals
        (np.uint32(0x7FC00000) | rng.integers(0, 1 << 16, 4096).astype(np.uint32)
         ).view(np.float32),  # NaN payloads
        rng.random(31) < 0.3,
        rng.random(4097) < 0.5,
    ]
    for arr in arrays:
        part = bitpack_raw_parts(bitpack_encode(arr))
        check(part["kind"] != 3, f"test array {arr.dtype} fell back to raw literals")
        (got,) = ops.basket_decode_batch([part], arr.dtype, device=device)
        check(got.dtype == arr.dtype and got.shape == arr.shape,
              f"basket_decode round trip of {arr.dtype} gave {got.dtype} {got.shape}")
        err = bit_err(got, arr)
        max_err = max(max_err, err)
        check(err == 0.0, f"basket_decode round trip of {arr.dtype} (kind "
              f"{part['kind']}) is not bit-identical (max |bits| {err})")
        cases += 1
    # (c) whole rounds: mixed kinds, widths and output types in one launch,
    # against the plain version of the round on the same staged layout
    for seed in range(4):
        baskets = random_round(rng, 24)
        layout = ops.plan_round(baskets)
        staged = torch.empty(layout["n_in"], dtype=torch.int32)
        ops.fill_round(staged.numpy(), layout)
        want = ref.basket_decode_round_ref(*ops.round_views(staged, layout),
                                           layout["out_bytes"])
        dev = staged.to(device)
        got = torch.zeros(layout["out_bytes"], dtype=torch.uint8, device=device)
        ops.reset_launch_counts()
        bd.decode_round(*ops.round_views(dev, layout), got)
        torch.cuda.synchronize()
        check(ops.launch_counts()["basket_decode"] == 1,
              "basket_decode: a round took more than one launch")
        got = got.cpu()
        for (p, _), (o, store) in zip(baskets, layout["stores"]):
            nb = p["n"] * store.itemsize
            err = bit_err(got[o: o + nb].view(store), want[o: o + nb].view(store))
            max_err = max(max_err, err)
            check(err == 0.0, f"basket_decode round {seed}: kind {p['kind']} "
                  f"n={p['n']} bits={p['bits']} -> {store} differs from the plain "
                  f"version (max |bits| {err})")
        cases += 1
    # (d) rounds of real blobs through ops.basket_decode_round, against the
    # host codec: several branches, every kind, raw literals, empty baskets
    blobs, dtypes, arrays = round_blobs(rng)
    for _ in range(2):
        ops.reset_launch_counts()
        got = ops.basket_decode_round(
            {name: [bitpack_raw_parts(b) for b in bs] for name, bs in blobs.items()},
            dtypes, device=device)
        check(ops.launch_counts()["basket_decode"] == 1,
              "ops.basket_decode_round took more than one launch")
        for name, arrs in arrays.items():
            for g, a in zip(got[name], arrs):
                check(g.dtype == a.dtype and g.tobytes() == a.tobytes(),
                      f"ops.basket_decode_round {name}: not the encoded values")
        cases += 1
    log(f"  basket_decode: {cases} cases bit-identical to the plain version "
        "(kinds 0/1/2, widths 0-32, n in 1/31/4095/4096/4097/10000, outputs "
        "int32/int16/int8/int64, float32/float64, bool; wrap-around, -0.0, "
        "NaN payloads; 4 mixed rounds of 24 baskets in one launch each; 2 rounds "
        f"of real blobs, raw literals and empty baskets among them); max |bits| "
        f"{max_err}")
    return max_err


def random_round(rng, n: int):
    """``n`` baskets for one decode round as (bitpack_raw_parts-style dict,
    torch output dtype): random kinds, plane words and firsts, widths 0, 1,
    31, 32 or any, value counts with ragged tails and one wider than the
    kernel's 4096-value chunk, every output type of
    :data:`DECODE_OUT_DTYPES`."""
    import numpy as np
    import torch

    out = []
    for i in range(n):
        kind = int(rng.integers(0, 3))
        size = int(rng.choice([1, 31, 32, 33, 4095, 4096, 4097, 10000]))
        W = -(-size // 32)
        bits = 1 if kind == 2 else int(rng.choice([0, 1, 31, 32, rng.integers(1, 33)]))
        planes = np.zeros((max(bits, 1), W), np.uint32)
        planes[:bits] = rng.integers(0, 1 << 32, (bits, W), dtype=np.uint64)
        names = DECODE_OUT_DTYPES[kind]
        out.append(({"kind": kind, "n": size, "bits": bits, "n_pad": W * 32,
                     "first": int(rng.integers(0, 1 << 32, dtype=np.uint64)),
                     "planes": planes.reshape(-1)},
                    getattr(torch, names[i % len(names)])))
    return out


def round_blobs(rng):
    """A fetch round of real blobs: ({branch: [blob, ...]}, {branch: dtype},
    {branch: [the encoded arrays]}), with int32, int16, bool, xor-coded and
    raw-literal float32 branches, empty and ragged baskets."""
    import numpy as np

    from repro_torch.data.codecs import bitpack_encode

    gens = {
        "nJet": lambda n: rng.integers(0, 9, n).astype(np.int32),
        "run_id": lambda n: rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32),
        "charge": lambda n: rng.choice(np.array([-1, 1], np.int16), n),
        "HLT_bit": lambda n: rng.random(n) < 0.3,
        "discrete": lambda n: rng.choice(np.array([1.0, 1.25, -0.0], np.float32), n),
        "smooth": lambda n: (rng.exponential(30, n) + 1).astype(np.float32),
    }
    blobs, dtypes, arrays = {}, {}, {}
    for name, gen in gens.items():
        arrs = [gen(n) for n in (4096, 0, 1, 4097, 300)]
        blobs[name] = [bitpack_encode(a) for a in arrs]
        dtypes[name] = arrs[0].dtype
        arrays[name] = arrs
    return blobs, dtypes, arrays


# ---------------------------------------------------------------------------
# phase 2a: skim_fused against its plain version
# ---------------------------------------------------------------------------


def sweep_programs():
    """(name, Program, collection per term) covering all 8 ops and all six
    group kinds."""
    from repro_torch.core.expr import (
        RPN_ABS, RPN_ADD, RPN_BRANCH, RPN_CONST, RPN_DIV, RPN_MAX, RPN_MIN,
        RPN_MUL, RPN_NEG, RPN_SUB, RPN_SUM,
    )
    from repro_torch.kernels.program import (
        GROUP_ANY, GROUP_COUNT, GROUP_DR, GROUP_EXPR, GROUP_HT, GROUP_MASS,
        OP_IDS, Group, Program,
    )

    O = OP_IDS
    kin = ("pt", "eta", "phi", "mass")
    progs = [
        ("count", Program(
            (Group(GROUP_COUNT, (0, 1), (O[">"], O["abs<"]), (20.0, 2.4)),
             Group(GROUP_COUNT, (2, 3), (O["<"], O["abs>"]), (60.0, 0.5),
                   min_count=2)),
            ("A_pt", "A_eta", "B_pt", "B_eta"), ("A", "B"), (None, None))),
        ("ht", Program(
            (Group(GROUP_HT, (0,), (O[">="],), (10.0,), cmp_op=O[">"],
                   cmp_thr=100.0),
             Group(GROUP_HT, (1,), (O["<="],), (50.0,), cmp_op=O["<="],
                   cmp_thr=80.0)),
            ("B_pt", "B_eta"), ("B", "B"), ("B_pt", "B_pt"))),
        ("any", Program(
            (Group(GROUP_ANY, (0, 1), (O[">="], O["=="]), (0.5, 1.0)),
             Group(GROUP_COUNT, (2,), (O["!="],), (3.0,))),
            ("F_t1", "F_t2", "F_n"), (None, None), (None, None))),
        ("mass_same", Program(
            (Group(GROUP_MASS, tuple(range(8)), (), (), cmp_thr=20.0,
                   cmp_thr2=60.0),),
            tuple(f"A_{v}" for v in kin) * 2, ("A",), (None,), ("A",))),
        ("mass_pair", Program(
            (Group(GROUP_MASS, tuple(range(8)), (), (), cmp_thr=15.0,
                   cmp_thr2=70.0),),
            tuple(f"A_{v}" for v in kin) + tuple(f"B_{v}" for v in kin),
            ("A",), (None,), ("B",))),
        ("dr_same", Program(
            (Group(GROUP_DR, tuple(range(6)), (), (), cmp_op=O[">"],
                   cmp_thr=1.5),),
            tuple(f"A_{v}" for v in kin[:3]) * 2, ("A",), (None,), ("A",))),
        ("dr_pair", Program(
            (Group(GROUP_DR, tuple(range(6)), (), (), cmp_op=O["<"],
                   cmp_thr=2.0),),
            tuple(f"A_{v}" for v in kin[:3]) + tuple(f"B_{v}" for v in kin[:3]),
            ("A",), (None,), ("B",))),
        ("expr", Program(
            (Group(GROUP_EXPR, (0, 1, 2), (), (), cmp_op=O["<"], cmp_thr=40.0,
                   rpn=((RPN_BRANCH, 0), (RPN_SUM, 1), (RPN_CONST, 0.5),
                        (RPN_MUL, None), (RPN_ADD, None), (RPN_BRANCH, 2),
                        (RPN_NEG, None), (RPN_ABS, None), (RPN_CONST, 3.0),
                        (RPN_ADD, None), (RPN_DIV, None), (RPN_BRANCH, 0),
                        (RPN_MIN, None), (RPN_CONST, 1.0), (RPN_MAX, None),
                        (RPN_CONST, 2.0), (RPN_SUB, None))),),
            ("F_x", "B_pt", "F_y"), (None,), (None,))),
        ("empty", Program(
            (Group(GROUP_COUNT, (0,), (O[">"],), (1e30,)),),
            ("A_pt",), ("A",), (None,))),
        ("full", Program(
            (Group(GROUP_ANY, (0,), (O[">="],), (float("-inf"),)),),
            ("F_x",), (None,), (None,))),
    ]
    return progs


def sweep_inputs(rng, program, E: int, K: int, D: int):
    """Physics-shaped padded inputs for ``program``: collections A and B
    with Poisson multiplicities, flat terms in slot 0 only."""
    import numpy as np

    from repro_torch.kernels.program import GROUP_DR, GROUP_MASS

    counts = {c: np.minimum(rng.poisson(2.0, E), K) for c in ("A", "B")}
    valid_of = {
        c: (np.arange(K)[None, :] < counts[c][:, None]).astype(np.float32)
        for c in counts
    }
    flat = np.zeros((E, K), np.float32)
    flat[:, 0] = 1.0

    def values(branch):
        var = branch.split("_", 1)[1]
        n = (E, K)
        if var == "pt":
            v = rng.exponential(25.0, n) + 3.0
        elif var == "eta":
            v = rng.uniform(-2.5, 2.5, n)
        elif var == "phi":
            v = rng.uniform(-np.pi, np.pi, n)
        elif var == "mass":
            v = np.abs(rng.normal(5.0, 3.0, n))
        elif var in ("t1", "t2"):
            v = (rng.random(n) < 0.3).astype(np.float64)
        elif var == "n":
            v = rng.integers(0, 6, n).astype(np.float64)
        else:
            v = rng.normal(10.0, 20.0, n)
        coll = branch.split("_", 1)[0]
        mask = valid_of[coll] if coll in valid_of else flat
        return (v * mask).astype(np.float32)

    T, G = program.n_terms, program.n_groups
    columns = {}  # a branch named twice (a same-collection pair) holds one column
    for b in program.term_branches:
        if b not in columns:
            columns[b] = values(b)
    terms = np.stack([columns[b] for b in program.term_branches])
    valid = np.zeros((G, E, K), np.float32)
    weights = np.zeros((G, E, K), np.float32)
    for g, grp in enumerate(program.groups):
        c1 = program.group_collections[g]
        if grp.kind in (GROUP_MASS, GROUP_DR):
            c2 = program.group_collections2[g]
            valid[g] = valid_of[c1] + 2.0 * valid_of[c2]
        elif c1 is not None:
            valid[g] = valid_of[c1]
        else:
            valid[g] = flat
        if program.group_weights[g] is not None:
            weights[g] = terms[grp.term_ids[0]]
    payload = rng.normal(size=(E, D)).astype(np.float32)
    payload[:, 0] = np.arange(E, dtype=np.float32)
    return terms, valid, weights, payload


# The card's MASS against the host's, at most: CUDA's double cos, sin, sinh
# (2 ulp) and cosh (1 ulp), the host's float64 ones taken at 2 ulp each,
# carried through core/expr.py's formula (PERF.md, "the MASS residue"):
# |m²(card) - m²(host)| <= 116 u (E1 + E2)², u = 2^-53, plus 2 u for the
# square root's rounding at the cut.  Every other group value is the
# host's bit for bit.
MASS_RESIDUE_N = 118


def mass_scale(program, g, terms, valid):
    """MASS group ``g`` by the plain version: (float64 mass, ok, (E1 +
    E2)², the scale its square is the difference of)."""
    from repro_torch.kernels import ref

    grp = program.groups[g]
    ids = grp.term_ids
    va, vb = ref._unpack_validity(valid[g])
    same = program.group_collections[g] == ref._coll2(program, g)
    i1, i2, ok = ref._pair_slots(terms[ids[0]], va, terms[ids[4]], vb, same)
    e1 = ref._p4(*(ref._sel(terms[i], i1) for i in ids[:4]))[3]
    e2 = ref._p4(*(ref._sel(terms[i], i2) for i in ids[4:]))[3]
    m, _ = ref.pair_group_value(program, g, terms, valid)
    return m, ok, (e1 + e2) * (e1 + e2)


def edge_events(program, terms, valid, events) -> bool:
    """True when every event of ``events`` has a MASS value whose square
    lies within :data:`MASS_RESIDUE_N` u (E1 + E2)² of a cut's square (the
    plain version's value): the only events the card may decide otherwise
    than the plain version and the host."""
    import numpy as np

    from repro_torch.kernels.program import GROUP_MASS

    near = np.zeros(len(events), bool)
    for g, grp in enumerate(program.groups):
        if grp.kind != GROUP_MASS:
            continue
        m, _, scale = (x.cpu().numpy()[events] for x in mass_scale(program, g, terms, valid))
        slack = MASS_RESIDUE_N * 2.0 ** -53 * scale
        for cut in (grp.cmp_thr, grp.cmp_thr2):
            near |= np.abs(m * m - cut * cut) <= slack
    return bool(near.all())


def packed_edges(what, program, t, v, got, count, want, want_count) -> int:
    """Events kept by one of two packed outputs (payload column 0 the
    event index) and not the other; fails unless there are some and every
    one lies within the MASS residue.  Returns how many."""
    import numpy as np

    E = got.shape[0]
    m_got = np.zeros(E, bool)
    m_got[got[: int(count), 0].long().cpu().numpy()] = True
    m_want = np.zeros(E, bool)
    m_want[want[: int(want_count), 0].long().cpu().numpy()] = True
    diff = np.nonzero(m_got != m_want)[0]
    check(len(diff) > 0 and edge_events(program, t, v, diff),
          f"{what}: kernel and plain version disagree ({int(count)} vs "
          f"{int(want_count)} survivors)")
    log(f"  {what}: {len(diff)} events differ within the MASS residue: "
        f"{diff[:8].tolist()}")
    return len(diff)


def check_skim_fused(rng, device) -> tuple[float, int]:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import skim_fused as sf

    cases = edge = 0
    max_err = 0.0
    for name, program in sweep_programs():
        for E in (512, 4096, 4608):
            for K in (1, 4, 16):
                for D in (1, 5):
                    host = sweep_inputs(rng, program, E, K, D)
                    t, v, w, p = (torch.from_numpy(x).to(device) for x in host)
                    got, count = sf.skim_fused(t, v, w, p, program)
                    want, want_count = ref.skim_fused_ref(t, v, w, p, program)
                    torch.cuda.synchronize()
                    cases += 1
                    max_err = max(max_err, float((got - want).abs().max()))
                    if int(count) == int(want_count) and torch.equal(
                        got.view(torch.int32), want.view(torch.int32)
                    ):
                        if name == "empty":
                            check(int(count) == 0, "empty mask: survivors found")
                        if name == "full":
                            check(int(count) == E, "full mask: events lost")
                        continue
                    edge += packed_edges(f"skim_fused {name} E={E} K={K} D={D}",
                                         program, t, v, got, count, want, want_count)
    log(f"  skim_fused: {cases} cases (all 8 ops, COUNT/HT/ANY/MASS/ΔR/EXPR, "
        f"E in 512/4096/4608, K in 1/4/16, D in 1/5, empty and full masks); "
        f"packed and count equal to the plain version except {edge} events "
        "within the MASS residue")
    max_err = max(max_err, check_skim_fused_sizes(rng, device))
    check_skim_payloads(rng, device, batch=False)
    return max_err, edge


SKIM_SIZES = (1, 300, 512, 4097, 65_536, 1_000_000)
# payload kinds beside float32: elements of 4, 2, 1, 8 and 1 bytes
SKIM_PAYLOAD_KINDS = ("int32", "float16", "uint8", "int64", "bool")


def check_skim_payloads(rng, device, batch: bool) -> int:
    """``skim_fused`` (``batch``: ``skim_fused_batch``, B = 3) over every
    sweep program, E in 512/4608, K = 4, D in 1/5, with payloads of each
    kind of :data:`SKIM_PAYLOAD_KINDS` (NaN payloads, -0.0 and integers
    past 2^24 among them): one launch a call, the count, and the packed
    rows in the payload's type, zero tail included, bit for bit the plain
    compaction's (``ref.stream_compact_ref``) by the same survivors.  The
    survivors are the kernel's on the same inputs with a float32
    event-index payload, held to the plain version's but for events within
    the MASS residue (as :func:`check_skim_fused`).  Returns the number
    of calls."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import skim_fused as sf

    B = 3 if batch else 1
    who = "skim_fused_batch" if batch else "skim_fused"
    cases = 0
    for name, program in sweep_programs():
        for E in (512, 4608):
            host = batch_sweep_inputs(rng, program, B, E, 4, 1)
            t, v, w, index = (torch.from_numpy(x).to(device) for x in host)

            def run(payload):
                if batch:
                    return sf.skim_fused_batch(t, v, w, payload, program)
                got, n = sf.skim_fused(t[0], v[0], w[0], payload[0], program)
                return got[None], n[None]

            got, counts = run(index)
            want, want_counts = ref.skim_fused_batch_ref(t, v, w, index, program)
            torch.cuda.synchronize()
            keep = torch.zeros((B, E), dtype=torch.bool, device=device)
            for b in range(B):
                n, wn = int(counts[b]), int(want_counts[b])
                if n != wn or not torch.equal(got[b].view(torch.int32),
                                              want[b].view(torch.int32)):
                    packed_edges(f"{who} {name} E={E} window {b}", program, t[b], v[b],
                                 got[b], n, want[b], wn)
                keep[b, got[b, :n, 0].long()] = True
            for D in (1, 5):
                for kind in SKIM_PAYLOAD_KINDS:
                    payload = compact_payload(rng, kind, B * E, D).view(B, E, D).to(device)
                    ops.reset_launch_counts()
                    packed, n = run(payload)
                    torch.cuda.synchronize()
                    what = f"{who} {name} E={E} D={D} {kind}"
                    check(ops.launch_counts()[who] == 1,
                          f"{what}: {ops.launch_counts()[who]} launches for one call")
                    check(packed.dtype == payload.dtype and packed.shape == payload.shape
                          and torch.equal(n, counts),
                          f"{what}: {packed.dtype} {tuple(packed.shape)}, counts "
                          f"{n.tolist()} vs {counts.tolist()}")
                    for b in range(B):
                        plain, _ = ref.stream_compact_ref(payload[b], keep[b])
                        check(bit_err(packed[b], plain) == 0.0,
                              f"{what} window {b}: rows differ from the plain compaction")
                    cases += 1
    log(f"  {who}: {cases} calls with payloads of "
        f"{'/'.join(SKIM_PAYLOAD_KINDS)} (1, 2, 4 and 8 bytes; every sweep program, "
        f"E in 512/4608, D in 1/5{', B = 3' if batch else ''}): one launch each, "
        "packed rows bit for bit and counts equal to the plain version")
    return cases


def check_numpy_entries(rng, device) -> int:
    """The ``ops`` entries on numpy, as the JAX package reads it, through
    the card against the same call with ``device="cpu"``: the output's
    type and bytes and the count.  ``ops.fused_skim`` (the staged route:
    one page-locked upload, one launch, one readback) and
    ``ops.skim_fused`` with payloads of float64 (read as float32), int64
    (read as int32), int32, float16, uint8 and bool; ``ops.fused_skim_batch``
    with float64 planes and int64 payloads; ``ops.stream_compact`` with an
    int64 payload and float32 and int64 masks (0.5 and 2^32 read as 0);
    ``ops.flash_attention`` on float64 (float32 out).  Each card call
    launches its kernel once.  Returns the number of calls."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    cpu = torch.device("cpu")
    cases = 0

    def same(what, entry, launched, call):
        nonlocal cases
        ops.reset_launch_counts()
        got = call(device)
        torch.cuda.synchronize()
        check(ops.launch_counts()[launched] == 1,
              f"{what}: {ops.launch_counts()[launched]} {launched} launches")
        want = call(cpu)
        got, want = (x if isinstance(x, (tuple, list)) else (x,) for x in (got, want))
        for g, w_ in zip(got, want):
            g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            w_ = w_.numpy() if isinstance(w_, torch.Tensor) else np.asarray(w_)
            check(g.dtype == w_.dtype and g.shape == w_.shape,
                  f"{what}: {g.dtype} {g.shape} on the card, {w_.dtype} {w_.shape} on "
                  "the host")
            if entry == "flash_attention":
                check(np.allclose(g, w_, rtol=FLASH_TOL["float32"][0],
                                  atol=FLASH_TOL["float32"][1]), f"{what}: values differ")
            else:
                check(g.tobytes() == w_.tobytes(), f"{what}: bytes differ")
        cases += 1

    program = dict(sweep_programs())["count"]
    t, v, w, _ = sweep_inputs(rng, program, 4608, 4, 1)
    kinds = {"float64": rng.normal(size=(4608, 3)),
             "int64": rng.integers(-(1 << 40), 1 << 40, (4608, 3)),
             "int32": rng.integers(-(1 << 30), 1 << 30, (4608, 3)).astype(np.int32),
             "float16": rng.normal(size=(4608, 3)).astype(np.float16),
             "uint8": rng.integers(0, 256, (4608, 3), dtype=np.uint8),
             "bool": rng.random((4608, 3)) < 0.5}
    for kind, payload in kinds.items():
        same(f"ops.fused_skim numpy {kind}", "fused_skim", "skim_fused",
             lambda dev, payload=payload: ops.fused_skim(t, v, w, payload, program,
                                                        device=dev))
        same(f"ops.skim_fused numpy {kind}", "skim_fused", "skim_fused",
             lambda dev, payload=payload: ops.skim_fused(t, v, w, payload, program,
                                                        device=dev))
    bt, bv, bw, _ = batch_sweep_inputs(rng, program, 3, 512, 4)
    big = rng.integers(-(1 << 40), 1 << 40, (3, 512, 2))
    same("ops.fused_skim_batch numpy float64 planes, int64 payload", "fused_skim_batch",
         "skim_fused_batch",
         lambda dev: ops.fused_skim_batch(bt.astype(np.float64), bv, bw, big, program,
                                          device=dev))
    payload = rng.integers(-(1 << 40), 1 << 40, (5000, 2))
    m32 = np.where(rng.random(5000) < 0.4, 2.7, 0.5).astype(np.float32)
    m64 = np.where(rng.random(5000) < 0.4, 3, 1 << 32).astype(np.int64)
    for what, mask in (("float32", m32), ("int64", m64)):
        same(f"ops.stream_compact numpy int64 payload, {what} mask", "stream_compact",
             "stream_compact",
             lambda dev, mask=mask: ops.stream_compact(payload, mask, device=dev))
    q, k, vv = (rng.normal(size=(1, 2, 200, 64)) for _ in range(3))
    same("ops.flash_attention numpy float64", "flash_attention", "flash_attention",
         lambda dev: ops.flash_attention(q, k, vv, device=dev))
    log(f"  ops entries on numpy: {cases} calls on the card equal to the host's in "
        "type and bytes (fused_skim staged and skim_fused with float64/int64/int32/"
        "float16/uint8/bool payloads, fused_skim_batch, stream_compact with float32 "
        "and int64 masks; flash_attention float64 -> float32 within 3e-5), one "
        "launch each")
    return cases


def check_skim_fused_sizes(rng, device, Es=SKIM_SIZES) -> float:
    """The single-pass compaction across many tiles and a ragged last tile:
    ``skim_fused`` at each E of ``Es`` (1,954 tiles of look-back at 10^6)
    equal to the plain version bit for bit, zero tail and count included,
    in one launch per call; twice per E, so the second call meets the
    first call's status words under an older epoch."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import skim_fused as sf

    progs = dict(sweep_programs())
    cases = 0
    for E in Es:
        for name in ("count", "ht", "full"):
            program = progs[name]
            host = sweep_inputs(rng, program, E, 4, 2)
            t, v, w, p = (torch.from_numpy(x).to(device) for x in host)
            want, want_count = ref.skim_fused_ref(t, v, w, p, program)
            for _ in range(2):
                ops.reset_launch_counts()
                got, count = sf.skim_fused(t, v, w, p, program)
                torch.cuda.synchronize()
                check(ops.launch_counts()["skim_fused"] == 1,
                      f"skim_fused E={E}: {ops.launch_counts()['skim_fused']} "
                      "launches for one call")
                check(int(count) == int(want_count) and torch.equal(
                    got.view(torch.int32), want.view(torch.int32)),
                    f"skim_fused {name} E={E}: {int(count)} survivors vs "
                    f"{int(want_count)}, or the packed rows or zero tail differ")
                cases += 1
            del t, v, w, p, got, want
    log(f"  skim_fused at E in {'/'.join(map(str, Es))} (count, ht, full; twice "
        f"each): {cases} calls, one launch each, packed rows, zero tail and "
        "count equal to the plain version bit for bit")
    return 0.0


# ---------------------------------------------------------------------------
# phase 2a: the batched predicate and the cascade stage
# ---------------------------------------------------------------------------


def batch_inputs(rng, program, B: int, E: int, K: int, basket_events: int):
    """A window-batch staged as ``run_window_batch`` stages it: sweep inputs
    per window, a random carried mask (window 1 all dead), and ``seg_ids``
    from window starts that are not aligned to a basket.  Returns numpy
    (terms, valid, weights, packed (B, E/32) int32, seg_ids (B, E) int32,
    nb)."""
    import numpy as np

    from repro_torch.kernels import ops

    per = [sweep_inputs(rng, program, E, K, 1)[:3] for _ in range(B)]
    terms, valid, weights = (np.stack([w[i] for w in per]) for i in range(3))
    alive = rng.random((B, E)) < 0.7
    alive[min(1, B - 1)] = False
    nb = E // basket_events + 2
    seg = np.zeros((B, E), np.int32)
    for b in range(B):
        start = int(rng.integers(0, 8 * basket_events))
        grid0 = start - start % basket_events
        ids = (start + np.arange(E, dtype=np.int64) - grid0) // basket_events
        seg[b] = np.clip(ids, 0, nb - 1)
    packed = ops.pack_mask(alive).view(np.int32)
    return terms, valid, weights, packed, seg, nb


def dense_batch(inputs):
    """The dense (Bn,T,E,K), (Bn,G,E,K), (Bn,G,E,K) numpy batch that the
    windows staged in ``inputs`` (``ops.CascadeInputs``) stand for: zeros
    in every row no window is staged to."""
    import numpy as np

    Bn, T, E, K = inputs.shape
    G = inputs.n_groups
    out = [np.zeros((Bn, n, E, K), np.float32) for n in (T, G, G)]
    for s, b in enumerate(inputs.rows):
        for dense, part in zip(out, inputs.window(s)):
            dense[b] = part
    return tuple(out)


def staged_batch(rng, program, B: int, E: int, K: int, basket_events: int, rows,
                 start: int = 0, keep=()):
    """A window-batch staged for one cascade stage as ``run_window_batch``
    stages it: :func:`batch_inputs`' windows, with only ``rows`` staged
    (``ops.CascadeInputs``, host memory) and every other row's mask words
    zero, as a window with no live event has, except the rows in ``keep``,
    which keep live words the stage must leave alone.  In every staged
    window the events before ``start`` are dead with zero planes (a live
    span that starts inside a mask word), and so are the events of one
    512-event run (tiles with no live event).  Returns (inputs, packed
    (B, E/32) int32, seg_ids (B, E) int32, nb)."""
    import numpy as np

    from repro_torch.kernels import ops

    terms, valid, weights, packed, seg, nb = batch_inputs(
        rng, program, B, E, K, basket_events)
    alive = ops.unpack_mask(packed, E)
    dead = np.zeros(E, bool)
    dead[:start] = True
    if E >= 2048:
        dead[1024:1536] = True
    for b in range(B):
        if b in rows:
            alive[b, dead] = False
        elif b not in keep:
            alive[b] = False
    inputs = ops.CascadeInputs(terms.shape, program.n_groups, rows)
    for s, b in enumerate(inputs.rows):
        for part, dense in zip(inputs.window(s), (terms, valid, weights)):
            part[...] = dense[b]
            part[:, dead] = 0.0
    return inputs, ops.pack_mask(alive).view(np.int32), seg, nb


def _mask_edges(program, t, v, got, want) -> int:
    """Events where two (B, E) masks differ; every one must lie within
    the MASS residue (checked), else the run fails."""
    import numpy as np

    diff = (got != want).cpu().numpy()
    n = 0
    for b in np.nonzero(diff.any(axis=1))[0]:
        events = np.nonzero(diff[b])[0]
        check(edge_events(program, t[b], v[b], events),
              f"{program.term_branches}: window {b} differs at events "
              f"{events[:8].tolist()}, outside the MASS residue")
        n += len(events)
    return n


def check_cascade_stage(rng, device, names=None) -> tuple[float, int]:
    """``cascade_stage`` against its plain version: the new mask (in place),
    the basket bits and the counts, over the sweep programs, B in 1/3/16,
    E in 512/4096.  Where the masks differ (only within the MASS residue),
    the kernel's basket bits and counts must be those of its own mask.
    Returns (max |kernel - plain| over mask bits, basket bits and counts;
    events that differ within the MASS residue)."""
    import torch

    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref

    cases = edge = 0
    max_err = 0.0
    for name, program in sweep_programs():
        if names and name not in names:
            continue
        for B in (1, 3, 16):
            for E, be in ((512, 128), (4096, 1024)):
                for K in (1, 8):
                    host = batch_inputs(rng, program, B, E, K, be)
                    t, v, w, packed, seg = (torch.from_numpy(x).to(device)
                                            for x in host[:5])
                    nb = host[5]
                    w_packed, *w_out = ref.cascade_stage_ref(
                        t, v, w, packed, seg, program, nb)
                    want = torch.cat([w_out[0], w_out[1][:, None]], dim=1)
                    got_packed, got = pe.cascade_stage(t, v, w, packed, seg, program, nb)
                    torch.cuda.synchronize()
                    check(got_packed.data_ptr() == packed.data_ptr(),
                          "cascade_stage did not update the carried mask in place")
                    m_got, m_want = ref.unpack_bits(got_packed, E), ref.unpack_bits(w_packed, E)
                    err = max(float((m_got.int() - m_want.int()).abs().max()),
                              float((got - want).abs().max()))
                    max_err = max(max_err, err)
                    cases += 1
                    if err == 0.0:
                        continue
                    n = _mask_edges(program, t, v, m_got, m_want)
                    check(n > 0, f"cascade_stage {name} B={B} E={E} K={K}: basket "
                          "bits or counts differ where the masks agree")
                    edge += n
                    # the kernel's basket bits and counts follow its own mask
                    own = torch.zeros((B, nb), dtype=torch.int32, device=device)
                    own.scatter_reduce_(1, seg.long(), m_got.int(), "amax")
                    check(torch.equal(got[:, :nb], own),
                          f"cascade_stage {name}: basket bits do not follow the mask")
                    check(torch.equal(got[:, nb], m_got.sum(dim=1, dtype=torch.int32)),
                          f"cascade_stage {name}: counts do not follow the mask")
                    log(f"  cascade_stage {name} B={B} E={E} K={K}: events "
                        "differ within the MASS residue")
    log(f"  cascade_stage: {cases} cases (all 8 ops, COUNT/HT/ANY/MASS/ΔR/EXPR, "
        "B in 1/3/16, E in 512/4096, K in 1/8, random carried masks with an "
        "all-dead window, unaligned window starts); mask, basket bits and "
        f"counts equal to the plain version except {edge} events within "
        f"the MASS residue; max |err| {max_err}")
    return max_err, edge


def check_cascade_stage_public(rng, device, names=None) -> float:
    """``ops.cascade_stage_step``, the JAX package's form, over a dense
    batch: every sweep program at B = 16, E = 4096, K in 1/8/16/64, given
    numpy (staged whole into one page-locked upload) and given tensors on
    the card.  The new mask words, basket bits and counts must equal
    ``ref.cascade_stage_ref``'s bit for bit, with one ``cascade_stage``
    launch a call.  Returns the max |err| over the three."""
    import torch

    from repro_torch.kernels import ops, ref

    cases = 0
    max_err = 0.0
    for name, program in sweep_programs():
        if names and name not in names:
            continue
        for K in (1, 8, 16, 64):
            host = batch_inputs(rng, program, 16, 4096, K, 1024)
            nb = host[5]
            t, v, w, packed, seg = (torch.from_numpy(x).to(device) for x in host[:5])
            want = ref.cascade_stage_ref(t, v, w, packed, seg, program, nb)
            for form, args in (("numpy", host[:5]),
                               ("card tensors", (t, v, w, packed.clone(), seg))):
                ops.reset_launch_counts()
                got = ops.cascade_stage_step(*args, program, nb, device=device)
                torch.cuda.synchronize()
                launched = ops.launch_counts()["cascade_stage"]
                check(launched == 1, f"cascade_stage_step ({form}) {name} K={K}: "
                      f"{launched} cascade_stage launches, not one")
                for part, g, wnt in zip(("mask words", "basket bits", "counts"),
                                        got, want):
                    err = float((g.long() - wnt.long()).abs().max())
                    max_err = max(max_err, err)
                    check(err == 0.0, f"cascade_stage_step ({form}) {name} K={K}: "
                          f"{part} differ from cascade_stage_ref by {err}")
                cases += 1
    log(f"  cascade_stage_step (the public form, a dense batch): {cases} calls "
        "(every sweep program, B = 16, E = 4096, K in 1/8/16/64, numpy and card "
        "tensors); mask words, basket bits and counts equal to cascade_stage_ref "
        f"bit for bit, one cascade_stage launch a call; max |err| {max_err}")
    return max_err


def check_cascade_stage_windows(rng, device, names=None) -> tuple[float, int]:
    """``cascade_stage_windows`` (the kernel over the staged windows only,
    as ``ops.cascade_stage_step_staged`` launches it) against its plain version,
    bit for bit: every sweep program at K in 1/8/16/64, E in 512/4000
    (4000: a short last tile), B in 1/5/16 with all, some, one or no
    windows staged, live spans that start inside a mask word, a run of
    tiles with no live event, and a row not staged whose live words must
    stay as they are; then a misaligned buffer (4-byte ``cp.async``) and a
    shape too large for shared memory (read from device memory).
    Returns (max |kernel - plain| over words and the (B, nb+1) buffer;
    events that differ within the MASS residue)."""
    import torch

    from repro_torch.kernels import predicate_eval as pe

    cases = edge = 0
    max_err = 0.0
    modes = set()

    def one(label, program, planes, rows, packed, seg, nb):
        nonlocal cases, edge, max_err
        want_p, want = pe.cascade_stage_windows_plain(
            planes, rows, packed.clone(), seg, program, nb)
        got_p = packed.clone()
        _, got = pe.cascade_stage_windows(planes, rows, got_p, seg, program, nb)
        torch.cuda.synchronize()
        E = seg.shape[1]
        err = max(float((got_p != want_p).any()), float((got - want).abs().max()))
        max_err = max(max_err, err)
        cases += 1
        if err:
            # only MASS events within the residue may differ; the kernel's
            # bits and counts then follow its own mask
            from repro_torch.kernels import ref

            m_got, m_want = ref.unpack_bits(got_p, E), ref.unpack_bits(want_p, E)
            dense = [torch.zeros((packed.shape[0], n, E, planes.shape[3]),
                                 device=device)
                     for n in (program.n_terms, program.n_groups)]
            dense[0][rows.long()] = planes[:, :program.n_terms]
            dense[1][rows.long()] = planes[:, program.n_terms:program.n_terms
                                           + program.n_groups]
            n = _mask_edges(program, dense[0], dense[1], m_got, m_want)
            check(n > 0, f"cascade_stage_windows {label}: bits or counts differ "
                  "where the masks agree")
            own = torch.zeros_like(got[:, :nb])
            own.scatter_reduce_(1, seg.long(), m_got.int(), "amax")
            check(torch.equal(got[:, :nb], own) and torch.equal(
                got[:, nb], m_got.sum(dim=1, dtype=torch.int32)),
                f"cascade_stage_windows {label}: bits or counts do not follow "
                "the kernel's own mask")
            edge += n

    for name, program in sweep_programs():
        if names and name not in names:
            continue
        for K in (1, 8, 16, 64):
            for B in (1, 5, 16):
                subsets = {"all": range(B), "none": ()}
                if B > 1:
                    subsets.update(some=range(0, B, 3), one=(B // 2,))
                for E in (512, 4000):
                    for subset, rows in subsets.items():
                        keep = (1,) if B > 1 and 1 not in rows else ()
                        inputs, packed, seg, nb = staged_batch(
                            rng, program, B, E, K, 1024, tuple(rows), start=37,
                            keep=keep)
                        planes, r = inputs.views(inputs.host.to(device))
                        one(f"{name} K={K} B={B} E={E} {subset}", program, planes,
                            r, torch.from_numpy(packed).to(device),
                            torch.from_numpy(seg).to(device), nb)
                        modes.add(pe.stage_plan(planes.shape[1], K,
                                                pe.event_lanes(program, K), True)[1])
        # a misaligned buffer: 4-byte cp.async; K = 512: device memory
        for K, shift in ((8, 1), (512, 0)):
            inputs, packed, seg, nb = staged_batch(rng, program, 3, 512, K, 128,
                                                   (0, 2), start=5)
            raw = torch.zeros(inputs.host.numel() + 4, dtype=torch.int32,
                              device=device)
            dev = raw[shift: shift + inputs.host.numel()]
            dev.copy_(inputs.host)
            planes, r = inputs.views(dev)
            aligned = planes.data_ptr() % 16 == 0
            modes.add(pe.stage_plan(planes.shape[1], K, pe.event_lanes(program, K),
                                    aligned)[1])
            one(f"{name} K={K} shift={shift}", program, planes, r,
                torch.from_numpy(packed).to(device), torch.from_numpy(seg).to(device),
                nb)
    check(modes == {pe.MODE_BULK, pe.MODE_ASYNC4, pe.MODE_DIRECT},
          f"cascade_stage_windows: copy modes {sorted(modes)} run, not all three")
    log(f"  cascade_stage_windows: {cases} cases (every sweep program, K in "
        "1/8/16/64, E in 512/4000, B in 1/5/16 with all/some/one/no windows "
        "staged, spans from event 37, a dead 512-event run, a live row not "
        "staged; bulk copies, 4-byte cp.async on a misaligned buffer, device "
        f"memory at K = 512); equal to the plain version except {edge} events "
        f"within the MASS residue; max |err| {max_err}")
    return max_err, edge


# (B, E, K, shift) of check_predicate_eval's dense batches: ragged E, the
# three copy modes (bulk where E*K % 4 == 0 and the buffer is aligned,
# 4-byte cp.async where E*K % 4 != 0 or the buffer is shifted by a float,
# device memory where a tile of the planes passes 200 KiB at K = 512)
PREDICATE_CASES = ((1, 1, 4, 0), (1, 300, 4, 0), (1, 4097, 4, 0), (3, 300, 4, 0),
                   (16, 4097, 4, 0), (2, 4097, 1, 0), (2, 301, 3, 0), (3, 1000, 8, 1),
                   (2, 40, 512, 0))
# benchmarks/bench_kernels.py's predicate benchmark: E = 2^17, K = 8, one
# COUNT group pt > 20 and |eta| < 2.4 (T = 2, G = 1); and the same at the
# 1,000,000-event store's scale
PREDICATE_BENCH_E = (1 << 17, 1 << 20)


def bench_predicate(rng, E: int, device):
    """bench_kernels.py's predicate program and inputs at E events, K = 8:
    (program, terms (2, E, 8), valid (1, E, 8), weights (1, E, 8))."""
    import numpy as np
    import torch

    from repro_torch.kernels.program import GROUP_COUNT, OP_IDS, Group, Program

    K = 8
    program = Program(
        (Group(GROUP_COUNT, (0, 1), (OP_IDS[">"], OP_IDS["abs<"]), (20.0, 2.4)),),
        ("pt", "eta"), ("X",), (None,))
    terms = rng.normal(20, 15, (2, E, K)).astype(np.float32)
    valid = (rng.random((1, E, K)) < 0.4).astype(np.float32)
    return program, *(torch.from_numpy(x).to(device)
                      for x in (terms, valid, np.zeros((1, E, K), np.float32)))


def shifted(x, shift: int):
    """A contiguous copy of ``x`` that starts ``shift`` elements into its
    allocation (so 4 * shift bytes off 16-byte alignment for float32)."""
    raw = x.new_empty(x.numel() + shift)
    out = raw[shift:].view(x.shape)
    out.copy_(x)
    return out


def check_predicate_eval(rng, device, names=None) -> tuple[float, int]:
    """``predicate_eval`` (one window) and ``predicate_eval_batch`` against
    the plain versions over every sweep program at
    :data:`PREDICATE_CASES` (ragged E; bulk copies, 4-byte cp.async on a
    misaligned plane stride or buffer, device memory), then
    bench_kernels' program at E = 2^17 and 2^20.  Fails unless all three
    copy modes ran."""
    import torch

    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref

    cases = edge = 0
    max_err = 0.0
    modes = set()

    def one(program, t, v, w):
        nonlocal cases, edge, max_err
        B, T, E, K = t.shape
        G = v.shape[1]
        modes.add(pe.mask_plan((t, v, w), (T * E * K, G * E * K), E, K, program)[1])
        if B == 1:
            got = pe.predicate_eval(t[0], v[0], w[0], program)[None]
        else:
            got = pe.predicate_eval_batch(t, v, w, program)
        want = ref.predicate_eval_batch_ref(t, v, w, program)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and got.shape == want.shape,
              f"predicate_eval {program.term_branches}: {got.dtype} {tuple(got.shape)}")
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        cases += 1
        if err:
            edge += _mask_edges(program, t, v, got, want)

    for name, program in sweep_programs():
        if names and name not in names:
            continue
        for B, E, K, shift in PREDICATE_CASES:
            host = batch_inputs(rng, program, B, E, K, 128)
            one(program, *(shifted(torch.from_numpy(x).to(device), shift)
                           for x in host[:3]))
    for E in PREDICATE_BENCH_E:
        program, t, v, w = bench_predicate(rng, E, device)
        one(program, t[None], v[None], w[None])
    check(modes == {pe.MODE_BULK, pe.MODE_ASYNC4, pe.MODE_DIRECT},
          f"predicate_eval: copy modes {sorted(modes)} run, not all three")
    log(f"  predicate_eval: {cases} cases (every sweep program, one window and "
        "batches of 2/3/16 at E = 1/40/300/301/1000/4097, K = 1/3/4/8/512: bulk "
        "copies, 4-byte cp.async on a misaligned stride or a shifted buffer, device "
        "memory; bench_kernels' program at E = 2^17 and 2^20, K = 8); equal to the "
        f"plain version except {edge} events within the MASS residue; max |err| "
        f"{max_err}")
    return max_err, edge


# Rows 1, 3, 4 and 6 beside the parent tree's sources: its skim_fused.cu and
# predicate_eval.cu (every plane read as float32, ANY by its compiled op)
# and the wrappers that call them, from a copy of the parent commit's src/
# given with --parent (``git archive <parent> | tar -x -C _local/parent``):
# :func:`start_parent_ab_build`, :func:`time_parent_ab`.
PARENT_AB_KERNELS = ("skim_fused", "predicate_eval")


def float32_layout(terms, weights, kinds):
    """``terms`` (..., T, E, K) and ``weights`` (..., G, E, K) with every
    plane ``kinds`` marks as an integer's int32 bits (the T terms', then
    the G weights') holding its float32 value instead: the JAX package's
    layout, which the public forms and the parent tree's kernels read.  Tensors or numpy arrays, given back in their type."""
    import numpy as np
    import torch

    if not kinds or not any(kinds):
        return terms, weights
    T = terms.shape[-3]
    out = []
    for x, ks in ((terms, kinds[:T]), (weights, kinds[T:])):
        y = torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x.clone()
        for q, k in enumerate(ks):
            if k:
                y[..., q, :, :] = y[..., q, :, :].view(torch.int32).to(torch.float32)
        out.append(y.numpy() if isinstance(x, np.ndarray) else y)
    return tuple(out)


def start_parent_ab_build(parent_src: Path):
    """Start ``nvcc -Xptxas -v`` on the parent tree's ``skim_fused.cu`` and
    ``predicate_eval.cu`` (``parent_src``: its ``src/``), copied with every
    source of its ``csrc/`` into ``build/parent-src-<hash>/``; returns
    [(process or None, kernel, library path)]."""
    import hashlib

    from repro_torch.kernels import _build

    csrc = parent_src / "repro_torch" / "csrc"
    texts = {f.name: f.read_text() for f in sorted(csrc.iterdir())
             if f.suffix in (".cu", ".cuh")}
    digest = hashlib.sha256("".join(texts[k] for k in sorted(texts)).encode()
                            + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    root = _build.build_dir() / f"parent-src-{digest}"
    root.mkdir(parents=True, exist_ok=True)
    for name, text in texts.items():
        (root / name).write_text(text)
    out = []
    for name in PARENT_AB_KERNELS:
        lib = root / f"{name}.so"
        proc = None if lib.exists() else subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(root),
             "-o", str(lib), str(root / _build.SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        out.append((proc, name, lib))
    return out


def finish_parent_ab_build(procs, parent_src: Path):
    """Wait for :func:`start_parent_ab_build`; logs ptxas's registers and
    spills of each kernel; loads the parent's ``kernels/skim_fused.py`` and
    ``kernels/predicate_eval.py`` as modules of their own (its
    ``predicate_eval`` reading its own ``skim_fused``'s descriptors).
    Returns (skim_fused module, predicate_eval module, {kernel: library})."""
    import ctypes
    import importlib.util

    libs = {}
    for proc, name, lib in procs:
        if proc is not None:
            out, err = proc.communicate()
            check(proc.returncode == 0,
                  f"the parent's build of {name} failed:\n{out}{err}")
            for entry, line in sorted(ptxas_entries(out + err).items()):
                log(f"  ptxas, the parent's {name} {entry}: {line}")
        libs[name] = ctypes.CDLL(str(lib))
    kdir = parent_src / "repro_torch" / "kernels"

    def load(name):
        spec = importlib.util.spec_from_file_location(f"parent_{name}", kdir / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    psf = load("skim_fused")
    key = "repro_torch.kernels.skim_fused"
    ours = sys.modules[key]
    sys.modules[key] = psf  # the parent's predicate_eval imports its program_args
    try:
        ppe = load("predicate_eval")
    finally:
        sys.modules[key] = ours
    return psf, ppe, libs


def time_parent_ab(skim_cases, stage_cases, batch_cases, parent_ab) -> dict:
    """Rows 1, 3, 4 and 6 at the path's shapes (:func:`time_kernels`'
    cases: each skim call, each cascade stage of the first 16-window batch
    with the carried mask restored before each call and the copy's time
    taken off, window 0 of each batch as ``predicate_eval``, each batch of
    ``skim_fused_batch``), device ms of this tree's kernels with the
    path's plane kinds beside the parent's wrappers and kernels
    (``parent_ab``, from :func:`finish_parent_ab_build`) on the same cases
    in the float32 layout they read (:func:`float32_layout`), in turns:
    parent, this tree, this tree, parent.  Returns {row: {"ms",
    "parent_ms", "spread_ms", "parent_spread_ms", "cases"}}: means over
    the cases of each side's two readings and of the gap between them."""
    import contextlib

    from repro_torch.kernels import _build
    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import skim_fused as sf

    psf, ppe, libs = parent_ab

    @contextlib.contextmanager
    def parent():
        saved = {n: _build._LIBS.get(n) for n in libs}
        _build._LIBS.update(libs)
        try:
            yield
        finally:
            for n, lib in saved.items():
                if lib is None:
                    _build._LIBS.pop(n, None)
                else:
                    _build._LIBS[n] = lib

    def turns(fn, parent_fn, offset=0.0):
        with parent():
            first = device_ms(parent_fn)
        new = (device_ms(fn), device_ms(fn))
        with parent():
            last = device_ms(parent_fn)
        return (sum(new) / 2 - offset, (first + last) / 2 - offset,
                abs(new[0] - new[1]), abs(first - last))

    pairs = {"skim_fused": [], "predicate_eval_batch": [], "predicate_eval": [],
             "skim_fused_batch": []}
    for program, (t, v, w, p), _, kinds in skim_cases:
        t32, w32 = float32_layout(t, w, kinds)
        pairs["skim_fused"].append(turns(
            lambda: sf.skim_fused(t, v, w, p, program, kinds),
            lambda: psf.skim_fused(t32, v, w32, p, program)))
    for program, nb, (t, v, w), packed0, seg, st in stage_cases:
        pk = packed0.clone()
        kinds = st["kinds"]
        T, G = program.n_terms, program.n_groups
        planes = st["planes"]
        t32, w32 = float32_layout(planes[:, :T], planes[:, T + G:], kinds)
        planes32 = planes.clone()
        planes32[:, :T], planes32[:, T + G:] = t32, w32

        def stage(pk=pk, packed0=packed0, st=st, seg=seg, program=program, nb=nb,
                  kinds=kinds):
            pk.copy_(packed0)
            return pe.cascade_stage_windows(st["planes"], st["rows"], pk, seg,
                                            program, nb, kinds)

        def parent_stage(pk=pk, packed0=packed0, st=st, seg=seg, program=program,
                         nb=nb, planes32=planes32):
            pk.copy_(packed0)
            return ppe.cascade_stage_windows(planes32, st["rows"], pk, seg, program, nb)

        copy_ms = device_ms(lambda: pk.copy_(packed0))
        pairs["predicate_eval_batch"].append(turns(stage, parent_stage, copy_ms))
        d32 = float32_layout(t[0], w[0], kinds)
        pairs["predicate_eval"].append(turns(
            lambda: pe.predicate_eval(t[0], v[0], w[0], program, kinds),
            lambda: ppe.predicate_eval(d32[0], v[0], d32[1], program)))
    for program, t, v, w, p, kinds in batch_cases:
        t32, w32 = float32_layout(t, w, kinds)
        pairs["skim_fused_batch"].append(turns(
            lambda: sf.skim_fused_batch(t, v, w, p, program, kinds),
            lambda: psf.skim_fused_batch(t32, v, w32, p, program)))
    keys = ("ms", "parent_ms", "spread_ms", "parent_spread_ms")
    return {row: {k: sum(g[i] for g in got) / len(got) for i, k in enumerate(keys)}
            | {"cases": len(got)} for row, got in pairs.items() if got}


def count_uploads(step_name: str = "cascade_stage_step_staged"):
    """Count, until the returned ``restore()``, every host-to-device copy
    made by ``Tensor.copy_`` or ``Tensor.to`` (any thread): copies, bytes
    and how many came from pageable memory, in total and inside
    ``ops.<step_name>`` (on its caller's thread), with that function's
    calls.  Returns (counts, restore)."""
    import torch

    from repro_torch.kernels import ops

    counts = {"calls": 0, "uploads": 0, "bytes": 0, "pageable": 0,
              "step_uploads": 0, "step_bytes": 0, "step_pageable": 0}
    lock, local = threading.Lock(), threading.local()
    step, copy_, to = getattr(ops, step_name), torch.Tensor.copy_, torch.Tensor.to

    def note(src, dst_cuda):
        if not dst_cuda or src.is_cuda:
            return
        nbytes, pageable = src.numel() * src.element_size(), not src.is_pinned()
        with lock:
            counts["uploads"] += 1
            counts["bytes"] += nbytes
            counts["pageable"] += pageable
            if getattr(local, "in_step", False):
                counts["step_uploads"] += 1
                counts["step_bytes"] += nbytes
                counts["step_pageable"] += pageable

    def counting_copy(self, src, *a, **k):
        if isinstance(src, torch.Tensor):
            note(src, self.is_cuda)
        return copy_(self, src, *a, **k)

    def counting_to(self, *a, **k):
        out = to(self, *a, **k)
        if out is not self:
            note(self, out.is_cuda)
        return out

    def counting_step(*a, **k):
        with lock:
            counts["calls"] += 1
        local.in_step = True
        try:
            return step(*a, **k)
        finally:
            local.in_step = False

    torch.Tensor.copy_, torch.Tensor.to = counting_copy, counting_to
    setattr(ops, step_name, counting_step)

    def restore():
        torch.Tensor.copy_, torch.Tensor.to = copy_, to
        setattr(ops, step_name, step)

    return counts, restore


# ---------------------------------------------------------------------------
# phase 2a: stream_compact, skim_fused_batch and flash_attention
# ---------------------------------------------------------------------------

COMPACT_KINDS = ("float32", "int32", "bfloat16", "int64", "bool")


def compact_payload(rng, kind: str, E: int, D: int):
    """An (E, D) host payload of ``kind``: float32, bfloat16 and float16
    with NaNs (random payload bits) and -0.0 mixed in, int32 at and above
    2^24 (and negative), int64 across its range, random bytes (uint8),
    random bools."""
    import numpy as np
    import torch

    n = E * D
    if kind in ("float32", "bfloat16", "float16"):
        x = rng.normal(size=n).astype(np.float32)
        nan = (np.uint32(0x7FC00000) | rng.integers(0, 1 << 22, n).astype(np.uint32))
        special = rng.random(n)
        x = np.where(special < 0.05, nan.view(np.float32), x)
        x = np.where((special >= 0.05) & (special < 0.1), np.float32(-0.0), x)
        return torch.from_numpy(x.reshape(E, D)).to(getattr(torch, kind))
    if kind == "uint8":
        return torch.from_numpy(rng.integers(0, 256, (E, D), dtype=np.uint8))
    if kind == "int32":
        big = rng.integers((1 << 24) - 3, (1 << 31) - 1, n)
        sign = np.where(rng.random(n) < 0.3, -1, 1)
        return torch.from_numpy((big * sign).astype(np.int32).reshape(E, D))
    if kind == "int64":
        return torch.from_numpy(
            rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64).reshape(E, D))
    return torch.from_numpy(rng.random((E, D)) < 0.5)


def compact_mask(rng, E: int, rate: float, as_int: bool):
    """(E,) keep mask at ``rate``: bool, or int32 whose kept entries are
    nonzero values of either sign (the kernel keeps ``mask != 0``)."""
    import numpy as np
    import torch

    keep = rng.random(E) < rate
    if not as_int:
        return torch.from_numpy(keep)
    vals = rng.choice(np.array([1, 7, -1, -5], np.int32), E)
    return torch.from_numpy(np.where(keep, vals, 0).astype(np.int32))


def check_stream_compact(rng, device, Es=(1, 300, 512, 4097, N_EVENTS)) -> float:
    """``stream_compact`` against its plain version, bit for bit: every E
    of ``Es``, D in 1/3/4/8/16 (rows of a multiple of 16 bytes, copied in
    16-byte units, and of others, copied by the element), rates
    0/0.13/0.5/1, every payload kind of :data:`COMPACT_KINDS`, bool and
    int32 masks; then payloads and masks shifted off 16-byte alignment
    (:func:`shifted`), which take the element-wise paths.  Returns the
    largest :func:`bit_err` seen."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_compact as sc

    cases = 0
    max_err = 0.0

    def one(payload, mask, what):
        nonlocal cases, max_err
        got, count = sc.stream_compact(payload, mask)
        want, want_count = ref.stream_compact_ref(payload, mask)
        torch.cuda.synchronize()
        err = bit_err(got, want)
        max_err = max(max_err, err)
        cases += 1
        check(int(count) == int(want_count) == int((mask != 0).sum()),
              f"stream_compact {what}: count {int(count)} vs {int(want_count)}")
        check(err == 0.0, f"stream_compact {what}: rows differ from the plain "
              f"version (max |bits| {err})")

    for E in Es:
        for D in (1, 3, 4, 8, 16):
            for kind in COMPACT_KINDS:
                payload = compact_payload(rng, kind, E, D).to(device)
                for i, rate in enumerate((0.0, 0.13, 0.5, 1.0)):
                    mask = compact_mask(rng, E, rate, as_int=bool(i % 2)).to(device)
                    one(payload, mask, f"E={E} D={D} {kind} rate={rate}")
    for E in (300, 4097, 70_000):
        for D, kind in ((4, "float32"), (8, "bfloat16"), (2, "int64"), (3, "int32")):
            payload = compact_payload(rng, kind, E, D).to(device)
            for as_int in (False, True):
                mask = compact_mask(rng, E, 0.3, as_int).to(device)
                for p_shift, m_shift in ((1, 0), (0, 1), (1, 3)):
                    one(shifted(payload, p_shift), shifted(mask, m_shift),
                        f"E={E} D={D} {kind} shifted by {p_shift}/{m_shift}")
    log(f"  stream_compact: {cases} cases bit-identical to the plain version "
        f"(E in {'/'.join(map(str, Es))}, D in 1/3/4/8/16, rates 0/0.13/0.5/1, "
        "float32 and bf16 with NaN payloads and -0.0, int32 at and above 2^24, "
        "int64, bool; bool and int32 masks; payloads and masks off 16-byte "
        f"alignment at E = 300/4097/70000); max |bits| {max_err}")
    return max_err


def batch_sweep_inputs(rng, program, B: int, E: int, K: int, D: int = 2):
    """A (B, ...) batch of :func:`sweep_inputs` windows: numpy terms,
    valid, weights and payload (column 0 the local event index)."""
    import numpy as np

    per = [sweep_inputs(rng, program, E, K, D) for _ in range(B)]
    return tuple(np.stack([w[i] for w in per]) for i in range(4))


def check_skim_fused_batch(rng, device, names=None) -> tuple[float, int]:
    """``skim_fused_batch`` against its plain version over the sweep
    programs, B in 1/3/16, E in 512/4096, K in 1/8: packed rows and counts
    bit for bit, except events within the MASS residue (as
    :func:`check_skim_fused`).  Returns (max |kernel - plain|, edge
    events)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import skim_fused as sf

    cases = edge = 0
    max_err = 0.0
    for name, program in sweep_programs():
        if names and name not in names:
            continue
        for B in (1, 3, 16):
            for E in (512, 4096):
                for K in (1, 8):
                    host = batch_sweep_inputs(rng, program, B, E, K)
                    t, v, w, p = (torch.from_numpy(x).to(device) for x in host)
                    got, counts = sf.skim_fused_batch(t, v, w, p, program)
                    want, want_counts = ref.skim_fused_batch_ref(t, v, w, p, program)
                    torch.cuda.synchronize()
                    cases += 1
                    check(got.shape == want.shape and counts.dtype == torch.int32,
                          f"skim_fused_batch {name}: {tuple(got.shape)} {counts.dtype}")
                    max_err = max(max_err, float((got - want).abs().max()),
                                  float((counts - want_counts).abs().max()))
                    if torch.equal(counts, want_counts) and torch.equal(
                        got.view(torch.int32), want.view(torch.int32)
                    ):
                        if name == "empty":
                            check(int(counts.sum()) == 0, "empty mask: survivors found")
                        if name == "full":
                            check(int(counts.sum()) == B * E, "full mask: events lost")
                        continue
                    for b in range(B):
                        n, wn = int(counts[b]), int(want_counts[b])
                        if n == wn and torch.equal(got[b].view(torch.int32),
                                                   want[b].view(torch.int32)):
                            continue
                        edge += packed_edges(
                            f"skim_fused_batch {name} B={B} E={E} K={K} window {b}",
                            program, t[b], v[b], got[b], n, want[b], wn)
    log(f"  skim_fused_batch: {cases} cases (every sweep program, B in 1/3/16, "
        f"E in 512/4096, K in 1/8); packed rows and counts equal to the plain "
        f"version except {edge} events within the MASS residue; max |err| {max_err}")
    check_skim_payloads(rng, device, batch=True)
    return max_err, edge


def nonfinite_programs():
    """:func:`sweep_programs` and two EXPR groups whose ``min`` / ``max``
    meet zeros of opposite sign: ``F_z / min(F_y - F_y, F_x) > 0`` and
    ``F_z / max(F_x, F_y - F_y) > 0`` (``F_y - F_y`` is +0.0 where F_y is
    finite)."""
    from repro_torch.core.expr import RPN_BRANCH, RPN_DIV, RPN_MAX, RPN_MIN, RPN_SUB
    from repro_torch.kernels.program import GROUP_EXPR, OP_IDS, Group, Program

    zero = ((RPN_BRANCH, 1), (RPN_BRANCH, 1), (RPN_SUB, None))
    x = ((RPN_BRANCH, 2),)
    groups = tuple(
        Group(GROUP_EXPR, (0, 1, 2), (), (), cmp_op=OP_IDS[">"], cmp_thr=0.0,
              rpn=((RPN_BRANCH, 0),) + args + ((op, None), (RPN_DIV, None)))
        for op, args in ((RPN_MIN, zero + x), (RPN_MAX, x + zero)))
    signed_zero = Program(groups, ("F_z", "F_y", "F_x"), (None, None), (None, None))
    return sweep_programs() + [("expr_signed_zero", signed_zero)]


def nonfinite_inputs(rng, program, E: int, K: int, D: int, share: float = 0.1):
    """:func:`sweep_inputs` with a ``share`` of the term planes' entries
    (valid slots and padding alike) set to NaN, +inf, -inf or -0.0, HT
    weights taken again from the poisoned terms, and payload columns past
    the event index poisoned the same way."""
    import numpy as np

    from repro_torch.kernels.program import GROUP_HT

    terms, valid, weights, payload = sweep_inputs(rng, program, E, K, D)
    values = np.array(NONFINITE_VALUES, np.float32)

    def poison(x):
        hit = rng.random(x.shape) < share
        x[hit] = values[rng.integers(0, len(values), int(hit.sum()))]

    poison(terms)
    poison(payload[:, 1:])
    for g, grp in enumerate(program.groups):
        if grp.kind == GROUP_HT:
            weights[g] = terms[grp.term_ids[0]]
    return terms, valid, weights, payload


def check_nonfinite_kernels(rng, device) -> float:
    """The five kernels that evaluate the program or move rows, bit for bit
    against their plain versions on :func:`nonfinite_inputs` (every sweep
    program and the signed-zero EXPR program): ``predicate_eval``,
    ``skim_fused`` and ``stream_compact`` (the poisoned payload by the
    plain mask) at E in 512/4097 and K in 1/4/16, ``cascade_stage`` and
    ``skim_fused_batch`` at B = 3, E = 4096, K in 1/8.  Masks may differ
    only within the MASS residue, as in the finite checks.  Returns the
    largest bit-pattern difference (0.0: all bit-identical)."""
    import numpy as np
    import torch

    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref
    from repro_torch.kernels import skim_fused as sf
    from repro_torch.kernels import stream_compact as sc

    cases = edge = 0
    max_err = 0.0

    def same(got, want) -> bool:
        return got.shape == want.shape and bit_err(got.cpu(), want.cpu()) == 0.0

    for name, program in nonfinite_programs():
        for E in (512, 4097):
            for K in (1, 4, 16):
                host = nonfinite_inputs(rng, program, E, K, 3)
                t, v, w, p = (torch.from_numpy(x).to(device) for x in host)
                want_mask = ref.predicate_eval_ref(t, v, w, program).to(torch.int32)
                mask = pe.predicate_eval(t, v, w, program)
                want, want_n = ref.skim_fused_ref(t, v, w, p, program)
                got, n = sf.skim_fused(t, v, w, p, program)
                packed, m = sc.stream_compact(p, want_mask)
                want_packed, want_m = ref.stream_compact_ref(p, want_mask)
                torch.cuda.synchronize()
                cases += 1
                what = f"{name} E={E} K={K}"
                check(int(m) == int(want_m) and same(packed, want_packed),
                      f"stream_compact on non-finite rows {what}: not bit for bit")
                if not torch.equal(mask, want_mask):
                    max_err = max(max_err, float((mask - want_mask).abs().max()))
                    edge += _mask_edges(program, t[None], v[None], mask[None],
                                        want_mask[None])
                if int(n) != int(want_n) or not same(got, want):
                    max_err = max(max_err, bit_err(got.cpu(), want.cpu()))
                    edge += packed_edges(f"skim_fused on non-finite inputs {what}",
                                         program, t, v, got, n, want, want_n)
        for K in (1, 8):
            B, E = 3, 4096
            batch = [nonfinite_inputs(rng, program, E, K, 3) for _ in range(B)]
            t, v, w, p = (torch.from_numpy(np.stack([b[i] for b in batch])).to(device)
                          for i in range(4))
            got, counts = sf.skim_fused_batch(t, v, w, p, program)
            want, want_counts = ref.skim_fused_batch_ref(t, v, w, p, program)
            alive = torch.from_numpy(rng.random((B, E)) < 0.7).to(device)
            packed = ref.pack_bits(alive)
            seg = (torch.arange(E, device=device, dtype=torch.int32) // 1024).expand(B, E)
            seg = seg.contiguous()
            w_packed, *w_out = ref.cascade_stage_ref(t, v, w, packed.clone(), seg,
                                                     program, 4)
            s_packed, s_out = pe.cascade_stage(t, v, w, packed, seg, program, 4)
            torch.cuda.synchronize()
            cases += 1
            what = f"{name} B={B} E={E} K={K}"
            for b in range(B):
                if int(counts[b]) != int(want_counts[b]) or not same(got[b], want[b]):
                    max_err = max(max_err, bit_err(got[b].cpu(), want[b].cpu()))
                    edge += packed_edges(f"skim_fused_batch on non-finite inputs "
                                         f"{what} window {b}", program, t[b], v[b],
                                         got[b], counts[b], want[b], want_counts[b])
            want_out = torch.cat([w_out[0], w_out[1][:, None]], dim=1)
            if not (torch.equal(s_packed, w_packed) and torch.equal(s_out, want_out)):
                m_got, m_want = ref.unpack_bits(s_packed, E), ref.unpack_bits(w_packed, E)
                max_err = max(max_err, float((m_got.int() - m_want.int()).abs().max()))
                n = _mask_edges(program, t, v, m_got, m_want)
                check(n > 0, f"cascade_stage on non-finite inputs {what}: basket "
                      "bits or counts differ where the masks agree")
                edge += n
    log(f"  non-finite inputs: {cases} cases (every sweep program and the "
        "signed-zero EXPR program; a tenth of every term plane NaN, +inf, -inf "
        "or -0.0, HT weights from the poisoned terms); predicate_eval, "
        "skim_fused, skim_fused_batch and cascade_stage equal to their plain "
        f"versions except {edge} events within the MASS residue; stream_compact "
        "of the poisoned rows bit for bit")
    return max_err


def check_edge_kernels(device) -> float:
    """The four kernels that evaluate the program, on :func:`edge_window`'s
    padded inputs for every query of :data:`EDGE_QUERIES` (the whole window
    one launch, at the K that truncates no object), against their plain
    versions on the same card tensors and against the host evaluator:
    ``predicate_eval``'s mask, ``cascade_stage``'s mask, basket bits and
    count (every event live), ``skim_fused``'s and ``skim_fused_batch``'s
    survivors (payload column 0 the event index).  The plain version on
    the card may differ from the host, and a kernel from either, only at
    MASS events within the residue (:func:`edge_events`; counted, logged).
    Returns the largest |kernel - plain| over masks and counts."""
    import numpy as np
    import torch

    from repro_torch.core.neardata import (build_padded_inputs, fused_window_skim,
                                           window_pad_K)
    from repro_torch.core.planner import plan_skim
    from repro_torch.core.query import parse_query
    from repro_torch.data.store import EventStore
    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref
    from repro_torch.kernels import skim_fused as sf

    columns, jagged, edges = edge_window()
    store = EventStore.from_arrays(columns, jagged=jagged, basket_events=EDGE_BASKET,
                                   device="cpu")
    E, nb = EDGE_EVENTS, EDGE_EVENTS // EDGE_BASKET
    seg = (torch.arange(E, dtype=torch.int32, device=device) // EDGE_BASKET)[None]
    max_err, residue = 0.0, {}

    def kept(packed, count):
        mask = torch.zeros(E, dtype=torch.bool)
        mask[packed[: int(count), 0].long().cpu()] = True
        return mask

    for name, q in EDGE_QUERIES.items():
        plan = plan_skim(parse_query(q), store)
        program = plan.compiled_program()
        data = {b: store.read_jagged(b)[0] if store.branches[b].jagged
                else store.read_flat(b) for b in plan.filter_branches}
        host = torch.from_numpy(fused_window_skim(data, program, store, backend="host")[0])
        pb = build_padded_inputs(data, program, store, K=window_pad_K(data, program, store),
                                 include_index=True, to_device=False)
        t, v, w, p = (torch.from_numpy(np.asarray(x)).to(device)
                      for x in (pb.terms, pb.valid, pb.weights, pb.payload))
        plain = ref.predicate_eval_ref(t, v, w, program).cpu()
        packed = ref.pack_bits(torch.ones((1, E), dtype=torch.bool, device=device))
        words, out = pe.cascade_stage(t[None], v[None], w[None], packed, seg, program, nb)
        sk, n = sf.skim_fused(t, v, w, p, program)
        skb, nbt = sf.skim_fused_batch(t[None], v[None], w[None], p[None], program)
        torch.cuda.synchronize()
        stage_mask = ref.unpack_bits(words, E)[0].cpu()
        got = {"predicate_eval": pe.predicate_eval(t, v, w, program).cpu().bool(),
               "cascade_stage": stage_mask, "skim_fused": kept(sk, n),
               "skim_fused_batch": kept(skb[0], nbt[0])}
        check(int(out[0, nb]) == int(stage_mask.sum()) and torch.equal(
            out[0, :nb].cpu(), stage_mask.reshape(nb, -1).any(dim=1).int()),
            f"edge window, {name}: cascade_stage's basket bits or count do not "
            "follow its mask")
        n_res = 0
        for who, mask in [("plain version", plain)] + list(got.items()):
            for other, want in (("host evaluator", host), ("plain version", plain)):
                diff = torch.nonzero(mask != want).flatten().numpy()
                if who != "plain version":
                    max_err = max(max_err, float((mask != plain).any()))
                if len(diff) == 0:
                    continue
                check(edge_events(program, t.cpu(), v.cpu(), diff),
                      f"edge window, {name}: the {who} and the {other} differ at "
                      f"events {diff[:8].tolist()}, outside the MASS residue")
                n_res = max(n_res, len(diff))
        residue[name] = n_res
        for event, keep in edges[name]:
            check(bool(host[event]) == keep,
                  f"edge window, {name}: the host evaluator decides event {event} "
                  f"otherwise than the float64 formulas ({keep})")
    log(f"  edge window ({E} events, {sum(len(c) for c in edges.values())} at float32 "
        f"cut edges over {len(EDGE_QUERIES)} queries): predicate_eval, cascade_stage, "
        "skim_fused and skim_fused_batch equal their plain versions on the card and "
        f"the host evaluator except MASS events within the residue: {json.dumps(residue)}")
    return max_err


def check_int_kernels(device) -> float:
    """The four kernels that evaluate the program, on :func:`int_window`'s
    padded inputs with their plane kinds (an integer branch's int32 bits)
    for every query of :data:`INT_QUERIES`, the whole window one launch at
    the K that truncates no object: ``predicate_eval``'s and
    ``predicate_eval_batch``'s masks, ``cascade_stage``'s mask, basket bits
    and count (every event live), ``skim_fused``'s and
    ``skim_fused_batch``'s survivors (payload column 0 the event index),
    each bit for bit equal to the plain version on the same card tensors
    and to the host evaluator.  Returns the largest |kernel - plain| over
    masks and counts: 0."""
    import numpy as np
    import torch

    from repro_torch.core.neardata import (build_padded_inputs, fused_window_skim,
                                           program_kinds, window_pad_K)
    from repro_torch.core.planner import plan_skim
    from repro_torch.core.query import parse_query
    from repro_torch.data.store import EventStore
    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref
    from repro_torch.kernels import skim_fused as sf

    columns, jagged = int_window()
    store = EventStore.from_arrays(columns, jagged=jagged, basket_events=INT_BASKET,
                                   device="cpu")
    E, nb = INT_EVENTS, INT_EVENTS // INT_BASKET
    seg = (torch.arange(E, dtype=torch.int32, device=device) // INT_BASKET)[None]
    max_err, kept_by = 0.0, {}

    def kept(packed, count):
        mask = torch.zeros(E, dtype=torch.bool)
        mask[packed[: int(count), 0].long().cpu()] = True
        return mask

    for name, q in INT_QUERIES.items():
        plan = plan_skim(parse_query(q), store)
        program = plan.compiled_program()
        kinds = program_kinds(program, store)
        data = {b: store.read_jagged(b)[0] if store.branches[b].jagged
                else store.read_flat(b) for b in plan.filter_branches}
        host = torch.from_numpy(fused_window_skim(data, program, store, backend="host")[0])
        pb = build_padded_inputs(data, program, store, K=window_pad_K(data, program, store),
                                 include_index=True, to_device=False, kinds=kinds)
        t, v, w, p = (torch.from_numpy(np.asarray(x)).to(device)
                      for x in (pb.terms, pb.valid, pb.weights, pb.payload))
        plain = ref.predicate_eval_ref(t, v, w, program, kinds).cpu()
        packed = ref.pack_bits(torch.ones((1, E), dtype=torch.bool, device=device))
        words, out = pe.cascade_stage(t[None], v[None], w[None], packed, seg, program, nb,
                                      kinds)
        sk, n = sf.skim_fused(t, v, w, p, program, kinds)
        skb, nbt = sf.skim_fused_batch(t[None], v[None], w[None], p[None], program, kinds)
        batch = pe.predicate_eval_batch(t[None], v[None], w[None], program, kinds)
        torch.cuda.synchronize()
        stage_mask = ref.unpack_bits(words, E)[0].cpu()
        got = {"predicate_eval": pe.predicate_eval(t, v, w, program, kinds).cpu().bool(),
               "predicate_eval_batch": batch[0].cpu().bool(),
               "cascade_stage": stage_mask, "skim_fused": kept(sk, n),
               "skim_fused_batch": kept(skb[0], nbt[0])}
        check(int(out[0, nb]) == int(stage_mask.sum()) and torch.equal(
            out[0, :nb].cpu(), stage_mask.reshape(nb, -1).any(dim=1).int()),
            f"int window, {name}: cascade_stage's basket bits or count do not "
            "follow its mask")
        check(torch.equal(plain, host),
              f"int window, {name}: the plain version and the host evaluator differ "
              f"at events {torch.nonzero(plain != host).flatten()[:8].tolist()}")
        for who, mask in got.items():
            max_err = max(max_err, float((mask != plain).any()))
            check(torch.equal(mask, host),
                  f"int window, {name}: {who} and the host evaluator differ at events "
                  f"{torch.nonzero(mask != host).flatten()[:8].tolist()}")
        kept_by[name] = int(host.sum())
    log(f"  int window ({E} events: event numbers on both sides of 2^24 and above "
        "10^8, an int32 word across -2^31, Jet_id beside 2^24, ANY over int32 and "
        "non-bool float32 words): predicate_eval, predicate_eval_batch, "
        "cascade_stage, skim_fused and skim_fused_batch with the plane kinds equal "
        "the plain version and the host evaluator bit for bit; survivors "
        + json.dumps(kept_by))
    return max_err


FLASH_SHAPES = ((1, 1, 128, 32), (2, 3, 256, 64), (1, 2, 512, 128))  # tests/test_kernels.py
# the kernel's edges: S a multiple of neither key tile (32, 128), a D the
# wrapper pads to 48, B*H = 72 heads over several waves of CTAs
FLASH_EDGE_SHAPES = ((1, 2, 200, 128), (1, 2, 2049, 128), (1, 2, 200, 40), (2, 36, 384, 128))
# Gemma-7B's attention (google/gemma-7b config.json: 16 heads, head_dim
# 256) over 2048 positions, causal
GEMMA_7B_ATTN = (1, 16, 2048, 256)
# head dims past 128 (the wide kernels: a CTA owns a 256-column slice of
# the output): a D the wrapper pads to 144, D = 144 itself (one 64-column
# box past 128), 192, 240 (just under 256), 256 at a ragged S and at S =
# 1000 (a ragged 64-key tile), 264 (a first 256-column slice plus 16
# columns: two chunks of Q K^T), 520 padded to 528 (three slices, the last
# of 16 columns), and Gemma-7B's layout
FLASH_WIDE_SHAPES = ((1, 2, 200, 136), (1, 2, 512, 192), (1, 2, 2049, 256), (1, 1, 130, 520),
                     GEMMA_7B_ATTN, (1, 2, 200, 144), (1, 2, 300, 240), (1, 2, 256, 264),
                     (1, 2, 1000, 256))
# (rtol, atol) against the plain version on the card.  float32: the JAX
# tests' 3e-5.  bf16: kernel and plain version both accumulate in float32
# and round once to bf16, so they differ by at most about one bf16 ulp
# (2^-8 of the value); 1e-2 relative plus 4e-3 absolute allows a few, far
# under the JAX tests' 0.05, which is as large as a typical output at
# S = 2048.  float16: the same argument with f16's ulp, at most 2^-10 of
# the value, and P rounded to f16 (2^-11) before P V: 2e-3 relative plus
# 2e-3 absolute, tighter than bf16's in both.
FLASH_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (1e-2, 4e-3), "float16": (2e-3, 2e-3)}


def attention_close(got, want, dtype_name: str, what: str) -> float:
    """Fails unless |got - want| <= atol + rtol * |want| everywhere (in
    float32 for float32 inputs; for bf16 both are bf16, compared in the
    working type's values).  Returns max |got - want|."""
    import torch

    rtol, atol = FLASH_TOL[dtype_name]
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    diff = (g - w).abs()
    over = diff > atol + rtol * w.abs()
    check(not bool(over.any()),
          f"{what}: {int(over.sum())} values outside rtol {rtol}, atol {atol} "
          f"(max |err| {float(diff.max())})")
    return float(diff.max())


def attention_inputs(rng, shape, dtype, device):
    import torch

    return [torch.from_numpy(rng.normal(size=shape).astype("float32"))
            .to(device=device, dtype=dtype) for _ in range(3)]


def check_flash_attention(rng, device,
                          shapes=FLASH_SHAPES + FLASH_EDGE_SHAPES + FLASH_WIDE_SHAPES) -> float:
    """``flash_attention`` against its plain version at the JAX tests'
    shapes, :data:`FLASH_EDGE_SHAPES` and :data:`FLASH_WIDE_SHAPES`, causal
    and not, in float32, bf16 and float16, within :data:`FLASH_TOL`, one
    launch a call.  Returns the largest |kernel - plain| over all cases."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    cases = 0
    errs = dict.fromkeys(FLASH_TOL, 0.0)
    for shape in shapes:
        for causal in (True, False):
            for dtype_name in errs:
                dtype = getattr(torch, dtype_name)
                q, k, v = attention_inputs(rng, shape, dtype, device)
                ops.reset_launch_counts()
                got = fa.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                what = f"flash_attention {shape} causal={causal} {dtype_name}"
                check(ops.launch_counts()["flash_attention"] == 1, f"{what}: not launched")
                want = ref.flash_attention_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err = attention_close(got, want, dtype_name, what)
                errs[dtype_name] = max(errs[dtype_name], err)
                cases += 1
                del q, k, v, got, want
    log(f"  flash_attention: {cases} cases (shapes {list(shapes)}, causal and "
        f"not, float32, bf16 and float16), one launch each, within (rtol, atol) "
        f"{FLASH_TOL} of the plain version; max |err| {errs}")
    return max(errs.values())


# ---------------------------------------------------------------------------
# phase 2b: the main path's shapes, timed
# ---------------------------------------------------------------------------


def path_skim_cases(store, queries, device):
    """Every cascade stage's padded inputs over window 0, staged by the
    main path's own helpers (``build_padded_inputs`` with the plane kinds,
    ``pad_window``): (program, tensors on ``device``, numpy arrays, kinds)."""
    import torch

    from repro_torch.core.engine import Breakdown, _decode_branches
    from repro_torch.core.neardata import (build_padded_inputs, pad_window,
                                           program_kinds, window_pad_K)
    from repro_torch.core.planner import plan_skim
    from repro_torch.core.query import parse_query
    from repro_torch.data.store import FetchStats

    cases = []
    stop = min(store.basket_events, store.n_events)
    for q in queries:
        plan = plan_skim(parse_query(q), store, window_events=store.basket_events,
                         prune=False, cascade=True)
        for stage in plan.cascade.stages:
            data = _decode_branches(store, list(stage.branches), 0, stop,
                                    Breakdown(), FetchStats(), True)
            K = window_pad_K(data, stage.program, store)
            kinds = program_kinds(stage.program, store)
            pb = build_padded_inputs(data, stage.program, store, K=K,
                                     include_index=True, to_device=False, kinds=kinds)
            arrays = pad_window(pb)
            cases.append((stage.program,
                          [torch.from_numpy(a).to(device) for a in arrays], arrays,
                          kinds))
    return cases


def path_stage_cases(store, queries, device, batch: int = 16):
    """Every cascade stage's inputs for the batch of the first ``batch``
    windows of each query, as ``run_window_batch`` hands them to
    ``ops.cascade_stage_step_staged`` (recorded on the way through, the carried
    mask as it was before the stage): (program, nb, the dense batch the
    staged windows stand for (terms, valid, weights) on the card, packed,
    seg_ids, and a dict of the staged form: ``planes`` and ``rows`` on the
    card, ``host`` a copy of the staged buffer, ``shape``, ``n_groups``,
    ``kinds``, the planes' kinds the path passed)."""
    import torch

    from repro_torch.core.engine import Breakdown
    from repro_torch.core.plan import CascadeExecutor, mark_fetched
    from repro_torch.core.planner import plan_skim
    from repro_torch.core.query import parse_query
    from repro_torch.data.store import FetchStats
    from repro_torch.kernels import ops

    cases = []
    step = ops.cascade_stage_step_staged

    def record(inputs, packed, seg_ids, program, nb, **kw):
        host = inputs.host.clone()  # the staging buffer serves the next stage
        planes, rows = inputs.views(host.to(device))
        cases.append((program, nb, [torch.from_numpy(x).to(device)
                                    for x in dense_batch(inputs)],
                      packed.clone(), seg_ids.clone(),
                      {"planes": planes, "rows": rows, "host": host,
                       "shape": inputs.shape, "n_groups": inputs.n_groups,
                       "row_list": inputs.rows.tolist(), "kinds": kw.get("kinds")}))
        return step(inputs, packed, seg_ids, program, nb, **kw)

    be = store.basket_events
    ops.cascade_stage_step_staged = record
    for q in queries:
        before = len(cases)
        plan = plan_skim(parse_query(q), store, window_events=be, prune=False,
                         cascade=True)
        ex = CascadeExecutor(plan, store, device=device)
        entries = []
        for start in range(0, min(batch * be, store.n_events), be):
            stop = min(start + be, store.n_events)
            ledger: dict = {}
            mark_fetched(store, ex.head_branches, start, stop, ledger)
            entries.append((start, stop, None, Breakdown(), FetchStats(), ledger))
        ex.run_window_batch(entries, pad_B=batch)
        check(len(cases) > before, f"the batched path of {sorted(q)} recorded no "
              "stage step: run_window_batch no longer calls "
              "ops.cascade_stage_step_staged")
    ops.cascade_stage_step_staged = step
    return cases


def path_decode_cases(store, queries, device):
    """The decode rounds of window 0 of each (label, query) (a window is one basket
    on the main path): one round per cascade stage's fetch set, and one for
    the output branches no stage read, each basket decoded to its branch's
    own dtype.  Each case: (label, parts {branch: [part]}, dtypes, plan_round
    layout, the staged round on ``device``, an output buffer there)."""
    import torch

    from repro_torch.core.planner import plan_skim
    from repro_torch.core.query import parse_query
    from repro_torch.data.codecs import bitpack_raw_parts
    from repro_torch.kernels import ops

    cases = []
    for label, q in queries:
        plan = plan_skim(parse_query(q), store, window_events=store.basket_events,
                         prune=False, cascade=True)
        rounds = [list(stage.branches) for stage in plan.cascade.stages]
        seen = {b for r in rounds for b in r}
        rounds.append([b for b in plan.output_branches if b not in seen])
        for i, names in enumerate(rounds):
            parts = {n: [bitpack_raw_parts(store._blobs[n][0])] for n in names}
            dtypes = {n: store.branches[n].np_dtype() for n in names}
            baskets = [(ps[0], ops.torch_dtype(dtypes[n])) for n, ps in parts.items()
                       if ps[0]["kind"] != 3 and ps[0]["n"]]
            if not baskets:
                continue
            layout = ops.plan_round(baskets)
            staged = torch.empty(layout["n_in"], dtype=torch.int32)
            ops.fill_round(staged.numpy(), layout)
            cases.append((f"{label} round {i}", parts, dtypes, layout,
                          staged.to(device),
                          torch.empty(layout["out_bytes"], dtype=torch.uint8,
                                      device=device)))
    return cases


def _summary(rows) -> dict | None:
    """Mean over the path's cases of each time and of the bound; the bound
    is by bytes or by operations as the larger of the two sums says.
    ``library_ms`` is null unless every case timed a library call."""
    if not rows:
        return None
    n = len(rows)
    t_bytes = sum(r["t_bytes"] for r in rows)
    t_ops = sum(r["t_ops"] for r in rows)
    libs = [r.get("library_ms") for r in rows]
    return {
        "ms": sum(r["ms"] for r in rows) / n,
        "plain_ms": sum(r["plain_ms"] for r in rows) / n,
        "bound_ms": sum(max(r["t_bytes"], r["t_ops"]) for r in rows) / n,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "stream_ms": sum(r["stream_ms"] for r in rows) / n,
        "library_ms": None if None in libs else sum(libs) / n,
    }


def bounds(summary: dict) -> dict:
    return {k: summary[k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "by_case",
                      "int32_ms", "uint8_ms",
                      "per_basket_ms", "round_ms", "window_ms", "dense_ms", "step_ms",
                      "public_step_ms", "staged_bytes", "dense_bytes", "shapes",
                      "wrapper_us")
            if k in summary}


def time_predicate(program, t, v, w, kinds=None) -> dict:
    """``predicate_eval`` on one window (T, E, K) with the planes' ``kinds``
    beside its plain version.  The bound reads the K slots of the planes the
    program reads (``predicate_eval.planes_read``) once and writes the (E,)
    mask once."""
    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref

    T, E, K = t.shape
    G = v.shape[0]
    n_read = bin(pe.planes_read(program) & ((1 << (T + 2 * G)) - 1)).count("1")
    t_bytes, t_ops = bound_times(4 * (n_read * E * K + E), E * K * (T + 4 * G))
    row = {
        "E": E, "K": K,
        "ms": device_ms(lambda: pe.predicate_eval(t, v, w, program, kinds)),
        "stream_ms": stream_ms(lambda: pe.predicate_eval(t, v, w, program, kinds)),
        "plain_ms": stream_ms(lambda: ref.predicate_mask(program, t, v, w, kinds),
                              calls=5),
        "t_bytes": t_bytes, "t_ops": t_ops,
    }
    log(f"  predicate_eval T={T} G={G} E={E} K={K}, {n_read} planes read: kernel "
        f"{row['ms']:.5f} ms on the device, {row['stream_ms']:.5f} ms per call from "
        f"the host; plain {row['plain_ms']:.5f} ms; bound "
        f"{max(t_bytes, t_ops):.7f} ms")
    return row


def compact_wrapper_steps(payload, mask, calls: int = 2000) -> dict:
    """Host microseconds a call of each step of ``stream_compact``'s wrapper
    on the card, each timed alone over ``calls`` calls: its argument
    checks, the two allocations (packed rows, count), the current stream's
    raw handle, the workspace's status words and epoch, the ``ctypes``
    call that launches the kernel (with a fresh epoch each, the
    workspace's time subtracted), the launch counter; the whole wrapper;
    and two steps the earlier wrapper took on every call: the current
    stream as a Stream object, and entering the device context (this one
    enters it only where another card is current).  The launch and the
    counter are the wrapper's own (``_build.function``,
    ``_build.count_launch``)."""
    import ctypes

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import stream_compact as sc
    from repro_torch.kernels.skim_fused import Workspace

    device = payload.device
    E, D = payload.shape
    n_status = -(-E // sc.EVENT_TILE)
    stream = torch.cuda.current_stream(device).cuda_stream
    out = torch.empty_like(payload)
    total = torch.empty((), dtype=torch.int32, device=device)
    fn = _build.function("stream_compact", "stream_compact_launch", sc._ARGTYPES)
    p = _build.ptr

    def checks():
        return (mask.dtype in sc.MASK_DTYPES and payload.dim() == 2 and mask.dim() == 1
                and mask.shape[0] == payload.shape[0] and payload.is_cuda
                and mask.device == device and payload.is_contiguous()
                and mask.is_contiguous() and payload.element_size())

    def reserve():
        return Workspace.reserve(device, stream, n_status, 1)

    def launch():
        status, ticket, epoch = reserve()
        return fn(p(payload), p(mask), mask.element_size(), E, D, payload.element_size(),
                  p(status), p(ticket), epoch, p(out), p(total), ctypes.c_void_p(stream))

    def context():
        with torch.cuda.device(device):
            pass

    def each(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    steps = {
        "checks": each(checks),
        "alloc_out": each(lambda: torch.empty_like(payload)),
        "alloc_count": each(lambda: torch.empty((), dtype=torch.int32, device=device)),
        "current_stream": each(lambda: _build.stream_id(device)),
        "current_stream_object": each(lambda: torch.cuda.current_stream(device).cuda_stream),
        "workspace": each(reserve),
        "pointers": each(lambda: (p(payload), p(mask), p(out), p(total))),
        "launch_and_workspace": each(launch),
        "count": each(lambda: _build.count_launch("stream_compact")),
        "whole_wrapper": each(lambda: sc.stream_compact(payload, mask)),
        "device_context": each(context),
    }
    steps["launch"] = steps["launch_and_workspace"] - steps["workspace"]
    log("  stream_compact's wrapper, host us a call by step: " + json.dumps(
        {k: round(v, 3) for k, v in steps.items()}))
    return steps


def time_kernels(skim_cases=(), decode_cases=(), stage_cases=(), batch_cases=(),
                 compact_cases=(), attn_cases=(), pred_cases=()) -> dict:
    """Each kernel at the shapes its path gives it: its device time (CUDA
    graph replay), its time per call as the stream sees it from the host,
    the plain version's time per call, the bound (decoded values counted
    at each branch's own width) and, where one PyTorch call computes the
    same function, that call's time per call from the host
    (``library_ms``).  ``skim_fused`` and ``skim_fused_batch`` are also
    timed at int32 and uint8 rows of the same shape.  ``predicate_eval`` also at ``pred_cases`` (program, terms, valid,
    weights: bench_kernels' shapes) and ``stream_compact`` at every case
    (label, payload, mask), the mean over those labelled "path" as its
    row; each shape is listed under ``shapes``.  ``flash_attention``'s row
    is the mean over its cases, each also under ``by_case``.  Only the
    kernels given cases are timed."""
    import torch

    from repro_torch.kernels import basket_decode as bd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref
    from repro_torch.kernels import skim_fused as sf
    from repro_torch.kernels import stream_compact as sc

    out = {}
    rows = []
    for program, (t, v, w, p), arrays, kinds in skim_cases:
        T, E, K = t.shape
        G, D = v.shape[0], p.shape[1]
        # read terms, valid, weights and payload once; write the packed
        # rows (zero tail included) and the count once
        nbytes = 4 * (T * E * K + 2 * G * E * K + 2 * E * D + 1)
        ops = E * K * (T + 4 * G)  # a compare per term slot, the group's AND/sum
        t_bytes, t_ops = bound_times(nbytes, ops)
        # the same rows' bits as int32, and bytes of them as uint8
        p_i32 = p.view(torch.int32)
        p_u8 = (p_i32 & 0xFF).to(torch.uint8)
        row = {
            "ms": device_ms(lambda: sf.skim_fused(t, v, w, p, program, kinds)),
            "int32_ms": device_ms(lambda: sf.skim_fused(t, v, w, p_i32, program, kinds)),
            "uint8_ms": device_ms(lambda: sf.skim_fused(t, v, w, p_u8, program, kinds)),
            "stream_ms": stream_ms(lambda: sf.skim_fused(t, v, w, p, program, kinds)),
            "plain_ms": stream_ms(lambda: ref.skim_fused_ref(t, v, w, p, program, kinds)),
            # the path's whole call: numpy in, one upload, the launch, one
            # readback of counts and rows
            "window_ms": host_ms(lambda: kops.fused_skim(*arrays, program,
                                                         device=t.device, kinds=kinds)),
            "t_bytes": t_bytes, "t_ops": t_ops,
        }
        rows.append(row)
        log(f"  skim_fused T={T} G={G} E={E} K={K} D={D}: kernel {row['ms']:.5f} ms "
            f"on the device (int32 rows {row['int32_ms']:.5f}, uint8 "
            f"{row['uint8_ms']:.5f}), "
            f"{row['stream_ms']:.5f} ms per call from the host; "
            f"numpy to packed rows (ops.fused_skim) {row['window_ms']:.5f} "
            f"ms; plain {row['plain_ms']:.5f} ms; bound {max(t_bytes, t_ops):.7f} ms")
    out["skim_fused"] = _summary(rows)
    if rows:
        for key in ("window_ms", "int32_ms", "uint8_ms"):
            out["skim_fused"][key] = sum(r[key] for r in rows) / len(rows)
    rows = []
    for label, parts, dtypes, layout, staged, dev_out in decode_cases:
        views = kops.round_views(staged, layout)
        descs = layout["descs"]
        N = len(descs)
        W, bits, n = descs[:, 1], descs[:, 3], descs[:, 7]
        # read each basket's planes (n_bits planes of W words) and its
        # first once; write each value once at its branch's own width.
        # The staging's stride and alignment padding and the descriptors
        # are not work the decode needs.
        nbytes = 4 * (int((bits * W).sum()) + N) + sum(
            int(k) * store.itemsize for k, (_, store) in zip(n, layout["stores"]))
        ops = int((W * 32 * (3 * bits + 6)).sum())  # rebuild a code, transform, scan
        t_bytes, t_ops = bound_times(nbytes, ops)
        row = {
            "ms": device_ms(lambda: bd.decode_round(*views, dev_out)),
            "stream_ms": stream_ms(lambda: bd.decode_round(*views, dev_out)),
            "plain_ms": stream_ms(lambda: ref.basket_decode_round_ref(
                *views, layout["out_bytes"]), calls=5),
            # the path's whole call: blob parts in, one upload, the launch,
            # one readback, numpy arrays out
            "round_ms": host_ms(lambda: kops.basket_decode_round(parts, dtypes,
                                                                 staged.device)),
            "t_bytes": t_bytes, "t_ops": t_ops,
        }
        row["per_basket_ms"] = row["ms"] / N
        rows.append(row)
        log(f"  basket_decode {label}: {N} baskets ({sorted(set(descs[:, 4].tolist()))} "
            f"kinds) in one launch: kernel {row['ms']:.5f} ms on the device "
            f"({row['per_basket_ms']:.6f} ms a basket), {row['stream_ms']:.5f} ms per "
            f"call from the host; parts to arrays (ops.basket_decode_round) "
            f"{row['round_ms']:.5f} ms; plain {row['plain_ms']:.5f} ms; bound "
            f"{max(t_bytes, t_ops):.7f} ms")
    out["basket_decode"] = _summary(rows)
    if rows:
        out["basket_decode"]["per_basket_ms"] = (
            sum(r["per_basket_ms"] for r in rows) / len(rows))
        out["basket_decode"]["round_ms"] = sum(r["round_ms"] for r in rows) / len(rows)

    rows, single = [], []
    for program, nb, (t, v, w), packed0, seg, st in stage_cases:
        B, T, E, K = t.shape
        G = v.shape[1]
        planes, stage_rows, kinds = st["planes"], st["rows"], st["kinds"]
        S = len(st["row_list"])
        # the least the stage must move at this run's data: for each event
        # live in the carried mask of a staged window, its K slots of every
        # plane the program reads; the staged windows' mask words read and
        # written, the live events' seg_ids, the (B, nb + 1) output
        live = int(ref.unpack_bits(packed0[stage_rows.long()], E).sum())
        n_read = bin(pe.planes_read(program)).count("1")
        nbytes = 4 * (live * K * n_read + 2 * S * E // 32 + live + B * (nb + 1))
        t_bytes, t_ops = bound_times(nbytes, live * K * (T + 4 * G))
        pk = packed0.clone()

        def restore():
            return pk.copy_(packed0)

        def kernel():  # the path's launch: the staged windows only
            restore()
            return pe.cascade_stage_windows(planes, stage_rows, pk, seg, program, nb,
                                            kinds)

        def dense():  # the same kernel, every window of the batch staged
            restore()
            return pe.cascade_stage(t, v, w, pk, seg, program, nb, kinds)

        # the stage step from the host, as the path calls it: one
        # page-locked upload of the staged buffer, the launch, the summary
        # back
        inputs = kops.CascadeInputs(st["shape"], st["n_groups"], st["row_list"],
                                    t.device)
        inputs.host.copy_(st["host"])
        # the dense batch in the float32 layout the public form reads
        dense_t, dense_v, dense_w = dense_batch(inputs)
        dense_t, dense_w = float32_layout(dense_t, dense_w, kinds)
        dense_np = (dense_t, dense_v, dense_w)

        def step():
            restore()
            kops.stage_summary_host(kops.cascade_stage_step_staged(
                inputs, pk, seg, program, nb, device=t.device, kinds=kinds)[1])

        def public_step():  # the JAX package's form: the dense numpy batch,
            restore()  # staged whole into one page-locked upload
            _, bits, counts = kops.cascade_stage_step(*dense_np, pk, seg, program, nb,
                                                      device=t.device)
            bits.cpu(), counts.cpu()

        copy_ms = device_ms(restore)
        copy_stream = stream_ms(restore)
        row = {
            "ms": device_ms(kernel) - copy_ms,
            "dense_ms": device_ms(dense) - copy_ms,
            "stream_ms": stream_ms(kernel) - copy_stream,
            "plain_ms": stream_ms(lambda: (restore(), pe.cascade_stage_windows_plain(
                planes, stage_rows, pk, seg, program, nb, kinds))) - copy_stream,
            "step_ms": host_ms(step, calls=20),
            "public_step_ms": host_ms(public_step, calls=20),
            "staged_bytes": inputs.nbytes,
            "dense_bytes": 4 * B * (T + 2 * G) * E * K,
            "t_bytes": t_bytes, "t_ops": t_ops,
        }
        rows.append(row)
        log(f"  cascade_stage B={B} staged {S} T={T} G={G} E={E} K={K} nb={nb}, "
            f"{live} live events: kernel {row['ms']:.5f} ms on the device (every "
            f"window staged {row['dense_ms']:.5f}), {row['stream_ms']:.5f} ms per call "
            f"from the host; the step from the host {row['step_ms']:.5f} ms, "
            f"{row['staged_bytes']} bytes in one pinned upload (the public form "
            f"ops.cascade_stage_step on the dense numpy batch, {row['dense_bytes']} "
            f"bytes: {row['public_step_ms']:.5f} ms); plain "
            f"{row['plain_ms']:.5f} ms; bound {max(t_bytes, t_ops):.7f} ms")
        # predicate_eval: window 0 of the same batch, the mask alone
        single.append(time_predicate(program, t[0], v[0], w[0], kinds))
    out["predicate_eval_batch"] = _summary(rows)
    if rows:
        for key in ("dense_ms", "step_ms", "public_step_ms", "staged_bytes",
                    "dense_bytes"):
            out["predicate_eval_batch"][key] = sum(r[key] for r in rows) / len(rows)
    out["predicate_eval"] = _summary(single)
    if single:
        out["predicate_eval"]["shapes"] = [  # bench_kernels' program
            {k: r[k] for k in ("E", "K", "ms", "stream_ms", "plain_ms")}
            | {"bound_ms": max(r["t_bytes"], r["t_ops"])}
            for r in (time_predicate(*case) for case in pred_cases)]
    rows = []
    for program, t, v, w, p, kinds in batch_cases:
        B, T, E, K = t.shape
        G, D = v.shape[1], p.shape[2]
        # B windows of skim_fused's bytes and operations
        nbytes = 4 * B * (T * E * K + 2 * G * E * K + 2 * E * D + 1)
        t_bytes, t_ops = bound_times(nbytes, B * E * K * (T + 4 * G))
        p_i32 = p.view(torch.int32)
        p_u8 = (p_i32 & 0xFF).to(torch.uint8)
        row = {
            "ms": device_ms(lambda: sf.skim_fused_batch(t, v, w, p, program, kinds)),
            "int32_ms": device_ms(lambda: sf.skim_fused_batch(t, v, w, p_i32, program,
                                                              kinds)),
            "uint8_ms": device_ms(lambda: sf.skim_fused_batch(t, v, w, p_u8, program,
                                                              kinds)),
            "stream_ms": stream_ms(lambda: sf.skim_fused_batch(t, v, w, p, program, kinds)),
            "plain_ms": stream_ms(
                lambda: ref.skim_fused_batch_ref(t, v, w, p, program, kinds)),
            "t_bytes": t_bytes, "t_ops": t_ops, "library_ms": None,
        }
        rows.append(row)
        log(f"  skim_fused_batch B={B} T={T} G={G} E={E} K={K} D={D}: kernel "
            f"{row['ms']:.5f} ms on the device (int32 rows {row['int32_ms']:.5f}, "
            f"uint8 {row['uint8_ms']:.5f}), {row['stream_ms']:.5f} ms per call "
            f"from the host; plain {row['plain_ms']:.5f} ms; bound "
            f"{max(t_bytes, t_ops):.7f} ms")
    out["skim_fused_batch"] = _summary(rows)
    if rows:
        for key in ("int32_ms", "uint8_ms"):
            out["skim_fused_batch"][key] = sum(r[key] for r in rows) / len(rows)
    rows = []
    for label, payload, mask in compact_cases:
        E, D = payload.shape
        # read the mask once and the survivors' rows once; write the
        # packed rows, the zero tail and the count once; one test of the
        # mask per row
        row_bytes = D * payload.element_size()
        survivors = int(torch.count_nonzero(mask))
        nbytes = E * mask.element_size() + survivors * row_bytes + E * row_bytes + 4
        t_bytes, t_ops = bound_times(nbytes, E)
        row = {
            "label": label, "E": E, "D": D, "kept": survivors,
            "ms": device_ms(lambda: sc.stream_compact(payload, mask)),
            "stream_ms": stream_ms(lambda: sc.stream_compact(payload, mask)),
            "plain_ms": stream_ms(lambda: ref.stream_compact_ref(payload, mask)),
            # the same survivors in the same order, without the zero tail
            "library_ms": stream_ms(lambda: payload[mask]),
            "t_bytes": t_bytes, "t_ops": t_ops,
        }
        rows.append(row)
        log(f"  stream_compact {label} E={E} D={D} {payload.dtype}, {survivors} kept: "
            f"kernel {row['ms']:.5f} ms on the device, {row['stream_ms']:.5f} ms per "
            f"call from the host; plain "
            f"{row['plain_ms']:.5f} ms; payload[mask] {row['library_ms']:.5f} ms (no "
            f"zero tail); bound {max(t_bytes, t_ops):.7f} ms")
    if rows:
        path = [r for r in rows if r["label"] == "path"]
        out["stream_compact"] = _summary(path)
        out["stream_compact"]["wrapper_us"] = compact_wrapper_steps(*compact_cases[0][1:])
        out["stream_compact"]["shapes"] = [
            {k: r[k] for k in ("label", "E", "D", "kept", "ms", "stream_ms", "plain_ms",
                               "library_ms")}
            | {"bound_ms": max(r["t_bytes"], r["t_ops"])} for r in rows]
    rows = []
    for q, k, v in attn_cases:
        B, H, S, D = q.shape
        half = q.dtype != torch.float32
        # q, k, v read once and the output written once; 2 products of
        # 2 operations per (row, key, column) the causal mask keeps
        t_bytes, _ = bound_times(4 * q.numel() * q.element_size(), 0)
        t_ops = attention_ops_ms(2 * 2 * B * H * D * S * (S + 1) / 2, half)
        scale = ref.attention_scale(D)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)

        def kernel():
            return fa.flash_attention(q, k, v, causal=True)

        row = {
            "case": f"{tuple(q.shape)} {str(q.dtype).removeprefix('torch.')}",
            "library_kernels": profiled_kernels(sdpa),
            "t_bytes": t_bytes, "t_ops": t_ops,
            "ms": device_ms(kernel),
            "stream_ms": stream_ms(kernel),
            "plain_ms": stream_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True)),
            "library_ms": stream_ms(sdpa),
            "library_device_ms": device_ms(sdpa),
        }
        rows.append(row)
        log(f"  flash_attention {row['case']} causal: kernel "
            f"{row['ms']:.5f} ms on the device, {row['stream_ms']:.5f} ms per call "
            f"from the host; plain {row['plain_ms']:.5f} ms; scaled_dot_product_attention "
            f"{row['library_ms']:.5f} ms per call from the host, "
            f"{row['library_device_ms']:.5f} ms on the device, kernels "
            f"{row['library_kernels']}; bound {max(t_bytes, t_ops):.7f} ms "
            f"({'16-bit tensor cores' if half else 'split TF32 on the tensor cores'})")
    out["flash_attention"] = _summary(rows)
    if rows:
        out["flash_attention"]["by_case"] = {
            r["case"]: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                        "library_ms": r["library_ms"],
                        "library_device_ms": r["library_device_ms"],
                        "library_kernels": r["library_kernels"],
                        "bound_ms": max(r["t_bytes"], r["t_ops"])}
            for r in rows}
    return {name: v for name, v in out.items() if v is not None}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def fetch_row(stats) -> dict:
    return {
        "bytes_fetched": stats.bytes_fetched, "requests": stats.requests,
        "by_branch": dict(stats.by_branch), "bytes_skipped": stats.bytes_skipped,
        "requests_skipped": stats.requests_skipped,
        "cascade_bytes_skipped": stats.cascade_bytes_skipped,
    }


def count_calls(store):
    """Count, until the returned function is called, the decode rounds of
    ``store`` that send a bitpack miss to the card (a miss the card
    decodes: not empty, not raw literals) and the calls of
    ``ops.fused_skim``.  Returns (counts, restore)."""
    from repro_torch.data.codecs import bitpack_raw_parts
    from repro_torch.kernels import ops

    counts = {"device_rounds": 0, "window_skims": 0}
    uncached, window = store._decode_round_uncached, ops.fused_skim
    lock = threading.Lock()  # the prefetcher decodes on its own thread

    def on_card(blob) -> bool:
        part = bitpack_raw_parts(blob)
        return part["n"] > 0 and part["kind"] != 3

    def counting_decode(calls):
        # a round's calls, [(branch, blobs), ...] ({branch: blobs} before
        # the round replayed the JAX package's calls)
        pairs = calls.items() if isinstance(calls, dict) else calls
        if (store.codec == "bitpack" and store.resolved_decode_backend() == "device"
                and any(on_card(b) for _, bs in pairs for b in bs)):
            with lock:
                counts["device_rounds"] += 1
        return uncached(calls)

    def counting_window(*a, **k):
        with lock:
            counts["window_skims"] += 1
        return window(*a, **k)

    store._decode_round_uncached = counting_decode
    ops.fused_skim = counting_window

    def restore():
        del store._decode_round_uncached
        ops.fused_skim = window

    return counts, restore


def run_main_path(label, query, store, host_store) -> dict:
    """``run_skim`` with every default on the card: survivors and output
    columns held against the staged reference and the host cascade, the
    fetch ledger against the host cascade of the same plan (the staged
    reference fetches per query stage, not per cascade stage)."""
    import torch

    from repro_torch.core import run_skim
    from repro_torch.kernels import ops

    stats0 = store.decode_backend_stats()
    counts, restore = count_calls(store)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_skim(store, query)  # every default, on the card
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    restore()
    dec = store.decode_backend_stats()

    staged = run_skim(host_store, query, fused=False, pipeline=False, device="cpu")
    host = run_skim(host_store, query, device="cpu")

    plan = res.plan
    kinds = [d.decision for d in plan.window_decisions or ()]
    n_win = -(-store.n_events // store.basket_events)
    windows = (
        {"prune": kinds.count("prune"), "accept_all": kinds.count("accept_all"),
         "scan": kinds.count("scan")} if kinds else {"scan": n_win}
    )
    log(f"  [{label}] {res.n_passed}/{res.n_input} events passed in {wall:.3f} s "
        f"wall ({res.n_input / wall:,.0f} events/s); windows {windows}; "
        f"cascade order {res.extras.get('cascade_order')}")
    log(f"  [{label}] launches on the main path: {launches}; decode tier "
        f"{dec['backend']}: {dec['device_baskets'] - stats0['device_baskets']} "
        f"device baskets, {dec['fallbacks'] - stats0['fallbacks']} fallbacks")
    log(f"  [{label}] fetch: card {fetch_row(res.stats)['bytes_fetched']} B in "
        f"{res.stats.requests} requests; staged reference "
        f"{staged.stats.bytes_fetched} B in {staged.stats.requests} requests "
        "(one request per query stage, not per cascade stage); host cascade "
        f"{host.stats.bytes_fetched} B in {host.stats.requests} requests")

    log(f"  [{label}] decode rounds with a bitpack miss {counts['device_rounds']}, "
        f"per-window skim calls {counts['window_skims']}")
    check(launches["skim_fused"] > 0, f"{label}: skim_fused never launched")
    check(launches["basket_decode"] > 0, f"{label}: basket_decode never launched")
    check(launches["basket_decode"] == counts["device_rounds"],
          f"{label}: {launches['basket_decode']} decode launches for "
          f"{counts['device_rounds']} rounds with a bitpack miss")
    check(launches["skim_fused"] == counts["window_skims"],
          f"{label}: {launches['skim_fused']} skim_fused launches for "
          f"{counts['window_skims']} calls")
    check(dec["backend"] == "device", f"{label}: decode tier is {dec['backend']}")
    check(dec["device_baskets"] > stats0["device_baskets"],
          f"{label}: no basket decoded on the card")
    check(dec["fallbacks"] == 0, f"{label}: {dec['fallbacks']} decode fallbacks")
    for ref_name, ref in (("staged reference", staged), ("host cascade", host)):
        check(res.n_passed == ref.n_passed,
              f"{label}: {res.n_passed} survivors vs {ref.n_passed} ({ref_name})")
        check(res.output.manifest_hash() == ref.output.manifest_hash()
              and res.output._blobs == ref.output._blobs,
              f"{label}: output columns differ from the {ref_name}")
    check(fetch_row(res.stats) == fetch_row(host.stats),
          f"{label}: FetchStats differ from the host cascade of the same plan")
    check(res.extras["cascade_stages"] == host.extras["cascade_stages"]
          and res.extras["cascade_order"] == host.extras["cascade_order"],
          f"{label}: cascade ledgers differ from the host cascade")
    log(f"  [{label}] stage times (s): " + json.dumps(res.breakdown.as_dict()))
    log(f"  [{label}] survivors and output columns (every basket byte) equal "
        "the staged reference and the host cascade; FetchStats and the "
        "stage ledgers equal the host cascade")
    return {"wall_s": wall, "events_per_s": res.n_input / wall,
            "n_passed": res.n_passed, "launches": launches, "res": res,
            "staged": staged}


def run_batched_path(label, query, store, host_store, per_window, batch=16) -> dict:
    """The batched cascade: ``run_skim(..., device_batch=batch)`` on the
    card, held against the staged reference and the per-window card run
    (survivors, every output byte), the port's own host run of the
    batched path (FetchStats, cascade ledgers), and the preload run's
    bytes (fetched + cascade-skipped == preload fetched).  Dispatches are
    logged, not compared: the card's count also holds the device decode
    tier's, which the host store does not run."""
    import torch

    from repro_torch.core import run_skim
    from repro_torch.kernels import ops

    counts, restore = count_calls(store)
    uploads, restore_uploads = count_uploads()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_skim(store, query, device_batch=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    restore()
    restore_uploads()

    host = run_skim(host_store, query, device="cpu", device_batch=batch)
    preload = run_skim(host_store, query, device="cpu", cascade=False)
    pw = per_window["res"]
    log(f"  [{label}, device_batch={batch}] {res.n_passed}/{res.n_input} events "
        f"passed in {wall:.3f} s wall ({res.n_input / wall:,.0f} events/s; "
        f"per-window run {per_window['wall_s']:.3f} s, "
        f"{per_window['events_per_s']:,.0f} events/s); device_dispatches "
        f"{res.extras['device_dispatches']} (per-window run "
        f"{pw.extras['device_dispatches']}); launches {launches}")
    log(f"  [{label}, device_batch={batch}] fetch {res.stats.bytes_fetched} B in "
        f"{res.stats.requests} requests, cascade-skipped "
        f"{res.stats.cascade_bytes_skipped} B; preload run fetched "
        f"{preload.stats.bytes_fetched} B")

    check(launches["cascade_stage"] > 0, f"{label}: cascade_stage never launched")
    check(launches["basket_decode"] > 0, f"{label}: basket_decode never launched")
    check(launches["basket_decode"] == counts["device_rounds"],
          f"{label}: {launches['basket_decode']} decode launches for "
          f"{counts['device_rounds']} rounds with a bitpack miss")
    check(res.extras["device_batch"] == batch, f"{label}: device_batch not reported")
    # launches also hold the warm-ups of shapes first seen in this run
    check(0 < uploads["calls"] <= launches["cascade_stage"]
          and uploads["step_uploads"] == uploads["calls"]
          and uploads["step_pageable"] == 0,
          f"{label}: {uploads['step_uploads']} host-to-device copies "
          f"({uploads['step_pageable']} pageable) in {uploads['calls']} stage "
          f"steps ({launches['cascade_stage']} launches): not one page-locked "
          "copy a step")
    log(f"  [{label}, device_batch={batch}] host-to-device: "
        f"{uploads['step_uploads']} page-locked copies of {uploads['step_bytes']} "
        f"bytes in {uploads['calls']} stage steps; {uploads['uploads']} copies of "
        f"{uploads['bytes']} bytes in the whole run ({uploads['pageable']} pageable)")
    for ref_name, ref in (("staged reference", per_window["staged"]),
                          ("per-window card run", pw)):
        check(res.n_passed == ref.n_passed,
              f"{label}: {res.n_passed} survivors vs {ref.n_passed} ({ref_name})")
        check(res.output.manifest_hash() == ref.output.manifest_hash()
              and res.output._blobs == ref.output._blobs,
              f"{label}: batched output columns differ from the {ref_name}")
    check(fetch_row(res.stats) == fetch_row(host.stats),
          f"{label}: batched FetchStats differ from the host batched run")
    for key in ("cascade_order", "cascade_stages"):
        check(res.extras[key] == host.extras[key],
              f"{label}: batched {key} differs from the host batched run")
    check(res.stats.bytes_fetched + res.stats.cascade_bytes_skipped
          == preload.stats.bytes_fetched,
          f"{label}: fetched + cascade-skipped != the preload run's fetched")
    log(f"  [{label}, device_batch={batch}] survivors and output columns equal "
        "the staged reference and the per-window card run; FetchStats and the "
        "cascade ledgers equal the host batched run; fetched + cascade-skipped "
        "equals the preload run's fetched bytes")
    log(f"  [{label}, device_batch={batch}] stage times (s): "
        + json.dumps(res.breakdown.as_dict()))
    return {"wall_s": wall, "events_per_s": res.n_input / wall,
            "n_passed": res.n_passed, "launches": launches, "uploads": uploads,
            "device_dispatches": res.extras["device_dispatches"],
            "per_window_dispatches": pw.extras["device_dispatches"]}


# ---------------------------------------------------------------------------
# phase 3c: the entry points of the kernels no skim calls
# ---------------------------------------------------------------------------

# eight float32 branches of the NanoAOD-like store (n_filler=8)
COMPACT_BRANCHES = ("MET_pt", "MET_phi") + tuple(f"Filler_{i:03d}" for i in range(6))
# StarCoder2-7B's attention (attic/repro/configs/starcoder2_7b.py): 36 heads
# of head dim 4608/36 = 128, over its attn_chunk of 2048 positions
STARCODER2_7B_ATTN = (1, 36, 2048, 128)


def run_fused_batch_path(label, stage_case, device) -> dict:
    """``ops.fused_skim_batch`` on the first cascade stage's inputs for
    the first 16 padded windows of a cell (as ``run_window_batch`` stages
    them, in the float32 layout the public form reads:
    :func:`float32_layout`), payload column 0 the local event index.  Each window must equal
    ``ops.fused_skim`` (the per-window kernel) on the same window, bit for
    bit: the reference's own contract.  Each window is also held against
    the plain version on the same tensors, bit for bit but for events within
    the MASS residue (as :func:`check_skim_fused_batch`)."""
    import torch

    from repro_torch.kernels import ops, ref

    program, _nb, (t, v, w), *_, st = stage_case
    t, w = float32_layout(t, w, st["kinds"])  # the public form's float32 layout
    B, T, E, K = t.shape
    payload = torch.arange(E, dtype=torch.float32, device=device).repeat(B, 1)
    payload = payload[:, :, None].contiguous()
    ops.reset_launch_counts()
    packed, counts = ops.fused_skim_batch(t, v, w, payload, program)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["skim_fused_batch"]
    check(launches > 0, f"{label}: skim_fused_batch never launched")
    for b in range(B):
        one, n = ops.fused_skim(t[b], v[b], w[b], payload[b], program)
        torch.cuda.synchronize()
        check(int(n) == int(counts[b]) and torch.equal(
            one.view(torch.int32), packed[b].view(torch.int32)),
            f"{label}: fused_skim_batch window {b} differs from fused_skim "
            f"({int(counts[b])} vs {int(n)} survivors)")
    want, want_counts = ref.skim_fused_batch_ref(t, v, w, payload, program)
    torch.cuda.synchronize()
    max_err = max(float((packed - want).abs().max()),
                  float((counts - want_counts).abs().max()))
    edge = 0
    for b in range(B):
        n, wn = int(counts[b]), int(want_counts[b])
        if n == wn and torch.equal(packed[b].view(torch.int32), want[b].view(torch.int32)):
            continue
        edge += packed_edges(f"{label}: fused_skim_batch window {b} vs the plain version",
                             program, t[b], v[b], packed[b], n, want[b], wn)
    log(f"  [{label}] fused_skim_batch B={B} T={T} E={E} K={K}: survivors per "
        f"window {counts.tolist()}; every window equals fused_skim bit for bit "
        f"and the plain version but for {edge} events within the MASS residue; "
        f"launches {launches}")
    return {"launches": launches, "max_abs_err": max_err,
            "case": (program, t, v, w, payload, None)}


def run_compact_path(store, host_store, n_passed: int, device) -> dict:
    """``ops.stream_compact`` on a whole store: the quickstart cell's
    1,000,000-event survivor mask over eight float32 branches.  The mask
    comes from the main path on the card with ``event`` added to the
    output branches (the quickstart query does not write it), which must
    keep the same ``n_passed``.  The packed rows must be the survivors'
    rows of those branches, bit for bit, and the count ``n_passed``."""
    import numpy as np
    import torch

    from repro_torch.core import run_skim
    from repro_torch.kernels import ops

    query = dict(QUICKSTART_QUERY, branches=QUICKSTART_QUERY["branches"] + ["event"])
    res = run_skim(store, query)
    check(res.n_passed == n_passed,
          f"quickstart with event: {res.n_passed} survivors vs {n_passed}")
    mask_host = np.zeros(store.n_events, bool)
    mask_host[res.output.read_flat("event")] = True
    check(int(mask_host.sum()) == n_passed, "quickstart: event indices repeat")
    payload_host = np.stack([host_store.read_flat(b) for b in COMPACT_BRANCHES], axis=1)
    check(payload_host.dtype == np.float32, f"payload is {payload_host.dtype}")
    payload = torch.from_numpy(payload_host).to(device)
    mask = torch.from_numpy(mask_host).to(device)
    ops.reset_launch_counts()
    packed, count = ops.stream_compact(payload, mask)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["stream_compact"]
    check(launches > 0, "stream_compact never launched")
    got = packed.cpu().numpy()
    n = int(count)
    check(n == n_passed, f"stream_compact counted {n}, the skim passed {n_passed}")
    check(got[:n].tobytes() == payload_host[mask_host].tobytes(),
          "stream_compact: packed rows are not the survivors' rows")
    check(not got[n:].view(np.uint32).any(), "stream_compact: tail not zero")
    log(f"  [quickstart] stream_compact of {payload_host.shape} float32 "
        f"({', '.join(COMPACT_BRANCHES)}) by the survivor mask: {n} rows, equal "
        f"to the survivors' rows bit for bit, tail zero; launches {launches}")
    return {"launches": launches, "case": ("path", payload, mask)}


def bench_compact(rng, E: int, device):
    """benchmarks/bench_kernels.py's compaction: (E, 16) float32 rows, 5%
    kept by a bool mask."""
    import torch

    payload = torch.from_numpy(rng.normal(size=(E, 16)).astype("float32")).to(device)
    return payload, torch.from_numpy(rng.random(E) < 0.05).to(device)


def run_predicate_path(label, stage_case, device) -> dict:
    """``ops.predicate_eval`` on each window of a cell's first cascade stage
    over its first 16 windows (as ``run_window_batch`` stages them, in the
    float32 layout the public form reads), one call a window, held against
    the plain version: bit for bit but for
    events within the MASS residue (:func:`_mask_edges`)."""
    import torch

    from repro_torch.kernels import ops, ref

    program, _nb, (t, v, w), *_, st = stage_case
    t, w = float32_layout(t, w, st["kinds"])  # the public form's float32 layout
    B, T, E, K = t.shape
    ops.reset_launch_counts()
    got = torch.stack([ops.predicate_eval(t[b], v[b], w[b], program) for b in range(B)])
    torch.cuda.synchronize()
    launches = ops.launch_counts()["predicate_eval"]
    check(launches == B, f"{label}: {launches} predicate_eval launches for {B} windows")
    want = ref.predicate_eval_batch_ref(t, v, w, program)
    err = float((got - want).abs().max())
    edge = _mask_edges(program, t, v, got, want) if err else 0
    log(f"  [{label}] predicate_eval on each of the first stage's {B} windows (T={T} "
        f"E={E} K={K}): {int(got.sum())} events pass, equal to the plain version but "
        f"for {edge} events within the MASS residue; launches {launches}")
    return {"launches": launches, "max_abs_err": err}


def run_attention_path(rng, device) -> dict:
    """``ops.flash_attention`` at StarCoder2-7B's and Gemma-7B's head
    layouts, causal, in float32, bf16 and float16, held against the plain
    version (:data:`FLASH_TOL`)."""
    import torch

    from repro_torch.kernels import ops, ref

    launches, cases, errs = 0, [], {}
    for shape in (STARCODER2_7B_ATTN, GEMMA_7B_ATTN):
        for dtype_name in FLASH_TOL:
            q, k, v = attention_inputs(rng, shape, getattr(torch, dtype_name), device)
            ops.reset_launch_counts()
            out = ops.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            n = ops.launch_counts()["flash_attention"]
            check(n > 0, f"flash_attention {shape} {dtype_name} never launched")
            launches += n
            want = ref.flash_attention_ref(q, k, v, causal=True)
            errs[f"{shape} {dtype_name}"] = attention_close(
                out, want, dtype_name, f"flash_attention {shape} {dtype_name}")
            cases.append((q, k, v))
            del out, want
    log(f"  flash_attention {STARCODER2_7B_ATTN} (StarCoder2-7B) and {GEMMA_7B_ATTN} "
        f"(Gemma-7B) causal: within tolerance of the plain version, max |err| {errs}; "
        f"launches {launches}")
    return {"launches": launches, "cases": cases, "max_abs_err": max(errs.values())}


# ---------------------------------------------------------------------------
# phase 3d: the serving plane (shared scan, job service, cluster)
# ---------------------------------------------------------------------------


def output_columns(out) -> dict:
    """Every branch of an output store as one array (jagged: its values)."""
    return {name: (out.read_jagged(name)[0] if br.jagged else out.read_flat(name))
            for name, br in out.branches.items()}


def same_output(got, want) -> bool:
    """Every output basket byte equal (the manifest hashes every blob)."""
    return (got.manifest_hash() == want.manifest_hash()
            and got._blobs == want._blobs)


def same_columns(cols: dict, want: dict) -> bool:
    return (sorted(cols) == sorted(want)
            and all(cols[k].dtype == want[k].dtype
                    and cols[k].tobytes() == want[k].tobytes() for k in want))


def count_staging_allocs():
    """Count, until the returned ``restore()``, the buffers the kernels'
    per-thread staging (``ops._Staging``) allocates anew, on any thread,
    how many are page-locked, and the seconds those allocations take.
    Returns (counts, restore)."""
    from repro_torch.kernels import ops

    counts = {"allocs": 0, "pinned": 0, "seconds": 0.0}
    lock, buffer = threading.Lock(), ops._Staging.buffer

    def counting(self, device, name, n, dtype, pinned=False):
        before = self.buffers.get((device, name))
        t0 = time.perf_counter()
        out = buffer(self, device, name, n, dtype, pinned)
        if self.buffers.get((device, name)) is not before:
            with lock:
                counts["allocs"] += 1
                counts["pinned"] += pinned
                counts["seconds"] += time.perf_counter() - t0
        return out

    ops._Staging.buffer = counting

    def restore():
        ops._Staging.buffer = buffer

    return counts, restore


class Launches:
    """The launch counts and the dispatch ledger of one step: set to 0 on
    entry, read on exit (``.launches``, ``.dispatches``)."""

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops

        self._ops = ops
        self._d0 = ops.dispatch_stats()["dispatches"]
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.launches = self._ops.launch_counts()
        self.dispatches = self._ops.dispatch_stats()["dispatches"] - self._d0
        return False


def shared_scan_step(label, store, host_store, tenants, solo, batch=None,
                     per_window=None) -> dict:
    """``SharedScanEngine(store).run_batch(tenants)`` on the card: each
    tenant's survivors and output bytes held against its solo card run
    (phase 3), the shared ledger and each tenant's ledgers against the
    port's host run of the same shared scan; one ``basket_decode`` launch
    per decode round with a bitpack miss and, per window, one
    ``skim_fused`` launch per window skim; with ``batch``, stage steps of
    one page-locked upload each, and outputs equal to the per-window
    shared scan."""
    from repro_torch.serve import SharedScanEngine

    queries = [q for _, q in tenants]
    stats0 = store.decode_backend_stats()
    counts, restore = count_calls(store)
    uploads, restore_uploads = count_uploads()
    try:
        with Launches() as step:
            res = SharedScanEngine(store, device_batch=batch).run_batch(queries)
    finally:
        restore()
        restore_uploads()
    dec = store.decode_backend_stats()
    t0 = time.perf_counter()
    host = SharedScanEngine(host_store, device="cpu",
                            device_batch=batch).run_batch(queries)
    host_s = time.perf_counter() - t0
    launches, name = step.launches, f"shared scan, {label}"
    n_events = store.n_events * len(tenants)
    log(f"  [{name}] {[r.n_passed for r in res.results]} survivors of "
        f"{store.n_events:,} events x {len(tenants)} tenants in "
        f"{step.wall_s:.3f} s wall ({n_events / step.wall_s:,.0f} tenant-events/s); "
        f"amortization {res.amortization:.4f}, saved {res.saved_bytes} B "
        f"(shared {res.shared_stats.bytes_fetched} B, naive "
        f"{res.naive_phase1_bytes} B); launches {launches}; device_dispatches "
        f"{step.dispatches}; decode rounds with a bitpack miss "
        f"{counts['device_rounds']}, window skims {counts['window_skims']}; "
        f"the host run {host_s:.3f} s")
    check(launches["basket_decode"] > 0, f"{name}: basket_decode never launched")
    check(launches["basket_decode"] == counts["device_rounds"],
          f"{name}: {launches['basket_decode']} decode launches for "
          f"{counts['device_rounds']} rounds with a bitpack miss")
    check(launches["skim_fused"] == counts["window_skims"],
          f"{name}: {launches['skim_fused']} skim_fused launches for "
          f"{counts['window_skims']} calls")
    check(dec["fallbacks"] == stats0["fallbacks"],
          f"{name}: {dec['fallbacks'] - stats0['fallbacks']} decode fallbacks")
    if batch:
        check(launches["cascade_stage"] > 0, f"{name}: cascade_stage never launched")
        check(0 < uploads["calls"] <= launches["cascade_stage"]
              and uploads["step_uploads"] == uploads["calls"]
              and uploads["step_pageable"] == 0,
              f"{name}: {uploads['step_uploads']} host-to-device copies "
              f"({uploads['step_pageable']} pageable) in {uploads['calls']} "
              "stage steps: not one page-locked copy a step")
    else:
        check(launches["skim_fused"] > 0, f"{name}: skim_fused never launched")
    check(res.amortization > 1, f"{name}: amortization {res.amortization} <= 1")
    check(fetch_row(res.shared_stats) == fetch_row(host.shared_stats),
          f"{name}: shared_stats differ from the host shared scan")
    for i, ((tenant, _), got, ref_) in enumerate(zip(tenants, res.results, host.results)):
        want = solo[tenant]
        check(got.n_passed == want.n_passed,
              f"{name}: tenant {i} ({tenant}) {got.n_passed} survivors vs "
              f"{want.n_passed} solo")
        check(same_output(got.output, want.output),
              f"{name}: tenant {i} ({tenant}) output differs from its solo card run")
        check(fetch_row(got.stats) == fetch_row(ref_.stats),
              f"{name}: tenant {i} FetchStats differ from the host shared scan")
        for key in ("cascade_stages", "cascade_order"):
            check(got.extras.get(key) == ref_.extras.get(key),
                  f"{name}: tenant {i} {key} differs from the host shared scan")
        if per_window is not None:
            check(same_output(got.output, per_window.results[i].output),
                  f"{name}: tenant {i} output differs from the per-window shared scan")
    log(f"  [{name}] every tenant's survivors and output bytes equal its solo card "
        "run; shared_stats, each tenant's FetchStats and cascade ledgers equal "
        "the host shared scan")
    return {"wall_s": step.wall_s, "tenant_events_per_s": n_events / step.wall_s,
            "amortization": res.amortization, "saved_bytes": res.saved_bytes,
            "launches": launches, "device_dispatches": step.dispatches,
            "host_s": host_s, "res": res}


def service_step(store, tenants, solo) -> dict:
    """The job service on the card: three tenants batched into one shared
    pass, every job DONE with the solo card run's columns; a fourth job
    cancelled after its first window keeps a prefix of the stream; the
    Chrome trace holds the lifecycle and engine spans; a journaled
    service stopped mid-run and recovered streams the same partials as
    one that ran through."""
    from repro_torch.obs import trace_json
    from repro_torch.serve import (
        EngineBackend,
        JobJournal,
        ManualClock,
        SkimService,
        union_columns,
    )

    with Launches() as step:
        svc = SkimService(EngineBackend(store), clock=ManualClock(), batching=True,
                          tracing=True, calibrate=True)
        jobs = [svc.submit(q, tenant=f"t{i}") for i, (_, q) in enumerate(tenants)]
        svc.run_until_idle()
    quanta = svc.executor.quanta
    for i, ((tenant, _), job) in enumerate(zip(tenants, jobs)):
        check(job.state == "DONE", f"service: job {job.job_id} ended {job.state}")
        cols, _ = union_columns(job)
        check(same_columns(cols, solo[tenant + "_cols"]),
              f"service: job {job.job_id} ({tenant}) columns differ from its solo "
              "card run")
        check(same_output(job.result.output, solo[tenant].output),
              f"service: job {job.job_id} ({tenant}) output differs from its solo "
              "card run")

    # cancelled after its first streamed window: a prefix of the stream
    first = jobs[0]
    late = svc.submit(tenants[0][1], tenant="late")
    stream = svc.stream(late.job_id)
    next(stream)
    svc.cancel(late.job_id)
    rest = list(stream)
    check(late.state == "CANCELLED" and not rest and len(late.partials) == 1,
          f"service: the cancelled job ended {late.state} with "
          f"{len(late.partials)} partials")
    for got, want in zip(late.partials, first.partials):
        check((got.start, got.stop, got.n_passed) == (want.start, want.stop,
                                                     want.n_passed)
              and same_columns(got.cols, want.cols),
              "service: the cancelled job's partials are not a prefix of the "
              "solo run's windows")

    doc = json.loads(trace_json(svc.export_trace()))
    kinds = {e.get("cat") for e in doc["traceEvents"]}
    need = {"job", "admission", "queue", "query", "window", "fetch"}
    check(need <= kinds, f"service: the trace lacks span kinds {sorted(need - kinds)}")
    # a decode span names its tier: "decode_device" where the card decodes
    check("decode_device" in kinds,
          f"service: the trace holds no card decode span: {sorted(kinds - {None})}")

    # stop a journaled service after two windows, recover it, compare
    query = tenants[1][1]
    ref_svc = SkimService(EngineBackend(store), clock=ManualClock(),
                          journal=JobJournal())
    ref_job = ref_svc.result(ref_svc.submit(query, tenant="r").job_id)
    journal = JobJournal()
    crashed = SkimService(EngineBackend(store), clock=ManualClock(), journal=journal)
    job = crashed.submit(query, tenant="r")
    while len(job.partials) < 2:
        check(crashed.step(), "service: stalled before the crash point")
    recovered = SkimService.recover(journal, EngineBackend(store), clock=ManualClock())
    done = recovered.result(job.job_id)
    check(done.state == "DONE" and done.resume_skip == 2,
          f"service: the recovered job ended {done.state}, skip {done.resume_skip}")
    check(done.windows_streamed() == ref_job.windows_streamed()[2:]
          and all(a.n_passed == b.n_passed and same_columns(a.cols, b.cols)
                  for a, b in zip(done.partials, ref_job.partials[2:]))
          and same_output(done.result.output, ref_job.result.output),
          "service: the recovered stream differs from the uninterrupted one")
    log(f"  [service] {len(jobs)} batched jobs DONE in {step.wall_s:.3f} s wall "
        f"({store.n_events * len(jobs) / step.wall_s:,.0f} tenant-events/s), "
        f"{quanta} quanta; launches {step.launches}; device_dispatches "
        f"{step.dispatches}; columns equal the solo card runs; the cancelled job "
        f"kept {len(late.partials)} partial (a prefix); the trace holds "
        f"{sorted(kinds - {None})}; the recovered job streamed "
        f"{len(done.partials)} partials equal to the uninterrupted run's suffix")
    return {"wall_s": step.wall_s, "quanta": quanta, "launches": step.launches,
            "device_dispatches": step.dispatches,
            "tenant_events_per_s": store.n_events * len(jobs) / step.wall_s}


def cluster_step(store, tenants, solo, batch=None, shards=None) -> dict:
    """A 4-node cluster with replicas on the card: ``build_cluster(store,
    4, replication=True, concurrency="threads")`` (or, with ``batch``,
    nodes over the same ``shards`` that batch ``batch`` windows a cascade
    stage); the merged output of each query equal to its solo card run,
    from pool threads and serially (a serial coordinator over the same
    nodes), then with node 1 failed (the replica serves, the retry
    ledgered), then one job through ``SkimService(ClusterBackend(...))``.
    The build's launches (re-basketing the shards reads every basket) are
    counted apart from the runs'."""
    from repro_torch.cluster import ClusterCoordinator, StorageNode, build_cluster
    from repro_torch.serve import ClusterBackend, ManualClock, SkimService

    name = "cluster" + (f", device_batch={batch}" if batch else "")
    queries = dict(tenants)
    with Launches() as build:
        if shards is None:
            coord = build_cluster(store, 4, replication=True, concurrency="threads")
        else:
            n = len(shards)
            coord = ClusterCoordinator(
                [StorageNode(sh, device_batch=batch) for sh in shards],
                replicas={sh.shard_id: StorageNode(sh, node_id=n + sh.shard_id,
                                                   device_batch=batch)
                          for sh in shards},
                concurrency="threads", basket_events=store.basket_events,
                codec=store.codec)
    serial = ClusterCoordinator(coord.nodes, replicas=coord.replicas,
                                concurrency="serial",
                                basket_events=store.basket_events, codec=store.codec)
    walls, allocs = {}, {}
    with Launches() as step:
        for conc, c in (("serial", serial), ("threads", coord)):
            allocs[conc], restore = count_staging_allocs()
            t0 = time.perf_counter()
            try:
                for tenant, q in queries.items():
                    res = c.run(q)
                    check(res.n_passed == solo[tenant].n_passed
                          and same_output(res.output, solo[tenant].output),
                          f"{name} ({conc}): {tenant} output differs from its "
                          "solo card run")
            finally:
                restore()
            walls[conc] = time.perf_counter() - t0
        coord.nodes[1].inject_fault("fail")
        failed = coord.run(queries["quickstart"])
        check(same_output(failed.output, solo["quickstart"].output),
              f"{name}: output with node 1 failed differs from the solo card run")
        check(failed.retries and failed.retries[0][0] == 1
              and failed.extras["retry_attempts"] >= 1,
              f"{name}: the replica retry is not ledgered: {failed.retries}, "
              f"{failed.extras.get('retry_attempts')}")
        svc = SkimService(ClusterBackend(coord), clock=ManualClock())
        job = svc.submit(queries["zee"], tenant="c")
        svc.run_until_idle()
        check(job.state == "DONE" and same_output(job.result.output,
                                                  solo["zee"].output),
              f"{name}: the service job over the cluster ended {job.state}")
    launches = step.launches
    # batched nodes run every stage of an all-cascade query as cascade_stage
    kernels = ("basket_decode", "cascade_stage") if batch else (
        "basket_decode", "skim_fused")
    for kernel in kernels:
        check(launches[kernel] > 0, f"{name}: {kernel} never launched")
    log(f"  [{name}] built in {build.wall_s:.3f} s (launches {build.launches}); "
        f"4 nodes + 4 replicas: both queries equal their solo card runs, from "
        f"pool threads in {walls['threads']:.3f} s and serially in "
        f"{walls['serial']:.3f} s wall (staging buffers allocated: threads "
        f"{allocs['threads']}, serial {allocs['serial']}); node 1 failed: retries "
        f"{failed.retries}, "
        f"retry_attempts {failed.extras['retry_attempts']}, output equal; a service "
        f"job over the cluster DONE; launches {launches}; device_dispatches "
        f"{step.dispatches} (threads add to one process-wide ledger)")
    total = {k: launches[k] + build.launches[k] for k in launches}
    return {"serial_s": walls["serial"], "threads_s": walls["threads"],
            "build_s": build.wall_s, "wall_s": step.wall_s, "launches": total,
            "staging_allocs": allocs,
            "build_launches": build.launches, "device_dispatches": step.dispatches,
            "shards": [node.shard for node in coord.nodes]}


def run_serving_plane(store, host_store, results) -> dict:
    """Phase 3d at full size on the NanoAOD-like store: tenants quickstart,
    Z->ee and quickstart again, each held against its solo card run of
    phase 3 (itself held there against the staged reference)."""
    tenants = [("quickstart", QUICKSTART_QUERY), ("zee", zee_query(store.n_events)),
               ("quickstart", QUICKSTART_QUERY)]
    solo = {}
    for label in ("quickstart", "zee"):
        solo[label] = results[label]["res"]
        solo[label + "_cols"] = output_columns(solo[label].output)
    out = {"shared": shared_scan_step("per window", store, host_store, tenants, solo)}
    out["shared_batched"] = shared_scan_step(
        "device_batch=16", store, host_store, tenants, solo, batch=16,
        per_window=out["shared"]["res"])
    out["service"] = service_step(store, tenants, solo)
    out["cluster"] = cluster_step(store, tenants, solo)
    out["cluster_batched"] = cluster_step(store, tenants, solo, batch=16,
                                          shards=out["cluster"]["shards"])
    return out


# ---------------------------------------------------------------------------
# phase 3e: the mesh skim (sharded_skim over torch.distributed)
# ---------------------------------------------------------------------------

MESH_NAMES = ("pod", "data", "model")
MESH_RANKS = (2, 2, 1)  # four ranks on the one card, over gloo
MESH_ARRAYS = ("terms", "valid", "weights", "payload")
MESH_RANK_TIMEOUT_S = 300


def mesh_inputs(query, host_store):
    """The whole store's padded inputs for ``query``'s filter branches (host
    numpy), at the K that truncates no object (``window_pad_K``), the
    payload the event index and ``MET_pt``."""
    from repro_torch.core import parse_query
    from repro_torch.core.neardata import build_padded_inputs, compile_query, window_pad_K

    q = parse_query(query)
    program = compile_query(q)
    data = {}
    for b in sorted(set(q.filter_branches())):
        br = host_store.branches.get(b)
        if br is None:
            continue  # an absent trigger branch: the zero page
        if br.jagged:
            data[b], data[br.counts_branch] = host_store.read_jagged(b)
        else:
            data[b] = host_store.read_flat(b)
    K = window_pad_K(data, program, host_store)
    pb = build_padded_inputs(data, program, host_store, K=K, include_index=True,
                             payload_branches=["MET_pt"], to_device=False)
    return program, pb


def mesh_shard(mesh, names, axes=("pod", "data")) -> tuple[int, int]:
    """(this rank's shard, the number of shards): row-major over the data
    axes of the mesh, the first outermost (``sharded_skim``'s layout)."""
    shard, n = 0, 1
    for d, a in enumerate(names):
        if a in axes:
            shard = shard * mesh.size(d) + mesh.get_local_rank(d)
            n *= mesh.size(d)
    return shard, n


def run_mesh_world1(cases, results, device, tmp) -> dict:
    """Phase 3e (a): ``sharded_skim`` at world size 1, mesh (1, 1, 1), NCCL
    (gloo for a CPU rehearsal), the group started from a ``HashStore``: no
    port is opened.  Per query: the total equals phase 3's survivors, the
    mask and the packed rows equal the plain versions on the same tensors
    bit for bit, one ``predicate_eval`` and one ``stream_compact`` launch a
    call; then the step's host-to-host time, each kernel's device time at
    the shard's shapes beside its bound, and the all_reduce's time.  Saves
    each query's arrays and mask to ``tmp`` for (b)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.neardata import sharded_skim
    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_compact as sc

    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    out = {}
    try:
        mesh = init_device_mesh(device.type, (1, 1, 1), mesh_dim_names=MESH_NAMES)
        for label, program, pb in cases:
            arrays = [getattr(pb, name) for name in MESH_ARRAYS]
            (T, E, K), G, D = pb.terms.shape, pb.valid.shape[0], pb.payload.shape[1]
            fn = sharded_skim(mesh, program)
            with Launches() as step:
                packed, mask, total = fn(*arrays)
            n = int(total)
            launches = {k: v for k, v in step.launches.items() if v}
            check(n == results[label]["n_passed"],
                  f"mesh skim [{label}]: total {n}, phase 3 passed "
                  f"{results[label]['n_passed']}")
            check(launches == {"predicate_eval": 1, "stream_compact": 1},
                  f"mesh skim [{label}]: launches {launches}, not one predicate_eval "
                  "and one stream_compact")
            t, v, w, p = (torch.from_numpy(x).to(device) for x in arrays)
            want = ref.predicate_eval_ref(t, v, w, program)
            want_packed, want_n = ref.stream_compact_ref(p, want)
            mask_err = float((mask - want.to(torch.int32)).abs().max())
            check(mask_err == 0 and mask.dtype == torch.int32,
                  f"mesh skim [{label}]: the mask differs from predicate_eval_ref")
            check(int(want_n) == n and torch.equal(packed.view(torch.int32),
                                                   want_packed.view(torch.int32)),
                  f"mesh skim [{label}]: packed rows differ from stream_compact_ref")
            check(packed[:n, 0].to(torch.int64).equal(torch.nonzero(want).squeeze(1)),
                  f"mesh skim [{label}]: the packed event indices are not the survivors")
            (tmp / label).mkdir()
            for name, x in zip(MESH_ARRAYS, arrays):
                np.save(tmp / label / f"{name}.npy", x)
            np.save(tmp / label / "mask.npy", mask.cpu().numpy())

            def call():
                return int(fn(*arrays)[2])

            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                call()
                walls.append((time.perf_counter() - t0) * 1e3)
            fn_ms = sorted(walls)[len(walls) // 2]
            keep = mask != 0
            n_read = bin(pe.planes_read(program) & ((1 << (T + 2 * G)) - 1)).count("1")
            pe_bound = bound_times(4 * (n_read * E * K + E), E * K * (T + 4 * G))
            row_bytes = 4 * D
            sc_bound = bound_times(E * keep.element_size() + n * row_bytes
                                   + E * row_bytes + 4, E)
            count = torch.zeros((), dtype=torch.int32, device=device)
            group = mesh.get_group(MESH_NAMES.index("data"))

            def reduce():
                dist.all_reduce(count, group=group)
                torch.cuda.synchronize()

            row = {
                "T": T, "G": G, "E": E, "K": K, "D": D, "total": n,
                "launches": launches, "mask_err": mask_err,
                "fn_ms": fn_ms, "fn_walls_ms": walls,
                "predicate_eval_ms": device_ms(lambda: pe.predicate_eval(t, v, w, program)),
                "predicate_eval_bound_ms": max(pe_bound),
                "stream_compact_ms": device_ms(lambda: sc.stream_compact(p, keep)),
                "stream_compact_bound_ms": max(sc_bound),
                "all_reduce_ms": host_ms(reduce, calls=50),
            }
            out[label] = row
            log(f"  [{label}] (a) world size 1, mesh (1, 1, 1) {MESH_NAMES}, "
                f"{dist.get_backend()}: T={T} G={G} E={E} K={K} D={D}; total {n} "
                f"(phase 3: {results[label]['n_passed']}); mask and packed rows equal "
                f"predicate_eval_ref and stream_compact_ref on the same tensors bit "
                f"for bit; launches {launches}")
            log(f"  [{label}] (a) fn host to host {fn_ms:.3f} ms (median of 5: numpy "
                f"in, the shard uploaded, the total read back; {[round(x, 3) for x in walls]}); "
                f"predicate_eval {row['predicate_eval_ms']:.5f} ms on the device (bound "
                f"{row['predicate_eval_bound_ms']:.5f}: {n_read} planes read); "
                f"stream_compact {row['stream_compact_ms']:.5f} ms (bound "
                f"{row['stream_compact_bound_ms']:.5f}); all_reduce of the count "
                f"{row['all_reduce_ms']:.5f} ms host to host")
            del t, v, w, p, want, want_packed, packed, mask, keep
    finally:
        dist.destroy_process_group()
    return out


def mesh_rank(rank, n, tmp, cases, device_type, shape) -> None:
    """One rank of phase 3e (b), spawned: the group over gloo from a
    ``FileStore`` in ``tmp``, ``sharded_skim`` over ``shape`` on each
    query's arrays mapped from (a)'s files (only this rank's block is
    read).  Writes ``rank<r>.json``: its launches, whether its block equals
    the plain compaction of its slice of (a)'s mask, its total."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import parse_query
    from repro_torch.core.neardata import compile_query, sharded_skim
    from repro_torch.kernels import ops, ref

    tmp = Path(tmp)
    on_card = device_type == "cuda"
    if on_card:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "rendezvous"), n),
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=MESH_RANK_TIMEOUT_S))
    try:
        mesh = init_device_mesh(device_type, shape, mesh_dim_names=MESH_NAMES)
        shard, n_shards = mesh_shard(mesh, MESH_NAMES)
        device = torch.device("cuda", 0) if on_card else torch.device("cpu")
        report = {"rank": rank, "shard": shard, "n_shards": n_shards}
        for label, query in cases:
            program = compile_query(parse_query(query))
            arrays = [np.load(tmp / label / f"{name}.npy", mmap_mode="r")
                      for name in MESH_ARRAYS]
            fn = sharded_skim(mesh, program)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            packed, mask, total = fn(*arrays)
            if on_card:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            size = arrays[3].shape[0] // n_shards
            rows = slice(shard * size, (shard + 1) * size)
            want_mask = torch.from_numpy(
                np.load(tmp / label / "mask.npy", mmap_mode="r")[rows].copy()).to(device)
            payload = torch.from_numpy(np.array(arrays[3][rows])).to(device)
            want, want_n = ref.stream_compact_ref(payload, want_mask)
            report[label] = {
                "launches": launches, "total": int(total), "wall_ms": wall_ms,
                "rows": [rows.start, rows.stop], "kept": int(want_n),
                "mask_equal": bool(torch.equal(mask, want_mask)),
                "packed_equal": bool(torch.equal(packed.view(torch.int32),
                                                 want.view(torch.int32))),
            }
        (tmp / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def run_mesh_ranks(cases, world1, device, tmp) -> dict:
    """Phase 3e (b): four ranks on one card over gloo (NCCL refuses two
    ranks on one GPU), mesh (2, 2, 1), spawned with ``torch.multiprocessing``
    and met through a ``FileStore``; each rank's block must equal the plain
    compaction of its slice of (a)'s mask, its total (a)'s, with one launch
    of each kernel a call.  A rank that fails, or does not end within
    :data:`MESH_RANK_TIMEOUT_S`, fails the phase; every rank is stopped."""
    import torch.multiprocessing as mp

    n = MESH_RANKS[0] * MESH_RANKS[1] * MESH_RANKS[2]
    ctx = mp.start_processes(
        mesh_rank, args=(n, str(tmp), [(label, query) for label, query in cases],
                         device.type, MESH_RANKS),
        nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_RANK_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"mesh skim (b): the ranks did not end within {MESH_RANK_TIMEOUT_S} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
        raise SmokeFailure(f"mesh skim (b): a rank failed: {exc}") from exc
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(10)
    reports = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(n)]
    shards = sorted(r["shard"] for r in reports)
    check(shards == list(range(4)) and all(r["n_shards"] == 4 for r in reports),
          f"mesh skim (b): shards {shards}")
    launches = dict.fromkeys(("predicate_eval", "stream_compact"), 0)
    for label, _ in cases:
        for r in reports:
            got = r[label]
            check(got["launches"] == {"predicate_eval": 1, "stream_compact": 1},
                  f"mesh skim (b) [{label}] rank {r['rank']}: launches {got['launches']}")
            check(got["mask_equal"] and got["packed_equal"],
                  f"mesh skim (b) [{label}] rank {r['rank']}: its block differs from "
                  "the plain compaction of its slice of (a)'s mask")
            check(got["total"] == world1[label]["total"],
                  f"mesh skim (b) [{label}] rank {r['rank']}: total {got['total']}, "
                  f"(a) {world1[label]['total']}")
            for k in launches:
                launches[k] += got["launches"].get(k, 0)
        kept = {r["shard"]: r[label]["kept"] for r in reports}
        check(sum(kept.values()) == world1[label]["total"],
              f"mesh skim (b) [{label}]: the shards keep {kept}")
        log(f"  [{label}] (b) 4 ranks on one card over gloo, mesh {MESH_RANKS}: every "
            f"rank's total {world1[label]['total']} equals (a)'s; each block equals the "
            f"plain compaction of its slice of (a)'s mask bit for bit; kept per shard "
            f"{[kept[s] for s in sorted(kept)]}; one launch of each kernel a rank; "
            f"first-call walls {[round(r[label]['wall_ms'], 1) for r in reports]} ms")
    return {"launches": launches, "reports": reports}


def run_mesh_skim(host_store, results, device) -> dict:
    """Phase 3e: the mesh skim on the whole NanoAOD-like store, for the
    quickstart and Z->ee queries: (a) at world size 1, then (b) four ranks."""
    import tempfile

    queries = [("quickstart", QUICKSTART_QUERY), ("zee", zee_query(host_store.n_events))]
    with tempfile.TemporaryDirectory(prefix="mesh_skim_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        cases = [(label, *mesh_inputs(query, host_store)) for label, query in queries]
        log(f"  the store read and padded for both queries in "
            f"{time.perf_counter() - t0:.1f} s")
        world1 = run_mesh_world1(cases, results, device, tmp)
        del cases
        ranks = run_mesh_ranks(queries, world1, device, tmp)
    launches = {k: len(world1) + v for k, v in ranks["launches"].items()}
    return {"world1": world1, "ranks": ranks["reports"], "launches": launches,
            "max_abs_err": max(r["mask_err"] for r in world1.values())}


# ---------------------------------------------------------------------------
# phase 3f: the five examples, on the card and on the host
# ---------------------------------------------------------------------------


def run_example(name: str, device: str) -> dict:
    """``repro_torch.examples.<name>.main(["--device", device])`` in this
    process at its default size: its stdout, wall time and launches
    (counted from 0), each ``SkimEngine.run`` it made (mode, input link,
    the unrounded ``Breakdown``, ``busy_fraction``) and the
    ``basket_decode`` launches of each ``build_cluster`` call.  The module's
    ``SkimEngine`` and ``build_cluster`` are wrapped for the run only, and
    the wrappers return what the real ones return."""
    import contextlib
    import importlib
    import io

    from repro_torch.kernels import ops

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    runs, builds, wrapped = [], [], {}
    if hasattr(mod, "SkimEngine"):
        class RecordingEngine(mod.SkimEngine):
            def run(self, query, mode="near_data", **kw):
                res = super().run(query, mode, **kw)
                runs.append({"mode": mode, "gbps": self.input_link.bandwidth_gbps,
                             "breakdown": res.breakdown.as_dict(),
                             "busy_fraction": res.busy_fraction})
                return res

        wrapped["SkimEngine"] = RecordingEngine
    if hasattr(mod, "build_cluster"):
        build = mod.build_cluster

        def counted_build(*args, **kw):
            before = ops.launch_counts()["basket_decode"]
            coord = build(*args, **kw)
            builds.append(ops.launch_counts()["basket_decode"] - before)
            return coord

        wrapped["build_cluster"] = counted_build
    saved = {k: getattr(mod, k) for k in wrapped}
    buf = io.StringIO()
    try:
        for k, v in wrapped.items():
            setattr(mod, k, v)
        with Launches() as step, contextlib.redirect_stdout(buf):
            mod.main(["--device", device])
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)
    return {"text": buf.getvalue(), "wall_s": step.wall_s, "launches": step.launches,
            "runs": runs, "builds": builds}


def example_pair(name: str) -> dict:
    """One example on the card, then on the host: every line but the device
    line equal once the wall-clock values (``examples.CLOCK_FIELDS``) are
    masked, ``basket_decode`` and ``skim_fused`` launched on the card, and
    nothing launched by the host run."""
    from repro_torch.examples import mask_clock

    card = run_example(name, "cuda")
    host = run_example(name, "cpu")
    lines, masked = mask_clock(name, card["text"])
    host_lines, host_masked = mask_clock(name, host["text"])
    check(lines[0].startswith("device: cuda") and host_lines[0] == "device: cpu",
          f"example {name}: device lines {lines[0]!r} / {host_lines[0]!r}")
    diff = [(a, b) for a, b in zip(lines[1:], host_lines[1:]) if a != b]
    check(len(lines) == len(host_lines) and not diff,
          f"example {name}: {len(diff)} lines differ between the card and the host "
          f"({len(lines)} / {len(host_lines)} lines), first {diff[:2]}")
    check(masked == host_masked, f"example {name}: masked {masked} / {host_masked}")
    for kernel in ("basket_decode", "skim_fused"):
        check(card["launches"][kernel] > 0,
              f"example {name}: no {kernel} launch on the card")
    check(not any(host["launches"].values()),
          f"example {name}: the host run launched {host['launches']}")
    return {"card": card, "host": host, "lines": len(lines) - 1, "masked": sorted(masked),
            "launches": card["launches"]}


PLACEMENTS = ("client_plain", "client_opt", "server_side", "near_data")  # skim_service.MODES
PLACEMENT_GBPS = (1, 10, 100)


def placement_table(pair) -> dict:
    """The paper's four placements from ``skim_service``'s table: per mode
    and link, the ``Breakdown`` total (measured stages + the modeled link)
    and ``busy_fraction``, on the card and on the host, unrounded."""
    table = {}
    for side in ("card", "host"):
        runs = pair[side]["runs"]
        check(len(runs) == len(PLACEMENTS) * len(PLACEMENT_GBPS) + 1,
              f"skim_service made {len(runs)} SkimEngine runs")
        for run, (mode, gbps) in zip(runs, [(m, g) for m in PLACEMENTS
                                            for g in PLACEMENT_GBPS]):
            check((run["mode"], run["gbps"]) == (mode, float(gbps)),
                  f"skim_service ran {run['mode']} at {run['gbps']} Gb/s in {mode}'s place")
            table.setdefault(mode, {}).setdefault(side, {})[f"{gbps} Gb/s"] = {
                "total_s": run["breakdown"]["total"],
                "busy_fraction": run["busy_fraction"], "breakdown": run["breakdown"]}
        table.setdefault("near_data breakdown", {})[side] = runs[-1]["breakdown"]
    for mode in PLACEMENTS:
        log(f"  placement [{mode}] Breakdown.total() s at 1 / 10 / 100 Gb/s (links "
            "modeled): card " + " / ".join(
                str(table[mode]["card"][f"{g} Gb/s"]["total_s"]) for g in PLACEMENT_GBPS)
            + ", host " + " / ".join(
                str(table[mode]["host"][f"{g} Gb/s"]["total_s"]) for g in PLACEMENT_GBPS)
            + "; busy_fraction card " + " / ".join(
                str(table[mode]["card"][f"{g} Gb/s"]["busy_fraction"])
                for g in PLACEMENT_GBPS)
            + ", host " + " / ".join(
                str(table[mode]["host"][f"{g} Gb/s"]["busy_fraction"])
                for g in PLACEMENT_GBPS))
    return table


def run_examples() -> tuple[dict, dict]:
    """Phase 3f: each of the five examples at its default size, on the card
    and on the host (:func:`example_pair`), then the placement table."""
    from repro_torch.examples import EXAMPLES

    out = {}
    for name in EXAMPLES:
        pair = example_pair(name)
        log(f"  [{name}] card {pair['card']['wall_s']:.3f} s, host "
            f"{pair['host']['wall_s']:.3f} s; {pair['lines']} lines equal, masked "
            f"{pair['masked']}; launches on the card "
            + json.dumps({k: v for k, v in pair["launches"].items() if v}, sort_keys=True)
            + (f", of them basket_decode in build_cluster {pair['card']['builds']}"
               if pair["card"]["builds"] else ""))
        out[name] = pair
    return out, placement_table(out["skim_service"])


# ---------------------------------------------------------------------------
# phase 3g: non-finite values (NaN, ±inf, -0.0) on the card
# ---------------------------------------------------------------------------


def check_nonfinite_window(backend: str, device) -> dict:
    """:func:`nonfinite_window`'s eight events through ``fused_window_skim``
    for each of :data:`NONFINITE_WINDOW_QUERIES`, at the K the engine picks
    and at K = 8: the mask of ``backend`` equal to the host evaluator's.
    Returns the host masks by query."""
    import numpy as np

    from repro_torch.core.neardata import fused_window_skim
    from repro_torch.core.planner import plan_skim
    from repro_torch.core.query import parse_query
    from repro_torch.data.store import EventStore

    columns, jagged = nonfinite_window()
    n = len(columns["MET_pt"])
    store = EventStore.from_arrays(columns, jagged=jagged, basket_events=n,
                                   device="cpu")
    masks = {}
    for name, q in NONFINITE_WINDOW_QUERIES.items():
        plan = plan_skim(parse_query(q), store)
        program = plan.compiled_program()
        data = {b: columns[b] for b in plan.filter_branches}
        want, _ = fused_window_skim(data, program, store, backend="host")
        for K in (None, 8):
            got, _ = fused_window_skim(data, program, store, backend=backend, K=K,
                                       device=device)
            check(np.array_equal(got, want),
                  f"non-finite window, {name}, K={K}: {backend} keeps "
                  f"{np.nonzero(got)[0].tolist()}, the host evaluator "
                  f"{np.nonzero(want)[0].tolist()}")
        masks[name] = np.nonzero(want)[0].tolist()
    return masks


def mass_residue(label, store, query, device) -> int:
    """Events of the host ``store`` that the card (the CUDA skim over the
    whole store as one window) and the host evaluator decide differently
    for ``query``.  The plain version must equal the host evaluator
    exactly; each card difference must be a MASS event within the residue
    (:func:`edge_events`) and is logged with the host's value and the
    bound.  Returns the card's survivors less the host evaluator's."""
    import numpy as np
    import torch

    from repro_torch.core.neardata import (build_padded_inputs, fused_window_skim,
                                           window_pad_K)
    from repro_torch.core.planner import plan_skim
    from repro_torch.core.query import parse_query
    from repro_torch.kernels.program import GROUP_MASS

    plan = plan_skim(parse_query(query), store)
    program = plan.compiled_program()
    data = {b: store.read_jagged(b)[0] if store.branches[b].jagged
            else store.read_flat(b) for b in plan.filter_branches}
    host, _ = fused_window_skim(data, program, store, backend="host")
    plain, _ = fused_window_skim(data, program, store, backend="torch", device="cpu")
    check(np.array_equal(plain, host),
          f"{label}: the plain version and the host evaluator differ at events "
          f"{np.nonzero(plain != host)[0][:8].tolist()}")
    card, _ = fused_window_skim(data, program, store, backend="cuda", device=device)
    diff = np.nonzero(card != host)[0]
    if len(diff) == 0:
        return 0
    padded = build_padded_inputs(data, program, store, K=window_pad_K(data, program, store),
                                 to_device=False)
    terms, valid = (torch.as_tensor(np.asarray(x)) for x in (padded.terms, padded.valid))
    check(edge_events(program, terms, valid, diff),
          f"{label}: the card and the host evaluator differ at events "
          f"{diff[:8].tolist()}, outside the MASS residue")
    for g, grp in enumerate(program.groups):
        if grp.kind != GROUP_MASS:
            continue
        m, _, scale = (x.numpy() for x in mass_scale(program, g, terms, valid))
        for e in diff[:8].tolist():
            log(f"  {label}: event {e} kept by the card {bool(card[e])}, by the host "
                f"{bool(host[e])}; group {g}'s mass {float(m[e])!r} (host), the "
                f"residue's bound on its square {MASS_RESIDUE_N * 2.0 ** -53 * scale[e]!r}")
    return int(card.sum()) - int(host.sum())


def run_nonfinite_path(device, n_events: int = NONFINITE_EVENTS, batch: int = 16) -> dict:
    """Phase 3g: a store of ``n_events`` holding NaN, ±inf and -0.0
    (:func:`make_nonfinite_stores`) through ``run_skim`` on the card, per
    window and with ``device_batch=batch``, decode on the card, for every
    query of :func:`nonfinite_queries`.  The host runs of the same paths
    through the kernels' plain versions (``fused_backend="torch"`` per
    window; the batched path's plain version) equal the port's staged run
    in survivors and output bytes.  Each card run equals the host run of
    its path in survivors, output bytes, FetchStats, cascade ledgers and
    plan, and keeps fetched + cascade-skipped == the preload run's fetched
    bytes; where it does not, every event the card decides otherwise must
    be a MASS event within the residue (:func:`mass_residue`, logged).
    Launches are counted from 0 around each card run."""
    import torch

    from repro_torch.core import run_skim
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    store, host = make_nonfinite_stores(n_events)
    store.decode_backend = "device"
    log(f"  store: {n_events:,} events, {len(store.branch_names())} branches, "
        f"{store.compressed_bytes() / 1e6:.1f} MB compressed, built twice in "
        f"{time.perf_counter() - t0:.1f} s")
    masks = check_nonfinite_window("cuda", device)
    log("  the eight-event window: masks of the CUDA kernel equal the host "
        "evaluator's for every query, at the engine's K and at K = 8: "
        + json.dumps(masks))
    stats0 = store.decode_backend_stats()
    launches = dict.fromkeys(ops.launch_counts(), 0)
    survivors, residues = {}, {}
    card_s = 0.0
    for name, q in nonfinite_queries(n_events).items():
        staged = run_skim(host, q, fused=False, pipeline=False, device="cpu")
        preload = run_skim(host, q, device="cpu", cascade=False)
        runs = {"staged": staged.n_passed}
        for label, kw in (("per window", {"fused_backend": "torch"}),
                          (f"device_batch={batch}", {"device_batch": batch})):
            what = f"non-finite store, {name}, {label}"
            plain = run_skim(host, q, device="cpu", **kw)
            check(plain.n_passed == staged.n_passed
                  and plain.output._blobs == staged.output._blobs,
                  f"{what}: the plain version's host run keeps {plain.n_passed} "
                  f"events, the staged run {staged.n_passed}, or their bytes differ")
            card_kw = {k: v for k, v in kw.items() if k != "fused_backend"}
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = run_skim(store, q, **card_kw)
            torch.cuda.synchronize()
            card_s += time.perf_counter() - t1
            for k, v in ops.launch_counts().items():
                launches[k] += v
            runs[label] = res.n_passed
            if (res.n_passed != plain.n_passed
                    or res.output._blobs != plain.output._blobs):
                if name not in residues:
                    residues[name] = mass_residue(name, host, q, device)
                check(res.n_passed - plain.n_passed == residues[name] != 0,
                      f"{what}: {res.n_passed} survivors vs {plain.n_passed} (plain "
                      f"version), not the {residues[name]:+d} of the MASS residue")
                continue
            check(res.output.manifest_hash() == plain.output.manifest_hash(),
                  f"{what}: output columns differ from the plain version's host run")
            check(fetch_row(res.stats) == fetch_row(plain.stats),
                  f"{what}: FetchStats differ from the plain version's host run")
            for key in ("cascade_order", "cascade_stages"):
                check(res.extras.get(key) == plain.extras.get(key),
                      f"{what}: {key} differs from the plain version's host run")
            check(res.plan.describe() == plain.plan.describe(),
                  f"{what}: the plan differs from the host run's")
            check(res.stats.bytes_fetched + res.stats.cascade_bytes_skipped
                  == preload.stats.bytes_fetched,
                  f"{what}: fetched + cascade-skipped != the preload run's fetched")
        survivors[name] = runs
    dec = store.decode_backend_stats()
    check(dec["device_baskets"] > stats0["device_baskets"] and dec["fallbacks"] == 0,
          f"non-finite store: decode on the card {dec}")
    for kernel in ("skim_fused", "cascade_stage", "basket_decode"):
        check(launches[kernel] > 0, f"non-finite store: {kernel} never launched")
    exact = [n for n in survivors if n not in residues]
    log(f"  {len(survivors)} queries: every host run through the plain versions "
        "equals the staged reference in survivors and output bytes; the card runs "
        f"of {len(exact)} equal the host runs of their paths (survivors, output "
        "bytes, FetchStats, cascade ledgers, plan); within the MASS residue "
        f"(survivors against the host): {json.dumps(residues)}; mass-jets "
        f"{json.dumps(survivors.get('mass-jets'))}; card runs {card_s:.3f} s in all; "
        f"launches {json.dumps(launches)}; decode tier "
        f"{dec['device_baskets'] - stats0['device_baskets']} device baskets, "
        f"{dec['fallbacks']} fallbacks")
    log("  survivors (staged, card per window, card batched): "
        + json.dumps(survivors))
    return {"launches": launches, "survivors": survivors, "residues": residues,
            "card_s": card_s}


def run_int_path(device, n_events: int = INT_STORE_EVENTS, batch: int = 16) -> dict:
    """Phase 3h: :func:`make_int_stores`' store (``event`` past 10^9, an
    int32 word across -2^31, ``Jet_id`` beside 2^24, non-bool trigger
    words) through ``run_skim`` on the card, per window and with
    ``device_batch=batch``, decode on the card, for every query of
    :func:`int_queries`: each card run equal to the port's staged run on the
    host store in survivors and output bytes, and the picks keeping their
    one event.  Launches are counted from 0 around each card run."""
    import torch

    from repro_torch.core import run_skim
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    store, host = make_int_stores(n_events)
    store.decode_backend = "device"
    log(f"  store: {n_events:,} events, {len(store.branch_names())} branches, "
        f"{store.compressed_bytes() / 1e6:.1f} MB compressed, built twice in "
        f"{time.perf_counter() - t0:.1f} s")
    stats0 = store.decode_backend_stats()
    launches = dict.fromkeys(ops.launch_counts(), 0)
    survivors = {}
    card_s = 0.0
    for name, q in int_queries(INT_STORE_BASE, n_events).items():
        staged = run_skim(host, q, fused=False, pipeline=False, device="cpu")
        runs = {"staged": staged.n_passed}
        for label, kw in (("per window", {}), (f"device_batch={batch}",
                                               {"device_batch": batch})):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = run_skim(store, q, **kw)
            torch.cuda.synchronize()
            card_s += time.perf_counter() - t1
            counts = ops.launch_counts()
            for k, v in counts.items():
                launches[k] += v
            kernel = "cascade_stage" if kw else "skim_fused"
            check(counts[kernel] > 0, f"int store, {name}, {label}: {kernel} never "
                  "launched")
            check(res.n_passed == staged.n_passed
                  and res.output._blobs == staged.output._blobs
                  and res.output.manifest_hash() == staged.output.manifest_hash(),
                  f"int store, {name}, {label}: {res.n_passed} survivors on the card, "
                  f"{staged.n_passed} in the staged run, or their bytes differ")
            runs[label] = res.n_passed
        survivors[name] = runs
    for name in ("event-pick", "run-lumi-event"):
        check(survivors[name]["staged"] == 1,
              f"int store, {name}: the staged run keeps {survivors[name]['staged']} "
              "events, not the one picked")
    dec = store.decode_backend_stats()
    check(dec["device_baskets"] > stats0["device_baskets"] and dec["fallbacks"] == 0,
          f"int store: decode on the card {dec}")
    log(f"  {len(survivors)} queries: every card run, per window and batched, equals "
        "the staged run in survivors and output bytes; card runs "
        f"{card_s:.3f} s in all; launches {json.dumps(launches)}; decode tier "
        f"{dec['device_baskets'] - stats0['device_baskets']} device baskets, "
        f"{dec['fallbacks']} fallbacks")
    log("  survivors (staged, card per window, card batched): " + json.dumps(survivors))
    return {"launches": launches, "survivors": survivors, "card_s": card_s}


def device_busy(label, query, store, **kw) -> None:
    """One more run of the main path under ``torch.profiler``: the device
    time of every kernel over the run's wall time, and the kernels that
    took the most.  The profiler's own cost lengthens the wall time, so
    the share is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import run_skim

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_skim(store, query, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}  # device-side events only (kernels and copies): the
    # host ops that launched them carry the same time again
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            by_name[ev.key] = (us, ev.count)
    device_s = sum(us for us, _ in by_name.values()) / 1e6
    if device_s == 0:
        log(f"  [{label}] device busy share: not measured (the profiler saw no "
            "device time)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    log(f"  [{label}] profiled run: wall {wall:.4f} s, device busy {device_s:.6f} s "
        f"= {device_s / wall:.4%} of the wall; by kernel (us, count): "
        + json.dumps({k[:60]: [round(us, 1), n] for k, (us, n) in top}))


# ---------------------------------------------------------------------------


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a copy of the parent commit's tree: rows 1, 3, 4 and 6 "
                        "are then timed beside its kernels and wrappers")
    args = parser.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SmokeFailure("src/repro_torch is not beside chip_smoke.py")
    parent_src = None if args.parent is None else args.parent.resolve() / "src"
    if parent_src is not None and not (parent_src / "repro_torch" / "csrc").is_dir():
        raise SmokeFailure(f"--parent: no src/repro_torch/csrc under {args.parent}")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no card")
    device = torch.device("cuda")
    # the plain attention's products in full float32 (PyTorch's default,
    # stated): TF32 would miss the 3e-5 tolerance
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    log("== 1. device ==")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    parent_ab_build = None if parent_src is None else start_parent_ab_build(parent_src)
    ptxas = start_ptxas_report()
    build_s = _build.build_all()
    ops.load_kernels()
    parent_ab = (None if parent_src is None
                 else finish_parent_ab_build(parent_ab_build, parent_src))
    log(f"  kernels built in {build_s:.1f} s into {_build.build_dir()}; with the "
        f"parent tree's (--parent) {time.perf_counter() - t0:.1f} s")
    finish_ptxas_report(ptxas)
    check_tensor_core_sass()

    log("== 2. kernels against their plain versions ==")
    rng = np.random.default_rng(0)
    decode_err = check_basket_decode(rng, device)
    skim_err, _ = check_skim_fused(rng, device)
    stage_err = max(check_cascade_stage(rng, device)[0],
                    check_cascade_stage_public(rng, device),
                    check_cascade_stage_windows(rng, device)[0])
    pred_err, _ = check_predicate_eval(rng, device)
    compact_err = check_stream_compact(rng, device)
    batch_err, _ = check_skim_fused_batch(rng, device)
    flash_err = check_flash_attention(rng, device)
    check_numpy_entries(rng, device)
    nonfinite_err = check_nonfinite_kernels(np.random.default_rng(1), device)
    edge_err = check_edge_kernels(device)
    int_err = check_int_kernels(device)

    log(f"== building the {N_EVENTS:,}-event stores ==")
    from repro_torch.data.synth import make_nanoaod_like

    t0 = time.perf_counter()
    store = make_nanoaod_like(N_EVENTS, n_hlt=64, n_filler=8, seed=0)
    host_store = make_nanoaod_like(N_EVENTS, n_hlt=64, n_filler=8, seed=0,
                                   device="cpu")
    log(f"  NanoAOD-like: {len(store.branch_names())} branches, "
        f"{store.compressed_bytes() / 1e6:.1f} MB compressed, built twice "
        f"(card store, host store) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    era_store = make_era_store(N_EVENTS)
    era_host = make_era_store(N_EVENTS, device="cpu")
    log(f"  conditions-era: {len(era_store.branch_names())} branches, "
        f"{era_store.compressed_bytes() / 1e6:.1f} MB compressed, built twice "
        f"in {time.perf_counter() - t0:.1f} s")
    cells = [("quickstart", QUICKSTART_QUERY, store, host_store),
             ("zee", zee_query(N_EVENTS), store, host_store),
             ("era", ERA_QUERY, era_store, era_host)]

    log("== 2b. timing at the main path's shapes (window 0; the batch of the "
        "first 16 windows) ==")
    stage_cases = {label: path_stage_cases(st, [q], device)
                   for label, q, st, _ in cells}
    skim_cases = path_skim_cases(store, [q for _, q, *_ in cells[:2]], device)
    timing = time_kernels(
        skim_cases,
        path_decode_cases(store, [(label, q) for label, q, *_ in cells[:2]], device),
        [c for cases in stage_cases.values() for c in cases],
        pred_cases=[bench_predicate(rng, E, device) for E in PREDICATE_BENCH_E],
    )

    log("== 3. main path: run_skim with every default, on the card ==")
    totals = dict.fromkeys(ops.launch_counts(), 0)
    results = {}
    for label, query, st, host in cells:
        results[label] = run_main_path(label, query, st, host)
        for k, v in results[label]["launches"].items():
            totals[k] += v

    log("== 3a. the batched cascade: run_skim(..., device_batch=16) ==")
    batched = {}
    for label, query, st, host in cells:
        batched[label] = run_batched_path(label, query, st, host, results[label])
        for k, v in batched[label]["launches"].items():
            totals[k] += v

    log("== 3b. where the device time goes (torch.profiler) ==")
    for label, query, st, _ in cells[:2]:
        device_busy(label, query, st)
    for label, query, st, _ in cells:
        device_busy(f"{label}, device_batch=16", query, st, device_batch=16)

    log("== 3c. the entry points no skim calls, at full size: "
        "ops.predicate_eval, ops.fused_skim_batch, ops.stream_compact, "
        "ops.flash_attention ==")
    log(f"  launches of the four kernels on the run_skim paths above: "
        f"predicate_eval {totals['predicate_eval']}, skim_fused_batch "
        f"{totals['skim_fused_batch']}, stream_compact {totals['stream_compact']}, "
        f"flash_attention {totals['flash_attention']}")
    predicate = {label: run_predicate_path(label, stage_cases[label][0], device)
                 for label, *_ in cells}
    fused_batch = {label: run_fused_batch_path(label, stage_cases[label][0], device)
                   for label, *_ in cells}
    compact = run_compact_path(store, host_store, results["quickstart"]["n_passed"],
                               device)
    attention = run_attention_path(rng, device)
    log("== 3c. timing of the three at their paths' shapes (stream_compact also "
        "at bench_kernels' shapes) ==")
    timing.update(time_kernels(
        batch_cases=[r["case"] for r in fused_batch.values()],
        compact_cases=[compact["case"]] + [
            (f"bench E={E}", *bench_compact(rng, E, device)) for E in PREDICATE_BENCH_E],
        attn_cases=attention["cases"],
    ))
    parent_times = None
    if parent_ab is None:
        log("== 3c. (no --parent: rows 1, 3, 4 and 6 are not timed beside the parent "
            "tree's sources) ==")
    else:
        log("== 3c. rows 1, 3, 4 and 6 beside the parent tree's sources (device ms, "
            "in turns: parent, this tree, this tree, parent) ==")
        parent_times = time_parent_ab(
            skim_cases, [c for cases in stage_cases.values() for c in cases],
            [r["case"] for r in fused_batch.values()], parent_ab)
        log(f"  parent sources A/B ({card}): " + json.dumps(parent_times))

    log("== 3d. the serving plane: shared scan, job service, cluster, on the "
        f"{N_EVENTS:,}-event NanoAOD-like store ==")
    t0 = time.perf_counter()
    serving = run_serving_plane(store, host_store, results)
    serving_s = time.perf_counter() - t0
    for step in serving.values():
        for k, v in step["launches"].items():
            totals[k] += v
    log(f"  phase 3d took {serving_s:.1f} s ({card})")

    log("== 3e. the mesh skim: sharded_skim on the whole NanoAOD-like store, "
        "predicate_eval and stream_compact per shard, the count summed over the "
        "mesh ==")
    t0 = time.perf_counter()
    mesh = run_mesh_skim(host_store, results, device)
    mesh_s = time.perf_counter() - t0
    log(f"  phase 3e took {mesh_s:.1f} s ({card})")

    log("== 3f. the five examples (repro_torch.examples), each on the card and "
        "on the host ==")
    t0 = time.perf_counter()
    examples, placements = run_examples()
    examples_s = time.perf_counter() - t0
    for pair in examples.values():
        for k, v in pair["launches"].items():
            totals[k] += v
    log(f"  phase 3f took {examples_s:.1f} s ({card})")

    log(f"== 3g. non-finite values: a {NONFINITE_EVENTS:,}-event NanoAOD-like store "
        "holding NaN, +inf, -inf and -0.0, every skimlint fixture query, "
        "quickstart and Z->ee, per window and with device_batch=16 ==")
    t0 = time.perf_counter()
    nonfinite = run_nonfinite_path(device)
    nonfinite_s = time.perf_counter() - t0
    for k, v in nonfinite["launches"].items():
        totals[k] += v
    log(f"  phase 3g took {nonfinite_s:.1f} s ({card})")

    log(f"== 3h. integer branches and non-bool ANY: a {INT_STORE_EVENTS:,}-event "
        "NanoAOD-like store, event numbers past 10^9, per window and with "
        "device_batch=16, decode on the card, held to the staged run ==")
    t0 = time.perf_counter()
    ints = run_int_path(device)
    ints_s = time.perf_counter() - t0
    for k, v in ints["launches"].items():
        totals[k] += v
    log(f"  phase 3h took {ints_s:.1f} s ({card})")

    kernels = [
        {"name": "skim_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/skim_fused.cu",
         "replaces": "src/repro/kernels/skim_fused.py:151",
         "launches": totals["skim_fused"],
         "max_abs_err": max(skim_err, nonfinite_err, edge_err, int_err),
         **bounds(timing["skim_fused"])},
        {"name": "basket_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/basket_decode.cu",
         "replaces": "src/repro/kernels/basket_decode.py:135",
         "launches": totals["basket_decode"], "max_abs_err": decode_err,
         **bounds(timing["basket_decode"])},
        {"name": "predicate_eval_batch", "route": "cuda",
         "source": "src/repro_torch/csrc/predicate_eval.cu",
         "replaces": "src/repro/kernels/predicate_eval.py:270",
         "launches": totals["cascade_stage"] + totals["predicate_eval_batch"],
         "max_abs_err": max(stage_err, pred_err, nonfinite_err, edge_err, int_err),
         **bounds(timing["predicate_eval_batch"])},
        # the four below have no caller in run_skim: their launches are
        # those of their own paths, the ops entry points of phase 3c and,
        # for predicate_eval and stream_compact, the mesh skim of phase 3e
        {"name": "predicate_eval", "route": "cuda",
         "source": "src/repro_torch/csrc/predicate_eval.cu",
         "replaces": "src/repro/kernels/predicate_eval.py:304",
         "launches": sum(r["launches"] for r in predicate.values())
         + mesh["launches"]["predicate_eval"],
         "max_abs_err": max([pred_err, nonfinite_err, edge_err, int_err,
                             mesh["max_abs_err"]]
                            + [r["max_abs_err"] for r in predicate.values()]),
         **bounds(timing["predicate_eval"])},
        {"name": "skim_fused_batch", "route": "cuda",
         "source": "src/repro_torch/csrc/skim_fused.cu",
         "replaces": "src/repro/kernels/skim_fused.py:119",
         "launches": sum(r["launches"] for r in fused_batch.values()),
         "max_abs_err": max([batch_err, nonfinite_err, edge_err, int_err]
                            + [r["max_abs_err"] for r in fused_batch.values()]),
         **bounds(timing["skim_fused_batch"])},
        {"name": "stream_compact", "route": "cuda",
         "source": "src/repro_torch/csrc/stream_compact.cu",
         "replaces": "src/repro/kernels/stream_compact.py:58",
         "launches": compact["launches"] + mesh["launches"]["stream_compact"],
         "max_abs_err": max(compact_err, nonfinite_err),
         **bounds(timing["stream_compact"])},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:93",
         "launches": attention["launches"],
         "max_abs_err": max(flash_err, attention["max_abs_err"]),
         **bounds(timing["flash_attention"])},
    ]
    log("kernel means over the path's shapes (ms; stream_ms is per call from "
        "the host): " + json.dumps(timing))
    log(f"== done in {time.perf_counter() - t_start:.1f} s ==")
    log("main path: " + json.dumps(
        {k: {"wall_s": r["wall_s"], "events_per_s": r["events_per_s"],
             "n_passed": r["n_passed"]} for k, r in results.items()}))
    log("batched path (device_batch=16): " + json.dumps(
        {k: {"wall_s": r["wall_s"], "events_per_s": r["events_per_s"],
             "n_passed": r["n_passed"], "device_dispatches": r["device_dispatches"],
             "per_window_dispatches": r["per_window_dispatches"],
             "stage_upload_bytes": r["uploads"]["step_bytes"],
             "upload_bytes": r["uploads"]["bytes"]}
         for k, r in batched.items()}))
    log("serving plane (" + card + "): " + json.dumps(
        {k: {f: v for f, v in r.items() if f not in ("res", "shards")}
         for k, r in serving.items()}))
    log("mesh skim (" + card + "): " + json.dumps(
        {"seconds": mesh_s, "launches": mesh["launches"], **{
            label: {k: r[k] for k in ("total", "fn_ms", "predicate_eval_ms",
                                      "predicate_eval_bound_ms", "stream_compact_ms",
                                      "stream_compact_bound_ms", "all_reduce_ms")}
            for label, r in mesh["world1"].items()}}))
    log("examples (" + card + "): " + json.dumps(
        {"seconds": examples_s, **{
            name: {"card_s": p["card"]["wall_s"], "host_s": p["host"]["wall_s"],
                   "launches": {k: v for k, v in p["launches"].items() if v},
                   "build_cluster_basket_decode": p["card"]["builds"]}
            for name, p in examples.items()}}, sort_keys=True))
    log("placements (" + card + "; links modeled): " + json.dumps(placements, sort_keys=True))
    if parent_times is not None:
        log("parent sources A/B (" + card + "; device ms): " + json.dumps(parent_times))
    log("non-finite store (" + card + "): " + json.dumps(
        {"seconds": nonfinite_s, "card_s": nonfinite["card_s"],
         "launches": nonfinite["launches"], "survivors": nonfinite["survivors"],
         "mass_residue": nonfinite["residues"]}))
    log("int store (" + card + "): " + json.dumps(
        {"seconds": ints_s, "card_s": ints["card_s"], "launches": ints["launches"],
         "survivors": ints["survivors"]}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
