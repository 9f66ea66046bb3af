"""Synthetic NanoAOD-like event generator.

Produces a physically-shaped stand-in for the CMS NanoAOD files the paper
filters: jagged particle collections (Electron/Muon/Jet) with kinematic
variables, event-level MET, and a block of HLT trigger bits, plus optional
filler branches so the branch count can approach the paper's 1749-branch
file for the benchmarks.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.store import EventStore

COLLECTIONS = {
    # name -> (poisson mean multiplicity, kinematic variables)
    "Electron": (0.4, ["pt", "eta", "phi", "mass", "charge", "mvaId"]),
    "Muon": (0.5, ["pt", "eta", "phi", "mass", "charge", "tightId"]),
    "Jet": (4.0, ["pt", "eta", "phi", "mass", "btagDeepB"]),
}

DEFAULT_TRIGGERS = [
    "HLT_IsoMu24",
    "HLT_Ele32_WPTight_Gsf",
    "HLT_PFMET120_PFMHT120_IDTight",
    "HLT_DoubleEle25_CaloIdL_MW",
    "HLT_Mu17_TrkIsoVVL_Mu8_TrkIsoVVL",
]


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
        return (rng.random(n) > 0.3)
    if var == "btagDeepB":
        return rng.beta(0.5, 2.0, n).astype(np.float32)
    return rng.normal(0.0, 1.0, n).astype(np.float32)


def make_nanoaod_like(
    n_events: int = 20_000,
    n_hlt: int = 64,
    n_filler: int = 0,
    basket_events: int = 4096,
    codec: str = "bitpack",
    seed: int = 0,
    device=None,
) -> EventStore:
    """Build a synthetic NanoAOD-style :class:`EventStore`.

    ``n_hlt`` trigger-bit branches named ``HLT_*`` (the first few use the
    realistic names in :data:`DEFAULT_TRIGGERS`); ``n_filler`` extra flat
    float branches (``Filler_000`` ...) standing in for the long tail of
    NanoAOD branches that a skim carries to the output but never filters on.
    ``device`` is where the store's device decodes run (see
    :class:`~repro_torch.data.store.EventStore`); it does not change a byte.
    """
    rng = np.random.default_rng(seed)
    columns: dict[str, np.ndarray] = {}
    jagged: dict[str, str] = {}

    for coll, (mean_mult, variables) in COLLECTIONS.items():
        counts = rng.poisson(mean_mult, n_events).astype(np.int32)
        total = int(counts.sum())
        columns[f"n{coll}"] = counts
        for var in variables:
            name = f"{coll}_{var}"
            columns[name] = _kinematic(rng, var, total)
            jagged[name] = f"n{coll}"

    columns["MET_pt"] = (rng.exponential(30.0, n_events) + 1.0).astype(np.float32)
    columns["MET_phi"] = rng.uniform(-np.pi, np.pi, n_events).astype(np.float32)
    columns["PV_npvs"] = rng.poisson(35.0, n_events).astype(np.int32)
    columns["run"] = np.full(n_events, 362_104, dtype=np.int32)
    columns["event"] = np.arange(n_events, dtype=np.int64).astype(np.int32)
    columns["luminosityBlock"] = (np.arange(n_events) // 1000).astype(np.int32)

    for i in range(n_hlt):
        name = DEFAULT_TRIGGERS[i] if i < len(DEFAULT_TRIGGERS) else f"HLT_path{i:03d}"
        rate = 0.15 if i < len(DEFAULT_TRIGGERS) else 0.02
        columns[name] = rng.random(n_events) < rate

    for i in range(n_filler):
        columns[f"Filler_{i:03d}"] = rng.normal(0, 1, n_events).astype(np.float32)

    return EventStore.from_arrays(
        columns, jagged=jagged, basket_events=basket_events, codec=codec,
        device=device,
    )
