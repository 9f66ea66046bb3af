"""Skim service comparison on the port — the paper's evaluation (Figs.
4a/4b/5a/5b) as a runnable scenario: four placements x three network
tiers, plus the multi-tenant shared-scan batch mode, which fetches +
decodes phase 1 once for all tenants and prints the resulting
amortization ratio (approaches Nx for N tenants with overlapping filter
sets).

The synthetic dataset is seeded (``--seed``, default 0), so every run
reproduces the same events, survivor counts, and byte accounting.

Run: PYTHONPATH=src python -m repro_torch.examples.skim_service
     [--events 50000] [--device cuda|cpu]
"""

import argparse

from repro_torch.core.engine import NetworkModel, SkimEngine
from repro_torch.data.synth import make_nanoaod_like
from repro_torch.examples import add_device_arg, open_device
from repro_torch.serve.engine import SharedScanEngine

QUERY = {
    "branches": ["Electron_*", "Muon_*", "Jet_*", "MET_*", "HLT_*"]
    + [f"Filler_{i:03d}" for i in range(40)],
    "selection": {
        "preselection": [{"branch": "nElectron", "op": ">=", "value": 1}],
        "object": [
            {
                "collection": "Electron",
                "cuts": [
                    {"var": "pt", "op": ">", "value": 20.0},
                    {"var": "eta", "op": "abs<", "value": 2.4},
                ],
            }
        ],
        "event": [{"type": "cut", "branch": "MET_pt", "op": ">", "value": 25.0}],
    },
}

MODES = ["client_plain", "client_opt", "server_side", "near_data"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0,
                    help="dataset RNG seed (fixed -> bit-reproducible runs)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device)

    store = make_nanoaod_like(args.events, n_hlt=32, n_filler=60, seed=args.seed,
                              device=device)
    print(f"store: {args.events} events, {len(store.branch_names())} branches, "
          f"{store.compressed_bytes()/1e6:.1f} MB\n")

    print(f"{'mode':<14}", end="")
    for gbps in (1, 10, 100):
        print(f"{gbps} Gb/s".rjust(12), end="")
    print(f"{'busy%':>8}")

    for mode in MODES:
        print(f"{mode:<14}", end="")
        busy = 0.0
        for gbps in (1, 10, 100):
            link = NetworkModel(gbps, rtt_s=0.010 if gbps == 1 else 0.001)
            res = SkimEngine(store, input_link=link, device=device).run(QUERY, mode)
            print(f"{res.breakdown.total():>11.2f}s", end="")
            busy = res.busy_fraction
        print(f"{100*busy:>7.0f}%")

    res = SkimEngine(store, device=device).run(QUERY, "near_data")
    print(f"\nnear-data breakdown: "
          + ", ".join(f"{k}={v:.3f}s" for k, v in res.breakdown.as_dict().items()))

    # -- multi-tenant shared scan: N queries, one pass over the store -----
    # realistic tenant mix: everyone gates on MET + a trigger, each
    # analysis adds its own object leg
    def tenant(extra: dict) -> dict:
        return {
            "branches": ["Electron_*", "Muon_*", "Jet_*", "MET_*"],
            "selection": {
                "preselection": [{"branch": "MET_pt", "op": ">", "value": 20.0}],
                "event": [{"type": "any", "branches": ["HLT_IsoMu24"]}],
                **extra,
            },
        }

    tenants = [
        tenant({"object": [{"collection": "Electron",
                            "cuts": [{"var": "pt", "op": ">", "value": 20.0}]}]}),
        tenant({"object": [{"collection": "Muon",
                            "cuts": [{"var": "pt", "op": ">", "value": 15.0}]}]}),
        tenant({"object": [{"collection": "Jet",
                            "cuts": [{"var": "pt", "op": ">", "value": 30.0}],
                            "min_count": 2}]}),
        tenant({}),
    ]
    batch = SharedScanEngine(store, device=device).run_batch(tenants)
    print(f"\nshared scan: {batch.n_queries} tenant queries, one pass")
    for i, r in enumerate(batch.results):
        print(f"  tenant {i}: {r.n_passed}/{r.n_input} events "
              f"({100 * r.selectivity:.2f}%)")
    print(f"  phase-1 bytes shared={batch.shared_stats.bytes_fetched / 1e6:.2f} MB "
          f"vs naive={batch.naive_phase1_bytes / 1e6:.2f} MB "
          f"-> {batch.amortization:.2f}x phase-1 amortization "
          f"({batch.n_queries} tenants)")


if __name__ == "__main__":
    main()
