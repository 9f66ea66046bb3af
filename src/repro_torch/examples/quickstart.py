"""Quickstart: the SkimROOT workflow in five minutes, on the port.

1. build a synthetic NanoAOD-like columnar store,
2. write a JSON selection query (paper Fig. 2c),
3. inspect the physical plan (zone-map window decisions + the cascaded
   phase-1 stage order, DESIGN.md §9/§11),
4. run the near-data two-phase skim,
5. compare against the legacy client-side baseline (paper Fig. 4b).

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart
     [--events 20000] [--device cuda|cpu]
"""

import argparse

from repro_torch.core import WAN_1G, SkimEngine
from repro_torch.data.synth import make_nanoaod_like
from repro_torch.examples import add_device_arg, open_device

QUERY = {
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=20_000)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device)

    print("== 1. synthesize a NanoAOD-like store ==")
    store = make_nanoaod_like(args.events, n_hlt=16, n_filler=8, device=device)
    print(f"   {store.n_events} events x {len(store.branch_names())} branches, "
          f"{store.compressed_bytes()/1e6:.1f} MB compressed")

    print("== 2./3. near-data two-phase skim (cascaded phase 1) ==")
    engine = SkimEngine(store, input_link=WAN_1G, device=device)
    res = engine.run(QUERY, mode="near_data")
    print(f"   {res.plan.describe()}")
    print(f"   passed {res.n_passed}/{res.n_input} events "
          f"({100*res.selectivity:.2f}%)")
    print(f"   moved {res.stats.bytes_fetched/1e6:.2f} MB in "
          f"{res.stats.requests} requests"
          + (f"; cascade skipped {res.stats.cascade_bytes_skipped/1e6:.2f} MB "
             "of phase-1 fetch"
             if res.stats.cascade_bytes_skipped else ""))

    print("== 4. operation breakdown (Fig. 4b analogue) ==")
    for op, secs in res.breakdown.as_dict().items():
        print(f"   {op:16s} {secs:8.4f}s")

    print("== 5. legacy client-side baseline ==")
    legacy = engine.run(QUERY, mode="client_plain")
    print(f"   client_plain moved {legacy.stats.bytes_fetched/1e6:.2f} MB "
          f"({legacy.stats.bytes_fetched/max(res.stats.bytes_fetched, 1):.1f}x "
          "more than near-data)")
    print(f"   speedup vs legacy client-side: "
          f"{legacy.breakdown.total()/res.breakdown.total():.1f}x")
    print("done.")


if __name__ == "__main__":
    main()
