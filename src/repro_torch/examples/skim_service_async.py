"""Async skim job service demo on the port — submit N tenants, watch
partials stream, cancel one (DESIGN.md §12).

Three tenants hit one :class:`SkimService` front door:

  * ``alice`` submits the full Higgs-style skim;
  * ``bob`` submits a tighter variant — and gets cancelled mid-stream;
  * ``carol`` is over her byte quota, so admission control rejects her
    *before anything is fetched*, with the plan-priced estimate attached;
  * ``dave`` submits a cheap counting query AFTER alice's expensive one
    and still finishes first — the weighted-fair queue refuses to
    head-of-line block him.

Every scheduling decision runs on the deterministic single-threaded
executor with an injected clock, so the run is bit-reproducible: same
partials, same order, same byte accounting, every time.

Run: PYTHONPATH=src python -m repro_torch.examples.skim_service_async
     [--events 50000] [--device cuda|cpu]
"""

import argparse

from repro_torch.data.synth import make_nanoaod_like
from repro_torch.examples import add_device_arg, open_device
from repro_torch.serve import (
    EngineBackend,
    ManualClock,
    SkimService,
    TenantQuota,
    union_columns,
)

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
        "event": [
            {"type": "cut", "branch": "MET_pt", "op": ">", "value": 25.0}
        ],
    },
}

QUERY_TIGHT = {
    **QUERY,
    "selection": {
        **QUERY["selection"],
        "event": [
            {"type": "cut", "branch": "MET_pt", "op": ">", "value": 40.0}
        ],
    },
}

QUERY_CHEAP = {
    "branches": ["nMuon", "event"],
    "selection": {
        "preselection": [{"branch": "nMuon", "op": ">=", "value": 3}]
    },
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device)

    store = make_nanoaod_like(
        args.events, n_hlt=32, n_filler=60, seed=args.seed, device=device
    )
    print(
        f"store: {args.events} events, {len(store.branch_names())} "
        f"branches, {store.compressed_bytes() / 1e6:.1f} MB\n"
    )

    # a bare store would give EngineBackend(store): an engine on the card
    svc = SkimService(
        EngineBackend(store, device=device),
        clock=ManualClock(),
        quotas={
            "carol": TenantQuota(byte_budget=1_000),  # ~nothing
            "dave": TenantQuota(weight=2.0),
        },
    )

    alice = svc.submit(QUERY, tenant="alice")
    bob = svc.submit(QUERY_TIGHT, tenant="bob")
    carol = svc.submit(QUERY, tenant="carol")
    dave = svc.submit(QUERY_CHEAP, tenant="dave")

    for job, who in ((alice, "alice"), (bob, "bob"), (carol, "carol"),
                     (dave, "dave")):
        tag = f"job {job.job_id} ({who})"
        if job.estimate:
            print(f"{tag:>16}: {job.state:<9} {job.estimate.describe()}")
        if job.state == "REJECTED":
            print(f"{' ':>16}  rejected: {job.error.split('(')[0].strip()}")
            print(
                f"{' ':>16}  bytes fetched for this job: "
                f"{job.stats.bytes_fetched}"
            )
    print()

    # drive the scheduler by hand, narrating every streamed partial;
    # cancel bob after his second window
    seen: dict[int, int] = {}
    while svc.step():
        for job, who in ((alice, "alice"), (bob, "bob"), (dave, "dave")):
            for p in job.partials[seen.get(job.job_id, 0):]:
                print(
                    f"  quantum {svc.executor.quanta:>2}: {who:<6} "
                    f"window [{p.start:>6},{p.stop:>6}) -> "
                    f"{p.n_passed} survivors"
                )
            seen[job.job_id] = len(job.partials)
        if len(bob.partials) == 2 and not bob.terminal:
            svc.cancel(bob.job_id)
            print("  >> cancelled bob at the window boundary")

    print()
    for job, who in ((alice, "alice"), (bob, "bob"), (carol, "carol"),
                     (dave, "dave")):
        line = f"{who:>16}: {job.state:<9} {len(job.partials)} partials"
        if job.state == "DONE":
            cols, _ = union_columns(job)
            line += (
                f", {job.n_passed} survivors, "
                f"{job.stats.bytes_fetched / 1e6:.2f} MB fetched"
            )
        print(line)

    order = []
    for _, picked, _ in svc.trace:
        if picked not in order:
            order.append(picked)
    print(
        f"\nfair-queue service order (job ids): {order}"
        f" — dave's cheap query was never head-of-line blocked"
    )


if __name__ == "__main__":
    main()
