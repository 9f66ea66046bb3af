"""Distributed skim cluster walkthrough on the port (DESIGN.md §5).

A fleet of storage nodes stripes one synthetic NanoAOD-like dataset;
the scatter-gather coordinator fans a Higgs-style query out to every
node, merges the per-shard results bit-identically to a single-node
run, and demonstrates the operational story on top:

  1. cold scatter-gather across N nodes vs the single-node run,
  2. a node failure mid-fleet, transparently retried on a replica,
  3. a straggling node stretching the modeled makespan,
  4. a warm content-addressed result cache serving every shard without
     touching a node,
  5. a multi-tenant batch: one shared scan per node, phase-1 bytes
     amortized across tenants,
  6. zone-map predicate pushdown (DESIGN.md §9): a selective run-range
     query whose basket stats prove most windows empty — per-node pruned
     windows and saved bytes, and (striped finely enough) whole shards
     answered by the coordinator without any RPC.

Deterministic: the dataset is seeded, faults are injected, links are
modeled.  Every node's engines run on ``--device``.
Run: PYTHONPATH=src python -m repro_torch.examples.skim_cluster
     [--events 40000] [--device cuda|cpu]
"""

import argparse

from repro_torch.cluster import SkimResultCache, build_cluster, window_spans
from repro_torch.core.engine import LOCAL_DISK, SkimEngine
from repro_torch.data.synth import make_nanoaod_like
from repro_torch.examples import add_device_arg, open_device

QUERY = {
    "branches": ["Electron_*", "Jet_*", "MET_*", "HLT_*"],
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

TENANTS = [
    {"branches": ["Muon_*", "MET_*"], "selection": {
        "preselection": [{"branch": "MET_pt", "op": ">", "value": 20.0}],
        "object": [{"collection": "Muon",
                    "cuts": [{"var": "pt", "op": ">", "value": 15.0}]}]}},
    {"branches": ["Jet_*", "MET_*"], "selection": {
        "preselection": [{"branch": "MET_pt", "op": ">", "value": 20.0}],
        "object": [{"collection": "Jet",
                    "cuts": [{"var": "pt", "op": ">", "value": 30.0}],
                    "min_count": 2}]}},
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=40_000)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--policy", default="size_balanced",
                    choices=["round_robin", "size_balanced"])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device)

    store = make_nanoaod_like(args.events, n_hlt=16, n_filler=24, seed=args.seed,
                              device=device)
    print(f"dataset: {args.events} events, {len(store.branch_names())} branches, "
          f"{store.compressed_bytes()/1e6:.1f} MB compressed")

    single = SkimEngine(store, near_input_link=LOCAL_DISK, device=device).run(
        QUERY, "near_data")
    print(f"single node: {single.n_passed}/{single.n_input} events pass, "
          f"modeled {single.extras['pipeline_total']*1e3:.1f} ms\n")

    cache = SkimResultCache(budget_bytes=128 << 20)
    coord = build_cluster(
        store, args.nodes, policy=args.policy, cache=cache,
        near_input_link=LOCAL_DISK, device=device,
    )
    print(f"cluster: {args.nodes} nodes ({args.policy}), one replica per shard")
    for node in coord.nodes:
        sh = node.shard
        print(f"  node {node.node_id}: {len(sh.window_ids)} windows, "
              f"{sh.n_events} events, {sh.comp_bytes/1e6:.1f} MB, "
              f"manifest {sh.manifest_hash[:12]}…")

    # 1. cold scatter-gather --------------------------------------------------
    res = coord.run(QUERY)
    assert res.n_passed == single.n_passed
    assert res.output.compressed_bytes() == single.output.compressed_bytes()
    print(f"\ncold run: {res.n_passed} survivors (bit-identical to single node), "
          f"modeled {res.modeled_total_s*1e3:.1f} ms "
          f"(slowest node + {res.merge_s*1e3:.1f} ms merge), "
          f"realized {res.wall_s*1e3:.0f} ms")

    # 2. node failure -> replica retry ---------------------------------------
    cache.clear()
    coord.nodes[1].inject_fault("fail")
    res = coord.run(QUERY)
    assert res.n_passed == single.n_passed
    sid, dead, used = res.retries[0]
    print(f"node failure: shard {sid} primary (node {dead}) died, replica "
          f"node {used} served it — output unchanged")

    # 3. straggler ------------------------------------------------------------
    cache.clear()
    coord.nodes[0].inject_fault("straggle", delay_s=0.25)
    res = coord.run(QUERY)
    print(f"straggler: +250 ms on node 0 -> modeled "
          f"{res.modeled_total_s*1e3:.1f} ms (max-over-nodes absorbs it)")

    # 4. warm cache -----------------------------------------------------------
    warm = coord.run(QUERY)
    assert warm.cache_hits == args.nodes
    assert warm.n_passed == single.n_passed
    print(f"warm cache: {warm.cache_hits}/{args.nodes} shards served from cache "
          f"({cache.stats.saved_fetch_bytes/1e6:.1f} MB fetch skipped), modeled "
          f"{warm.modeled_total_s*1e3:.1f} ms")

    # 5. multi-tenant batch ---------------------------------------------------
    batch = coord.run_batch(TENANTS)
    print(f"\ntenant batch: {len(TENANTS)} queries, one shared scan per node")
    for i, r in enumerate(batch.results):
        print(f"  tenant {i}: {r.n_passed}/{r.n_input} events "
              f"({100*r.selectivity:.2f}%)")
    print(f"  phase-1 {batch.shared_phase1_bytes/1e6:.2f} MB shared vs "
          f"{batch.naive_phase1_bytes/1e6:.2f} MB naive -> "
          f"{batch.amortization:.2f}x amortization")

    # 6. zone-map predicate pushdown ------------------------------------------
    # a run-range skim: luminosityBlock is recorded monotonically, so the
    # per-basket min/max prove most windows empty before any fetch
    lumi_max = (args.events // 1000) // 20  # ~5% of luminosity blocks
    selective = {
        "branches": ["Electron_*", "MET_*", "event", "luminosityBlock"],
        "selection": {
            "preselection": [
                {"branch": "luminosityBlock", "op": "<=", "value": lumi_max}
            ],
            "event": [
                {"type": "cut", "branch": "MET_pt", "op": ">", "value": 25.0}
            ],
        },
    }
    single_sel = SkimEngine(store, near_input_link=LOCAL_DISK, device=device).run(
        selective, "near_data", prune=False
    )
    res = coord.run(selective)
    assert res.n_passed == single_sel.n_passed
    assert res.output.compressed_bytes() == single_sel.output.compressed_bytes()
    print(f"\nzone-map pushdown: lumi <= {lumi_max} & MET > 25 -> "
          f"{res.n_passed}/{res.n_input} events "
          f"({100 * res.selectivity:.2f}%), bit-identical to unpruned")
    for r in res.responses:
        pw = r.result.extras.get("pruned_windows", [])
        print(f"  node {r.node_id}: {len(pw)}/{len(r.window_ids)} windows "
              f"pruned, {r.result.stats.bytes_skipped / 1e3:.1f} KB fetch "
              f"proved away{' [shard skipped, no RPC]' if r.pruned else ''}")
    print(f"  cluster total: {res.extras['prune_saved_bytes'] / 1e6:.2f} MB "
          f"never moved, {len(res.pruned_shards)} shard(s) answered "
          "from manifests alone")

    # striped one window per node, whole shards become skippable
    fine = build_cluster(
        store, len(window_spans(store.n_events, store.basket_events)),
        replication=False, near_input_link=LOCAL_DISK, device=device,
    )
    res = fine.run(selective)
    assert res.n_passed == single_sel.n_passed
    print(f"  striped 1 window/node ({len(fine.nodes)} nodes): "
          f"{len(res.pruned_shards)} shards skipped before any RPC")


if __name__ == "__main__":
    main()
