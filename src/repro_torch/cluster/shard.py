"""Dataset sharding for the distributed skim cluster (DESIGN.md §5a).

A fleet of storage nodes stripes one logical dataset: the partitioner
cuts the event axis into **basket windows** (the engine's unit of
fetch/filter work) and assigns whole windows to shards, so every shard
is a self-contained :class:`~repro_torch.data.store.EventStore` whose basket
boundaries coincide with the parent's.  Window-aligned shards are what
make the scatter-gather merge bit-identical: each shard's baskets are
byte-identical to the parent's baskets for the same events, and the
coordinator can reassemble per-window survivor chunks in global window
order (coordinator.py).

Two assignment policies:

  * ``round_robin``    — window *i* → shard ``i % n`` (striping; even
    window counts, oblivious to size skew),
  * ``size_balanced``  — greedy longest-processing-time: windows sorted
    by compressed size, each assigned to the currently lightest shard
    (balances bytes when basket sizes are skewed).

Each shard carries a per-shard manifest (every branch's
:class:`~repro_torch.data.store.BasketMeta` rows) and its SHA-256
``manifest_hash`` — the content address the skim-result cache keys on
(cache.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.data.store import BasketMeta, EventStore

POLICIES = ("round_robin", "size_balanced")


def window_spans(n_events: int, window_events: int) -> list[tuple[int, int]]:
    """Global basket-window spans: ``[start, stop)`` per window."""
    if window_events <= 0:
        raise ValueError("window_events must be positive")
    return [
        (s, min(s + window_events, n_events))
        for s in range(0, n_events, window_events)
    ]


@dataclass
class Shard:
    """One node's slice of the dataset: whole basket windows, ascending."""

    shard_id: int
    window_ids: list[int]  # global window indices, ascending
    spans: list[tuple[int, int]]  # global [start, stop) per window
    window_events: int
    store: EventStore  # the shard-local re-basketed store
    manifest_hash: str = ""
    comp_bytes: int = 0  # compressed payload this shard holds

    def __post_init__(self):
        if not self.manifest_hash:
            self.manifest_hash = self.store.manifest_hash()
        if not self.comp_bytes:
            self.comp_bytes = self.store.compressed_bytes()

    @property
    def n_events(self) -> int:
        return self.store.n_events

    def manifest(self) -> dict[str, list[BasketMeta]]:
        """Per-branch basket metadata of the shard-local store."""
        return {
            name: [
                self.store.basket_meta(name, i)
                for i in range(self.store.n_baskets(name))
            ]
            for name in self.store.branch_names()
        }

    def zone_stats(self, branch: str):
        """Shard-level aggregate zone-map stats of one branch — every
        basket of the shard folded into one
        :class:`~repro_torch.data.store.ZoneStats` interval.  This is what the
        coordinator consults to skip a whole node before any RPC
        (DESIGN.md §9); per-window stats stay on the node for the finer
        in-engine pruning."""
        return self.store.window_stats(branch, 0, self.store.n_events)


def _window_comp_bytes(
    store: EventStore, spans: list[tuple[int, int]]
) -> list[int]:
    """Compressed bytes per window, summed over every branch's baskets."""
    sizes = [0] * len(spans)
    for name in store.branch_names():
        for w, (a, b) in enumerate(spans):
            for i in store.basket_ids_for_range(name, a, b):
                sizes[w] += store.basket_meta(name, i).comp_bytes
    return sizes


def assign_windows(
    n_windows: int,
    n_shards: int,
    policy: str = "round_robin",
    sizes: list[int] | None = None,
) -> list[list[int]]:
    """Window → shard assignment; returns ascending window ids per shard."""
    if policy not in POLICIES:
        raise ValueError(f"unknown shard policy {policy!r} (want {POLICIES})")
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    out: list[list[int]] = [[] for _ in range(n_shards)]
    if policy == "round_robin":
        for w in range(n_windows):
            out[w % n_shards].append(w)
        return out
    if sizes is None or len(sizes) != n_windows:
        raise ValueError("size_balanced needs one size per window")
    load = [0] * n_shards
    # LPT greedy; ties broken by shard id for determinism
    for w in sorted(range(n_windows), key=lambda i: (-sizes[i], i)):
        s = min(range(n_shards), key=lambda j: (load[j], j))
        out[s].append(w)
        load[s] += sizes[w]
    for shard in out:
        shard.sort()
    return out


def partition_store(
    store: EventStore,
    n_shards: int,
    policy: str = "round_robin",
    window_events: int | None = None,
) -> list[Shard]:
    """Partition ``store`` into ``n_shards`` window-aligned shards.

    ``window_events`` defaults to the store's ``basket_events`` and must
    be a multiple of it — otherwise shard-local basket boundaries drift
    from the parent's and the byte accounting / bit-identity contracts
    break.  Shards may be empty when there are fewer windows than shards.
    """
    window_events = window_events or store.basket_events
    if window_events % store.basket_events:
        raise ValueError(
            f"window_events={window_events} must be a multiple of "
            f"basket_events={store.basket_events} for basket-aligned shards"
        )
    spans = window_spans(store.n_events, window_events)
    sizes = (
        _window_comp_bytes(store, spans) if policy == "size_balanced" else None
    )
    assignment = assign_windows(len(spans), n_shards, policy, sizes)
    shards = []
    for sid, wids in enumerate(assignment):
        sh_spans = [spans[w] for w in wids]
        shards.append(
            Shard(
                shard_id=sid,
                window_ids=wids,
                spans=sh_spans,
                window_events=window_events,
                store=store.slice_events(sh_spans),
            )
        )
    return shards


@dataclass
class ShardMap:
    """Cluster-wide view: which shard owns each global window."""

    shards: list[Shard]
    window_events: int
    n_events: int
    owner: dict[int, int] = field(default_factory=dict)  # window -> shard

    @classmethod
    def build(cls, shards: list[Shard], n_events: int) -> "ShardMap":
        if not shards:
            raise ValueError("need at least one shard")
        owner: dict[int, int] = {}
        for sh in shards:
            for w in sh.window_ids:
                if w in owner:
                    raise ValueError(f"window {w} owned by two shards")
                owner[w] = sh.shard_id
        n_windows = len(window_spans(n_events, shards[0].window_events))
        missing = set(range(n_windows)) - set(owner)
        if missing:
            raise ValueError(f"windows not owned by any shard: {sorted(missing)}")
        return cls(
            shards=shards,
            window_events=shards[0].window_events,
            n_events=n_events,
            owner=owner,
        )
