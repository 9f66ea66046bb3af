"""Columnar event store — the ROOT-file analogue.

Mirrors the structures §2.1 of the paper describes:

  * branches (columns) of per-event values, flat or jagged,
  * baskets: fixed event-count chunks, the unit of compression and I/O,
  * a header with per-branch basket metadata including the
    "first event index array" used to locate the basket holding event *i*.

Access is basket-granular: readers ask for the baskets overlapping an event
range and get compressed blobs back; decompression and deserialization are
separate, *timed* stages in ``repro_torch.core.engine`` (matching the paper's
operation breakdown).  A ``FetchStats`` object accounts every byte and
request so the network model (1/10/100 Gb/s tiers) stays honest.

Window-granular reading lives here too: :meth:`EventStore.fetch_window`
is the explicit TTreeCache round (all baskets a read round needs, bulk
request accounting — DESIGN.md §2b) and :class:`WindowPrefetcher` is the
double-buffered loader the pipelined near-data executor uses to overlap
fetch+decode of window *i+1* with filtering of window *i* (DESIGN.md §4b).
"""

from __future__ import annotations

import json
import threading
from bisect import bisect_left, bisect_right
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.data.codecs import (
    basket_digest,
    basket_stats,
    decode_basket,
    decode_basket_round,
    encode_basket,
)

# Paper §4: "A 100 MB TTreeCache is used in all methods".  The coalesced
# window fetch aggregates every basket a read round needs into bulk
# requests of at most this size (DESIGN.md §2b).
TTREECACHE_BYTES = 100 * 1024 * 1024

# Version of the zone-map statistics schema carried by BasketMeta and the
# manifest.  Bumping this changes every manifest_hash (and therefore every
# cluster cache key), which is exactly the invalidation we want when the
# stat semantics change (DESIGN.md §9).
ZONEMAP_VERSION = 1

# Version of the basket integrity schema: since v1 every BasketMeta row
# carries a CRC-32 digest of its encoded blob, recomputed (and enforced)
# on every fetch.  Carried in the manifest like ZONEMAP_VERSION, so
# digest-bearing stores hash to different content addresses than legacy
# ones (DESIGN.md §14).
INTEGRITY_VERSION = 1

# Default capacity (in baskets) of the per-store decoded-basket LRU.
DECODE_CACHE_BASKETS = 64


class CorruptBasket(RuntimeError):
    """A fetched basket blob failed its integrity digest.

    Raised by the fetch path (:meth:`EventStore.fetch_basket` /
    :meth:`EventStore.fetch_range`, and therefore
    :meth:`EventStore.fetch_window`) before any decode — corrupt bytes
    never reach the filter.  The cluster layer treats this like a node
    fault: the shard is retried under its retry policy (typically
    re-fetching from the replica) and the (shard, branch, basket) is
    quarantined on the node (DESIGN.md §14).
    """

    def __init__(self, branch: str, basket_id: int, expected: int, actual: int):
        super().__init__(
            f"basket {branch}[{basket_id}]: digest mismatch "
            f"(expected {expected:#010x}, got {actual:#010x})"
        )
        self.branch = branch
        self.basket_id = basket_id
        self.expected = expected
        self.actual = actual


@dataclass
class Branch:
    name: str
    dtype: str  # numpy dtype string, e.g. "float32"
    jagged: bool = False
    counts_branch: str | None = None  # e.g. "nElectron" for "Electron_pt"

    def np_dtype(self):
        return np.dtype(self.dtype)


@dataclass
class BasketMeta:
    first_entry: int  # first event index (the "first event index array")
    n_entries: int  # events covered
    n_values: int  # values stored (== n_entries for flat branches)
    comp_bytes: int
    raw_bytes: int
    # zone-map statistics (DESIGN.md §9): value bounds as exact float64
    # embeddings of the stored dtype, plus the true-count for bool
    # branches.  ``None`` means "unknown" (empty basket, non-finite data,
    # or a store written before ZONEMAP_VERSION) and always degrades to
    # "scan" in the pruning analysis — never to a wrong skip.
    vmin: float | None = None
    vmax: float | None = None
    n_true: int | None = None
    # CRC-32 of the encoded blob (INTEGRITY_VERSION).  ``None`` means
    # "unverifiable" (a store written before the digest upgrade) and
    # degrades to skipping the check — never to a false alarm.
    digest: int | None = None

    def stats_row(self) -> list:
        return [
            self.first_entry, self.n_entries, self.n_values,
            self.comp_bytes, self.raw_bytes,
            self.vmin, self.vmax, self.n_true, self.digest,
        ]


@dataclass(frozen=True)
class ZoneStats:
    """Aggregate zone-map statistics of one branch over an event range.

    ``lo``/``hi`` bound every value in the range (``None`` = unknown or no
    values); ``n_true`` sums bool true-counts (``None`` for non-bool or
    unknown).  ``n_entries``/``n_values`` count the covered events/values
    — for flat branches they coincide, for jagged value branches
    ``n_values`` is the object total the counts branch describes.
    """

    lo: float | None
    hi: float | None
    n_true: int | None
    n_entries: int
    n_values: int


@dataclass
class FetchStats:
    bytes_fetched: int = 0
    requests: int = 0
    by_branch: dict = field(default_factory=dict)
    # bytes/requests the zone-map pruning proved unnecessary and never
    # issued (DESIGN.md §9).  Not part of ``bytes_fetched`` — these are
    # the savings ledger, not traffic.
    bytes_skipped: int = 0
    requests_skipped: int = 0
    # bytes the cascaded executor never moved relative to the preloading
    # reference (DESIGN.md §11): filter-branch baskets that neither a
    # cascade stage nor phase 2 ever fetched, so
    # bytes_fetched + cascade_bytes_skipped == the preload run's
    # bytes_fetched, exactly.  A savings ledger like ``bytes_skipped``,
    # not traffic.
    cascade_bytes_skipped: int = 0

    def record(self, branch: str, nbytes: int, n_requests: int = 1) -> None:
        self.bytes_fetched += nbytes
        self.requests += n_requests
        self.by_branch[branch] = self.by_branch.get(branch, 0) + nbytes

    def skip(self, nbytes: int, n_requests: int = 0) -> None:
        """Account a fetch the pruning analysis proved away."""
        self.bytes_skipped += nbytes
        self.requests_skipped += n_requests

    def merge(self, other: "FetchStats") -> None:
        self.bytes_fetched += other.bytes_fetched
        self.requests += other.requests
        self.bytes_skipped += other.bytes_skipped
        self.requests_skipped += other.requests_skipped
        self.cascade_bytes_skipped += other.cascade_bytes_skipped
        for k, v in other.by_branch.items():
            self.by_branch[k] = self.by_branch.get(k, 0) + v

    @classmethod
    def merged(cls, parts: "list[FetchStats]") -> "FetchStats":
        """Sum a sequence of stats into a fresh object (the scatter-gather
        coordinator's gather contract — inputs are left untouched)."""
        out = cls()
        for p in parts:
            out.merge(p)
        return out


def _check_placements(name: str, metas: list[BasketMeta]) -> None:
    """Refuse a branch whose baskets' first entries or ends descend: the
    range lookup bisects over both, and blobs are read in basket order."""
    for a, b in zip(metas, metas[1:]):
        if (b.first_entry < a.first_entry
                or b.first_entry + b.n_entries < a.first_entry + a.n_entries):
            raise ValueError(f"baskets of {name!r} are not in event order")


def coalesced_requests(
    nbytes: int, n_baskets: int, coalesce: bool,
    cache_bytes: int = TTREECACHE_BYTES,
) -> int:
    """Requests one fetch round issues under the TTreeCache model: bulk
    requests of at most ``cache_bytes`` when coalescing, one seek per
    basket otherwise.  The single source of truth — `fetch_window`, the
    engine's skip pricing, and the cascade's ledger all use it."""
    if coalesce:
        return max(1, -(-nbytes // cache_bytes)) if nbytes else 0
    return n_baskets


class WindowPrefetcher:
    """Double-buffered basket-window loader (DESIGN.md §4).

    The paper's TTreeCache batching made explicit *and* asynchronous:
    while the consumer filters window *i*, one background worker fetches
    and decodes window *i+1*, so the pipeline bound per window is
    ``max(fetch+decode, filter)`` instead of their sum.

    ``load_fn(start, stop)`` runs in the worker thread and must touch only
    thread-local state; whatever it returns (decoded columns plus
    per-window ``FetchStats``/timing objects) is handed back to the
    consumer strictly in window order, so merging the accounting on the
    consumer side is deterministic and byte-identical to the serial
    schedule (pinned by tests/test_pipeline_executor.py).

    ``depth`` is the number of windows in flight (2 = classic double
    buffering); ``enabled=False`` degrades to the serial schedule with the
    same iteration contract, which is what the serial/pipelined
    invariance tests compare against.
    """

    def __init__(
        self,
        n_events: int,
        window_events: int,
        load_fn,
        depth: int = 2,
        enabled: bool = True,
    ):
        if window_events <= 0:
            raise ValueError("window_events must be positive")
        self.n_events = int(n_events)
        self.window_events = int(window_events)
        self.load_fn = load_fn
        self.depth = max(int(depth), 1)
        self.enabled = enabled

    def windows(self) -> list[tuple[int, int]]:
        return [
            (s, min(s + self.window_events, self.n_events))
            for s in range(0, self.n_events, self.window_events)
        ]

    def __iter__(self):
        spans = self.windows()
        if not self.enabled:
            for start, stop in spans:
                yield start, stop, self.load_fn(start, stop)
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="skim-prefetch"
        )
        try:
            pending: deque = deque()
            it = iter(spans)
            for _ in range(self.depth):
                try:
                    s, e = next(it)
                except StopIteration:
                    break
                pending.append((s, e, ex.submit(self.load_fn, s, e)))
            while pending:
                start, stop, fut = pending.popleft()
                payload = fut.result()
                try:
                    s, e = next(it)
                    pending.append((s, e, ex.submit(self.load_fn, s, e)))
                except StopIteration:
                    pass
                # the next window is now decoding while the consumer works
                yield start, stop, payload
        finally:
            # Cancellation-under-fault contract (pinned by
            # tests/test_faults.py): closing the generator — or a worker
            # exception surfacing through ``fut.result()`` — cancels
            # every queued-but-unstarted load and joins only the one in
            # flight.  Unconsumed payloads are dropped here without
            # touching the consumer's ledger, so ``FetchStats`` can
            # never double-account a window that was never yielded; an
            # in-flight worker that raises parks its exception in the
            # abandoned future (never re-raised).
            ex.shutdown(wait=True, cancel_futures=True)


class EventStore:
    """Columnar store with basket-granular compressed access."""

    def __init__(
        self,
        basket_events: int = 4096,
        codec: str = "bitpack",
        decode_cache_baskets: int = DECODE_CACHE_BASKETS,
        verify: bool = True,
        decode_backend: str | None = None,
        device=None,
    ):
        self.basket_events = int(basket_events)
        self.codec = codec
        # basket decode tier (DESIGN.md §16): "host" runs the numpy codec
        # reference, "device" ships compressed plane words to ``device``
        # and decodes them there (bitpack only; bit-identical by
        # contract).  None resolves lazily: "device" on the card, "host"
        # when the store's device is the CPU.  A codec with no device
        # decode (zlib, raw) is counted in ``decode_fallbacks``; an error
        # of the device decode itself propagates.
        if decode_backend not in (None, "host", "device"):
            raise ValueError(f"unknown decode_backend {decode_backend!r}")
        self.decode_backend = decode_backend
        self._decode_backend_resolved: str | None = None
        # where device decodes run: None resolves lazily, at the first
        # decode, to the card (raising if there is none); "cpu" decodes
        # with the kernels' plain versions.  A store that is only built,
        # saved or hashed never needs a device.
        self.device = device
        self._device_resolved = None
        self.decode_device_baskets = 0
        self.decode_host_baskets = 0
        self.decode_fallbacks = 0
        # enforce basket digests on every fetch (INTEGRITY_VERSION);
        # ``False`` restores the unverified fast path for A/B costing
        # (benchmarks/bench_faults.py pins the overhead under 2%)
        self.verify = bool(verify)
        self.branches: dict[str, Branch] = {}
        self.n_events = 0
        self._baskets: dict[str, list[BasketMeta]] = {}
        self._blobs: dict[str, list[bytes]] = {}
        # per-branch placement index of the range lookup (:meth:`_basket_index`)
        self._index: dict[str, tuple] = {}
        # small decoded-basket LRU so windows that overlap between phase 1
        # and phase 2 (counts branches, shared-scan tenants) don't decode
        # the same basket twice.  Keyed by (branch, blob) — content, not
        # identity — so it can never serve stale data.  0 disables.
        self.decode_cache_baskets = int(decode_cache_baskets)
        self._decode_cache: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._decode_lock = threading.Lock()
        self.decode_cache_hits = 0
        self.decode_cache_misses = 0
        # byte-weighted savings: decoded bytes NOT re-decoded thanks to
        # a hit / decoded on a miss (same currency as the cluster result
        # cache's saved_fetch_bytes — see repro_torch.obs.metrics)
        self.decode_cache_hit_bytes = 0
        self.decode_cache_miss_bytes = 0

    # -- construction -------------------------------------------------------

    @classmethod
    def from_arrays(
        cls,
        columns: dict[str, np.ndarray],
        jagged: dict[str, str] | None = None,
        basket_events: int = 4096,
        codec: str = "bitpack",
        decode_backend: str | None = None,
        device=None,
    ) -> "EventStore":
        """Build a store.

        ``columns`` maps branch name -> values.  For jagged branches the
        entry holds the flattened values and ``jagged[name]`` names the
        counts branch (itself a flat integer column in ``columns``).
        """
        jagged = jagged or {}
        store = cls(
            basket_events=basket_events,
            codec=codec,
            decode_backend=decode_backend,
            device=device,
        )

        flat_names = [n for n in columns if n not in jagged]
        if not flat_names:
            raise ValueError("need at least one flat branch to set n_events")
        store.n_events = len(columns[flat_names[0]])

        for name in flat_names:
            arr = np.asarray(columns[name])
            if len(arr) != store.n_events:
                raise ValueError(f"branch {name}: length mismatch")
            store._add_flat(name, arr)

        for name, counts_name in jagged.items():
            counts = np.asarray(columns[counts_name]).astype(np.int32)
            values = np.asarray(columns[name])
            if counts.sum() != len(values):
                raise ValueError(f"branch {name}: counts/values mismatch")
            store._add_jagged(name, values, counts, counts_name)
        return store

    def _add_flat(self, name: str, arr: np.ndarray) -> None:
        br = Branch(name, str(arr.dtype), jagged=False)
        metas, blobs = [], []
        for start in range(0, self.n_events, self.basket_events):
            stop = min(start + self.basket_events, self.n_events)
            chunk = arr[start:stop]
            blob = encode_basket(chunk, self.codec)
            vmin, vmax, n_true = basket_stats(chunk)
            metas.append(
                BasketMeta(
                    start, stop - start, len(chunk), len(blob), chunk.nbytes,
                    vmin=vmin, vmax=vmax, n_true=n_true,
                    digest=basket_digest(blob),
                )
            )
            blobs.append(blob)
        self.branches[name] = br
        self._baskets[name] = metas
        self._blobs[name] = blobs

    def _add_jagged(
        self, name: str, values: np.ndarray, counts: np.ndarray, counts_name: str
    ) -> None:
        br = Branch(name, str(values.dtype), jagged=True, counts_branch=counts_name)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        metas, blobs = [], []
        for start in range(0, self.n_events, self.basket_events):
            stop = min(start + self.basket_events, self.n_events)
            v0, v1 = offsets[start], offsets[stop]
            chunk = values[v0:v1]
            blob = encode_basket(chunk, self.codec)
            vmin, vmax, n_true = basket_stats(chunk)
            metas.append(
                BasketMeta(
                    start, stop - start, len(chunk), len(blob), chunk.nbytes,
                    vmin=vmin, vmax=vmax, n_true=n_true,
                    digest=basket_digest(blob),
                )
            )
            blobs.append(blob)
        self.branches[name] = br
        self._baskets[name] = metas
        self._blobs[name] = blobs

    # -- metadata -----------------------------------------------------------

    def branch_names(self) -> list[str]:
        return list(self.branches)

    def first_event_index(self, name: str) -> np.ndarray:
        """The paper's per-branch "first event index array"."""
        return np.array(self._basket_index(name)[1], dtype=np.int64)

    def _basket_index(self, name: str) -> tuple:
        """``(metas, firsts, ends)`` of a branch's baskets: each basket's
        first entry and ``first_entry + n_entries`` in basket order, both
        ascending (``load`` refuses a file whose placements do not).

        Built on the first lookup and kept while ``_baskets[name]`` is the
        same list, so a list set anew (``_add_flat``, ``_add_jagged``,
        ``load``) is indexed again.  A meta replaced in place must keep its
        placement, as a legacy row does."""
        metas = self._baskets[name]
        index = self._index.get(name)
        if index is None or index[0] is not metas:
            index = (metas, [m.first_entry for m in metas],
                     [m.first_entry + m.n_entries for m in metas])
            self._index[name] = index
        return index

    def basket_ids_for_range(self, name: str, start: int, stop: int) -> list[int]:
        """Ids, ascending, of the baskets of ``name`` that overlap
        ``[start, stop)``: those whose first entry is below ``stop`` and
        whose end is above ``start``.

        With ascending firsts and ends the first condition holds on a
        prefix of the baskets and the second on a suffix, so two
        bisections find the run between them."""
        _, firsts, ends = self._basket_index(name)
        return list(range(bisect_right(ends, start), bisect_left(firsts, stop)))

    def basket_meta(self, name: str, basket_id: int) -> BasketMeta:
        return self._baskets[name][basket_id]

    def n_baskets(self, name: str) -> int:
        return len(self._baskets[name])

    def compressed_bytes(self, names=None) -> int:
        names = names if names is not None else self.branch_names()
        return sum(m.comp_bytes for n in names for m in self._baskets[n])

    def raw_bytes(self, names=None) -> int:
        names = names if names is not None else self.branch_names()
        return sum(m.raw_bytes for n in names for m in self._baskets[n])

    def range_comp_bytes(self, names, start: int, stop: int) -> tuple[int, int]:
        """``(compressed bytes, basket count)`` of ``names`` overlapping
        ``[start, stop)`` — what a fetch round for that window would move.
        Pure metadata; the pruning ledger prices skipped fetches with it."""
        total = baskets = 0
        for name in names:
            for i in self.basket_ids_for_range(name, start, stop):
                total += self._baskets[name][i].comp_bytes
                baskets += 1
        return total, baskets

    def window_stats(self, name: str, start: int, stop: int) -> ZoneStats | None:
        """Aggregate zone-map stats of one branch over ``[start, stop)``.

        Returns ``None`` when any overlapping basket lacks stats (legacy
        store, non-finite data) — the conservative "unknown" that the
        interval analysis maps to *scan*.  Baskets only partially inside
        the range contribute their full-basket bounds, which keeps the
        interval a superset of the range's true values (conservative in
        the safe direction for both prune and accept-all).
        """
        ids = self.basket_ids_for_range(name, start, stop)
        lo = hi = None
        n_true: int | None = 0
        n_entries = n_values = 0
        is_bool = self.branches[name].np_dtype() == np.bool_
        for i in ids:
            m = self._baskets[name][i]
            n_entries += m.n_entries
            n_values += m.n_values
            if m.n_values == 0:
                continue  # empty basket constrains nothing
            if m.vmin is None or m.vmax is None:
                return None  # unknown stats poison the whole range
            lo = m.vmin if lo is None else min(lo, m.vmin)
            hi = m.vmax if hi is None else max(hi, m.vmax)
            if is_bool:
                if m.n_true is None:
                    return None
                n_true += m.n_true
        return ZoneStats(
            lo=lo, hi=hi, n_true=n_true if is_bool else None,
            n_entries=n_entries, n_values=n_values,
        )

    def manifest(self) -> dict:
        """Canonical description of the store's physical layout: branch
        schemas plus every basket's placement and size.  Two stores holding
        byte-identical baskets produce equal manifests, which is what makes
        the manifest hash usable as a content address for skim results
        (DESIGN.md §5).  Since ZONEMAP_VERSION 1 every basket row also
        carries its zone-map stats, so shard manifests ship the pruning
        metadata for free and any stat change re-addresses the content.
        Since INTEGRITY_VERSION 1 each row also carries the blob's CRC-32
        digest — digest-bearing stores therefore hash differently from
        legacy ones, re-addressing every cluster cache key without a
        CACHE_KEY_VERSION bump (digests are deterministic functions of
        the basket contents, so re-encoding identical data still hits)."""
        return {
            "n_events": self.n_events,
            "basket_events": self.basket_events,
            "codec": self.codec,
            "zonemap_version": ZONEMAP_VERSION,
            "integrity_version": INTEGRITY_VERSION,
            "branches": {
                n: [b.dtype, b.jagged, b.counts_branch]
                for n, b in sorted(self.branches.items())
            },
            "baskets": {
                n: [m.stats_row() for m in self._baskets[n]]
                for n in sorted(self._baskets)
            },
        }

    def manifest_hash(self) -> str:
        """SHA-256 of the canonical manifest (hex)."""
        import hashlib

        doc = json.dumps(self.manifest(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(doc.encode()).hexdigest()

    def slice_events(self, spans: "list[tuple[int, int]]") -> "EventStore":
        """Build a new store holding the concatenation of event ranges.

        ``spans`` is a list of half-open ``[start, stop)`` event ranges,
        taken in the given order.  The result re-baskets with this store's
        ``basket_events``/``codec``, so when every span is basket-aligned
        the sliced baskets are byte-identical to the originals — the
        property the cluster shard layer relies on (DESIGN.md §5).
        """
        columns: dict[str, np.ndarray] = {}
        jagged: dict[str, str] = {}
        for name, br in self.branches.items():
            if br.jagged:
                jagged[name] = br.counts_branch
                parts = [self.read_jagged(name, a, b)[0] for a, b in spans]
            else:
                parts = [self.read_flat(name, a, b) for a, b in spans]
            columns[name] = (
                np.concatenate(parts) if parts else np.empty(0, dtype=br.np_dtype())
            )
        store = EventStore(
            basket_events=self.basket_events, codec=self.codec, device=self.device
        )
        flat = [n for n in columns if n not in jagged]
        store.n_events = int(sum(b - a for a, b in spans))
        for name in flat:
            arr = np.asarray(columns[name])
            if len(arr) != store.n_events:
                raise ValueError(f"branch {name}: length mismatch in slice")
            store._add_flat(name, arr)
        for name, counts_name in jagged.items():
            counts = np.asarray(columns[counts_name]).astype(np.int32)
            store._add_jagged(name, np.asarray(columns[name]), counts, counts_name)
        return store

    # -- basket access ------------------------------------------------------

    def _verify_blob(self, name: str, basket_id: int, blob: bytes) -> None:
        """Recompute and enforce one blob's digest (no-op for legacy
        metadata without one, or with ``verify=False``)."""
        meta = self._baskets[name][basket_id]
        if meta.digest is None:
            return
        actual = basket_digest(blob)
        if actual != meta.digest:
            raise CorruptBasket(name, basket_id, meta.digest, actual)

    def corrupt_blob(self, name: str, basket_id: int, xor: int = 0xFF):
        """Deterministically flip bits in one stored blob (fault
        injection for tests/chaos).  Returns a zero-arg ``restore()``
        callable that puts the original bytes back — the chaos harness
        models transient read-path corruption, not durable media loss."""
        blobs = self._blobs[name]
        original = blobs[basket_id]
        corrupted = bytes([original[0] ^ (xor & 0xFF)]) + original[1:]
        blobs[basket_id] = corrupted

        def restore():
            blobs[basket_id] = original

        return restore

    def fetch_basket(
        self, name: str, basket_id: int, stats: FetchStats | None = None
    ) -> bytes:
        blob = self._blobs[name][basket_id]
        if self.verify:
            self._verify_blob(name, basket_id, blob)
        if stats is not None:
            stats.record(name, len(blob))
        return blob

    def fetch_range(
        self,
        name: str,
        start: int,
        stop: int,
        stats: FetchStats | None = None,
        coalesce: bool = True,
    ) -> list[tuple[BasketMeta, bytes]]:
        """Fetch all baskets overlapping [start, stop).

        ``coalesce=True`` models TTreeCache-style prefetching: one request
        for the whole contiguous run of baskets.  ``coalesce=False`` models
        the on-demand per-basket reads the paper observed for local
        server-side access (§4, "TTreeCache does not function for local
        ROOT file access").
        """
        ids = self.basket_ids_for_range(name, start, stop)
        out = []
        total = 0
        for i in ids:
            blob = self._blobs[name][i]
            if self.verify:
                self._verify_blob(name, i, blob)
            total += len(blob)
            out.append((self._baskets[name][i], blob))
        if stats is not None:
            stats.record(name, total, n_requests=1 if coalesce else max(len(ids), 1))
        return out

    def fetch_window(
        self,
        names: list[str],
        start: int,
        stop: int,
        stats: FetchStats | None = None,
        coalesce: bool = True,
        cache_bytes: int = TTREECACHE_BYTES,
    ) -> dict[str, list[tuple[BasketMeta, bytes]]]:
        """Fetch every basket of ``names`` overlapping [start, stop) as one
        read round — the TTreeCache model made explicit.

        ``coalesce=True``: all baskets of the round are aggregated into
        bulk requests of at most ``cache_bytes`` (one request for typical
        windows), which is what the prefetcher overlaps with compute.
        ``coalesce=False``: one request (seek) per basket — the paper's
        on-demand local-read behavior for server-side filtering.
        """
        out: dict[str, list[tuple[BasketMeta, bytes]]] = {}
        local = FetchStats()
        for name in names:
            out[name] = self.fetch_range(
                name, start, stop, stats=local, coalesce=coalesce
            )
        if stats is not None:
            if coalesce:
                stats.bytes_fetched += local.bytes_fetched
                stats.requests += coalesced_requests(
                    local.bytes_fetched, 0, True, cache_bytes
                )
                for k, v in local.by_branch.items():
                    stats.by_branch[k] = stats.by_branch.get(k, 0) + v
            else:
                stats.merge(local)
        return out

    def resolved_device(self):
        """The torch device device decodes run on (resolved once)."""
        if self._device_resolved is None:
            from repro_torch.device import resolve_device

            self._device_resolved = resolve_device(self.device)
        return self._device_resolved

    def resolved_decode_backend(self) -> str:
        """The decode tier actually in use: the configured backend, or
        (when unset) device on the card and host on the CPU."""
        if self._decode_backend_resolved is None:
            backend = self.decode_backend
            if backend is None:
                backend = (
                    "device" if self.resolved_device().type == "cuda" else "host"
                )
            self._decode_backend_resolved = backend
        return self._decode_backend_resolved

    def _decode_round_uncached(self, calls: list) -> list:
        """Backend-dispatched decode of a round's calls, ``[(branch,
        [blob, ...]), ...]`` (no cache); returns one list of arrays per call.

        The device tier covers the bitpack codec only, and decodes the
        whole round in one call, noting each call's (codec kind) groups in
        the dispatch ledger as the JAX package notes one ``decode_blobs``;
        other codecs fall back to the host reference, counted in
        ``decode_fallbacks``.  An error of the device decode itself is
        raised, never hidden behind the host path.  Both tiers are
        bit-identical by the codec contract."""
        n = sum(len(bs) for _, bs in calls)
        backend = self.resolved_decode_backend()
        if backend == "device" and n:
            if self.codec == "bitpack":
                vals = decode_basket_round(
                    {c: bs for c, (_, bs) in enumerate(calls)}, self.codec,
                    {c: self.branches[name].np_dtype()
                     for c, (name, _) in enumerate(calls)},
                    backend="device", device=self.resolved_device(),
                )
                with self._decode_lock:
                    self.decode_device_baskets += n
                return [vals[c] for c in range(len(calls))]
            with self._decode_lock:
                self.decode_fallbacks += n
        with self._decode_lock:
            self.decode_host_baskets += n
        return [[decode_basket(blob, self.codec, self.branches[name].np_dtype())
                 for blob in bs] for name, bs in calls]

    def decode_blob(self, name: str, blob: bytes) -> np.ndarray:
        """Decode one basket blob, memoized through a small per-store LRU.

        The cache key is ``(branch, blob bytes)`` — content-addressed, so
        hits are always exact.  Cached arrays are frozen (read-only) to
        keep aliasing safe across phase 1 / phase 2 and across shared-scan
        tenants; every current consumer slices or copies.  Thread-safe:
        the :class:`WindowPrefetcher` worker decodes concurrently with the
        consumer's phase 2.
        """
        return self.decode_blobs(name, [blob])[0]

    def decode_blobs(self, name: str, blobs: list) -> list:
        """Decode a list of basket blobs for one branch: a round of one
        call (:meth:`decode_calls`)."""
        return self.decode_calls([(name, blobs)])[0]

    def decode_round(self, blobs: dict) -> dict:
        """Decode a fetch round, ``{branch: [blob, ...]}``, as one
        :meth:`decode_calls` round of one call per branch, in the dict's
        order; returns ``{branch: [array, ...]}``."""
        return dict(zip(blobs, self.decode_calls(list(blobs.items()))))

    def decode_calls(self, calls: list) -> list:
        """Decode a fetch round given as a sequence of :meth:`decode_blobs`
        calls, ``[(branch, [blob, ...]), ...]``, through the decoded-basket
        LRU; returns one list of arrays per call.  A branch may come more
        than once (the engine's read of a jagged basket's leading counts).

        The LRU sees exactly what one :meth:`decode_blobs` per call, in
        order, would make it see — the same lookups, hits, misses, byte
        counters, insertions, evictions and freezing — but the misses of
        every call decode together (:meth:`_decode_round_uncached`), so a
        device-backed store pays one kernel launch per fetch round.  A
        miss holds its slot with a placeholder until the round's values
        arrive.  A later call of the same round that meets that
        placeholder counts the hit the inserted values would have given,
        and shares them; another thread that meets it counts a miss and
        decodes the basket itself, as it would have before the insert.
        """
        if self.decode_cache_baskets <= 0:
            return self._decode_round_uncached([(n, list(bs)) for n, bs in calls])
        out = [[None] * len(bs) for _, bs in calls]
        misses: list[list[int]] = []
        shared = []  # (call, index, key): hits on this round's placeholders
        pending = object()  # this round's placeholder
        with self._decode_lock:
            for c, (name, bs) in enumerate(calls):
                miss = []
                for i, blob in enumerate(bs):
                    cached = self._decode_cache.get((name, blob))
                    if cached is pending or isinstance(cached, np.ndarray):
                        self._decode_cache.move_to_end((name, blob))
                        self.decode_cache_hits += 1
                        if cached is pending:
                            shared.append((c, i, (name, blob)))
                        else:
                            self.decode_cache_hit_bytes += cached.nbytes
                            out[c][i] = cached
                    else:
                        self.decode_cache_misses += 1
                        miss.append(i)
                misses.append(miss)
                for i in miss:
                    self._decode_cache[(name, bs[i])] = pending
                    self._decode_cache.move_to_end((name, bs[i]))
                while len(self._decode_cache) > self.decode_cache_baskets:
                    self._decode_cache.popitem(last=False)
        todo = [(name, [bs[i] for i in miss]) for (name, bs), miss in zip(calls, misses)]
        decoded = None
        try:
            decoded = (self._decode_round_uncached(todo) if any(misses)
                       else [[] for _ in calls])
        finally:
            with self._decode_lock:
                values = {}  # key -> this round's decoded array
                for (name, bs), miss, vals_list, o in zip(
                        calls, misses, decoded or [None] * len(calls), out):
                    for j, i in enumerate(miss):
                        key = (name, bs[i])
                        if vals_list is None:  # the decode raised
                            if self._decode_cache.get(key) is pending:
                                del self._decode_cache[key]
                            continue
                        vals = vals_list[j]
                        if vals.flags.writeable:
                            vals.flags.writeable = False
                        self.decode_cache_miss_bytes += vals.nbytes
                        if self._decode_cache.get(key) is pending:
                            self._decode_cache[key] = vals
                        o[i] = values.setdefault(key, vals)
                if decoded is not None:
                    for c, i, key in shared:
                        out[c][i] = values[key]
                        self.decode_cache_hit_bytes += values[key].nbytes
        return out

    def decode_backend_stats(self) -> dict:
        """Decode-tier ledger: which tier decoded how many baskets, and
        how many device requests degraded to the host reference."""
        with self._decode_lock:
            return {
                "backend": self.resolved_decode_backend(),
                "device_baskets": self.decode_device_baskets,
                "host_baskets": self.decode_host_baskets,
                "fallbacks": self.decode_fallbacks,
            }

    def decode_cache_stats(self) -> dict:
        with self._decode_lock:
            hits, misses = self.decode_cache_hits, self.decode_cache_misses
            return {
                "hits": hits,
                "misses": misses,
                "resident": len(self._decode_cache),
                "hit_bytes": self.decode_cache_hit_bytes,
                "miss_bytes": self.decode_cache_miss_bytes,
                # decoded bytes a hit avoided re-producing — the decode
                # cache's byte-weighted savings currency
                "saved_decode_bytes": self.decode_cache_hit_bytes,
                "hit_rate": hits / max(hits + misses, 1),
            }

    # -- convenience full reads (not timed; for tests and writers) ----------

    def read_flat(self, name: str, start: int = 0, stop: int | None = None) -> np.ndarray:
        stop = self.n_events if stop is None else stop
        parts = []
        for meta, blob in self.fetch_range(name, start, stop):
            vals = self.decode_blob(name, blob)
            lo = max(start - meta.first_entry, 0)
            hi = min(stop - meta.first_entry, meta.n_entries)
            parts.append(vals[lo:hi])
        if not parts:
            return np.empty(0, dtype=self.branches[name].np_dtype())
        return np.concatenate(parts)

    def read_jagged(
        self, name: str, start: int = 0, stop: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        stop = self.n_events if stop is None else stop
        br = self.branches[name]
        counts = self.read_flat(br.counts_branch, start, stop).astype(np.int64)
        parts = []
        for meta, blob in self.fetch_range(name, start, stop):
            vals = self.decode_blob(name, blob)
            # per-basket event counts to slice values at event granularity
            bc = self.read_flat(
                br.counts_branch, meta.first_entry, meta.first_entry + meta.n_entries
            ).astype(np.int64)
            boff = np.concatenate([[0], np.cumsum(bc)])
            lo_e = max(start - meta.first_entry, 0)
            hi_e = min(stop - meta.first_entry, meta.n_entries)
            parts.append(vals[boff[lo_e] : boff[hi_e]])
        values = (
            np.concatenate(parts) if parts else np.empty(0, dtype=br.np_dtype())
        )
        return values, counts

    # -- serialization ------------------------------------------------------

    def save(self, path: str) -> None:
        header = {
            "basket_events": self.basket_events,
            "codec": self.codec,
            "n_events": self.n_events,
            "zonemap_version": ZONEMAP_VERSION,
            "integrity_version": INTEGRITY_VERSION,
            "branches": {
                n: {
                    "dtype": b.dtype,
                    "jagged": b.jagged,
                    "counts_branch": b.counts_branch,
                }
                for n, b in self.branches.items()
            },
            "baskets": {
                n: [m.stats_row() for m in metas]
                for n, metas in self._baskets.items()
            },
        }
        # sort_keys makes the header — and with it the whole file —
        # deterministic in branch *content*, not dict insertion order;
        # the blob section must follow the same sorted order because
        # load() slurps blobs in header order
        hbytes = json.dumps(header, sort_keys=True).encode()
        with open(path, "wb") as f:
            f.write(len(hbytes).to_bytes(8, "little"))
            f.write(hbytes)
            for n in sorted(self.branches):
                for blob in self._blobs[n]:
                    f.write(blob)

    @classmethod
    def load(cls, path: str, device=None) -> "EventStore":
        with open(path, "rb") as f:
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen).decode())
            store = cls(
                basket_events=header["basket_events"], codec=header["codec"],
                device=device,
            )
            store.n_events = header["n_events"]
            for n, b in header["branches"].items():
                store.branches[n] = Branch(
                    n, b["dtype"], b["jagged"], b["counts_branch"]
                )
            for n, metas in header["baskets"].items():
                store._baskets[n] = [BasketMeta(*m) for m in metas]
                _check_placements(n, store._baskets[n])
            for n in store.branches:
                store._blobs[n] = [
                    f.read(m.comp_bytes) for m in store._baskets[n]
                ]
        return store

    # -- mutation used by the skim writer ------------------------------------

    @classmethod
    def from_selection(
        cls,
        columns: dict[str, np.ndarray],
        jagged: dict[str, str],
        basket_events: int,
        codec: str,
        device=None,
    ) -> "EventStore":
        return cls.from_arrays(
            columns, jagged=jagged, basket_events=basket_events, codec=codec,
            device=device,
        )
