"""Content-addressed skim-result cache (DESIGN.md §5c).

Repeat and overlapping tenant queries are the norm in the paper's
multi-user regime: the same Higgs-style selection runs against the same
striped dataset over and over.  The cluster caches **per-shard** skim
results under a content address::

    key = sha256(canonical_query_form) . sha256(shard_manifest)

The canonical query form normalizes everything that cannot change the
result — AND-stage ordering, trigger-OR ordering, object-cut ordering —
and keeps everything that can (output branch patterns in order,
``force_all``, every threshold).  The shard side is the store's basket
manifest hash, so the address names *content*, not placement: two
clusters striping byte-identical shards share cache entries, and any
mutation of the underlying baskets changes the address.

Entries are whole :class:`NodeResponse` payloads (shard output store +
window ledger + accounting), budgeted by the output's compressed bytes
under LRU eviction.  ``CacheStats`` accounts hits/misses and the two byte
currencies: output bytes served from cache and phase-1/2 fetch bytes the
hit avoided.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from dataclasses import dataclass, field

from repro_torch.core.query import (
    AnyOf,
    Cut,
    DeltaRCut,
    ExprCut,
    HTCut,
    MassWindow,
    ObjectSelection,
    Query,
    parse_query,
)

# ---------------------------------------------------------------------------
# canonical query form
# ---------------------------------------------------------------------------


def _varcuts_doc(cuts) -> list:
    return sorted([c.var, c.op, float(c.value)] for c in cuts)


def _node_doc(node) -> list:
    if isinstance(node, Cut):
        return ["cut", node.branch, node.op, float(node.value)]
    if isinstance(node, AnyOf):
        return ["any", sorted(node.names)]
    if isinstance(node, ObjectSelection):
        return [
            "object", node.collection, _varcuts_doc(node.cuts), int(node.min_count)
        ]
    if isinstance(node, HTCut):
        return [
            "ht", node.collection, node.var,
            _varcuts_doc(node.object_cuts), node.op, float(node.value),
        ]
    if isinstance(node, MassWindow):
        # the leading-pair observables are symmetric in the two
        # collections (mass and ΔR of (leading A, leading B)), so the
        # canonical form sorts the pair and reordered queries share a key
        return ["mass", sorted(node.collections), float(node.lo), float(node.hi)]
    if isinstance(node, DeltaRCut):
        return ["deltaR", sorted(node.collections), node.op, float(node.value)]
    if isinstance(node, ExprCut):
        # the lowered stack program, not the source text: whitespace and
        # redundant parens normalize away, every op and constant stays
        return ["expr", [[op, arg] for op, arg in node.rpn],
                node.op, float(node.value)]
    raise TypeError(f"unknown AST node {type(node)}")


def canonical_query(query: Query | dict | str) -> str:
    """Deterministic JSON form of a query's *semantics*.

    Stages are AND-semantic, so node order inside a stage is sorted away;
    output branch patterns keep their order (pattern order is part of the
    output contract).  ``input``/``output`` paths and free-form ``meta``
    do not affect the result and are excluded.
    """
    q = query if isinstance(query, Query) else parse_query(query)
    doc = {
        "branches": list(q.branches),
        "force_all": bool(q.force_all),
        # strict changes what a store with missing trigger branches
        # produces (error vs constant-False), so it addresses content
        "strict": bool(q.strict),
        # the query-level cascade override (DESIGN.md §11): survivors are
        # bit-identical either way, but a cached NodeResponse carries the
        # executor's byte/request ledger, which the cascade changes —
        # None (engine decides) / True / False address differently
        "cascade": q.cascade,
        "stages": {
            name: sorted(
                (_node_doc(n) for n in stage),
                key=lambda d: json.dumps(d, sort_keys=True),
            )
            for name, stage in q.stages()
        },
    }
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def query_hash(query: Query | dict | str) -> str:
    return hashlib.sha256(canonical_query(query).encode()).hexdigest()


# Version prefix of the cache address format.  v2: shard manifests carry
# zone-map basket statistics (store.ZONEMAP_VERSION), so stores written
# before the stats upgrade hash differently — the version prefix makes
# that an explicit, debuggable namespace instead of a silent miss, and
# re-encoding identical data keeps hitting (stats are deterministic
# functions of the basket contents).  v3: the canonical query form grew
# the ``strict`` flag and the derived-expression node docs, changing
# query hashes for every query.  v4: the canonical form grew the
# ``cascade`` flag (cascaded phase-1 execution, DESIGN.md §11) — results
# are bit-identical across the upgrade, but cached responses carry the
# executor's accounting ledger, which the cascade changes.
CACHE_KEY_VERSION = 4


def versioned_key(query_hash_hex: str, manifest_hash: str) -> str:
    """Assemble the content address from precomputed hashes (the
    coordinator hashes the query once per fan-out)."""
    return f"v{CACHE_KEY_VERSION}.{query_hash_hex}.{manifest_hash}"


def cache_key(query: Query | dict | str, manifest_hash: str) -> str:
    """(query canonical form, shard manifest hash) -> content address."""
    return versioned_key(query_hash(query), manifest_hash)


# ---------------------------------------------------------------------------
# LRU byte-budgeted cache
# ---------------------------------------------------------------------------


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    replacements: int = 0  # same-key re-puts (racing primary vs fallback)
    evictions: int = 0
    stored_bytes: int = 0  # current resident output bytes
    hit_bytes: int = 0  # output bytes served from cache
    miss_bytes: int = 0  # output bytes inserted after misses
    saved_fetch_bytes: int = 0  # phase-1/2 fetch bytes hits avoided

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)

    def as_dict(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "insertions": self.insertions,
            "replacements": self.replacements,
            "evictions": self.evictions,
            "stored_bytes": self.stored_bytes,
            "hit_bytes": self.hit_bytes,
            "miss_bytes": self.miss_bytes,
            "saved_fetch_bytes": self.saved_fetch_bytes,
            "hit_rate": self.hit_rate,
        }


@dataclass
class _Entry:
    value: object
    nbytes: int
    fetch_bytes: int  # accounted fetch bytes a hit short-circuits


@dataclass
class SkimResultCache:
    """Thread-safe LRU cache of per-shard skim results, byte-budgeted.

    ``budget_bytes`` bounds the sum of entry sizes (the shard outputs'
    compressed bytes).  An entry larger than the whole budget is refused
    rather than flushing the cache for one tenant.
    """

    budget_bytes: int = 256 * 1024 * 1024
    stats: CacheStats = field(default_factory=CacheStats)

    def __post_init__(self):
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def contains(self, key: str) -> bool:
        """Membership peek — no LRU touch, no hit/miss accounting."""
        with self._lock:
            return key in self._entries

    def get(self, key: str):
        """Return the cached value or ``None``; accounts the hit/miss."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            self.stats.hit_bytes += entry.nbytes
            self.stats.saved_fetch_bytes += entry.fetch_bytes
            return entry.value

    def get_many(self, keys: "list[str]"):
        """All-or-nothing multi-get under ONE lock acquisition (no
        check-then-get race): returns the values in key order iff every
        key is resident (each accounted as a hit), else ``None`` (one
        miss per absent key)."""
        with self._lock:
            entries = [self._entries.get(k) for k in keys]
            if any(e is None for e in entries):
                self.stats.misses += sum(1 for e in entries if e is None)
                return None
            out = []
            for k, e in zip(keys, entries):
                self._entries.move_to_end(k)
                self.stats.hits += 1
                self.stats.hit_bytes += e.nbytes
                self.stats.saved_fetch_bytes += e.fetch_bytes
                out.append(e.value)
            return out

    def put(self, key: str, value, nbytes: int, fetch_bytes: int = 0) -> bool:
        """Insert under LRU eviction; returns False if over-budget."""
        with self._lock:
            if nbytes > self.budget_bytes:
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self.stats.stored_bytes -= old.nbytes
            while (
                self._entries
                and self.stats.stored_bytes + nbytes > self.budget_bytes
            ):
                _, victim = self._entries.popitem(last=False)
                self.stats.stored_bytes -= victim.nbytes
                self.stats.evictions += 1
            self._entries[key] = _Entry(value, nbytes, fetch_bytes)
            self.stats.stored_bytes += nbytes
            if old is None:
                self.stats.insertions += 1
                self.stats.miss_bytes += nbytes
            else:
                # re-putting the same content address (a timed-out
                # primary completing after its replica already won the
                # race) used to double-count insertions and miss_bytes
                self.stats.replacements += 1
            return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.stats.stored_bytes = 0
