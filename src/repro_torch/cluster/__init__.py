"""The cluster layer's content-addressed skim-result cache (DESIGN.md §5c).

Only ``cache.py`` is ported so far: the verifier needs its canonical
query form.  The coordinator, nodes and retry policy are still to port.
"""

from repro_torch.cluster.cache import (
    CACHE_KEY_VERSION,
    CacheStats,
    SkimResultCache,
    cache_key,
    canonical_query,
    query_hash,
    versioned_key,
)

__all__ = [
    "CACHE_KEY_VERSION",
    "CacheStats",
    "SkimResultCache",
    "cache_key",
    "canonical_query",
    "query_hash",
    "versioned_key",
]
