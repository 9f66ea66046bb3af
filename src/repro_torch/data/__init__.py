from repro_torch.data.codecs import CODECS, decode_basket, encode_basket
from repro_torch.data.store import (
    TTREECACHE_BYTES,
    Branch,
    EventStore,
    FetchStats,
    WindowPrefetcher,
)
from repro_torch.data.synth import make_nanoaod_like

__all__ = [
    "CODECS",
    "encode_basket",
    "decode_basket",
    "Branch",
    "EventStore",
    "FetchStats",
    "WindowPrefetcher",
    "TTREECACHE_BYTES",
    "make_nanoaod_like",
]
