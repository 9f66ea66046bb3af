"""The decoded-basket LRU sees the port's lookups in the JAX package's order.

The JAX package's engine decodes a window branch by branch, and reads a
jagged basket's leading counts (``read_flat`` of the counts branch, for
a basket that starts before the window) right after that branch's own
decode.  The port decodes the whole fetch round in one call
(``EventStore.decode_calls``), which replays that sequence of lookups.
On windows that do not start on a basket boundary, with a cache smaller
than the window's baskets, every eviction must fall where the JAX
package's falls: these tests hold ``decode_cache_stats()``,
``decode_backend_stats()`` and ``dispatch_stats()`` equal, with
``pipeline=False`` (the prefetch thread makes the order of lookups
depend on timing in both packages).  Every comparison is exact.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from repro.core.engine import SkimEngine as JEngine  # noqa: E402
from repro.data.synth import make_nanoaod_like as j_make  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.engine import SkimEngine as TEngine  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like as t_make  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_device_batch import QUERY  # noqa: E402

STORE_KW = dict(n_hlt=16, n_filler=8, basket_events=2048)
N_EVENTS = 12_000


def _run_both(chunk, cache, backend, **engine_kw):
    js = j_make(N_EVENTS, **STORE_KW)
    ts = t_make(N_EVENTS, device="cpu", **STORE_KW)
    for store in (js, ts):
        store.decode_cache_baskets = cache
        store.decode_backend = backend
    jops.reset_dispatch_stats()
    tops.reset_dispatch_stats()
    jr = JEngine(js, chunk_events=chunk, **engine_kw).run(QUERY, pipeline=False)
    tr = TEngine(ts, chunk_events=chunk, device="cpu", **engine_kw).run(
        QUERY, pipeline=False)
    want = (js.decode_cache_stats(), js.decode_backend_stats(), jops.dispatch_stats())
    got = (ts.decode_cache_stats(), ts.decode_backend_stats(), tops.dispatch_stats())
    return jr, tr, want, got


def test_c1_case_matches_jax_ledgers():
    """The case that showed the fault: 777-event windows, a cache of 5
    baskets, the device decode tier."""
    jr, tr, want, got = _run_both(777, 5, "device")
    assert tr.n_passed == jr.n_passed == 67
    assert tr.output._blobs == jr.output._blobs
    cache, backend, dispatch = want
    assert (cache["hits"], cache["misses"]) == (20, 70)
    assert backend["device_baskets"] == 70
    assert dispatch["dispatches"] == 31
    assert got == want


@pytest.mark.parametrize("cascade", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("cache", [2, 5, 8])
@pytest.mark.parametrize("chunk", [777, 3000])
def test_unaligned_windows_match_jax_ledgers(chunk, cache, backend, fused, cascade):
    """Windows that do not start on a basket boundary, with caches
    smaller than a window's baskets: the same survivors, output bytes
    and ledgers as the JAX package."""
    jr, tr, want, got = _run_both(chunk, cache, backend, fused=fused,
                                  cascade=cascade)
    assert tr.n_passed == jr.n_passed
    assert tr.output._blobs == jr.output._blobs
    assert got == want


@pytest.mark.parametrize("device_batch", [2, 3])
def test_batched_unaligned_windows_match_jax_ledgers(device_batch):
    """The batched cascade decodes through the same rounds."""
    jr, tr, want, got = _run_both(777, 5, "device", device_batch=device_batch)
    assert tr.n_passed == jr.n_passed
    assert tr.output._blobs == jr.output._blobs
    assert got == want


def test_lead_read_joins_its_round():
    """The lead reads decode in the round's launch, not in one of their
    own: a device-decode store makes one decode call per fetch round."""
    ts = t_make(N_EVENTS, device="cpu", **STORE_KW)
    ts.decode_cache_baskets = 2
    ts.decode_backend = "device"
    rounds = {"decode": 0, "fetch": 0}
    decode, fetch = ts._decode_round_uncached, ts.fetch_window

    def counting_decode(calls):
        rounds["decode"] += 1
        return decode(calls)

    def counting_fetch(*a, **k):
        rounds["fetch"] += 1
        return fetch(*a, **k)

    ts._decode_round_uncached, ts.fetch_window = counting_decode, counting_fetch
    TEngine(ts, chunk_events=777, device="cpu").run(QUERY, pipeline=False)
    assert 0 < rounds["decode"] <= rounds["fetch"]
