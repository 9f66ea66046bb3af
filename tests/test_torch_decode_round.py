"""The port's round decode against the JAX package's per-branch decode.

A fetch round's bitpack baskets go to the device together
(``ops.basket_decode_round``: one staged buffer, one launch), while the
JAX package decodes each (branch, codec kind) group in its own call.  On
the CPU the port runs the same staging through the plain version of the
round (``ref.basket_decode_round_ref``), so these tests hold the staging
itself against the JAX package: every value bit for bit, and the ledgers
(``dispatch_stats()``, ``decode_backend_stats()``, ``decode_cache_stats()``)
equal.  Inputs come from numpy seeds.  Every comparison is exact.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the round builders the card checks use)
from repro.core.engine import run_skim as j_run_skim  # noqa: E402
from repro.data import codecs as jcodecs  # noqa: E402
from repro.data.synth import make_nanoaod_like as j_make  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.engine import run_skim as t_run_skim  # noqa: E402
from repro_torch.data import codecs as tcodecs  # noqa: E402
from repro_torch.data.synth import make_nanoaod_like as t_make  # noqa: E402
from repro_torch.kernels import basket_decode as tbd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_device_batch import BASKET, N_EVENTS, QUERY  # noqa: E402


def _np(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _branches(baskets, rng, extras=True):
    """Random baskets grouped into branches by output type (a branch has
    one dtype and may mix codec kinds); with ``extras`` some branches also
    get an empty basket and a raw-literal (kind 3) basket."""
    parts, dtypes = {}, {}
    for part, tdt in baskets:
        name = f"b_{_np(tdt).name}"
        parts.setdefault(name, []).append(part)
        dtypes[name] = _np(tdt)
    if extras:
        for name in list(parts)[::2]:
            parts[name].insert(0, {"kind": 1, "n": 0, "bits": 1, "n_pad": 32,
                                   "first": 0, "planes": np.zeros(1, np.uint32)})
            raw = rng.normal(size=int(rng.integers(1, 5000))).astype(np.float32)
            parts[name].append({"kind": 3, "n": raw.size, "bits": 32,
                                "n_pad": raw.size, "first": 0, "raw": raw,
                                "planes": np.zeros(0, np.uint32)})
    return parts, dtypes


def _jax_round(parts, dtypes):
    """The JAX package's decode of a round: one ``basket_decode_batch``
    call per (branch, kind) group, as its ``codecs.decode_basket_batch``
    makes them."""
    out = {}
    for name, ps in parts.items():
        dtype = dtypes[name]
        vals = [None] * len(ps)
        groups: dict = {}
        for i, p in enumerate(ps):
            if p["n"] == 0:
                vals[i] = np.empty(0, dtype=dtype)
            else:
                groups.setdefault(p["kind"], []).append(i)
        for _kind, idxs in sorted(groups.items()):
            decoded = jops.basket_decode_batch([ps[i] for i in idxs], dtype)
            for i, v in zip(idxs, decoded):
                vals[i] = np.asarray(v).astype(dtype)
        out[name] = vals
    return out


def _assert_rounds_equal(got, want, dtypes):
    assert got.keys() == want.keys()
    for name in want:
        assert len(got[name]) == len(want[name])
        for g, w in zip(got[name], want[name]):
            assert g.dtype == dtypes[name] and g.shape == w.shape, name
            assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("seed", range(6))
def test_round_matches_jax_per_branch_kind(seed):
    """Mixed kinds, widths 0-32, ragged tails, a basket wider than the
    kernel's chunk, every output type, empty and raw-literal baskets."""
    rng = np.random.default_rng(seed)
    parts, dtypes = _branches(chip_smoke.random_round(rng, 16), rng)
    got = tops.basket_decode_round(parts, dtypes, device="cpu")
    _assert_rounds_equal(got, _jax_round(parts, dtypes), dtypes)


@pytest.mark.parametrize("bits", [0, 1, 31, 32])
def test_round_plane_widths_match_jax(bits):
    """One plane width over every kind it applies to, with value counts
    1, 31, 33 and 4097, each decoded to every output type."""
    rng = np.random.default_rng(100 + bits)
    baskets = []
    for kind, names in chip_smoke.DECODE_OUT_DTYPES.items():
        b = 1 if kind == 2 else bits
        for n in (1, 31, 33, 4097):
            W = -(-n // 32)
            planes = np.zeros((max(b, 1), W), np.uint32)
            planes[:b] = rng.integers(0, 1 << 32, (b, W), dtype=np.uint64)
            part = {"kind": kind, "n": n, "bits": b, "n_pad": W * 32,
                    "first": int(rng.integers(0, 1 << 32, dtype=np.uint64)),
                    "planes": planes.reshape(-1)}
            baskets += [(part, getattr(torch, name)) for name in names]
    parts, dtypes = _branches(baskets, rng, extras=False)
    got = tops.basket_decode_round(parts, dtypes, device="cpu")
    _assert_rounds_equal(got, _jax_round(parts, dtypes), dtypes)


def test_round_of_blobs_matches_jax_and_the_host_codec():
    """Real blobs of several branches, raw literals and empty baskets
    among them: the round, the one-branch batch and the JAX package's
    device tier all give the encoded values."""
    blobs, dtypes, arrays = chip_smoke.round_blobs(np.random.default_rng(7))
    got = tcodecs.decode_basket_round(blobs, "bitpack", dtypes, backend="device",
                                      device="cpu")
    for name, arrs in arrays.items():
        want = jcodecs.decode_basket_batch(blobs[name], "bitpack", dtypes[name],
                                           backend="device")
        one = tcodecs.decode_basket_batch(blobs[name], "bitpack", dtypes[name],
                                          backend="device", device="cpu")
        for g, o, w, a in zip(got[name], one, want, arrs):
            assert g.dtype == a.dtype and g.tobytes() == a.tobytes(), name
            assert o.tobytes() == g.tobytes() and np.asarray(w).tobytes() == g.tobytes()


def test_round_ledger_is_one_dispatch_per_branch_kind():
    """``dispatch_stats()`` of one round equals the JAX package's for the
    same branches decoded one (branch, kind) group at a time."""
    rng = np.random.default_rng(3)
    parts, dtypes = _branches(chip_smoke.random_round(rng, 20), rng)
    tops.reset_dispatch_stats()
    jops.reset_dispatch_stats()
    for _ in range(2):  # the second round compiles nothing new
        tops.basket_decode_round(parts, dtypes, device="cpu")
        _jax_round(parts, dtypes)
    assert tops.dispatch_stats() == jops.dispatch_stats()
    assert tops.dispatch_stats()["dispatches"] > len(parts)


def test_staged_layout_is_what_the_kernel_reads():
    """Odd plane strides, 16-byte plane blocks and outputs, and the plain
    version of the round equal to the per-basket plain version."""
    rng = np.random.default_rng(5)
    baskets = chip_smoke.random_round(rng, 12)
    layout = tops.plan_round(baskets)
    descs = layout["descs"]
    assert (descs[:, 2] % 2 == 1).all() and (descs[:, 2] >= descs[:, 1]).all()
    assert (descs[:, 0] % 4 == 0).all() and (descs[:, 5] % 16 == 0).all()
    assert layout["base"] % 4 == 0
    assert (descs[:, 6] & tbd.STORE_PADDED).all()
    staged = torch.zeros(layout["n_in"], dtype=torch.int32)
    tops.fill_round(staged.numpy(), layout)
    out = tref.basket_decode_round_ref(*tops.round_views(staged, layout),
                                       layout["out_bytes"])
    for (part, tdt), (o, store) in zip(baskets, layout["stores"]):
        W = part["n_pad"] // 32
        planes = torch.from_numpy(part["planes"].view(np.int32).reshape(-1, W).copy())
        first = torch.tensor([part["first"]], dtype=torch.int64).to(torch.int32)
        want = tref.basket_decode_ref(planes[None, : part["bits"]], first, part["kind"],
                                      part["n"], store)
        got = out[o: o + part["n"] * store.itemsize].view(store)
        assert got.view(torch.uint8).tolist() == want[0].view(torch.uint8).tolist()


def _ledgers(store) -> tuple:
    return store.decode_backend_stats(), store.decode_cache_stats()


@pytest.mark.parametrize("device_batch", [None, 3])
@pytest.mark.parametrize("pipeline", [True, "threads"])
def test_run_skim_device_decode_ledgers_match_jax(device_batch, pipeline):
    """A whole skim with the device decode tier on the CPU: survivors,
    output bytes and every ledger equal to the JAX package's run."""
    kw = dict(n_hlt=16, n_filler=8, basket_events=BASKET)
    js, ts = j_make(N_EVENTS, **kw), t_make(N_EVENTS, device="cpu", **kw)
    js.decode_backend = ts.decode_backend = "device"
    run_kw = dict(pipeline=pipeline)
    if device_batch:
        run_kw["device_batch"] = device_batch
    jops.reset_dispatch_stats()
    tops.reset_dispatch_stats()
    jr = j_run_skim(js, QUERY, **run_kw)
    tr = t_run_skim(ts, QUERY, device="cpu", **run_kw)
    assert tr.n_passed == jr.n_passed > 0
    assert tr.output._blobs == jr.output._blobs
    assert tops.dispatch_stats() == jops.dispatch_stats()
    assert _ledgers(ts) == _ledgers(js)
    assert ts.decode_backend_stats()["device_baskets"] > 0


@pytest.mark.parametrize("cache", [0, 3, 64])
def test_round_lru_equals_per_branch_decode_blobs(cache):
    """Rounds through ``decode_round`` leave the LRU exactly as the JAX
    package's ``decode_blobs`` per branch, in the round's order, leaves
    it: the same hits, misses, bytes, resident keys in the same order,
    with a cache smaller than a round (evictions inside it)."""
    kw = dict(n_hlt=4, n_filler=2, basket_events=1024)
    js, ts = j_make(8_000, **kw), t_make(8_000, device="cpu", **kw)
    js.decode_cache_baskets = ts.decode_cache_baskets = cache
    names = ["MET_pt", "run", "nJet", "Jet_pt", "HLT_IsoMu24", "Electron_charge"]
    for start in (0, 4096, 0, 2048, 4096):
        window = ts.fetch_window(names, start, start + 4096)
        rnd = {n: [b for _, b in window[n]] for n in names}
        got = ts.decode_round(rnd)
        for n in names:
            want = js.decode_blobs(n, rnd[n])
            assert [g.tobytes() for g in got[n]] == [w.tobytes() for w in want]
            assert all(not g.flags.writeable for g in got[n]) or cache <= 0
        assert ts.decode_cache_stats() == js.decode_cache_stats()
        assert list(ts._decode_cache) == list(js._decode_cache)


def test_failed_round_leaves_no_placeholder():
    ts = t_make(4_000, device="cpu", n_hlt=4, n_filler=2, basket_events=1024)
    names = ["MET_pt", "nJet"]
    window = ts.fetch_window(names, 0, 2048)
    rnd = {n: [b for _, b in window[n]] for n in names}

    def fail(blobs):
        raise RuntimeError("decode failed")

    ts._decode_round_uncached = fail
    with pytest.raises(RuntimeError):
        ts.decode_round(rnd)
    assert not ts._decode_cache
    del ts._decode_round_uncached
    got = ts.decode_round(rnd)
    assert all(isinstance(v, np.ndarray) for v in ts._decode_cache.values())
    assert [g.tobytes() for g in got["MET_pt"]] == [
        tcodecs.decode_basket(b, "bitpack", np.float32).tobytes() for b in rnd["MET_pt"]]


def test_rounds_from_many_threads_keep_the_lru_whole():
    """Eight threads decode overlapping rounds through one store's LRU at
    once (the prefetcher and the consumer share it): every value is the
    host codec's, every lookup is counted once, and no placeholder is
    left behind."""
    import threading

    ts = t_make(8_000, device="cpu", n_hlt=4, n_filler=2, basket_events=1024)
    ts.decode_backend = "device"
    ts.decode_cache_baskets = 5  # smaller than a round: evictions race inserts
    names = ["MET_pt", "run", "nJet", "Jet_pt"]
    rounds = []
    for start in range(0, 8_000, 2048):
        window = ts.fetch_window(names, start, start + 2048)
        rounds.append({n: [b for _, b in window[n]] for n in names})
    want = [{n: [tcodecs.decode_basket(b, "bitpack", ts.branches[n].np_dtype()).tobytes()
                 for b in r[n]] for n in names} for r in rounds]
    lookups = sum(len(bs) for r in rounds for bs in r.values())
    errors = []

    def work(k):
        for i in range(12):
            j = (k + i) % len(rounds)
            got = ts.decode_round(rounds[j])
            if {n: [g.tobytes() for g in got[n]] for n in names} != want[j]:
                errors.append((k, j))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,), name=f"round-{k}")
                   for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    stats = ts.decode_cache_stats()
    assert stats["hits"] + stats["misses"] == 8 * 12 * lookups // len(rounds)
    assert all(isinstance(v, np.ndarray) for v in ts._decode_cache.values())
    assert len(ts._decode_cache) <= 5
