"""The PyTorch port's data layer against the JAX package's.

Codecs, the store and the synthetic generator are numpy code that the
port keeps its own copy of: the same seed gives the same bytes, a store
saved by one package loads in the other, and fetch accounting, CRC
digests and the decode tiers agree.  Every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

from repro.data import codecs as jcodecs
from repro.data.store import CorruptBasket as JCorrupt
from repro.data.store import EventStore as JStore
from repro.data.store import FetchStats as JFetchStats
from repro.data.synth import make_nanoaod_like as j_make
from repro_torch.data import codecs as tcodecs
from repro_torch.data.store import CorruptBasket as TCorrupt
from repro_torch.data.store import EventStore as TStore
from repro_torch.data.store import FetchStats as TFetchStats
from repro_torch.data.synth import make_nanoaod_like as t_make

N = 20_000
SHAPE = dict(n_hlt=16, n_filler=4)


@pytest.fixture(scope="module")
def stores():
    return j_make(N, **SHAPE), t_make(N, **SHAPE, device="cpu")


def _columns(store, names):
    out = {}
    for name in names:
        if store.branches[name].jagged:
            out[name] = store.read_jagged(name)
        else:
            out[name] = (store.read_flat(name),)
    return out


def _assert_same_columns(a, b):
    assert a.keys() == b.keys()
    for name in a:
        for x, y in zip(a[name], b[name]):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("codec", ["bitpack", "zlib", "raw"])
@pytest.mark.parametrize("seed,basket_events", [(0, 4096), (5, 777)])
def test_synth_blobs_byte_identical(codec, seed, basket_events):
    kw = dict(n_hlt=8, n_filler=2, basket_events=basket_events, codec=codec, seed=seed)
    js, ts = j_make(6_000, **kw), t_make(6_000, **kw, device="cpu")
    assert ts.branch_names() == js.branch_names()
    assert ts._blobs == js._blobs
    assert ts.manifest() == js.manifest()
    assert ts.manifest_hash() == js.manifest_hash()


@pytest.mark.parametrize("codec", ["bitpack", "zlib", "raw"])
@pytest.mark.parametrize(
    "arr",
    [
        np.arange(5000, dtype=np.int32) * 3 - 7,
        np.random.default_rng(1).integers(-(1 << 30), 1 << 30, 777).astype(np.int32),
        np.random.default_rng(2).normal(size=4096).astype(np.float32),
        np.random.default_rng(3).choice(np.array([0.5, 1.0, -0.0], np.float32), 100),
        np.random.default_rng(4).random(33) < 0.5,
    ],
    ids=["ramp", "wide-int", "smooth-float", "discrete-float", "bool"],
)
def test_codecs_cross_decode(codec, arr):
    jblob = jcodecs.encode_basket(arr, codec)
    tblob = tcodecs.encode_basket(arr, codec)
    assert jblob == tblob
    for blob, dec in ((jblob, tcodecs.decode_basket), (tblob, jcodecs.decode_basket)):
        out = dec(blob, codec, arr.dtype)
        assert out.dtype == arr.dtype and out.tobytes() == arr.tobytes()
    if codec == "bitpack":
        jp, tp = jcodecs.bitpack_raw_parts(jblob), tcodecs.bitpack_raw_parts(tblob)
        assert jp.keys() == tp.keys()
        for k in jp:
            assert np.array_equal(np.asarray(jp[k]), np.asarray(tp[k])), k


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_save_load_across_packages(tmp_path, stores, direction):
    js, ts = stores
    path = str(tmp_path / "x.skim")
    if direction == "jax-to-torch":
        js.save(path)
        loaded, src = TStore.load(path, device="cpu"), js
    else:
        ts.save(path)
        loaded, src = JStore.load(path), ts
    assert loaded.manifest_hash() == src.manifest_hash()
    assert loaded._blobs == src._blobs
    names = ["MET_pt", "run", "HLT_IsoMu24", "Electron_pt", "Jet_pt", "nMuon"]
    _assert_same_columns(_columns(loaded, names), _columns(src, names))


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("span", [(0, N), (1500, 2100), (4096, 8192), (19_999, N)])
def test_fetch_window_stats_equal(stores, coalesce, span):
    js, ts = stores
    names = ["MET_pt", "Electron_pt", "nElectron", "HLT_IsoMu24"]
    jst, tst = JFetchStats(), TFetchStats()
    jout = js.fetch_window(names, *span, stats=jst, coalesce=coalesce)
    tout = ts.fetch_window(names, *span, stats=tst, coalesce=coalesce)
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert {k: [b for _, b in v] for k, v in tout.items()} == {
        k: [b for _, b in v] for k, v in jout.items()
    }
    assert [m.stats_row() for m, _ in tout["MET_pt"]] == [
        m.stats_row() for m, _ in jout["MET_pt"]
    ]


@pytest.mark.parametrize("branch,basket", [("MET_pt", 1), ("Electron_eta", 3)])
def test_corrupt_basket_raises_the_same(branch, basket):
    kw = dict(n_hlt=4, n_filler=2, basket_events=512)
    js, ts = j_make(2_000, **kw), t_make(2_000, **kw, device="cpu")
    assert tcodecs.basket_digest(ts._blobs[branch][basket]) == jcodecs.basket_digest(
        js._blobs[branch][basket]
    )
    restore_j, restore_t = js.corrupt_blob(branch, basket), ts.corrupt_blob(branch, basket)
    with pytest.raises(JCorrupt) as je:
        js.fetch_basket(branch, basket)
    with pytest.raises(TCorrupt) as te:
        ts.fetch_basket(branch, basket)
    assert (te.value.branch, te.value.basket_id, te.value.expected, te.value.actual) == (
        je.value.branch, je.value.basket_id, je.value.expected, je.value.actual
    )
    assert str(te.value) == str(je.value)
    restore_j()
    restore_t()
    _assert_same_columns(_columns(ts, [branch]), _columns(js, [branch]))


@pytest.mark.parametrize("codec", ["bitpack", "zlib"])
@pytest.mark.parametrize("backend", ["device", "host"])
def test_decode_tiers_equal(codec, backend):
    """The port's device tier on the CPU (the kernels' plain versions)
    and its host tier both decode the JAX package's bytes exactly; a codec
    with no device decode is counted as a fallback, as in the JAX
    package."""
    kw = dict(n_hlt=8, n_filler=2, basket_events=1024, codec=codec)
    js, ts = j_make(5_000, **kw), t_make(5_000, **kw, device="cpu")
    js.decode_backend = backend
    ts.decode_backend = backend
    names = ["MET_pt", "run", "event", "HLT_IsoMu24", "Electron_pt", "Electron_charge",
             "nJet", "Jet_pt"]
    _assert_same_columns(_columns(ts, names), _columns(js, names))
    jd, td = js.decode_backend_stats(), ts.decode_backend_stats()
    assert td == jd
    if backend == "device" and codec == "bitpack":
        assert td["device_baskets"] > 0 and td["fallbacks"] == 0
    if backend == "device" and codec == "zlib":
        assert td["device_baskets"] == 0 and td["fallbacks"] > 0
    assert ts.decode_cache_stats() == js.decode_cache_stats()
