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
from repro_torch.data.store import BasketMeta
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


def _every_basket_shape(n, basket_events, seed=7):
    """Flat and jagged branches of each stored type: NaN and inf, floats too
    wide to pack, int deltas that wrap, sparse and all-false bools, and
    counts whose first basket holds no object."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(1.5, n).astype(np.int32)
    counts[:basket_events] = 0
    cols, jagged = {}, {}
    for prefix, size in (("F", n), ("J", int(counts.sum()))):
        smooth = np.round(rng.normal(size=size), 1).astype(np.float32)
        with_nan, with_inf = smooth.copy(), smooth.copy()
        with_nan[size // 2:size // 2 + 1] = np.nan
        with_inf[-1:] = -np.inf
        cols.update({
            f"{prefix}_smooth": smooth, f"{prefix}_nan": with_nan, f"{prefix}_inf": with_inf,
            f"{prefix}_wide": rng.uniform(-1e30, 1e30, size).astype(np.float32),
            f"{prefix}_int": rng.integers(-(1 << 31), (1 << 31) - 1, size, dtype=np.int32),
            f"{prefix}_small": rng.integers(-1, 8, size, dtype=np.int32),
            f"{prefix}_u8": rng.integers(0, 4, size, dtype=np.uint8),
            f"{prefix}_bits": rng.random(size) < 0.02,
            f"{prefix}_off": np.zeros(size, bool),
        })
    cols["nJ"] = counts
    jagged.update({name: "nJ" for name in cols if name.startswith("J_")})
    return cols, jagged


@pytest.mark.parametrize("codec", ["bitpack", "zlib", "raw"])
@pytest.mark.parametrize(
    "n, basket_events", [(0, 64), (5, 4096), (1000, 100), (2 * 4096 + 31, 4096)]
)
def test_stores_of_every_basket_shape_byte_identical(codec, n, basket_events):
    # the same blobs and zone maps, basket by basket, for every stored type
    cols, jagged = _every_basket_shape(n, basket_events)
    js = JStore.from_arrays(cols, jagged=jagged, basket_events=basket_events, codec=codec)
    ts = TStore.from_arrays(cols, jagged=jagged, basket_events=basket_events, codec=codec,
                            device="cpu")
    assert ts.branch_names() == js.branch_names()
    assert ts._blobs == js._blobs
    assert ts.manifest() == js.manifest()
    for name in cols:
        assert ([m.stats_row() for m in ts._baskets[name]]
                == [m.stats_row() for m in js._baskets[name]]), name


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


# basket size -> event count leaving a short last basket (size 1 cannot)
LOOKUP_SHAPES = {1: 23, 7: 7 * 13 + 3, 100: 1037, 4096: 2 * 4096 + 31}


def _lookup_columns(n, seed=11):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(1.5, n).astype(np.int32)
    cols = {"nJ": counts, "F_x": rng.normal(size=n).astype(np.float32),
            "J_x": rng.normal(size=int(counts.sum())).astype(np.float32)}
    return cols, {"J_x": "nJ"}


def _lookup_grid(n, basket_events):
    """Event positions around every basket edge, both ends of the file and
    past them; every (start, stop) pair of them, empty and reversed too."""
    points = {-5, -1, 0, 1, n - 1, n, n + 1, n + 10, n + basket_events}
    for edge in range(0, n + basket_events, basket_events):
        points.update((edge - 1, edge, edge + 1))
    return [(a, b) for a in sorted(points) for b in sorted(points)]


def _scanned_ids(store, name, start, stop):
    # the lookup as a walk over every basket: what the index must return
    return [i for i, m in enumerate(store._baskets[name])
            if m.first_entry < stop and m.first_entry + m.n_entries > start]


def _with_empty_baskets(metas):
    # a zero-entry basket before the first, between every two and after the last
    out = []
    for m in metas:
        out += [dataclasses.replace(m, n_entries=0, n_values=0), m]
    end = metas[-1].first_entry + metas[-1].n_entries
    return out + [dataclasses.replace(metas[-1], first_entry=end, n_entries=0, n_values=0)]


@pytest.mark.parametrize("store_shape", [
    "built", "loaded", "meta-replaced", "list-reassigned", "empty-baskets"])
@pytest.mark.parametrize("basket_events", sorted(LOOKUP_SHAPES))
def test_basket_lookup_matches_the_scan(tmp_path, basket_events, store_shape):
    n = LOOKUP_SHAPES[basket_events]
    cols, jagged = _lookup_columns(n)
    ts = TStore.from_arrays(cols, jagged=jagged, basket_events=basket_events, device="cpu")
    grid = _lookup_grid(n, basket_events)
    names = ts.branch_names()
    for name in names:  # index every branch before the store changes
        ts.basket_ids_for_range(name, 0, n)
    if store_shape == "loaded":
        ts.save(str(tmp_path / "lookup.skim"))
        ts = TStore.load(str(tmp_path / "lookup.skim"), device="cpu")
    elif store_shape == "meta-replaced":
        for name in names:  # same placement, no digest: a legacy row
            ts._baskets[name][-1] = BasketMeta(*ts._baskets[name][-1].stats_row()[:8])
    elif store_shape == "list-reassigned":
        other = TStore.from_arrays(cols, jagged=jagged, basket_events=basket_events + 3,
                                   device="cpu")
        for name in names:
            ts._baskets[name] = other._baskets[name]
    elif store_shape == "empty-baskets":
        for name in names:
            ts._baskets[name] = _with_empty_baskets(ts._baskets[name])
    for name in names:
        for start, stop in grid:
            assert ts.basket_ids_for_range(name, start, stop) == _scanned_ids(
                ts, name, start, stop), (name, start, stop)
        firsts = ts.first_event_index(name)
        assert firsts.tolist() == [m.first_entry for m in ts._baskets[name]]
        firsts[:] = -1  # a fresh array: the index does not see the write
        assert ts.first_event_index(name).tolist() == [
            m.first_entry for m in ts._baskets[name]]
    if store_shape == "meta-replaced":
        assert all(ts.basket_meta(name, ts.n_baskets(name) - 1).digest is None
                   for name in names)


@pytest.mark.parametrize("disorder", ["reversed", "nested"])
@pytest.mark.parametrize("basket_events", sorted(LOOKUP_SHAPES))
def test_load_refuses_baskets_out_of_event_order(tmp_path, basket_events, disorder):
    # the lookup bisects over the placements, so a file must keep them ascending
    n = LOOKUP_SHAPES[basket_events]
    cols, jagged = _lookup_columns(n)
    ts = TStore.from_arrays(cols, jagged=jagged, basket_events=basket_events, device="cpu")
    if disorder == "reversed":  # firsts and ends descend
        ts._baskets["F_x"] = ts._baskets["F_x"][::-1]
        ts._blobs["F_x"] = ts._blobs["F_x"][::-1]
    else:  # firsts ascend, but the first basket ends past the second
        first = ts._baskets["F_x"][0]
        ts._baskets["F_x"][0] = dataclasses.replace(first, n_entries=first.n_entries + n)
    path = str(tmp_path / "disordered.skim")
    ts.save(path)
    with pytest.raises(ValueError, match="F_x"):
        TStore.load(path, device="cpu")


@pytest.mark.parametrize("basket_events", sorted(LOOKUP_SHAPES))
def test_basket_lookup_matches_jax(basket_events):
    n = LOOKUP_SHAPES[basket_events]
    cols, jagged = _lookup_columns(n)
    js = JStore.from_arrays(cols, jagged=jagged, basket_events=basket_events)
    ts = TStore.from_arrays(cols, jagged=jagged, basket_events=basket_events, device="cpu")
    for name in ts.branch_names():
        for start, stop in _lookup_grid(n, basket_events):
            assert ts.basket_ids_for_range(name, start, stop) == js.basket_ids_for_range(
                name, start, stop), (name, start, stop)
