"""The port's ``stream_compact`` and ``fused_skim_batch`` against the JAX
package's.

On the CPU the port's kernel wrappers take their plain versions; they are
held here against the Pallas kernels run in interpret mode
(``ops.stream_compact`` and ``ops.fused_skim_batch(..., use_pallas=True)``)
on inputs made from a numpy seed.

Tolerances: none.  On the reference's tested domain (finite float32 with
no -0.0) the port equals the Pallas kernels byte for byte.  Outside it
(NaN, -0.0, integers at or above 2^24, negative int32 masks) it equals
the JAX oracle ``ref.stream_compact_ref`` byte for byte: the Pallas kernel
moves rows through a float32 one-hot matmul and keeps ``mask > 0``, which
ROADMAP C records as a quirk of the reference.  The CUDA kernels are held
against the plain versions on the card in ``tests/test_torch_cuda.py``.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the sweep programs and inputs the card checks use)
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ref import GROUP_ANY, GROUP_COUNT, GROUP_HT, OP_IDS  # noqa: E402
from repro_torch.data.codecs import (  # noqa: E402
    bitpack_encode,
    bitpack_raw_parts,
    decode_basket_batch,
)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.program import Group, Program  # noqa: E402
from test_torch_kernels import SWEEP, _assert_masks_agree, _jax_program  # noqa: E402


def _port_compact(payload, mask):
    packed, count = tops.stream_compact(payload, mask, device="cpu")
    return packed.numpy(), int(count)


def _pallas_compact(payload, mask):
    packed, count = jops.stream_compact(payload, mask, interpret=True)
    return np.asarray(packed), int(count)


def _oracle_compact(payload, mask):
    packed, count = jref.stream_compact_ref(jnp.asarray(payload), jnp.asarray(mask))
    return np.asarray(packed), int(count)


# ---------------------------------------------------------------------------
# stream_compact on the reference's tested domain: equal to Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,D", [(128, 1), (512, 7), (1000, 16), (2048, 3)])
@pytest.mark.parametrize("rate", [0.0, 0.13, 0.5, 1.0])
def test_stream_compact_sweep_matches_pallas_interpret(E, D, rate):
    """The grid of ``tests/test_kernels.py::test_stream_compact_sweep``."""
    rng = np.random.default_rng(E * 10 + D)
    payload = rng.normal(size=(E, D)).astype(np.float32)
    mask = rng.random(E) < rate
    got, n = _port_compact(payload, mask)
    want, want_n = _pallas_compact(payload, mask)
    assert n == want_n == int(mask.sum())
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_stream_compact_preserves_order():
    E = 512
    payload = np.arange(E, dtype=np.float32)[:, None]
    mask = np.zeros(E, bool)
    mask[[3, 100, 101, 400]] = True
    got, n = _port_compact(payload, mask)
    assert n == 4
    np.testing.assert_array_equal(got[:4, 0], [3.0, 100.0, 101.0, 400.0])
    assert not got[4:].any()
    assert got.tobytes() == _pallas_compact(payload, mask)[0].tobytes()


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("seed,rate", [(1, 0.05), (4, 0.5), (6, 0.95)])
def test_stream_compact_count_property(d, seed, rate):
    """The cases of ``tests/test_kernels.py::test_compact_count_property``
    (its hypothesis ranges, fixed): the survivors are the masked rows."""
    rng = np.random.default_rng(seed)
    E = 256
    payload = rng.normal(size=(E, d)).astype(np.float32)
    mask = rng.random(E) < rate
    got, n = _port_compact(payload, mask)
    want, want_n = _pallas_compact(payload, mask)
    assert n == want_n == int(mask.sum())
    assert got[:n].tobytes() == payload[mask].tobytes()
    assert got.tobytes() == want.tobytes()


def test_stream_compact_takes_any_e_without_padding():
    """The JAX entry point pads E to its tile and slices back; the port's
    kernel masks its own ragged edge.  Both give the same rows."""
    rng = np.random.default_rng(5)
    for E in (1, 31, 129, 777):
        payload = rng.normal(size=(E, 2)).astype(np.float32)
        mask = rng.random(E) < 0.4
        got, n = _port_compact(payload, mask)
        want, want_n = _pallas_compact(payload, mask)
        assert got.shape == (E, 2) and n == want_n
        assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# stream_compact outside it: equal to the oracle, byte for byte
# ---------------------------------------------------------------------------


def test_stream_compact_keeps_nan_and_negative_zero_where_pallas_does_not():
    """The reproduction in ROADMAP C: the Pallas kernel's one-hot matmul
    spreads the NaN over its tile and turns -0.0 into +0.0; the port, like
    the oracle, moves the bits."""
    payload = np.arange(10, dtype=np.float32)[:, None]
    payload[5, 0] = np.nan
    payload[7, 0] = -0.0
    mask = np.zeros(10, bool)
    mask[[1, 5, 7, 9]] = True
    got, n = _port_compact(payload, mask)
    want, want_n = _oracle_compact(payload, mask)
    assert n == want_n == 4
    assert got.tobytes() == want.tobytes()
    assert np.signbit(got[2, 0]) and np.isnan(got[1, 0]) and got[3, 0] == 9.0
    pallas, _ = _pallas_compact(payload, mask)
    assert np.isnan(pallas[:, 0]).all()  # the quirk the port does not copy


@pytest.mark.parametrize("rate", [0.13, 0.5, 1.0])
def test_stream_compact_moves_float_bits_exactly(rate):
    """NaNs with payload bits, -0.0 and denormals, against the oracle."""
    rng = np.random.default_rng(int(rate * 100))
    E, D = 1000, 3
    bits = rng.integers(0, 1 << 32, (E, D), dtype=np.uint64).astype(np.uint32)
    bits[:, 1] = np.uint32(0x7FC00000) | (bits[:, 1] & np.uint32(0xFFFF))
    bits[::7, 2] = np.uint32(0x80000000)
    bits[::11, 0] = np.uint32(0x00000003)
    payload = bits.view(np.float32)
    mask = rng.random(E) < rate
    got, n = _port_compact(payload, mask)
    want, want_n = _oracle_compact(payload, mask)
    assert n == want_n
    assert got.tobytes() == want.tobytes()
    assert got[:n].tobytes() == payload[mask].tobytes()


def test_stream_compact_keeps_int32_at_and_above_2_24():
    rng = np.random.default_rng(9)
    E = 700
    payload = rng.integers((1 << 24) - 2, (1 << 31) - 1, (E, 4)).astype(np.int32)
    payload[::3] *= -1
    mask = rng.random(E) < 0.5
    got, n = _port_compact(payload, mask)
    want, want_n = _oracle_compact(payload, mask)
    assert n == want_n and got.dtype == np.int32
    assert got.tobytes() == want.tobytes()
    pallas, _ = _pallas_compact(payload, mask)
    assert pallas.tobytes() != want.tobytes()  # float32 rounding past 2^24


def test_stream_compact_keeps_rows_where_an_int_mask_is_nonzero():
    """The oracle keeps ``mask != 0`` (so does the port); the Pallas kernel
    keeps ``mask > 0``."""
    rng = np.random.default_rng(2)
    E = 512
    payload = rng.normal(size=(E, 2)).astype(np.float32)
    mask = rng.choice(np.array([0, 1, -1, 5, -7], np.int32), E)
    got, n = _port_compact(payload, mask)
    want, want_n = _oracle_compact(payload, mask)
    assert n == want_n == int((mask != 0).sum())
    assert got.tobytes() == want.tobytes()
    assert _pallas_compact(payload, mask)[1] == int((mask > 0).sum())


@pytest.mark.parametrize("dtype", ["bfloat16", "int64", "bool", "int8", "float64"])
def test_stream_compact_moves_every_element_width(dtype):
    """1-, 2- and 8-byte elements move as raw bits, held against numpy's
    boolean indexing of the same bits (JAX holds no 64-bit types here).
    bf16 is also held against the oracle: equal bits, except that XLA on
    the CPU rewrites a bf16 NaN's bits (0xFFFF, PyTorch's, comes back as
    0x7FC0), so NaNs are compared by position."""
    rng = np.random.default_rng(4)
    E, D = 600, 3
    mask = rng.random(E) < 0.4
    if dtype == "bfloat16":
        x = rng.normal(size=(E, D)).astype(np.float32)
        x[::5, 0] = np.nan
        x[::9, 1] = -0.0
        payload = torch.from_numpy(x).to(torch.bfloat16)
        bits = payload.view(torch.int16).numpy()
    else:
        if dtype == "bool":
            bits = rng.random((E, D)) < 0.5
        elif dtype == "float64":
            bits = rng.normal(size=(E, D))
        else:
            bits = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, (E, D),
                                dtype=dtype)
        payload = torch.from_numpy(bits)
    want = np.zeros_like(bits)
    want[: int(mask.sum())] = bits[mask]
    packed, n = tops.stream_compact(payload, torch.from_numpy(mask), device="cpu")
    assert packed.dtype == payload.dtype and int(n) == int(mask.sum())
    got = packed.view(torch.int16).numpy() if dtype == "bfloat16" else packed.numpy()
    assert got.tobytes() == want.tobytes()
    if dtype == "bfloat16":
        oracle, oracle_n = _oracle_compact(bits.view(jnp.bfloat16), mask)
        nan = np.isnan(got.view(jnp.bfloat16).astype(np.float32))
        assert oracle_n == int(n)
        assert (np.isnan(oracle.astype(np.float32)) == nan).all()
        assert (oracle.view(np.int16)[~nan] == got[~nan]).all()


# ---------------------------------------------------------------------------
# fused_skim_batch
# ---------------------------------------------------------------------------


def _skim_program():
    """The program of ``tests/test_skim_fused.py``."""
    return Program(
        groups=(
            Group(GROUP_COUNT, (0, 1), (OP_IDS[">"], OP_IDS["abs<"]), (20.0, 25.0)),
            Group(GROUP_HT, (2,), (OP_IDS[">"],), (10.0,),
                  cmp_op=OP_IDS[">"], cmp_thr=100.0),
            Group(GROUP_ANY, (3,), (OP_IDS[">="],), (0.5,)),
        ),
        term_branches=("a", "b", "c", "d"),
        group_collections=("X", None, None),
        group_weights=(None, "w", None),
    )


def _skim_batch(rng, B, E, K, D):
    terms = rng.normal(20, 15, (B, 4, E, K)).astype(np.float32)
    valid = (rng.random((B, 3, E, K)) < 0.4).astype(np.float32)
    weights = np.abs(rng.normal(30, 20, (B, 3, E, K))).astype(np.float32)
    payload = rng.normal(size=(B, E, D)).astype(np.float32)
    return terms, valid, weights, payload


def _any_read_as_bool(host):
    """``_skim_batch``'s inputs with the ANY term's plane (term 3, which no
    other group reads) as 0/1: the port reads an ANY term as nonzero, as
    the staged evaluator reads it as bool, and the JAX kernel's compiled
    ``>= 0.5`` reads the 0/1 plane the same way."""
    terms, *rest = host
    terms = terms.copy()
    terms[:, 3] = terms[:, 3] != 0
    return terms, *rest


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("E,K,D", [(256, 4, 3), (1024, 8, 6), (2048, 1, 1)])
def test_fused_skim_batch_matches_pallas_interpret(B, E, K, D):
    """The grid of ``tests/test_skim_fused.py::test_fused_matches_two_pass``
    (E = 1000 padded to 1024: the batched Pallas kernel asserts whole
    tiles) through the batched Pallas kernel and the port."""
    prog = _skim_program()
    host = _skim_batch(np.random.default_rng(E + B), B, E, K, D)
    want, want_n = jops.fused_skim_batch(*_any_read_as_bool(host), _jax_program(prog),
                                         use_pallas=True)
    got, n = tops.fused_skim_batch(*host, prog, device="cpu")
    assert n.dtype == torch.int32
    np.testing.assert_array_equal(n.numpy(), np.asarray(want_n))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("name", sorted(SWEEP))
def test_fused_skim_batch_group_kinds_match_pallas_interpret(name):
    """Every group kind and op of the sweep programs, B = 3 windows; the
    mass/ΔR groups may differ only at a cut's edge (see
    ``tests/test_torch_kernels.py``)."""
    prog = SWEEP[name]
    rng = np.random.default_rng(13)
    host = chip_smoke.batch_sweep_inputs(rng, prog, 3, 512, 4)
    want, want_n = jops.fused_skim_batch(*host, _jax_program(prog), use_pallas=True)
    got, n = tops.fused_skim_batch(*host, prog, device="cpu")
    want, want_n, got, n = np.asarray(want), np.asarray(want_n), got.numpy(), n.numpy()
    if name == "empty":
        assert not n.any()
    if name == "full":
        assert (n == 512).all()
    for b in range(3):
        if n[b] == want_n[b] and got[b].tobytes() == want[b].tobytes():
            continue
        m_got = np.zeros(512, bool)
        m_got[got[b, : n[b], 0].astype(np.int64)] = True
        m_want = np.zeros(512, bool)
        m_want[want[b, : want_n[b], 0].astype(np.int64)] = True
        _assert_masks_agree(prog, host[0][b], host[1][b], m_got, m_want)


@pytest.mark.parametrize("E", [1000, 4097])
def test_fused_skim_batch_takes_any_e_and_equals_fused_skim_per_window(E):
    """The reference's batched kernel needs whole tiles; the port takes a
    ragged E and stays per window equal to the JAX package's single-window
    fused kernel (which pads and slices back)."""
    prog = _skim_program()
    host = _skim_batch(np.random.default_rng(E), 2, E, 4, 2)
    got, n = tops.fused_skim_batch(*host, prog, device="cpu")
    for b in range(2):
        want, want_n = jops.skim_fused(*(x[b] for x in _any_read_as_bool(host)),
                                       _jax_program(prog), interpret=True)
        assert int(n[b]) == int(want_n)
        assert got[b].numpy().tobytes() == np.asarray(want).tobytes()


def test_fused_skim_batch_plain_route_and_dispatch_ledger_match_jax():
    """``use_kernel=False`` is the plain version on the tensors' device;
    both routes note one dispatch under the JAX package's signature."""
    prog = _skim_program()
    host = _skim_batch(np.random.default_rng(3), 2, 512, 4, 2)
    tensors = [torch.from_numpy(x) for x in host]
    tops.reset_dispatch_stats()
    jops.reset_dispatch_stats()
    a, na = tops.fused_skim_batch(*tensors, prog)
    b, nb = tops.fused_skim_batch(*tensors, prog, use_kernel=False)
    assert torch.equal(a, b) and torch.equal(na, nb)
    assert a.device.type == "cpu"
    for use in (True, False):
        jops.fused_skim_batch(*host, _jax_program(prog), use_pallas=use)
    assert tops.dispatch_stats() == jops.dispatch_stats()


def test_skim_fused_batch_ref_is_skim_fused_ref_per_window():
    prog = SWEEP["expr"]
    host = chip_smoke.batch_sweep_inputs(np.random.default_rng(8), prog, 4, 700, 4)
    t, v, w, p = (torch.from_numpy(x) for x in host)
    got, n = tref.skim_fused_batch_ref(t, v, w, p, prog)
    for b in range(4):
        want, want_n = tref.skim_fused_ref(t[b], v[b], w[b], p[b], prog)
        assert int(n[b]) == int(want_n) and torch.equal(got[b], want)


# ---------------------------------------------------------------------------
# the entry points' device rule
# ---------------------------------------------------------------------------


def _entry_calls():
    prog = _skim_program()
    host = _skim_batch(np.random.default_rng(1), 1, 256, 2, 1)
    q = np.random.default_rng(2).normal(size=(1, 1, 16, 8)).astype(np.float32)
    ints = np.arange(300, dtype=np.int32) * 7 - 1000
    blob = bitpack_encode(ints)
    return {
        "basket_decode_batch": lambda **kw: tops.basket_decode_batch(
            [bitpack_raw_parts(blob)], np.int32, **kw),
        "decode_basket_batch": lambda **kw: decode_basket_batch(
            [blob], "bitpack", np.int32, backend="device", **kw),
        "predicate_eval": lambda **kw: tops.predicate_eval(
            host[0][0], host[1][0], host[2][0], prog, **kw),
        "stream_compact": lambda **kw: tops.stream_compact(
            host[3][0], host[0][0, 0, :, 0] > 20, **kw),
        "fused_skim_batch": lambda **kw: tops.fused_skim_batch(*host, prog, **kw),
        "skim_fused": lambda **kw: tops.skim_fused(*(a[0] for a in host), prog, **kw),
        "flash_attention": lambda **kw: tops.flash_attention(q, q, q, **kw),
    }


@pytest.mark.parametrize("entry", ["predicate_eval", "stream_compact",
                                   "fused_skim_batch", "skim_fused", "flash_attention",
                                   "basket_decode_batch", "decode_basket_batch"])
def test_numpy_inputs_need_a_card_unless_asked_for_the_cpu(monkeypatch, entry):
    """numpy inputs go to ``device``, which defaults to the card: without
    one the entry point raises, naming ``device='cpu'``, as the engine's
    entry points do; CPU tensors keep their plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_calls()[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    out = call(device="cpu")
    first = out[0] if isinstance(out, (tuple, list)) else out
    if isinstance(first, np.ndarray):  # the decodes return host arrays
        assert first.tobytes() == (np.arange(300, dtype=np.int32) * 7 - 1000).tobytes()
    else:
        assert first.device.type == "cpu"
