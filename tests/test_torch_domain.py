"""The kernels' entry points over the JAX package's whole input domain.

The same seeded numpy inputs go through the JAX package's entry (on the
CPU: Pallas in interpret mode, or its XLA oracle) and the port's with
``device="cpu"``; the output's dtype, shape, count and bytes must be
equal.  What is held:

* numpy types as ``jnp.asarray`` reads them with 64-bit types off:
  float64 -> float32, int64 -> int32 (wrapping like a C cast), uint64 ->
  uint32, every other type kept; a numpy mask of ``ops.stream_compact``
  through ``jnp.asarray(mask, jnp.int32)`` (0.5 -> 0, 2.7 -> 2, int64
  2^32 -> 0);
* ``ops.fused_skim`` and ``ops.fused_skim_batch`` keep the payload's
  type, against JAX's XLA oracle at any values (NaN, -0.0, integers past
  2^24 included); ``ops.skim_fused`` takes numpy and keeps the type,
  against the Pallas kernel at values exact in float32;
* ``ops.predicate_eval`` on float64 and float16 planes;
* ``ops.flash_attention`` on numpy float64 (a float32 output), and in
  float16 and bf16 at D = 64, 136, 192 and 256, causal and not.

Left out, as ROADMAP C records: where the Pallas compaction's float32
one-hot matmul departs from its oracle (negative mask entries, payload
values not exact in float32).  Tolerances, attention only: float32
3e-5, bf16 0.05 (the JAX tests' own, ``tests/test_kernels.py``), float16
2e-3: both packages accumulate in float32 and round the output once to
float16, whose ulp is at most 2^-10 of the value, so they differ by
about one ulp (4.9e-4 at most over these cases); bf16 keeps three
fewer bits.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the sweep programs and inputs the card checks use)
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_torch_kernels import _jax_program  # noqa: E402

PAYLOADS = ("float64", "int64", "uint64", "float32", "int32", "float16", "int16", "uint8",
            "bool")
ATTN_TOL = {"float32": 3e-5, "bfloat16": 0.05, "float16": 2e-3}


def _payload(rng, kind: str, shape, exact: bool = True) -> np.ndarray:
    """A payload of numpy type ``kind``.  ``exact``: every value exact in
    float32 once JAX has read it (64-bit entries of k * 2^32 + small,
    which wrap to small 32-bit ones); otherwise NaN, inf and -0.0 mixed
    into floats and integers across their type's range."""
    n = int(np.prod(shape))
    if kind == "bool":
        x = rng.random(n) < 0.5
    elif kind in ("float64", "float32", "float16"):
        x = rng.normal(size=n).astype(kind)
        if not exact:
            x[::7] = -0.0
            x[3::11] = np.nan
            x[5::13] = np.inf
    elif kind in ("int64", "uint64"):
        signed = kind == "int64"
        high = rng.integers(-3 if signed else 0, 4, n) << 32
        x = high + rng.integers(-1000 if signed else 0, 1000, n) if exact else rng.integers(
            np.iinfo(kind).min, np.iinfo(kind).max, n, dtype=kind)
    else:
        info = np.iinfo(kind)
        lo, hi = (-1000, 1000) if exact else (info.min, info.max)
        x = rng.integers(max(lo, info.min), min(hi, info.max), n)
    return x.astype(kind).reshape(shape)


def _same(got, want, count=None, want_count=None):
    """Port output (tensor or numpy) against the JAX package's: dtype,
    shape, count and bytes."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    if count is not None:
        assert int(count) == int(want_count)
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# stream_compact
# ---------------------------------------------------------------------------


def _mask(rng, kind: str, E: int) -> np.ndarray:
    """A keep mask of numpy type ``kind``, entries >= 0 (a negative entry
    is a Pallas quirk): int64 puts 2^32 (0 as int32) and 2^32 + 1 in;
    float32 0.5 (0) and 2.7 (2)."""
    keep = rng.random(E) < 0.4
    if kind == "bool":
        return keep
    vals = rng.integers(1, 9, E)
    if kind == "int64":
        m = np.where(keep, vals, 0).astype(np.int64)
        m[::5] = 1 << 32
        m[1::7] = (1 << 32) + 1
        return m
    if kind == "float32":
        m = np.where(keep, vals + 0.7, 0.0).astype(np.float32)
        m[::5] = 0.5
        m[1::6] = 2.7
        return m
    return np.where(keep, vals, 0).astype(kind)


@pytest.mark.parametrize("payload_kind", PAYLOADS)
@pytest.mark.parametrize("mask_kind", ["bool", "int32", "uint8", "int64", "float32"])
def test_stream_compact_reads_numpy_as_jax_does(payload_kind, mask_kind):
    rng = np.random.default_rng(len(payload_kind) * 31 + len(mask_kind))
    E, D = 300, 3
    payload = _payload(rng, payload_kind, (E, D))
    mask = _mask(rng, mask_kind, E)
    got, n = tops.stream_compact(payload, mask, device="cpu")
    want, want_n = jops.stream_compact(payload, mask, interpret=True)
    _same(got, want, n, want_n)
    assert int(n) == int((mask.astype(np.int32) != 0).sum())


# ---------------------------------------------------------------------------
# the fused skim: fused_skim, fused_skim_batch (XLA oracle), skim_fused (Pallas)
# ---------------------------------------------------------------------------

PROGRAM = dict(chip_smoke.sweep_programs())["count"]


def _planes(rng, E: int, K: int, B: int | None = None, dtype=np.float64):
    """Sweep inputs for the COUNT program, the planes in ``dtype`` (float64:
    the JAX package reads them as float32)."""
    if B is None:
        t, v, w, _ = chip_smoke.sweep_inputs(rng, PROGRAM, E, K, 1)
        return t.astype(dtype), v.astype(dtype), w.astype(dtype)
    t, v, w, _ = chip_smoke.batch_sweep_inputs(rng, PROGRAM, B, E, K)
    return t.astype(dtype), v.astype(dtype), w.astype(dtype)


def _oracle_type(got: np.ndarray, want) -> np.ndarray:
    """The XLA oracle's zero tail, ``jnp.where(keep, packed, 0)``
    (``src/repro/kernels/ref.py:253``), promotes a bool payload to int32;
    the Pallas kernels keep bool, and so does the port on every route
    (ROADMAP C's notes).  The port's bool rows are held to the oracle's
    0/1 values."""
    if got.dtype == np.bool_:
        assert np.asarray(want).dtype == np.int32
        return got.astype(np.int32)
    return got


@pytest.mark.parametrize("payload_kind", PAYLOADS)
def test_fused_skim_keeps_the_payload_type(payload_kind):
    rng = np.random.default_rng(5 + len(payload_kind))
    E, K, D = 700, 4, 3
    planes = _planes(rng, E, K)
    payload = _payload(rng, payload_kind, (E, D), exact=False)
    got, n = tops.fused_skim(*planes, payload, PROGRAM, device="cpu")
    want, want_n = jops.fused_skim(*planes, payload, _jax_program(PROGRAM), use_pallas=False)
    assert isinstance(got, np.ndarray) and isinstance(n, int)
    assert got.dtype == tops.fused_skim(*planes, payload, PROGRAM, use_kernel=False,
                                        device="cpu")[0].dtype
    _same(_oracle_type(got, want), want, n, want_n)


@pytest.mark.parametrize("payload_kind", PAYLOADS)
def test_fused_skim_batch_keeps_the_payload_type(payload_kind):
    rng = np.random.default_rng(9 + len(payload_kind))
    B, E, K, D = 3, 512, 2, 2
    planes = _planes(rng, E, K, B)
    payload = _payload(rng, payload_kind, (B, E, D), exact=False)
    got, n = tops.fused_skim_batch(*planes, payload, PROGRAM, device="cpu")
    want, want_n = jops.fused_skim_batch(*planes, payload, _jax_program(PROGRAM),
                                         use_pallas=False)
    _same(_oracle_type(got.numpy(), want), want)
    _same(n, want_n)


def test_the_pallas_skims_keep_a_bool_payload():
    """Where the XLA oracle gives int32 for a bool payload, the JAX
    package's Pallas kernels give bool, as the port does."""
    rng = np.random.default_rng(23)
    planes = _planes(rng, 512, 2, 2)
    payload = _payload(rng, "bool", (2, 512, 2))
    jprog = _jax_program(PROGRAM)
    want, _ = jops.fused_skim(*(a[0] for a in planes), payload[0], jprog, use_pallas=True)
    got, _ = tops.fused_skim(*(a[0] for a in planes), payload[0], PROGRAM, device="cpu")
    _same(got, want)
    want, _ = jops.fused_skim_batch(*planes, payload, jprog, use_pallas=True)
    got, _ = tops.fused_skim_batch(*planes, payload, PROGRAM, device="cpu")
    _same(got, want)


@pytest.mark.parametrize("payload_kind", PAYLOADS)
def test_skim_fused_takes_numpy_as_jax_does(payload_kind):
    rng = np.random.default_rng(13 + len(payload_kind))
    E, K, D = 600, 4, 2
    planes = _planes(rng, E, K)
    payload = _payload(rng, payload_kind, (E, D))
    got, n = tops.skim_fused(*planes, payload, PROGRAM, device="cpu")
    want, want_n = jops.skim_fused(*planes, payload, _jax_program(PROGRAM), interpret=True)
    _same(got, want, n, want_n)


# ---------------------------------------------------------------------------
# predicate_eval
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float16])
def test_predicate_eval_reads_wide_and_narrow_planes(dtype):
    planes = _planes(np.random.default_rng(17), 900, 4, dtype=dtype)
    got = tops.predicate_eval(*planes, PROGRAM, device="cpu")
    want = jops.predicate_eval(*planes, _jax_program(PROGRAM), interpret=True)
    _same(got, want)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


def _close(got, want, dtype_name: str):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    tol = ATTN_TOL[dtype_name]
    np.testing.assert_allclose(got.astype(np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_reads_float64_as_float32(causal):
    rng = np.random.default_rng(19)
    q, k, v = (rng.normal(size=(1, 2, 128, 32)) for _ in range(3))
    got = tops.flash_attention(q, k, v, causal=causal, device="cpu")
    want = jops.flash_attention(q, k, v, causal=causal, interpret=True)
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    _close(got, want, "float32")


@pytest.mark.parametrize("D", [64, 136, 192, 256])
@pytest.mark.parametrize("dtype_name", ["float16", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_half_types_at_every_head_dim(D, dtype_name, causal):
    """numpy float16 and bf16 (``ml_dtypes``, as JAX hands them out) in,
    the same type out."""
    np_dtype = np.float16 if dtype_name == "float16" else ml_dtypes.bfloat16
    rng = np.random.default_rng(D)
    q, k, v = (rng.normal(size=(1, 2, 128, D)).astype(np.float32).astype(np_dtype)
               for _ in range(3))
    got = tops.flash_attention(q, k, v, causal=causal, device="cpu")
    want = jops.flash_attention(q, k, v, causal=causal, interpret=True)
    assert got.dtype == getattr(torch, dtype_name) and got.shape == (1, 2, 128, D)
    assert np.asarray(want).dtype == np_dtype
    _close(got, want, dtype_name)
