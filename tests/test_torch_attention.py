"""The port's ``flash_attention`` against the JAX package's.

On the CPU the port's wrapper takes its plain version, which repeats the
Pallas ``_attn_kernel``'s arithmetic in float32 (q scaled before the
product, -1e30 masking, the denominator floored at 1e-30, the output in
q's dtype).  It is held here against ``ops.flash_attention`` (Pallas,
interpret mode) and the jnp oracle ``ref.flash_attention_ref`` on inputs
made from a numpy seed.

Tolerances: rtol = atol = 3e-5 in float32 and 0.05 in bf16, the JAX
tests' own (``tests/test_kernels.py``): the online softmax rescales tile
by tile and sums in another order than one softmax over the whole row,
and bf16 keeps 8 bits of mantissa.  The CUDA kernel is held against the
plain version on the card in ``tests/test_torch_cuda.py``.

The second half emulates, in plain torch on the CPU, the rounding of the
CUDA kernel's two routes (its key tiles, the online rescale, the scale
applied to the float32 logits, exp2 with one folded constant; P rounded
to bf16 before P V on the bf16 route, three split-TF32 products on the
float32 route, summed over four parts of D apart above D = 128) and
holds each to the reference within ``chip_smoke``'s card tolerances
``FLASH_TOL`` and to the Pallas kernel within ``TOL``.  A single TF32
product misses 3e-5: that is why the float32 route splits.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (FLASH_TOL, the card's tolerances)

TOL = {"float32": 3e-5, "bfloat16": 0.05}


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,S,D", [(1, 1, 128, 32), (2, 3, 256, 64), (1, 2, 64, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_and_oracle(B, H, S, D, causal):
    q, k, v = _inputs(S + D, (B, H, S, D))
    got = tops.flash_attention(q, k, v, causal=causal, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (B, H, S, D)
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, interpret=True)
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal)
    _close(got.numpy(), pallas, TOL["float32"])
    _close(got.numpy(), oracle, TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_matches_pallas_and_oracle(causal):
    """The case of ``tests/test_kernels.py::test_flash_attention_bf16``;
    the port gets the same bf16 bits as JAX."""
    x = [jnp.asarray(a, jnp.bfloat16) for a in _inputs(21, (1, 2, 128, 64))]
    q, k, v = (torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
               for a in x)
    got = tops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    pallas = jops.flash_attention(*x, causal=causal, interpret=True)
    oracle = jref.flash_attention_ref(*x, causal=causal)
    _close(got, pallas, TOL["bfloat16"])
    _close(got, oracle, TOL["bfloat16"])


@pytest.mark.parametrize("sm_scale", [0.05, 1.0])
def test_flash_attention_sm_scale_matches_pallas(sm_scale):
    q, k, v = _inputs(3, (1, 2, 128, 32))
    got = tops.flash_attention(q, k, v, causal=True, sm_scale=sm_scale, device="cpu")
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, sm_scale=sm_scale, interpret=True)
    _close(got.numpy(), want, TOL["float32"])


@pytest.mark.parametrize("S", [1, 100, 200])
def test_flash_attention_takes_a_ragged_s(S):
    """The Pallas kernel needs S to divide by its 128-row block; the port
    takes any S (the CUDA kernel masks its own edge).  Held against the
    oracle, which has no block."""
    q, k, v = _inputs(S, (1, 2, S, 24))
    for causal in (True, False):
        got = tops.flash_attention(q, k, v, causal=causal, device="cpu")
        want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=causal)
        _close(got.numpy(), want, TOL["float32"])


def test_flash_attention_first_row_attends_to_itself_only():
    """Causal row 0 sees key 0 alone: its output is v[0] exactly."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, (1, 1, 64, 8)))
    got = tfa.flash_attention(q, k, v, causal=True)
    assert torch.equal(got[0, 0, 0], v[0, 0, 0])


def test_flash_attention_ref_floors_the_denominator_and_keeps_the_dtype():
    q = torch.zeros((1, 1, 4, 8), dtype=torch.bfloat16)
    out = tref.flash_attention_ref(q, q, q, causal=True)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert tref.attention_scale(64) == float(np.float32(0.125))
    assert tref.attention_scale(64, 0.3) == float(np.float32(0.3))


# ---------------------------------------------------------------------------
# the CUDA kernel's rounding, emulated on the CPU
# ---------------------------------------------------------------------------

# keys per K/V tile of each route (kBc and kF32Keys in csrc/flash_attention.cu)
ROUTE_KEYS = {"bf16": 128, "f16": 128, "tf32x3": 32, "tf32": 32}
HALF = {"bf16": torch.bfloat16, "f16": torch.float16}  # the 16-bit routes' P
WIDE_KEYS = 64  # the 16-bit wide tile's keys per K/V tile (kWideKeys), D > 128
LOG2E = 1.4426950408889634


def _route_keys(route: str, D: int) -> int:
    """Keys per K/V tile of the kernel that ``route`` runs at head dim D."""
    if route in HALF and D > 128:
        return WIDE_KEYS
    return ROUTE_KEYS[route]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero: cvt.rna.tf32.f32 on finite values."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, route: str) -> torch.Tensor:
    """a @ b as the route's tensor cores form it, accumulated in float32."""
    if route in HALF:  # bf16 x bf16 and f16 x f16 products are exact in float32
        return a @ b
    big_a, big_b = _tf32(a), _tf32(b)
    if route == "tf32":
        return big_a @ big_b
    small_a, small_b = _tf32(a - big_a), _tf32(b - big_b)
    return small_a @ big_b + big_a @ small_b + big_a @ big_b


F32_PARTS = 4  # kF32Parts: the float32 wide kernel's warps that share 16 rows


def _part_cols(cols: int, part: int) -> tuple[int, int]:
    """The columns [a, b) of a chunk of ``cols`` that warp ``part`` of a
    row group sums (``part_steps`` in csrc/flash_attention.cu): the
    8-column steps split as evenly as they go, the first parts the
    larger."""
    steps = cols // 8
    per = -(-steps // F32_PARTS)
    first = min(steps, part * per)
    return 8 * first, 8 * min(steps, first + per)


def _scores(q, kt, route: str) -> torch.Tensor:
    """q kt^T as the route forms it.  float32 above D = 128 (the wide
    kernel): D padded to a multiple of 16 is cut into chunks of
    tfa.WIDE_COLS columns, each chunk into F32_PARTS parts; warp p of a row
    group sums part p of every chunk, and the group adds the four parts'
    sums in one order, (x0 + x1) + (x2 + x3).  Every other kernel forms the
    whole product at once."""
    D = q.shape[-1]
    if route in HALF or D <= 128:
        return _product(q, kt.transpose(-1, -2), route)
    padded = -(-D // tfa.HEAD_DIM_STEP) * tfa.HEAD_DIM_STEP
    parts = [0.0] * F32_PARTS
    for c0 in range(0, padded, tfa.WIDE_COLS):
        cols = min(tfa.WIDE_COLS, padded - c0)
        for p in range(F32_PARTS):
            a, b = (c0 + x for x in _part_cols(cols, p))
            parts[p] = parts[p] + _product(q[..., a:b], kt[..., a:b].transpose(-1, -2), route)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _emulate(q, k, v, causal: bool, route: str, sm_scale=None) -> torch.Tensor:
    """The kernel's arithmetic over float32 (B, H, S, D) inputs (bf16 or
    f16 values upcast for the 16-bit routes): key tiles of
    ``_route_keys(route, D)``, the scores as ``_scores`` forms them,
    running max from -1e30, p = exp2(s c - m c) with c = scale * log2(e)
    in float32 and s c - m c rounded once (one FMA), the row sums in
    float32, P rounded to the route's 16-bit type before P V on a 16-bit
    route, the sum floored at 1e-30.  Above D = 128 every 256-column slice
    of the output repeats the same scores and P, and each column of P V is
    its own sum, so the slices need no emulation of their own."""
    S = q.shape[2]
    c = torch.tensor(tref.attention_scale(q.shape[-1], sm_scale), dtype=torch.float32)
    c = c * torch.tensor(LOG2E, dtype=torch.float32)
    m = torch.full(q.shape[:3] + (1,), tref.NEG_INF, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    rows = torch.arange(S)[:, None]
    step = _route_keys(route, q.shape[-1])
    for k0 in range(0, S, step):
        kt, vt = k[:, :, k0:k0 + step], v[:, :, k0:k0 + step]
        s = _scores(q, kt, route)
        keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
        if causal:
            s = s.masked_fill(keys > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        mc = m_new * c
        p = torch.exp2((s.double() * c.double() - mc.double()).float())
        l = l * alpha + p.sum(-1, keepdim=True)
        if route in HALF:
            p = p.to(HALF[route]).float()
        acc = acc * alpha + _product(p, vt, route)
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)


def _over(got, want, rtol: float, atol: float) -> int:
    """How many values fall outside atol + rtol * |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return int((np.abs(got - want) > atol + rtol * np.abs(want)).sum())


@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (1, 2, 256, 128), (2, 1, 130, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_route_rounding_stays_within_flash_tol(shape, causal):
    """P rounded to bf16 before P V, the scale after the product, exp2: the
    result rounded to bf16 stays within the card's bf16 FLASH_TOL of the
    reference on the same bf16 inputs (ragged S included)."""
    x = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(shape[2], shape)]
    got = _emulate(*(a.float() for a in x), causal, "bf16").to(torch.bfloat16)
    want = tref.flash_attention_ref(*x, causal=causal)
    rtol, atol = chip_smoke.FLASH_TOL["bfloat16"]
    assert _over(got.float(), want.float(), rtol, atol) == 0


@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (1, 2, 256, 128), (2, 1, 130, 16),
                                   (1, 2, 200, 136), (1, 1, 256, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_f16_route_rounding_stays_within_flash_tol(shape, causal):
    """The float16 route: P rounded to f16 before P V; the result rounded to
    f16 stays within the card's float16 FLASH_TOL of the reference on the
    same f16 inputs, at the narrow and the wide (D > 128) head dims."""
    x = [torch.from_numpy(a).to(torch.float16) for a in _inputs(shape[2] + 3, shape)]
    got = _emulate(*(a.float() for a in x), causal, "f16").to(torch.float16)
    want = tref.flash_attention_ref(*x, causal=causal)
    rtol, atol = chip_smoke.FLASH_TOL["float16"]
    assert _over(got.float(), want.float(), rtol, atol) == 0


@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (1, 2, 256, 128), (2, 1, 130, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_split_tf32_route_rounding_stays_within_flash_tol(shape, causal):
    """Three TF32 products per product (small*big + big*small + big*big)
    stay within the card's float32 FLASH_TOL (3e-5) of the reference."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(shape[2] + 1, shape))
    got = _emulate(q, k, v, causal, "tf32x3")
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    rtol, atol = chip_smoke.FLASH_TOL["float32"]
    assert _over(got, want, rtol, atol) == 0


@pytest.mark.parametrize("route", ["bf16", "tf32x3"])
@pytest.mark.parametrize("causal", [True, False])
def test_route_emulations_match_pallas(route, causal):
    """Each route's emulation against the Pallas kernel in interpret mode,
    within the JAX tests' tolerances (TOL)."""
    shape = (1, 2, 256, 64)
    host = _inputs(7, shape)
    if route == "bf16":
        x = [jnp.asarray(a, jnp.bfloat16) for a in host]
        got = _emulate(*(torch.from_numpy(np.asarray(a, np.float32)) for a in x), causal, route)
        tol = TOL["bfloat16"]
    else:
        x = [jnp.asarray(a) for a in host]
        got = _emulate(*(torch.from_numpy(a) for a in host), causal, route)
        tol = TOL["float32"]
    want = jops.flash_attention(*x, causal=causal, interpret=True)
    _close(got.numpy(), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("route", ["bf16", "f16", "tf32x3"])
@pytest.mark.parametrize("D", [192, 256, 264])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_route_rounding_stays_within_flash_tol(route, D, causal):
    """The wide kernels (D > 128): the 16-bit tile's 64-key tiles, the
    float32 row group's parts of D summed apart (at D = 264 over two
    chunks of 256 columns), at a ragged S; each emulation, rounded to the
    route's type, within the card's FLASH_TOL of the reference on the same
    inputs."""
    shape = (1, 2, 130, D)
    host = [torch.from_numpy(a) for a in _inputs(D + 5, shape)]
    dtype = HALF.get(route, torch.float32)
    x = [a.to(dtype) for a in host]
    got = _emulate(*(a.float() for a in x), causal, route).to(dtype)
    want = tref.flash_attention_ref(*x, causal=causal)
    rtol, atol = chip_smoke.FLASH_TOL[str(dtype).removeprefix("torch.")]
    assert _over(got.float(), want.float(), rtol, atol) == 0


def test_wide_routes_cut_the_keys_and_the_head_dim_as_the_kernels_do():
    """The emulation's tiles and parts follow csrc/flash_attention.cu:
    64-key tiles for the 16-bit wide tile, 32 for float32 at every D; the
    parts of a chunk cover it once, and the float32 scores above D = 128
    differ from one product over all of D only by the order of the sums."""
    assert [_route_keys(r, 256) for r in ("bf16", "f16", "tf32x3")] == [64, 64, 32]
    assert [_route_keys(r, 128) for r in ("bf16", "f16", "tf32x3")] == [128, 128, 32]
    for cols in (16, 144, 240, 256):
        cuts = [_part_cols(cols, p) for p in range(F32_PARTS)]
        assert cuts[0][0] == 0 and cuts[-1][1] == cols
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    q, k = (torch.from_numpy(a) for a in _inputs(9, (1, 1, 40, 264))[:2])
    parts = _scores(q, k, "tf32x3")
    whole = _product(q, k.transpose(-1, -2), "tf32x3")
    assert not torch.equal(parts, whole)
    torch.testing.assert_close(parts, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["bf16", "tf32x3"])
def test_wide_route_emulations_match_pallas(route):
    """The wide routes' emulations at Gemma-7B's head dim (256) against the
    Pallas kernel in interpret mode, within the JAX tests' tolerances."""
    shape = (1, 1, 256, 256)
    host = _inputs(19, shape)
    if route == "bf16":
        x = [jnp.asarray(a, jnp.bfloat16) for a in host]
        got = _emulate(*(torch.from_numpy(np.asarray(a, np.float32)) for a in x), True, route)
        tol = TOL["bfloat16"]
    else:
        x = [jnp.asarray(a) for a in host]
        got = _emulate(*(torch.from_numpy(a) for a in host), True, route)
        tol = TOL["float32"]
    want = jops.flash_attention(*x, causal=True, interpret=True)
    _close(got.numpy(), np.asarray(want, np.float32), tol)


def test_split_tf32_route_with_sm_scale_matches_pallas():
    q, k, v = _inputs(11, (1, 1, 128, 32))
    got = _emulate(*(torch.from_numpy(a) for a in (q, k, v)), True, "tf32x3", sm_scale=0.3)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, sm_scale=0.3, interpret=True)
    _close(got.numpy(), want, TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_a_single_tf32_product_misses_the_float32_tolerance(causal):
    """Why the float32 route splits: one TF32 pass keeps 11 bits and puts
    values outside 3e-5 of the reference, where the split does not."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(13, (1, 2, 256, 64)))
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    rtol, atol = chip_smoke.FLASH_TOL["float32"]
    assert _over(_emulate(q, k, v, causal, "tf32"), want, rtol, atol) > 0
    assert _over(_emulate(q, k, v, causal, "tf32x3"), want, rtol, atol) == 0


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11),
                      1.0 + 3 * 2.0**-11], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0, -(1.0 + 2.0**-10), 1.0 + 2.0**-9],
                        dtype=torch.float32)
    assert torch.equal(_tf32(x), want)


@pytest.mark.parametrize("D", [40, 24, 8, 100, 136])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_head_dim_pad_equals_the_unpadded_plain_version(D, dtype):
    """The wrapper's staging for the kernel: D zero-padded to a multiple of
    16, the scale taken from the original D, the output sliced back."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(D, (1, 2, 96, D)))
    qs, ks, vs, scale = tfa.stage(q, k, v)
    assert qs.shape[-1] % tfa.HEAD_DIM_STEP == 0 and qs.shape[-1] - D < tfa.HEAD_DIM_STEP
    assert scale == tref.attention_scale(D)
    assert torch.equal(qs[..., :D], q) and not qs[..., D:].any()
    for causal in (True, False):
        got = tref.flash_attention_ref(qs, ks, vs, causal, sm_scale=scale)[..., :D]
        want = tref.flash_attention_ref(q, k, v, causal)
        if dtype == torch.float32:
            _close(got.numpy(), want.numpy(), 1e-6)
        else:  # one ulp of the type: 2^-8 (bf16), 2^-11 (f16)
            _close(got.float().numpy(), want.float().numpy(),
                   2.0**-8 if dtype == torch.bfloat16 else 2.0**-11)


@pytest.mark.parametrize("sm_scale", [-0.2, 0.0])
def test_stage_folds_a_scale_that_is_not_positive_into_q(sm_scale):
    """The kernel takes scale > 0; staging moves a sign or a zero into q,
    and the plain version on the staged inputs equals it on the originals."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(17, (1, 1, 64, 16)))
    qs, ks, vs, scale = tfa.stage(q, k, v, sm_scale)
    assert scale > 0
    got = tref.flash_attention_ref(qs, ks, vs, True, sm_scale=scale)
    want = tref.flash_attention_ref(q, k, v, True, sm_scale=sm_scale)
    _close(got.numpy(), want.numpy(), 1e-6)
