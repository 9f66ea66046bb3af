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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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
