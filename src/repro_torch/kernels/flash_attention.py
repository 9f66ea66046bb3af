"""The attention kernel (``csrc/flash_attention.cu``).

Causal or full online-softmax attention over (B, H, S, D) tensors of
float32, bfloat16 or float16, any S and D, accumulated in float32,
computing what the JAX package's Pallas ``_attn_kernel`` computes:
``sm_scale`` or 1/sqrt(D) on the logits, -1e30 as the running max's
start, the denominator floored at 1e-30, the output in q's dtype.  bf16
and float16 run on wgmma fed by TMA, float32 on mma.sync in split TF32
(the source's note says where each rounds).  Above D = 128 a CTA owns all
the columns of a 256-column slice of the output and forms Q K^T once a key
tile: for bf16 and float16 one wgmma tile of 128 rows, for float32 sixteen
warps, four to 16 rows, each summing the score tile over a quarter of D.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, :func:`repro_torch.kernels.ref.flash_attention_ref`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# the types the kernel takes, by the code its launch function reads
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIM_STEP = 16  # the kernel takes D in multiples of 16 (one 16-bit wgmma step)
MAX_HEADS = 2**31 - 1  # B*H: the grid's x dimension
MAX_Q_TILES = 65535  # the grid's y dimension, in tiles of 64 (float32) or 128 rows;
# its z dimension, in slices of WIDE_COLS columns of D
WIDE_COLS = 256  # the columns of O a CTA of the wide kernels (D > 128) owns
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _P)


def stage(q, k, v, sm_scale: float | None = None):
    """What the kernel is given: q, k and v with D zero-padded to a
    multiple of :data:`HEAD_DIM_STEP` (zero columns add nothing to q.k and
    their output columns are dropped), each 16-byte aligned, and the scale
    of the original D.  The kernel takes only a scale > 0: a negative one
    is folded into q as -q (exact), a zero one as q * 0 with scale 1 (the
    reference's own q * 0).  Returns (q, k, v, scale)."""
    scale = _ref.attention_scale(q.shape[-1], sm_scale)
    if scale < 0:
        q, scale = -q, -scale
    elif scale == 0:
        q, scale = q * 0, 1.0
    pad = -q.shape[-1] % HEAD_DIM_STEP
    staged = []
    for x in (q, k, v):
        if pad:
            x = F.pad(x, (0, pad))
        if x.data_ptr() % 16:
            x = x.clone()
        staged.append(x)
    return (*staged, scale)


def flash_attention(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """(B, H, S, D) attention, any S and D."""
    if not q.is_cuda:
        return _ref.flash_attention_ref(q, k, v, causal, sm_scale)
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, H, S, D), got {tuple(q.shape)}")
    B, H, S, D = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"flash_attention: {name} is {x.dtype} {tuple(x.shape)} on "
                f"{x.device}, q is {q.dtype} {tuple(q.shape)} on {q.device}"
            )
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: {q.dtype} is not float32, bfloat16 or float16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if B * H > MAX_HEADS or -(-S // 64) > MAX_Q_TILES or -(-D // WIDE_COLS) > MAX_Q_TILES:
        raise ValueError(f"flash_attention: {B * H} heads of {S} rows exceed the grid")
    if q.numel() == 0:
        return torch.empty_like(q)
    qs, ks, vs, scale = stage(q, k, v, sm_scale)
    out = torch.empty_like(qs)
    p = _build.ptr
    rc = _build.call_on(
        q.device, _build.function("flash_attention", "flash_attention_launch", _ARGTYPES),
        p(qs), p(ks), p(vs), p(out), B * H, S, qs.shape[-1], scale, int(bool(causal)),
        DTYPES[q.dtype], _build.stream_of(q.device))
    _build.check_launch("flash_attention", rc)
    _build.count_launch("flash_attention")
    return out if out.shape[-1] == D else out[..., :D].contiguous()


__all__ = ["DTYPES", "HEAD_DIM_STEP", "flash_attention", "stage"]
