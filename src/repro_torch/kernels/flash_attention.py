"""The attention kernel (``csrc/flash_attention.cu``).

Causal or full online-softmax attention over (B, H, S, D) tensors of
float32 or bfloat16, accumulated in float32, with the arithmetic of the
JAX package's Pallas ``_attn_kernel``: q scaled before the product,
-1e30 as the running max's start, the denominator floored at 1e-30, the
output in q's dtype.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, :func:`repro_torch.kernels.ref.flash_attention_ref`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128  # each lane holds at most 4 output columns
MAX_HEADS = 65535  # B*H: the grid's y dimension

launches = 0  # kernel launches through flash_attention(); never reset here
_LAUNCHES_LOCK = threading.Lock()


def _fn():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """(B, H, S, D) attention, any S, D <= 128."""
    global launches
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
        raise ValueError(f"flash_attention: {q.dtype} is not float32 or bfloat16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM}")
    if B * H > MAX_HEADS:
        raise ValueError(f"flash_attention: {B * H} heads exceed the grid's {MAX_HEADS}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    p = _build.ptr
    with torch.cuda.device(q.device):
        rc = _fn()(
            p(q), p(k), p(v), p(out), B * H, S, D,
            _ref.attention_scale(D, sm_scale), int(bool(causal)),
            int(q.dtype == torch.bfloat16),
            _build.stream_of(q.device),
        )
    _build.check_launch("flash_attention", rc)
    with _LAUNCHES_LOCK:
        launches += 1
    return out


__all__ = ["DTYPES", "MAX_HEAD_DIM", "flash_attention"]
