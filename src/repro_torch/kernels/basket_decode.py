"""The bitpack basket-decode kernel (``csrc/basket_decode.cu``).

Decodes the baskets of one fetch round of the ``bitpack`` codec
(``repro_torch.data.codecs``) in one launch, whatever their kinds,
widths and output types: per basket, ``n_bits`` bit-planes of ``W``
uint32 words give ``W*32`` codes, then the inverse transform of the codec
kind —

  kind 0 (int)   : zigzag^-1 then a wrap-exact inclusive prefix *sum*,
  kind 1 (float) : inclusive prefix *xor* then a bitcast to float32,
  kind 2 (bool)  : identity.

A round is flat: one descriptor row of :data:`DESC_FIELDS` int32 per
basket (:func:`descriptor`), the firsts, the plane words of every basket,
and one byte buffer that receives each basket's values at its own offset
and width.  ``kernels/ops.py`` stages a fetch round into that layout;
:func:`basket_decode` lays a same-shaped ``(N, B, W)`` batch on it.

uint32 words travel as int32 tensors holding the same bits (PyTorch has
few uint32 ops).  The kernel stores each value at ``out_dtype``'s own
width (see :func:`store_width`); only a dtype wider than 32 bits, or a
float kind decoded to another float type, is converted after the launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

KIND_INT, KIND_FLOAT, KIND_BOOL = 0, 1, 2

# descriptor row (csrc/basket_decode.cu kDesc*): plane-word offset, words
# per plane W, words between planes, n_bits, kind, output byte offset,
# store flags (out_bytes | STORE_BOOL | STORE_PADDED), values n
DESC_FIELDS = 8
STORE_BOOL = 1 << 8  # a 1-byte output holding value != 0
STORE_PADDED = 1 << 9  # the plane block is padded to 16 bytes (bulk copy)
_P = ctypes.c_void_p
_ARGTYPES = (_P, _P, _P, _P, ctypes.c_int, _P)


def store_width(kind: int, out_dtype) -> tuple[int, bool] | None:
    """How the kernel stores a decoded value of ``out_dtype``: (bytes,
    as_bool), or None where the value needs a conversion after a 32-bit
    store.  Each stored form equals the plain version's ``.to(out_dtype)``
    of the 32-bit result: a bool is ``value != 0``, a narrower integer the
    low bytes."""
    if kind == KIND_FLOAT:
        return (4, False) if out_dtype == torch.float32 else None
    if out_dtype == torch.bool:
        return 1, True
    if out_dtype.is_floating_point or out_dtype.itemsize > 4:
        return None
    return out_dtype.itemsize, False


def stored_dtype(kind: int, out_dtype) -> torch.dtype:
    """The dtype the kernel writes for ``out_dtype``: itself where
    :func:`store_width` stores it directly, else the 32-bit result (float32
    bits for a float kind, int32 otherwise)."""
    if store_width(kind, out_dtype) is not None:
        return out_dtype
    return torch.float32 if kind == KIND_FLOAT else torch.int32


def descriptor(plane_off, W, stride, n_bits, kind, out_off, out_dtype, n,
               padded=False) -> list[int]:
    """One basket's descriptor row."""
    width = store_width(kind, out_dtype)
    nbytes, as_bool = width or (4, False)
    store = nbytes | (STORE_BOOL if as_bool else 0) | (STORE_PADDED if padded else 0)
    return [plane_off, W, stride, n_bits, kind, out_off, store, n]


def _check_round(descs, firsts, planes, out) -> None:
    """Raise on tensors the kernel does not take (their contents, built by
    the caller, are not read here: that would cost a device sync)."""
    device = descs.device
    N = descs.shape[0] if descs.dim() == 2 else -1
    for name, x, dtype, shape in (
        ("descs", descs, torch.int32, (N, DESC_FIELDS)),
        ("firsts", firsts, torch.int32, (N,)),
        ("planes", planes, torch.int32, tuple(planes.shape[:1])),
        ("out", out, torch.uint8, tuple(out.shape[:1])),
    ):
        if x.dtype != dtype or not x.is_contiguous() or x.device != device \
                or tuple(x.shape) != shape:
            raise ValueError(
                f"basket_decode: {name} must be contiguous {dtype} of shape "
                f"{shape} on {device}"
            )


def decode_round(descs, firsts, planes, out):
    """Decode one round into ``out``.

    Args:
      descs:  (N, DESC_FIELDS) int32 — one :func:`descriptor` row a basket.
      firsts: (N,) int32 — first-value bit patterns.
      planes: (P,) int32 — the plane words the descriptors address.
      out:    (bytes,) uint8 — receives each basket's ``n`` values at its
              output offset, at its stored width.
    Returns ``out``.  Tensors on the card launch the kernel (or raise);
    CPU tensors take the plain version,
    :func:`repro_torch.kernels.ref.basket_decode_round_ref`.  The
    descriptors are the caller's (``kernels/ops.py`` builds them from
    checked kinds and widths); their tensors are checked here.
    """
    _check_round(descs, firsts, planes, out)
    if not descs.is_cuda:
        out.copy_(_ref.basket_decode_round_ref(descs, firsts, planes, out.numel()))
        return out
    N = descs.shape[0]
    if N:
        p, device = _build.ptr, descs.device
        rc = _build.call_on(
            device, _build.function("basket_decode", "basket_decode_launch", _ARGTYPES),
            p(descs), p(firsts), p(planes), p(out), N, _build.stream_of(device))
        _build.check_launch("basket_decode", rc)
        _build.count_launch("basket_decode")
    return out


def basket_decode(planes, firsts, *, kind: int, n_bits: int,
                  out_dtype=torch.float32):
    """Decode ``N`` same-shaped baskets.

    Args:
      planes: (N, B, W) int32 — the uint32 plane words' bits (planes at or
              above a basket's true bit width are zero).
      firsts: (N,) int32 — first-value bit patterns.
      kind, n_bits: codec kind (0, 1 or 2) and the planes to read.
    Returns: (N, W*32) values of ``out_dtype``.

    A CUDA tensor launches the round kernel on the batch laid out as a
    round (or raises); a CPU tensor takes the plain version,
    :func:`repro_torch.kernels.ref.basket_decode_ref`.
    """
    N, B, W = planes.shape
    if kind not in (KIND_INT, KIND_FLOAT, KIND_BOOL):
        raise ValueError(f"basket_decode: kind {kind} has no decode")
    if not 0 <= n_bits <= B or B > 32:
        raise ValueError(f"basket_decode: n_bits={n_bits} for {B} planes")
    if not planes.is_cuda:
        return _ref.basket_decode_ref(planes, firsts, kind, W * 32, out_dtype)
    device = planes.device
    for name, x, shape in (("planes", planes, (N, B, W)), ("firsts", firsts, (N,))):
        if x.dtype != torch.int32 or not x.is_contiguous() or x.device != device \
                or tuple(x.shape) != shape:
            raise ValueError(
                f"basket_decode: {name} must be contiguous int32 of shape "
                f"{shape} on {device}"
            )
    store = stored_dtype(kind, out_dtype)
    V = W * 32
    row = V * store.itemsize
    descs = torch.from_numpy(np.asarray(
        [descriptor(i * B * W, W, W, n_bits, kind, i * row, out_dtype, V)
         for i in range(N)], np.int32).reshape(N, DESC_FIELDS)).to(device)
    out = torch.empty(N * row, dtype=torch.uint8, device=device)
    decode_round(descs, firsts, planes.reshape(-1), out)
    out = out.view(store).reshape(N, V)
    return out if store == out_dtype else _ref.finish_decode(out, kind, out_dtype)


__all__ = [
    "DESC_FIELDS",
    "KIND_BOOL",
    "KIND_FLOAT",
    "KIND_INT",
    "STORE_BOOL",
    "STORE_PADDED",
    "basket_decode",
    "decode_round",
    "descriptor",
    "store_width",
    "stored_dtype",
]
