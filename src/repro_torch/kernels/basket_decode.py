"""The bitpack basket-decode kernel (``csrc/basket_decode.cu``).

Decodes ``N`` baskets of the ``bitpack`` codec (``repro_torch.data.codecs``)
in one launch: per basket, ``B`` bit-planes of ``W`` uint32 words give
``W*32`` codes, then the inverse transform of the codec kind —

  kind 0 (int)   : zigzag^-1 then a wrap-exact inclusive prefix *sum*,
  kind 1 (float) : inclusive prefix *xor* then a bitcast to float32,
  kind 2 (bool)  : identity.

uint32 words travel as int32 tensors holding the same bits (PyTorch has
few uint32 ops).  The kernel stores each value at ``out_dtype``'s own
width (see :func:`store_width`); only a dtype wider than 32 bits, or a
float kind decoded to another float type, is converted after the launch.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

KIND_INT, KIND_FLOAT, KIND_BOOL = 0, 1, 2

launches = 0  # kernel launches through basket_decode(); never reset here
_LAUNCHES_LOCK = threading.Lock()  # pipelined skims call from several threads


def _lib():
    lib = _build.load("basket_decode")
    fn = lib.basket_decode_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


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


def basket_decode(planes, firsts, *, kind: int, n_bits: int,
                  out_dtype=torch.float32):
    """Decode ``N`` same-shaped baskets.

    Args:
      planes: (N, B, W) int32 — the uint32 plane words' bits (planes at or
              above a basket's true bit width are zero).
      firsts: (N,) int32 — first-value bit patterns.
      kind, n_bits: codec kind (0, 1 or 2) and the planes to read.
    Returns: (N, W*32) values of ``out_dtype``.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version, :func:`repro_torch.kernels.ref.basket_decode_ref`.
    """
    global launches
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
    width = store_width(kind, out_dtype)
    nbytes, as_bool = width or (4, False)
    store_dtype = out_dtype if width else torch.int32
    out = torch.empty((N, W * 32), dtype=store_dtype, device=device)
    if N and W:
        p = _build.ptr
        with torch.cuda.device(device):
            rc = _lib().basket_decode_launch(
                p(planes), p(firsts), p(out), N, B, W, n_bits, kind,
                nbytes, int(as_bool), _build.stream_of(device),
            )
        _build.check_launch("basket_decode", rc)
        with _LAUNCHES_LOCK:
            launches += 1
    return out if width else _ref.finish_decode(out, kind, out_dtype)


__all__ = ["KIND_BOOL", "KIND_FLOAT", "KIND_INT", "basket_decode", "store_width"]
