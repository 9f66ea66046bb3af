"""The stream-compaction kernel (``csrc/stream_compact.cu``).

Packs the rows of a payload where a mask is set to the front, in order,
zeroes the rest and counts them, in one single-pass launch (decoupled
look-back, ``csrc/compact.cuh``).  The rows move as raw bits of their
element width, so every dtype of 1, 2, 4 or 8 bytes comes through exact
(the JAX package's Pallas kernel routes them through a float32 matmul;
ROADMAP C records where the two differ).  The look-back's status words
and ticket come from the workspace ``skim_fused`` uses on the same
stream (:class:`repro_torch.kernels.skim_fused.Workspace`).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, :func:`repro_torch.kernels.ref.stream_compact_ref`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.skim_fused import Workspace

EVENT_TILE = 2048  # events per block (csrc/stream_compact.cu kTile)
MASK_DTYPES = (torch.bool, torch.int32)

launches = 0  # kernel launches through stream_compact(); never reset here
KERNELS_PER_CALL = 1  # single pass: one kernel a call
_LAUNCHES_LOCK = threading.Lock()


def _fn():
    fn = _build.load("stream_compact").stream_compact_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, ctypes.c_longlong, i, i, p, p, ctypes.c_uint, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def stream_compact(payload: torch.Tensor, mask: torch.Tensor):
    """(E, D) payload of any dtype of 1, 2, 4 or 8 bytes, (E,) bool or
    int32 mask -> (packed (E, D) with the rows where ``mask != 0`` first,
    in order, then zeros; count () int32).  Any E and D."""
    global launches
    if mask.dtype not in MASK_DTYPES:
        raise ValueError(f"stream_compact: mask must be bool or int32, not {mask.dtype}")
    if payload.dim() != 2 or mask.dim() != 1 or mask.shape[0] != payload.shape[0]:
        raise ValueError(
            f"stream_compact: payload {tuple(payload.shape)} and mask "
            f"{tuple(mask.shape)} are not (E, D) and (E,)"
        )
    if not payload.is_cuda:
        return _ref.stream_compact_ref(payload, mask)
    device = payload.device
    if mask.device != device:
        raise ValueError(f"stream_compact: mask on {mask.device}, payload on {device}")
    if not (payload.is_contiguous() and mask.is_contiguous()):
        raise ValueError("stream_compact: payload and mask must be contiguous")
    width = payload.element_size()
    if width not in (1, 2, 4, 8):
        raise ValueError(f"stream_compact: {payload.dtype} has {width}-byte elements")
    E, D = payload.shape
    out = torch.empty_like(payload)
    if E == 0:
        return out, torch.zeros((), dtype=torch.int32, device=device)
    total = torch.empty((), dtype=torch.int32, device=device)
    stream = _build.stream_id(device)
    status, ticket, epoch = Workspace.reserve(device, stream, -(-E // EVENT_TILE), 1)
    p = _build.ptr
    rc = _build.call_on(device, _fn(), p(payload), p(mask), mask.element_size(), E, D,
                        width, p(status), p(ticket), epoch, p(out), p(total),
                        ctypes.c_void_p(stream))
    _build.check_launch("stream_compact", rc)
    with _LAUNCHES_LOCK:
        launches += KERNELS_PER_CALL
    return out, total


__all__ = ["EVENT_TILE", "KERNELS_PER_CALL", "MASK_DTYPES", "stream_compact"]
