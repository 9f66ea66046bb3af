"""Host side of the kernel tier: staging, dispatch and accounting.

The engine's device path calls these entry points; each stages its
inputs, dispatches to a kernel wrapper (the CUDA kernel for a CUDA
tensor, the plain PyTorch version for a CPU tensor) and notes the
dispatch in the same ledger as the JAX package's ``kernels/ops.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import basket_decode as _bd
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import skim_fused as _sf
from repro_torch.kernels.program import Program, compile_query  # re-export

# ---------------------------------------------------------------------------
# dispatch / compile accounting
#
# Every device entry point below notes one "dispatch" per real call and
# one "compile" per unique (entry, program, shape) signature — the same
# currency as the JAX package's ledger, so a run reports the same
# ``device_dispatches`` in both.  The kernels' own launch counters
# (``launch_counts``) are separate: they count launches of hand-written
# kernels only, and show that a run went through them.
# ---------------------------------------------------------------------------

_DISPATCH_STATS = {"dispatches": 0, "compiles": 0, "warmups": 0}
_SEEN_SIGNATURES: set = set()


def reset_dispatch_stats() -> None:
    _DISPATCH_STATS.update(dispatches=0, compiles=0, warmups=0)
    _SEEN_SIGNATURES.clear()


def dispatch_stats() -> dict:
    return dict(_DISPATCH_STATS)


def _note_dispatch(sig, warm: bool = False) -> None:
    if sig not in _SEEN_SIGNATURES:
        _SEEN_SIGNATURES.add(sig)
        _DISPATCH_STATS["compiles"] += 1
    if warm:
        _DISPATCH_STATS["warmups"] += 1
    else:
        _DISPATCH_STATS["dispatches"] += 1


def launch_counts() -> dict:
    """Launches of each hand-written kernel since the last reset."""
    return {"skim_fused": _sf.launches, "basket_decode": _bd.launches}


def reset_launch_counts() -> None:
    _sf.launches = 0
    _bd.launches = 0


def load_kernels() -> None:
    """Build (on first use) and load every kernel library."""
    from repro_torch.kernels import _build

    for name in _build.SOURCES:
        _build.load(name)


# ---------------------------------------------------------------------------
# bit-packed survivor masks (host <-> device interchange format)
# ---------------------------------------------------------------------------


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """Bool mask -> little-endian uint32 words over the last axis
    (bit ``j`` of word ``w`` is event ``w*32 + j``); pads to 32."""
    m = np.asarray(mask, dtype=np.uint8)
    pad = (-m.shape[-1]) % 32
    if pad:
        widths = [(0, 0)] * (m.ndim - 1) + [(0, pad)]
        m = np.pad(m, widths)
    packed = np.packbits(m, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4")


def unpack_mask(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_mask`: uint32 words -> (..., n) bool."""
    b = np.ascontiguousarray(words).view(np.uint8)
    bits = np.unpackbits(b, axis=-1, bitorder="little")
    return bits[..., :n].astype(bool)


# ---------------------------------------------------------------------------
# basket decode
# ---------------------------------------------------------------------------


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype -> the torch dtype of the same kind and width."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def stage_planes(parts_list) -> tuple[np.ndarray, np.ndarray, int]:
    """Plane words of same-kind ``bitpack_raw_parts`` dicts, padded to the
    batch maximum: (planes (N, B, W) uint32, firsts (N,) uint32, B)."""
    bits_max = max(p["bits"] for p in parts_list)
    w_max = max(p["n_pad"] // 32 for p in parts_list)
    planes = np.zeros((len(parts_list), bits_max, w_max), dtype=np.uint32)
    firsts = np.zeros((len(parts_list),), dtype=np.uint32)
    for i, p in enumerate(parts_list):
        pw = p["planes"].reshape(max(p["bits"], 1), -1)
        planes[i, : pw.shape[0], : pw.shape[1]] = pw
        firsts[i] = p["first"]
    return planes, firsts, bits_max


def basket_decode_batch(parts_list, out_dtype, device="cpu"):
    """Decode a batch of ``bitpack_raw_parts`` dicts of the same kind.

    Pads plane counts and words to the batch maximum
    (:func:`stage_planes`), decodes the batch in one call on ``device`` —
    the CUDA kernel on the card, its plain version on the CPU — and
    returns a list of correctly sized numpy arrays, bit-identical to the
    host codec (``repro_torch.data.codecs.bitpack_decode``).
    """
    kind = parts_list[0]["kind"]
    assert all(p["kind"] == kind for p in parts_list)
    if kind == 3:  # KIND_RAW_F32: literals — passthrough, nothing to decode
        return [p["raw"].astype(np.dtype(out_dtype)) for p in parts_list]
    planes, firsts, bits_max = stage_planes(parts_list)

    device = torch.device(device)
    _note_dispatch(("decode", kind, planes.shape, device.type))
    out = _bd.basket_decode(
        torch.from_numpy(planes.view(np.int32)).to(device),
        torch.from_numpy(firsts.view(np.int32)).to(device),
        kind=kind,
        n_bits=bits_max,
        out_dtype=torch_dtype(out_dtype),
    )
    out = out.cpu().numpy()
    return [out[i, : p["n"]] for i, p in enumerate(parts_list)]


# ---------------------------------------------------------------------------
# the fused skim
# ---------------------------------------------------------------------------


def skim_fused(terms, valid, weights, payload, program: Program):
    """One-pass predicate + compaction through the kernel wrapper.
    Returns (packed (E, D) with survivors front-packed globally, count)."""
    return _sf.skim_fused(terms, valid, weights, payload, program)


def fused_skim(terms, valid, weights, payload, program: Program, use_kernel=True):
    """Backend-dispatched one-pass skim (the engine's device path).

    ``use_kernel`` routes to :func:`skim_fused` — the CUDA kernel for
    tensors on the card — otherwise to the plain PyTorch version over the
    same padded layout on the tensors' own device.  Returns (packed (E, D)
    survivors-first, count).
    """
    _note_dispatch(("fused", program, tuple(terms.shape), bool(use_kernel)))
    if use_kernel:
        return skim_fused(terms, valid, weights, payload, program)
    return _ref.skim_fused_ref(terms, valid, weights, payload, program)


__all__ = [
    "Program",
    "basket_decode_batch",
    "compile_query",
    "dispatch_stats",
    "fused_skim",
    "launch_counts",
    "load_kernels",
    "pack_mask",
    "reset_dispatch_stats",
    "reset_launch_counts",
    "skim_fused",
    "stage_planes",
    "unpack_mask",
]
