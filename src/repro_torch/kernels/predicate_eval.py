"""The batched predicate kernel and the cascade stage (``csrc/predicate_eval.cu``).

Three wrappers over one CUDA source, each with its own launch counter:

* :func:`cascade_stage` — the batched cascade's stage step: the program
  over a window-batch, ANDed into the carried bit-packed survivor mask
  in place, with each window's survivor count and each basket's alive
  bit (the epilogue of the JAX package's ``ops._cascade_stage_impl``
  fused into the kernel).
* :func:`predicate_eval_batch` — the (B, E) int32 mask alone.
* :func:`predicate_eval` — its B = 1 case, (E,) int32.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version in :mod:`repro_torch.kernels.ref`.  The program reaches the
kernel as the same descriptor arrays as ``skim_fused``'s.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.program import Program
from repro_torch.kernels.skim_fused import program_descriptor

MAX_WINDOWS = 65535  # the grid's y dimension (one window per row)

# kernel launches through each wrapper; never reset here
launches = {"cascade_stage": 0, "predicate_eval_batch": 0, "predicate_eval": 0}
_LAUNCHES_LOCK = threading.Lock()  # pipelined skims call from several threads

_PROGRAM_ARGS = 8  # descriptor pointers after (terms, valid, weights, B, T, G, E, K)


def _fn(name: str, tail: list):
    fn = getattr(_build.load("predicate_eval"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, ctypes.c_longlong, i,
                       *([p] * _PROGRAM_ARGS), *tail]
        fn.restype = ctypes.c_int
    return fn


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        launches[name] += 1


def _check_inputs(who: str, terms, valid, weights, program: Program):
    """(B, T, E, K) of a batch the kernel takes, or raises."""
    if terms.dim() != 4:
        raise ValueError(f"{who}: terms must be (B, T, E, K), got {tuple(terms.shape)}")
    B, T, E, K = terms.shape
    G = program.n_groups
    if T != program.n_terms:
        raise ValueError(f"{who}: {T} term planes for {program.n_terms} terms")
    if B > MAX_WINDOWS:
        raise ValueError(f"{who}: {B} windows exceed the grid's {MAX_WINDOWS}")
    for name, x, shape in (("terms", terms, (B, T, E, K)),
                           ("valid", valid, (B, G, E, K)),
                           ("weights", weights, (B, G, E, K))):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous float32")
        if tuple(x.shape) != shape or x.device != terms.device:
            raise ValueError(
                f"{who}: {name} has shape {tuple(x.shape)} on {x.device}, "
                f"expected {shape} on {terms.device}"
            )
    return B, T, E, K


def _program_args(program: Program, device):
    ints, floats, off = program_descriptor(program, device)

    def at(base, name):
        return ctypes.c_void_p(base.data_ptr() + 4 * off[name])

    return (at(ints, "groups"), at(ints, "term_ids"), at(ints, "ops"),
            at(floats, "thrs"), at(floats, "cmp_thrs"), at(ints, "rpn_op"),
            at(ints, "rpn_term"), at(floats, "rpn_const"))


def _mask(terms, valid, weights, program: Program) -> torch.Tensor:
    """Launch ``predicate_eval_launch``: (B, E) int32 on the card."""
    B, T, E, K = _check_inputs("predicate_eval", terms, valid, weights, program)
    device = terms.device
    out = torch.empty((B, E), dtype=torch.int32, device=device)
    if B == 0 or E == 0:
        return out
    p = _build.ptr
    with torch.cuda.device(device):
        rc = _fn("predicate_eval_launch", [ctypes.c_void_p, ctypes.c_void_p])(
            p(terms), p(valid), p(weights), B, T, program.n_groups, E, K,
            *_program_args(program, device), p(out), _build.stream_of(device),
        )
    _build.check_launch("predicate_eval", rc)
    return out


def predicate_eval_batch(terms, valid, weights, program: Program) -> torch.Tensor:
    """The program over a batch of windows: terms (B, T, E, K),
    valid/weights (B, G, E, K) float32 -> (B, E) int32 mask.  Any E."""
    if not terms.is_cuda:
        return _ref.predicate_eval_batch_ref(terms, valid, weights, program)
    out = _mask(terms, valid, weights, program)
    _count("predicate_eval_batch")
    return out


def predicate_eval(terms, valid, weights, program: Program) -> torch.Tensor:
    """The program over one window: (T, E, K), (G, E, K) float32 -> (E,)
    int32 mask; the B = 1 case of :func:`predicate_eval_batch`."""
    if not terms.is_cuda:
        return _ref.predicate_mask(program, terms, valid, weights).to(torch.int32)
    out = _mask(terms[None], valid[None], weights[None], program)[0]
    _count("predicate_eval")
    return out


def cascade_stage(terms, valid, weights, packed, seg_ids, program: Program, nb: int):
    """One batched cascade stage: the contract of
    :func:`repro_torch.kernels.ref.cascade_stage_ref`, with ``packed``
    updated **in place** (the JAX package donates the buffer instead).

    Returns ``(packed, out)``: ``out`` (B, nb + 1) int32 holds each
    window's basket bits in columns ``[0, nb)`` and its count in column
    ``nb``, so one copy brings both back.
    """
    B, T, E, K = _check_inputs("cascade_stage", terms, valid, weights, program)
    device = terms.device
    if E % 32:
        raise ValueError(f"cascade_stage: E={E} is not a multiple of 32")
    if packed.dtype != torch.int32 or tuple(packed.shape) != (B, E // 32):
        raise ValueError(
            f"cascade_stage: packed must be int32 ({B}, {E // 32}), got "
            f"{packed.dtype} {tuple(packed.shape)}"
        )
    if seg_ids.dtype != torch.int32 or tuple(seg_ids.shape) != (B, E):
        raise ValueError(
            f"cascade_stage: seg_ids must be int32 ({B}, {E}), got "
            f"{seg_ids.dtype} {tuple(seg_ids.shape)}"
        )
    for name, x in (("packed", packed), ("seg_ids", seg_ids)):
        if not x.is_contiguous() or x.device != device:
            raise ValueError(f"cascade_stage: {name} must be contiguous on {device}")
    if nb < 1:
        raise ValueError(f"cascade_stage: nb={nb} < 1")
    if not terms.is_cuda:
        return cascade_stage_plain(terms, valid, weights, packed, seg_ids, program, nb)
    if not (B and E):  # nothing to launch: no event survives
        return packed, torch.zeros((B, nb + 1), dtype=torch.int32, device=device)
    # zeroed by the launch itself (cudaMemsetAsync), not by a PyTorch kernel
    out = torch.empty((B, nb + 1), dtype=torch.int32, device=device)
    p = _build.ptr
    with torch.cuda.device(device):
        rc = _fn("cascade_stage_launch",
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p])(
            p(terms), p(valid), p(weights), B, T, program.n_groups, E, K,
            *_program_args(program, device), p(packed), p(seg_ids), nb,
            p(out), _build.stream_of(device),
        )
    _build.check_launch("cascade_stage", rc)
    _count("cascade_stage")
    return packed, out


def cascade_stage_plain(terms, valid, weights, packed, seg_ids, program: Program,
                        nb: int):
    """:func:`repro_torch.kernels.ref.cascade_stage_ref` with the kernel's
    outputs: ``packed`` updated in place, and one (B, nb + 1) buffer of
    basket bits and counts."""
    new, basket_alive, counts = _ref.cascade_stage_ref(
        terms, valid, weights, packed, seg_ids, program, nb
    )
    packed.copy_(new)
    return packed, torch.cat([basket_alive, counts[:, None]], dim=1)


__all__ = [
    "cascade_stage",
    "cascade_stage_plain",
    "launches",
    "predicate_eval",
    "predicate_eval_batch",
]
