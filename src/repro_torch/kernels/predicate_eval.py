"""The batched predicate kernel and the cascade stage (``csrc/predicate_eval.cu``).

Four wrappers over one CUDA source, three launch counters:

* :func:`cascade_stage_windows` — the batched cascade's stage step over
  the windows the stage runs: the program over each staged window, ANDed
  into its row of the carried bit-packed survivor mask in place, with
  each window's survivor count and each basket's alive bit (the epilogue
  of the JAX package's ``ops._cascade_stage_impl`` fused into the
  kernel).  Rows no staged window maps to keep their words and get zero
  rows of counts and bits.
* :func:`cascade_stage` — the same over a dense batch, every window
  staged (the same kernel and counter).
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
from repro_torch.kernels.program import (
    GROUP_COUNT,
    GROUP_DR,
    GROUP_HT,
    GROUP_MASS,
    Program,
)
from repro_torch.kernels.skim_fused import program_descriptor

MAX_WINDOWS = 65535  # the grid's y dimension (one window per row)

# kernel launches through each wrapper; never reset here
launches = {"cascade_stage": 0, "predicate_eval_batch": 0, "predicate_eval": 0}
_LAUNCHES_LOCK = threading.Lock()  # pipelined skims call from several threads

_PROGRAM_ARGS = 8  # program descriptor pointers


def _fn(name: str, argtypes: list):
    fn = getattr(_build.load("predicate_eval"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _mask_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _fn("predicate_eval_launch",
               [p, p, p, i, i, i, ctypes.c_longlong, i, *([p] * _PROGRAM_ARGS), p, p])


def _stage_fn():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _fn("cascade_stage_launch",
               [p, p, p, ll, ll, p, i, i, i, ll, i, i, i, i, i, ctypes.c_ulonglong,
                *([p] * _PROGRAM_ARGS), p, p, i, p, i, p])


# The stage kernel's tile: a block brings (T + 2G) planes of `tile`
# events x K slots into shared memory, at most SMEM_BUDGET bytes, so a
# few blocks share an SM; a shape that does not fit even at 32 events
# within SMEM_MAX reads device memory instead.
SMEM_BUDGET = 48 * 1024
SMEM_MAX = 200 * 1024
MODE_BULK, MODE_ASYNC4, MODE_DIRECT = 0, 1, 2  # csrc/predicate_eval.cu kMode*
MAX_TILE = 512


def event_lanes(program: Program, K: int) -> int:
    """Lanes an event takes in the stage kernel: min(K, 32), each lane
    its own slots, so a warp reads consecutive words of shared memory; 1
    (an event a lane) for a program with a mass or ΔR group at K <= 8,
    whose per-event four-vectors and trig every lane of the event would
    otherwise repeat."""
    pair = any(g.kind in (GROUP_MASS, GROUP_DR) for g in program.groups)
    return 1 if pair and K <= 8 else min(K, 32)


def planes_read(program: Program) -> int:
    """Bit q set where the stage kernel reads plane q of a staged window:
    every term plane, the valid planes of COUNT/HT/MASS/ΔR groups and the
    weights planes of HT groups (planes past 64 are always read)."""
    T, G = program.n_terms, program.n_groups
    mask = (1 << T) - 1
    for g, grp in enumerate(program.groups):
        if grp.kind in (GROUP_COUNT, GROUP_HT, GROUP_MASS, GROUP_DR):
            mask |= 1 << (T + g)
        if grp.kind == GROUP_HT:
            mask |= 1 << (T + G + g)
    return mask & ((1 << 64) - 1)


def stage_plan(n_planes: int, K: int, lanes: int, aligned: bool) -> tuple[int, int, int]:
    """(tile, mode, shared bytes) of a stage launch: the largest power of
    two of events up to 512 whose planes fit ``SMEM_BUDGET``, but enough
    events for each of the block's 8 warps (256 / ``lanes``, at least 32);
    bulk copies where every plane is 16-byte aligned, 4-byte ``cp.async``
    where not, device memory where the planes exceed ``SMEM_MAX``."""
    tile, least = MAX_TILE, max(32, 256 // lanes)
    while tile > least and n_planes * tile * K * 4 > SMEM_BUDGET:
        tile //= 2
    smem = n_planes * tile * K * 4
    if smem > SMEM_MAX:
        return tile, MODE_DIRECT, 0
    return tile, MODE_BULK if aligned else MODE_ASYNC4, smem


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
        rc = _mask_fn()(
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


def _check_mask(who: str, packed, seg_ids, B: int, E: int, nb: int, device):
    if E % 32:
        raise ValueError(f"{who}: E={E} is not a multiple of 32")
    if packed.dtype != torch.int32 or tuple(packed.shape) != (B, E // 32):
        raise ValueError(
            f"{who}: packed must be int32 ({B}, {E // 32}), got "
            f"{packed.dtype} {tuple(packed.shape)}"
        )
    if seg_ids.dtype != torch.int32 or tuple(seg_ids.shape) != (B, E):
        raise ValueError(
            f"{who}: seg_ids must be int32 ({B}, {E}), got "
            f"{seg_ids.dtype} {tuple(seg_ids.shape)}"
        )
    for name, x in (("packed", packed), ("seg_ids", seg_ids)):
        if not x.is_contiguous() or x.device != device:
            raise ValueError(f"{who}: {name} must be contiguous on {device}")
    if nb < 1:
        raise ValueError(f"{who}: nb={nb} < 1")


def _launch_stage(planes, strides, rows, S: int, T: int, E: int, K: int,
                  packed, seg_ids, program: Program, nb: int):
    """Launch ``cascade_stage_launch`` over S staged windows; ``planes``
    are the (terms, valid, weights) base tensors, ``strides`` the floats
    between two windows' term and group planes, ``rows`` the (S,) int32
    row table or None for the identity."""
    device = packed.device
    B = packed.shape[0]
    out = torch.empty((B, nb + 1), dtype=torch.int32, device=device)
    n_planes = T + 2 * program.n_groups
    aligned = all(x.data_ptr() % 16 == 0 for x in planes) and all(
        4 * n % 16 == 0 for n in (*strides, E * K))
    lanes = event_lanes(program, K)
    tile, mode, smem = stage_plan(n_planes, K, lanes, aligned)
    p = _build.ptr
    with torch.cuda.device(device):
        rc = _stage_fn()(
            *(p(x) for x in planes), *strides,
            None if rows is None else p(rows), S, T, program.n_groups, E, K,
            tile, mode, smem, lanes, planes_read(program),
            *_program_args(program, device), p(packed),
            p(seg_ids), nb, p(out), B, _build.stream_of(device),
        )
    _build.check_launch("cascade_stage", rc)
    # the launch zeroes `out` first, then runs the kernel if S and E
    if S and E:
        _count("cascade_stage")
    return packed, out


def cascade_stage(terms, valid, weights, packed, seg_ids, program: Program, nb: int):
    """One batched cascade stage over a dense batch, every window staged:
    the contract of :func:`repro_torch.kernels.ref.cascade_stage_ref`, with
    ``packed`` updated **in place** (the JAX package donates the buffer
    instead).

    Returns ``(packed, out)``: ``out`` (B, nb + 1) int32 holds each
    window's basket bits in columns ``[0, nb)`` and its count in column
    ``nb``, so one copy brings both back.
    """
    B, T, E, K = _check_inputs("cascade_stage", terms, valid, weights, program)
    _check_mask("cascade_stage", packed, seg_ids, B, E, nb, terms.device)
    if not terms.is_cuda:
        return cascade_stage_plain(terms, valid, weights, packed, seg_ids, program, nb)
    G = program.n_groups
    return _launch_stage((terms, valid, weights), (T * E * K, G * E * K), None,
                         B, T, E, K, packed, seg_ids, program, nb)


def cascade_stage_windows(planes, rows, packed, seg_ids, program: Program, nb: int):
    """The cascade stage over the windows it runs only.

    ``planes`` (S, T + 2G, E, K) float32 holds staged window s's T term
    planes, then its G valid and G weights planes; ``rows`` (S,) int32 is
    each staged window's row of ``packed`` (B, E/32) and ``seg_ids`` (B,
    E), distinct rows in [0, B).  Each staged row of ``packed`` is updated
    in place as :func:`cascade_stage` updates it; a row no staged window
    maps to keeps its words.  Returns ``(packed, out)`` with ``out`` (B, nb
    + 1): a staged row's basket bits and count, zeros for the others.
    """
    if planes.dim() != 4:
        raise ValueError(f"cascade_stage: planes must be (S, P, E, K), got "
                         f"{tuple(planes.shape)}")
    S, P, E, K = planes.shape
    T, G = program.n_terms, program.n_groups
    device = planes.device
    if P != T + 2 * G:
        raise ValueError(f"cascade_stage: {P} planes for {T} terms and {G} groups")
    if planes.dtype != torch.float32 or not planes.is_contiguous():
        raise ValueError("cascade_stage: planes must be contiguous float32")
    if (rows.dtype != torch.int32 or tuple(rows.shape) != (S,)
            or not rows.is_contiguous() or rows.device != device):
        raise ValueError(f"cascade_stage: rows must be contiguous int32 ({S},) on "
                         f"{device}, got {rows.dtype} {tuple(rows.shape)}")
    if S > MAX_WINDOWS:
        raise ValueError(f"cascade_stage: {S} windows exceed the grid's {MAX_WINDOWS}")
    B = packed.shape[0] if packed.dim() == 2 else -1
    _check_mask("cascade_stage", packed, seg_ids, B, E, nb, device)
    if not planes.is_cuda:
        return cascade_stage_windows_plain(planes, rows, packed, seg_ids, program, nb)
    window = P * E * K
    return _launch_stage((planes, planes[:, T:], planes[:, T + G:]), (window, window),
                         rows, S, T, E, K, packed, seg_ids, program, nb)


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


def cascade_stage_windows_plain(planes, rows, packed, seg_ids, program: Program,
                                nb: int):
    """:func:`cascade_stage_plain` over the staged windows' rows; the
    other rows keep their words and get zero rows."""
    T, G = program.n_terms, program.n_groups
    out = torch.zeros((packed.shape[0], nb + 1), dtype=torch.int32,
                      device=packed.device)
    if len(rows):
        idx = rows.long()
        new, summary = cascade_stage_plain(
            planes[:, :T], planes[:, T:T + G], planes[:, T + G:],
            packed[idx], seg_ids[idx], program, nb)
        packed[idx] = new
        out[idx] = summary
    return packed, out


__all__ = [
    "cascade_stage",
    "cascade_stage_plain",
    "cascade_stage_windows",
    "cascade_stage_windows_plain",
    "event_lanes",
    "planes_read",
    "launches",
    "predicate_eval",
    "predicate_eval_batch",
    "stage_plan",
]
