"""The batched predicate kernel and the cascade stage (``csrc/predicate_eval.cu``).

Four wrappers over one CUDA source, counted under three names
(``_build.launch_counts``):

* :func:`cascade_stage_windows` — the batched cascade's stage step over
  the windows the stage runs: the program over each staged window, ANDed
  into its row of the carried bit-packed survivor mask in place, with
  each window's survivor count and each basket's alive bit (the epilogue
  of the JAX package's ``ops._cascade_stage_impl`` fused into the
  kernel).  Rows no staged window maps to keep their words and get zero
  rows of counts and bits.
* :func:`cascade_stage` — the same over a dense batch, every window
  staged (the same kernel and counter).
* :func:`predicate_eval_batch` — the (B, E) int32 mask alone: the same
  kernel with its mask epilogue, over a dense batch (every window
  staged, every event live), any E.
* :func:`predicate_eval` — its B = 1 case, (E,) int32.

Both epilogues share the stage kernel's evaluator: the planes the
program reads come into shared memory (:func:`launch_plan` picks the
tile and the copy mode; :func:`mask_plan` for the mask) and an event's
lanes go over its K slots.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version in :mod:`repro_torch.kernels.ref`.  The program reaches the
kernel as the same descriptor arrays as ``skim_fused``'s.  Each wrapper
takes the planes' ``kinds`` (``program.KIND_*``: an integer branch's
plane holds its int32 bits); None, the JAX package's form, reads every
plane as float32.
"""

from __future__ import annotations

import ctypes

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
from repro_torch.kernels.skim_fused import PROGRAM_ARGS, program_args

MAX_WINDOWS = 65535  # the grid's y dimension (one window per row)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_MASK_ARGTYPES = (_P, _P, _P, _LL, _LL, _I, _I, _I, _LL, _I, _I, _I, _I, _I,
                  ctypes.c_ulonglong, *([_P] * PROGRAM_ARGS), _P, _P)
_STAGE_ARGTYPES = (_P, _P, _P, _LL, _LL, _P, _I, _I, _I, _LL, _I, _I, _I, _I, _I,
                   ctypes.c_ulonglong, *([_P] * PROGRAM_ARGS), _P, _P, _I, _P, _I, _P)


# The stage kernel's tile: a block brings (T + 2G) planes of `tile`
# events x K slots into shared memory, at most SMEM_BUDGET bytes, so a
# few blocks share an SM; a shape that does not fit even at 32 events
# within SMEM_MAX reads device memory instead.
SMEM_BUDGET = 48 * 1024
SMEM_MAX = 200 * 1024  # csrc/predicate_eval.cu kSmemMax
MODE_BULK, MODE_ASYNC4, MODE_DIRECT = 0, 1, 2  # csrc/predicate_eval.cu kMode*
MAX_TILE = 512


def event_lanes(program: Program, K: int) -> int:
    """Lanes an event takes in the stage kernel: min(K, 32), each lane
    its own slots, so a warp reads consecutive words of shared memory; 1
    (an event a lane) for a program with a mass or ΔR group at K <= 8,
    whose per-event four-vectors and trig every lane of the event would
    otherwise repeat."""
    pair = any(g.kind in (GROUP_MASS, GROUP_DR) for g in program.groups)
    return 1 if pair and K <= 8 else max(1, min(K, 32))


def mask_lanes(K: int) -> int:
    """Lanes an event takes in the mask launch: about 8 slots a lane (1 up
    to K = 8, then K / 8 rounded up to a power of two, at most 32).  There
    every event is live and a batch is large, so each lane's share of the
    event's scalar work (the program's walk, ballots, shuffles) costs more
    than the slots it reads one after another."""
    lanes = 1
    while lanes < 32 and lanes * 8 < K:
        lanes *= 2
    return lanes


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
    where not, device memory where the planes exceed ``SMEM_MAX`` (or
    there is nothing to copy: no plane or no slot)."""
    tile, least = MAX_TILE, max(32, 256 // lanes)
    while tile > least and n_planes * tile * K * 4 > SMEM_BUDGET:
        tile //= 2
    smem = n_planes * tile * K * 4
    if smem > SMEM_MAX or smem == 0:
        return tile, MODE_DIRECT, 0
    return tile, MODE_BULK if aligned else MODE_ASYNC4, smem


def launch_plan(planes, strides, E: int, K: int, program: Program, lanes: int):
    """(tile, mode, shared bytes) of a launch over ``planes``, the (terms,
    valid, weights) base tensors, with ``strides`` the floats between two
    windows' term and group planes and ``lanes`` an event: bulk copies need
    every base 16-byte aligned and every stride and plane (E*K floats) a
    multiple of 16 bytes, which also makes a ragged last tile's slice of a
    plane whole 16-byte units."""
    aligned = all(x.data_ptr() % 16 == 0 for x in planes) and all(
        4 * n % 16 == 0 for n in (*strides, E * K))
    return stage_plan(program.n_terms + 2 * program.n_groups, K, lanes, aligned)


def mask_plan(planes, strides, E: int, K: int, program: Program):
    """(tile, mode, shared bytes, lanes) of the mask launch over a dense
    batch: :func:`mask_lanes` lanes an event, and the stage's plan
    (:func:`launch_plan`) where the program reads every slot of the planes
    it reads (COUNT and HT groups only); device memory otherwise, where
    ANY, EXPR and pair groups read a slot or two of most of their planes
    and a copy of the whole tile would bring the rest in for nothing."""
    lanes = mask_lanes(K)
    tile, mode, smem = launch_plan(planes, strides, E, K, program, lanes)
    if any(g.kind not in (GROUP_COUNT, GROUP_HT) for g in program.groups):
        mode, smem = MODE_DIRECT, 0
    return tile, mode, smem, lanes


def _check_inputs(who: str, terms, valid, weights, program: Program, window=False):
    """(B, T, E, K) of a batch the kernel takes, or raises; with ``window``
    the inputs are one window, (T, E, K) and (G, E, K), and B is 1."""
    if terms.dim() != 4 - window:
        raise ValueError(f"{who}: terms must be {'(' if window else '(B, '}T, E, K), "
                         f"got {tuple(terms.shape)}")
    B, T, E, K = (1, *terms.shape) if window else terms.shape
    G = program.n_groups
    if T != program.n_terms:
        raise ValueError(f"{who}: {T} term planes for {program.n_terms} terms")
    if B > MAX_WINDOWS:
        raise ValueError(f"{who}: {B} windows exceed the grid's {MAX_WINDOWS}")
    lead = () if window else (B,)
    for name, x, shape in (("terms", terms, (*lead, T, E, K)),
                           ("valid", valid, (*lead, G, E, K)),
                           ("weights", weights, (*lead, G, E, K))):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous float32")
        if tuple(x.shape) != shape or x.device != terms.device:
            raise ValueError(
                f"{who}: {name} has shape {tuple(x.shape)} on {x.device}, "
                f"expected {shape} on {terms.device}"
            )
    return B, T, E, K


def _mask(terms, valid, weights, program: Program, window: bool,
          kinds=None) -> torch.Tensor:
    """Launch ``predicate_eval_launch`` (the stage kernel, mask epilogue):
    (B, E) int32 on the card, or (E,) for one ``window``."""
    B, T, E, K = _check_inputs("predicate_eval", terms, valid, weights, program, window)
    device = terms.device
    out = torch.empty((E,) if window else (B, E), dtype=torch.int32, device=device)
    if B == 0 or E == 0:
        return out
    G = program.n_groups
    planes, strides = (terms, valid, weights), (T * E * K, G * E * K)
    tile, mode, smem, lanes = mask_plan(planes, strides, E, K, program)
    p = _build.ptr
    rc = _build.call_on(
        device, _build.function("predicate_eval", "predicate_eval_launch", _MASK_ARGTYPES),
        *(p(x) for x in planes), *strides, B, T, G, E, K,
        tile, mode, smem, lanes, planes_read(program),
        *program_args(program, device, kinds), p(out), _build.stream_of(device))
    _build.check_launch("predicate_eval", rc)
    return out


def predicate_eval_batch(terms, valid, weights, program: Program,
                         kinds=None) -> torch.Tensor:
    """The program over a batch of windows: terms (B, T, E, K),
    valid/weights (B, G, E, K) float32 -> (B, E) int32 mask.  Any E."""
    if not terms.is_cuda:
        return _ref.predicate_eval_batch_ref(terms, valid, weights, program, kinds)
    out = _mask(terms, valid, weights, program, window=False, kinds=kinds)
    _build.count_launch("predicate_eval_batch")
    return out


def predicate_eval(terms, valid, weights, program: Program, kinds=None) -> torch.Tensor:
    """The program over one window: (T, E, K), (G, E, K) float32 -> (E,)
    int32 mask; the B = 1 case of :func:`predicate_eval_batch`."""
    if not terms.is_cuda:
        return _ref.predicate_mask(program, terms, valid, weights, kinds).to(torch.int32)
    out = _mask(terms, valid, weights, program, window=True, kinds=kinds)
    _build.count_launch("predicate_eval")
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
                  packed, seg_ids, program: Program, nb: int, kinds=None):
    """Launch ``cascade_stage_launch`` over S staged windows; ``planes``
    are the (terms, valid, weights) base tensors, ``strides`` the floats
    between two windows' term and group planes, ``rows`` the (S,) int32
    row table or None for the identity."""
    device = packed.device
    B = packed.shape[0]
    out = torch.empty((B, nb + 1), dtype=torch.int32, device=device)
    lanes = event_lanes(program, K)
    tile, mode, smem = launch_plan(planes, strides, E, K, program, lanes)
    p = _build.ptr
    rc = _build.call_on(
        device, _build.function("predicate_eval", "cascade_stage_launch", _STAGE_ARGTYPES),
        *(p(x) for x in planes), *strides,
        None if rows is None else p(rows), S, T, program.n_groups, E, K,
        tile, mode, smem, lanes, planes_read(program),
        *program_args(program, device, kinds), p(packed),
        p(seg_ids), nb, p(out), B, _build.stream_of(device))
    _build.check_launch("cascade_stage", rc)
    # the launch zeroes `out` first, then runs the kernel if S and E
    if S and E:
        _build.count_launch("cascade_stage")
    return packed, out


def cascade_stage(terms, valid, weights, packed, seg_ids, program: Program, nb: int,
                  kinds=None):
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
        return cascade_stage_plain(terms, valid, weights, packed, seg_ids, program, nb,
                                   kinds)
    G = program.n_groups
    return _launch_stage((terms, valid, weights), (T * E * K, G * E * K), None,
                         B, T, E, K, packed, seg_ids, program, nb, kinds)


def cascade_stage_windows(planes, rows, packed, seg_ids, program: Program, nb: int,
                          kinds=None):
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
        return cascade_stage_windows_plain(planes, rows, packed, seg_ids, program, nb,
                                           kinds)
    window = P * E * K
    return _launch_stage((planes, planes[:, T:], planes[:, T + G:]), (window, window),
                         rows, S, T, E, K, packed, seg_ids, program, nb, kinds)


def cascade_stage_plain(terms, valid, weights, packed, seg_ids, program: Program,
                        nb: int, kinds=None):
    """:func:`repro_torch.kernels.ref.cascade_stage_ref` with the kernel's
    outputs: ``packed`` updated in place, and one (B, nb + 1) buffer of
    basket bits and counts."""
    new, basket_alive, counts = _ref.cascade_stage_ref(
        terms, valid, weights, packed, seg_ids, program, nb, kinds
    )
    packed.copy_(new)
    return packed, torch.cat([basket_alive, counts[:, None]], dim=1)


def cascade_stage_windows_plain(planes, rows, packed, seg_ids, program: Program,
                                nb: int, kinds=None):
    """:func:`cascade_stage_plain` over the staged windows' rows; the
    other rows keep their words and get zero rows."""
    T, G = program.n_terms, program.n_groups
    out = torch.zeros((packed.shape[0], nb + 1), dtype=torch.int32,
                      device=packed.device)
    if len(rows):
        idx = rows.long()
        new, summary = cascade_stage_plain(
            planes[:, :T], planes[:, T:T + G], planes[:, T + G:],
            packed[idx], seg_ids[idx], program, nb, kinds)
        packed[idx] = new
        out[idx] = summary
    return packed, out


__all__ = [
    "cascade_stage",
    "cascade_stage_plain",
    "cascade_stage_windows",
    "cascade_stage_windows_plain",
    "event_lanes",
    "launch_plan",
    "mask_lanes",
    "mask_plan",
    "planes_read",
    "predicate_eval",
    "predicate_eval_batch",
    "stage_plan",
]
