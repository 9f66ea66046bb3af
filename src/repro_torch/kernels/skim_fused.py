"""The fused predicate + stream-compaction kernel (``csrc/skim_fused.cu``).

One pass per window: each event is tested against the compiled program,
and the payload rows of the survivors are packed to the front in event
order.  By convention payload column 0 is the local event index, so the
packed output alone gives the host the survivor mask (see
``repro_torch.core.neardata.fused_window_skim``).

Two wrappers over one launch, each counted under its own name
(``_build.launch_counts``): :func:`skim_fused` (one window, the engine's
per-window path) and :func:`skim_fused_batch` (a batch of windows, each
packed on its own);
the first is the B = 1 launch of the second.  A launch is one kernel
(single-pass compaction by decoupled look-back, the zero tail written by
the kernel itself), and writes the counts and the packed rows into one
allocation (:func:`launch`), so a caller can read both back in one copy.

The program reaches the kernel as data: :func:`program_descriptor`
flattens a frozen :class:`Program` and its planes' kinds (float32 values
or an integer branch's int32 bits, ``program.KIND_*``) into small int32
and float64 arrays, uploaded once per (program, kinds, device) and cached
by the program's identity for as long as the program lives, so one build
serves every cascade stage and a call hashes nothing.  The look-back's status words
live in a grow-only workspace per (device, stream), tagged with a
per-call epoch (:class:`Workspace`, which ``stream_compact`` shares).
"""

from __future__ import annotations

import ctypes
import threading
import weakref

import numpy as np
import torch

from repro_torch.core.expr import RPN_ABS, RPN_BRANCH, RPN_CONST, RPN_NEG, RPN_SUM
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.program import GROUP_EXPR, Program

EVENT_TILE = 512  # events per block (csrc/skim_fused.cu kTile)
MAX_STACK = 16  # RPN stack depth the kernel holds (csrc kMaxStack)
MAX_WINDOWS = 65535  # the grid's y dimension (one window per row)
ROW_WIDTHS = (1, 2, 4, 8)  # payload element bytes the kernel moves as raw bits

EPOCH_LIMIT = 1 << 30  # epochs live in 30 bits of a status word
PROGRAM_ARGS = 9  # descriptor pointers a launch takes (program_args)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _I, _I, _I,
             *([_P] * PROGRAM_ARGS), _P, _P, ctypes.c_uint, _P, _P, _P)

# (id(program), kinds, device) -> (descriptor arrays, pointer arguments).
# An entry leaves when its program is collected, so the map holds only
# live programs and a later program at the same address never finds it.
_DESCRIPTORS: dict = {}


def _stack_depth(rpn) -> int:
    depth = peak = 0
    for op, _ in rpn:
        if op in (RPN_BRANCH, RPN_SUM, RPN_CONST):
            depth += 1
        elif op not in (RPN_NEG, RPN_ABS):  # binary: pop two, push one
            depth -= 1
        peak = max(peak, depth)
    return peak


def _kinds_key(kinds) -> tuple:
    """``kinds`` as a cache key: () when every plane is float32."""
    return tuple(int(k) for k in kinds) if kinds and any(kinds) else ()


def flatten_program(program: Program, kinds=None) -> tuple[np.ndarray, np.ndarray, dict]:
    """Program -> (int32 array, float64 array, offsets of each segment in
    its array).

    int32: groups (G, 9) = kind, term offset, term count, min_count,
    cmp_op, same-collection flag, RPN offset, RPN length, the kind of the
    group's weights plane; then term ids, ops, RPN opcodes, RPN term
    slots, and the plane kinds: each term slot's (T, which the RPN leaves
    read), then each term's again aligned with the term ids (so a kernel
    reads a term's kind beside its id, not through it).  ``kinds`` are the
    (T + G) plane kinds of :func:`repro_torch.core.neardata.program_kinds`
    (float32 when None).  float64, exact: the per-object thresholds
    (aligned with the term ids; a float32 plane reads its cut in float32,
    an integer one in float64), (cmp_thr, cmp_thr2) per group and the RPN
    constants, which meet group values evaluated in float64.
    """
    groups, term_ids, ops, term_kinds, thrs, cmp_thrs = [], [], [], [], [], []
    rpn_op, rpn_term, rpn_const = [], [], []
    c2 = program.group_collections2 or (None,) * program.n_groups
    n_kinds = program.n_terms + program.n_groups
    kinds = list(kinds) if kinds else [0] * n_kinds
    if len(kinds) != n_kinds:
        raise ValueError(f"{len(kinds)} plane kinds for {program.n_terms} terms "
                         f"and {program.n_groups} groups")
    for g, grp in enumerate(program.groups):
        if grp.kind == GROUP_EXPR and _stack_depth(grp.rpn) > MAX_STACK:
            raise ValueError(
                f"expression group {g} needs a stack deeper than {MAX_STACK}"
            )
        n = len(grp.term_ids)
        same = int(program.group_collections[g] == c2[g])
        groups.append([grp.kind, len(term_ids), n, grp.min_count, grp.cmp_op,
                       same, len(rpn_op), len(grp.rpn), kinds[program.n_terms + g]])
        term_ids.extend(grp.term_ids)
        term_kinds.extend(kinds[t] for t in grp.term_ids)
        ops.extend(list(grp.ops) + [0] * (n - len(grp.ops)))
        thrs.extend(list(grp.thrs) + [0.0] * (n - len(grp.thrs)))
        cmp_thrs.extend([grp.cmp_thr, grp.cmp_thr2])
        for op, arg in grp.rpn:
            rpn_op.append(op)
            rpn_term.append(int(arg) if op in (RPN_BRANCH, RPN_SUM) else 0)
            rpn_const.append(float(arg) if op == RPN_CONST else 0.0)
    segments = (
        (np.int32, (("groups", np.asarray(groups, np.int64).reshape(-1)),
                    ("term_ids", term_ids), ("ops", ops), ("rpn_op", rpn_op),
                    ("rpn_term", rpn_term), ("kinds", kinds[:program.n_terms]),
                    ("term_kinds", term_kinds))),
        (np.float64, (("thrs", thrs), ("cmp_thrs", cmp_thrs),
                      ("rpn_const", rpn_const))),
    )
    offsets, arrays = {}, []
    for dtype, segs in segments:
        values = []
        for name, seg in segs:
            offsets[name] = len(values)
            values.extend(seg)
        arrays.append(np.asarray(values + [0], dtype))
    return (*arrays, offsets)


def program_descriptor(program: Program, device: torch.device, kinds=None):
    """The descriptor arrays of ``program`` with plane ``kinds`` on
    ``device`` (cached)."""
    return _descriptor_entry(program, device, kinds)[0]


def program_args(program: Program, device: torch.device, kinds=None):
    """The program's nine descriptor pointers on ``device``, as the
    kernels take them (cached with the descriptors)."""
    return _descriptor_entry(program, device, kinds)[1]


def _descriptor_entry(program: Program, device: torch.device, kinds=None):
    """((ints, doubles, offsets), the nine kernel pointer arguments),
    cached by ``id(program)`` and the kinds while the program lives."""
    kinds = _kinds_key(kinds)
    key = (id(program), kinds, device)
    entry = _DESCRIPTORS.get(key)
    if entry is None:
        *arrays, offsets = flatten_program(program, kinds)
        ints, doubles = (_build.to_device(a, device) for a in arrays)

        def at(base, name):
            return ctypes.c_void_p(base.data_ptr() + base.element_size() * offsets[name])

        args = (at(ints, "groups"), at(ints, "term_ids"), at(ints, "ops"),
                at(ints, "kinds"), at(doubles, "thrs"), at(doubles, "cmp_thrs"),
                at(ints, "rpn_op"), at(ints, "rpn_term"), at(doubles, "rpn_const"))
        entry = ((ints, doubles, offsets), args)
        _DESCRIPTORS[key] = entry
        weakref.finalize(program, _DESCRIPTORS.pop, key, None)
    return entry


class Workspace:
    """The look-back's status words and ticket counters on one (device,
    stream), grow-only, and the epoch of its last launch: one workspace
    for both compaction kernels (``skim_fused`` takes a status word a tile
    and a ticket a window, ``stream_compact`` a word a tile and one
    ticket), so one counter owns a stream's epochs.  Launches on one
    stream run in order, so a workspace never serves two kernels at once.
    Status words of earlier epochs read as "not published"; at the epoch
    limit they are zeroed on the stream and the epochs start again.  Each
    launch leaves its counters at 0."""

    _all: dict = {}
    _lock = threading.Lock()

    def __init__(self, device):
        self.device = device
        self.status = torch.zeros(0, dtype=torch.int64, device=device)
        self.tickets = torch.zeros(0, dtype=torch.int32, device=device)
        self.epoch = 0

    @classmethod
    def reserve(cls, device, stream: int, n_status: int, n_tickets: int):
        """(status, tickets, epoch) for one launch on ``stream``."""
        with cls._lock:
            ws = cls._all.get((device, stream))
            if ws is None:
                ws = cls._all[(device, stream)] = cls(device)
            if ws.status.numel() < n_status:
                ws.status = torch.zeros(max(n_status, 2 * ws.status.numel()),
                                        dtype=torch.int64, device=device)
            if ws.tickets.numel() < n_tickets:
                ws.tickets = torch.zeros(max(n_tickets, 2 * ws.tickets.numel()),
                                         dtype=torch.int32, device=device)
            ws.epoch += 1
            if ws.epoch >= EPOCH_LIMIT:
                ws.status.zero_()
                ws.epoch = 1
            return ws.status, ws.tickets, ws.epoch


def _check(who, name, x, shape, device):
    """float32 planes; a payload of any type of 1, 2, 4 or 8 bytes (its
    rows move as raw bits)."""
    if name == "payload":
        if x.element_size() not in ROW_WIDTHS:
            raise ValueError(f"{who}: payload of {x.dtype} has "
                             f"{x.element_size()}-byte elements, not 1, 2, 4 or 8")
        if not x.is_contiguous():
            raise ValueError(f"{who}: payload must be contiguous")
    elif x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous float32")
    if tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(
            f"{who}: {name} has shape {tuple(x.shape)} on {x.device}, "
            f"expected {tuple(shape)} on {device}"
        )


def header_words(B: int) -> int:
    """int32 words before the rows in :func:`launch`'s buffer: the B
    counts, padded to 16 bytes."""
    return (B + 3) & ~3


def view_rows(words, B: int, E: int, D: int, dtype) -> torch.Tensor:
    """The (B, E, D) rows of ``dtype`` at the start of ``words``, a 1-D
    int32 tensor starting on a 16-byte boundary (a view)."""
    return words.view(torch.uint8)[: B * E * D * dtype.itemsize].view(dtype).view(B, E, D)


def launch(who, terms, valid, weights, payload, program: Program, kinds=None):
    """Launch ``skim_fused_launch`` over a (B, T, E, K) batch on the card,
    the planes read by their ``kinds`` (None: every plane float32).

    Returns ``buf``, one int32 allocation: the B counts, padding to
    :func:`header_words`, then the packed (B, E, D) rows' bits in the
    payload's type, padded to whole words — so one device-to-host copy
    brings back both."""
    device = terms.device
    B, T, E, K = terms.shape
    G = program.n_groups
    D = payload.shape[-1]
    if T != program.n_terms:
        raise ValueError(f"{who}: {T} term planes for {program.n_terms} terms")
    if B > MAX_WINDOWS:
        raise ValueError(f"{who}: {B} windows exceed the grid's {MAX_WINDOWS}")
    _check(who, "terms", terms, (B, T, E, K), device)
    _check(who, "valid", valid, (B, G, E, K), device)
    _check(who, "weights", weights, (B, G, E, K), device)
    _check(who, "payload", payload, (B, E, D), device)
    hdr = header_words(B)
    width = payload.element_size()
    buf = torch.empty(hdr + -(-B * E * D * width // 4), dtype=torch.int32, device=device)
    if B == 0 or E == 0:
        buf.zero_()
        return buf
    args = program_args(program, device, kinds)
    stream = _build.stream_id(device)
    status, tickets, epoch = Workspace.reserve(
        device, stream, B * -(-E // EVENT_TILE), B)
    p = _build.ptr
    rc = _build.call_on(
        device, _build.function("skim_fused", "skim_fused_launch", _ARGTYPES),
        p(terms), p(valid), p(weights), p(payload),
        B, T, G, E, K, D, width, *args, p(status), p(tickets), epoch,
        ctypes.c_void_p(buf.data_ptr() + 4 * hdr), p(buf), ctypes.c_void_p(stream))
    _build.check_launch(who, rc)
    _build.count_launch(who)
    return buf


def split(buf, B: int, E: int, D: int, dtype=torch.float32):
    """:func:`launch`'s buffer -> (packed (B, E, D) of the payload's
    ``dtype``, counts (B,) int32), views of it."""
    return view_rows(buf[header_words(B):], B, E, D, dtype), buf[:B]


def skim_fused(terms, valid, weights, payload, program: Program, kinds=None):
    """One-pass skim: (T,E,K),(G,E,K),(G,E,K) float32 and an (E,D)
    payload of any type of 1, 2, 4 or 8 bytes -> (packed (E, D) in the
    payload's type with the survivors' rows first, bit for bit, and zeros
    after, count () int32).  ``kinds``: the planes' kinds (the engine's
    route; None: every plane float32, the JAX package's form).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version, :func:`repro_torch.kernels.ref.skim_fused_ref`.
    """
    if not terms.is_cuda:
        return _ref.skim_fused_ref(terms, valid, weights, payload, program, kinds)
    if terms.dim() != 3 or payload.dim() != 2:
        raise ValueError(
            f"skim_fused: terms {tuple(terms.shape)} and payload "
            f"{tuple(payload.shape)} are not (T, E, K) and (E, D)"
        )
    E, D = payload.shape
    buf = launch("skim_fused", terms[None], valid[None], weights[None],
                 payload[None], program, kinds)
    out, totals = split(buf, 1, E, D, payload.dtype)
    return out[0], totals[0]


def skim_fused_batch(terms, valid, weights, payload, program: Program, kinds=None):
    """The one-pass skim over a batch of windows: terms (B, T, E, K),
    valid/weights (B, G, E, K) float32, payload (B, E, D) of any type of
    1, 2, 4 or 8 bytes -> (packed (B, E, D) in the payload's type with
    each window's survivors first in its own slice, counts (B,) int32).
    Per window it equals :func:`skim_fused`.  Any E.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version, :func:`repro_torch.kernels.ref.skim_fused_batch_ref`.
    """
    if not terms.is_cuda:
        return _ref.skim_fused_batch_ref(terms, valid, weights, payload, program, kinds)
    if terms.dim() != 4 or payload.dim() != 3:
        raise ValueError(
            f"skim_fused_batch: terms {tuple(terms.shape)} and payload "
            f"{tuple(payload.shape)} are not (B, T, E, K) and (B, E, D)"
        )
    buf = launch("skim_fused_batch", terms, valid, weights, payload, program, kinds)
    return split(buf, *payload.shape, payload.dtype)


__all__ = [
    "EVENT_TILE",
    "MAX_WINDOWS",
    "PROGRAM_ARGS",
    "ROW_WIDTHS",
    "Workspace",
    "flatten_program",
    "header_words",
    "launch",
    "program_args",
    "program_descriptor",
    "skim_fused",
    "skim_fused_batch",
    "split",
    "view_rows",
]
