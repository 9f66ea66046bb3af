"""The fused predicate + stream-compaction kernel (``csrc/skim_fused.cu``).

One pass per window: each event is tested against the compiled program,
and the payload rows of the survivors are packed to the front in event
order.  By convention payload column 0 is the local event index, so the
packed output alone gives the host the survivor mask (see
``repro_torch.core.neardata.fused_window_skim``).

The program reaches the kernel as data: :func:`program_descriptor`
flattens a frozen :class:`Program` into small int32/float32 arrays,
uploaded once per (program, device) and cached, so one build serves every
cascade stage.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.core.expr import RPN_ABS, RPN_BRANCH, RPN_CONST, RPN_NEG, RPN_SUM
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.program import GROUP_EXPR, Program

EVENT_TILE = 512  # events per block (csrc/skim_fused.cu kTile)
MAX_STACK = 16  # RPN stack depth the kernel holds (csrc kMaxStack)

launches = 0  # kernel launches through skim_fused(); never reset here
KERNELS_PER_CALL = 2  # skim_fused_launch runs the evaluate and compact kernels
_LAUNCHES_LOCK = threading.Lock()  # pipelined skims call from several threads

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


def flatten_program(program: Program) -> tuple[np.ndarray, np.ndarray, dict]:
    """Program -> (int32 array, float32 array, offsets of each segment).

    int32: groups (G, 8) = kind, term offset, term count, min_count,
    cmp_op, same-collection flag, RPN offset, RPN length; then term ids,
    ops (aligned with the term ids), RPN opcodes, RPN term slots.
    float32: thresholds (aligned with the term ids), (cmp_thr, cmp_thr2)
    per group, RPN constants.
    """
    groups, term_ids, ops, thrs, cmp_thrs = [], [], [], [], []
    rpn_op, rpn_term, rpn_const = [], [], []
    c2 = program.group_collections2 or (None,) * program.n_groups
    for g, grp in enumerate(program.groups):
        if grp.kind == GROUP_EXPR and _stack_depth(grp.rpn) > MAX_STACK:
            raise ValueError(
                f"expression group {g} needs a stack deeper than {MAX_STACK}"
            )
        n = len(grp.term_ids)
        same = int(program.group_collections[g] == c2[g])
        groups.append([grp.kind, len(term_ids), n, grp.min_count, grp.cmp_op,
                       same, len(rpn_op), len(grp.rpn)])
        term_ids.extend(grp.term_ids)
        ops.extend(list(grp.ops) + [0] * (n - len(grp.ops)))
        thrs.extend(list(grp.thrs) + [0.0] * (n - len(grp.thrs)))
        cmp_thrs.extend([grp.cmp_thr, grp.cmp_thr2])
        for op, arg in grp.rpn:
            rpn_op.append(op)
            rpn_term.append(int(arg) if op in (RPN_BRANCH, RPN_SUM) else 0)
            rpn_const.append(float(arg) if op == RPN_CONST else 0.0)
    segs_i = [np.asarray(groups, np.int64).reshape(-1), term_ids, ops, rpn_op, rpn_term]
    segs_f = [thrs, cmp_thrs, rpn_const]
    offsets, ints, floats = {}, [], []
    for name, seg in zip(("groups", "term_ids", "ops", "rpn_op", "rpn_term"), segs_i):
        offsets[name] = len(ints)
        ints.extend(int(x) for x in seg)
    for name, seg in zip(("thrs", "cmp_thrs", "rpn_const"), segs_f):
        offsets[name] = len(floats)
        floats.extend(float(x) for x in seg)
    return (
        np.asarray(ints + [0], np.int32),
        np.asarray(floats + [0.0], np.float32),
        offsets,
    )


def program_descriptor(program: Program, device: torch.device):
    """The program's descriptor arrays on ``device`` (cached)."""
    key = (program, str(device))
    desc = _DESCRIPTORS.get(key)
    if desc is None:
        ints, floats, offsets = flatten_program(program)
        desc = (
            torch.from_numpy(ints).to(device),
            torch.from_numpy(floats).to(device),
            offsets,
        )
        _DESCRIPTORS[key] = desc
    return desc


def _lib():
    lib = _build.load("skim_fused")
    fn = lib.skim_fused_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, ctypes.c_longlong, i, i,
                       p, p, p, p, p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _check(name, x, shape, device):
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"skim_fused: {name} must be contiguous float32")
    if tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(
            f"skim_fused: {name} has shape {tuple(x.shape)} on {x.device}, "
            f"expected {tuple(shape)} on {device}"
        )


def skim_fused(terms, valid, weights, payload, program: Program):
    """One-pass skim: (T,E,K),(G,E,K),(G,E,K),(E,D) float32 ->
    (packed (E, D) with the survivors' rows first and zeros after,
    count () int32).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version, :func:`repro_torch.kernels.ref.skim_fused_ref`.
    """
    global launches
    if not terms.is_cuda:
        return _ref.skim_fused_ref(terms, valid, weights, payload, program)
    device = terms.device
    T, E, K = terms.shape
    G = program.n_groups
    D = payload.shape[1]
    if T != program.n_terms:
        raise ValueError(f"skim_fused: {T} term planes for {program.n_terms} terms")
    _check("terms", terms, (T, E, K), device)
    _check("valid", valid, (G, E, K), device)
    _check("weights", weights, (G, E, K), device)
    _check("payload", payload, (E, D), device)
    if E == 0:
        return payload.clone(), torch.zeros((), dtype=torch.int32, device=device)
    out = torch.empty_like(payload)
    total = torch.empty(1, dtype=torch.int32, device=device)
    ints, floats, off = program_descriptor(program, device)
    words = torch.empty(-(-E // 32), dtype=torch.int32, device=device)
    tile_counts = torch.empty(-(-E // EVENT_TILE), dtype=torch.int32, device=device)

    def at(base, name):
        return ctypes.c_void_p(base.data_ptr() + 4 * off[name])

    p = _build.ptr
    with torch.cuda.device(device):
        rc = _lib().skim_fused_launch(
            p(terms), p(valid), p(weights), p(payload), T, G, E, K, D,
            at(ints, "groups"), at(ints, "term_ids"), at(ints, "ops"),
            at(floats, "thrs"), at(floats, "cmp_thrs"), at(ints, "rpn_op"),
            at(ints, "rpn_term"), at(floats, "rpn_const"),
            p(words), p(tile_counts), p(out), p(total),
            _build.stream_of(device),
        )
    _build.check_launch("skim_fused", rc)
    with _LAUNCHES_LOCK:
        launches += KERNELS_PER_CALL
    return out, total[0]


__all__ = [
    "EVENT_TILE",
    "KERNELS_PER_CALL",
    "flatten_program",
    "program_descriptor",
    "skim_fused",
]
