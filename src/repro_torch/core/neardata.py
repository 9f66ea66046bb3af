"""Near-data skimming on the card (DESIGN.md §2, §6).

The paper's placement insight — filter where the bytes live, ship only
survivors: each window evaluates the compiled predicate and compacts its
survivors on the device, and only the compacted survivor rows come back.

Device data layout: jagged collections are padded to a static ``K``
objects/event with a validity mask (built per window by
:func:`build_padded_inputs`), so the device path is dense tiles — what
the fused CUDA kernel reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import expr as xpr
from repro_torch.device import resolve_device
from repro_torch.kernels import program as kprog
from repro_torch.kernels.program import Program, compile_query


@dataclass
class PaddedBatch:
    """Dense device-side event batch for predicate evaluation."""

    terms: torch.Tensor  # (T, E, K) float32
    valid: torch.Tensor  # (G, E, K) float32
    weights: torch.Tensor  # (G, E, K) float32
    payload: torch.Tensor  # (E, D) float32 — output columns to compact
    n_events: int


def _scatter_jagged(out: np.ndarray, values: np.ndarray, counts: np.ndarray) -> None:
    """Write jagged values into a preallocated (E, K) dense view (in place;
    fully vectorized — this runs per window on the skim hot path)."""
    E, K = out.shape
    take = np.minimum(counts, K).astype(np.int64)
    if not (E and take.sum()):
        return
    offsets = np.concatenate([[0], np.cumsum(counts)])
    idx_event = np.repeat(np.arange(E), take)
    # slot index within each event: global ramp minus each event's base
    bases = np.concatenate([[0], np.cumsum(take)])[:-1]
    idx_slot = np.arange(take.sum()) - np.repeat(bases, take)
    src_idx = np.repeat(offsets[:-1], take) + idx_slot
    out[idx_event, idx_slot] = values[src_idx].astype(np.float32)


def _collection_validity(counts: np.ndarray, K: int) -> np.ndarray:
    """(E, K) validity: slot k live iff k < counts[e]."""
    take = np.minimum(counts, K)
    return (np.arange(K)[None, :] < take[:, None]).astype(np.float32)


def build_padded_inputs(
    data: dict[str, np.ndarray],
    program: Program,
    store,
    K: int = 8,
    payload_branches: list[str] | None = None,
    include_index: bool = False,
    to_device: bool = True,
    device=None,
) -> PaddedBatch:
    """Build dense kernel inputs from columnar (host) data.

    ``data`` is the decoded columnar dict (flat arrays; jagged values with
    their ``n<Coll>`` counts).  ``K`` caps objects/event (overflow objects
    are dropped from *filtering only* — counts-based cuts use true counts
    via validity, see below).

    ``include_index=True`` prepends a local-event-index column to the
    payload: after stream compaction the survivor rows carry their own
    source indices, so the host can reconstruct the boolean mask from the
    compacted output alone — the mask itself never has to leave the device
    (DESIGN.md §7).  float32 holds indices exactly up to 2**24 events,
    far above any window size.

    ``to_device=True`` returns tensors on ``device`` (the card unless the
    caller asks for the CPU); ``False`` keeps the numpy host buffers.
    """
    flat_names = [n for n in data if not (store.branches.get(n) and store.branches[n].jagged)]
    n_events = len(data[flat_names[0]])

    T = program.n_terms
    G = program.n_groups
    # preallocate and fill views in place: flat branches touch only slot 0
    # of their zero pages, jagged branches scatter exactly once — this is
    # the per-window hot path of the fused executor
    terms = np.zeros((T, n_events, K), np.float32)
    valid = np.zeros((G, n_events, K), np.float32)
    weights = np.zeros((G, n_events, K), np.float32)

    values_cache: dict[str, np.ndarray] = {}  # scatter each branch once

    def fill_values(target: np.ndarray, branch: str) -> None:
        if branch not in data:
            # absent trigger branch (menus differ across eras): the zero
            # page is constant-False under the ANY-group >= 0.5 test; the
            # planner guarantees every non-optional branch is present
            return
        br = store.branches.get(branch)
        if br is not None and br.jagged:
            if branch not in values_cache:
                _scatter_jagged(
                    target,
                    np.asarray(data[branch]),
                    np.asarray(data[br.counts_branch], dtype=np.int64),
                )
                values_cache[branch] = target
            else:
                np.copyto(target, values_cache[branch])
        else:
            target[:, 0] = np.asarray(data[branch], dtype=np.float32)

    validity_cache: dict[str, np.ndarray] = {}  # keyed by counts branch

    def validity_of(branch: str) -> np.ndarray:
        br = store.branches.get(branch)
        key = br.counts_branch if (br is not None and br.jagged) else ""
        if key not in validity_cache:
            if key:  # one validity per collection, shared by its branches
                validity_cache[key] = _collection_validity(
                    np.asarray(data[key], dtype=np.int64), K
                )
            else:  # flat branches live in slot 0 only
                v = np.zeros((n_events, K), np.float32)
                v[:, 0] = 1.0
                validity_cache[key] = v
        return validity_cache[key]

    for t, branch in enumerate(program.term_branches):
        fill_values(terms[t], branch)
    for g, grp in enumerate(program.groups):
        if grp.kind in (kprog.GROUP_MASS, kprog.GROUP_DR):
            # pair groups read two collections: pack both validity planes
            # into the one channel (bit0 = first, bit1 = second; a
            # same-collection pair encodes 3 everywhere it has objects)
            half = len(grp.term_ids) // 2
            first = program.term_branches[grp.term_ids[0]]
            second = program.term_branches[grp.term_ids[half]]
            valid[g] = validity_of(first) + 2.0 * validity_of(second)
            continue
        if grp.kind == kprog.GROUP_EXPR:
            # sum() reductions read the zero-padded object slots directly
            # (invalid slots are exactly 0.0) — no validity channel
            continue
        if grp.term_ids:
            anchor = program.term_branches[grp.term_ids[0]]
            valid[g] = validity_of(anchor)
        wbranch = program.group_weights[g]
        if wbranch is not None:
            fill_values(weights[g], wbranch)

    payload_branches = payload_branches or []
    pay_cols = []
    if include_index:
        if n_events >= 1 << 24:
            raise ValueError("window too large for exact float32 index payload")
        pay_cols.append(np.arange(n_events, dtype=np.float32))
    pay_cols.extend(np.asarray(data[b], dtype=np.float32) for b in payload_branches)
    if pay_cols:
        payload = np.stack(pay_cols, axis=1)
    else:
        payload = np.zeros((n_events, 1), np.float32)

    if not to_device:
        # host staging: the caller pads or places windows and ships once
        return PaddedBatch(
            terms=terms, valid=valid, weights=weights,
            payload=payload, n_events=n_events,
        )
    device = resolve_device(device)
    return PaddedBatch(
        terms=torch.from_numpy(terms).to(device),
        valid=torch.from_numpy(valid).to(device),
        weights=torch.from_numpy(weights).to(device),
        payload=torch.from_numpy(payload).to(device),
        n_events=n_events,
    )


# numpy mirror of kernels.ref.apply_op, keyed by the compiled op ids
_NP_OPS = {
    kprog.OP_GT: np.greater,
    kprog.OP_GE: np.greater_equal,
    kprog.OP_LT: np.less,
    kprog.OP_LE: np.less_equal,
    kprog.OP_EQ: np.equal,
    kprog.OP_NE: np.not_equal,
    kprog.OP_ABSLT: lambda x, v: np.abs(x) < v,
    kprog.OP_ABSGT: lambda x, v: np.abs(x) > v,
}


def program_eval_np(
    data: dict[str, np.ndarray], program: Program, n_events: int
) -> np.ndarray:
    """Host interpreter for a compiled :class:`Program` over the *jagged*
    columnar layout (no padding).

    This is the fused executor's CPU fallback: one pass over the compiled
    groups, semantically identical to ``repro_torch.core.query.eval_stage`` run
    over every stage (same float64 segment accumulation, so masks are
    bit-identical to the reference path) and to the device kernels modulo
    their float32 reductions.  On jagged data it skips the (T, E, K)
    densification entirely, which is what makes ``fused=True`` at least
    as fast as the staged evaluator on backends without a real
    accelerator.
    """
    mask = np.ones(n_events, dtype=bool)
    for g, grp in enumerate(program.groups):
        coll = program.group_collections[g]
        if grp.kind == kprog.GROUP_ANY:
            gpass = np.zeros(n_events, dtype=bool)
            for t, op, thr in zip(grp.term_ids, grp.ops, grp.thrs):
                arr = data.get(program.term_branches[t])
                if arr is None:
                    continue  # absent trigger branch: constant-False
                gpass |= np.asarray(_NP_OPS[op](arr, thr), dtype=bool)
        elif grp.kind == kprog.GROUP_MASS:
            m, ok = xpr.leading_pair_mass(
                data, coll, program.group_collections2[g]
            )
            gpass = ok & (m >= grp.cmp_thr) & (m <= grp.cmp_thr2)
        elif grp.kind == kprog.GROUP_DR:
            dr, ok = xpr.leading_delta_r(
                data, coll, program.group_collections2[g]
            )
            gpass = ok & np.asarray(
                _NP_OPS[grp.cmp_op](dr, grp.cmp_thr), dtype=bool
            )
        elif grp.kind == kprog.GROUP_EXPR:
            # same stack walk as the staged evaluator (expr.eval_rpn), with
            # term slots resolved back to branch names — bit-identical to
            # eval_node by construction
            def resolve(op, slot):
                name = program.term_branches[int(slot)]
                if op == xpr.RPN_BRANCH:
                    return np.asarray(data[name], dtype=np.float64)
                counts = np.asarray(
                    data[xpr.counts_name(name)], dtype=np.int64
                )
                return np.bincount(
                    np.repeat(np.arange(n_events), counts),
                    weights=np.asarray(data[name], dtype=np.float64),
                    minlength=n_events,
                )

            val = xpr.eval_rpn(grp.rpn, resolve)
            gpass = np.asarray(
                _NP_OPS[grp.cmp_op](val, grp.cmp_thr), dtype=bool
            )
        elif coll is None:
            # flat-branch cut compiled as a one-term COUNT group
            t, op, thr = grp.term_ids[0], grp.ops[0], grp.thrs[0]
            passing = np.asarray(
                _NP_OPS[op](data[program.term_branches[t]], thr), dtype=bool
            )
            gpass = passing.astype(np.int64) >= grp.min_count
        else:
            counts = np.asarray(data[f"n{coll}"], dtype=np.int64)
            ids = np.repeat(np.arange(n_events), counts)
            passing = np.ones(int(counts.sum()), dtype=bool)
            for t, op, thr in zip(grp.term_ids, grp.ops, grp.thrs):
                passing &= np.asarray(
                    _NP_OPS[op](data[program.term_branches[t]], thr), dtype=bool
                )
            if grp.kind == kprog.GROUP_COUNT:
                # integer accumulation — exact counts, matching both the
                # staged evaluator and the device kernels' int32 path
                per_event = np.bincount(ids[passing], minlength=n_events)
                gpass = per_event >= grp.min_count
            else:  # GROUP_HT
                w = np.asarray(data[program.group_weights[g]], dtype=np.float64)
                ht = np.bincount(ids, weights=w * passing, minlength=n_events)
                gpass = np.asarray(
                    _NP_OPS[grp.cmp_op](ht, grp.cmp_thr), dtype=bool
                )
        mask &= gpass
    return mask


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def window_pad_K(data: dict[str, np.ndarray], program: Program, store) -> int:
    """Smallest pow2 object capacity that loses no object of any jagged
    branch the program reads — guarantees the padded device evaluation is
    bit-identical to the host evaluator (no overflow truncation)."""
    K = 1
    seen: set[str] = set()
    branches = set(program.term_branches) | {
        w for w in program.group_weights if w is not None
    }
    for name in branches:
        br = store.branches.get(name)
        if br is None or not br.jagged or br.counts_branch in seen:
            continue
        seen.add(br.counts_branch)
        counts = np.asarray(data[br.counts_branch])
        if len(counts):
            K = max(K, int(counts.max()))
    return _next_pow2(K)


_WINDOW_QUANTUM = 512  # event-axis padding multiple (fused kernel tile)


def pad_window(pb: PaddedBatch, pad_to: int | None = None) -> tuple[np.ndarray, ...]:
    """A host-staged window's (terms, valid, weights, payload), padded on
    the event axis to a multiple of the kernel's tile, at least ``pad_to``
    events.  Padding events are zero, with indices from ``n_events`` up in
    payload column 0: phantom survivors the caller drops by index."""
    arrays = (pb.terms, pb.valid, pb.weights, pb.payload)
    E = pb.n_events
    target = -(-max(E, pad_to or E) // _WINDOW_QUANTUM) * _WINDOW_QUANTUM
    pad = target - E
    if pad <= 0:
        return arrays
    terms, valid, weights = (
        np.pad(x, ((0, 0), (0, pad), (0, 0))) for x in arrays[:3]
    )
    payload = np.pad(pb.payload, ((0, pad), (0, 0)))
    payload[E:, 0] = np.arange(E, target, dtype=np.float32)
    return terms, valid, weights, payload


def fused_window_skim(
    data: dict[str, np.ndarray],
    program: Program,
    store,
    payload_branches: list[str] | tuple[str, ...] = (),
    K: int | None = None,
    pad_to: int | None = None,
    backend: str | None = None,
    decision: str = "scan",
    device=None,
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """One-pass skim of a decoded window (the engine's fused path).

    Evaluates the compiled predicate AND compacts the survivor payload in
    a single pass over the window, on the best executor for the backend:

      * ``"cuda"``  — the fused CUDA kernel (``kernels.skim_fused``): pad
        the window once, then predicate + ballot/scan compaction per
        512-event tile.  Default on the card.
      * ``"torch"`` — the kernel's plain PyTorch version over the same
        padded layout, on ``device`` (validation).
      * ``"host"``  — the compiled-program interpreter over the native
        jagged layout (:func:`program_eval_np`); skips densification.
        Default on the CPU.

    All three produce bit-identical survivor sets on the repo fixtures
    (pinned by tests/test_torch_engine.py).  Returns the boolean
    survivor mask and the compacted payload columns (survivor-only, event
    order).

    ``pad_to`` fixes the padded event-axis shape (e.g. to the engine's
    window size) so every window of a skim has the same shape.
    Padding events get index >= n_events in the payload index column and
    are dropped after compaction, so a predicate that happens to accept
    an all-zero event (e.g. ``HT < x``) cannot leak phantom survivors.

    ``decision`` is the window's zone-map classification (DESIGN.md §9):
    ``"accept_all"`` skips predicate evaluation entirely — every event
    provably survives, so the payload columns pass through whole (payload
    branches are flat float32 by the planner's contract, hence identical
    to ``arr[all-true mask]``).  ``"scan"`` (default) runs the normal
    fused evaluation.  Pruned windows never reach this function: their
    data is never fetched, let alone decoded.
    """
    flat = next(
        n for n in data if not (store.branches.get(n) and store.branches[n].jagged)
    )
    E = len(data[flat])

    if decision == "accept_all":
        mask = np.ones(E, dtype=bool)
        return mask, {n: np.asarray(data[n]) for n in payload_branches}

    from repro_torch.kernels import ops

    if backend is None:
        backend = "cuda" if resolve_device(device).type == "cuda" else "host"

    if backend == "host":
        mask = program_eval_np(data, program, E)
        cols = {
            name: np.asarray(data[name])[mask] for name in payload_branches
        }
        return mask, cols
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown fused backend {backend!r}")
    device = resolve_device(device)
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("fused backend 'cuda' needs a CUDA device")

    if K is None:
        K = window_pad_K(data, program, store)
    pb = build_padded_inputs(
        data, program, store, K=K,
        payload_branches=list(payload_branches), include_index=True,
        to_device=False,
    )
    arrays = pad_window(pb, pad_to)
    packed, count = ops.fused_skim(
        *(torch.from_numpy(x).to(device) for x in arrays),
        program, use_kernel=(backend == "cuda"),
    )
    k = int(count)
    packed = packed[:k].cpu().numpy()
    idx = packed[:, 0].astype(np.int64)
    real = idx < E  # drop phantom survivors from event-axis padding
    packed, idx = packed[real], idx[real]
    mask = np.zeros(E, dtype=bool)
    mask[idx] = True
    cols = {
        name: packed[:, 1 + j].astype(
            store.branches[name].np_dtype() if name in store.branches else np.float32
        )
        for j, name in enumerate(payload_branches)
    }
    return mask, cols


__all__ = [
    "PaddedBatch",
    "Program",
    "compile_query",
    "build_padded_inputs",
    "program_eval_np",
    "fused_window_skim",
    "pad_window",
    "window_pad_K",
]
