"""Plain PyTorch versions of the hand-written kernels.

Each function here computes what its CUDA kernel computes, in ordinary
tensor ops on any device.  They are the CPU path of the kernel wrappers
(a wrapper takes them only for a tensor that lies on the CPU) and, on the
card, the oracle the kernels are held against by the tests and by
``chip_smoke.py``.  Nothing on the main path calls them when a card is
present.

Two rules keep them bit-identical to the JAX package's ``kernels/ref.py``:

* Sums over the ``K`` object slots run left to right, slot by slot.
  ``torch.sum`` reduces in another order and can flip an HT or ``sum()``
  cut at its edge; XLA on the CPU sums in slot order, and so do the loops
  below and the CUDA kernel.
* Bit patterns are held as ``int64`` and masked to 32 bits after each
  step: PyTorch has no ``uint32`` shifts on the CPU, and an ``int32``
  right shift is arithmetic, which would smear bit 31.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.expr import (
    RPN_ABS,
    RPN_ADD,
    RPN_BRANCH,
    RPN_CONST,
    RPN_DIV,
    RPN_MAX,
    RPN_MIN,
    RPN_MUL,
    RPN_NEG,
    RPN_SUB,
    RPN_SUM,
)
from repro_torch.kernels.program import (
    GROUP_ANY,
    GROUP_COUNT,
    GROUP_DR,
    GROUP_EXPR,
    GROUP_HT,
    GROUP_MASS,
    OP_ABSGT,
    OP_ABSLT,
    OP_EQ,
    OP_GE,
    OP_GT,
    OP_LE,
    OP_LT,
    OP_NE,
)

# float32(pi), as the JAX oracle's ``jnp.float32(np.pi)``
PI_F32 = float(np.float32(np.pi))

# ---------------------------------------------------------------------------
# predicate program
# ---------------------------------------------------------------------------


def _f32(x: torch.Tensor, value: float) -> torch.Tensor:
    """A float32 scalar on ``x``'s device (comparisons and arithmetic with
    it stay in float32, as JAX's weakly typed Python floats do)."""
    return torch.tensor(value, dtype=torch.float32, device=x.device)


def apply_op(x: torch.Tensor, op_id: int, thr: float) -> torch.Tensor:
    t = _f32(x, thr)
    if op_id == OP_GT:
        return x > t
    if op_id == OP_GE:
        return x >= t
    if op_id == OP_LT:
        return x < t
    if op_id == OP_LE:
        return x <= t
    if op_id == OP_EQ:
        return x == t
    if op_id == OP_NE:
        return x != t
    if op_id == OP_ABSLT:
        return torch.abs(x) < t
    if op_id == OP_ABSGT:
        return torch.abs(x) > t
    raise ValueError(op_id)


def slot_sum(x: torch.Tensor) -> torch.Tensor:
    """(E, K) -> (E,) float32 sum in slot order (see the module note)."""
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k]
    return acc


def _unpack_validity(vg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mass/ΔR groups pack two collections' validity planes into one float
    channel: bit0 = first collection, bit1 = second (values 0..3)."""
    return torch.remainder(vg, 2.0) >= 1.0, vg >= 2.0


def _lead_slot(masked_pt: torch.Tensor) -> torch.Tensor:
    """(E, K) -> (E, 1) index of each event's first maximal slot."""
    return torch.argmax(masked_pt, dim=-1, keepdim=True)


def _pair_slots(pt_a, va, pt_b, vb, same: bool):
    """Leading-pair selection: (i1, i2, ok).  Same-collection pairs take
    the two highest-pt objects of A; otherwise each collection's leading
    object.  ``ok`` marks events with a full pair."""
    neg = torch.full_like(pt_a, float("-inf"))
    ma = torch.where(va, pt_a, neg)
    i1 = _lead_slot(ma)
    if same:
        iota = torch.arange(ma.shape[1], device=ma.device)[None, :]
        i2 = _lead_slot(torch.where(iota == i1, neg, ma))
        ok = va.sum(dim=-1) >= 2
    else:
        i2 = _lead_slot(torch.where(vb, pt_b, neg))
        ok = (va.sum(dim=-1) >= 1) & (vb.sum(dim=-1) >= 1)
    return i1, i2, ok


def _sel(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx)[:, 0]


def _p4(pt, eta, phi, mass):
    px = pt * torch.cos(phi)
    py = pt * torch.sin(phi)
    pz = pt * torch.sinh(eta)
    ch = torch.cosh(eta)
    e = torch.sqrt(mass * mass + pt * pt * ch * ch)
    return px, py, pz, e


def pair_group_value(program, g: int, terms, valid):
    """Invariant mass or ΔR of group ``g``'s leading pair -> (value, ok).

    ``value`` is garbage where ``ok`` is False.  Exposed so a check can
    tell a disagreement at a cut's edge (transcendental rounding) from a
    real fault."""
    grp = program.groups[g]
    ids = grp.term_ids
    same = program.group_collections[g] == _coll2(program, g)
    va, vb = _unpack_validity(valid[g])
    half = len(ids) // 2
    i1, i2, ok = _pair_slots(terms[ids[0]], va, terms[ids[half]], vb, same)
    if grp.kind == GROUP_MASS:
        px1, py1, pz1, e1 = _p4(*(_sel(terms[i], i1) for i in ids[:4]))
        px2, py2, pz2, e2 = _p4(*(_sel(terms[i], i2) for i in ids[4:]))
        m2 = (
            (e1 + e2) * (e1 + e2)
            - (px1 + px2) * (px1 + px2)
            - (py1 + py2) * (py1 + py2)
            - (pz1 + pz2) * (pz1 + pz2)
        )
        return torch.sqrt(torch.maximum(m2, torch.zeros_like(m2))), ok
    deta = _sel(terms[ids[1]], i1) - _sel(terms[ids[4]], i2)
    pi = _f32(deta, PI_F32)
    dphi = torch.remainder(
        _sel(terms[ids[2]], i1) - _sel(terms[ids[5]], i2) + pi, 2.0 * pi
    ) - pi
    return torch.sqrt(deta * deta + dphi * dphi), ok


def _group_expr(grp, terms):
    """Stack-program evaluation over term slots: flat branches read slot 0,
    sum() reductions sum the zero-padded slots in slot order."""
    stack: list = []
    for op, arg in grp.rpn:
        if op == RPN_BRANCH:
            stack.append(terms[int(arg)][:, 0])
        elif op == RPN_SUM:
            stack.append(slot_sum(terms[int(arg)]))
        elif op == RPN_CONST:
            stack.append(_f32(terms, float(arg)))
        elif op == RPN_NEG:
            stack.append(-stack.pop())
        elif op == RPN_ABS:
            stack.append(torch.abs(stack.pop()))
        else:
            b = stack.pop()
            a = stack.pop()
            if op == RPN_ADD:
                stack.append(a + b)
            elif op == RPN_SUB:
                stack.append(a - b)
            elif op == RPN_MUL:
                stack.append(a * b)
            elif op == RPN_DIV:
                stack.append(a / b)
            elif op == RPN_MIN:
                stack.append(torch.minimum(a, b))
            elif op == RPN_MAX:
                stack.append(torch.maximum(a, b))
            else:
                raise ValueError(f"unknown RPN op {op}")
    return apply_op(stack[-1].expand(terms.shape[1]), grp.cmp_op, grp.cmp_thr)


def _coll2(program, g: int):
    c2 = getattr(program, "group_collections2", ())
    return c2[g] if c2 else None


def predicate_mask(program, terms, valid, weights) -> torch.Tensor:
    """Evaluate a compiled predicate program.

    Args:
      terms:   (T, E, K) float32 — per-term padded values.
      valid:   (G, E, K) float32 — per-group object validity (mass/ΔR
               groups carry two packed planes, see ``_unpack_validity``).
      weights: (G, E, K) float32 — per-group HT weights (zeros if unused).
    Returns: (E,) bool event mask.
    """
    E = terms.shape[1]
    mask = torch.ones(E, dtype=torch.bool, device=terms.device)
    for g, grp in enumerate(program.groups):
        if grp.kind == GROUP_ANY:
            gpass = torch.zeros(E, dtype=torch.bool, device=terms.device)
            for t, op, thr in zip(grp.term_ids, grp.ops, grp.thrs):
                gpass = gpass | apply_op(terms[t, :, 0], op, thr)
        elif grp.kind == GROUP_EXPR:
            gpass = _group_expr(grp, terms)
        elif grp.kind == GROUP_MASS:
            m, ok = pair_group_value(program, g, terms, valid)
            gpass = (
                ok & (m >= _f32(m, grp.cmp_thr)) & (m <= _f32(m, grp.cmp_thr2))
            )
        elif grp.kind == GROUP_DR:
            dr, ok = pair_group_value(program, g, terms, valid)
            gpass = ok & apply_op(dr, grp.cmp_op, grp.cmp_thr)
        else:
            obj = torch.ones(terms.shape[1:], dtype=torch.bool, device=terms.device)
            for t, op, thr in zip(grp.term_ids, grp.ops, grp.thrs):
                obj = obj & apply_op(terms[t], op, thr)
            obj = obj & (valid[g] > 0)
            if grp.kind == GROUP_COUNT:
                gpass = obj.sum(dim=-1) >= grp.min_count
            elif grp.kind == GROUP_HT:
                ht = slot_sum(weights[g] * obj.to(torch.float32))
                gpass = apply_op(ht, grp.cmp_op, grp.cmp_thr)
            else:
                raise ValueError(grp.kind)
        mask = mask & gpass
    return mask


# ---------------------------------------------------------------------------
# stream compaction and the fused skim
# ---------------------------------------------------------------------------


def stream_compact_ref(payload: torch.Tensor, mask: torch.Tensor):
    """Pack rows of ``payload`` where ``mask`` is true to the front, in
    order.  Returns (packed (E, D) with survivors first then zeros,
    count () int32)."""
    idx = torch.nonzero(mask.to(torch.bool)).squeeze(1)
    packed = torch.zeros_like(payload)
    packed[: idx.numel()] = payload[idx]
    return packed, torch.tensor(idx.numel(), dtype=torch.int32, device=payload.device)


def skim_fused_ref(terms, valid, weights, payload, program):
    """The plain version of the fused kernel: predicate, then compaction."""
    return stream_compact_ref(payload, predicate_mask(program, terms, valid, weights))


# ---------------------------------------------------------------------------
# basket_decode
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2**32) -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def finish_decode(bits: torch.Tensor, kind: int, out_dtype) -> torch.Tensor:
    """int32 bit patterns -> values of ``out_dtype``: a float kind is
    reinterpreted, never passed through a float op (-0.0 and NaN payloads
    keep their bits)."""
    if kind == 1:
        return bits.view(torch.float32).to(out_dtype)
    return bits.to(out_dtype)


def basket_decode_ref(planes, firsts, kind: int, n_values: int, out_dtype):
    """Decode a batch of bit-plane baskets.

    Args:
      planes: (N, B, W) int32 — B bit-planes of W words per basket, as
              the uint32 words' bit patterns (planes above a basket's true
              bit width are zero).
      firsts: (N,) int32 — first raw value (bit pattern).
      kind:   0 int-delta, 1 float-xor, 2 bool.
      n_values: values per basket (W*32 >= n_values).
    Returns: (N, n_values) tensor of ``out_dtype``.
    """
    N, B, W = planes.shape
    words = planes.to(torch.int64) & _U32
    shifts = torch.arange(32, dtype=torch.int64, device=planes.device)
    codes = torch.zeros((N, W * 32), dtype=torch.int64, device=planes.device)
    for j in range(B):
        bits = (words[:, j, :, None] >> shifts[None, None, :]) & 1
        codes = codes | (bits.reshape(N, W * 32) << j)
    codes = codes[:, :n_values]
    first = firsts.to(torch.int64) & _U32
    if kind == 2:  # bool
        return finish_decode(u32_to_i32(codes), kind, out_dtype)
    if kind == 0:  # zigzag delta + wrap-exact int32 prefix sum
        dec = ((codes >> 1) ^ -(codes & 1)) & _U32
        dec[:, 0] = first
        acc = torch.cumsum(dec, dim=1) & _U32
        return finish_decode(u32_to_i32(acc), kind, out_dtype)
    if kind == 1:  # prefix xor (log-step scan), then reinterpret as f32
        acc = codes.clone()
        acc[:, 0] = first
        shift = 1
        while shift < acc.shape[1]:
            shifted = torch.zeros_like(acc)
            shifted[:, shift:] = acc[:, :-shift]
            acc = acc ^ shifted
            shift *= 2
        return finish_decode(u32_to_i32(acc), kind, out_dtype)
    raise ValueError(kind)


__all__ = [
    "apply_op",
    "basket_decode_ref",
    "finish_decode",
    "pair_group_value",
    "predicate_mask",
    "skim_fused_ref",
    "slot_sum",
    "stream_compact_ref",
]
