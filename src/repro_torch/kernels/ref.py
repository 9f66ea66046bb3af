"""Plain PyTorch versions of the hand-written kernels.

Each function here computes what its CUDA kernel computes, in ordinary
tensor ops on any device.  They are the CPU path of the kernel wrappers
(a wrapper takes them only for a tensor that lies on the CPU) and, on the
card, the oracle the kernels are held against by the tests and by
``chip_smoke.py``.  Nothing on the main path calls them when a card is
present.

The predicate decides every event as the host evaluator does
(``repro_torch.core.neardata.program_eval_np``, the staged semantics).
``kinds`` (one per term plane, then one per weights plane; all float32
when None) says what a plane holds (``program.KIND_*``): float32 values,
or an integer or bool branch's values as int32 bits.

* Per-object cuts (COUNT, HT's object cuts) compare a float32 value with
  the cut read in float32, as numpy compares a float32 column with a
  Python float, and an integer in float64, as numpy promotes an integer
  column beside a Python float (exact for every int32 and every cut
  below 2^53); ``abs`` is numpy's integer abs, which leaves the type's
  least value negative.
* An ANY term is nonzero, as the staged evaluator reads it as bool (NaN
  true, ±0 false), whatever the compiled op.
* Group values (MASS, ΔR, HT, EXPR) are evaluated in float64 from the
  planes widened exactly, in the host's operation order, and
  compared with the float64 cut: every operation but MASS's ``cos``,
  ``sin``, ``sinh`` and ``cosh`` is correctly rounded, so the value is the
  host's bit for bit.  On the CPU those four are numpy's own, so MASS is
  the host's too; on the card they are CUDA's, which may differ by a few
  ulp (the kernels' only residue against the host).
* Sums over the ``K`` object slots (HT, ``sum()``) run left to right,
  slot by slot, from +0.0: the host's ``bincount`` order.  ``torch.sum``
  reduces in another order.

Bit patterns are held as ``int64`` and masked to 32 bits after each step:
PyTorch has no ``uint32`` shifts on the CPU, and an ``int32`` right shift
is arithmetic, which would smear bit 31.
"""

from __future__ import annotations

import math

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
    KIND_F32,
    KIND_MIN,
    OP_ABSGT,
    OP_ABSLT,
    OP_EQ,
    OP_GE,
    OP_GT,
    OP_LE,
    OP_LT,
    OP_NE,
)

# ---------------------------------------------------------------------------
# predicate program
# ---------------------------------------------------------------------------


def _scalar(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a scalar of ``x``'s type on its device: read in float32
    beside a float32 plane (as numpy reads a Python float beside a float32
    column), exactly beside a float64 group value."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def apply_op(x: torch.Tensor, op_id: int, thr: float) -> torch.Tensor:
    t = _scalar(x, thr)
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


def _kind(kinds, i: int) -> int:
    return kinds[i] if kinds else KIND_F32


def plane_values(x: torch.Tensor, kind: int) -> torch.Tensor:
    """A term or weights plane's values in float64: float32 widened, an
    integer's int32 bits widened, both exactly."""
    return (x if kind == KIND_F32 else x.view(torch.int32)).to(torch.float64)


def term_cut(x: torch.Tensor, op_id: int, thr: float, kind: int) -> torch.Tensor:
    """A per-object cut on a term plane of ``kind``: :func:`apply_op` on
    float32, in float64 on an integer (abs first, as numpy's integer abs:
    the type's least value stays negative)."""
    if kind == KIND_F32:
        return apply_op(x, op_id, thr)
    v = x.view(torch.int32)
    if op_id in (OP_ABSLT, OP_ABSGT):
        a = torch.where(v == KIND_MIN.get(kind, 0), v, v.abs()).to(torch.float64)
        return apply_op(a, OP_LT if op_id == OP_ABSLT else OP_GT, thr)
    return apply_op(v.to(torch.float64), op_id, thr)


def nonzero(x: torch.Tensor, kind: int) -> torch.Tensor:
    """An ANY term: the value read as bool (NaN true, ±0 false)."""
    return (x if kind == KIND_F32 else x.view(torch.int32)) != 0


def slot_sum(x: torch.Tensor) -> torch.Tensor:
    """(E, K) -> (E,) sum in slot order from +0.0, in ``x``'s type (see
    the module note)."""
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k]
    return acc


def _unpack_validity(vg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mass/ΔR groups pack two collections' validity planes into one float
    channel: bit0 = first collection, bit1 = second (values 0..3)."""
    return torch.remainder(vg, 2.0) >= 1.0, vg >= 2.0


def _lead_slot(pt: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(E, K) float64 -> (E, 1) each event's leading valid slot, in the host
    evaluator's order (``core.expr._leading_indices``): pt descending,
    NaN after every number (-inf included), ties to the lower slot.  An
    event with no valid slot takes slot 0."""
    num = valid & ~torch.isnan(pt)
    top = torch.where(num, pt, float("-inf")).amax(dim=-1, keepdim=True)
    # the first valid number equal to the largest, else the first valid slot
    pick = torch.where(num.any(dim=-1, keepdim=True), num & (pt == top), valid)
    return torch.argmax(pick.to(torch.int8), dim=-1, keepdim=True)


def _pair_slots(pt_a, va, pt_b, vb, same: bool):
    """Leading-pair selection: (i1, i2, ok).  Same-collection pairs take
    the two leading objects of A; otherwise each collection's leading
    object.  ``ok`` marks events with a full pair."""
    i1 = _lead_slot(pt_a, va)
    if same:
        iota = torch.arange(va.shape[1], device=va.device)[None, :]
        i2 = _lead_slot(pt_a, va & (iota != i1))
        ok = va.sum(dim=-1) >= 2
    else:
        i2 = _lead_slot(pt_b, vb)
        ok = (va.sum(dim=-1) >= 1) & (vb.sum(dim=-1) >= 1)
    return i1, i2, ok


def _sel(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The slot ``idx`` of each event of a float64 plane."""
    return torch.gather(x, 1, idx)[:, 0]


def _unary(np_fn, torch_fn, x: torch.Tensor) -> torch.Tensor:
    """A float64 function as the host evaluator has it: numpy's own on a
    CPU tensor, PyTorch's (CUDA's) on the card.  numpy's ``cos``, ``sin``,
    ``sinh`` and ``cosh`` are not correctly rounded, so only the same
    function gives the same bits; PyTorch's CPU ``sqrt`` is not either."""
    if x.device.type == "cpu":
        return torch.from_numpy(np_fn(x.numpy()))
    return torch_fn(x)


def _p4(pt, eta, phi, mass):
    px = pt * _unary(np.cos, torch.cos, phi)
    py = pt * _unary(np.sin, torch.sin, phi)
    pz = pt * _unary(np.sinh, torch.sinh, eta)
    ch = _unary(np.cosh, torch.cosh, eta)
    e = _sqrt(mass * mass + pt * pt * ch * ch)
    return px, py, pz, e


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    return _unary(np.sqrt, torch.sqrt, x)


def _floor_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """numpy's ``remainder``: ``fmod``, moved by one period where its sign
    differs from the divisor's, and a zero with the divisor's sign.
    ``torch.remainder`` can return -0.0 where numpy returns +0.0."""
    r = torch.fmod(x, y)
    r = torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)
    return torch.where(r == 0, _scalar(r, math.copysign(0.0, y)), r)


def pair_group_value(program, g: int, terms, valid, kinds=None):
    """Invariant mass or ΔR of group ``g``'s leading pair -> (value, ok),
    the value in float64 as the host evaluator computes it
    (``core.expr.leading_pair_mass`` / ``leading_delta_r``).

    ``value`` is garbage where ``ok`` is False.  Exposed so a check can
    tell a disagreement at a cut's edge (transcendental rounding) from a
    real fault."""
    grp = program.groups[g]
    ids = grp.term_ids
    same = program.group_collections[g] == _coll2(program, g)
    va, vb = _unpack_validity(valid[g])
    half = len(ids) // 2
    x = {t: plane_values(terms[t], _kind(kinds, t)) for t in set(ids)}
    i1, i2, ok = _pair_slots(x[ids[0]], va, x[ids[half]], vb, same)
    if grp.kind == GROUP_MASS:
        px1, py1, pz1, e1 = _p4(*(_sel(x[i], i1) for i in ids[:4]))
        px2, py2, pz2, e2 = _p4(*(_sel(x[i], i2) for i in ids[4:]))
        m2 = (
            (e1 + e2) * (e1 + e2)
            - (px1 + px2) * (px1 + px2)
            - (py1 + py2) * (py1 + py2)
            - (pz1 + pz2) * (pz1 + pz2)
        )
        return _sqrt(torch.maximum(m2, torch.zeros_like(m2))), ok
    deta = _sel(x[ids[1]], i1) - _sel(x[ids[4]], i2)
    dphi = _floor_mod(
        _sel(x[ids[2]], i1) - _sel(x[ids[5]], i2) + math.pi, 2.0 * math.pi
    ) - math.pi
    return _sqrt(deta * deta + dphi * dphi), ok


def _np_minmax(a, b, take_a):
    """``np.minimum`` / ``np.maximum`` as the host evaluator has them: NaN
    if either is NaN, else ``a`` where ``take_a`` and ``b`` otherwise, so
    of two equal zeros the second wins.  ``torch.minimum`` returns the
    first on its scalar path and the second on its vector path."""
    nan = torch.isnan(a) | torch.isnan(b)
    return torch.where(nan, a + b, torch.where(take_a, a, b))


def _group_expr(grp, terms, kinds):
    """Stack-program evaluation over term slots in float64, the host's
    ``expr.eval_rpn`` walk: flat branches read slot 0, sum() reductions sum
    the zero-padded slots in slot order, constants are float64."""
    stack: list = []
    for op, arg in grp.rpn:
        if op == RPN_BRANCH:
            stack.append(plane_values(terms[int(arg)][:, 0], _kind(kinds, int(arg))))
        elif op == RPN_SUM:
            stack.append(slot_sum(plane_values(terms[int(arg)], _kind(kinds, int(arg)))))
        elif op == RPN_CONST:
            stack.append(torch.tensor(float(arg), dtype=torch.float64,
                                      device=terms.device))
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
                stack.append(_np_minmax(a, b, a < b))
            elif op == RPN_MAX:
                stack.append(_np_minmax(a, b, a > b))
            else:
                raise ValueError(f"unknown RPN op {op}")
    return apply_op(stack[-1].expand(terms.shape[1]), grp.cmp_op, grp.cmp_thr)


def _coll2(program, g: int):
    c2 = getattr(program, "group_collections2", ())
    return c2[g] if c2 else None


def predicate_mask(program, terms, valid, weights, kinds=None) -> torch.Tensor:
    """Evaluate a compiled predicate program.

    Args:
      terms:   (T, E, K) float32 — per-term padded values.
      valid:   (G, E, K) float32 — per-group object validity (mass/ΔR
               groups carry two packed planes, see ``_unpack_validity``).
      weights: (G, E, K) float32 — per-group HT weights (zeros if unused).
      kinds:   (T + G) plane kinds, the terms' then the weights' (see the
               module note); None: every plane float32.
    Returns: (E,) bool event mask.
    """
    E = terms.shape[1]
    T = program.n_terms
    mask = torch.ones(E, dtype=torch.bool, device=terms.device)
    for g, grp in enumerate(program.groups):
        if grp.kind == GROUP_ANY:
            gpass = torch.zeros(E, dtype=torch.bool, device=terms.device)
            for t in grp.term_ids:
                gpass = gpass | nonzero(terms[t, :, 0], _kind(kinds, t))
        elif grp.kind == GROUP_EXPR:
            gpass = _group_expr(grp, terms, kinds)
        elif grp.kind == GROUP_MASS:
            m, ok = pair_group_value(program, g, terms, valid, kinds)
            gpass = (
                ok & (m >= _scalar(m, grp.cmp_thr)) & (m <= _scalar(m, grp.cmp_thr2))
            )
        elif grp.kind == GROUP_DR:
            dr, ok = pair_group_value(program, g, terms, valid, kinds)
            gpass = ok & apply_op(dr, grp.cmp_op, grp.cmp_thr)
        else:
            obj = torch.ones(terms.shape[1:], dtype=torch.bool, device=terms.device)
            for t, op, thr in zip(grp.term_ids, grp.ops, grp.thrs):
                obj = obj & term_cut(terms[t], op, thr, _kind(kinds, t))
            obj = obj & (valid[g] > 0)
            if grp.kind == GROUP_COUNT:
                gpass = obj.sum(dim=-1) >= grp.min_count
            elif grp.kind == GROUP_HT:
                w = plane_values(weights[g], _kind(kinds, T + g))
                ht = slot_sum(w * obj.to(torch.float64))
                gpass = apply_op(ht, grp.cmp_op, grp.cmp_thr)
            else:
                raise ValueError(grp.kind)
        mask = mask & gpass
    return mask


def predicate_eval_ref(terms, valid, weights, program, kinds=None) -> torch.Tensor:
    """Alias of :func:`predicate_mask` under the JAX package's name, in
    its argument order: (T, E, K), (G, E, K), (G, E, K) -> (E,) bool."""
    return predicate_mask(program, terms, valid, weights, kinds)


def predicate_eval_batch_ref(terms, valid, weights, program, kinds=None) -> torch.Tensor:
    """:func:`predicate_mask` per window of a batch: terms (B, T, E, K),
    valid/weights (B, G, E, K) -> (B, E) int32.

    Every group is a function of its own event alone, so the windows are
    laid side by side as one (T, B*E, K) batch and evaluated in one call.
    """
    B, T, E, K = terms.shape
    G = valid.shape[1]

    def side_by_side(x, planes):
        return x.permute(1, 0, 2, 3).reshape(planes, B * E, K)

    mask = predicate_mask(
        program, side_by_side(terms, T), side_by_side(valid, G),
        side_by_side(weights, G), kinds,
    )
    return mask.reshape(B, E).to(torch.int32)


# ---------------------------------------------------------------------------
# bit-packed masks and the batched cascade stage
# ---------------------------------------------------------------------------

_SHIFTS = tuple(range(32))


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(B, E) bool, E a multiple of 32 -> (B, E/32) int32 words holding
    the uint32 bits (bit ``j`` of word ``w`` is event ``w*32 + j``)."""
    B, E = mask.shape
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=mask.device)
    bits = mask.reshape(B, E // 32, 32).to(torch.int64) << shifts
    return u32_to_i32(bits.sum(dim=-1))


def unpack_bits(words: torch.Tensor, E: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (B, W) int32 words -> (B, E) bool.
    The words are widened to int64 and masked first: an int32 right shift
    is arithmetic and would smear bit 31."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=words.device)
    bits = ((words.to(torch.int64) & _U32)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :E].to(torch.bool)


def cascade_stage_ref(terms, valid, weights, packed, seg_ids, program, nb: int,
                      kinds=None):
    """One batched cascade stage, the contract of the JAX package's
    ``ops._cascade_stage_impl``.

    ``terms`` (B,T,E,K) and ``valid``/``weights`` (B,G,E,K) are the staged
    window inputs; ``packed`` (B, E/32) int32 is the carried survivor mask;
    ``seg_ids`` (B, E) int32 maps each event slot to its window-local
    basket ordinal in [0, nb).  Returns ``(new_packed (B, E/32) int32,
    basket_alive (B, nb) int32, counts (B,) int32)``: the mask ANDed with
    the program, each basket's max of the new mask, each window's count.
    """
    E = terms.shape[2]
    alive = unpack_bits(packed, E) & (
        predicate_eval_batch_ref(terms, valid, weights, program, kinds) > 0
    )
    basket_alive = torch.zeros(
        (alive.shape[0], nb), dtype=torch.int32, device=alive.device
    ).scatter_reduce_(1, seg_ids.to(torch.int64), alive.to(torch.int32), "amax")
    counts = alive.sum(dim=1, dtype=torch.int32)
    return pack_bits(alive), basket_alive, counts


# ---------------------------------------------------------------------------
# stream compaction and the fused skim
# ---------------------------------------------------------------------------


# a payload element's bits as the signed integer of its width: the
# compactions below only move bits, and CPU torch lacks gathers and
# fills for some types (uint32, uint64) that it has for these
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(_BITS.get(x.element_size(), x.dtype))


def stream_compact_ref(payload: torch.Tensor, mask: torch.Tensor):
    """Pack rows of ``payload`` where ``mask`` is true to the front, in
    order, bit for bit.  Returns (packed (E, D) with survivors first then
    zeros, count () int32)."""
    idx = torch.nonzero(mask.to(torch.bool)).squeeze(1)
    bits = _bits(payload)
    packed = torch.zeros_like(bits)
    packed[: idx.numel()] = bits[idx]
    return (packed.view(payload.dtype),
            torch.tensor(idx.numel(), dtype=torch.int32, device=payload.device))


def skim_fused_ref(terms, valid, weights, payload, program, kinds=None):
    """The plain version of the fused kernel: predicate, then compaction."""
    return stream_compact_ref(payload,
                              predicate_mask(program, terms, valid, weights, kinds))


def skim_fused_batch_ref(terms, valid, weights, payload, program, kinds=None):
    """:func:`skim_fused_ref` per window of a batch: terms (B, T, E, K),
    valid/weights (B, G, E, K), payload (B, E, D) -> (packed (B, E, D)
    with each window's survivors first then zeros, counts (B,) int32)."""
    keep = predicate_eval_batch_ref(terms, valid, weights, program, kinds) > 0
    B, E, D = payload.shape
    # survivors first, each window in event order (a stable sort of ~keep)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    packed = torch.gather(_bits(payload), 1, order[:, :, None].expand(B, E, D))
    counts = keep.sum(dim=1, dtype=torch.int32)
    tail = torch.arange(E, device=payload.device)[None, :] >= counts[:, None]
    return packed.masked_fill_(tail[:, :, None], 0).view(payload.dtype), counts


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

NEG_INF = -1e30  # the reference's mask value (flash_attention.py NEG_INF)


def attention_scale(head_dim: int, sm_scale: float | None = None) -> float:
    """The float32 factor q is scaled by: ``sm_scale`` or 1/sqrt(D)."""
    scale = sm_scale if sm_scale is not None else 1.0 / np.sqrt(head_dim)
    return float(np.float32(scale))


def flash_attention_ref(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """(B, H, S, D) attention with the Pallas ``_attn_kernel``'s arithmetic
    in float32: q, k and v upcast, q scaled before the product, the logit
    of every key after the query's own position set to -1e30 when
    ``causal``, softmax with the denominator floored at 1e-30, the result
    cast to q's dtype."""
    scale = attention_scale(q.shape[-1], sm_scale)
    qf = q.to(torch.float32) * scale
    logits = qf @ k.to(torch.float32).transpose(-1, -2)
    if causal:
        S = q.shape[2]
        rows = torch.arange(S, device=q.device)
        logits = logits.masked_fill(rows[:, None] < rows[None, :], NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ v.to(torch.float32)) / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype)


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


def basket_decode_round_ref(descs, firsts, planes, out_nbytes: int):
    """The plain version of a decode round, over the kernel's flat layout.

    Args:
      descs:  (N, 8) int32 — per basket: plane-word offset, words per
              plane W, words between planes, n_bits, kind, output byte
              offset, store flags (bytes | 256 for a bool byte), values n
              (``repro_torch.kernels.basket_decode.descriptor``).
      firsts: (N,) int32 — first-value bit patterns.
      planes: (P,) int32 — the plane words the descriptors address.
      out_nbytes: the size of the round's output buffer.
    Returns: (out_nbytes,) uint8 — each basket's ``n`` values at its output
    offset, stored as the kernel stores them: 4 bytes (the 32-bit result),
    2 or 1 (its low bytes), or a bool byte (value != 0).  Bytes no basket
    owns are zero.
    """
    out = torch.zeros(out_nbytes, dtype=torch.uint8, device=planes.device)
    for i, (off, W, stride, n_bits, kind, out_off, store, n) in enumerate(
        descs.tolist()
    ):
        if n == 0 or W == 0:
            continue
        block = planes[off: off + n_bits * stride].reshape(n_bits, stride)
        dtype = torch.float32 if kind == 1 else torch.int32
        vals = basket_decode_ref(block[None, :, :W], firsts[i: i + 1], kind, n, dtype)
        bits = vals[0].view(torch.int32)
        nbytes = store & 0xFF
        if store & 0x100:
            stored = (bits != 0).to(torch.uint8)
        else:
            stored = bits.to({4: torch.int32, 2: torch.int16, 1: torch.int8}[nbytes])
        out[out_off: out_off + n * nbytes] = stored.view(torch.uint8)
    return out


__all__ = [
    "apply_op",
    "attention_scale",
    "basket_decode_ref",
    "basket_decode_round_ref",
    "cascade_stage_ref",
    "finish_decode",
    "flash_attention_ref",
    "nonzero",
    "pack_bits",
    "pair_group_value",
    "plane_values",
    "predicate_eval_batch_ref",
    "predicate_eval_ref",
    "predicate_mask",
    "skim_fused_batch_ref",
    "skim_fused_ref",
    "slot_sum",
    "stream_compact_ref",
    "term_cut",
    "unpack_bits",
]
