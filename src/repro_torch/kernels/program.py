"""The compiled predicate program: the IR both device kernels evaluate.

A query's selection is lowered to a frozen :class:`Program` — ``T`` term
slots (each fed by one branch) combined by ``G`` AND-ed groups.  The
program is plain data: the CUDA kernel reads it as small descriptor
arrays (``repro_torch.kernels.skim_fused``), the plain PyTorch version
and the host interpreter walk it in Python.

Field for field the same dataclasses as the JAX package's
``Group``/``Program``, so ``dataclasses.astuple`` of the two compiled
programs compares equal and :func:`program_from_fields` carries a
program across.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.expr import KINEMATIC_VARS, RPN_BRANCH, RPN_SUM

OP_GT, OP_GE, OP_LT, OP_LE, OP_EQ, OP_NE, OP_ABSLT, OP_ABSGT = range(8)

OP_IDS = {
    ">": OP_GT,
    ">=": OP_GE,
    "<": OP_LT,
    "<=": OP_LE,
    "==": OP_EQ,
    "!=": OP_NE,
    "abs<": OP_ABSLT,
    "abs>": OP_ABSGT,
}

GROUP_COUNT = 0  # count of objects passing all terms >= min_count
GROUP_HT = 1  # sum(weight * passing) cmp threshold
GROUP_ANY = 2  # OR over terms, each read as bool: nonzero (NaN true, ±0 false)
GROUP_MASS = 3  # leading-pair invariant mass inside [cmp_thr, cmp_thr2]
GROUP_DR = 4  # leading-pair ΔR cmp threshold
GROUP_EXPR = 5  # arithmetic stack program (Group.rpn) cmp threshold

# What a term or weights plane holds (csrc/predicate.cuh KIND_*): float32
# values, or an integer or bool branch's values widened exactly to int32
# and kept as their bits.  The kernels compare an integer in float64, as
# numpy promotes an integer column beside a Python float, and take
# numpy's integer abs, which leaves the type's least value negative: the
# kind names the type for that.  Kinds are not part of the program: they
# come from the store (``repro_torch.core.neardata.program_kinds``).
KIND_F32, KIND_I32, KIND_I16, KIND_I8, KIND_UINT = range(5)
_KINDS = {np.dtype(np.int32): KIND_I32, np.dtype(np.int16): KIND_I16,
          np.dtype(np.int8): KIND_I8, np.dtype(np.uint16): KIND_UINT,
          np.dtype(np.uint8): KIND_UINT, np.dtype(np.bool_): KIND_UINT}
# the least value of each integer kind, which numpy's abs leaves as it is
KIND_MIN = {KIND_I32: -(1 << 31), KIND_I16: -(1 << 15), KIND_I8: -(1 << 7)}


def value_kind(dtype) -> int:
    """The plane kind of a branch of numpy type ``dtype``: an integer or
    bool type int32 holds exactly, else float32 (the planes' type)."""
    return _KINDS.get(np.dtype(dtype), KIND_F32)


@dataclass(frozen=True)
class Group:
    kind: int  # GROUP_COUNT / GROUP_HT / GROUP_ANY / GROUP_MASS / ...
    term_ids: tuple[int, ...]
    ops: tuple[int, ...]
    thrs: tuple[float, ...]
    min_count: int = 1
    cmp_op: int = 0
    cmp_thr: float = 0.0
    cmp_thr2: float = 0.0  # mass window upper bound (GROUP_MASS)
    rpn: tuple = ()  # GROUP_EXPR stack program, term-slot operands


@dataclass(frozen=True)
class Program:
    """Static predicate program: ``T`` terms over ``G`` AND-ed groups."""

    groups: tuple[Group, ...]
    term_branches: tuple[str, ...]  # branch feeding each term slot
    group_collections: tuple[str | None, ...]  # validity source per group
    group_weights: tuple[str | None, ...]  # HT weight branch per group
    # second collection of mass/ΔR pair groups (None elsewhere); default ()
    # keeps hand-built three-field programs valid
    group_collections2: tuple = ()

    @property
    def n_terms(self) -> int:
        return len(self.term_branches)

    @property
    def n_groups(self) -> int:
        return len(self.groups)


def program_from_fields(fields: tuple) -> Program:
    """Rebuild a :class:`Program` from ``dataclasses.astuple`` of a
    program (this package's or the JAX package's: the fields are the
    same), so one compiled program can feed both packages' kernels."""
    groups, *rest = fields
    return Program(tuple(Group(*g) for g in groups), *rest)


def compile_query(query) -> Program:
    """Lower a :class:`repro_torch.core.query.Query` to a :class:`Program`.

    Compilation is store-independent: trigger branches absent from a
    store evaluate as constant-False at ingest (zero term pages), not
    here.
    """
    from repro_torch.core.query import (
        AnyOf,
        Cut,
        DeltaRCut,
        ExprCut,
        HTCut,
        MassWindow,
        ObjectSelection,
    )

    term_branches: list[str] = []
    groups: list[Group] = []
    group_colls: list[str | None] = []
    group_colls2: list[str | None] = []
    group_weights: list[str | None] = []

    def add_term(branch: str) -> int:
        term_branches.append(branch)
        return len(term_branches) - 1

    def add_group(group: Group, coll=None, coll2=None, weight=None) -> None:
        groups.append(group)
        group_colls.append(coll)
        group_colls2.append(coll2)
        group_weights.append(weight)

    for _, stage in query.stages():
        for node in stage:
            if isinstance(node, Cut):
                t = add_term(node.branch)
                add_group(
                    Group(GROUP_COUNT, (t,), (OP_IDS[node.op],), (float(node.value),))
                )
            elif isinstance(node, AnyOf):
                # the JAX package's fields; every evaluator reads an ANY
                # term as nonzero, as the staged evaluator reads it as bool
                ids = tuple(add_term(n) for n in node.names)
                add_group(
                    Group(GROUP_ANY, ids, (OP_IDS[">="],) * len(ids), (0.5,) * len(ids))
                )
            elif isinstance(node, ObjectSelection):
                ids, ops, thrs = [], [], []
                for c in node.cuts:
                    ids.append(add_term(f"{node.collection}_{c.var}"))
                    ops.append(OP_IDS[c.op])
                    thrs.append(float(c.value))
                add_group(
                    Group(
                        GROUP_COUNT,
                        tuple(ids),
                        tuple(ops),
                        tuple(thrs),
                        min_count=node.min_count,
                    ),
                    coll=node.collection,
                )
            elif isinstance(node, HTCut):
                ids, ops, thrs = [], [], []
                for c in node.object_cuts:
                    ids.append(add_term(f"{node.collection}_{c.var}"))
                    ops.append(OP_IDS[c.op])
                    thrs.append(float(c.value))
                if not ids:  # unconditioned HT still needs a term for shape
                    ids.append(add_term(f"{node.collection}_{node.var}"))
                    ops.append(OP_IDS[">="])
                    thrs.append(-math.inf)
                add_group(
                    Group(
                        GROUP_HT,
                        tuple(ids),
                        tuple(ops),
                        tuple(thrs),
                        cmp_op=OP_IDS[node.op],
                        cmp_thr=float(node.value),
                    ),
                    coll=node.collection,
                    weight=f"{node.collection}_{node.var}",
                )
            elif isinstance(node, MassWindow):
                a, b = node.collections
                ids = tuple(
                    add_term(f"{c}_{v}")
                    for c in (a, b)
                    for v in KINEMATIC_VARS["mass"]
                )
                add_group(
                    Group(
                        GROUP_MASS, ids, (), (),
                        cmp_thr=float(node.lo), cmp_thr2=float(node.hi),
                    ),
                    coll=a, coll2=b,
                )
            elif isinstance(node, DeltaRCut):
                a, b = node.collections
                ids = tuple(
                    add_term(f"{c}_{v}")
                    for c in (a, b)
                    for v in KINEMATIC_VARS["deltaR"]
                )
                add_group(
                    Group(
                        GROUP_DR, ids, (), (),
                        cmp_op=OP_IDS[node.op], cmp_thr=float(node.value),
                    ),
                    coll=a, coll2=b,
                )
            elif isinstance(node, ExprCut):
                # rewrite branch-name operands to term slots; sums read the
                # zero-padded object slots, flat refs read slot 0
                rpn = []
                ids = []
                for op, arg in node.rpn:
                    if op in (RPN_BRANCH, RPN_SUM):
                        t = add_term(str(arg))
                        ids.append(t)
                        rpn.append((op, t))
                    else:
                        rpn.append((op, arg))
                add_group(
                    Group(
                        GROUP_EXPR, tuple(ids), (), (),
                        cmp_op=OP_IDS[node.op], cmp_thr=float(node.value),
                        rpn=tuple(rpn),
                    )
                )
            else:
                raise TypeError(f"cannot compile node {type(node)}")

    program = Program(
        tuple(groups),
        tuple(term_branches),
        tuple(group_colls),
        tuple(group_weights),
        tuple(group_colls2),
    )
    # static verification gate (REPRO_VERIFY=1): prove the compiled
    # program's structural invariants before anything evaluates it
    from repro_torch.analysis.verify import maybe_verify_program

    maybe_verify_program(program)
    return program


__all__ = [
    "GROUP_ANY", "GROUP_COUNT", "GROUP_DR", "GROUP_EXPR", "GROUP_HT",
    "GROUP_MASS", "KIND_F32", "KIND_I16", "KIND_I32", "KIND_I8", "KIND_MIN",
    "KIND_UINT", "OP_IDS", "Group", "Program", "compile_query",
    "program_from_fields", "value_kind",
]
