"""Derived-kinematics expression tier (DESIGN.md §10).

Real LHC skims cut on *derived* quantities — dilepton invariant-mass
windows, ΔR isolation, arithmetic over event scalars — not just raw
branches against constants.  This module is the host half of that tier:

  * a tiny arithmetic language over flat branches and ``sum(...)``
    reductions (``"MET_pt + 0.5*sum(Jet_pt)"``), parsed to an AST and
    lowered to a stack (RPN) program that both the NumPy reference
    evaluator and the compiled device :class:`~repro_torch.kernels.program.Program`
    execute — same post-order, same op sequence, so the two host paths
    are bit-identical by construction;
  * leading-pair kinematics (invariant mass, ΔR) shared by the query
    evaluator (``repro_torch.core.query.eval_node``) and the fused program
    interpreter (``repro_torch.core.neardata.program_eval_np``).

Everything here is float64 NumPy; the device kernels mirror the same
formulas in float32 (the HT precedent: bit-identical on the repo
fixtures, where no value sits within float32 noise of a threshold).

Conventions:

  * bare identifiers name **flat** branches;
  * ``sum(X)`` sums a **jagged** branch per event (float64 accumulation,
    exactly like HT); ``X`` must follow the NanoAOD ``Coll_var`` naming so
    its counts branch is ``nColl`` (:func:`counts_name`) — the same
    convention the ``object``/``ht`` nodes already rely on;
  * "leading" objects are highest-``pt`` first, ties broken by storage
    order (what ``argmax`` picks on device).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# ---------------------------------------------------------------------------
# RPN opcodes (shared with the device compiler/kernels)
# ---------------------------------------------------------------------------

(
    RPN_BRANCH,  # push a flat branch      (arg: branch name / term slot)
    RPN_SUM,  # push per-event sum of a jagged branch (arg: name / slot)
    RPN_CONST,  # push a constant          (arg: float)
    RPN_ADD,
    RPN_SUB,
    RPN_MUL,
    RPN_DIV,
    RPN_NEG,
    RPN_ABS,
    RPN_MIN,
    RPN_MAX,
) = range(11)

_BINARY = {RPN_ADD, RPN_SUB, RPN_MUL, RPN_DIV, RPN_MIN, RPN_MAX}
_UNARY = {RPN_NEG, RPN_ABS}

_FUNCTIONS = {"abs": (1, RPN_ABS), "min": (2, RPN_MIN), "max": (2, RPN_MAX)}


def counts_name(branch: str) -> str:
    """``Coll_var`` -> ``nColl`` (the NanoAOD counts-branch convention)."""
    return "n" + branch.split("_", 1)[0]


# ---------------------------------------------------------------------------
# AST + parser
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Num:
    value: float


@dataclass(frozen=True)
class Ref:
    name: str  # flat branch


@dataclass(frozen=True)
class SumRef:
    name: str  # jagged branch, summed per event


@dataclass(frozen=True)
class Un:
    op: int  # RPN_NEG / RPN_ABS
    arg: object


@dataclass(frozen=True)
class Bin:
    op: int  # RPN_ADD / RPN_SUB / RPN_MUL / RPN_DIV / RPN_MIN / RPN_MAX
    lhs: object
    rhs: object


class ExprError(ValueError):
    """Malformed expression text."""


def _tokenize(text: str) -> list[tuple[str, object]]:
    toks: list[tuple[str, object]] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
        elif c in "+-*/(),":
            toks.append((c, None))
            i += 1
        elif c.isdigit() or c == ".":
            j = i
            while j < n and (text[j].isdigit() or text[j] in ".eE" or
                             (text[j] in "+-" and text[j - 1] in "eE")):
                j += 1
            try:
                toks.append(("num", float(text[i:j])))
            except ValueError as exc:
                raise ExprError(f"bad number {text[i:j]!r} in {text!r}") from exc
            i = j
        elif c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            toks.append(("ident", text[i:j]))
            i = j
        else:
            raise ExprError(f"unexpected character {c!r} in {text!r}")
    toks.append(("end", None))
    return toks


class _Parser:
    """Recursive descent: expr -> term -> unary -> primary."""

    def __init__(self, text: str):
        self.text = text
        self.toks = _tokenize(text)
        self.pos = 0

    def peek(self) -> str:
        return self.toks[self.pos][0]

    def next(self) -> tuple[str, object]:
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def expect(self, kind: str) -> object:
        k, v = self.next()
        if k != kind:
            raise ExprError(f"expected {kind!r}, got {k!r} in {self.text!r}")
        return v

    def parse(self):
        node = self.expr()
        if self.peek() != "end":
            raise ExprError(f"trailing input after expression in {self.text!r}")
        return node

    def expr(self):
        node = self.term()
        while self.peek() in "+-":
            op, _ = self.next()
            node = Bin(RPN_ADD if op == "+" else RPN_SUB, node, self.term())
        return node

    def term(self):
        node = self.unary()
        while self.peek() in "*/":
            op, _ = self.next()
            node = Bin(RPN_MUL if op == "*" else RPN_DIV, node, self.unary())
        return node

    def unary(self):
        if self.peek() == "-":
            self.next()
            return Un(RPN_NEG, self.unary())
        if self.peek() == "+":
            self.next()
            return self.unary()
        return self.primary()

    def primary(self):
        kind, val = self.next()
        if kind == "num":
            return Num(float(val))
        if kind == "(":
            node = self.expr()
            self.expect(")")
            return node
        if kind == "ident":
            if self.peek() != "(":
                return Ref(str(val))
            self.next()  # '('
            name = str(val)
            if name == "sum":
                arg = self.expect("ident")
                self.expect(")")
                return SumRef(str(arg))
            if name not in _FUNCTIONS:
                raise ExprError(f"unknown function {name!r} in {self.text!r}")
            arity, op = _FUNCTIONS[name]
            args = [self.expr()]
            while self.peek() == ",":
                self.next()
                args.append(self.expr())
            self.expect(")")
            if len(args) != arity:
                raise ExprError(
                    f"{name}() takes {arity} argument(s), got {len(args)}"
                )
            return Un(op, args[0]) if arity == 1 else Bin(op, args[0], args[1])
        raise ExprError(f"unexpected token {kind!r} in {self.text!r}")


def parse_expr(text: str):
    """Parse expression text -> AST."""
    return _Parser(text).parse()


def to_rpn(node) -> tuple[tuple[int, object], ...]:
    """Post-order lowering of the AST to a stack program.

    Operands are branch *names* here; the device compiler rewrites them to
    term-slot indices.  Both host evaluators walk this exact sequence, so
    their float64 op order is identical.
    """
    out: list[tuple[int, object]] = []

    def walk(n) -> None:
        if isinstance(n, Num):
            out.append((RPN_CONST, float(n.value)))
        elif isinstance(n, Ref):
            out.append((RPN_BRANCH, n.name))
        elif isinstance(n, SumRef):
            out.append((RPN_SUM, n.name))
        elif isinstance(n, Un):
            walk(n.arg)
            out.append((n.op, None))
        elif isinstance(n, Bin):
            walk(n.lhs)
            walk(n.rhs)
            out.append((n.op, None))
        else:  # pragma: no cover - parser never builds other nodes
            raise TypeError(f"unknown expression node {type(n)}")

    walk(node)
    return tuple(out)


def compile_expr(text: str) -> tuple[tuple[int, object], ...]:
    """Text -> RPN; rejects expressions that read no branch (a constant
    predicate would silently defeat the engine's selection-free fast path)."""
    rpn = to_rpn(parse_expr(text))
    if not any(op in (RPN_BRANCH, RPN_SUM) for op, _ in rpn):
        raise ExprError(f"expression references no branches: {text!r}")
    return rpn


def rpn_branches(rpn) -> set[str]:
    """Branches the program reads (sum reductions include their counts)."""
    out: set[str] = set()
    for op, arg in rpn:
        if op == RPN_BRANCH:
            out.add(str(arg))
        elif op == RPN_SUM:
            out.add(str(arg))
            out.add(counts_name(str(arg)))
    return out


def validate_rpn(rpn, store, source: str = "") -> None:
    """Check branch kinds against a store: bare refs must be flat, sums
    jagged with the conventional counts branch (missing branches are the
    planner's generic error)."""
    for op, arg in rpn:
        br = store.branches.get(arg) if op in (RPN_BRANCH, RPN_SUM) else None
        if br is None:
            continue
        if op == RPN_BRANCH and br.jagged:
            raise ValueError(
                f"expression {source!r}: {arg!r} is jagged — "
                f"use sum({arg}) or an object/ht node"
            )
        if op == RPN_SUM:
            if not br.jagged:
                raise ValueError(
                    f"expression {source!r}: sum() needs a jagged branch, "
                    f"{arg!r} is flat"
                )
            if br.counts_branch != counts_name(str(arg)):
                raise ValueError(
                    f"expression {source!r}: sum({arg}) expects counts "
                    f"branch {counts_name(str(arg))!r}, store has "
                    f"{br.counts_branch!r}"
                )


# ---------------------------------------------------------------------------
# NumPy evaluation (the semantics of record for the host paths)
# ---------------------------------------------------------------------------


def _event_ids(counts: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(len(counts)), counts)


def eval_rpn(rpn, resolve) -> np.ndarray:
    """Run a stack program; ``resolve(op, arg)`` supplies RPN_BRANCH /
    RPN_SUM operands as float64 ``(n_events,)`` arrays.

    Both ``eval_node`` (branch-name operands) and ``program_eval_np``
    (term-slot operands) call this exact walk, which is what makes the
    staged and fused host evaluations bit-identical for expressions.
    """
    stack: list = []
    for op, arg in rpn:
        if op in (RPN_BRANCH, RPN_SUM):
            stack.append(resolve(op, arg))
        elif op == RPN_CONST:
            stack.append(np.float64(arg))
        elif op in _UNARY:
            x = stack.pop()
            stack.append(-x if op == RPN_NEG else np.abs(x))
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
                with np.errstate(divide="ignore", invalid="ignore"):
                    stack.append(a / b)
            elif op == RPN_MIN:
                stack.append(np.minimum(a, b))
            elif op == RPN_MAX:
                stack.append(np.maximum(a, b))
            else:  # pragma: no cover - compile_expr never emits others
                raise ValueError(f"unknown RPN op {op}")
    (result,) = stack
    return result


def eval_expr_np(rpn, data: dict) -> np.ndarray:
    """Evaluate a branch-name RPN over decoded columnar ``data``.

    Flat branches promote exactly to float64; ``sum(X)`` is a float64
    ``bincount`` segment sum (the HT accumulation, kept float64 per the
    count/sum semantics split).  Branch-name operands missing from
    ``data`` raise ``KeyError`` — expressions are never optional the way
    trigger ORs are.
    """

    def resolve(op, name):
        if op == RPN_BRANCH:
            return np.asarray(data[name], dtype=np.float64)
        counts = np.asarray(data[counts_name(name)], dtype=np.int64)
        vals = np.asarray(data[name], dtype=np.float64)
        return np.bincount(
            _event_ids(counts), weights=vals, minlength=len(counts)
        )

    return eval_rpn(rpn, resolve)


# ---------------------------------------------------------------------------
# leading-pair kinematics (invariant mass, ΔR)
# ---------------------------------------------------------------------------


def _leading_indices(pt: np.ndarray, counts: np.ndarray, k: int):
    """Global value-array indices of the ``k`` highest-``pt`` objects per
    event (ties -> storage order, matching device ``argmax``).  Returns a
    list of ``k`` index arrays plus the per-event "has >= j objects"
    masks; indices are clamped safe where the mask is False.
    """
    n = len(counts)
    counts = np.asarray(counts, dtype=np.int64)
    if len(pt) == 0:
        zeros = np.zeros(n, dtype=np.int64)
        return [zeros] * k, [np.zeros(n, dtype=bool)] * k
    order = np.lexsort(
        (np.arange(len(pt)), -np.asarray(pt, dtype=np.float64),
         _event_ids(counts))
    )
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    idxs, masks = [], []
    for j in range(k):
        has = counts >= j + 1
        pos = np.minimum(starts + j, len(order) - 1)
        idxs.append(np.where(has, order[pos], 0))
        masks.append(has)
    return idxs, masks


def _pair_kinematics(data: dict, coll_a: str, coll_b: str, variables):
    """Kinematic columns of the leading pair: for a same-collection pair
    the two highest-``pt`` objects, otherwise each collection's leading
    object.  Returns ``(cols_a, cols_b, ok)`` with float64 columns keyed
    by variable name and ``ok`` the events that have a full pair."""
    if coll_a == coll_b:
        counts = np.asarray(data[f"n{coll_a}"], dtype=np.int64)
        (i1, i2), (has1, has2) = _leading_indices(
            np.asarray(data[f"{coll_a}_pt"]), counts, 2
        )
        ok = has2
        idx_a, idx_b = i1, i2
        src_a = src_b = coll_a
    else:
        ca = np.asarray(data[f"n{coll_a}"], dtype=np.int64)
        cb = np.asarray(data[f"n{coll_b}"], dtype=np.int64)
        (ia,), (ha,) = _leading_indices(
            np.asarray(data[f"{coll_a}_pt"]), ca, 1
        )
        (ib,), (hb,) = _leading_indices(
            np.asarray(data[f"{coll_b}_pt"]), cb, 1
        )
        ok = ha & hb
        idx_a, idx_b = ia, ib
        src_a, src_b = coll_a, coll_b

    def gather(coll, idx):
        out = {}
        for var in variables:
            vals = np.asarray(data[f"{coll}_{var}"], dtype=np.float64)
            out[var] = vals[idx] if len(vals) else np.zeros(len(idx))
        return out

    return gather(src_a, idx_a), gather(src_b, idx_b), ok


def wrap_dphi(dphi: np.ndarray) -> np.ndarray:
    """Wrap an azimuthal difference into (-pi, pi]."""
    return (dphi + np.pi) % (2.0 * np.pi) - np.pi


def leading_pair_mass(
    data: dict, coll_a: str, coll_b: str
) -> tuple[np.ndarray, np.ndarray]:
    """Invariant mass of the leading pair -> ``(m (n,), ok (n,))``.

    ``m`` is garbage (zeros) where ``ok`` is False — callers gate on
    ``ok``.  Formula mirrored term-for-term by the float32 device kernel
    (kernels/ref.py)."""
    a, b, ok = _pair_kinematics(data, coll_a, coll_b,
                                ("pt", "eta", "phi", "mass"))

    def p4(c):
        px = c["pt"] * np.cos(c["phi"])
        py = c["pt"] * np.sin(c["phi"])
        pz = c["pt"] * np.sinh(c["eta"])
        ch = np.cosh(c["eta"])
        e = np.sqrt(c["mass"] * c["mass"] + c["pt"] * c["pt"] * ch * ch)
        return px, py, pz, e

    pxa, pya, pza, ea = p4(a)
    pxb, pyb, pzb, eb = p4(b)
    m2 = (
        (ea + eb) * (ea + eb)
        - (pxa + pxb) * (pxa + pxb)
        - (pya + pyb) * (pya + pyb)
        - (pza + pzb) * (pza + pzb)
    )
    return np.sqrt(np.maximum(m2, 0.0)), ok


def leading_delta_r(
    data: dict, coll_a: str, coll_b: str
) -> tuple[np.ndarray, np.ndarray]:
    """ΔR between the leading pair -> ``(dr (n,), ok (n,))``."""
    a, b, ok = _pair_kinematics(data, coll_a, coll_b, ("pt", "eta", "phi"))
    deta = a["eta"] - b["eta"]
    dphi = wrap_dphi(a["phi"] - b["phi"])
    return np.sqrt(deta * deta + dphi * dphi), ok


KINEMATIC_VARS = {"mass": ("pt", "eta", "phi", "mass"),
                  "deltaR": ("pt", "eta", "phi")}


__all__ = [
    "RPN_BRANCH", "RPN_SUM", "RPN_CONST", "RPN_ADD", "RPN_SUB", "RPN_MUL",
    "RPN_DIV", "RPN_NEG", "RPN_ABS", "RPN_MIN", "RPN_MAX",
    "ExprError", "parse_expr", "to_rpn", "compile_expr", "rpn_branches",
    "validate_rpn", "counts_name", "eval_rpn", "eval_expr_np",
    "leading_pair_mass", "leading_delta_r", "wrap_dphi", "KINEMATIC_VARS",
]
