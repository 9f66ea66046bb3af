"""The plain reference: a skim query evaluated in NumPy on the columns the
benchmark generated, and the output file it selects.

The semantics are those of the staged reference the port follows
(``core/query.py``, ``core/expr.py``), written here anew:

* preselection, ``cut`` and per-object cuts compare a float32 column with
  the cut read in float32, and an integer or bool column exactly; ``abs<``
  and ``abs>`` take the column's own ``abs``;
* ``object`` keeps an event with at least ``min_count`` objects passing
  every cut; ``any`` ORs its branches read as nonzero (absent ones false);
* ``ht``, ``mass``, ``deltaR`` and ``expr`` are float64: HT sums the passing
  objects' values in storage order; the leading pair is the two highest-pt
  objects of one collection (NaN last, ties to storage order) or each
  collection's leading object; an event without a full pair fails;
* the output holds the query's branches (``fnmatch`` patterns, ``HLT_*``
  read as the minimal trigger set), the filter branches and the counts of
  every jagged one, written in baskets of the input's basket size.

``precision="lower"`` is the control: every float32 column read through
bfloat16 and every float64 group value computed in float32, one step below
what the configuration states, in the cuts and in the values written.
"""

from __future__ import annotations

import fnmatch

import numpy as np

from portbench import codec

# the wildcard whose output set is the minimal trigger set (SkimROOT, 3.1)
MINIMAL_SETS = {
    "HLT_*": ("HLT_IsoMu24", "HLT_Ele32_WPTight_Gsf", "HLT_PFMET120_PFMHT120_IDTight",
              "HLT_DoubleEle25_CaloIdL_MW", "HLT_Mu17_TrkIsoVVL_Mu8_TrkIsoVVL"),
}
MASS_VARS = ("pt", "eta", "phi", "mass")
DELTA_R_VARS = ("pt", "eta", "phi")

CMP = {
    ">": np.greater, ">=": np.greater_equal, "<": np.less, "<=": np.less_equal,
    "==": np.equal, "!=": np.not_equal,
}


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to the nearest bfloat16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


class Columns:
    """One file's columns as the reference reads them."""

    def __init__(self, cols: dict, jagged: dict, precision: str = "stated"):
        if precision not in ("stated", "lower"):
            raise ValueError(f"unknown precision {precision!r}")
        self.raw, self.jagged, self.precision = cols, jagged, precision
        self.n_events = len(next(v for k, v in cols.items() if k not in jagged))
        self.real = np.float64 if precision == "stated" else np.float32
        self._read: dict = {}

    def __contains__(self, name: str) -> bool:
        return name in self.raw

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self._read:
            x = self.raw[name]
            self._read[name] = (to_bfloat16(x) if self.precision == "lower"
                                and x.dtype == np.float32 else x)
        return self._read[name]

    def counts(self, coll: str) -> np.ndarray:
        return np.asarray(self[f"n{coll}"], dtype=np.int64)

    def real_of(self, name: str) -> np.ndarray:
        return np.asarray(self[name], dtype=self.real)


def compare(values: np.ndarray, op: str, cut: float) -> np.ndarray:
    """A column against a cut: float32 in float32, the rest in float64."""
    if op in ("abs<", "abs>"):
        values, op = np.abs(values), op[-1]
    if values.dtype == np.float32:
        return CMP[op](values, np.float32(cut))
    if values.dtype.kind in "fc":
        return CMP[op](values, np.asarray(cut, dtype=values.dtype))
    return CMP[op](values.astype(np.float64), np.float64(cut))


def _event_ids(counts: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(len(counts)), counts)


def leading(pt: np.ndarray, counts: np.ndarray, k: int):
    """Value indices of each event's ``k`` highest-pt objects (NaN last,
    ties to storage order) and the events that have them."""
    if len(pt) == 0:
        zero = np.zeros(len(counts), np.int64)
        return [zero] * k, [np.zeros(len(counts), bool)] * k
    order = np.lexsort((np.arange(len(pt)), -np.asarray(pt, dtype=np.float64),
                        _event_ids(counts)))
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    idx, has = [], []
    for j in range(k):
        h = counts >= j + 1
        idx.append(np.where(h, order[np.minimum(starts + j, len(order) - 1)], 0))
        has.append(h)
    return idx, has


def pair(cols: Columns, colls, variables):
    """The leading pair's columns (in the reference's real type) and the
    events that have one."""
    a, b = colls
    if a == b:
        (i1, i2), (_, ok) = leading(cols[f"{a}_pt"], cols.counts(a), 2)
    else:
        (i1,), (ha,) = leading(cols[f"{a}_pt"], cols.counts(a), 1)
        (i2,), (hb,) = leading(cols[f"{b}_pt"], cols.counts(b), 1)
        ok = ha & hb

    def take(coll, idx):
        out = {}
        for var in variables:
            v = cols.real_of(f"{coll}_{var}")
            out[var] = v[idx] if len(v) else np.zeros(len(idx), cols.real)
        return out

    return take(a, i1), take(b, i2), ok


def mass_squared(cols: Columns, colls):
    """(m^2, ok) of the leading pair."""
    a, b, ok = pair(cols, colls, MASS_VARS)

    def p4(c):
        ch = np.cosh(c["eta"])
        e = np.sqrt(c["mass"] * c["mass"] + c["pt"] * c["pt"] * ch * ch)
        return (c["pt"] * np.cos(c["phi"]), c["pt"] * np.sin(c["phi"]),
                c["pt"] * np.sinh(c["eta"]), e)

    xa, ya, za, ea = p4(a)
    xb, yb, zb, eb = p4(b)
    m2 = ((ea + eb) * (ea + eb) - (xa + xb) * (xa + xb) - (ya + yb) * (ya + yb)
          - (za + zb) * (za + zb))
    return m2, ok


# -- expressions: + - * / unary -, abs(), min(), max(), sum(jagged) -----------

def _tokens(text: str) -> list:
    out, i = [], 0
    while i < len(text):
        c = text[i]
        if c.isspace():
            i += 1
        elif c in "+-*/(),":
            out.append((c, None))
            i += 1
        elif c.isdigit() or c == ".":
            j = i
            while j < len(text) and (text[j].isdigit() or text[j] in ".eE"
                                     or (text[j] in "+-" and text[j - 1] in "eE")):
                j += 1
            out.append(("num", float(text[i:j])))
            i = j
        elif c.isalpha() or c == "_":
            j = i
            while j < len(text) and (text[j].isalnum() or text[j] == "_"):
                j += 1
            out.append(("name", text[i:j]))
            i = j
        else:
            raise ValueError(f"unexpected {c!r} in {text!r}")
    return out + [("end", None)]


def parse_expr(text: str):
    """Text -> a tree of ``("num", v)``, ``("ref", name)``, ``("sum", name)``,
    ``(op, lhs[, rhs])``; ``+ -`` and ``* /`` associate to the left."""
    toks, pos = _tokens(text), [0]

    def peek():
        return toks[pos[0]][0]

    def take():
        pos[0] += 1
        return toks[pos[0] - 1]

    def expr():
        node = term()
        while peek() in ("+", "-"):
            node = (take()[0], node, term())
        return node

    def term():
        node = unary()
        while peek() in ("*", "/"):
            node = (take()[0], node, unary())
        return node

    def unary():
        if peek() == "-":
            take()
            return ("neg", unary())
        if peek() == "+":
            take()
            return unary()
        return primary()

    def primary():
        kind, val = take()
        if kind == "num":
            return ("num", val)
        if kind == "(":
            node = expr()
            take()
            return node
        if kind != "name":
            raise ValueError(f"unexpected {kind!r} in {text!r}")
        if peek() != "(":
            return ("ref", val)
        take()
        if val == "sum":
            _, arg = take()
            take()
            return ("sum", arg)
        args = [expr()]
        while peek() == ",":
            take()
            args.append(expr())
        take()
        return (val, *args)

    node = expr()
    if peek() != "end":
        raise ValueError(f"trailing input in {text!r}")
    return node


def eval_expr(node, cols: Columns) -> np.ndarray:
    kind = node[0]
    if kind == "num":
        return cols.real(node[1])
    if kind == "ref":
        return cols.real_of(node[1])
    if kind == "sum":
        name = node[1]
        counts = cols.counts(name.split("_", 1)[0])
        return np.bincount(_event_ids(counts), weights=cols.real_of(name),
                           minlength=len(counts)).astype(cols.real)
    args = [eval_expr(a, cols) for a in node[1:]]
    if kind == "neg":
        return -args[0]
    if kind == "abs":
        return np.abs(args[0])
    if kind == "min":
        return np.minimum(*args)
    if kind == "max":
        return np.maximum(*args)
    a, b = args
    if kind == "+":
        return a + b
    if kind == "-":
        return a - b
    if kind == "*":
        return a * b
    with np.errstate(divide="ignore", invalid="ignore"):
        return a / b


def selection_nodes(query: dict) -> list[dict]:
    sel = query.get("selection", {})
    nodes = [dict(c, type="cut") for c in sel.get("preselection", [])]
    nodes += [dict(o, type="object") for o in sel.get("object", [])]
    return nodes + [dict(e, type=e.get("type", "cut")) for e in sel.get("event", [])]


def node_mask(node: dict, cols: Columns) -> np.ndarray:
    """One node's verdict on every event."""
    kind, n = node["type"], cols.n_events
    if kind == "cut":
        return compare(cols[node["branch"]], node["op"], node["value"])
    if kind == "any":
        out = np.zeros(n, bool)
        for name in node["branches"]:
            if name in cols:
                out |= cols[name] != 0
        return out
    if kind == "object":
        coll = node["collection"]
        counts = cols.counts(coll)
        passing = np.ones(int(counts.sum()), bool)
        for c in node.get("cuts", []):
            passing &= compare(cols[f"{coll}_{c['var']}"], c["op"], c["value"])
        per_event = np.bincount(_event_ids(counts)[passing], minlength=n)
        return per_event >= node.get("min_count", 1)
    if kind == "ht":
        coll, var = node["collection"], node.get("var", "pt")
        counts = cols.counts(coll)
        passing = np.ones(int(counts.sum()), bool)
        for c in node.get("object_cuts", []):
            passing &= compare(cols[f"{coll}_{c['var']}"], c["op"], c["value"])
        vals = cols.real_of(f"{coll}_{var}")
        ht = np.bincount(_event_ids(counts), weights=vals * passing,
                         minlength=n).astype(cols.real)
        return compare(ht, node["op"], node["value"])
    if kind == "mass":
        lo, hi = node["window"]
        m2, ok = mass_squared(cols, node["collections"])
        m = np.sqrt(np.maximum(m2, 0))
        return ok & (m >= lo) & (m <= hi)
    if kind == "deltaR":
        a, b, ok = pair(cols, node["collections"], DELTA_R_VARS)
        deta = a["eta"] - b["eta"]
        dphi = (a["phi"] - b["phi"] + cols.real(np.pi)) % cols.real(2 * np.pi) - cols.real(np.pi)
        return ok & compare(np.sqrt(deta * deta + dphi * dphi), node["op"], node["value"])
    if kind == "expr":
        return compare(eval_expr(parse_expr(node["expr"]), cols), node["op"], node["value"])
    raise ValueError(f"unknown selection node {kind!r}")


def evaluate(query: dict, cols: Columns) -> np.ndarray:
    """The survivors of a file."""
    mask = np.ones(cols.n_events, bool)
    for node in selection_nodes(query):
        mask &= node_mask(node, cols)
    return mask


def node_branches(node: dict) -> set:
    kind = node["type"]
    if kind == "cut":
        return {node["branch"]}
    if kind == "any":
        return set(node["branches"])
    if kind in ("object", "ht"):
        coll = node["collection"]
        cuts = node.get("cuts", []) + node.get("object_cuts", [])
        out = {f"n{coll}"} | {f"{coll}_{c['var']}" for c in cuts}
        return out | ({f"{coll}_{node.get('var', 'pt')}"} if kind == "ht" else set())
    if kind in ("mass", "deltaR"):
        variables = MASS_VARS if kind == "mass" else DELTA_R_VARS
        return {f"n{c}" for c in node["collections"]} | {
            f"{c}_{v}" for c in node["collections"] for v in variables}
    if kind == "expr":
        out = set()

        def walk(t):
            if t[0] == "ref":
                out.add(t[1])
            elif t[0] == "sum":
                out.update({t[1], "n" + t[1].split("_", 1)[0]})
            elif t[0] != "num":
                for a in t[1:]:
                    walk(a)

        walk(parse_expr(node["expr"]))
        return out
    raise ValueError(f"unknown selection node {kind!r}")


def filter_branches(query: dict, available) -> list[str]:
    out = set()
    for node in selection_nodes(query):
        out |= node_branches(node)
    return sorted(b for b in out if b in available)


def output_branches(query: dict, cols: dict, jagged: dict) -> list[str]:
    """The branches the output file holds."""
    available = list(cols)
    names: list[str] = []
    for pat in query.get("branches", []):
        full = fnmatch.filter(available, pat) or ([pat] if pat in available else [])
        if not query.get("force_all") and pat in MINIMAL_SETS:
            full = [n for n in MINIMAL_SETS[pat] if n in available]
        else:
            full = sorted(full)
        names += [n for n in full if n not in names]
    names += [n for n in filter_branches(query, available) if n not in names]
    names += sorted({jagged[n] for n in names if n in jagged} - set(names))
    return names


def expected_output(query: dict, cols: Columns, mask: np.ndarray, basket_events: int) -> dict:
    """``{branch: [basket values, ...]}`` of the output file the survivors
    ``mask`` select, cut into baskets as the input is."""
    raw, jagged = cols.raw, cols.jagged
    out = {}
    for name in output_branches(query, raw, jagged):
        values = cols[name]
        if name in jagged:
            counts = np.asarray(raw[jagged[name]])
            out[name] = codec.baskets(values[np.repeat(mask, counts)], counts[mask],
                                      basket_events)
        else:
            out[name] = codec.baskets(values[mask], None, basket_events)
    return out


def window_counts(mask: np.ndarray, window_events: int) -> np.ndarray:
    """Survivors of each window of ``window_events`` events."""
    n = len(mask)
    return np.add.reduceat(mask.astype(np.int64), np.arange(0, n, window_events)) if n else np.zeros(0, np.int64)
