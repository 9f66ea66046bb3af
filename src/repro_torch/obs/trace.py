"""Per-query span trees + Chrome-trace export (DESIGN.md §13).

A :class:`Tracer` records a tree of timed **spans** for one logical unit
of work (one query, one service job, one shard execution).  The design
constraints, in order:

  * **Zero cost when off.**  The module-level :data:`NULL_TRACER` is the
    default everywhere; its ``span``/``begin``/``end`` are empty method
    calls returning shared singletons, so the engines' hot window loop
    pays a few attribute lookups per window, never an allocation.
  * **Byte-deterministic under an injected clock.**  The clock is
    injectable (any object with ``.now()``); span ids are a per-tracer
    counter; :func:`trace_json` serializes with sorted keys and fixed
    separators.  Same seed ⇒ byte-identical export (pinned by
    tests/test_obs.py).
  * **Trees compose across processes.**  A storage node traces into its
    own tracer; the coordinator *adopts* the node's spans — re-ids them
    and re-parents the node's roots under a coordinator span — so a
    cluster query exports as ONE tree (every node span adopted exactly
    once).
  * **Opens in ``chrome://tracing``.**  :func:`chrome_trace` emits the
    Trace Event Format (``ph: "X"`` complete events, microsecond
    timestamps, one ``pid`` per traced process/job).

Span taxonomy (the ``kind`` field): ``query``, ``plan``, ``window``,
``cascade_stage``, ``fetch``, ``decode``, ``decode_device`` (the
backend-selected on-device basket decode, DESIGN.md §16), ``kernel``,
``device_batch`` (one per window-batched cascade dispatch group, attrs:
windows/pad_windows/pad_events), ``write``, ``shard``, ``merge``,
``job``, ``admission``, ``queue``, ``settle``, ``tenant``, and the
fault-tolerance kinds ``retry`` (one per re-issued shard, attrs:
failed/used node), ``hedge`` (one per hedged shard, attrs: outcome
won/lost/cancelled), ``recover`` (one per journal-recovered job, attrs:
resume_skip).  See DESIGN.md §13–14, §16.

**Host detail.**  A tracer built with ``detail=True`` (the default of
``Tracer()``) also records the *leaves* of a skim's host time, one span
per round, stage step or phase-2 call (never one per basket or per
branch), opened where the work runs, one kind per kind of work:

  ===============  =========================================  ======================
  kind             covers                                     recorded in
  ===============  =========================================  ======================
  ``fetch``        the store's blob reads and CRC-32 digests  ``core/engine.py``
  ``ledger``       the cascade's basket ledger:               ``core/plan.py``
                   ``account_fetch``, ``mark_fetched``,
                   ``unfetched_bytes``
  ``pack``         laying out a kernel's inputs: a decode     ``data/codecs.py``,
                   round's plane parsing, ``plan_round`` and  ``kernels/ops.py``,
                   ``fill_round``; the padded planes; the     ``core/neardata.py``,
                   ``CascadeInputs`` fill; a staged skim      ``core/plan.py``
                   buffer; a batch's mask words and segment
                   ids
  ``launch``       staged buffer to work enqueued: the        ``kernels/ops.py``,
                   upload, the launch, the copy back's        ``core/plan.py``
                   enqueue (on the CPU, the plain version's
                   run)
  ``device_wait``  the host blocked on the card               ``kernels/ops.py``
  ``unpack``       copied-back bytes turned into arrays       ``kernels/ops.py``,
                   (``finish_decode``, ``unpack_mask``, the   ``core/neardata.py``,
                   survivor mask)                             ``core/plan.py``
  ``evaluate``     the host interpreter's run of a program    ``core/neardata.py``,
                                                              ``core/plan.py``
  ``decompress``,  exactly the intervals added to the         ``core/engine.py``
  ``deserialize``  ``Breakdown`` fields of those names        (``_Timer``)
  ===============  =========================================  ======================

In a detailed tree the parents ``load_window`` and ``phase2`` (of kind
``fetch`` in a tree without detail) take their names as their kinds, so
``fetch`` is the store read alone.  Leaves on one thread are disjoint or
nested: a device decode round's ``pack`` .. ``unpack`` lie inside its
``decompress``.  The ``Breakdown`` timers read ``time.perf_counter``; a
tracer on that clock (``clock=None``) takes the same two readings for
the ``decompress`` and ``deserialize`` spans, so their sums equal the
fields exactly.  A ``deserialize`` span around a phase-2 selection ends
with ``jagged_indexes`` (the survivor object indices it built, one a
counts branch) and ``jagged_columns`` (the jagged columns gathered with
them).  A ``cascade_stage`` span ends with ``plane_slots``, the events ×
K of the padded planes the stage laid out (each span's padded events on
the per-window route, the staged windows' padded events on the batched
one; 0 where the host interpreter ran), and ``object_slots``, the slots
among them that hold a real value (each event's largest object count
over the collections the stage reads, 1 where it reads a flat branch).
The ``plan`` span carries ``store_branches`` (the store's) and
``matched_branches`` (those the plan reads: filter and output branches,
the patterns expanded).

A detailed skim's ``query`` span also ends with ``clock_ns`` (epoch
nanoseconds read beside its ``t0``, for placing its spans on a device
profiler's clock) and the skim's own host<->device transfers:
``h2d_bytes``, ``h2d_copies`` (the uploads a decoded-columns-on-the-card
design would cut) and ``d2h_bytes``, ``d2h_copies`` (the decoded
columns, stage summaries and survivor rows read back, which such a
design would cut too).  They are counted where each copy is issued
(``repro_torch.kernels.ops``), into the skim's own :class:`Tally`: a
prefetch worker's copies count to the skim that handed it the work
(:func:`carried`), and skims on other threads count to their own.
``ops.transfer_stats`` holds the same counts for the whole process.

A tracer built with ``detail=False`` records the tree the JAX package
records, byte for byte: the service's job and batch tracers ask for no
detail, and a cluster node's tracer takes its coordinator tracer's
setting.

The kernel tier (``repro_torch.kernels.ops``) takes no tracer
argument; it records into the tracer *active* on its thread
(:func:`active`, the no-op tracer when none is).  :func:`activated`
runs a skim generator with its tracer and tally active during each step
and inactive across each ``yield``.  **Never hold an activation across
a ``yield``**: several jobs' generators advance on one thread, and an
activation held across a ``yield`` would put one job's spans into
another's tree.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time


class Span:
    """One timed node of the trace tree.  ``t1 is None`` while open."""

    __slots__ = ("sid", "parent", "name", "kind", "t0", "t1", "attrs")

    def __init__(self, sid, parent, name, kind, t0, t1=None, attrs=None):
        self.sid = sid
        self.parent = parent  # sid of the parent span, or None for roots
        self.name = name
        self.kind = kind
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs if attrs is not None else {}

    def __setitem__(self, key, value):
        self.attrs[key] = value

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def as_dict(self) -> dict:
        return {
            "sid": self.sid,
            "parent": self.parent,
            "name": self.name,
            "kind": self.kind,
            "t0": self.t0,
            "t1": self.t1,
            "attrs": dict(self.attrs),
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (
            f"Span({self.sid}<-{self.parent} {self.kind}:{self.name} "
            f"{self.duration * 1e3:.3f}ms)"
        )


class _SpanCM:
    """Context-manager wrapper around begin/end (the ``with`` form)."""

    __slots__ = ("_tr", "_name", "_kind", "_parent", "_attrs", "_span")

    def __init__(self, tracer, name, kind, parent, attrs):
        self._tr, self._name, self._kind = tracer, name, kind
        self._parent, self._attrs = parent, attrs

    def __enter__(self) -> Span:
        tr = self._tr
        st = tr._stack()
        pid = self._parent if self._parent is not None else (st[-1] if st else None)
        self._span = tr._new(self._name, self._kind, pid, tr.now(), None, self._attrs)
        st.append(self._span.sid)
        return self._span

    def __exit__(self, *exc) -> bool:
        tr, sp = self._tr, self._span
        sp.t1 = tr.now()
        st = tr._stack()
        if sp.sid in st:
            del st[st.index(sp.sid) :]
        return False


class Tracer:
    """Records one span tree.  Parenting is implicit (the innermost open
    span on the *calling thread*) unless ``parent=`` is given — worker
    threads that must attach to a specific span pass it explicitly.

    ``clock`` is any object with a ``.now() -> float`` (seconds), a bare
    callable, or ``None`` for ``time.perf_counter``.  ``detail`` asks for
    the host-detail leaves and attributes (module docstring).
    """

    enabled = True

    def __init__(self, clock=None, name: str = "trace", detail: bool = True):
        self.name = name
        self.clock = clock
        self.detail = bool(detail)
        if hasattr(clock, "now"):
            self._now = clock.now
        else:
            self._now = clock if callable(clock) else time.perf_counter
        self._spans: list[Span] = []
        self._by_id: dict[int, Span] = {}
        self._counter = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- internals -----------------------------------------------------------

    def now(self) -> float:
        return float(self._now())

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def _new(self, name, kind, parent, t0, t1, attrs) -> Span:
        with self._lock:
            sid = next(self._counter)
            sp = Span(sid, parent, name, kind, t0, t1, dict(attrs) if attrs else {})
            self._spans.append(sp)
            self._by_id[sid] = sp
        return sp

    # -- recording -----------------------------------------------------------

    def span(self, name: str, kind: str = "span", parent: int | None = None, **attrs):
        """``with tracer.span("window", kind="window") as sp: ...``"""
        return _SpanCM(self, name, kind, parent, attrs)

    def begin(self, name: str, kind: str = "span", parent: int | None = None, **attrs) -> int:
        """Open a span without a ``with`` block; returns its sid for
        :meth:`end`.  The generator-shaped executors use this to keep a
        span open across ``yield`` boundaries of *inner* code without
        re-indenting their bodies."""
        st = self._stack()
        pid = parent if parent is not None else (st[-1] if st else None)
        sp = self._new(name, kind, pid, self.now(), None, attrs)
        st.append(sp.sid)
        return sp.sid

    def end(self, sid: int, **attrs) -> None:
        """Close a span opened with :meth:`begin`; late attrs merge in.
        Pops the stack through ``sid`` so a dangling child (error paths)
        cannot mis-parent later spans."""
        sp = self._by_id.get(sid)
        if sp is None:
            return
        if sp.t1 is None:
            sp.t1 = self.now()
        if attrs:
            sp.attrs.update(attrs)
        st = self._stack()
        if sid in st:
            del st[st.index(sid) :]

    def add_span(
        self,
        name: str,
        kind: str = "span",
        t0: float = 0.0,
        t1: float | None = None,
        parent: int | None = None,
        **attrs,
    ) -> Span:
        """Record an already-completed span with explicit timestamps
        (admission decided at submit time, queue-wait measured between
        two clock readings, ...)."""
        st = self._stack()
        pid = parent if parent is not None else (st[-1] if st else None)
        return self._new(
            name, kind, pid, float(t0), float(t1 if t1 is not None else t0), attrs
        )

    def adopt(self, spans, parent: int | None = None) -> int:
        """Graft a foreign span list (e.g. a :class:`NodeResponse`'s
        node-local trace) into this tree: every span is re-id'd exactly
        once, internal parent links are remapped, and the foreign roots
        re-parent under ``parent``.  Spans must arrive parents-first
        (tracers append at open time, so ``spans()`` already is).
        Returns the number of spans adopted."""
        mapping: dict[int, int] = {}
        n = 0
        for sp in spans or ():
            pid = mapping.get(sp.parent, parent)
            new = self._new(
                sp.name, sp.kind, pid, sp.t0,
                sp.t1 if sp.t1 is not None else sp.t0, dict(sp.attrs),
            )
            mapping[sp.sid] = new.sid
            n += 1
        return n

    # -- reading -------------------------------------------------------------

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def get(self, sid: int) -> Span | None:
        return self._by_id.get(sid)

    def roots(self) -> list[Span]:
        return [s for s in self.spans() if s.parent is None]

    def children(self, sid: int | None) -> list[Span]:
        return [s for s in self.spans() if s.parent == sid]

    def chrome_trace(self, pid: int = 0) -> dict:
        return chrome_trace([(pid, self.name, self)])


class _NullSpan:
    """Shared do-nothing span; also its own context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setitem__(self, key, value) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The default tracer: every operation is a no-op returning shared
    singletons.  The hot path's only cost is the call itself."""

    enabled = False
    detail = False
    name = "null"
    clock = None

    def now(self) -> float:
        return 0.0

    def span(self, *args, **attrs):
        return _NULL_SPAN

    def begin(self, *args, **attrs) -> int:
        return 0

    def end(self, sid, **attrs) -> None:
        pass

    def add_span(self, *args, **attrs):
        return _NULL_SPAN

    def adopt(self, spans, parent=None) -> int:
        return 0

    def spans(self) -> list:
        return []

    def roots(self) -> list:
        return []


#: the process-wide shared no-op tracer (default everywhere)
NULL_TRACER = NullTracer()


# ---------------------------------------------------------------------------
# the tracer active on a thread (host detail below the engine)
# ---------------------------------------------------------------------------

class Tally:
    """Counts one skim adds to from any thread it runs on (the kernel
    tier's host<->device copies and bytes)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def add(self, **counts: int) -> None:
        with self._lock:
            for key, n in counts.items():
                self._counts[key] = self._counts.get(key, 0) + n

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)


class _Active(threading.local):
    tracer = NULL_TRACER
    tally = None


_ACTIVE = _Active()


def active():
    """The detailed tracer active on this thread, or :data:`NULL_TRACER`."""
    return _ACTIVE.tracer


def active_tally() -> Tally | None:
    """The tally of the skim running on this thread, or None."""
    return _ACTIVE.tally


def activated(gen, tracer):
    """``gen`` with ``tracer`` and a fresh :class:`Tally` active on the
    calling thread while each of its steps runs, and the earlier
    activation back across each ``yield``; returns what ``gen`` returns.
    A tracer that asks for no detail gets ``gen`` itself."""
    if not getattr(tracer, "detail", False):
        return gen
    return _activated(gen, tracer, Tally())


def _activated(gen, tracer, tally):
    while True:
        with _activation(tracer, tally):
            try:
                item = next(gen)
            except StopIteration as stop:
                return stop.value
        try:
            yield item
        except GeneratorExit:
            with _activation(tracer, tally):
                gen.close()
            raise


def carried(fn):
    """``fn`` with the calling thread's tally active, and no tracer, on
    whichever thread calls it: a prefetch worker's copies then count to
    the skim that handed it the work, and its spans go unrecorded."""
    tally = active_tally()
    if tally is None:
        return fn

    def run(*args, **kwargs):
        with _activation(NULL_TRACER, tally):
            return fn(*args, **kwargs)

    return run


@contextlib.contextmanager
def _activation(tracer, tally):
    prev = _ACTIVE.tracer, _ACTIVE.tally
    _ACTIVE.tracer, _ACTIVE.tally = tracer, tally
    try:
        yield
    finally:
        _ACTIVE.tracer, _ACTIVE.tally = prev


# ---------------------------------------------------------------------------
# Chrome Trace Event Format export
# ---------------------------------------------------------------------------


def _json_safe(value):
    """Coerce attrs to plain JSON types (numpy scalars via ``.item()``)
    without importing numpy — obs stays dependency-free."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if hasattr(value, "item"):
        try:
            return _json_safe(value.item())
        except Exception:
            pass
    return str(value)


def chrome_events(spans, pid: int = 0, tid: int = 0) -> list[dict]:
    """Spans -> Trace Event Format complete (``ph: "X"``) events.
    Timestamps are microseconds; open spans export with zero duration."""
    events = []
    for sp in spans:
        t1 = sp.t1 if sp.t1 is not None else sp.t0
        events.append(
            {
                "name": sp.name,
                "cat": sp.kind,
                "ph": "X",
                "ts": round(sp.t0 * 1e6, 3),
                "dur": round((t1 - sp.t0) * 1e6, 3),
                "pid": int(pid),
                "tid": int(tid),
                "args": {
                    "sid": sp.sid,
                    "parent": sp.parent,
                    **_json_safe(sp.attrs),
                },
            }
        )
    return events


def chrome_trace(groups) -> dict:
    """Assemble one Chrome-trace document from many traced processes.

    ``groups`` is an iterable of ``(pid, display_name, tracer_or_spans)``
    — one per traced unit (the service exports one pid per job).  The
    result opens directly in ``chrome://tracing`` / Perfetto.
    """
    events: list[dict] = []
    for pid, name, src in groups:
        spans = src.spans() if hasattr(src, "spans") else list(src)
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": int(pid),
                "tid": 0,
                "args": {"name": str(name)},
            }
        )
        events.extend(chrome_events(spans, pid=pid))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def trace_json(doc: dict) -> str:
    """Canonical serialization: sorted keys, fixed separators — the
    byte-determinism contract (same spans ⇒ same bytes)."""
    return json.dumps(_json_safe(doc), sort_keys=True, separators=(",", ":"))


def dump_chrome_trace(path: str, groups) -> dict:
    doc = chrome_trace(groups)
    with open(path, "w") as fh:
        fh.write(trace_json(doc))
    return doc


__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "Tally",
    "Tracer",
    "activated",
    "active",
    "active_tally",
    "carried",
    "chrome_events",
    "chrome_trace",
    "dump_chrome_trace",
    "trace_json",
]
