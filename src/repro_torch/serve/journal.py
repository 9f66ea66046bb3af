"""Durable job journal for the skim service (DESIGN.md §14).

The :class:`~repro_torch.serve.service.SkimService` is deliberately
single-threaded and in-memory — which means a crashed process forgets
every queued and half-streamed job.  :class:`JobJournal` fixes that with
the classic write-ahead pattern: the service appends one JSON-lines
record per lifecycle transition (``submit`` / ``admit`` / ``reject`` /
``start`` / ``window`` / ``settle``), and
:meth:`SkimService.recover <repro_torch.serve.service.SkimService.recover>`
replays the log into a fresh service:

  * terminal jobs come back with their state, error, and settle-time
    accounting (a recovered tenant's budget is exactly as drained as it
    was);
  * admitted-but-unstarted jobs re-enter the weighted-fair queue with
    their journaled estimate and virtual finish time — no re-pricing,
    no queue-order drift;
  * RUNNING jobs resume from their **window watermark**: the executor
    generator is reopened and deterministically fast-forwarded past the
    windows whose partials were already streamed (recomputed, not
    re-streamed), so the post-recovery stream is exactly the
    uninterrupted run's suffix and the final result is bit-identical.

The journal is append-only; records are never rewritten.  ``path=None``
keeps it in memory (tests, or callers who persist elsewhere); with a
path every append is flushed before returning so a crash loses at most
the transition in flight.
"""

from __future__ import annotations

import json
import os

#: every record kind the service appends, in lifecycle order
JOURNAL_EVENTS = (
    "submit",
    "admit",
    "reject",
    "start",
    "window",
    "settle",
)

#: bump when the record shape changes incompatibly
JOURNAL_VERSION = 1


class JobJournal:
    """Append-only JSON-lines journal of service lifecycle transitions.

    Every record is one JSON object with at least ``event`` (one of
    :data:`JOURNAL_EVENTS`), ``job_id``, and ``t`` (the service's
    deterministic clock).  Opening an existing path loads its records —
    the crash-recovery entry point — and appends after them.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self._records: list[dict] = []
        if path is not None and os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        self._records.append(json.loads(line))
        # the append handle stays open for the journal's lifetime;
        # line-buffered JSON so each record hits the OS on write
        self._fh = open(path, "a") if path is not None else None

    def append(self, event: str, job_id: int, t: float, **fields) -> dict:
        """Record one transition; returns the appended record."""
        if event not in JOURNAL_EVENTS:
            raise ValueError(
                f"unknown journal event {event!r} (want {JOURNAL_EVENTS})"
            )
        rec = {"v": JOURNAL_VERSION, "event": event, "job_id": job_id, "t": t}
        rec.update(fields)
        try:
            line = json.dumps(rec, sort_keys=True)
        except TypeError as exc:
            raise TypeError(
                f"journal record for {event!r} is not JSON-able: {exc} — "
                "submit queries as dict/str docs when journaling"
            ) from None
        self._records.append(rec)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        return rec

    def records(self, event: str | None = None) -> list[dict]:
        """All records in append order, optionally one event kind."""
        if event is None:
            return list(self._records)
        return [r for r in self._records if r["event"] == event]

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __len__(self) -> int:
        return len(self._records)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        where = self.path or "<memory>"
        return f"JobJournal({where!r}, records={len(self._records)})"


__all__ = ["JOURNAL_EVENTS", "JOURNAL_VERSION", "JobJournal"]
