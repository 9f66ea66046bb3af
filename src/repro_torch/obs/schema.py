"""Versioned result-report schema (DESIGN.md §13).

Result accounting used to accrete as ad-hoc ``extras["..."]`` writes
scattered across the engines — no common shape, no versioning, and every
consumer guessing which keys a given execution path produces.  This
module is now the single place result metadata is defined:

  * :class:`SkimReport` — the structured, versioned record attached to
    every :class:`~repro_torch.core.engine.SkimResult` as ``result.report``.
  * :meth:`SkimReport.legacy_extras` — the compatibility shim: it
    renders the report back into exactly the historical ``extras`` dict
    (same keys, same conditional presence), so every existing
    ``result.extras["..."]`` / ``"key" in extras`` consumer keeps
    working unchanged.
  * :func:`make_extras` — the validating constructor for the few extras
    dicts that are not per-engine reports (cluster merge metadata).

A CI checker (tools/check_extras.py) forbids new bare ``extras[...]``
writes outside this module, so the schema can only grow here — bump
:data:`SCHEMA_VERSION` when a field changes meaning or disappears
(adding optional fields is backward-compatible and needs no bump).
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: version stamped into every SkimReport (and its exports)
SCHEMA_VERSION = 1

#: every extras key any execution path may produce — the closed set the
#: lint checker and :func:`make_extras` validate against
KNOWN_EXTRAS = frozenset(
    {
        # per-engine report keys (SkimReport.legacy_extras)
        "output_bytes",
        "overlap_total",
        "fused",
        "pipelined",
        "phase_wall_s",
        "window_rows",
        "phase1_bytes",
        "phase2_bytes",
        "pruned_windows",
        "prune",
        "cascade",
        "cascade_order",
        "cascade_stages",
        "cascade_bytes_skipped",
        "pipeline_total",
        "shared_scan",
        "shard_pruned",
        # device-resident batched cascade (DESIGN.md §16)
        "device_batch",
        "device_dispatches",
        "decode_backend",
        # cluster merge metadata (coordinator-level, make_extras)
        "n_nodes",
        "concurrency",
        "query_hash",
        "pruned_shards",
        "prune_saved_bytes",
        "tenant",
        # fault-tolerance ledger (coordinator / DESIGN.md §14)
        "retry_attempts",
        "retry_backoff_s",
        "corrupt_baskets",
        "hedges_won",
        "hedges_lost",
        "hedges_cancelled",
        "degraded",
        "missing_windows",
    }
)


def make_extras(**kv) -> dict:
    """Build an extras dict restricted to the known schema; the one
    sanctioned way to produce extras outside :class:`SkimReport`."""
    unknown = set(kv) - KNOWN_EXTRAS
    if unknown:
        raise KeyError(
            f"extras keys {sorted(unknown)} are not in the obs schema "
            f"(add them to repro_torch.obs.schema.KNOWN_EXTRAS deliberately)"
        )
    return kv


@dataclass
class SkimReport:
    """Structured per-execution report.

    Optional fields are ``None`` when the execution path doesn't produce
    them (shared-scan tenants have no phase split; only pipelined runs
    have a schedule total) — :meth:`legacy_extras` omits ``None`` fields
    so the emitted key set matches each path's historical extras dict
    exactly.
    """

    mode: str = ""
    version: int = SCHEMA_VERSION
    # flags (always emitted)
    fused: bool = False
    pipelined: bool = False
    prune: bool = False
    # emitted only when the path reports it (pruned shard responses
    # predate the cascade and never carried the key)
    cascade: bool | None = None
    # ledgers (always emitted)
    output_bytes: int = 0
    window_rows: list = field(default_factory=list)
    pruned_windows: list = field(default_factory=list)
    # modeled/measured times (single-engine two-phase runs only)
    overlap_total_s: float | None = None
    phase_wall_s: float | None = None
    pipeline_total_s: float | None = None
    # phase byte split (single-engine two-phase runs only)
    phase1_bytes: int | None = None
    phase2_bytes: int | None = None
    # cascaded phase-1 ledger (cascade runs only)
    cascade_order: list | None = None
    cascade_stages: list | None = None
    cascade_bytes_skipped: int | None = None
    # device-resident batched cascade (DESIGN.md §16): the configured
    # window-batch size, the run's device dispatch count, and the
    # store's resolved decode tier — emitted only on batched runs
    device_batch: int | None = None
    device_dispatches: int | None = None
    decode_backend: str | None = None
    # path markers (emitted only when True)
    shared_scan: bool = False
    shard_pruned: bool = False

    def as_dict(self) -> dict:
        """Full versioned record (``None`` fields included) — the
        machine-readable export shape."""
        return {
            "version": self.version,
            "mode": self.mode,
            "fused": self.fused,
            "pipelined": self.pipelined,
            "prune": self.prune,
            "cascade": self.cascade,
            "output_bytes": self.output_bytes,
            "window_rows": list(self.window_rows),
            "pruned_windows": list(self.pruned_windows),
            "overlap_total_s": self.overlap_total_s,
            "phase_wall_s": self.phase_wall_s,
            "pipeline_total_s": self.pipeline_total_s,
            "phase1_bytes": self.phase1_bytes,
            "phase2_bytes": self.phase2_bytes,
            "cascade_order": self.cascade_order,
            "cascade_stages": self.cascade_stages,
            "cascade_bytes_skipped": self.cascade_bytes_skipped,
            "device_batch": self.device_batch,
            "device_dispatches": self.device_dispatches,
            "decode_backend": self.decode_backend,
            "shared_scan": self.shared_scan,
            "shard_pruned": self.shard_pruned,
        }

    def legacy_extras(self) -> dict:
        """Render the historical ``extras`` dict: same keys, same
        conditional presence, per execution path."""
        extras = {"output_bytes": self.output_bytes}
        if self.overlap_total_s is not None:
            extras["overlap_total"] = self.overlap_total_s
        extras["fused"] = self.fused
        extras["pipelined"] = self.pipelined
        if self.phase_wall_s is not None:
            extras["phase_wall_s"] = self.phase_wall_s
        if self.shared_scan:
            extras["shared_scan"] = True
        extras["window_rows"] = self.window_rows
        if self.phase1_bytes is not None:
            extras["phase1_bytes"] = self.phase1_bytes
        if self.phase2_bytes is not None:
            extras["phase2_bytes"] = self.phase2_bytes
        extras["pruned_windows"] = self.pruned_windows
        extras["prune"] = self.prune
        if self.shard_pruned:
            extras["shard_pruned"] = True
        if self.cascade is not None:
            extras["cascade"] = self.cascade
        if self.cascade_order is not None:
            extras["cascade_order"] = self.cascade_order
        if self.cascade_stages is not None:
            extras["cascade_stages"] = self.cascade_stages
        if self.cascade_bytes_skipped is not None:
            extras["cascade_bytes_skipped"] = self.cascade_bytes_skipped
        if self.pipeline_total_s is not None:
            extras["pipeline_total"] = self.pipeline_total_s
        if self.device_batch is not None:
            extras["device_batch"] = self.device_batch
        if self.device_dispatches is not None:
            extras["device_dispatches"] = self.device_dispatches
        if self.decode_backend is not None:
            extras["decode_backend"] = self.decode_backend
        return extras


__all__ = ["KNOWN_EXTRAS", "SCHEMA_VERSION", "SkimReport", "make_extras"]
