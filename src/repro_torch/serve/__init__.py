"""Service layer: shared-scan batching + the async skim job service.

:class:`SharedScanEngine` amortizes one phase-1 pass over a tenant
batch (DESIGN.md §6); :class:`SkimService` (DESIGN.md §12) puts a job
lifecycle in front of every backend — cost-based admission, per-tenant
quotas, a weighted-fair queue, and window-granular streaming of partial
results.
"""

from repro_torch.serve.engine import BatchWindowPartial, SharedScanEngine, SharedScanResult
from repro_torch.serve.jobs import (
    CANCELLED,
    DONE,
    FAILED,
    PENDING,
    REJECTED,
    RUNNING,
    TERMINAL,
    CostEstimate,
    ManualClock,
    PartialResult,
    SkimJob,
    TenantQuota,
    price_query,
    union_columns,
)
from repro_torch.serve.journal import JOURNAL_EVENTS, JOURNAL_VERSION, JobJournal
from repro_torch.serve.service import (
    ClusterBackend,
    DeterministicExecutor,
    EngineBackend,
    ServiceError,
    SkimService,
)

__all__ = [
    "CANCELLED",
    "DONE",
    "FAILED",
    "PENDING",
    "REJECTED",
    "RUNNING",
    "TERMINAL",
    "BatchWindowPartial",
    "ClusterBackend",
    "CostEstimate",
    "DeterministicExecutor",
    "EngineBackend",
    "JOURNAL_EVENTS",
    "JOURNAL_VERSION",
    "JobJournal",
    "ManualClock",
    "PartialResult",
    "ServiceError",
    "SharedScanEngine",
    "SharedScanResult",
    "SkimJob",
    "SkimService",
    "TenantQuota",
    "price_query",
    "union_columns",
]
