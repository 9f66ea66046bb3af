"""Retry budgets, deterministic backoff, and hedge policy (DESIGN.md §14).

The coordinator's original fault policy was hard-coded: exactly one
replica retry on :class:`~repro_torch.cluster.node.NodeFailure`, nothing else.
This module replaces it with explicit, per-query policy objects:

  * :class:`RetryPolicy` — how many times a failing shard may be
    re-issued (``budget``), to which targets (replica first;
    ``retry_primary=True`` alternates back to the primary for transient
    faults), and how long each attempt backs off.  Backoff is
    *modeled*, never slept: the exponential delay (plus jitter from a
    seeded RNG, so tests replay exactly) is added to the shard's modeled
    seconds and ledgered in a :class:`RetryEvent` — the same
    two-currency discipline as the rest of the repo (DESIGN.md §2c).
    One policy covers every fault kind uniformly: ``NodeFailure``,
    ``NodeTimeout``, and :class:`~repro_torch.data.store.CorruptBasket`.

  * :class:`HedgePolicy` — when a completed shard's modeled time sits in
    the straggler tail, the coordinator re-issues it to the replica and
    takes the faster *bit-identical* response (mismatch is
    ``IntegrityError``, never a silent pick).  The hedge delay is either
    fixed (``delay_s``) or quantile-based: ``multiplier`` times the
    ``quantile`` of the modeled times observed so far in the gather,
    which is the classic "hedge after the p95" tail-latency policy.
    Hedging operates on the **modeled clock** — a node that is modeled
    slow (straggle injection, cold links) gets hedged deterministically;
    real wall-clock hangs are the job of ``shard_timeout_s``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    """Per-query retry budget + deterministic exponential backoff.

    ``budget`` is the number of *re-issues* per shard per query (the
    primary's first attempt is free).  Attempt ``k`` (1-based) backs off
    ``base_delay_s * multiplier**(k-1)`` seconds, capped at
    ``max_delay_s``, with ±``jitter`` relative noise drawn from an RNG
    seeded by ``(seed, shard_id, k)`` — two runs with the same policy
    replay byte-identical delays.  The defaults reproduce the historical
    policy: one replica retry, primaries never retried.
    """

    budget: int = 1
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 5.0
    jitter: float = 0.1
    seed: int = 0
    # retry the primary itself when no replica exists (or alternate
    # replica/primary when one does) — off by default: a primary that
    # just failed is assumed bad for the rest of the query
    retry_primary: bool = False

    def __post_init__(self):
        if self.budget < 0:
            raise ValueError("retry budget must be >= 0")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("backoff delays must be >= 0")
        if not 0 <= self.jitter <= 1:
            raise ValueError("jitter must be in [0, 1]")

    def backoff_s(self, attempt: int, shard_id: int = 0) -> float:
        """Modeled backoff before re-issue ``attempt`` (1-based) of one
        shard.  Deterministic: seeded by (policy seed, shard, attempt)."""
        if attempt < 1:
            raise ValueError("attempts are 1-based")
        delay = min(
            self.base_delay_s * self.multiplier ** (attempt - 1),
            self.max_delay_s,
        )
        if self.jitter == 0 or delay == 0:
            return delay
        # mixed int seed (tuple seeds are deprecated): same inputs, same draw
        rng = random.Random(
            (self.seed * 1_000_003 + shard_id) * 1_000_003 + attempt
        )
        return delay * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))

    def targets(self, primary, replica) -> list:
        """The node to use for each re-issue, in order — length
        ``budget``.  Replica first when one exists; ``retry_primary``
        alternates back to the primary (or, with no replica, retries the
        primary itself).  Without either, the list is empty and the
        first fault is terminal."""
        if replica is not None:
            if self.retry_primary:
                pair = [replica, primary]
                return [pair[i % 2] for i in range(self.budget)]
            return [replica] * self.budget
        if self.retry_primary:
            return [primary] * self.budget
        return []


#: the historical coordinator policy: one replica retry, no primary retry
DEFAULT_RETRY_POLICY = RetryPolicy()


@dataclass(frozen=True)
class HedgePolicy:
    """When (and whether) to hedge a straggling shard onto its replica.

    ``delay_s`` fixes the hedge delay outright; when ``None`` the delay
    is ``multiplier`` x the ``quantile`` of the modeled shard times
    completed so far in this gather (``min_delay_s`` floors the cold
    start before enough samples exist).  A shard whose modeled time
    exceeds the delay is re-issued to its replica; the coordinator keeps
    whichever response finishes the modeled race first — primary at its
    own modeled time, replica at ``delay + replica modeled`` — after
    verifying the two are bit-identical.

    ``jitter_guard`` makes the race decision deterministic: modeled
    shard times carry measured decode/filter components that jitter a
    few percent between two runs of identical work, so the replica only
    *wins* when it beats the primary by more than this relative margin
    (``delay + replica < primary * (1 - jitter_guard)``).  Flapping
    between two bit-identical responses on sub-jitter differences buys
    nothing and makes the reported modeled time (and the hedge ledger)
    nondeterministic; a genuine straggler rescue clears the guard by
    orders of magnitude.
    """

    delay_s: float | None = None
    quantile: float = 0.95
    multiplier: float = 2.0
    min_delay_s: float = 0.05
    min_samples: int = 2
    jitter_guard: float = 0.25

    def __post_init__(self):
        if self.delay_s is not None and self.delay_s < 0:
            raise ValueError("hedge delay_s must be >= 0")
        if not 0 < self.quantile <= 1:
            raise ValueError("hedge quantile must be in (0, 1]")
        if self.min_delay_s < 0:
            raise ValueError("min_delay_s must be >= 0")
        if not 0 <= self.jitter_guard < 1:
            raise ValueError("jitter_guard must be in [0, 1)")

    def delay(self, samples_modeled_s: list[float]) -> float:
        """The hedge delay given the modeled times gathered so far."""
        if self.delay_s is not None:
            return self.delay_s
        done = sorted(samples_modeled_s)
        if len(done) < max(self.min_samples, 1):
            return self.min_delay_s
        idx = min(int(self.quantile * len(done)), len(done) - 1)
        return max(self.multiplier * done[idx], self.min_delay_s)


@dataclass(frozen=True)
class RetryEvent:
    """One re-issue of one shard, with its modeled backoff — the
    detailed ledger behind ``ClusterSkimResult.retries``."""

    shard_id: int
    attempt: int  # 1-based re-issue ordinal
    error: str  # "fail" | "timeout" | "corrupt"
    failed_node: int
    next_node: int
    backoff_s: float


def classify_fault(exc: BaseException) -> str:
    """Map a shard-serving exception onto the fault taxonomy
    (DESIGN.md §14): ``corrupt`` | ``timeout`` | ``fail``."""
    from repro_torch.data.store import CorruptBasket

    if isinstance(exc, CorruptBasket):
        return "corrupt"
    name = type(exc).__name__
    if "Timeout" in name:
        return "timeout"
    return "fail"


__all__ = [
    "DEFAULT_RETRY_POLICY",
    "HedgePolicy",
    "RetryEvent",
    "RetryPolicy",
    "classify_fault",
]
