"""Static analysis of compiled artifacts (DESIGN.md §15).

``repro_torch.analysis.verify`` proves invariants of compiled Programs
and SkimPlans *before anything runs*; ``compile_query`` and
``plan_skim`` call its gates behind ``REPRO_VERIFY=1``.
"""

from repro_torch.analysis.verify import (
    VerifyError,
    maybe_verify_plan,
    maybe_verify_program,
    program_reads,
    verify_cache_key_coverage,
    verify_enabled,
    verify_plan,
    verify_program,
)

__all__ = [
    "VerifyError",
    "maybe_verify_plan",
    "maybe_verify_program",
    "program_reads",
    "verify_cache_key_coverage",
    "verify_enabled",
    "verify_plan",
    "verify_program",
]
