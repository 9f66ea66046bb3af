"""Wildcard -> minimal branch-set mapping (paper §3.1).

``HLT_*`` expands to >650 trigger branches in NanoAOD, but "most physics
studies typically rely on fewer than 23 specific triggers".  SkimROOT maps
wildcard selections to a minimal predefined set based on usage statistics,
logs a warning for excluded branches, and honors a ``force_all`` override.
"""

from __future__ import annotations

import fnmatch
import logging

logger = logging.getLogger("repro_torch.branchmap")

# "Usage statistics" table: wildcard prefix -> the minimal branch set that
# common analyses actually read.  Extend via ``register_minimal_set``.
_MINIMAL_SETS: dict[str, tuple[str, ...]] = {
    "HLT_*": (
        "HLT_IsoMu24",
        "HLT_Ele32_WPTight_Gsf",
        "HLT_PFMET120_PFMHT120_IDTight",
        "HLT_DoubleEle25_CaloIdL_MW",
        "HLT_Mu17_TrkIsoVVL_Mu8_TrkIsoVVL",
    ),
}


def register_minimal_set(pattern: str, names: tuple[str, ...]) -> None:
    _MINIMAL_SETS[pattern] = tuple(names)


def expand_branches(
    patterns,
    available: list[str],
    force_all: bool = False,
    extra_required: set[str] | None = None,
) -> tuple[list[str], list[str]]:
    """Expand output-branch patterns against the store's branch list.

    Returns ``(selected, excluded_by_optimization)``.  Wildcards with a
    registered minimal set expand to that set unless ``force_all``; a
    warning is logged naming every excluded branch (paper: "SkimROOT logs a
    warning for any missing branches that were excluded due to
    optimization").  ``extra_required`` (e.g. filter branches) are always
    kept.
    """
    selected: list[str] = []
    excluded: list[str] = []
    seen: set[str] = set()

    def add(name: str) -> None:
        if name not in seen:
            seen.add(name)
            selected.append(name)

    for pat in patterns:
        full = fnmatch.filter(available, pat)
        if not full and pat in available:
            full = [pat]
        if not force_all and pat in _MINIMAL_SETS:
            minimal = [n for n in _MINIMAL_SETS[pat] if n in available]
            dropped = sorted(set(full) - set(minimal))
            if dropped:
                logger.warning(
                    "branchmap: pattern %r reduced to %d-branch minimal set; "
                    "%d branches excluded by optimization: %s%s",
                    pat,
                    len(minimal),
                    len(dropped),
                    ", ".join(dropped[:8]),
                    " ..." if len(dropped) > 8 else "",
                )
            excluded.extend(dropped)
            for n in minimal:
                add(n)
        else:
            for n in sorted(full):
                add(n)

    for n in sorted(extra_required or ()):
        if n in available:
            add(n)

    # jagged branches need their counts branch in the output
    return selected, excluded


def with_counts_branches(names: list[str], store) -> list[str]:
    """Ensure every jagged branch's counts branch rides along."""
    out = list(names)
    present = set(out)
    for n in names:
        br = store.branches.get(n)
        if br is not None and br.jagged and br.counts_branch not in present:
            present.add(br.counts_branch)
            out.append(br.counts_branch)
    return out
