# The paper's primary contribution: JSON-query-driven, two-phase,
# near-data skimming (SkimROOT) as a composable library.
from repro_torch.core.branchmap import expand_branches, register_minimal_set
from repro_torch.core.engine import (
    LAN_10G,
    LAN_100G,
    LOCAL_DISK,
    PCIE_128G,
    WAN_1G,
    Breakdown,
    NetworkModel,
    SkimEngine,
    SkimResult,
    run_skim,
)
from repro_torch.core.planner import SkimPlan, plan_skim
from repro_torch.core.query import Query, eval_node, eval_stage, parse_query

__all__ = [
    "expand_branches",
    "register_minimal_set",
    "Breakdown",
    "NetworkModel",
    "SkimEngine",
    "SkimResult",
    "run_skim",
    "WAN_1G",
    "LAN_10G",
    "LAN_100G",
    "PCIE_128G",
    "LOCAL_DISK",
    "SkimPlan",
    "plan_skim",
    "Query",
    "parse_query",
    "eval_node",
    "eval_stage",
]
