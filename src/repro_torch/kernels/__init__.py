"""Hand-written CUDA kernels of the skim data plane.

Three layers, each calling only the one below: ``ops.py``, the host side
the engine calls (entry points, staging, the dispatch ledger); a wrapper
module a kernel (``skim_fused``, ``basket_decode``, ``predicate_eval``,
``stream_compact``, ``flash_attention``) that checks its inputs and
launches its CUDA C++ source under ``repro_torch/csrc/`` for a CUDA
tensor, or takes its plain PyTorch version in ``ref.py``; and
``_build.py``, which builds, loads and launches the kernels and counts
every launch and every copy between the host and a card.
"""

from repro_torch.kernels import ops, ref
from repro_torch.kernels.program import Group, Program, compile_query

__all__ = ["ops", "ref", "Group", "Program", "compile_query"]
