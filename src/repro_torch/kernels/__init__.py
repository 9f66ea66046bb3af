"""Hand-written CUDA kernels of the skim data plane.

Each kernel has a CUDA C++ source under ``repro_torch/csrc/``, a wrapper
module here (``skim_fused``, ``basket_decode``, ``predicate_eval``,
``stream_compact``, ``flash_attention``) that launches it for a CUDA
tensor and counts its launches, and a plain PyTorch version in
``ref.py``; ``ops.py`` is the host side the engine calls.
"""

from repro_torch.kernels import ops, ref
from repro_torch.kernels.program import Group, Program, compile_query

__all__ = ["ops", "ref", "Group", "Program", "compile_query"]
