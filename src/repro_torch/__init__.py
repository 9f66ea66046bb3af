"""SkimROOT's near-data skim in PyTorch, with hand-written CUDA kernels
for an NVIDIA H100.

The same module layout and public names as the JAX package ``repro``
(``repro_torch.core.engine`` <-> ``repro.core.engine``), without importing
JAX or anything of ``repro``.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
