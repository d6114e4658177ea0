"""Hand-written CUDA kernels for the serving hot spots, with their plain
PyTorch versions.

paged_attention_ragged — token-packed ragged paged attention (the fused
                         hybrid step's one launch per layer, DESIGN.md §11)

Each kernel has its plain version in ref.py, a wrapper with a launch count
beside it, and a dispatch entry in ops.py. Sources live in csrc/ and build
with nvcc on first use (_build.py).
"""
from .ops import paged_attention_ragged_op

__all__ = ["paged_attention_ragged_op"]
