"""Hand-written CUDA kernels for the serving hot spots, with their plain
PyTorch versions.

paged_attention_ragged — token-packed ragged paged attention (the fused
                         hybrid step's one launch per layer, DESIGN.md §11)
paged_attention        — batched (B, Tq) paged attention (sequential mode,
                         multi-step decode, speculative draft and verify)
paged_attention_ragged_quant — the ragged kernel over int8 / fp8-e4m3 K/V
                         with f32 row scales (DESIGN.md §14); the batched
                         quantized op flattens into it
moe_gmm                — batched expert GEMM (E, C, K) x (E, K, N), the
                         capacity-dispatch MoE FFN's three projections
                         (and, in training, their backward GEMMs)
mamba2_scan            — the Mamba2 SSD chunk scan, every Mamba2 block's
                         prefill and training forward, and its backward
                         (``MambaChunkScan``) in training

These are the counterparts of all five TPU kernels of the JAX package.

Each kernel has its plain version in ref.py, a wrapper with a launch count
beside it, and a dispatch entry in ops.py. Sources live in csrc/ and build
with nvcc on first use (_build.py). quant.py holds the KV number formats.
"""
from .ops import (mamba_chunk_scan_op, moe_gmm_op, paged_attention_op,
                  paged_attention_quant_op, paged_attention_ragged_op,
                  paged_attention_ragged_quant_op)

__all__ = ["mamba_chunk_scan_op", "moe_gmm_op", "paged_attention_op",
           "paged_attention_quant_op", "paged_attention_ragged_op",
           "paged_attention_ragged_quant_op"]
