"""Zamba2 2.7B — hybrid: Mamba2 backbone + shared attention block.

[arXiv:2411.15242; hf] 54 Mamba2 layers d_model=2560, shared transformer
block (32H kv=32, d_ff=10240) applied every 6 Mamba blocks (9 applications,
weights shared), vocab=32000, ssm_state=64.

DESIGN.md §5: the real Zamba2 concatenates original embeddings into the
shared block and alternates two shared blocks with per-use LoRAs; we model a
single weight-shared transformer block on the residual stream (same FLOP and
memory profile at roofline granularity).
"""
from .base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10_240,
        vocab=32_000,
        ssm=SSMConfig(d_state=64),
        attn_period=6,
        source="arXiv:2411.15242; hf",
    ),
    reduced=ArchConfig(
        name="zamba2-2.7b-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        ssm=SSMConfig(d_state=16, head_dim=16, chunk=16),
        attn_period=2,
    ),
)
