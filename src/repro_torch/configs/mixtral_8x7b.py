"""Mixtral 8x7B — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, SWA window 4096.
"""
from .base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=0,
        vocab=32_000,
        window=4096,
        rope_theta=1e6,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14_336),
        source="arXiv:2401.04088; hf",
    ),
    reduced=ArchConfig(
        name="mixtral-8x7b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=0,
        vocab=256,
        window=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, router_chunk=64),
    ),
)
