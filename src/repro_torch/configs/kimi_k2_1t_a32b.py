"""Kimi K2 — trillion-parameter MoE, 32B active.

[arXiv:2501.kimi2; unverified, paper-table] 61L d_model=7168 64H (GQA kv=8)
d_ff=2048 (per-expert) vocab=163840, MoE 384 experts top-8.

Notes (DESIGN.md §5/§6): the real K2 uses MLA attention and a dense first
layer; the assigned table specifies GQA and uniform MoE layers, which we
follow. Weights (2 TB bf16) force 2-D expert sharding: experts over `model`,
expert-FFN hidden over `data` (256-way).
"""
from .base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=0,
        vocab=163_840,
        rope_theta=5e7,
        moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                      router_chunk=8192),
        source="arXiv:2501.kimi2; unverified",
    ),
    reduced=ArchConfig(
        name="kimi-k2-1t-a32b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=0,
        vocab=512,
        moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=64, router_chunk=64),
    ),
)
