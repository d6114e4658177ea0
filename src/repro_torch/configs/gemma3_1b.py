"""Gemma 3 1B — dense, 5:1 local:global attention, 128k-class context.

[hf:google/gemma-3-1b-pt; unverified] 26L d_model=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144. Every 6th layer is global attention; local layers
use a 512-token sliding window (Gemma-3 defaults).
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma3-1b",
        family="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,             # gemma3 fixes head_dim=256 (not d_model/H)
        d_ff=6912,
        vocab=262_144,
        local_global_period=6,
        local_window=512,
        rope_theta=1e6,
        source="hf:google/gemma-3-1b-pt; unverified",
    ),
    reduced=ArchConfig(
        name="gemma3-1b-smoke",
        family="dense",
        n_layers=2,                # 1 local + 1 global (period 2)
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab=256,
        local_global_period=2,
        local_window=16,
    ),
)
