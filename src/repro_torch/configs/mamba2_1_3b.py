"""Mamba2 1.3B — attention-free state-space model (SSD).

[arXiv:2405.21060; unverified] 48L d_model=2048, vocab=50280, ssm_state=128.
d_inner = 2*d_model = 4096, head_dim 64 → 64 SSM heads, conv width 4.
"""
from .base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50_280,
        ssm=SSMConfig(d_state=128),
        source="arXiv:2405.21060; unverified",
    ),
    reduced=ArchConfig(
        name="mamba2-1.3b-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=256,
        ssm=SSMConfig(d_state=16, head_dim=16, chunk=16),
    ),
)
