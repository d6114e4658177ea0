"""H2O-Danube 1.8B — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000,
SWA window 4096.
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab=32_000,
        window=4096,
        source="arXiv:2401.16818; hf",
    ),
    reduced=ArchConfig(
        name="h2o-danube-1.8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        window=16,
    ),
)
