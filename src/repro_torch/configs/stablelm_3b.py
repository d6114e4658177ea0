"""StableLM 3B — dense transformer, full MHA (kv = heads).

[hf:stabilityai/stablelm-2-1_6b; unverified] 32L d_model=2560 32H (GQA kv=32)
d_ff=6912 vocab=50304.
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab=50_304,
        source="hf:stabilityai/stablelm-2-1_6b; unverified",
    ),
    reduced=ArchConfig(
        name="stablelm-3b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
    ),
)
