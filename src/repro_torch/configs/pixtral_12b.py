"""Pixtral 12B — vision-language model; Pixtral-ViT frontend + Mistral-Nemo
style decoder backbone.

[hf:mistralai/Pixtral-12B-2409; unverified] 40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072.

Per the assignment, only the transformer BACKBONE is modeled; the vision
frontend is a stub — ``input_specs()`` supplies precomputed patch embeddings,
so prefill consumes (B, S, d_model) embeddings and decode consumes text
token ids.
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14_336,
        vocab=131_072,
        rope_theta=1e9,
        embeds_input=True,
        source="hf:mistralai/Pixtral-12B-2409; unverified",
    ),
    reduced=ArchConfig(
        name="pixtral-12b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        embeds_input=True,
    ),
)
