"""SeamlessM4T-large v2 — encoder-decoder, multimodal (speech/text).

[arXiv:2308.11596; hf] 24L(enc) + 24L(dec) d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206.

The audio frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (B, S_enc, d_model); the decoder generates text
tokens autoregressively with self- + cross-attention. FairBatching treats
encoder passes as prefill-class work units (DESIGN.md §5).
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=256_206,
        is_encoder_decoder=True,
        n_encoder_layers=24,
        cross_attention=True,
        embeds_input=True,
        source="arXiv:2308.11596; hf",
    ),
    reduced=ArchConfig(
        name="seamless-m4t-large-v2-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        is_encoder_decoder=True,
        n_encoder_layers=2,
        cross_attention=True,
        embeds_input=True,
    ),
)
