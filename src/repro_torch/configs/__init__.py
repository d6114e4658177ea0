"""Config registry: every architecture of the JAX package — the dense and
MoE families the paged executor serves, every family
``models.lm.DecoderLM`` runs (dense, MoE, VLM, SSM, hybrid) and the
encoder-decoder seamless-m4t-large-v2 (``models.encdec.EncDecLM``).

``base.py`` and the config modules are copies of ``src/repro/configs``.
"""
from .base import (ArchConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES,
                   cells, long_context_capable, get, get_reduced, all_archs)

_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    from . import (deepseek_67b, gemma3_1b, h2o_danube_1_8b,  # noqa: F401
                   kimi_k2_1t_a32b, mamba2_1_3b, mixtral_8x7b, pixtral_12b,
                   seamless_m4t_large_v2, stablelm_3b, zamba2_2_7b)
    _LOADED = True


__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
           "cells", "long_context_capable", "get", "get_reduced", "all_archs"]
