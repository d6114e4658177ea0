"""Config registry: the architectures the port runs so far — the dense
and MoE families the paged executor serves, and the SSM family (mamba2)
that ``models.lm.DecoderLM`` runs.

``base.py`` and the config modules are copies of ``src/repro/configs``;
later slices add the remaining architectures to ``_load_all``.
"""
from .base import (ArchConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES,
                   cells, long_context_capable, get, get_reduced, all_archs)

_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    from . import (h2o_danube_1_8b, kimi_k2_1t_a32b,  # noqa: F401
                   mamba2_1_3b, mixtral_8x7b, stablelm_3b)
    _LOADED = True


__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
           "cells", "long_context_capable", "get", "get_reduced", "all_archs"]
