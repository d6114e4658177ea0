"""Config registry: the architectures the port serves so far.

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
    from . import h2o_danube_1_8b, stablelm_3b  # noqa: F401
    _LOADED = True


__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
           "cells", "long_context_capable", "get", "get_reduced", "all_archs"]
