"""Parameters of the dense decoder LM, in the JAX package's layout.

The tree is the one ``DecoderLM.init`` builds (``src/repro/models/lm.py``)
for the dense family: ``embed (V, d)``, ``ln_f (d,)``, ``head (d, V)`` and
``layers`` with a stacked leading layer dim holding ``attn.{wq, wk, wv,
wo}``, ``ln1``, ``ln2`` and ``mlp.{w_gate, w_up, w_down}``.

* ``params_from_numpy`` carries a JAX parameter tree across as numpy
  arrays (``jax.tree.map(np.asarray, params)``), so both packages compute
  the same function in the parity tests.
* ``init_params`` is the port's own initializer, drawing the same
  distributions as the JAX one (normal × 1/sqrt(fan_in), embed × 0.02, zero
  norms) from a ``torch.Generator``. It is for runs without JAX, such as
  ``chip_smoke.py`` at full width, and never decides a parity result.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..configs.base import ArchConfig


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: dict, device) -> dict:
    """Numpy (or array-like) parameter tree → fp32 tensors on ``device``."""
    dev = torch.device(device)
    return _map(tree, lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev))


def params_to_numpy(params: dict) -> dict:
    """The inverse bridge: tensors → numpy arrays, same tree."""
    return _map(params, lambda t: t.detach().cpu().numpy())


def params_to(params: dict, device) -> dict:
    """The same tree with every tensor on ``device``."""
    dev = torch.device(device)
    return _map(params, lambda t: t.to(dev))


def init_params(cfg: ArchConfig, generator: torch.Generator, device) -> dict:
    """Random fp32 parameters for a dense-family ``cfg``; the generator must
    live on ``device``."""
    if cfg.family != "dense" or cfg.moe is not None or cfg.ssm is not None:
        raise NotImplementedError(
            f"init_params covers the dense family; {cfg.name} is "
            f"{cfg.family} (later slice)")
    dev = torch.device(device)
    d, n = cfg.d_model, cfg.n_layers

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return x.mul_(std)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=torch.float32)

    sd, sq, sf = 1.0 / math.sqrt(d), 1.0 / math.sqrt(cfg.q_dim), \
        1.0 / math.sqrt(cfg.d_ff)
    return {
        "embed": normal((cfg.vocab, d), 0.02),
        "ln_f": zeros((d,)),
        "head": normal((d, cfg.vocab), sd),
        "layers": {
            "attn": {"wq": normal((n, d, cfg.q_dim), sd),
                     "wk": normal((n, d, cfg.kv_dim), sd),
                     "wv": normal((n, d, cfg.kv_dim), sd),
                     "wo": normal((n, cfg.q_dim, d), sq)},
            "ln1": zeros((n, d)),
            "ln2": zeros((n, d)),
            "mlp": {"w_gate": normal((n, d, cfg.d_ff), sd),
                    "w_up": normal((n, d, cfg.d_ff), sd),
                    "w_down": normal((n, cfg.d_ff, d), sf)},
        },
    }
