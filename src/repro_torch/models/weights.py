"""Parameters of the decoder LM, in the JAX package's layout.

The tree is the one ``DecoderLM.init`` builds (``src/repro/models/lm.py``):
``embed (V, d)``, ``ln_f (d,)``, ``head (d, V)`` and ``layers`` with a
stacked leading layer dim holding, for the dense and MoE families,
``attn.{wq, wk, wv, wo}``, ``ln1``, ``ln2`` and either ``mlp.{w_gate,
w_up, w_down}`` (dense) or ``moe.{router (d, E), w_gate (E, d, f), w_up
(E, d, f), w_down (E, f, d)}`` (MoE, ``init_moe_params``); for the SSM
family ``mamba.{in_proj, conv_w, conv_b, A_log, D, dt_bias, norm_w,
out_proj}`` (``mamba2.init_mamba_params``) and ``ln``.

* ``params_from_numpy`` carries a JAX parameter tree across as numpy
  arrays (``jax.tree.map(np.asarray, params)``), so both packages compute
  the same function in the parity tests.
* ``init_params`` is the port's own initializer, drawing the same
  distributions as the JAX one (normal × 1/sqrt(fan_in), embed × 0.02, zero
  norms; MoE weights as ``init_moe_params``; Mamba2 weights as
  ``init_mamba_params``) from a ``torch.Generator``.
  It is for runs without JAX, such as
  ``chip_smoke.py`` at full width, and never decides a parity result.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..configs.base import ArchConfig
from .mamba2 import init_mamba_params


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
    """Random fp32 parameters for a dense-, MoE- or SSM-family ``cfg``;
    the generator must live on ``device``."""
    uniform = cfg.family in ("dense", "moe") and cfg.ssm is None
    ssm = cfg.family == "ssm" and cfg.ssm is not None
    if not (uniform or ssm):
        raise NotImplementedError(
            f"init_params covers the dense, MoE and SSM families; {cfg.name} "
            f"is {cfg.family} (hybrid: ROADMAP A12b)")
    dev = torch.device(device)
    d, n = cfg.d_model, cfg.n_layers

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return x.mul_(std)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=torch.float32)

    sd = 1.0 / math.sqrt(d)
    # drawn in the order of the tree: embed, head, then the layers
    params = {"embed": normal((cfg.vocab, d), 0.02), "ln_f": zeros((d,)),
              "head": normal((d, cfg.vocab), sd)}
    if ssm:
        return {**params, "layers": {
            "mamba": init_mamba_params(cfg, generator, dev, lead=(n,)),
            "ln": zeros((n, d))}}
    sq = 1.0 / math.sqrt(cfg.q_dim)
    layers = {"attn": {"wq": normal((n, d, cfg.q_dim), sd),
                       "wk": normal((n, d, cfg.kv_dim), sd),
                       "wv": normal((n, d, cfg.kv_dim), sd),
                       "wo": normal((n, cfg.q_dim, d), sq)},
              "ln1": zeros((n, d)),
              "ln2": zeros((n, d))}
    if cfg.moe is not None:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        sf = 1.0 / math.sqrt(f)
        layers["moe"] = {"router": normal((n, d, e), sd),
                         "w_gate": normal((n, e, d, f), sd),
                         "w_up": normal((n, e, d, f), sd),
                         "w_down": normal((n, e, f, d), sf)}
    else:
        sf = 1.0 / math.sqrt(cfg.d_ff)
        layers["mlp"] = {"w_gate": normal((n, d, cfg.d_ff), sd),
                         "w_up": normal((n, d, cfg.d_ff), sd),
                         "w_down": normal((n, cfg.d_ff, d), sf)}
    return {**params, "layers": layers}
