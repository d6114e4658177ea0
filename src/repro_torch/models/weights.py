"""Parameters of the decoder LM, in the JAX package's layout.

The tree is the one ``DecoderLM.init`` builds (``src/repro/models/lm.py``):
``embed (V, d)``, ``ln_f (d,)``, ``head (d, V)`` and ``layers`` with a
stacked leading layer dim holding, for the dense, MoE and VLM families,
``attn.{wq, wk, wv, wo}``, ``ln1``, ``ln2`` and either ``mlp.{w_gate,
w_up, w_down}`` (dense, VLM) or ``moe.{router (d, E), w_gate (E, d, f),
w_up (E, d, f), w_down (E, f, d)}`` (MoE, ``init_moe_params``); for the SSM
and hybrid families ``mamba.{in_proj, conv_w, conv_b, A_log, D, dt_bias,
norm_w, out_proj}`` (``mamba2.init_mamba_params``) and ``ln``. The hybrid
family (zamba2) adds one weight-shared attention block, unstacked:
``shared.{attn, ln1, mlp, ln2}``. The encoder-decoder (seamless-m4t-
large-v2, ``encdec.EncDecLM``) has ``embed``, ``enc_layers.{attn, ln1,
mlp, ln2}``, ``enc_ln_f``, ``dec_layers.{attn, ln1, cross, lnx, mlp,
ln2}`` (``cross`` an attention block), ``ln_f`` and ``head``.

* ``params_from_numpy`` carries a JAX parameter tree across as numpy
  arrays (``jax.tree.map(np.asarray, params)``), so both packages compute
  the same function in the parity tests, in the dtype asked for (the
  model's ``param_dtype``): numpy holds a JAX bf16 array as
  ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so every
  leaf goes through fp32, which holds a bf16 exactly, and then to the
  dtype. ``params_to_numpy`` brings a tree (parameters or a cache, lists
  included) back, bf16 as fp32 (exact).
* ``init_params`` is the port's own initializer, drawing the same
  distributions as the JAX one (normal × 1/sqrt(fan_in), embed × 0.02, zero
  norms; MoE weights as ``init_moe_params``; Mamba2 weights as
  ``init_mamba_params``; the encoder-decoder's as ``EncDecLM.init``) from a
  ``torch.Generator``, in fp32 and then cast to the dtype asked for.
  It is for runs without JAX, such as
  ``chip_smoke.py`` at full width, and never decides a parity result.
  On the ``meta`` device, with no generator, it gives the tree's shapes
  and dtypes and allocates nothing (``launch.steps``: a cell's abstract
  parameters, JAX's ``jax.eval_shape(model.init, key)``).
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
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_numpy(tree: dict, device, dtype=torch.float32) -> dict:
    """Numpy (or array-like) parameter tree → ``dtype`` tensors on
    ``device`` (through fp32: exact for a bf16 leaf)."""
    dev = torch.device(device)
    return _map(tree, lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype))


def params_to_numpy(params: dict) -> dict:
    """The inverse bridge: tensors → numpy arrays, same tree (bf16 as
    fp32, which holds it exactly)."""
    return _map(params, lambda t: (t.detach().float() if t.dtype
                                   == torch.bfloat16 else t.detach())
                .cpu().numpy())


def params_to(params: dict, device) -> dict:
    """The same tree with every tensor on ``device``."""
    dev = torch.device(device)
    return _map(params, lambda t: t.to(dev))


def init_params(cfg: ArchConfig, generator: torch.Generator, device,
                dtype=torch.float32) -> dict:
    """Random parameters for ``cfg`` (dense, MoE, VLM, SSM, hybrid or the
    encoder-decoder) in ``dtype``, drawn in fp32 leaf by leaf; the
    generator must live on ``device`` (None on ``meta``)."""
    uniform = cfg.family in ("dense", "moe", "vlm") and cfg.ssm is None
    mamba = (cfg.ssm is not None and (cfg.family == "ssm" or (
        cfg.family == "hybrid" and cfg.attn_period is not None)))
    encdec = cfg.is_encoder_decoder and cfg.moe is None and cfg.ssm is None
    if not (uniform or mamba or encdec):
        raise NotImplementedError(
            f"init_params covers the dense, MoE, VLM, SSM, hybrid and "
            f"encoder-decoder families; {cfg.name} is {cfg.family}")
    dev = torch.device(device)
    d, n = cfg.d_model, cfg.n_layers

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return x.mul_(std).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def attn(lead):
        sq = 1.0 / math.sqrt(cfg.q_dim)
        return {"wq": normal(lead + (d, cfg.q_dim), sd),
                "wk": normal(lead + (d, cfg.kv_dim), sd),
                "wv": normal(lead + (d, cfg.kv_dim), sd),
                "wo": normal(lead + (cfg.q_dim, d), sq)}

    def mlp(lead):
        sf = 1.0 / math.sqrt(cfg.d_ff)
        return {"w_gate": normal(lead + (d, cfg.d_ff), sd),
                "w_up": normal(lead + (d, cfg.d_ff), sd),
                "w_down": normal(lead + (cfg.d_ff, d), sf)}

    sd = 1.0 / math.sqrt(d)
    # drawn in the order of the tree: embed, head, then the layers
    params = {"embed": normal((cfg.vocab, d), 0.02), "ln_f": zeros((d,)),
              "head": normal((d, cfg.vocab), sd)}
    if cfg.is_encoder_decoder:
        ne = cfg.n_encoder_layers
        params["enc_layers"] = {"attn": attn((ne,)), "ln1": zeros((ne, d)),
                                "mlp": mlp((ne,)), "ln2": zeros((ne, d))}
        params["enc_ln_f"] = zeros((d,))
        params["dec_layers"] = {"attn": attn((n,)), "ln1": zeros((n, d)),
                                "cross": attn((n,)), "lnx": zeros((n, d)),
                                "mlp": mlp((n,)), "ln2": zeros((n, d))}
        return params
    if cfg.family in ("ssm", "hybrid"):
        params["layers"] = {
            "mamba": init_mamba_params(cfg, generator, dev, lead=(n,),
                                       dtype=dtype),
            "ln": zeros((n, d))}
        if cfg.family == "hybrid":
            params["shared"] = {"attn": attn(()), "ln1": zeros((d,)),
                                "mlp": mlp(()), "ln2": zeros((d,))}
        return params
    layers = {"attn": attn((n,)), "ln1": zeros((n, d)), "ln2": zeros((n, d))}
    if cfg.moe is not None:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        sf = 1.0 / math.sqrt(f)
        layers["moe"] = {"router": normal((n, d, e), sd),
                         "w_gate": normal((n, e, d, f), sd),
                         "w_up": normal((n, e, d, f), sd),
                         "w_down": normal((n, e, f, d), sf)}
    else:
        layers["mlp"] = mlp((n,))
    return {**params, "layers": layers}
