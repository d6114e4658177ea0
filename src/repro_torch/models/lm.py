"""Decoder-only LM of the SSM family (mamba2), in PyTorch.

Port of ``src/repro/models/lm.py``'s ``DecoderLM`` for ``family == "ssm"``,
the family the paged executor does not serve (nor does the JAX one). Its
entry points are the JAX package's:

  * ``prefill(params, tokens, max_len)`` — whole prompt → last logits and
    the cache; every Mamba2 block's chunk scan runs on kernel B5 on the
    card (``mamba2.ssd_chunked``), so B5 launches ``n_layers`` times;
  * ``decode_step(params, tokens, cache)`` — one token per sequence, the
    one-step recurrence as tensor ops (B5 launches 0 times);
  * ``init_cache(batch, max_len)`` — the zero cache.

The JAX scan over stacked layer params becomes a Python loop over the
stacked tensors; the new caches are stacked back (``{"ssm": (L, B, H, P,
N), "conv": (L, B, d_conv-1, conv_dim)}``), as the scan returns them.
``constrain`` is the identity: the port has no mesh (ROADMAP A13), so the
JAX calls are left out. ``DecoderLM(cfg, device=None)`` runs on the card
unless the caller asks for the CPU (``_device.resolve_device``). Every
other family raises ``NotImplementedError`` (ROADMAP A12b); ``train_loss``
is not ported (ROADMAP A14).
"""
from __future__ import annotations

import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from . import mamba2 as M
from .module import rmsnorm
from .weights import init_params


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class DecoderLM:
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        if cfg.family != "ssm" or cfg.ssm is None:
            raise NotImplementedError(
                f"DecoderLM covers the ssm family so far; {cfg.name} is "
                f"{cfg.family} (dense, MoE, gemma3, VLM and the hybrid "
                f"zamba2: ROADMAP A12b)")
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> dict:
        """The JAX ``init`` tree, drawn by ``init_params`` from
        ``generator`` (on this model's device)."""
        return init_params(self.cfg, generator, self.device)

    # ------------------------------------------------------------------
    # pieces
    # ------------------------------------------------------------------

    def _embed(self, params, tokens):
        return params["embed"].float()[tokens.long()]

    def _head(self, params, h_last):
        """h_last: (B, d) → logits (B, V) f32."""
        h = rmsnorm(h_last, params["ln_f"], self.cfg.norm_eps)
        return h.float() @ params["head"].float()

    def _mamba_block(self, lp, ln_w, x, mode, cache=None):
        h = rmsnorm(x, ln_w, self.cfg.norm_eps)
        if mode == "decode":
            y, new_cache = M.mamba_step(lp, h, self.cfg, cache)
        else:
            y, new_cache = M.mamba_seq(lp, h, self.cfg, cache)
        return x + y, new_cache

    def _ssm_stack(self, params, x, mode, cache):
        """Every Mamba2 block over ``x``; ``cache`` is the stacked cache,
        or None for a fresh prefill (zero states, as the JAX one builds
        them inline). Returns x and the new caches, stacked."""
        layers = params["layers"]
        if cache is None:
            cache = self._zero_cache(x.shape[0], x.device)
        new = []
        for i in range(self.cfg.n_layers):
            x, nc = self._mamba_block(_layer(layers["mamba"], i),
                                      layers["ln"][i], x, mode,
                                      _layer(cache, i))
            new.append(nc)
        return x, {k: torch.stack([c[k] for c in new]) for k in new[0]}

    def _zero_cache(self, batch: int, device) -> dict:
        one = M.init_mamba_cache(self.cfg, batch, device)
        return {k: v.expand(self.cfg.n_layers, *v.shape)
                for k, v in one.items()}

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------

    def prefill(self, params, tokens, max_len: int):
        """tokens (B,S) → (logits (B,V), cache). ``max_len`` is unused: the
        SSM cache has a constant size."""
        x = self._embed(params, tokens)
        b, s, _ = x.shape
        x, kv = self._ssm_stack(params, x, "prefill", None)
        logits = self._head(params, x[:, -1])
        pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
        return logits, {"pos": pos, "mamba": kv}

    def decode_step(self, params, tokens, cache):
        """tokens: (B,) int → (logits (B,V), updated cache)."""
        x = self._embed(params, tokens[:, None])
        x, new = self._ssm_stack(params, x, "decode", cache["mamba"])
        logits = self._head(params, x[:, 0])
        return logits, {"pos": cache["pos"] + 1, "mamba": new}

    def init_cache(self, batch: int, max_len: int):
        """Zero cache (engine restore path / decode-only lowering)."""
        zero = self._zero_cache(batch, self.device)
        return {"pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device),
                "mamba": {k: v.contiguous() for k, v in zero.items()}}


def build_model(cfg: ArchConfig, device: DeviceLike = None) -> DecoderLM:
    """The counterpart of the JAX ``build_model`` for the families the port
    runs through ``DecoderLM`` (ssm); fp32 only, so no ``ModelOpts``."""
    return DecoderLM(cfg, device)
