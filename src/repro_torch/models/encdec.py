"""Encoder-decoder LM (the seamless-m4t-large-v2 backbone), in PyTorch.

Port of ``src/repro/models/encdec.py``. Encoder: a bidirectional
transformer over precomputed frame embeddings (the audio frontend is a
stub, as in the JAX package). Decoder: causal self-attention with a ring
KV cache plus cross-attention over the encoder memory, whose K/V are
projected once at prefill and cached (the standard enc-dec serving
layout).

  * ``prefill(params, {"enc_embeds": (B, S_enc, d), "dec_tokens": (B,
    S_dec)}, max_len)`` → last logits and the cache ``{"pos", "kv": {"k",
    "v": (L, B, max_len, Hkv, Dh), "kv_pos": (B, max_len)}, "cross_k",
    "cross_v": (L, B, S_enc, Hkv, Dh), "memory_pos": (B, S_enc)}``, the
    JAX layout;
  * ``decode_step(params, tokens, cache)`` — one token per sequence; like
    ``DecoderLM.decode_step`` it writes the self-attention ring in place
    (a caller that steps twice from one cache passes a copy);
  * ``train_loss(params, {"enc_embeds", "dec_tokens"})`` — teacher-forced
    cross-entropy through ``lm.chunked_ce_loss``; every encoder and
    decoder layer checkpointed under ``remat``;
  * ``init_cache(batch, max_len, enc_len)`` — the zero cache.

The JAX encoder checkpoints its layers in every mode; here only with grad
on, which computes the same values. No kernel of the port runs here: the
attention is ``attention.py``'s plain ops, as the JAX model's is plain
XLA. ``EncDecLM(cfg, opts, device=None)`` runs on the card unless the
caller asks for the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from . import layers as L
from .lm import ModelOpts, _auto_impl, _layer, chunked_ce_loss, remat_call
from .module import rmsnorm
from .weights import init_params


class EncDecLM:
    def __init__(self, cfg: ArchConfig, opts: Optional[ModelOpts] = None,
                 device: DeviceLike = None):
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder")
        self.cfg = cfg
        self.opts = opts or ModelOpts()
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> dict:
        """The JAX ``init`` tree in ``param_dtype``, drawn by
        ``init_params`` from ``generator`` (on this model's device)."""
        return init_params(self.cfg, generator, self.device,
                           self.opts.param_dtype)

    def axes(self) -> dict:
        """Logical sharding axes, same structure as params."""
        lead = (None,)
        attn = {k: lead + v for k, v in L.ATTN_AXES.items()}
        mlp = {k: lead + v for k, v in L.MLP_AXES.items()}
        enc = {"attn": attn, "ln1": lead + ("embed",), "mlp": mlp,
               "ln2": lead + ("embed",)}
        dec = dict(enc)
        dec["cross"] = attn
        dec["lnx"] = lead + ("embed",)
        return {"embed": ("vocab", "embed"),
                "enc_layers": enc, "enc_ln_f": ("embed",),
                "dec_layers": dec, "ln_f": ("embed",),
                "head": ("embed", "vocab")}

    def cache_axes(self) -> dict:
        """Logical axes tree matching init_cache's structure."""
        kvax = (None, "cache_batch", "cache_seq", "kv_heads", None)
        return {
            "pos": ("cache_batch",),
            "kv": {"k": kvax, "v": kvax,
                   "kv_pos": ("cache_batch", "cache_seq")},
            "cross_k": kvax, "cross_v": kvax,
            "memory_pos": ("cache_batch", "cache_seq"),
        }

    # ------------------------------------------------------------------

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        """(B, S) positions 0..S-1 for the (B, S, d) activations ``x``."""
        b, s = x.shape[:2]
        return torch.arange(s, dtype=torch.int32,
                            device=x.device).expand(b, s)

    def _enc_layer(self, lp, h, pos, impl):
        cfg = self.cfg
        h, _ = L.attn_seq(lp["attn"], h, pos, cfg, window=None,
                          ln_w=lp["ln1"], impl=impl,
                          flash_block=self.opts.flash_block, causal=False)
        return h + L.mlp_apply(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps))

    def _encode(self, params, enc_embeds):
        """Encoder memory (B, S_enc, d) after ``enc_ln_f``, and its
        positions."""
        cfg = self.cfg
        x = enc_embeds.to(self.opts.compute_dtype)
        pos = self._positions(x)
        impl = _auto_impl(self.opts, x.shape[1])
        for i in range(cfg.n_encoder_layers):
            x = remat_call(self.opts.remat, self._enc_layer,
                           _layer(params["enc_layers"], i), x, pos, impl)
        return rmsnorm(x, params["enc_ln_f"], cfg.norm_eps), pos

    def _cross_kv(self, params, memory):
        """The encoder memory projected to every decoder layer's cross K/V
        (once), in the cache dtype: two (L, B, S_enc, Hkv, Dh) tensors."""
        cfg, cd = self.cfg, self.opts.cache_dtype
        b, s, _ = memory.shape
        cross = params["dec_layers"]["cross"]
        k = torch.einsum("bsd,lde->lbse", memory, cross["wk"].to(memory.dtype))
        v = torch.einsum("bsd,lde->lbse", memory, cross["wv"].to(memory.dtype))
        shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
        return k.reshape(shape).to(cd), v.reshape(shape).to(cd)

    def _dec_layer(self, lp, x, positions, mode, self_kv, cross_k, cross_v,
                   memory_pos, cache_width):
        cfg = self.cfg
        if mode == "decode":
            x, self_kv = L.attn_decode(lp["attn"], x, positions, cfg,
                                       window=None, ln_w=lp["ln1"],
                                       cache_k=self_kv[0],
                                       cache_v=self_kv[1],
                                       kv_pos=self_kv[2])
        else:
            x, self_kv = L.attn_seq(lp["attn"], x, positions, cfg,
                                    window=None, ln_w=lp["ln1"],
                                    impl=_auto_impl(self.opts, x.shape[1]),
                                    flash_block=self.opts.flash_block,
                                    cache_width=cache_width)
            if self_kv is not None:
                cd = self.opts.cache_dtype
                self_kv = (self_kv[0].to(cd), self_kv[1].to(cd), self_kv[2])
        x = L.cross_attn_apply(lp["cross"], x, (cross_k, cross_v),
                               memory_pos, positions, cfg, lp["lnx"])
        x = x + L.mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
        return x, self_kv

    def _train_dec_layer(self, lp, x, positions, cross_k, cross_v,
                         memory_pos):
        return self._dec_layer(lp, x, positions, "train", None, cross_k,
                               cross_v, memory_pos, None)[0]

    def _decode_stack(self, params, x, positions, mode, cache, cross_kv,
                      memory_pos, cache_width):
        """Every decoder layer over ``x``. "prefill" returns the stacked
        self-attention caches, "decode" the updated ``cache`` (written in
        place), "train" None, each layer checkpointed under ``remat``."""
        cfg, layers = self.cfg, params["dec_layers"]
        ck, cv = cross_kv
        if mode == "train":
            for i in range(cfg.n_layers):
                x = remat_call(self.opts.remat, self._train_dec_layer,
                               _layer(layers, i), x, positions, ck[i], cv[i],
                               memory_pos)
            return x, None
        if mode == "decode":
            # every layer writes the same slot of the shared kv_pos
            for i in range(cfg.n_layers):
                x, _ = self._dec_layer(
                    _layer(layers, i), x, positions, mode,
                    (cache["k"][i], cache["v"][i], cache["kv_pos"]), ck[i],
                    cv[i], memory_pos, None)
            return x, cache
        ks, vs, kp = [], [], None
        for i in range(cfg.n_layers):
            x, (k, v, kp) = self._dec_layer(_layer(layers, i), x, positions,
                                            mode, None, ck[i], cv[i],
                                            memory_pos, cache_width)
            ks.append(k)
            vs.append(v)
        return x, {"k": torch.stack(ks), "v": torch.stack(vs), "kv_pos": kp}

    def _dec_embed(self, params, toks):
        return params["embed"][toks.long()].to(self.opts.compute_dtype)

    def _logits(self, params, h_last):
        h = rmsnorm(h_last, params["ln_f"], self.cfg.norm_eps)
        return h.float() @ params["head"].float()

    # ------------------------------------------------------------------

    def prefill(self, params, inputs, max_len: int):
        """inputs: {'enc_embeds': (B,S_enc,d), 'dec_tokens': (B,S_dec)} →
        (logits (B,V), cache)."""
        memory, mem_pos = self._encode(params, inputs["enc_embeds"])
        cross_kv = self._cross_kv(params, memory)
        x = self._dec_embed(params, inputs["dec_tokens"])
        b, sd, _ = x.shape
        x, self_cache = self._decode_stack(params, x, self._positions(x),
                                           "prefill", None, cross_kv, mem_pos,
                                           max_len)
        cache = {"pos": torch.full((b,), sd, dtype=torch.int32,
                                   device=x.device),
                 "kv": self_cache, "cross_k": cross_kv[0],
                 "cross_v": cross_kv[1], "memory_pos": mem_pos.contiguous()}
        return self._logits(params, x[:, -1]), cache

    def decode_step(self, params, tokens, cache):
        """tokens: (B,) int → (logits (B,V), updated cache). Consumes
        ``cache``'s self-attention ring, as ``DecoderLM.decode_step``
        does."""
        pos = cache["pos"]
        x = self._dec_embed(params, tokens[:, None])
        x, kv = self._decode_stack(params, x, pos[:, None], "decode",
                                   cache["kv"],
                                   (cache["cross_k"], cache["cross_v"]),
                                   cache["memory_pos"], None)
        return self._logits(params, x[:, 0]), {**cache, "pos": pos + 1,
                                                "kv": kv}

    def train_loss(self, params, batch):
        """batch: {'enc_embeds', 'dec_tokens'} — teacher-forced CE."""
        memory, mem_pos = self._encode(params, batch["enc_embeds"])
        cross_kv = self._cross_kv(params, memory)
        toks = batch["dec_tokens"]
        x = self._dec_embed(params, toks)
        x, _ = self._decode_stack(params, x, self._positions(x), "train",
                                  None, cross_kv, mem_pos, None)
        return chunked_ce_loss(params["head"], params["ln_f"], x[:, :-1],
                               toks[:, 1:], None, self.cfg,
                               self.opts.ce_chunk)

    def init_cache(self, batch: int, max_len: int, enc_len: int = 4096):
        """Zero cache, the JAX ``init_cache``'s."""
        cfg, dev, dt = self.cfg, self.device, self.opts.cache_dtype
        kv = L.empty_kv_cache(cfg.n_layers, batch, max_len, cfg.n_kv_heads,
                              cfg.head_dim, dt, device=dev)
        cross = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
                "kv": kv,
                "cross_k": torch.zeros(cross, dtype=dt, device=dev),
                "cross_v": torch.zeros(cross, dtype=dt, device=dev),
                "memory_pos": torch.zeros((batch, enc_len),
                                          dtype=torch.int32, device=dev)}
