"""Decoder-only LM assembly for every decoder-only architecture family, in
PyTorch.

Port of ``src/repro/models/lm.py``'s ``DecoderLM``: one class, four family
paths, the JAX package's three entry points.

  * families: uniform transformer (dense / moe / vlm), ssm (mamba2), hybrid
    (zamba2: mamba backbone + one weight-shared attention block after every
    ``attn_period`` Mamba2 blocks), with per-layer windows (gemma3
    local:global) on the unrolled path;
  * ``train_loss(params, batch)`` — the full sequence (tokens, or
    ``embeds`` with ``labels`` and an optional ``mask``) through every
    layer, each checkpointed under ``remat`` (``torch.utils.checkpoint``
    where JAX uses ``jax.checkpoint``), then ``chunked_ce_loss``. Windowed
    layers run the unbanded windowed flash here, as JAX trains them; only
    the prefill bands. The SSM and hybrid families train through every
    Mamba2 block, each checkpointed under ``remat``, the hybrid's shared
    attention block without a cache;
  * ``prefill(params, inputs, max_len)`` — whole prompt (tokens (B, S), or
    ``{"embeds": (B, S, d)}`` for the VLM backbone) → last logits and the
    cache: ring KV caches of width ``min(window, max_len)`` per attention
    stack, Mamba2 states per block;
  * ``decode_step(params, tokens, cache)`` — one token per sequence; the
    ring caches are written in place (``layers.decode_ring_write``);
  * ``init_cache(batch, max_len)`` — the zero cache.

Kernels on the card: every Mamba2 block's prefill chunk scan is kernel B5
(``mamba2.ssd_chunked``), in training also its backward
(``kernels.mamba2_scan.MambaChunkScan``), and the MoE FFN under
``moe_impl="capacity"`` runs its three expert GEMMs on kernel B4
(``moe.moe_capacity``), in training also their backward GEMMs
(``kernels.moe_gmm.MoeGmm``).
Attention is ``attention.py``'s plain tensor ops, as the JAX model's is
plain XLA.

Cache layouts are the JAX package's: stacked ``{"k", "v": (L, B, W, Hkv,
Dh), "kv_pos": (B, W)}`` with one shared ``kv_pos`` when the layers are
"scanned" (here a Python loop over the stacked weights); a per-layer list
of ``{"k", "v", "kv_pos"}`` with per-layer widths when unrolled (gemma3's
``local_global_period``, or ``scan_layers=False``); for the hybrid,
``{"mamba": (L, ...), "attn": {"k", "v": (G, B, W, Hkv, Dh), "kv_pos": (G,
B, W)}}`` with one attention cache per shared-block application.
``axes()`` and ``cache_axes()`` give the JAX package's logical sharding
axes of the parameter and cache trees (``distributed.sharding`` maps them
to a mesh); the model itself carries no sharding constraint, and runs on
one device: the sharded data plane is the paged executor's ``mesh=``
path.
Dtypes are the JAX package's (``ModelOpts``): parameters in
``param_dtype``, activations in ``compute_dtype``, KV caches in
``cache_dtype``, each fp32 or bf16, and the casts where JAX casts them
(embeddings to the compute dtype, K/V to the cache dtype, logits and the
cross-entropy in fp32, norms and softmax in fp32; mixed products get the
cast ``jnp``'s promotion implies). The launch cells' serving opts are
bf16 throughout, their training opts fp32 parameters with bf16 compute
and cache (``src/repro/launch/steps.py``); Mamba2 states stay fp32.
``DecoderLM(cfg, opts, device=None)`` runs on the card unless the caller
asks for the CPU (``_device.resolve_device``), or on ``meta`` tensors for
a dry run (``launch.dryrun``); ``build_model`` returns the
encoder-decoder's ``encdec.EncDecLM`` for seamless-m4t-large-v2. JAX's
``flash_unroll`` has no counterpart: it unrolls XLA's scans for the HLO
analysis, and the port's loops run eagerly (``launch.cost_analysis``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from . import layers as L
from . import mamba2 as M
from .moe import MOE_AXES, MOE_IMPLS
from .module import rmsnorm
from .weights import init_params

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")


# the dtypes ModelOpts takes (fp16, which the JAX package also takes and
# nothing in it uses, is ROADMAP B6's one gap left)
DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass
class ModelOpts:
    """The JAX ``ModelOpts`` but ``flash_unroll`` (an HLO-analysis switch
    with no counterpart in eager loops). Each dtype is fp32 or bf16;
    another raises ``TypeError``."""
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    cache_dtype: torch.dtype = torch.float32
    attn_impl: str = "auto"        # dense | flash | auto
    flash_block: int = 512
    moe_impl: str = "capacity"     # capacity | exact
    remat: bool = True             # checkpoint each layer in train_loss
    ce_chunk: int = 512            # tokens per chunked-CE block
    scan_layers: bool = True       # False → per-layer cache list

    def __post_init__(self):
        for name in ("param_dtype", "compute_dtype", "cache_dtype"):
            if getattr(self, name) not in DTYPES:
                raise TypeError(
                    f"ModelOpts.{name} must be torch.float32 or "
                    f"torch.bfloat16, not {getattr(self, name)} (fp16: "
                    f"ROADMAP B6)")
        if self.attn_impl not in ("dense", "flash", "auto"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"unknown moe_impl {self.moe_impl!r}")


def _auto_impl(opts: ModelOpts, seq_len: int) -> str:
    if opts.attn_impl != "auto":
        return opts.attn_impl
    return "flash" if seq_len >= 1024 else "dense"


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _stack(trees: list) -> dict:
    """Per-layer trees → one stacked tree."""
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def _kv(kv) -> dict:
    return {"k": kv[0], "v": kv[1], "kv_pos": kv[2]}


class DecoderLM:
    def __init__(self, cfg: ArchConfig, opts: Optional[ModelOpts] = None,
                 device: DeviceLike = None):
        if cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it "
                             f"as EncDecLM (build_model does)")
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"DecoderLM runs the {', '.join(FAMILIES)} families; "
                f"{cfg.name} is {cfg.family}")
        self.cfg = cfg
        self.opts = opts or ModelOpts()
        self.device = resolve_device(device)
        # gemma3-style heterogeneous windows force the unrolled path
        self.unroll = (not self.opts.scan_layers
                       or cfg.local_global_period is not None)

    def init(self, generator: torch.Generator) -> dict:
        """The JAX ``init`` tree in ``param_dtype``, drawn by
        ``init_params`` from ``generator`` (on this model's device)."""
        return init_params(self.cfg, generator, self.device,
                           self.opts.param_dtype)

    def axes(self) -> dict:
        """Logical sharding axes, same structure as params (stacked leading
        'layers' dim is unsharded)."""
        cfg = self.cfg
        lead = (None,)  # stacked layer dim
        ax: dict = {
            "embed": ("vocab", "embed"),
            "ln_f": ("embed",),
            "head": ("embed", "vocab"),
        }
        if cfg.family in ("ssm", "hybrid"):
            mam = {k: lead + v for k, v in M.MAMBA_AXES.items()}
            ax["layers"] = {"mamba": mam, "ln": lead + ("embed",)}
            if cfg.family == "hybrid":
                ax["shared"] = {
                    "attn": dict(L.ATTN_AXES), "ln1": ("embed",),
                    "mlp": dict(L.MLP_AXES), "ln2": ("embed",),
                }
        else:
            lp = {"attn": {k: lead + v for k, v in L.ATTN_AXES.items()},
                  "ln1": lead + ("embed",), "ln2": lead + ("embed",)}
            if cfg.moe is not None:
                lp["moe"] = {k: lead + v for k, v in MOE_AXES.items()}
            else:
                lp["mlp"] = {k: lead + v for k, v in L.MLP_AXES.items()}
            ax["layers"] = lp
        return ax

    def cache_axes(self) -> dict:
        """Logical axes tree matching init_cache's structure."""
        cfg = self.cfg
        kv = {"k": (None, "cache_batch", "cache_seq", "kv_heads", None),
              "v": (None, "cache_batch", "cache_seq", "kv_heads", None),
              "kv_pos": ("cache_batch", "cache_seq")}
        ax: dict = {"pos": ("cache_batch",)}
        mam = {"ssm": (None, "cache_batch", "state", None, None),
               "conv": (None, "cache_batch", None, "inner")}
        if cfg.family == "ssm":
            ax["mamba"] = mam
        elif cfg.family == "hybrid":
            ax["mamba"] = mam
            # shared-attn caches carry a leading group dim on kv_pos too
            ax["attn"] = {**kv, "kv_pos": (None, "cache_batch", "cache_seq")}
        elif self.unroll:
            per = {"k": ("cache_batch", "cache_seq", "kv_heads", None),
                   "v": ("cache_batch", "cache_seq", "kv_heads", None),
                   "kv_pos": ("cache_batch", "cache_seq")}
            ax["kv"] = [per for _ in range(cfg.n_layers)]
        else:
            ax["kv"] = kv
        return ax

    # ------------------------------------------------------------------
    # pieces
    # ------------------------------------------------------------------

    def _embed(self, params, inputs):
        """Embeddings in the compute dtype (the rows gathered, then cast:
        the values of JAX's cast-then-gather)."""
        cd = self.opts.compute_dtype
        if isinstance(inputs, dict) and "embeds" in inputs:
            return inputs["embeds"].to(cd)
        toks = inputs["tokens"] if isinstance(inputs, dict) else inputs
        return params["embed"][toks.long()].to(cd)

    def _to_cache(self, kv):
        """A prefill's (k, v, kv_pos) with K and V in the cache dtype."""
        cd = self.opts.cache_dtype
        return None if kv is None else (kv[0].to(cd), kv[1].to(cd), kv[2])

    def _layer_seq(self, lp, x, positions, window, cache_width, impl):
        # banded SWA flash on the (no-grad) prefill path only
        x, kv = L.attn_seq(lp["attn"], x, positions, self.cfg, window=window,
                           ln_w=lp["ln1"], impl=impl,
                           flash_block=self.opts.flash_block,
                           banded=cache_width is not None,
                           cache_width=cache_width)
        return (L.layer_ffn(self.cfg, lp, x, self.opts.moe_impl),
                self._to_cache(kv))

    def _layer_decode(self, lp, x, positions, window, kv):
        x, kv = L.attn_decode(lp["attn"], x, positions, self.cfg,
                              window=window, ln_w=lp["ln1"],
                              cache_k=kv[0], cache_v=kv[1], kv_pos=kv[2])
        return L.layer_ffn(self.cfg, lp, x, self.opts.moe_impl), kv

    def _head(self, params, h_last):
        """h_last: (B, d) → logits (B, V) f32."""
        h = rmsnorm(h_last, params["ln_f"], self.cfg.norm_eps)
        return h.float() @ params["head"].float()

    def _width(self, window, max_len):
        return min(window, max_len) if window else max_len

    # ------------------------------------------------------------------
    # forward: uniform transformer stacks
    # ------------------------------------------------------------------

    def _uniform_seq(self, params, x, positions, max_len, mode="prefill"):
        """Every layer over ``x``; ``mode`` "prefill" also returns the
        caches, "train" returns None for them and, under ``remat``,
        checkpoints each layer."""
        cfg, layers = self.cfg, params["layers"]
        impl = _auto_impl(self.opts, x.shape[1])
        if mode == "train":
            for i in range(cfg.n_layers):
                x = remat_call(self.opts.remat, self._train_layer,
                               _layer(layers, i), x, positions,
                               cfg.layer_window(i), impl)
            return x, None
        caches = []
        for i in range(cfg.n_layers):
            # layer_window(i) is cfg.window unless local:global forces
            # the unrolled layout
            win = cfg.layer_window(i)
            x, kv = self._layer_seq(_layer(layers, i), x, positions, win,
                                    self._width(win, max_len), impl)
            caches.append(_kv(kv))
        if self.unroll:
            return x, caches
        stacked = _stack([{"k": c["k"], "v": c["v"]} for c in caches])
        return x, {**stacked, "kv_pos": caches[0]["kv_pos"]}

    def _train_layer(self, lp, x, positions, window, impl):
        return self._layer_seq(lp, x, positions, window, None, impl)[0]

    def _uniform_decode(self, params, x, positions, cache):
        cfg, layers = self.cfg, params["layers"]
        kv = cache["kv"]
        for i in range(cfg.n_layers):
            # stacked: every layer writes the same slot of the shared kv_pos
            c = kv[i] if self.unroll else {"k": kv["k"][i], "v": kv["v"][i],
                                           "kv_pos": kv["kv_pos"]}
            x, _ = self._layer_decode(_layer(layers, i), x, positions,
                                      cfg.layer_window(i),
                                      (c["k"], c["v"], c["kv_pos"]))
        return x, kv

    # ------------------------------------------------------------------
    # forward: ssm / hybrid stacks
    # ------------------------------------------------------------------

    def _mamba_block(self, lp, ln_w, x, mode, cache=None):
        h = rmsnorm(x, ln_w, self.cfg.norm_eps)
        if mode == "decode":
            y, new_cache = M.mamba_step(lp, h, self.cfg, cache)
        else:
            y, new_cache = M.mamba_seq(lp, h, self.cfg, cache)
        return x + y, new_cache

    def _mamba_span(self, params, x, mode, cache, lo, hi) -> tuple:
        """Mamba2 blocks ``lo:hi`` over ``x`` from the stacked ``cache``;
        returns x and the blocks' new caches, one per block. In "train"
        mode there is no cache (zero states: the scan starts from none)
        and none is returned; each block is checkpointed under ``remat``,
        as JAX checkpoints the scan body."""
        layers = params["layers"]
        new = []
        for i in range(lo, hi):
            if mode == "train":
                x = remat_call(self.opts.remat, self._train_mamba,
                               _layer(layers["mamba"], i), layers["ln"][i],
                               x)
                continue
            x, nc = self._mamba_block(_layer(layers["mamba"], i),
                                      layers["ln"][i], x, mode,
                                      _layer(cache, i))
            new.append(nc)
        return x, new

    def _train_mamba(self, lp, ln_w, x):
        return self._mamba_block(lp, ln_w, x, "train")[0]

    def _ssm_stack(self, params, x, mode, cache):
        """Every Mamba2 block over ``x``; ``cache`` is the stacked cache, or
        None for a fresh prefill (zero states, as the JAX one builds them
        inline). Returns x and the new caches, stacked (None in "train"
        mode)."""
        if mode == "train":
            return self._mamba_span(params, x, mode, None, 0,
                                    self.cfg.n_layers)[0], None
        if cache is None:
            cache = self._zero_mamba(x.shape[0], x.device)
        x, new = self._mamba_span(params, x, mode, cache, 0,
                                  self.cfg.n_layers)
        return x, _stack(new)

    def _zero_mamba(self, batch: int, device) -> dict:
        one = M.init_mamba_cache(self.cfg, batch, device)
        return {k: v.expand(self.cfg.n_layers, *v.shape)
                for k, v in one.items()}

    def _shared_attn_block(self, sp, x, positions, mode, kv, max_len):
        cfg = self.cfg
        if mode == "decode":
            x, kv = L.attn_decode(sp["attn"], x, positions, cfg, window=None,
                                  ln_w=sp["ln1"], cache_k=kv[0],
                                  cache_v=kv[1], kv_pos=kv[2])
        else:   # no cache in "train" mode, as JAX
            x, kv = L.attn_seq(sp["attn"], x, positions, cfg, window=None,
                               ln_w=sp["ln1"],
                               impl=_auto_impl(self.opts, x.shape[1]),
                               flash_block=self.opts.flash_block,
                               cache_width=max_len if mode == "prefill"
                               else None)
            kv = self._to_cache(kv)
        x = x + L.mlp_apply(sp["mlp"], rmsnorm(x, sp["ln2"], cfg.norm_eps))
        return x, kv

    def _hybrid_forward(self, params, x, positions, mode, cache, max_len):
        """The Mamba2 backbone with the shared attention block after every
        ``attn_period`` blocks, then the remaining blocks. Returns x and
        the new cache: Mamba2 caches stacked along the layers, attention
        caches along the block's applications (decode updates the latter
        in place); None in "train" mode."""
        cfg = self.cfg
        period = cfg.attn_period
        n_groups = cfg.n_layers // period
        if mode == "train":
            mam = None
        else:
            mam = (self._zero_mamba(x.shape[0], x.device) if cache is None
                   else cache["mamba"])
        new_mam, new_attn = [], []
        for g in range(n_groups):
            x, nc = self._mamba_span(params, x, mode, mam, g * period,
                                     (g + 1) * period)
            new_mam += nc
            kv = None
            if mode == "decode":
                a = cache["attn"]
                kv = (a["k"][g], a["v"][g], a["kv_pos"][g])
            x, kv = self._shared_attn_block(params["shared"], x, positions,
                                            mode, kv, max_len)
            if kv is not None:
                new_attn.append(_kv(kv))
        if n_groups * period < cfg.n_layers:
            x, nc = self._mamba_span(params, x, mode, mam, n_groups * period,
                                     cfg.n_layers)
            new_mam += nc
        if mode == "train":
            return x, None
        attn = cache["attn"] if mode == "decode" else _stack(new_attn)
        return x, {"mamba": _stack(new_mam), "attn": attn}

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------

    def prefill(self, params, inputs, max_len: int):
        """inputs: tokens (B,S) | {'embeds': (B,S,d)} → (logits (B,V),
        cache)."""
        cfg = self.cfg
        x = self._embed(params, inputs)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        cache: dict = {"pos": torch.full((b,), s, dtype=torch.int32,
                                         device=x.device)}
        if cfg.family == "ssm":
            x, cache["mamba"] = self._ssm_stack(params, x, "prefill", None)
        elif cfg.family == "hybrid":
            x, kv = self._hybrid_forward(params, x, positions, "prefill",
                                         None, max_len)
            cache.update(kv)
        else:
            x, cache["kv"] = self._uniform_seq(params, x, positions, max_len)
        return self._head(params, x[:, -1]), cache

    def decode_step(self, params, tokens, cache):
        """tokens: (B,) int → (logits (B,V), updated cache).

        Consumes ``cache``: its attention rings (K, V and ``kv_pos``) take
        the new token in place, where JAX's ``decode_step`` returns new
        arrays, while its ``pos`` and Mamba2 states stay as they were. A
        caller that steps from one cache twice (a retry, two branches from
        one prefill) passes a copy of it."""
        cfg = self.cfg
        pos = cache["pos"]
        positions = pos[:, None]
        x = self._embed(params, tokens[:, None])
        if cfg.family == "ssm":
            x, new = self._ssm_stack(params, x, "decode", cache["mamba"])
            new_cache = {"pos": pos + 1, "mamba": new}
        elif cfg.family == "hybrid":
            x, new = self._hybrid_forward(params, x, positions, "decode",
                                          cache, max_len=0)
            new_cache = {"pos": pos + 1, **new}
        else:
            x, new = self._uniform_decode(params, x, positions, cache)
            new_cache = {"pos": pos + 1, "kv": new}
        return self._head(params, x[:, 0]), new_cache

    def train_loss(self, params, batch):
        """batch: {'tokens' (B, S) | 'embeds' (B, S, d), optional 'labels'
        (B, S), optional 'mask' (B, S)} → the mean next-token cross-entropy
        (a 0-d fp32 tensor). Without labels the tokens shifted by one are
        the targets."""
        cfg = self.cfg
        x = self._embed(params, batch)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        if cfg.family == "ssm":
            h, _ = self._ssm_stack(params, x, "train", None)
        elif cfg.family == "hybrid":
            h, _ = self._hybrid_forward(params, x, positions, "train", None,
                                        max_len=s)
        else:
            h, _ = self._uniform_seq(params, x, positions, s, mode="train")
        if "labels" in batch:
            labels, mask = batch["labels"], batch.get("mask")
        else:
            labels, mask = batch["tokens"][:, 1:], None
            h = h[:, :-1]
        return chunked_ce_loss(params["head"], params["ln_f"], h, labels,
                               mask, cfg, self.opts.ce_chunk)

    def init_cache(self, batch: int, max_len: int):
        """Zero cache (engine restore path / decode-only lowering)."""
        cfg, dev, dt = self.cfg, self.device, self.opts.cache_dtype
        cache: dict = {"pos": torch.zeros((batch,), dtype=torch.int32,
                                          device=dev)}
        if cfg.family in ("ssm", "hybrid"):
            cache["mamba"] = {k: v.contiguous() for k, v in
                              self._zero_mamba(batch, dev).items()}
            if cfg.family == "hybrid":
                n_groups = cfg.n_layers // cfg.attn_period
                kvc = L.empty_kv_cache(n_groups, batch, max_len,
                                       cfg.n_kv_heads, cfg.head_dim, dt,
                                       device=dev)
                kvc["kv_pos"] = kvc["kv_pos"].expand(
                    n_groups, batch, max_len).contiguous()
                cache["attn"] = kvc
        elif self.unroll:
            cache["kv"] = []
            for i in range(cfg.n_layers):
                width = self._width(cfg.layer_window(i), max_len)
                c = L.empty_kv_cache(1, batch, width, cfg.n_kv_heads,
                                     cfg.head_dim, dt, device=dev)
                cache["kv"].append({"k": c["k"][0], "v": c["v"][0],
                                    "kv_pos": c["kv_pos"]})
        else:
            cache["kv"] = L.empty_kv_cache(
                cfg.n_layers, batch, self._width(cfg.window, max_len),
                cfg.n_kv_heads, cfg.head_dim, dt, device=dev)
        return cache


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, checkpointed when ``remat`` and grad mode is on: its
    activations are recomputed in the backward pass instead of kept
    (``jax.checkpoint``). Nothing is checkpointed without grad."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _chunk_nll(h, y, head):
    """Per-token negative log-likelihood of one chunk: h (n, d), y (n,)."""
    logits = h.float() @ head                             # (n, V)
    gold = logits.gather(1, y[:, None].long())[:, 0]
    return torch.logsumexp(logits, dim=-1) - gold


def chunked_ce_loss(head, ln_f, hidden, labels, mask, cfg: ArchConfig,
                    chunk: int):
    """Cross-entropy without materializing (B, S, V) logits: the tokens
    in chunks of ``chunk``, each chunk's logits recomputed in the backward
    pass (``torch.utils.checkpoint``, as JAX checkpoints the ``lax.map``
    body), so at most one chunk's (chunk, V) logits live at a time. The
    mean over the mask's tokens (all tokens without one)."""
    b, s, d = hidden.shape
    h = rmsnorm(hidden, ln_f, cfg.norm_eps).reshape(b * s, d)
    y = labels.reshape(b * s)
    m = (torch.ones(b * s, device=h.device) if mask is None
         else mask.reshape(b * s).float())
    headf = head.float()
    nll = torch.cat([remat_call(True, _chunk_nll, h[i:i + chunk],
                                y[i:i + chunk], headf)
                     for i in range(0, b * s, chunk)])
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def build_model(cfg: ArchConfig, opts: Optional[ModelOpts] = None,
                device: DeviceLike = None):
    """The counterpart of the JAX ``build_model``: ``EncDecLM`` for an
    encoder-decoder, else ``DecoderLM``."""
    if cfg.is_encoder_decoder:
        from .encdec import EncDecLM   # encdec imports this module
        return EncDecLM(cfg, opts, device)
    return DecoderLM(cfg, opts, device)
