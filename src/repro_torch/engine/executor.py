"""Step executors: the engine's data plane.

* ``SimExecutor`` — discrete-event world model: step time from a ground-truth
  linear cost model (+ lognormal jitter + optional GC pauses, reproducing the
  paper's §4 observation). The scheduler under test never sees these true
  coefficients — it calibrates its own online (exactly the paper's setup).
  A copy of the JAX package's.

* ``PagedTransformerExecutor`` — real PyTorch execution of the FairBatching
  hybrid step for dense-GQA archs over a paged KV cache (kv_manager). The
  fused mode packs the whole BatchPlan — every prefill chunk and decode
  token — into ONE padded token stream and runs a single forward per step
  (DESIGN.md §11), so the wall-clock step times feeding the scheduler's
  online calibration (paper §3.2) measure the unified batch the fairness
  math reasons about. Its attention takes the ragged paged contract by
  default (``ragged_attention=True``, on every device); ``False`` routes it
  through the batched kernel on a per-sequence padded view, as the JAX
  executor does off the TPU. ``mode="sequential"`` keeps the per-item
  launch loop as the parity oracle; ``execute_multi`` runs committed
  multi-step decode (DESIGN.md §12) and, with a draft installed by
  ``set_draft``, speculative rounds (§18), each horizon as one dispatch
  with a single device→host copy at its end. ``kv_dtype="int8"`` or
  ``"fp8_e4m3"`` stores the pools quantized with f32 row scales in scale
  pages (DESIGN.md §14) on every one of these paths: K/V quantize on
  scatter, the fused step attends through the quantized ragged kernel and
  the batched paths through the quantized batched op, which flattens into
  that kernel on the card. Every kernel is hand-written CUDA on the card
  and its plain PyTorch version on the CPU. The time a step returns ends
  after the device finished it (the copy of its tokens to the host
  synchronizes).

Not ported yet (each raises ``NotImplementedError``): ``mesh`` sharding,
the MoE family and ``attach_cache`` (the prefix cache).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..core.cost_model import LinearCostModel
from ..core.types import BatchPlan
from ..kernels.ops import (paged_attention_op, paged_attention_quant_op,
                           paged_attention_ragged_op,
                           paged_attention_ragged_quant_op)
from ..kernels.quant import QuantSpec, kv_quant_spec, quantize_kv, raw_pool
from ..models.layers import attn_qkv, mlp_apply
from ..models.module import rmsnorm
from ..models.weights import params_to
from .kv_manager import BlockAllocator


@dataclasses.dataclass
class SimExecutor:
    """True step-time generator (the 'GPU')."""
    true_model: LinearCostModel
    noise_sigma: float = 0.02          # lognormal jitter on step time
    gc_pause_every: float = 0.0        # seconds of sim time between GC STWs
    gc_pause_len: float = 0.25
    seed: int = 0
    # speculative decode world model (DESIGN.md §18): per-draft acceptance
    # probability and the draft pass's cost as a fraction of a target-pass
    # token (self-speculative ≈ truncated-layer depth / full depth)
    spec_acceptance: float = 0.7
    spec_draft_frac: float = 0.3

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._next_gc = self.gc_pause_every or math.inf

    def execute(self, plan: BatchPlan, requests, now: float) -> tuple[float, dict]:
        nt = plan.total_new_tokens
        if nt == 0:
            return 0.0, {}
        ctx = sum(requests[it.req_id].to_sched_task().cost_context()
                  for it in plan.items)
        t = self.true_model.step_time(nt, ctx)
        t *= float(self._rng.lognormal(0.0, self.noise_sigma))
        if now + t >= self._next_gc:
            t += self.gc_pause_len          # stop-the-world GC (paper §4)
            self._next_gc = now + t + self.gc_pause_every
        return t, {}

    def execute_spec(self, plan: BatchPlan, requests, now: float,
                     gamma: int) -> tuple[float, dict]:
        """ONE speculative round: γ drafts + one γ+1-wide verify pass.

        Returns ``(dt, accepted)`` where ``accepted[req_id]`` is the round's
        emitted-token count (1 verified fallback + leading accepted drafts,
        a truncated-geometric draw at ``spec_acceptance``). The verify pass
        prices like a Tq=γ+1 target step; drafting adds
        ``spec_draft_frac × step_time(n·γ, ctx)``. RNG draw order is fixed
        (jitter, then per-item acceptance in plan order) so lock-step and
        pipelined engines replay identical worlds (DESIGN.md §18).
        """
        items = plan.decode_items
        n = len(items)
        if n == 0:
            return 0.0, {}
        ctx = sum(requests[it.req_id].to_sched_task().cost_context()
                  for it in items)
        t = (self.true_model.step_time(n * (gamma + 1), ctx)
             + self.spec_draft_frac * self.true_model.step_time(n * gamma,
                                                                ctx))
        t *= float(self._rng.lognormal(0.0, self.noise_sigma))
        if now + t >= self._next_gc:
            t += self.gc_pause_len          # stop-the-world GC (paper §4)
            self._next_gc = now + t + self.gc_pause_every
        accepted = {}
        for it in items:
            a = 0
            while a < gamma and self._rng.random() < self.spec_acceptance:
                a += 1
            accepted[it.req_id] = a + 1     # +1: the verified fallback token
        return t, accepted


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _ladder(n: int, lo: int) -> int:
    """1.5-step bucket ladder: lo, 1.5·lo, 2·lo, 3·lo, 4·lo, … — finer than
    powers of two (≤ 33% padding waste) at ~2× the bucket-key count
    (DESIGN.md §11)."""
    b = lo
    while b < n:
        b = b * 3 // 2 if b % 3 else b * 4 // 3
    return b


@dataclasses.dataclass
class _PackedSeq:
    """Host-side view of one sequence in the packed step (DESIGN.md §11)."""
    req_id: int
    tokens: list            # new tokens this step (chunk, or [fed-back token])
    pos0: int               # global position of tokens[0]
    ctx: int                # context_len incl. this step's tokens
    emits: bool             # produces an output token this step


def _later(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet ({where}, a later slice)")


def kv_slots(table, positions, page_size: int, valid=None):
    """Flat (page ids, slots) of the K/V rows at ``positions`` (B, T)
    through ``table`` (B, n_pages), as int64 index tensors for
    ``index_put_``; rows with ``valid`` False go to trash page 0. The page
    index is clamped to the table before the gather: a padded prefill
    chunk's positions may run past it (JAX's ``take_along_axis`` clamps
    silently, torch would raise), and those rows are invalid anyway."""
    col = (positions // page_size).clamp(max=table.shape[1] - 1)
    page_ids = torch.gather(table, 1, col.long())
    if valid is not None:
        page_ids = torch.where(valid, page_ids, 0)
    return (page_ids.reshape(-1).long(),
            (positions % page_size).reshape(-1).long())


class ScalePools(NamedTuple):
    """The quantized side of a paged forward (DESIGN.md §14): the storage
    spec, the f32 scale pools (L, P, page, Hkv) and the scale tables
    (B, n_pages) parallel to the block tables."""
    spec: QuantSpec
    k: torch.Tensor
    v: torch.Tensor
    tables: torch.Tensor


def scatter_kv(pages, x, idx, spec: Optional[QuantSpec] = None,
               scale_pages=None, sidx=None) -> None:
    """Write K or V rows x (N, Hkv, D) into one layer's pool at the flat
    (page, slot) index ``idx``, in place. With ``spec`` the rows quantize
    on scatter and their f32 row scales land in ``scale_pages`` at
    ``sidx`` (the scale-page twin of ``idx``)."""
    if spec is None:
        pages.index_put_(idx, x)
        return
    xq, xs = quantize_kv(x, spec)
    raw_pool(pages).index_put_(idx, raw_pool(xq))
    scale_pages.index_put_(sidx, xs)


def paged_forward(cfg: ArchConfig, layers: list, k_pages, v_pages, x,
                  positions, tables, ctx_lens, page_size: int, valid=None,
                  n_layers: Optional[int] = None,
                  scales: Optional[ScalePools] = None):
    """Dense-family forward over paged KV, one batched attention launch per
    layer. x: (B, T, d); positions: (B, T); tables: (B, n_pages); ctx_lens:
    (B,) int32; ``layers`` the per-layer weight dicts over the pools'
    leading layer dim. ``n_layers`` truncates the stack (early-exit draft
    pass, DESIGN.md §18); None runs it all. ``scales`` makes the pools
    quantized (DESIGN.md §14): K/V quantize on scatter, with invalid rows'
    scales on trash scale page 0, and attention dequantizes. K/V writes
    land in the pools in place (``index_put_``), where JAX's ``.at[].set``
    returns new pools; their (page, slot) targets are the same in every
    layer, so they are gathered once. Returns the hidden states (B, T,
    d)."""
    q_starts = positions[:, 0].contiguous()
    idx = kv_slots(tables, positions, page_size, valid)
    spec = sidx = sk = sv = None
    if scales is not None:
        spec = scales.spec
        sidx = kv_slots(scales.tables, positions, page_size, valid)
    for l in range(len(layers) if n_layers is None else n_layers):
        lp = layers[l]
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(lp["attn"], h, positions, cfg)
        if scales is not None:
            sk, sv = scales.k[l], scales.v[l]
        scatter_kv(k_pages[l], k.reshape(-1, *k.shape[2:]), idx, spec, sk,
                   sidx)
        scatter_kv(v_pages[l], v.reshape(-1, *v.shape[2:]), idx, spec, sv,
                   sidx)
        if scales is None:
            o = paged_attention_op(q, k_pages[l], v_pages[l], tables,
                                   ctx_lens, q_starts, window=cfg.window)
        else:
            o = paged_attention_quant_op(q, k_pages[l], v_pages[l], sk, sv,
                                         tables, scales.tables, ctx_lens,
                                         q_starts, window=cfg.window)
        x = x + o.reshape(*x.shape[:2], cfg.q_dim) @ lp["attn"]["wo"]
        x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
    return x


def layer_views(params: dict, n_layers: int) -> list:
    """Per-layer weight dicts over the stacked-layer parameter tree."""
    lay = params["layers"]
    return [{"attn": {k: w[l] for k, w in lay["attn"].items()},
             "mlp": {k: w[l] for k, w in lay["mlp"].items()},
             "ln1": lay["ln1"][l], "ln2": lay["ln2"][l]}
            for l in range(n_layers)]


class PagedTransformerExecutor:
    """Real hybrid-step executor over a paged KV cache (dense GQA, fp32
    weights and activations; fp32, int8 or fp8-e4m3 KV).

    ``params`` is the JAX package's parameter tree as tensors
    (``models.weights.params_from_numpy`` or ``init_params``); it is moved
    to ``device``. ``device=None`` means the CUDA card and raises without
    one; ``device="cpu"`` runs the plain PyTorch path.
    """

    def __init__(self, cfg: ArchConfig, params, *, num_pages: int = 256,
                 page_size: int = 128, max_pages_per_seq: int = 16,
                 mode: str = "fused",
                 ragged_attention: bool = True,
                 capture_logits: bool = False,
                 kv_dtype: str = "fp32",
                 trim_page_tables: bool = True,
                 mesh=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if mode not in ("fused", "sequential"):
            raise ValueError(f"unknown mode {mode!r}")
        if mesh is not None:
            raise _later("mesh sharding", "queue A13")
        if cfg.family != "dense" or cfg.moe is not None or cfg.ssm is not None:
            raise _later(f"the {cfg.family} family", "queue A11")
        self.cfg = cfg
        self.mode = mode
        self.page_size = page_size
        self.params = params_to(params, self.device)
        self._layers = layer_views(self.params, cfg.n_layers)
        # fused-step attention backend (DESIGN.md §11): the packed stream
        # feeds the ragged kernel directly; False routes q through a
        # host-staged per-sequence padded view into the batched kernel
        self.ragged_attention = ragged_attention
        # pages-bucket trim (DESIGN.md §14): stage fused block tables at the
        # ladder over the step's widest table instead of max_pages_per_seq
        self.trim_page_tables = trim_page_tables
        self.alloc = BlockAllocator(num_pages, page_size)
        # page 0 is the trash page: bucket-padding tokens write there so
        # they can never clobber a live slot (attention masks them anyway)
        reserved = self.alloc.extend(-1, page_size)
        assert reserved == [0]
        self.max_pages = max_pages_per_seq
        shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
                 cfg.head_dim)
        # quantized paged KV (DESIGN.md §14): values stored int8/fp8 in the
        # data pages, per-(token, kv-head) f32 scales in the allocator's
        # scale pages; None = unquantized fp32 storage
        self.kv_dtype = kv_dtype
        self.qspec = kv_quant_spec(kv_dtype, self.device)
        if self.qspec is None:
            self.k_pages = torch.zeros(shape, dtype=torch.float32,
                                       device=self.device)
            self.v_pages = torch.zeros(shape, dtype=torch.float32,
                                       device=self.device)
            self.k_scales = self.v_scales = None
        else:
            # zero bytes are 0 in int8 and in e4m3fn
            self.k_pages, self.v_pages = (
                torch.zeros(shape, dtype=torch.uint8, device=self.device)
                .view(self.qspec.dtype) for _ in range(2))
            self.k_scales = torch.zeros(shape[:-1], dtype=torch.float32,
                                        device=self.device)
            self.v_scales = torch.zeros(shape[:-1], dtype=torch.float32,
                                        device=self.device)
            # pad tokens redirect scales to the trash page's scale page,
            # which the construction order above pins to id 0
            assert self.alloc.scale_of[0] == 0
        # speculative decode (DESIGN.md §18): a draft adapter installed via
        # set_draft() enables execute_multi(speculate=γ); force_reject
        # zeroes every acceptance on the device (the parity edge case)
        self.draft = None
        self.spec_force_reject = False
        self.last_spec_accepted = 0
        self.last_spec_drafted = 0
        # items the last execute() could not serve (out of KV blocks); the
        # engine skips their progress so the scheduler retries them
        self.last_deferred: frozenset[int] = frozenset()
        # opt-in test/bench introspection: req_id -> np logits of the last
        # step. Off by default — the extra device→host logits copy would
        # land inside the wall-clock the §3.2 calibration observes.
        self.capture_logits = capture_logits
        self.last_logits: dict[int, np.ndarray] = {}
        # dispatch / bucket-ladder accounting (DESIGN.md §11), kept with the
        # JAX executor's meaning so its counting pins carry over
        self.n_dispatches = 0
        self.compile_keys: set = set()
        self._staging: dict[tuple, tuple[np.ndarray, dict]] = {}

    # ------------------------------------------------------------------
    # step bodies: device work only, no host round trip inside
    # ------------------------------------------------------------------

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.params["embed"][tokens.long()]

    def _head(self, h_last: torch.Tensor) -> torch.Tensor:
        p = self.params
        return rmsnorm(h_last, p["ln_f"], self.cfg.norm_eps) @ p["head"]

    def _forward(self, x, positions, tables, ctx_lens, valid=None,
                 n_layers=None, stables=None):
        """Paged forward over the executor's pools (``paged_forward``);
        ``stables`` the scale tables parallel to ``tables`` when the pools
        are quantized."""
        scales = None if self.qspec is None else ScalePools(
            self.qspec, self.k_scales, self.v_scales, stables)
        return paged_forward(self.cfg, self._layers, self.k_pages,
                             self.v_pages, x, positions, tables, ctx_lens,
                             self.page_size, valid, n_layers, scales)

    @torch.no_grad()
    def _chunk_step(self, st: dict, n_valid: int) -> torch.Tensor:
        """One prefill chunk, B=1 (sequential mode). ``st``: tokens and
        positions (n_tok,) — pad tokens keep monotone positions (the causal
        mask stays exact) but their K/V lands on the trash page — table
        (max_pages,), ctx (1,) excluding the pad, and when quantized the
        scale table ``stable`` (max_pages,). Returns the last real token's
        logits (vocab,)."""
        n_tok = st["tokens"].shape[0]
        x = self._embed(st["tokens"])[None]                # (1, T, d)
        valid = (torch.arange(n_tok, device=self.device) < n_valid)[None]
        stable = st.get("stable")
        x = self._forward(x, st["positions"][None], st["table"][None],
                          st["ctx"], valid,
                          stables=None if stable is None else stable[None])
        return self._head(x[0, max(n_valid - 1, 0)])

    @torch.no_grad()
    def _decode_step(self, st: dict) -> torch.Tensor:
        """One decode token per row: tokens/positions/ctx (B,), tables (and
        when quantized stables) (B, max_pages). Returns logits (B, vocab)."""
        x = self._embed(st["tokens"])[:, None]            # (B, 1, d)
        x = self._forward(x, st["positions"][:, None], st["tables"],
                          st["ctx"], stables=st.get("stables"))
        return self._head(x[:, 0])

    @torch.no_grad()
    def _multi_decode_step(self, st: dict, horizon: int) -> torch.Tensor:
        """``horizon`` greedy decode steps as ONE dispatch (DESIGN.md §12).

        Each iteration is exactly the ``_decode_step`` body — same shapes,
        same ops, so emitted tokens equal running the steps one dispatch at
        a time — with the argmax token fed back on the device and K/V
        writes advancing in-loop (the caller pre-reserved ``horizon`` slots
        per sequence in the block tables). Nothing here waits for the
        device. Returns the (horizon, B) int32 token matrix.
        """
        tokens, positions, ctx = st["tokens"], st["positions"], st["ctx"]
        emitted = []
        for h in range(horizon):
            x = self._embed(tokens)[:, None]              # (B, 1, d)
            x = self._forward(x, (positions + h)[:, None], st["tables"],
                              ctx + h, stables=st.get("stables"))
            tokens = self._head(x[:, 0]).argmax(-1).to(torch.int32)
            emitted.append(tokens)
        return torch.stack(emitted)

    @torch.no_grad()
    def _spec_multi_step(self, st: dict, *, rounds: int, gamma: int,
                         force_reject: bool) -> torch.Tensor:
        """``rounds`` speculative draft/verify rounds as ONE dispatch
        (DESIGN.md §18).

        Per round: γ draft steps (argmax fed forward) build the candidate
        run; one Tq=γ+1 target pass verifies the fed-back token plus every
        draft at once; ``n_acc`` leading draft/target matches accept, the
        verified argmax covers the rejection slot, and per-sequence state
        (token, position, context) advances by ``eff = min(n_acc+1,
        remaining)`` on the device. A sequence whose emission budget
        (``max_emit``) is exhausted freezes: eff=0, its rewrites are
        byte-idempotent, its state holds. The emitted tokens are always
        target argmaxes over exactly the sequential pass's visible key set.
        ``force_reject`` zeroes every match (pure verified fallback).

        Returns one int32 tensor (B, R·(γ+1) + 1 + R): the emitted tokens
        (``[:, :counts]`` is each sequence's stream), the count, and each
        round's emission — concatenated so one copy brings them all home.
        """
        draft = self.draft
        G = gamma + 1
        cur_tok, cur_pos, cur_ctx = st["tokens"], st["positions"], st["ctx"]
        tables, max_emit = st["tables"], st["max_emit"]
        stables = st.get("stables")
        bsz = cur_tok.shape[0]
        dev = cur_tok.device
        counts = torch.zeros(bsz, dtype=torch.int32, device=dev)
        # the last column takes the writes JAX's mode="drop" would drop
        emitted = torch.zeros((bsz, rounds * G + 1), dtype=torch.int32,
                              device=dev)
        rows = torch.arange(bsz, device=dev)
        steps = torch.arange(G, dtype=torch.int32, device=dev)[None]
        accs = []
        for _ in range(rounds):
            feed = [cur_tok]
            tok = cur_tok
            for j in range(gamma):
                logits = draft.step(tok, cur_pos + j, tables, stables,
                                    cur_ctx + j)
                tok = logits.argmax(-1).to(torch.int32)
                feed.append(tok)
            if draft.needs_sync_pass:
                # write the last draft token's own draft-KV so a fully-
                # accepting sequence enters the next round with complete
                # draft context (logits discarded)
                draft.step(tok, cur_pos + gamma, tables, stables,
                           cur_ctx + gamma)
            feed = torch.stack(feed, dim=1)                   # (B, G)
            x = self._forward(self._embed(feed), cur_pos[:, None] + steps,
                              tables, cur_ctx + gamma, stables=stables)
            tgt = self._head(x).argmax(-1).to(torch.int32)    # (B, G)
            match = (feed[:, 1:] == tgt[:, :-1]).to(torch.int32)
            if force_reject:
                match = match * 0
            n_acc = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
            eff = torch.minimum(n_acc + 1, (max_emit - counts).clamp(min=0))
            idx = torch.where(steps < eff[:, None], counts[:, None] + steps,
                              rounds * G)
            emitted.scatter_(1, idx.long(), tgt)
            accs.append(eff)
            counts = counts + eff
            last = tgt[rows, (eff - 1).clamp(min=0).long()]
            cur_tok = torch.where(eff > 0, last, cur_tok)
            cur_pos = cur_pos + eff
            cur_ctx = cur_ctx + eff
        return torch.cat([emitted[:, :rounds * G], counts[:, None],
                          torch.stack(accs, dim=1)], dim=1)

    @torch.no_grad()
    def _fused_step(self, st: dict, t_bucket: int) -> torch.Tensor:
        """The whole BatchPlan as ONE forward (DESIGN.md §11).

        ``st`` holds the staged int32 arrays on the device: tokens,
        positions, tok_pages, tok_slots (T,) — the packed stream, padding →
        trash page; tables (S, pg_bucket); ctx, q_starts, q_lens, pos0,
        last_idx (S,); for the batched backend also seq_gather (S, Tq) and
        pack_gather (T,), the packed↔per-sequence row maps; when quantized
        also tok_spages (T,) and stables (S, pg_bucket), the scale-page
        routing (DESIGN.md §14). Per layer: one K/V scatter for every
        sequence's writes and one attention launch; at the top one head
        projection over each sequence's last-token hidden state. Returns
        the logits (S, vocab).
        """
        cfg = self.cfg
        spec = self.qspec
        x = self._embed(st["tokens"])                      # (T, d)
        pos2d = st["positions"][None]
        idx = (st["tok_pages"].long(), st["tok_slots"].long())
        sidx = sk = sv = None
        if spec is not None:
            sidx = (st["tok_spages"].long(), idx[1])
        if not self.ragged_attention:
            seq_gather = st["seq_gather"].long()           # (S, Tq)
            pack_gather = st["pack_gather"].long()         # (T,)
        for l, lp in enumerate(self._layers):
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = attn_qkv(lp["attn"], h[None], pos2d, cfg)
            kp, vp = self.k_pages[l], self.v_pages[l]
            if spec is not None:
                sk, sv = self.k_scales[l], self.v_scales[l]
            # in place, where JAX's .at[].set returns new pools. Pad tokens
            # all write trash page 0, slot 0 (and trash scale page 0): those
            # duplicates are harmless because attention never reads them.
            scatter_kv(kp, k[0], idx, spec, sk, sidx)
            scatter_kv(vp, v[0], idx, spec, sv, sidx)
            if self.ragged_attention:
                meta = (st["ctx"], st["q_starts"], st["q_lens"], st["pos0"])
                if spec is None:
                    o = paged_attention_ragged_op(q[0], kp, vp, st["tables"],
                                                  *meta, window=cfg.window)
                else:
                    o = paged_attention_ragged_quant_op(
                        q[0], kp, vp, sk, sv, st["tables"], st["stables"],
                        *meta, window=cfg.window)
            else:
                qv = q[0][seq_gather]
                if spec is None:
                    ov = paged_attention_op(qv, kp, vp, st["tables"],
                                            st["ctx"], st["pos0"],
                                            window=cfg.window)
                else:
                    ov = paged_attention_quant_op(
                        qv, kp, vp, sk, sv, st["tables"], st["stables"],
                        st["ctx"], st["pos0"], window=cfg.window)
                o = ov.reshape(-1, *ov.shape[2:])[pack_gather]
            x = x + o.reshape(t_bucket, cfg.q_dim) @ lp["attn"]["wo"]
            x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
        return self._head(x[st["last_idx"].long()])        # (S, vocab)

    # ------------------------------------------------------------------

    def attach_cache(self, prefix_cache) -> None:
        raise _later("the prefix cache", "queue A9")

    def _extend(self, req_id: int, n_tokens: int, *,
                mirror_cow: bool = True) -> Optional[list]:
        """Allocator extend; COW page copies are mirrored into the device
        K/V per call unless ``mirror_cow=False`` (the fused path drains the
        whole step's events in one batched copy — ``_mirror_cow_batched``)."""
        tbl = self.alloc.extend(req_id, n_tokens)
        if mirror_cow:
            self._mirror_cow_batched()
        return tbl

    def _mirror_cow_batched(self) -> None:
        """Drain every pending COW event as one gather/scatter per pool.

        Scale pages copy in the same drain (DESIGN.md §14): the allocator
        paired each COW'd data page with a fresh scale page, so values and
        their dequant scales stay in lock-step."""
        old, new, s_old, s_new = self.alloc.pop_cow_events_batched()
        if old:
            def ids(a):
                return torch.as_tensor(a, dtype=torch.long,
                                       device=self.device)
            src, dst = ids(old), ids(new)
            for pool in (self.k_pages, self.v_pages):
                raw = raw_pool(pool)
                raw[:, dst] = raw[:, src]
            if self.qspec is not None:
                s_src, s_dst = ids(s_old), ids(s_new)
                self.k_scales[:, s_dst] = self.k_scales[:, s_src]
                self.v_scales[:, s_dst] = self.v_scales[:, s_src]
            if self.draft is not None:
                # draft pools index the same global page ids (DESIGN.md §18)
                self.draft.mirror_cow(src, dst)

    def execute(self, plan: BatchPlan, requests, now: float) -> tuple[float, dict]:
        if self.mode == "sequential":
            return self._execute_sequential(plan, requests, now)
        return self._execute_fused(plan, requests, now)

    # ------------------------------------------------------------------
    # staging: every dispatch's inputs go to the device in one copy
    # ------------------------------------------------------------------

    def _to_device(self, flat: np.ndarray, views: dict) -> dict:
        """One host→device copy of the staging buffer, cut like ``views``."""
        buf = torch.from_numpy(flat).to(self.device)
        out, off = {}, 0
        for name, a in views.items():
            out[name] = buf[off:off + a.size].view(a.shape)
            off += a.size
        return out

    def _stage(self, arrays: dict) -> dict:
        """Named int32 arrays → device tensors, in one host→device copy."""
        flat = np.concatenate([np.asarray(a, np.int32).ravel()
                               for a in arrays.values()])
        views = {k: np.asarray(a) for k, a in arrays.items()}
        return self._to_device(flat, views)

    def _table(self, req_id: int) -> np.ndarray:
        """The request's block table, zero-padded (→ trash page 0) to
        ``max_pages`` columns."""
        tbl = self.alloc.tables.get(req_id, [])
        pad = self.max_pages - len(tbl)
        assert pad >= 0, "max_pages_per_seq exceeded"
        return np.asarray(tbl + [0] * pad, np.int32)

    def _stable(self, req_id: int) -> np.ndarray:
        """The request's scale-page table, parallel to ``_table``
        (DESIGN.md §14); quantized executors only."""
        stbl = self.alloc.scale_table(req_id)
        return np.asarray(stbl + [0] * (self.max_pages - len(stbl)), np.int32)

    def _stage_decode(self, ids: list, requests, tokens: list,
                      bsz: int, **extra) -> dict:
        """A decode batch padded to ``bsz`` rows: tokens (the fed-back
        ones), positions, ctx (B,), tables (and when quantized stables)
        (B, max_pages), plus ``extra`` (B,) columns whose pad rows are 0.
        Pad rows read and write only the trash page and its scale page
        (table 0, position 0, context 1)."""
        a = {"tokens": np.zeros(bsz, np.int32),
             "positions": np.zeros(bsz, np.int32),
             "ctx": np.ones(bsz, np.int32),
             "tables": np.zeros((bsz, self.max_pages), np.int32)}
        for i, rid in enumerate(ids):
            req = requests[rid]
            a["tokens"][i] = tokens[i]
            # the fed-back token's position: context counts it as emitted,
            # but its K/V enters the cache only now
            a["positions"][i] = req.context - 1
            a["ctx"][i] = req.context
            a["tables"][i] = self._table(rid)
        if self.qspec is not None:
            a["stables"] = np.zeros((bsz, self.max_pages), np.int32)
            for i, rid in enumerate(ids):
                a["stables"][i] = self._stable(rid)
        for name, col in extra.items():
            a[name] = np.zeros(bsz, np.int32)
            a[name][:len(col)] = col
        return self._stage(a)

    @staticmethod
    def _fed_back(req) -> int:
        return req.generated_tokens[-1] if req.generated_tokens else 0

    # ------------------------------------------------------------------
    # slack-bounded multi-step decode commitment (DESIGN.md §12)
    # ------------------------------------------------------------------

    def set_draft(self, draft) -> None:
        """Install a draft adapter (``spec_decode``); enables
        ``execute_multi(speculate=γ)``."""
        draft.bind(self)
        self.draft = draft

    def execute_multi(self, plan: BatchPlan, requests, now: float,
                      horizon: int, *, speculate: int = 0) -> tuple[list, dict]:
        """Run ``horizon`` committed decode steps as ONE device dispatch.

        The engine only commits all-decode plans (``capacity.commit_horizon``
        gates how deep). KV pages for all ``horizon`` tokens per sequence
        are reserved up front; the loop feeds each step's argmax token back
        on the device and advances K/V writes in-loop; the (horizon, B)
        token matrix comes home in one copy at the end. Returns
        ``(steps, emitted_seq)`` where ``steps`` is one
        ``(dt, new_tokens, context)`` triple per internal step (the §3.2
        observation stream) and ``emitted_seq`` maps req_id to its
        ``horizon`` output tokens. Out-of-blocks sequences defer whole
        (``last_deferred``), exactly like the single-step paths.

        ``speculate=γ > 0`` routes to the speculative draft/verify path
        (``horizon`` becomes the round count; requires ``set_draft``); its
        second return value is then one dict PER ROUND mapping req_id to
        that round's emitted tokens (DESIGN.md §18).

        ``capture_logits`` is not supported on any multi-step path — the
        per-step logits never leave the device — and raises loudly rather
        than silently returning stale ``last_logits``.
        """
        if self.capture_logits:
            raise ValueError(
                "capture_logits is not supported on the multi-step/"
                "speculative decode path: per-step logits never leave the "
                "device (run with commit_horizon=1/speculate=0, or disable "
                "capture_logits)")
        if speculate > 0:
            return self._execute_spec(plan, requests, now, horizon, speculate)
        assert not plan.prefill_items, "multi-step commitment is decode-only"
        t0 = time.perf_counter()
        deferred: set[int] = set()
        ids = []
        for it in plan.decode_items:
            if self._extend(it.req_id, horizon) is None:
                deferred.add(it.req_id)   # out of KV blocks: defer & retry
                continue
            ids.append(it.req_id)
        self.last_deferred = frozenset(deferred)
        self.last_logits = {}
        if not ids:
            return [(time.perf_counter() - t0, 0, 0)], {}
        bsz = _bucket(len(ids), 4)
        st = self._stage_decode(ids, requests,
                                [self._fed_back(requests[r]) for r in ids],
                                bsz)
        self.n_dispatches += 1
        self.compile_keys.add(("multi", bsz, horizon))
        toks_np = self._multi_decode_step(st, horizon).cpu().numpy()
        dt = time.perf_counter() - t0
        emitted_seq = {rid: [int(toks_np[h, i]) for h in range(horizon)]
                       for i, rid in enumerate(ids)}
        # per-internal-step accounting: contexts grow one token per step,
        # capped by the arch's attention window like SchedTask.cost_context
        base = [(requests[rid].context, requests[rid].window) for rid in ids]
        steps = [(dt / horizon, len(ids),
                  sum(min(c + h, w) if w else c + h for c, w in base))
                 for h in range(horizon)]
        return steps, emitted_seq

    def _execute_spec(self, plan: BatchPlan, requests, now: float,
                      rounds: int, gamma: int) -> tuple[list, list]:
        """``rounds`` speculative draft/verify rounds as ONE dispatch.

        Reserves the optimistic ``rounds·(γ+1)`` KV slots per sequence up
        front (a mid-run dispatch cannot defer), runs the round loop on the
        device, then reclaims every rejected slot with the slot-granular
        ``shrink_to`` — post-run each sequence holds exactly
        ``context - 1 + emitted`` slots, as a non-speculative run emitting
        the same stream would. Returns ``(steps, emitted_rounds)``: one §3.2
        observation triple and one {req_id: [tokens]} dict per round.
        """
        assert not plan.prefill_items, "speculative rounds are decode-only"
        assert self.draft is not None, \
            "execute_multi(speculate=γ) requires set_draft()"
        t0 = time.perf_counter()
        G = gamma + 1
        deferred: set[int] = set()
        ids, pre_lens = [], {}
        for it in plan.decode_items:
            pre = self.alloc.context_len(it.req_id)
            if self._extend(it.req_id, rounds * G) is None:
                deferred.add(it.req_id)   # out of KV blocks: defer & retry
                continue
            ids.append(it.req_id)
            pre_lens[it.req_id] = pre
        self.last_deferred = frozenset(deferred)
        self.last_logits = {}
        self.last_spec_accepted = self.last_spec_drafted = 0
        if not ids:
            return [(time.perf_counter() - t0, 0, 0)], [{}]
        self.draft.prepare(ids, requests)
        bsz = _bucket(len(ids), 4)
        st = self._stage_decode(
            ids, requests, [self._fed_back(requests[r]) for r in ids], bsz,
            # padded rows never emit
            max_emit=[requests[r].max_new_tokens - requests[r].generated
                      for r in ids])
        self.n_dispatches += 1
        self.compile_keys.add(("spec", bsz, rounds, gamma))
        out = self._spec_multi_step(
            st, rounds=rounds, gamma=gamma,
            force_reject=self.spec_force_reject).cpu().numpy()
        em, cnt, acc = out[:, :rounds * G], out[:, rounds * G], \
            out[:, rounds * G + 1:]                        # acc: (bsz, R)
        dt = time.perf_counter() - t0
        emitted_rounds: list[dict] = [{} for _ in range(rounds)]
        for i, rid in enumerate(ids):
            e = int(cnt[i])
            off = 0
            for r in range(rounds):
                k = int(acc[i, r])
                emitted_rounds[r][rid] = [int(x) for x in em[i, off:off + k]]
                off += k
            # reclaim rejected reservation: keep exactly the accepted run
            self.alloc.shrink_to(rid, pre_lens[rid] + e)
            self.draft.note_progress(rid, pre_lens[rid] + e)
            self.last_spec_accepted += sum(
                max(int(acc[i, r]) - 1, 0) for r in range(rounds))
        self.last_spec_drafted = rounds * len(ids) * gamma
        # per-round §3.2 observations: the verify pass computes n·(γ+1)
        # target tokens per round (draft cost is folded into the measured
        # dt — the calibration absorbs it as per-token overhead) over
        # contexts grown by each round's actual acceptance, window-capped
        base = [(requests[rid].context, requests[rid].window) for rid in ids]
        steps, grown = [], np.zeros(len(ids), np.int64)
        for r in range(rounds):
            c = sum(min(b + int(g), w) if w else b + int(g)
                    for (b, w), g in zip(base, grown))
            steps.append((dt / rounds, len(ids) * G, c))
            grown += acc[:len(ids), r]
        return steps, emitted_rounds

    def rollback_tokens(self, req_id: int, n_tokens: int) -> None:
        """Return a rolled-back dispatch's reserved KV slots (DESIGN.md §12).

        The stale K/V written beyond the request's committed length is
        unreachable — context lengths never covered it — so releasing the
        reservation is the whole rollback.
        """
        self.alloc.shrink(req_id, n_tokens)
        if self.draft is not None:
            self.draft.clamp(req_id, self.alloc.context_len(req_id))

    # ------------------------------------------------------------------
    # fused path: pack the whole plan, launch once
    # ------------------------------------------------------------------

    def _get_staging(self, t_bucket: int, s_bucket: int, tq_bucket: int,
                     pg_bucket: int) -> tuple[np.ndarray, dict]:
        """One preallocated int32 staging buffer per bucket key, cut into
        named views, so the whole step goes to the device in one copy.

        Block tables stage at ``pg_bucket`` columns — the step's pages
        bucket, not ``max_pages`` — so attention never scores table padding
        the mask would discard anyway. The batched backend also stages the
        packed↔per-sequence row maps, and a quantized executor the
        scale-page routing (tok_spages, stables)."""
        key = (t_bucket, s_bucket, tq_bucket, pg_bucket)
        hit = self._staging.get(key)
        if hit is not None:
            hit[0].fill(0)
            return hit
        shapes = {"tokens": (t_bucket,), "positions": (t_bucket,),
                  "tok_pages": (t_bucket,), "tok_slots": (t_bucket,),
                  "tables": (s_bucket, pg_bucket), "ctx": (s_bucket,),
                  "q_starts": (s_bucket,), "q_lens": (s_bucket,),
                  "pos0": (s_bucket,), "last_idx": (s_bucket,)}
        if not self.ragged_attention:
            shapes.update(seq_gather=(s_bucket, tq_bucket),
                          pack_gather=(t_bucket,))
        if self.qspec is not None:
            shapes.update(tok_spages=(t_bucket,),
                          stables=(s_bucket, pg_bucket))
        flat = np.zeros(sum(math.prod(s) for s in shapes.values()), np.int32)
        views, off = {}, 0
        for name, shape in shapes.items():
            n = math.prod(shape)
            views[name] = flat[off:off + n].reshape(shape)
            off += n
        self._staging[key] = (flat, views)
        return flat, views

    def _execute_fused(self, plan: BatchPlan, requests,
                       now: float) -> tuple[float, dict]:
        t0 = time.perf_counter()
        seqs: list[_PackedSeq] = []
        deferred: set[int] = set()
        prefill_rids = set()
        for it in plan.prefill_items:
            req = requests[it.req_id]
            prefill_rids.add(it.req_id)
            if self._extend(it.req_id, it.n_tokens, mirror_cow=False) is None:
                deferred.add(it.req_id)   # out of KV blocks: defer & retry
                continue
            chunk = req.tokens[req.prefilled:req.prefilled + it.n_tokens]
            seqs.append(_PackedSeq(
                it.req_id, chunk, pos0=req.prefilled,
                ctx=req.prefilled + len(chunk),
                emits=req.prefilled + it.n_tokens == req.prompt_len))
        for it in plan.decode_items:
            req = requests[it.req_id]
            # a single launch computes every emission at once, so it cannot
            # feed a same-step prefill emission back into a decode item
            assert it.req_id not in prefill_rids, \
                "fused step: request cannot both prefill and decode in one plan"
            if self._extend(it.req_id, 1, mirror_cow=False) is None:
                deferred.add(it.req_id)
                continue
            # the fed-back token's position: context counts it as emitted,
            # but its K/V enters the cache only now
            seqs.append(_PackedSeq(it.req_id, [self._fed_back(req)],
                                   pos0=req.context - 1,
                                   ctx=req.context, emits=True))
        self.last_deferred = frozenset(deferred)
        self.last_logits = {}
        if not seqs:
            return time.perf_counter() - t0, {}
        self._mirror_cow_batched()

        n_tok = sum(len(s.tokens) for s in seqs)
        t_bucket = _ladder(n_tok, 4)
        s_bucket = _ladder(len(seqs), 4)
        tq_bucket = _bucket(max(len(s.tokens) for s in seqs), 1)
        # pages bucket (DESIGN.md §14): trim staged block tables to the
        # ladder over the step's widest table — early steps attend over a
        # fraction of max_pages_per_seq instead of always paying for it
        if self.trim_page_tables:
            max_pg = max(len(self.alloc.tables[s.req_id]) for s in seqs)
            pg_bucket = min(self.max_pages, _ladder(max_pg, 2))
        else:
            pg_bucket = self.max_pages
        flat, st = self._get_staging(t_bucket, s_bucket, tq_bucket, pg_bucket)
        off = 0
        for i, s in enumerate(seqs):
            n = len(s.tokens)
            pos = np.arange(s.pos0, s.pos0 + n, dtype=np.int32)
            tbl = np.asarray(self.alloc.tables[s.req_id], np.int32)
            assert len(tbl) <= pg_bucket, "pages bucket exceeded"
            st["tokens"][off:off + n] = s.tokens
            st["positions"][off:off + n] = pos
            st["tok_pages"][off:off + n] = tbl[pos // self.page_size]
            st["tok_slots"][off:off + n] = pos % self.page_size
            st["tables"][i, :len(tbl)] = tbl
            st["ctx"][i] = s.ctx
            st["q_starts"][i] = off
            st["q_lens"][i] = n
            st["pos0"][i] = s.pos0
            st["last_idx"][i] = off + n - 1
            if not self.ragged_attention:
                st["seq_gather"][i, :n] = np.arange(off, off + n)
                st["pack_gather"][off:off + n] = i * tq_bucket + np.arange(n)
            if self.qspec is not None:
                stbl = np.asarray(self.alloc.scale_table(s.req_id), np.int32)
                st["tok_spages"][off:off + n] = stbl[pos // self.page_size]
                st["stables"][i, :len(stbl)] = stbl
            off += n

        self.n_dispatches += 1
        self.compile_keys.add(("fused", t_bucket, s_bucket, tq_bucket,
                               pg_bucket))
        logits = self._fused_step(self._to_device(flat, st), t_bucket)
        # the argmax copy to the host waits for the device, so the step
        # time below covers the whole step even when nothing emits
        nxt = logits.argmax(-1).cpu().numpy()
        lg = logits.cpu().numpy() if self.capture_logits else None
        emitted: dict[int, int] = {}
        for i, s in enumerate(seqs):
            if s.emits:
                emitted[s.req_id] = int(nxt[i])
                if lg is not None:
                    self.last_logits[s.req_id] = lg[i].copy()
        return time.perf_counter() - t0, emitted

    # ------------------------------------------------------------------
    # sequential escape hatch: per-item launches (parity oracle / benches)
    # ------------------------------------------------------------------

    def _execute_sequential(self, plan: BatchPlan, requests,
                            now: float) -> tuple[float, dict]:
        t0 = time.perf_counter()
        emitted: dict[int, int] = {}
        deferred: set[int] = set()
        self.last_logits = {}
        for it in plan.prefill_items:
            req = requests[it.req_id]
            if self._extend(it.req_id, it.n_tokens) is None:
                deferred.add(it.req_id)   # out of KV blocks: defer & retry
                continue
            chunk = req.tokens[req.prefilled:req.prefilled + it.n_tokens]
            n_tok = _bucket(len(chunk), 16)
            arrays = {
                "tokens": chunk + [0] * (n_tok - len(chunk)),
                "positions": np.arange(req.prefilled, req.prefilled + n_tok),
                "table": self._table(it.req_id),
                "ctx": [req.prefilled + len(chunk)]}
            if self.qspec is not None:
                arrays["stable"] = self._stable(it.req_id)
            st = self._stage(arrays)
            self.n_dispatches += 1
            self.compile_keys.add(("chunk", n_tok))
            logits = self._chunk_step(st, len(chunk))
            if req.prefilled + it.n_tokens == req.prompt_len:
                emitted[it.req_id] = int(logits.argmax())
                if self.capture_logits:
                    self.last_logits[it.req_id] = logits.cpu().numpy()
        ids = []
        for it in plan.decode_items:
            if self._extend(it.req_id, 1) is None:
                deferred.add(it.req_id)
                continue
            ids.append(it.req_id)
        if ids:
            bsz = _bucket(len(ids), 4)
            toks = [requests[r].generated_tokens[-1]
                    if requests[r].generated_tokens else emitted.get(r, 0)
                    for r in ids]
            st = self._stage_decode(ids, requests, toks, bsz)
            self.n_dispatches += 1
            self.compile_keys.add(("decode", bsz))
            logits = self._decode_step(st)
            nxt = logits.argmax(-1).cpu().numpy()
            lg = logits.cpu().numpy() if self.capture_logits else None
            for i, rid in enumerate(ids):
                emitted[rid] = int(nxt[i])
                if lg is not None:
                    self.last_logits[rid] = lg[i].copy()
        self.last_deferred = frozenset(deferred)
        return time.perf_counter() - t0, emitted

    def stats(self) -> dict:
        """Dispatch/bucket counters for benches and regression guards."""
        return {"dispatches": self.n_dispatches,
                "compile_keys": len(self.compile_keys)}

    def release(self, req_id: int) -> None:
        self.alloc.release(req_id)
        if self.draft is not None:
            self.draft.release(req_id)
