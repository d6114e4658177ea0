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
  math reasons about. Attention always takes the ragged paged contract:
  the hand-written CUDA kernel on the card, its plain PyTorch version on
  the CPU. The time ``execute`` returns ends after the device finished
  the step (the argmax copy to the host synchronizes every step).

Not ported yet (each raises ``NotImplementedError``): ``mode="sequential"``,
quantized KV (``kv_dtype != "fp32"``), ``mesh`` sharding, the MoE family,
``set_draft`` and ``attach_cache``. ``execute_multi`` is left undefined,
so the engine takes its single-step path.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..core.cost_model import LinearCostModel
from ..core.types import BatchPlan
from ..kernels.ops import paged_attention_ragged_op
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


class PagedTransformerExecutor:
    """Real hybrid-step executor over a paged KV cache (dense GQA, fp32).

    ``params`` is the JAX package's parameter tree as tensors
    (``models.weights.params_from_numpy`` or ``init_params``); it is moved
    to ``device``. ``device=None`` means the CUDA card and raises without
    one; ``device="cpu"`` runs the plain PyTorch path.
    """

    def __init__(self, cfg: ArchConfig, params, *, num_pages: int = 256,
                 page_size: int = 128, max_pages_per_seq: int = 16,
                 mode: str = "fused",
                 capture_logits: bool = False,
                 kv_dtype: str = "fp32",
                 trim_page_tables: bool = True,
                 mesh=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if mode == "sequential":
            raise _later("mode='sequential'", "queue A5, kernel B3")
        if mode != "fused":
            raise ValueError(f"unknown mode {mode!r}")
        if kv_dtype != "fp32":
            raise _later(f"kv_dtype={kv_dtype!r}", "queue A6, kernel B2")
        if mesh is not None:
            raise _later("mesh sharding", "queue A13")
        if cfg.family != "dense" or cfg.moe is not None or cfg.ssm is not None:
            raise _later(f"the {cfg.family} family", "queue A11")
        self.cfg = cfg
        self.mode = mode
        self.page_size = page_size
        self.params = params_to(params, self.device)
        lay = self.params["layers"]
        self._layers = [
            {"attn": {k: w[l] for k, w in lay["attn"].items()},
             "mlp": {k: w[l] for k, w in lay["mlp"].items()},
             "ln1": lay["ln1"][l], "ln2": lay["ln2"][l]}
            for l in range(cfg.n_layers)]
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
        self.k_pages = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
        self.v_pages = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
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
    # the fused step body
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _fused_step(self, st: dict, t_bucket: int) -> torch.Tensor:
        """The whole BatchPlan as ONE forward (DESIGN.md §11).

        ``st`` holds the staged int32 arrays on the device: tokens,
        positions, tok_pages, tok_slots (T,) — the packed stream, padding →
        trash page; tables (S, pg_bucket); ctx, q_starts, q_lens, pos0,
        last_idx (S,). Per layer: one K/V scatter for every sequence's
        writes and one ragged attention launch; at the top one head
        projection over each sequence's last-token hidden state. Returns
        the logits (S, vocab).
        """
        cfg, p = self.cfg, self.params
        x = p["embed"][st["tokens"].long()]                # (T, d)
        pos2d = st["positions"][None]
        tok_pages = st["tok_pages"].long()
        tok_slots = st["tok_slots"].long()
        for l, lp in enumerate(self._layers):
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = attn_qkv(lp["attn"], h[None], pos2d, cfg)
            # in place, where JAX's .at[].set returns new pools. Pad tokens
            # all write trash page 0, slot 0: those duplicates are harmless
            # because attention never reads that page.
            self.k_pages[l].index_put_((tok_pages, tok_slots), k[0])
            self.v_pages[l].index_put_((tok_pages, tok_slots), v[0])
            o = paged_attention_ragged_op(
                q[0], self.k_pages[l], self.v_pages[l], st["tables"],
                st["ctx"], st["q_starts"], st["q_lens"], st["pos0"],
                window=cfg.window)
            x = x + o.reshape(t_bucket, cfg.q_dim) @ lp["attn"]["wo"]
            x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
        h_last = x[st["last_idx"].long()]                  # (S, d)
        return rmsnorm(h_last, p["ln_f"], cfg.norm_eps) @ p["head"]

    # ------------------------------------------------------------------

    def attach_cache(self, prefix_cache) -> None:
        raise _later("the prefix cache", "queue A9")

    def set_draft(self, draft) -> None:
        raise _later("speculative decode", "queue A8")

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
        """Drain every pending COW event as one gather/scatter per pool."""
        old, new, _, _ = self.alloc.pop_cow_events_batched()
        if old:
            src = torch.as_tensor(old, dtype=torch.long, device=self.device)
            dst = torch.as_tensor(new, dtype=torch.long, device=self.device)
            self.k_pages[:, dst] = self.k_pages[:, src]
            self.v_pages[:, dst] = self.v_pages[:, src]

    def execute(self, plan: BatchPlan, requests, now: float) -> tuple[float, dict]:
        return self._execute_fused(plan, requests, now)

    def rollback_tokens(self, req_id: int, n_tokens: int) -> None:
        """Return a rolled-back dispatch's reserved KV slots (DESIGN.md §12).

        The stale K/V written beyond the request's committed length is
        unreachable — context lengths never covered it — so releasing the
        reservation is the whole rollback.
        """
        self.alloc.shrink(req_id, n_tokens)

    # ------------------------------------------------------------------
    # fused path: pack the whole plan, launch once
    # ------------------------------------------------------------------

    def _get_staging(self, t_bucket: int, s_bucket: int, tq_bucket: int,
                     pg_bucket: int) -> tuple[np.ndarray, dict]:
        """One preallocated int32 staging buffer per bucket key, cut into
        named views, so the whole step goes to the device in one copy.

        Block tables stage at ``pg_bucket`` columns — the step's pages
        bucket, not ``max_pages`` — so attention never scores table padding
        the mask would discard anyway."""
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
        flat = np.zeros(sum(math.prod(s) for s in shapes.values()), np.int32)
        views, off = {}, 0
        for name, shape in shapes.items():
            n = math.prod(shape)
            views[name] = flat[off:off + n].reshape(shape)
            off += n
        self._staging[key] = (flat, views)
        return flat, views

    def _to_device(self, flat: np.ndarray, views: dict) -> dict:
        """One host→device copy of the staging buffer, cut like ``views``."""
        buf = torch.from_numpy(flat).to(self.device)
        out, off = {}, 0
        for name, a in views.items():
            out[name] = buf[off:off + a.size].view(a.shape)
            off += a.size
        return out

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
            last = req.generated_tokens[-1] if req.generated_tokens else 0
            # the fed-back token's position: context counts it as emitted,
            # but its K/V enters the cache only now
            seqs.append(_PackedSeq(it.req_id, [last], pos0=req.context - 1,
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

    def stats(self) -> dict:
        """Dispatch/bucket counters for benches and regression guards."""
        return {"dispatches": self.n_dispatches,
                "compile_keys": len(self.compile_keys)}

    def release(self, req_id: int) -> None:
        self.alloc.release(req_id)
