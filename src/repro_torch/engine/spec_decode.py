"""Self-speculative decode inside the commit horizon (DESIGN.md §18).

A speculative *round* drafts γ candidate tokens per sequence, then verifies
all γ+1 positions (the fed-back token plus the γ drafts) in ONE target pass
through the batched paged-attention kernel at Tq=γ+1. Greedy accept/reject
is resolved on the device: the emitted tokens are the target argmaxes
``tgt[:n_acc+1]`` where ``n_acc`` is the number of leading drafts matching
the target. Because a rejection falls back to the *verified* argmax, the
emitted stream is the non-speculative greedy stream — draft quality only
moves the acceptance rate, never the tokens.

Two draft adapters share one interface so the executor's round body
(``PagedTransformerExecutor._spec_multi_step``) is draft-agnostic. Every
K/V write lands in the pools in place, so, unlike the JAX package's jitted
round, no draft state is threaded through the round:

* ``TruncatedSelfDraft`` — early-exit self-speculation: the first ``n_layers``
  of the target model plus the target's own head. Its K/V writes land in the
  MAIN page pools — quantized, with their scale pages, when the target's
  are (DESIGN.md §14); that is safe because the verify pass rewrites the
  same (layer, position) slots before any attention reads them, and
  rejected positions are overwritten before any later pass can attend to
  them.
* ``SmallModelDraft`` — a separate (smaller) model with its OWN fp32 page
  pools, whatever the target's ``kv_dtype`` (the JAX package's
  ``draft_forward`` is the target's forward "minus quantization"), indexed
  by the SAME global page ids as the target's allocator so block tables
  are shared verbatim. It keeps a host-side coverage map and
  backfills draft-KV for any context it has not seen (admission after the
  target prefilled, rollback, migration) with a chunked prefill pass before
  the speculative dispatch.

``AcceptanceEWMA`` is the capacity layer's pessimistic acceptance estimator:
cold start sits at the floor, measured collapses are adopted *immediately*
(min with the raw rate), improvements smooth in — overstating acceptance is
the only way ``commit_horizon`` could bust a TPOT envelope, so the estimator
is one-sided by design.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models.module import rmsnorm
from ..models.weights import params_to
from .executor import _bucket, layer_views, paged_forward


class AcceptanceEWMA:
    """Pessimistic one-sided EWMA of the per-draft acceptance rate.

    ``value`` is what ``commit_horizon`` prices emission with; it must never
    run ahead of reality, so updates are asymmetric: a measured rate BELOW
    the current estimate replaces it outright (``min``), a rate above it
    only pulls the estimate up at ``alpha`` speed. ``floor`` is the
    cold-start value (0.0 = fully pessimistic: speculative rounds earn no
    extra emission allowance until measured).
    """

    def __init__(self, floor: float = 0.0, alpha: float = 0.3):
        self.floor = floor
        self.alpha = alpha
        self._v: Optional[float] = None

    @property
    def value(self) -> float:
        return self.floor if self._v is None else max(self.floor, self._v)

    def update(self, accepted: int, drafted: int) -> None:
        if drafted <= 0:
            return
        m = accepted / drafted
        prev = m if self._v is None else self._v
        self._v = min(m, self.alpha * m + (1.0 - self.alpha) * prev)


class TruncatedSelfDraft:
    """Early-exit self-speculative draft: first ``n_layers`` of the target.

    State-free — drafts write (and read) the target's own page pools. Every
    draft write is later rewritten by the verify pass (layers < n_layers
    with the same tokens at the same positions, layers >= n_layers with
    fresh values), so no rollback hook is needed beyond the allocator's
    slot reclamation.
    """

    needs_sync_pass = False

    def __init__(self, n_layers: int):
        assert n_layers >= 1
        self.n_layers = n_layers
        self._ex = None

    def bind(self, executor) -> None:
        assert self.n_layers <= executor.cfg.n_layers
        self._ex = executor

    # -- round hook (device work only) ----------------------------------

    def step(self, tok, pos, tables, stables, ctx_lens) -> torch.Tensor:
        """One Tq=1 draft step: tok/pos/ctx_lens (B,), tables (B, n_pages)
        and the scale tables parallel to them (None when the target's pools
        are fp32). Returns logits (B, vocab)."""
        ex = self._ex
        x = ex._forward(ex._embed(tok)[:, None], pos[:, None], tables,
                        ctx_lens, n_layers=self.n_layers, stables=stables)
        return ex._head(x[:, 0])

    # -- host-side lifecycle hooks (all no-ops: no private state) -------

    def prepare(self, ids, requests) -> None:
        pass

    def note_progress(self, req_id: int, n_tokens: int) -> None:
        pass

    def clamp(self, req_id: int, n_tokens: int) -> None:
        pass

    def release(self, req_id: int) -> None:
        pass

    def mirror_cow(self, src, dst) -> None:
        pass


class SmallModelDraft:
    """Separate small draft model behind the same adapter interface.

    Owns fp32 page pools of the target allocator's cardinality, indexed by
    the SAME global page ids — the speculative round body passes the
    target's block tables straight through. A host-side coverage map tracks
    how many leading positions of each request have draft-KV; ``prepare``
    backfills gaps with chunked draft-prefill dispatches (counted in
    ``n_backfill_dispatches``, NOT the executor's ``n_dispatches`` — the
    one-dispatch-per-step serving invariant is about the target plane).
    Its forward is the executor's ``paged_forward`` over its own pools and
    weights (the JAX package's ``draft_forward``).

    ``needs_sync_pass``: after the γ in-round draft steps the last draft
    token's own draft-KV has not been written; one extra draft pass (logits
    discarded) writes it so a fully-accepting sequence enters the next round
    with complete draft context.
    """

    needs_sync_pass = True

    def __init__(self, cfg: ArchConfig, params):
        assert cfg.family == "dense" and cfg.moe is None, \
            "SmallModelDraft supports dense-family draft archs"
        self.cfg = cfg
        self.params = params
        self._layers: list = []
        self.page_size = 0
        self.dk = self.dv = None
        self._covered: dict[int, int] = {}
        self.n_backfill_dispatches = 0
        self._ex = None

    def bind(self, executor) -> None:
        cfg = self.cfg
        self._ex = executor
        self.page_size = executor.page_size
        self.params = params_to(self.params, executor.device)
        self._layers = layer_views(self.params, cfg.n_layers)
        shape = (cfg.n_layers, executor.alloc.num_blocks, self.page_size,
                 cfg.n_kv_heads, cfg.head_dim)
        self.dk = torch.zeros(shape, dtype=torch.float32,
                              device=executor.device)
        self.dv = torch.zeros(shape, dtype=torch.float32,
                              device=executor.device)

    def _logits(self, x_last: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(x_last, self.params["ln_f"], self.cfg.norm_eps)
        return h @ self.params["head"]

    # -- round hook (device work only) ----------------------------------

    def step(self, tok, pos, tables, stables, ctx_lens) -> torch.Tensor:
        """One Tq=1 draft step over the draft's own fp32 pools; the
        target's scale tables (``stables``) do not apply to them."""
        x = self.params["embed"][tok.long()][:, None]
        x = paged_forward(self.cfg, self._layers, self.dk, self.dv, x,
                          pos[:, None], tables, ctx_lens, self.page_size)
        return self._logits(x[:, 0])

    @torch.no_grad()
    def _prefill_step(self, st: dict, n_valid: int) -> None:
        """One draft-prefill chunk (B=1) into the draft pools: ``st`` as
        the executor's sequential chunk — tokens/positions (n_tok,) padded,
        table (max_pages,), ctx (1,)."""
        n_tok = st["tokens"].shape[0]
        x = self.params["embed"][st["tokens"].long()][None]
        valid = (torch.arange(n_tok, device=x.device) < n_valid)[None]
        paged_forward(self.cfg, self._layers, self.dk, self.dv, x,
                      st["positions"][None], st["table"][None], st["ctx"],
                      self.page_size, valid)

    # -- host-side lifecycle -------------------------------------------

    def prepare(self, ids, requests) -> None:
        """Backfill draft-KV coverage up to each request's fed-back token
        position (``context - 1``) before the round's dispatch."""
        ex = self._ex
        for rid in ids:
            req = requests[rid]
            need = req.context - 1
            have = self._covered.get(rid, 0)
            if have >= need:
                continue
            stream = list(req.tokens or []) + list(req.generated_tokens)
            assert len(stream) >= need, \
                f"draft backfill: request {rid} token stream too short"
            table = ex._table(rid)
            while have < need:
                chunk = stream[have:need]
                n_tok = _bucket(len(chunk), 16)
                st = ex._stage({
                    "tokens": chunk + [0] * (n_tok - len(chunk)),
                    "positions": np.arange(have, have + n_tok),
                    "table": table, "ctx": [have + len(chunk)]})
                self.n_backfill_dispatches += 1
                self._prefill_step(st, len(chunk))
                have += len(chunk)
            self._covered[rid] = need

    def note_progress(self, req_id: int, n_tokens: int) -> None:
        self._covered[req_id] = n_tokens

    def clamp(self, req_id: int, n_tokens: int) -> None:
        if req_id in self._covered:
            self._covered[req_id] = min(self._covered[req_id], n_tokens)

    def release(self, req_id: int) -> None:
        self._covered.pop(req_id, None)

    def mirror_cow(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Mirror the target allocator's COW page copies: draft pools share
        the global page-id space, so a copied data page's draft-KV must
        follow it or the surviving holders would read the wrong rows."""
        self.dk[:, dst] = self.dk[:, src]
        self.dv[:, dst] = self.dv[:, src]
