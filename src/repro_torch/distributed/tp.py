"""Tensor- and expert-parallel arithmetic of one rank of the paged
executor under a mesh (DESIGN.md §17), with the collectives GSPMD inserts
in the JAX package written out.

A rank holds its share of the parameters (``sharding.shard_params`` over
``DecoderLM.axes()`` and ``serving_rules(mesh, cfg)``) and of the K/V
pools (the kv-head dim). Per dispatch it runs the same layers as one
device (``models.layers.layer_ffn`` and the executor's o-proj), on its
heads, FFN columns or experts, and completes each partial result with one
``all_reduce`` (a sum) on the mesh's ``model`` group:

* the vocab-parallel embedding: rows outside the rank's vocab slice are
  masked to 0, then summed;
* after the attention output projection (o-proj), over the heads;
* after the FFN's down projection, or the MoE combine, over the FFN
  columns or the experts;
* the vocab-sharded logits, each rank's columns written into a zero-filled
  full-vocab buffer, then summed.

That is ``2·L + 2`` all-reduces a pass where the rule tables shard
every one of those dimensions (``all_reduces`` counts them,
``reduces_per_dispatch`` says how many a dispatch should run: one pass,
a committed horizon's or a speculative dispatch's). A dimension they leave
replicated (a divisibility guard) is computed whole on every rank and
needs no collective. Where the KV heads are replicated and the query
heads sharded (``n_kv_heads % TP != 0``), each rank holds every KV head
and places its query heads at their global positions in a zero-filled
full-head query, so that the attention kernel maps each onto its KV
group; the other heads' outputs are dropped.

The embedding and the logits are exact (one nonzero term a sum). The
o-proj and FFN sums add the ranks' partial products in another order than
one device's matrix product, so logits agree to fp reassociation and the
greedy tokens are what a test holds equal.

``ONE_DEVICE`` is the same interface with no mesh: every hook the
identity, so that one layer body serves both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..configs.base import ArchConfig
from .sharding import map_axes, serving_rules, shard_params, shard_range


class OneDevice:
    """The layer hooks of an unsharded executor: each the identity."""

    experts = None

    @staticmethod
    def attention_q(q: torch.Tensor) -> torch.Tensor:
        return q

    @staticmethod
    def own_heads(o: torch.Tensor) -> torch.Tensor:
        return o

    @staticmethod
    def reduce_heads(y: torch.Tensor) -> torch.Tensor:
        return y

    @staticmethod
    def reduce_ffn(y: torch.Tensor) -> torch.Tensor:
        return y


ONE_DEVICE = OneDevice()


class TensorParallel(OneDevice):
    """One rank's view of a decoder sharded over the ``model`` axis of
    ``mesh`` by ``serving_rules(mesh, cfg)``. Other mesh axes must have
    size 1 (``data > 1`` is ROADMAP A13b)."""

    def __init__(self, mesh, cfg: ArchConfig):
        wide = {a: n for a, n in mesh.shape.items() if a != "model" and n > 1}
        if wide:
            raise NotImplementedError(
                f"the paged executor shards over the model axis only; mesh "
                f"axes {wide} (data parallelism under one executor) are "
                f"ROADMAP A13b")
        if mesh.groups is None:
            raise ValueError("an abstract mesh has no process group: build "
                             "one with launch.mesh.make_test_mesh on the "
                             "running ranks")
        self.cfg = cfg
        self.mesh = mesh
        self.rules = serving_rules(mesh, cfg)
        self.group = mesh.group("model")
        self.rank = mesh.coords["model"]
        # the broadcast root of the step message: model coordinate 0
        self.src = dist.get_global_rank(self.group, 0)
        self.all_reduces = 0

        def split(name: str, size: int):
            """(lo, hi) of the rank's rows, and whether the model axis
            splits them."""
            part = self.rules.spec((name,))[0]
            members = part if isinstance(part, tuple) else (part,)
            return (shard_range(part, size, mesh, mesh.coords),
                    "model" in members)

        self.heads, self.heads_split = split("heads", cfg.n_heads)
        self.kv_heads, kv_split = split("kv_heads", cfg.n_kv_heads)
        self.vocab, self.vocab_split = split("vocab", cfg.vocab)
        # q heads sharded over KV heads that are not: the full-head query
        self.expand_q = self.heads_split and not kv_split
        self.experts = None
        if cfg.moe is not None:
            experts, expert_split = split("expert", cfg.moe.n_experts)
            _, ff_split = split("expert_ff", cfg.moe.d_ff_expert)
            self.experts = experts if expert_split else None
            self.ffn_split = expert_split or ff_split
        else:
            _, self.ffn_split = split("ffn", cfg.d_ff)
        # the config attn_qkv reshapes this rank's projections by
        self.local_cfg = dataclasses.replace(
            cfg, n_heads=self.heads[1] - self.heads[0],
            n_kv_heads=self.kv_heads[1] - self.kv_heads[0])

    # ------------------------------------------------------------------

    def shard(self, params: dict, axes: dict) -> dict:
        """This rank's slices of ``params``, each a copy of its own, so
        that the caller may free the whole tree."""
        return map_axes(lambda _, t: t.clone(), axes,
                        shard_params(params, axes, self.rules,
                                     self.mesh.coords))

    def all_reduce(self, y: torch.Tensor, split: bool) -> torch.Tensor:
        """Sum ``y`` over the model group, in place, where the model axis
        ``split`` its dimension; else every rank computed the whole of
        ``y`` and it is returned as it is."""
        if split:
            dist.all_reduce(y, group=self.group)
            self.all_reduces += 1
        return y

    def reduces_per_dispatch(self, n_layers: int, *, steps: int = 1,
                             gamma: int = 0,
                             draft_layers: Optional[int] = None) -> int:
        """The all-reduces of one dispatch over ``n_layers`` layers: 2·L + 2
        a pass where every dimension is sharded. A committed horizon runs
        ``steps`` passes; a speculative dispatch of ``steps`` rounds runs
        each round's verify pass plus ``gamma`` draft passes, which reduce
        like a pass over ``draft_layers`` layers for a draft sharded like
        the target (``TruncatedSelfDraft``) and not at all for a replicated
        one (``draft_layers=None``: ``SmallModelDraft``)."""
        def one_pass(layers: int) -> int:
            return (layers * (self.heads_split + self.ffn_split)
                    + 2 * self.vocab_split)
        draft = 0 if draft_layers is None else gamma * one_pass(draft_layers)
        return steps * (one_pass(n_layers) + draft)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` from model rank 0 to every rank of the group, in place."""
        dist.broadcast(t, src=self.src, group=self.group)
        return t

    # ------------------------------------------------------------------
    # the sharded layers
    # ------------------------------------------------------------------

    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        """Vocab-parallel embedding: ``table`` the rank's (V/TP, d) rows;
        tokens outside them give 0 rows before the sum."""
        lo, hi = self.vocab
        t = tokens.long()
        rows = table[(t - lo).clamp(0, hi - lo - 1)]
        mine = ((t >= lo) & (t < hi)).unsqueeze(-1)
        return self.all_reduce(torch.where(mine, rows, 0.0),
                               self.vocab_split)

    def logits(self, h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        """The full-vocab logits of normed ``h`` from the rank's (d, V/TP)
        columns of ``head``."""
        local = h @ head
        lo, hi = self.vocab
        out = local.new_zeros(*local.shape[:-1], self.cfg.vocab)
        out[..., lo:hi] = local
        return self.all_reduce(out, self.vocab_split)

    def attention_q(self, q: torch.Tensor) -> torch.Tensor:
        """q (..., H/TP, D) as the attention kernel takes it: itself, or
        placed in a zero-filled full-head query when the KV heads are
        replicated."""
        if not self.expand_q:
            return q
        full = q.new_zeros(*q.shape[:-2], self.cfg.n_heads, q.shape[-1])
        full[..., self.heads[0]:self.heads[1], :] = q
        return full

    def own_heads(self, o: torch.Tensor) -> torch.Tensor:
        """The rank's heads of an attention output (inverse of
        ``attention_q``)."""
        if not self.expand_q:
            return o
        return o[..., self.heads[0]:self.heads[1], :]

    def reduce_heads(self, y: torch.Tensor) -> torch.Tensor:
        """The o-proj over the rank's heads, summed."""
        return self.all_reduce(y, self.heads_split)

    def reduce_ffn(self, y: torch.Tensor) -> torch.Tensor:
        """The FFN over the rank's FFN columns (MLP) or its experts or
        expert columns (MoE), summed."""
        return self.all_reduce(y, self.ffn_split)
