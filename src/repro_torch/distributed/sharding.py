"""Logical-axis sharding: models annotate tensors with *logical* names;
a ShardingRules table maps them to mesh axes per (arch, mode). Port of
``src/repro/distributed/sharding.py``.

The rule tables (``serving_rules``, ``training_rules``, ``_batch_axes``)
are the JAX package's line for line, divisibility guards, kimi-k2's 2-D
expert table and context-parallel decode included. What differs:

* ``ShardingRules.spec(axes)`` returns a plain tuple, the parts a JAX
  ``PartitionSpec`` would hold, under the same rule that a mesh axis
  appears only once in a spec. ``axes_to_spec`` and ``param_specs`` map an
  axes tree (nested dicts and lists whose leaves are tuples) to such specs;
  the port has no ``NamedSharding``, so both return specs.
* ``shard_params(params, axes, rules, coords)`` slices each leaf along the
  dimensions its spec shards: one rank's share at its mesh coordinates.
  GSPMD's ``device_put`` does this in the JAX package.
* ``constrain`` keeps its API and stays the identity on tensors. Under a
  mesh the executor runs the collectives itself
  (``distributed.tp.TensorParallel``), where GSPMD inserted them.

Default rule tables (DESIGN.md §6):

serving:  batch→data(+pod), heads/ffn/vocab/kv_heads→model, embed→None
          experts→model when divisible, else expert_ff→model
          kimi-k2: experts→model AND expert_ff→data (2-D, 256-way weights)
          cache_seq→data or model for context-parallel cells
training: adds embed→data (FSDP param/optimizer sharding)
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional


@dataclasses.dataclass
class ShardingRules:
    mesh: object  # launch.mesh.Mesh: reads .shape (dict) and .axis_names
    table: dict  # logical name -> mesh axis name | tuple | None

    def spec(self, axes: tuple) -> tuple:
        parts = []
        used = set()
        for a in axes:
            m = self.table.get(a) if a is not None else None
            members = (set(m) if isinstance(m, tuple)
                       else {m} if m is not None else set())
            # one mesh axis may appear only once in a spec
            if m is None or members & used:
                parts.append(None)
            else:
                parts.append(m)
                used |= members
        return tuple(parts)


_local = threading.local()


def _active() -> Optional[ShardingRules]:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = _active()
    _local.rules = rules
    try:
        yield
    finally:
        _local.rules = prev


def constrain(x, axes: tuple):
    """The JAX annotation's API; the identity on tensors, with or without
    active rules (the executor runs the collectives itself)."""
    return x


def map_axes(fn, axes_tree, *rest):
    """``fn`` over the leaves of an axes tree (tuples) and the same leaves
    of ``rest`` (trees of dicts and lists); the result has the axes tree's
    structure."""
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [map_axes(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(axes_tree)]
    return fn(axes_tree, *rest)


def axes_to_spec(axes_tree, rules: ShardingRules):
    return map_axes(rules.spec, axes_tree)


def param_specs(axes_tree, rules: ShardingRules):
    """The spec of every leaf of ``axes_tree`` (the JAX function returns
    ``NamedSharding``s built on these specs)."""
    return map_axes(rules.spec, axes_tree)


def shard_range(part, size: int, mesh, coords: dict) -> tuple[int, int]:
    """[lo, hi) of the rows of a ``size``-long dimension with spec part
    ``part`` (a mesh axis, a tuple of them, or None) that the rank at mesh
    coordinates ``coords`` holds: the axes of a tuple linearized in order,
    the first slowest, as JAX lays a multi-axis dimension out."""
    idx, n = 0, 1
    for a in () if part is None else (
            part if isinstance(part, tuple) else (part,)):
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    if size % n:
        raise ValueError(f"a dimension of {size} does not split {n} ways "
                         f"over {part!r}")
    return idx * size // n, (idx + 1) * size // n


def shard_params(params, axes, rules: ShardingRules, coords: dict):
    """Each leaf of ``params`` sliced along the dimensions its spec (from
    ``axes``, a tree of the same structure) shards: the share of the rank
    at mesh coordinates ``coords`` (axis name → index). A replicated
    dimension is kept whole; the slices are views of the leaves."""
    def cut(ax, leaf):
        if len(ax) != leaf.dim():
            raise ValueError(f"axes {ax} do not match a leaf of shape "
                             f"{tuple(leaf.shape)}")
        for dim, part in enumerate(rules.spec(ax)):
            lo, hi = shard_range(part, leaf.shape[dim], rules.mesh, coords)
            leaf = leaf.narrow(dim, lo, hi - lo)
        return leaf
    return map_axes(cut, axes, params)


# --------------------------------------------------------------------------
# Rule tables
# --------------------------------------------------------------------------

def _batch_axes(mesh):
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    return tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)


def serving_rules(mesh, arch=None, *, decode: bool = False,
                  context_parallel=None) -> ShardingRules:
    """Rules for a serving step.

    context_parallel: mesh axis (or tuple) carrying the KV-cache sequence
    dim. Used when (a) KV heads don't divide the model axis — decode then
    runs flash-decoding style: q all-gathered (tiny), scores/softmax/PV
    reduced across the axis by GSPMD — or (b) long_500k, where batch=1
    leaves the data axis idle and the 500k context is the only shardable dim
    (DESIGN.md §6).
    """
    batch = _batch_axes(mesh)
    table = {
        "batch": batch,
        "seq": None,
        "embed": None,
        "heads": "model",          # weight storage: always TP over model
        "kv_heads": "model",
        "q_heads": "model",        # activation q-head dim
        "ffn": "model",
        "vocab": "model",
        "inner": "model",          # mamba d_inner
        "expert": None,
        "expert_ff": "model",
        # MoE dispatch-buffer capacity dim: MUST shard over the batch axes,
        # else every data shard redundantly computes the full chunk's expert
        # GEMMs (16× waste — EXPERIMENTS.md §Perf, mixtral prefill iteration)
        "dispatch": batch,
        # pre-dispatch token stack (always batch-sharded, even when the
        # dispatch dim itself can't be — kimi's 2-D expert sharding)
        "moe_tokens": batch,
        "cache_seq": context_parallel,
        "cache_batch": batch,
        "state": "model",
    }
    if arch is not None and arch.moe is not None:
        n_model = mesh.shape["model"]
        if arch.moe.n_experts % n_model == 0:
            table["expert"] = "model"
            # kimi-class: weights must shard over BOTH axes to fit (2 TB bf16)
            big = (arch.n_layers * arch.moe.n_experts
                   * arch.moe.d_ff_expert * arch.d_model * 3)
            if big * 2 > 400e9 and arch.moe.d_ff_expert % mesh.shape.get("data", 1) == 0:
                table["expert_ff"] = "data"
                # both mesh axes already carry expert×ff parallelism: the
                # dispatch dim has no axis left (and must not fight ff)
                table["dispatch"] = None
            else:
                table["expert_ff"] = None
        # else: experts replicated, expert_ff TP over model (default above)
    if arch is not None:
        n_model = mesh.shape["model"]
        if arch.n_kv_heads > 0 and arch.n_kv_heads % n_model != 0:
            table["kv_heads"] = None   # can't head-shard the KV cache...
            if decode and context_parallel is None:
                # ...so decode context-parallels it over the model axis
                table["cache_seq"] = "model"
                table["q_heads"] = None
        # Divisibility guards: replicate what the model axis can't divide.
        if arch.n_heads > 0 and arch.n_heads % n_model != 0:
            table["heads"] = None
            table["q_heads"] = None
        if arch.vocab % n_model != 0:
            table["vocab"] = None
        if arch.d_ff > 0 and arch.d_ff % n_model != 0:
            table["ffn"] = None
        if arch.ssm is not None:
            if arch.ssm.n_heads(arch.d_model) % n_model != 0:
                table["state"] = None
            if arch.ssm.d_inner(arch.d_model) % n_model != 0:
                table["inner"] = None
        if arch.moe is not None and arch.moe.d_ff_expert % n_model != 0 \
                and table["expert_ff"] == "model":
            table["expert_ff"] = None
    if decode and context_parallel is not None:
        table["q_heads"] = None
    return ShardingRules(mesh=mesh, table=table)


def training_rules(mesh, arch=None) -> ShardingRules:
    r = serving_rules(mesh, arch)
    r.table = dict(r.table)
    r.table["embed"] = _batch_axes(mesh)   # FSDP: shard params/opt over data
    r.table["seq"] = None
    r.table["cache_seq"] = None
    return r
