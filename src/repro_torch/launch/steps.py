"""Cell builders: (architecture × input shape × mesh) → the step that a
cell runs, its abstract arguments and the spec of every leaf. Port of
``src/repro/launch/steps.py``.

A *cell* is one entry of the assignment matrix. ``build_cell`` returns the
step function (train step, prefill or decode step), abstract arguments
(``meta`` tensors of the global shapes and dtypes: the JAX package's
``ShapeDtypeStruct``s, no allocation), in and out specs resolved from the
models' logical axes through the cell's ``ShardingRules``, and donation
info. What differs from the JAX cell:

  * the port has no XLA, so a ``CellSpec`` has no ``lower()``. It has
    ``abstract_args()`` (the arguments as ``meta`` tensors, which
    ``cost_analysis.analyze`` and ``dryrun`` run the step on),
    ``rank_shapes(coords)`` (one rank's local shapes, from the specs and
    ``sharding.shard_range``) and ``materialize(device, generator)`` (real
    arguments: weights and inputs drawn from the generator, a decode
    cell's cache full, as after a prefill of ``seq_len - 1`` tokens);
  * ``in_shardings`` and ``out_shardings`` hold specs (tuples), as the
    port's ``param_specs`` returns them: the ``PartitionSpec``s of the
    JAX cell's ``NamedSharding``s;
  * ``donate_argnums`` records what the step updates in place: the train
    step updates the parameters and the optimizer state leaf by leaf
    (``training/optimizer.py``), the decode step writes its rings in place
    (``models/lm.py``);
  * ``build_cell`` takes two cuts beside the JAX arguments, ``batch`` (the
    global batch) and ``layers`` (the depth), so that a cell that does not
    fit one card can be run, and dry-run, at the size that does;
  * the step runs on one device: ``DecoderLM`` and the train step under a
    mesh are ROADMAP A13b (iv). The specs say how a mesh would hold each
    leaf; ``rank_shapes`` gives a rank's share of the arguments.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import torch

from .. import configs
from ..configs.base import ArchConfig, ShapeConfig
from ..distributed.sharding import (ShardingRules, map_axes, param_specs,
                                    serving_rules, shard_range,
                                    training_rules)
from ..models.layers import prefill_ring_write
from ..models.lm import ModelOpts, build_model
from ..models.weights import init_params
from ..training import OptConfig, init_opt_state, make_train_step
from ..training.optimizer import opt_axes

# Archs whose AdamW states cannot fit the assigned meshes (1T params):
# Adafactor + gradient accumulation (DESIGN.md §6).
ADAFACTOR_THRESHOLD = 400e9
ENC_LEN = 4096  # enc-dec cross-memory length for decode shapes
META = torch.device("meta")


@dataclasses.dataclass
class CellSpec:
    arch: ArchConfig
    shape: ShapeConfig
    mesh: Any                  # launch.mesh.Mesh
    mode: str                  # train | prefill | decode
    fn: Callable
    args: tuple                # meta tensors
    in_shardings: tuple        # specs, the structure of ``args``
    out_shardings: Any
    donate_argnums: tuple
    rules: ShardingRules
    model: Any
    notes: str = ""

    def abstract_args(self) -> tuple:
        """The step's arguments as ``meta`` tensors of the global shapes and
        dtypes (the JAX cell's ``ShapeDtypeStruct``s)."""
        return self.args

    def rank_shapes(self, coords: dict) -> tuple:
        """The arguments as ``meta`` tensors of the local shapes of the rank
        at mesh coordinates ``coords`` (axis name → index)."""
        def local(spec, t):
            return torch.empty(local_shape(self.mesh, coords, t.shape, spec),
                               dtype=t.dtype, device=META)
        return tuple(map_axes(local, s, a)
                     for a, s in zip(self.args, self.in_shardings))

    def materialize(self, device, generator: torch.Generator) -> tuple:
        """Real arguments on ``device`` of the cell's shapes and dtypes:
        weights as ``init_params`` draws them, the optimizer state as
        ``init_opt_state`` makes it, tokens, embeddings and a decode cell's
        cache drawn from ``generator`` (on ``device``). A decode cell's
        cache is full: random K/V, Mamba2 states and convolution tails, and
        the ring positions and ``pos`` of a prefill of ``seq_len - 1``
        tokens."""
        dev = torch.device(device)
        params = init_params(self.arch, generator, dev,
                             self.model.opts.param_dtype)
        draw = functools.partial(_draw, dev=dev, g=generator,
                                 vocab=self.arch.vocab,
                                 seen=self.shape.seq_len - 1)
        if self.mode == "train":
            return (params, init_opt_state(params, _opt_config(self.arch)),
                    draw(self.args[2]))
        return (params, *map(draw, self.args[1:]))


def local_shape(mesh, coords: dict, shape, spec: tuple) -> list:
    """The shape of the rank at ``coords``'s share of a leaf of ``shape``
    held by ``spec`` (``sharding.shard_range`` along each dimension)."""
    return [hi - lo for lo, hi in (shard_range(part, size, mesh, coords)
                                   for part, size in zip(spec, shape))]


def _draw(tree, dev, g, vocab: int, seen: int):
    """Real tensors of ``tree``'s shapes and dtypes on ``dev``: positions
    by their key (those of a sequence ``seen`` tokens long), other integers
    token ids in [0, vocab), floats ~ N(0, 0.3²)."""
    def one(key, t):
        if key == "pos":
            return torch.full(t.shape, seen, dtype=t.dtype, device=dev)
        if key == "kv_pos":       # a ring after ``seen`` tokens
            _, pos = prefill_ring_write(torch.empty(0, device=dev), seen,
                                        t.shape[-1])
            return pos.to(t.dtype).expand(t.shape).contiguous()
        if key == "memory_pos":
            return torch.arange(t.shape[-1], dtype=t.dtype,
                                device=dev).expand(t.shape).contiguous()
        if not t.is_floating_point():    # token ids
            return torch.randint(0, vocab, t.shape, generator=g,
                                 device=dev, dtype=t.dtype)
        return torch.randn(t.shape, generator=g, device=dev,
                           dtype=t.dtype).mul_(0.3)

    def walk(key, t):
        if isinstance(t, dict):
            return {k: walk(k, v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(key, v) for v in t]
        return one(key, t)
    return walk(None, tree)


def _batch_shardable(rules: ShardingRules, global_batch: int) -> None:
    """Clear batch axes the batch size can't divide (e.g. long_500k B=1)."""
    ax = rules.table.get("batch")
    if ax is None:
        return
    axes = ax if isinstance(ax, tuple) else (ax,)
    n = math.prod(rules.mesh.shape[a] for a in axes)
    if global_batch % n != 0:
        rules.table["batch"] = None
        rules.table["cache_batch"] = None


def rules_for(mesh, arch: ArchConfig, shape: ShapeConfig) -> ShardingRules:
    if shape.kind == "train":
        r = training_rules(mesh, arch)
    elif shape.kind == "prefill":
        r = serving_rules(mesh, arch, decode=False)
    else:  # decode
        cp = None
        if shape.name == "long_500k" and arch.has_attention():
            cp = tuple(mesh.axis_names)  # batch=1: every axis is CP
        r = serving_rules(mesh, arch, decode=True, context_parallel=cp)
    r.table = dict(r.table)
    _batch_shardable(r, shape.global_batch)
    return r


def _model_opts(arch: ArchConfig, mode: str, for_analysis: bool = False
                ) -> ModelOpts:
    """The launch dtypes and impls. ``for_analysis`` turns remat and the
    stacked layers off, as the JAX costing opts do; JAX's ``flash_unroll``
    has no counterpart: it unrolls XLA's flash scan for the HLO analysis,
    and the port's flash loop runs eagerly, every block dispatched."""
    if mode == "train":
        o = ModelOpts(param_dtype=torch.float32,
                      compute_dtype=torch.bfloat16,
                      cache_dtype=torch.bfloat16, attn_impl="flash",
                      moe_impl="capacity", remat=True, ce_chunk=2048)
    else:
        o = ModelOpts(param_dtype=torch.bfloat16,
                      compute_dtype=torch.bfloat16,
                      cache_dtype=torch.bfloat16,
                      attn_impl="flash" if mode == "prefill" else "dense",
                      moe_impl="capacity", remat=False)
    if for_analysis:
        o = dataclasses.replace(o, remat=False, scan_layers=False)
    return o


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _inputs_spec(arch: ArchConfig, shape: ShapeConfig, mode: str):
    b, s = shape.global_batch, shape.seq_len
    f, i = torch.bfloat16, torch.int32
    if mode == "train":
        if arch.is_encoder_decoder:
            return {"enc_embeds": _abstract((b, s, arch.d_model), f),
                    "dec_tokens": _abstract((b, s), i)}
        if arch.embeds_input:
            return {"embeds": _abstract((b, s, arch.d_model), f),
                    "labels": _abstract((b, s), i)}
        return {"tokens": _abstract((b, s), i)}
    if mode == "prefill":
        if arch.is_encoder_decoder:
            return {"enc_embeds": _abstract((b, s, arch.d_model), f),
                    "dec_tokens": _abstract((b, 1), i)}
        if arch.embeds_input:
            return {"embeds": _abstract((b, s, arch.d_model), f)}
        return _abstract((b, s), i)
    # decode: one new token against a seq_len-deep cache
    return _abstract((b,), i)


def _inputs_sharding(arch: ArchConfig, shape: ShapeConfig, mode: str,
                     rules: ShardingRules):
    if mode == "decode":
        return rules.spec(("batch",))
    tok = rules.spec(("batch", "seq"))
    emb = rules.spec(("batch", "seq", "embed"))
    if mode == "train":
        if arch.is_encoder_decoder:
            return {"enc_embeds": emb, "dec_tokens": tok}
        if arch.embeds_input:
            return {"embeds": emb, "labels": tok}
        return {"tokens": tok}
    if arch.is_encoder_decoder:
        return {"enc_embeds": emb,
                "dec_tokens": rules.spec(("batch", "seq"))}
    if arch.embeds_input:
        return {"embeds": emb}
    return tok


def _opt_config(arch: ArchConfig) -> OptConfig:
    return OptConfig(name="adafactor"
                     if arch.param_count() > ADAFACTOR_THRESHOLD
                     else "adamw")


def build_cell(arch_name: str, shape_name: str, mesh, *,
               reduced: bool = False, for_analysis: bool = False,
               batch: Optional[int] = None,
               layers: Optional[int] = None) -> CellSpec:
    """The cell of ``arch_name`` × ``shape_name`` on ``mesh``;
    ``batch`` and ``layers`` cut its global batch and its depth."""
    arch = (configs.get_reduced(arch_name) if reduced
            else configs.get(arch_name))
    shape = configs.SHAPES[shape_name]
    if shape.name == "long_500k" and not configs.long_context_capable(arch):
        raise ValueError(
            f"{arch.name}: long_500k skipped (pure full attention — "
            "DESIGN.md §5)")
    if layers is not None:
        arch = dataclasses.replace(arch, n_layers=layers)
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    mode = shape.kind
    rules = rules_for(mesh, arch, shape)
    opts = _model_opts(arch, mode, for_analysis)
    model = build_model(arch, opts, device=META)
    params_shapes = init_params(arch, None, META, opts.param_dtype)
    p_axes = model.axes()
    p_specs = param_specs(p_axes, rules)
    notes = ""

    if mode == "train":
        opt_cfg = _opt_config(arch)
        use_adafactor = opt_cfg.name == "adafactor"
        # accum ×2 (not ×4): every microbatch re-all-gathers the 2-D-sharded
        # expert weights in fwd+bwd — halving accum halves that traffic;
        # remat keeps activations in budget (EXPERIMENTS.md §Perf C1)
        accum = 2 if use_adafactor else 1
        if use_adafactor:
            notes = "adafactor + grad-accum x2 (AdamW state would not fit)"
        step = make_train_step(model, opt_cfg, accum_steps=accum)
        opt_shapes = init_opt_state(params_shapes, opt_cfg)
        o_axes = opt_axes(p_axes, params_shapes, opt_cfg)
        o_specs = param_specs(o_axes, rules)
        batch_spec = _inputs_spec(arch, shape, mode)
        batch_sh = _inputs_sharding(arch, shape, mode, rules)
        repl = rules.spec(())
        out_sh = (p_specs, o_specs, {"loss": repl, "grad_norm": repl})
        return CellSpec(arch, shape, mesh, mode, step,
                        (params_shapes, opt_shapes, batch_spec),
                        (p_specs, o_specs, batch_sh), out_sh,
                        donate_argnums=(0, 1), rules=rules, model=model,
                        notes=notes)

    cache_specs = param_specs(model.cache_axes(), rules)
    logits_sh = rules.spec(("batch", "vocab"))
    if mode == "prefill":
        fn = functools.partial(_prefill_fn, model=model, max_len=shape.seq_len)
        inp = _inputs_spec(arch, shape, mode)
        inp_sh = _inputs_sharding(arch, shape, mode, rules)
        return CellSpec(arch, shape, mesh, mode, fn, (params_shapes, inp),
                        (p_specs, inp_sh), (logits_sh, cache_specs),
                        donate_argnums=(), rules=rules, model=model)

    # decode
    if arch.is_encoder_decoder:
        cache_shapes = model.init_cache(shape.global_batch, shape.seq_len,
                                        enc_len=ENC_LEN)
    else:
        cache_shapes = model.init_cache(shape.global_batch, shape.seq_len)
    fn = functools.partial(_decode_fn, model=model)
    tok = _inputs_spec(arch, shape, mode)
    tok_sh = _inputs_sharding(arch, shape, mode, rules)
    return CellSpec(arch, shape, mesh, mode, fn,
                    (params_shapes, tok, cache_shapes),
                    (p_specs, tok_sh, cache_specs),
                    (logits_sh, cache_specs),
                    donate_argnums=(2,), rules=rules, model=model)


def _prefill_fn(params, inputs, *, model, max_len):
    return model.prefill(params, inputs, max_len)


def _decode_fn(params, tokens, cache, *, model):
    return model.decode_step(params, tokens, cache)


def all_cells() -> list[tuple[str, str, bool]]:
    """(arch, shape, runnable) for the full 40-cell matrix."""
    out = []
    for a in configs.all_archs():
        cfg = configs.get(a)
        for s, runnable in configs.cells(cfg):
            out.append((a, s, runnable))
    return out
