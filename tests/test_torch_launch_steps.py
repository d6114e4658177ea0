"""The port's launch cells (``src/repro_torch/launch/steps.py``) against the
JAX package's ``build_cell``, with nothing lowered or allocated.

For every cell of ``all_cells()`` on the meshes (1, 2), (1, 4), (2, 2),
(16, 16) and (2, 16, 16) (JAX: an ``AbstractMesh``; the port: a
``Mesh.abstract`` of the same shape): the mode, the tree of global
argument shapes and dtypes (the port's ``meta`` tensors against JAX's
``ShapeDtypeStruct``s), the in and out specs (JAX's ``NamedSharding``
specs as tuples), ``notes``, ``donate_argnums``, and the ``long_500k``
refusals with their message; and the rank at the last coordinates of
every axis: its local shapes (``rank_shapes``) against JAX's
``shard_shape``. Then ``materialize`` on the CPU at a reduced cell: the
abstract shapes, a decode cache full as after ``seq_len - 1`` tokens.
"""
import functools

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

import repro.launch.steps as jsteps
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh

MESHES = {"1x2": ((1, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = steps.all_cells()


@functools.lru_cache(maxsize=None)
def _jax_cell(arch, shape, mesh):
    m = AbstractMesh(*MESHES[mesh])
    try:
        return jsteps.build_cell(arch, shape, m)
    except ValueError as e:
        return e


def _port_cell(arch, shape, mesh):
    try:
        return steps.build_cell(arch, shape, Mesh.abstract(*MESHES[mesh]))
    except ValueError as e:
        return e


def _leaves(tree, path=()):
    """(path, leaf) of every leaf of nested dicts, lists and tuples (a
    ``NamedSharding`` a leaf), dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _shapes(tree):
    """(path, shape, dtype name) of every array leaf."""
    return [(p, tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for p, a in _leaves(tree)]


def _jax_specs(tree):
    """A JAX tree of NamedShardings → the same tree of spec tuples (lists
    for tuple containers)."""
    if isinstance(tree, NamedSharding):
        return tuple(tree.spec)
    if isinstance(tree, dict):
        return {k: _jax_specs(v) for k, v in tree.items()}
    return [_jax_specs(v) for v in tree]


def test_all_cells_match_jax():
    assert CELLS == jsteps.all_cells()
    assert len(CELLS) == 40 and sum(r for *_, r in CELLS) == 35


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in CELLS])
def test_cell_matches_jax(arch, shape, mesh):
    want, got = _jax_cell(arch, shape, mesh), _port_cell(arch, shape, mesh)
    if isinstance(want, ValueError):
        assert shape == "long_500k"
        assert isinstance(got, ValueError) and str(got) == str(want)
        return
    assert got.mode == want.mode
    assert got.notes == want.notes
    assert got.donate_argnums == want.donate_argnums
    assert _shapes(got.abstract_args()) == _shapes(want.args)
    assert all(t.device.type == "meta"
               for _, t in _leaves(got.abstract_args()))
    # the port's specs are tuples in dicts and lists, under a top-level
    # tuple
    assert list(got.in_shardings) == _jax_specs(want.in_shardings)
    assert list(got.out_shardings) == _jax_specs(want.out_shardings)
    # the last rank of the mesh: its local shapes are JAX's shard shapes
    coords = {a: n - 1 for a, n in got.mesh.shape.items()}
    local = _shapes(got.rank_shapes(coords))
    shard = [(p, tuple(s.shard_shape(a.shape)), str(a.dtype))
             for (p, a), (_, s) in zip(_leaves(want.args),
                                       _leaves(want.in_shardings))]
    assert local == shard


def test_model_opts_are_the_launch_opts():
    """The JAX launch opts, field by field (dtypes by name), but
    ``flash_unroll``, which only unrolls XLA scans for the HLO
    analysis."""
    for mode in ("train", "prefill", "decode"):
        for analysis in (False, True):
            want = jsteps._model_opts(None, mode, analysis)
            got = steps._model_opts(None, mode, analysis)
            for f in ("attn_impl", "flash_block", "moe_impl", "remat",
                      "ce_chunk", "scan_layers"):
                assert getattr(got, f) == getattr(want, f), (mode, f)
            for f in ("param_dtype", "compute_dtype", "cache_dtype"):
                assert str(getattr(got, f)).replace("torch.", "") == \
                    str(jnp.dtype(getattr(want, f)))


@pytest.mark.parametrize("arch,shape", [
    ("h2o-danube-1.8b", "decode_32k"), ("zamba2-2.7b", "decode_32k"),
    ("gemma3-1b", "decode_32k"), ("seamless-m4t-large-v2", "decode_32k"),
    ("mamba2-1.3b", "train_4k"), ("pixtral-12b", "prefill_32k")])
def test_materialize_gives_the_abstract_shapes(arch, shape):
    cell = steps.build_cell(arch, shape, Mesh.abstract((1, 1),
                                                       ("data", "model")),
                            reduced=True, batch=2, layers=2)
    args = cell.materialize("cpu", torch.Generator().manual_seed(0))
    assert _shapes(args) == _shapes(cell.abstract_args())
    assert all(t.device.type == "cpu" for _, t in _leaves(args))
    if cell.mode != "decode":
        return
    seen = cell.shape.seq_len - 1
    cache = args[2]
    assert (cache["pos"] == seen).all()
    rings = [c for c in _leaves(cache) if c[0][-1] == "kv_pos"]
    assert rings or cell.arch.family == "ssm"
    for _, kp in rings:            # the last `width` positions, in ring order
        width = kp.shape[-1]
        want = torch.arange(seen - width, seen)
        assert torch.equal(kp.reshape(-1, width)[0].sort().values.long(),
                           want)
        assert torch.equal(kp.reshape(-1, width)[0].long() % width,
                           torch.arange(width))
    assert (args[1] >= 0).all() and (args[1] < cell.arch.vocab).all()


def test_cuts_change_only_batch_and_depth():
    mesh = Mesh.abstract((1, 1), ("data", "model"))
    full = steps.build_cell("mixtral-8x7b", "decode_32k", mesh)
    cut = steps.build_cell("mixtral-8x7b", "decode_32k", mesh, batch=4,
                           layers=16)
    assert cut.shape.global_batch == 4 and cut.arch.n_layers == 16
    assert cut.arch.d_model == full.arch.d_model
    assert cut.args[2]["kv"]["k"].shape == (16, 4) + \
        full.args[2]["kv"]["k"].shape[2:]
    assert cut.args[0]["layers"]["moe"]["w_gate"].shape[1:] == \
        full.args[0]["layers"]["moe"]["w_gate"].shape[1:]
