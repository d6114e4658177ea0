"""The port's logical-axis rule tables (``distributed/sharding.py``),
models' axes trees and ``opt_axes`` against the JAX package's, with no
process spawned.

The JAX side gets a ``jax.sharding.AbstractMesh`` (its rule code reads only
``shape`` and ``axis_names``), the port a ``Mesh.abstract`` of the same
shape. For every config of ``src/repro_torch/configs`` on the meshes
(1, 2), (1, 4), (2, 2), (16, 16) and (2, 16, 16): the ``serving_rules``
tables with ``decode`` False and True and ``context_parallel`` None and
each mesh axis, ``training_rules``, and the spec of every leaf of
``axes()`` and ``cache_axes()`` under each of them, equal JAX's
(``PartitionSpec`` as a tuple). On the reduced configs ``opt_axes``
(AdamW, Adafactor) equals JAX's, and ``shard_params``'s shards, put back
together, give each leaf at TP 2 and 4.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
import repro.distributed.sharding as jsh
import repro.models as jmodels
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.optimizer import opt_axes as jopt_axes
import repro_torch.configs as tconfigs
import repro_torch.distributed.sharding as tsh
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models.lm import build_model
from repro_torch.models.weights import init_params
from repro_torch.training.optimizer import OptConfig, opt_axes

tconfigs._load_all()
ARCHS = tconfigs.all_archs()
MESHES = {"1x2": ((1, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(key):
    shape, names = MESHES[key]
    return AbstractMesh(shape, names), Mesh.abstract(shape, names)


def _variants(names):
    """(decode, context_parallel) of every serving table compared."""
    return [(d, cp) for d in (False, True) for cp in (None,) + names]


def _leaves(tree, path=()):
    """(path, axes tuple) of every leaf of an axes tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def test_config_copies_cover_the_jax_archs():
    assert set(ARCHS) == set(jconfigs.all_archs())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_rules_match_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for decode, cp in _variants(tm.axis_names):
        want = jsh.serving_rules(jm, jcfg, decode=decode,
                                 context_parallel=cp).table
        got = tsh.serving_rules(tm, tcfg, decode=decode,
                                context_parallel=cp).table
        assert got == want, (decode, cp)
    assert tsh.serving_rules(tm).table == jsh.serving_rules(jm).table


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_training_rules_match_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    want = jsh.training_rules(jm, jconfigs.get(arch)).table
    assert tsh.training_rules(tm, tconfigs.get(arch)).table == want
    assert tsh.training_rules(tm).table == jsh.training_rules(jm).table


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_specs_match_jax(arch, mesh):
    """``spec()`` of every leaf of ``axes()`` and ``cache_axes()`` (and
    ``axes_to_spec`` / ``param_specs`` over the trees) under every serving
    table and the training table."""
    jm, tm = _meshes(mesh)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jmodel = jmodels.build_model(jcfg)
    tmodel = build_model(tcfg, device="cpu")
    trees = {"axes": (jmodel.axes(), tmodel.axes()),
             "cache_axes": (jmodel.cache_axes(), tmodel.cache_axes())}
    for name, (jt, tt) in trees.items():
        assert [p for p, _ in _leaves(tt)] == [p for p, _ in _leaves(jt)], \
            name
        assert _leaves(tt) == [(p, tuple(a)) for p, a in _leaves(jt)], name
    rules = [(jsh.serving_rules(jm, jcfg, decode=d, context_parallel=cp),
              tsh.serving_rules(tm, tcfg, decode=d, context_parallel=cp))
             for d, cp in _variants(tm.axis_names)]
    rules.append((jsh.training_rules(jm, jcfg),
                  tsh.training_rules(tm, tcfg)))
    for jr, tr in rules:
        for name, (jt, tt) in trees.items():
            want = [tuple(jr.spec(a)) for _, a in _leaves(jt)]
            assert [tr.spec(a) for _, a in _leaves(tt)] == want, name
            assert [s for _, s in _leaves(tsh.axes_to_spec(tt, tr))] == want
            assert [s for _, s in _leaves(tsh.param_specs(tt, tr))] == want


def test_spec_edge_cases_match_jax():
    """A mesh axis appears once in a spec (first use wins, a tuple overlap
    suppressed either way round); None and unknown logical axes give
    None."""
    jm, tm = _meshes("2x16x16")
    table = {"a": "model", "b": "model", "batch": ("pod", "data"),
             "x": "data", "embed": None}
    jr = jsh.ShardingRules(mesh=jm, table=table)
    tr = tsh.ShardingRules(mesh=tm, table=table)
    for axes in (("a", "b"), ("b", "a"), ("batch", "x"), ("x", "batch"),
                 (None, "embed", "missing"), ()):
        assert tr.spec(axes) == tuple(jr.spec(axes)), axes
    assert tr.spec(("x", "batch")) == ("data", None)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_axes_match_jax(arch, opt):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jmodel = jmodels.build_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    want = jopt_axes(jmodel.axes(), shapes, JOptConfig(name=opt))
    params = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = opt_axes(build_model(tcfg, device="cpu").axes(), params,
                   OptConfig(name=opt))
    assert _leaves(got) == [(p, tuple(a)) for p, a in _leaves(want)]


def _model_dim(spec) -> int:
    """The dim a spec shards over ``model`` (-1: none)."""
    for i, part in enumerate(spec):
        if part is not None and "model" in (
                part if isinstance(part, tuple) else (part,)):
            return i
    return -1


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_params_round_trip(arch, tp):
    """Each rank's ``shard_params`` slices, concatenated in model order
    along the dim the spec shards, give back every leaf; a replicated leaf
    is whole on every rank."""
    cfg = tconfigs.get_reduced(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    axes = build_model(cfg, device="cpu").axes()
    mesh = Mesh.abstract((1, tp), ("data", "model"))
    rules = tsh.serving_rules(mesh, cfg)
    shards = [tsh.shard_params(params, axes, rules, {"data": 0, "model": r})
              for r in range(tp)]
    leaves = _leaves(axes)
    n_split = 0
    for path, ax in leaves:
        def at(tree):
            for k in path:
                tree = tree[k]
            return tree
        whole, parts = at(params), [at(s) for s in shards]
        dim = _model_dim(rules.spec(ax))
        if dim < 0:
            assert all(torch.equal(p, whole) for p in parts), path
            continue
        n_split += 1
        assert {p.shape[dim] for p in parts} == {whole.shape[dim] // tp}
        assert torch.equal(torch.cat(parts, dim), whole), path
    assert n_split > 0


def test_shard_params_refuses_a_mismatch():
    mesh = Mesh.abstract((1, 2), ("data", "model"))
    rules = tsh.ShardingRules(mesh=mesh, table={"heads": "model"})
    with pytest.raises(ValueError, match="do not match"):
        tsh.shard_params({"w": torch.zeros(4, 4)}, {"w": ("heads",)}, rules,
                         {"data": 0, "model": 0})
    with pytest.raises(ValueError, match="does not split"):
        tsh.shard_params({"w": torch.zeros(3)}, {"w": ("heads",)}, rules,
                         {"data": 0, "model": 0})


def test_meshes():
    """Production meshes are abstract (the rule tables' 16 × 16 and
    2 × 16 × 16); a test mesh without a started group fails loudly, naming
    the processes to start; ``constrain`` is the identity."""
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.groups is None
    m3 = make_production_mesh(multi_pod=True)
    assert m3.axis_names == ("pod", "data", "model") and m3.size == 512
    with pytest.raises(RuntimeError, match="spawn"):
        make_test_mesh(data=1, model=4)
    x = torch.ones(2)
    with tsh.use_rules(tsh.serving_rules(m)):
        assert tsh.constrain(x, ("batch",)) is x
    assert np.array_equal(tsh.constrain(x, ("batch",)).numpy(), np.ones(2))
