"""The port's model primitives and weight bridge against the JAX package.

Same numpy inputs through ``rmsnorm``, ``apply_rope``, ``attn_qkv`` and
``mlp_apply`` in both packages, fp32, atol 1e-5 (a few ulps of the values
involved; the two sides use different BLAS and transcendental code). The
bridge must carry ``DecoderLM.init``'s tree across exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import build_model
from repro.models.layers import attn_qkv as jax_attn_qkv
from repro.models.layers import mlp_apply as jax_mlp_apply
from repro.models.module import rmsnorm as jax_rmsnorm
from repro.models.rope import apply_rope as jax_apply_rope
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.models import (apply_rope, attn_qkv, init_params,
                                mlp_apply, params_from_numpy,
                                params_to_numpy, rmsnorm)

ATOL = 1e-5
ARCHS = ["h2o-danube-1.8b", "stablelm-3b"]


@pytest.fixture(scope="module")
def jax_params():
    """DecoderLM(get_reduced(...)).init(PRNGKey(0)) as numpy, per arch."""
    return {a: jax.tree.map(np.asarray, build_model(get_reduced(a)).init(
        jax.random.PRNGKey(0))) for a in ARCHS}


def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree["layers"])


def _t(tree):
    return params_from_numpy(tree, "cpu")


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    want = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", [16, 80])
def test_apply_rope_matches_jax(d):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, d)).astype(np.float32)
    pos = rng.integers(0, 600, (2, 9)).astype(np.int32)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                     10_000.0).numpy()
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     10_000.0))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_qkv_matches_jax(arch, jax_params):
    cfg, tcfg = get_reduced(arch), torch_get_reduced(arch)
    lp = _layer0(jax_params[arch])["attn"]
    rng = np.random.default_rng(2)
    h = rng.standard_normal((1, 11, cfg.d_model)).astype(np.float32)
    pos = (5 + np.arange(11, dtype=np.int32))[None]
    got = attn_qkv(_t(lp), torch.from_numpy(h), torch.from_numpy(pos), tcfg)
    want = jax_attn_qkv(_j(lp), jnp.asarray(h), jnp.asarray(pos), cfg)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_mlp_apply_matches_jax(arch, jax_params):
    cfg = get_reduced(arch)
    lp = _layer0(jax_params[arch])["mlp"]
    x = np.random.default_rng(3).standard_normal(
        (1, 6, cfg.d_model)).astype(np.float32)
    got = mlp_apply(_t(lp), torch.from_numpy(x)).numpy()
    want = np.asarray(jax_mlp_apply(_j(lp), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_bridge_round_trips_decoder_lm_tree(jax_params):
    tree = jax_params["h2o-danube-1.8b"]
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    flat_in, struct_in = jax.tree.flatten(tree)
    flat_out, struct_out = jax.tree.flatten(back)
    assert struct_in == struct_out
    for a, b in zip(flat_in, flat_out):
        assert a.shape == b.shape and b.dtype == np.float32
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_jax_layout_and_scales(arch, jax_params):
    """The port's own initializer: same tree, shapes and distributions as
    DecoderLM.init (never used for a parity result)."""
    cfg = torch_get_reduced(arch)
    mine = params_to_numpy(init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    ref = jax_params[arch]
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mine),
                            jax.tree.leaves(ref)):
        assert a.shape == b.shape, path
        assert a.std() == pytest.approx(b.std(), rel=0.25, abs=1e-6), path
    assert np.all(mine["layers"]["ln1"] == 0) and np.all(mine["ln_f"] == 0)


def test_init_params_rejects_non_dense():
    import dataclasses
    cfg = dataclasses.replace(torch_get_reduced("stablelm-3b"), family="ssm")
    with pytest.raises(NotImplementedError):
        init_params(cfg, torch.Generator(), "cpu")
