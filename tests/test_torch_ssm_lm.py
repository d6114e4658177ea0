"""The port's ``DecoderLM`` for the SSM family (mamba2) against the JAX
package's, on the CPU.

Parameters come from ``repro.models.build_model(cfg).init(PRNGKey(0))`` and
cross to the port through ``params_from_numpy``; the prompts come from a
numpy seed. Pinned, on reduced mamba2-1.3b (2 layers, d_model 64, 8 heads
of 16, d_state 16, chunk 16):

* ``prefill`` and 3 greedy ``decode_step``s, at prompts shorter than a
  chunk, of one chunk and ragged across chunks: the greedy tokens equal
  the JAX run's, logits within 5e-4 (the bar of tests/test_models.py::
  test_prefill_decode_consistency) and the caches within 1e-4;
* the port's own prefill/decode consistency: decode(prefill(x[:n])) logits
  equal prefill(x[:n+1]) logits within 5e-4;
* the port's ``init_params`` builds the JAX tree (keys, shapes, std within
  25 %), ``init_cache`` the JAX zero cache; the bridge carries the SSM
  tree both ways;
* every other family is refused: ``DecoderLM`` and ``init_params`` for the
  dense and hybrid configs, the paged executor for the SSM config (it
  points at ``DecoderLM``, as the JAX executor serves no SSM model).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.engine import PagedTransformerExecutor
from repro_torch.models import (DecoderLM, build_model, init_params,
                                params_from_numpy, params_to_numpy)

ARCH = "mamba2-1.3b"
ATOL_LOGITS = 5e-4
ATOL_CACHE = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced(ARCH)
    jm = jax_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = torch_get_reduced(ARCH)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, jm, params, tcfg, build_model(tcfg, device="cpu"), tparams


def _prompt(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _close_tree(got, want, atol):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree.leaves(params_to_numpy(got))
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        assert g.shape == np.asarray(w).shape, path
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("slen", [10, 16, 33])
def test_prefill_and_decode_match_jax(setup, slen):
    cfg, jm, params, tcfg, tm, tparams = setup
    toks = _prompt(cfg, 2, slen, seed=slen)
    lj, cj = jm.prefill(params, jnp.asarray(toks), max_len=slen + 4)
    lt, ct = tm.prefill(tparams, torch.from_numpy(toks), max_len=slen + 4)
    assert lt.shape == (2, cfg.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL_LOGITS,
                               rtol=0)
    _close_tree(ct, cj, ATOL_CACHE)
    tj = jnp.argmax(lj, -1).astype(jnp.int32)
    tt = lt.argmax(-1)
    for _ in range(3):
        assert tt.tolist() == np.asarray(tj).tolist()
        lj, cj = jm.decode_step(params, tj, cj)
        lt, ct = tm.decode_step(tparams, tt, ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=ATOL_LOGITS, rtol=0)
        _close_tree(ct, cj, ATOL_CACHE)
        tj = jnp.argmax(lj, -1).astype(jnp.int32)
        tt = lt.argmax(-1)
    assert tt.tolist() == np.asarray(tj).tolist()
    assert ct["pos"].tolist() == [slen + 3] * 2


@pytest.mark.parametrize("n", [15, 16, 24])
def test_prefill_decode_consistency(setup, n):
    """decode(prefill(x[:n])) == prefill(x[:n+1]), across the chunk edge."""
    _, _, _, tcfg, tm, tparams = setup
    toks = torch.from_numpy(_prompt(tcfg, 2, n + 1, seed=100 + n))
    _, cache = tm.prefill(tparams, toks[:, :n], max_len=n + 1)
    dec, _ = tm.decode_step(tparams, toks[:, n], cache)
    full, _ = tm.prefill(tparams, toks, max_len=n + 1)
    assert float((dec - full).abs().max()) < ATOL_LOGITS


def test_init_params_builds_the_jax_tree(setup):
    cfg, _, params, tcfg, tm, _ = setup
    mine = params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    ref = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mine),
                            jax.tree.leaves(ref)):
        assert a.shape == b.shape, path
        assert a.std() == pytest.approx(b.std(), rel=0.25, abs=1e-6), path
    assert np.all(mine["layers"]["ln"] == 0) and np.all(mine["ln_f"] == 0)
    np.testing.assert_allclose(mine["layers"]["mamba"]["A_log"],
                               ref["layers"]["mamba"]["A_log"], rtol=1e-6)


def test_bridge_carries_the_ssm_tree(setup):
    _, _, params, _, _, tparams = setup
    ref = jax.tree.map(np.asarray, params)
    back = params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_init_cache_is_the_jax_zero_cache(setup):
    _, jm, _, _, tm, _ = setup
    want = jm.init_cache(3, 32)
    got = tm.init_cache(3, 32)
    _close_tree(got, want, 0.0)
    assert got["pos"].dtype == torch.int32


def test_other_families_are_refused():
    dense = torch_get_reduced("stablelm-3b")
    ssm = torch_get_reduced(ARCH)
    with pytest.raises(NotImplementedError, match="A12b"):
        DecoderLM(dense, device="cpu")
    with pytest.raises(NotImplementedError, match="A12b"):
        DecoderLM(dataclasses.replace(ssm, family="hybrid"), device="cpu")
    with pytest.raises(NotImplementedError):
        init_params(dataclasses.replace(ssm, family="hybrid"),
                    torch.Generator(), "cpu")
    params = init_params(ssm, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="DecoderLM"):
        PagedTransformerExecutor(ssm, params, device="cpu")
