"""The port's encoder-decoder (``EncDecLM``, seamless-m4t-large-v2)
against the JAX package's, on the CPU.

Both packages run the reduced config on the JAX ``init(PRNGKey(0))``
weights, carried across by the bridge; encoder frames and decoder tokens
come from a numpy seed; the JAX side runs jitted. Pinned:

* ``init_cache`` equals the JAX zero cache, structure included;
* prefill logits and the cache (``pos``, the self-attention ring ``kv``,
  ``cross_k``/``cross_v``, ``memory_pos``) within 1e-4, then three greedy
  decode steps, logits and caches within 1e-4 and tokens equal, with
  the encoder on the dense and on the flash path (blocks of 8);
* ``train_loss`` and every gradient leaf against ``jax.value_and_grad``:
  loss within rtol 1e-5, gradients within atol 1e-5·max|g| + rtol 1e-4;
* the port's own prefill/decode consistency within
  tests/test_models.py's 5e-4;
* the config copy is byte-equal to the JAX package's and registered;
  ``init_params`` builds the JAX tree; ``build_model`` gives ``EncDecLM``.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import ModelOpts as JaxOpts
from repro.models import build_model as jax_build_model
from repro_torch.configs import all_archs, get_reduced as torch_get_reduced
from repro_torch.models import (EncDecLM, ModelOpts, build_model,
                                init_params, params_from_numpy,
                                params_to_numpy)
from repro_torch.training.train_step import value_and_grad

ARCH = "seamless-m4t-large-v2"
ATOL = 1e-4
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under the suite's parallel workers each process's default thread
    pool oversubscribes the cores, which slows these loops of small ops
    by an order of magnitude. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    params = jax.jit(jax_build_model(get_reduced(ARCH)).init)(
        jax.random.PRNGKey(0))
    return params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def _models(weights, **opts):
    params, tparams = weights
    jm = jax_build_model(get_reduced(ARCH), JaxOpts(**opts))
    tm = build_model(torch_get_reduced(ARCH), ModelOpts(**opts),
                     device="cpu")
    return jm, params, tm, tparams


def _inputs(b, s_enc, s_dec, seed, d=64, vocab=256):
    rng = np.random.default_rng(seed)
    e = (rng.standard_normal((b, s_enc, d)) * 0.1).astype(np.float32)
    t = rng.integers(0, vocab, (b, s_dec)).astype(np.int32)
    return ({"enc_embeds": jnp.asarray(e), "dec_tokens": jnp.asarray(t)},
            {"enc_embeds": torch.from_numpy(e),
             "dec_tokens": torch.from_numpy(t)})


def _close_tree(got, want, atol):
    ref = jax.tree.map(np.asarray, want)
    mine = params_to_numpy(got)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(mine)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=str(path))


def test_build_model_gives_encdec_and_zero_cache(weights):
    jm, _, tm, _ = _models(weights)
    assert isinstance(tm, EncDecLM)
    _close_tree(tm.init_cache(3, 16, enc_len=12),
                jm.init_cache(3, 16, enc_len=12), 0.0)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_prefill_and_decode_match_jax(weights, impl):
    opts = {"attn_impl": impl, "flash_block": 8}
    jm, params, tm, tparams = _models(weights, **opts)
    ji, ti = _inputs(2, 21, 4, seed=1)
    prefill = jax.jit(jm.prefill, static_argnames="max_len")
    decode = jax.jit(jm.decode_step)
    lj, cj = prefill(params, ji, max_len=16)
    lt, ct = tm.prefill(tparams, ti, max_len=16)
    for step in range(4):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        _close_tree(ct, cj, ATOL)
        tj = jnp.argmax(lj, -1).astype(jnp.int32)
        tt = lt.argmax(-1)
        assert tt.tolist() == np.asarray(tj).tolist(), f"step {step}"
        if step < 3:
            lj, cj = decode(params, tj, cj)
            lt, ct = tm.decode_step(tparams, tt, ct)
    assert ct["pos"].tolist() == [7, 7]
    assert ct["cross_k"].shape == (2, 2, 21, 4, 16)
    assert sorted(ct["kv"]["kv_pos"][0].tolist())[-7:] == list(range(7))


def test_train_loss_and_grads_match_jax(weights):
    jm, params, tm, tparams = _models(weights)
    ji, ti = _inputs(2, 12, 10, seed=2)
    jl, jg = jax.jit(jax.value_and_grad(jm.train_loss))(params, ji)
    tl, tg = value_and_grad(tm.train_loss, tparams, ti)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    ref = jax.tree.map(np.asarray, jg)
    mine = params_to_numpy(tg)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(mine)):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=str(path))


def test_prefill_decode_consistency(weights):
    """decode(prefill(x[:n])) logits == prefill(x[:n+1]) logits, as
    tests/test_models.py holds the JAX model."""
    _, _, tm, tparams = _models(weights)
    _, ti = _inputs(2, 12, 1, seed=3)
    enc = ti["enc_embeds"]
    d0 = torch.tensor([[3], [5]], dtype=torch.int32)
    lg1, c = tm.prefill(tparams, {"enc_embeds": enc, "dec_tokens": d0}, 16)
    t1 = lg1.argmax(-1).to(torch.int32)
    lg2, _ = tm.decode_step(tparams, t1, c)
    lg3, _ = tm.prefill(tparams, {"enc_embeds": enc, "dec_tokens": torch.cat(
        [d0, t1[:, None]], 1)}, 16)
    assert float((lg2 - lg3).abs().max()) < 5e-4


def test_config_copy_is_pinned():
    rel = "configs/seamless_m4t_large_v2.py"
    assert (SRC / "repro_torch" / rel).read_text() == \
        (SRC / "repro" / rel).read_text()
    assert ARCH in all_archs()
    assert dataclasses.asdict(torch_get_reduced(ARCH)) == \
        dataclasses.asdict(get_reduced(ARCH))


def test_init_params_builds_the_jax_tree(weights):
    ref = jax.tree.map(np.asarray, weights[0])
    mine = params_to_numpy(init_params(torch_get_reduced(ARCH),
                                       torch.Generator().manual_seed(0),
                                       "cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mine),
                            jax.tree.leaves(ref)):
        assert a.shape == b.shape, path
        assert a.std() == pytest.approx(b.std(), rel=0.25, abs=1e-6), path
