"""The port's models in bf16 against the JAX package's, on the CPU, at the
JAX launch cells' dtypes (``src/repro/launch/steps.py::_model_opts``).

Serving opts: bf16 parameters, compute and cache, flash prefill,
``capacity`` MoE. ``DecoderLM`` for a dense model (stablelm-3b), a
sliding window (h2o-danube-1.8b), gemma3's local:global windows, MoE
(mixtral-8x7b under ``exact`` and ``capacity``), the SSM (mamba2-1.3b) and
the hybrid (zamba2-2.7b), and ``EncDecLM`` (seamless-m4t-large-v2), on the
JAX ``init`` weights in bf16 carried across by the bridge: prefill and
three decode steps, both fed JAX's greedy tokens. Bar: logits within
2e-2·max|logit| (XLA's and PyTorch's CPU bf16 products round about 0.02 %
of their elements to a neighbouring bf16 value, and those one-ulp
differences travel through the layers: the reduced models measure up to
1.9e-2), the port's greedy token equal to JAX's wherever JAX's top-2
margin is larger than that bar, and the caches of JAX's dtypes (bf16 K/V,
fp32 Mamba2 states).

Training opts: fp32 parameters, bf16 compute and cache, flash, capacity,
remat, ``ce_chunk`` 2048. ``train_loss`` and its gradients against
``jax.value_and_grad`` for h2o-danube-1.8b, mixtral-8x7b, mamba2-1.3b,
zamba2-2.7b and seamless-m4t-large-v2. Each framework's bf16 gradients
are 1-7 % of a leaf's max away from its own fp32 ones, so the bar is
relative to that: per leaf, |port − JAX| ≤ (2e-2 + 1.5·|JAX − JAX fp32|)
of the leaf's fp32 max, none lost (a leaf JAX moves, the port moves);
the loss within 1e-3 of JAX's (measured ≤ 4e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import ModelOpts as JaxOpts
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.models import (ModelOpts, build_model, params_from_numpy,
                                params_to_numpy)
from repro_torch.training.train_step import value_and_grad

BF16 = torch.bfloat16
LOGIT_BAR = 2e-2


def _opts(mode: str, moe_impl: str = "capacity"):
    """(JAX opts, port opts) of the launch cells' ``mode``."""
    if mode == "serve":
        kw = dict(attn_impl="flash", moe_impl=moe_impl, remat=False)
        dts = ((jnp.bfloat16,) * 3, (BF16,) * 3)
    else:
        kw = dict(attn_impl="flash", moe_impl="capacity", remat=True,
                  ce_chunk=2048)
        dts = ((jnp.float32, jnp.bfloat16, jnp.bfloat16),
               (torch.float32, BF16, BF16))
    names = ("param_dtype", "compute_dtype", "cache_dtype")
    return (JaxOpts(**dict(zip(names, dts[0])), **kw),
            ModelOpts(**dict(zip(names, dts[1])), **kw))


def _models(arch, mode, moe_impl="capacity"):
    """Both models and both copies of the JAX ``init`` weights (in the
    opts' parameter dtype)."""
    jo, to = _opts(mode, moe_impl)
    jm = jax_build_model(get_reduced(arch), jo)
    tm = build_model(torch_get_reduced(arch), to, device="cpu")
    params = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params), "cpu",
        to.param_dtype)
    return jm, params, tm, tparams


def _inputs(cfg, seed, b=2, s=20):
    """(JAX, port) inputs: token ids, embeddings for a VLM, or the
    encoder-decoder's frames and decoder tokens."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        e = (rng.standard_normal((b, 12, cfg.d_model)) * 0.1).astype(
            np.float32)
        t = rng.integers(0, cfg.vocab, (b, 6)).astype(np.int32)
        return ({"enc_embeds": jnp.asarray(e), "dec_tokens": jnp.asarray(t)},
                {"enc_embeds": torch.from_numpy(e),
                 "dec_tokens": torch.from_numpy(t)})
    if cfg.embeds_input:
        e = (rng.standard_normal((b, s, cfg.d_model)) * 0.1).astype(
            np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t)


def _check_logits(got: torch.Tensor, want, step):
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    g, w = got.numpy(), np.asarray(want)
    bar = LOGIT_BAR * np.abs(w).max()
    assert np.abs(g - w).max() <= bar, (step, np.abs(g - w).max() / bar)
    top2 = np.sort(w, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > bar
    assert np.array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear]), step


def _cache_dtypes(got, want):
    """The port's cache has JAX's structure and dtypes."""
    ref = jax.tree.map(lambda a: str(a.dtype), want)
    mine = jax.tree.map(lambda t: str(t.dtype).replace("torch.", ""), got)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    assert jax.tree.leaves(mine) == jax.tree.leaves(ref)


SERVE = [("stablelm-3b", "capacity"), ("h2o-danube-1.8b", "capacity"),
         ("gemma3-1b", "capacity"), ("mixtral-8x7b", "exact"),
         ("mixtral-8x7b", "capacity"), ("mamba2-1.3b", "capacity"),
         ("zamba2-2.7b", "capacity"), ("seamless-m4t-large-v2", "capacity")]


@pytest.mark.parametrize("arch, moe_impl", SERVE,
                         ids=[f"{a}-{m}" for a, m in SERVE])
def test_serving_opts_match_jax(arch, moe_impl):
    jm, params, tm, tparams = _models(arch, "serve", moe_impl)
    ji, ti = _inputs(tm.cfg, seed=7)
    lj, cj = jm.prefill(params, ji, max_len=32)
    lt, ct = tm.prefill(tparams, ti, max_len=32)
    for step in range(4):
        _check_logits(lt, lj, step)
        _cache_dtypes(ct, cj)
        if step == 3:
            break
        tok = np.array(jnp.argmax(lj, -1), np.int32)
        lj, cj = jm.decode_step(params, jnp.asarray(tok), cj)
        lt, ct = tm.decode_step(tparams, torch.from_numpy(tok), ct)
    if tm.cfg.family in ("ssm", "hybrid"):
        assert ct["mamba"]["ssm"].dtype == torch.float32
    if tm.cfg.family != "ssm":
        kv = ct["attn"] if tm.cfg.family == "hybrid" else ct["kv"]
        kv = kv[0] if isinstance(kv, list) else kv
        assert kv["k"].dtype == BF16


TRAIN = ["h2o-danube-1.8b", "mixtral-8x7b", "mamba2-1.3b", "zamba2-2.7b",
         "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", TRAIN)
def test_training_opts_loss_and_grads_match_jax(arch):
    jm, params, tm, tparams = _models(arch, "train")
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    if cfg.is_encoder_decoder:
        jb, tb = _inputs(cfg, seed=3)
    else:
        t = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}
    lj, gj = jax.value_and_grad(jm.train_loss)(params, jb)
    lt, gt = value_and_grad(tm.train_loss, tparams, tb)
    f32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    jm32 = jax_build_model(get_reduced(arch),
                           JaxOpts(**{**_opts("train")[0].__dict__, **f32}))
    _, g32 = jax.value_and_grad(jm32.train_loss)(params, jb)
    assert lt.dtype == torch.float32
    assert abs(float(lt) - float(lj)) <= 1e-3 * abs(float(lj))
    want, ref32 = (jax.tree.map(np.asarray, g) for g in (gj, g32))
    got = params_to_numpy(gt)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g, r in zip(jax.tree_util.tree_leaves_with_path(want),
                               jax.tree.leaves(got), jax.tree.leaves(ref32)):
        assert g.dtype == w.dtype == np.float32, path
        scale = np.abs(r).max()
        if np.abs(w).max() > 0:
            assert np.abs(g).max() > 0, f"{path}: gradient lost"
        if scale == 0:
            continue
        own = np.abs(w - r).max() / scale
        err = np.abs(g - w).max() / scale
        assert err <= 2e-2 + 1.5 * own, (jax.tree_util.keystr(path), err,
                                         own)
