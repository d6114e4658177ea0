"""The port's training loss and its gradients against the JAX package's,
on the CPU.

Both packages run the reduced configs on the JAX ``init(PRNGKey(0))``
weights, carried across by the bridge; tokens, embeddings, labels and
masks come from a numpy seed; the JAX side runs jitted, as its train
step does. Pinned:

* ``DecoderLM.train_loss`` and every gradient leaf against
  ``jax.value_and_grad`` for stablelm-3b, deepseek-67b, mixtral-8x7b and
  kimi-k2-1t-a32b (``moe_impl`` exact and capacity: B4's plain version
  under the ``MoeGmm`` Function), pixtral-12b (``embeds`` with labels and a
  mask), gemma3-1b (unrolled local:global windows through the flash
  Function, blocks of 8), mamba2-1.3b and zamba2-2.7b (every Mamba2 block
  through B5's plain forward and backward under the ``MambaChunkScan``
  Function; zamba2's shared attention block applied once, then a
  remainder block). Loss within rtol 1e-5; gradients within atol
  1e-5·max|g| plus rtol 1e-4 (fp32 sums in another order, through up to
  four layers and the chunked cross-entropy);
* the ``FlashAttention`` Function's gradients against JAX's custom VJP
  (blocks of 8, the last one padded) and against autograd through
  ``dense_attention``, causal, windowed and non-causal, within 1e-5;
* the ``MoeGmm`` Function's gradients against autograd through
  ``moe_gmm_ref``, within 1e-5; B4's launch plan and checks take the
  backward GEMMs' shapes (dw's rows are d or f);
* ``remat`` on and off give equal gradients (mixtral-8x7b, mamba2-1.3b,
  zamba2-2.7b); the hybrid's ``train_loss`` builds no KV cache (its
  shared block runs with ``cache_width=None``, as JAX's), while its
  prefill builds one of the prompt's width; a windowed ``attn_seq``
  without a cache, and so ``train_loss``, never takes the banded path,
  while the prefill still does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import ModelOpts as JaxOpts
from repro.models import build_model as jax_build_model
from repro.models.attention import flash_attention as jax_flash
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.kernels import moe_gmm
from repro_torch.kernels.moe_gmm import MoeGmm
from repro_torch.kernels.ref import moe_gmm_ref
from repro_torch.models import (ModelOpts, build_model, params_from_numpy,
                                params_to_numpy)
from repro_torch.models import layers as L
from repro_torch.models.attention import dense_attention, flash_attention
from repro_torch.training.train_step import value_and_grad

RTOL_LOSS = 1e-5
RTOL_GRAD, ATOL_GRAD = 1e-4, 1e-5     # atol × max|g| of the leaf
CASES = [("stablelm-3b", {}), ("deepseek-67b", {}),
         ("mixtral-8x7b", {"moe_impl": "exact"}),
         ("mixtral-8x7b", {"moe_impl": "capacity"}),
         ("kimi-k2-1t-a32b", {"moe_impl": "exact"}),
         ("kimi-k2-1t-a32b", {"moe_impl": "capacity"}),
         ("pixtral-12b", {}),
         ("gemma3-1b", {"attn_impl": "flash", "flash_block": 8}),
         ("mamba2-1.3b", {}), ("zamba2-2.7b", {})]


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


def _batch(cfg, b, s, seed):
    """(JAX batch, port batch): tokens, or embeds with labels and a
    mask."""
    rng = np.random.default_rng(seed)
    if cfg.embeds_input:
        e = (rng.standard_normal((b, s, cfg.d_model)) * 0.1).astype(
            np.float32)
        lab = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        mask = rng.random((b, s)) < 0.7
        return ({"embeds": jnp.asarray(e), "labels": jnp.asarray(lab),
                 "mask": jnp.asarray(mask)},
                {"embeds": torch.from_numpy(e),
                 "labels": torch.from_numpy(lab),
                 "mask": torch.from_numpy(mask)})
    t = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}


def _grads_close(got, want):
    """Same tree; every leaf within atol 1e-5·max|g| + rtol 1e-4."""
    ref = jax.tree.map(np.asarray, want)
    mine = params_to_numpy(got)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(mine)):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(
            g, w, rtol=RTOL_GRAD, atol=ATOL_GRAD * float(np.abs(w).max()),
            err_msg=str(path))


@pytest.mark.parametrize("arch, opts", CASES,
                         ids=[f"{a}-{'-'.join(map(str, o.values()))}"
                              for a, o in CASES])
def test_train_loss_and_grads_match_jax(arch, opts):
    cfg = get_reduced(arch)
    jm = jax_build_model(cfg, JaxOpts(**opts))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = build_model(torch_get_reduced(arch), ModelOpts(**opts),
                     device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    jb, tb = _batch(cfg, 2, 20, seed=3)
    jl, jg = jax.jit(jax.value_and_grad(jm.train_loss))(params, jb)
    tl, tg = value_and_grad(tm.train_loss, tparams, tb)
    assert float(tl) == pytest.approx(float(jl), rel=RTOL_LOSS)
    _grads_close(tg, jg)


def _qkv(b, tq, tk, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, tq, h, d), (b, tk, hkv, d), (b, tk, hkv, d),
                      (b, tq, h, d))]


@pytest.mark.parametrize("causal, window", [(True, None), (True, 5),
                                            (False, None)],
                         ids=["causal", "window5", "noncausal"])
def test_flash_function_grads_match_jax_vjp_and_dense(causal, window):
    """Blocks of 8 over 21 keys: the last block padded with 3 invalid
    slots; GQA of 2 query heads per KV head."""
    q, k, v, dout = _qkv(2, 21, 21, 4, 2, 16, seed=1)
    pos = np.broadcast_to(np.arange(21, dtype=np.int32), (2, 21))
    kw = dict(causal=causal, window=window)
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash(
        a, b_, c, jnp.asarray(pos), jnp.asarray(pos), block=8, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tpos = torch.from_numpy(pos.copy())
    out = flash_attention(tq, tk, tv, tpos, tpos, block=8, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    dense = dense_attention(tq, tk, tv, tpos, tpos, **kw)
    oracle = torch.autograd.grad(dense, (tq, tk, tv), torch.from_numpy(dout))
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(g.numpy(), o.numpy(), atol=1e-5, rtol=0)


def test_moe_gmm_function_grads_match_autograd_through_plain():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 12, 20)).astype(np.float32)
    w = rng.standard_normal((3, 20, 28)).astype(np.float32)
    dy = torch.from_numpy(rng.standard_normal((3, 12, 28)).astype(
        np.float32))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = torch.autograd.grad(MoeGmm.apply(tx, tw), (tx, tw), dy)
    want = torch.autograd.grad(moe_gmm_ref(tx, tw), (tx, tw), dy)
    for g, o in zip(got, want):
        np.testing.assert_allclose(g.numpy(), o.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("c", [8, 640, 960])
def test_gmm_plan_takes_the_backward_shapes(c):
    """mixtral-8x7b's dx = dy · wᵀ and dw = xᵀ · dy for the gate/up and
    down GEMMs at capacity ``c``: ``_check`` passes each (on meta
    tensors) and its grid fits CUDA's limits; dw's rows take the tile
    body."""
    e, d, f = 8, 4096, 14336
    for k, n in ((d, f), (f, d)):
        for xs, ws in (((e, c, n), (e, n, k)), ((e, k, c), (e, c, n))):
            plan = moe_gmm._check(torch.empty(xs, device="meta"),
                                  torch.empty(ws, device="meta"))
            gx, gy, gz = plan.grid
            assert gx <= moe_gmm.GRID_X and max(gy, gz) <= moe_gmm.GRID_YZ
            if xs[1] == k:
                assert plan.body == "tile"


def test_remat_on_and_off_give_equal_grads():
    cfg = torch_get_reduced("mixtral-8x7b")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    _, batch = _batch(cfg, 2, 20, seed=4)
    out = []
    for remat in (True, False):
        m = build_model(cfg, ModelOpts(remat=remat), device="cpu")
        out.append(value_and_grad(m.train_loss, params, batch))
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(jax.tree.leaves(params_to_numpy(out[0][1])),
                    jax.tree.leaves(params_to_numpy(out[1][1]))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_remat_on_and_off_give_equal_grads_ssm_hybrid(arch):
    """Every Mamba2 block checkpointed or not: the same loss and
    gradients (the recomputed forward repeats the first one)."""
    cfg = torch_get_reduced(arch)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    _, batch = _batch(cfg, 2, 20, seed=4)
    out = []
    for remat in (True, False):
        m = build_model(cfg, ModelOpts(remat=remat), device="cpu")
        out.append(value_and_grad(m.train_loss, params, batch))
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(jax.tree.leaves(params_to_numpy(out[0][1])),
                    jax.tree.leaves(params_to_numpy(out[1][1]))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_hybrid_train_loss_builds_no_kv_cache(monkeypatch):
    """zamba2-2.7b: ``train_loss`` runs every shared-block application
    with ``cache_width=None`` and gets no cache back; the prefill asks
    for caches of its ``max_len``."""
    seen = []
    attn_seq = L.attn_seq

    def spy(*args, **kw):
        out = attn_seq(*args, **kw)
        seen.append((kw.get("cache_width"), out[1] is None))
        return out
    monkeypatch.setattr(L, "attn_seq", spy)
    cfg = torch_get_reduced("zamba2-2.7b")
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    _, batch = _batch(cfg, 1, 12, seed=6)
    applications = cfg.n_layers // cfg.attn_period
    loss, _ = value_and_grad(m.train_loss, params, batch)
    assert torch.isfinite(loss)
    assert seen == [(None, True)] * applications
    seen.clear()
    with torch.no_grad():
        m.prefill(params, batch["tokens"], 16)
    assert seen == [(16, False)] * applications


def test_windowed_attn_seq_without_cache_does_not_band(monkeypatch):
    """h2o's reduced window of 16 at 1024 tokens: the banded path would
    apply (512-query blocks, a 528-key band). ``train_loss`` must not
    take it; the prefill must."""
    calls = []
    banded = L.flash_attention_banded

    def spy(*args, **kw):
        calls.append(args[0].shape[1])
        return banded(*args, **kw)
    monkeypatch.setattr(L, "flash_attention_banded", spy)
    cfg = torch_get_reduced("h2o-danube-1.8b")
    m = build_model(cfg, ModelOpts(attn_impl="flash"), device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 1024)).astype(np.int32))
    loss = m.train_loss(params, {"tokens": toks})
    assert calls == [] and torch.isfinite(loss)
    with torch.no_grad():
        m.prefill(params, toks, 1024)
    assert calls == [1024] * cfg.n_layers
