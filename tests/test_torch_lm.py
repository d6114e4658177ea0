"""The port's ``DecoderLM`` for every decoder-only family against the JAX
package's, on the CPU.

Both packages run the reduced configs on the JAX ``init(PRNGKey(0))``
weights, carried across by the bridge (``params_from_numpy``); prompts and
embeddings come from a numpy seed. Pinned, for stablelm-3b, h2o-danube-1.8b
(sliding window), gemma3-1b (local:global, unrolled), pixtral-12b
(``embeds`` input), deepseek-67b, mixtral-8x7b (``moe_impl`` exact and
capacity), kimi-k2-1t-a32b and zamba2-2.7b (hybrid):

* ``init_cache`` equals the JAX zero cache, structure included;
* prefill logits and caches within 1e-4 of the JAX model's (stacked, a
  per-layer list, or the hybrid's Mamba2 stack plus per-application
  attention caches), then three greedy decode steps: logits and caches
  within 1e-4, the greedy tokens equal;
* the port's own prefill/decode consistency, within tests/test_models.py's
  5e-4; h2o's ring keeps exactly the last ``window`` positions;
* ``attn_impl`` dense / flash / auto and ``scan_layers=False`` on h2o at a
  1024-token prompt (flash, banded past the window): logits and caches
  within 1e-4 of the JAX model with the same options;
* the config copies are byte-equal to the JAX package's modulo the package
  name, and the registry holds every decoder-only arch;
* the port's ``init_params`` builds the JAX tree for the new families, the
  bridge carries the hybrid's ``shared`` subtree unchanged, and
  ``ModelOpts`` takes fp32 and bf16 and refuses fp16.
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as jax_all_archs
from repro.configs import get_reduced
from repro.models import ModelOpts as JaxOpts
from repro.models import build_model as jax_build_model
from repro_torch.configs import all_archs, get_reduced as torch_get_reduced
from repro_torch.models import (EncDecLM, ModelOpts, build_model,
                                init_params, params_from_numpy,
                                params_to_numpy)

ATOL = 1e-4
ATOL_CONSISTENCY = 5e-4
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
CASES = [("stablelm-3b", "capacity"), ("h2o-danube-1.8b", "capacity"),
         ("gemma3-1b", "capacity"), ("pixtral-12b", "capacity"),
         ("deepseek-67b", "capacity"), ("mixtral-8x7b", "exact"),
         ("mixtral-8x7b", "capacity"), ("kimi-k2-1t-a32b", "capacity"),
         ("zamba2-2.7b", "capacity")]
NEW_CONFIGS = ["zamba2_2_7b.py", "gemma3_1b.py", "pixtral_12b.py",
               "deepseek_67b.py"]


@pytest.fixture(scope="module")
def weights():
    """JAX params and their bridged copy, once per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            params = jax_build_model(get_reduced(arch)).init(
                jax.random.PRNGKey(0))
            cache[arch] = (params, params_from_numpy(
                jax.tree.map(np.asarray, params), "cpu"))
        return cache[arch]
    return get


def _inputs(cfg, b, s, seed):
    """(JAX input, port input): token ids, or {"embeds"} for a VLM."""
    rng = np.random.default_rng(seed)
    if cfg.embeds_input:
        e = (rng.standard_normal((b, s, cfg.d_model)) * 0.1).astype(
            np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t)


def _close_tree(got, want, atol):
    """Same structure (dicts and lists), shapes, dtypes; values within
    ``atol``."""
    ref = jax.tree.map(np.asarray, want)
    mine = params_to_numpy(got)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(mine)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=str(path))


def _models(arch, weights, **opts):
    params, tparams = weights(arch)
    jm = jax_build_model(get_reduced(arch), JaxOpts(**opts))
    tm = build_model(torch_get_reduced(arch), ModelOpts(**opts),
                     device="cpu")
    return jm, params, tm, tparams


def _run_both(jm, params, tm, tparams, inputs, max_len, steps):
    """Prefill, then ``steps`` greedy decode steps in both packages, each
    held to the other."""
    lj, cj = jm.prefill(params, inputs[0], max_len=max_len)
    lt, ct = tm.prefill(tparams, inputs[1], max_len=max_len)
    for step in range(steps + 1):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        _close_tree(ct, cj, ATOL)
        tj = jnp.argmax(lj, -1).astype(jnp.int32)
        tt = lt.argmax(-1)
        assert tt.tolist() == np.asarray(tj).tolist(), f"step {step}"
        if step < steps:
            lj, cj = jm.decode_step(params, tj, cj)
            lt, ct = tm.decode_step(tparams, tt, ct)
    return ct


@pytest.mark.parametrize("arch, moe_impl", CASES,
                         ids=[f"{a}-{m}" for a, m in CASES])
def test_prefill_and_decode_match_jax(weights, arch, moe_impl):
    jm, params, tm, tparams = _models(arch, weights, moe_impl=moe_impl)
    _close_tree(tm.init_cache(3, 32), jm.init_cache(3, 32), 0.0)
    cfg = tm.cfg
    ct = _run_both(jm, params, tm, tparams, _inputs(cfg, 2, 20, seed=7),
                   max_len=32, steps=3)
    assert ct["pos"].tolist() == [23, 23]
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_period
        assert ct["attn"]["kv_pos"].shape == (groups, 2, 32)
        assert ct["mamba"]["ssm"].shape[0] == cfg.n_layers
    elif cfg.local_global_period is not None:
        assert isinstance(ct["kv"], list) and len(ct["kv"]) == cfg.n_layers


CONSISTENCY = ["stablelm-3b", "h2o-danube-1.8b", "gemma3-1b", "pixtral-12b",
               "deepseek-67b", "mixtral-8x7b", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", CONSISTENCY)
def test_prefill_decode_consistency(weights, arch):
    """decode(prefill(x[:n])) logits == prefill(x[:n+1]) logits
    (tests/test_models.py; MoE under exact, as there)."""
    _, tparams = weights(arch)
    cfg = torch_get_reduced(arch)
    tm = build_model(cfg, ModelOpts(moe_impl="exact"), device="cpu")
    _, x = _inputs(cfg, 2, 10, seed=11)
    lg1, cache = tm.prefill(tparams, x, max_len=16)
    t1 = lg1.argmax(-1)
    lg2, _ = tm.decode_step(tparams, t1, cache)
    if cfg.embeds_input:
        nxt = tparams["embed"][t1][:, None]
        longer = {"embeds": torch.cat([x["embeds"], nxt], 1)}
    else:
        longer = torch.cat([x, t1[:, None].to(x.dtype)], 1)
    lg3, _ = tm.prefill(tparams, longer, max_len=16)
    assert float((lg2 - lg3).abs().max()) < ATOL_CONSISTENCY


def test_swa_ring_cache_keeps_the_window(weights):
    """tests/test_models.py::test_swa_ring_cache_matches_full_window on the
    port: a 20-token prompt leaves exactly the last 16 positions, and
    three decode steps slide them on."""
    _, tparams = weights("h2o-danube-1.8b")
    cfg = torch_get_reduced("h2o-danube-1.8b")
    tm = build_model(cfg, device="cpu")
    _, toks = _inputs(cfg, 1, 20, seed=3)
    lg, cache = tm.prefill(tparams, toks, max_len=32)
    assert sorted(cache["kv"]["kv_pos"][0].tolist()) == list(range(4, 20))
    for i in range(3):
        lg, cache = tm.decode_step(tparams, lg.argmax(-1), cache)
        assert sorted(cache["kv"]["kv_pos"][0].tolist()) == \
            list(range(5 + i, 21 + i))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _rings(cache) -> list:
    """The attention caches' K, V and ``kv_pos`` tensors."""
    if "attn" in cache:
        return list(cache["attn"].values())
    kv = cache["kv"]
    return [t for c in (kv if isinstance(kv, list) else [kv])
            for t in c.values()]


@pytest.mark.parametrize("arch", ["stablelm-3b", "gemma3-1b", "zamba2-2.7b"])
def test_decode_step_consumes_the_ring_cache(weights, arch):
    """``decode_step`` writes the new token into the input cache's rings in
    place (stacked, per-layer list, hybrid groups) and leaves its ``pos``;
    a copy taken before the step replays it exactly."""
    _, tparams = weights(arch)
    cfg = torch_get_reduced(arch)
    tm = build_model(cfg, device="cpu")
    _, x = _inputs(cfg, 2, 12, seed=13)
    lg, cache = tm.prefill(tparams, x, max_len=16)
    tok = lg.argmax(-1)
    before = _clone(cache)
    lg1, new = tm.decode_step(tparams, tok, cache)
    assert cache["pos"].tolist() == before["pos"].tolist() == [12, 12]
    assert new["pos"].tolist() == [13, 13]
    for got, was, out in zip(_rings(cache), _rings(before), _rings(new)):
        assert got.data_ptr() == out.data_ptr()
        assert not torch.equal(got, was)
    lg2, again = tm.decode_step(tparams, tok, before)
    assert torch.equal(lg1, lg2)
    for a, b in zip(_rings(again), _rings(new)):
        assert torch.equal(a, b)


VARIANTS = {"dense": dict(attn_impl="dense"),
            "flash": dict(attn_impl="flash", flash_block=256),
            "auto": dict(),
            "unrolled": dict(scan_layers=False)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_attention_impls_and_layouts_match_jax(weights, variant):
    """h2o (window 16) at a 1024-token prompt: auto picks flash there,
    and its layers take the banded path (band 528 of 1024 keys)."""
    arch = "h2o-danube-1.8b"
    jm, params, tm, tparams = _models(arch, weights, **VARIANTS[variant])
    ct = _run_both(jm, params, tm, tparams,
                   _inputs(tm.cfg, 1, 1024, seed=5), max_len=1040, steps=1)
    assert isinstance(ct["kv"], list) == (variant == "unrolled")


@pytest.mark.parametrize("rel", NEW_CONFIGS)
def test_config_copy_is_byte_equal_modulo_package(rel):
    ref = (SRC / "repro" / "configs" / rel).read_text()
    port = (SRC / "repro_torch" / "configs" / rel).read_text()
    assert port == re.sub(r"\brepro\.", "repro_torch.", ref)


def test_registry_holds_every_decoder_only_arch():
    """Every arch of the JAX registry, the decoder-only ones and, since
    ``EncDecLM``, the encoder-decoder too."""
    want = jax_all_archs()
    assert [a for a in want if not get_reduced(a).is_encoder_decoder]
    assert all_archs() == want
    for arch in want:
        assert dataclasses.asdict(torch_get_reduced(arch)) == \
            dataclasses.asdict(get_reduced(arch))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "pixtral-12b", "gemma3-1b"])
def test_init_params_builds_the_jax_tree(weights, arch):
    params, _ = weights(arch)
    ref = jax.tree.map(np.asarray, params)
    mine = params_to_numpy(init_params(torch_get_reduced(arch),
                                       torch.Generator().manual_seed(0),
                                       "cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mine),
                            jax.tree.leaves(ref)):
        assert a.shape == b.shape, path
        assert a.std() == pytest.approx(b.std(), rel=0.25, abs=1e-6), path


def test_bridge_carries_the_hybrid_tree(weights):
    params, tparams = weights("zamba2-2.7b")
    ref = jax.tree.map(np.asarray, params)
    back = params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    assert set(back["shared"]) == {"attn", "ln1", "mlp", "ln2"}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_model_opts_serve_fp32_only():
    """fp32 and bf16 are taken (the launch cells' dtypes), fp16 raises
    with its pointer to ROADMAP B6."""
    for name in ("param_dtype", "compute_dtype", "cache_dtype"):
        for dt in (torch.float32, torch.bfloat16):
            assert getattr(ModelOpts(**{name: dt}), name) == dt
        with pytest.raises(TypeError, match="B6"):
            ModelOpts(**{name: torch.float16})
    with pytest.raises(ValueError, match="attn_impl"):
        ModelOpts(attn_impl="ring")
    with pytest.raises(ValueError, match="moe_impl"):
        ModelOpts(moe_impl="dropless")
    cfg = dataclasses.replace(torch_get_reduced("stablelm-3b"),
                              is_encoder_decoder=True)
    assert isinstance(build_model(cfg, device="cpu"), EncDecLM)
    assert ModelOpts().remat and ModelOpts().ce_chunk == 512
