"""The port's optimizers, train step and checkpoints, on the CPU: the
cases of tests/test_training.py on the port, and the port against the JAX
package.

* loss falls by a fifth in 20 steps under AdamW and Adafactor; gradient
  accumulation over 4 microbatches equals the full batch (loss and
  params within 1e-5); a checkpoint restart continues bit for bit;
  Adafactor's state is under a fifth of AdamW's;
* ``apply_updates`` (both optimizers, two steps) and
  ``clip_by_global_norm`` on shared numpy params and grads match JAX's
  within 1e-6 (fp32 elementwise math, rounded in another order);
* three ``make_train_step`` steps of reduced stablelm-3b from the same
  weights and batches match JAX's: losses within rtol 1e-5, params within
  2e-5 (gradients agree to ~1e-6 relative; Adam's normalised update
  scales their differences by lr over |g|);
* a checkpoint written by the JAX package loads in the port and the
  reverse, dtypes (the int32 step) and ``#i`` list keys included;
* ``load_checkpoint`` puts tensors on the card unless asked otherwise.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import build_model as jax_build_model
from repro.training import OptConfig as JaxOptConfig
from repro.training import apply_updates as jax_apply_updates
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import load_checkpoint as jax_load_checkpoint
from repro.training import make_train_step as jax_make_train_step
from repro.training import save_checkpoint as jax_save_checkpoint
from repro.training.optimizer import clip_by_global_norm as jax_clip
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.weights import params_to_numpy
from repro_torch.training import (OptConfig, apply_updates,
                                  clip_by_global_norm, init_opt_state,
                                  load_checkpoint, make_train_step,
                                  save_checkpoint)
from repro_torch.training.optimizer import leaves, tree_map

ARCH = "stablelm-3b"


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


def _model():
    cfg = torch_get_reduced(ARCH)
    m = build_model(cfg, device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def toy_batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))}


def _copy(tree):
    return tree_map(lambda t: t.clone(), tree)


def _max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(leaves(a),
                                                          leaves(b)))


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_training_reduces_loss(opt_name):
    model, params = _model()
    opt_cfg = OptConfig(name=opt_name, lr=1e-3, weight_decay=0.0)
    step = make_train_step(model, opt_cfg)
    opt = init_opt_state(params, opt_cfg)
    batch = toy_batch(model.cfg)
    losses = []
    for _ in range(20):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses[::5]
    assert int(opt["step"]) == 20 and opt["step"].dtype == torch.int32


def test_grad_accum_matches_full_batch():
    model, params = _model()
    opt_cfg = OptConfig(name="adamw", lr=1e-3)
    batch = toy_batch(model.cfg, b=8)
    s1 = make_train_step(model, opt_cfg, accum_steps=1)
    s4 = make_train_step(model, opt_cfg, accum_steps=4)
    p1, _, m1 = s1(_copy(params), init_opt_state(params, opt_cfg), batch)
    p4, _, m4 = s4(_copy(params), init_opt_state(params, opt_cfg), batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-5
    assert _max_diff(p1, p4) < 1e-5


def test_checkpoint_restart_exact(tmp_path):
    """Kill-and-restore yields a bit-identical continuation."""
    model, params = _model()
    opt_cfg = OptConfig(lr=1e-3)
    step = make_train_step(model, opt_cfg)
    opt = init_opt_state(params, opt_cfg)
    batches = [toy_batch(model.cfg, seed=i) for i in range(6)]
    for b in batches[:3]:
        params, opt, _ = step(params, opt, b)
    ck = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(ck, {"params": params, "opt": opt}, meta={"step": 3})
    pa, oa = params, opt
    for b in batches[3:]:
        pa, oa, _ = step(pa, oa, b)
    st = load_checkpoint(ck, device="cpu")
    pb, ob = st["params"], st["opt"]
    for b in batches[3:]:
        pb, ob, _ = step(pb, ob, b)
    assert _max_diff(pa, pb) == 0.0 and _max_diff(oa, ob) == 0.0


def test_adafactor_state_is_factored():
    _, params = _model()
    adam = init_opt_state(params, OptConfig(name="adamw"))
    ada = init_opt_state(params, OptConfig(name="adafactor"))
    size = lambda t: sum(x.numel() for x in leaves(t))
    assert size(ada) < 0.2 * size(adam)


def _shared_tree(seed):
    """Params and grads with factored (16 x 12, 2 x 9 x 8) and unfactored
    (16,), (4 x 3) leaves, and a list."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (16, 12), "b": {"c": (2, 9, 8), "d": (16,)},
              "e": [(4, 3), (8, 8)]}

    def draw(s, scale):
        if isinstance(s, dict):
            return {k: draw(v, scale) for k, v in s.items()}
        if isinstance(s, list):
            return [draw(v, scale) for v in s]
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return draw(shapes, 1.0), draw(shapes, 0.3)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_apply_updates_matches_jax(name):
    p_np, g_np = _shared_tree(7)
    cfg = OptConfig(name=name, lr=1e-2)
    jcfg = JaxOptConfig(name=name, lr=1e-2)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jax_init_opt_state(jp, jcfg)
    tp = params_from_numpy(p_np, "cpu")
    ts = init_opt_state(tp, cfg)
    for i in range(2):
        g = jax.tree.map(lambda a: a * (1 + i), g_np)
        jp, js = jax.jit(jax_apply_updates, static_argnums=3)(
            jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts = apply_updates(tp, params_from_numpy(g, "cpu"), ts, cfg)
    assert int(ts["step"]) == int(js["step"]) == 2
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    for a, b in zip(jax.tree.leaves(params_to_numpy(ts)),
                    jax.tree.leaves(jax.tree.map(np.asarray, js))):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "keeps"])
def test_clip_by_global_norm_matches_jax(max_norm):
    _, g_np = _shared_tree(8)
    jg, jn = jax_clip(jax.tree.map(jnp.asarray, g_np), max_norm)
    tg, tn = clip_by_global_norm(params_from_numpy(g_np, "cpu"), max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tg)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_steps_match_jax(name):
    cfg = get_reduced(ARCH)
    jm = jax_build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    jcfg, tcfg = JaxOptConfig(name=name, lr=1e-3), OptConfig(name=name,
                                                             lr=1e-3)
    jstep = jax.jit(jax_make_train_step(jm, jcfg))
    js = jax_init_opt_state(jp, jcfg)
    tm = build_model(torch_get_reduced(ARCH), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tstep = make_train_step(tm, tcfg)
    ts = init_opt_state(tp, tcfg)
    for i in range(3):
        tb = toy_batch(tm.cfg, seed=10 + i)
        jp, js, jmet = jstep(jp, js, {"tokens": jnp.asarray(
            tb["tokens"].numpy())})
        tp, ts, tmet = tstep(tp, ts, tb)
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-5)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-4)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)


def test_checkpoints_cross_between_packages(tmp_path):
    """A tree with a nested dict, a list (``#i`` keys), fp32 leaves and
    an int32 step, each way."""
    p_np, g_np = _shared_tree(9)
    tree = {"params": p_np, "opt": {"step": np.int32(5), "m": g_np}}
    jpath = os.path.join(tmp_path, "jax.npz")
    jax_save_checkpoint(jpath, jax.tree.map(jnp.asarray, tree),
                        meta={"step": 5})
    got = params_to_numpy(load_checkpoint(jpath, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    tpath = os.path.join(tmp_path, "torch.npz")
    save_checkpoint(tpath, tree_map(torch.as_tensor, {
        "params": p_np, "opt": {"step": np.array(5, np.int32),
                                "m": g_np}}), meta={"step": 5})
    back = jax.tree.map(np.asarray, jax_load_checkpoint(tpath))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    assert open(tpath + ".meta.json").read() == open(
        jpath + ".meta.json").read()


def test_load_checkpoint_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    path = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(path, {"w": torch.ones(3)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(path)
    assert load_checkpoint(path, device="cpu")["w"].device.type == "cpu"
