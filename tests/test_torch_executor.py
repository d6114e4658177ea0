"""The port's fused PagedTransformerExecutor against the JAX package's.

Both executors run the ragged paged-attention contract: the JAX one with
``ragged_attention=True`` (its CPU oracle), the port on ``device="cpu"``
(its plain PyTorch version), on shared weights carried across by the
bridge. On seeded mixed plans their greedy token streams are equal and
first-token logits agree within 1e-4 (fp32 through two different BLAS
libraries over a 2-layer model); under the deterministic model clock
(each package's ``ModelTimedExecutor``) the scheduler traces are
byte-equal; each engine step is one dispatch; and pool exhaustion defers
instead of corrupting.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.engine as jeng
import repro_torch.core as tcore
import repro_torch.engine as teng
from repro.configs import get_reduced
from repro.engine import numerics as jnum
from repro.models import ModelOpts, build_model
from repro_torch.cache import PrefixCache
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.engine import numerics as tnum
from repro_torch.engine.spec_decode import TruncatedSelfDraft
from repro_torch.launch.mesh import Mesh
from repro_torch.models import params_from_numpy

PAGE, NUM_PAGES, MAX_PAGES = 16, 64, 8
ATOL_LOGITS = 1e-4
ARCHS = ["stablelm-3b", "h2o-danube-1.8b"]   # full attention; window 16


def _cfgs(arch):
    cfg, tcfg = get_reduced(arch), torch_get_reduced(arch)
    if arch == "stablelm-3b":
        cfg = dataclasses.replace(cfg, window=None)
        tcfg = dataclasses.replace(tcfg, window=None)
    return cfg, tcfg


@pytest.fixture(scope="module")
def setups():
    out = {}
    for arch in ARCHS:
        cfg, tcfg = _cfgs(arch)
        model = build_model(cfg, ModelOpts(attn_impl="dense"))
        params = model.init(jax.random.PRNGKey(0))
        out[arch] = (cfg, tcfg, params,
                     params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu"))
    return out


def _executors(setup, **kw):
    cfg, tcfg, params, tparams = setup
    kw = {"num_pages": NUM_PAGES, "page_size": PAGE,
          "max_pages_per_seq": MAX_PAGES, **kw}
    return (jeng.PagedTransformerExecutor(cfg, params, ragged_attention=True,
                                          **kw),
            teng.PagedTransformerExecutor(tcfg, tparams, device="cpu", **kw))


@pytest.fixture(scope="module")
def jax_executors(setups):
    """One JAX executor per arch, shared across tests (warm jit caches);
    ``_reset`` gives each run a clean allocator and zeroed pages."""
    return {arch: _executors(setups[arch], capture_logits=True)[0]
            for arch in ARCHS}


def _reset(execu):
    execu.alloc = jeng.BlockAllocator(NUM_PAGES, PAGE)
    assert execu.alloc.extend(-1, PAGE) == [0]     # trash page
    execu.k_pages = jnp.zeros_like(execu.k_pages)
    execu.v_pages = jnp.zeros_like(execu.v_pages)
    execu.last_deferred = frozenset()
    execu.n_dispatches = 0
    execu.compile_keys = set()
    return execu


def _mixed_requests(pkg, vocab, seed, n=5, max_prompt=40, n_new=5):
    """tests/test_fused_executor.py's seeded mixed workload: staggered
    arrivals interleave chunked prefills with live decodes."""
    rng = jax.random.PRNGKey(seed)
    reqs = []
    for i in range(n):
        plen = 1 + (7 * i + seed) % max_prompt
        toks = [int(x) for x in jax.random.randint(
            jax.random.fold_in(rng, i), (plen,), 0, vocab)]
        reqs.append(pkg.Request(i, arrival=0.002 * i, prompt_len=plen,
                                max_new_tokens=n_new, ttft_slo=5.0,
                                tpot_slo=5.0, tokens=toks))
    return reqs


def _drive(core, eng_pkg, execu, reqs, max_steps=400):
    sched = core.make_scheduler("fairbatching",
                                core.LinearCostModel(a=1e-4, b=1e-6, c=1e-10))
    eng = eng_pkg.Engine(sched, execu,
                         eng_pkg.EngineConfig(ttft_slo=5.0, tpot_slo=5.0))
    # each package's own harness (the port's engine/numerics.py is a copy)
    trace = (tnum if eng_pkg is teng else jnum).capture_schedule(eng)
    for r in reqs:
        eng.submit(r)
    first, deferred_seen, n = {}, False, 0
    inner = getattr(execu, "_inner", execu)
    while eng.has_work and n < max_steps:
        eng.step()
        n += 1
        deferred_seen |= bool(inner.last_deferred)
        for rid, lg in inner.last_logits.items():
            first.setdefault(rid, lg.copy())
    tokens = {rid: list(r.generated_tokens) for rid, r in eng.requests.items()}
    return eng, tokens, first, trace, deferred_seen


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [1, 9])
def test_fused_tokens_and_logits_match_jax(setups, jax_executors, arch,
                                          seed):
    jx = _reset(jax_executors[arch])
    tx = _executors(setups[arch], capture_logits=True)[1]
    vocab = setups[arch][0].vocab
    ej, tok_j, lg_j, _, _ = _drive(jcore, jeng, jx,
                                   _mixed_requests(jeng, vocab, seed))
    et, tok_t, lg_t, _, _ = _drive(tcore, teng, tx,
                                   _mixed_requests(teng, vocab, seed))
    assert not ej.has_work and not et.has_work
    assert tok_t == tok_j
    assert lg_t.keys() == lg_j.keys() and len(lg_t) == 5
    for rid in lg_j:
        np.testing.assert_allclose(lg_t[rid], lg_j[rid], atol=ATOL_LOGITS,
                                   rtol=0)
    assert tx.n_dispatches == len(et.steps)


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_trace_byte_equal_under_model_clock(setups, jax_executors,
                                                      arch):
    """Same plans and deferral sets, step for step, once both data planes
    report the cost model's time instead of their wall clocks."""
    jx = _reset(jax_executors[arch])
    tx = _executors(setups[arch])[1]
    vocab = setups[arch][0].vocab
    reqs = dict(n=7, max_prompt=60, n_new=6)
    ej, tok_j, _, tr_j, _ = _drive(jcore, jeng, jnum.ModelTimedExecutor(jx),
                                   _mixed_requests(jeng, vocab, 4, **reqs))
    et, tok_t, _, tr_t, _ = _drive(tcore, teng, tnum.ModelTimedExecutor(tx),
                                   _mixed_requests(teng, vocab, 4, **reqs))
    assert len(tr_j.plans) > 5
    assert tr_t.fingerprint() == tr_j.fingerprint()
    assert tok_t == tok_j
    assert [dataclasses.astuple(s) for s in et.steps] == \
        [dataclasses.astuple(s) for s in ej.steps]
    assert tx.n_dispatches == len(et.steps) == jx.n_dispatches
    assert tx.compile_keys == jx.compile_keys


def test_decode_defers_when_out_of_blocks(setups):
    """tests/test_fused_executor.py::test_decode_defers_when_out_of_blocks on
    the port: 5 usable pages of 4 slots; req 1's page-crossing decode finds
    the pool dry and must defer, then finish once req 0 releases — with the
    tokens the JAX executor emits, and no page leaked."""
    outs = []
    for core, eng_pkg, execu in zip(
            (jcore, tcore), (jeng, teng),
            _executors(setups["stablelm-3b"], num_pages=6, page_size=4,
                       max_pages_per_seq=5)):
        rng = jax.random.PRNGKey(21)
        prompts = {i: [int(x) for x in jax.random.randint(
            jax.random.fold_in(rng, i), (n,), 0, 256)]
            for i, n in ((0, 8), (1, 7))}
        reqs = [eng_pkg.Request(0, arrival=0.0, prompt_len=8,
                                max_new_tokens=4, ttft_slo=5.0, tpot_slo=5.0,
                                tokens=prompts[0]),
                eng_pkg.Request(1, arrival=0.0, prompt_len=7,
                                max_new_tokens=12, ttft_slo=5.0,
                                tpot_slo=5.0, tokens=prompts[1])]
        eng, tokens, _, _, deferred_seen = _drive(core, eng_pkg, execu,
                                                  reqs, max_steps=200)
        assert deferred_seen, "pool never exhausted: regression test is inert"
        assert not eng.has_work, "deferred request never completed"
        assert execu.alloc.free_blocks == execu.alloc.num_blocks - 1
        outs.append(tokens)
    assert outs[1] == outs[0]
    assert len(outs[1][1]) == 12


def test_unported_options_raise(setups):
    """A mesh with a data axis above 1 is a later slice (ROADMAP A13b) and
    raises, as does a mesh without process groups; sequential mode,
    multi-step decode, the draft hook, quantized KV and a prefix cache on
    the executor's own allocator work, a cache on another allocator is
    refused, and an unknown kv_dtype raises."""
    cfg, tcfg, _, tparams = setups["stablelm-3b"]
    with pytest.raises(NotImplementedError, match="A13b"):
        teng.PagedTransformerExecutor(
            tcfg, tparams, device="cpu",
            mesh=Mesh.abstract((2, 1), ("data", "model")))
    with pytest.raises(ValueError, match="process group"):
        teng.PagedTransformerExecutor(
            tcfg, tparams, device="cpu",
            mesh=Mesh.abstract((1, 2), ("data", "model")))
    with pytest.raises(ValueError):
        teng.PagedTransformerExecutor(tcfg, tparams, device="cpu",
                                      mode="pipelined")
    with pytest.raises(ValueError):
        teng.PagedTransformerExecutor(tcfg, tparams, device="cpu",
                                      kv_dtype="int4")
    q8 = teng.PagedTransformerExecutor(tcfg, tparams, device="cpu",
                                       num_pages=8, page_size=4,
                                       kv_dtype="int8")
    assert q8.k_pages.dtype == torch.int8
    assert q8.k_scales.shape == q8.k_pages.shape[:-1]
    ex = teng.PagedTransformerExecutor(tcfg, tparams, device="cpu",
                                       num_pages=8, page_size=4)
    with pytest.raises(AssertionError, match="share the executor"):
        ex.attach_cache(PrefixCache(4, block_size=4))
    assert ex.prefix_cache is None
    cache = PrefixCache(4, block_size=4, alloc=ex.alloc)
    ex.attach_cache(cache)
    assert ex.prefix_cache is cache
    assert callable(ex.execute_multi)     # the engine's one-dispatch paths
    draft = TruncatedSelfDraft(1)
    ex.set_draft(draft)
    assert ex.draft is draft and draft._ex is ex
    seq = teng.PagedTransformerExecutor(tcfg, tparams, device="cpu",
                                        mode="sequential", num_pages=8,
                                        page_size=4)
    assert seq.mode == "sequential"
