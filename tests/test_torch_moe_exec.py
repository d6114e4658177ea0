"""The port's MoE serving against the JAX package's executor.

Both packages run reduced mixtral-8x7b and kimi-k2-1t-a32b (window off, as
tests/test_tp_executor.py builds them) on shared weights carried across by
the bridge (``params_from_numpy``), on the CPU, where kernel B4's wrapper
takes its plain version. Each comparison runs both executors in the same
setting: capacity mode sizes its per-expert capacity from the step's
packing, so its tokens are held to the JAX executor's in the same mode and
on the same plans, never to another mode's. Pinned:

* the JAX MoE parameter tree crosses the bridge unchanged, and the port's
  own initializer builds the same tree;
* fused steps (fp32 and int8 KV) and ``mode="sequential"`` on fixed plans,
  under ``moe_impl="exact"`` and ``"capacity"``: tokens equal the JAX
  executor's, first-token logits within 1e-4, same dispatches and bucket
  keys;
* ``commit_horizon=4`` under the model clock: tokens and scheduler traces
  equal the JAX run's, one dispatch per horizon;
* under ``exact`` the fused, sequential and multi-step tokens are one
  stream (the per-token oracle does not see the packing);
* a fairbatching engine with VTC under the model clock decides byte for
  byte as the JAX package's, fp32 and int8 KV;
* speculative decode on a MoE target (ROADMAP A11) with a
  ``TruncatedSelfDraft``: through the engine under ``exact``, tokens and
  accept/draft counters equal the JAX run's and the greedy stream; under
  ``capacity`` on fixed plans (fp32 and int8 KV), tokens and counters equal
  the JAX run's; a MoE draft model is refused in both packages.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.engine as jeng
import repro_torch.core as tcore
import repro_torch.engine as teng
from repro.configs import get_reduced
from repro.engine import numerics as jnum
from repro.engine.spec_decode import SmallModelDraft as JaxSmallDraft
from repro.engine.spec_decode import TruncatedSelfDraft as JaxSelfDraft
from repro.models import ModelOpts, build_model
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.engine import numerics as tnum
from repro_torch.engine.spec_decode import SmallModelDraft, TruncatedSelfDraft
from repro_torch.kernels import moe_gmm as tmg
from repro_torch.models import init_params, params_from_numpy
from repro_torch.models import moe as tm
from repro_torch.models.weights import params_to_numpy

PAGE, NUM_PAGES, MAX_PAGES = 8, 64, 16
ATOL_LOGITS = 1e-4
ARCHS = ["mixtral-8x7b", "kimi-k2-1t-a32b"]
IMPLS = ["exact", "capacity"]
MODEL = tcore.LinearCostModel(a=1e-3, b=1e-4, c=0.0)


@pytest.fixture(scope="module")
def setups():
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_reduced(arch), window=None)
        tcfg = dataclasses.replace(torch_get_reduced(arch), window=None)
        params = build_model(cfg, ModelOpts(attn_impl="dense")).init(
            jax.random.PRNGKey(0))
        out[arch] = (cfg, tcfg, params, params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu"))
    return out


def _port(setup, **kw):
    kw = {"num_pages": NUM_PAGES, "page_size": PAGE,
          "max_pages_per_seq": MAX_PAGES, **kw}
    return teng.PagedTransformerExecutor(setup[1], setup[3], device="cpu",
                                         **kw)


def _jax(setup, **kw):
    kw = {"num_pages": NUM_PAGES, "page_size": PAGE,
          "max_pages_per_seq": MAX_PAGES, "ragged_attention": True, **kw}
    return jeng.PagedTransformerExecutor(setup[0], setup[2], **kw)


def _requests(pkg, vocab, n=4, plen=19, n_new=6, seed=5):
    rng = np.random.default_rng(seed)
    return {i: pkg.Request(i, arrival=0.0, prompt_len=plen + 3 * i,
                           max_new_tokens=n_new, ttft_slo=10.0,
                           tpot_slo=10.0, tokens=[int(x) for x in
                                                  rng.integers(0, vocab,
                                                               plen + 3 * i)])
            for i in range(n)}


def _drive_plans(core, eng_pkg, execu, requests, chunk=12):
    """A fixed-chunk round robin (tests/test_kv_quant_exec.py's): the same
    plan sequence whatever the executor. Returns tokens and first-emission
    logits by request."""
    first, steps = {}, 0
    while any(r.active for r in requests.values()):
        items = []
        for r in requests.values():
            if not r.active:
                continue
            if r.state is eng_pkg.RequestState.DECODE:
                items.append(core.BatchItem(r.req_id, 1, core.TaskKind.DECODE))
            else:
                n = min(chunk, r.prompt_len - r.prefilled)
                items.append(core.BatchItem(r.req_id, n,
                                            core.TaskKind.PREFILL))
        plan = core.BatchPlan(items, 0.0, 0.0, 0, 0)
        _, emitted = execu.execute(plan, requests, float(steps))
        assert not execu.last_deferred, "pool sized to never defer"
        for rid, lg in execu.last_logits.items():
            first.setdefault(rid, lg.copy())
        for it in plan.items:
            req = requests[it.req_id]
            if it.req_id in emitted:
                req.generated_tokens.append(emitted[it.req_id])
            req.advance(it.n_tokens, float(steps))
        steps += 1
    return {rid: list(r.generated_tokens) for rid, r in requests.items()}, \
        first


def _both_on_plans(setup, **kw):
    vocab = setup[0].vocab
    jx = _jax(setup, capture_logits=True, **kw)
    tx = _port(setup, capture_logits=True, **kw)
    before = tmg.moe_gmm.launches
    tok_j, lg_j = _drive_plans(jcore, jeng, jx, _requests(jeng, vocab))
    tok_t, lg_t = _drive_plans(tcore, teng, tx, _requests(teng, vocab))
    assert tmg.moe_gmm.launches == before          # the CPU: plain version
    assert tok_t == tok_j
    assert all(len(t) == 6 for t in tok_t.values())
    assert lg_t.keys() == lg_j.keys() and len(lg_t) == 4
    for rid in lg_j:
        np.testing.assert_allclose(lg_t[rid], lg_j[rid], atol=ATOL_LOGITS,
                                   rtol=0)
    assert tx.n_dispatches == jx.n_dispatches
    assert tx.compile_keys == jx.compile_keys
    return tok_t, tx


@pytest.mark.parametrize("arch", ARCHS)
def test_params_bridge_carries_the_moe_tree(setups, arch):
    cfg, tcfg, params, tparams = setups[arch]
    ref = jax.tree.map(np.asarray, params)
    back = params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert "moe" in back["layers"] and "mlp" not in back["layers"]
    mine = params_to_numpy(init_params(tcfg, torch.Generator().manual_seed(0),
                                       "cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mine),
                            jax.tree.leaves(ref)):
        assert a.shape == b.shape, path
        assert a.std() == pytest.approx(b.std(), rel=0.25, abs=1e-6), path


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("moe_impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_tokens_match_jax(setups, arch, moe_impl, kv_dtype,
                                monkeypatch):
    kept = []
    dispatch = tm.dispatch

    def counted(x, valid, router, cfg, capacity):
        dp = dispatch(x, valid, router, cfg, capacity)
        kept.append((int(dp.keep.sum()), x.shape[0] * cfg.top_k))
        return dp

    monkeypatch.setattr(tm, "dispatch", counted)
    _, tx = _both_on_plans(setups[arch], moe_impl=moe_impl,
                           kv_dtype=kv_dtype)
    assert {k[0] for k in tx.compile_keys} == {"fused"}
    # one dispatch per layer and fused step under capacity, none under
    # exact; the packed steps overflow some expert's capacity
    assert len(kept) == (tx.n_dispatches * setups[arch][1].n_layers
                         if moe_impl == "capacity" else 0)
    assert moe_impl == "exact" or any(k < n for k, n in kept)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("moe_impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sequential_tokens_match_jax(setups, arch, moe_impl, kv_dtype):
    _, tx = _both_on_plans(setups[arch], mode="sequential",
                           moe_impl=moe_impl, kv_dtype=kv_dtype)
    assert {k[0] for k in tx.compile_keys} == {"chunk", "decode"}


def _decode_requests(pkg, vocab, n=4, n_new=9):
    """tests/test_async_pipeline.py's multi-step workload: all arrive at
    0, prompts 5 + 9i."""
    rng = np.random.default_rng(3)
    return [pkg.Request(i, 0.0, 5 + 9 * i, n_new, 5.0, 5.0,
                        tokens=[int(x) for x in rng.integers(
                            0, vocab, 5 + 9 * i)])
            for i in range(n)]


def _engine_run(core, eng_pkg, num, execu, reqs, horizon=1):
    """A fairbatching engine over the model clock; returns tokens, the
    scheduler trace and the engine."""
    eng = eng_pkg.Engine(core.make_scheduler("fairbatching", MODEL,
                                             calibrate=False),
                         num.ModelTimedExecutor(execu, MODEL),
                         eng_pkg.EngineConfig(ttft_slo=5.0, tpot_slo=5.0,
                                              commit_horizon=horizon))
    trace = num.capture_schedule(eng)
    for r in reqs:
        eng.submit(r)
    n = 0
    while eng.has_work and n < 400:
        eng.step()
        n += 1
    assert not eng.has_work
    return {rid: list(r.generated_tokens)
            for rid, r in eng.requests.items()}, trace, eng


@pytest.mark.parametrize("moe_impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_multistep_decode_matches_jax(setups, arch, moe_impl):
    setup = setups[arch]
    vocab = setup[0].vocab
    jx = _jax(setup, moe_impl=moe_impl)
    tx = _port(setup, moe_impl=moe_impl)
    tok_j, tr_j, _ = _engine_run(jcore, jeng, jnum, jx,
                                 _decode_requests(jeng, vocab), horizon=4)
    tok_t, tr_t, eng = _engine_run(tcore, teng, tnum, tx,
                                   _decode_requests(teng, vocab), horizon=4)
    assert tr_t.fingerprint() == tr_j.fingerprint()
    assert tok_t == tok_j
    assert all(len(t) == 9 for t in tok_t.values())
    assert ("multi", 4, 4) in tx.compile_keys
    assert tx.compile_keys == jx.compile_keys
    assert tx.n_dispatches == jx.n_dispatches < len(eng.steps)
    assert tx.alloc.free_blocks == NUM_PAGES - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_paths_emit_one_stream(setups, arch):
    """Under ``exact`` a token's FFN output does not depend on what else
    the step packs, so the fused (fp32, and the batched backend),
    sequential and multi-step paths emit the same tokens."""
    setup = setups[arch]
    vocab = setup[0].vocab
    base, _, _ = _engine_run(tcore, teng, tnum, _port(setup),
                             _decode_requests(teng, vocab))
    for kw, horizon in ((dict(mode="sequential"), 1),
                        (dict(ragged_attention=False), 1), ({}, 4)):
        got, _, _ = _engine_run(tcore, teng, tnum, _port(setup, **kw),
                                _decode_requests(teng, vocab), horizon)
        assert got == base, (kw, horizon)
    fused, _ = _drive_plans(tcore, teng, _port(setup),
                            _requests(teng, vocab))
    seq, _ = _drive_plans(tcore, teng, _port(setup, mode="sequential"),
                          _requests(teng, vocab))
    assert fused == seq


def _sched_run(core, eng_pkg, num, execu):
    """tests/test_torch_kv_quant_exec.py::_sched_run: fairbatching with VTC
    admission over the model clock, two tenants."""
    eng = eng_pkg.Engine(core.make_scheduler(
        "fairbatching", core.LinearCostModel(a=1e-3, b=1e-4, c=0.0),
        vtc=True, calibrate=False),
        num.ModelTimedExecutor(execu, core.LinearCostModel(a=1e-3, b=1e-4,
                                                           c=0.0)),
        eng_pkg.EngineConfig(ttft_slo=0.5, tpot_slo=0.05))
    trace = num.capture_schedule(eng)
    rng = np.random.default_rng(9)
    for i in range(6):
        plen = 10 + (7 * i) % 28
        eng.submit(eng_pkg.Request(
            i, arrival=0.01 * i, prompt_len=plen, max_new_tokens=5,
            ttft_slo=0.5, tpot_slo=0.05,
            tenant="interactive" if i % 2 else "batch",
            tokens=[int(x) for x in rng.integers(0, 256, plen)]))
    eng.run(max_steps=3000)
    assert len(eng.done) == 6, "workload did not complete"
    execu.alloc.check_invariants()
    tokens = {rid: list(r.generated_tokens) for rid, r in eng.requests.items()}
    return trace, num.vtc_counters(eng), tokens


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_trace_byte_equal_to_jax(setups, arch, kv_dtype):
    """Capacity mode, fused: every plan, deferral set and VTC counter of
    the port's run equals the JAX run's, and so do its tokens."""
    setup = setups[arch]
    tr_t, vtc_t, tok_t = _sched_run(tcore, teng, tnum, _port(
        setup, num_pages=48, max_pages_per_seq=8, moe_impl="capacity",
        kv_dtype=kv_dtype))
    tr_j, vtc_j, tok_j = _sched_run(jcore, jeng, jnum, _jax(
        setup, num_pages=48, max_pages_per_seq=8, moe_impl="capacity",
        kv_dtype=kv_dtype))
    assert len(tr_t.plans) > 10, "trace too short to be meaningful"
    tnum.assert_same_decisions(tr_t, tr_j, "port vs JAX")
    assert tr_t.fingerprint() == tr_j.fingerprint()
    assert vtc_t == vtc_j and set(vtc_t) == {"interactive", "batch"}
    assert tok_t == tok_j


def _spec_engine_run(core, eng_pkg, execu, draft, gamma=2, horizon=2):
    """tests/test_torch_spec_decode.py's engine run (wall clock, SLOs loose
    enough that the plans do not depend on it) with ``draft`` installed;
    horizons of at most 2 rounds (the JAX engine's double finish, ROADMAP
    §C). Returns tokens and the engine."""
    execu.set_draft(draft)
    eng = eng_pkg.Engine(core.make_scheduler(
        "fairbatching", core.LinearCostModel(a=1e-4, b=1e-6, c=1e-10)),
        execu, eng_pkg.EngineConfig(5.0, 5.0, speculate=gamma,
                                    commit_horizon=horizon))
    for r in _decode_requests(eng_pkg, execu.cfg.vocab, n=3, n_new=8):
        eng.submit(r)
    n = 0
    while eng.has_work and n < 400:
        eng.step()
        n += 1
    assert not eng.has_work
    return {rid: list(r.generated_tokens)
            for rid, r in eng.requests.items()}, eng


@pytest.mark.parametrize("arch", ARCHS)
def test_self_draft_speculation_matches_jax_under_exact(setups, arch):
    """A11: a ``TruncatedSelfDraft(1)`` on a MoE target through the engine
    (γ=2, horizons of 2 rounds): tokens, accept/draft counters, rounds and
    bucket keys equal the JAX run's, and the tokens are the target's
    non-speculative greedy stream."""
    setup = setups[arch]
    vocab = setup[0].vocab
    tok_j, ej = _spec_engine_run(jcore, jeng, _jax(setup, num_pages=64,
                                                   page_size=16,
                                                   max_pages_per_seq=8),
                                 JaxSelfDraft(1))
    tx = _port(setup, num_pages=64, page_size=16, max_pages_per_seq=8)
    tok_t, et = _spec_engine_run(tcore, teng, tx, TruncatedSelfDraft(1))
    assert tok_t == tok_j
    assert et.spec_drafted > 0
    assert (et.spec_accepted, et.spec_drafted, et.spec_rounds) == \
        (ej.spec_accepted, ej.spec_drafted, ej.spec_rounds)
    assert any(k[0] == "spec" for k in tx.compile_keys)
    assert tx.compile_keys == ej.executor.compile_keys
    assert tx.alloc.free_blocks == 64 - 1
    greedy, _, _ = _engine_run(tcore, teng, tnum, _port(setup),
                               _decode_requests(teng, vocab, n=3, n_new=8))
    assert tok_t == greedy


def _drive_spec_plans(core, eng_pkg, execu, requests, gamma=3, rounds=2,
                      chunk=12):
    """Fixed plans with speculative dispatches: ``_drive_plans``'s chunked
    prefill (decode items ride along), then, once every active request
    decodes, ``execute_multi(speculate=gamma)`` over all of them with
    ``rounds`` rounds, each round's tokens applied as the engine applies
    them. The plans depend on nothing the executor computes. Returns
    tokens, accepted and drafted drafts, and the speculative dispatches."""
    accepted = drafted = n_spec = 0
    steps = 0
    while any(r.active for r in requests.values()):
        active = [r for r in requests.values() if r.active]
        if all(r.state is eng_pkg.RequestState.DECODE for r in active):
            plan = core.BatchPlan([core.BatchItem(r.req_id, 1,
                                                  core.TaskKind.DECODE)
                                   for r in active], 0.0, 0.0, 0, 0)
            _, rounds_out = execu.execute_multi(plan, requests, float(steps),
                                                rounds, speculate=gamma)
            assert not execu.last_deferred, "pool sized to never defer"
            accepted += execu.last_spec_accepted
            drafted += execu.last_spec_drafted
            n_spec += 1
            for em in rounds_out:
                for rid, toks in em.items():
                    if toks:
                        requests[rid].generated_tokens.extend(toks)
                        requests[rid].advance(len(toks), float(steps))
        else:
            items = []
            for r in active:
                if r.state is eng_pkg.RequestState.DECODE:
                    items.append(core.BatchItem(r.req_id, 1,
                                                core.TaskKind.DECODE))
                else:
                    items.append(core.BatchItem(
                        r.req_id, min(chunk, r.prompt_len - r.prefilled),
                        core.TaskKind.PREFILL))
            plan = core.BatchPlan(items, 0.0, 0.0, 0, 0)
            _, emitted = execu.execute(plan, requests, float(steps))
            assert not execu.last_deferred, "pool sized to never defer"
            for it in plan.items:
                req = requests[it.req_id]
                if it.req_id in emitted:
                    req.generated_tokens.append(emitted[it.req_id])
                req.advance(it.n_tokens, float(steps))
        for r in requests.values():
            if not r.active:
                execu.release(r.req_id)
        steps += 1
    return ({rid: list(r.generated_tokens) for rid, r in requests.items()},
            accepted, drafted, n_spec)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_self_draft_speculation_matches_jax_on_fixed_plans(setups, arch,
                                                           kv_dtype):
    """A11 under ``moe_impl="capacity"`` (kernel B4's path): capacity drops
    follow the packing, so both packages run the same fixed plans — γ=3,
    2 rounds a dispatch — and their tokens and accept/draft counters are
    equal, fp32 and int8 KV."""
    setup = setups[arch]
    vocab = setup[0].vocab
    kw = dict(moe_impl="capacity", kv_dtype=kv_dtype)
    jx = _jax(setup, **kw)
    jx.set_draft(JaxSelfDraft(1))
    tx = _port(setup, **kw)
    tx.set_draft(TruncatedSelfDraft(1))
    before = tmg.moe_gmm.launches
    got_j = _drive_spec_plans(jcore, jeng, jx, _requests(jeng, vocab))
    got_t = _drive_spec_plans(tcore, teng, tx, _requests(teng, vocab))
    assert tmg.moe_gmm.launches == before          # the CPU: plain version
    assert got_t == got_j
    tokens, _, drafted, n_spec = got_t
    assert n_spec >= 2 and drafted > 0
    assert all(len(t) == 6 for t in tokens.values())
    assert tx.compile_keys == jx.compile_keys
    assert tx.alloc.free_blocks == NUM_PAGES - 1


def test_moe_target_refuses_speculative_decode(setups):
    """A MoE target takes a ``TruncatedSelfDraft`` now (ROADMAP A11), which
    runs the target's own MoE FFN; a MoE *draft model* is still refused
    by ``SmallModelDraft`` in both packages (it is dense-only)."""
    setup = setups["mixtral-8x7b"]
    ex = _port(setup, moe_impl="capacity")
    draft = TruncatedSelfDraft(1)
    ex.set_draft(draft)
    assert ex.draft is draft and draft._ex is ex
    with pytest.raises(AssertionError):
        SmallModelDraft(setup[1], setup[3])
    with pytest.raises(AssertionError):
        JaxSmallDraft(setup[0], setup[2])


def test_moe_impl_and_family_checks(setups):
    setup = setups["kimi-k2-1t-a32b"]
    with pytest.raises(ValueError, match="moe_impl"):
        _port(setup, moe_impl="dropless")
    assert _port(setup).moe_impl == "exact"        # the JAX default
    ssm = dataclasses.replace(setup[1], family="ssm")
    with pytest.raises(NotImplementedError):
        teng.PagedTransformerExecutor(ssm, setup[3], device="cpu")
