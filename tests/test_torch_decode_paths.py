"""The port's sequential mode, fused batched backend and committed
multi-step decode against the JAX package.

Both packages serve the same requests on shared weights carried across by
the bridge (``params_from_numpy``), on the CPU, where the port's batched
paged attention takes its plain version. Pinned:

* ``mode="sequential"`` — the parity oracle of every JAX executor suite —
  emits the JAX sequential executor's greedy tokens, first-token logits
  within 1e-4 (fp32 through two BLAS libraries over a 2-layer model), and
  under the model clock (``ModelTimedExecutor``) a byte-equal scheduler
  trace with the same dispatches and compile keys;
* the port's fused step (ragged kernel, and the batched backend with
  ``ragged_attention=False``) emits the port's sequential tokens, logits
  allclose — not bitwise: the two paths sum in different orders;
* ``commit_horizon=4`` (tests/test_async_pipeline.py's parity pin): H=4
  tokens equal H=1 tokens and the JAX run's, one executor dispatch per
  engine dispatch, the ``("multi", bsz, 4)`` key, no page leaked.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.core as jcore
import repro.engine as jeng
import repro_torch.core as tcore
import repro_torch.engine as teng
from repro.configs import get_reduced
from repro.engine import numerics as jnum
from repro.models import ModelOpts, build_model
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.engine import numerics as tnum
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import params_from_numpy

PAGE, NUM_PAGES, MAX_PAGES = 16, 64, 8
ATOL_LOGITS = 1e-4
ARCHS = ["stablelm-3b", "h2o-danube-1.8b"]   # full attention; window 16


@pytest.fixture(scope="module")
def setups():
    out = {}
    for arch in ARCHS:
        cfg, tcfg = get_reduced(arch), torch_get_reduced(arch)
        if arch == "stablelm-3b":
            cfg = dataclasses.replace(cfg, window=None)
            tcfg = dataclasses.replace(tcfg, window=None)
        params = build_model(cfg, ModelOpts(attn_impl="dense")).init(
            jax.random.PRNGKey(0))
        out[arch] = (cfg, tcfg, params, params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu"))
    return out


def _executors(setup, **kw):
    cfg, tcfg, params, tparams = setup
    kw = {"num_pages": NUM_PAGES, "page_size": PAGE,
          "max_pages_per_seq": MAX_PAGES, **kw}
    jax_kw = {k: v for k, v in kw.items() if k != "ragged_attention"}
    return (jeng.PagedTransformerExecutor(cfg, params, **jax_kw),
            teng.PagedTransformerExecutor(tcfg, tparams, device="cpu", **kw))


def _mixed_requests(pkg, vocab, seed, n=5, max_prompt=40, n_new=5):
    """Staggered arrivals interleave chunked prefills with live decodes."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = 1 + (7 * i + seed) % max_prompt
        toks = [int(x) for x in rng.integers(0, vocab, plen)]
        reqs.append(pkg.Request(i, arrival=0.002 * i, prompt_len=plen,
                                max_new_tokens=n_new, ttft_slo=5.0,
                                tpot_slo=5.0, tokens=toks))
    return reqs


def _decode_requests(pkg, vocab, n=4, n_new=13):
    """tests/test_async_pipeline.py's multi-step workload: all arrive at
    0, prompts 5 + 9i."""
    rng = np.random.default_rng(3)
    return [pkg.Request(i, 0.0, 5 + 9 * i, n_new, 5.0, 5.0,
                        tokens=[int(x) for x in rng.integers(
                            0, vocab, 5 + 9 * i)])
            for i in range(n)]


def _drive(core, eng_pkg, execu, reqs, max_steps=400, **ecfg):
    sched = core.make_scheduler("fairbatching",
                                core.LinearCostModel(a=1e-4, b=1e-6, c=1e-10))
    eng = eng_pkg.Engine(sched, execu,
                         eng_pkg.EngineConfig(ttft_slo=5.0, tpot_slo=5.0,
                                              **ecfg))
    trace = (tnum if eng_pkg is teng else jnum).capture_schedule(eng)
    for r in reqs:
        eng.submit(r)
    first, n = {}, 0
    inner = getattr(execu, "_inner", execu)
    while eng.has_work and n < max_steps:
        eng.step()
        n += 1
        for rid, lg in inner.last_logits.items():
            first.setdefault(rid, lg.copy())
    assert not eng.has_work
    tokens = {rid: list(r.generated_tokens) for rid, r in eng.requests.items()}
    return eng, tokens, first, trace


@pytest.mark.parametrize("arch", ARCHS)
def test_sequential_matches_jax_sequential(setups, arch):
    jx, tx = _executors(setups[arch], mode="sequential", capture_logits=True)
    vocab = setups[arch][0].vocab
    before = tpa.paged_attention.launches
    _, tok_j, lg_j, _ = _drive(jcore, jeng, jx,
                               _mixed_requests(jeng, vocab, 1))
    et, tok_t, lg_t, _ = _drive(tcore, teng, tx,
                                _mixed_requests(teng, vocab, 1))
    assert tok_t == tok_j
    assert lg_t.keys() == lg_j.keys() and len(lg_t) == 5
    for rid in lg_j:
        np.testing.assert_allclose(lg_t[rid], lg_j[rid], atol=ATOL_LOGITS,
                                   rtol=0)
    # plans follow the wall clock here (staggered arrivals), so dispatch
    # counts may differ run to run; the model-clock test pins them equal
    assert tx.n_dispatches >= len(et.steps)
    assert {k[0] for k in tx.compile_keys} == {"chunk", "decode"}
    assert tpa.paged_attention.launches == before   # the CPU: plain version
    assert tx.alloc.free_blocks == NUM_PAGES - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_sequential_trace_byte_equal_under_model_clock(setups, arch):
    """Same plans and deferral sets, step for step, once both data planes
    report the cost model's time instead of their wall clocks."""
    jx, tx = _executors(setups[arch], mode="sequential")
    vocab = setups[arch][0].vocab
    reqs = dict(n=7, max_prompt=60, n_new=6)
    ej, tok_j, _, tr_j = _drive(jcore, jeng, jnum.ModelTimedExecutor(jx),
                                _mixed_requests(jeng, vocab, 4, **reqs))
    et, tok_t, _, tr_t = _drive(tcore, teng, tnum.ModelTimedExecutor(tx),
                                _mixed_requests(teng, vocab, 4, **reqs))
    assert len(tr_j.plans) > 5
    assert tr_t.fingerprint() == tr_j.fingerprint()
    assert tok_t == tok_j
    assert [dataclasses.astuple(s) for s in et.steps] == \
        [dataclasses.astuple(s) for s in ej.steps]
    assert tx.n_dispatches == jx.n_dispatches
    assert tx.compile_keys == jx.compile_keys


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "batched"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_matches_port_sequential(setups, arch, ragged):
    """The fused step, through either attention backend, emits the port's
    sequential stream; one dispatch per engine step."""
    _, seq = _executors(setups[arch], mode="sequential", capture_logits=True)
    _, fused = _executors(setups[arch], ragged_attention=ragged,
                          capture_logits=True)
    vocab = setups[arch][0].vocab
    _, tok_s, lg_s, _ = _drive(tcore, teng, seq,
                               _mixed_requests(teng, vocab, 9))
    ef, tok_f, lg_f, _ = _drive(tcore, teng, fused,
                                _mixed_requests(teng, vocab, 9))
    assert tok_f == tok_s
    assert lg_f.keys() == lg_s.keys()
    for rid in lg_s:
        np.testing.assert_allclose(lg_f[rid], lg_s[rid], atol=ATOL_LOGITS,
                                   rtol=0)
    assert fused.n_dispatches == len(ef.steps)
    assert {k[0] for k in fused.compile_keys} == {"fused"}


@pytest.mark.parametrize("arch", ARCHS)
def test_multistep_decode_parity(setups, arch):
    """H committed decode steps == H single-step dispatches, in the port
    and against the JAX run, as ONE dispatch each."""
    vocab = setups[arch][0].vocab
    runs = {}
    for horizon in (1, 4):
        jx, tx = _executors(setups[arch])
        runs[horizon] = (
            _drive(tcore, teng, tx, _decode_requests(teng, vocab),
                   commit_horizon=horizon), tx)
    (base, tok_1, _, _), ex1 = runs[1]
    (multi, tok_4, _, _), ex4 = runs[4]
    _, tok_j, _, _ = _drive(jcore, jeng, jx, _decode_requests(jeng, vocab),
                            commit_horizon=4)
    assert tok_4 == tok_1 == tok_j
    assert all(len(t) == 13 for t in tok_4.values())
    # same scheduler-step trajectory, fewer device dispatches
    assert len(multi.steps) == len(base.steps)
    assert multi.n_dispatches < base.n_dispatches
    assert ex4.n_dispatches == multi.n_dispatches
    assert ex1.n_dispatches == base.n_dispatches == len(base.steps)
    assert ("multi", 4, 4) in ex4.compile_keys, sorted(ex4.compile_keys)
    assert ex4.compile_keys == jx.compile_keys
    # deferral-free run must not leak pages
    assert ex4.alloc.free_blocks == ex1.alloc.free_blocks == NUM_PAGES - 1
