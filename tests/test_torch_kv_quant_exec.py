"""The port's quantized paged-KV data plane against the JAX package
(DESIGN.md §14): tests/test_kv_quant_exec.py's contracts on the port.

Both packages run reduced stablelm-3b (``window=None``) and reduced
h2o-danube-1.8b on shared weights carried across by the bridge
(``params_from_numpy``), on the CPU, where kernel B2's wrapper and the
batched quantized op take their plain versions. Pinned:

* int8 (and fp8-e4m3) fused tokens equal the JAX package's quantized fused
  executor's on the same fixed plans, first-token logits within 1e-4;
* the §11 contract survives quantization: under int8 and fp8 the fused
  step (ragged and batched backends), ``mode="sequential"``, committed
  multi-step decode (H=4) and speculative decode (γ=2, both drafts, at
  most 2 rounds a dispatch, ROADMAP §C) emit equal tokens;
* layer-0 K/V within ``row_error_bound`` of an fp32 twin through the
  port's ``kv_parity_report``, deeper layers within a compounding slack;
* under the port's ``ModelTimedExecutor`` the fp32 and int8 scheduler
  traces, deferral sets and VTC counters are byte-equal, and the int8
  trace is byte-equal to the JAX package's;
* a forked request's copy-on-write carries its scale page with the data
  page.
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
from repro.kernels import quant as jq
from repro.models import ModelOpts, build_model
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.engine import numerics as tnum
from repro_torch.engine.spec_decode import SmallModelDraft, TruncatedSelfDraft
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant as tq
from repro_torch.models import params_from_numpy

PAGE = 8
ATOL_LOGITS = 1e-4
ARCHS = ["stablelm-3b", "h2o-danube-1.8b"]   # full attention; window 16
MODEL = tcore.LinearCostModel(a=1e-3, b=1e-4, c=0.0)
# layers > 0 compound the previous layers' dequantization error through
# attention and MLP: tests/test_kv_quant_exec.py's envelope
DEEP_LAYER_SLACK = 64.0


def _need(fmt):
    if fmt == "fp8_e4m3" and not (jq.supports_fp8() and tq.supports_fp8()):
        pytest.skip("fp8_e4m3 needs float8_e4m3fn in both packages")


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


def _port(setup, kv_dtype="int8", num_pages=64, max_pages=16, **kw):
    return teng.PagedTransformerExecutor(
        setup[1], setup[3], num_pages=num_pages, page_size=PAGE,
        max_pages_per_seq=max_pages, kv_dtype=kv_dtype, device="cpu", **kw)


def _jax(setup, kv_dtype="int8", num_pages=64, max_pages=16, **kw):
    return jeng.PagedTransformerExecutor(
        setup[0], setup[2], num_pages=num_pages, page_size=PAGE,
        max_pages_per_seq=max_pages, kv_dtype=kv_dtype, **kw)


def _requests(pkg, vocab, n, plen, n_new, seed=5):
    rng = np.random.default_rng(seed)
    return {i: pkg.Request(i, arrival=0.0, prompt_len=plen + 3 * i,
                           max_new_tokens=n_new, ttft_slo=10.0,
                           tpot_slo=10.0, tokens=[int(x) for x in
                                                  rng.integers(0, vocab,
                                                               plen + 3 * i)])
            for i in range(n)}


def _drive_plans(core, eng_pkg, execu, requests, chunk):
    """tests/test_kv_quant_exec.py's deterministic fixed-chunk round robin:
    the same plan sequence whatever the executor (no scheduler feedback).
    Returns tokens and first-emission logits by request."""
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


@pytest.mark.parametrize("fmt, arch", [("int8", "stablelm-3b"),
                                       ("int8", "h2o-danube-1.8b"),
                                       ("fp8_e4m3", "stablelm-3b")])
def test_quant_fused_tokens_match_jax(setups, fmt, arch):
    _need(fmt)
    setup = setups[arch]
    vocab = setup[0].vocab
    jx = _jax(setup, fmt, ragged_attention=True, capture_logits=True)
    tx = _port(setup, fmt, capture_logits=True)
    tok_j, lg_j = _drive_plans(jcore, jeng, jx,
                               _requests(jeng, vocab, 4, 19, 6), chunk=12)
    tok_t, lg_t = _drive_plans(tcore, teng, tx,
                               _requests(teng, vocab, 4, 19, 6), chunk=12)
    assert tok_t == tok_j
    assert all(len(t) == 6 for t in tok_t.values())
    assert lg_t.keys() == lg_j.keys()
    for rid in lg_j:
        np.testing.assert_allclose(lg_t[rid], lg_j[rid], atol=ATOL_LOGITS,
                                   rtol=0)
    assert tx.k_pages.dtype == tq.kv_quant_spec(fmt).dtype
    assert tx.n_dispatches == jx.n_dispatches


def _serve(setup, fmt, *, mode="fused", ragged=True, horizon=1, gamma=0,
           draft=None, shuffle_scales=False):
    ex = _port(setup, fmt, mode=mode, ragged_attention=ragged)
    if shuffle_scales:
        # the allocator pops data and scale pages in lockstep, so scale ids
        # equal page ids unless the free scale list is permuted: then a
        # path that routed scales by the block table would read wrong ones
        np.random.default_rng(11).shuffle(ex.alloc._free_scales)
    if draft is not None:
        ex.set_draft(draft)
    eng = teng.Engine(tcore.make_scheduler("fairbatching", MODEL,
                                           calibrate=False),
                      tnum.ModelTimedExecutor(ex, MODEL),
                      teng.EngineConfig(ttft_slo=5.0, tpot_slo=5.0,
                                        commit_horizon=horizon,
                                        speculate=gamma))
    for r in _requests(teng, setup[0].vocab, 4, 11, 9, seed=3).values():
        eng.submit(r)
    n = 0
    while eng.has_work and n < 400:
        eng.step()
        n += 1
    assert not eng.has_work
    assert ex.alloc.free_blocks == ex.alloc.num_blocks - 1, "pages leaked"
    ex.alloc.check_invariants()
    return {rid: list(r.generated_tokens) for rid, r in
            eng.requests.items()}, ex


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_every_path_emits_the_fused_stream_under_quant(setups, fmt):
    """Quantization error is state, not noise: every path round-trips the
    same quantized pages and scale pages, so they emit one stream — a
    divergence is a scatter, gather or scale-table fault. The paths run
    with scale-page ids permuted against the data-page ids."""
    _need(fmt)
    setup = setups["h2o-danube-1.8b"]
    dcfg = dataclasses.replace(setup[1], n_layers=1)
    dparams = {**setup[3], "layers": {
        k: ({kk: vv[:1] for kk, vv in v.items()} if isinstance(v, dict)
            else v[:1]) for k, v in setup[3]["layers"].items()}}
    base, _ = _serve(setup, fmt)
    paths = {
        "batched": dict(ragged=False),
        "sequential": dict(mode="sequential"),
        "multi_h4": dict(horizon=4),
        "self_draft": dict(gamma=2, horizon=2,
                           draft=TruncatedSelfDraft(1)),
        "small_draft": dict(gamma=2, horizon=2,
                            draft=SmallModelDraft(dcfg, dparams)),
    }
    for name, kw in {"fused": {}, **paths}.items():
        tokens, ex = _serve(setup, fmt, shuffle_scales=True, **kw)
        assert tokens == base, name
        kinds = {k[0] for k in ex.compile_keys}
        if name in ("multi_h4", "self_draft", "small_draft"):
            assert kinds & {"multi", "spec"}, (name, kinds)
    assert all(len(t) == 9 for t in base.values())


def test_kv_parity_layer0_within_row_bound(setups):
    """Teacher-forced chunked prefill on identical tokens: layer 0's K/V
    depend only on the embeddings, so its dequantized rows sit within the
    exact ``row_error_bound``; deeper layers within ``DEEP_LAYER_SLACK``."""
    setup = setups["stablelm-3b"]
    vocab = setup[0].vocab
    exq, exr = _port(setup, "int8"), _port(setup, "fp32")
    for ex in (exq, exr):
        # the prompts cross page boundaries and leave a partial tail page
        _drive_plans(tcore, teng, ex, _requests(teng, vocab, 2, 37, 1, 7),
                     chunk=16)
    for rid in (0, 1):
        report = tnum.kv_parity_report(exq, exr, rid)
        assert len(report) == setup[1].n_layers
        lp0 = report[0]
        assert lp0.k_bound > 0 and lp0.v_bound > 0
        assert lp0.within(1.0), lp0
        for lp in report[1:]:
            assert lp.within(DEEP_LAYER_SLACK), lp
    with pytest.raises(AssertionError):
        tnum.kv_parity_report(exr, exq, 0)


def _sched_run(core, eng_pkg, num, execu):
    """tests/test_kv_quant_exec.py::_sched_run, smaller: a fairbatching
    engine with VTC admission over the deterministic model clock."""
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
    counts = {rid: r.generated for rid, r in eng.requests.items()}
    return trace, num.vtc_counters(eng), counts


def test_scheduler_trace_byte_equal_fp32_vs_int8_and_jax(setups):
    """Token values may drift within the §14 bound; every scheduling
    decision — plans, deferral sets, per-tenant VTC billing — is
    byte-identical between fp32 and int8 at equal page counts, and the
    port's int8 run decides as the JAX package's does."""
    setup = setups["stablelm-3b"]
    runs = {kv: _sched_run(tcore, teng, tnum, _port(
        setup, kv, num_pages=48, max_pages=8)) for kv in ("fp32", "int8")}
    jrun = _sched_run(jcore, jeng, jnum, _jax(setup, "int8", num_pages=48,
                                              max_pages=8))
    (t32, c32, n32), (t8, c8, n8) = runs["fp32"], runs["int8"]
    assert len(t32.plans) > 10, "trace too short to be meaningful"
    tnum.assert_same_decisions(t32, t8, "fp32 vs int8")
    assert t32.fingerprint() == t8.fingerprint() == jrun[0].fingerprint()
    assert c32 == c8 == jrun[1] and set(c8) == {"interactive", "batch"}
    assert n32 == n8 == jrun[2]


def test_cow_copy_carries_the_scale_page(setups):
    """A request forked onto another's partial tail page copies it on its
    first write; the copy gets a fresh scale page holding the same scales,
    so the fork reads the values it shares, and the original is intact."""
    setup = setups["stablelm-3b"]
    vocab = setup[0].vocab
    ex = _port(setup, "int8")
    _drive_plans(tcore, teng, ex, _requests(teng, vocab, 1, 12, 1), chunk=12)
    pages = list(ex.alloc.tables[0])
    n_tok = ex.alloc.context_len(0)
    assert n_tok % PAGE, "the tail page must be partial"
    ex.alloc.fork(1, pages, n_tok)
    tail, s_tail = pages[-1], ex.alloc.scale_of[pages[-1]]
    before = (ex.k_pages[:, tail].clone(), ex.k_scales[:, s_tail].clone())
    ex._extend(1, 1)                       # mirrors the COW copy at once
    new = ex.alloc.tables[1][-1]
    s_new = ex.alloc.scale_of[new]
    assert new != tail and s_new != s_tail
    assert ex.alloc.tables[0][-1] == tail
    used = n_tok % PAGE
    for pool, scales in ((ex.k_pages, ex.k_scales),
                         (ex.v_pages, ex.v_scales)):
        assert torch.equal(pool[:, new, :used].view(torch.uint8),
                           pool[:, tail, :used].view(torch.uint8))
        assert torch.equal(scales[:, s_new, :used], scales[:, s_tail, :used])
        assert scales[:, s_new, :used].abs().min() > 0
    assert torch.equal(ex.k_pages[:, tail], before[0])
    assert torch.equal(ex.k_scales[:, s_tail], before[1])
    ex.release(0)
    ex.release(1)
    ex.alloc.check_invariants()
    assert tpa.paged_attention_ragged_quant.launches == 0   # the CPU
