"""The port's speculative decode (DESIGN.md §18) against the JAX package.

tests/test_spec_decode.py's contracts on the port, on the CPU and on
shared weights: for the truncated-layer self-draft (γ ∈ {1, 2, 4}), the
forced-rejection edge case and a separate small-model draft, each emitted
stream equals the JAX greedy oracle (``build_model(...).prefill`` /
``decode_step``) — stream identity by construction — and the engine's
``spec_accepted`` / ``spec_drafted`` equal the JAX speculative run's. Each
engine step is one executor dispatch under the ``("spec", bsz, R, γ)``
key, the optimistic reservations are reclaimed (the pool drains back to
all but the trash page), and ``capture_logits`` raises on the multi-step
paths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
import repro.engine as jeng
import repro_torch.core as tcore
import repro_torch.engine as teng
from repro.configs import get_reduced
from repro.engine import spec_decode as jspec
from repro.models import ModelOpts, build_model
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.engine import spec_decode as tspec
from repro_torch.models import params_from_numpy

PAGE, NUM_PAGES, MAX_PAGES = 16, 64, 8
N_NEW = 8


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_reduced("stablelm-3b"), window=None)
    tcfg = dataclasses.replace(torch_get_reduced("stablelm-3b"), window=None)
    model = build_model(cfg, ModelOpts(attn_impl="dense"))
    params = model.init(jax.random.PRNGKey(0))
    return cfg, tcfg, model, params, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


@pytest.fixture(scope="module")
def draft_setup(setup):
    """A genuinely smaller dense draft arch sharing the target's vocab."""
    cfg, tcfg = setup[:2]
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = build_model(dcfg, ModelOpts(attn_impl="dense")).init(
        jax.random.PRNGKey(42))
    return (dcfg, dataclasses.replace(tcfg, n_layers=1), dparams,
            params_from_numpy(jax.tree.map(np.asarray, dparams), "cpu"))


def _requests(pkg, vocab, n=3, n_new=N_NEW):
    rng = np.random.default_rng(3)
    return [pkg.Request(i, arrival=0.0, prompt_len=5 + 9 * i,
                        max_new_tokens=n_new, ttft_slo=5.0, tpot_slo=5.0,
                        tokens=[int(x) for x in rng.integers(
                            0, vocab, 5 + 9 * i)])
            for i in range(n)]


@pytest.fixture(scope="module")
def oracle(setup):
    """The JAX model's own greedy decode of each request's prompt."""
    cfg, _, model, params, _ = setup
    out = {}
    for r in _requests(jeng, cfg.vocab):
        logits, cache = model.prefill(
            params, jnp.asarray(r.tokens, jnp.int32)[None], max_len=256)
        toks = [int(jnp.argmax(logits, -1)[0])]
        for _ in range(r.max_new_tokens - 1):
            logits, cache = model.decode_step(
                params, jnp.asarray([toks[-1]], jnp.int32), cache)
            toks.append(int(jnp.argmax(logits, -1)[0]))
        out[r.req_id] = toks
    return out


def _drive(core, pkg, cfg, params, gamma, draft=None, force_reject=False,
           horizon=1, capture_logits=False):
    ex = pkg.PagedTransformerExecutor(
        cfg, params, num_pages=NUM_PAGES, page_size=PAGE,
        max_pages_per_seq=MAX_PAGES, capture_logits=capture_logits,
        **({"device": "cpu"} if pkg is teng else {}))
    if draft is not None:
        ex.set_draft(draft)
        ex.spec_force_reject = force_reject
    sched = core.make_scheduler("fairbatching",
                                core.LinearCostModel(a=1e-4, b=1e-6, c=1e-10))
    eng = pkg.Engine(sched, ex, pkg.EngineConfig(
        5.0, 5.0, speculate=gamma, commit_horizon=horizon))
    for r in _requests(pkg, cfg.vocab):
        eng.submit(r)
    n = 0
    while eng.has_work and n < 400:
        eng.step()
        n += 1
    assert not eng.has_work
    return eng, ex


def _both(setup, gamma, drafts, **kw):
    """The same speculative run in the JAX package and in the port."""
    cfg, tcfg, _, params, tparams = setup
    jd, td = drafts()
    return (_drive(jcore, jeng, cfg, params, gamma, jd, **kw),
            _drive(tcore, teng, tcfg, tparams, gamma, td, **kw))


def _assert_round_invariants(eng, ex, oracle):
    for rid, toks in oracle.items():
        assert list(eng.requests[rid].generated_tokens) == toks
    assert any(k[0] == "spec" for k in ex.compile_keys), ex.compile_keys
    assert ex.n_dispatches == eng.n_dispatches
    assert ex.alloc.free_blocks == NUM_PAGES - 1


@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_self_draft_streams_match_jax(setup, oracle, gamma):
    """Truncated-layer self-draft speculation emits the greedy stream, with
    the JAX run's acceptance counts, over horizons of up to 2 rounds."""
    (ej, xj), (et, xt) = _both(
        setup, gamma,
        lambda: (jspec.TruncatedSelfDraft(1), tspec.TruncatedSelfDraft(1)),
        horizon=2)
    _assert_round_invariants(et, xt, oracle)
    assert et.spec_drafted > 0
    assert (et.spec_accepted, et.spec_drafted, et.spec_rounds) == \
        (ej.spec_accepted, ej.spec_drafted, ej.spec_rounds)
    assert xt.compile_keys == xj.compile_keys


def test_forced_rejection_stream_identical(setup, oracle):
    """acceptance = 0 edge: every draft rejected, every round still emits
    the verified argmax — stream unchanged, progress 1 token/round."""
    (ej, _), (et, xt) = _both(
        setup, 2,
        lambda: (jspec.TruncatedSelfDraft(1), tspec.TruncatedSelfDraft(1)),
        force_reject=True)
    _assert_round_invariants(et, xt, oracle)
    assert et.spec_accepted == ej.spec_accepted == 0
    assert et.spec_drafted == ej.spec_drafted > 0


def test_small_model_draft_stream_matches_jax(setup, draft_setup, oracle):
    """A separate small draft model behind the same interface: its own KV
    pools (global page ids), host coverage map and chunked backfill."""
    dcfg, dtcfg, dparams, dtparams = draft_setup
    (ej, xj), (et, xt) = _both(
        setup, 2, lambda: (jspec.SmallModelDraft(dcfg, dparams),
                           tspec.SmallModelDraft(dtcfg, dtparams)),
        horizon=2)
    _assert_round_invariants(et, xt, oracle)
    assert (et.spec_accepted, et.spec_drafted) == \
        (ej.spec_accepted, ej.spec_drafted)
    # coverage gaps (admission after target prefill) were backfilled by
    # draft-side dispatches, NOT billed to the target plane's counter
    assert xt.draft.n_backfill_dispatches == \
        xj.draft.n_backfill_dispatches > 0
    assert not xt.draft._covered, "released requests leave no coverage"


@pytest.mark.parametrize("gamma", [2, 3])
def test_request_finishing_mid_dispatch_is_finished_once(setup, oracle,
                                                         gamma):
    """A request whose budget runs out in round 1 of a 3-round dispatch
    gets capped (empty) rounds after it and must be finished once. The JAX
    engine finishes it again on each capped round and raises (ROADMAP §C);
    the port's engine finishes it on the round that completed it."""
    _, tcfg, _, _, tparams = setup
    eng, ex = _drive(tcore, teng, tcfg, tparams, gamma,
                     tspec.TruncatedSelfDraft(1), horizon=3)
    _assert_round_invariants(eng, ex, oracle)
    assert ("spec", 4, 3, gamma) in ex.compile_keys
    assert sorted(r.req_id for r in eng.done) == sorted(oracle)


@pytest.mark.parametrize("gamma, horizon", [(2, 1), (0, 4)],
                         ids=["spec", "multi"])
def test_capture_logits_raises_on_multistep(setup, gamma, horizon):
    """Per-step logits never leave the device on the multi-step paths:
    ``execute_multi`` raises instead of returning stale ``last_logits``."""
    _, tcfg, _, _, tparams = setup
    draft = tspec.TruncatedSelfDraft(1) if gamma else None
    with pytest.raises(ValueError, match="capture_logits"):
        _drive(tcore, teng, tcfg, tparams, gamma, draft, horizon=horizon,
               capture_logits=True)
