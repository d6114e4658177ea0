"""Preemption on the port (DESIGN.md §13) against the JAX package.

tests/test_preemption.py's contracts on the port:

* allocator level — ``evict_request`` is refcount/COW-aware in both
  packages alike: the same eviction scenarios (a seeded sweep and a
  derandomized hypothesis sweep) leave equal allocator state, and the
  survivor's table intact;
* engine level — with a sim-speed executor over a real ``BlockAllocator``
  (the data plane's defer-on-out-of-pool contract without tensors) the
  aged requeue and SLO-aware preemption make the same decisions in both
  packages: equal output times, preemption counts and deferral events;
* real executor — a victim whose pages are shared with a COW survivor
  through the prefix cache is evicted on the port's executor
  (``Engine._preempt``, as the JAX test drives it): the survivor's table
  and pages are untouched, and both streams equal the JAX dense model's
  greedy oracle; with ample KV preemption is inert; and a pool cut so
  that preemption fires on its own, on the model clock, gives the JAX
  engine's tokens and preemption count.

Weights: reduced stablelm-3b (``window=None``) from
``build_model(cfg).init(PRNGKey(0))``, carried across by the bridge.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
import repro.engine as jeng
import repro_torch.core as tcore
import repro_torch.engine as teng
from repro.cache import PrefixCache as JPrefixCache
from repro.configs import get_reduced
from repro.engine import numerics as jnum
from repro.engine.kv_manager import BlockAllocator as JAlloc
from repro.models import ModelOpts, build_model
from repro_torch.cache import PrefixCache as TPrefixCache
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.engine import numerics as tnum
from repro_torch.engine.kv_manager import BlockAllocator as TAlloc
from repro_torch.models import params_from_numpy

PAGE = 8


# ---------------------------------------------------------------------------
# allocator level
# ---------------------------------------------------------------------------

def _evict(alloc_cls, num_pages, block_size, survivor_tokens, shared_pages,
           victim_extra):
    """tests/test_preemption.py::_evict_scenario on one package; returns
    the allocator state before and after the eviction."""
    alloc = alloc_cls(num_pages, block_size)
    tbl = alloc.extend(1, survivor_tokens)
    shared = tbl[:shared_pages]
    alloc.fork(2, shared, shared_pages * block_size)
    if victim_extra:
        alloc.extend(2, victim_extra)        # may COW a shared partial tail
        alloc.pop_cow_events()
    survivor = list(alloc.tables[1])
    n_before = alloc.context_len(1)
    state = lambda: (dict(alloc.tables), dict(alloc.lens),
                     dict(alloc.refcount), dict(alloc.scale_of),
                     list(alloc._free), list(alloc._free_scales))
    before = state()
    reclaim = alloc.reclaimable_pages(2)
    freed = alloc.evict_request(2)
    alloc.check_invariants()
    assert alloc.tables[1] == survivor and alloc.context_len(1) == n_before
    assert all(alloc.refcount.get(p, 0) >= 1 for p in survivor)
    assert not set(survivor) & set(alloc._free)
    assert freed == reclaim
    return before, state(), freed


def _evict_both(*args):
    j, t = _evict(JAlloc, *args), _evict(TAlloc, *args)
    assert j == t


@pytest.mark.parametrize("args", [
    (16, 4, 12, 3, 5),        # aligned fork, the victim grows its own tail
    (16, 4, 10, 3, 3),        # non-aligned share of a partial tail: COW
    (8, 4, 8, 2, 0),          # the victim holds only shared pages
    (64, 3, 20, 4, 17),
])
def test_eviction_never_corrupts_survivor_as_jax(args):
    _evict_both(*args)


def test_eviction_sweep_seeded():
    rng = random.Random(0)
    for _ in range(60):
        bs = rng.randint(1, 8)
        tokens = rng.randint(1, 6) * bs + rng.randint(0, bs - 1)
        shared = min(rng.randint(0, 6), -(-tokens // bs))
        _evict_both(64, bs, tokens, shared, rng.randint(0, 24))


def test_eviction_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(block_size=st.integers(1, 8),
               survivor_blocks=st.integers(1, 6),
               tail_fill=st.integers(0, 7),
               shared_pages=st.integers(0, 6),
               victim_extra=st.integers(0, 24))
    @hyp.settings(max_examples=100, deadline=None, derandomize=True,
                  database=None)
    def run(block_size, survivor_blocks, tail_fill, shared_pages,
            victim_extra):
        tokens = survivor_blocks * block_size + min(tail_fill, block_size - 1)
        _evict_both(64, block_size, tokens,
                    min(shared_pages, -(-tokens // block_size)),
                    victim_extra)

    run()


# ---------------------------------------------------------------------------
# engine level: a sim-speed executor with a real allocator
# ---------------------------------------------------------------------------

class _FakePaged:
    """tests/test_preemption.py's FakePagedExecutor, over either package's
    allocator: prefills grab pages first, as the fused executor does."""

    def __init__(self, alloc_cls, model, num_pages, page_size):
        self.true_model = model
        self.alloc = alloc_cls(num_pages, page_size)
        self.last_deferred = frozenset()

    def execute(self, plan, requests, now):
        deferred, nt, ctx = set(), 0, 0
        for items, n in ((plan.prefill_items, None), (plan.decode_items, 1)):
            for it in items:
                if self.alloc.extend(it.req_id, n or it.n_tokens) is None:
                    deferred.add(it.req_id)
                    continue
                nt += n or it.n_tokens
                ctx += requests[it.req_id].to_sched_task().cost_context()
        self.last_deferred = frozenset(deferred)
        return (self.true_model.step_time(nt, ctx) if nt else 1e-4), {}

    def release(self, req_id):
        self.alloc.release(req_id)


def _fake_run(pkg, core, alloc_cls, workload, preemption):
    model = core.LinearCostModel(a=1e-3, b=1e-4, c=0.0)
    num_pages, budget, defer_age, reqs = workload
    eng = pkg.Engine(core.make_scheduler("sarathi", model,
                                         token_budget=budget,
                                         calibrate=False),
                     _FakePaged(alloc_cls, model, num_pages, 8),
                     pkg.EngineConfig(ttft_slo=0.5, tpot_slo=0.05,
                                      preemption=preemption,
                                      defer_age=defer_age))
    for rid, arr, plen, n_new in reqs:
        eng.submit(pkg.Request(rid, arrival=arr, prompt_len=plen,
                               max_new_tokens=n_new, ttft_slo=0.5,
                               tpot_slo=0.05))
    eng.run(max_steps=5000)
    eng.executor.alloc.check_invariants()
    return ({rid: (list(r.output_times), r.preemptions, r.generated)
             for rid, r in eng.requests.items()},
            eng.preemptions, eng.defer_events, len(eng.done))


STARVING_PREFILL = (12, 64, 0.01, [(0, 0.0, 8, 80), (1, 0.06, 48, 4)])
AGED_REQUEUE = (8, 16, 0.005, [(0, 0.0, 8, 40)] + [
    (i, 0.002 * i, 16, 1) for i in range(1, 61)])


@pytest.mark.parametrize("name,workload,preemption", [
    ("starving_prefill", STARVING_PREFILL, True),
    ("starving_prefill_off", STARVING_PREFILL, False),
    ("aged_requeue", AGED_REQUEUE, False),
])
def test_engine_preemption_decisions_match_jax(name, workload, preemption):
    j = _fake_run(jeng, jcore, JAlloc, workload, preemption)
    t = _fake_run(teng, tcore, TAlloc, workload, preemption)
    assert t == j
    per_req, n_preempt, n_defer, n_done = t
    assert n_done == len(workload[3])
    if name == "starving_prefill":
        assert n_preempt >= 1 and per_req[0][1] >= 1
        assert per_req[0][2] == 80 and len(per_req[0][0]) == 80
    else:
        assert n_preempt == 0
    if name == "aged_requeue":
        assert n_defer > 0


# ---------------------------------------------------------------------------
# real executor: recompute-on-resume × prefix-cache COW sharing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_reduced("stablelm-3b"), window=None)
    tcfg = dataclasses.replace(torch_get_reduced("stablelm-3b"), window=None)
    model = build_model(cfg, ModelOpts(attn_impl="dense"))
    params = model.init(jax.random.PRNGKey(0))
    return (cfg, tcfg, model, params,
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))


def greedy_oracle(model, params, prompt, n_new):
    """tests/test_preemption.py's dense-cache greedy oracle, its decode
    step jitted (one compile for every step)."""
    toks = jnp.asarray(prompt, jnp.int32)[None]
    logits, cache = model.prefill(params, toks, max_len=64)
    step = jax.jit(model.decode_step)
    out = [int(jnp.argmax(logits, -1)[0])]
    for _ in range(n_new - 1):
        logits, cache = step(params, jnp.asarray([out[-1]], jnp.int32), cache)
        out.append(int(jnp.argmax(logits, -1)[0]))
    return out


def _port_engine(setup, num_pages, *, preemption, clock=None,
                 cache_pages=8):
    ex = teng.PagedTransformerExecutor(setup[1], setup[4],
                                       num_pages=num_pages, page_size=PAGE,
                                       max_pages_per_seq=16, device="cpu")
    cache = TPrefixCache(cache_pages, block_size=PAGE, alloc=ex.alloc)
    ex.attach_cache(cache)
    if clock is None:
        sched = tcore.make_scheduler("fairbatching", tcore.LinearCostModel(
            a=1e-4, b=1e-6, c=1e-10))
        timed = ex
    else:
        sched = tcore.make_scheduler("fairbatching", clock, calibrate=False)
        timed = tnum.ModelTimedExecutor(ex, clock)
    eng = teng.Engine(sched, timed,
                      teng.EngineConfig(ttft_slo=5.0, tpot_slo=5.0,
                                        preemption=preemption,
                                        defer_age=0.01),
                      prefix_cache=cache)
    return eng, ex, cache


def _pair_prompts(vocab):
    """tests/test_preemption.py::_shared_prefix_pair's prompts: X and Y
    share a 32-token prefix (four pages of 8)."""
    shared = [int(x) for x in jax.random.randint(jax.random.PRNGKey(11),
                                                 (32,), 0, vocab)]
    y_tail = [int(x) for x in jax.random.randint(jax.random.PRNGKey(12),
                                                 (12,), 0, vocab)]
    return shared + [1, 2, 3], shared + y_tail


def _shared_prefix_pair(setup, num_pages, preemption, n_new=16):
    x_prompt, y_prompt = _pair_prompts(setup[0].vocab)
    eng, ex, cache = _port_engine(setup, num_pages, preemption=preemption)
    eng.submit(teng.Request(0, arrival=0.0, prompt_len=len(x_prompt),
                            max_new_tokens=n_new, ttft_slo=5.0, tpot_slo=5.0,
                            tokens=list(x_prompt)))
    while eng.requests.get(0) is None or \
            eng.requests[0].prefilled < len(x_prompt):
        eng.step()
    eng.submit(teng.Request(1, arrival=eng.now, prompt_len=len(y_prompt),
                            max_new_tokens=n_new, ttft_slo=5.0, tpot_slo=5.0,
                            tokens=list(y_prompt)))
    while eng.requests.get(1) is None or eng.requests[1].generated < 4 \
            or eng.requests[0].generated >= n_new:
        eng.step()
    return eng, ex, (x_prompt, y_prompt, n_new)


@pytest.fixture(scope="module")
def oracle(setup):
    x_prompt, y_prompt = _pair_prompts(setup[0].vocab)
    return [greedy_oracle(setup[2], setup[3], p, 16)
            for p in (x_prompt, y_prompt)]


def test_preempted_victim_never_corrupts_cow_survivor(setup, oracle):
    eng, ex, _ = _shared_prefix_pair(setup, 64, preemption=True)
    x, y = eng.requests[0], eng.requests[1]
    x_table = list(ex.alloc.tables[0])
    shared = [p for p in x_table if ex.alloc.refcount.get(p, 0) > 1]
    assert shared, "Y should hold forked copies of X's prefix pages"
    pages_before = (ex.k_pages[:, x_table].clone(),
                    ex.v_pages[:, x_table].clone())
    eng._preempt(y)                           # evict Y mid-decode
    ex.alloc.check_invariants()
    assert y.preemptions == 1 and eng.preemptions == 1
    assert ex.alloc.tables[0] == x_table, "survivor table changed"
    for p in shared:
        assert p in ex.alloc.refcount, "shared page freed by eviction"
    assert (ex.k_pages[:, x_table] == pages_before[0]).all()
    assert (ex.v_pages[:, x_table] == pages_before[1]).all()
    # the resume recomputes only the uncached tail: the radix hit survived
    assert y.cached_context > 0 and y.prefilled == y.cached_context
    eng.run(max_steps=3000)
    assert len(eng.done) == 2
    assert x.generated_tokens == oracle[0], "survivor corrupted"
    assert y.generated_tokens == oracle[1], "victim resume diverged"
    ex.alloc.check_invariants()


def test_preemption_disabled_is_inert(setup, oracle):
    runs = {}
    for flag in (False, True):
        eng, ex, _ = _shared_prefix_pair(setup, 64, preemption=flag)
        eng.run(max_steps=3000)
        assert eng.preemptions == 0
        runs[flag] = [eng.requests[i].generated_tokens for i in (0, 1)]
    assert runs[False] == runs[True] == oracle


def _organic(pkg, setup, num_pages):
    """Four requests on a pool too small for all of them, the engine on
    the model clock so both packages make the same plans: preemption fires
    on its own (deferral, aging, victim choice) and victims re-prefill
    through the cache."""
    core = jcore if pkg is jeng else tcore
    num = jnum if pkg is jeng else tnum
    if pkg is jeng:
        ex = jeng.PagedTransformerExecutor(
            setup[0], setup[3], num_pages=num_pages, page_size=PAGE,
            max_pages_per_seq=16, ragged_attention=True)
        cache = JPrefixCache(8, block_size=PAGE, alloc=ex.alloc)
    else:
        ex = teng.PagedTransformerExecutor(
            setup[1], setup[4], num_pages=num_pages, page_size=PAGE,
            max_pages_per_seq=16, device="cpu")
        cache = TPrefixCache(8, block_size=PAGE, alloc=ex.alloc)
    ex.attach_cache(cache)
    clock = core.LinearCostModel(a=1e-3, b=1e-4, c=0.0)
    eng = pkg.Engine(core.make_scheduler("fairbatching", clock,
                                         calibrate=False),
                     num.ModelTimedExecutor(ex, clock),
                     pkg.EngineConfig(ttft_slo=5.0, tpot_slo=5.0,
                                      preemption=True, defer_age=0.01),
                     prefix_cache=cache)
    x_prompt, y_prompt = _pair_prompts(setup[0].vocab)
    for i, p in enumerate((x_prompt, y_prompt, x_prompt[:20], y_prompt)):
        eng.submit(pkg.Request(i, arrival=0.003 * i, prompt_len=len(p),
                               max_new_tokens=24, ttft_slo=5.0, tpot_slo=5.0,
                               tokens=list(p)))
    eng.run(max_steps=3000)
    ex.alloc.check_invariants()
    return ({r: list(q.generated_tokens) for r, q in eng.requests.items()},
            eng.preemptions, len(eng.done))


def test_organic_preemption_matches_jax(setup):
    tok_t, n_t, done_t = _organic(teng, setup, 17)
    tok_j, n_j, done_j = _organic(jeng, setup, 17)
    assert done_t == done_j == 4
    assert n_t == n_j and n_t >= 1, (n_t, n_j)
    assert tok_t == tok_j
