"""The port's prefix cache (DESIGN.md §10) against the JAX package's.

* ``cache/`` is a copy: the same operation programs through both packages'
  ``RadixTree`` / ``PrefixCache`` / ``BlockAllocator`` (virtual mode and a
  cache on a shared allocator with a permuted free-scale list) return the
  same values and leave equal tables, refcounts, scale pairings, free lists
  and matches after every operation;
* the real executor with a cache attached (``attach_cache``, eviction on a
  failed extend) serves shared-prefix requests through ``Engine`` on the
  deterministic model clock (each package's ``ModelTimedExecutor``, so both
  make the same plans): in fp32 the tokens equal the JAX package's and the
  first-token logits agree within 1e-5, with equal allocator state after
  every step; in int8 and fp8-e4m3 (scale pages permuted against the data
  pages) the tokens equal JAX's, logits agree within 1e-4 and the forked
  pages' layer-0 K/V sit within DESIGN.md §14's ``row_error_bound`` of an
  fp32 twin;
* a capacity-0 cache is bit-identical to no cache within the port, and the
  first-token logits computed on top of cache-shared pages equal a cold
  prefill (tests/test_real_executor.py's contract).

Both packages run reduced stablelm-3b (``window=None``) on shared weights
(``build_model(cfg).init(PRNGKey(0))``, carried across by the bridge), on
the CPU, where the port's kernels take their plain versions.
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
from repro.kernels import quant as jq
from repro.models import ModelOpts, build_model
from repro_torch.cache import PrefixCache as TPrefixCache
from repro_torch.cache import split_blocks
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.engine import numerics as tnum
from repro_torch.engine.kv_manager import BlockAllocator as TAlloc
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant as tq
from repro_torch.models import params_from_numpy

PAGE = 8
CLOCK = dict(a=1e-3, b=1e-4, c=0.0)
ATOL_FP32 = 1e-5
ATOL_QUANT = 1e-4


# ---------------------------------------------------------------------------
# cache and allocator: one operation program through both packages
# ---------------------------------------------------------------------------

def _alloc_state(alloc) -> tuple:
    return (dict(alloc.tables), dict(alloc.lens), dict(alloc.refcount),
            dict(alloc.scale_of), list(alloc._free), list(alloc._free_scales))


def _cache_state(cache) -> tuple:
    return (_alloc_state(cache.alloc), cache.stats_dict(), cache.held_pages,
            cache.prefix_hash_summary(), cache.snapshot())


def _run_program(seed: int, make_cache, n_ops: int = 40) -> None:
    """Seeded request lifecycles (admit, prefill in chunks, publish,
    decode, finish) over prompts that share prefixes, with evictions and
    allocator forks between them, applied to both packages' caches; after
    every op both return the same value and hold the same state."""
    rng = random.Random(seed)
    caches = make_cache()
    stems = [[rng.randrange(50) for _ in range(rng.randrange(4, 28))]
             for _ in range(3)]
    live: dict = {}                      # rid -> [tokens, prefilled]
    for i in range(n_ops):
        now, rid = float(i), rng.randrange(6)
        op = rng.choice(("begin", "begin", "progress", "progress", "insert",
                         "decode", "end", "evict", "fork"))
        if op == "begin" and rid not in live:
            toks = rng.choice(stems)[:rng.randrange(1, 28)] + \
                [rng.randrange(50) for _ in range(rng.randrange(0, 6))]
            outs = [c.begin_request(rid, toks, now) for c in caches]
            live[rid] = [toks, outs[0]]
        elif op == "progress" and rid in live:
            toks, done = live[rid]
            n = min(len(toks) - done, rng.randrange(1, 12))
            outs = [c.on_prefill_progress(rid, n) for c in caches]
            live[rid][1] += n
        elif op == "insert" and rid in live:
            outs = [c.insert_request(rid, live[rid][0], now) for c in caches]
        elif op == "decode" and rid in live \
                and live[rid][1] == len(live[rid][0]):
            # the data plane's decode growth (a shared allocator only;
            # a virtual one tracks prefill growth alone)
            outs = [None if c.owns_alloc else
                    (c.alloc.extend(rid, 1), c.alloc.pop_cow_events_batched())
                    for c in caches]
        elif op == "end" and rid in live:
            outs = [c.end_request(rid) for c in caches]
            del live[rid]
        elif op == "evict":
            n = rng.randrange(1, 12)
            outs = [c.evict_for(n) for c in caches]
        elif op == "fork" and live and 100 + rid not in caches[0].alloc.tables:
            # a sibling forked onto a live table (unaligned when the donor's
            # tail page is partial), then grown: copy-on-write
            donor = sorted(live)[rid % len(live)]
            outs = []
            for c in caches:
                tbl = list(c.alloc.tables.get(donor, ()))
                c.alloc.fork(100 + rid, tbl, c.alloc.lens.get(donor, 0))
                outs.append((c.alloc.extend(100 + rid, 1 + rid),
                             c.alloc.pop_cow_events_batched()))
                c.alloc.release(100 + rid)
        else:
            continue
        assert outs[0] == outs[1], (i, op)
        assert _cache_state(caches[0]) == _cache_state(caches[1]), (i, op)
        for c in caches:
            c.alloc.check_invariants()
            c.tree.check_invariants()
    probe = split_blocks(stems[0], 4)
    assert caches[0].tree.match(probe, 1e9) == caches[1].tree.match(probe,
                                                                     1e9)


def _virtual():
    return (JPrefixCache(12, block_size=4, alloc_pages=40),
            TPrefixCache(12, block_size=4, alloc_pages=40))


def _shared_permuted():
    """A cache on an executor-style shared allocator whose free scale list
    is permuted: the lockstep scale-id = page-id pairing no longer holds."""
    out = []
    for alloc_cls, cache_cls in ((JAlloc, JPrefixCache),
                                 (TAlloc, TPrefixCache)):
        alloc = alloc_cls(40, 4)
        random.Random(3).shuffle(alloc._free_scales)
        out.append(cache_cls(12, block_size=4, alloc=alloc))
    return tuple(out)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["virtual", "shared_permuted_scales"])
def test_cache_programs_match_jax(seed, kind):
    _run_program(seed, _virtual if kind == "virtual" else _shared_permuted)


def test_cache_programs_match_jax_hypothesis():
    """The same programs drawn by hypothesis: derandomized, no example
    database (a stale one must never replay into the run)."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(seed=st.integers(0, 10 ** 6), n_ops=st.integers(0, 60),
               shared=st.booleans())
    @hyp.settings(max_examples=40, deadline=None, derandomize=True,
                  database=None)
    def run(seed, n_ops, shared):
        if not n_ops:                    # an empty program: nothing to hold
            return
        _run_program(seed, _shared_permuted if shared else _virtual, n_ops)

    run()


def test_radix_tree_matches_and_evicts_as_jax():
    from repro.cache import RadixTree as JTree, block_hashes as jh, \
        split_blocks as jsb
    from repro_torch.cache import RadixTree as TTree, block_hashes as th, \
        split_blocks as tsb
    rng = random.Random(5)
    trees = (JTree(), TTree())
    for i in range(30):
        toks = [rng.randrange(4) for _ in range(rng.randrange(1, 24))]
        pages = list(range(100 * i, 100 * i + len(toks) // 4))
        assert jh(toks, 4) == th(toks, 4)
        outs = [t.insert(sb(toks, 4), pages, h(toks, 4), float(i))
                for t, sb, h in ((trees[0], jsb, jh), (trees[1], tsb, th))]
        assert outs[0] == outs[1]
        probe = [rng.randrange(4) for _ in range(rng.randrange(0, 24))]
        assert trees[0].match(jsb(probe, 4), i + 0.5) == \
            trees[1].match(tsb(probe, 4), i + 0.5)
        if i % 5 == 4:
            assert trees[0].evict_one(lambda p: True) == \
                trees[1].evict_one(lambda p: True)
        for t in trees:
            t.check_invariants()
        assert trees[0].prefix_hash_summary() == trees[1].prefix_hash_summary()


# ---------------------------------------------------------------------------
# the real executor with a cache attached
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_reduced("stablelm-3b"), window=None)
    tcfg = dataclasses.replace(torch_get_reduced("stablelm-3b"), window=None)
    model = build_model(cfg, ModelOpts(attn_impl="dense"))
    params = model.init(jax.random.PRNGKey(0))
    return (cfg, tcfg, params,
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"), model)


def _prompts(vocab: int, seed: int = 5) -> list:
    """A 3-block shared prefix and tails that diverge at, inside and past
    a page boundary; the last prompt repeats the first (a full hit)."""
    rng = np.random.default_rng(seed)
    shared = [int(x) for x in rng.integers(0, vocab, 3 * PAGE)]
    tails = [[int(x) for x in rng.integers(0, vocab, n)] for n in (5, 9, 3)]
    return [shared + tails[0], shared + tails[1], shared[:PAGE + 3] + tails[2],
            shared + tails[0]]


def _executor(pkg, setup, kv_dtype, *, num_pages=48, shuffle=False):
    if pkg is jeng:
        ex = jeng.PagedTransformerExecutor(
            setup[0], setup[2], num_pages=num_pages, page_size=PAGE,
            max_pages_per_seq=8, kv_dtype=kv_dtype, ragged_attention=True,
            capture_logits=True)
    else:
        ex = teng.PagedTransformerExecutor(
            setup[1], setup[3], num_pages=num_pages, page_size=PAGE,
            max_pages_per_seq=8, kv_dtype=kv_dtype, capture_logits=True,
            device="cpu")
    if shuffle:
        # the same permutation in both packages: their allocators pop the
        # same ids, so their states stay comparable step by step
        np.random.default_rng(11).shuffle(ex.alloc._free_scales)
    return ex


def _engine(pkg, ex, capacity: int, *, preemption=False):
    core = jcore if pkg is jeng else tcore
    num = jnum if pkg is jeng else tnum
    cache_cls = JPrefixCache if pkg is jeng else TPrefixCache
    cache = None
    if capacity is not None:
        cache = cache_cls(capacity, block_size=PAGE, alloc=ex.alloc)
        ex.attach_cache(cache)
    clock = core.LinearCostModel(**CLOCK)
    eng = pkg.Engine(core.make_scheduler("fairbatching", clock,
                                         calibrate=False),
                     num.ModelTimedExecutor(ex, clock),
                     pkg.EngineConfig(ttft_slo=5.0, tpot_slo=5.0,
                                      preemption=preemption),
                     prefix_cache=cache)
    return eng, num.capture_schedule(eng)


def _submit(pkg, eng, prompts, n_new=4, gap=0.05):
    # spaced arrivals: request 0 publishes its prefix before the rest look
    # it up (its prefill takes a few ms of model clock)
    for i, p in enumerate(prompts):
        eng.submit(pkg.Request(i, arrival=gap * i, prompt_len=len(p),
                               max_new_tokens=n_new, ttft_slo=5.0,
                               tpot_slo=5.0, tokens=list(p)))


def _first_logits(ex, first):
    for rid, lg in ex.last_logits.items():
        first.setdefault(rid, np.asarray(lg).copy())


def _lockstep(setup, kv_dtype, shuffle=False, capacity=16):
    """Both packages' engines step by step on the model clock; allocator
    state compared after every step. Returns tokens, logits, executors."""
    prompts = _prompts(setup[0].vocab)
    runs = []
    for pkg in (jeng, teng):
        ex = _executor(pkg, setup, kv_dtype, shuffle=shuffle)
        eng, trace = _engine(pkg, ex, capacity)
        _submit(pkg, eng, prompts)
        runs.append([eng, ex, {}, trace])
    n = 0
    while any(r[0].has_work for r in runs) and n < 400:
        for eng, ex, first, _ in runs:
            eng.step()
            _first_logits(ex, first)
        assert _alloc_state(runs[0][1].alloc) == _alloc_state(runs[1][1].alloc)
        n += 1
    assert not any(r[0].has_work for r in runs)
    (je, jx, jfirst, jtr), (te, tx, tfirst, ttr) = runs
    assert jtr.fingerprint() == ttr.fingerprint()
    assert te.prefix_cache.stats_dict() == je.prefix_cache.stats_dict()
    assert te.prefix_cache.stats.hit_requests >= 2
    tx.alloc.check_invariants()
    tok = lambda e: {r: list(q.generated_tokens)
                     for r, q in e.requests.items()}
    return tok(je), tok(te), jfirst, tfirst, tx


def test_cached_fp32_matches_jax(setup):
    tok_j, tok_t, lg_j, lg_t, tx = _lockstep(setup, "fp32")
    assert tok_t == tok_j
    assert all(len(t) == 4 for t in tok_t.values())
    assert tok_t[0] == tok_t[3]                 # a full hit, the same stream
    assert lg_t.keys() == lg_j.keys()
    for rid in lg_j:
        np.testing.assert_allclose(lg_t[rid], lg_j[rid], atol=ATOL_FP32,
                                   rtol=0)
    assert tpa.paged_attention_ragged.launches == 0      # the CPU


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_cached_quant_matches_jax_permuted_scales(setup, fmt):
    if fmt == "fp8_e4m3" and not (jq.supports_fp8() and tq.supports_fp8()):
        pytest.skip("fp8_e4m3 needs float8_e4m3fn in both packages")
    tok_j, tok_t, lg_j, lg_t, tx = _lockstep(setup, fmt, shuffle=True)
    assert tok_t == tok_j
    for rid in lg_j:
        np.testing.assert_allclose(lg_t[rid], lg_j[rid], atol=ATOL_QUANT,
                                   rtol=0)
    assert any(tx.alloc.scale_of[p] != p for p in tx.alloc.scale_of)


def test_forked_quant_pages_within_row_bound(setup):
    """A request that forked cached int8 pages reads layer-0 K/V within
    the exact §14 row bound of an fp32 twin's (the forked scale pages are
    the ones its data pages were written with)."""
    prompts = _prompts(setup[0].vocab)
    exs = {}
    for kv in ("int8", "fp32"):
        ex = _executor(teng, setup, kv, shuffle=(kv == "int8"))
        eng, _ = _engine(teng, ex, 16)
        _submit(teng, eng, prompts[:2], n_new=1)
        eng.submit(teng.Request(9, arrival=1.0, prompt_len=len(prompts[1]),
                                max_new_tokens=40, ttft_slo=5.0,
                                tpot_slo=5.0, tokens=list(prompts[1])))
        while eng.requests.get(9) is None or eng.requests[9].generated < 2:
            eng.step()
        assert eng.requests[9].cached_context == 4 * PAGE
        exs[kv] = ex
    report = tnum.kv_parity_report(exs["int8"], exs["fp32"], 9)
    assert report[0].within(1.0), report[0]


def test_capacity_zero_is_bit_identical_to_no_cache(setup):
    out = []
    for capacity in (None, 0):
        ex = _executor(teng, setup, "fp32")
        eng, trace = _engine(teng, ex, capacity)
        _submit(teng, eng, _prompts(setup[0].vocab))
        first = {}
        while eng.has_work:
            eng.step()
            _first_logits(ex, first)
        out.append(({r: list(q.generated_tokens)
                     for r, q in eng.requests.items()}, first,
                    trace.fingerprint(), [(s.new_tokens, s.context)
                                          for s in eng.steps]))
    (tok_a, lg_a, fp_a, st_a), (tok_b, lg_b, fp_b, st_b) = out
    assert tok_a == tok_b and fp_a == fp_b and st_a == st_b
    assert lg_a.keys() == lg_b.keys()
    for rid in lg_a:
        assert np.array_equal(lg_a[rid], lg_b[rid])


def test_eviction_under_pool_pressure_keeps_tokens(setup):
    """A pool too small to hold the cache and every live table: the failed
    extend evicts cached leaves and retries, and the streams stay those of
    a roomy pool (and of the JAX executor in the same squeeze)."""
    rng = np.random.default_rng(7)
    prompts = [[int(x) for x in rng.integers(0, setup[0].vocab, 30)]
               for _ in range(4)]
    runs = {}
    for pkg, pages in ((teng, 48), (teng, 8), (jeng, 8)):
        ex = _executor(pkg, setup, "fp32", num_pages=pages)
        eng, _ = _engine(pkg, ex, 64)
        _submit(pkg, eng, prompts, gap=0.5)
        eng.run(max_steps=400)
        runs[(pkg.__name__, pages)] = (
            {r: list(q.generated_tokens) for r, q in eng.requests.items()},
            eng.prefix_cache.stats.evicted_pages)
        ex.alloc.check_invariants()
    roomy, tight = runs[("repro_torch.engine", 48)], \
        runs[("repro_torch.engine", 8)]
    assert tight[1] > 0 and roomy[1] == 0
    assert tight[0] == roomy[0] == runs[("repro.engine", 8)][0]


def test_attach_cache_refuses_another_allocator(setup):
    ex = _executor(teng, setup, "fp32")
    with pytest.raises(AssertionError, match="share the executor"):
        ex.attach_cache(TPrefixCache(8, block_size=PAGE))
    assert ex.prefix_cache is None


def test_shared_page_logits_match_cold_prefill(setup):
    """tests/test_real_executor.py's contract: the first-token logits of a
    prefill on top of two cache-shared pages equal a cold full prefill's
    (the port's own and the JAX dense model's)."""
    cfg, model = setup[0], setup[4]
    prm = [int(x) for x in np.random.default_rng(9).integers(0, cfg.vocab,
                                                             21)]
    cold_jax, _ = model.prefill(setup[2], jnp.asarray(prm, jnp.int32)[None],
                                max_len=64)
    ex = _executor(teng, setup, "fp32")
    eng, _ = _engine(teng, ex, 16)
    _submit(teng, eng, [prm], n_new=1)
    first = {}
    while eng.has_work:
        eng.step()
        _first_logits(ex, first)
    cold = first[0]
    cached = eng.prefix_cache.begin_request(1, list(prm), eng.now)
    assert cached == 2 * PAGE
    req = teng.Request(1, arrival=eng.now, prompt_len=len(prm),
                       max_new_tokens=1, ttft_slo=5.0, tpot_slo=5.0,
                       tokens=list(prm))
    req.cached_context = req.prefilled = cached
    plan = tcore.BatchPlan([tcore.BatchItem(1, len(prm) - cached,
                                            tcore.TaskKind.PREFILL)],
                           0.0, 0.0, 0, 0)
    _, emitted = ex.execute(plan, {1: req}, eng.now)
    warm = ex.last_logits[1]
    np.testing.assert_allclose(warm, cold, atol=ATOL_FP32, rtol=0)
    np.testing.assert_allclose(warm, np.asarray(cold_jax[0]), atol=1e-4,
                               rtol=1e-4)
    assert emitted[1] == int(np.argmax(cold))
    eng.prefix_cache.end_request(1)
    ex.alloc.check_invariants()
