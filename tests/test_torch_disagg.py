"""Live KV-page migration on the port's real executors (DESIGN.md §15),
against the JAX package's.

tests/test_disagg_migration.py's contract on the port: a request migrated
mid-decode from one executor to another continues its token stream bit for
bit as a single executor that never migrated (on the CPU), for fp32, int8
and fp8-e4m3 KV (values and scale rows move verbatim, never requantized),
by KV, by recompute and with leading blocks transferred by reference into
the destination's warm radix cache; both allocators' invariants hold after
every migration; an install the destination cannot host returns ``None``
and rolls back. Against the JAX package: the never-migrated streams are
the JAX executor's, and ``capture_kv`` of the same pool contents and
tables returns the same payload bytes (fp8 compared as bytes: numpy has no
fp8, so the port ships 1-byte pools as raw bytes), and installing one
payload leaves the same pages in both packages.

Every run is on fixed plans (the teacher-forced driver of
tests/test_disagg_migration.py), never on the wall clock.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.engine as jeng
import repro_torch.core as tcore
import repro_torch.engine as teng
from repro.configs import get_reduced
from repro.disagg import migration as jmig
from repro.kernels import quant as jq
from repro.models import ModelOpts, build_model
from repro_torch.cache import PrefixCache as TPrefixCache
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.data.traces import make_scenario
from repro_torch.disagg import migration as tmig
from repro_torch.engine.kv_manager import BlockAllocator as TAlloc
from repro_torch.kernels import quant as tq
from repro_torch.kernels.quant import raw_pool
from repro_torch.models import params_from_numpy

PAGE = 8
CHUNK = 12
FORMATS = ["fp32", "int8", "fp8_e4m3"]


def _need(fmt):
    if fmt == "fp8_e4m3" and not (jq.supports_fp8() and tq.supports_fp8()):
        pytest.skip("fp8_e4m3 needs float8_e4m3fn in both packages")


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_reduced("stablelm-3b"), window=None)
    tcfg = dataclasses.replace(torch_get_reduced("stablelm-3b"), window=None)
    params = build_model(cfg, ModelOpts(attn_impl="dense")).init(
        jax.random.PRNGKey(0))
    return (cfg, tcfg, params,
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))


def _executor(pkg, setup, kv_dtype="fp32", num_pages=96, max_pages=16):
    if pkg is jeng:
        return jeng.PagedTransformerExecutor(
            setup[0], setup[2], num_pages=num_pages, page_size=PAGE,
            max_pages_per_seq=max_pages, kv_dtype=kv_dtype,
            ragged_attention=True)
    return teng.PagedTransformerExecutor(
        setup[1], setup[3], num_pages=num_pages, page_size=PAGE,
        max_pages_per_seq=max_pages, kv_dtype=kv_dtype, device="cpu")


def _requests(pkg, vocab, n_req, n_new, seed=13, prefix=None):
    """tests/test_disagg_migration.py::_scenario_requests on a multi-turn
    trace (its own token ids, truncated), optionally behind a shared
    two-block prefix and a divergence token."""
    trace = sorted(make_scenario("multi-turn", rps=8.0, duration=2.0,
                                 seed=seed), key=lambda t: t.arrival)
    out = []
    for i, tr in enumerate(trace[:n_req]):
        plen = max(10, min(tr.prompt_len, 30 + 3 * i))
        toks = [t % vocab for t in tr.tokens[:plen]]
        if prefix is not None:
            toks = prefix + [(100 + i) % vocab] + toks[:12]
        out.append(pkg.Request(i, 0.0, len(toks), n_new, ttft_slo=10.0,
                               tpot_slo=10.0, tokens=toks))
    return out


def _step(pkg, ex, requests, owned, steps):
    """One teacher-forced step over ``owned``: a decode token each, or a
    prefill chunk of up to CHUNK tokens."""
    core = jcore if pkg is jeng else tcore
    items = []
    for rid in owned:
        r = requests[rid]
        if not r.active:
            continue
        if r.state is pkg.RequestState.DECODE:
            items.append(core.BatchItem(rid, 1, core.TaskKind.DECODE))
        else:
            items.append(core.BatchItem(
                rid, min(CHUNK, r.prompt_len - r.prefilled),
                core.TaskKind.PREFILL))
    if not items:
        return
    plan = core.BatchPlan(items, 0.0, 0.0, 0, 0)
    _, emitted = ex.execute(plan, requests, float(steps))
    assert not ex.last_deferred, "pool sized to never defer"
    for it in plan.items:
        req = requests[it.req_id]
        if it.req_id in emitted:
            req.generated_tokens.append(emitted[it.req_id])
        req.advance(it.n_tokens, float(steps))


def _oracle(pkg, setup, kv_dtype, requests):
    """The streams of a single executor that never migrates."""
    ex = _executor(pkg, setup, kv_dtype)
    world = {r.req_id: r for r in requests}
    steps = 0
    while any(r.active for r in world.values()):
        _step(pkg, ex, world, list(world), steps)
        steps += 1
    for rid in world:
        ex.release(rid)
    ex.alloc.check_invariants()
    return {rid: list(r.generated_tokens) for rid, r in world.items()}


def _bytes(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _check_installed(dst, rid, payload, nref):
    """Materialized pages (and their scale pages) are a bitwise scatter of
    the payload; referenced pages are shared with the radix tree."""
    tbl = dst.alloc.tables[rid]
    assert len(tbl) == payload.n_pages
    assert dst.alloc.lens[rid] == payload.n_tokens
    for p in tbl[:nref]:
        assert dst.alloc.refcount[p] >= 2
    if len(tbl) > nref:
        idx = torch.as_tensor(tbl[nref:])
        for pool, rows in ((dst.k_pages, payload.k), (dst.v_pages, payload.v)):
            assert np.array_equal(raw_pool(pool)[:, idx].numpy(),
                                  rows[:, nref:])
        if payload.k_scales is not None:
            sidx = torch.as_tensor(dst.alloc.scale_table(rid)[nref:])
            assert np.array_equal(dst.k_scales[:, sidx].numpy(),
                                  payload.k_scales[:, nref:])
            assert np.array_equal(dst.v_scales[:, sidx].numpy(),
                                  payload.v_scales[:, nref:])


def _migrating_run(setup, kv_dtype, requests, migrate_at, *, recompute=(),
                   dst_cache_pages=0, warm_tokens=None, shuffle=False):
    """Drive on src, move each request at its ``migrate_at`` decode count
    (by recompute for those in ``recompute``, else by KV), finish on dst.
    Returns (streams, reference-transferred pages, payload bytes)."""
    src = _executor(teng, setup, kv_dtype)
    dst = _executor(teng, setup, kv_dtype)
    if shuffle:
        # scale ids no longer equal page ids on either side
        for ex, seed in ((src, 1), (dst, 2)):
            np.random.default_rng(seed).shuffle(ex.alloc._free_scales)
    cache = None
    if dst_cache_pages:
        cache = TPrefixCache(dst_cache_pages, block_size=PAGE,
                             alloc=dst.alloc)
        dst.attach_cache(cache)
    world = {r.req_id: r for r in requests}
    owner = {rid: "src" for rid in world}
    steps = 0
    if warm_tokens is not None:
        # the destination computes the shared prompt once and publishes it
        wid = 10_000
        warm = {wid: teng.Request(wid, 0.0, len(warm_tokens), 1,
                                  ttft_slo=10.0, tpot_slo=10.0,
                                  tokens=list(warm_tokens))}
        while warm[wid].active:
            _step(teng, dst, warm, [wid], steps)
            steps += 1
        cache.insert_request(wid, list(warm_tokens), float(steps))
        cache.end_request(wid)
        dst.release(wid)
    nref_total, wire = 0, 0
    while any(r.active for r in world.values()):
        for side, ex in (("src", src), ("dst", dst)):
            _step(teng, ex, world, [r for r, o in owner.items() if o == side],
                  steps)
        for rid, r in world.items():
            if (owner[rid] != "src" or r.state is not teng.RequestState.DECODE
                    or r.generated < migrate_at[rid] or not r.active):
                continue
            owner[rid] = "dst"
            if rid in recompute:
                src.release(rid)             # nothing crosses the wire
                r.preempt_requeue()
                assert r.prefilled == 0
                continue
            payload = tmig.capture_kv(src, rid)
            assert payload.n_tokens == src.alloc.lens[rid]
            src.release(rid)
            nref = tmig.install_kv_pages(dst, cache, r, payload,
                                         float(steps))
            assert nref is not None, "destination sized to host the table"
            nref_total += nref
            wire += sum(a[:, nref:].nbytes for a in (
                payload.k, payload.v, payload.k_scales, payload.v_scales)
                if a is not None)
            src.alloc.check_invariants()
            dst.alloc.check_invariants()
            _check_installed(dst, rid, payload, nref)
        steps += 1
    for rid, o in owner.items():
        (src if o == "src" else dst).release(rid)
        if cache is not None and o == "dst":
            cache.end_request(rid)
    src.alloc.check_invariants()
    dst.alloc.check_invariants()
    return ({rid: list(r.generated_tokens) for rid, r in world.items()},
            nref_total, wire)


MIGRATE_AT = {0: 1, 1: 3, 2: 5}


@pytest.fixture(scope="module")
def oracles(setup):
    """Never-migrated streams by package and format (one JAX run each)."""
    vocab = setup[0].vocab
    out = {}
    for fmt in FORMATS:
        if fmt == "fp8_e4m3" and not (jq.supports_fp8()
                                      and tq.supports_fp8()):
            continue
        for pkg in (jeng, teng):
            out[(pkg.__name__, fmt)] = _oracle(
                pkg, setup, fmt, _requests(pkg, vocab, 3, 8))
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_kv_migration_stream_equals_never_migrated_run(setup, oracles, fmt):
    """Each request moves at another decode count; int8 and fp8 with
    permuted scale ids on both sides."""
    _need(fmt)
    streams, _, _ = _migrating_run(setup, fmt,
                                   _requests(teng, setup[0].vocab, 3, 8),
                                   MIGRATE_AT, shuffle=(fmt != "fp32"))
    tok_t = oracles[("repro_torch.engine", fmt)]
    tok_j = oracles[("repro.engine", fmt)]
    assert streams == tok_t == tok_j
    assert all(len(s) == 8 for s in streams.values())


def test_recompute_migration_equals_never_migrated_run(setup, oracles):
    streams, nref, wire = _migrating_run(
        setup, "fp32", _requests(teng, setup[0].vocab, 3, 8), MIGRATE_AT,
        recompute={0, 2})
    assert streams == oracles[("repro_torch.engine", "fp32")]
    assert nref == 0 and wire > 0              # request 1 moved by KV


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_shared_prefix_migrates_by_reference(setup, fmt):
    """The destination's cache holds request 0's prompt and the two-block
    prefix request 1 shares with it: those blocks move as references (no
    bytes on the wire), and both streams equal the never-migrated run."""
    vocab = setup[0].vocab
    prefix = [int(x) for x in np.random.default_rng(2).integers(
        0, vocab, 2 * PAGE)]
    mk = lambda pkg: _requests(pkg, vocab, 2, 6, seed=21, prefix=prefix)
    reqs = mk(teng)
    oracle = _oracle(teng, setup, fmt, mk(teng))
    streams, nref, wire = _migrating_run(
        setup, fmt, reqs, {0: 2, 1: 4}, dst_cache_pages=16,
        warm_tokens=list(reqs[0].tokens))
    assert nref == reqs[0].prompt_len // PAGE + len(prefix) // PAGE
    assert streams == oracle
    # the wire carried only the materialized pages (the KV holds the
    # prompt and every emitted token but the last, not yet fed back)
    full = sum(-(-(r.prompt_len + k - 1) // PAGE)
               for r, k in zip(reqs, (2, 4)))
    per_page = 2 * setup[1].n_layers * PAGE * setup[1].n_kv_heads * \
        setup[1].head_dim * (4 if fmt == "fp32" else 1)
    per_page += 0 if fmt == "fp32" else \
        2 * setup[1].n_layers * PAGE * setup[1].n_kv_heads * 4
    assert wire == (full - nref) * per_page


@pytest.mark.parametrize("fmt", FORMATS)
def test_payload_bytes_equal_jax_capture(setup, oracles, fmt):
    """The same pools and tables give the same payload bytes in both
    packages, scale rows included, and the same pages once installed. The
    pool contents are made identical first (the JAX executor's pools and
    allocator state at MIGRATE_AT copied into the port's executor), since
    the two packages' fp32 GEMMs need not agree to the last bit."""
    _need(fmt)
    vocab = setup[0].vocab
    jx = _executor(jeng, setup, fmt)
    world = {r.req_id: r for r in _requests(jeng, vocab, 3, 8)}
    steps = 0
    while world[2].generated < MIGRATE_AT[2]:
        _step(jeng, jx, world, list(world), steps)
        steps += 1
    tx = _executor(teng, setup, fmt)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a = getattr(jx, name)
        if a is None:
            continue
        dst = raw_pool(getattr(tx, name))
        dst.copy_(torch.from_numpy(np.array(a).view(dst.numpy().dtype)))
    for attr in ("tables", "lens", "refcount", "scale_of"):
        setattr(tx.alloc, attr, {k: (list(v) if isinstance(v, list) else v)
                                 for k, v in getattr(jx.alloc, attr).items()})
    tx.alloc._free = list(jx.alloc._free)
    tx.alloc._free_scales = list(jx.alloc._free_scales)
    for rid in world:
        pj, pt = jmig.capture_kv(jx, rid), tmig.capture_kv(tx, rid)
        assert (pt.n_tokens, pt.block_size, pt.n_pages) == \
            (pj.n_tokens, pj.block_size, pj.n_pages)
        assert pt.dtype == tx.k_pages.dtype
        for a, b in ((pt.k, pj.k), (pt.v, pj.v), (pt.k_scales, pj.k_scales),
                     (pt.v_scales, pj.v_scales)):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.shape == b.shape
                assert np.array_equal(_bytes(a), _bytes(b))
        # install the same payload into fresh executors of both packages
        dj, dt = _executor(jeng, setup, fmt), _executor(teng, setup, fmt)
        rj = jeng.Request(rid, 0.0, world[rid].prompt_len, 8,
                          ttft_slo=10.0, tpot_slo=10.0,
                          tokens=list(world[rid].tokens))
        rt = teng.Request(rid, 0.0, world[rid].prompt_len, 8,
                          ttft_slo=10.0, tpot_slo=10.0,
                          tokens=list(world[rid].tokens))
        assert jmig.install_kv_pages(dj, None, rj, pj, 0.0) == \
            tmig.install_kv_pages(dt, None, rt, pt, 0.0) == 0
        assert dj.alloc.tables == dt.alloc.tables
        idx = dt.alloc.tables[rid]
        for a, b in ((dj.k_pages, dt.k_pages), (dj.v_pages, dt.v_pages)):
            assert np.array_equal(_bytes(np.asarray(a)[:, idx]),
                                  _bytes(raw_pool(b)[:, idx].numpy()))
    # the never-migrated streams agree across packages too
    assert oracles[("repro_torch.engine", fmt)] == \
        oracles[("repro.engine", fmt)]


def test_install_rejects_unhostable_table_and_rolls_back(setup):
    src = _executor(teng, setup)
    world = {0: _requests(teng, setup[0].vocab, 1, 4, seed=5)[0]}
    steps = 0
    while world[0].state is not teng.RequestState.DECODE:
        _step(teng, src, world, [0], steps)
        steps += 1
    payload = tmig.capture_kv(src, 0)
    assert payload.n_pages >= 2
    src.release(0)
    cases = {
        "table cap": _executor(teng, setup, max_pages=payload.n_pages - 1),
        "pool": _executor(teng, setup, num_pages=payload.n_pages - 1),
        "dtype": _executor(teng, setup, kv_dtype="int8"),
    }
    for name, ex in cases.items():
        free0 = list(ex.alloc._free)
        assert tmig.install_kv_pages(ex, None, world[0], payload, 0.0) \
            is None, name
        assert 0 not in ex.alloc.tables and ex.alloc._free == free0, name
        ex.alloc.check_invariants()
    # a pool with a cache evicts its leaves before it gives up
    ex = _executor(teng, setup, num_pages=payload.n_pages + 2)
    cache = TPrefixCache(8, block_size=PAGE, alloc=ex.alloc)
    ex.attach_cache(cache)
    filler = list(range(3 * PAGE))
    ex.alloc.extend(77, len(filler))
    cache.insert_request(77, filler, 0.0)
    cache.end_request(77)
    assert ex.alloc.free_blocks < payload.n_pages
    assert tmig.install_kv_pages(ex, cache, world[0], payload, 1.0) == 0
    assert cache.stats.evicted_pages > 0
    _check_installed(ex, 0, payload, 0)
    ex.alloc.check_invariants()


# ---------------------------------------------------------------------------
# randomized interleavings on a tiny data plane (the allocator contract)
# ---------------------------------------------------------------------------

class _TinyExec:
    """A ``BlockAllocator`` and torch pools (scale pools when quantized),
    with the executor's COW drain: enough for capture and install."""

    def __init__(self, num_pages, quant, block=4):
        self.alloc = TAlloc(num_pages, block)
        dt = torch.int8 if quant else torch.float32
        self.k_pages = torch.zeros((1, num_pages, block, 1, 2), dtype=dt)
        self.v_pages = torch.zeros_like(self.k_pages)
        self.k_scales = self.v_scales = None
        if quant:
            self.k_scales = torch.zeros((1, num_pages, block, 1))
            self.v_scales = torch.zeros_like(self.k_scales)
        self.max_pages = num_pages
        self.block = block

    def _mirror_cow_batched(self):
        old, new, s_old, s_new = self.alloc.pop_cow_events_batched()
        for pool in (self.k_pages, self.v_pages):
            pool[:, new] = pool[:, old]
        if self.k_scales is not None:
            for pool in (self.k_scales, self.v_scales):
                pool[:, s_new] = pool[:, s_old]

    def grow(self, rid, n, fill):
        if self.alloc.extend(rid, n) is None:
            return False
        idx = self.alloc.tables[rid]
        self.k_pages[:, idx] = fill
        self.v_pages[:, idx] = -fill
        if self.k_scales is not None:
            sidx = self.alloc.scale_table(rid)
            self.k_scales[:, sidx] = float(fill)
            self.v_scales[:, sidx] = float(fill) + 0.5
        return True

    def release(self, rid):
        self.alloc.release(rid)


@dataclasses.dataclass
class _FakeReq:
    req_id: int
    tokens: list


COMMON = list(range(400, 480))
OPS = ("grow", "migrate", "migrate", "release_dst", "evict")


def _run_migration_program(program, num_pages, quant):
    """(op, rid, n) triples against a src/dst pair; both allocators'
    invariants after every op; every page back at the end."""
    src, dst = _TinyExec(num_pages, quant), _TinyExec(num_pages, quant)
    cache = TPrefixCache(max(2, num_pages // 2), block_size=dst.block,
                         alloc=dst.alloc)
    toks = {}
    for op, rid, n in program:
        if op == "grow":
            if rid not in dst.alloc.tables and src.grow(rid, n, rid + 1):
                toks[rid] = COMMON[:src.alloc.lens[rid]]
        elif op == "migrate" and rid in src.alloc.tables \
                and rid not in dst.alloc.tables:
            payload = tmig.capture_kv(src, rid)
            src.release(rid)
            nref = tmig.install_kv_pages(dst, cache, _FakeReq(rid, toks[rid]),
                                         payload, 0.0)
            if nref is not None:
                _check_installed(dst, rid, payload, nref)
        elif op == "release_dst" and rid in dst.alloc.tables:
            cache.end_request(rid)
            dst.release(rid)
        elif op == "evict":
            cache.evict_for(n)
        src.alloc.check_invariants()
        dst.alloc.check_invariants()
    for rid in list(src.alloc.tables):
        src.release(rid)
    for rid in list(dst.alloc.tables):
        cache.end_request(rid)
        dst.release(rid)
    cache.evict_for(10 ** 9)
    assert len(src.alloc._free) == len(dst.alloc._free) == num_pages


def test_migration_interleavings_seeded():
    for seed in range(30):
        rng = random.Random(seed)
        program = [(rng.choice(OPS), rng.randrange(4), rng.randint(1, 9))
                   for _ in range(rng.randint(1, 30))]
        _run_migration_program(program, rng.randint(8, 24), seed % 2 == 0)


def test_migration_interleavings_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @st.composite
    def programs(draw):
        n = draw(st.integers(0, 30))
        return [(draw(st.sampled_from(OPS)), draw(st.integers(0, 3)),
                 draw(st.integers(1, 9))) for _ in range(n)]

    @hyp.given(programs(), st.integers(8, 24), st.booleans())
    @hyp.settings(max_examples=60, deadline=None, derandomize=True,
                  database=None)
    def run(program, num_pages, quant):
        if not program:                  # an empty program: nothing to hold
            return
        _run_migration_program(program, num_pages, quant)

    run()
