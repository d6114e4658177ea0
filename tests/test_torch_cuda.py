"""The port's CUDA kernels and executor paths on the card.

Marked ``cuda``: each test skips with a reason where no CUDA device is
present (decided inside the ``cuda`` fixture, never at import). On a
machine with the card and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports neither JAX nor the JAX package: the card's machine has neither.
Each kernel is held against its plain version on the same card at 1e-4
(fp32 sums over at most a few hundred keys, online-softmax rescaling
against a one-pass softmax), over the shapes the serving paths give it:
D = 16 (reduced configs) and 80 (full width), GQA groups 1-8, pages of 16
and 128, with and without a window; pad sequences and stream padding for
the ragged kernel, Tq of 1 (decode), γ+1 (verify) and chunks for the
batched one. The executor's sequential, multi-step and speculative paths
give the CPU's tokens, and their horizons never wait for the device.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core import LinearCostModel, make_scheduler
from repro_torch.engine import (Engine, EngineConfig,
                                PagedTransformerExecutor, Request)
from repro_torch.engine.spec_decode import SmallModelDraft, TruncatedSelfDraft
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ragged)
from repro_torch.kernels.ref import (paged_attention_ragged_ref,
                                     paged_attention_ref)
from repro_torch.models import init_params

ATOL = 1e-4

# (q_lens, pos0, H, Hkv, D, page, n_pages, window); q_len 0 = pad sequence
LAYOUTS = [
    ([5, 1, 3], [10, 20, 0], 4, 2, 16, 16, 3, None),
    ([1, 1, 1, 1], [7, 12, 0, 33], 8, 1, 64, 32, 2, None),      # G = 8
    ([16], [8], 4, 4, 32, 16, 4, None),                         # G = 1
    ([8, 2, 1], [4, 9, 30], 8, 2, 16, 8, 5, 12),                # window
    ([40, 1, 0, 1, 17], [90, 200, 0, 379, 0], 32, 8, 80, 128, 3, 100),
    ([33, 1, 1], [0, 15, 250], 32, 8, 80, 16, 20, None),        # D=80, p16
    ([3, 0, 2], [0, 0, 60], 4, 4, 16, 16, 4, 16),               # G = 1, SWA
]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(q_lens, pos0, H, Hkv, D, page, n_pages, device, seed=0, gap=3):
    rng = np.random.default_rng(seed)
    S = len(q_lens)
    P = S * n_pages + 1
    ql = np.asarray(q_lens, np.int32)
    ctx = np.minimum(np.asarray(pos0, np.int32) + ql, page * n_pages)
    ctx = np.where(ql > 0, ctx, 0).astype(np.int32)
    arrs = {
        "q": rng.standard_normal((int(ql.sum()) + gap, H, D)),
        "k": rng.standard_normal((P, page, Hkv, D)),
        "v": rng.standard_normal((P, page, Hkv, D)),
        "bt": 1 + rng.permutation(S * n_pages).reshape(S, n_pages),
        "ctx": ctx,
        "qs": np.concatenate([[0], np.cumsum(ql)[:-1]]),
        "ql": ql,
        "p0": np.maximum(np.minimum(np.asarray(pos0), ctx - ql), 0),
    }
    out = {}
    for k, a in arrs.items():
        dt = torch.float32 if k in ("q", "k", "v") else torch.int32
        out[k] = torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return [out[k] for k in ("q", "k", "v", "bt", "ctx", "qs", "ql", "p0")]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[2:7]}")
def test_kernel_matches_plain_version(cuda, layout):
    *shape, window = layout
    args = _inputs(*shape, cuda)
    before = paged_attention_ragged.launches
    got = paged_attention_ragged(*args, window=window)
    torch.cuda.synchronize()
    assert paged_attention_ragged.launches == before + 1
    want = paged_attention_ragged_ref(*args, window=window)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL
    n_rows = sum(layout[0])
    assert torch.all(got[n_rows:] == 0), "stream padding rows must be 0"


@pytest.mark.parametrize("layout", LAYOUTS[3:5], ids=["swa", "d80"])
def test_kernel_never_reads_outside_visible_keys(cuda, layout):
    """NaN in every slot at or past a sequence's context (and before its
    window) leaves the output bit-identical."""
    *shape, window = layout
    q, k, v, bt, ctx, qs, ql, p0 = _inputs(*shape, cuda)
    clean = paged_attention_ragged(q, k, v, bt, ctx, qs, ql, p0,
                                   window=window)
    page, n_pages = k.shape[1], bt.shape[1]
    k2, v2 = k.clone(), v.clone()
    kv = torch.arange(n_pages * page, device=cuda)
    for s in range(bt.shape[0]):
        lo = 0 if window is None else max(0, int(p0[s]) - window + 1)
        bad = (kv < lo) | (kv >= int(ctx[s]))
        pg = bt[s].long()[kv[bad] // page]
        k2[pg, kv[bad] % page] = float("nan")
        v2[pg, kv[bad] % page] = float("nan")
    dirty = paged_attention_ragged(q, k2, v2, bt, ctx, qs, ql, p0,
                                   window=window)
    assert torch.equal(clean, dirty)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, bt, ctx, qs, ql, p0 = _inputs(*LAYOUTS[0][:-1], cuda)
    with pytest.raises(TypeError):
        paged_attention_ragged(q.double(), k, v, bt, ctx, qs, ql, p0)
    with pytest.raises(ValueError):
        paged_attention_ragged(q, k, v, bt.cpu(), ctx, qs, ql, p0)
    with pytest.raises(ValueError):
        paged_attention_ragged(q, k, v, bt, ctx, qs, ql, p0, window=0)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "stablelm-3b"])
def test_fused_executor_card_matches_cpu(cuda, arch):
    """Reduced configs, one set of weights: the fused step on the card gives
    the CPU's greedy tokens, logits within 1e-4, and one attention launch
    per layer per dispatch."""
    cfg = get_reduced(arch)
    if arch == "stablelm-3b":
        cfg = dataclasses.replace(cfg, window=None)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        ex = PagedTransformerExecutor(cfg, params, num_pages=64,
                                      page_size=16, max_pages_per_seq=8,
                                      capture_logits=True, device=dev)
        eng = Engine(make_scheduler("fairbatching", LinearCostModel(
            a=1e-4, b=1e-6, c=1e-10)), ex, EngineConfig(5.0, 5.0))
        rng = np.random.default_rng(3)
        for i in range(6):
            plen = int(rng.integers(1, 90))
            eng.submit(Request(i, arrival=0.002 * i, prompt_len=plen,
                               max_new_tokens=6, ttft_slo=5.0, tpot_slo=5.0,
                               tokens=[int(x) for x in rng.integers(
                                   0, cfg.vocab, plen)]))
        launches0, first = paged_attention_ragged.launches, {}
        while eng.has_work:
            eng.step()
            for rid, lg in ex.last_logits.items():
                first.setdefault(rid, lg)
        runs[dev] = ({r: q.generated_tokens for r, q in eng.requests.items()},
                     first, paged_attention_ragged.launches - launches0,
                     ex.n_dispatches)
    (tok_g, lg_g, n_g, d_g), (tok_c, lg_c, n_c, _) = runs["cuda"], runs["cpu"]
    assert tok_g == tok_c
    for rid in lg_c:
        np.testing.assert_allclose(lg_g[rid], lg_c[rid], atol=ATOL, rtol=0)
    assert n_c == 0 and n_g == cfg.n_layers * d_g > 0


# (B, Tq, H, Hkv, D, page, n_pages, window): the batched kernel's layouts
BATCHED = [
    (2, 1, 4, 2, 32, 16, 3, None),        # decode
    (3, 1, 8, 1, 64, 32, 4, None),        # MQA decode, G = 8
    (1, 16, 4, 4, 32, 16, 4, None),       # prefill chunk, G = 1
    (2, 8, 8, 2, 16, 8, 5, 12),           # SWA chunk
    (5, 1, 32, 8, 80, 128, 3, None),      # full-width decode
    (4, 4, 32, 8, 80, 16, 20, None),      # verify, γ = 3
    (1, 48, 32, 8, 80, 128, 3, 100),      # sequential chunk, window
]


def _batched(b, tq, h, hkv, d, page, n_pages, device, seed=0):
    """Distinct pages per sequence (page 0 is trash); contexts spread over
    the table, the last row of each sequence at its context's end, and the
    last sequence with an empty context (every row sees no key)."""
    rng = np.random.default_rng(seed)
    total = page * n_pages
    ctx = np.minimum([(total * (i + 1)) // (b + 1) + tq for i in range(b)],
                     total)
    ctx[-1] = 0 if b > 1 else ctx[-1]
    arrs = {"q": rng.standard_normal((b, tq, h, d)),
            "k": rng.standard_normal((b * n_pages + 1, page, hkv, d)),
            "v": rng.standard_normal((b * n_pages + 1, page, hkv, d)),
            "bt": 1 + rng.permutation(b * n_pages).reshape(b, n_pages),
            "ctx": ctx, "qs": np.maximum(ctx - tq, 0)}
    return [torch.as_tensor(np.asarray(arrs[k]), device=device,
                            dtype=torch.float32 if k in ("q", "k", "v")
                            else torch.int32)
            for k in ("q", "k", "v", "bt", "ctx", "qs")]


@pytest.mark.parametrize("layout", BATCHED, ids=lambda l: f"{l[:5]}")
def test_batched_kernel_matches_plain_version(cuda, layout):
    *shape, window = layout
    args = _batched(*shape, cuda)
    before = paged_attention.launches
    got = paged_attention(*args, window=window)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_ref(*args, window=window)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL
    if shape[0] > 1:
        assert torch.all(got[-1] == 0), "a row with no visible key is 0"


@pytest.mark.parametrize("layout", [BATCHED[3], BATCHED[5], BATCHED[6]],
                         ids=["swa", "verify", "chunk"])
def test_batched_kernel_never_reads_outside_visible_keys(cuda, layout):
    *shape, window = layout
    q, k, v, bt, ctx, qs = _batched(*shape, cuda)
    clean = paged_attention(q, k, v, bt, ctx, qs, window=window)
    page, n_pages = k.shape[1], bt.shape[1]
    k2, v2 = k.clone(), v.clone()
    kv = torch.arange(n_pages * page, device=cuda)
    for b in range(bt.shape[0]):
        lo = 0 if window is None else max(0, int(qs[b]) - window + 1)
        bad = (kv < lo) | (kv >= int(ctx[b]))
        pg = bt[b].long()[kv[bad] // page]
        k2[pg, kv[bad] % page] = float("nan")
        v2[pg, kv[bad] % page] = float("nan")
    assert torch.equal(clean, paged_attention(q, k2, v2, bt, ctx, qs,
                                              window=window))


def test_batched_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, bt, ctx, qs = _batched(*BATCHED[0][:-1], cuda)
    before = paged_attention.launches
    with pytest.raises(TypeError):
        paged_attention(q.double(), k, v, bt, ctx, qs)
    with pytest.raises(ValueError):
        paged_attention(q.transpose(1, 2), k, v, bt, ctx, qs)
    with pytest.raises(ValueError):
        paged_attention(q, k, v, bt, ctx.cpu(), qs)
    with pytest.raises(ValueError):
        paged_attention(q[:1], k, v, bt, ctx, qs)
    assert paged_attention.launches == before


def _serve_paths(cfg, params, dev, *, mode="fused", horizon=1, gamma=0,
                 draft=None, capture=False):
    ex = PagedTransformerExecutor(cfg, params, num_pages=64, page_size=16,
                                  max_pages_per_seq=8, mode=mode,
                                  capture_logits=capture, device=dev)
    if draft is not None:
        ex.set_draft(draft)
    eng = Engine(make_scheduler("fairbatching", LinearCostModel(
        a=1e-4, b=1e-6, c=1e-10)), ex, EngineConfig(
            5.0, 5.0, commit_horizon=horizon, speculate=gamma))
    rng = np.random.default_rng(5)
    for i in range(4):
        plen = int(rng.integers(3, 60))
        eng.submit(Request(i, arrival=0.0, prompt_len=plen,
                           max_new_tokens=9, ttft_slo=5.0, tpot_slo=5.0,
                           tokens=[int(x) for x in rng.integers(
                               0, cfg.vocab, plen)]))
    first = {}
    while eng.has_work:
        eng.step()
        for rid, lg in ex.last_logits.items():
            first.setdefault(rid, lg)
    return ({r: q.generated_tokens for r, q in eng.requests.items()}, first,
            ex)


def _no_sync(fn):
    """``fn`` with torch's sync debug mode set to raise on any
    device→host synchronisation while it runs."""
    def run(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


@pytest.mark.parametrize("path", ["sequential", "multi", "self_draft",
                                  "small_draft"])
def test_decode_paths_card_match_cpu(cuda, path):
    """Reduced h2o-danube-1.8b (window 16), one set of weights: each path
    gives the CPU's greedy tokens on the card, the batched kernel launches
    on it and never on the CPU, and a committed horizon or speculative
    round runs to its one final copy without a device→host sync."""
    cfg = get_reduced("h2o-danube-1.8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = init_params(dcfg, torch.Generator().manual_seed(7), "cpu")
    kw = {"sequential": dict(mode="sequential", capture=True),
          "multi": dict(horizon=4),
          "self_draft": dict(gamma=2, horizon=3),
          "small_draft": dict(gamma=2, horizon=3)}[path]
    runs = {}
    for dev in ("cuda", "cpu"):
        draft = {"self_draft": lambda: TruncatedSelfDraft(1),
                 "small_draft": lambda: SmallModelDraft(dcfg, dparams)}.get(
                     path, lambda: None)()
        before = paged_attention.launches
        if dev == "cuda":
            orig = PagedTransformerExecutor._multi_decode_step, \
                PagedTransformerExecutor._spec_multi_step
            PagedTransformerExecutor._multi_decode_step = _no_sync(orig[0])
            PagedTransformerExecutor._spec_multi_step = _no_sync(orig[1])
        try:
            toks, first, ex = _serve_paths(cfg, params, dev, draft=draft,
                                           **kw)
        finally:
            if dev == "cuda":
                (PagedTransformerExecutor._multi_decode_step,
                 PagedTransformerExecutor._spec_multi_step) = orig
        runs[dev] = (toks, first, paged_attention.launches - before,
                     ex.compile_keys)
    (tok_g, lg_g, n_g, keys_g), (tok_c, lg_c, n_c, keys_c) = (runs["cuda"],
                                                              runs["cpu"])
    assert tok_g == tok_c
    assert keys_g == keys_c
    for rid in lg_c:
        np.testing.assert_allclose(lg_g[rid], lg_c[rid], atol=ATOL, rtol=0)
    assert n_c == 0 and n_g > 0
    if path != "sequential":
        assert any(k[0] in ("multi", "spec") for k in keys_g)
