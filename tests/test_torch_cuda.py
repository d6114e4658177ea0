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
batched one. The quantized ragged kernel (B2) is held the same way for
int8 and fp8-e4m3 pools: both it and its plain version read the same
dequantized values, so only the fp32 summation order differs. The
executor's sequential, multi-step and speculative paths give the CPU's
tokens, fp32 and int8, and their horizons never wait for the device.
The attention body's split-KV decode tiles are held at split boundaries
(contexts of split - 1, split and split + 1 keys (splits of 512), a
window starting inside a split, splits with no visible key), next to
chunk tiles and on both sides of the decode/chunk threshold, for pages of
16 and 128, with poison and a bitwise repeat: B2 in int8 and fp8 (D = 80,
128 and D % 16 != 0, the 4-byte copies), B1 in fp32 on the same cases, and B3
at Tq x G on both sides of 16, with chunk tiles whose keys split, and
with rows that see no key written as exact zeros into an output that
starts as NaN.
The expert GEMM (B4) is held against its plain version at 2e-4·√K (the
JAX suite's bar) over both bodies and every row tile and split path (C =
1, 4, 8, 20, 33, 64, 160, 640, 960 at mixtral-8x7b's and kimi-k2's
widths), K and N off the slab and the tile, N % 4 != 0 and an unaligned
x (the 4-byte copies), and repeats bitwise; the capacity MoE
FFN with top-8 repeats bitwise run to run (its combine uses no atomics);
the MoE executor on the card gives the CPU's tokens under both
``moe_impl``s, B4 launching three times per layer and router chunk.
The SSD chunk scan (B5) is held against its plain version at 1e-4 ×
max(1, max|plain|) (fp32 sums over at most 128 steps and 128 state
columns, in another order) over chunk lengths 5-128 (on both sides of
its 32-step slabs and 32-row quarters), the JAX suite's sweep,
mamba2-1.3b's widths (H 64, P 64, N 128) and its reduced config's, head
counts its head groups do not divide, 256 chunks, with and without an
initial state, and repeats bitwise; it writes every row of an output
that starts as NaN; the reduced
mamba2-1.3b ``DecoderLM`` on the card gives the CPU's greedy tokens, B5
launching once per layer per prefill and never in a decode step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import MoEConfig, get_reduced
from repro_torch.core import LinearCostModel, make_scheduler
from repro_torch.engine import (Engine, EngineConfig,
                                PagedTransformerExecutor, Request)
from repro_torch.engine.numerics import ModelTimedExecutor
from repro_torch.engine.spec_decode import SmallModelDraft, TruncatedSelfDraft
from repro_torch.kernels.mamba2_scan import mamba_chunk_scan
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.paged_attention import (
    paged_attention, paged_attention_ragged, paged_attention_ragged_quant)
from repro_torch.kernels.quant import kv_quant_spec, quantize_kv
from repro_torch.kernels.ref import (mamba_chunk_scan_ref, moe_gmm_ref,
                                     paged_attention_ragged_quant_ref,
                                     paged_attention_ragged_ref,
                                     paged_attention_ref)
from repro_torch.models import build_model, init_params
from repro_torch.models.moe import moe_capacity, router_chunks
from repro_torch.models.weights import params_to

ATOL = 1e-4
# card vs CPU logits under quantized KV: K/V rows that differ by fp32
# noise between the devices may quantize an element to the neighbouring
# step (absmax / 127 for int8), which moves the logits by ~1e-3 at the
# reduced sizes; the tokens must still be equal
ATOL_QUANT_LOGITS = 1e-2

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


# -- the quantized ragged kernel (B2) ------------------------------------

def _quant_inputs(fmt, layout, device, seed=0):
    """``_inputs``' step with its pools quantized on the card and scale
    pages at permuted ids, so a wrong scale table reads wrong scales."""
    q, k, v, bt, ctx, qs, ql, p0 = _inputs(*layout, device, seed=seed)
    spec = kv_quant_spec(fmt, device)
    kq, ks = quantize_kv(k, spec)
    vq, vs = quantize_kv(v, spec)
    perm = torch.as_tensor(np.random.default_rng(seed + 1).permutation(
        k.shape[0]), device=device)
    inv = torch.argsort(perm)
    st = perm[bt.long()].to(torch.int32)
    return [q, kq, vq, ks[inv].contiguous(), vs[inv].contiguous(), bt, st,
            ctx, qs, ql, p0]


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[2:7]}")
def test_quant_kernel_matches_plain_version(cuda, fmt, layout):
    *shape, window = layout
    args = _quant_inputs(fmt, shape, cuda)
    before = paged_attention_ragged_quant.launches
    got = paged_attention_ragged_quant(*args, window=window)
    torch.cuda.synchronize()
    assert paged_attention_ragged_quant.launches == before + 1
    want = paged_attention_ragged_quant_ref(*args, window=window)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL
    assert torch.all(got[sum(layout[0]):] == 0), "stream padding rows are 0"


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("layout", LAYOUTS[3:5], ids=["swa", "d80"])
def test_quant_kernel_never_reads_outside_visible_keys(cuda, fmt, layout):
    """NaN in every scale slot a row may not read and 0x7F bytes (NaN in
    e4m3fn) in those value slots leave the output bit-identical."""
    *shape, window = layout
    args = _quant_inputs(fmt, shape, cuda)
    clean = paged_attention_ragged_quant(*args, window=window)
    dirty = paged_attention_ragged_quant(*_poisoned_quant(args, window),
                                         window=window)
    assert torch.equal(clean, dirty)


def _poisoned_quant(args, window):
    """``args`` with 0x7F bytes (NaN in e4m3fn) in every value slot no row
    of its sequence may read and NaN in those slots' scales."""
    q, k, v, ks, vs, bt, st, ctx, qs, ql, p0 = args
    page, n_pages = k.shape[1], bt.shape[1]
    kb, vb = k.view(torch.uint8).clone(), v.view(torch.uint8).clone()
    ks2, vs2 = ks.clone(), vs.clone()
    kv = torch.arange(n_pages * page, device=k.device)
    for s in range(bt.shape[0]):
        lo = 0 if window is None else max(0, int(p0[s]) - window + 1)
        bad = (kv < lo) | (kv >= int(ctx[s]))
        pg = bt[s].long()[kv[bad] // page]
        spg = st[s].long()[kv[bad] // page]
        kb[pg, kv[bad] % page] = 0x7F
        vb[pg, kv[bad] % page] = 0x7F
        ks2[spg, kv[bad] % page] = float("nan")
        vs2[spg, kv[bad] % page] = float("nan")
    return [q, kb.view(k.dtype), vb.view(v.dtype), ks2, vs2, bt, st, ctx, qs,
            ql, p0]


# (q_lens, pos0, H, Hkv, D, page, n_pages, window) over tables of 1024 keys
# or more (splits of 512 keys, quant_plan); decode rows at pos0 = ctx - 1
QSPLIT = {
    "ctx_511_512_513_p16": ([1, 1, 1], [510, 511, 512], 32, 8, 80, 16, 64,
                            None),
    "ctx_511_512_513_p128": ([1, 1, 1], [510, 511, 512], 32, 8, 80, 128, 8,
                             None),
    "window_in_split_empty_split": ([1, 1, 3], [800, 600, 597], 32, 8, 80,
                                    128, 8, 100),
    "decode_next_to_chunks": ([1, 40, 1, 0, 17, 1],
                              [900, 480, 512, 0, 0, 1020], 32, 8, 80, 128, 8,
                              None),
    # G = 4: one row is a decode tile, two rows a chunk tile; G = 1: four
    # rows and five; G = 8: a decode row of 8 vectors
    "threshold_1_2_rows": ([1, 2, 1, 3], [511, 510, 600, 0], 32, 8, 80, 16,
                           64, None),
    "g1_threshold_4_5_rows": ([4, 5, 4, 1], [508, 509, 600, 0], 4, 4, 80, 16,
                              64, None),
    "g8_decode_rows": ([1, 1, 2, 20], [511, 600, 512, 100], 16, 2, 64, 128,
                       8, 64),
    "d20_4byte_copies": ([1, 1, 1, 9], [510, 511, 512, 100], 8, 2, 20, 16,
                         64, 200),
    "d36_4byte_copies": ([2, 30, 1], [1023, 60, 767], 4, 1, 36, 16, 64, None),
    "long_ctx_16_splits": ([1, 1, 64], [7000, 8191, 7900], 32, 8, 80, 128,
                           64, None),
    # D = 128: the chunk tiles' fourth float4 column of O (fp32 takes three
    # up to D = 96)
    "d128_chunks": ([1, 40, 1], [511, 60, 767], 8, 2, 128, 16, 64, None),
}


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("case", sorted(QSPLIT))
def test_quant_kernel_split_kv_cases(cuda, fmt, case):
    """Split-KV decode tiles next to chunk tiles: within 1e-4 of the plain
    version, stream padding rows 0, poison in unreadable slots leaves the
    output bit-identical, and a second launch is bitwise equal."""
    *shape, window = QSPLIT[case]
    args = _quant_inputs(fmt, shape, cuda)
    got = paged_attention_ragged_quant(*args, window=window)
    again = paged_attention_ragged_quant(*args, window=window)
    dirty = paged_attention_ragged_quant(*_poisoned_quant(args, window),
                                         window=window)
    torch.cuda.synchronize()
    want = paged_attention_ragged_quant_ref(*args, window=window)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL
    assert torch.all(got[sum(shape[0]):] == 0), "stream padding rows are 0"
    assert torch.equal(again, got)
    assert torch.equal(dirty, got)


def _poisoned_f32(k, v, bt, ctx, starts, window):
    """Copies of fp32 pools with NaN in every slot no row of its sequence
    may read: before the window's first key (from ``starts``, the first
    row's position) and at or past the context."""
    page, n_pages = k.shape[1], bt.shape[1]
    k2, v2 = k.clone(), v.clone()
    kv = torch.arange(n_pages * page, device=k.device)
    for s in range(bt.shape[0]):
        lo = 0 if window is None else max(0, int(starts[s]) - window + 1)
        bad = (kv < lo) | (kv >= int(ctx[s]))
        pg = bt[s].long()[kv[bad] // page]
        k2[pg, kv[bad] % page] = float("nan")
        v2[pg, kv[bad] % page] = float("nan")
    return k2, v2


@pytest.mark.parametrize("case", sorted(QSPLIT))
def test_kernel_split_kv_cases(cuda, case):
    """B1 (fp32) on B2's split cases: split-KV decode tiles at split
    boundaries, windows starting inside a split, splits with no visible
    key, next to chunk tiles and on both sides of the decode/chunk
    threshold. Within 1e-4 of the plain version, stream padding rows 0,
    NaN in unreadable slots leaves the output bit-identical, and a second
    launch is bitwise equal."""
    *shape, window = QSPLIT[case]
    q, k, v, bt, ctx, qs, ql, p0 = _inputs(*shape, cuda)
    before = paged_attention_ragged.launches
    got = paged_attention_ragged(q, k, v, bt, ctx, qs, ql, p0, window=window)
    again = paged_attention_ragged(q, k, v, bt, ctx, qs, ql, p0,
                                   window=window)
    k2, v2 = _poisoned_f32(k, v, bt, ctx, p0, window)
    dirty = paged_attention_ragged(q, k2, v2, bt, ctx, qs, ql, p0,
                                   window=window)
    torch.cuda.synchronize()
    assert paged_attention_ragged.launches == before + 3
    want = paged_attention_ragged_ref(q, k, v, bt, ctx, qs, ql, p0,
                                      window=window)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL
    assert torch.all(got[sum(shape[0]):] == 0), "stream padding rows are 0"
    assert torch.equal(again, got)
    assert torch.equal(dirty, got)


# (B, Tq, H, Hkv, D, page, n_pages, window, contexts, first positions):
# B3 over tables of 1024 keys or more (splits of 512: batched_plan); rows
# sit at positions first.. (None: ctx - Tq)
BSPLIT = {
    "decode_ctx_511_512_513_p16": (3, 1, 32, 8, 80, 16, 64, None,
                                   [511, 512, 513], None),
    "decode_ctx_511_512_513_p128": (3, 1, 32, 8, 80, 128, 8, None,
                                    [511, 512, 513], None),
    "verify_ctx_511_512_513_p16": (4, 4, 32, 8, 80, 16, 64, None,
                                   [511, 512, 513, 516], None),
    "window_in_split": (3, 1, 32, 8, 80, 128, 8, 100, [800, 600, 1000],
                        None),
    "verify_window_empty_first_split": (2, 4, 32, 8, 80, 16, 64, 80,
                                        [900, 1024], None),
    # Tq x G on both sides of 16: decode tiles of 16, chunk tiles of 20
    "g4_tq4_16_vectors": (3, 4, 32, 8, 80, 16, 64, None, [7, 600, 1000],
                          None),
    "g4_tq5_20_vectors": (3, 5, 32, 8, 80, 16, 64, None, [7, 600, 1000],
                          None),
    "g1_tq16_16_vectors": (2, 16, 4, 4, 32, 16, 64, 64, [20, 700], None),
    "g1_tq17_17_vectors": (2, 17, 4, 4, 32, 16, 64, 64, [20, 700], None),
    "g8_tq2_16_vectors": (2, 2, 16, 2, 64, 128, 8, None, [513, 1000], None),
    # chunk tiles whose keys split (a short grid), a window inside a split
    "chunk_split_keys": (1, 100, 32, 8, 80, 16, 64, None, [1000], None),
    "chunk_split_window": (2, 70, 32, 8, 80, 128, 16, 300, [1500, 2048],
                           None),
    "d128_chunk_split_keys": (1, 40, 8, 2, 128, 16, 64, None, [900], None),
    # rows with no visible key: an empty context, and rows past their
    # context beyond the window
    "no_visible_key_decode": (3, 1, 32, 8, 80, 16, 64, 4, [0, 600, 100],
                              [0, 599, 200]),
    "no_visible_key_chunk": (3, 24, 32, 8, 80, 16, 64, 4, [0, 600, 100],
                             [0, 576, 200]),
}


def _batched_at(b, tq, h, hkv, d, page, n_pages, ctx, first, device,
                seed=0):
    """B3's inputs at the given contexts and first positions."""
    rng = np.random.default_rng(seed)
    starts = [max(c - tq, 0) for c in ctx] if first is None else first
    arrs = {"q": rng.standard_normal((b, tq, h, d)),
            "k": rng.standard_normal((b * n_pages + 1, page, hkv, d)),
            "v": rng.standard_normal((b * n_pages + 1, page, hkv, d)),
            "bt": 1 + rng.permutation(b * n_pages).reshape(b, n_pages),
            "ctx": ctx, "qs": starts}
    return [torch.as_tensor(np.asarray(arrs[k]), device=device,
                            dtype=torch.float32 if k in ("q", "k", "v")
                            else torch.int32)
            for k in ("q", "k", "v", "bt", "ctx", "qs")]


@pytest.mark.parametrize("case", sorted(BSPLIT))
def test_batched_kernel_split_cases(cuda, case, monkeypatch):
    """B3 at split boundaries, windows inside a split, Tq x G on both sides
    of 16 and chunk tiles with split keys, into an output that starts as
    NaN (the wrapper does not zero it): within 1e-4 of the plain version,
    every row with no visible key exactly 0, NaN in unreadable slots
    leaves the output bit-identical, and a second launch is bitwise
    equal."""
    b, tq, h, hkv, d, page, n_pages, window, ctx, first = BSPLIT[case]
    q, k, v, bt, cl, qs = _batched_at(b, tq, h, hkv, d, page, n_pages, ctx,
                                      first, cuda)
    nan_like = lambda x, **kw: torch.full_like(x, float("nan"), **kw)
    monkeypatch.setattr(torch, "empty_like", nan_like)
    before = paged_attention.launches
    got = paged_attention(q, k, v, bt, cl, qs, window=window)
    again = paged_attention(q, k, v, bt, cl, qs, window=window)
    dirty = paged_attention(q, *_poisoned_f32(k, v, bt, cl, qs, window), bt,
                            cl, qs, window=window)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert paged_attention.launches == before + 3
    want = paged_attention_ref(q, k, v, bt, cl, qs, window=window)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL
    for i in range(b):
        for t in range(tq):
            p = int(qs[i]) + t
            lo = 0 if window is None else max(0, p - window + 1)
            if min(ctx[i], p + 1) <= lo:
                assert torch.all(got[i, t] == 0), (i, t)
    assert torch.equal(again, got)
    assert torch.equal(dirty, got)


def test_quant_kernel_rejects_what_it_does_not_take(cuda):
    args = _quant_inputs("int8", LAYOUTS[0][:-1], cuda)
    q, k, v, ks, vs, bt, st, *meta = args
    before = paged_attention_ragged_quant.launches
    with pytest.raises(TypeError):              # fp32 pools
        paged_attention_ragged_quant(q, k.float(), v.float(), ks, vs, bt,
                                     st, *meta)
    with pytest.raises(TypeError):              # f64 scales
        paged_attention_ragged_quant(q, k, v, ks.double(), vs, bt, st, *meta)
    raw = torch.zeros(k.numel() + 1, dtype=torch.uint8, device=cuda)
    k_off = raw[1:].view(torch.int8).view(k.shape)
    with pytest.raises(ValueError):             # pools off 4-byte alignment
        paged_attention_ragged_quant(q, k_off, v, ks, vs, bt, st, *meta)
    with pytest.raises(ValueError):             # scale tables of other shape
        paged_attention_ragged_quant(q, k, v, ks, vs, bt, st[:, :-1], *meta)
    with pytest.raises(ValueError):             # scale tables on the host
        paged_attention_ragged_quant(q, k, v, ks, vs, bt, st.cpu(), *meta)
    assert paged_attention_ragged_quant.launches == before


@pytest.mark.parametrize("path", ["fused", "batched", "sequential", "multi",
                                  "self_draft"])
def test_int8_executor_card_matches_cpu(cuda, path):
    """Reduced h2o-danube-1.8b with int8 KV: every path gives the CPU's
    tokens on the card, and B2 launches once per layer per attention
    pass on the card, never on the CPU; B1 and B3 do not launch."""
    cfg = get_reduced("h2o-danube-1.8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        ex = PagedTransformerExecutor(
            cfg, params, num_pages=64, page_size=16, max_pages_per_seq=8,
            kv_dtype="int8", mode="sequential" if path == "sequential"
            else "fused", ragged_attention=path != "batched",
            capture_logits=path in ("fused", "batched", "sequential"),
            device=dev)
        if path == "self_draft":
            ex.set_draft(TruncatedSelfDraft(1))
        eng = Engine(make_scheduler("fairbatching", LinearCostModel(
            a=1e-4, b=1e-6, c=1e-10)), ex, EngineConfig(
                5.0, 5.0, commit_horizon={"multi": 4, "self_draft": 2}.get(
                    path, 1), speculate=2 if path == "self_draft" else 0))
        rng = np.random.default_rng(3)
        for i in range(5):
            plen = int(rng.integers(1, 70))
            eng.submit(Request(i, arrival=0.0, prompt_len=plen,
                               max_new_tokens=7, ttft_slo=5.0, tpot_slo=5.0,
                               tokens=[int(x) for x in rng.integers(
                                   0, cfg.vocab, plen)]))
        counts0 = (paged_attention_ragged_quant.launches,
                   paged_attention_ragged.launches, paged_attention.launches)
        first = {}
        while eng.has_work:
            eng.step()
            for rid, lg in ex.last_logits.items():
                first.setdefault(rid, lg)
        counts = (paged_attention_ragged_quant.launches - counts0[0],
                  paged_attention_ragged.launches - counts0[1],
                  paged_attention.launches - counts0[2])
        runs[dev] = ({r: q.generated_tokens for r, q in eng.requests.items()},
                     first, counts, ex)
    (tok_g, lg_g, n_g, ex_g), (tok_c, lg_c, n_c, _) = runs["cuda"], runs["cpu"]
    assert tok_g == tok_c
    for rid in lg_c:
        np.testing.assert_allclose(lg_g[rid], lg_c[rid],
                                   atol=ATOL_QUANT_LOGITS, rtol=0)
    assert n_c == (0, 0, 0)
    assert n_g[0] > 0 and n_g[1:] == (0, 0)
    if path in ("fused", "batched"):
        assert n_g[0] == cfg.n_layers * ex_g.n_dispatches


# (E, C, K, N): B4 at chip_smoke's step (h) — mixtral-8x7b decode, C=20,
# gate/up then down (split K) — at serve-16's 16-row decode bucket (C=8)
# and C=4 and 1, step (k), kimi-k2's 384 experts at C=4 (w holds 5.6e9
# elements: 64-bit offsets), and the tile body at the prefill capacities
# (C=160: 32-row tiles, 640: 128, 960: 64); then edges of every row tile,
# 128-column tiles and 16- and 32-deep K slabs, and N % 4 != 0 or K % 4
# != 0 (4-byte copies) in both bodies
MOE_SHAPES = [(8, 20, 4096, 14336), (8, 20, 14336, 4096),
              (8, 8, 4096, 14336), (8, 8, 14336, 4096),
              (8, 4, 14336, 4096), (8, 1, 14336, 4096),
              (384, 4, 7168, 2048), (8, 160, 4096, 14336),
              (8, 640, 4096, 14336), (8, 960, 14336, 4096),
              (8, 33, 4096, 1000), (8, 64, 1000, 4096), (3, 20, 96, 72),
              (5, 1, 33, 5), (2, 4, 17, 130), (4, 33, 100, 130),
              (2, 9, 64, 64), (1, 640, 64, 256), (3, 960, 100, 130),
              (2, 160, 33, 132), (2, 12, 40, 260)]


@pytest.mark.parametrize("shape", MOE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_moe_gmm_matches_plain_version(cuda, shape):
    e, c, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((e, c, k), generator=g, device=cuda).mul_(0.3)
    w = torch.randn((e, k, n), generator=g, device=cuda).mul_(0.3)
    before = moe_gmm.launches
    got = moe_gmm(x, w)
    want = moe_gmm_ref(x, w)
    again = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 2
    assert got.shape == (e, c, n) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 2e-4 * k ** 0.5
    assert torch.equal(again, got)          # one FMA chain per output
    del x, w, got, want, again
    torch.cuda.empty_cache()


def test_moe_gmm_takes_an_unaligned_x(cuda):
    """x 4 bytes off 16-byte alignment: every copy is 4 bytes, in the tile
    and the stream body alike."""
    for e, c, k, n in ((2, 40, 64, 256), (2, 8, 256, 128)):
        g = torch.Generator(device=cuda).manual_seed(1)
        buf = torch.randn((e * c * k + 1,), generator=g, device=cuda)
        x = buf[1:].view(e, c, k)
        w = torch.randn((e, k, n), generator=g, device=cuda)
        assert x.data_ptr() % 16 == 4
        got = moe_gmm(x, w)
        assert float((got - moe_gmm_ref(x, w)).abs().max()) < 2e-4 * k ** 0.5
        assert torch.equal(moe_gmm(x, w), got)


def test_moe_gmm_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((2, 4, 8), device=cuda)
    w = torch.zeros((2, 8, 12), device=cuda)
    with pytest.raises(TypeError):
        moe_gmm(x.double(), w)
    with pytest.raises(ValueError):
        moe_gmm(x, w[:, :7].contiguous())
    with pytest.raises(ValueError):
        moe_gmm(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError):
        moe_gmm(x, w.cpu())


def test_moe_capacity_repeats_bitwise(cuda):
    """Top-8 of 64 experts over three router chunks: three runs on the
    card are bitwise equal, agree with the CPU within fp32 noise, and
    launch B4 three times per chunk."""
    cfg = MoEConfig(n_experts=64, top_k=8, d_ff_expert=256, router_chunk=128)
    d, t = 512, 300
    gen = torch.Generator().manual_seed(0)
    params = {"router": torch.randn(d, 64, generator=gen) / d ** 0.5,
              "w_gate": torch.randn(64, d, 256, generator=gen) / d ** 0.5,
              "w_up": torch.randn(64, d, 256, generator=gen) / d ** 0.5,
              "w_down": torch.randn(64, 256, d, generator=gen) / 16.0}
    x = torch.randn(t, d, generator=gen)
    valid = torch.rand(t, generator=gen) > 0.1
    on_card = {k: v.to(cuda) for k, v in params.items()}
    before = moe_gmm.launches
    outs = [moe_capacity(x.to(cuda), on_card, cfg, valid.to(cuda))
            for _ in range(3)]
    torch.cuda.synchronize()
    assert moe_gmm.launches - before == 3 * 3 * router_chunks(t, cfg) == 27
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    cpu = moe_capacity(x, params, cfg, valid)
    np.testing.assert_allclose(outs[0].cpu().numpy(), cpu.numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("path", ["fused", "sequential", "multi"])
@pytest.mark.parametrize("moe_impl", ["exact", "capacity"])
def test_moe_executor_card_matches_cpu(cuda, moe_impl, path):
    """Reduced kimi-k2 (top-4 of 8 experts) under the model clock, so both
    devices see the same plans and so the same capacity drops: the card
    gives the CPU's tokens and first logits within 1e-4; B4 launches three
    times per layer and router chunk (64 tokens here) of each fused step
    under capacity, never under exact; a committed horizon never waits for
    the device."""
    cfg = dataclasses.replace(get_reduced("kimi-k2-1t-a32b"), window=None)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = LinearCostModel(a=1e-3, b=1e-4, c=0.0)
    runs = {}
    for dev in ("cuda", "cpu"):
        ex = PagedTransformerExecutor(
            cfg, params, num_pages=64, page_size=16, max_pages_per_seq=8,
            mode="sequential" if path == "sequential" else "fused",
            moe_impl=moe_impl, capture_logits=path != "multi", device=dev)
        buckets = []
        if dev == "cuda":
            ex._multi_decode_step = _no_sync(ex._multi_decode_step)
            fused_step = ex._fused_step
            ex._fused_step = lambda st, t: (buckets.append(t),
                                            fused_step(st, t))[1]
        eng = Engine(make_scheduler("fairbatching", model, calibrate=False),
                     ModelTimedExecutor(ex, model), EngineConfig(
                         5.0, 5.0, commit_horizon=4 if path == "multi"
                         else 1))
        rng = np.random.default_rng(3)
        for i in range(5):
            plen = int(rng.integers(1, 70))
            eng.submit(Request(i, arrival=0.0, prompt_len=plen,
                               max_new_tokens=7, ttft_slo=5.0, tpot_slo=5.0,
                               tokens=[int(x) for x in rng.integers(
                                   0, cfg.vocab, plen)]))
        before, first = moe_gmm.launches, {}
        while eng.has_work:
            eng.step()
            for rid, lg in ex.last_logits.items():
                first.setdefault(rid, lg)
        runs[dev] = ({r: q.generated_tokens for r, q in eng.requests.items()},
                     first, moe_gmm.launches - before, buckets, ex)
    (tok_g, lg_g, n_g, bk_g, ex_g), (tok_c, lg_c, n_c, _, _) = (
        runs["cuda"], runs["cpu"])
    assert tok_g == tok_c
    assert lg_g.keys() == lg_c.keys()
    for rid in lg_c:
        np.testing.assert_allclose(lg_g[rid], lg_c[rid], atol=ATOL, rtol=0)
    assert n_c == 0
    if moe_impl == "exact":
        assert n_g == 0
    else:
        assert n_g > 0
        if path == "fused":
            assert n_g == sum(3 * cfg.n_layers * router_chunks(t, cfg.moe)
                              for t in bk_g)
            assert max(bk_g) > cfg.moe.router_chunk    # two chunks seen
    if path == "multi":
        assert any(k[0] == "multi" for k in ex_g.compile_keys)


# (B, NC, L, H, P, N): the JAX suite's sweep, ragged chunks of 5-100 steps
# (prompts shorter than the chunk), P != N, more heads than a block takes,
# the reduced mamba2-1.3b (8 heads of 16, N 16) and its full widths; then
# the edges of the 32-step slabs and 32-row quarters at full heads (L 64,
# 65, 96, 127), head counts no head group divides (H 9, 65; at 8 x 33 and
# 1 x 120 chunks the plan gives 2 and 8 heads a block, the last group
# holding one) and 256 chunks
SCAN_SHAPES = [(1, 2, 8, 2, 8, 8), (2, 3, 16, 4, 16, 8), (2, 4, 32, 2, 32, 16),
               (1, 3, 5, 3, 12, 4), (2, 2, 33, 9, 16, 16),
               (2, 1, 24, 8, 16, 16), (1, 4, 127, 5, 64, 128),
               (2, 3, 100, 64, 64, 128), (2, 3, 128, 64, 64, 128),
               (1, 2, 64, 64, 64, 128), (1, 2, 65, 64, 64, 128),
               (1, 2, 96, 64, 64, 128), (1, 2, 127, 64, 64, 128),
               (2, 2, 128, 9, 64, 128), (8, 33, 128, 9, 64, 128),
               (1, 120, 128, 65, 64, 128), (1, 256, 128, 8, 64, 128)]


def _scan_inputs(shape, device, seed=0):
    b, nc, l, h, p, n = shape
    g = torch.Generator(device=device).manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g, device=device)
    return (f(b, nc, l, h, p) * 0.3, -f(b, nc, l, h).abs() * 0.1,
            f(b, nc, l, n) * 0.3, f(b, nc, l, n) * 0.3, f(b, h, p, n) * 0.3)


@pytest.mark.parametrize("init", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("shape", SCAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mamba_chunk_scan_matches_plain_version(cuda, shape, init):
    x, a, b, c, s0 = _scan_inputs(shape, cuda)
    s0 = s0 if init else None
    before = mamba_chunk_scan.launches
    y, st = mamba_chunk_scan(x, a, b, c, s0)
    y2, st2 = mamba_chunk_scan(x, a, b, c, s0)
    yr, str_ = mamba_chunk_scan_ref(x, a, b, c, s0)
    torch.cuda.synchronize()
    assert mamba_chunk_scan.launches == before + 2
    assert y.shape == shape[:5] and st.shape == str_.shape
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    tol = 1e-4 * max(1.0, float(yr.abs().max()))
    assert float((y - yr).abs().max()) < tol
    tol = 1e-4 * max(1.0, float(str_.abs().max()))
    assert float((st - str_).abs().max()) < tol
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.parametrize("shape", [(2, 3, 100, 9, 64, 128),
                                   (1, 2, 5, 3, 12, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_mamba_chunk_scan_writes_every_output(cuda, shape, monkeypatch):
    """y starts as NaN (the wrapper does not zero it): every row of every
    head is written, within 1e-4 of the plain version, and a repeat is
    bitwise equal."""
    x, a, b, c, s0 = _scan_inputs(shape, cuda, seed=1)
    yr, str_ = mamba_chunk_scan_ref(x, a, b, c, s0)
    nan_like = lambda t, **kw: torch.full_like(t, float("nan"), **kw)
    monkeypatch.setattr(torch, "empty_like", nan_like)
    y, st = mamba_chunk_scan(x, a, b, c, s0)
    y2, st2 = mamba_chunk_scan(x, a, b, c, s0)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    tol = 1e-4 * max(1.0, float(yr.abs().max()))
    assert float((y - yr).abs().max()) < tol
    tol = 1e-4 * max(1.0, float(str_.abs().max()))
    assert float((st - str_).abs().max()) < tol
    assert torch.equal(y, y2) and torch.equal(st, st2)


def test_mamba_chunk_scan_rejects_what_it_does_not_take(cuda):
    x, a, b, c, s0 = _scan_inputs((1, 2, 16, 2, 16, 16), cuda)
    with pytest.raises(TypeError):
        mamba_chunk_scan(x.double(), a, b, c)
    with pytest.raises(ValueError, match="L=129"):
        xl, al, bl, cl, _ = _scan_inputs((1, 1, 129, 2, 16, 16), cuda)
        mamba_chunk_scan(xl, al, bl, cl)
    with pytest.raises(ValueError):       # a state of another shape
        mamba_chunk_scan(x, a, b, c, s0[..., :8].contiguous())
    with pytest.raises(ValueError):
        mamba_chunk_scan(x, a, b.cpu(), c)


@pytest.mark.parametrize("slen", [10, 40])
def test_ssm_decoder_card_matches_cpu(cuda, slen):
    """Reduced mamba2-1.3b, the port's weights: prefill and 4 greedy decode
    steps give the CPU's tokens, logits within 1e-4 × max(1, |logits|);
    B5 launches n_layers times in the prefill and never in decode."""
    cfg = get_reduced("mamba2-1.3b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(slen).integers(
        0, cfg.vocab, (3, slen)))
    runs = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg, device=dev)
        p = params_to(params, dev)
        before = mamba_chunk_scan.launches
        logits, cache = m.prefill(p, toks.to(dev), max_len=slen + 4)
        n_pre = mamba_chunk_scan.launches - before
        out, first = [], logits.cpu()
        for _ in range(4):
            t = logits.argmax(-1)
            out.append(t.tolist())
            logits, cache = m.decode_step(p, t, cache)
        runs[dev] = (out, first, n_pre, mamba_chunk_scan.launches - before)
    (tok_g, lg_g, pre_g, all_g), (tok_c, lg_c, pre_c, all_c) = (
        runs["cuda"], runs["cpu"])
    assert tok_g == tok_c
    tol = 1e-4 * max(1.0, float(lg_c.abs().max()))
    assert float((lg_g - lg_c).abs().max()) < tol
    assert pre_g == all_g == cfg.n_layers
    assert pre_c == all_c == 0
