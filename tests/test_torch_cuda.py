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
With a ``PrefixCache`` attached, the reduced h2o-danube-1.8b's fused
executor on the card gives the CPU's tokens and cached-token count over
shared-prefix requests on the model clock (fp32 and int8); a victim
evicted off a COW survivor's shared pages leaves the survivor's stream
that of a run without preemption; and KV pages migrated between two
executors on the card are the captured payload byte for byte (scale
pages too, at permuted scale ids), with the streams of a run that never
migrated (fp32, int8, fp8-e4m3).
The reduced zamba2-2.7b and gemma3-1b ``DecoderLM``s on the card give the
CPU's greedy tokens (B5 once per Mamba2 block in zamba2's prefill), and a
MoE target speculates with a ``TruncatedSelfDraft`` of one layer and of
every layer (which accepts drafts) on fixed plans with the CPU's tokens
and accept/draft counters, under both ``moe_impl``s.
Training: B4's ``MoeGmm`` Function gives dx and dw (two more B4 launches)
within 2e-4·√(contraction) of autograd through the plain version; a
2-layer reduced mixtral-8x7b train step under ``capacity`` (and h2o-
danube-1.8b under flash) gives the CPU's loss, gradients (nonzero where
the CPU's are) and updated params, B4 launching 12 times per layer and
router chunk (3 forward, 3 recomputed, 6 backward); the reduced
mamba2-1.3b and zamba2-2.7b train steps give the CPU's loss, gradients
and params, B5 launching twice per Mamba2 block (forward, recomputed)
and its backward once. B5's backward (``MambaChunkScan``) gives every
gradient within 1e-4 of its max |g| against the fp64 plain backward over
chunk lengths on both sides of its slabs and both families' heads, with
and without an initial state and a final-state gradient, writes every
element of outputs that start as NaN, and repeats bitwise.
bf16: each kernel takes bf16 where its Pallas kernel does (B1 and B3 bf16
q and pools, B2 a bf16 q over its 1-byte pools, B4 bf16 x and w, B5 bf16
xdt, a_dt, b and c, or fp32 xdt and a_dt with bf16 b and c as the model
gives them) and is held against its plain version's fp32 math on the
same (widened) inputs: at most one bf16 rounding of the output, |Δ| ≤
2⁻⁸·|plain| + 1e-4·max|plain|, and a repeat bitwise equal; fp16 raises
``TypeError``.
The sharded data plane: B1 (fp32) and B2 (int8) at h2o-danube-1.8b's
heads on one rank at TP 2 and 4 and B4 at mixtral-8x7b's experts on one
rank at TP 2 against their plain versions; and a 1 × 1 mesh on NCCL
(``launch.mesh.spawn``, one process) gives every dispatch's logits bit for
bit as ``mesh=None`` does, fp32 and int8.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.cache import PrefixCache
from repro_torch.configs import MoEConfig, get_reduced
from repro_torch.core import (BatchItem, BatchPlan, LinearCostModel,
                              TaskKind, make_scheduler)
from repro_torch.disagg.migration import capture_kv, install_kv_pages
from repro_torch.engine import (Engine, EngineConfig,
                                PagedTransformerExecutor, Request,
                                RequestState)
from repro_torch.engine.numerics import ModelTimedExecutor
from repro_torch.engine.spec_decode import SmallModelDraft, TruncatedSelfDraft
from repro_torch.kernels.mamba2_scan import (MambaChunkScan, mamba_chunk_scan,
                                             mamba_chunk_scan_backward)
from repro_torch.kernels.moe_gmm import MoeGmm, moe_gmm
from repro_torch.kernels.paged_attention import (
    paged_attention, paged_attention_ragged, paged_attention_ragged_quant)
from repro_torch.kernels.quant import (kv_quant_spec, quantize_kv, raw_pool,
                                      supports_fp8)
from repro_torch.kernels.ref import (mamba_chunk_scan_backward_ref,
                                     mamba_chunk_scan_ref, moe_gmm_ref,
                                     paged_attention_ragged_quant_ref,
                                     paged_attention_ragged_ref,
                                     paged_attention_ref)
from repro_torch.models import ModelOpts, build_model, init_params
from repro_torch.models.moe import moe_capacity, router_chunks
from repro_torch.models.weights import params_to
from repro_torch.training import (OptConfig, apply_updates,
                                  init_opt_state)
from repro_torch.training.optimizer import leaves
from repro_torch.training.train_step import value_and_grad

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


# ---------------------------------------------------------------------------
# the prefix cache, preemption and KV migration on the card
# ---------------------------------------------------------------------------

CLOCK = LinearCostModel(a=1e-3, b=1e-4, c=0.0)


def _shared_prefix_prompts(vocab, seed=5):
    rng = np.random.default_rng(seed)
    shared = [int(x) for x in rng.integers(0, vocab, 48)]
    return [shared + [int(x) for x in rng.integers(0, vocab, n)]
            for n in (5, 19, 3, 5)]


def _cached_engine(cfg, params, dev, kv_dtype, *, preemption=False,
                   cache_pages=16):
    ex = PagedTransformerExecutor(cfg, params, num_pages=64, page_size=16,
                                  max_pages_per_seq=8, kv_dtype=kv_dtype,
                                  capture_logits=True, device=dev)
    cache = PrefixCache(cache_pages, block_size=16, alloc=ex.alloc)
    ex.attach_cache(cache)
    eng = Engine(make_scheduler("fairbatching", CLOCK, calibrate=False),
                 ModelTimedExecutor(ex, CLOCK),
                 EngineConfig(5.0, 5.0, preemption=preemption,
                              defer_age=0.01), prefix_cache=cache)
    return eng, ex, cache


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_cached_prefill_card_matches_cpu(cuda, kv_dtype):
    """Shared-prefix requests through the cache on the model clock: the
    card's tokens, cached tokens and plans are the CPU's; the attention
    kernel launches once per layer per dispatch on the card."""
    cfg = get_reduced("h2o-danube-1.8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kern = (paged_attention_ragged_quant if kv_dtype != "fp32"
            else paged_attention_ragged)
    runs = {}
    for dev in ("cuda", "cpu"):
        eng, ex, cache = _cached_engine(cfg, params, dev, kv_dtype)
        for i, p in enumerate(_shared_prefix_prompts(cfg.vocab)):
            eng.submit(Request(i, arrival=0.05 * i, prompt_len=len(p),
                               max_new_tokens=6, ttft_slo=5.0, tpot_slo=5.0,
                               tokens=p))
        before, first = kern.launches, {}
        while eng.has_work:
            eng.step()
            for rid, lg in ex.last_logits.items():
                first.setdefault(rid, lg)
        ex.alloc.check_invariants()
        runs[dev] = ({r: q.generated_tokens for r, q in eng.requests.items()},
                     first, cache.stats.hit_tokens, kern.launches - before,
                     ex.n_dispatches)
    (tok_g, lg_g, hit_g, n_g, d_g), (tok_c, lg_c, hit_c, n_c, _) = \
        runs["cuda"], runs["cpu"]
    assert tok_g == tok_c
    assert hit_g == hit_c > 0
    tol = ATOL if kv_dtype == "fp32" else ATOL_QUANT_LOGITS
    for rid in lg_c:
        np.testing.assert_allclose(lg_g[rid], lg_c[rid], atol=tol, rtol=0)
    assert n_c == 0 and n_g == cfg.n_layers * d_g


def test_preempted_victim_leaves_survivor_stream_on_card(cuda):
    """A victim forked onto a survivor's cached pages is evicted mid-decode
    and recomputes its tail; the survivor's pages are untouched and both
    streams are those of the run without the preemption."""
    cfg = get_reduced("h2o-danube-1.8b")
    params = params_to(init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu"), cuda)
    prompts = _shared_prefix_prompts(cfg.vocab)[:2]
    out = []
    for preempt in (False, True):
        eng, ex, _ = _cached_engine(cfg, params, cuda, "fp32",
                                    preemption=True, cache_pages=8)
        eng.submit(Request(0, 0.0, len(prompts[0]), 12, 5.0, 5.0,
                           tokens=prompts[0]))
        while eng.requests.get(0) is None or \
                eng.requests[0].prefilled < len(prompts[0]):
            eng.step()
        eng.submit(Request(1, eng.now, len(prompts[1]), 12, 5.0, 5.0,
                           tokens=prompts[1]))
        while eng.requests.get(1) is None or eng.requests[1].generated < 3:
            eng.step()
        table = list(ex.alloc.tables[0])
        assert any(ex.alloc.refcount[p] > 1 for p in table)
        pages = ex.k_pages[:, table].clone()
        if preempt:
            eng._preempt(eng.requests[1])
            assert ex.alloc.tables[0] == table
            assert torch.equal(ex.k_pages[:, table], pages)
            assert eng.requests[1].cached_context > 0
        eng.run(max_steps=500)
        ex.alloc.check_invariants()
        out.append(([eng.requests[i].generated_tokens for i in (0, 1)],
                    eng.preemptions))
    assert out[1][1] == 1 and out[0][1] == 0
    assert out[1][0] == out[0][0]


def _fixed_step(ex, world, owned):
    items = []
    for rid in owned:
        r = world[rid]
        if r.active:
            items.append(BatchItem(rid, 1, TaskKind.DECODE)
                         if r.state is RequestState.DECODE else
                         BatchItem(rid, min(16, r.prompt_len - r.prefilled),
                                   TaskKind.PREFILL))
    if not items:
        return False
    plan = BatchPlan(items, 0.0, 0.0, 0, 0)
    _, emitted = ex.execute(plan, world, 0.0)
    assert not ex.last_deferred
    for it in items:
        if it.req_id in emitted:
            world[it.req_id].generated_tokens.append(emitted[it.req_id])
        world[it.req_id].advance(it.n_tokens, 0.0)
    return True


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8_e4m3"])
def test_migrated_pages_bitwise_on_card(cuda, kv_dtype):
    """Fixed plans on two card executors sharing weights: each request
    moves by KV at its own decode count; the installed pages (and scale
    pages, at permuted scale ids) are the payload byte for byte, and the
    streams are those of a card run that never migrated."""
    if kv_dtype == "fp8_e4m3" and not supports_fp8(cuda):
        pytest.skip("the card's torch has no float8_e4m3fn")
    cfg = get_reduced("h2o-danube-1.8b")
    params = params_to(init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu"), cuda)
    make = lambda: PagedTransformerExecutor(
        cfg, params, num_pages=64, page_size=16, max_pages_per_seq=8,
        kv_dtype=kv_dtype, device=cuda)
    lens = (23, 41, 60)

    def world():
        r = np.random.default_rng(7)
        return {i: Request(i, 0.0, n, 7, 5.0, 5.0, tokens=[
            int(x) for x in r.integers(0, cfg.vocab, n)])
            for i, n in enumerate(lens)}

    oracle, ex = world(), make()
    while _fixed_step(ex, oracle, list(oracle)):
        pass
    src, dst = make(), make()
    for a, seed in ((src, 1), (dst, 2)):
        np.random.default_rng(seed).shuffle(a.alloc._free_scales)
    moved, owner = world(), {i: "src" for i in range(len(lens))}
    at = {0: 1, 1: 3, 2: 5}
    while any(r.active for r in moved.values()):
        _fixed_step(src, moved, [i for i, o in owner.items() if o == "src"])
        _fixed_step(dst, moved, [i for i, o in owner.items() if o == "dst"])
        for rid, r in moved.items():
            if (owner[rid] == "src" and r.active and r.generated >= at[rid]
                    and r.state is RequestState.DECODE):
                payload = capture_kv(src, rid)
                src.release(rid)
                assert install_kv_pages(dst, None, r, payload, 0.0) == 0
                owner[rid] = "dst"
                idx = torch.as_tensor(dst.alloc.tables[rid], device=cuda)
                sidx = torch.as_tensor(dst.alloc.scale_table(rid),
                                       device=cuda)
                for pool, rows in ((dst.k_pages, payload.k),
                                   (dst.v_pages, payload.v)):
                    assert np.array_equal(
                        raw_pool(pool)[:, idx].cpu().numpy(), rows)
                if payload.k_scales is not None:
                    assert np.array_equal(
                        dst.k_scales[:, sidx].cpu().numpy(), payload.k_scales)
                    assert np.array_equal(
                        dst.v_scales[:, sidx].cpu().numpy(), payload.v_scales)
                src.alloc.check_invariants()
                dst.alloc.check_invariants()
    assert {r: q.generated_tokens for r, q in moved.items()} == \
        {r: q.generated_tokens for r, q in oracle.items()}


# ---------------------------------------------------------------------------
# DecoderLM for the hybrid and local:global families, MoE speculation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-2.7b", "gemma3-1b"])
def test_decoder_families_card_match_cpu(cuda, arch):
    """Reduced zamba2 (two shared-block applications) and gemma3 (local
    and global layers, a 40-token prompt past the 16-token window), the
    port's weights: prefill and 4 greedy decode steps give the CPU's
    tokens, logits within 1e-4 × max(1, |logits|); B5 launches once per
    Mamba2 block in the prefill and never in decode."""
    cfg = get_reduced(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (3, 40)))
    runs = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg, device=dev)
        p = params_to(params, dev)
        before = mamba_chunk_scan.launches
        logits, cache = m.prefill(p, toks.to(dev), max_len=48)
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
    mamba = cfg.n_layers if cfg.family == "hybrid" else 0
    assert pre_g == all_g == mamba
    assert pre_c == all_c == 0


def _spec_fixed_plans(ex, world, gamma=3, rounds=2):
    """``_fixed_step``'s plans until every active request decodes, then
    speculative dispatches over all of them; returns the accepted and
    drafted counts."""
    accepted = drafted = 0
    while any(r.active for r in world.values()):
        active = [r for r in world.values() if r.active]
        if all(r.state is RequestState.DECODE for r in active):
            plan = BatchPlan([BatchItem(r.req_id, 1, TaskKind.DECODE)
                              for r in active], 0.0, 0.0, 0, 0)
            _, out = ex.execute_multi(plan, world, 0.0, rounds,
                                      speculate=gamma)
            assert not ex.last_deferred
            accepted += ex.last_spec_accepted
            drafted += ex.last_spec_drafted
            for em in out:
                for rid, toks in em.items():
                    if toks:
                        world[rid].generated_tokens.extend(toks)
                        world[rid].advance(len(toks), 0.0)
        else:
            _fixed_step(ex, world, list(world))
        for r in world.values():
            if not r.active:
                ex.release(r.req_id)
    return accepted, drafted


@pytest.mark.parametrize("draft", ["one_layer", "full_depth"])
@pytest.mark.parametrize("moe_impl", ["exact", "capacity"])
def test_moe_speculation_card_matches_cpu(cuda, moe_impl, draft):
    """ROADMAP A11 on the card: reduced mixtral-8x7b (window off) with a
    ``TruncatedSelfDraft`` of one layer or of every layer (which drafts
    the target's own tokens, so drafts are accepted and the multi-token
    commits run), γ=3, 2 rounds a dispatch, fixed plans: the card gives
    the CPU's tokens and accept/draft counters, B3 launches in the rounds,
    B4 under capacity only, and no round waits for the device."""
    cfg = dataclasses.replace(get_reduced("mixtral-8x7b"), window=None)
    depth = 1 if draft == "one_layer" else cfg.n_layers
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab, 9 + 7 * i)]
               for i in range(4)]
    runs = {}
    for dev in ("cuda", "cpu"):
        ex = PagedTransformerExecutor(cfg, params, num_pages=64,
                                      page_size=16, max_pages_per_seq=8,
                                      moe_impl=moe_impl, device=dev)
        ex.set_draft(TruncatedSelfDraft(depth))
        if dev == "cuda":
            ex._spec_multi_step = _no_sync(ex._spec_multi_step)
        world = {i: Request(i, 0.0, len(p), 9, 5.0, 5.0, tokens=p)
                 for i, p in enumerate(prompts)}
        b3, b4 = paged_attention.launches, moe_gmm.launches
        counts = _spec_fixed_plans(ex, world)
        runs[dev] = ({r: q.generated_tokens for r, q in world.items()},
                     counts, paged_attention.launches - b3,
                     moe_gmm.launches - b4)
    (tok_g, cnt_g, b3_g, b4_g), (tok_c, cnt_c, b3_c, b4_c) = (
        runs["cuda"], runs["cpu"])
    assert tok_g == tok_c and cnt_g == cnt_c and cnt_g[1] > 0
    assert cnt_g[0] > 0 or draft == "one_layer"
    assert all(len(t) == 9 for t in tok_g.values())
    assert b3_g > 0 and b3_c == b4_c == 0
    assert (b4_g > 0) == (moe_impl == "capacity")


# (E, C, K, N): mixtral's gate/up and down at a decode and a prefill
# capacity, and ragged edges
GMM_GRAD_SHAPES = [(8, 8, 4096, 14336), (8, 160, 14336, 4096),
                   (3, 20, 96, 72), (2, 33, 100, 132)]


@pytest.mark.parametrize("shape", GMM_GRAD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_moe_gmm_backward_matches_plain_version(cuda, shape):
    e, c, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((e, c, k), generator=g, device=cuda).mul_(0.3)
    w = torch.randn((e, k, n), generator=g, device=cuda).mul_(0.3)
    dy = torch.randn((e, c, n), generator=g, device=cuda).mul_(0.3)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = moe_gmm.launches
    dx, dw = torch.autograd.grad(
        MoeGmm.apply(x.requires_grad_(), w.requires_grad_()), (x, w), dy)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 3
    ex, ew = torch.autograd.grad(moe_gmm_ref(xr, wr), (xr, wr), dy)
    assert float((dx - ex).abs().max()) < 2e-4 * n ** 0.5
    assert float((dw - ew).abs().max()) < 2e-4 * c ** 0.5
    del x, w, dy, dx, dw, ex, ew, xr, wr
    torch.cuda.empty_cache()


@pytest.mark.parametrize("arch, impl", [("mixtral-8x7b", "capacity"),
                                        ("h2o-danube-1.8b", "flash"),
                                        ("mamba2-1.3b", "auto"),
                                        ("zamba2-2.7b", "auto")])
def test_train_step_card_matches_cpu(cuda, arch, impl):
    """Reduced config at 2 layers, the port's weights, on the card and on
    the CPU. Loss within 1e-5 relative; every gradient leaf within 1e-4 of
    its max |g| and nonzero wherever the CPU's is; one AdamW step from the
    CPU's gradients gives params within 1e-6 on both (Adam's first update
    is about g / |g|, so a gradient element near 0 passes on its fp32
    noise amplified up to 1/eps: each device steps from the same
    gradients)."""
    cfg = get_reduced(arch)
    opts = (ModelOpts(moe_impl="capacity") if impl == "capacity"
            else ModelOpts(attn_impl="flash", flash_block=8)
            if impl == "flash" else ModelOpts())
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 40)))
    opt_cfg = OptConfig(lr=1e-3)
    runs = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg, opts, device=dev)
        counts = (moe_gmm, mamba_chunk_scan, mamba_chunk_scan_backward)
        before = [k.launches for k in counts]
        loss, grads = value_and_grad(m.train_loss, params_to(params, dev),
                                     {"tokens": toks.to(dev)})
        runs[dev] = (float(loss), params_to(grads, "cpu"),
                     [k.launches - b for k, b in zip(counts, before)])
    (lc, gc_, (n, n_scan, n_bwd)), (l0, g0, _) = runs["cuda"], runs["cpu"]
    assert lc == pytest.approx(l0, rel=1e-5)
    for a, b in zip(leaves(gc_), leaves(g0)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        assert not bool(((b != 0) & (a == 0)).any())
    stepped = []
    for dev in ("cuda", "cpu"):
        p = params_to(params, dev)
        p, _ = apply_updates(p, params_to(g0, dev), init_opt_state(
            p, opt_cfg), opt_cfg)
        stepped.append(params_to(p, "cpu"))
    for a, b in zip(leaves(stepped[0]), leaves(stepped[1])):
        assert float((a - b).abs().max()) <= 1e-6
    chunks = router_chunks(2 * 40, cfg.moe) if cfg.moe else 0
    assert n == 12 * cfg.n_layers * chunks
    mamba = cfg.family in ("ssm", "hybrid")
    assert (n_scan, n_bwd) == ((2 * cfg.n_layers, cfg.n_layers) if mamba
                               else (0, 0))


# (B, NC, L, H, P, N) of B5's backward: chunks on both sides of the 32-deep
# slabs, a 5-step chunk, the reduced configs' heads, both families' full
# heads (mamba2-1.3b H 64 N 128, zamba2-2.7b H 80 N 64), 20 chunks
SCAN_BWD_SHAPES = [(1, 2, 5, 3, 12, 4), (2, 3, 33, 9, 16, 16),
                   (2, 2, 16, 8, 16, 16), (1, 3, 100, 4, 64, 128),
                   (2, 2, 128, 64, 64, 128), (2, 2, 128, 80, 64, 64),
                   (1, 20, 128, 8, 64, 128)]


@pytest.mark.parametrize("init", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mamba_chunk_scan_backward_matches_plain_version(cuda, shape, init,
                                                         monkeypatch):
    """Through ``MambaChunkScan`` (y and the final state both carry a
    gradient): every gradient within 1e-4 of its max |g| against the fp64
    plain backward, one backward launch a backward pass, its outputs
    (NaN to start with) all written, and a repeat bitwise equal."""
    x, a, b, c, s0 = _scan_inputs(shape, cuda, seed=2)
    g = torch.Generator(device=cuda).manual_seed(3)
    dy = torch.randn(x.shape, generator=g, device=cuda)
    dfin = torch.randn(s0.shape, generator=g, device=cuda)
    want = mamba_chunk_scan_backward_ref(
        *(t.double() for t in (x, a, b, c)), s0.double() if init else None,
        dy.double(), dfin.double())
    nan_like = lambda t, **kw: torch.full_like(t, float("nan"), **kw)
    monkeypatch.setattr(torch, "empty_like", nan_like)
    runs = []
    for _ in range(2):
        ins = [t.clone().requires_grad_() for t in (x, a, b, c)]
        ins.append(s0.clone().requires_grad_() if init else None)
        before = mamba_chunk_scan_backward.launches
        y, fin = MambaChunkScan.apply(*ins)
        assert y.grad_fn is not None
        runs.append(torch.autograd.grad(
            (y, fin), [t for t in ins if t is not None], (dy, dfin)))
        torch.cuda.synchronize()
        assert mamba_chunk_scan_backward.launches == before + 1
    for got, again, exact in zip(runs[0], runs[1], want):
        scale = float(exact.abs().max())
        assert torch.isfinite(got).all()
        assert float((got.double() - exact).abs().max()) <= 1e-4 * scale
        assert torch.equal(got, again)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_mamba_chunk_scan_grad_through_backward_kernel(cuda, arch):
    """At the family's full heads (B 2 x 256 tokens): ``ops.
    mamba_chunk_scan_op`` under grad returns tensors with a ``grad_fn``
    whose backward launches B5's backward, the gradients of y alone within
    1e-4 of the fp64 plain backward's max and bitwise equal on a repeat;
    without grad one forward launch and no graph."""
    from repro_torch.configs import get
    from repro_torch.kernels.ops import mamba_chunk_scan_op
    s = get(arch).ssm
    d = get(arch).d_model
    shape = (2, 256 // s.chunk, s.chunk, s.n_heads(d), s.head_dim,
             s.d_state)
    x, a, b, c, _ = _scan_inputs(shape, cuda, seed=4)
    dy = torch.randn(x.shape, generator=torch.Generator(
        device=cuda).manual_seed(5), device=cuda)
    want = mamba_chunk_scan_backward_ref(
        *(t.double() for t in (x, a, b, c)), None, dy.double(), None)
    runs = []
    for _ in range(2):
        ins = [t.clone().requires_grad_() for t in (x, a, b, c)]
        fwd, bwd = mamba_chunk_scan.launches, \
            mamba_chunk_scan_backward.launches
        y, fin = mamba_chunk_scan_op(*ins)
        assert y.grad_fn is not None and fin.grad_fn is not None
        runs.append(torch.autograd.grad(y, ins, dy))
        torch.cuda.synchronize()
        assert (mamba_chunk_scan.launches - fwd,
                mamba_chunk_scan_backward.launches - bwd) == (1, 1)
    for got, again, exact in zip(runs[0], runs[1], want):
        assert float((got.double() - exact).abs().max()) <= \
            1e-4 * float(exact.abs().max())
        assert torch.equal(got, again)
    with torch.no_grad():
        fwd = mamba_chunk_scan.launches
        y, _ = mamba_chunk_scan_op(x, a, b, c)
    assert y.grad_fn is None and mamba_chunk_scan.launches == fwd + 1


# -- bf16 ------------------------------------------------------------------

BF16 = torch.bfloat16


def _one_rounding(got, plain, name=""):
    """``got`` (bf16, or fp32 from bf16 inputs) is the plain version's fp32
    result ``plain`` up to one bf16 rounding of the output and fp32 sums
    taken in another order: |Δ| ≤ 2⁻⁸·|plain| + 1e-4·max|plain|."""
    got, plain = got.double(), plain.double()
    assert torch.isfinite(got).all(), name
    bar = 2.0 ** -8 * plain.abs() + 1e-4 * float(plain.abs().max())
    assert bool(((got - plain).abs() <= bar).all()), (
        name, float((got - plain).abs().max()))


def _bf16(args, n):
    """The first ``n`` tensors of ``args`` rounded to bf16, the rest as
    they are."""
    return [t.to(BF16) if i < n else t for i, t in enumerate(args)]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[2:7]}")
def test_kernel_bf16_matches_plain_version(cuda, layout):
    *shape, window = layout
    q, k, v, *meta = _bf16(_inputs(*shape, cuda), 3)
    before = paged_attention_ragged.launches
    got = paged_attention_ragged(q, k, v, *meta, window=window)
    again = paged_attention_ragged(q, k, v, *meta, window=window)
    torch.cuda.synchronize()
    assert paged_attention_ragged.launches == before + 2
    assert got.dtype == BF16 and torch.equal(got, again)
    plain = paged_attention_ragged_ref(q.float(), k, v, *meta, window=window)
    _one_rounding(got, plain)
    assert torch.all(got[sum(layout[0]):] == 0)


@pytest.mark.parametrize("layout", BATCHED, ids=lambda l: f"{l[:5]}")
def test_batched_kernel_bf16_matches_plain_version(cuda, layout):
    *shape, window = layout
    q, k, v, *meta = _bf16(_batched(*shape, cuda), 3)
    before = paged_attention.launches
    got = paged_attention(q, k, v, *meta, window=window)
    again = paged_attention(q, k, v, *meta, window=window)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 2
    assert got.dtype == BF16 and torch.equal(got, again)
    _one_rounding(got, paged_attention_ref(q.float(), k, v, *meta,
                                           window=window))


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[2:7]}")
def test_quant_kernel_bf16_q_matches_plain_version(cuda, fmt, layout):
    *shape, window = layout
    q, *rest = _quant_inputs(fmt, shape, cuda)
    q = q.to(BF16)
    before = paged_attention_ragged_quant.launches
    got = paged_attention_ragged_quant(q, *rest, window=window)
    again = paged_attention_ragged_quant(q, *rest, window=window)
    torch.cuda.synchronize()
    assert paged_attention_ragged_quant.launches == before + 2
    assert got.dtype == BF16 and torch.equal(got, again)
    _one_rounding(got, paged_attention_ragged_quant_ref(q.float(), *rest,
                                                        window=window))
    assert torch.all(got[sum(layout[0]):] == 0)


def test_attention_bf16_refusals(cuda):
    q, k, v, *meta = _inputs(*LAYOUTS[0][:-1], cuda)
    with pytest.raises(TypeError):          # fp16
        paged_attention_ragged(q.half(), k.half(), v.half(), *meta)
    with pytest.raises(TypeError):          # bf16 q over fp32 pools
        paged_attention_ragged(q.to(BF16), k, v, *meta)
    q, k, v, *meta = _inputs([2, 1], [0, 5], 4, 2, 20, 16, 2, cuda)
    with pytest.raises(ValueError, match="D % 8"):
        paged_attention_ragged(q.to(BF16), k.to(BF16), v.to(BF16), *meta)


# B4 in bf16: the MOE_SHAPES with K and N even (a copy moves 4 bytes at
# least), both bodies, the split-K path and the 4-byte copies (K or N off
# 8)
GMM_BF16_SHAPES = [s for s in MOE_SHAPES if s[2] % 2 == 0 and s[3] % 2 == 0]


@pytest.mark.parametrize("shape", GMM_BF16_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_moe_gmm_bf16_matches_plain_version(cuda, shape):
    e, c, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((e, c, k), generator=g, device=cuda).mul_(0.3).to(BF16)
    w = torch.randn((e, k, n), generator=g, device=cuda).mul_(0.3).to(BF16)
    before = moe_gmm.launches
    got = moe_gmm(x, w)
    again = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 2
    assert got.dtype == BF16 and got.shape == (e, c, n)
    assert torch.equal(again, got)
    _one_rounding(got, moe_gmm_ref(x.float(), w.float()))
    del x, w, got, again
    torch.cuda.empty_cache()


def test_moe_gmm_bf16_refusals(cuda):
    x = torch.zeros((2, 4, 8), device=cuda, dtype=BF16)
    w = torch.zeros((2, 8, 12), device=cuda, dtype=BF16)
    with pytest.raises(TypeError):
        moe_gmm(x.half(), w.half())
    with pytest.raises(TypeError):          # mixed: the caller casts
        moe_gmm(x, w.float())
    with pytest.raises(ValueError):         # K odd
        moe_gmm(torch.zeros((2, 4, 7), device=cuda, dtype=BF16),
                torch.zeros((2, 7, 12), device=cuda, dtype=BF16))


@pytest.mark.parametrize("shape", [s for s in GMM_GRAD_SHAPES
                                   if not any(v % 2 for v in s[1:])],
                         ids=lambda s: "x".join(map(str, s)))
def test_moe_gmm_backward_bf16_matches_plain_version(cuda, shape):
    """C, K and N even: each is the contraction of one of the three GEMMs
    (the capacities are multiples of 4)."""
    e, c, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((e, c, k), generator=g, device=cuda).mul_(0.3).to(BF16)
    w = torch.randn((e, k, n), generator=g, device=cuda).mul_(0.3).to(BF16)
    dy = torch.randn((e, c, n), generator=g, device=cuda).mul_(0.3).to(BF16)
    before = moe_gmm.launches
    dx, dw = torch.autograd.grad(
        MoeGmm.apply(x.requires_grad_(), w.requires_grad_()), (x, w), dy)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 3
    assert dx.dtype == dw.dtype == BF16
    xr, wr = (t.detach().float().requires_grad_() for t in (x, w))
    ex, ew = torch.autograd.grad(moe_gmm_ref(xr, wr), (xr, wr), dy.float())
    _one_rounding(dx, ex, "dx")
    _one_rounding(dw, ew, "dw")
    del x, w, dy, dx, dw, ex, ew, xr, wr
    torch.cuda.empty_cache()


# B5 in bf16: (xdt and a_dt, b and c, y) dtypes of the kernel's contract
# and of the model at bf16 compute
SCAN_BF16 = {"bf16": (BF16, BF16, None), "model": (torch.float32, BF16,
                                                  torch.float32)}


@pytest.mark.parametrize("combo", sorted(SCAN_BF16))
@pytest.mark.parametrize("init", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("shape", SCAN_SHAPES[:9] + SCAN_SHAPES[13:15],
                         ids=lambda s: "x".join(map(str, s)))
def test_mamba_chunk_scan_bf16_matches_plain_version(cuda, shape, init,
                                                     combo):
    xt, bt, yt = SCAN_BF16[combo]
    x, a, b, c, s0 = _scan_inputs(shape, cuda)
    x, a, b, c = x.to(xt), a.to(xt), b.to(bt), c.to(bt)
    s0 = s0 if init else None
    before = mamba_chunk_scan.launches
    y, st = mamba_chunk_scan(x, a, b, c, s0, yt)
    y2, st2 = mamba_chunk_scan(x, a, b, c, s0, yt)
    torch.cuda.synchronize()
    assert mamba_chunk_scan.launches == before + 2
    assert y.dtype == (yt or xt) and st.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(st, st2)
    yr, str_ = mamba_chunk_scan_ref(*(t.float() for t in (x, a, b, c)), s0)
    _one_rounding(y, yr, "y")
    tol = 1e-4 * max(1.0, float(str_.abs().max()))
    assert float((st - str_).abs().max()) < tol


@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mamba_chunk_scan_backward_bf16_matches_plain_version(cuda, shape):
    """``MambaChunkScan`` at the model's dtypes (fp32 xdt and a_dt, bf16 b
    and c) with y in fp32 (what the backward reads): each gradient in its
    input's dtype, one rounding away from the fp64 plain backward on the
    widened inputs, a repeat bitwise equal."""
    xt, bt, _ = SCAN_BF16["model"]
    x, a, b, c, _ = _scan_inputs(shape, cuda, seed=2)
    x, a, b, c = x.to(xt), a.to(xt), b.to(bt), c.to(bt)
    dy = torch.randn(x.shape, generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    want = mamba_chunk_scan_backward_ref(
        *(t.double() for t in (x, a, b, c)), None, dy.double(), None)[:4]
    runs = []
    for _ in range(2):
        ins = [t.clone().requires_grad_() for t in (x, a, b, c)]
        before = mamba_chunk_scan_backward.launches
        y, _ = MambaChunkScan.apply(*ins, None, torch.float32)
        assert y.dtype == torch.float32
        runs.append(torch.autograd.grad(y, ins, dy))
        torch.cuda.synchronize()
        assert mamba_chunk_scan_backward.launches == before + 1
    for name, got, again, exact, t in zip("xabc", runs[0], runs[1], want,
                                          (x, a, b, c)):
        assert got.dtype == t.dtype
        _one_rounding(got, exact, name)
        assert torch.equal(got, again)


def test_mamba_chunk_scan_bf16_refusals(cuda):
    x, a, b, c, s0 = _scan_inputs((1, 2, 16, 2, 16, 16), cuda)
    with pytest.raises(TypeError):                  # fp16
        mamba_chunk_scan(x.half(), a.half(), b.half(), c.half())
    with pytest.raises(TypeError):                  # bf16 xdt, fp32 b and c
        mamba_chunk_scan(x.to(BF16), a.to(BF16), b, c)
    with pytest.raises(TypeError):                  # a bf16 state
        mamba_chunk_scan(x, a, b, c, s0.to(BF16))
    with pytest.raises(TypeError):                  # the backward reads fp32 y
        MambaChunkScan.apply(*(t.to(BF16).requires_grad_()
                               for t in (x, a, b, c)), None, None)
    with pytest.raises(TypeError):                  # bf16 xdt: forward only
        MambaChunkScan.apply(*(t.to(BF16).requires_grad_()
                               for t in (x, a, b, c)), None, torch.float32)
    with pytest.raises(TypeError):                  # no fp32 y from bf16 xdt
        mamba_chunk_scan(*(t.to(BF16) for t in (x, a, b, c)), None,
                         torch.float32)


# ---------------------------------------------------------------------------
# the sharded data plane's per-rank shapes (chip_smoke 3i) and TP = 1 on NCCL
# ---------------------------------------------------------------------------

# h2o-danube-1.8b's attention on one rank: H 16 / Hkv 4 at TP 2, H 8 /
# Hkv 2 at TP 4 (D 80, pages of 128), a mixed step and a decode batch
SHARD_LAYOUTS = [
    ([40, 1, 0, 1, 17], [90, 200, 0, 379, 0], 16, 4, 80, 128, 3, None),
    ([1] * 8, [5, 60, 127, 128, 200, 255, 300, 380], 16, 4, 80, 128, 3,
     None),
    ([40, 1, 0, 1, 17], [90, 200, 0, 379, 0], 8, 2, 80, 128, 3, 100),
    ([1] * 8, [5, 60, 127, 128, 200, 255, 300, 380], 8, 2, 80, 128, 3,
     None),
]


@pytest.mark.parametrize("layout", SHARD_LAYOUTS,
                         ids=["tp2_mixed", "tp2_decode", "tp4_mixed_swa",
                              "tp4_decode"])
def test_attention_kernels_at_per_shard_heads(cuda, layout):
    """B1 in fp32 and B2 in int8 at a rank's heads, against their plain
    versions at 1e-4, stream padding rows 0."""
    *shape, window = layout
    args = _inputs(*shape, cuda)
    got = paged_attention_ragged(*args, window=window)
    want = paged_attention_ragged_ref(*args, window=window)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL
    assert torch.all(got[sum(layout[0]):] == 0)
    qargs = _quant_inputs("int8", shape, cuda)
    got = paged_attention_ragged_quant(*qargs, window=window)
    want = paged_attention_ragged_quant_ref(*qargs, window=window)
    assert float((got - want).abs().max()) <= ATOL
    assert torch.all(got[sum(layout[0]):] == 0)


@pytest.mark.parametrize("c", [8, 640])
@pytest.mark.parametrize("kn", [(4096, 14336), (14336, 4096)],
                         ids=["gate_up", "down"])
def test_moe_gmm_at_per_rank_experts(cuda, c, kn):
    """B4 at mixtral-8x7b's experts on one rank at TP 2 (E 4), decode and
    prefill capacities, at 2e-4·√K, a repeat bitwise."""
    k, n = kn
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((4, c, k), generator=g, device=cuda).mul_(0.3)
    w = torch.randn((4, k, n), generator=g, device=cuda).mul_(0.3)
    got = moe_gmm(x, w)
    assert float((got - moe_gmm_ref(x, w)).abs().max()) < 2e-4 * k ** 0.5
    assert torch.equal(moe_gmm(x, w), got)
    del x, w, got
    torch.cuda.empty_cache()


def _tp1_rank(rank, world, kv_dtype):
    """One NCCL rank: the reduced h2o-danube-1.8b served on the model
    clock by a 1 × 1 mesh's executor and by ``mesh=None``'s on the same
    weights; every dispatch's logits of both, and their tokens."""
    from repro_torch.launch.mesh import make_test_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_test_mesh(data=1, model=1)
    cfg = get_reduced("h2o-danube-1.8b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                         "cuda")
    clock = LinearCostModel(a=1e-3, b=1e-4, c=0.0)
    out = {}
    for key, m in (("single", None), ("mesh", mesh)):
        ex = PagedTransformerExecutor(cfg, params, num_pages=64,
                                      page_size=16, max_pages_per_seq=8,
                                      kv_dtype=kv_dtype, mesh=m,
                                      device="cuda")
        logs, step = [], ex._fused_step
        ex._fused_step = lambda st, t, _s=step, _l=logs: (
            lambda lg: (_l.append(lg.cpu()), lg)[1])(_s(st, t))
        eng = Engine(make_scheduler("fairbatching", clock, calibrate=False),
                     ModelTimedExecutor(ex, clock),
                     EngineConfig(ttft_slo=30.0, tpot_slo=2.0))
        rng = np.random.default_rng(2)
        for i in range(5):
            toks = [int(t) for t in rng.integers(0, cfg.vocab, 8 + 9 * i)]
            eng.submit(Request(i, arrival=0.01 * i, prompt_len=len(toks),
                               max_new_tokens=6, ttft_slo=30.0,
                               tpot_slo=2.0, tokens=toks))
        while eng.has_work:
            eng.step()
        out[key] = (logs, {r: list(q.generated_tokens)
                           for r, q in eng.requests.items()})
    (a, ta), (b, tb) = out["single"], out["mesh"]
    return {"dispatches": len(b), "tokens_equal": ta == tb,
            "bitwise": len(a) == len(b) and all(
                torch.equal(x, y) for x, y in zip(a, b))}


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_tp1_nccl_logits_bitwise_equal_single_device(cuda, kv_dtype):
    """A 1 × 1 mesh on NCCL runs the sharded path (its all-reduces and
    broadcasts over one rank) and gives every dispatch's logits bit for
    bit as ``mesh=None`` does."""
    from repro_torch.launch.mesh import spawn
    rec, = spawn(_tp1_rank, 1, "nccl", kv_dtype, timeout=300)
    assert rec["dispatches"] > 5
    assert rec["tokens_equal"] and rec["bitwise"]


def test_launch_cell_decode_held_to_its_dry_run(cuda):
    """chip_smoke 7a (iii): mamba2-1.3b ``decode_32k`` at its production
    batch of 128, the cache full (states and convolution tails drawn, as
    after 32 767 tokens): the materialised arguments' bytes and the
    outputs' equal the dry run's, the card's FLOPs the abstract run's,
    and its peak, the arguments resident, lies within ±10 % of the dry
    run's ``per_device_hbm_bytes``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost_analysis import analyze, tree_bytes
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import build_cell
    cell = build_cell("mamba2-1.3b", "decode_32k",
                      Mesh.abstract((1, 1), ("data", "model")))
    dry = dryrun.measure(cell)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = cell.materialize("cuda", torch.Generator(device="cuda")
                            .manual_seed(0))
    assert tree_bytes(args) == dry["memory"]["argument_bytes"]
    assert (args[2]["pos"] == 32767).all()
    res = analyze(cell.fn, *args)
    assert res["flops"] == dry["flops"]
    assert res["output_bytes"] == dry["memory"]["output_bytes"]
    assert torch.isfinite(res["output"][0]).all()
    del res
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = cell.fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert abs(peak / dry["per_device_hbm_bytes"] - 1) <= 0.10, (
        peak, dry["per_device_hbm_bytes"])
    assert torch.isfinite(out[0]).all()
