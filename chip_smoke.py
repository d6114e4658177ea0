#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX and
nothing of the JAX package. Phases, each printing its own lines:

1. device — the card's name and power limit as nvidia-smi gives them.
2. build  — nvcc builds every kernel of the serving path from
   ``src/repro_torch/kernels/csrc`` (seconds and ptxas' resource report).
3. kernel vs plain — ``paged_attention_ragged`` against its plain PyTorch
   version at the serving step's shapes (h2o-danube-1.8b attention: H=32,
   Hkv=8, D=80, fp32; pages of 128 and 16): (a) a mixed step of 4 prefill
   chunks and 60 decode rows, (b) 64 decode rows at context 2048, (c) step
   (a) with a 4096-token window and contexts past it. Max abs error ≤ 1e-4
   (fp32 sums over ≤ 8192 keys; online-softmax rescaling against a one-pass
   softmax). Times by CUDA events (median of 20 after warm-up, kernel,
   plain and library in turns); bound = max(bytes / 3.35 TB/s, FLOPs / 67
   TFLOP/s fp32) over what the step's data needs. The library yardstick is
   ``scaled_dot_product_attention``: one call over every decode row (keys
   padded, boolean mask) plus one call per prefill chunk. Also checks that
   K/V slots outside a sequence's visible range are never read (NaN there
   leaves the output bit-identical).
3b. batched kernel vs plain — ``paged_attention`` (B3) against
   ``paged_attention_ref``, same geometry and pages: (d) decode, 64
   sequences at Tq=1, contexts uniform in 128–4096; (e) verify, 16
   sequences at Tq=4 (γ=3), contexts 128–4096; (f) a sequential prefill
   chunk, 1 sequence at Tq=512 from a position ≤ 3584; (g) step (e) with a
   4096-token window and contexts up to 8192. Same gates, timing and bound
   as phase 3; table columns past a context point at trash page 0. The
   library yardstick is one SDPA call over the padded batched view with a
   boolean mask.
3c. quantized kernel vs plain — ``paged_attention_ragged_quant`` (B2)
   against ``paged_attention_ragged_quant_ref`` on phase 3's steps (a), (b)
   and (c), pages of 128 and 16, with the pools quantized to int8 and to
   fp8-e4m3 (per-row f32 scales on scale pages at permuted ids). Gate:
   max abs error ≤ 1e-4 (both read the same dequantized values; only the
   fp32 summation order differs), and the error against the fp32 oracle
   on the unquantized K/V within the DESIGN.md §14 tolerance
   (tests/test_kernels.py::_quant_attention_tol). Poison: NaN in every
   scale slot a row may not read and 0x7F bytes (NaN in e4m3fn) in those
   value slots leave the output bit-identical. Timing as in phase 3; the
   bound counts 1 byte per K/V element plus 4 per row scale (q, output
   and tables f32 / int32); the library yardstick is phase 3's SDPA over
   the dequantized view, dequantized before timing.
4. serve parity — a 2-layer, full-width h2o-danube-1.8b with one set of
   random weights serves the same 6 requests on the card and on the CPU
   (plain path): greedy tokens equal, first-token logits within 1e-3.
4b. path parity — the same model and requests through ``mode="sequential"``
   (first-token logits within 1e-3), fused + ``commit_horizon=4``, and
   fused + ``speculate=2`` with a ``TruncatedSelfDraft(1)`` and with a
   1-layer ``SmallModelDraft``: tokens equal on card and CPU in each, and
   equal to the card's fused single-step tokens (the stream identity of
   DESIGN.md §12 and §18); ``execute_multi`` ran on the last three. On the
   card every committed horizon and speculative round runs under torch's
   sync debug mode set to raise: no device→host sync before its one copy.
4c. quantized parity — the same model and requests with ``kv_dtype="int8"``
   and ``"fp8_e4m3"``: fused tokens equal on card and CPU (first-token
   logits reported: an element within fp32 noise of a rounding boundary
   may quantize to the neighbouring step on one device); on the card the
   fused batched backend, ``mode="sequential"``, ``commit_horizon=4`` and
   γ=2 with a ``TruncatedSelfDraft(1)`` emit the card's fused single-step
   tokens of the same dtype (DESIGN.md §11/§12/§18 under §14), horizons
   under the sync check; B2 launches once per layer per attention pass,
   B1 and B3 never.
5. serve — the full 24-layer h2o-danube-1.8b (fp32 weights from a seed)
   serves 16 requests through ``Engine`` + the ``fairbatching`` scheduler +
   the fused ``PagedTransformerExecutor``; every request must finish with
   32 tokens in [0, vocab) and the attention kernel must have launched
   exactly n_layers times per dispatch.
5b. serving paths — the same model: (i) ``mode="sequential"`` on phase 5's
   requests; (ii) decode-16: 16 requests at time 0, prompts 256–3072, 64 new
   tokens, fused + ``commit_horizon=8``; (iii) decode-16 with
   ``speculate=3``, ``TruncatedSelfDraft(6)`` and ``commit_horizon=4``.
   Every request finishes with its tokens in [0, vocab); (ii) and (iii)
   ran multi-step / speculative dispatches; the batched kernel launched
   n_layers per sequential dispatch, n_layers × horizon per multi-step
   dispatch and rounds × (γ × draft layers + n_layers) per speculative
   one, the ragged kernel n_layers per fused dispatch. The share of tokens
   equal to a fused single-step run of the same requests is reported, not
   gated (at 24 random-weight layers a near-tie may flip a token).
5c. quantized serving — the same model: serve-16 with ``kv_dtype="int8"``
   and with ``"fp8_e4m3"``, and decode-16 with int8 and
   ``commit_horizon=8``. Every request finishes with its tokens in
   [0, vocab); B2 launched n_layers per fused dispatch and n_layers ×
   horizon per multi-step dispatch, B1 and B3 never. Reports the pools'
   bytes and the share of tokens equal to the fp32 run (not gated).

Lines before the last: one ``{"kernels": [...]}`` JSON object (launches
summed over every serving phase on the card: 4, 4b, 4c, 5, 5b, 5c), and
the card's name and power limit.
The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises: the exit code is then non-zero and no result prints.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get  # noqa: E402
from repro_torch.core import LinearCostModel, make_scheduler  # noqa: E402
from repro_torch.engine import (Engine, EngineConfig,  # noqa: E402
                                PagedTransformerExecutor, Request)
from repro_torch.engine.metrics import summarize  # noqa: E402
from repro_torch.engine.spec_decode import (  # noqa: E402
    SmallModelDraft, TruncatedSelfDraft)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_ragged, paged_attention_ragged_quant)
from repro_torch.kernels.quant import (  # noqa: E402
    dequantize_kv, kv_quant_spec, quantize_kv)
from repro_torch.kernels.ref import (  # noqa: E402
    paged_attention_ragged_quant_ref, paged_attention_ragged_ref,
    paged_attention_ref)
from repro_torch.models.weights import init_params  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
ATOL_KERNEL = 1e-4
ATOL_LOGITS = 1e-3
N_TIMED, N_WARMUP = 20, 3
H, HKV, D = 32, 8, 80            # h2o-danube-1.8b attention geometry


def _emit(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Step:
    """One ragged attention step: the layout and its device tensors."""
    name: str
    q_lens: list
    pos0: list
    ctx: list
    window: object
    page: int
    args: tuple = ()

    def visible(self, s: int) -> tuple[int, int]:
        """[lo, hi): the keys any row of sequence s can see."""
        last = self.pos0[s] + self.q_lens[s] - 1
        hi = min(self.ctx[s], last + 1)
        lo = 0 if self.window is None else max(0, self.pos0[s] - self.window + 1)
        return lo, hi


def _layout(kind: str, rng: np.random.Generator):
    """(q_lens, pos0, ctx, window, max_ctx) of step a, b or c."""
    if kind == "b_decode":
        return [1] * 64, [2047] * 64, [2048] * 64, None, 2048
    window, max_ctx = (None, 4096) if kind == "a_mixed" else (4096, 8192)
    q_lens, pos0, ctx = [], [], []
    for _ in range(4):                     # prefill chunks
        n = int(rng.integers(256, 513))
        p = int(rng.integers(0, min(max_ctx - 512, 3584 * max_ctx // 4096) + 1))
        q_lens.append(n)
        pos0.append(p)
        ctx.append(p + n)
    for _ in range(60):                    # decode rows
        c = int(rng.integers(128, max_ctx + 1))
        q_lens.append(1)
        pos0.append(c - 1)
        ctx.append(c)
    return q_lens, pos0, ctx, window, max_ctx


def make_step(kind: str, page: int, device, seed: int = 0) -> Step:
    rng = np.random.default_rng(seed)
    q_lens, pos0, ctx, window, max_ctx = _layout(kind, rng)
    s = len(q_lens)
    n_pages = -(-max_ctx // page)
    n_rows = sum(q_lens)
    t = n_rows + 5                         # stream padding rows stay zero
    q_starts = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    # distinct pages per sequence, in shuffled order; page 0 is trash
    pages = 1 + rng.permutation(s * n_pages).astype(np.int32)
    tables = pages.reshape(s, n_pages)
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    pool_shape = (s * n_pages + 1, page, HKV, D)
    dev = torch.device(device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    args = (randn(t, H, D), randn(*pool_shape), randn(*pool_shape),
            i32(tables), i32(ctx), i32(q_starts), i32(q_lens), i32(pos0))
    return Step(kind, q_lens, pos0, ctx, window, page, args)


def step_bound(st: Step, kv_bytes: int = 4, scale_bytes: int = 0) -> dict:
    """Least time for the work this step's data needs: each input byte read
    once, each output byte written once; FLOPs of QK and PV over the keys
    each row sees. ``kv_bytes`` per K/V element and ``scale_bytes`` per
    (key, KV head) row scale; a quantized step also reads a scale-table
    entry per page."""
    q = st.args[0]
    t = q.shape[0]
    g = H // HKV
    keys = flops = 0
    for s in range(len(st.q_lens)):
        lo, hi = st.visible(s)
        keys += max(hi - lo, 0)
        for r in range(st.q_lens[s]):
            qp = st.pos0[s] + r
            k_hi = min(st.ctx[s], qp + 1)
            k_lo = 0 if st.window is None else max(0, qp - st.window + 1)
            flops += max(k_hi - k_lo, 0) * HKV * g * D * 4
    n_rows = sum(st.q_lens)
    pages_read = sum(-(-(hi) // st.page) - lo // st.page
                     for lo, hi in map(st.visible, range(len(st.q_lens))))
    tables = 2 if scale_bytes else 1
    nbytes = (n_rows * H * D * 4                  # q rows owned
              + keys * HKV * (D * kv_bytes + scale_bytes) * 2  # K, V rows
              + pages_read * 4 * tables + len(st.q_lens) * 4 * 4
              + t * H * D * 4)                    # output, padding included
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops}


def library_call(st: Step):
    """The SDPA yardstick: returns (fn, check) where ``fn()`` runs one SDPA
    call over all decode rows (keys padded, boolean mask) and one per
    prefill chunk, and ``check(outs)`` gives its max abs error against the
    plain version on the rows it covers. Gathering is set-up, not timed."""
    import torch.nn.functional as F
    q, kp, vp, tables = st.args[:4]
    page, g = st.page, H // HKV
    dev = q.device
    starts = np.concatenate([[0], np.cumsum(st.q_lens)[:-1]])

    def gathered(s, lo, hi):
        idx = torch.arange(lo, hi, device=dev)
        pg = tables[s].long()[idx // page]
        k = kp[pg, idx % page]                      # (L, Hkv, D)
        v = vp[pg, idx % page]
        return (k.repeat_interleave(g, 1).transpose(0, 1),
                v.repeat_interleave(g, 1).transpose(0, 1))   # (H, L, D)

    calls = []
    dec = [s for s in range(len(st.q_lens)) if st.q_lens[s] == 1]
    pre = [s for s in range(len(st.q_lens)) if st.q_lens[s] > 1]
    if dec:
        spans = [st.visible(s) for s in dec]
        width = max(hi - lo for lo, hi in spans)
        kb = torch.zeros(len(dec), H, width, D, device=dev)
        vb = torch.zeros_like(kb)
        mask = torch.zeros(len(dec), 1, 1, width, dtype=torch.bool, device=dev)
        for i, (s, (lo, hi)) in enumerate(zip(dec, spans)):
            kb[i, :, :hi - lo], vb[i, :, :hi - lo] = gathered(s, lo, hi)
            mask[i, 0, 0, :hi - lo] = True
        rows = torch.as_tensor(starts[dec], device=dev)
        qb = q[rows].unsqueeze(2)                    # (n, H, 1, D)
        calls.append(("decode", rows, qb, kb, vb, mask))
    for s in pre:
        lo, hi = st.visible(s)
        k, v = gathered(s, lo, hi)
        rows = torch.arange(starts[s], starts[s] + st.q_lens[s], device=dev)
        qp = st.pos0[s] + torch.arange(st.q_lens[s], device=dev)[:, None]
        kv = torch.arange(lo, hi, device=dev)[None]
        m = kv <= qp
        if st.window is not None:
            m &= (qp - kv) < st.window
        calls.append(("chunk", rows, q[rows].transpose(0, 1)[None], k[None],
                      v[None], m[None, None]))

    def fn():
        return [F.scaled_dot_product_attention(qb, kb, vb, attn_mask=m)
                for _, _, qb, kb, vb, m in calls]

    def check(outs, expect):
        err = 0.0
        for (kind, rows, *_), o in zip(calls, outs):
            got = o[:, :, 0] if kind == "decode" else o[0].transpose(0, 1)
            err = max(err, float((got - expect[rows]).abs().max()))
        return err

    return fn, check


def cuda_timer(fn) -> float:
    """Milliseconds of one call, by CUDA events on the current stream."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def time_in_turns(timer, kern, plain, library) -> dict:
    """Median ms of the kernel, its plain version and the library call,
    timed in turns, over N_TIMED rounds after N_WARMUP."""
    ts = {"ms": [], "plain_ms": [], "library_ms": []}
    for i in range(N_WARMUP + N_TIMED):
        for key, fn in (("ms", kern), ("plain_ms", plain),
                        ("library_ms", library)):
            dt = timer(fn)
            if i >= N_WARMUP:
                ts[key].append(dt)
    return {k: statistics.median(v) for k, v in ts.items()}


def poisoned(st):
    """Copies of the pools of ``st`` (a ``Step`` or ``BStep``) with NaN in
    every slot no row of its sequence may read: before the window's first
    key and at or past the context — trash page 0 included, where a batched
    step's table columns past each context point."""
    kp, vp, tables = st.args[1].clone(), st.args[2].clone(), st.args[3]
    kv = torch.arange(tables.shape[1] * st.page, device=kp.device)
    for s in range(len(st.ctx)):
        lo, _ = st.visible(s)
        bad = (kv < lo) | (kv >= st.ctx[s])
        pg = tables[s].long()[kv[bad] // st.page]
        kp[pg, kv[bad] % st.page] = float("nan")
        vp[pg, kv[bad] % st.page] = float("nan")
    return kp, vp


def check_kernel(st: Step, timer, timed: bool) -> dict:
    """Kernel vs plain version on ``st``; times all three when ``timed``."""
    q, kp, vp, *meta = st.args
    kern = lambda: paged_attention_ragged(q, kp, vp, *meta, window=st.window)
    plain = lambda: paged_attention_ragged_ref(q, kp, vp, *meta,
                                               window=st.window)
    got, want = kern(), plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{st.name}/page {st.page}: non-finite output")
    err = float((got - want).abs().max())
    pad = float(got[sum(st.q_lens):].abs().max()) if got.shape[0] > sum(
        st.q_lens) else 0.0
    kp2, vp2 = poisoned(st)
    same = torch.equal(
        paged_attention_ragged(q, kp2, vp2, *meta, window=st.window), got)
    del kp2, vp2
    lib_fn, lib_check = library_call(st)
    lib_err = lib_check(lib_fn(), want)
    rec = {"step": st.name, "page": st.page, "rows": sum(st.q_lens),
           "seqs": len(st.q_lens), "window": st.window,
           "max_abs_err": err, "pad_rows_max": pad, "poison_ok": same,
           "library_max_abs_err": lib_err, **step_bound(st)}
    if err > ATOL_KERNEL or pad != 0.0 or not same:
        _emit("kernel_step", rec)
        raise AssertionError(f"{st.name}/page {st.page}: kernel disagrees "
                             f"with its plain version")
    if timed:
        rec.update(time_in_turns(timer, kern, plain, lib_fn))
    return rec


def phase_kernels(device, timer) -> list:
    recs = []
    for kind in ("a_mixed", "b_decode", "c_window"):
        for page in (128, 16):
            st = make_step(kind, page, device)
            recs.append(check_kernel(st, timer, timed=True))
            _emit("kernel_step", recs[-1])
            del st
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 3b: the batched kernel (B3) against its plain version
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BStep:
    """One batched attention call: the layout and its device tensors."""
    name: str
    tq: int
    q_starts: list
    ctx: list
    window: object
    page: int
    args: tuple = ()

    def visible(self, b: int) -> tuple[int, int]:
        """[lo, hi): the keys any row of sequence b can see."""
        hi = min(self.ctx[b], self.q_starts[b] + self.tq)
        lo = 0 if self.window is None else max(
            0, self.q_starts[b] - self.window + 1)
        return lo, hi


def _blayout(kind: str, rng: np.random.Generator):
    """(batch, Tq, q_starts, ctx, window, max_ctx) of step d, e, f or g."""
    if kind == "f_chunk":
        q0 = int(rng.integers(0, 3584 + 1))
        return 1, 512, [q0], [q0 + 512], None, 4096
    b, tq, window, max_ctx = {"d_decode": (64, 1, None, 4096),
                              "e_verify": (16, 4, None, 4096),
                              "g_window": (16, 4, 4096, 8192)}[kind]
    ctx = [int(c) for c in rng.integers(128, max_ctx + 1, b)]
    return b, tq, [c - tq for c in ctx], ctx, window, max_ctx


def make_bstep(kind: str, page: int, device, seed: int = 0) -> BStep:
    rng = np.random.default_rng(seed)
    b, tq, q_starts, ctx, window, max_ctx = _blayout(kind, rng)
    n_pages = -(-max_ctx // page)
    # distinct pages per sequence, shuffled; the columns past a context
    # point at trash page 0, as the executor's block tables do
    tables = (1 + rng.permutation(b * n_pages)).reshape(b, n_pages)
    for i, c in enumerate(ctx):
        tables[i, -(-c // page):] = 0
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    pool_shape = (b * n_pages + 1, page, HKV, D)
    dev = torch.device(device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    args = (randn(b, tq, H, D), randn(*pool_shape), randn(*pool_shape),
            i32(tables), i32(ctx), i32(q_starts))
    return BStep(kind, tq, q_starts, ctx, window, page, args)


def bstep_bound(st: BStep) -> dict:
    """As ``step_bound``: each input byte read once (q, the visible K/V
    rows, the table entries they need, metadata), the output written once;
    FLOPs of QK and PV over the keys each row sees."""
    g = H // HKV
    b = len(st.ctx)
    keys = flops = pages_read = 0
    for i in range(b):
        lo, hi = st.visible(i)
        keys += max(hi - lo, 0)
        pages_read += max(-(-hi // st.page) - lo // st.page, 0)
        for t in range(st.tq):
            qp = st.q_starts[i] + t
            k_hi = min(st.ctx[i], qp + 1)
            k_lo = 0 if st.window is None else max(0, qp - st.window + 1)
            flops += max(k_hi - k_lo, 0) * HKV * g * D * 4
    q_bytes = b * st.tq * H * D * 4
    nbytes = (q_bytes + keys * HKV * D * 4 * 2 + pages_read * 4 + b * 2 * 4
              + q_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops}


def blibrary_call(st: BStep):
    """The SDPA yardstick: one call over the padded batched view (the keys
    each sequence can see, padded to the widest, boolean mask). Gathering
    is set-up, not timed. Returns (fn, check) as ``library_call``."""
    import torch.nn.functional as F
    q, kp, vp, tables = st.args[:4]
    g, b = H // HKV, len(st.ctx)
    dev = q.device
    spans = [st.visible(i) for i in range(b)]
    width = max(hi - lo for lo, hi in spans)
    kb = torch.zeros(b, H, width, D, device=dev)
    vb = torch.zeros_like(kb)
    mask = torch.zeros(b, 1, st.tq, width, dtype=torch.bool, device=dev)
    for i, (lo, hi) in enumerate(spans):
        idx = torch.arange(lo, hi, device=dev)
        pg = tables[i].long()[idx // st.page]
        kb[i, :, :hi - lo] = kp[pg, idx % st.page].repeat_interleave(
            g, 1).transpose(0, 1)
        vb[i, :, :hi - lo] = vp[pg, idx % st.page].repeat_interleave(
            g, 1).transpose(0, 1)
        qp = st.q_starts[i] + torch.arange(st.tq, device=dev)[:, None]
        m = idx[None] <= qp
        if st.window is not None:
            m &= (qp - idx[None]) < st.window
        mask[i, 0, :, :hi - lo] = m
    qb = q.transpose(1, 2)                           # (B, H, Tq, D)

    def fn():
        return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask)

    def check(out, expect):
        return float((out.transpose(1, 2) - expect).abs().max())

    return fn, check


def check_bkernel(st: BStep, timer) -> dict:
    """Batched kernel vs plain version on ``st``; times all three."""
    q, kp, vp, *meta = st.args
    kern = lambda: paged_attention(q, kp, vp, *meta, window=st.window)
    plain = lambda: paged_attention_ref(q, kp, vp, *meta, window=st.window)
    got, want = kern(), plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{st.name}/page {st.page}: non-finite output")
    err = float((got - want).abs().max())
    kp2, vp2 = poisoned(st)
    same = torch.equal(
        paged_attention(q, kp2, vp2, *meta, window=st.window), got)
    del kp2, vp2
    lib_fn, lib_check = blibrary_call(st)
    lib_err = lib_check(lib_fn(), want)
    rec = {"step": st.name, "page": st.page, "batch": len(st.ctx),
           "tq": st.tq, "window": st.window, "max_abs_err": err,
           "poison_ok": same, "library_max_abs_err": lib_err,
           **bstep_bound(st)}
    if err > ATOL_KERNEL or not same:
        _emit("batched_kernel_step", rec)
        raise AssertionError(f"{st.name}/page {st.page}: batched kernel "
                             f"disagrees with its plain version")
    rec.update(time_in_turns(timer, kern, plain, lib_fn))
    return rec


def phase_batched_kernels(device, timer) -> list:
    recs = []
    for kind in ("d_decode", "e_verify", "f_chunk", "g_window"):
        for page in (128, 16):
            st = make_bstep(kind, page, device)
            recs.append(check_bkernel(st, timer))
            _emit("batched_kernel_step", recs[-1])
            del st
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 3c: the quantized ragged kernel (B2) against its plain version
# ---------------------------------------------------------------------------

def quantize_step(st: Step, fmt: str, seed: int = 0):
    """``st``'s pools quantized to ``fmt``, scale pages at permuted ids.
    Returns (the B2 argument tuple, the dequantized pools (data-page
    order), the spec)."""
    q, kp, vp, tables, *meta = st.args
    spec = kv_quant_spec(fmt, q.device)
    kq, ks = quantize_kv(kp, spec)
    vq, vs = quantize_kv(vp, spec)
    deq = (dequantize_kv(kq, ks), dequantize_kv(vq, vs))
    perm = torch.as_tensor(np.random.default_rng(seed + 1).permutation(
        kp.shape[0]), device=q.device)
    inv = torch.argsort(perm)
    stables = perm[tables.long()].to(torch.int32)
    args = (q, kq, vq, ks[inv].contiguous(), vs[inv].contiguous(), tables,
            stables, *meta)
    return args, deq, spec


def quant_tol(q, kp, vp, spec) -> float:
    """tests/test_kernels.py::_quant_attention_tol: the §14 bound on the
    quantized attention's distance from the fp32 oracle."""
    q1 = float(q.abs().sum(-1).max())
    kmax, vmax = float(kp.abs().max()), float(vp.abs().max())
    delta = D ** -0.5 * q1 * kmax * spec.half_step
    return (math.exp(2.0 * delta) - 1.0) * vmax + vmax * spec.half_step + 1e-6


def poisoned_quant(st: Step, qargs):
    """Copies of the quantized pools with 0x7F bytes (NaN in e4m3fn) in
    every value slot no row of its sequence may read and NaN in those
    slots' scales."""
    _, kq, vq, ks, vs, tables, stables = qargs[:7]
    kb, vb = kq.view(torch.uint8).clone(), vq.view(torch.uint8).clone()
    ks2, vs2 = ks.clone(), vs.clone()
    kv = torch.arange(tables.shape[1] * st.page, device=kq.device)
    for s in range(len(st.ctx)):
        lo, _ = st.visible(s)
        bad = (kv < lo) | (kv >= st.ctx[s])
        col, slot = kv[bad] // st.page, kv[bad] % st.page
        kb[tables[s].long()[col], slot] = 0x7F
        vb[tables[s].long()[col], slot] = 0x7F
        ks2[stables[s].long()[col], slot] = float("nan")
        vs2[stables[s].long()[col], slot] = float("nan")
    return kb.view(kq.dtype), vb.view(vq.dtype), ks2, vs2


def check_quant_kernel(st: Step, fmt: str, timer) -> dict:
    """B2 vs its plain version on ``st`` quantized to ``fmt``; times B2,
    the plain version and SDPA over the dequantized view."""
    q, kp, vp, tables, *meta = st.args
    args, (kd, vd), spec = quantize_step(st, fmt)
    kern = lambda: paged_attention_ragged_quant(*args, window=st.window)
    plain = lambda: paged_attention_ragged_quant_ref(*args, window=st.window)
    got, want = kern(), plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{st.name}/{fmt}/page {st.page}: non-finite")
    err = float((got - want).abs().max())
    fp32 = paged_attention_ragged_ref(*st.args, window=st.window)
    err32 = float((got - fp32).abs().max())
    tol32 = quant_tol(q, kp, vp, spec)
    del fp32
    pad = float(got[sum(st.q_lens):].abs().max()) if got.shape[0] > sum(
        st.q_lens) else 0.0
    same = torch.equal(paged_attention_ragged_quant(
        q, *poisoned_quant(st, args), *args[5:], window=st.window), got)
    # the yardstick reads the dequantized pools: dequantizing is set-up
    lib_fn, lib_check = library_call(dataclasses.replace(
        st, args=(q, kd, vd, tables, *meta)))
    lib_err = lib_check(lib_fn(), want)
    rec = {"step": st.name, "format": fmt, "page": st.page,
           "rows": sum(st.q_lens), "seqs": len(st.q_lens),
           "window": st.window, "max_abs_err": err,
           "fp32_oracle_max_abs_err": err32, "s14_tolerance": tol32,
           "pad_rows_max": pad, "poison_ok": same,
           "library_max_abs_err": lib_err,
           **step_bound(st, kv_bytes=1, scale_bytes=4)}
    if err > ATOL_KERNEL or err32 > tol32 or pad != 0.0 or not same:
        _emit("quant_kernel_step", rec)
        raise AssertionError(f"{st.name}/{fmt}/page {st.page}: B2 "
                             f"disagrees with its plain version")
    rec.update(time_in_turns(timer, kern, plain, lib_fn))
    return rec


def phase_quant_kernels(device, timer) -> list:
    recs = []
    for kind in ("a_mixed", "b_decode", "c_window"):
        for page in (128, 16):
            st = make_step(kind, page, device)
            for fmt in ("int8", "fp8_e4m3"):
                recs.append(check_quant_kernel(st, fmt, timer))
                _emit("quant_kernel_step", recs[-1])
            del st
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phases 4-5: serving through the engine
# ---------------------------------------------------------------------------

def make_requests(cfg, n: int, prompt_range, new_tokens: int, gap: float,
                  seed: int, slo=(30.0, 2.0)) -> list:
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        toks = [int(x) for x in rng.integers(0, cfg.vocab, plen)]
        reqs.append(Request(i, arrival=gap * i, prompt_len=plen,
                            max_new_tokens=new_tokens, ttft_slo=slo[0],
                            tpot_slo=slo[1], tokens=toks))
    return reqs


KERNELS = {"paged_attention_ragged": paged_attention_ragged,
           "paged_attention": paged_attention,
           "paged_attention_ragged_quant": paged_attention_ragged_quant}
# launches of each kernel summed over every serving run on the card
SERVING_LAUNCHES = {name: 0 for name in KERNELS}


@dataclasses.dataclass
class Served:
    """One serving run: its engine and executor, first-token logits by
    request, wall seconds, each kernel's launches in the run, and the
    (horizon, γ) of every multi-step (γ = 0) or speculative dispatch."""
    eng: Engine
    ex: PagedTransformerExecutor
    first: dict
    wall: float
    launches: dict
    multi: list

    @property
    def tokens(self) -> dict:
        return {r: list(q.generated_tokens)
                for r, q in self.eng.requests.items()}


def _no_sync(fn):
    """``fn`` under torch's sync debug mode set to raise: any device→host
    synchronisation while it runs is an error."""
    def run(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def serve(cfg, params, device, requests, *, page_size, num_pages,
          max_pages_per_seq, capture_logits=False, max_steps=20_000,
          mode="fused", horizon=1, gamma=0, draft=None,
          check_sync=True, kv_dtype="fp32", ragged=True) -> Served:
    """Serve ``requests`` to completion. On the card, with ``check_sync``,
    every committed horizon and speculative round body runs under torch's
    sync debug mode set to raise: it may not wait for the device."""
    ex = PagedTransformerExecutor(cfg, params, num_pages=num_pages,
                                  page_size=page_size,
                                  max_pages_per_seq=max_pages_per_seq,
                                  mode=mode, capture_logits=capture_logits,
                                  kv_dtype=kv_dtype,
                                  ragged_attention=ragged, device=device)
    if draft is not None:
        ex.set_draft(draft)
    cuda = torch.device(device).type == "cuda"
    if cuda and check_sync:
        ex._multi_decode_step = _no_sync(ex._multi_decode_step)
        ex._spec_multi_step = _no_sync(ex._spec_multi_step)
    multi, execute_multi = [], ex.execute_multi

    def recorded(plan, reqs, now, h, *, speculate=0):
        n0 = ex.n_dispatches
        out = execute_multi(plan, reqs, now, h, speculate=speculate)
        if ex.n_dispatches > n0:
            multi.append((h, speculate))
        return out

    ex.execute_multi = recorded
    slo_ttft, slo_tpot = requests[0].ttft_slo, requests[0].tpot_slo
    sched = make_scheduler("fairbatching",
                           LinearCostModel(a=5e-3, b=7e-5, c=4e-8))
    eng = Engine(sched, ex, EngineConfig(ttft_slo=slo_ttft,
                                         tpot_slo=slo_tpot,
                                         commit_horizon=horizon,
                                         speculate=gamma))
    for r in requests:
        eng.submit(r)
    first, n = {}, 0
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    while eng.has_work and n < max_steps:
        eng.step()
        n += 1
        for rid, lg in ex.last_logits.items():
            first.setdefault(rid, lg)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    if eng.has_work:
        raise AssertionError(f"engine still busy after {max_steps} steps")
    if cuda:
        for name, c in launches.items():
            SERVING_LAUNCHES[name] += c
    return Served(eng, ex, first, wall, launches, multi)


PARITY_PAGES = dict(page_size=16, num_pages=64, max_pages_per_seq=8)


def phase_parity(cfg, device) -> tuple[dict, dict]:
    """The same weights and requests on ``device`` and on the CPU; returns
    the record and the card's tokens."""
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    out = {}
    for dev in (device, "cpu"):
        reqs = make_requests(cfg, 6, (8, 64), 8, 0.01, seed=2)
        run = serve(cfg, params, dev, reqs, capture_logits=True,
                    **PARITY_PAGES)
        out[dev] = (run.tokens, run.first)
    (tok_d, lg_d), (tok_c, lg_c) = out[device], out["cpu"]
    err = max(float(np.abs(lg_d[r] - lg_c[r]).max()) for r in lg_c)
    rec = {"requests": len(tok_c), "tokens_equal": tok_d == tok_c,
           "first_logits_max_abs_err": err,
           "tokens": sum(len(v) for v in tok_c.values())}
    _emit("serve_parity", rec)
    if tok_d != tok_c or lg_d.keys() != lg_c.keys() or err > ATOL_LOGITS:
        raise AssertionError("card and CPU runs disagree")
    return rec, tok_d


def phase_path_parity(cfg, device, fused_tokens: dict) -> list:
    """Phase 4's weights and requests through the sequential, multi-step
    and speculative paths, on ``device`` and on the CPU."""
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = init_params(dcfg, torch.Generator().manual_seed(5), "cpu")
    paths = {
        "sequential": dict(mode="sequential", capture_logits=True),
        "multi_h4": dict(horizon=4),
        "spec_self_draft": dict(gamma=2, draft=lambda: TruncatedSelfDraft(1)),
        "spec_small_draft": dict(gamma=2, draft=lambda: SmallModelDraft(
            dcfg, dparams)),
    }
    recs = []
    for name, kw in paths.items():
        kw = dict(kw)
        make_draft = kw.pop("draft", None)
        runs = {}
        for dev in (device, "cpu"):
            reqs = make_requests(cfg, 6, (8, 64), 8, 0.01, seed=2)
            runs[dev] = serve(cfg, params, dev, reqs, **PARITY_PAGES,
                              draft=make_draft() if make_draft else None,
                              **kw)
        d, c = runs[device], runs["cpu"]
        rec = {"path": name, "tokens_equal_cpu": d.tokens == c.tokens,
               "tokens_equal_fused": d.tokens == fused_tokens,
               "dispatches": d.ex.n_dispatches, "steps": len(d.eng.steps),
               "multi_dispatches": len(d.multi), "launches": d.launches,
               "spec_accepted": d.eng.spec_accepted,
               "spec_drafted": d.eng.spec_drafted}
        ok = rec["tokens_equal_cpu"] and rec["tokens_equal_fused"]
        if name == "sequential":
            err = max(float(np.abs(d.first[r] - c.first[r]).max())
                      for r in c.first)
            rec["first_logits_max_abs_err"] = err
            ok &= d.first.keys() == c.first.keys() and err <= ATOL_LOGITS
        else:
            ok &= len(d.multi) >= 1
        _emit("path_parity", rec)
        if not ok:
            raise AssertionError(f"path {name}: card, CPU and fused "
                                 f"single-step runs disagree")
        recs.append(rec)
    return recs


def attention_passes(run: Served, cfg) -> int:
    """Attention launches per layer the run's dispatches imply, each one
    kernel launch: one per fused or sequential dispatch, H per committed
    horizon, and per speculative round γ draft steps (+ the draft's sync
    pass) over the draft's layers plus one verify pass over all."""
    nl = cfg.n_layers
    draft = run.ex.draft
    per_multi = sum(h * ((g + draft.needs_sync_pass) * draft.n_layers + nl
                         if g else nl) for h, g in run.multi)
    return per_multi + nl * (run.ex.n_dispatches - len(run.multi))


def phase_quant_parity(cfg, device) -> list:
    """Phase 4's weights and requests with quantized KV: fused on the card
    and the CPU, then every other path on the card, against the card's
    fused single-step tokens of the same dtype."""
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    paths = {"batched": dict(ragged=False),
             "sequential": dict(mode="sequential"),
             "multi_h4": dict(horizon=4),
             "spec_self_draft": dict(gamma=2, draft=TruncatedSelfDraft)}
    recs = []
    for kv in ("int8", "fp8_e4m3"):
        runs = {}
        for dev in (device, "cpu"):
            reqs = make_requests(cfg, 6, (8, 64), 8, 0.01, seed=2)
            runs[dev] = serve(cfg, params, dev, reqs, capture_logits=True,
                              kv_dtype=kv, **PARITY_PAGES)
        d, c = runs[device], runs["cpu"]
        err = max(float(np.abs(d.first[r] - c.first[r]).max())
                  for r in c.first)
        # logits are reported, not gated: K/V rows that differ by fp32
        # noise between card and CPU may quantize an element to the
        # neighbouring step, so only the tokens must be equal
        rec = {"kv_dtype": kv, "path": "fused", "tokens_equal_cpu":
               d.tokens == c.tokens, "first_logits_max_abs_err": err,
               "dispatches": d.ex.n_dispatches, "launches": d.launches}
        ok = d.tokens == c.tokens and d.first.keys() == c.first.keys()
        runs = {"fused": d}
        for name, kw in paths.items():
            kw = dict(kw)
            make_draft = kw.pop("draft", None)
            reqs = make_requests(cfg, 6, (8, 64), 8, 0.01, seed=2)
            runs[name] = serve(cfg, params, device, reqs, kv_dtype=kv,
                               draft=make_draft(1) if make_draft else None,
                               **PARITY_PAGES, **kw)
        _emit("quant_parity", rec)
        recs.append(rec)
        for name, run in runs.items():
            want = attention_passes(run, cfg)
            prec = {"kv_dtype": kv, "path": name,
                    "tokens_equal_fused": run.tokens == d.tokens,
                    "dispatches": run.ex.n_dispatches,
                    "multi_dispatches": len(run.multi),
                    "launches": run.launches,
                    "expected_quant_launches": want}
            ok &= (prec["tokens_equal_fused"]
                   and run.launches["paged_attention_ragged_quant"] == want
                   and run.launches["paged_attention_ragged"] == 0
                   and run.launches["paged_attention"] == 0)
            if name in ("multi_h4", "spec_self_draft"):
                ok &= len(run.multi) >= 1
            if name != "fused":
                _emit("quant_path_parity", prec)
                recs.append(prec)
        if not ok:
            raise AssertionError(f"{kv}: card, CPU and paths disagree")
        del runs, d, c
    return recs


def _check_outputs(run: Served, cfg, new_tokens: int) -> None:
    for r in run.eng.requests.values():
        toks = r.generated_tokens
        if len(toks) != new_tokens or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"request {r.req_id}: bad output {toks[:8]}")


def _serve_record(run: Served, reqs, cfg, cuda: bool) -> dict:
    s = summarize(run.eng.done, duration=max(run.eng.now, 1e-9))
    n_out = sum(len(r.generated_tokens) for r in run.eng.requests.values())
    # engine-clock step times: a committed horizon's steps get dt / H each
    pre = [st.t_end - st.t_start for st in run.eng.steps if st.n_prefill]
    dec = [st.t_end - st.t_start for st in run.eng.steps if not st.n_prefill]
    return {"model": cfg.name, "layers": cfg.n_layers, "requests": len(reqs),
            "prompt_tokens": sum(r.prompt_len for r in reqs),
            "output_tokens": n_out, "steps": len(run.eng.steps),
            "dispatches": run.ex.n_dispatches,
            "prefill_step_median_s": statistics.median(pre) if pre else None,
            "decode_step_median_s": statistics.median(dec) if dec else None,
            "wall_s": run.wall, "output_tok_per_s": n_out / run.wall,
            "ttft_p50_s": s["ttft_p50"], "ttft_p99_s": s["ttft_p99"],
            "tpot_p50_s": s["tpot_p50"], "tpot_p99_s": s["tpot_p99"],
            "slo_attainment": s["slo_attainment"],
            "bucket_keys": len(run.ex.compile_keys),
            "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated()
                                           if cuda else None)}


SERVE_PAGES = dict(page_size=128, num_pages=1024, max_pages_per_seq=32)


def phase_serve(cfg, device, *, n_req=16, prompt_range=(256, 3072),
                new_tokens=32, gap=0.05, params=None) -> tuple[dict, dict]:
    """The main path at full width: Engine + fairbatching + fused executor.
    Returns the record and the tokens."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device)
    reqs = make_requests(cfg, n_req, prompt_range, new_tokens, gap, seed=3,
                         slo=(10.0, 0.25))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run = serve(cfg, params, device, reqs, **SERVE_PAGES)
    _check_outputs(run, cfg, new_tokens)
    rec = _serve_record(run, reqs, cfg, cuda)
    rec["attention_launches"] = run.launches["paged_attention_ragged"]
    _emit("serve", rec)
    return rec, run.tokens


def _release_memory() -> None:
    """Free the card's memory of finished runs: an executor and its draft
    refer to each other, so their pools wait for the cycle collector."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _share_equal(got: dict, ref: dict) -> float:
    same = sum(a == b for r in ref for a, b in zip(got[r], ref[r]))
    return same / max(sum(len(v) for v in ref.values()), 1)


def phase_serve_paths(cfg, device, params, serve16_tokens: dict) -> list:
    """Sequential mode, committed multi-step decode and speculative decode
    at full width, with their launch counts held to their dispatches."""
    cuda = torch.device(device).type == "cuda"
    serve16 = lambda: make_requests(cfg, 16, (256, 3072), 32, 0.05, seed=3,
                                    slo=(10.0, 0.25))
    decode16 = lambda: make_requests(cfg, 16, (256, 3072), 64, 0.0, seed=3,
                                     slo=(10.0, 0.25))
    if cuda:
        _release_memory()
        torch.cuda.reset_peak_memory_stats()
    ref = serve(cfg, params, device, decode16(), **SERVE_PAGES)
    _check_outputs(ref, cfg, 64)
    decode16_tokens = dict(ref.tokens)
    _emit("serve_path", {"workload": "decode16_fused_reference",
                         **_serve_record(ref, decode16(), cfg, cuda),
                         "launches": ref.launches})
    del ref
    workloads = [
        ("serve16_sequential", serve16, 32, serve16_tokens,
         dict(mode="sequential")),
        ("decode16_multi_h8", decode16, 64, decode16_tokens,
         dict(horizon=8)),
        ("decode16_spec_g3", decode16, 64, decode16_tokens,
         dict(gamma=3, horizon=4, draft=TruncatedSelfDraft(6))),
    ]
    recs = []
    for name, make, new_tokens, ref_tokens, kw in workloads:
        if cuda:
            _release_memory()
            torch.cuda.reset_peak_memory_stats()
        reqs = make()
        run = serve(cfg, params, device, reqs, **SERVE_PAGES, **kw)
        _check_outputs(run, cfg, new_tokens)
        ex, draft = run.ex, run.ex.draft
        # fused single steps launch B1, every other pass B3
        want_b1 = (0 if ex.mode == "sequential"
                   else cfg.n_layers * (ex.n_dispatches - len(run.multi)))
        want_b3 = attention_passes(run, cfg) - want_b1
        rec = {"workload": name, **_serve_record(run, reqs, cfg, cuda),
               "multi_dispatches": len(run.multi),
               "multi_steps": sum(h for h, _ in run.multi),
               "ragged_launches": run.launches["paged_attention_ragged"],
               "batched_launches": run.launches["paged_attention"],
               "expected_ragged_launches": want_b1,
               "expected_batched_launches": want_b3,
               "spec_accepted": run.eng.spec_accepted,
               "spec_drafted": run.eng.spec_drafted,
               "share_tokens_equal_fused": _share_equal(run.tokens,
                                                        ref_tokens)}
        _emit("serve_path", rec)
        if (rec["batched_launches"] != want_b3 or want_b3 == 0
                or rec["ragged_launches"] != want_b1):
            raise AssertionError(f"{name}: launches do not match the "
                                 f"dispatches")
        if ex.mode != "sequential" and not run.multi:
            raise AssertionError(f"{name}: no multi-step dispatch ran")
        recs.append(rec)
        del run, ex, draft
    return recs, decode16_tokens


def pool_bytes(ex) -> int:
    """Bytes of the executor's K/V pools and, quantized, scale pools."""
    pools = [ex.k_pages, ex.v_pages, ex.k_scales, ex.v_scales]
    return sum(p.numel() * p.element_size() for p in pools if p is not None)


def phase_quant_serve(cfg, device, params, serve16_tokens: dict,
                      decode16_tokens: dict) -> list:
    """Full depth with quantized KV: serve-16 in int8 and fp8-e4m3,
    decode-16 in int8 with ``commit_horizon=8``; B2 carries every
    attention pass."""
    cuda = torch.device(device).type == "cuda"
    workloads = [
        ("serve16_int8", 16, 32, 0.05, serve16_tokens,
         dict(kv_dtype="int8")),
        ("serve16_fp8", 16, 32, 0.05, serve16_tokens,
         dict(kv_dtype="fp8_e4m3")),
        ("decode16_int8_multi_h8", 16, 64, 0.0, decode16_tokens,
         dict(kv_dtype="int8", horizon=8)),
    ]
    recs = []
    for name, n, new_tokens, gap, ref_tokens, kw in workloads:
        if cuda:
            _release_memory()
            torch.cuda.reset_peak_memory_stats()
        reqs = make_requests(cfg, n, (256, 3072), new_tokens, gap, seed=3,
                             slo=(10.0, 0.25))
        run = serve(cfg, params, device, reqs, **SERVE_PAGES, **kw)
        _check_outputs(run, cfg, new_tokens)
        want = attention_passes(run, cfg)
        rec = {"workload": name, **_serve_record(run, reqs, cfg, cuda),
               "kv_dtype": kw["kv_dtype"], "pool_bytes": pool_bytes(run.ex),
               "multi_dispatches": len(run.multi),
               "quant_launches": run.launches["paged_attention_ragged_quant"],
               "expected_quant_launches": want,
               "fp32_kernel_launches": run.launches["paged_attention_ragged"]
               + run.launches["paged_attention"],
               "share_tokens_equal_fp32": _share_equal(run.tokens,
                                                       ref_tokens)}
        _emit("quant_serve", rec)
        if (rec["quant_launches"] != want or want == 0
                or rec["fp32_kernel_launches"] != 0):
            raise AssertionError(f"{name}: launches do not match the "
                                 f"dispatches")
        if kw.get("horizon", 1) > 1 and not run.multi:
            raise AssertionError(f"{name}: no multi-step dispatch ran")
        recs.append(rec)
        del run
    return recs


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    _emit("device", {"nvidia_smi": card,
                     "torch": torch.__version__, "cuda": torch.version.cuda,
                     "name": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    info = _build.build()
    _emit("build", {"seconds": time.perf_counter() - t0,
                    "kernels": {n: i["seconds"] for n, i in info.items()}})
    for n, i in info.items():
        for line in i["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {n}: {line.strip()}")

    recs = phase_kernels("cuda", cuda_timer)
    brecs = phase_batched_kernels("cuda", cuda_timer)
    qrecs = phase_quant_kernels("cuda", cuda_timer)
    small = dataclasses.replace(get("h2o-danube-1.8b"), n_layers=2)
    _, fused_tokens = phase_parity(small, "cuda")
    phase_path_parity(small, "cuda", fused_tokens)
    phase_quant_parity(small, "cuda")
    cfg = get("h2o-danube-1.8b")
    _release_memory()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    serve_rec, serve16_tokens = phase_serve(cfg, "cuda", params=params)
    if serve_rec["attention_launches"] == 0 or serve_rec[
            "attention_launches"] != cfg.n_layers * serve_rec["dispatches"]:
        raise AssertionError(
            f"attention launches {serve_rec['attention_launches']} != "
            f"{cfg.n_layers} x {serve_rec['dispatches']} dispatches")
    _, decode16_tokens = phase_serve_paths(cfg, "cuda", params,
                                           serve16_tokens)
    phase_quant_serve(cfg, "cuda", params, serve16_tokens, decode16_tokens)

    main_rec = recs[0]            # step (a), pages of 128: the serving shape
    main_brec = brecs[0]          # step (d), pages of 128: decode batches
    main_qrec = qrecs[0]          # step (a), int8, pages of 128
    kernels = [{
        "name": "paged_attention_ragged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention_ragged.cu",
        "replaces": "src/repro/kernels/paged_attention.py:243",
        "launches": SERVING_LAUNCHES["paged_attention_ragged"],
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"]}, {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:382",
        "launches": SERVING_LAUNCHES["paged_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in brecs),
        "ms": main_brec["ms"], "plain_ms": main_brec["plain_ms"],
        "bound_ms": main_brec["bound_ms"], "bound_by": main_brec["bound_by"],
        "library_ms": main_brec["library_ms"]}, {
        "name": "paged_attention_ragged_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/"
                  "paged_attention_ragged_quant.cu",
        "replaces": "src/repro/kernels/paged_attention.py:309",
        "launches": SERVING_LAUNCHES["paged_attention_ragged_quant"],
        "max_abs_err": max(r["max_abs_err"] for r in qrecs),
        "ms": main_qrec["ms"], "plain_ms": main_qrec["plain_ms"],
        "bound_ms": main_qrec["bound_ms"], "bound_by": main_qrec["bound_by"],
        "library_ms": main_qrec["library_ms"]}]
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError("a kernel of the serving paths never launched")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
