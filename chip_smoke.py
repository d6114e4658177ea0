#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX and
nothing of the JAX package. Phases, each printing its own lines:

1. device — the card's name and power limit as nvidia-smi gives them.
2. build  — nvcc builds every kernel of the serving paths from
   ``src/repro_torch/kernels/csrc`` (seconds and ptxas' resource report).
3. kernel vs plain — ``paged_attention_ragged`` against its plain PyTorch
   version at the serving step's shapes (h2o-danube-1.8b attention: H=32,
   Hkv=8, D=80, fp32; pages of 128 and 16): (a) a mixed step of 4 prefill
   chunks and 60 decode rows, (b) 64 decode rows at context 2048, (c) step
   (a) with a 4096-token window and contexts past it. Max abs error ≤ 1e-4
   (fp32 sums over ≤ 8192 keys; online-softmax rescaling against a one-pass
   softmax). Times by CUDA events (median of 20 after warm-up, kernel,
   plain and library in turns); ``graph_ms`` times the kernel's device
   work alone (CUDA-graph replay; ``ms`` also counts the wrapper's host
   time before the first launch), and % of bound is taken against it;
   bound = max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s fp32) over what the
   step's data needs. The library yardstick is
   ``scaled_dot_product_attention``: one call over every decode row (keys
   padded, boolean mask) plus one call per prefill chunk. Also checks that
   K/V slots outside a sequence's visible range are never read (NaN there
   leaves the output bit-identical).
3b. batched kernel vs plain — ``paged_attention`` (B3) against
   ``paged_attention_ref``, same geometry and pages: (d) decode, 64
   sequences at Tq=1, contexts uniform in 128–4096; (e) verify, 16
   sequences at Tq=4 (γ=3), contexts 128–4096; (f) a sequential prefill
   chunk, 1 sequence at Tq=512 from a position ≤ 3584; (g) step (e) with a
   4096-token window and contexts up to 8192. Same gates, timing (with
   ``graph_ms``) and bound as phase 3; table columns past a context point
   at trash page 0. The library yardstick is one SDPA call over the padded
   batched view with a boolean mask.
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
   the dequantized view, dequantized before timing. Then the split-KV
   decode tiles at their boundaries, pages of 128, both formats: 64
   decode rows at context (o) split - 1, (p) split and (q) split + 1 keys
   (``quant_plan``'s split of 512 for the 2048-key tables of step (b)),
   and (r) 64 rows at 2048 with a 300-key window, which starts inside a
   split. Every step also times B1 (``paged_attention_ragged``) on the
   step's fp32 pools in the same turns (``b1_ms``): the same work at 4
   bytes per element, on the same body's fp32 tiles. ``graph_ms`` and
   ``b1_graph_ms`` time each call's device work alone (CUDA-graph replay):
   a decode step's ~0.1 ms of host time before the first launch is in
   ``ms``, not in them.
3d. expert GEMM vs plain — ``moe_gmm`` (B4) against ``moe_gmm_ref`` and
   ``torch.bmm`` (fp32, TF32 off) at the capacity path's shapes, x and w
   ~ N(0, 0.3²): mixtral-8x7b (E=8, d=4096, f=14336) gate/up (K=4096,
   N=14336) and down (K=14336, N=4096) at the capacity of (h) a 64-token
   decode step (C=20), (i) a 512-token chunk (C=160) and (j) a 2048-token
   chunk (C=640); (k) kimi-k2's gate (E=384, C=4, K=7168, N=2048; w holds
   5.6e9 elements, 22.5 GB, freed before phase 4). Gate: max abs error
   < 2e-4·√K (tests/test_kernels.py) and a second launch bitwise equal;
   the error relative to max|plain| is reported. Timing as in phase 3;
   bound = max(bytes of x, w and the output / 3.35 TB/s, 2·E·C·K·N / 67
   TFLOP/s); ``graph_ms`` and ``library_graph_ms`` time B4's and bmm's
   device work alone (CUDA-graph replay). After phase 5d the same check
   runs at every capacity that phase's serving run launched B4 at (its
   decode and prefill buckets): the shapes of the main path.
3e. SSD chunk scan vs plain — ``mamba_chunk_scan`` (B5) against
   ``mamba_chunk_scan_ref`` at mamba2-1.3b's heads (H=64, P=64, N=128),
   xdt, b, c ~ N(0, 0.3²), a = −|N(0, 1)|·0.1: (l) B=8 × 2048 tokens
   (NC=16 chunks of L=128) and (m) one 32768-token prompt (NC=256), the
   shapes of phase 5e; (n) a 100-token prompt at B=8 (L=100, a prompt
   shorter than the chunk); each from a zero initial state (as the
   model's prefill passes it) and from a state ~ N(0, 0.3²) (the TPU
   kernel has no initial state: an extension). Gate: max abs error ≤
   1e-4·max(1, max|plain|) on y and on the state (fp32 sums over ≤ 128
   steps and 128 state columns in another order), the same against fp64
   on the first sequence's first two heads, a second launch bitwise
   equal. Timing as in phase 3, no library time: no single PyTorch call
   computes the SSD scan; ``graph_ms`` is the call's device work alone
   (CUDA-graph replay), and an ``ssm_launches_ms`` line per step gives
   each of B5's four kernels' device ms a call (``torch.profiler`` over 5
   calls). An ``ssm_occupancy`` line first gives the blocks an SM the
   runtime grants each kernel (``mamba2_scan.occupancy``) and the warps
   that makes. Bound = max(bytes of xdt, a_dt, b, c, y and the
   states / 3.35 TB/s, FLOPs / 67 TFLOP/s), the FLOPs what the inputs
   need: CBᵀ on the L(L+1)/2 pairs j ≤ i once per batch and chunk (B and
   C are shared by the heads), per head and chunk the masked scores
   times X on the same pairs, the chunk's own state (L·N·P FMAs) and,
   where a nonzero state is carried in, C · state (L·N·P).
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
4d. MoE parity — mixtral-8x7b at full width, 2 layers, the port's own
   weights, phase 4's requests, the engine on the cost model's clock
   (``ModelTimedExecutor``), so that card and CPU make the same plans and
   so the same capacity drops: under both ``moe_impl="exact"`` and
   ``"capacity"`` card fused tokens = CPU fused tokens and first-token
   logits within 1e-3; on the card exact fused tokens = ``mode=
   "sequential"`` and ``commit_horizon=4`` tokens. B4 launches three times
   per layer and router chunk of every capacity forward pass and never
   under exact.
4e. SSM parity — mamba2-1.3b at full width with 2 layers, the port's own
   weights (seed 1), through ``DecoderLM.prefill`` (B=2 prompts of 300
   tokens: NC=3 with L=128, the last chunk padded) and 8 greedy
   ``decode_step``s on the card and on the CPU: tokens equal, first
   logits within 1e-3; B5 launched n_layers times in the prefill and
   never in decode, no other kernel.
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
5d. MoE serving — phase 5's serve-16 requests on mixtral-8x7b at every
   published width with 8 of its 32 layers (47.5 GB of fp32 weights,
   seed 0), ``moe_impl="capacity"``, fused, fp32 KV, 512 pages of 128.
   Every request finishes with 32 tokens in [0, vocab); B4 launched what
   the forward passes imply, B1 n_layers per dispatch. Reports the
   serving numbers (host step medians; device time by kernel class is
   ``tools/profile_torch_serve.py --arch mixtral-8x7b --layers 8``'s) and
   B4's launches by capacity, at which phase 3d's check then runs.
5e. SSM serving — mamba2-1.3b at full depth (48 layers, 5.8 GB of fp32
   weights, seed 0) through ``DecoderLM.prefill`` plus greedy
   ``decode_step``s, each step ending on its tokens' copy to the host:
   (i) B=8 prompts of 2048 tokens, then 64 steps; (ii) one prompt of
   32768, then 16 steps. Every token in [0, vocab); B5 launched n_layers
   times per prefill, at a shape phase 3e checked, and never in decode.
   Reports the prefill's seconds and tokens/s, the decode step's median
   host ms, output tokens/s, peak memory, B5's launches and shape.

Lines before the last: one ``{"kernels": [...]}`` JSON object (B1, B3,
B2, B4, B5; launches summed over every serving phase on the card: 4, 4b,
4c, 4d, 4e, 5, 5b, 5c, 5d, 5e; B1's times at step (a), pages of 128,
with step (b)'s as ``decode_*``; B3's at step (d), pages of 128, with
step (f)'s, SDPA's beside, as ``chunk_*``; B2's at step (a), int8, pages
of 128, with B1's time from the same call (``b1_ms``) and step (b)'s as
``decode_*``; B4's at the gate/up shape of the capacity 5d launched it at
most, with the gate/up shape of the largest capacity 5d launched as
``prefill_*``; ``*graph_ms`` are device times alone, by CUDA-graph
replay; B5's at 5e (i)'s shape from a zero state, with 5e (ii)'s as
``long_*``), and the card's name and power limit.
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
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tools"))

from compare_mamba2_scan import device_ms_by_kernel  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import LinearCostModel, make_scheduler  # noqa: E402
from repro_torch.engine import (Engine, EngineConfig,  # noqa: E402
                                PagedTransformerExecutor, Request)
from repro_torch.engine.metrics import summarize  # noqa: E402
from repro_torch.engine.numerics import ModelTimedExecutor  # noqa: E402
from repro_torch.engine.spec_decode import (  # noqa: E402
    SmallModelDraft, TruncatedSelfDraft)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mamba2_scan  # noqa: E402
from repro_torch.kernels.mamba2_scan import mamba_chunk_scan  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_ragged, paged_attention_ragged_quant)
from repro_torch.kernels.quant import (  # noqa: E402
    dequantize_kv, kv_quant_spec, quantize_kv)
from repro_torch.kernels.ref import (  # noqa: E402
    mamba_chunk_scan_ref, moe_gmm_ref, paged_attention_ragged_quant_ref,
    paged_attention_ragged_ref, paged_attention_ref)
from repro_torch.models.lm import DecoderLM  # noqa: E402
from repro_torch.models.moe import (  # noqa: E402
    _capacity, chunk_capacity, router_chunks)
from repro_torch.models.weights import init_params, params_to  # noqa: E402

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


# phase 3c's split-boundary steps: 64 decode rows at this context and
# window over step (b)'s 2048-key tables (quant_plan: splits of 512)
SPLIT_STEPS = {"o_ctx511": (511, None), "p_ctx512": (512, None),
               "q_ctx513": (513, None), "r_window300": (2048, 300)}


def _layout(kind: str, rng: np.random.Generator):
    """(q_lens, pos0, ctx, window, max_ctx) of step a, b, c or one of
    ``SPLIT_STEPS``."""
    if kind == "b_decode":
        return [1] * 64, [2047] * 64, [2048] * 64, None, 2048
    if kind in SPLIT_STEPS:
        c, window = SPLIT_STEPS[kind]
        return [1] * 64, [c - 1] * 64, [c] * 64, window, 2048
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


def graph_timer(fn, reps: int = 5, windows: int = 3) -> float:
    """Milliseconds of one call's device work alone: the call captured in a
    CUDA graph and replayed ``reps`` times between two events, the median
    of ``windows`` (``cuda_timer`` of one call from an idle card also
    counts the host's time to the first launch)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                  # warm up off the capture stream, as CUDA wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = [cuda_timer(lambda: [graph.replay() for _ in range(reps)]) / reps
             for _ in range(windows)]
    del graph
    return statistics.median(times)


def time_in_turns(timer, kern, plain, library, **others) -> dict:
    """Median ms of the kernel, its plain version and the library call,
    timed in turns, over N_TIMED rounds after N_WARMUP. ``library`` None:
    no single PyTorch call computes the function, ``library_ms`` is None.
    ``others`` (name: function) are timed in the same turns."""
    fns = {"ms": kern, "plain_ms": plain, "library_ms": library, **others}
    ts = {k: [] for k, fn in fns.items() if fn is not None}
    for i in range(N_WARMUP + N_TIMED):
        for key in ts:
            dt = timer(fns[key])
            if i >= N_WARMUP:
                ts[key].append(dt)
    return {"library_ms": None,
            **{k: statistics.median(v) for k, v in ts.items()}}


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
        if q.is_cuda:
            rec["graph_ms"] = graph_timer(kern)
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
    if q.is_cuda:
        rec["graph_ms"] = graph_timer(kern)
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
    b1 = lambda: paged_attention_ragged(q, kp, vp, tables, *meta,
                                        window=st.window)
    rec.update(time_in_turns(timer, kern, plain, lib_fn, b1_ms=b1))
    if q.is_cuda:
        rec.update(graph_ms=graph_timer(kern), b1_graph_ms=graph_timer(b1))
    return rec


def phase_quant_kernels(device, timer) -> list:
    """Phase 3c: steps (a)-(c) at pages of 128 and 16, then the split
    steps (o)-(r) at pages of 128, each in int8 and fp8-e4m3."""
    recs = []
    steps = [(kind, page) for kind in ("a_mixed", "b_decode", "c_window")
             for page in (128, 16)] + [(kind, 128) for kind in SPLIT_STEPS]
    for kind, page in steps:
        st = make_step(kind, page, device)
        for fmt in ("int8", "fp8_e4m3"):
            recs.append(check_quant_kernel(st, fmt, timer))
            _emit("quant_kernel_step", recs[-1])
        del st
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 3d: the expert GEMM (B4) against its plain version
# ---------------------------------------------------------------------------

def moe_steps() -> list:
    """(name, E, C, K, N) of phase 3d: mixtral-8x7b's gate/up (K=d, N=f)
    and down (K=f, N=d) GEMMs at the capacity of a 64-token decode step,
    a 512-token and a 2048-token chunk, then kimi-k2's gate GEMM at a
    64-token decode step."""
    mix, kimi = get("mixtral-8x7b"), get("kimi-k2-1t-a32b")
    steps = []
    for tag, t in (("h_decode64", 64), ("i_chunk512", 512),
                   ("j_chunk2048", 2048)):
        e, c = mix.moe.n_experts, _capacity(t, mix.moe)
        d, f = mix.d_model, mix.moe.d_ff_expert
        steps += [(f"{tag}_gate_up", e, c, d, f), (f"{tag}_down", e, c, f, d)]
    steps.append(("k_kimi_decode64_gate", kimi.moe.n_experts,
                  _capacity(64, kimi.moe), kimi.d_model,
                  kimi.moe.d_ff_expert))
    return steps


def gmm_bound(e: int, c: int, k: int, n: int) -> dict:
    """x and w read once, the output written once, fp32; 2·E·C·K·N FLOPs
    at the fp32 rate of the CUDA cores."""
    nbytes = 4 * (e * c * k + e * k * n + e * c * n)
    flops = 2 * e * c * k * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops}


def check_moe_kernel(name, e, c, k, n, w, timer, device, seed=0) -> dict:
    """B4 vs its plain version and ``torch.bmm`` on x ~ N(0, 0.3²) against
    ``w``; gate: max abs error < 2e-4·√K (tests/test_kernels.py)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((e, c, k), generator=g, device=device).mul_(0.3)
    kern = lambda: moe_gmm(x, w)
    plain = lambda: moe_gmm_ref(x, w)
    library = lambda: torch.bmm(x, w)
    got, want = kern(), plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - want).abs().max())
    tol = 2e-4 * k ** 0.5
    # both against fp64 on the first expert's first rows: the plain
    # version (cuBLAS) may run the same fp32 FMA chain as B4
    rows = min(c, 8)
    exact = x[0, :rows].double() @ w[0].double()
    rec = {"step": name, "E": e, "C": c, "K": k, "N": n,
           "max_abs_err": err, "tolerance": tol,
           "rel_err": err / float(want.abs().max()),
           "fp64_max_abs_err": float((got[0, :rows] - exact).abs().max()),
           "plain_fp64_max_abs_err": float(
               (want[0, :rows] - exact).abs().max()),
           "library_max_abs_err": float((library() - want).abs().max()),
           "repeat_bitwise": torch.equal(kern(), got), **gmm_bound(e, c, k, n)}
    del got, want, exact
    if (err >= tol or rec["fp64_max_abs_err"] >= tol
            or not rec["repeat_bitwise"]):
        _emit("moe_kernel_step", rec)
        raise AssertionError(f"{name}: B4 disagrees with its plain version")
    rec.update(time_in_turns(timer, kern, plain, library))
    if x.is_cuda:
        rec.update(graph_ms=graph_timer(kern),
                   library_graph_ms=graph_timer(library))
    return rec


def phase_moe_kernels(device, timer, steps=None) -> list:
    """Phase 3d. The weights are N(0, 0.3²) like x; one w per (E, K, N),
    freed before the next shape (kimi's holds 22.5 GB)."""
    recs, w, w_shape = [], None, None
    cuda = torch.device(device).type == "cuda"
    for i, (name, e, c, k, n) in enumerate(steps or moe_steps()):
        if (e, k, n) != w_shape:
            del w
            if cuda:
                torch.cuda.empty_cache()
            g = torch.Generator(device=device).manual_seed(100 + i)
            w = torch.randn((e, k, n), generator=g, device=device).mul_(0.3)
            w_shape = (e, k, n)
        recs.append(check_moe_kernel(name, e, c, k, n, w, timer, device, i))
        _emit("moe_kernel_step", recs[-1])
    del w
    if cuda:
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 3e: the SSD chunk scan (B5) against its plain version
# ---------------------------------------------------------------------------

# (name, B, prompt tokens) of phase 3e at mamba2-1.3b's heads: 5e (i)'s and
# (ii)'s shapes, then a prompt shorter than the chunk
SSM_STEPS = (("l_b8_s2048", 8, 2048), ("m_b1_s32768", 1, 32768),
             ("n_b8_s100", 8, 100))


def scan_shape(cfg, batch: int, prompt: int) -> tuple:
    """(B, NC, L, H, P, N) that ``mamba_seq`` gives B5 for ``batch``
    prompts of ``prompt`` tokens: chunks of min(chunk, prompt), the last
    one padded."""
    s = cfg.ssm
    chunk = min(s.chunk, prompt)
    return (batch, -(-prompt // chunk), chunk, s.n_heads(cfg.d_model),
            s.head_dim, s.d_state)


def scan_bound(b, nc, l, h, p, n, carried) -> dict:
    """xdt, a_dt, b, c and y once, fp32, with the initial and the final
    state; FLOPs at the fp32 rate, as many as these
    inputs need: CBᵀ on the L(L+1)/2 pairs j ≤ i the causal mask keeps,
    once per (batch, chunk) (B and C are shared by the heads); per head
    and chunk the masked scores times X on the same pairs and the chunk's
    own state (2·L·N·P), C · state (2·L·N·P) in the ``carried`` chunks a
    nonzero state enters, and the state carried across (2·P·N)."""
    nbytes = 4 * (2 * b * nc * l * h * p + b * nc * l * h + 2 * b * nc * l * n
                  + 2 * b * h * p * n)
    tri = l * (l + 1) // 2
    flops = (b * nc * 2 * n * tri
             + b * nc * h * (2 * p * tri + 2 * l * n * p + 2 * p * n)
             + b * carried * h * 2 * l * n * p)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops}


def check_ssm_kernel(name, shape, nonzero, timer, device, seed=0) -> dict:
    """B5 vs its plain version at ``shape`` (B, NC, L, H, P, N), from a
    zero initial state or (``nonzero``) one ~ N(0, 0.3²). Gate: max abs
    error ≤ 1e-4 · max(1, max|plain|) on y and on the state, the same
    against fp64 on the first sequence's first two heads, a second launch
    bitwise equal."""
    b, nc, l, h, p, n = shape
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shp: torch.randn(shp, generator=g, device=device)
    x = rnd(b, nc, l, h, p).mul_(0.3)
    a = rnd(b, nc, l, h).abs_().mul_(-0.1)
    bm, cm = rnd(b, nc, l, n).mul_(0.3), rnd(b, nc, l, n).mul_(0.3)
    s0 = (rnd(b, h, p, n).mul_(0.3) if nonzero
          else torch.zeros((b, h, p, n), device=device))
    kern = lambda: mamba_chunk_scan(x, a, bm, cm, s0)
    plain = lambda: mamba_chunk_scan_ref(x, a, bm, cm, s0)
    (y, st), (y_p, st_p) = kern(), plain()
    if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
        raise AssertionError(f"{name}: non-finite output")
    tol_y = ATOL_KERNEL * max(1.0, float(y_p.abs().max()))
    tol_st = ATOL_KERNEL * max(1.0, float(st_p.abs().max()))
    y64, st64 = mamba_chunk_scan_ref(
        x[:1, :, :, :2].double(), a[:1, :, :, :2].double(), bm[:1].double(),
        cm[:1].double(), s0[:1, :2].double())
    y2, st2 = kern()
    carried = nc - 1 + int(nonzero)
    rec = {"step": name, "B": b, "NC": nc, "L": l, "H": h, "P": p, "N": n,
           "init_state": "nonzero" if nonzero else "zero",
           "max_abs_err": float((y - y_p).abs().max()),
           "state_max_abs_err": float((st - st_p).abs().max()),
           "tolerance": tol_y, "state_tolerance": tol_st,
           "fp64_max_abs_err": max(
               float((y[:1, :, :, :2] - y64).abs().max()),
               float((st[:1, :2] - st64).abs().max())),
           "plain_fp64_max_abs_err": max(
               float((y_p[:1, :, :, :2] - y64).abs().max()),
               float((st_p[:1, :2] - st64).abs().max())),
           "repeat_bitwise": torch.equal(y2, y) and torch.equal(st2, st),
           **scan_bound(b, nc, l, h, p, n, carried)}
    del y, st, y_p, st_p, y64, st64, y2, st2
    if (rec["max_abs_err"] > tol_y or rec["state_max_abs_err"] > tol_st
            or rec["fp64_max_abs_err"] > tol_y or not rec["repeat_bitwise"]):
        _emit("ssm_kernel_step", rec)
        raise AssertionError(f"{name}: B5 disagrees with its plain version")
    rec.update(time_in_turns(timer, kern, plain, None))
    if torch.device(device).type == "cuda":
        rec["graph_ms"] = graph_timer(kern)
        _emit("ssm_launches_ms", {"step": name,
                                  "ms": device_ms_by_kernel(kern, 5)})
    return rec


def phase_ssm_kernels(device, timer, cfg=None, steps=SSM_STEPS) -> list:
    """Phase 3e at ``cfg``'s heads (mamba2-1.3b by default): every step
    from a zero and from a nonzero initial state; on the card first the
    occupancy the runtime grants B5's kernels."""
    cfg = cfg or get("mamba2-1.3b")
    if torch.device(device).type == "cuda":
        blocks = mamba2_scan.occupancy()
        plan = mamba2_scan.scan_plan(*scan_shape(cfg, *steps[0][1:]))
        _emit("ssm_occupancy", {
            "blocks_per_sm": blocks,
            "warps_per_sm": {k: blocks[k] * launch.threads // 32
                             for k, launch in plan.launches.items()}})
    recs = []
    for i, (name, batch, prompt) in enumerate(steps):
        for nonzero in (False, True):
            tag = f"{name}_{'state' if nonzero else 'zero'}"
            recs.append(check_ssm_kernel(tag, scan_shape(cfg, batch, prompt),
                                         nonzero, timer, device, seed=i))
            _emit("ssm_kernel_step", recs[-1])
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
           "paged_attention_ragged_quant": paged_attention_ragged_quant,
           "moe_gmm": moe_gmm, "mamba2_scan": mamba_chunk_scan}
# launches of each kernel summed over every serving run on the card
SERVING_LAUNCHES = {name: 0 for name in KERNELS}


@dataclasses.dataclass
class Served:
    """One serving run: its engine and executor, first-token logits by
    request, wall seconds, each kernel's launches in the run, the
    (horizon, γ) of every multi-step (γ = 0) or speculative dispatch, and
    the (token rows, layers) of every forward pass."""
    eng: Engine
    ex: PagedTransformerExecutor
    first: dict
    wall: float
    launches: dict
    multi: list
    forwards: list

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


def _record_forwards(ex, forwards: list) -> None:
    """Append (token rows, layers run) for every forward pass of ``ex``:
    the fused step's bucket, and each batched pass's B·T rows (sequential
    chunks and decodes, every step of a committed horizon)."""
    fused_step, forward = ex._fused_step, ex._forward

    def fused(st, t_bucket):
        forwards.append((t_bucket, ex.cfg.n_layers))
        return fused_step(st, t_bucket)

    def batched(x, *args, n_layers=None, **kw):
        forwards.append((x.shape[0] * x.shape[1],
                         ex.cfg.n_layers if n_layers is None else n_layers))
        return forward(x, *args, n_layers=n_layers, **kw)

    ex._fused_step, ex._forward = fused, batched


def serve(cfg, params, device, requests, *, page_size, num_pages,
          max_pages_per_seq, capture_logits=False, max_steps=20_000,
          mode="fused", horizon=1, gamma=0, draft=None,
          check_sync=True, kv_dtype="fp32", ragged=True,
          moe_impl="exact", clock=None) -> Served:
    """Serve ``requests`` to completion. On the card, with ``check_sync``,
    every committed horizon and speculative round body runs under torch's
    sync debug mode set to raise: it may not wait for the device. With a
    ``clock`` (a ``LinearCostModel``) the engine runs on that model's step
    times instead of the wall clock, so that the plans do not depend on
    the device."""
    ex = PagedTransformerExecutor(cfg, params, num_pages=num_pages,
                                  page_size=page_size,
                                  max_pages_per_seq=max_pages_per_seq,
                                  mode=mode, capture_logits=capture_logits,
                                  kv_dtype=kv_dtype,
                                  ragged_attention=ragged,
                                  moe_impl=moe_impl, device=device)
    if draft is not None:
        ex.set_draft(draft)
    forwards: list = []
    _record_forwards(ex, forwards)
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
    if clock is None:
        sched = make_scheduler("fairbatching",
                               LinearCostModel(a=5e-3, b=7e-5, c=4e-8))
        timed = ex
    else:
        sched = make_scheduler("fairbatching", clock, calibrate=False)
        timed = ModelTimedExecutor(ex, clock)
    eng = Engine(sched, timed, EngineConfig(ttft_slo=slo_ttft,
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
    return Served(eng, ex, first, wall, launches, multi, forwards)


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
# phases 4d, 5d: MoE serving (mixtral-8x7b at full width)
# ---------------------------------------------------------------------------

# the card test's cost model: both devices see the same plans
MODEL_CLOCK = LinearCostModel(a=1e-3, b=1e-4, c=0.0)


def phase_moe_parity(cfg, device) -> list:
    """Phase 4d: the port's own weights (seed 1) and phase 4's requests on
    a MoE model, the engine on ``MODEL_CLOCK``. Under ``exact`` and
    ``capacity``: card fused tokens = CPU fused tokens, first-token logits
    within 1e-3. On the card, exact fused tokens = sequential and
    ``commit_horizon=4`` tokens. B4 launches = what the forward passes
    imply: three per layer and router chunk under capacity, none under
    exact."""
    params = init_params(cfg, torch.Generator(device=device).manual_seed(1),
                         device)
    on_cpu = params_to(params, "cpu")
    reqs = lambda: make_requests(cfg, 6, (8, 64), 8, 0.01, seed=2)
    runs = {}
    for impl in ("exact", "capacity"):
        for dev, p in ((device, params), ("cpu", on_cpu)):
            runs[impl, dev] = serve(cfg, p, dev, reqs(), capture_logits=True,
                                    moe_impl=impl, clock=MODEL_CLOCK,
                                    **PARITY_PAGES)
    for name, kw in (("sequential", dict(mode="sequential")),
                     ("multi_h4", dict(horizon=4))):
        runs["exact", name] = serve(cfg, params, device, reqs(),
                                    clock=MODEL_CLOCK, **PARITY_PAGES, **kw)
    recs, ok = [], True
    for impl in ("exact", "capacity"):
        d, c = runs[impl, device], runs[impl, "cpu"]
        first_err = max(float(np.abs(d.first[r] - c.first[r]).max())
                        for r in c.first)
        rec = {"moe_impl": impl, "path": "fused",
               "tokens_equal_cpu": d.tokens == c.tokens,
               "share_tokens_equal_cpu": _share_equal(d.tokens, c.tokens),
               "first_token_logits_max_abs_err": first_err,
               "dispatches": d.ex.n_dispatches,
               "cpu_dispatches": c.ex.n_dispatches,
               "b4_launches": d.launches["moe_gmm"],
               "expected_b4_launches": moe_launches(d, cfg)}
        ok &= (rec["tokens_equal_cpu"] and d.first.keys() == c.first.keys()
               and first_err <= ATOL_LOGITS
               and rec["dispatches"] == rec["cpu_dispatches"]
               and rec["b4_launches"] == rec["expected_b4_launches"])
        if impl == "capacity":
            ok &= rec["b4_launches"] > 0
        _emit("moe_parity", rec)
        recs.append(rec)
    fused = runs["exact", device]
    for name in ("sequential", "multi_h4"):
        run = runs["exact", name]
        rec = {"moe_impl": "exact", "path": name,
               "tokens_equal_fused": run.tokens == fused.tokens,
               "dispatches": run.ex.n_dispatches,
               "multi_dispatches": len(run.multi),
               "b4_launches": run.launches["moe_gmm"]}
        ok &= rec["tokens_equal_fused"] and rec["b4_launches"] == 0
        if name == "multi_h4":
            ok &= len(run.multi) >= 1
        _emit("moe_parity", rec)
        recs.append(rec)
    if not ok:
        raise AssertionError("MoE parity: card, CPU and paths disagree")
    return recs


MOE_SERVE_PAGES = dict(page_size=128, num_pages=512, max_pages_per_seq=32)
MOE_SERVE_LAYERS = 8             # of mixtral-8x7b's 32: 47.5 GB of fp32


def launches_by_capacity(run: Served, cfg) -> dict:
    """B4 launches a run's forward passes imply, by the per-expert
    capacity C they run at, most launched first: under ``capacity`` three
    per layer and router chunk of each pass, under ``exact`` none."""
    out: dict = {}
    if run.ex.moe_impl != "capacity":
        return out
    for rows, layers in run.forwards:
        c = chunk_capacity(rows, cfg.moe)
        out[c] = out.get(c, 0) + 3 * layers * router_chunks(rows, cfg.moe)
    return dict(sorted(out.items(), key=lambda kv: (-kv[1], kv[0])))


def moe_launches(run: Served, cfg) -> int:
    return sum(launches_by_capacity(run, cfg).values())


def serve_moe_steps(by_capacity: dict, cfg) -> list:
    """Phase 3d's (name, E, C, K, N) at every capacity a serving run
    launched B4 at: gate/up (K=d, N=f) and down (K=f, N=d) each."""
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    steps = []
    for c in by_capacity:
        steps += [(f"5d_C{c}_gate_up", e, c, d, f),
                  (f"5d_C{c}_down", e, c, f, d)]
    return steps


def phase_moe_serve(cfg, device, *, params=None) -> dict:
    """Phase 5d: serve-16 on ``cfg`` (mixtral-8x7b, every published width,
    depth cut) with ``moe_impl="capacity"``, fused, fp32 KV, pages of 128
    and 512 of them. Every request finishes with its tokens in [0, vocab);
    B4 launches = what the forward passes imply. Reports the serving
    numbers and B4's launches by capacity."""
    cuda = torch.device(device).type == "cuda"
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device)
    reqs = make_requests(cfg, 16, (256, 3072), 32, 0.05, seed=3,
                         slo=(10.0, 0.25))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run = serve(cfg, params, device, reqs, moe_impl="capacity",
                **MOE_SERVE_PAGES)
    _check_outputs(run, cfg, 32)
    by_c = launches_by_capacity(run, cfg)
    rec = {**_serve_record(run, reqs, cfg, cuda), "moe_impl": "capacity",
           "pool_bytes": pool_bytes(run.ex),
           "b4_launches": run.launches["moe_gmm"],
           "expected_b4_launches": moe_launches(run, cfg),
           "b4_launches_by_capacity": [[c, n] for c, n in by_c.items()],
           "attention_launches": run.launches["paged_attention_ragged"]}
    _emit("moe_serve", rec)
    if (rec["b4_launches"] != rec["expected_b4_launches"]
            or rec["b4_launches"] == 0
            or rec["attention_launches"] != cfg.n_layers
            * run.ex.n_dispatches):
        raise AssertionError("moe serve: launches do not match the "
                             "dispatches")
    return rec


# ---------------------------------------------------------------------------
# phases 4e, 5e: the SSM family through DecoderLM
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Generated:
    """One ``prefill`` plus greedy ``decode_step``s: tokens (B, steps + 1),
    the prefill's logits, host seconds of the prefill and of each step,
    and each kernel's launches in the prefill and in the decode steps."""
    tokens: np.ndarray
    first: np.ndarray
    prefill_s: float
    step_s: list
    prefill_launches: dict
    decode_launches: dict


def generate(cfg, params, device, prompts: np.ndarray, steps: int
             ) -> Generated:
    """The SSM family's main path: ``DecoderLM.prefill`` then ``steps``
    greedy ``decode_step``s, each ending on its tokens' copy to the host,
    as a serving loop checks for a stop token. Every kernel count is set
    to 0 just before and read just after the prefill and the decode
    steps; launches on the card add to ``SERVING_LAUNCHES``."""
    model = DecoderLM(cfg, device=device)
    toks = torch.as_tensor(prompts, device=model.device)
    cuda = model.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, toks, prompts.shape[1] + steps)
    tok = logits.argmax(-1)
    out = [tok.cpu()]
    prefill_s = time.perf_counter() - t0
    pre = {name: k.launches for name, k in KERNELS.items()}
    first = logits.cpu().numpy()
    for k in KERNELS.values():
        k.launches = 0
    step_s = []
    for _ in range(steps):
        t = time.perf_counter()
        logits, cache = model.decode_step(params, tok, cache)
        tok = logits.argmax(-1)
        out.append(tok.cpu())
        step_s.append(time.perf_counter() - t)
    dec = {name: k.launches for name, k in KERNELS.items()}
    if cuda:
        for name in KERNELS:
            SERVING_LAUNCHES[name] += pre[name] + dec[name]
    return Generated(torch.stack(out, 1).numpy(), first, prefill_s, step_s,
                     pre, dec)


def _ssm_launches_ok(run: Generated, cfg, cuda: bool) -> bool:
    """B5 n_layers times in the prefill and never in decode; no other
    kernel anywhere (on the CPU nothing launches)."""
    want = cfg.n_layers if cuda else 0
    others = [n for n in KERNELS if n != "mamba2_scan"]
    return (run.prefill_launches["mamba2_scan"] == want
            and run.decode_launches["mamba2_scan"] == 0
            and all(run.prefill_launches[n] == run.decode_launches[n] == 0
                    for n in others))


def phase_ssm_parity(cfg, device, prompt_len=300, steps=8) -> dict:
    """Phase 4e on ``cfg`` (mamba2-1.3b at full width, depth cut): the
    port's own weights (seed 1), 2 prompts of ``prompt_len`` tokens, then
    ``steps`` greedy decode steps, on ``device`` and on the CPU."""
    cuda = torch.device(device).type == "cuda"
    params = init_params(cfg, torch.Generator(device=device).manual_seed(1),
                         device)
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab, (2, prompt_len)).astype(np.int64)
    d = generate(cfg, params, device, prompts, steps)
    c = generate(cfg, params_to(params, "cpu"), "cpu", prompts, steps)
    rec = {"model": cfg.name, "layers": cfg.n_layers, "batch": 2,
           "prompt_tokens": prompt_len, "decode_steps": steps,
           "tokens_equal_cpu": bool(np.array_equal(d.tokens, c.tokens)),
           "first_logits_max_abs_err": float(np.abs(d.first - c.first).max()),
           "b5_prefill_launches": d.prefill_launches["mamba2_scan"],
           "b5_decode_launches": d.decode_launches["mamba2_scan"],
           "scan_shape": list(scan_shape(cfg, 2, prompt_len))}
    _emit("ssm_parity", rec)
    if (not rec["tokens_equal_cpu"]
            or rec["first_logits_max_abs_err"] > ATOL_LOGITS
            or not _ssm_launches_ok(d, cfg, cuda)):
        raise AssertionError(f"{cfg.name}: card and CPU disagree")
    return rec


# (batch, prompt tokens, greedy decode steps) of phase 5e
SSM_SERVE = ((8, 2048, 64), (1, 32768, 16))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_ssm_serve(cfg, device, workloads=SSM_SERVE) -> list:
    """Phase 5e: ``cfg`` (mamba2-1.3b, every layer) with fp32 weights from
    seed 0 through ``DecoderLM.prefill`` plus greedy ``decode_step``s.
    Every token in [0, vocab), B5 launched n_layers times per prefill at a
    shape phase 3e checked, never in decode."""
    cuda = torch.device(device).type == "cuda"
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    checked = {scan_shape(cfg, b, s) for _, b, s in SSM_STEPS}
    recs = []
    for batch, prompt_len, steps in workloads:
        prompts = np.random.default_rng(5).integers(
            0, cfg.vocab, (batch, prompt_len)).astype(np.int64)
        if cuda:
            _release_memory()
            torch.cuda.reset_peak_memory_stats()
        run = generate(cfg, params, device, prompts, steps)
        n_out = run.tokens.size
        decode_s = sum(run.step_s)
        shape = scan_shape(cfg, batch, prompt_len)
        rec = {"model": cfg.name, "layers": cfg.n_layers, "batch": batch,
               "prompt_tokens": prompt_len, "decode_steps": steps,
               "prefill_s": run.prefill_s,
               "prefill_tok_per_s": batch * prompt_len / run.prefill_s,
               "decode_step_median_ms": statistics.median(run.step_s) * 1e3,
               "decode_tok_per_s": batch * steps / decode_s,
               "output_tokens": n_out,
               "output_tok_per_s": n_out / (run.prefill_s + decode_s),
               "weight_bytes": sum(t.numel() * 4 for t in _leaves(params)),
               "max_memory_allocated_bytes": (
                   torch.cuda.max_memory_allocated() if cuda else None),
               "b5_prefill_launches": run.prefill_launches["mamba2_scan"],
               "b5_decode_launches": run.decode_launches["mamba2_scan"],
               "scan_shape": list(shape)}
        _emit("ssm_serve", rec)
        if (run.tokens.min() < 0 or run.tokens.max() >= cfg.vocab
                or run.tokens.shape != (batch, steps + 1)
                or not _ssm_launches_ok(run, cfg, cuda)
                or shape not in checked):
            raise AssertionError(f"{cfg.name} B={batch} S={prompt_len}: "
                                 f"bad output, launches or shape")
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
    mrecs = phase_moe_kernels("cuda", cuda_timer)
    srecs = phase_ssm_kernels("cuda", cuda_timer)
    small = dataclasses.replace(get("h2o-danube-1.8b"), n_layers=2)
    _, fused_tokens = phase_parity(small, "cuda")
    phase_path_parity(small, "cuda", fused_tokens)
    phase_quant_parity(small, "cuda")
    _release_memory()
    phase_moe_parity(dataclasses.replace(get("mixtral-8x7b"), n_layers=2),
                     "cuda")
    _release_memory()
    phase_ssm_parity(dataclasses.replace(get("mamba2-1.3b"), n_layers=2),
                     "cuda")
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
    del params
    _release_memory()
    mix = dataclasses.replace(get("mixtral-8x7b"), n_layers=MOE_SERVE_LAYERS)
    by_c = dict(phase_moe_serve(mix, "cuda")["b4_launches_by_capacity"])
    _release_memory()
    served_mrecs = phase_moe_kernels("cuda", cuda_timer,
                                     serve_moe_steps(by_c, mix))
    _release_memory()
    phase_ssm_serve(get("mamba2-1.3b"), "cuda")

    main_rec = recs[0]            # step (a), pages of 128: the serving shape
    dec_rec = recs[2]             # step (b), pages of 128
    main_brec = brecs[0]          # step (d), pages of 128: decode batches
    chunk_brec = brecs[4]         # step (f), pages of 128: a prefill chunk
    main_qrec = qrecs[0]          # step (a), int8, pages of 128
    dec_qrec = qrecs[4]           # step (b), int8, pages of 128
    mrecs += served_mrecs
    main_mrec = served_mrecs[0]   # gate/up at 5d's most launched C
    pre_mrec = max((r for r in served_mrecs if r["step"].endswith("gate_up")),
                   key=lambda r: r["C"])   # gate/up at 5d's largest C
    main_srec = srecs[0]          # step (l), zero state: 5e (i)'s shape
    long_srec = srecs[2]          # step (m), zero state: 5e (ii)'s shape
    kernels = [{
        "name": "paged_attention_ragged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention_ragged.cu",
        "replaces": "src/repro/kernels/paged_attention.py:243",
        "launches": SERVING_LAUNCHES["paged_attention_ragged"],
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
        "graph_ms": main_rec["graph_ms"], "decode_ms": dec_rec["ms"],
        "decode_graph_ms": dec_rec["graph_ms"],
        "decode_bound_ms": dec_rec["bound_ms"]}, {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:382",
        "launches": SERVING_LAUNCHES["paged_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in brecs),
        "ms": main_brec["ms"], "plain_ms": main_brec["plain_ms"],
        "bound_ms": main_brec["bound_ms"], "bound_by": main_brec["bound_by"],
        "library_ms": main_brec["library_ms"],
        "graph_ms": main_brec["graph_ms"], "chunk_ms": chunk_brec["ms"],
        "chunk_graph_ms": chunk_brec["graph_ms"],
        "chunk_library_ms": chunk_brec["library_ms"],
        "chunk_bound_ms": chunk_brec["bound_ms"]}, {
        "name": "paged_attention_ragged_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/"
                  "paged_attention_ragged_quant.cu",
        "replaces": "src/repro/kernels/paged_attention.py:309",
        "launches": SERVING_LAUNCHES["paged_attention_ragged_quant"],
        "max_abs_err": max(r["max_abs_err"] for r in qrecs),
        "ms": main_qrec["ms"], "plain_ms": main_qrec["plain_ms"],
        "bound_ms": main_qrec["bound_ms"], "bound_by": main_qrec["bound_by"],
        "library_ms": main_qrec["library_ms"],
        "graph_ms": main_qrec["graph_ms"], "b1_ms": main_qrec["b1_ms"],
        "decode_ms": dec_qrec["ms"], "decode_graph_ms": dec_qrec["graph_ms"],
        "decode_b1_ms": dec_qrec["b1_ms"],
        "decode_bound_ms": dec_qrec["bound_ms"]}, {
        "name": "moe_gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:38",
        "launches": SERVING_LAUNCHES["moe_gmm"],
        "max_abs_err": max(r["max_abs_err"] for r in mrecs),
        "ms": main_mrec["ms"], "plain_ms": main_mrec["plain_ms"],
        "bound_ms": main_mrec["bound_ms"], "bound_by": main_mrec["bound_by"],
        "library_ms": main_mrec["library_ms"],
        "graph_ms": main_mrec["graph_ms"],
        "prefill_C": pre_mrec["C"], "prefill_ms": pre_mrec["ms"],
        "prefill_library_ms": pre_mrec["library_ms"],
        "prefill_graph_ms": pre_mrec["graph_ms"],
        "prefill_library_graph_ms": pre_mrec["library_graph_ms"],
        "prefill_bound_ms": pre_mrec["bound_ms"]}, {
        "name": "mamba2_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba2_scan.cu",
        "replaces": "src/repro/kernels/mamba2_scan.py:64",
        "launches": SERVING_LAUNCHES["mamba2_scan"],
        "max_abs_err": max(max(r["max_abs_err"], r["state_max_abs_err"])
                           for r in srecs),
        "ms": main_srec["ms"], "plain_ms": main_srec["plain_ms"],
        "bound_ms": main_srec["bound_ms"], "bound_by": main_srec["bound_by"],
        "library_ms": main_srec["library_ms"],
        "graph_ms": main_srec["graph_ms"], "long_ms": long_srec["ms"],
        "long_graph_ms": long_srec["graph_ms"],
        "long_bound_ms": long_srec["bound_ms"]}]
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
