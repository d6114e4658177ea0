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
4. serve parity — a 2-layer, full-width h2o-danube-1.8b with one set of
   random weights serves the same 6 requests on the card and on the CPU
   (plain path): greedy tokens equal, first-token logits within 1e-3.
5. serve — the full 24-layer h2o-danube-1.8b (fp32 weights from a seed)
   serves 16 requests through ``Engine`` + the ``fairbatching`` scheduler +
   the fused ``PagedTransformerExecutor``; every request must finish with
   32 tokens in [0, vocab) and the attention kernel must have launched
   exactly n_layers times per dispatch.

Lines before the last: one ``{"kernels": [...]}`` JSON object, and the
card's name and power limit. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises: the exit code is then non-zero and no result prints.
"""
from __future__ import annotations

import dataclasses
import json
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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention_ragged)
from repro_torch.kernels.ref import paged_attention_ragged_ref  # noqa: E402
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


def step_bound(st: Step) -> dict:
    """Least time for the work this step's data needs: each input byte read
    once, each output byte written once; FLOPs of QK and PV over the keys
    each row sees."""
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
    nbytes = (n_rows * H * D * 4                  # q rows owned
              + keys * HKV * D * 4 * 2            # K and V rows visible
              + pages_read * 4 + len(st.q_lens) * 4 * 4   # tables, metadata
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


def poisoned(st: Step):
    """Copies of the pools with NaN in every slot no row of its sequence
    may read: before the window's first key and at or past the context."""
    kp, vp, tables = st.args[1].clone(), st.args[2].clone(), st.args[3]
    n_pages = tables.shape[1]
    for s in range(len(st.q_lens)):
        lo, hi = st.visible(s)
        kv = torch.arange(n_pages * st.page, device=kp.device)
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
        ts = {"ms": [], "plain_ms": [], "library_ms": []}
        for i in range(N_WARMUP + N_TIMED):
            for key, fn in (("ms", kern), ("plain_ms", plain),
                            ("library_ms", lib_fn)):
                dt = timer(fn)
                if i >= N_WARMUP:
                    ts[key].append(dt)
        rec.update({k: statistics.median(v) for k, v in ts.items()})
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


def serve(cfg, params, device, requests, *, page_size, num_pages,
          max_pages_per_seq, capture_logits=False, max_steps=20_000):
    """Serve ``requests`` to completion; returns (engine, executor, first
    logits by request, wall seconds)."""
    ex = PagedTransformerExecutor(cfg, params, num_pages=num_pages,
                                  page_size=page_size,
                                  max_pages_per_seq=max_pages_per_seq,
                                  capture_logits=capture_logits,
                                  device=device)
    slo_ttft, slo_tpot = requests[0].ttft_slo, requests[0].tpot_slo
    sched = make_scheduler("fairbatching",
                           LinearCostModel(a=5e-3, b=7e-5, c=4e-8))
    eng = Engine(sched, ex, EngineConfig(ttft_slo=slo_ttft,
                                         tpot_slo=slo_tpot))
    for r in requests:
        eng.submit(r)
    first, n = {}, 0
    t0 = time.perf_counter()
    while eng.has_work and n < max_steps:
        eng.step()
        n += 1
        for rid, lg in ex.last_logits.items():
            first.setdefault(rid, lg)
    wall = time.perf_counter() - t0
    if eng.has_work:
        raise AssertionError(f"engine still busy after {max_steps} steps")
    return eng, ex, first, wall


def phase_parity(cfg, device) -> dict:
    """The same weights and requests on ``device`` and on the CPU."""
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    out = {}
    for dev in (device, "cpu"):
        reqs = make_requests(cfg, 6, (8, 64), 8, 0.01, seed=2)
        eng, ex, first, _ = serve(cfg, params, dev, reqs, page_size=16,
                                  num_pages=64, max_pages_per_seq=8,
                                  capture_logits=True)
        out[dev] = ({r: list(q.generated_tokens)
                     for r, q in eng.requests.items()}, first)
    (tok_d, lg_d), (tok_c, lg_c) = out[device], out["cpu"]
    err = max(float(np.abs(lg_d[r] - lg_c[r]).max()) for r in lg_c)
    rec = {"requests": len(tok_c), "tokens_equal": tok_d == tok_c,
           "first_logits_max_abs_err": err,
           "tokens": sum(len(v) for v in tok_c.values())}
    _emit("serve_parity", rec)
    if tok_d != tok_c or lg_d.keys() != lg_c.keys() or err > ATOL_LOGITS:
        raise AssertionError("card and CPU runs disagree")
    return rec


def phase_serve(cfg, device, *, n_req=16, prompt_range=(256, 3072),
                new_tokens=32, page_size=128, num_pages=1024,
                max_pages_per_seq=32, gap=0.05) -> dict:
    """The main path at full width: Engine + fairbatching + fused executor."""
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    reqs = make_requests(cfg, n_req, prompt_range, new_tokens, gap, seed=3,
                         slo=(10.0, 0.25))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    paged_attention_ragged.launches = 0
    eng, ex, _, wall = serve(cfg, params, device, reqs, page_size=page_size,
                             num_pages=num_pages,
                             max_pages_per_seq=max_pages_per_seq)
    launches = paged_attention_ragged.launches
    for r in eng.requests.values():
        toks = r.generated_tokens
        if len(toks) != new_tokens or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"request {r.req_id}: bad output {toks[:8]}")
    s = summarize(eng.done, duration=max(eng.now, 1e-9))
    n_out = sum(len(r.generated_tokens) for r in eng.requests.values())
    rec = {"model": cfg.name, "layers": cfg.n_layers, "requests": len(reqs),
           "prompt_tokens": sum(r.prompt_len for r in reqs),
           "output_tokens": n_out, "steps": len(eng.steps),
           "dispatches": ex.n_dispatches, "attention_launches": launches,
           "wall_s": wall, "output_tok_per_s": n_out / wall,
           "ttft_p50_s": s["ttft_p50"], "ttft_p99_s": s["ttft_p99"],
           "tpot_p50_s": s["tpot_p50"], "tpot_p99_s": s["tpot_p99"],
           "slo_attainment": s["slo_attainment"],
           "bucket_keys": len(ex.compile_keys),
           "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated()
                                          if cuda else None)}
    _emit("serve", rec)
    return rec


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
    phase_parity(dataclasses.replace(get("h2o-danube-1.8b"), n_layers=2),
                 "cuda")
    cfg = get("h2o-danube-1.8b")
    torch.cuda.empty_cache()
    serve_rec = phase_serve(cfg, "cuda")
    if serve_rec["attention_launches"] == 0 or serve_rec[
            "attention_launches"] != cfg.n_layers * serve_rec["dispatches"]:
        raise AssertionError(
            f"attention launches {serve_rec['attention_launches']} != "
            f"{cfg.n_layers} x {serve_rec['dispatches']} dispatches")

    main_rec = recs[0]            # step (a), pages of 128: the serving shape
    kernels = [{
        "name": "paged_attention_ragged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention_ragged.cu",
        "replaces": "src/repro/kernels/paged_attention.py:243",
        "launches": serve_rec["attention_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
