#!/usr/bin/env python3
"""Where the port's serving time goes on the card.

    python3 tools/profile_torch_serve.py [--workload serve16|decode16]
        [--horizon H] [--kv-dtype fp32|int8|fp8_e4m3]
        [--arch h2o-danube-1.8b|mixtral-8x7b|mamba2-1.3b|...]
        [--layers N] [--moe-impl exact|capacity]
        [--out build/profile/serve_trace.json]

Serves one of ``chip_smoke.py``'s full-width workloads on ``--arch``
(default h2o-danube-1.8b; ``--layers`` cuts the depth, default the
config's own; a MoE arch runs ``--moe-impl``, default capacity, on
chip_smoke phase 5d's 512 pages of 128) —
``serve16`` (phase 5: 16 seeded requests, prompts of 256-3072 tokens, 32
new tokens, arrivals 50 ms apart) or ``decode16`` (phase 5b: the same
prompts all at time 0, 64 new tokens) — with ``commit_horizon=H``
(default 1, the fused single-step path) and the KV pools stored as
``--kv-dtype`` (default fp32; int8 and fp8_e4m3 quantize on scatter and
attend through kernel B2) three times on one CUDA card:
once to warm up (kernel build, cuBLAS set-up), once untraced, once under
``torch.profiler``. With H > 1 a fourth run repeats the untraced one with
chip_smoke's sync check on (each horizon under torch's sync debug mode),
to show what that check costs. Prints, as JSON lines:

* ``untraced`` / ``traced`` — wall seconds, output tokens/s, and the
  median step time of steps that carry prefill and of decode-only steps
  (a committed horizon's steps count dt / H each; the traced-untraced
  difference is the tracing overhead);
* ``device_time`` — device milliseconds by kernel class (matmul,
  attention (every paged-attention kernel), moe (the expert GEMM B4),
  ssm (the SSD chunk scan B5), KV scatter, other elementwise/index
  kernels — quantization and the MoE dispatch among them — copies) from
  the trace, and each class's share;
* ``ssm_launches_ms`` (SSM archs) — the ``ssm`` class's device ms by
  B5's four launches (chunk prep, chunk states, state pass, chunk scan);
* ``device_busy`` — the union of device activity over the traced serving
  wall time, and its complement, the idle share;
* ``per_step`` — for steps that carry prefill, decode-only steps and
  multi-step dispatches (each executor call is a ``record_function`` span
  in the traced run): the median host time, the median device-busy time
  inside the span, and device time by kernel class per span; for
  multi-step dispatches also host and device-busy time per internal step.

The chrome trace is written to ``--out``. Needs one CUDA card and nvcc;
imports nothing of JAX.

For an SSM arch (mamba2-1.3b) the workload is chip_smoke phase 5e (i)
instead: ``DecoderLM.prefill`` of 8 prompts of 2048 tokens, then 64
greedy ``decode_step``s, each ending on its tokens' copy to the host; the
spans are ``prefill`` and ``decode_step``, and kernel B5 is the ``ssm``
class.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.engine import PagedTransformerExecutor  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models.lm import DecoderLM  # noqa: E402
from repro_torch.models.weights import init_params  # noqa: E402

CLASSES = (("attention", ("decode_split_kernel", "merge_splits_kernel",
                          "chunk_tile_kernel")),
           ("moe", ("gmm_tile_kernel", "gmm_stream_kernel",
                    "splitk_reduce_kernel")),
           ("ssm", ("chunk_prep_kernel", "chunk_state_kernel",
                    "state_pass_kernel", "chunk_scan_kernel")),
           ("matmul", ("gemm", "cutlass", "xmma", "sm90_", "sm80_")),
           ("kv_scatter", ("index_put", "indexing_backward", "scatter")))


def classify(name: str, cat: str) -> str:
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy"
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other_kernels"


WORKLOADS = {"serve16": dict(new_tokens=32, gap=0.05),
             "decode16": dict(new_tokens=64, gap=0.0)}


def run(cfg, params, workload: str, horizon: int, kv_dtype: str,
        moe_impl: str, check_sync: bool = False):
    w = WORKLOADS[workload]
    reqs = cs.make_requests(cfg, 16, (256, 3072), w["new_tokens"], w["gap"],
                            seed=3, slo=(10.0, 0.25))
    pages = cs.SERVE_PAGES if cfg.moe is None else cs.MOE_SERVE_PAGES
    served = cs.serve(cfg, params, "cuda", reqs, **pages,
                      horizon=horizon, check_sync=check_sync,
                      kv_dtype=kv_dtype, moe_impl=moe_impl)
    eng, wall = served.eng, served.wall
    pre = [s.t_end - s.t_start for s in eng.steps if s.n_prefill]
    dec = [s.t_end - s.t_start for s in eng.steps if not s.n_prefill]
    n_out = sum(len(r.generated_tokens) for r in eng.requests.values())
    return {"wall_s": wall, "output_tok_per_s": n_out / wall,
            "steps": len(eng.steps), "dispatches": served.ex.n_dispatches,
            "multi_dispatches": len(served.multi),
            "prefill_steps": len(pre), "decode_only_steps": len(dec),
            "prefill_step_median_s": statistics.median(pre) if pre else None,
            "decode_step_median_s": statistics.median(dec) if dec else None}


def run_ssm(cfg, params, batch: int, prompt: int, steps: int):
    """chip_smoke phase 5e's path: prefill, then greedy decode steps."""
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab, (batch, prompt)).astype(np.int64)
    g = cs.generate(cfg, params, "cuda", prompts, steps)
    wall = g.prefill_s + sum(g.step_s)
    return {"wall_s": wall, "output_tok_per_s": g.tokens.size / wall,
            "prefill_s": g.prefill_s,
            "decode_step_median_s": statistics.median(g.step_s),
            "b5_launches": g.prefill_launches["mamba2_scan"]}


def busy_union(spans) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile/serve_trace.json")
    ap.add_argument("--workload", choices=sorted(WORKLOADS),
                    default="serve16")
    ap.add_argument("--horizon", type=int, default=1)
    ap.add_argument("--kv-dtype", choices=("fp32", "int8", "fp8_e4m3"),
                    default="fp32")
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth to serve (default: the config's own)")
    ap.add_argument("--moe-impl", choices=("exact", "capacity"),
                    default="capacity")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    cfg = get(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    ssm = cfg.family == "ssm"
    if ssm:       # (batch, prompt tokens, decode steps) of phase 5e (i)
        wl = cs.SSM_SERVE[0]
        go = lambda: run_ssm(cfg, params, *wl)
        desc = dict(zip(("batch", "prompt", "steps"), wl))
    else:
        wl = (args.workload, args.horizon, args.kv_dtype, args.moe_impl)
        go = lambda: run(cfg, params, *wl)
        desc = {"workload": args.workload, "horizon": args.horizon,
                "kv_dtype": args.kv_dtype,
                "moe_impl": None if cfg.moe is None else args.moe_impl}
    print("workload", json.dumps({"arch": cfg.name, "layers": cfg.n_layers,
                                  **desc}), flush=True)
    go()                                                     # warm-up
    print("untraced", json.dumps(go()), flush=True)
    if args.horizon > 1 and not ssm:
        print("untraced_sync_checked", json.dumps(run(
            cfg, params, *wl, check_sync=True)), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    execute = PagedTransformerExecutor.execute
    execute_multi = PagedTransformerExecutor.execute_multi
    prefill, decode_step = DecoderLM.prefill, DecoderLM.decode_step
    horizons = []

    def spanned(self, plan, requests, now):
        kind = "prefill_step" if plan.prefill_items else "decode_step"
        with torch.profiler.record_function(kind):
            return execute(self, plan, requests, now)

    def spanned_multi(self, plan, requests, now, horizon, **kw):
        horizons.append(horizon)
        with torch.profiler.record_function("multi_dispatch"):
            return execute_multi(self, plan, requests, now, horizon, **kw)

    # an SSM span ends where the caller's token copy waits for the device
    def spanned_prefill(self, *a, **kw):
        with torch.profiler.record_function("prefill"):
            out = prefill(self, *a, **kw)
            torch.cuda.synchronize()
            return out

    def spanned_decode(self, *a, **kw):
        with torch.profiler.record_function("decode_step"):
            out = decode_step(self, *a, **kw)
            torch.cuda.synchronize()
            return out

    PagedTransformerExecutor.execute = spanned
    PagedTransformerExecutor.execute_multi = spanned_multi
    DecoderLM.prefill, DecoderLM.decode_step = spanned_prefill, spanned_decode
    try:
        with torch.profiler.profile(activities=acts) as prof:
            traced = go()
    finally:
        PagedTransformerExecutor.execute = execute
        PagedTransformerExecutor.execute_multi = execute_multi
        DecoderLM.prefill, DecoderLM.decode_step = prefill, decode_step
    print("traced", json.dumps(traced), flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))

    events = json.loads(out.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset")]
    if not dev:
        raise SystemExit("the trace holds no device activity")
    by_cls: dict[str, float] = {}
    for e in dev:
        c = classify(e.get("name", ""), e["cat"])
        by_cls[c] = by_cls.get(c, 0.0) + e["dur"] / 1e3
    total = sum(by_cls.values())
    print("device_time", json.dumps({
        "ms": by_cls, "share": {k: v / total for k, v in by_cls.items()}}))
    if ssm:       # B5's four launches apart
        parts: dict[str, float] = {}
        for e in dev:
            low = e.get("name", "").lower()
            for key in dict(CLASSES)["ssm"]:
                if key in low:
                    parts[key] = parts.get(key, 0.0) + e["dur"] / 1e3
        print("ssm_launches_ms", json.dumps(parts))
    busy = busy_union((e["ts"], e["ts"] + e["dur"]) for e in dev) / 1e6
    print("device_busy", json.dumps({
        "busy_s": busy, "serve_wall_s": traced["wall_s"],
        "busy_share": busy / traced["wall_s"],
        "idle_share": 1.0 - busy / traced["wall_s"],
        "kernels": len(dev)}))
    # a step's kernels all run inside its span: the step ends on the argmax
    # copy to the host, which waits for the device
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in ("prefill_step", "decode_step",
                                   "multi_dispatch", "prefill")]
    dev.sort(key=lambda e: e["ts"])
    per: dict[str, dict] = {}
    for sp in spans:
        lo, hi = sp["ts"], sp["ts"] + sp["dur"]
        inside = [e for e in dev if lo <= e["ts"] and e["ts"] + e["dur"] <= hi]
        rec = per.setdefault(sp["name"], {"host_ms": [], "busy_ms": [],
                                          "by_class_ms": {}})
        rec["host_ms"].append(sp["dur"] / 1e3)
        rec["busy_ms"].append(busy_union(
            (e["ts"], e["ts"] + e["dur"]) for e in inside) / 1e3)
        for e in inside:
            c = classify(e.get("name", ""), e["cat"])
            rec["by_class_ms"][c] = rec["by_class_ms"].get(c, 0.0) \
                + e["dur"] / 1e3
    summary = {k: {
        "spans": len(v["host_ms"]),
        "host_ms_median": statistics.median(v["host_ms"]),
        "device_busy_ms_median": statistics.median(v["busy_ms"]),
        "device_ms_by_class_per_span": {c: t / len(v["host_ms"])
                                        for c, t in v["by_class_ms"].items()}}
        for k, v in per.items()}
    if "multi_dispatch" in per:
        # one span and one horizon per execute_multi call of the traced run
        m, n_steps = per["multi_dispatch"], sum(horizons)
        summary["multi_dispatch"].update({
            "internal_steps": n_steps,
            "host_ms_per_internal_step": sum(m["host_ms"]) / n_steps,
            "device_busy_ms_per_internal_step": sum(m["busy_ms"]) / n_steps})
    print("per_step", json.dumps(summary))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
