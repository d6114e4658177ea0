#!/usr/bin/env python3
"""Where the port's serving time goes on the card.

    python3 tools/profile_torch_serve.py [--out build/profile/serve_trace.json]

Serves ``chip_smoke.py``'s phase-5 workload (full-width h2o-danube-1.8b,
16 seeded requests, prompts of 256-3072 tokens, 32 new tokens each) three
times on one CUDA card: once to warm up (kernel build, cuBLAS set-up), once
untraced, once under ``torch.profiler``. Prints, as JSON lines:

* ``untraced`` / ``traced`` — wall seconds, output tokens/s, and the
  median step time of steps that carry prefill and of decode-only steps
  (their difference is the tracing overhead);
* ``device_time`` — device milliseconds by kernel class (matmul, ragged
  attention, KV scatter, other elementwise/index kernels, copies) from the
  trace, and each class's share;
* ``device_busy`` — the union of device activity over the traced serving
  wall time, and its complement, the idle share;
* ``per_step`` — for steps that carry prefill and for decode-only steps
  (each executor call is a ``record_function`` span in the traced run):
  the median host time, the median device-busy time inside the span, and
  device time by kernel class.

The chrome trace is written to ``--out``. Needs one CUDA card and nvcc;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.engine import PagedTransformerExecutor  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models.weights import init_params  # noqa: E402

CLASSES = (("attention", ("ragged_paged_attention",)),
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


def run(cfg, params, reqs_seed: int = 3):
    reqs = cs.make_requests(cfg, 16, (256, 3072), 32, 0.05, seed=reqs_seed,
                            slo=(10.0, 0.25))
    eng, _, _, wall = cs.serve(cfg, params, "cuda", reqs, page_size=128,
                                num_pages=1024, max_pages_per_seq=32)
    pre = [s.t_end - s.t_start for s in eng.steps if s.n_prefill]
    dec = [s.t_end - s.t_start for s in eng.steps if not s.n_prefill]
    n_out = sum(len(r.generated_tokens) for r in eng.requests.values())
    return {"wall_s": wall, "output_tok_per_s": n_out / wall,
            "steps": len(eng.steps), "prefill_steps": len(pre),
            "decode_only_steps": len(dec),
            "prefill_step_median_s": statistics.median(pre) if pre else None,
            "decode_step_median_s": statistics.median(dec) if dec else None}


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    cfg = get("h2o-danube-1.8b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    run(cfg, params)                                   # warm-up
    print("untraced", json.dumps(run(cfg, params)), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    execute = PagedTransformerExecutor.execute

    def spanned(self, plan, requests, now):
        kind = "prefill_step" if plan.prefill_items else "decode_step"
        with torch.profiler.record_function(kind):
            return execute(self, plan, requests, now)

    PagedTransformerExecutor.execute = spanned
    try:
        with torch.profiler.profile(activities=acts) as prof:
            traced = run(cfg, params)
    finally:
        PagedTransformerExecutor.execute = execute
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
    busy = busy_union((e["ts"], e["ts"] + e["dur"]) for e in dev) / 1e6
    print("device_busy", json.dumps({
        "busy_s": busy, "serve_wall_s": traced["wall_s"],
        "busy_share": busy / traced["wall_s"],
        "idle_share": 1.0 - busy / traced["wall_s"],
        "kernels": len(dev)}))
    # a step's kernels all run inside its span: the step ends on the argmax
    # copy to the host, which waits for the device
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in ("prefill_step", "decode_step")]
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
    print("per_step", json.dumps({k: {
        "steps": len(v["host_ms"]),
        "host_ms_median": statistics.median(v["host_ms"]),
        "device_busy_ms_median": statistics.median(v["busy_ms"]),
        "device_ms_by_class_per_step": {c: t / len(v["host_ms"])
                                        for c, t in v["by_class_ms"].items()}}
        for k, v in per.items()}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
