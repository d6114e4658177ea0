#!/usr/bin/env python3
"""Device times of one tree's SSD chunk scan (kernel B5), launch by launch,
for comparing two versions of B5 on one card.

    python3 tools/compare_mamba2_scan.py [--tree DIR] [--calls N]
        [--json FILE]

Imports ``chip_smoke`` and ``repro_torch`` from ``DIR`` (default: this
repository; for an older commit, unpack it with ``git archive`` into a
git-ignored directory such as ``build/parent``), builds that tree's B5
and, at phase 3e's steps (``chip_smoke.SSM_STEPS`` at mamba2-1.3b's
heads: (l) 8 x 2048 tokens, (m) one 32768-token prompt, (n) 8 x 100), from
a zero and from a nonzero initial state, on phase 3e's inputs and seeds:

* ``graph_ms``: the device time of one call alone
  (``chip_smoke.graph_timer``, the median of three such timings);
* ``launches_ms``: each of B5's kernels' device ms a call, by kernel
  name, from ``torch.profiler`` over ``--calls`` calls (default 5);
* ``fp64_max_abs_err``: y's and the final state's max abs error against
  the plain version in fp64 on the first sequence's first two heads, and
  ``tolerance``, 1e-4 x max(1, max|y|) of that fp64 answer;
* the step's ``bound_ms`` (``chip_smoke.scan_bound``);
* ``copy_ms``: the device time of one ``Tensor.copy_`` of as many fp32
  elements as the (B, NC, H, N, P) state scratch, which reads and writes
  the bytes that B5's state pass does: that pass's yardstick;
* ``sm_clock_mhz`` and ``power_w``: the medians of what
  ``nvidia-smi --query-gpu=clocks.sm,power.draw`` reports every 100 ms
  in the last second of two seconds of back-to-back calls (the rate a
  percentage of the fp32 peak is read against).

Prints one JSON line per step and, with ``--json``, writes them all to
FILE. One process serves one tree (two builds of B5 cannot share a
process): run it for the older tree, then this one, then the older one
again, in one command on one card, and compare within it. Needs one CUDA
card and nvcc; exits non-zero without one, or when an error exceeds its
tolerance.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import statistics
import sys


def device_ms_by_kernel(fn, calls: int) -> dict:
    """Device ms a call of each CUDA kernel ``fn`` launches, by the
    kernel's name, from ``torch.profiler`` over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.key_averages():
        name = re.search(r"(\w+_kernel)\b", ev.key)
        if name and ev.device_time_total > 0:
            key = name.group(1)
            out[key] = out.get(key, 0.0) + ev.device_time_total / 1e3 / calls
    return out


def clocks_under_load(fn, seconds: float = 2.0) -> tuple:
    """(SM clock MHz, power W): medians of nvidia-smi's 100 ms samples in
    the last half of ``seconds`` of back-to-back calls of ``fn``; (None,
    None) if nvidia-smi gives no sample."""
    import subprocess
    import time
    import torch
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(4):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate()
    rows = []
    for line in out.splitlines():
        try:
            rows.append(tuple(float(v) for v in line.split(",")))
        except ValueError:
            continue
    rows = rows[len(rows) // 2:]
    if not rows:
        return None, None
    return (statistics.median(r[0] for r in rows),
            statistics.median(r[1] for r in rows))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(
        pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--json")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("compare_mamba2_scan: no CUDA device")
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba2_scan import mamba_chunk_scan
    from repro_torch.kernels.ref import mamba_chunk_scan_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["mamba2_scan"])
    cfg = get("mamba2-1.3b")
    recs, ok = [], True
    for seed, (name, batch, prompt) in enumerate(cs.SSM_STEPS):
        shape = cs.scan_shape(cfg, batch, prompt)
        b, nc, l, h, p, n = shape
        for nonzero in (False, True):
            g = torch.Generator(device="cuda").manual_seed(seed)
            rnd = lambda *shp: torch.randn(shp, generator=g, device="cuda")
            x = rnd(b, nc, l, h, p).mul_(0.3)
            a = rnd(b, nc, l, h).abs_().mul_(-0.1)
            bm, cm = rnd(b, nc, l, n).mul_(0.3), rnd(b, nc, l, n).mul_(0.3)
            s0 = (rnd(b, h, p, n).mul_(0.3) if nonzero
                  else torch.zeros((b, h, p, n), device="cuda"))
            kern = lambda: mamba_chunk_scan(x, a, bm, cm, s0)
            y, st = kern()
            y64, st64 = mamba_chunk_scan_ref(
                x[:1, :, :, :2].double(), a[:1, :, :, :2].double(),
                bm[:1].double(), cm[:1].double(), s0[:1, :2].double())
            err = max(float((y[:1, :, :, :2] - y64).abs().max()),
                      float((st[:1, :2] - st64).abs().max()))
            tol = cs.ATOL_KERNEL * max(1.0, float(y64.abs().max()))
            ok = ok and err <= tol
            del y, st, y64, st64
            rec = {"tree": str(tree),
                   "step": f"{name}_{'state' if nonzero else 'zero'}",
                   "shape": list(shape),
                   "graph_ms": statistics.median(
                       cs.graph_timer(kern) for _ in range(3)),
                   "launches_ms": device_ms_by_kernel(kern, args.calls),
                   "fp64_max_abs_err": err, "tolerance": tol,
                   "bound_ms": cs.scan_bound(
                       b, nc, l, h, p, n, nc - 1 + int(nonzero))["bound_ms"]}
            rec["sm_clock_mhz"], rec["power_w"] = clocks_under_load(kern)
            src = torch.empty((b, nc, h, n, p), device="cuda")
            dst = torch.empty_like(src)
            rec["copy_ms"] = statistics.median(
                cs.graph_timer(lambda: dst.copy_(src)) for _ in range(3))
            del src, dst
            recs.append(rec)
            print(json.dumps(rec), flush=True)
            del x, a, bm, cm, s0
            torch.cuda.empty_cache()
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(
            {"tree": str(tree), "records": recs}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
