#!/usr/bin/env python3
"""Device times of one tree's expert GEMM (kernel B4) in fp32, for
comparing two versions of B4 on one card.

    python3 tools/compare_moe_gmm.py [--tree DIR] [--ptxas]

Imports ``repro_torch`` from ``DIR`` (default: this repository; for an
older commit, unpack it with ``git archive`` into a git-ignored directory
such as ``build/parent``), builds that tree's B4 and times it at
mixtral-8x7b's gate/up shape (E 8, K 4096, N 14336, x and w ~ N(0, 0.3²)
from seed 0) at C = 960 (the tile body) and C = 8 (the stream body):
``c960_graph_ms`` and ``c8_graph_ms``, the device time of one call alone
(a CUDA graph of the call replayed 5 times between two events, the
median of 5 such windows). ``--ptxas`` first prints nvcc's resource
report for the tree's B4 (registers and spills by kernel).

Prints one JSON line ``B4TIME {...}``. One process serves one tree (two
builds of B4 cannot share a process): run it for the older tree, then
this one, then the older one again, in one command on one card, and
compare within it. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys


def graph_ms(fn, reps: int = 5, windows: int = 5) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                  # warm up off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__)
                                           .resolve().parents[1]))
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("compare_moe_gmm: no CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import moe_gmm
    info = _build.build(["moe_gmm"])
    if args.ptxas:
        print(info["moe_gmm"]["ptxas"])
    out = {"tree": str(tree)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn((8, 4096, 14336), generator=gen,
                    device="cuda").mul_(0.3)
    for c in (960, 8):
        x = torch.randn((8, c, 4096), generator=gen,
                        device="cuda").mul_(0.3)
        out[f"c{c}_graph_ms"] = graph_ms(lambda: moe_gmm(x, w))
    print("B4TIME", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
