#!/usr/bin/env python3
"""Serve-16 on the sharded executor with one card a rank (NCCL).

    python3 tools/tp_serve.py --tp 2 4           # needs 4 cards for TP 4

chip_smoke's phase 5l serves h2o-danube-1.8b at TP 2 with both ranks on
one card over gloo, so its collectives go through the host. This runs the
same serve (full depth and width, serve-16's requests on the wall clock,
the collectives timed with the device synchronised either side) with rank
r on ``cuda:r`` over NCCL, beside the single-device serve-16 (phase 5) in
the same call, so that the all-reduces are the cards' own. Each
configuration serves three times in one process (one a rank): plain,
with rank 0's collectives timed (each between two device
synchronisations, which also holds rank 0's host to the others'
progress), plain again; the last plain run is the warm one. Prints one
JSON line a run (``single``, ``tp``) and the cards' names and power
limits. Every rank's gates are chip_smoke's: one dispatch a step, 2·L + 2
all-reduces and L attention launches a dispatch, every request's tokens
in [0, vocab).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tp", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: all 24 layers)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tp_serve: no CUDA device")
    if max(args.tp) > torch.cuda.device_count():
        raise SystemExit(f"tp_serve: TP {max(args.tp)} needs that many "
                         f"cards, this machine has "
                         f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    C._build.build()
    cfg = C.get("h2o-danube-1.8b")
    if args.layers:
        cfg = C.dataclasses.replace(cfg, n_layers=args.layers)
    params = C.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    for i in range(2):
        rec, tokens = C.phase_serve(cfg, "cuda", params=params)
        print(json.dumps({"run": "single", "repeat": i, **rec}), flush=True)
    del params
    C._release_memory()
    case = {"cfg": cfg, "device": "cuda", "seed": 0, "kv_dtype": "fp32",
            "moe_impl": "exact", "pages": C.SERVE_PAGES,
            "model_clock": False, "requests": C.TP_SERVE,
            "serve_record": True}
    for tp in args.tp:
        runs = [dict(case, cost_shards=tp, timed=timed)
                for timed in (False, True, False)]
        per_rank = C.spawn(C.tp_rank, tp, "nccl", runs, timeout=900)
        for i, c in enumerate(runs):
            ranks = [recs[i] for recs in per_rank]
            r0, s = ranks[0], ranks[0]["serve"]
            ok = (r0["dispatches"] == r0["steps"]
                  and all(r["dispatches"] == r0["dispatches"]
                          and r["all_reduces"]
                          == (2 * cfg.n_layers + 2) * r["dispatches"]
                          and r["launches"]["paged_attention_ragged"]
                          == cfg.n_layers * r["dispatches"] for r in ranks))
            out = {"run": "tp", "tp": tp, "backend": "nccl", "repeat": i,
                   "timed_collectives": c["timed"], **s,
                   "share_tokens_equal_single": C._share_equal(
                       r0["tokens"], tokens), "gates_ok": ok}
            if c["timed"]:
                out.update(
                    all_reduce_ms_per_step=r0["all_reduce_s"] * 1e3
                    / s["steps"],
                    broadcast_ms_per_step=r0["broadcast_s"] * 1e3
                    / s["steps"],
                    collective_share_of_wall=(r0["all_reduce_s"]
                                              + r0["broadcast_s"])
                    / s["wall_s"])
            print(json.dumps(out), flush=True)
            if not ok:
                raise AssertionError(f"TP {tp}: a gate failed")
    for card in cards:
        print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
