#!/usr/bin/env python3
"""The spread of chip_smoke's phase 4m over weight seeds: bf16 serving
(and, with ``--train``, training) card against CPU at the launch opts.

    python3 tools/bf16_parity_seeds.py [--seeds 1 2 3 4 5] [--train]

Runs ``chip_smoke.phase_bf16_parity`` on the card once for each seed
(its cases: h2o-danube-1.8b 2 layers, mixtral-8x7b 1, mamba2-1.3b 2,
zamba2-2.7b 7, at full width; weights from ``--seeds``, prompts and
training tokens as in chip_smoke), which prints each case's
``bf16_parity`` record and raises on the first gate it fails. Then
prints one JSON line ``BF16SEEDS {...}``: for each model the seeds'
``logits_max_rel_err`` (4m's gate: at most 2e-2 of max|logit|), their
largest, and, with ``--train``, each seed's worst gradient error and
its bar. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bf16_parity_seeds: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.build()
    out = {}
    for seed in args.seeds:
        for rec in cs.phase_bf16_parity("cuda", seed=seed, train=args.train):
            m = out.setdefault(rec["model"], {"seeds": [], "logits": []})
            m["seeds"].append(seed)
            m["logits"].append(rec["logits_max_rel_err"])
            if args.train:
                m.setdefault("grad", []).append(rec["grad_worst_rel_err"])
                m.setdefault("grad_bar", []).append(rec["grad_worst_bar"])
            cs._release_memory()
    for m in out.values():
        m["logits_max"] = max(m["logits"])
    out["bar"] = cs.BF16_BAR
    print("BF16SEEDS", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
