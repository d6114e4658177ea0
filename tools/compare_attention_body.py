#!/usr/bin/env python3
"""Device times of one tree's attention kernels, and B2's outputs, for
comparing two versions of the attention body on one card.

    python3 tools/compare_attention_body.py [--tree DIR]
        [--save-b2 FILE | --check-b2 FILE] [--json FILE]

Imports ``chip_smoke`` and ``repro_torch`` from ``DIR`` (default: this
repository; for an older commit, unpack it with ``git archive`` into a
git-ignored directory such as ``build/parent``), builds that tree's
paged-attention kernels and, at pages of 128 on ``chip_smoke``'s steps
and seeds:

* B1 (``paged_attention_ragged``) at phase 3's steps (a)-(c) and B3
  (``paged_attention``) at phase 3b's steps (d)-(g): the device time of
  one call alone (``graph_ms``: ``chip_smoke.graph_timer``, the median of
  three such timings), its max abs error against the plain version, and
  the step's bound;
* B2 (``paged_attention_ragged_quant``) at phase 3c's steps (a)-(c), int8
  and fp8-e4m3: ``graph_ms`` and the output, which ``--save-b2`` writes
  to FILE and ``--check-b2`` compares bitwise with FILE's.

Prints one JSON line per step and, with ``--json``, writes them all to
FILE. One process serves one tree (two trees cannot share a process's
``repro_torch``): run it for the older tree, then this one, then the
older one again, in one command on one card, and compare within it.
Needs one CUDA card and nvcc; exits non-zero without one, when a kernel
disagrees with its plain version by more than 1e-4, or when ``--check-b2``
finds an output that is not bitwise equal.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(
        pathlib.Path(__file__).resolve().parents[1]))
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--save-b2")
    group.add_argument("--check-b2")
    ap.add_argument("--json")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("compare_attention_body: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["paged_attention_ragged", "paged_attention",
                  "paged_attention_ragged_quant"])

    def device_ms(fn) -> float:
        return statistics.median(cs.graph_timer(fn) for _ in range(3))

    recs, b2_out = [], {}

    def emit(rec):
        recs.append(rec)
        print(json.dumps(rec), flush=True)

    for kind in ("a_mixed", "b_decode", "c_window"):
        st = cs.make_step(kind, 128, "cuda")
        q, kp, vp, *meta = st.args
        kern = lambda: cs.paged_attention_ragged(q, kp, vp, *meta,
                                                 window=st.window)
        err = float((kern() - cs.paged_attention_ragged_ref(
            q, kp, vp, *meta, window=st.window)).abs().max())
        emit({"kernel": "B1", "step": kind, "page": 128,
              "graph_ms": device_ms(kern), "max_abs_err": err,
              "bound_ms": cs.step_bound(st)["bound_ms"]})
        for fmt in ("int8", "fp8_e4m3"):
            qargs, _, _ = cs.quantize_step(st, fmt)
            b2 = lambda: cs.paged_attention_ragged_quant(*qargs,
                                                         window=st.window)
            b2_out[f"{kind}/{fmt}"] = b2().cpu()
            emit({"kernel": "B2", "step": kind, "format": fmt, "page": 128,
                  "graph_ms": device_ms(b2)})
        del st, q, kp, vp, meta
        torch.cuda.empty_cache()
    for kind in ("d_decode", "e_verify", "f_chunk", "g_window"):
        st = cs.make_bstep(kind, 128, "cuda")
        q, kp, vp, *meta = st.args
        kern = lambda: cs.paged_attention(q, kp, vp, *meta, window=st.window)
        err = float((kern() - cs.paged_attention_ref(
            q, kp, vp, *meta, window=st.window)).abs().max())
        emit({"kernel": "B3", "step": kind, "page": 128,
              "graph_ms": device_ms(kern), "max_abs_err": err,
              "bound_ms": cs.bstep_bound(st)["bound_ms"]})
        del st, q, kp, vp, meta
        torch.cuda.empty_cache()
    ok = all(r.get("max_abs_err", 0.0) <= cs.ATOL_KERNEL for r in recs)
    if args.save_b2:
        torch.save(b2_out, args.save_b2)
    if args.check_b2:
        ref = torch.load(args.check_b2)
        same = {k: torch.equal(v, ref[k]) for k, v in b2_out.items()}
        emit({"b2_bitwise_equal": same, "file": args.check_b2})
        ok = ok and set(ref) == set(b2_out) and all(same.values())
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(
            {"tree": str(tree), "records": recs}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
