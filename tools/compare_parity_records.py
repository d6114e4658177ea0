#!/usr/bin/env python3
"""The records of chip_smoke's card-vs-CPU parity phases for one tree, and
their comparison between two trees: did a change leave the serving paths
as they were?

    python3 tools/compare_parity_records.py --tree DIR --out FILE
    python3 tools/compare_parity_records.py --diff OLD NEW

The first form imports ``chip_smoke`` and ``repro_torch`` from ``DIR``
(for an older commit, unpack it with ``git archive`` into a git-ignored
directory such as ``build/parent``), runs its phases 4 (serve parity), 4b
(path parity), 4c (quantized parity), 4d (MoE parity), 4h (MoE
speculation), 4e/4i (every decoder family), 4f (prefix cache and
preemption) and 4g (migration) on the card, in chip_smoke's order, with
its inputs and seeds, and writes every record they emit, then the summed
launches, to FILE as JSON. One process serves one tree (two builds of a
kernel cannot share a process): run the older tree, then this one, in
one command on one card.

``--diff`` compares two such files record by record, leaving out the
times (keys ``seconds``, ``wall``, ``*_s``, ``*ms``): it prints each
record that differs and the count, and exits 0. Phases 4b and 4c run the
engine on the wall clock, so their step and dispatch counts (and the
launches, n_layers a dispatch) may differ run to run; the other phases
run on fixed plans or the model clock, and their records (tokens equal,
first-logit errors, cached tokens, launches) repeat exactly on
unchanged code.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys


def _timing(key: str) -> bool:
    return key in ("seconds", "wall") or key.endswith(("_s", "ms"))


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if not _timing(k)}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def diff(old_path: str, new_path: str) -> int:
    old = json.loads(pathlib.Path(old_path).read_text())
    new = json.loads(pathlib.Path(new_path).read_text())
    if [t for t, _ in old] != [t for t, _ in new]:
        raise SystemExit("the two runs emitted different phases")
    differing = 0
    for (tag, a), (_, b) in zip(old, new):
        a, b = _strip(a), _strip(b)
        if a != b:
            differing += 1
            keys = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
            print(tag, json.dumps({k: [a.get(k), b.get(k)] for k in keys}))
    print(json.dumps({"records": len(old), "differing": differing}))
    return 0


def run(tree: pathlib.Path, out: pathlib.Path) -> int:
    sys.path.insert(0, str(tree))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("compare_parity_records: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records, emit = [], cs._emit

    def grab(tag, obj):
        records.append([tag, obj])
        emit(tag, obj)
    cs._emit = grab
    small = dataclasses.replace(cs.get("h2o-danube-1.8b"), n_layers=2)
    mix = dataclasses.replace(cs.get("mixtral-8x7b"), n_layers=2)
    _, fused = cs.phase_parity(small, "cuda")
    cs.phase_path_parity(small, "cuda", fused)
    cs.phase_quant_parity(small, "cuda")
    for phase in (cs.phase_moe_parity, cs.phase_moe_spec):
        cs._release_memory()
        phase(mix, "cuda")
    cs._release_memory()
    cs.phase_decoder_parity("cuda")
    cs._release_memory()
    cs.phase_cache_parity(small, "cuda")
    cs.phase_migration_parity(small, "cuda")
    records.append(["launches", cs.SERVING_LAUNCHES])
    out.write_text(json.dumps(records))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--diff", nargs=2, metavar=("OLD", "NEW"))
    a = ap.parse_args()
    if a.diff:
        return diff(*a.diff)
    if a.tree is None or a.out is None:
        ap.error("give --tree and --out, or --diff OLD NEW")
    return run(a.tree.resolve(), a.out)


if __name__ == "__main__":
    sys.exit(main())
