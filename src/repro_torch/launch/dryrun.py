"""Dry run of every (architecture × input shape) cell on the production
meshes: each cell's step run once on abstract (``meta``) tensors, which
allocate nothing, and its bytes, FLOPs and peak recorded. Port of
``src/repro/launch/dryrun.py``; it needs no card.

Run as:  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
             --arch mixtral-8x7b --shape decode_32k [--multi-pod]
         PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
             [--multi-pod] [--device-bytes N]

Each cell writes ``<out>/<mesh>/<arch>__<shape>.json`` (``--out``,
default ``experiments/dryrun_torch``). A record holds the JAX record's
keys where they apply: ``status``, ``arch``, ``shape``, ``mesh``,
``n_devices``, ``notes``; ``memory`` (``argument_bytes``,
``output_bytes``, ``alias_bytes``) for one rank, the rank at coordinates
0, from the cell's specs (``CellSpec.rank_shapes``); ``flops`` and
``bytes`` of the whole step (``cost_analysis.analyze``, the counterpart
of the HLO analysis: matrix products and B4/B5 calls, not a per-device
share); ``model_params`` and ``model_params_active``.

Where the mesh is one device the record also holds ``temp_bytes``,
``peak_bytes`` and ``per_device_hbm_bytes`` (the step's peak with its
arguments resident) and ``fits_device``: that peak against
``--device-bytes``, by default the card's memory where there is a card
(the record names the card). Where the mesh shards the cell, the step
runs on one device and cannot say what a rank holds at its peak or which
collectives it runs: ``DecoderLM`` and the train step under a mesh are
ROADMAP A13b (iv). The record says so in ``sharded`` and prints no zeros.
``fits_16g`` (a TPU's HBM) has no counterpart.

Not ported: ``estimate_cpu_upcast_bytes``, which measures an artifact of
XLA's CPU backend (bf16 matmuls upcast to f32 copies); and
``parse_collectives``, which reads HLO text. ``cost_analysis`` counts the
``torch.distributed`` calls of a step instead.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from .. import configs
from .cost_analysis import analyze, tensor_leaves, tree_bytes
from .mesh import make_production_mesh
from ..distributed.sharding import map_axes
from .steps import all_cells, build_cell, local_shape

SHARDED = ("the step runs on one device: a rank's temp bytes, its peak "
           "and its collectives wait for DecoderLM and the train step "
           "under a mesh (ROADMAP A13b (iv))")


def device_bytes_default() -> tuple[Optional[int], Optional[str]]:
    """(bytes, name) of card 0's memory, or (None, None) without a card."""
    if not torch.cuda.is_available():
        return None, None
    return (torch.cuda.get_device_properties(0).total_memory,
            torch.cuda.get_device_name(0))


def measure(cell, device_bytes: Optional[int] = None,
            device_name: Optional[str] = None) -> dict:
    """The dry run of one cell: its step on ``cell.abstract_args()``,
    the argument, output and alias bytes of the rank at coordinates 0,
    and on a one-device mesh the peak and whether it fits
    ``device_bytes``."""
    t0 = time.time()
    res = analyze(cell.fn, *cell.abstract_args())
    coords = {a: 0 for a in cell.mesh.axis_names}
    args = {id(t.untyped_storage()) for t in tensor_leaves(cell.args)}
    rec = {
        "analysis_s": time.time() - t0,
        "flops": res["flops"], "bytes": res["bytes"],
        "kernels": res["kernels"],
        "memory": {
            "argument_bytes": tree_bytes(cell.rank_shapes(coords)),
            "output_bytes": _out_bytes(cell, res["output"], coords),
            "alias_bytes": _out_bytes(
                cell, res["output"], coords,
                lambda t: id(t.untyped_storage()) in args)},
        "model_params": cell.arch.param_count(),
        "model_params_active": cell.arch.active_param_count(),
    }
    if cell.mesh.size > 1:
        rec["sharded"] = SHARDED
        return rec
    rec["memory"]["temp_bytes"] = res["temp_bytes"]
    rec["memory"]["peak_bytes"] = res["peak_bytes"]
    rec["collectives"] = res["collectives"]
    rec["per_device_hbm_bytes"] = res["peak_bytes"]
    if device_bytes is not None:
        rec["device_bytes"] = device_bytes
        rec["device"] = device_name
        rec["fits_device"] = bool(res["peak_bytes"] <= device_bytes)
    return rec


def _out_bytes(cell, out, coords, keep=lambda t: True) -> int:
    """Bytes of the rank at ``coords``'s share of the step's outputs that
    ``keep`` selects (their specs: ``cell.out_shardings``)."""
    total = 0

    def one(spec, t):
        nonlocal total
        if keep(t):
            total += math.prod(local_shape(cell.mesh, coords, t.shape,
                                           spec)) * t.element_size()
    for o, spec in zip(out, cell.out_shardings):
        map_axes(one, spec, o)
    return total


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             device_bytes: Optional[int] = None) -> dict:
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "n_devices": mesh.size, "status": "ok"}
    path = os.path.join(out_dir, mesh_name, f"{arch}__{shape}.json")
    if shape == "long_500k" and not configs.long_context_capable(
            configs.get(arch)):
        rec["status"] = "skipped"
        rec["reason"] = ("pure full attention: no sub-quadratic path "
                         "(DESIGN.md §5)")
        return _write(rec, path)
    name = None
    if device_bytes is None:
        device_bytes, name = device_bytes_default()
    try:
        t0 = time.time()
        cell = build_cell(arch, shape, mesh)
        rec["notes"] = cell.notes
        rec["build_s"] = time.time() - t0
        rec.update(measure(cell, device_bytes, name))
    except Exception as e:  # noqa: BLE001 — record the failure, don't crash --all
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return _write(rec, path)


def _write(rec: dict, path: str) -> dict:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device-bytes", type=int, default=None,
                    help="a device's memory for fits_device (default: the "
                         "card's, where there is one)")
    args = ap.parse_args(argv)

    cells = ([(args.arch, args.shape, True)] if not args.all
             else all_cells())
    for arch, shape, runnable in cells:
        if not runnable:
            print(f"SKIP  {arch:26s} {shape:12s} (long-context inapplicable)")
            continue
        rec = run_cell(arch, shape, args.multi_pod, args.out,
                       args.device_bytes)
        if rec["status"] == "ok":
            m = rec["memory"]
            print(f"OK    {arch:26s} {shape:12s} "
                  f"flops={rec['flops']:.4g} "
                  f"args={m['argument_bytes'] / 2**30:8.2f}GiB/rank "
                  f"analysis={rec['analysis_s']:6.1f}s")
        elif rec["status"] == "skipped":
            print(f"SKIP  {arch:26s} {shape:12s} {rec['reason']}")
        else:
            print(f"FAIL  {arch:26s} {shape:12s} {rec['error'][:120]}")


if __name__ == "__main__":
    main()
