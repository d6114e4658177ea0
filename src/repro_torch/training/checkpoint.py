"""Checkpointing: a flat-path ``.npz`` of the tree (params, optimizer
state) plus an optional JSON of host state. Port of
``src/repro/training/checkpoint.py``, in its format: the path of each leaf
is its dict keys joined by ``/``, list entries as ``#i``; the arrays keep
their dtypes (the step is int32). A bf16 leaf is written as JAX's
``np.savez`` writes one: numpy holds a JAX bf16 array as
``ml_dtypes.bfloat16``, which the ``.npz`` stores as ``|V2``, its two raw
bytes; ``load_checkpoint`` reads a ``|V2`` leaf back as bf16, bit for
bit. A checkpoint written by either package
loads in the other.

Restarting from a checkpoint is exact: ``load_checkpoint`` gives back the
saved values bit for bit, and the train step is deterministic on the CPU.
The KV cache is never checkpointed: a prefix re-prefill recomputes it.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = (_to_numpy(tree) if isinstance(tree, torch.Tensor)
                            else np.asarray(tree))
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 as its raw two bytes a value (``|V2``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_RAW_BF16)
    return t.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """The inverse of ``_to_numpy``: a ``|V2`` array is bf16."""
    if a.dtype == _RAW_BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


_RAW_BF16 = np.dtype("V2")


def _unflatten(flat: dict, device: torch.device):
    root: dict = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return _from_numpy(node).to(device)
        if node and all(k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


def save_checkpoint(path: str, tree: Any, meta: dict | None = None) -> None:
    """Write ``tree`` to ``path`` (``.npz``, through a temporary file and
    a rename), and ``meta`` to ``path + ".meta.json"``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_checkpoint(path: str, device: DeviceLike = None) -> Any:
    """The tree saved at ``path``, its tensors on ``device`` (the card
    unless the caller asks otherwise)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat, dev)


def load_meta(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)
