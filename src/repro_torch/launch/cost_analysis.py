"""What one step of the port costs, counted while it runs: FLOPs, bytes,
collectives and the bytes it holds at its peak.

The counterpart of ``src/repro/launch/hlo_analysis.py``, which parses a
compiled XLA module's HLO text. The port has no HLO: ``analyze(fn,
*args)`` runs the step once under a ``TorchDispatchMode`` and counts the
aten ops it dispatches, on real tensors or on abstract ones (``meta``:
the shapes of a dry run, ``launch.dryrun``). It keeps the keys of the JAX
``analyze`` that still mean something here:

  * ``flops`` — matrix products (mm, bmm, addmm, baddbmm, SDPA,
    convolutions) by ``torch.utils.flop_counter``'s formulas, where the
    JAX analysis counts ``dot`` ops; elementwise FLOPs are ignored, as
    there. Each call of kernel B4 or B5 (forward or backward) counts as
    one op with the FLOPs and bytes of ``kernels.bounds`` (``gmm_bound``,
    ``scan_bound``, ``scan_backward_bound``): its wrapper reports itself
    (``bounds.counted``) on every route, the card, the plain version on
    the CPU and the abstract route on ``meta``, and the tensor ops inside
    it are not counted again. So a step's count is the same on every
    device;
  * ``bytes`` — output plus operand bytes of each dispatched op, views and
    bare allocations (``empty``) excluded, plus each kernel call's own;
  * ``collectives`` — ``torch.distributed`` ops (the ``c10d`` namespaces)
    by name: calls and output bytes.

What the JAX analysis takes from HLO structure has no counterpart: the
step runs eagerly, so every loop iteration dispatches its ops and no trip
count is needed. In place of XLA's ``memory_analysis()`` the mode tracks
storages: the arguments' are live from the start, every storage an op
makes is live from its creation until its last tensor dies (a weak
reference on the storage), so ``peak_bytes`` is the most the step holds at
once with its arguments resident, as it runs under this mode: on the
card any Python dispatch mode, even a bare pass-through one, raised a
training step's allocator peak above a plain run's (chip_smoke 7a (i)),
so a plain run may hold a little less. ``argument_bytes``, ``output_bytes`` and
``alias_bytes`` (outputs that are arguments' storage, updated in place)
count each leaf's elements, as XLA counts buffers.

``param_counts`` and ``model_flops`` give the 6·N·tokens count of a
training step that ``chip_smoke.py`` reports beside the counted FLOPs.
"""
from __future__ import annotations

import contextlib
import math
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..training.optimizer import leaves

_aten = torch.ops.aten
# ops that allocate or reinterpret memory without reading or writing it
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten._unsafe_view.default}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


def tensor_leaves(tree, out=None) -> list:
    """The tensors of nested tuples, lists and dicts, in order. (No
    closure: a recursive one would be a reference cycle holding the
    tensors until the next collection.)"""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            tensor_leaves(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            tensor_leaves(v, out)
    return out


def tree_bytes(tree) -> int:
    """Bytes of the tensor leaves of ``tree``: elements × element size,
    each leaf counted as XLA counts a buffer."""
    return sum(t.numel() * t.element_size() for t in tensor_leaves(tree))


class CostAnalysis(TorchDispatchMode):
    """The counting mode of ``analyze``: enter it, mark the arguments
    ``resident``, run the step, read ``report(out)``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: dict = {}
        self.kernels: dict = {}      # name → {"calls", "flops", "bytes"}
        self.live = self.peak = 0
        self.argument_bytes = 0
        self._inside = 0             # depth of kernel calls
        self._storages: dict = {}    # id(storage) → (nbytes, finalizer)
        self._args: set = set()
        # a finalizer may run inside _track (a collection it triggers)
        self._lock = threading.RLock()

    # -- storages --------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        with self._lock:
            if key in self._storages:
                return
            nb = s.nbytes()
            self._storages[key] = (nb, weakref.finalize(s, self._free, key))
            self.live += nb
            self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        with self._lock:
            nb, _ = self._storages.pop(key, (0, None))
            self.live -= nb

    def resident(self, args) -> None:
        """Count the storages of ``args``' tensors as live from now on,
        and their leaves as the step's arguments."""
        self.argument_bytes += tree_bytes(args)
        for t in tensor_leaves(args):
            self._track(t)
            self._args.add(id(t.untyped_storage()))

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        with self._lock:
            for _, fin in self._storages.values():
                fin.detach()
            self._storages.clear()
        return out

    # -- kernels -----------------------------------------------------------

    @contextlib.contextmanager
    def kernel(self, name: str, flops: int, nbytes: int):
        """One call of a kernel (``kernels.bounds.counted``): its FLOPs and
        bytes count; the ops inside it only allocate."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    # -- ops ---------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = tensor_leaves((args, kwargs))
        outs = tensor_leaves(out)
        mine = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            if id(t.untyped_storage()) not in mine:
                self._track(t)
        if self._inside:
            return out
        if func.namespace in _COLLECTIVE_NAMESPACES:
            c = self.collectives.setdefault(func.overloadpacket.__name__,
                                            {"count": 0, "bytes": 0})
            c["count"] += 1
            c["bytes"] += tree_bytes(outs)
            return out
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view and func not in _NO_TRAFFIC:
            self.bytes += tree_bytes(ins) + tree_bytes(outs)
        return out

    def report(self, out) -> dict:
        """The counts of the run that returned ``out``."""
        arg = self.argument_bytes
        outs = tensor_leaves(out)
        alias = sum(t.numel() * t.element_size() for t in outs
                    if id(t.untyped_storage()) in self._args)
        out_b = tree_bytes(outs)
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": self.collectives, "kernels": self.kernels,
                "argument_bytes": arg, "output_bytes": out_b,
                "alias_bytes": alias, "peak_bytes": self.peak,
                "temp_bytes": self.peak - (arg + out_b - alias)}


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under a ``CostAnalysis`` with the
    arguments resident; return its counts (``CostAnalysis.report``) and,
    under ``output``, what ``fn`` returned."""
    mode = CostAnalysis()
    with mode:
        mode.resident((args, kwargs))
        out = fn(*args, **kwargs)
    return {**mode.report(out), "output": out}


# --------------------------------------------------------------------------
# 6·N·tokens
# --------------------------------------------------------------------------

def param_counts(cfg, params) -> dict:
    """All parameters, those a token of the decoder (or the encoder)
    multiplies by, per ``6·N·tokens``: a MoE layer's experts count
    top_k / E of theirs; the embedding counts, as in 6·N·tokens."""
    total = sum(t.numel() for t in leaves(params))
    if cfg.is_encoder_decoder:
        enc = sum(t.numel() for t in leaves(params["enc_layers"])) + \
            params["enc_ln_f"].numel()
        return {"params": total, "encoder_params": enc,
                "decoder_params": total - enc}
    active = total
    if cfg.moe is not None:
        experts = sum(params["layers"]["moe"][k].numel()
                      for k in ("w_gate", "w_up", "w_down"))
        active -= experts * (1 - cfg.moe.top_k / cfg.moe.n_experts)
    return {"params": total, "active_params": int(active)}


def model_flops(cfg, counts: dict, batch: tuple) -> float:
    """6·N·tokens of one step: decoder-only, 6 × active params × B·S; the
    encoder-decoder, 6 × (encoder params × frames + decoder params ×
    decoder tokens). Remat's recomputed forward is not counted."""
    if cfg.is_encoder_decoder:
        b, frames, dec = batch
        return 6.0 * b * (counts["encoder_params"] * frames
                          + counts["decoder_params"] * dec)
    return 6.0 * counts["active_params"] * math.prod(batch)
