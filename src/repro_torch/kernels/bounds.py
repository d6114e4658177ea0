"""The work of kernels B4 and B5 counted from their shapes, and the hook by
which a wrapper reports a call to an active cost analysis.

Each ``*_bound`` function gives a call's ``bytes`` (every input read once,
every output written once) and ``flops`` (what these inputs need), and the
least time one H100 could take for them, ``bound_ms``, the larger of bytes
over the HBM rate and FLOPs over the peak rate of their type (NVIDIA's
data sheet, SXM part, dense): ``chip_smoke.py`` holds each kernel's time
against it, and ``launch.cost_analysis`` counts a step's B4 and B5 calls
with the same ``bytes`` and ``flops``, so there is one count.

``counted(name, bound)`` is the hook: the wrappers of B4 and B5 call it
around the work of one call, on every route (the kernel on the card, its
plain version on the CPU, the abstract route on ``meta`` tensors). With no
cost analysis active it returns a context that does nothing; under one
(a ``TorchDispatchMode`` on the current mode stack with a ``kernel``
method, ``launch.cost_analysis.CostAnalysis``) the call's ``bound()`` is
reported to it, and the tensor ops inside count as that one kernel.
"""
from __future__ import annotations

import contextlib
from typing import Callable

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 dense tensor rate, published

_NOTHING = contextlib.nullcontext()


def counted(name: str, bound: Callable[[], dict]):
    """The context of one call of kernel ``name``: reports ``bound()``
    (``flops`` and ``bytes``) to every active cost analysis, which counts
    the ops inside as that kernel's; a no-op without one."""
    modes = [m for m in _get_current_dispatch_mode_stack()
             if hasattr(m, "kernel")]
    if not modes:
        return _NOTHING
    b = bound()
    stack = contextlib.ExitStack()
    for m in modes:
        stack.enter_context(m.kernel(name, b["flops"], b["bytes"]))
    return stack


def _timed(nbytes: int, flops: int, t_flops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops}


def gmm_bound(e: int, c: int, k: int, n: int, elem: int = 4,
              flops_per_s: float = FP32_FLOPS_PER_S) -> dict:
    """x and w read once, the output written once, ``elem`` bytes an
    element; 2·E·C·K·N FLOPs at ``flops_per_s`` (the fp32 rate of the CUDA
    cores by default)."""
    nbytes = elem * (e * c * k + e * k * n + e * c * n)
    flops = 2 * e * c * k * n
    return _timed(nbytes, flops, flops / flops_per_s * 1e3)


def gmm_backward_bound(e: int, c: int, k: int, n: int, elem: int = 4,
                       flops_per_s: float = FP32_FLOPS_PER_S) -> dict:
    """dx = dy · wᵀ and dw = xᵀ · dy: each reads its two operands once and
    writes its output once, ``elem`` bytes an element, and does the
    forward's 2·E·C·K·N FLOPs at ``flops_per_s`` (the fp32 rate of the
    CUDA cores by default). Each of the two is one ``moe_gmm`` call, which
    a cost analysis counts by ``gmm_bound``: the same FLOPs."""
    nbytes = elem * 2 * (e * c * k + e * k * n + e * c * n)
    flops = 4 * e * c * k * n
    return _timed(nbytes, flops, flops / flops_per_s * 1e3)


def rate(*elems) -> float:
    """The peak rate of products whose operands have these element sizes:
    bf16's tensor rate when all are 2 bytes, else fp32's."""
    return BF16_FLOPS_PER_S if set(elems) == {2} else FP32_FLOPS_PER_S


def scan_bound(b, nc, l, h, p, n, carried, x_elem: int = 4,
               bc_elem: int = 4) -> dict:
    """xdt, a_dt and y once at ``x_elem`` bytes an element, b and c at
    ``bc_elem``, with the initial and the final state (fp32); FLOPs, as
    many as these inputs need, each product at its operands' rate
    (``rate``): CBᵀ on the L(L+1)/2 pairs j ≤ i the causal mask keeps,
    once per (batch, chunk) (B and C are shared by the heads); per head
    and chunk the masked scores times X on the same pairs and the chunk's
    own state (2·L·N·P), C · state (2·L·N·P) in the ``carried`` chunks a
    nonzero state enters, and the state carried across (2·P·N)."""
    nbytes = (x_elem * (2 * b * nc * l * h * p + b * nc * l * h)
              + bc_elem * 2 * b * nc * l * n + 4 * 2 * b * h * p * n)
    tri = l * (l + 1) // 2
    cb = b * nc * 2 * n * tri
    flops = (cb + b * nc * h * (2 * p * tri + 2 * l * n * p + 2 * p * n)
             + b * carried * h * 2 * l * n * p)
    return _timed(nbytes, flops, (cb / rate(bc_elem)
                                  + (flops - cb) / rate(x_elem, bc_elem))
                  * 1e3)


def scan_backward_bound(b, nc, l, h, p, n, bc_elem: int = 4) -> dict:
    """xdt, a_dt (fp32), b, c (``bc_elem`` bytes an element) and y's
    gradient (fp32) read and the four gradients written once, each in its
    input's dtype (a zero start and no final-state gradient, as in
    training); FLOPs at the fp32 rate (every product has an fp32 operand:
    dY, X or Σ_h dG), as many as these inputs need: per head and chunk dY
    Xᵀ and Mᵀ dY on the L(L+1)/2 causal pairs (2·P each) and four L·N·P
    products (Cᵀ (exp(A) ⊙ dY), B D, the head's terms of dB and dC), per
    batch and chunk (Σ_h dG) C and (Σ_h dG) B on the causal pairs (B and C
    are shared by the heads)."""
    nbytes = (4 * (3 * b * nc * l * h * p + 2 * b * nc * l * h)
              + bc_elem * 4 * b * nc * l * n)
    tri = l * (l + 1) // 2
    flops = b * nc * h * (4 * p * tri + 8 * l * n * p) + b * nc * 4 * n * tri
    return _timed(nbytes, flops, flops / FP32_FLOPS_PER_S * 1e3)
