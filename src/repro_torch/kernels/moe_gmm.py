"""Batched expert GEMM: the wrapper of the hand-written CUDA kernel B4.

``moe_gmm`` is the port of ``src/repro/kernels/moe_gmm.py::moe_gmm``, the
Pallas TPU kernel behind the capacity-dispatch MoE FFN's three expert GEMMs
(``models/moe.py``); kernel ``csrc/moe_gmm.cu``, CUDA C++ for sm_90a,
built by ``_build``. The source notes what bounds it on the H100 and how
its design differs from the TPU grid; it masks the ragged edges, so the
128-padding of the JAX op is not needed.

Tensors on the CPU take the plain version (``ref.moe_gmm_ref``); tensors on
a CUDA device launch the kernel or raise — there is no fallback.
``moe_gmm.launches`` counts the kernel's launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

# argtypes of every extern "C" launcher, by symbol
_SIG = {"moe_gmm_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]}
_GRID_Y = _GRID_Z = 65535     # gridDim.y (row tiles), gridDim.z (experts)


def _launcher():
    fn = _build.load("moe_gmm").moe_gmm_f32
    if fn.argtypes is None:
        fn.argtypes = _SIG["moe_gmm_f32"]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what the kernel does not take: x (E, C, K) and w (E, K, N),
    float32, contiguous, on one device, E <= 65535, at most 65535 row
    tiles, K and N int32."""
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype} "
                            "(bf16 is later work)")
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    e, c, k = x.shape
    if w.shape[0] != e or w.shape[1] != k:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: "
                         "want (E, C, K) and (E, K, N)")
    if e > _GRID_Z:
        raise ValueError(f"{e} experts: the kernel takes at most {_GRID_Z}")
    if c > _GRID_Y * 64:     # 64-row tiles beyond C = 32
        raise ValueError(f"C={c}: the kernel takes at most {_GRID_Y * 64}")
    if max(k, w.shape[2]) >= 2 ** 31:
        raise ValueError("K and N must fit in an int32")


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, K) @ w (E, K, N) → (E, C, N), one GEMM per expert, fp32
    accumulation."""
    if x.device.type == "cpu":
        return ref.moe_gmm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no moe_gmm for {x.device}")
    _check(x, w)
    e, c, k = x.shape
    n = w.shape[2]
    out = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, k, n,
                stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm launch failed: cudaError {rc}")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
