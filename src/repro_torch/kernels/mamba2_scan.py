"""Mamba2 SSD chunk scan: the wrapper of the hand-written CUDA kernel B5.

``mamba_chunk_scan`` is the port of
``src/repro/kernels/mamba2_scan.py::mamba_chunk_scan``, the Pallas TPU
kernel of the SSD chunk scan; kernel ``csrc/mamba2_scan.cu``, CUDA C++ for
sm_90a, built by ``_build``. The source notes what bounds it on the H100
and how its design differs from the TPU grid: three launches (each chunk's
own state, the state carried across chunks, then y) where the TPU walks
the chunks of one (batch, head) in order. It takes an initial state and
returns the final one in the model's (B, H, P, N) convention — what the
model's ``ssd_chunked`` computes — where the TPU kernel starts from zeros
and returns (B, H, N, P).

Tensors on the CPU take the plain version (``ref.mamba_chunk_scan_ref``);
tensors on a CUDA device launch the kernel or raise — there is no
fallback. ``mamba_chunk_scan.launches`` counts the kernel's calls (one per
call, whose three launches run on the current stream), and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref

# argtypes of every extern "C" launcher, by symbol
_SIG = {"mamba2_scan_f32": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_void_p]}
MAX_L, MAX_N, MAX_P = 128, 128, 64     # the kernel's shared-memory tiles
_GRID_YZ = 65535                       # gridDim.y (chunks), gridDim.z (batch)


def _launcher():
    fn = _build.load("mamba2_scan").mamba2_scan_f32
    if fn.argtypes is None:
        fn.argtypes = _SIG["mamba2_scan_f32"]
        fn.restype = ctypes.c_int
    return fn


def _check(xdt, a_dt, b, c, init_state) -> None:
    """Raise on what the kernel does not take: xdt (B, NC, L, H, P), a_dt
    (B, NC, L, H), b and c (B, NC, L, N), init_state (B, H, P, N) or None;
    float32, contiguous, 16-byte aligned, on one device; 1 <= L <= 128,
    N in 4..128 and P in 4..64, both multiples of 4 (mamba2-1.3b: L 128,
    N 128, P 64; its reduced config: N 16, P 16); B and NC in 1..65535,
    H at least 1."""
    named = [("xdt", xdt, 5), ("a_dt", a_dt, 4), ("b", b, 4), ("c", c, 4)]
    if init_state is not None:
        named.append(("init_state", init_state, 4))
    for name, t, rank in named:
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, xdt on {xdt.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != rank:
            raise ValueError(f"{name} must be {rank}-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    bsz, nc, l, h, p = xdt.shape
    n = b.shape[-1]
    if tuple(a_dt.shape) != (bsz, nc, l, h):
        raise ValueError(f"a_dt {tuple(a_dt.shape)} does not match xdt "
                         f"{tuple(xdt.shape)}")
    for name, t in (("b", b), ("c", c)):
        if tuple(t.shape) != (bsz, nc, l, n):
            raise ValueError(f"{name} {tuple(t.shape)}: want "
                             f"{(bsz, nc, l, n)}")
    if init_state is not None and tuple(init_state.shape) != (bsz, h, p, n):
        raise ValueError(f"init_state {tuple(init_state.shape)}: want "
                         f"{(bsz, h, p, n)}")
    if not (1 <= l <= MAX_L and 4 <= n <= MAX_N and n % 4 == 0
            and 4 <= p <= MAX_P and p % 4 == 0):
        raise ValueError(
            f"no B5 for chunk L={l}, state N={n}, head P={p}: it takes L "
            f"1..{MAX_L}, N 4..{MAX_N} and P 4..{MAX_P}, N and P multiples "
            f"of 4")
    if not (1 <= nc <= _GRID_YZ and 1 <= bsz <= _GRID_YZ and h >= 1):
        raise ValueError(f"B={bsz}, NC={nc}, H={h}: B and NC must be in "
                         f"1..{_GRID_YZ}, H at least 1")


def mamba_chunk_scan(xdt: torch.Tensor, a_dt: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, init_state: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD chunk scan. xdt (B, NC, L, H, P), a_dt (B, NC, L, H), b and c
    (B, NC, L, N), init_state (B, H, P, N) or None (zeros) → (y (B, NC, L,
    H, P), final state (B, H, P, N)), fp32."""
    if xdt.device.type == "cpu":
        return ref.mamba_chunk_scan_ref(xdt, a_dt, b, c, init_state)
    if xdt.device.type != "cuda":
        raise ValueError(f"no mamba_chunk_scan for {xdt.device}")
    _check(xdt, a_dt, b, c, init_state)
    bsz, nc, l, h, p = xdt.shape
    n = b.shape[-1]
    dev = xdt.device
    y = torch.empty_like(xdt)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    # scratch: each chunk's own state, then the state carried into it
    states = torch.empty((bsz, nc, h, n, p), dtype=torch.float32, device=dev)
    decay = torch.empty((bsz, nc, h), dtype=torch.float32, device=dev)
    fn = _launcher()
    s0 = None if init_state is None else init_state.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(xdt.data_ptr(), a_dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                s0, y.data_ptr(), state.data_ptr(), states.data_ptr(),
                decay.data_ptr(), bsz, nc, l, h, p, n, stream)
    if rc != 0:
        raise RuntimeError(f"mamba_chunk_scan launch failed: cudaError {rc}")
    mamba_chunk_scan.launches += 1
    return y, state


mamba_chunk_scan.launches = 0
