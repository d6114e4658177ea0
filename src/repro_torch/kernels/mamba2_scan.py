"""Mamba2 SSD chunk scan: the wrapper of the hand-written CUDA kernel B5.

``mamba_chunk_scan`` is the port of
``src/repro/kernels/mamba2_scan.py::mamba_chunk_scan``, the Pallas TPU
kernel of the SSD chunk scan; kernel ``csrc/mamba2_scan.cu``, CUDA C++ for
sm_90a, built by ``_build``. The source notes what bounds it on the H100
and how its design differs from the TPU grid: four launches (acum, Cᵀ and
the causal tiles of C Bᵀ once per chunk; each chunk's own state; the state
carried across chunks; then y) where the TPU walks the chunks of one
(batch, head) in order. ``scan_plan`` lays the launches out from
host-known sizes, and the launcher refuses a plan whose shared memory
disagrees with its own. It takes an initial state and returns the final
one in the model's (B, H, P, N) convention — what the model's
``ssd_chunked`` computes — where the TPU kernel starts from zeros and
returns (B, H, N, P).

Tensors on the CPU take the plain version (``ref.mamba_chunk_scan_ref``);
tensors on a CUDA device launch the kernel or raise — there is no
fallback. ``mamba_chunk_scan.launches`` counts the kernel's calls (one per
call, whose four launches run on the current stream), and nothing else.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import _build, ref
from .moe_gmm import H100_SMS

# argtypes of every extern "C" function, by symbol
_SIG = {"mamba2_scan_f32": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
        + [ctypes.c_void_p],
        "mamba2_scan_occupancy": [ctypes.c_void_p]}
MAX_L, MAX_N, MAX_P = 128, 128, 64     # the kernel's shared-memory tiles
_GRID_YZ = 65535                       # gridDim.y (chunks), gridDim.z (batch)
# the source's sizes (csrc/mamba2_scan.cu): k rows a slab, stage buffers
# and acum slots of launches 2 and 4, their threads and the blocks an SM
# they are built for; launch 1's C and B tiles, rows padded by 4 floats
SLAB, STAGES, ACUM_SLOTS = 32, 2, 3
THREADS, BLOCKS_PER_SM = 128, 4
PREP_THREADS = PASS_THREADS = 256
PIPE_SMEM = 4 * (STAGES * SLAB * (MAX_L + MAX_P) + ACUM_SLOTS * MAX_L)
PREP_SMEM = 4 * (32 + MAX_L) * (MAX_N + 4)
WAVES = 2             # launches 2 and 4 take fewer heads a block below this
KERNELS = ("chunk_prep_kernel", "chunk_state_kernel", "state_pass_kernel",
           "chunk_scan_kernel")


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch: its grid, threads a block, heads a block (0: the launch
    does not walk heads) and dynamic shared memory a block (bytes)."""
    grid: tuple
    threads: int
    heads: int
    smem: int


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """One call of B5, from host-known sizes only: ``lp`` (L rounded up to
    4, the row stride of the acum, Cᵀ and Gᵀ scratch), the four launches
    in order (``prep``, ``state``, ``state_pass``, ``scan``) and the
    shapes of the scratch the wrapper allocates."""
    lp: int
    prep: Launch
    state: Launch
    state_pass: Launch
    scan: Launch
    scratch: dict

    @property
    def launches(self) -> dict:
        return dict(zip(KERNELS, (self.prep, self.state, self.state_pass,
                                  self.scan)))


def _heads_per_block(h: int, chunks: int, sms: int) -> int:
    """8 heads a block of launches 2 and 4 where the grid still makes WAVES
    waves of BLOCKS_PER_SM blocks on ``sms`` SMs, else 4 or 2, else 1: the
    more heads a block walks, the fewer pipelines fill and drain; the
    fewer, the fuller the card (``chunks`` = B x NC blocks a head group)."""
    for hb in (8, 4, 2):
        if -(-h // hb) * chunks >= WAVES * sms * BLOCKS_PER_SM:
            return hb
    return 1


@functools.lru_cache(maxsize=256)
def scan_plan(b: int, nc: int, l: int, h: int, p: int, n: int,
              sms: int = H100_SMS) -> ScanPlan:
    """B5's layout for xdt (B, NC, L, H, P) and b, c (B, NC, L, N) on a card
    of ``sms`` SMs: launch 1 a block per (32-row quarter of a chunk, chunk,
    batch); launches 2 and 4 a block per (head group, chunk, batch), the
    heads a block from ``_heads_per_block``; launch 3 a thread per 4
    elements of the (B, H, N, P) state."""
    lp = -(-l // 4) * 4
    hb = _heads_per_block(h, b * nc, sms)
    groups = (-(-h // hb), nc, b)
    return ScanPlan(
        lp,
        Launch((-(-lp // 32), nc, b), PREP_THREADS, 0, PREP_SMEM),
        Launch(groups, THREADS, hb, PIPE_SMEM),
        Launch((-(-(b * h * n * p // 4) // PASS_THREADS),), PASS_THREADS, 0,
               0),
        Launch(groups, THREADS, hb, PIPE_SMEM),
        {"states": (b, nc, h, n, p), "decay": (b, nc, h),
         "acum": (b, nc, h, lp), "ct": (b, nc, n, lp), "gt": (b, nc, l, lp)})


def _function(symbol: str):
    fn = getattr(_build.load("mamba2_scan"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIG[symbol]
        fn.restype = ctypes.c_int
    return fn


def occupancy(device=None) -> dict:
    """Blocks an SM the runtime grants each of B5's launches on ``device``
    (default: the current CUDA device), by kernel name: what
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports at each
    launch's block size and shared memory."""
    blocks = (ctypes.c_int * len(KERNELS))()
    with torch.cuda.device(device):
        rc = _function("mamba2_scan_occupancy")(ctypes.addressof(blocks))
    if rc != 0:
        raise RuntimeError(f"mamba2_scan_occupancy failed: cudaError {rc}")
    return dict(zip(KERNELS, blocks))


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
    plan = scan_plan(bsz, nc, l, h, p, n)
    y = torch.empty_like(xdt)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    # one scratch buffer, cut in the launcher's order: states (each chunk's
    # own state, then the state carried into it), acum, Cᵀ, Gᵀ, decay
    # last (every other size is a multiple of 4 floats: 16-byte aligned)
    order = ("states", "acum", "ct", "gt", "decay")
    sizes = [torch.Size(plan.scratch[k]).numel() for k in order]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    ptrs = dict(zip(order, (t.data_ptr() for t in flat.split(sizes))))
    fn = _function("mamba2_scan_f32")
    s0 = None if init_state is None else init_state.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(xdt.data_ptr(), a_dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                s0, y.data_ptr(), state.data_ptr(), ptrs["states"],
                ptrs["decay"], ptrs["acum"], ptrs["ct"], ptrs["gt"], bsz,
                nc, l, h, p, n, plan.state.heads, plan.scan.heads,
                plan.prep.smem, plan.state.smem, plan.scan.smem, stream)
    if rc != 0:
        raise RuntimeError(f"mamba_chunk_scan launch failed: cudaError {rc}")
    mamba_chunk_scan.launches += 1
    return y, state


mamba_chunk_scan.launches = 0
