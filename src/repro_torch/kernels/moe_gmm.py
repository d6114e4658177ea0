"""Batched expert GEMM: the wrapper of the hand-written CUDA kernel B4.

``moe_gmm`` is the port of ``src/repro/kernels/moe_gmm.py::moe_gmm``, the
Pallas TPU kernel behind the capacity-dispatch MoE FFN's three expert GEMMs
(``models/moe.py``); kernel ``csrc/moe_gmm.cu``, CUDA C++ for sm_90a,
built by ``_build``. The source notes what bounds it on the H100 and how
its design differs from the TPU grid; it masks the ragged edges, so the
128-padding of the JAX op is not needed. ``gmm_plan`` picks its body (the
8 x 8-per-thread tile body at prefill capacities, the streaming body with
split K at decode capacities), row tile and split count from the shapes
alone.

Tensors on the CPU take the plain version (``ref.moe_gmm_ref``); tensors on
a CUDA device launch the kernel or raise — there is no fallback.
``moe_gmm.launches`` counts the kernel's calls (one per call, whose one or
two launches — the GEMM and, with split K, the sum of the parts — run on
the current stream), and nothing else.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, ref

# argtypes of every extern "C" launcher, by symbol
_SIG = {"moe_gmm_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_void_p]}
GRID_X = 2 ** 31 - 1          # gridDim.x: row tiles
GRID_YZ = 65535               # gridDim.y: column tiles; gridDim.z: E x parts
BN = 128                      # output columns a block
TILE_ROWS = (128, 64, 32)     # the tile body's row tiles (C > STREAM_MAX_C)
STREAM_ROWS = (4, 8, 16, 20, 32)   # the stream body's row tiles
STREAM_MAX_C = 32
STAGES, TILE_BK, STREAM_BK = 4, 16, 32
STREAM_THREADS = 128
MAX_PARTS = 8
WAVES = 4                     # the stream body splits K up to this many waves
SMEM_PER_SM = 232448          # H100: what one SM's blocks may hold
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class GmmPlan:
    """One call of B4: the body (``tile`` or ``stream``), its row tile,
    the K parts (1: no split), the grid (row tiles, column tiles, E x
    parts), threads and dynamic shared memory a block, and the shape of
    the partial sums' scratch (None without split K)."""
    body: str
    rows: int
    parts: int
    grid: tuple
    threads: int
    smem: int
    scratch: tuple | None


def _padded(c: int, rows: int) -> int:
    return -(-c // rows) * rows


@functools.lru_cache(maxsize=256)
def gmm_plan(e: int, c: int, k: int, n: int, sms: int = H100_SMS) -> GmmPlan:
    """The body, row tile and split count for x (E, C, K) @ w (E, K, N) on
    a card of ``sms`` SMs. C > 32 takes the tile body (2 x BM threads)
    with the row tile that pads C least (the larger on a tie: 160 → 32,
    640 → 128, 960 → 64). C <= 32 takes the stream body with the first row tile at or past
    C; when its E x column-tile blocks fill under WAVES waves of the card,
    K is split into the parts that make WAVES waves (at most 8, each at
    least 4 slabs deep), so that the last wave's tail idles little of the
    card."""
    col_tiles = -(-n // BN)
    if c > STREAM_MAX_C:
        rows = min(TILE_ROWS, key=lambda r: (_padded(c, r), -r))
        smem = STAGES * (TILE_BK * (rows + 4) + TILE_BK * BN) * 4
        return GmmPlan("tile", rows, 1, (-(-c // rows), col_tiles, e),
                       2 * rows, smem, None)
    rows = next(r for r in STREAM_ROWS if r >= c)
    smem = STAGES * (rows * STREAM_BK + STREAM_BK * BN) * 4
    per_sm = max(1, min(65536 // (STREAM_THREADS * 128),
                        SMEM_PER_SM // (smem + 1024)))
    wave = sms * per_sm
    blocks = e * col_tiles * -(-c // rows)
    slabs = -(-k // STREAM_BK)
    parts = 1
    if 0 < blocks < WAVES * wave:
        parts = max(1, min(MAX_PARTS, -(-WAVES * wave // blocks),
                           slabs // 4))
    return GmmPlan("stream", rows, parts, (-(-c // rows), col_tiles,
                                           e * parts), STREAM_THREADS, smem,
                   (parts, e, c, n) if parts > 1 else None)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launcher():
    fn = _build.load("moe_gmm").moe_gmm_f32
    if fn.argtypes is None:
        fn.argtypes = _SIG["moe_gmm_f32"]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor,
           sms: int = H100_SMS) -> GmmPlan:
    """Raise on what the kernel does not take: x (E, C, K) and w (E, K, N),
    float32, contiguous, on one device, C, K and N int32, and a plan whose
    grid fits CUDA's limits (column tiles and E x parts at most 65535).
    Returns the plan."""
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
    n = w.shape[2]
    if max(c, k, n) >= 2 ** 31:
        raise ValueError("C, K and N must fit in an int32")
    plan = gmm_plan(e, c, k, n, sms)
    gx, gy, gz = plan.grid
    if gx > GRID_X or gy > GRID_YZ or gz > GRID_YZ:
        raise ValueError(f"E={e}, C={c}, N={n}: grid {plan.grid} is past "
                         f"CUDA's ({GRID_X}, {GRID_YZ}, {GRID_YZ})")
    return plan


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, K) @ w (E, K, N) → (E, C, N), one GEMM per expert, fp32
    accumulation."""
    if x.device.type == "cpu":
        return ref.moe_gmm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no moe_gmm for {x.device}")
    plan = _check(x, w, _sms(x.device.index if x.device.index is not None
                             else torch.cuda.current_device()))
    e, c, k = x.shape
    n = w.shape[2]
    out = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    scratch = (None if plan.scratch is None else
               torch.empty(plan.scratch, dtype=torch.float32,
                           device=x.device))
    fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), e, c, k, n,
                int(plan.body == "tile"), plan.rows, plan.parts, stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm launch failed: cudaError {rc}")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
