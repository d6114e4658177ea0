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

dtypes, as the Pallas kernel and the model's ``ssd_chunked`` take them:
all fp32; fp32 xdt and a_dt with bf16 b and c and fp32 y (the model's at
bf16 compute: ``ssd_chunked`` forms x·dt in fp32 and returns fp32 y); or
all bf16 with y in bf16 (the Pallas kernel's contract, forward only). The
initial and final states and all scratch are fp32; bf16 is widened
exactly in the kernel and y rounded once. Any other combination raises
``TypeError``.

Tensors on the CPU take the plain version (``ref.mamba_chunk_scan_ref``);
tensors on a CUDA device launch the kernel or raise — there is no
fallback. Tensors on the ``meta`` device take the abstract route of a dry
run (``launch.dryrun``): the checks, the plan and the allocation of the
outputs and the scratch, as on the card, and no launch. On every route
the call is reported to an active cost analysis (``bounds.counted``, by
``bounds.scan_bound``; its backward by ``bounds.scan_backward_bound``).
``mamba_chunk_scan.launches`` counts the kernel's calls (one per
call, whose four launches run on the current stream), and nothing else.

``mamba_chunk_scan_backward`` is B5's backward, the VJP of the model's
``ssd_chunked`` (the JAX package has no Pallas backward: its training
differentiates that einsum), five more launches of the same source from
the carried states, acum, decay and Gᵀ the forward left in its scratch;
``ref.mamba_chunk_scan_backward_ref`` on the CPU. It reads y's gradient
and y in fp32, takes fp32 xdt and a_dt with b and c in fp32 or bf16, and
writes each input's gradient in that input's dtype.
``mamba_chunk_scan_backward.launches`` counts its calls. ``MambaChunkScan``
is the ``torch.autograd.Function`` of the two, the way the model reaches
B5 (``ops.mamba_chunk_scan_op``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import _build, bounds, ref
from .moe_gmm import H100_SMS

_F32, _BF16 = torch.float32, torch.bfloat16
# the launchers by (xdt and a_dt, b and c[, y]) dtype
_FORWARD = {(_F32, _F32, _F32): "mamba2_scan_f32",
            (_F32, _BF16, _F32): "mamba2_scan_f32_bf16bc",
            (_BF16, _BF16, _BF16): "mamba2_scan_bf16"}
_BACKWARD = {(_F32, _F32): "mamba2_scan_bwd_f32",
             (_F32, _BF16): "mamba2_scan_bwd_f32_bf16bc"}
# argtypes of every extern "C" function, by symbol
_SIG = {**{k: [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
           + [ctypes.c_void_p] for k in _FORWARD.values()},
        **{k: [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8
           + [ctypes.c_void_p] for k in _BACKWARD.values()},
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
# the backward's five launches, in order (the first two on the bodies of
# chunk_state and state_pass)
BACKWARD_KERNELS = ("bwd_state_kernel", "bwd_pass_kernel", "bwd_chunk_kernel",
                    "bwd_dg_sum_kernel", "bwd_bc_kernel")


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
    xdt and a_dt float32 or bfloat16 alike, b and c float32 or bfloat16
    alike and bf16 where xdt is, init_state float32 (``TypeError``
    otherwise; which y and which backward each takes: ``_FORWARD``,
    ``_BACKWARD``); contiguous, 16-byte aligned, on one device; 1 <= L <= 128,
    N in 4..128 and P in 4..64, both multiples of 4 (mamba2-1.3b: L 128,
    N 128, P 64; its reduced config: N 16, P 16); B and NC in 1..65535,
    H at least 1."""
    named = [("xdt", xdt, 5), ("a_dt", a_dt, 4), ("b", b, 4), ("c", c, 4)]
    if init_state is not None:
        named.append(("init_state", init_state, 4))
    for name, t, rank in named:
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, xdt on {xdt.device}")
        if t.dim() != rank:
            raise ValueError(f"{name} must be {rank}-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if ((xdt.dtype, b.dtype) not in {k[:2] for k in _FORWARD}
            or a_dt.dtype != xdt.dtype
            or c.dtype != b.dtype
            or (init_state is not None and init_state.dtype != _F32)):
        raise TypeError(
            f"B5 takes xdt and a_dt float32 or bfloat16 alike, b and c "
            f"likewise (bf16 where xdt is), a float32 initial state; got "
            f"{xdt.dtype}, {a_dt.dtype}, {b.dtype}, {c.dtype}, "
            f"{None if init_state is None else init_state.dtype} "
            f"(fp16: ROADMAP B6)")
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
                     c: torch.Tensor, init_state: Optional[torch.Tensor] = None,
                     y_dtype: Optional[torch.dtype] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD chunk scan. xdt (B, NC, L, H, P), a_dt (B, NC, L, H), b and c
    (B, NC, L, N), init_state (B, H, P, N) or None (zeros) → (y (B, NC, L,
    H, P) in ``y_dtype`` (xdt's if None), final state (B, H, P, N) fp32).
    No autograd graph: the model differentiates it through
    ``MambaChunkScan``."""
    if xdt.device.type == "cpu":
        return _plain(xdt, a_dt, b, c, init_state, y_dtype)
    y, state, _ = _launch(xdt, a_dt, b, c, init_state, y_dtype)
    return y, state


def _bound(xdt, b, init_state) -> dict:
    """``bounds.scan_bound`` of one call: C · state in every chunk after
    the first, and in the first where an initial state is passed (the
    kernel cannot know that it is zero)."""
    bsz, nc, l, h, p = xdt.shape
    carried = nc - 1 + (init_state is not None)
    return bounds.scan_bound(bsz, nc, l, h, p, b.shape[-1], carried,
                             xdt.element_size(), b.element_size())


def _plain(xdt, a_dt, b, c, init_state, y_dtype):
    """The plain version on the CPU, counted as one B5 call."""
    with bounds.counted("mamba2_scan", lambda: _bound(xdt, b, init_state)):
        return ref.mamba_chunk_scan_ref(xdt, a_dt, b, c, init_state, y_dtype)


def _launch(xdt, a_dt, b, c, init_state, y_dtype=None):
    """B5 on a CUDA device, or its abstract route on ``meta`` tensors
    (everything but the launch): (y, final state, the scratch by name —
    states (B, NC, H, N, P) now the carried ones, acum, decay, ct, gt —
    that the backward reads)."""
    if xdt.device.type not in ("cuda", "meta"):
        raise ValueError(f"no mamba_chunk_scan for {xdt.device}")
    with bounds.counted("mamba2_scan", lambda: _bound(xdt, b, init_state)):
        _check(xdt, a_dt, b, c, init_state)
        y_dtype = xdt.dtype if y_dtype is None else y_dtype
        symbol = _FORWARD.get((xdt.dtype, b.dtype, y_dtype))
        if symbol is None:
            raise TypeError(f"no B5 for {xdt.dtype} xdt with y in "
                            f"{y_dtype}: y is float32 from float32 xdt, or "
                            f"bfloat16 from bfloat16 inputs")
        bsz, nc, l, h, p = xdt.shape
        n = b.shape[-1]
        dev = xdt.device
        plan = scan_plan(bsz, nc, l, h, p, n)
        y = torch.empty_like(xdt, dtype=y_dtype)
        state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                            device=dev)
        # one scratch buffer, cut in the launcher's order: states (each
        # chunk's own state, then the state carried into it), acum, Cᵀ,
        # Gᵀ, decay last (every other size is a multiple of 4 floats:
        # 16-byte aligned)
        order = ("states", "acum", "ct", "gt", "decay")
        sizes = [torch.Size(plan.scratch[k]).numel() for k in order]
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        scratch = {k: t.view(plan.scratch[k])
                   for k, t in zip(order, flat.split(sizes))}
        if dev.type == "meta":
            return y, state, scratch
        fn = _function(symbol)
        s0 = None if init_state is None else init_state.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(xdt.data_ptr(), a_dt.data_ptr(), b.data_ptr(),
                    c.data_ptr(), s0, y.data_ptr(), state.data_ptr(),
                    *(scratch[k].data_ptr()
                      for k in ("states", "decay", "acum", "ct", "gt")),
                    bsz, nc, l, h, p, n, plan.state.heads, plan.scan.heads,
                    plan.prep.smem, plan.state.smem, plan.scan.smem, stream)
        if rc != 0:
            raise RuntimeError(f"mamba_chunk_scan launch failed: "
                               f"cudaError {rc}")
        mamba_chunk_scan.launches += 1
        return y, state, scratch


mamba_chunk_scan.launches = 0


def mamba_chunk_scan_backward(xdt, a_dt, b, c, init_state, dy, dfinal,
                              saved, needs):
    """B5's backward: the gradients (dxdt, da_dt, db, dc, dinit) of
    ``mamba_chunk_scan(xdt, a_dt, b, c, init_state)`` for y's gradient
    ``dy`` and the final state's ``dfinal`` (either None: zeros; both
    fp32), each None where ``needs`` (five flags, the inputs' order) says
    it is not wanted, each in its input's dtype. ``saved``: on a CUDA
    device the forward's y (fp32) and its scratch (``_launch``), unused on
    the CPU, where the plain version runs."""
    if dy is None:
        dy = torch.zeros(xdt.shape, dtype=torch.float32, device=xdt.device)
    with bounds.counted("mamba2_scan_backward",
                        lambda: bounds.scan_backward_bound(
                            *xdt.shape, b.shape[-1], b.element_size())):
        if xdt.device.type == "cpu":
            grads = ref.mamba_chunk_scan_backward_ref(xdt, a_dt, b, c,
                                                      init_state, dy, dfinal)
            return tuple(g if need else None
                         for g, need in zip(grads, needs))
        return _backward(xdt, a_dt, b, c, init_state, dy, dfinal, saved,
                         needs)


def _backward(xdt, a_dt, b, c, init_state, dy, dfinal, saved, needs):
    """B5's backward on a CUDA device, or its abstract route on ``meta``
    tensors (everything but the launch)."""
    if xdt.device.type not in ("cuda", "meta"):
        raise ValueError(f"no mamba_chunk_scan_backward for {xdt.device}")
    _check(xdt, a_dt, b, c, init_state)
    symbol = _BACKWARD.get((xdt.dtype, b.dtype))
    if symbol is None:
        raise TypeError(f"B5's backward takes float32 xdt and a_dt, got "
                        f"{xdt.dtype}")
    dy = dy.contiguous()
    if dy.data_ptr() % 16:     # launch 1 copies dY's rows 16 bytes at a time
        dy = dy.clone()
    dfinal = None if dfinal is None else dfinal.contiguous()
    bsz, nc, l, h, p = xdt.shape
    n = b.shape[-1]
    for name, t, shape in (("dy", dy, xdt.shape),
                           ("dfinal", dfinal, (bsz, h, p, n))):
        if t is not None and (t.device != xdt.device
                              or t.dtype != torch.float32
                              or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{name} must be float32 {tuple(shape)} on "
                             f"{xdt.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    y, scratch = saved
    if y.dtype != torch.float32:
        raise TypeError(f"B5's backward reads y in float32, got {y.dtype}")
    dev = xdt.device
    plan = scan_plan(bsz, nc, l, h, p, n)
    dx, da = torch.empty_like(xdt), torch.empty_like(a_dt)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    dinit = (torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
             if needs[4] else None)
    # dstates (U, then D = dS_{c+1}) in the forward's state layout, dG a
    # head, Σ_h dG
    shapes = {"dstates": (bsz, nc, h, n, p), "dg": (bsz, nc, h, l, l),
              "dgsum": (bsz, nc, l, l)}
    sizes = [torch.Size(v).numel() for v in shapes.values()]
    work = dict(zip(shapes, torch.empty(sum(sizes), dtype=torch.float32,
                                        device=dev).split(sizes)))
    if dev.type == "meta":
        return tuple(g if need else None
                     for g, need in zip((dx, da, db, dc, dinit), needs))
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _function(symbol)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(xdt.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                dy.data_ptr(), ptr(dfinal), ptr(dinit),
                *(scratch[k].data_ptr() for k in ("states", "acum", "decay",
                                                  "gt")),
                *(work[k].data_ptr() for k in ("dstates", "dg", "dgsum")),
                dx.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
                bsz, nc, l, h, p, n, plan.state.heads, plan.state.smem,
                stream)
    if rc != 0:
        raise RuntimeError(f"mamba_chunk_scan_backward launch failed: "
                           f"cudaError {rc}")
    mamba_chunk_scan_backward.launches += 1
    return tuple(g if need else None
                 for g, need in zip((dx, da, db, dc, dinit), needs))


mamba_chunk_scan_backward.launches = 0


class MambaChunkScan(torch.autograd.Function):
    """``mamba_chunk_scan`` with its backward on ``mamba_chunk_scan_backward``
    (one call, one launch count, a backward pass). On the CPU the forward
    is ``ref.mamba_chunk_scan_ref`` and the backward
    ``ref.mamba_chunk_scan_backward_ref``. On the card a forward that may
    be differentiated takes fp32 xdt and a_dt and writes y in fp32, which
    the backward reads (``_BACKWARD``: the model's dtypes)."""

    @staticmethod
    def forward(ctx, xdt, a_dt, b, c, init_state, y_dtype=None):
        ctx.set_materialize_grads(False)
        if xdt.device.type == "cpu":
            ctx.save_for_backward(xdt, a_dt, b, c, init_state)
            return _plain(xdt, a_dt, b, c, init_state, y_dtype)
        if any(ctx.needs_input_grad[:5]) and (
                (xdt.dtype, b.dtype) not in _BACKWARD
                or (y_dtype or xdt.dtype) != torch.float32):
            raise TypeError(f"B5's backward takes float32 xdt and a_dt and "
                            f"reads y in float32: got {xdt.dtype} xdt, y in "
                            f"{y_dtype or xdt.dtype}")
        y, state, scratch = _launch(xdt, a_dt, b, c, init_state, y_dtype)
        ctx.save_for_backward(xdt, a_dt, b, c, init_state, y,
                              *(scratch[k] for k in ("states", "acum",
                                                     "decay", "gt")))
        return y, state

    @staticmethod
    def backward(ctx, dy, dfinal):
        xdt, a_dt, b, c, init_state, *rest = ctx.saved_tensors
        saved = None
        if rest:
            y, states, acum, decay, gt = rest
            saved = (y, {"states": states, "acum": acum, "decay": decay,
                         "gt": gt})
        grads = mamba_chunk_scan_backward(xdt, a_dt, b, c, init_state, dy,
                                          dfinal, saved,
                                          ctx.needs_input_grad[:5])
        return (*grads, None)
