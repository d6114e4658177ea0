"""Paged attention: the wrappers of the hand-written CUDA kernels.

* ``paged_attention_ragged`` — port of
  ``src/repro/kernels/paged_attention.py::paged_attention_ragged`` (the
  Pallas TPU kernel the fused serving step launches once per layer);
  kernel ``csrc/paged_attention_ragged.cu`` (B1).
* ``paged_attention`` — port of ``paged_attention.py::paged_attention``,
  the batched (B, Tq) kernel of sequential mode, committed multi-step
  decode, the speculative draft/verify passes and the fused step's
  non-ragged backend; kernel ``csrc/paged_attention.cu`` (B3).
* ``paged_attention_ragged_quant`` — port of
  ``paged_attention.py::paged_attention_ragged_quant``: ragged attention
  over int8 or fp8-e4m3 K/V with f32 row scales (DESIGN.md §14), the fused
  step's attention under quantized KV, and (flattened by
  ``ops.paged_attention_quant_op``) the batched paths'; kernel
  ``csrc/paged_attention_ragged_quant.cu`` (B2).

All three are CUDA C++ for sm_90a, built by ``_build``, on one body
(``csrc/attention_body.cuh``): split-KV decode tiles merged by a second
launch and register-tiled chunk tiles, over fp32, bf16 or 1-byte pools, in
the ragged (B1, B2) or batched (B3) layout. q and the output are fp32 or
bf16, as the Pallas kernels take them: B1 and B3 take fp32 or bf16 q with
pools of q's dtype, B2 either q over its 1-byte pools; the math is fp32
and a bf16 output is rounded once. Any other dtype raises ``TypeError``. ``quant_plan`` lays out a ragged
call, ``batched_plan`` a batched one, ``body_smem`` states the shared
memory of the body's kernels. The sources note what bounds them on the
H100 and how their design differs from the TPU grid.

Tensors on the CPU take the plain version (``ref.py``); tensors on a CUDA
device launch the kernel or raise — there is no fallback. Each wrapper's
``launches`` counts its calls that launch on the card (one for the one to
three launches of a call), and nothing else, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import _build, ref
from .moe_gmm import H100_SMS, SMEM_PER_SM, _sms

_TAIL = [ctypes.c_int] * 8 + [ctypes.c_float]   # T|B ... window, scale
_RAGGED = [ctypes.c_void_p] * 11 + _TAIL + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]
_QUANT = [ctypes.c_void_p] * 14 + _TAIL + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]
# argtypes of every extern "C" launcher, by symbol
_BATCHED = [ctypes.c_void_p] * 9 + _TAIL + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_SIG = {"paged_attention_ragged_f32": _RAGGED,
        "paged_attention_ragged_bf16": _RAGGED,
        "paged_attention_f32": _BATCHED, "paged_attention_bf16": _BATCHED,
        **{f"paged_attention_ragged_quant_{v}{q}": _QUANT
           for v in ("i8", "f8") for q in ("", "_bf16")}}
# the dtypes of q (and of B1's and B3's pools), with their launcher suffix
_Q_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# B2's launcher suffix by value dtype (then "_bf16" for a bf16 q)
_QUANT_SUFFIX = {torch.int8: "i8", torch.float8_e4m3fn: "f8"}
# The body's tiles (csrc/attention_body.cuh). Ragged: a sequence whose
# rows x G fit max(MIN_DECODE_VECS, G) query vectors is one split-KV decode
# tile, any other is cut into chunk tiles of CHUNK_VECS vectors. Batched:
# Tq x G <= MAX_DECODE_VECS makes decode tiles of that many vectors rounded
# up to DECODE_VECS, more makes chunk tiles. Splits are whole multiples of
# SPLIT_UNIT keys, at least MIN_SPLIT_UNITS of them (each warp's 2-stage
# ring streams), at most MAX_SPLITS over the table
MIN_DECODE_VECS, CHUNK_VECS = 4, 64
DECODE_VECS = (4, 8, 16)
MAX_DECODE_VECS = DECODE_VECS[-1]
SPLIT_UNIT, MIN_SPLIT_UNITS, MAX_SPLITS = 128, 4, 16
GRID_X = 2 ** 31 - 1          # gridDim.x: every grid is one-dimensional
# The body's warps a block, the shared memory CUDA reserves a block, the
# blocks a chunk launch keeps on an SM (its launch bounds; fewer where
# shared memory says so), and the waves of the card that batched chunk
# tiles fill before their keys are split
WARPS = 4
SMEM_PER_BLOCK = 1024
CHUNK_BLOCKS_PER_SM = 3
CHUNK_WAVES = 2


def body_smem(d: int, elem: int, ch: int, vecs: int) -> tuple[int, int]:
    """Dynamic shared memory (bytes) of the body's decode_split_kernel for
    ``vecs``-vector tiles and of its chunk_tile_kernel, over pools of
    ``elem``-byte values (4: fp32; 2: bf16; 1: int8 or fp8-e4m3, with
    scales) copied ``ch`` bytes at a time: ``decode_smem`` and
    ``chunk_smem`` of csrc/attention_body.cuh, which refuses a launch whose
    plan states other sizes. bf16 and 1-byte values are widened after the
    copy (kWide); only 1-byte values carry scales (kScaled)."""
    wide, scaled = elem != 4, elem == 1
    sub, keys = (32, 64) if wide else (16, 32)    # kSubKeys, kChunkKeys
    rs = ((d * elem // ch) | 1) * ch               # row_stride
    st4 = ((d // 4) | 1) * 16                      # a widened row
    stage = lambda nk: nk * (2 * rs + (8 if scaled else 0))
    dec = (vecs * d * 4 + WARPS * vecs * sub * 4 + 2 * WARPS * vecs * 4
           + WARPS * 2 * stage(sub))
    chunk = CHUNK_VECS * d * 4 + (2 * keys * st4 + stage(keys) if wide
                                  else 2 * 2 * keys * st4)
    return dec, chunk


def _splits(n_keys: int) -> tuple[int, int]:
    """(keys a split, splits) of a table of ``n_keys`` keys: 512 keys, or
    more for tables past 16 x 512 keys so that there are at most 16."""
    split_keys = SPLIT_UNIT * max(MIN_SPLIT_UNITS,
                                  -(-n_keys // (SPLIT_UNIT * MAX_SPLITS)))
    return split_keys, max(1, -(-n_keys // split_keys))


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """One call of the ragged layout (B2, and B1 on fp32 pools), from
    host-known sizes only: keys a split, splits over the table, vectors of
    a decode tile, rows of a chunk tile, chunk tiles, the blocks of the
    decode and chunk launches (upper bounds, the KV head fastest; blocks
    without work leave at once; the merge takes S x Hkv) and the shapes of
    the split scratch."""
    split_keys: int
    n_splits: int
    decode_vecs: int
    chunk_rows: int
    chunk_tiles: int
    decode_blocks: int
    chunk_blocks: int
    part_out: tuple
    part_lse: tuple


@functools.lru_cache(maxsize=256)
def quant_plan(t: int, s: int, n_keys: int, h: int, hkv: int,
               d: int) -> QuantPlan:
    """The ragged layout of a step of ``t`` packed rows over ``s``
    sequences whose tables reach ``n_keys`` = n_pages x page keys, H query
    heads on Hkv KV heads of width ``d`` (B1's and B2's). A decode tile
    holds max(4, G) vectors: a decode row of G heads (at G <= 2 a few
    rows). Splits follow ``_splits``; the chunk tiles are at most
    ceil(T / rows) + S (each sequence's last tile may be partial)."""
    g = h // hkv
    vecs = max(MIN_DECODE_VECS, g)
    split_keys, n_splits = _splits(n_keys)
    chunk_rows = CHUNK_VECS // g
    chunk_tiles = -(-t // chunk_rows) + s
    return QuantPlan(split_keys, n_splits, vecs, chunk_rows, chunk_tiles,
                     s * n_splits * hkv, chunk_tiles * hkv,
                     (s, n_splits, hkv, vecs, d), (s, n_splits, hkv, vecs))


@dataclasses.dataclass(frozen=True)
class BatchedPlan:
    """One call of B3, from host-known sizes only: vectors a tile (4, 8 or
    16: decode tiles of one sequence's Tq rows; 64: chunk tiles of ``rows``
    rows), tiles, keys a split and splits over the table (1: the keys are
    not split), the blocks of the split or chunk launch and of the merge
    (0: no merge), the shapes of the split scratch (None without a merge)
    and the launch's dynamic shared memory."""
    vecs: int
    rows: int
    tiles: int
    split_keys: int
    n_splits: int
    blocks: int
    merge_blocks: int
    part_out: Optional[tuple]
    part_lse: Optional[tuple]
    smem: int


@functools.lru_cache(maxsize=256)
def batched_plan(b: int, tq: int, n_keys: int, h: int, hkv: int, d: int,
                 sms: int = H100_SMS, elem: int = 4) -> BatchedPlan:
    """B3's layout for q (B, Tq, H, D) over tables of ``n_keys`` keys on a
    card of ``sms`` SMs, pools of ``elem``-byte values (4: fp32, 2: bf16;
    the shared memory, and so the blocks an SM, follow it). Tq x G <= 16: decode tiles of Tq x G vectors
    rounded up to 4, 8 or 16, their keys split as ``_splits`` says (the
    same splits as B1's for a table of the same width), then merged. Else
    chunk tiles of 64 vectors, a sequence's Tq rows cut into
    ceil(Tq / (64 / G)) of them; when their B x tiles x Hkv blocks fill
    less than CHUNK_WAVES waves of the card (CHUNK_BLOCKS_PER_SM blocks an
    SM, fewer where shared memory says so), their keys are split into as
    many splits of whole SPLIT_UNITs, at least 512 keys each and at most
    MAX_SPLITS, as make up the waves, and merged."""
    g = h // hkv
    if tq * g <= MAX_DECODE_VECS:
        vecs = next(v for v in DECODE_VECS if v >= tq * g)
        split_keys, n_splits = _splits(n_keys)
        smem = body_smem(d, elem, 16, vecs)[0]
        return BatchedPlan(vecs, tq, b, split_keys, n_splits,
                           b * n_splits * hkv, b * hkv,
                           (b, n_splits, hkv, vecs, d),
                           (b, n_splits, hkv, vecs), smem)
    rows = CHUNK_VECS // g
    tiles = b * -(-tq // rows)
    smem = body_smem(d, elem, 16, MIN_DECODE_VECS)[1]
    per_sm = min(CHUNK_BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_PER_BLOCK))
    want = -(-CHUNK_WAVES * sms * per_sm // (tiles * hkv))
    n_splits = max(1, min(want, MAX_SPLITS,
                          n_keys // (SPLIT_UNIT * MIN_SPLIT_UNITS)))
    split_keys = SPLIT_UNIT * -(-n_keys // (SPLIT_UNIT * n_splits))
    if n_splits > 1:
        n_splits = -(-n_keys // split_keys)
    merged = n_splits > 1
    return BatchedPlan(CHUNK_VECS, rows, tiles, split_keys, n_splits,
                       tiles * n_splits * hkv, tiles * hkv if merged else 0,
                       (tiles, n_splits, hkv, CHUNK_VECS, d) if merged
                       else None,
                       (tiles, n_splits, hkv, CHUNK_VECS) if merged
                       else None, smem)


def _ragged_plan(t, s, n_keys, h, hkv, d) -> QuantPlan:
    """``quant_plan``, refused when its grids are past CUDA's."""
    plan = quant_plan(t, s, n_keys, h, hkv, d)
    if max(plan.decode_blocks, plan.chunk_blocks) > GRID_X:
        raise ValueError(f"the ragged grids ({plan.decode_blocks}, "
                         f"{plan.chunk_blocks} blocks) are past CUDA's "
                         f"{GRID_X}")
    return plan


def _scratch(q, part_out, part_lse):
    """The split scratch of a plan (f32, allocated per call), or two
    empty tensors when it has none."""
    if part_out is None:
        part_out = part_lse = (0,)
    return (torch.empty(part_out, dtype=torch.float32, device=q.device),
            torch.empty(part_lse, dtype=torch.float32, device=q.device))


def _launcher(name: str, suffix: str):
    symbol = f"{name}_{suffix}"
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIG[symbol]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, block_tables, meta, *,
           batched: bool = False, scales: Optional[dict] = None) -> None:
    """Raise on what the kernel does not take: the ragged kernel's q is
    (T, H, D), the batched one's (B, Tq, H, D) with B = len(block_tables);
    q float32 or bfloat16 (``TypeError`` for any other dtype). Without
    ``scales`` both pools have q's dtype; bf16 rows move 16 bytes at a
    time, so bf16 pools need D % 8 == 0. ``scales`` (quantized pools:
    k_scales, v_scales, scale_tables) makes the pools int8 or fp8-e4m3,
    4-byte aligned."""
    dev = q.device
    named = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("block_tables", block_tables), *meta.items(),
             *(scales or {}).items()]
    for name, x in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _Q_SUFFIX:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype} "
                        "(fp16: ROADMAP B6)")
    if q.data_ptr() % 16:       # the kernel moves q 16 or 8 bytes at a time
        raise ValueError("q must be 16-byte aligned")
    pool_types = (q.dtype,) if scales is None else tuple(_QUANT_SUFFIX)
    # a quantized row of D % 4 == 0 bytes moves as 4-byte groups
    align = 16 if scales is None else 4
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if x.dtype not in pool_types or x.dtype != k_pages.dtype:
            raise TypeError(f"{name} must be one of {pool_types}, both "
                            f"pools alike; got {x.dtype}")
        if x.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    for name, x in [("block_tables", block_tables), *meta.items()]:
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    q_shape = "(B, Tq, H, D)" if batched else "(T, H, D)"
    if (q.dim() != (4 if batched else 3) or k_pages.dim() != 4
            or k_pages.shape != v_pages.shape):
        raise ValueError(f"q must be {q_shape} and both pools "
                         "(P, page, Hkv, D)")
    h, d = q.shape[-2:]
    _, page, hkv, dk = k_pages.shape
    s = block_tables.shape[0]
    if block_tables.dim() != 2 or any(x.shape != (s,) for x in meta.values()):
        raise ValueError("block_tables must be (S, n_pages) and the "
                         "per-sequence arrays (S,)")
    if batched and (q.shape[0] != s or s > 65535):
        raise ValueError(f"q holds {q.shape[0]} sequences, block_table "
                         f"{s}: they must agree, at most 65535")
    if dk != d or d % 4 or d > 128:
        raise ValueError(f"head_dim {d} (pools {dk}): the kernel takes "
                         "D % 4 == 0 and D <= 128")
    if k_pages.dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"head_dim {d}: bf16 pools move rows 16 bytes at a "
                         "time, so D % 8 == 0")
    if h % hkv or 16 % (h // hkv):
        raise ValueError(f"H={h}, Hkv={hkv}: the kernel takes a GQA group "
                         "that divides 16")
    if page < 1:
        raise ValueError("page size must be positive")
    if scales is not None:
        _check_scales(k_pages, block_tables, **scales)


def _check_scales(k_pages, block_tables, k_scales, v_scales,
                  scale_tables) -> None:
    """Scale pools f32 (Ps, page, Hkv) and scale tables int32 shaped like
    the block tables."""
    _, page, hkv, _ = k_pages.shape
    for name, x in (("k_scales", k_scales), ("v_scales", v_scales)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 3 or tuple(x.shape[1:]) != (page, hkv) \
                or x.shape != k_scales.shape:
            raise ValueError(f"{name} must be (Ps, {page}, {hkv}), both "
                             f"alike; got {tuple(x.shape)}")
    if scale_tables.dtype != torch.int32:
        raise TypeError(f"scale_tables must be int32, got "
                        f"{scale_tables.dtype}")
    if scale_tables.shape != block_tables.shape:
        raise ValueError(f"scale_tables {tuple(scale_tables.shape)} must "
                         f"have block_tables' shape "
                         f"{tuple(block_tables.shape)}")


def paged_attention_ragged(q, k_pages, v_pages, block_tables, context_lens,
                           q_starts, q_lens, pos0,
                           *, window: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Token-packed ragged paged attention: one launch for the whole hybrid
    step (DESIGN.md §11). q: (T, H, D) packed stream; pools (P, page, Hkv,
    D); block_tables: (S, n_pages); context_lens/q_starts/q_lens/pos0:
    (S,) int32; q and the pools fp32 or bf16, alike. Returns (T, H, D) in
    q's dtype; rows no sequence owns are zero.

    Sequences must own disjoint rows, and every block-table entry a
    sequence's context reaches must be a valid page id (the kernel reads
    them unchecked: checking would cost a device→host sync per launch).
    """
    d = q.shape[-1]
    scale = float(scale if scale is not None else d ** -0.5)
    if q.device.type == "cpu":
        return ref.paged_attention_ragged_ref(
            q, k_pages, v_pages, block_tables, context_lens, q_starts,
            q_lens, pos0, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention_ragged for {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    meta = {"context_lens": context_lens, "q_starts": q_starts,
            "q_lens": q_lens, "pos0": pos0}
    _check(q, k_pages, v_pages, block_tables, meta)
    t, h, _ = q.shape
    _, page, hkv, _ = k_pages.shape
    s, n_pages = block_tables.shape
    # zeroed: rows owned by no sequence (stream padding) must read 0
    out = torch.zeros_like(q)
    if t == 0 or s == 0:
        return out
    plan = _ragged_plan(t, s, n_pages * page, h, hkv, d)
    part_o, part_lse = _scratch(q, plan.part_out, plan.part_lse)
    dec_smem, chunk_smem = body_smem(d, q.element_size(), 16,
                                     plan.decode_vecs)
    fn = _launcher("paged_attention_ragged", _Q_SUFFIX[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), context_lens.data_ptr(),
                q_starts.data_ptr(), q_lens.data_ptr(), pos0.data_ptr(),
                out.data_ptr(), part_o.data_ptr(), part_lse.data_ptr(), t, h,
                hkv, d, page, s, n_pages, 0 if window is None else int(window),
                scale, plan.n_splits, plan.split_keys, plan.decode_vecs,
                plan.chunk_tiles, dec_smem, chunk_smem, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_ragged launch failed: "
                           f"cudaError {rc}")
    paged_attention_ragged.launches += 1
    return out


paged_attention_ragged.launches = 0


def paged_attention(q, k_pages, v_pages, block_table, context_lens, q_starts,
                    *, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Batched paged attention (decode Tq=1, verify Tq=γ+1, prefill chunk).

    q: (B, Tq, H, D); pools (P, page, Hkv, D); block_table: (B, n_pages);
    context_lens, q_starts: (B,) int32, ``q_starts[b]`` the global position
    of q[b, 0]; q and the pools fp32 or bf16, alike. Returns (B, Tq, H,
    D) in q's dtype; a row with no visible key is 0.

    Every block-table entry a sequence's context reaches must be a valid
    page id (the kernel reads them unchecked: checking would cost a
    device→host sync per launch); keys past the table's width do not exist.
    """
    d = q.shape[-1]
    scale = float(scale if scale is not None else d ** -0.5)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                       context_lens, q_starts, window=window,
                                       scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention for {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    _check(q, k_pages, v_pages, block_table,
           {"context_lens": context_lens, "q_starts": q_starts},
           batched=True)
    b, tq, h, _ = q.shape
    _, page, hkv, _ = k_pages.shape
    n_pages = block_table.shape[1]
    # not zeroed: the kernel writes every row (0 where no key is visible)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plan = batched_plan(b, tq, n_pages * page, h, hkv, d,
                        _sms(q.device.index), q.element_size())
    if plan.blocks > GRID_X:
        raise ValueError(f"B3's grid ({plan.blocks} blocks) is past CUDA's "
                         f"{GRID_X}")
    part_o, part_lse = _scratch(q, plan.part_out, plan.part_lse)
    fn = _launcher("paged_attention", _Q_SUFFIX[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_table.data_ptr(), context_lens.data_ptr(),
                q_starts.data_ptr(), out.data_ptr(), part_o.data_ptr(),
                part_lse.data_ptr(), b, tq, h, hkv, d, page, n_pages,
                0 if window is None else int(window), scale, plan.vecs,
                plan.n_splits, plan.split_keys, plan.smem, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_ragged_quant(q, k_pages, v_pages, k_scales, v_scales,
                                 block_tables, scale_tables, context_lens,
                                 q_starts, q_lens, pos0,
                                 *, window: Optional[int] = None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Quantized-KV ragged paged attention (DESIGN.md §14): the contract of
    ``paged_attention_ragged`` with int8 or fp8-e4m3 value pools (P, page,
    Hkv, D), f32 scale pools k_scales/v_scales (Ps, page, Hkv) and
    scale_tables (S, n_pages) of scale-page ids parallel to block_tables
    (``BlockAllocator.scale_table``); q f32 or bf16. Returns (T, H, D) in
    q's dtype; rows no sequence owns are zero. Like the value pages, every scale-table entry a
    context reaches must be a valid scale-page id (read unchecked).
    """
    d = q.shape[-1]
    scale = float(scale if scale is not None else d ** -0.5)
    if q.device.type == "cpu":
        return ref.paged_attention_ragged_quant_ref(
            q, k_pages, v_pages, k_scales, v_scales, block_tables,
            scale_tables, context_lens, q_starts, q_lens, pos0,
            window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention_ragged_quant for {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    _check(q, k_pages, v_pages, block_tables,
           {"context_lens": context_lens, "q_starts": q_starts,
            "q_lens": q_lens, "pos0": pos0},
           scales={"k_scales": k_scales, "v_scales": v_scales,
                   "scale_tables": scale_tables})
    t, h, _ = q.shape
    _, page, hkv, _ = k_pages.shape
    s, n_pages = block_tables.shape
    # zeroed: rows owned by no sequence (stream padding) must read 0
    out = torch.zeros_like(q)
    if t == 0 or s == 0:
        return out
    plan = _ragged_plan(t, s, n_pages * page, h, hkv, d)
    part_o, part_lse = _scratch(q, plan.part_out, plan.part_lse)
    # the body copies 16 bytes at a time where rows and pools allow
    ch = 16 if d % 16 == 0 and not (k_pages.data_ptr() % 16
                                    or v_pages.data_ptr() % 16) else 4
    dec_smem, chunk_smem = body_smem(d, 1, ch, plan.decode_vecs)
    fn = _launcher("paged_attention_ragged_quant",
                   _QUANT_SUFFIX[k_pages.dtype]
                   + ("_bf16" if q.dtype == torch.bfloat16 else ""))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr(), v_scales.data_ptr(),
                block_tables.data_ptr(), scale_tables.data_ptr(),
                context_lens.data_ptr(), q_starts.data_ptr(),
                q_lens.data_ptr(), pos0.data_ptr(), out.data_ptr(),
                part_o.data_ptr(), part_lse.data_ptr(), t, h, hkv, d, page,
                s, n_pages, 0 if window is None else int(window), scale,
                plan.n_splits, plan.split_keys, plan.decode_vecs,
                plan.chunk_tiles, dec_smem, chunk_smem, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_ragged_quant launch failed: "
                           f"cudaError {rc}")
    paged_attention_ragged_quant.launches += 1
    return out


paged_attention_ragged_quant.launches = 0
