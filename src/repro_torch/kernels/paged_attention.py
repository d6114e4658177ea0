"""Paged attention: the wrappers of the hand-written CUDA kernels.

* ``paged_attention_ragged`` — port of
  ``src/repro/kernels/paged_attention.py::paged_attention_ragged`` (the
  Pallas TPU kernel the fused serving step launches once per layer);
  kernel ``csrc/paged_attention_ragged.cu``.
* ``paged_attention`` — port of ``paged_attention.py::paged_attention``,
  the batched (B, Tq) kernel of sequential mode, committed multi-step
  decode, the speculative draft/verify passes and the fused step's
  non-ragged backend; kernel ``csrc/paged_attention.cu``.
* ``paged_attention_ragged_quant`` — port of
  ``paged_attention.py::paged_attention_ragged_quant``: the ragged kernel
  over int8 or fp8-e4m3 K/V with f32 row scales (DESIGN.md §14), the fused
  step's attention under quantized KV, and (flattened by
  ``ops.paged_attention_quant_op``) the batched paths'; kernel
  ``csrc/paged_attention_ragged_quant.cu``.

All three are CUDA C++ for sm_90a, built by ``_build``, and share their
tile body (``csrc/attention_tile.cuh``, templated over the pool's element
type); the sources note what bounds them on the H100 and how their design
differs from the TPU grid.

Tensors on the CPU take the plain version (``ref.py``); tensors on a CUDA
device launch the kernel or raise — there is no fallback. Each wrapper's
``launches`` counts its kernel's launches, and nothing else, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref

_RAGGED = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                         ctypes.c_void_p]
_QUANT = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                        ctypes.c_void_p]
# argtypes of every extern "C" launcher, by symbol
_SIG = {"paged_attention_ragged_f32": _RAGGED,
        "paged_attention_f32": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                                + [ctypes.c_float, ctypes.c_void_p]),
        "paged_attention_ragged_quant_i8": _QUANT,
        "paged_attention_ragged_quant_f8": _QUANT}
# B2's launcher suffix by value dtype
_QUANT_SUFFIX = {torch.int8: "i8", torch.float8_e4m3fn: "f8"}


def _launcher(name: str, suffix: str = "f32"):
    symbol = f"{name}_{suffix}"
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIG[symbol]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, block_tables, meta, *,
           batched: bool = False, scales: Optional[dict] = None) -> None:
    """Raise on what the kernel does not take: the ragged kernel's q is
    (T, H, D), the batched one's (B, Tq, H, D) with B = len(block_tables).
    ``scales`` (quantized pools: k_scales, v_scales, scale_tables) makes
    the pools int8 or fp8-e4m3, 4-byte aligned, instead of float32."""
    dev = q.device
    named = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("block_tables", block_tables), *meta.items(),
             *(scales or {}).items()]
    for name, x in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype} "
                        "(bf16 activations are later work)")
    if q.data_ptr() % 16:       # the kernel moves rows as float4
        raise ValueError("q must be 16-byte aligned")
    pool_types = (torch.float32,) if scales is None else tuple(_QUANT_SUFFIX)
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
    (S,) int32. Returns (T, H, D); rows no sequence owns are zero.

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
    fn = _launcher("paged_attention_ragged")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), context_lens.data_ptr(),
                q_starts.data_ptr(), q_lens.data_ptr(), pos0.data_ptr(),
                out.data_ptr(), t, h, hkv, d, page, s, n_pages,
                0 if window is None else int(window), scale, stream)
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
    of q[b, 0]. Returns (B, Tq, H, D); a row with no visible key is 0.

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
    out = torch.empty_like(q)        # the kernel writes every row
    if out.numel() == 0:
        return out
    fn = _launcher("paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_table.data_ptr(), context_lens.data_ptr(),
                q_starts.data_ptr(), out.data_ptr(), b, tq, h, hkv, d, page,
                n_pages, 0 if window is None else int(window), scale, stream)
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
    (``BlockAllocator.scale_table``). Returns (T, H, D) f32; rows no
    sequence owns are zero. Like the value pages, every scale-table entry a
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
    fn = _launcher("paged_attention_ragged_quant",
                   _QUANT_SUFFIX[k_pages.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr(), v_scales.data_ptr(),
                block_tables.data_ptr(), scale_tables.data_ptr(),
                context_lens.data_ptr(), q_starts.data_ptr(),
                q_lens.data_ptr(), pos0.data_ptr(), out.data_ptr(), t, h,
                hkv, d, page, s, n_pages,
                0 if window is None else int(window), scale, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_ragged_quant launch failed: "
                           f"cudaError {rc}")
    paged_attention_ragged_quant.launches += 1
    return out


paged_attention_ragged_quant.launches = 0
