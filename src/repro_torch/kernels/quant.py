"""Quantized KV-cache number formats (DESIGN.md §14), in PyTorch.

A copy of ``src/repro/kernels/quant.py``. The paged KV cache stores values
in int8 (or fp8-e4m3 where the device supports the dtype) with one f32
dequantization scale per (token, kv-head) row: ``scale = absmax(row) /
qmax`` and ``value ≈ stored * scale``. Scales live in dedicated scale
pages managed by ``BlockAllocator`` (one scale page per data page — see
engine/kv_manager.py), so COW/fork/evict semantics are identical for
values and scales.

Error bound: for int8 the dequantization error of any element in a row with
absmax ``a`` is at most half a quantization step, ``a / (2·127)``. For
fp8-e4m3 (3 mantissa bits) the round-to-nearest cast error is relative,
``|x| · 2^-4`` per element, bounded here by the conservative per-row
absolute form ``a · 2^-4``. ``row_error_bound`` exposes exactly the bound
the numerics tests and DESIGN.md §14 derive the attention output tolerance
from.

``quantize_kv`` keeps the JAX package's op order (absmax, floor, divide,
then round half to even and clamp for int8, clamp then cast for fp8), so
on equal inputs it gives the same bytes. It is plain PyTorch on every
device: the JAX package computes it outside any kernel too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._device import DeviceLike

_EPS = 1e-12      # floor for all-zero rows: scale 0 would make dequant 0/0


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """One KV storage format: dtype, quantization range, error step."""
    name: str
    dtype: torch.dtype
    qmax: float           # largest representable magnitude after scaling
    half_step: float      # per-row error bound as a fraction of row absmax
    bytes_per_elt: int


_INT8 = QuantSpec("int8", torch.int8, 127.0, 0.5 / 127.0, 1)
# e4m3fn max finite = 448; 3 mantissa bits → half-ulp relative 2^-4
_FP8 = QuantSpec("fp8_e4m3", torch.float8_e4m3fn, 448.0, 2.0 ** -4, 1)


def _fp8_spec(device: DeviceLike = "cpu") -> Optional[QuantSpec]:
    """The fp8 spec if a cast round trip survives on ``device``."""
    try:
        x = torch.tensor([0.5, -1.25], device=device).to(_FP8.dtype)
        if not bool(torch.isfinite(x.float()).all()):
            return None
    except (RuntimeError, TypeError):
        return None
    return _FP8


def supports_fp8(device: DeviceLike = "cpu") -> bool:
    return _fp8_spec(device) is not None


def kv_quant_spec(kv_dtype: Optional[str],
                  device: DeviceLike = "cpu") -> Optional[QuantSpec]:
    """Resolve a kv_dtype string; None means unquantized fp32 storage."""
    if kv_dtype in ("fp32", "float32", None):
        return None
    if kv_dtype == "int8":
        return _INT8
    if kv_dtype == "fp8_e4m3":
        spec = _fp8_spec(device)
        if spec is None:
            raise ValueError("fp8_e4m3 KV requested but the device has no "
                             "float8_e4m3fn support — use int8 or fp32")
        return spec
    raise ValueError(f"unknown kv_dtype {kv_dtype!r}")


def quantize_kv(x: torch.Tensor, spec: QuantSpec):
    """Per-(…, row) absmax quantization over the trailing (head_dim) axis.

    x: (..., D) f32 → (values (..., D) spec.dtype, scales (...,) f32) with
    ``x ≈ values * scales[..., None]``.
    """
    amax = x.abs().amax(dim=-1)
    scales = torch.clamp(amax, min=_EPS) / spec.qmax
    scaled = x / scales[..., None]
    if spec.dtype == torch.int8:
        scaled = torch.round(scaled)              # half to even, as jnp
    values = torch.clamp(scaled, -spec.qmax, spec.qmax)
    return values.to(spec.dtype), scales.float()


def dequantize_kv(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """values: (..., D) quantized; scales: (...,) f32 → (..., D) f32."""
    return values.float() * scales[..., None].float()


def raw_pool(pool: torch.Tensor) -> torch.Tensor:
    """A byte view of a 1-byte (int8, fp8) pool, the pool itself otherwise:
    indexing, scatters and page copies through it are bit-exact for any
    dtype, where a device's indexing kernels need not take fp8."""
    return pool.view(torch.uint8) if pool.element_size() == 1 else pool


def row_error_bound(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Per-row bound on |dequantize(quantize(x)) - x| (elementwise), (...,).

    The documented DESIGN.md §14 bound the numerics sweep asserts: half a
    quantization step of the row's absmax.
    """
    return x.abs().amax(dim=-1) * spec.half_step + _EPS
