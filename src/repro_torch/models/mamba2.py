"""Mamba2 (SSD — state-space duality) block in PyTorch.

Port of ``src/repro/models/mamba2.py``. The chunked SSD scan of a prefill
or a training pass (``ssd_chunked``) goes through
``ops.mamba_chunk_scan_op``: kernel B5 on the card, its plain version
(``kernels/ref.py::mamba_chunk_scan_ref``: the JAX module's einsums as
pairwise contractions, its ``_segsum`` as ``ref.segsum``) on the CPU;
its gradient is B5's backward kernel, or the plain backward on the CPU. The decode step (``ssd_step``) stays tensor
ops, as the JAX package computes it outside any kernel.

Layer layout (n_groups = 1):
  in_proj: d_model → [z (di), x (di), B (N), C (N), dt (H)]
  depthwise causal conv (width d_conv) over [x, B, C]
  y = SSD(x·dt, A·dt, B, C) + D·x ; gated RMSNorm with silu(z); out_proj

Cache per layer: {"ssm": (B, H, P, N) f32, "conv": (B, d_conv-1, conv_dim)}.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ops import mamba_chunk_scan_op
from .module import rmsnorm, silu, softplus


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    h = s.n_heads(cfg.d_model)
    return s, di, h, s.head_dim, s.d_state


def init_mamba_params(cfg: ArchConfig, generator: torch.Generator, device,
                      lead: tuple = (), dtype=torch.float32) -> dict:
    """The port's own Mamba2 weights, the distributions of the JAX
    ``init_mamba_params``: normal projections × 1/sqrt(fan_in), ``conv_w``
    × 0.1, zero ``conv_b`` and ``norm_w``, ``A_log = log(1..H)``, ``D = 1``
    and ``dt_bias = softplus⁻¹(0.01)``; every tensor with the leading dims
    ``lead`` (``(n_layers,)`` for the stacked tree), drawn in fp32 and
    cast to ``dtype``. ``generator`` lives on ``device``."""
    s, di, h, p, n = _dims(cfg)
    d = cfg.d_model
    conv_dim = di + 2 * n
    proj_out = 2 * di + 2 * n + h
    dev = torch.device(device)
    lead = tuple(lead)

    def normal(shape, std):
        return torch.randn(lead + shape, generator=generator, device=dev,
                           dtype=torch.float32).mul_(std)

    def per_head(row):
        return row.to(dev).expand(lead + (h,)).contiguous()

    tree = {
        "in_proj": normal((d, proj_out), 1.0 / math.sqrt(d)),
        "conv_w": normal((s.d_conv, conv_dim), 0.1),
        "conv_b": torch.zeros(lead + (conv_dim,), device=dev),
        "A_log": per_head(torch.log(torch.linspace(1.0, float(h), h))),
        "D": per_head(torch.ones(h)),
        "dt_bias": per_head(torch.log(torch.expm1(torch.full((h,), 0.01)))),
        "norm_w": torch.zeros(lead + (di,), device=dev),
        "out_proj": normal((di, d), 1.0 / math.sqrt(di)),
    }
    return {k: v.to(dtype) for k, v in tree.items()}


MAMBA_AXES = {
    "in_proj": ("embed", "inner"),
    "conv_w": (None, "inner"),
    "conv_b": ("inner",),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    "norm_w": ("inner",),
    "out_proj": ("inner", "embed"),
}


def ssd_chunked(xdt, a_dt, b, c, chunk: int, init_state=None):
    """Chunked SSD scan.

    xdt: (B, S, H, P) — inputs pre-multiplied by dt
    a_dt: (B, S, H)   — per-step log decay (A*dt, negative)
    b, c: (B, S, N)   — input/output projections (n_groups=1)
    Returns (y (B,S,H,P), final_state (B,H,P,N)), both fp32: JAX casts the
    four inputs to fp32; here xdt and a_dt are cast and b and c go to B5
    in their own dtype (the kernel widens bf16 exactly, the same values).
    """
    bsz, s, h, p = xdt.shape
    n = b.shape[-1]
    nc = s // chunk
    assert nc * chunk == s, "sequence must be chunk-aligned (pad upstream)"
    y, final = mamba_chunk_scan_op(
        xdt.float().reshape(bsz, nc, chunk, h, p),
        a_dt.float().reshape(bsz, nc, chunk, h),
        b.reshape(bsz, nc, chunk, n), c.reshape(bsz, nc, chunk, n),
        None if init_state is None else init_state.float(), torch.float32)
    return y.reshape(bsz, s, h, p), final


def ssd_step(xdt, a_dt, b, c, state):
    """One decode step. xdt: (B,H,P); a_dt: (B,H); b,c: (B,N);
    state (B,H,P,N)."""
    xdt = xdt.float()
    da = torch.exp(a_dt.float())                                  # (B,H)
    state = state * da[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xdt, b.float())
    y = torch.einsum("bhpn,bn->bhp", state, c.float())
    return y, state


def _project(params, x, cfg):
    s, di, h, p, n = _dims(cfg)
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    return torch.split(zxbcdt, [di, di, n, n, h], dim=-1)


def _post(params, y, z, x_heads, cfg):
    s, di, h, p, n = _dims(cfg)
    y = y + params["D"].float()[:, None] * x_heads.float()
    y = y.reshape(*y.shape[:-2], di)
    y = y * silu(z.float())
    y = rmsnorm(y, params["norm_w"], cfg.norm_eps)
    return y @ params["out_proj"].to(y.dtype)


def mamba_seq(params, x, cfg: ArchConfig, cache=None):
    """Full-sequence pass. x: (B, S, d_model) → (B, S, d_model), cache out."""
    s_cfg, di, h, p, n = _dims(cfg)
    bsz, slen, _ = x.shape
    z, xin, b, c, dt = _project(params, x, cfg)
    conv_in = torch.cat([xin, b, c], dim=-1)                      # (B,S,conv)
    tail_in = (x.new_zeros((bsz, s_cfg.d_conv - 1, conv_in.shape[-1]))
               if cache is None else cache["conv"].to(x.dtype))
    padded = torch.cat([tail_in, conv_in], dim=1)
    # Depthwise causal conv, width d_conv.
    conv = sum(padded[:, i:i + slen] * params["conv_w"][i].to(x.dtype)
               for i in range(s_cfg.d_conv))
    conv = silu(conv + params["conv_b"].to(x.dtype))
    xc, bc, cc = torch.split(conv, [di, n, n], dim=-1)
    x_heads = xc.reshape(bsz, slen, h, p)
    dt = softplus(dt.float() + params["dt_bias"].float())         # (B,S,H)
    a = -torch.exp(params["A_log"].float())                       # (H,)
    a_dt = a * dt
    xdt = x_heads.float() * dt[..., None]
    chunk = min(s_cfg.chunk, slen)
    pad = (-slen) % chunk
    if pad:   # padded steps: a_dt = 0 and b = 0 leave the state as it is
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a_dt = F.pad(a_dt, (0, 0, 0, pad))
        bc = F.pad(bc, (0, 0, 0, pad))
        cc_p = F.pad(cc, (0, 0, 0, pad))
    else:
        cc_p = cc
    init_state = None if cache is None else cache["ssm"]
    y, final = ssd_chunked(xdt, a_dt, bc, cc_p, chunk, init_state)
    y = y[:, :slen]
    out = _post(params, y, z, x_heads, cfg)
    new_cache = {"ssm": final,
                 "conv": padded[:, slen:slen + s_cfg.d_conv - 1].float()}
    return out.to(x.dtype), new_cache


def mamba_step(params, x, cfg: ArchConfig, cache):
    """Single-token decode. x: (B, 1, d_model)."""
    s_cfg, di, h, p, n = _dims(cfg)
    bsz = x.shape[0]
    z, xin, b, c, dt = _project(params, x[:, 0], cfg)
    conv_in = torch.cat([xin, b, c], dim=-1)                      # (B,conv)
    window = torch.cat([cache["conv"].to(x.dtype), conv_in[:, None]],
                       dim=1)                           # (B, d_conv, conv)
    conv = torch.einsum("bkc,kc->bc", window, params["conv_w"].to(x.dtype))
    conv = silu(conv + params["conv_b"].to(x.dtype))
    xc, bc, cc = torch.split(conv, [di, n, n], dim=-1)
    x_heads = xc.reshape(bsz, h, p)
    dt = softplus(dt.float() + params["dt_bias"].float())         # (B,H)
    a = -torch.exp(params["A_log"].float())
    y, new_state = ssd_step(x_heads.float() * dt[..., None], a * dt, bc, cc,
                            cache["ssm"])
    out = _post(params, y, z, x_heads, cfg)
    new_cache = {"ssm": new_state, "conv": window[:, 1:].float()}
    return out[:, None].to(x.dtype), new_cache


def mamba_cache_shape(cfg: ArchConfig, batch: int):
    s, di, h, p, n = _dims(cfg)
    return {"ssm": (batch, h, p, n), "conv": (batch, s.d_conv - 1, di + 2 * n)}


def init_mamba_cache(cfg: ArchConfig, batch: int, device=None):
    shp = mamba_cache_shape(cfg, batch)
    return {k: torch.zeros(v, dtype=torch.float32, device=device)
            for k, v in shp.items()}
