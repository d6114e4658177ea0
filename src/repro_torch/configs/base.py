"""Architecture + shape registry.

Every assigned architecture is a frozen ``ArchConfig``; every assigned input
shape is a ``ShapeConfig``. ``input_specs(arch, shape)`` (in specs.py) turns a
cell into ShapeDtypeStructs for the dry-run. ``reduced()`` produces the
smoke-test config of the same family.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int           # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_chunk: int = 8192   # token-chunked dispatch (lax.map) for big T


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int               # N
    head_dim: int = 64         # P
    expand: int = 2            # d_inner = expand * d_model
    d_conv: int = 4
    chunk: int = 128           # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free
    n_kv_heads: int
    d_ff: int                    # dense-path FFN hidden (0 if none)
    vocab: int
    # attention geometry
    head_dim: int = 0            # derived in __post_init__ when 0
    rope_theta: float = 10_000.0
    window: Optional[int] = None         # SWA window (all attn layers)
    local_global_period: Optional[int] = None  # gemma3: every Nth layer global
    local_window: Optional[int] = None   # window of local layers
    # mixtures
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: Optional[int] = None    # zamba2: shared attn every N ssm blocks
    # enc-dec
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub: model consumes precomputed embeddings at prefill
    embeds_input: bool = False
    norm_eps: float = 1e-6
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived sizes -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_window(self, layer_idx: int) -> Optional[int]:
        """Effective attention window of a layer (None = full/global)."""
        if self.local_global_period is not None:
            if (layer_idx + 1) % self.local_global_period == 0:
                return None
            return self.local_window
        return self.window

    def has_attention(self) -> bool:
        return self.n_heads > 0 or self.attn_period is not None

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline + docs)."""
        d, v = self.d_model, self.vocab
        n = 2 * v * d  # embed + untied head
        att = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        per_layer = 0
        if self.family in ("ssm",):
            per_layer = _mamba2_params(self)
        elif self.family == "hybrid":
            per_layer = _mamba2_params(self)
        else:
            per_layer = att + 2 * d  # attn + 2 rmsnorm
            if self.moe is not None:
                per_layer += d * self.moe.n_experts  # router
                per_layer += self.moe.n_experts * 3 * d * self.moe.d_ff_expert
            else:
                per_layer += 3 * d * self.d_ff
        n += self.n_layers * per_layer
        if self.family == "hybrid" and self.attn_period:
            shared = att + 3 * d * self.d_ff + 2 * d
            n += shared  # shared block params counted once
        if self.is_encoder_decoder:
            enc_layer = att + 3 * d * self.d_ff + 2 * d
            n += self.n_encoder_layers * enc_layer
            n += self.n_layers * (att + d)  # cross-attn + norm in decoder
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        expert_all = self.n_layers * self.moe.n_experts * 3 * self.d_model * self.moe.d_ff_expert
        expert_active = self.n_layers * self.moe.top_k * 3 * self.d_model * self.moe.d_ff_expert
        return total - expert_all + expert_active


def _mamba2_params(cfg: ArchConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.n_heads(d)
    # in_proj (z,x,B,C,dt), conv, dt_bias/A/D, norm, out_proj
    in_proj = d * (2 * di + 2 * s.d_state + h)
    return in_proj + (di + 2 * s.d_state) * s.d_conv + 3 * h + di + di * d + d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# Archs whose every attention layer is unbounded full attention: long_500k is
# skipped for these (no sub-quadratic path in the architecture; DESIGN.md §5).
def long_context_capable(cfg: ArchConfig) -> bool:
    if cfg.family in ("ssm", "hybrid"):
        return True
    if cfg.window is not None:
        return True
    if cfg.local_global_period is not None:
        return True  # only 1/period layers are global; CP-sharded KV
    return False


def cells(cfg: ArchConfig) -> list[tuple[str, bool]]:
    """(shape_name, runnable) for all four assigned shapes."""
    out = []
    for s in SHAPES.values():
        runnable = True
        if s.name == "long_500k" and not long_context_capable(cfg):
            runnable = False
        out.append((s.name, runnable))
    return out


_REGISTRY: dict[str, "ArchConfig"] = {}
_REDUCED: dict[str, "ArchConfig"] = {}


def register(cfg: ArchConfig, reduced: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced
    return cfg


def get(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        from . import _load_all  # lazy import of all config modules
        _load_all()
    return _REGISTRY[name]


def get_reduced(name: str) -> ArchConfig:
    get(name)
    return _REDUCED[name]


def all_archs() -> list[str]:
    from . import _load_all
    _load_all()
    return sorted(_REGISTRY)
