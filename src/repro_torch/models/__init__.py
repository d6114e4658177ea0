"""Model code of the port: attention over position arrays, the layer
primitives with ring-buffer KV caches, the MoE FFN, the Mamba2 block,
``lm.DecoderLM`` for every decoder-only family, ``encdec.EncDecLM`` for the
encoder-decoder, and the parameter bridge from the JAX package's
layout."""
from .layers import attn_qkv, mlp_apply
from .encdec import EncDecLM
from .lm import DecoderLM, ModelOpts, build_model
from .moe import moe_capacity, moe_dense_exact
from .module import rmsnorm, silu, softplus
from .rope import apply_rope
from .weights import init_params, params_from_numpy, params_to_numpy

__all__ = ["attn_qkv", "mlp_apply", "DecoderLM", "EncDecLM", "ModelOpts",
           "build_model",
           "moe_capacity", "moe_dense_exact", "rmsnorm", "silu", "softplus",
           "apply_rope", "init_params", "params_from_numpy",
           "params_to_numpy"]
