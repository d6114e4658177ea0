"""Model code of the port: the dense-GQA primitives of the serving step,
the MoE FFN, the Mamba2 block and ``lm.DecoderLM`` of the SSM family, and
the parameter bridge from the JAX package's layout."""
from .layers import attn_qkv, mlp_apply
from .lm import DecoderLM, build_model
from .moe import moe_capacity, moe_dense_exact
from .module import rmsnorm, silu, softplus
from .rope import apply_rope
from .weights import init_params, params_from_numpy, params_to_numpy

__all__ = ["attn_qkv", "mlp_apply", "DecoderLM", "build_model",
           "moe_capacity", "moe_dense_exact", "rmsnorm", "silu", "softplus",
           "apply_rope", "init_params", "params_from_numpy",
           "params_to_numpy"]
