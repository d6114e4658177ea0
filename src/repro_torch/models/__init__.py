"""Model code of the port: the dense-GQA primitives of the serving step,
the MoE FFN and the parameter bridge from the JAX package's layout."""
from .layers import attn_qkv, mlp_apply
from .moe import moe_capacity, moe_dense_exact
from .module import rmsnorm, silu
from .rope import apply_rope
from .weights import init_params, params_from_numpy, params_to_numpy

__all__ = ["attn_qkv", "mlp_apply", "moe_capacity", "moe_dense_exact",
           "rmsnorm", "silu", "apply_rope",
           "init_params", "params_from_numpy", "params_to_numpy"]
