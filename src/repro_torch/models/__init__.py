"""Model code of the port: the dense-GQA primitives of the serving step and
the parameter bridge from the JAX package's layout."""
from .layers import attn_qkv, mlp_apply
from .module import rmsnorm, silu
from .rope import apply_rope
from .weights import init_params, params_from_numpy, params_to_numpy

__all__ = ["attn_qkv", "mlp_apply", "rmsnorm", "silu", "apply_rope",
           "init_params", "params_from_numpy", "params_to_numpy"]
