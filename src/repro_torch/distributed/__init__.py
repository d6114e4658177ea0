"""Sharding of the port: the JAX package's logical-axis rule tables
(``sharding``) and the tensor- and expert-parallel layer arithmetic with
its explicit collectives (``tp``). Port of ``src/repro/distributed``."""
from .sharding import (ShardingRules, axes_to_spec, constrain, param_specs,
                       serving_rules, shard_params, training_rules,
                       use_rules)

__all__ = ["ShardingRules", "constrain", "use_rules", "axes_to_spec",
           "param_specs", "serving_rules", "training_rules", "shard_params"]
