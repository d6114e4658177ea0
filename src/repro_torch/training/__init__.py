"""Training of the port: the optimizers (AdamW, Adafactor), the train step
(loss → grad → clip → update, with gradient accumulation) and flat-path
``.npz`` checkpoints that the JAX package reads and writes too. Port of
``src/repro/training``. ``optimizer.opt_axes`` gives the optimizer state's
logical sharding axes; training runs on one device, and ``grad_shardings``
waits for sharded training (ROADMAP A13b)."""
from .checkpoint import load_checkpoint, load_meta, save_checkpoint
from .optimizer import (OptConfig, apply_updates, clip_by_global_norm,
                        global_norm, init_opt_state)
from .train_step import make_train_step

__all__ = ["OptConfig", "init_opt_state", "apply_updates", "global_norm",
           "clip_by_global_norm", "make_train_step", "save_checkpoint",
           "load_checkpoint", "load_meta"]
