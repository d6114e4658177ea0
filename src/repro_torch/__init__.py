"""FairBatching on PyTorch and CUDA: the port of the ``repro`` JAX package.

Subpackages mirror ``src/repro/`` so a module and its port sit at parallel
paths. The port imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``: the pure-Python host code it needs (configs, the scheduler core,
the engine's request/metrics/KV-allocator/engine modules) is kept as its own
copy. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (``_device.resolve_device``).
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
