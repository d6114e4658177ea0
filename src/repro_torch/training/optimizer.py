"""Optimizers, hand-rolled: AdamW and Adafactor. Port of
``src/repro/training/optimizer.py``.

* AdamW — the default; m and v in fp32, one of each per parameter.
* Adafactor — a factored second moment (a row and a column statistic per
  matrix of at least 8 x 8), no first moment: kimi-k2's optimizer state
  shrinks from 8 TB (AdamW, fp32) to about params/row + col.

Parameters may be fp32 or bf16 (the launch cells' serving dtype); the
moments are fp32, the math is fp32 throughout and each new parameter is
rounded once to its own dtype (``copy_``, round to nearest even, as JAX's
``.astype(p.dtype)``), as in JAX; the step is a 0-d int32 tensor and
the bias corrections ``1 - b ** step`` are computed from it in fp32 on the
device. Trees are nested dicts and lists of tensors; ``leaves`` walks them
in the JAX package's order (dict keys sorted), so a global norm sums its
leaves in the same order.

Updates run leaf by leaf, under ``torch.no_grad()``, **in place**:
``apply_updates`` writes the new parameters and state into the tensors it
is given and returns them, and ``clip_by_global_norm`` scales the
gradients in place. At full width that keeps one copy of the parameters
and of each moment on the card (h2o-danube-1.8b: 29 GB for params, grads
and AdamW's two moments, where returning new trees would hold both copies
of params and moments at once: 51 GB). A caller that needs the old values
(two steps from one state) passes a copy, as for ``decode_step``'s cache.
``opt_axes`` gives the state's logical sharding axes, mirroring the
params' (``distributed.sharding`` maps them to a mesh); training itself
runs on one device (sharded training: ROADMAP A13b).
"""
from __future__ import annotations

import dataclasses

import torch

from ..distributed.sharding import map_axes


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def leaves(tree) -> list:
    """The tensors of a nested dict / list tree, dict keys sorted (the
    order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of
    ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def init_opt_state(params, cfg: OptConfig) -> dict:
    """Zero state for ``params``, on their device: ``step`` (0-d int32)
    and ``m``/``v`` (AdamW) or ``vr``/``vc`` (Adafactor) trees."""
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    if cfg.name == "adamw":
        return {"step": step,
                "m": tree_map(lambda p: _zeros(p.shape, p), params),
                "v": tree_map(lambda p: _zeros(p.shape, p), params)}
    if cfg.name == "adafactor":
        def vrow(p):
            return _zeros(p.shape[:-1] if _factored(p.shape) else p.shape, p)

        def vcol(p):
            if _factored(p.shape):
                return _zeros(p.shape[:-2] + p.shape[-1:], p)
            return _zeros((1,), p)  # unused
        return {"step": step, "vr": tree_map(vrow, params),
                "vc": tree_map(vcol, params)}
    raise ValueError(cfg.name)


def opt_axes(params_axes, params_shapes, cfg: OptConfig):
    """Sharding axes for the optimizer state, mirroring the params axes.
    ``params_shapes`` has the params' structure, its leaves anything with
    a ``shape`` (tensors)."""
    if cfg.name == "adamw":
        return {"step": (), "m": params_axes, "v": params_axes}

    def vrow_ax(ax, p):
        return tuple(ax[:-1]) if _factored(p.shape) else tuple(ax)

    def vcol_ax(ax, p):
        return tuple(ax[:-2]) + tuple(ax[-1:]) if _factored(p.shape) else (None,)
    return {"step": (),
            "vr": map_axes(vrow_ax, params_axes, params_shapes),
            "vc": map_axes(vcol_ax, params_axes, params_shapes)}


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, fp32, a 0-d tensor."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place by min(1, max_norm / norm); returns
    (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _step_leaf(p, u, cfg: OptConfig) -> None:
    """p ← p - lr · (u + weight_decay · p), in fp32, through ``u``'s
    storage."""
    pf = p.float()
    u.add_(pf * cfg.weight_decay).mul_(cfg.lr)
    p.copy_(torch.sub(pf, u, out=u))


def _adamw_leaf(p, g, m, v, bc1, bc2, cfg: OptConfig) -> None:
    b1, b2 = cfg.b1, cfg.b2
    g = g.float()
    m.mul_(b1).add_(g * (1 - b1))
    v.mul_(b2).add_(g.mul(1 - b2).mul_(g))
    u = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    _step_leaf(p, u, cfg)


def _adafactor_leaf(p, g, vr, vc, cfg: OptConfig) -> None:
    b2 = cfg.b2
    g = g.float()
    g2 = g * g + 1e-30
    if _factored(p.shape):
        vr.mul_(b2).add_(g2.mean(-1) * (1 - b2))
        vc.mul_(b2).add_(g2.mean(-2) * (1 - b2))
        del g2
        r = vr / vr.mean(-1, keepdim=True).clamp_min(1e-30)
        den = r.sqrt_()[..., None] * vc.sqrt()[..., None, :]
        u = g / den.add_(cfg.eps)
    else:
        vr.mul_(b2).add_(g2 * (1 - b2))
        u = g / (vr.sqrt() + cfg.eps)
    _step_leaf(p, u, cfg)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig):
    """One optimizer step, leaf by leaf, in place: ``params`` and
    ``state`` take the new values; returns (params, state). Adafactor is
    the JAX package's simplified form: constant lr, no update clipping,
    no momentum."""
    step = state["step"]
    step.add_(1)
    if cfg.name == "adamw":
        t = step.float()
        one = torch.ones((), device=step.device)
        bc1 = 1.0 - (one * cfg.b1) ** t
        bc2 = 1.0 - (one * cfg.b2) ** t
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["m"]), leaves(state["v"])):
            _adamw_leaf(p, g, m, v, bc1, bc2, cfg)
        return params, state
    for p, g, vr, vc in zip(leaves(params), leaves(grads),
                            leaves(state["vr"]), leaves(state["vc"])):
        _adafactor_leaf(p, g, vr, vc, cfg)
    return params, state
