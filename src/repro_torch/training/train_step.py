"""Train-step builder: loss → grad → clip → optimizer, with optional
gradient accumulation (microbatching). Port of
``src/repro/training/train_step.py``.

The gradient is ``torch.autograd.grad`` of the model's ``train_loss`` with
respect to detached copies of every parameter leaf (a parameter that the
loss does not reach, such as ``embed`` under an ``embeds`` input, gets
zeros, as ``jax.grad`` gives). The update then runs in place
(``optimizer.apply_updates``): the step consumes ``params`` and
``opt_state`` and returns them updated. ``grad_shardings`` waits for
sharded training with ``distributed.sharding.training_rules`` (ROADMAP
A13b).
"""
from __future__ import annotations

import torch

from .optimizer import (OptConfig, apply_updates, clip_by_global_norm,
                        leaves, tree_map)


def _rebuild(tree, flat):
    """A tree of ``tree``'s structure whose leaves come from the iterator
    ``flat``, in the order of ``optimizer.leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, flat) for v in tree]
    return next(flat)


def value_and_grad(loss_fn, params, batch):
    """(loss, grads): the 0-d loss (detached) and a tree of gradients in
    ``params``' structure."""
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(req, batch)
    flat = leaves(req)
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    gs = (torch.zeros_like(p) if g is None else g for p, g in zip(flat, gs))
    return loss.detach(), _rebuild(req, gs)


def make_train_step(model, opt_cfg: OptConfig, *, accum_steps: int = 1):
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    {"loss", "grad_norm"}), both metrics 0-d fp32 tensors.

    accum_steps > 1 splits dim 0 of every batch leaf into that many
    microbatches, one backward pass each, and sums their gradients in
    fp32 (one buffer tree, fp32 whatever the parameters' dtype, as JAX's
    f32 zeros); the loss is the microbatches' mean.
    """
    loss_fn = model.train_loss

    def step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            acc, losses = None, []
            for i in range(accum_steps):
                mb = {k: v[i * (v.shape[0] // accum_steps):
                           (i + 1) * (v.shape[0] // accum_steps)]
                      for k, v in batch.items()}
                loss, g = value_and_grad(loss_fn, params, mb)
                losses.append(loss)
                acc = tree_map(lambda b: b.float(), g) if acc is None \
                    else tree_map(lambda a, b: a.add_(b.float()), acc, g)
                del g
            grads = tree_map(lambda a: a.div_(accum_steps), acc)
            loss = torch.stack(losses).mean()
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        params, opt_state = apply_updates(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step
