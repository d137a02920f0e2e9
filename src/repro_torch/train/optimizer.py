"""AdamW with a warmup-cosine schedule and global-norm clipping, as plain
functions over the parameter tree (port of ``repro/train/optimizer.py``).

Not ``torch.optim.AdamW``: ``repro`` decays as ``p - lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p)`` and floors its cosine at ``min_lr_frac``,
and the port keeps both. The moments are f32 trees congruent with the
parameters. :func:`adamw_update` computes every new value first and then
writes the parameters and moments in place, so an update that fails
midway leaves them as they were. On DTensor parameters the moments are
DTensors in the same placements, and the clip's global norm sums each
rank's shards and reduces across the ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.sharding import partitioning as part
from repro_torch.sharding.partitioning import leaves

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update",
           "lr_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    """``step``: int32 scalar tensor, the updates taken; ``mu`` / ``nu``:
    the f32 first and second moments, trees congruent with the
    parameters. The field order is ``repro``'s, so a checkpoint's leaves
    line up."""
    step: torch.Tensor
    mu: dict
    nu: dict


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params) -> OptState:
    """Zero moments in f32 beside each parameter; step 0 on the
    parameters' device."""
    dev = next(leaves(params))[1].device

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    _map(zeros, params), _map(zeros, params))


def lr_schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or an int tensor), f32:
    linear warmup over ``warmup_steps``, then a cosine from ``lr`` down to
    ``min_lr_frac * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by
    leaf in sorted-key order."""
    total = None
    for _, g in leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState):
    """One AdamW step of ``grads`` (a tree congruent with ``params``) ->
    ``(params, new state, {"grad_norm", "lr"})``. The gradients are
    clipped to global norm ``clip_norm``; the parameters and the moments
    are written in place once every new value is computed, and the same
    parameter tree is returned. The step's scalars meet DTensors as
    replicated values."""
    with torch.no_grad(), part.replicate_plain():
        return _adamw_update(cfg, params, grads, state)


def _adamw_update(cfg: AdamWConfig, params, grads, state: OptState):
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    mu, nu = dict(leaves(state.mu)), dict(leaves(state.nu))
    gs = dict(leaves(grads))
    new = []
    for path, p in leaves(params):
        g = gs[path].float() * scale
        m = cfg.b1 * mu[path] + (1 - cfg.b1) * g
        v = cfg.b2 * nu[path] + (1 - cfg.b2) * g * g
        pf = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * pf
        new.append((p, (pf - lr * delta).to(p.dtype), mu[path], m,
                    nu[path], v))
    for p, p2, m_old, m, v_old, v in new:
        p.copy_(p2)
        m_old.copy_(m)
        v_old.copy_(v)
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
