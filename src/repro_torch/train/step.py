"""The step builders (port of ``repro/train/step.py``).

    step = build_train_step(model, AdamWConfig(), microbatches=1)
    params, opt_state, metrics = step(params, opt_state, batch)
    # compress=True: step(params, opt_state, batch, err) -> (..., err)
    prefill = build_prefill_step(model)
    logits, caches = prefill(params, {"tokens": tokens})
    decode = build_decode_step(model)
    next_tok, cache = decode(params, token, cache, pos)   # greedy

The train step differentiates ``Model.loss`` with autograd, sums the f32
gradients of ``microbatches`` backward passes (peak activation memory is
one microbatch's) and divides by their count, optionally passes them
through int8 error-feedback compression, and applies AdamW in place:
the parameter and moment tensors are updated under ``torch.no_grad()``,
where ``repro`` donates its buffers to a functional update.

On a mesh (DTensor parameters and batch, run inside ``use_global_mesh``)
a gradient that comes back in other placements than its parameter's --
``Partial`` over the data axes, or sharded otherwise -- is redistributed
to the parameter's before AdamW: FSDP's reduce-scatter, and the
all-reduce of a replicated leaf. Microbatches split each rank's shard of
the batch.
"""
from __future__ import annotations

import torch

from repro_torch.models.api import Model
from repro_torch.sharding.partitioning import is_dtensor, leaves
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamWConfig, adamw_update

__all__ = ["build_train_step", "loss_and_grads", "build_prefill_step",
           "build_decode_step", "greedy"]


def _unflatten(paths, values) -> dict:
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return out


def _microbatch(v, i, n):
    """Slice ``i`` of ``n`` of the batch entry ``v`` (dim 0): of each
    rank's shard for a DTensor."""
    if not is_dtensor(v):
        size = v.shape[0] // n
        return v[i * size:(i + 1) * size]
    from torch.distributed.tensor import DTensor

    loc = v.to_local()
    size = loc.shape[0] // n
    return DTensor.from_local(loc[i * size:(i + 1) * size], v.device_mesh,
                              v.placements, run_check=False)


def _as_param(g, p):
    """The gradient ``g`` in its parameter's placements (a plain gradient
    as it is)."""
    if g is None or not is_dtensor(g) or \
            tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def loss_and_grads(model: Model, params, batch, *, microbatches: int = 1):
    """(loss, {"nll", "aux"}, grads) of ``batch`` at ``params``: the loss
    the mean over ``microbatches`` equal slices of the batch (dim 0), the
    metrics the last slice's, detached; ``grads`` a tree congruent with
    ``params``, f32, the mean of the slices' gradients, None at a leaf the
    loss does not reach. Marks every parameter leaf as requiring grad."""
    paths, ps = zip(*leaves(params))
    for p in ps:
        if not p.requires_grad:
            p.requires_grad_(True)
    first = next(iter(batch.values()))
    n = (first.to_local() if is_dtensor(first) else first).shape[0]
    if microbatches < 1 or n % microbatches:
        raise ValueError(f"batch of {n} does not split into {microbatches} "
                         "microbatches")
    acc, loss_sum = None, 0.0
    for i in range(microbatches):
        mb = batch if microbatches == 1 else {
            k: _microbatch(v, i, microbatches) for k, v in batch.items()}
        with torch.enable_grad():
            loss, metrics = model.loss(params, mb)
            gs = torch.autograd.grad(loss, ps, allow_unused=True)
        gs = [_as_param(g, p) for g, p in zip(gs, ps)]
        if acc is None:
            acc = [None if g is None else g.float() for g in gs]
        else:
            acc = [a if g is None else (
                g.float() if a is None else a.add_(g))
                for a, g in zip(acc, gs)]
        loss_sum = loss_sum + loss.detach()
    if microbatches > 1:
        acc = [None if a is None else a / microbatches for a in acc]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss_sum / microbatches, metrics, _unflatten(paths, acc)


def build_train_step(model: Model, opt_cfg: AdamWConfig, *,
                     microbatches: int = 1, compress: bool = False):
    """(params, opt_state, batch[, err]) -> (params, opt_state, metrics[,
    err]), metrics ``{"loss", "nll", "aux", "grad_norm", "lr"}`` (device
    scalars). The parameter tree is updated in place and returned; with
    ``compress`` the gradients go through
    ``compression.compress_grads`` against the carried ``err``."""

    def grads_of(params, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch,
                                              microbatches=microbatches)
        # a leaf the loss does not reach gets a zero gradient, as in repro
        paths, gs = zip(*leaves(grads))
        gs = [torch.zeros_like(p, dtype=torch.float32)
              if g is None else g for (_, p), g in zip(leaves(params), gs)]
        return loss, metrics, _unflatten(paths, gs)

    if compress:
        def step(params, opt_state, batch, err):
            loss, metrics, grads = grads_of(params, batch)
            grads, err = compression.compress_grads(grads, err)
            params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                                 opt_state)
            return params, opt_state, {"loss": loss, **metrics, **om}, err

        return step

    def step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                             opt_state)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return step


def build_prefill_step(model: Model):
    def step(params, inputs):
        return model.prefill(params, **inputs)

    return step


def greedy(cfg, logits):
    """Logits [B, V] -> the greedy token ids int32 [B, 1], the padded
    vocab tail masked, so every id lies in ``[0, vocab)``; ties go to the
    lower id."""
    if cfg.padded_vocab != cfg.vocab:
        tail = torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg.vocab
        logits = torch.where(tail, torch.full((), float("-inf"),
                                              dtype=logits.dtype,
                                              device=logits.device), logits)
    if is_dtensor(logits):  # the vocab whole on each rank, rows split
        from torch.distributed.tensor import Replicate, Shard

        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if pl == Shard(1) or pl.is_partial() else pl
            for pl in logits.placements])
    return logits.argmax(dim=-1).to(torch.int32)[:, None]


def build_decode_step(model: Model):
    """One token for the whole batch against the cache: (params, token
    [B, 1], cache, pos) -> (the :func:`greedy` next token ids int32
    [B, 1], the cache, updated in place)."""
    cfg = model.cfg

    def step(params, token, cache, pos):
        logits, cache = model.decode(params, token, cache, pos)
        return greedy(cfg, logits.reshape(logits.shape[0], -1)), cache

    return step
