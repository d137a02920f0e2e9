"""Serve-step builders (port of ``repro/train/step.py::build_prefill_step,
build_decode_step``; ``build_train_step`` waits with training, ROADMAP
queue 1 item 13b).

    prefill = build_prefill_step(model)
    logits, caches = prefill(params, {"tokens": tokens})
    decode = build_decode_step(model)
    next_tok, cache = decode(params, token, cache, pos)   # greedy
"""
from __future__ import annotations

import torch

from repro_torch.models.api import Model

__all__ = ["build_prefill_step", "build_decode_step", "greedy"]


def build_prefill_step(model: Model):
    def step(params, inputs):
        return model.prefill(params, **inputs)

    return step


def greedy(cfg, logits):
    """Logits [B, V] -> the greedy token ids int32 [B, 1], the padded
    vocab tail masked, so every id lies in ``[0, vocab)``; ties go to the
    lower id."""
    if cfg.padded_vocab != cfg.vocab:
        logits = logits.masked_fill(
            torch.arange(logits.shape[-1], device=logits.device)
            >= cfg.vocab, float("-inf"))
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
