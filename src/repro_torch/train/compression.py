"""Int8 gradient compression with error feedback (port of
``repro/train/compression.py``).

Each gradient leaf plus its carried residual is quantized to int8 with one
scale per tensor (``max|g| / 127``), and what the quantization lost is
carried to the next step:

    q, new_err = quantize(g + err)
    g_hat      = q * scale           # what the optimizer applies

``torch.round`` rounds half to even as ``jnp.round`` does, so the codes are
``repro``'s bit for bit on the same inputs. On one card there is no
collective to shrink; the pair stands where ``repro`` puts it, between the
gradients and the optimizer.
"""
from __future__ import annotations

import torch

__all__ = ["init_error_state", "compress_grads", "quantize"]


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_error_state(params):
    """Zero f32 residuals beside each parameter."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def quantize(g):
    """f32 ``g`` -> (int8 codes, f32 scale): ``round(g / scale)`` clipped
    to [-127, 127], ``scale = max(max|g|, 1e-12) / 127``."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(grads, err):
    """-> (the decompressed gradients, the new error state), trees
    congruent with ``grads``."""
    def one(g, e):
        gf = g.float() + e
        q, scale = quantize(gf)
        ghat = q.float() * scale
        return ghat, gf - ghat

    pairs = _map(one, grads, err)
    return _map(lambda t: t[0], pairs), _map(lambda t: t[1], pairs)
