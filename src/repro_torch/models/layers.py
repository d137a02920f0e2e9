"""Shared model layers: RMS norm, RoPE, embedding lookup, softcap and the
output projection (port of ``repro/models/layers.py``; the cross-entropy
losses wait with training, ROADMAP queue 1 item 13b)."""
from __future__ import annotations

import torch

from repro_torch.sharding.partitioning import ParamDef

__all__ = ["rms_norm", "rms_norm_def", "rope", "embed_def", "embed_lookup",
           "logits", "softcap"]


def rms_norm_def(d):
    return {"scale": ParamDef((d,), (None,), init="ones")}


def rms_norm(p, x, eps=1e-6):
    """RMS norm over the last dim, in f32, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def rope(x, positions, theta=10000.0):
    """x [B, S, H, Dh] or [B, S, Dh], rotated by absolute positions [S]
    (the two halves of the head dim as the real and imaginary parts)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs                 # [S, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == 4:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[None], sin[None]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_def(vocab, d):
    return {"table": ParamDef((vocab, d), ("vocab", "embed"))}


def embed_lookup(p, tokens, compute_dtype):
    """Rows of the table at ``tokens``, in ``compute_dtype``. Indexes
    first and casts the rows: the same values as casting the whole table
    first, as ``repro`` does, without a copy of it per call."""
    return p["table"][tokens].to(compute_dtype)


def softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def logits(embed_p, head_p, x, cfg):
    """x [..., d] -> [..., padded_vocab] in x's dtype: the tied embedding
    table (``cfg.tie_embeddings``) or ``head/w``, then
    ``cfg.logit_softcap``."""
    w = embed_p["table"] if cfg.tie_embeddings else head_p["w"]
    out = torch.einsum("...d,vd->...v", x, w.to(x.dtype))
    return softcap(out, cfg.logit_softcap)
