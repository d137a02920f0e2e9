"""Shared model layers: RMS norm, RoPE, embedding lookup, softcap, the
output projection and the next-token cross-entropy losses (port of
``repro/models/layers.py``)."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.partitioning import ParamDef

__all__ = ["rms_norm", "rms_norm_def", "rope", "embed_def", "embed_lookup",
           "logits", "softcap", "cross_entropy", "chunked_cross_entropy"]


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


def _ce_terms(logits, targets, vocab, padded_vocab):
    """(sum of the masked NLL, count of targets >= 0), both f32 scalars:
    ``logits`` [..., padded_vocab] stay in their dtype, the max and the
    exp-sum accumulate in f32, the padded vocab tail is pushed out by a
    -1e30 bias in that dtype."""
    ct = logits.dtype
    if padded_vocab != vocab:
        pad = (torch.arange(padded_vocab, device=logits.device)
               >= vocab).to(ct)
        logits = logits - pad * torch.tensor(1e30, dtype=ct,
                                             device=logits.device)
    m = logits.amax(dim=-1).float()
    ex = torch.exp(logits - m[..., None].to(ct))
    logz = m + torch.log(ex.sum(dim=-1, dtype=torch.float32))
    gold = torch.gather(logits, -1, targets.clamp_min(0)[..., None].long()
                        )[..., 0].float()
    mask = (targets >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def cross_entropy(logits, targets, vocab, padded_vocab):
    """Masked next-token CE of ``logits`` [B, S, padded_vocab] (in the
    compute dtype) against ``targets`` int [B, S]; targets of -1 are
    ignored. Returns the mean over the counted targets, f32."""
    tot, cnt = _ce_terms(logits, targets, vocab, padded_vocab)
    return tot / cnt.clamp_min(1.0)


def chunked_cross_entropy(w, hidden, targets, cfg, *, chunk=512):
    """CE fused with the output projection ``w`` [padded_vocab, d] (the
    tied embedding or ``head/w``), a chunk of ``chunk`` positions at a
    time: each chunk's [B, chunk, V] logits are made, reduced and, under
    autograd, recomputed in backward (``torch.utils.checkpoint``, as
    ``repro``'s ``@jax.checkpoint``), so one chunk's logits live at a
    time. When ``chunk`` does not divide S the full logits are made."""
    B, S, d = hidden.shape
    ct = hidden.dtype
    Sc = min(chunk, S)
    if S % Sc:
        return cross_entropy(
            softcap(torch.einsum("bsd,vd->bsv", hidden, w.to(ct)),
                    cfg.logit_softcap),
            targets, cfg.vocab, cfg.padded_vocab)

    def body(xb, tb, w):
        lg = softcap(torch.einsum("bsd,vd->bsv", xb, w.to(ct)),
                     cfg.logit_softcap)
        return _ce_terms(lg, tb, cfg.vocab, cfg.padded_vocab)

    grad = torch.is_grad_enabled()
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, S, Sc):
        xb, tb = hidden[:, s:s + Sc], targets[:, s:s + Sc]
        t, c = (checkpoint(body, xb, tb, w, use_reentrant=False) if grad
                else body(xb, tb, w))
        tot, cnt = tot + t, cnt + c
    return tot / cnt.clamp_min(1.0)
