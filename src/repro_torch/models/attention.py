"""GQA attention sublayer over the full sequence: projections, qk-norm,
RoPE, the flash-attention kernel (port of ``repro/models/attention.py::
attn_defs, _project_qkv, attention``; the decode path, its KV cache and
cross-attention wait, ROADMAP queue 1 item 13).

The projections are plain matrix products (``torch.einsum``), as
``repro`` leaves them to XLA; attention itself goes through
``kernels/ops.py::flash_attention`` with ``cfg.attention_impl``: the
hand-written kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.sharding.partitioning import ParamDef

__all__ = ["attn_defs", "attention"]


def attn_defs(cfg):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs = {
        "wq": ParamDef((d, hq, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((hq, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = L.rms_norm_def(hd)
        defs["k_norm"] = L.rms_norm_def(hd)
    return defs


def _project_qkv(p, cfg, x, positions):
    """x [B, S, d] -> q [B, Hq, S, Dh], k / v [B, Hkv, S, Dh] (views of
    the [B, S, H, Dh] products: the kernel takes any batch, head and
    position strides)."""
    ct = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(ct))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(ct))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(ct))
    if cfg.qk_norm:
        q = L.rms_norm(p["q_norm"], q)
        k = L.rms_norm(p["k_norm"], k)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attention(p, cfg, x, positions, *, window=None, causal=True):
    """Full-sequence attention (prefill): x [B, S, d] -> [B, S, d]."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = kops.flash_attention(
        q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap,
        impl=cfg.attention_impl,
    )
    out = out.transpose(1, 2)                       # [B, S, H, Dh]
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
