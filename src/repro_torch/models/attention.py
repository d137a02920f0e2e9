"""GQA attention sublayer: projections, qk-norm, RoPE, local windows,
softcap, cross-attention and the KV cache (port of
``repro/models/attention.py``).

The projections are plain matrix products (``torch.einsum``), as
``repro`` leaves them to XLA. Full-sequence attention (prefill, the
encoder, cross-attention) goes through ``kernels/ops.py::flash_attention``
with ``cfg.attention_impl``: the hand-written kernel on the card, its
plain version on the CPU. One-token decode is a masked f32 softmax over
the cache in plain torch, as ``repro`` computes it (its flash kernel
targets the prefill shapes).

The decode cache keeps ``repro``'s ``[B, Hkv, Smax, Dh]`` layout. Unlike
``repro``, which returns an updated copy, :func:`decode_attention` writes
the new K/V row into the cache tensors in place and returns the same
dict: no per-token copy of the cache.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.sharding.partitioning import ParamDef

__all__ = ["attn_defs", "attention", "cross_kv", "init_kv_cache",
           "decode_attention"]


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


def attention(p, cfg, x, positions, *, window=None, causal=True, kv=None):
    """Full-sequence attention (prefill, the encoder): x [B, S, d] ->
    (out [B, S, d], (k, v)), the K/V seeding the decode cache.

    ``kv``: precomputed (k, v) [B, Hkv, Skv, Dh] for cross-attention
    (:func:`cross_kv`); q then gets no RoPE."""
    if kv is None:
        q, k, v = _project_qkv(p, cfg, x, positions)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
        if cfg.qk_norm:
            q = L.rms_norm(p["q_norm"], q)
        q = q.transpose(1, 2)
        k, v = kv
    out = kops.flash_attention(
        q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap,
        impl=cfg.attention_impl,
    )
    out = out.transpose(1, 2)                       # [B, S, H, Dh]
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), (k, v)


def cross_kv(p, cfg, enc_out):
    """Cross-attention K/V from the encoder output [B, S_enc, d]:
    contiguous [B, Hkv, S_enc, Dh] each, computed once per request and
    kept as the decoder's static cross cache."""
    ct = enc_out.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(ct))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(ct))
    return (k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())


def init_kv_cache(cfg, batch, max_len, dtype, *, device):
    """An empty per-layer KV cache, [B, Hkv, Smax, Dh] x2."""
    shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p, cfg, x, cache, pos, *, window=None, update=True):
    """One-token decode against the KV cache: x [B, 1, d], ``pos`` the
    token's absolute position (an int) -> (out [B, 1, d], cache).

    ``update=True`` (self-attention): q and the new k get RoPE at ``pos``
    and the new K/V row is written into ``cache["k"]`` / ``cache["v"]``
    at ``pos`` in place; keys past ``pos`` (and, with ``window``, at or
    before ``pos - window``) are masked. ``update=False``
    (cross-attention): the cache is static, q gets no RoPE and every key
    is seen. The softmax over the whole cache runs in f32."""
    ct = x.dtype
    pos = int(pos)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(ct))
    if update:
        k_new = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(ct))
        v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(ct))
    if cfg.qk_norm:
        q = L.rms_norm(p["q_norm"], q)
        if update:
            k_new = L.rms_norm(p["k_norm"], k_new)
    if update:
        posv = torch.full((1,), pos, dtype=torch.long, device=x.device)
        q = L.rope(q, posv, cfg.rope_theta)
        k_new = L.rope(k_new, posv, cfg.rope_theta)
        cache["k"][:, :, pos] = k_new[:, 0]
        cache["v"][:, :, pos] = v_new[:, 0]
    k, v = cache["k"], cache["v"]

    B = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qg = (q.float() * (hd ** -0.5)).reshape(B, hkv, hq // hkv, hd)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float())
    s = L.softcap(s, cfg.attn_softcap)
    if update:
        kpos = torch.arange(k.shape[2], device=x.device)
        mask = kpos <= pos
        if window is not None:
            mask &= kpos > pos - window
        s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", w, v.float())
    out = out.reshape(B, 1, hq, hd).to(ct)             # [B, 1, H, Dh]
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(ct)), cache
