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
from repro_torch.sharding import partitioning as part
from repro_torch.sharding.partitioning import ParamDef, constrain, \
    is_dtensor

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


def _heads_proj(x, w):
    """x [B, S, d] @ w [d, H, Dh] -> [B, S, H, Dh]; on a mesh as
    ``partitioning.local_linear`` on the flattened [d, H * Dh] weight (H
    splits over model where it divides, else H * Dh stays whole)."""
    if not is_dtensor(w):
        return torch.einsum("bsd,dhk->bshk", x, w)
    B, S, _ = x.shape
    H, Dh = w.shape[1], w.shape[2]
    out = part.local_linear(x, w.reshape(w.shape[0], H * Dh))
    return out.reshape(B, S, H, Dh)


def _out_proj(out, w):
    """out [B, S, H, Dh] @ w [H, Dh, d] -> [B, S, d]; on a mesh as
    ``partitioning.local_linear`` (row-parallel where H splits)."""
    if not is_dtensor(w):
        return torch.einsum("bshk,hkd->bsd", out, w)
    B, S, H, Dh = out.shape
    return part.local_linear(out.reshape(B, S, H * Dh),
                             w.reshape(H * Dh, w.shape[2]))


def _project_qkv(p, cfg, x, positions):
    """x [B, S, d] -> q [B, Hq, S, Dh], k / v [B, Hkv, S, Dh] (views of
    the [B, S, H, Dh] products: the kernel takes any batch, head and
    position strides)."""
    ct = x.dtype
    q = _heads_proj(x, p["wq"].to(ct))
    k = _heads_proj(x, p["wk"].to(ct))
    v = _heads_proj(x, p["wv"].to(ct))
    if cfg.qk_norm:
        q = L.rms_norm(p["q_norm"], q)
        k = L.rms_norm(p["k_norm"], k)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    q = constrain(q.transpose(1, 2), "batch", "act_heads", "seq", None)
    k = constrain(k.transpose(1, 2), "batch", "act_heads", "seq", None)
    v = constrain(v.transpose(1, 2), "batch", "act_heads", "seq", None)
    return q, k, v


def attention(p, cfg, x, positions, *, window=None, causal=True, kv=None):
    """Full-sequence attention (prefill, the encoder): x [B, S, d] ->
    (out [B, S, d], (k, v)), the K/V seeding the decode cache.

    ``kv``: precomputed (k, v) [B, Hkv, Skv, Dh] for cross-attention
    (:func:`cross_kv`); q then gets no RoPE."""
    if kv is None:
        q, k, v = _project_qkv(p, cfg, x, positions)
    else:
        q = _heads_proj(x, p["wq"].to(x.dtype))
        if cfg.qk_norm:
            q = L.rms_norm(p["q_norm"], q)
        q = q.transpose(1, 2)
        k, v = kv
    out = kops.flash_attention(
        q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap,
        impl=cfg.attention_impl,
    )
    out = out.transpose(1, 2)                       # [B, S, H, Dh]
    out = _out_proj(out, p["wo"].to(x.dtype))
    return constrain(out, "batch", "seq", "act_embed"), (k, v)


def cross_kv(p, cfg, enc_out):
    """Cross-attention K/V from the encoder output [B, S_enc, d]:
    contiguous [B, Hkv, S_enc, Dh] each, computed once per request and
    kept as the decoder's static cross cache."""
    ct = enc_out.dtype
    k = _heads_proj(enc_out, p["wk"].to(ct))
    v = _heads_proj(enc_out, p["wv"].to(ct))
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
    is seen. The softmax over the whole cache runs in f32. A cache of
    DTensors goes through :func:`_decode_on_mesh`."""
    ct = x.dtype
    pos = int(pos)
    q = _heads_proj(x, p["wq"].to(ct))
    k_new = v_new = None
    if update:
        k_new = _heads_proj(x, p["wk"].to(ct))
        v_new = _heads_proj(x, p["wv"].to(ct))
    if cfg.qk_norm:
        q = L.rms_norm(p["q_norm"], q)
        if update:
            k_new = L.rms_norm(p["k_norm"], k_new)
    if update:
        posv = torch.full((1,), pos, dtype=torch.long, device=x.device)
        q = L.rope(q, posv, cfg.rope_theta)
        k_new = L.rope(k_new, posv, cfg.rope_theta)
    if is_dtensor(cache["k"]):
        out = _decode_on_mesh(cfg, q, k_new, v_new, cache, pos, window)
    else:
        if update:
            cache["k"][:, :, pos] = k_new[:, 0]
            cache["v"][:, :, pos] = v_new[:, 0]
        out = _decode_softmax(cfg, q, cache["k"], cache["v"], pos, window,
                              update)
    out = _out_proj(out.to(ct), p["wo"].to(ct))
    return constrain(out, "batch", "seq", "act_embed"), cache


def _decode_scores(cfg, q, k, pos, window, update, lo=0):
    """f32 scores [B, Hkv, g, S] of q [B, 1, Hq, Dh] against the cache
    rows k [B, Hkv, S, Dh] at positions ``lo ..``, masked past ``pos``."""
    B, hd = q.shape[0], cfg.hd
    hkv = k.shape[1]
    qg = (q.float() * (hd ** -0.5)).reshape(B, hkv, q.shape[2] // hkv, hd)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float())
    s = L.softcap(s, cfg.attn_softcap)
    if update:
        kpos = torch.arange(lo, lo + k.shape[2], device=q.device)
        mask = kpos <= pos
        if window is not None:
            mask &= kpos > pos - window
        s = s.masked_fill(~mask, float("-inf"))
    return s


def _decode_softmax(cfg, q, k, v, pos, window, update):
    """[B, 1, Hq, Dh] f32: the softmax over the whole cache."""
    s = _decode_scores(cfg, q, k, pos, window, update)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", w, v.float())
    return out.reshape(q.shape[0], 1, q.shape[2], cfg.hd)


def _decode_on_mesh(cfg, q, k_new, v_new, cache, pos, window):
    """Decode attention on a DTensor cache [B, Hkv, S, Dh] whose mesh dims
    shard the batch, the KV heads or the positions (at most one dim).
    Each rank writes the new row where ``pos`` falls in its positions and
    scores its rows in a ``local_map`` region; with the positions sharded
    each rank returns its softmax max, sum and weighted V (the
    flash-decode pattern) and the ranks' partials are gathered and merged,
    so no rank holds another's rows. Returns [B, 1, Hq, Dh] f32."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    kc, vc = cache["k"], cache["v"]
    mesh, cp = kc.device_mesh, tuple(kc.placements)
    update = k_new is not None
    if tuple(vc.placements) != cp or any(
            not isinstance(pl, (Shard, Replicate))
            or (isinstance(pl, Shard) and pl.dim > 2) for pl in cp):
        raise ValueError(f"decode on a mesh: cache placements k {cp}, "
                         f"v {tuple(vc.placements)}")
    seq_dims = [i for i, pl in enumerate(cp) if pl == Shard(2)]
    for i, pl in enumerate(cp):
        if pl == Replicate() and mesh.size(i) > 1:
            part.note_replicated(f"decode attention: the cache whole on "
                                 f"mesh dim {i}")
    if len(seq_dims) > 1:
        raise ValueError(f"decode on a mesh: positions on mesh dims "
                         f"{seq_dims}")
    # q, k_new, v_new [B, 1, H, Dh]: the cache's batch and head placements
    qp = tuple(Shard(0) if pl == Shard(0) else
               Shard(2) if pl == Shard(1) else Replicate() for pl in cp)
    q = q.redistribute(mesh, qp)
    # the partials [1, B, Hkv, g(, Dh)]: one entry per position shard
    sp = tuple(Shard(0) if pl == Shard(2) else
               Shard(pl.dim + 1) if isinstance(pl, Shard) else Replicate()
               for pl in cp)

    def local(ql, kl, vl, *new):
        lo = mesh.get_local_rank(seq_dims[0]) * kl.shape[2] \
            if seq_dims else 0
        if new and lo <= pos < lo + kl.shape[2]:
            kl[:, :, pos - lo] = new[0][:, 0]
            vl[:, :, pos - lo] = new[1][:, 0]
        s = _decode_scores(cfg, ql, kl, pos, window, update, lo)
        m = s.amax(dim=-1)
        e = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
        o = torch.einsum("bhgs,bhsd->bhgd", e, vl.float())
        return m[None], e.sum(dim=-1)[None], o[None]

    args = (q, kc, vc)
    in_p = (list(qp), list(cp), list(cp))
    if update:
        args += (k_new.redistribute(mesh, qp), v_new.redistribute(mesh, qp))
        in_p += (list(qp), list(qp))
    m, l, o = local_map(local, out_placements=(list(sp),) * 3,
                        in_placements=in_p, device_mesh=mesh)(*args)
    if seq_dims:
        rp = tuple(Replicate() if i == seq_dims[0] else pl
                   for i, pl in enumerate(sp))
        m, l, o = (t.redistribute(mesh, rp) for t in (m, l, o))
    top = m.amax(dim=0)
    w = torch.exp(m - top[None])
    out = (o * w[..., None]).sum(dim=0) / (l * w).sum(dim=0)[..., None]
    B = out.shape[0]
    return out.reshape(B, 1, cfg.n_heads, cfg.hd)
