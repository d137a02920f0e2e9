"""Mamba2 (SSD) mixer: the chunked full-sequence form and the O(1) decode
step (port of ``repro/models/mamba2.py``).

Per head h, with scalar decay ``a_t`` and the shared input / output
projections B_t, C_t (state dim N, head dim P):

    H_t = a_t * H_{t-1} + B_t x_t^T          H in R^{N x P}
    y_t = C_t^T H_t

:func:`mamba_seq` computes it chunk by chunk (the SSD decomposition): a
quadratic term inside each chunk, and the state carried from chunk to
chunk. ``repro`` combines the chunk states with ``lax.associative_scan``;
the port walks the chunks in order, which computes the same recurrence,
and so also takes a last chunk shorter than ``cfg.ssm_chunk`` (``repro``
requires S to be a multiple of it). The SSM state stays in f32. Decode
keeps (conv_state, ssm_state) and updates both in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import partitioning as part
from repro_torch.sharding.partitioning import ParamDef, constrain, \
    is_dtensor

__all__ = ["mamba_defs", "mamba_seq", "mamba_decode_step",
           "init_mamba_cache"]

_CONV_K = 4


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    return d_inner, heads, cfg.ssm_state, cfg.ssm_head_dim


def mamba_defs(cfg):
    d = cfg.d_model
    d_inner, H, N, P = _dims(cfg)
    conv_dim = d_inner + 2 * N  # x, B, C go through the causal conv
    return {
        "w_in": ParamDef(
            (d, 2 * d_inner + 2 * N + H), ("embed", "mlp")
        ),  # [z, x, B, C, dt]
        "conv_w": ParamDef((_CONV_K, conv_dim), ("conv", "mlp")),
        "conv_b": ParamDef((conv_dim,), ("mlp",), init="zeros"),
        "a_log": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamDef((H,), ("ssm_heads",), init="ones"),
        "norm": {"scale": ParamDef((d_inner,), ("mlp",), init="ones")},
        "w_out": ParamDef((d_inner, d), ("mlp", "embed")),
    }


def _split_proj(p, cfg, x):
    """x [B, S, d] -> z, x, B, C, dt (the input projection's parts)."""
    d_inner, H, N, P = _dims(cfg)
    proj = torch.einsum("bsd,de->bse", x, p["w_in"].to(x.dtype))
    return torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)


def _gated_norm(p, x, z, eps=1e-6):
    xf = x.float() * F.silu(z.float())
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def mamba_seq(p, cfg, x):
    """Full-sequence (prefill) forward: x [B, S, d] -> (out [B, S, d],
    final state {"conv", "ssm"}), the state seeding decode."""
    if is_dtensor(x):
        out, state = part.batch_local(
            lambda p, x, _: mamba_seq(p, cfg, x), p, x,
            state_keys=("conv", "ssm"),
            region="mamba2 mixer: the heads whole on each rank")
        return constrain(out, "batch", "seq", "act_embed"), state
    B, S, d = x.shape
    d_inner, H, N, P = _dims(cfg)
    Lc = min(cfg.ssm_chunk, S)
    ct = x.dtype

    z, xin, Bc, Cc, dt = _split_proj(p, cfg, x)
    # causal depthwise conv over (x, B, C)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv = F.pad(conv_in, (0, 0, _CONV_K - 1, 0))
    win = torch.stack([conv[:, i:i + S] for i in range(_CONV_K)], dim=-1)
    conv_out = F.silu(torch.einsum("bsck,kc->bsc", win, p["conv_w"].to(ct))
                      + p["conv_b"].to(ct))
    xin, Bc, Cc = torch.split(conv_out, [d_inner, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())         # [B, S, H]
    a = -torch.exp(p["a_log"].float())                         # [H]
    la = dt * a                                                # log decay
    xh = xin.reshape(B, S, H, P).float() * dt[..., None]       # dt folded in
    Bf, Cf = Bc.float(), Cc.float()                            # [B, S, N]

    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, Lc):
        sl = slice(c0, min(c0 + Lc, S))
        n = sl.stop - c0
        cum = torch.cumsum(la[:, sl], dim=1)                   # [B, n, H]
        total = cum[:, -1]                                     # [B, H]
        xc, Bcc, Ccc = xh[:, sl], Bf[:, sl], Cf[:, sl]
        # inside the chunk: y[t] = sum_{s<=t} decay(t, s) (C_t . B_s) x_s
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # [B, t, s, H]
        tri = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                    device=x.device))
        # masked before the exp: exp(seg) above the diagonal overflows at
        # long chunks, and an inf there makes a NaN gradient
        decay = torch.exp(seg.masked_fill(~tri[None, :, :, None],
                                          float("-inf")))
        cb = torch.einsum("btn,bsn->bts", Ccc, Bcc)
        y = torch.einsum("btsh,bshp->bthp", cb[..., None] * decay, xc)
        # from the state entering the chunk: exp(cum_t) C_t . H
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "btn,bhnp->bthp", Ccc, h)
        ys.append(y)
        # the state leaving it: exp(total) H + sum_s exp(total - cum_s)
        # B_s x_s^T
        sdecay = torch.exp(total[:, None, :] - cum)            # [B, n, H]
        h = h * torch.exp(total)[..., None, None] + torch.einsum(
            "bsn,bshp->bhnp", Bcc, xc * sdecay[..., None])
    y = torch.cat(ys, dim=1) + xh * p["d_skip"].float()[:, None]
    y = y.reshape(B, S, d_inner).to(ct)

    y = _gated_norm(p["norm"], y, z)
    out = torch.einsum("bse,ed->bsd", y, p["w_out"].to(ct))
    return constrain(out, "batch", "seq", "act_embed"), \
        {"conv": conv[:, S:], "ssm": h}


def init_mamba_cache(cfg, batch, dtype, *, device):
    d_inner, H, N, P = _dims(cfg)
    return {
        "conv": torch.zeros((batch, _CONV_K - 1, d_inner + 2 * N),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, N, P), dtype=torch.float32,
                           device=device),
    }


def mamba_decode_step(p, cfg, x, cache):
    """x [B, 1, d] -> (out [B, 1, d], cache), O(1) a token; the conv
    window and the SSM state are updated in place."""
    B = x.shape[0]
    d_inner, H, N, P = _dims(cfg)
    ct = x.dtype
    z, xin, Bc, Cc, dt = _split_proj(p, cfg, x)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)                # [B, 1, cd]
    win = torch.cat([cache["conv"], conv_in], dim=1)          # [B, K, cd]
    conv_out = F.silu(torch.einsum("bkc,kc->bc", win, p["conv_w"].to(ct))
                      + p["conv_b"].to(ct))
    xin, Bc, Cc = torch.split(conv_out, [d_inner, N, N], dim=-1)

    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # [B, H]
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dtv * a)                                 # [B, H]
    xh = xin.reshape(B, H, P).float() * dtv[..., None]
    h = cache["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", Bc.float(), xh)
    y = torch.einsum("bn,bhnp->bhp", Cc.float(), h)
    y = y + xh * p["d_skip"].float()[None, :, None]
    y = _gated_norm(p["norm"], y.reshape(B, 1, d_inner).to(ct), z)
    out = torch.einsum("bse,ed->bsd", y, p["w_out"].to(ct))
    cache["conv"].copy_(win[:, 1:])
    cache["ssm"].copy_(h)
    return out, cache
