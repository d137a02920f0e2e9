"""xLSTM blocks: mLSTM (matrix memory, chunkwise parallel form and O(1)
recurrent decode) and sLSTM (scalar memory, recurrent) -- arXiv:2405.04517,
``repro``'s simplified block wiring (port of ``repro/models/xlstm.py``).

:func:`mlstm_seq` runs the stabilised parallel form inside chunks of 256
positions and carries the matrix state from chunk to chunk, as ``repro``'s
``lax.scan`` does; walking the chunks in order, it also takes a last chunk
shorter than the rest (``repro`` requires S to be a multiple of the
chunk). :func:`slstm_seq` is a loop over time (sLSTM has no parallel
form). The states stay in f32; decode updates them in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import partitioning as part
from repro_torch.sharding.partitioning import ParamDef, constrain, \
    is_dtensor

__all__ = [
    "mlstm_defs", "mlstm_seq", "mlstm_decode_step", "init_mlstm_cache",
    "slstm_defs", "slstm_seq", "slstm_decode_step", "init_slstm_cache",
]

_CONV_K = 4
_M0 = -1e30     # the stabiliser's start: no memory yet


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mdims(cfg):
    d_inner = 2 * cfg.d_model
    return d_inner, cfg.n_heads, d_inner // cfg.n_heads


def mlstm_defs(cfg):
    d = cfg.d_model
    d_inner, H, dh = _mdims(cfg)
    return {
        "w_up": ParamDef((d, 2 * d_inner), ("embed", "mlp")),
        "conv_w": ParamDef((_CONV_K, d_inner), ("conv", "mlp")),
        "conv_b": ParamDef((d_inner,), ("mlp",), init="zeros"),
        "wq": ParamDef((d_inner, d_inner), ("mlp", None)),
        "wk": ParamDef((d_inner, d_inner), ("mlp", None)),
        "wv": ParamDef((d_inner, d_inner), ("mlp", None)),
        "w_if": ParamDef((d_inner, 2 * H), ("mlp", None), scale=0.01),
        "b_if": ParamDef((2 * H,), (None,), init="zeros"),
        "norm": {"scale": ParamDef((d_inner,), ("mlp",), init="ones")},
        "w_down": ParamDef((d_inner, d), ("mlp", "embed")),
    }


def _causal_conv(pad, w, b, S):
    """The causal conv over a front-padded [B, S + K - 1, C] input."""
    win = torch.stack([pad[:, i:i + S] for i in range(_CONV_K)], dim=-1)
    return F.silu(torch.einsum("bsck,kc->bsc", win, w) + b)


def _mlstm_chunk(q, k, v, i_p, logf, C_prev, n_prev, m_prev):
    """One chunk of the stabilised parallel form: q, k, v [B, n, H, dh],
    gates [B, n, H], the state entering it -> (h [B, n, H, dh], the state
    leaving it)."""
    n = q.shape[1]
    tril = torch.tril(torch.ones((n, n), dtype=torch.bool, device=q.device))
    fcum = torch.cumsum(logf, dim=1)                          # [B, n, H]
    dtil = fcum[:, :, None, :] - fcum[:, None, :, :] + i_p[:, None, :, :]
    dtil = dtil.masked_fill(~tril[None, :, :, None], float("-inf"))
    inter_log = fcum + m_prev[:, None, :]                     # [B, n, H]
    m_t = torch.maximum(dtil.amax(dim=2), inter_log)
    Dl = torch.exp(dtil - m_t[:, :, None, :])
    scores = torch.einsum("bthd,bshd->btsh", q, k) * Dl
    inter_w = torch.exp(inter_log - m_t)                      # [B, n, H]
    num = torch.einsum("btsh,bshd->bthd", scores, v) + inter_w[..., None] \
        * torch.einsum("bthd,bhde->bthe", q, C_prev)
    qn = torch.einsum("bthd,bhd->bth", q, n_prev)
    den = torch.maximum((scores.sum(dim=2) + inter_w * qn).abs(),
                        torch.exp(-m_t))
    h = num / den[..., None]
    # the state at the chunk's end
    total = fcum[:, -1, :]                                    # [B, H]
    su = total[:, None, :] - fcum + i_p                       # [B, n, H]
    m_next = torch.maximum(total + m_prev, su.amax(dim=1))
    w_s = torch.exp(su - m_next[:, None, :])
    carry_w = torch.exp(total + m_prev - m_next)
    C_next = carry_w[..., None, None] * C_prev + torch.einsum(
        "bshd,bshe->bhde", k * w_s[..., None], v)
    n_next = carry_w[..., None] * n_prev + torch.einsum(
        "bsh,bshd->bhd", w_s, k)
    return h, C_next, n_next, m_next


def mlstm_seq(p, cfg, x, chunk=256):
    """Chunkwise stabilised mLSTM: x [B, S, d] -> (out [B, S, d], final
    state {"conv", "c", "n", "m"}); memory O(S * chunk), not O(S^2)."""
    if is_dtensor(x):
        out, state = part.batch_local(
            lambda p, x, _: mlstm_seq(p, cfg, x, chunk), p, x,
            state_keys=("conv", "c", "n", "m"),
            region="mLSTM mixer: the heads whole on each rank")
        return constrain(out, "batch", "seq", "act_embed"), state
    B, S, d = x.shape
    d_inner, H, dh = _mdims(cfg)
    ct = x.dtype
    Lc = min(chunk, S)

    xi, z = torch.einsum("bsd,de->bse", x, p["w_up"].to(ct)).chunk(2, -1)
    pad = F.pad(xi, (0, 0, _CONV_K - 1, 0))
    xc = _causal_conv(pad, p["conv_w"].to(ct), p["conv_b"].to(ct), S)
    q = torch.einsum("bse,ef->bsf", xc, p["wq"].to(ct))
    k = torch.einsum("bse,ef->bsf", xc, p["wk"].to(ct))
    v = torch.einsum("bse,ef->bsf", xi, p["wv"].to(ct))
    gates = (torch.einsum("bse,eg->bsg", xc, p["w_if"].to(ct))
             + p["b_if"].to(ct)).float()
    i_pre, f_pre = gates.chunk(2, -1)                         # [B, S, H]
    qf = q.float().reshape(B, S, H, dh)
    kf = (k.float() / (dh ** 0.5)).reshape(B, S, H, dh)
    vf = v.float().reshape(B, S, H, dh)
    logf = F.logsigmoid(f_pre)

    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
    m = torch.full((B, H), _M0, dtype=torch.float32, device=x.device)
    hs = []
    for c0 in range(0, S, Lc):
        sl = slice(c0, min(c0 + Lc, S))
        h, C, n, m = _mlstm_chunk(qf[:, sl], kf[:, sl], vf[:, sl],
                                  i_pre[:, sl], logf[:, sl], C, n, m)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S, d_inner).to(ct)

    h = L.rms_norm(p["norm"], h) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", h, p["w_down"].to(ct))
    return constrain(out, "batch", "seq", "act_embed"), \
        {"conv": pad[:, S:], "c": C, "n": n, "m": m}


def init_mlstm_cache(cfg, batch, dtype, *, device):
    d_inner, H, dh = _mdims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, _CONV_K - 1, d_inner), dtype=dtype,
                            device=device),
        "c": torch.zeros((batch, H, dh, dh), **f32),
        "n": torch.zeros((batch, H, dh), **f32),
        "m": torch.full((batch, H), _M0, **f32),
    }


def mlstm_decode_step(p, cfg, x, cache):
    """x [B, 1, d] -> (out [B, 1, d], cache), the recurrent form; the
    cache is updated in place."""
    if is_dtensor(x):
        return part.batch_local(
            lambda p, x, c: mlstm_decode_step(p, cfg, x, c), p, x, cache,
            region="mLSTM decode: the heads whole on each rank")
    B = x.shape[0]
    d_inner, H, dh = _mdims(cfg)
    ct = x.dtype
    xi, z = torch.einsum("bsd,de->bse", x, p["w_up"].to(ct)).chunk(2, -1)
    win = torch.cat([cache["conv"], xi], dim=1)
    xc = F.silu(torch.einsum("bkc,kc->bc", win, p["conv_w"].to(ct))
                + p["conv_b"].to(ct))
    q = (xc @ p["wq"].to(ct)).reshape(B, H, dh).float()
    k = (xc @ p["wk"].to(ct)).reshape(B, H, dh).float() / (dh ** 0.5)
    v = (xi[:, 0] @ p["wv"].to(ct)).reshape(B, H, dh).float()
    gates = (xc @ p["w_if"].to(ct) + p["b_if"].to(ct)).float()
    i_pre, f_pre = gates.chunk(2, -1)                         # [B, H]
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + cache["m"], i_pre)
    fs = torch.exp(logf + cache["m"] - m_new)[..., None]
    is_ = torch.exp(i_pre - m_new)[..., None]
    c = cache["c"] * fs[..., None] + is_[..., None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    n = cache["n"] * fs + is_ * k
    num = torch.einsum("bhde,bhd->bhe", c, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, d_inner).to(ct)
    h = L.rms_norm(p["norm"], h) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", h, p["w_down"].to(ct))
    for key, val in (("conv", win[:, 1:]), ("c", c), ("n", n), ("m", m_new)):
        cache[key].copy_(val)
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_defs(cfg):
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    return {
        "w_gates": ParamDef((d, 4 * d), ("embed", "mlp")),
        "r_gates": ParamDef((H, dh, 4 * dh), ("ssm_heads", None, None),
                            scale=0.01),
        "b_gates": ParamDef((4 * d,), (None,), init="zeros"),
        "norm": {"scale": ParamDef((d,), (None,), init="ones")},
        "w_down": ParamDef((d, d), ("embed", None)),
    }


def _slstm_cell(p, cfg, xt, state):
    """One sLSTM step: xt [B, 4d] the pre-projected gates, state {"h",
    "c", "n", "m"} [B, d] f32 -> the new state (new tensors)."""
    B = xt.shape[0]
    d, H = cfg.d_model, cfg.n_heads
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    rec = torch.einsum("bhd,hdg->bhg", h.reshape(B, H, d // H),
                       p["r_gates"].float()).reshape(B, 4 * d)
    g = xt.float() + rec + p["b_gates"].float()
    i_pre, f_pre, z_pre, o_pre = g.chunk(4, -1)               # [B, d]
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_pre)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_pre) * c_new / n_new.clamp_min(1e-6)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def init_slstm_cache(cfg, batch, dtype, *, device):
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z + 1e-6, "m": z + _M0}


def slstm_seq(p, cfg, x):
    """The recurrence over time: x [B, S, d] -> (out [B, S, d], final
    state)."""
    if is_dtensor(x):
        out, state = part.batch_local(
            lambda p, x, _: slstm_seq(p, cfg, x), p, x,
            state_keys=("c", "h", "m", "n"),
            region="sLSTM mixer: the features whole on each rank")
        return constrain(out, "batch", "seq", "act_embed"), state
    B, S, d = x.shape
    ct = x.dtype
    xg = torch.einsum("bsd,dg->bsg", x, p["w_gates"].to(ct))
    state = init_slstm_cache(cfg, B, ct, device=x.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, cfg, xg[:, t], state)
        hs.append(state["h"])
    h = L.rms_norm(p["norm"], torch.stack(hs, dim=1).to(ct))
    out = torch.einsum("bsd,de->bse", h, p["w_down"].to(ct))
    return constrain(out, "batch", "seq", "act_embed"), state


def slstm_decode_step(p, cfg, x, cache):
    """x [B, 1, d] -> (out [B, 1, d], cache), updated in place."""
    if is_dtensor(x):
        return part.batch_local(
            lambda p, x, c: slstm_decode_step(p, cfg, x, c), p, x, cache,
            region="sLSTM decode: the features whole on each rank")
    ct = x.dtype
    xg = torch.einsum("bsd,dg->bsg", x, p["w_gates"].to(ct))
    new = _slstm_cell(p, cfg, xg[:, 0], cache)
    h = L.rms_norm(p["norm"], new["h"][:, None].to(ct))
    out = torch.einsum("bsd,de->bse", h, p["w_down"].to(ct))
    for key, val in new.items():
        cache[key].copy_(val)
    return out, cache
