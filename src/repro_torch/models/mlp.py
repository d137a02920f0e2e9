"""Dense feed-forward sublayers, SwiGLU and GELU, and the MoE variant (port
of ``repro/models/mlp.py``). The products are plain matrix products, as
``repro`` leaves them to XLA: ``torch.einsum``.

MoE routes as ``repro`` does, bit for bit on the integers: top-k of the
router's f32 softmax (the lower expert first on a tie, as ``lax.top_k``),
the T*k assignments stably sorted by expert, each expert's first ``C =
int(T*k/e * moe_capacity_factor) + 1`` kept in an ``[E, C, d]`` block and
the rest dropped through a trash slot (a zero contribution), then each
kept expert output added to its token with its renormalised weight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.partitioning import ParamDef

__all__ = ["mlp_defs", "mlp", "moe_defs", "moe"]


def mlp_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {
            "w_gate": ParamDef((d, f), ("embed", "mlp")),
            "w_up": ParamDef((d, f), ("embed", "mlp")),
            "w_down": ParamDef((f, d), ("mlp", "embed")),
        }
    return {
        "w_up": ParamDef((d, f), ("embed", "mlp")),
        "w_down": ParamDef((f, d), ("mlp", "embed")),
    }


def mlp(p, cfg, x):
    """x [B, S, d] in the compute dtype -> [B, S, d]. GELU is the tanh
    approximation, ``jax.nn.gelu``'s default."""
    ct = x.dtype
    if cfg.mlp_kind == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(ct))
        u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(ct))
        h = F.silu(g) * u
    else:
        h = F.gelu(torch.einsum("bsd,df->bsf", x, p["w_up"].to(ct)),
                   approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(ct))


def moe_defs(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamDef((d, e), ("embed", None)),
        "w_gate": ParamDef((e, d, f), ("expert", "embed", "mlp")),
        "w_up": ParamDef((e, d, f), ("expert", "embed", "mlp")),
        "w_down": ParamDef((e, f, d), ("expert", "mlp", "embed")),
    }


def route(p, cfg, xt):
    """The routing of tokens xt [T, d]: a dict of ``probs`` [T, e] (f32),
    ``top_w`` / ``top_e`` [T, k], the Switch ``aux`` loss, the
    assignments sorted by expert (``se``, ``st``, ``sw`` [T*k]), each
    one's ``pos`` in its expert group, ``keep`` (pos < C) and ``C``."""
    T = xt.shape[0]
    e, k = cfg.n_experts, cfg.expert_top_k
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    # a stable descending sort puts the lower expert first on a tie
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = top_e.reshape(-1)
    counts = torch.bincount(flat_e, minlength=e)
    aux = e * torch.sum(probs.mean(0) * counts.float() / (T * k))

    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.arange(T, device=xt.device).repeat_interleave(k)[order]
    sw = top_w.reshape(-1)[order]
    C = int((T * k / e) * cfg.moe_capacity_factor) + 1
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=xt.device) - starts[se]
    return {"probs": probs, "top_w": top_w, "top_e": top_e, "aux": aux,
            "se": se, "st": st, "sw": sw, "pos": pos, "keep": pos < C,
            "C": C}


def moe(p, cfg, x):
    """x [B, S, d] -> (out [B, S, d], aux), top-k expert routing with
    capacity-bounded dispatch (:func:`route`)."""
    B, S, d = x.shape
    e = cfg.n_experts
    ct = x.dtype
    xt = x.reshape(B * S, d)
    r = route(p, cfg, xt)
    C, keep, se, st, pos = r["C"], r["keep"], r["se"], r["st"], r["pos"]

    # dispatch into [E, C, d]; dropped assignments spill to a trash slot
    slot = torch.where(keep, se * C + pos, torch.full_like(pos, e * C))
    disp = torch.zeros((e * C + 1, d), dtype=ct, device=x.device)
    disp[slot] = xt[st].to(ct)
    disp = disp[: e * C].reshape(e, C, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", disp, p["w_gate"].to(ct))) \
        * torch.einsum("ecd,edf->ecf", disp, p["w_up"].to(ct))
    eo = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(ct)).reshape(e * C, d)

    # combine: each kept assignment adds w * expert_out to its token
    gath = eo[torch.clamp(se * C + pos, 0, e * C - 1)]
    gath = torch.where(keep[:, None], gath, torch.zeros((), dtype=ct,
                                                         device=x.device))
    out = torch.zeros((B * S, d), dtype=ct, device=x.device).index_add_(
        0, st, gath * r["sw"][:, None].to(ct))
    return out.reshape(B, S, d), r["aux"]
