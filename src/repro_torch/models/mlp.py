"""Dense feed-forward sublayers, SwiGLU and GELU, and the MoE variant (port
of ``repro/models/mlp.py``). The products are plain matrix products, as
``repro`` leaves them to XLA: ``torch.einsum``.

MoE routes as ``repro`` does, bit for bit on the integers: top-k of the
router's f32 softmax (the lower expert first on a tie, as ``lax.top_k``),
the T*k assignments stably sorted by expert, each expert's first ``C =
int(T*k/e * moe_capacity_factor) + 1`` kept in an ``[E, C, d]`` block and
the rest dropped through a trash slot (a zero contribution), then each
kept expert output added to its token with its renormalised weight.

On a mesh (:func:`_moe_on_mesh`) the routing runs on every rank over all
tokens, gathered over the batch axes (a replicated region, noted in
``partitioning.REPLICATED``), so the capacity and the drops are the
meshless ones; each rank dispatches to and combines from its own experts
in ``local_map`` regions, and the combine's per-rank sums add up across
the expert axis.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import partitioning as part
from repro_torch.sharding.partitioning import ParamDef, constrain

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
        g = L.linear(x, p["w_gate"].to(ct))
        u = L.linear(x, p["w_up"].to(ct))
        h = F.silu(g) * u
    else:
        h = F.gelu(L.linear(x, p["w_up"].to(ct)), approximate="tanh")
    h = constrain(h, "batch", "seq", "act_mlp")
    out = L.linear(h, p["w_down"].to(ct))
    return constrain(out, "batch", "seq", "act_embed")



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
    # bincount, as a scatter: its output shape does not hang on the data
    counts = torch.zeros(e, dtype=torch.long, device=xt.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
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
    if part.is_dtensor(x):
        return _moe_on_mesh(p, cfg, x)
    xt = x.reshape(B * S, d)
    r = route(p, cfg, xt)
    disp = _dispatch(xt, r["se"], r["st"], r["pos"], r["keep"], 0, e, r["C"],
                     ct)
    h = F.silu(torch.einsum("ecd,edf->ecf", disp, p["w_gate"].to(ct))) \
        * torch.einsum("ecd,edf->ecf", disp, p["w_up"].to(ct))
    eo = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(ct))
    out = _combine(eo, r["se"], r["st"], r["sw"], r["pos"], r["keep"], 0,
                   B * S)
    return out.reshape(B, S, d), r["aux"]


def _dispatch(xt, se, st, pos, keep, lo, hi, C, ct):
    """The ``[hi - lo, C, d]`` block of experts ``[lo, hi)`` filled from
    tokens xt [T, d]: each kept assignment to one of them in its slot, the
    rest (dropped, or another expert's) spilled to a trash slot."""
    n, d = hi - lo, xt.shape[1]
    mine = keep & (se >= lo) & (se < hi)
    slot = torch.where(mine, (se - lo) * C + pos, torch.full_like(pos, n * C))
    disp = torch.zeros((n * C + 1, d), dtype=ct, device=xt.device)
    disp[slot] = xt[st].to(ct)
    return disp[: n * C].reshape(n, C, d)


def _combine(eo, se, st, sw, pos, keep, lo, T):
    """[T, d]: each kept assignment to experts ``[lo, lo + E)`` (eo
    [E, C, d], their outputs) added to its token with its weight."""
    n, C, d = eo.shape
    ct = eo.dtype
    mine = keep & (se >= lo) & (se < lo + n)
    gath = eo.reshape(n * C, d)[torch.clamp((se - lo) * C + pos, 0,
                                            n * C - 1)]
    gath = torch.where(mine[:, None], gath,
                       torch.zeros((), dtype=ct, device=eo.device))
    return torch.zeros((T, d), dtype=ct, device=eo.device).index_add_(
        0, st, gath * sw[:, None].to(ct))


_ROUTE_KEYS = ("probs", "top_w", "top_e", "aux", "se", "st", "sw", "pos",
               "keep")


def _moe_on_mesh(p, cfg, x):
    """:func:`moe` on DTensors, at ``repro``'s constrain sites: the
    routing replicated over all tokens, then ``[E, C, d]`` with the
    experts on ``act_expert``'s axis (each rank fills its own experts'
    slots), the expert products as DTensor einsums, and the combine as
    per-rank partial sums over the expert axis."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    B, S, d = x.shape
    e, T = cfg.n_experts, B * S
    ct = x.dtype
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    part.note_replicated("moe routing: every token on every rank")
    xt = x.reshape(T, d).redistribute(mesh, rep)
    router = p["router"].redistribute(mesh, rep)
    C = int((T * cfg.expert_top_k / e) * cfg.moe_capacity_factor) + 1

    def route_local(xt, router):
        r = route({"router": router}, cfg, xt)
        return tuple(r[k] for k in _ROUTE_KEYS)

    r = dict(zip(_ROUTE_KEYS, local_map(
        route_local, out_placements=(rep,) * len(_ROUTE_KEYS),
        in_placements=(rep, rep), device_mesh=mesh)(xt, router)))

    ep = list(part.placements(part.logical_to_spec(
        ("act_expert", None, None), mesh, (e, C, d)), mesh))
    e_dims = [i for i, pl in enumerate(ep) if pl == Shard(0)]

    def e_range(n_local):
        lo = 0
        for i in e_dims:  # experts split outer mesh dim first
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
        return lo * n_local, (lo + 1) * n_local

    def dispatch(xt, se, st, pos, keep):
        e_l = e // math.prod(mesh.size(i) for i in e_dims)
        lo, hi = e_range(e_l)
        return _dispatch(xt, se, st, pos, keep, lo, hi, C, ct)

    # a replicated input read by one rank's experts only gets a partial
    # gradient on each rank: it sums over the expert axis
    part_e = [Partial() if i in e_dims else Replicate()
              for i in range(mesh.ndim)]
    disp = local_map(dispatch, out_placements=ep,
                     in_placements=(rep,) * 5,
                     in_grad_placements=(part_e,) + (rep,) * 4,
                     device_mesh=mesh)(
        xt, r["se"], r["st"], r["pos"], r["keep"])
    disp = constrain(disp, "act_expert", None, None)
    h = F.silu(torch.einsum("ecd,edf->ecf", disp, p["w_gate"].to(ct))) \
        * torch.einsum("ecd,edf->ecf", disp, p["w_up"].to(ct))
    h = constrain(h, "act_expert", None, "act_mlp")
    eo = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(ct))
    eo = constrain(eo, "act_expert", None, None)

    def combine(eo, se, st, sw, pos, keep):
        return _combine(eo, se, st, sw, pos, keep, e_range(eo.shape[0])[0],
                        T)

    out = local_map(combine, out_placements=part_e,
                    in_placements=(ep,) + (rep,) * 5,
                    in_grad_placements=(ep, rep, rep, part_e, rep, rep),
                    device_mesh=mesh)(
        eo, r["se"], r["st"], r["sw"], r["pos"], r["keep"])
    return constrain(out.reshape(B, S, d), "batch", "seq", "act_embed"), \
        r["aux"]
