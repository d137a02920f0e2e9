"""Dense feed-forward sublayers, SwiGLU and GELU (port of
``repro/models/mlp.py::mlp_defs, mlp``; MoE waits, ROADMAP queue 1 item
13). The products are plain matrix products, as ``repro`` leaves them to
XLA: ``torch.einsum``."""
from __future__ import annotations

import torch.nn.functional as F
import torch

from repro_torch.sharding.partitioning import ParamDef

__all__ = ["mlp_defs", "mlp"]


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
