"""The uniform decoder stack (port of ``repro/models/transformer.py::defs,
block_defs, block_seq, forward_seq`` for ``layer_pattern="global"``
attention blocks with a dense FFN).

Parameters keep ``repro``'s tree: ``embed/table``, ``final_norm/scale``,
``head/w`` when the embeddings are not tied, and ``blocks/...`` with every
leaf stacked ``[n_layers, ...]``, so weights map path to path. The layers
run one after another in a Python loop over that leading dim (``repro``
scans them). The family and pattern checks live in ``models/api.py``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mlp as mlp_mod
from repro_torch.sharding.partitioning import ParamDef

__all__ = ["defs", "block_defs", "block_seq", "forward_seq"]


def _has_ffn(cfg):
    return cfg.d_ff > 0


def block_defs(cfg):
    d = cfg.d_model
    out = {"norm1": L.rms_norm_def(d), "mixer": attn_mod.attn_defs(cfg)}
    if cfg.sandwich_norm:
        out["norm1b"] = L.rms_norm_def(d)
    if _has_ffn(cfg):
        out["norm2"] = L.rms_norm_def(d)
        out["ffn"] = mlp_mod.mlp_defs(cfg)
        if cfg.sandwich_norm:
            out["norm2b"] = L.rms_norm_def(d)
    return out


def _stack_defs(defs, n):
    """Prepend a ("layers",) stacking dim to every ParamDef."""
    if isinstance(defs, ParamDef):
        return ParamDef((n,) + defs.shape, ("layers",) + defs.axes,
                        init=defs.init, scale=defs.scale)
    return {k: _stack_defs(v, n) for k, v in defs.items()}


def defs(cfg):
    d = cfg.d_model
    out = {
        "embed": L.embed_def(cfg.padded_vocab, d),
        "final_norm": L.rms_norm_def(d),
        "blocks": _stack_defs(block_defs(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        out["head"] = {
            "w": ParamDef((cfg.padded_vocab, d), ("vocab", "embed"))
        }
    return out


def block_seq(bp, cfg, x, positions):
    """One pre-norm block: x + attn(norm(x)), then x + ffn(norm(x))."""
    h = L.rms_norm(bp["norm1"], x)
    mix = attn_mod.attention(bp["mixer"], cfg, h, positions, causal=True)
    if cfg.sandwich_norm:
        mix = L.rms_norm(bp["norm1b"], mix)
    x = x + mix
    if _has_ffn(cfg):
        f = mlp_mod.mlp(bp["ffn"], cfg, L.rms_norm(bp["norm2"], x))
        if cfg.sandwich_norm:
            f = L.rms_norm(bp["norm2b"], f)
        x = x + f
    return x


def _layer(tree, i):
    """Layer ``i`` of a stacked block tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def forward_seq(params, cfg, tokens):
    """tokens int [B, S] -> final hidden states [B, S, d] in the compute
    dtype (after the final norm)."""
    ct = getattr(torch, cfg.compute_dtype)
    x = L.embed_lookup(params["embed"], tokens, ct)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(cfg.n_layers):
        x = block_seq(_layer(params["blocks"], i), cfg, x, positions)
    return L.rms_norm(params["final_norm"], x)
