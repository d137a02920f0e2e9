"""Decoder-only model assembly for every family (port of
``repro/models/transformer.py``).

One block skeleton with a pluggable mixer (attention / mamba2 / mLSTM /
sLSTM) and FFN (dense / MoE / none). Parameters keep ``repro``'s tree, so
weights map path to path: ``embed/table``, ``final_norm/scale``,
``head/w`` when the embeddings are not tied, and ``blocks/...`` with every
leaf stacked on a leading layer dim; gemma2's local/global pairs stack as
``blocks/{a,b}``, xLSTM's groups of four as ``blocks/{m0,m1,m2,s}``, and
zamba2 adds the one ``shared_attn`` block applied after every
``shared_attn_period`` mamba layers (``_split_hybrid``: G groups and a
tail). The layers run one after another in a Python loop over the
leading dim (``repro`` scans them); the caches keep ``repro``'s stacked
trees, and decode updates them in place.

Under autograd each repeating unit of the stack (a block; gemma2's
local/global pair; xLSTM's group of four; zamba2's group of mamba layers
with the shared block after it, and each tail layer) runs through
:func:`_remat` by ``cfg.remat``, as ``repro`` wraps its scan bodies.

Public surface: ``defs``, ``forward_seq``, ``compute_logits``,
``loss_fn``, ``prefill``, ``init_cache``, ``decode_step``.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.sharding.partitioning import ParamDef

__all__ = ["defs", "forward_seq", "compute_logits", "loss_fn", "prefill",
           "init_cache", "decode_step", "layer_kinds"]

_XLSTM_GROUP = (("m0", "mlstm"), ("m1", "mlstm"), ("m2", "mlstm"),
                ("s", "slstm"))
_LOCAL_GLOBAL = (("a", "attn_local"), ("b", "attn"))


# ---------------------------------------------------------------------------
# layer-kind layout per family
# ---------------------------------------------------------------------------

def layer_kinds(cfg):
    if cfg.layer_pattern == "local_global":
        return ["attn_local" if i % 2 == 0 else "attn"
                for i in range(cfg.n_layers)]
    if cfg.layer_pattern == "xlstm":
        return ["slstm" if i in cfg.slstm_layers else "mlstm"
                for i in range(cfg.n_layers)]
    if cfg.layer_pattern in ("hybrid_shared_attn", "ssm"):
        return ["mamba"] * cfg.n_layers  # zamba2's shared attn: separate
    return ["attn"] * cfg.n_layers


def _mixer_defs(cfg, kind):
    if kind.startswith("attn"):
        return attn_mod.attn_defs(cfg)
    if kind == "mamba":
        return mamba_mod.mamba_defs(cfg)
    if kind == "mlstm":
        return xlstm_mod.mlstm_defs(cfg)
    if kind == "slstm":
        return xlstm_mod.slstm_defs(cfg)
    raise ValueError(kind)


def _has_ffn(cfg, kind):
    if kind in ("mlstm", "slstm"):
        return False  # xlstm blocks carry their own projections
    if cfg.layer_pattern == "hybrid_shared_attn" and kind == "mamba":
        return False  # zamba2: only the shared attention block has an MLP
    return cfg.d_ff > 0 or cfg.n_experts > 0


def block_defs(cfg, kind):
    d = cfg.d_model
    out = {"norm1": L.rms_norm_def(d), "mixer": _mixer_defs(cfg, kind)}
    if cfg.sandwich_norm:
        out["norm1b"] = L.rms_norm_def(d)
    if _has_ffn(cfg, kind):
        out["norm2"] = L.rms_norm_def(d)
        out["ffn"] = (mlp_mod.moe_defs(cfg) if cfg.n_experts > 0
                      else mlp_mod.mlp_defs(cfg))
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
    }
    if not cfg.tie_embeddings:
        out["head"] = {
            "w": ParamDef((cfg.padded_vocab, d), ("vocab", "embed"))
        }
    if cfg.layer_pattern == "hybrid_shared_attn":
        out["blocks"] = _stack_defs(block_defs(cfg, "mamba"), cfg.n_layers)
        out["shared_attn"] = block_defs(cfg, "attn")
        return out
    if cfg.layer_pattern == "local_global":
        if cfg.n_layers % 2:
            raise ValueError("local_global needs an even n_layers")
        out["blocks"] = _stack_defs(
            {key: block_defs(cfg, kind) for key, kind in _LOCAL_GLOBAL},
            cfg.n_layers // 2)
        return out
    if cfg.layer_pattern == "xlstm":
        # periodic (mLSTM, mLSTM, mLSTM, sLSTM) groups
        if cfg.n_layers % 4 or tuple(cfg.slstm_layers) != tuple(
                range(3, cfg.n_layers, 4)):
            raise ValueError("the xlstm stack takes groups of 4 with the "
                             "sLSTM block at positions 3 mod 4")
        out["blocks"] = _stack_defs(
            {key: block_defs(cfg, kind) for key, kind in _XLSTM_GROUP},
            cfg.n_layers // 4)
        return out
    out["blocks"] = _stack_defs(block_defs(cfg, layer_kinds(cfg)[0]),
                                cfg.n_layers)
    return out


# ---------------------------------------------------------------------------
# trees: layer views, stacking, zero caches
# ---------------------------------------------------------------------------

def _layer(tree, i):
    """Entry ``i`` of the leading dim of every leaf (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees):
    """Stack a list of equal trees on a new leading dim."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _repeat(tree, lead):
    """A tree of ``lead + shape`` tensors, each entry a copy of ``tree``
    (own memory: decode writes into it)."""
    if isinstance(tree, dict):
        return {k: _repeat(v, lead) for k, v in tree.items()}
    return tree.expand(tuple(lead) + tuple(tree.shape)).clone()


def _split_hybrid(cfg):
    """zamba2's layout: the layer indices of G full groups of
    ``shared_attn_period`` mamba layers (each followed by the shared
    attention block) and of the tail of the remaining layers."""
    period = cfg.shared_attn_period
    G = cfg.n_layers // period
    groups = [range(g * period, (g + 1) * period) for g in range(G)]
    return groups, range(G * period, cfg.n_layers)


# ---------------------------------------------------------------------------
# block application (full sequence)
# ---------------------------------------------------------------------------

def _mixer_seq(bp, cfg, kind, h, positions):
    """(mix_out, cache_seed): the prefill KV or the final state."""
    if kind.startswith("attn"):
        window = cfg.local_window if kind == "attn_local" else None
        out, (k, v) = attn_mod.attention(bp, cfg, h, positions,
                                         window=window, causal=True)
        return out, {"k": k, "v": v}
    if kind == "mamba":
        return mamba_mod.mamba_seq(bp, cfg, h)
    if kind == "mlstm":
        return xlstm_mod.mlstm_seq(bp, cfg, h)
    if kind == "slstm":
        return xlstm_mod.slstm_seq(bp, cfg, h)
    raise ValueError(kind)


def _ffn(bp, cfg, x):
    """The FFN half of a block: (x + ffn(norm(x)), MoE aux or 0)."""
    h2 = L.rms_norm(bp["norm2"], x)
    aux = 0.0
    if cfg.n_experts > 0:
        f, aux = mlp_mod.moe(bp["ffn"], cfg, h2)
    else:
        f = mlp_mod.mlp(bp["ffn"], cfg, h2)
    if cfg.sandwich_norm:
        f = L.rms_norm(bp["norm2b"], f)
    return x + f, aux


def block_seq(bp, cfg, kind, x, positions):
    """One pre-norm block: (x', cache_seed, MoE aux)."""
    h = L.rms_norm(bp["norm1"], x)
    mix, cache = _mixer_seq(bp["mixer"], cfg, kind, h, positions)
    if cfg.sandwich_norm:
        mix = L.rms_norm(bp["norm1b"], mix)
    x = x + mix
    aux = 0.0
    if _has_ffn(cfg, kind):
        x, aux = _ffn(bp, cfg, x)
    return x, cache, aux


def _units(cfg, blocks):
    """The stack as a list of repeating units: (layer params, kinds by
    key or None for one block of ``kind``)."""
    if cfg.layer_pattern == "xlstm":
        return [(_layer(blocks, i), _XLSTM_GROUP)
                for i in range(cfg.n_layers // 4)]
    if cfg.layer_pattern == "local_global":
        return [(_layer(blocks, i), _LOCAL_GLOBAL)
                for i in range(cfg.n_layers // 2)]
    kind = layer_kinds(cfg)[0]
    return [(_layer(blocks, i), kind) for i in range(cfg.n_layers)]


def _add_aux(aux, a):
    """aux + a, where ``a`` is a block's MoE aux loss or 0.0."""
    return aux + a if torch.is_tensor(a) else aux


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of matrix products, recompute
    the rest (``jax.checkpoint_policies.checkpoint_dots``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """``fn`` as one repeating unit runs under ``cfg.remat``: ``"none"``
    keeps every activation for backward; ``"full"`` keeps the unit's
    inputs and recomputes the rest in backward; ``"dots"`` keeps the
    outputs of its matrix products too. Without autograd ``fn`` runs
    as it is."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: expected none, full or dots")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _unit_seq(bp, x, cfg, kinds, positions):
    """One repeating unit of the stack: (x', cache seeds, MoE aux)."""
    if isinstance(kinds, str):
        return block_seq(bp, cfg, kinds, x, positions)
    c, aux = {}, 0.0
    for key, kind in kinds:
        x, c[key], a = block_seq(bp[key], cfg, kind, x, positions)
        aux = _add_aux(aux, a)
    return x, c, aux


def _group_seq(bps, x, cfg, sp, positions):
    """zamba2's unit: mamba layers ``bps`` then the shared attention block
    ``sp`` -> (x', ([mamba cache seeds], attention's), MoE aux)."""
    mcs, aux = [], 0.0
    for bp in bps:
        x, c, a = block_seq(bp, cfg, "mamba", x, positions)
        mcs.append(c)
        aux = _add_aux(aux, a)
    x, ac, a = block_seq(sp, cfg, "attn", x, positions)
    return x, (mcs, ac), _add_aux(aux, a)


def _apply(unit, cfg, collect_cache, params, x, *rest):
    """``unit(params, x, *rest) -> (x', cache, aux)``, through
    :func:`_remat` unless the caches are collected (prefill), which keeps
    them and runs as it is."""
    if collect_cache:
        return unit(params, x, *rest)

    def no_cache(params, x):
        x, _, aux = unit(params, x, *rest)
        return x, aux

    x, aux = _remat(no_cache, cfg)(params, x)
    return x, None, aux


def forward_seq(params, cfg, tokens, *, collect_cache=False):
    """tokens int [B, S] -> (hidden [B, S, d] after the final norm, in the
    compute dtype; the per-layer prefill caches stacked as ``repro``'s
    scans stack them, or None; the summed MoE aux loss, an f32 tensor, or
    0.0 where no block has experts: a dense stack adds nothing on the
    card). Each repeating unit runs through :func:`_remat` unless
    ``collect_cache``."""
    ct = getattr(torch, cfg.compute_dtype)
    x = L.embed_lookup(params["embed"], tokens, ct)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = 0.0

    if cfg.layer_pattern == "hybrid_shared_attn":
        groups, tail = _split_hybrid(cfg)
        sp = params["shared_attn"]
        gm, ga, rm = [], [], []
        for grp in groups:
            bps = [_layer(params["blocks"], i) for i in grp]
            x, c, a = _apply(_group_seq, cfg, collect_cache, bps, x, cfg,
                             sp, positions)
            aux = _add_aux(aux, a)
            if collect_cache:
                gm.append(_stack(c[0]))
                ga.append(c[1])
        for i in tail:
            x, c, a = _apply(_unit_seq, cfg, collect_cache,
                             _layer(params["blocks"], i), x, cfg, "mamba",
                             positions)
            rm.append(c)
            aux = _add_aux(aux, a)
        caches = None
        if collect_cache:
            caches = {"mamba_g": _stack(gm), "attn": _stack(ga),
                      "mamba_r": _stack(rm) if rm else None}
        return L.rms_norm(params["final_norm"], x), caches, aux

    seeds = []
    for bp, kinds in _units(cfg, params["blocks"]):
        x, c, a = _apply(_unit_seq, cfg, collect_cache, bp, x, cfg, kinds,
                         positions)
        aux = _add_aux(aux, a)
        if collect_cache:
            seeds.append(c)
    caches = _stack(seeds) if collect_cache else None
    return L.rms_norm(params["final_norm"], x), caches, aux


# ---------------------------------------------------------------------------
# train / serve entry points
# ---------------------------------------------------------------------------

def compute_logits(params, cfg, hidden):
    return L.logits(params["embed"], params.get("head"), hidden, cfg)


def loss_fn(params, cfg, batch):
    """Next-token CE of ``batch`` {"tokens", "targets"} (long tensors on
    the parameters' device; targets of -1 ignored) plus 0.01 x the MoE
    aux loss -> (loss, {"nll", "aux"}), f32 scalars. The CE stays in the
    compute dtype with f32 sums, a chunk of positions at a time
    (:func:`layers.chunked_cross_entropy`)."""
    hidden, _, aux = forward_seq(params, cfg, batch["tokens"])
    w = params["embed"]["table"] if cfg.tie_embeddings else \
        params["head"]["w"]
    loss = L.chunked_cross_entropy(w, hidden, batch["targets"], cfg)
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}


def prefill(params, cfg, tokens):
    """tokens [B, S] -> (last-position logits [B, V], caches)."""
    hidden, caches, _ = forward_seq(params, cfg, tokens, collect_cache=True)
    return compute_logits(params, cfg, hidden[:, -1:, :])[:, 0], caches


def init_cache(cfg, batch, max_len, *, device):
    """The zero decode cache ``decode_step`` consumes, in ``repro``'s
    tree; every leaf has its own memory."""
    ct = getattr(torch, cfg.compute_dtype)

    def one(kind):
        if kind.startswith("attn"):
            return attn_mod.init_kv_cache(cfg, batch, max_len, ct,
                                          device=device)
        if kind == "mamba":
            return mamba_mod.init_mamba_cache(cfg, batch, ct, device=device)
        if kind == "mlstm":
            return xlstm_mod.init_mlstm_cache(cfg, batch, ct, device=device)
        if kind == "slstm":
            return xlstm_mod.init_slstm_cache(cfg, batch, ct, device=device)
        raise ValueError(kind)

    if cfg.layer_pattern == "xlstm":
        return _repeat({key: one(kind) for key, kind in _XLSTM_GROUP},
                       (cfg.n_layers // 4,))
    if cfg.layer_pattern == "local_global":
        return _repeat({key: one(kind) for key, kind in _LOCAL_GLOBAL},
                       (cfg.n_layers // 2,))
    if cfg.layer_pattern == "hybrid_shared_attn":
        groups, tail = _split_hybrid(cfg)
        return {
            "mamba_g": _repeat(one("mamba"),
                               (len(groups), cfg.shared_attn_period)),
            "attn": _repeat(one("attn"), (len(groups),)),
            "mamba_r": _repeat(one("mamba"), (len(tail),)) if tail else None,
        }
    return _repeat(one(layer_kinds(cfg)[0]), (cfg.n_layers,))


def _mixer_decode(bp, cfg, kind, h, cache, pos):
    if kind.startswith("attn"):
        window = cfg.local_window if kind == "attn_local" else None
        return attn_mod.decode_attention(bp, cfg, h, cache, pos,
                                         window=window)
    if kind == "mamba":
        return mamba_mod.mamba_decode_step(bp, cfg, h, cache)
    if kind == "mlstm":
        return xlstm_mod.mlstm_decode_step(bp, cfg, h, cache)
    if kind == "slstm":
        return xlstm_mod.slstm_decode_step(bp, cfg, h, cache)
    raise ValueError(kind)


def block_decode(bp, cfg, kind, x, cache, pos):
    h = L.rms_norm(bp["norm1"], x)
    mix, cache = _mixer_decode(bp["mixer"], cfg, kind, h, cache, pos)
    if cfg.sandwich_norm:
        mix = L.rms_norm(bp["norm1b"], mix)
    x = x + mix
    if _has_ffn(cfg, kind):
        x, _ = _ffn(bp, cfg, x)
    return x, cache


def decode_step(params, cfg, token, cache, pos):
    """token int [B, 1] at absolute position ``pos`` (an int) -> (logits
    [B, 1, V], cache): every layer's cache is updated in place and the
    same tree is returned."""
    ct = getattr(torch, cfg.compute_dtype)
    x = L.embed_lookup(params["embed"], token, ct)

    if cfg.layer_pattern == "hybrid_shared_attn":
        groups, tail = _split_hybrid(cfg)
        for g, grp in enumerate(groups):
            for j, i in enumerate(grp):
                x, _ = block_decode(_layer(params["blocks"], i), cfg, "mamba",
                                    x, _layer(_layer(cache["mamba_g"], g), j),
                                    pos)
            x, _ = block_decode(params["shared_attn"], cfg, "attn", x,
                                _layer(cache["attn"], g), pos)
        for j, i in enumerate(tail):
            x, _ = block_decode(_layer(params["blocks"], i), cfg, "mamba", x,
                                _layer(cache["mamba_r"], j), pos)
    else:
        for u, (bp, kinds) in enumerate(_units(cfg, params["blocks"])):
            cu = _layer(cache, u)
            if isinstance(kinds, str):
                x, _ = block_decode(bp, cfg, kinds, x, cu, pos)
            else:
                for key, kind in kinds:
                    x, _ = block_decode(bp[key], cfg, kind, x, cu[key], pos)
    x = L.rms_norm(params["final_norm"], x)
    return compute_logits(params, cfg, x), cache
