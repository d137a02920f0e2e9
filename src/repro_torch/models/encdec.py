"""Encoder-decoder assembly, the seamless-m4t backbone (port of
``repro/models/encdec.py``).

The modality frontend is a stub, as in ``repro``: the encoder takes
precomputed frame embeddings [B, S_enc, d] through a linear adapter, then
bidirectional attention blocks. The decoder is a causal stack with
cross-attention over the encoder output; its K/V come once from
``attention.cross_kv`` (contiguous) and stay as the static cross cache,
while the self-attention cache is updated in place each step. Under
autograd each encoder and decoder block runs through
``transformer._remat`` by ``cfg.remat``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.transformer import _apply, _layer, _remat, \
    _repeat, _stack, _stack_defs
from repro_torch.sharding.partitioning import ParamDef

__all__ = ["defs", "encode", "decode_seq", "loss_fn", "prefill",
           "decode_step", "init_cache"]


def _enc_block_defs(cfg):
    return {
        "norm1": L.rms_norm_def(cfg.d_model),
        "attn": attn_mod.attn_defs(cfg),
        "norm2": L.rms_norm_def(cfg.d_model),
        "ffn": mlp_mod.mlp_defs(cfg),
    }


def _dec_block_defs(cfg):
    return {
        "norm1": L.rms_norm_def(cfg.d_model),
        "self_attn": attn_mod.attn_defs(cfg),
        "norm_x": L.rms_norm_def(cfg.d_model),
        "cross_attn": attn_mod.attn_defs(cfg),
        "norm2": L.rms_norm_def(cfg.d_model),
        "ffn": mlp_mod.mlp_defs(cfg),
    }


def defs(cfg):
    d = cfg.d_model
    return {
        "embed": L.embed_def(cfg.padded_vocab, d),
        "enc_in": ParamDef((d, d), ("embed", None)),  # frame adapter
        "enc_blocks": _stack_defs(_enc_block_defs(cfg), cfg.enc_layers),
        "enc_norm": L.rms_norm_def(d),
        "dec_blocks": _stack_defs(_dec_block_defs(cfg), cfg.n_layers),
        "final_norm": L.rms_norm_def(d),
    }


def _enc_block(bp, x, cfg, positions):
    mix, _ = attn_mod.attention(bp["attn"], cfg, L.rms_norm(bp["norm1"], x),
                                positions, causal=False)
    x = x + mix
    return x + mlp_mod.mlp(bp["ffn"], cfg, L.rms_norm(bp["norm2"], x))


def encode(params, cfg, frames):
    """frames [B, S_enc, d_model] (the stub frontend's output) -> the
    encoder's hidden states in the compute dtype."""
    ct = getattr(torch, cfg.compute_dtype)
    x = L.linear(frames.to(ct), params["enc_in"].to(ct))
    positions = torch.arange(frames.shape[1], device=frames.device)
    block = _remat(_enc_block, cfg)
    for i in range(cfg.enc_layers):
        x = block(_layer(params["enc_blocks"], i), x, cfg, positions)
    return L.rms_norm(params["enc_norm"], x)


def _dec_block_seq(bp, x, cfg, positions, enc_out):
    """One decoder block -> (x', (self K/V, cross K/V), 0.0)."""
    h = L.rms_norm(bp["norm1"], x)
    mix, (k, v) = attn_mod.attention(bp["self_attn"], cfg, h, positions,
                                     causal=True)
    x = x + mix
    hx = L.rms_norm(bp["norm_x"], x)
    ck, cv = attn_mod.cross_kv(bp["cross_attn"], cfg, enc_out)
    cx, _ = attn_mod.attention(bp["cross_attn"], cfg, hx, positions,
                               causal=False, kv=(ck, cv))
    x = x + cx
    x = x + mlp_mod.mlp(bp["ffn"], cfg, L.rms_norm(bp["norm2"], x))
    return x, ({"k": k, "v": v}, {"k": ck, "v": cv}), 0.0


def decode_seq(params, cfg, tokens, enc_out, *, collect_cache=False):
    """tokens [B, S] over enc_out -> (hidden [B, S, d] after the final
    norm; (self caches, cross caches) stacked [L, ...] as ``repro``'s scan
    stacks them, or None)."""
    ct = getattr(torch, cfg.compute_dtype)
    x = L.embed_lookup(params["embed"], tokens, ct)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    sc, cc = [], []
    for i in range(cfg.n_layers):
        x, c, _ = _apply(_dec_block_seq, cfg, collect_cache,
                         _layer(params["dec_blocks"], i), x, cfg, positions,
                         enc_out)
        if collect_cache:
            sc.append(c[0])
            cc.append(c[1])
    caches = (_stack(sc), _stack(cc)) if collect_cache else None
    return L.rms_norm(params["final_norm"], x), caches


def loss_fn(params, cfg, batch):
    """batch {"frames" [B, S_enc, d], "tokens", "targets" [B, S_dec]} ->
    (CE over the tied embedding, {"nll", "aux": 0})."""
    enc_out = encode(params, cfg, batch["frames"])
    hidden, _ = decode_seq(params, cfg, batch["tokens"], enc_out)
    loss = L.chunked_cross_entropy(params["embed"]["table"], hidden,
                                   batch["targets"], cfg)
    return loss, {"nll": loss, "aux": torch.zeros(
        (), dtype=torch.float32, device=hidden.device)}


def prefill(params, cfg, frames, tokens):
    """-> (last-position logits [B, V], (self caches, cross caches))."""
    enc_out = encode(params, cfg, frames)
    hidden, caches = decode_seq(params, cfg, tokens, enc_out,
                                collect_cache=True)
    logits = L.logits(params["embed"], None, hidden[:, -1:, :], cfg)
    return logits[:, 0], caches


def init_cache(cfg, batch, max_len, enc_len=None, *, device):
    """{"self", "cross"}: zero [L, B, Hkv, S, Dh] K/V of ``max_len`` and
    ``enc_len`` (default ``max_len``) positions."""
    ct = getattr(torch, cfg.compute_dtype)
    enc_len = enc_len or max_len
    lead = (cfg.n_layers,)
    return {
        "self": _repeat(attn_mod.init_kv_cache(cfg, batch, max_len, ct,
                                               device=device), lead),
        "cross": _repeat(attn_mod.init_kv_cache(cfg, batch, enc_len, ct,
                                                device=device), lead),
    }


def decode_step(params, cfg, token, cache, pos):
    """One decoder token at ``pos``: the cross cache is static, the self
    cache is written in place -> (logits [B, 1, V], cache)."""
    ct = getattr(torch, cfg.compute_dtype)
    x = L.embed_lookup(params["embed"], token, ct)
    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        mix, _ = attn_mod.decode_attention(
            bp["self_attn"], cfg, L.rms_norm(bp["norm1"], x),
            _layer(cache["self"], i), pos)
        x = x + mix
        cx, _ = attn_mod.decode_attention(
            bp["cross_attn"], cfg, L.rms_norm(bp["norm_x"], x),
            _layer(cache["cross"], i), pos, update=False)
        x = x + cx
        x = x + mlp_mod.mlp(bp["ffn"], cfg, L.rms_norm(bp["norm2"], x))
    x = L.rms_norm(params["final_norm"], x)
    return L.logits(params["embed"], None, x, cfg), cache
