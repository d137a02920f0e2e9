"""The model entry point of the port: one ``Model`` per config, whatever
the family (port of ``repro/models/api.py``).

    model = Model(get_arch("gemma2-9b"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    loss, metrics = model.loss(params, batch)  # tokens, targets (+ frames)
    logits, caches = model.prefill(params, tokens=tokens)  # + frames= (encdec)
    cache = model.grow_cache(caches, max_len)
    logits, cache = model.decode(params, token, cache, pos)
    emb = model.embed(params, tokens)   # f32 [B, d_model]: the index's vectors

Every config of ``configs/`` runs: dense and MoE stacks, gemma2's
local/global pairs, zamba2's mamba groups with a shared attention block,
xLSTM and the encoder-decoder. Weights from ``repro`` carry across with
:func:`params_from_numpy`, so both packages compute the same function.
Decode updates the cache in place. ``loss`` is differentiable (train it
with ``train/step.py::build_train_step``); ``prefill``, ``decode`` and
``embed`` serve and run under ``torch.no_grad()``, so parameters that
require grad still go through the flash-attention kernel, which has no
backward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.sharding import partitioning as part

__all__ = ["Model", "count_params", "params_from_numpy", "BatchSpec"]


def _tokens(tokens, dev) -> torch.Tensor:
    """Token ids (numpy or a tensor) as a long tensor on ``dev``."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.as_tensor(np.asarray(tokens))
    return tokens.to(dev, torch.long)


class BatchSpec(NamedTuple):
    """The shape and dtype of one batch entry (no allocation)."""
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    @property
    def is_encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def _mod(self):
        return encdec if self.is_encdec else transformer

    def defs(self):
        return self._mod().defs(self.cfg)

    def init(self, generator: torch.Generator, *, device=None) -> dict:
        """Random parameters (``sharding/partitioning.py::init_params``) in
        ``cfg.param_dtype``, drawn by ``generator`` on its device, which
        must be ``device`` (the card unless ``device="cpu"``)."""
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(f"the generator lives on {generator.device}, "
                             f"the parameters go to {dev}")
        return part.init_params(self.defs(), generator,
                                getattr(torch, self.cfg.param_dtype))

    def abstract(self, mesh=None):
        """The parameter tree as fake tensors in ``cfg.param_dtype`` (no
        memory; ``partitioning.abstract_params``), DTensors on ``mesh``."""
        return part.abstract_params(
            self.defs(), getattr(torch, self.cfg.param_dtype), mesh)

    def param_specs(self, mesh):
        return part.param_specs(self.defs(), mesh)

    def param_shardings(self, mesh):
        return part.named_shardings(self.defs(), mesh)

    def loss(self, params, batch):
        """Differentiable next-token loss of ``batch`` {"tokens",
        "targets"} int [B, S] (and "frames" f32 [B, S_enc, d] for the
        encoder-decoder; numpy or tensors, moved to the parameters'
        device) -> (loss + 0.01 x MoE aux, {"nll", "aux"}), f32
        scalars."""
        dev = params["embed"]["table"].device
        b = {"tokens": _tokens(batch["tokens"], dev),
             "targets": _tokens(batch["targets"], dev)}
        if self.is_encdec:
            b["frames"] = torch.as_tensor(batch["frames"]).to(dev)
        return self._mod().loss_fn(params, self.cfg, b)

    def train_batch_specs(self, batch, seq) -> dict:
        """The entries of a training batch as :class:`BatchSpec`s: int32
        tokens and targets [batch, seq], and for the encoder-decoder
        frames [batch, seq, d_model] in the compute dtype."""
        tok = BatchSpec((batch, seq), torch.int32)
        if self.is_encdec:
            frames = BatchSpec((batch, seq, self.cfg.d_model),
                               getattr(torch, self.cfg.compute_dtype))
            return {"frames": frames, "tokens": tok, "targets": tok}
        return {"tokens": tok, "targets": tok}

    @torch.no_grad()
    def prefill(self, params, **inputs):
        """tokens [B, S] (and frames [B, S_enc, d] for the encoder-decoder)
        -> (last-position logits [B, padded_vocab], the prefill caches)."""
        dev = params["embed"]["table"].device
        tokens = _tokens(inputs["tokens"], dev)
        if self.is_encdec:
            frames = torch.as_tensor(inputs["frames"]).to(dev)
            return encdec.prefill(params, self.cfg, frames, tokens)
        return transformer.prefill(params, self.cfg, tokens)

    @torch.no_grad()
    def decode(self, params, token, cache, pos):
        """token [B, 1] at position ``pos`` -> (logits [B, 1, V], cache),
        the cache updated in place."""
        token = _tokens(token, params["embed"]["table"].device)
        return self._mod().decode_step(params, self.cfg, token, cache, pos)

    def init_cache(self, batch, max_len, *, enc_len=None, device=None):
        """A zero decode cache of ``max_len`` positions on ``device`` (the
        card unless ``device="cpu"``); ``enc_len``: the encoder-decoder's
        cross-cache length (default ``max_len``, as ``repro``'s).
        ``launch/specs.py::cache_shardings`` lays a cache out on a mesh."""
        dev = resolve_device(device)
        if self.is_encdec:
            return encdec.init_cache(self.cfg, batch, max_len, enc_len,
                                     device=dev)
        return transformer.init_cache(self.cfg, batch, max_len, device=dev)

    def cache_specs(self, batch, max_len, *, enc_len=None):
        """The decode cache's leaves as :class:`BatchSpec`s (no memory)."""
        cache = self.init_cache(batch, max_len, enc_len=enc_len,
                                device="meta")
        return part.map_tree(lambda t: BatchSpec(tuple(t.shape), t.dtype),
                             cache)

    def grow_cache(self, caches, max_len):
        """The decode cache of ``max_len`` positions that continues a
        prefill: ``prefill``'s caches copied into a zero cache (K/V rows
        at the front of the position dim, states as they are; the
        encoder-decoder's cross cache kept at the encoder's length)."""
        if self.is_encdec:
            self_c, cross = caches
            lead = self_c["k"]
            out = encdec.init_cache(self.cfg, lead.shape[1], max_len,
                                    cross["k"].shape[3], device=lead.device)
            _copy_into(out["self"], self_c)
            out["cross"] = cross
            return out
        # a leaf stacked on one leading dim: [units, B, ...]
        lead = caches["attn"]["k"] if self.cfg.layer_pattern == \
            "hybrid_shared_attn" else next(part.leaves(caches))[1]
        out = transformer.init_cache(self.cfg, lead.shape[1], max_len,
                                     device=lead.device)
        _copy_into(out, caches)
        return out

    @torch.no_grad()
    def embed(self, params, tokens) -> torch.Tensor:
        """Mean over positions of the f32 final hidden states: tokens int
        [B, S] (numpy or a tensor; moved to the parameters' device) ->
        f32 [B, d_model], the RFANN vectors. Decoder-only families only:
        ``repro``'s embed reads the decoder-only tree, so it has none for
        the encoder-decoder, and neither has the port."""
        if self.is_encdec:
            raise ValueError(f"{self.cfg.name}: embed is defined for "
                             "decoder-only families, not the "
                             "encoder-decoder")
        tokens = _tokens(tokens, params["embed"]["table"].device)
        hidden, _, _ = transformer.forward_seq(params, self.cfg, tokens)
        return hidden.float().mean(dim=1)


def _copy_into(dst, src) -> None:
    """Copy a prefill cache tree into a decode cache tree of the same
    paths: equal shapes whole, K/V into the first positions (dim -2)."""
    if src is None:
        return
    if isinstance(src, dict):
        for key, val in src.items():
            _copy_into(dst[key], val)
        return
    if dst.shape == src.shape:
        dst.copy_(src)
    else:
        dst[..., :src.shape[-2], :].copy_(src)


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameter count from the ParamDef tree (no allocation).
    ``active_only``: MoE expert leaves counted at ``top_k / n_experts``;
    the padded vocab rows are not counted."""
    total = 0
    for _, d in part.leaves(Model(cfg).defs()):
        n = math.prod(d.shape)
        if active_only and "expert" in d.axes and cfg.n_experts:
            n = int(n * cfg.expert_top_k / cfg.n_experts)
        if "vocab" in d.axes and cfg.padded_vocab != cfg.vocab:
            n = int(n * cfg.vocab / cfg.padded_vocab)
        total += n
    return total


def params_from_numpy(model: Model, tree, *, device=None) -> dict:
    """The port's parameters from ``repro``'s tree for the same config,
    given as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
    params)``) -- every family's tree: stacked blocks, the nested stacks
    ``a``/``b`` and ``m0``/``m1``/``m2``/``s``, ``shared_attn``,
    ``enc_blocks``/``dec_blocks`` -- placed on ``device`` (the card unless
    ``device="cpu"``) in ``cfg.param_dtype``. Raises ``ValueError`` when a
    path is missing or extra or a shape differs."""
    dev = resolve_device(device)
    dtype = getattr(torch, model.cfg.param_dtype)
    want = dict(part.leaves(model.defs()))
    got = dict(part.leaves(tree))
    if set(want) != set(got):
        missing = sorted("/".join(p) for p in set(want) - set(got))
        extra = sorted("/".join(p) for p in set(got) - set(want))
        raise ValueError(f"parameter paths differ: missing {missing}, "
                         f"extra {extra}")
    out: dict = {}
    for path, d in want.items():
        a = np.asarray(got[path])
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, expected "
                             f"{d.shape}")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.as_tensor(
            np.array(a, dtype=np.float32)).to(dev, dtype)
    return out
