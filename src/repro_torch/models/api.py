"""The model entry point of the port (port of ``repro/models/api.py::
Model`` for the embed path).

    model = Model(get_arch("qwen3-0.6b"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    emb = model.embed(params, tokens)   # f32 [B, d_model]: the index's vectors

The port runs ``family="dense"`` with ``layer_pattern="global"``; any other
family or pattern raises ``NotImplementedError`` at construction. Weights
from ``repro`` carry across with :func:`params_from_numpy`, so both
packages compute the same function.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.sharding import partitioning as part

__all__ = ["Model", "params_from_numpy"]

_TODO = "ROADMAP queue 1, item 13 (the rest of the LM stack)"


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        cfg = self.cfg
        if cfg.family != "dense" or cfg.layer_pattern != "global":
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} with layer pattern "
                f"{cfg.layer_pattern!r} is not ported; the port runs dense "
                f"models with global attention only ({_TODO})")

    def defs(self):
        return transformer.defs(self.cfg)

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

    def embed(self, params: dict, tokens) -> torch.Tensor:
        """Mean over positions of the f32 final hidden states: tokens int
        [B, S] (numpy or a tensor; moved to the parameters' device) ->
        f32 [B, d_model], the RFANN vectors."""
        dev = params["embed"]["table"].device
        tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens).to(dev, torch.long)
        hidden = transformer.forward_seq(params, self.cfg, tokens)
        return hidden.float().mean(dim=1)


def params_from_numpy(model: Model, tree, *, device=None) -> dict:
    """The port's parameters from ``repro``'s tree for the same config,
    given as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
    params)``), placed on ``device`` (the card unless ``device="cpu"``)
    in ``cfg.param_dtype``. Raises ``ValueError`` when a path is missing
    or extra or a shape differs."""
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

