"""Input specs and shardings for every (arch x shape) cell (port of
``repro/launch/specs.py``).

``input_specs(cfg, shape)`` gives a ``BatchSpec`` (shape, dtype) for every
model input, no allocation, and ``input_shardings`` the matching
``NamedSharding``s on a mesh. Decode caches get theirs from leaf-path rules
over the cache tree (attention K/V [..., B, Hkv, S, Dh]: batch over (pod,
data), heads over model, positions over data for the long-context cell,
or over model when the KV heads cannot cover it; SSM and xLSTM states:
batch, then heads or features over model). A mesh is a ``DeviceMesh`` or
a mapping of axis name to size.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.api import BatchSpec, Model
from repro_torch.sharding.partitioning import NamedSharding, mesh_axes

__all__ = ["input_specs", "input_shardings", "cache_shardings"]


def _div(n, size):
    return size > 0 and n % size == 0


def _axsize(mesh, axes):
    sizes = mesh_axes(mesh)
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(sizes[a] for a in axes if a in sizes)


def _maybe(mesh, axes, dim):
    """axes if dim divides the product of their sizes, else None."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in mesh_axes(mesh))
    if not axes:
        return None
    if _div(dim, _axsize(mesh, axes)):
        return axes if len(axes) > 1 else axes[0]
    return None


def input_specs(cfg: ArchConfig, shape: ShapeSpec):
    """A dict of ``BatchSpec``s keyed like the step functions' arguments."""
    model = Model(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": model.train_batch_specs(B, S)}
    if shape.kind == "prefill":
        inputs = {"tokens": BatchSpec((B, S), torch.int32)}
        if model.is_encdec:
            inputs["frames"] = BatchSpec((B, S, cfg.d_model),
                                         getattr(torch, cfg.compute_dtype))
        return {"inputs": inputs}
    # decode: one new token against a cache of seq_len
    return {
        "token": BatchSpec((B, 1), torch.int32),
        "cache": model.cache_specs(B, S),
        "pos": BatchSpec((), torch.int32),
    }


def _with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return None if tree is None else fn(path, tree)


def cache_shardings(cfg: ArchConfig, cache_spec, mesh, batch: int, *,
                    seq_shard: bool):
    """``NamedSharding`` tree for a decode cache (leaves with a ``shape``)
    by leaf-path rules."""
    baxes = _maybe(mesh, batch_axes(mesh), batch)
    seq_ax = "data" if seq_shard else None

    def leaf(names, a):
        shape = tuple(a.shape)
        rank = len(shape)
        spec = [None] * rank
        # batch dim = first occurrence of the batch size past any layer-stack
        # dims (stack dims come first and never equal the prod batch sizes)
        bidx = next((i for i, s in enumerate(shape) if s == batch), None)
        if bidx is None:
            return NamedSharding(mesh, tuple(spec))
        spec[bidx] = baxes
        is_kv = names and names[-1] in ("k", "v")
        if is_kv and rank - bidx >= 4:          # [.., B, Hkv, S, Dh]
            h_ax = _maybe(mesh, "model", shape[bidx + 1])
            spec[bidx + 1] = h_ax
            # positions: explicit for long-context cells, and the fallback
            # when GQA kv-heads cannot cover the model axis (the
            # flash-decode pattern: partial scores + merged softmax stats,
            # instead of a replicated multi-GB cache)
            cands = ([seq_ax] if seq_ax else []) + (
                ["model"] if h_ax is None else []
            )
            for cand in cands:
                ax = _maybe(mesh, cand, shape[bidx + 2])
                if ax is not None:
                    spec[bidx + 2] = ax
                    break
        elif rank - bidx >= 2:                   # states: heads/feature next
            spec[bidx + 1] = _maybe(mesh, "model", shape[bidx + 1])
        return NamedSharding(mesh, tuple(spec))

    return _with_path(leaf, cache_spec)


def input_shardings(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """Shardings congruent with ``input_specs(cfg, shape)``."""
    B = shape.global_batch
    baxes = _maybe(mesh, batch_axes(mesh), B)
    tok_sh = NamedSharding(mesh, (baxes, None))
    frames_sh = NamedSharding(mesh, (baxes, None, None))
    if shape.kind == "train":
        sh = {"tokens": tok_sh, "targets": tok_sh}
        if Model(cfg).is_encdec:
            sh["frames"] = frames_sh
        return {"batch": sh}
    if shape.kind == "prefill":
        sh = {"tokens": tok_sh}
        if Model(cfg).is_encdec:
            sh["frames"] = frames_sh
        return {"inputs": sh}
    seq_shard = shape.name == "long_500k"
    cache_spec = Model(cfg).cache_specs(B, shape.seq_len)
    return {
        "token": tok_sh,
        "cache": cache_shardings(cfg, cache_spec, mesh, B,
                                 seq_shard=seq_shard),
        "pos": NamedSharding(mesh, ()),
    }
