"""Parameter trees: ``ParamDef`` and ``init_params`` (port of
``repro/sharding/partitioning.py:47-56, 134-147``).

The port runs on one card, so there is no mesh, no logical-to-physical
axis rules and no sharding constraint; a ``ParamDef`` keeps its ``axes``
names only so the trees read as ``repro``'s do. A parameter tree is a
nested ``dict`` of tensors with the same paths as ``repro``'s, so weights
map path to path (``models/api.py::params_from_numpy``).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ParamDef", "init_params", "leaves"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple          # logical name (or None) per dim; len == len(shape)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def leaves(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested-dict tree (of ``ParamDef``s or
    of arrays) in sorted-key order, the order ``jax.tree.flatten`` visits
    a dict tree."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for key in sorted(tree):
        yield from leaves(tree[key], prefix + (key,))


def init_params(defs, generator: torch.Generator,
                dtype: torch.dtype = torch.float32):
    """Materialize a tree of ``ParamDef`` on the generator's device:
    ``normal`` draws N(0, 1) * scale from ``generator``, leaf after leaf in
    sorted-key order; ``ones`` / ``zeros`` are constant. The draws are not
    ``jax.random``'s: carry ``repro``'s weights with
    ``models/api.py::params_from_numpy`` where the two must agree."""
    dev = generator.device
    out: dict = {}
    for path, d in leaves(defs):
        if d.init == "zeros":
            a = torch.zeros(d.shape, dtype=dtype, device=dev)
        elif d.init == "ones":
            a = torch.ones(d.shape, dtype=dtype, device=dev)
        else:
            a = torch.randn(d.shape, generator=generator, dtype=dtype,
                            device=dev).mul_(d.scale)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    return out
