"""Parameter trees and logical-axis sharding on a ``DeviceMesh`` (port of
``repro/sharding/partitioning.py``).

Every parameter is declared as a ``ParamDef(shape, axes, ...)`` where
``axes`` names each dimension logically ("vocab", "embed", "mlp", ...).
``RULES`` maps logical names to mesh axes, as ``repro``'s do; a dimension
whose size does not divide its mesh axis falls back to replication, and
where a mesh axis is already taken by an earlier dimension of the same
tensor the first one wins.

A spec is a tuple with one entry per dimension: ``None``, a mesh-axis
name, or a tuple of names (``("pod", "data")``), the entries of ``repro``'s
``PartitionSpec``. :func:`placements` turns it into DTensor placements: a
dimension on two axes is ``Shard(d)`` on both mesh dims, the outer axis
first, which is JAX's row-major order. :class:`NamedSharding` pairs a
mesh with a spec and gives the local shard shape.

:func:`constrain` is ``with_sharding_constraint`` by logical names: it
returns its input unchanged outside :func:`use_global_mesh` and for a
plain tensor, and redistributes a DTensor to the spec's placements. So the
meshless path pays nothing. Inside :func:`use_global_mesh` plain tensors
that meet a DTensor (positions, masks, constants) count as replicated.

A mesh here is a ``DeviceMesh`` with named dims, or a mapping of axis name
to size (enough to compute specs and shard shapes without ranks).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Mapping

import torch

__all__ = ["ParamDef", "RULES", "init_params", "leaves", "map_tree",
           "mesh_axes", "logical_to_spec", "placements", "NamedSharding",
           "param_specs", "named_shardings", "abstract_params",
           "use_global_mesh", "replicate_plain", "global_mesh", "constrain",
           "is_dtensor", "from_shard", "local_chunk", "shard_like",
           "shard_tensor", "shard_tree", "full_tree", "grad_as_value",
           "local_linear", "batch_local", "REPLICATED", "note_replicated"]

_GLOBAL_MESH: list = [None]
# regions that compute the same thing on every rank of a mesh axis they
# could have split (a memory cost): description -> times entered
REPLICATED: dict = {}


def note_replicated(region: str) -> None:
    """Count one entry of a replicated region (read by the dry-run)."""
    REPLICATED[region] = REPLICATED.get(region, 0) + 1


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


# logical axis -> mesh axis (or tuple for multi-axis sharding, or None)
RULES: Mapping[str, object] = {
    "vocab": "model",
    "embed": "data",        # FSDP: weight-stationary dim sharded over data
    "embed_tp": "model",    # used where embed is the contracting TP dim
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv": None,
    "expert": "model",
    "layers": None,
    "ssm_state": None,
    "ssm_heads": "model",
    "conv": None,
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "data",    # sequence parallelism for long-context decode
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_expert": "model",
    "act_vocab": "model",
}


def mesh_axes(mesh) -> dict:
    """Axis name -> size, in the mesh's order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_to_spec(axes, mesh, shape=None) -> tuple:
    """Logical axes -> a spec (one entry per dim: None, an axis name or a
    tuple of names), ``repro``'s ``logical_to_spec`` entry for entry."""
    sizes = mesh_axes(mesh)
    out = []
    used: set = set()
    for i, name in enumerate(axes):
        mesh_ax = RULES.get(name) if name is not None else None
        if mesh_ax is None:
            out.append(None)
            continue
        if isinstance(mesh_ax, tuple):
            mesh_ax = tuple(a for a in mesh_ax
                            if a in sizes and a not in used)
            if not mesh_ax:
                out.append(None)
                continue
            size = math.prod(sizes[a] for a in mesh_ax)
            if len(mesh_ax) == 1:
                mesh_ax = mesh_ax[0]
        else:
            if mesh_ax not in sizes or mesh_ax in used:
                out.append(None)
                continue
            size = sizes[mesh_ax]
        if shape is not None and shape[i] % size != 0:
            out.append(None)  # divisibility fallback: replicate
        else:
            out.append(mesh_ax)
            used.update(mesh_ax if isinstance(mesh_ax, tuple)
                        else (mesh_ax,))
    return tuple(out)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that shards dim d, ``Replicate()`` on the others. A dim on several
    axes takes them outer first (row-major, as JAX); another order
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {d} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def _shard_shape(spec, sizes, shape) -> tuple:
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[d] //= sizes[a]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: object
    spec: tuple

    def shard_shape(self, shape) -> tuple:
        """The shape of one rank's shard of a tensor of ``shape``."""
        return _shard_shape(self.spec, mesh_axes(self.mesh), shape)


def map_tree(fn, tree):
    """``fn`` over the leaves of a nested-dict tree; None leaves stay
    None."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def param_specs(defs, mesh):
    """Spec tree matching the ParamDef tree."""
    return map_tree(lambda d: logical_to_spec(d.axes, mesh, d.shape), defs)


def named_shardings(defs, mesh):
    return map_tree(lambda d: NamedSharding(
        mesh, logical_to_spec(d.axes, mesh, d.shape)), defs)


@contextlib.contextmanager
def replicate_plain():
    """Inside, a plain tensor that meets a DTensor counts as replicated
    (DTensor's ``implicit_replication``, which resets its flag on exit:
    so it is entered only where the flag is off)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    if getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
        yield
        return
    with implicit_replication():
        yield


@contextlib.contextmanager
def use_global_mesh(mesh):
    """Make ``mesh`` visible to :func:`constrain`; plain tensors meeting a
    DTensor inside count as replicated."""
    _GLOBAL_MESH.append(mesh)
    try:
        with replicate_plain():
            yield mesh
    finally:
        _GLOBAL_MESH.pop()


def global_mesh():
    return _GLOBAL_MESH[-1]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor on a plain
    path)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *axes):
    """Redistribute the DTensor ``x`` to the placements its logical
    ``axes`` name on the global mesh, and its gradient to the same, as
    JAX constrains a cotangent with its value; ``x`` itself outside a
    mesh and for a plain tensor."""
    mesh = global_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    want = placements(logical_to_spec(axes, mesh, x.shape), mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return grad_as_value(x) if x.requires_grad else x


class _GradAsValue(torch.autograd.Function):
    """Identity; in backward the gradient is redistributed to the
    forward value's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.places = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.places:
            g = g.redistribute(ctx.mesh, ctx.places)
        return g


def grad_as_value(x):
    """``x``, whose gradient is redistributed to ``x``'s own placements
    in backward (a DTensor; a plain tensor as it is)."""
    return _GradAsValue.apply(x) if is_dtensor(x) else x


def local_linear(x, w):
    """x [B, ..., K] @ w [K, N] -> [B, ..., N] on DTensors, each rank's
    product in a ``local_map`` region with placements fixed per mesh
    dim: where x splits its batch, w is gathered (FSDP) and w's gradient
    sums over the batch shards; where w splits N, x is gathered and the
    output splits N (column-parallel, x's gradient summed over the
    slices); where w splits K, x splits K and the output is ``Partial``
    (row-parallel). DTensor's own matmul strategies may instead split
    the flattened (B, S) rows, which its backward cannot contract."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, last = w.device_mesh, x.ndim - 1
    xp, wp, op, gx, gw = [], [], [], [], []
    for xpl, wpl in zip(x.placements, w.placements):
        if xpl == Shard(0):
            row = (Shard(0), Replicate(), Shard(0), Shard(0), Partial())
        elif wpl == Shard(1):
            row = (Replicate(), Shard(1), Shard(last), Partial(), Shard(1))
        elif wpl == Shard(0):
            row = (Shard(last), Shard(0), Partial(), Shard(last), Shard(0))
        else:
            row = (Replicate(),) * 5
        for acc, pl in zip((xp, wp, op, gx, gw), row):
            acc.append(pl)
    return local_map(torch.matmul, out_placements=op, in_placements=(xp, wp),
                     in_grad_placements=(gx, gw), device_mesh=mesh)(
        x.redistribute(mesh, xp), w.redistribute(mesh, wp))


def batch_local(fn, p, x, cache=None, *, state_keys=(), region):
    """``fn(p, x, cache) -> (out, state)`` run on each rank's batch shard
    in a ``local_map`` region, for mixers DTensor has no strategy for (the
    recurrent scans): ``x`` [B, ...] split over its batch's mesh dims only,
    the parameters ``p`` gathered whole (a replicated region where a mesh
    dim of more than one rank does not split the batch: noted as
    ``region``). ``out`` and every leaf of the ``state`` dict come back
    batch-split (its keys ``state_keys``). A ``cache`` dict of DTensors
    [B, ...] is handed over batch-split and written back in place after
    ``fn`` updated it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    bp = [Shard(0) if pl == Shard(0) else Replicate() for pl in x.placements]
    if any(pl == Replicate() and mesh.size(i) > 1 for i, pl in enumerate(bp)):
        note_replicated(region)
    rep = [Replicate()] * mesh.ndim
    grad_rep = [Partial() if pl == Shard(0) else Replicate() for pl in bp]
    x = x.redistribute(mesh, bp)
    paths, ws = zip(*leaves(p))
    ws = [w.redistribute(mesh, rep) for w in ws]
    keys = sorted(cache) if cache is not None else []
    cs = [cache[k].redistribute(mesh, bp) for k in keys]
    out_keys = keys if cache is not None else sorted(state_keys)

    def local(x, *flat):
        tree: dict = {}
        for path, w in zip(paths, flat[:len(paths)]):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = w
        loc = dict(zip(keys, flat[len(paths):])) if cache is not None \
            else None
        out, state = fn(tree, x, loc)
        return (out, *(state[k] for k in out_keys))

    res = local_map(
        local, out_placements=(bp,) * (1 + len(out_keys)),
        in_placements=(bp,) + (rep,) * len(ws) + (bp,) * len(cs),
        in_grad_placements=(bp,) + (grad_rep,) * len(ws) + (bp,) * len(cs),
        device_mesh=mesh)(x, *ws, *cs)
    out, state = res[0], dict(zip(out_keys, res[1:]))
    if cache is None:
        return out, state
    for k in keys:  # the rank-local update, back into the cache's layout
        cache[k].copy_(state[k].redistribute(mesh, cache[k].placements))
    return out, cache


def local_chunk(t: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's shard of ``t`` (which every rank holds whole) under the
    DTensor placements ``places``, mesh dims outer first: a view when it is
    all of ``t``, else a contiguous copy."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    out = t
    for i, pl in enumerate(places):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            out = out.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return out if out is t else out.contiguous()


def shard_like(t: torch.Tensor, template):
    """``t`` (the same global tensor on every rank) as a DTensor on the
    template DTensor's mesh and placements; no collective runs."""
    from torch.distributed.tensor import DTensor

    mesh, places = template.device_mesh, tuple(template.placements)
    return DTensor.from_local(local_chunk(t, mesh, places), mesh, places,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def shard_tensor(t: torch.Tensor, mesh, spec):
    """A DTensor of ``t`` (the same global tensor on every rank) sharded
    by ``spec``; each rank keeps its own chunk and no collective runs."""
    places = placements(spec, mesh)
    return from_shard(local_chunk(t, mesh, places), mesh, spec, t.shape)


def shard_tree(tree, specs, mesh):
    """:func:`shard_tensor` over congruent trees of tensors and specs
    (``leaves`` of ``tree`` that are None stay None)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if tree is None:
        return None
    return shard_tensor(tree, mesh, specs)


def full_tree(tree):
    """Every DTensor leaf of ``tree`` gathered to a plain tensor
    (``full_tensor()``); plain leaves as they are."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(full_tree(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(full_tree(v) for v in tree)
    return tree.full_tensor() if is_dtensor(tree) else tree


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def from_shard(local: torch.Tensor, mesh, spec, shape):
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local`` (laid out by ``spec``)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def abstract_params(defs, dtype=torch.float32, mesh=None):
    """The ParamDef tree as fake tensors, no memory (``repro``'s
    ``ShapeDtypeStruct`` tree): global shapes, or on ``mesh`` DTensors
    whose local tensors are fake shards laid out by :func:`param_specs`.
    Made in the active ``FakeTensorMode``, or in a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = detect_fake_mode() or FakeTensorMode()

    def one(d):
        with mode:
            if mesh is None:
                return torch.empty(d.shape, dtype=dtype)
            spec = logical_to_spec(d.axes, mesh, d.shape)
            local = torch.empty(_shard_shape(spec, mesh_axes(mesh), d.shape),
                                dtype=dtype, device=mesh.device_type)
            return from_shard(local, mesh, spec, d.shape)

    return map_tree(one, defs)


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
