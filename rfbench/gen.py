"""Deployment data and request pools, drawn from the seed on the device.

One general generator reads every deployment and traffic file:

  * vectors: a Gaussian mixture, ``n_clusters`` centres of scale 2 and unit
    noise (the recipe of the repository's ``vector_dataset``);
  * attributes: ``uniform`` on [0, 1e6), or ``clustered``, cluster x 1000
    + U(0, 1000), so an attribute range selects few clusters;
  * queries: the data's own centres plus fresh unit noise;
  * ranges: drawn in rank space from this module's own sort of the
    attributes, a span of ``max(n >> i, min_span)`` at a uniform start, then
    turned into value bounds.

The clients send the pool in order, ``clients`` requests a flush, so each
such block is one batch. Every block holds the same multiset of levels
``i`` (each level of ``[i_min, i_max]`` in turn) and of query clusters,
each in its own order: a seed changes where the work is, not how much of
it there is, and a batch's slowest query is drawn from the same mix in
every block.

Everything is drawn by one ``torch.Generator`` on ``device``, in a few
large calls.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Data:
    vectors: torch.Tensor   # f32 [n, d], original order
    attrs: torch.Tensor     # f64 [n]
    centers: torch.Tensor   # f32 [n_clusters, d]
    order: torch.Tensor     # int64 [n]: original id of rank r (stable sort)
    rank_of: torch.Tensor   # int64 [n]: rank of original id
    sorted_attrs: torch.Tensor  # f64 [n]


@dataclasses.dataclass
class Pool:
    q: torch.Tensor         # f32 [P, d]
    L: torch.Tensor         # int64 [P], inclusive rank range
    R: torch.Tensor
    lo: torch.Tensor        # f64 [P], inclusive value range
    hi: torch.Tensor
    level: torch.Tensor     # int64 [P]: the range is n >> level wide


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2**63 - 1))
    return g


def make_data(dep: dict, g: torch.Generator, device) -> Data:
    n, d, c = int(dep["n"]), int(dep["d"]), int(dep["n_clusters"])
    centers = torch.randn(c, d, generator=g, device=device) * 2.0
    assign = torch.randint(0, c, (n,), generator=g, device=device)
    vectors = torch.randn(n, d, generator=g, device=device)
    vectors += centers[assign]
    u = torch.rand(n, dtype=torch.float64, generator=g, device=device)
    kind = dep["attr_kind"]
    if kind == "uniform":
        attrs = u * 1e6
    elif kind == "clustered":
        attrs = assign.double() * 1000.0 + u * 1000.0
    else:
        raise ValueError(f"unknown attr_kind {kind!r}")
    sorted_attrs, order = torch.sort(attrs, stable=True)
    rank_of = torch.empty_like(order)
    rank_of[order] = torch.arange(n, device=device)
    return Data(vectors, attrs, centers, order, rank_of, sorted_attrs)


def _balanced(values: int, rows: int, width: int, g, dev) -> torch.Tensor:
    """``[rows * width]``: each row holds ``0 .. values-1`` in turn,
    ``width`` long, in its own random order, so every row (and every seed)
    has the same multiset."""
    base = torch.arange(width, device=dev) % values
    order = torch.rand(rows, width, generator=g, device=dev).argsort(dim=1)
    return base[order].reshape(-1)


def make_pool(data: Data, traffic: dict, g: torch.Generator) -> Pool:
    dev = data.vectors.device
    n, d = data.vectors.shape
    P, B = int(traffic["pool"]), int(traffic["clients"])
    if P % B:
        raise ValueError(f"pool {P} is not a whole number of {B} clients")
    rng = traffic["ranges"]
    i_min, i_max = int(rng["i_min"]), int(rng["i_max"])
    levels = _balanced(i_max - i_min + 1, P // B, B, g, dev) + i_min
    span = torch.clamp(torch.div(n, 2 ** levels, rounding_mode="floor"),
                       min=int(rng["min_span"]), max=n)
    start = (torch.rand(P, dtype=torch.float64, generator=g, device=dev)
             * (n - span + 1)).floor().long()
    L, R = start, start + span - 1
    qa = _balanced(data.centers.shape[0], P // B, B, g, dev)
    q = torch.randn(P, d, generator=g, device=dev)
    q += data.centers[qa]
    return Pool(q, L, R, data.sorted_attrs[L], data.sorted_attrs[R], levels)


def make(dep: dict, traffic: dict, seed: int, device) -> tuple[Data, Pool]:
    """The deployment's data and the traffic's request pool for ``seed``."""
    g = generator(seed, device)
    data = make_data(dep, g, device)
    return data, make_pool(data, traffic, g)
