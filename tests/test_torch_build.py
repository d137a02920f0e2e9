"""The port's index build against the JAX package's, on the CPU.

The same data goes through ``repro``'s build and the port's (plain torch on
``device="cpu"``). Float sums run in other orders, so bit identity is not
required: every layer's per-node edge sets must overlap >= 0.95 on
average, and recall@10 of the two indexes' searches must agree within
0.02. Chunking never changes the built table.
"""
import numpy as np
import pytest
import torch

from repro.core import BuildConfig as JBuildConfig
from repro.core import RangeGraphIndex as JIndex
from repro.core import build as jbuild
from repro.core import recall as jrecall
from repro.data import pipeline as jpipeline
from repro_torch import BuildConfig, RangeGraphIndex, StorageConfig, recall
from repro_torch.core import build as tbuild
from repro_torch.data import make_workload, vector_dataset

N, D = 512, 16
CFG = dict(m=8, ef_construction=32, brute_threshold=32)


@pytest.fixture(scope="module")
def built():
    vectors, attrs, _ = vector_dataset(N, D, seed=0)
    jidx = JIndex.build(vectors, attrs[:, 0], JBuildConfig(**CFG))
    tidx = RangeGraphIndex.build(vectors, attrs[:, 0], BuildConfig(**CFG),
                                 device="cpu")
    return vectors, attrs, jidx, tidx


def _overlap(a, b):
    """Mean per-node Jaccard overlap of two [n, m] edge tables."""
    out = []
    for x, y in zip(a, b):
        xs, ys = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        out.append(len(xs & ys) / len(xs | ys) if xs | ys else 1.0)
    return float(np.mean(out))


def test_edge_overlap_every_layer(built):
    _, _, jidx, tidx = built
    jt = np.asarray(jidx.neighbors)
    tt = tidx.neighbors.numpy()
    assert tt.shape == jt.shape and tt.dtype == np.int32
    np.testing.assert_array_equal(tidx.perm, jidx.perm)
    np.testing.assert_array_equal(tidx.vectors.numpy(),
                                  np.asarray(jidx.vectors))
    for lay in range(jt.shape[1]):
        assert _overlap(tt[:, lay], jt[:, lay]) >= 0.95, lay


def test_recall_matches_jax_built_index(built):
    _, _, jidx, tidx = built
    wl = make_workload(tidx, "mixed", n_queries=96, seed=2)
    gt, _ = jidx.brute_force(wl.queries, wl.L, wl.R, k=10)
    r_j = jrecall(np.asarray(jidx.search_ranks(wl.queries, wl.L, wl.R).ids),
                  gt)
    r_t = recall(tidx.search_ranks(wl.queries, wl.L, wl.R).ids, gt)
    assert abs(r_t - r_j) <= 0.02, (r_t, r_j)
    assert r_t >= 0.9


@pytest.mark.parametrize("chunk", [64, 100])
def test_chunk_does_not_change_the_table(built, chunk):
    vectors, attrs, _, tidx = built
    other = RangeGraphIndex.build(vectors, attrs[:, 0],
                                  BuildConfig(**CFG, chunk=chunk),
                                  device="cpu")
    assert torch.equal(other.neighbors, tidx.neighbors)


def test_pinned_build_backends(built):
    """Pinning the prune and the sibling searches' distances to plain torch
    is what "auto" picks on the CPU; pinning the kernels there raises."""
    vectors, attrs, _, tidx = built
    plain = RangeGraphIndex.build(vectors, attrs[:, 0], BuildConfig(**CFG),
                                  device="cpu", prune_impl="torch",
                                  dist_impl="torch")
    assert torch.equal(plain.neighbors, tidx.neighbors)
    with pytest.raises(RuntimeError, match="CUDA"):
        RangeGraphIndex.build(vectors, attrs[:, 0], BuildConfig(**CFG),
                              device="cpu", dist_impl="cuda")


def test_vector_dataset_labels():
    """``labels=True`` adds each vector's cluster and changes nothing else:
    the arrays equal the JAX package's, and every vector lies nearest the
    mean of its own cluster."""
    vectors, attrs, qv, labels = vector_dataset(4096, D, seed=0, queries=8,
                                                labels=True)
    jv, ja, jq = jpipeline.vector_dataset(4096, D, seed=0, queries=8)
    for got, want in ((vectors, jv), (attrs, ja), (qv, jq)):
        np.testing.assert_array_equal(got, want)
    assert labels.shape == (4096,) and set(labels.tolist()) <= set(range(64))
    means = np.stack([vectors[labels == c].mean(0) for c in range(64)])
    near = ((vectors[:, None, :] - means[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_array_equal(near, labels)


def test_neighbor_storage_int16(built):
    vectors, attrs, _, tidx = built
    small = RangeGraphIndex.build(
        vectors, attrs[:, 0], BuildConfig(**CFG), device="cpu",
        storage=StorageConfig(neighbor_dtype="auto"))
    assert small.neighbors.dtype == torch.int16
    assert torch.equal(small.neighbors.to(torch.int32), tidx.neighbors)
    assert small.nbytes < tidx.nbytes


def test_flat_graph_is_layer_zero(built):
    _, _, _, tidx = built
    flat = tbuild.build_flat_graph(tidx.vectors, BuildConfig(**CFG),
                                   device="cpu")
    assert torch.equal(flat[:, 0], tidx.neighbors[:, 0])


@pytest.mark.parametrize("C,d", [(48, 16), (80, 128), (128, 128),
                                 (4096, 2048)])
def test_auto_chunk_matches_jax(C, d):
    assert tbuild.auto_chunk(C, d) == jbuild.auto_chunk(C, d)
    for cfg_kw in ({}, {"chunk": 300}):
        for floor in (None, 2048):
            assert tbuild.resolve_chunk(BuildConfig(**cfg_kw), C, d,
                                        floor=floor) == \
                jbuild.resolve_chunk(JBuildConfig(**cfg_kw), C, d,
                                     floor=floor)


def test_reverse_pass_matches_jax():
    """The reverse-edge pass alone, on one level of random edges."""
    rng = np.random.default_rng(3)
    n, m, d = 256, 6, 8
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    edges = rng.integers(-1, n, size=(n, m)).astype(np.int32)
    seg_of = (np.arange(n) >> 6).astype(np.int32)  # 64-wide segments
    edges = np.where(seg_of[np.maximum(edges, 0)] == seg_of[:, None],
                     edges, -1).astype(np.int32)
    edges[edges == np.arange(n)[:, None]] = -1
    cfg = JBuildConfig(m=m)
    import jax.numpy as jnp
    want = jbuild._reverse_pass(edges, vectors, jnp.asarray(vectors),
                                seg_of, cfg, chunk=100)
    got = tbuild._reverse_pass(torch.from_numpy(edges),
                               torch.from_numpy(vectors),
                               torch.from_numpy(seg_of), BuildConfig(m=m),
                               chunk=100)
    assert _overlap(got.numpy(), want) >= 0.99
