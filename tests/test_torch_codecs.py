"""The port's storage codecs against ``repro``'s, on the same numpy inputs.

Encodings are bit-identical: int8 codes and scales, bf16/f16 tables (held
through their ``uint16`` bits, since the port has no ``ml_dtypes``), PQ
codebooks and codes (dsub 4 and 8, the port's chunked device encode at two
chunk sizes), split neighbor ids. Decoded rows agree to 1e-6; the plain
gather-distance and hop on int8 and PQ tables give bit-identical integers
and distances within 1e-5 of ``repro``'s (sums run in other orders in XLA
and torch). A ``repro``-built codec index carried into the port through
``from_numpy`` answers with recall@10 within 0.01 of ``repro``'s, with and
without the rerank sidecar, at expand_width 1 and 4; the mean top-10 id
agreement is printed (``-s``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BuildConfig as JBuildConfig
from repro.core import RangeGraphIndex as JIndex
from repro.core import SearchConfig as JSearchConfig
from repro.core import StorageConfig as JStorageConfig
from repro.core import recall as jrecall
from repro.core import storage as jstorage
from repro.kernels import ref as jref
from repro_torch import (BuildConfig, RangeGraphIndex, SearchConfig,
                         StorageConfig, recall)
from repro_torch.core import bitset
from repro_torch.core import storage
from repro_torch.kernels import ops, ref

N, D = 1024, 32
CFG = dict(m=8, ef_construction=32, brute_threshold=32)
CODECS = {
    "bf16": ("compact", ("bfloat16",)),
    "f16": ("compact", ("float16",)),
    "int8": ("int8", ()),
    "pq": ("pq", ()),
}


def _cfgs(name):
    meth, args = CODECS[name]
    return (getattr(StorageConfig, meth)(*args),
            getattr(JStorageConfig, meth)(*args))


def _np(leaf):
    """A leaf as comparable numpy: bf16 (either package) as uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        return storage.to_numpy(leaf)
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_table(got, want):
    if want is None:
        assert got is None
        return
    gl = list(got) if isinstance(got, tuple) else [got]
    wl = list(want) if isinstance(want, tuple) else [want]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _fields(j):
    return dict(vectors=j.vectors, attrs=j.attrs, perm=j.perm,
                neighbors=j.neighbors, m=j.m, logn=j.logn,
                build_cfg=dataclasses.asdict(j.build_cfg),
                storage=dataclasses.asdict(j.storage), rerank=j.rerank)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    vectors = rng.standard_normal((N, D)).astype(np.float32)
    vectors[7] = 0.0  # an all-zero row: int8 scale 1.0
    attrs = rng.uniform(0, 100, N)
    return vectors, attrs


@pytest.fixture(scope="module")
def jax_indexes(data):
    vectors, attrs = data
    j32 = JIndex.build(vectors, attrs, JBuildConfig(**CFG),
                       storage=JStorageConfig())
    return {"f32": j32, **{name: j32.astype_storage(_cfgs(name)[1])
                           for name in CODECS}}


# ---------------------------------------------------------------------------
# encodings, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["bf16", "f16", "int8"])
def test_vector_encodings_identical(data, codec):
    vectors, _ = data
    tcfg, jcfg = _cfgs(codec)
    _same_table(storage.encode_vectors(vectors, tcfg),
                jstorage.encode_vectors(vectors, jcfg))
    _same_table(storage.encode_vectors(torch.from_numpy(vectors), tcfg),
                jstorage.encode_vectors(vectors, jcfg))


def test_bf16_rounds_to_nearest_even():
    """Ties, subnormals, infinities: ``Tensor.to(bfloat16)`` is
    ``ml_dtypes``' round-to-nearest-even, bit for bit."""
    bits = np.array([0x3F808000, 0x3F818000, 0x3F80FFFF, 0x00008000,
                     0x00018000, 0x7F7FFFFF, 0xFF800000, 0x80000001,
                     0x7F800000, 0x3F7FFFFF], np.uint32)
    rng = np.random.default_rng(0)
    x = np.concatenate([bits.view(np.float32),
                        rng.standard_normal(4096).astype(np.float32) * 1e3])
    got = storage.to_numpy(torch.from_numpy(x).to(torch.bfloat16))
    want = x.astype(jnp.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(got, want)
    assert storage.np_dtype("bfloat16") == np.uint16


@pytest.mark.parametrize("d,pq_m", [(32, 0), (32, 4), (128, 0)])
@pytest.mark.parametrize("chunk", [100, 4096])
def test_train_pq_identical(d, pq_m, chunk):
    """dsub 4 (auto) and 8 (pq_m=4), and d=128 (M=32): codebook and codes
    equal ``repro``'s, whatever the encode's chunk."""
    rng = np.random.default_rng(d + pq_m)
    centers = rng.standard_normal((16, d)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 16, 3000)]
         + rng.standard_normal((3000, d)).astype(np.float32))
    got = storage.train_pq(x, pq_m, chunk=chunk, sample=1024)
    want = jstorage.train_pq(x, pq_m, sample=1024)
    _same_table(got, want)
    assert got.codebook.shape[2] == (8 if pq_m == 4 else 4)


@pytest.mark.parametrize("dsub", [1, 3, 4, 7, 8, 9, 16, 100, 128, 129, 300])
def test_pq_distance_sum_is_numpys(dsub):
    """The PQ encode's squared-distance sum adds in numpy's ``sum(-1)``
    order for any dsub: bit-identical over values of wide magnitude."""
    rng = np.random.default_rng(dsub)
    x = (rng.standard_normal((4000, dsub))
         * np.exp(rng.uniform(-8, 8, (4000, dsub)))).astype(np.float32)
    t = torch.from_numpy(x)
    got = storage._numpy_sum_last([t[:, i] for i in range(dsub)]).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  x.sum(-1).view(np.uint32))


def test_split_neighbors_identical(jax_indexes):
    j32, j8 = jax_indexes["f32"], jax_indexes["int8"]
    nb = np.asarray(j32.neighbors)
    got = storage.encode_neighbors(nb, N, StorageConfig.int8())
    assert isinstance(got, storage.SplitNeighbors)
    _same_table(got, j8.neighbors)
    dec = storage.decode_neighbors(got)
    assert dec.dtype == torch.int32
    np.testing.assert_array_equal(dec.numpy(), nb)
    # a split table carried from repro decodes the same
    np.testing.assert_array_equal(
        storage.decode_neighbors(storage.as_table(j8.neighbors)).numpy(), nb)


def test_split_rejects_misaligned_edges(jax_indexes):
    nb = np.array(jax_indexes["f32"].neighbors)
    logn = nb.shape[1] - 1
    lay = logn - 2  # a narrow layer: segments of 4 nodes
    nb[5, lay, 0] = 100
    with pytest.raises(ValueError, match=f"layer {lay} has an edge") as ei:
        storage.encode_neighbors(nb, N, StorageConfig.int8())
    with pytest.raises(ValueError) as ej:
        jstorage.encode_neighbors(nb, N, JStorageConfig.int8())
    assert str(ei.value) == str(ej.value)


@pytest.mark.parametrize("codec", list(CODECS))
def test_to_device_moves_every_leaf(jax_indexes, codec):
    """``to_device`` (``repro``'s ``as_device``) keeps the struct type and
    moves every leaf; the struct-safe accessors read it."""
    tt = storage.as_table(jax_indexes[codec].vectors)
    moved = storage.to_device(tt, torch.device("cpu"))
    assert type(moved) is type(tt)
    _same_table(moved, jax_indexes[codec].vectors)
    assert storage.table_device(moved) == torch.device("cpu")
    assert storage.table_n(moved) == N and storage.table_dim(moved) == D
    assert storage.table_nbytes(moved) == jstorage.table_nbytes(
        jax_indexes[codec].vectors)
    assert storage.to_device(None, "cpu") is None


@pytest.mark.parametrize("codec", ["bf16", "int8", "pq"])
def test_decode_rows_matches_jax(jax_indexes, codec):
    jt = jax_indexes[codec].vectors
    tt = storage.as_table(jt)
    ids = np.random.default_rng(1).integers(0, N, (4, 9))
    got = storage.decode_rows(tt, torch.from_numpy(ids)).numpy()
    want = np.asarray(jstorage.decode_rows(jstorage.as_device(jt),
                                           jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    full = storage.decode_vectors(tt).numpy()
    np.testing.assert_allclose(full, jstorage.decode_vectors(jt),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the plain kernels on codec tables
# ---------------------------------------------------------------------------

def _hop_problem(seed=0, B=6, W=3):
    rng = np.random.default_rng(seed)
    u = rng.integers(-1, N, (B, W)).astype(np.int32)
    L = rng.integers(0, N // 2, B).astype(np.int32)
    R = (L + rng.integers(0, N // 2, B)).astype(np.int32)
    exp_ok = rng.uniform(size=(B, W)) < 0.8
    q = rng.standard_normal((B, D)).astype(np.float32)
    return q, u, np.repeat(L, W), np.repeat(R, W), exp_ok


@pytest.mark.parametrize("codec", ["int8", "pq"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ref_gather_dist_matches_jax(jax_indexes, codec, metric):
    jt = jax_indexes[codec].vectors
    q, *_ = _hop_problem()
    ids = np.random.default_rng(2).integers(-1, N, (q.shape[0], 40))
    ids = ids.astype(np.int32)
    got = ops.gather_dist(torch.from_numpy(q), storage.as_table(jt),
                          torch.from_numpy(ids), metric=metric)
    want = np.asarray(jref.gather_dist(jnp.asarray(q), jstorage.as_device(jt),
                                       jnp.asarray(ids), metric=metric))
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("codec", ["int8", "pq"])
def test_ref_hop_matches_jax(jax_indexes, codec):
    j = jax_indexes[codec]
    q, u, Lw, Rw, exp_ok = _hop_problem(seed=3)
    nbrs = storage.as_table(j.neighbors)
    table = storage.as_table(j.vectors)
    vis = bitset.make(q.shape[0], N)
    got = ops.hop(torch.from_numpy(q), table, nbrs, torch.from_numpy(u),
                  torch.from_numpy(Lw), torch.from_numpy(Rw), vis,
                  torch.from_numpy(exp_ok), logn=j.logn, m_out=j.m)
    words = vis.shape[1]
    want = jref.hop(jnp.asarray(q), jstorage.as_device(j.vectors),
                    jstorage.decode_neighbors(jstorage.as_device(j.neighbors)),
                    jnp.asarray(u), jnp.asarray(Lw), jnp.asarray(Rw),
                    jnp.zeros((q.shape[0], words), jnp.uint32),
                    jnp.asarray(exp_ok), logn=j.logn, m_out=j.m)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy().view(np.uint32),
                                  np.asarray(want[3]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("codec", ["int8", "pq"])
def test_ref_prune_takes_codec_tables(jax_indexes, codec):
    """``ops.prune`` on the CPU decodes a codec table as the plain prune
    does over the decoded rows; on CUDA it raises (tests/test_torch_cuda)."""
    jt = jax_indexes[codec].vectors
    tt = storage.as_table(jt)
    rng = np.random.default_rng(4)
    cand = torch.from_numpy(rng.integers(-1, N, (8, 24)).astype(np.int32))
    du = torch.from_numpy(rng.uniform(1, 50, (8, 24)).astype(np.float32))
    got = ops.prune(cand, du, tt, m=8)
    dec = storage.decode_vectors(tt)
    np.testing.assert_array_equal(
        got.numpy(), ref.prune(cand, du, dec, m=8).numpy())


# ---------------------------------------------------------------------------
# the index: re-encode, footprint, search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", list(CODECS))
def test_astype_storage_matches_jax(data, jax_indexes, codec):
    """From ``repro``'s f32 index, the port re-encodes every table to
    ``repro``'s bits; a port-built index re-encodes to the same bytes."""
    vectors, attrs = data
    tcfg, _ = _cfgs(codec)
    j = jax_indexes[codec]
    t = RangeGraphIndex.from_numpy(_fields(jax_indexes["f32"]),
                                   device="cpu").astype_storage(tcfg)
    _same_table(t.vectors, j.vectors)
    _same_table(t.neighbors, j.neighbors)
    _same_table(t.rerank, j.rerank)
    assert t.nbytes == j.nbytes
    built = RangeGraphIndex.build(vectors, attrs, BuildConfig(**CFG),
                                  device="cpu")
    assert built.astype_storage(tcfg).nbytes == j.nbytes
    direct = RangeGraphIndex.build(vectors, attrs, BuildConfig(**CFG),
                                   device="cpu", storage=tcfg)
    assert direct.nbytes == j.nbytes
    assert type(direct.vectors) is type(t.vectors)
    # re-encoding starts from the sidecar when there is one
    if codec == "pq":
        back = t.astype_storage(StorageConfig.int8())
        _same_table(back.vectors, t.rerank)


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(9)
    B = 48
    q = rng.standard_normal((B, D)).astype(np.float32)
    span = rng.integers(16, N, B)
    L = rng.integers(0, N - span + 1).astype(np.int32)
    R = (L + span - 1).astype(np.int32)
    L[:12], R[:12] = 0, N - 1
    return q, L, R


def _agreement(a, b):
    a, b = np.asarray(a), np.asarray(b)
    out = []
    for x, y in zip(a, b):
        xs, ys = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        out.append(len(xs & ys) / len(ys) if ys else float(not xs))
    return float(np.mean(out))


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("codec,rerank", [("int8", 0), ("int8", 48),
                                          ("pq", 0), ("pq", 48)])
def test_codec_search_matches_jax(jax_indexes, queries, codec, rerank, W):
    q, L, R = queries
    j = jax_indexes[codec]
    t = RangeGraphIndex.from_numpy(_fields(j), device="cpu")
    gt, _ = jax_indexes["f32"].brute_force(q, L, R, k=10)
    want = j.search_ranks(q, L, R, k=10, config=JSearchConfig(
        ef=64, expand_width=W, rerank=rerank))
    got = t.search_ranks(q, L, R, k=10, config=SearchConfig(
        ef=64, expand_width=W, rerank=rerank))
    r_j = jrecall(np.asarray(want.ids), gt)
    r_t = recall(got.ids, gt)
    agree = _agreement(got.ids, want.ids)
    print(f"{codec} rerank={rerank} W={W}: recall port {r_t:.4f} "
          f"repro {r_j:.4f}, top-10 id agreement {agree:.4f}")
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
    assert agree >= 0.95
