"""The port's sharded index and serve step (``repro_torch/core/
distributed.py``) held against ``repro/core/distributed.py`` on the CPU.

Shared inputs, made from a seed with numpy, in the settings of
``tests/test_distributed.py``: ``vector_dataset(1000, 16, seed=11)`` over
S = 3 ragged shards (334 rows, the last padded by 2), ``BuildConfig(m=8,
ef_construction=32)``. ``repro``'s tables cross with
``ShardedRangeIndex.from_numpy``. The serve step runs over gloo ranks:
one spawned process a rank with one torch thread, a ``FileStore`` under
``tmp_path`` and a 30 s init timeout, each join bounded. A rank imports
this module, so ``repro`` (and JAX) import in the ``ref`` fixture, not at
the top.
"""
import datetime
import multiprocessing
import queue
import traceback
import types

import numpy as np
import pytest
import torch

from repro_torch.core import (
    BuildConfig,
    SearchConfig,
    ShardedRangeIndex,
    ShardLayout,
    StorageConfig,
    build_sharded,
    merge_topk,
    rfann_serve_step,
    shard_topk,
)
from repro_torch.core import storage as storage_mod
from repro_torch.data import vector_dataset

N, D, S, B, K, EF = 1000, 16, 3, 24, 10, 64
RANK_TIMEOUT_S = 60


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors and many operations: one intra-op thread, so that on
    a loaded host no operation waits at a thread-pool barrier for threads
    the other test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """``repro``'s side: its distributed module, configs and storage."""
    import jax.numpy as jnp

    from repro.core import BuildConfig, RangeGraphIndex, SearchConfig, \
        StorageConfig, recall
    from repro.core import distributed, storage

    return types.SimpleNamespace(
        jnp=jnp, dist=distributed, storage=storage, recall=recall,
        BuildConfig=BuildConfig, RangeGraphIndex=RangeGraphIndex,
        SearchConfig=SearchConfig, StorageConfig=StorageConfig)


@pytest.fixture(scope="module")
def data(ref):
    vectors, attrs, qv = vector_dataset(N, D, seed=11, queries=B)
    rng = np.random.default_rng(0)
    L = rng.integers(0, N // 2, B).astype(np.int32)
    R = (L + rng.integers(64, N // 2, B)).clip(max=N - 1).astype(np.int32)
    order = np.argsort(attrs[:, 0], kind="stable")
    vs = np.asarray(vectors, np.float32)[order]
    # repro's exact in-range top-10 over the globally sorted ranks; the
    # dataclass needs no graph for brute_force
    flat = ref.RangeGraphIndex(
        vectors=vs, attrs=attrs[order, 0], perm=order,
        neighbors=np.zeros((N, 1, 1), np.int32), m=8, logn=0,
        build_cfg=ref.BuildConfig(m=8, ef_construction=32))
    gt, _ = flat.brute_force(qv, L, R, k=K)
    return vectors, attrs[:, 0], qv, L, R, vs, gt


@pytest.fixture(scope="module")
def repro_sharded(ref, data):
    vectors, attrs = data[0], data[1]
    return ref.dist.build_sharded(vectors, attrs, S,
                                  ref.BuildConfig(m=8, ef_construction=32),
                                  storage=ref.StorageConfig())


@pytest.fixture(scope="module")
def port_sharded(data):
    vectors, attrs = data[0], data[1]
    cfg = BuildConfig(m=8, ef_construction=32)
    return {s: build_sharded(vectors, attrs, s, cfg, device="cpu")
            for s in (1, 2, S)}


def _host_serve(sh, qv, L, R, config=None):
    """The mesh-free path: ``shard_topk`` per shard, then ``merge_topk``."""
    config = config or SearchConfig(ef=EF)
    q = torch.as_tensor(qv, dtype=torch.float32)
    Lt, Rt = torch.as_tensor(L), torch.as_tensor(R)
    outs = [shard_topk(*sh.shard(s, "cpu"), q, Lt, Rt, logn=sh.logn,
                       m=sh.m, k=K, config=config)
            for s in range(sh.n_shards)]
    ids, dists = merge_topk(torch.stack([o[0] for o in outs]),
                            torch.stack([o[1] for o in outs]), K)
    return ids.numpy(), dists.numpy()


def _repro_host_serve(ref, sh, qv, L, R):
    """``tests/test_distributed.py``'s mesh-free path on ``repro``."""
    jnp, rdist = ref.jnp, ref.dist
    outs = [rdist.shard_topk(
        jnp.asarray(sh.vectors[s]), jnp.asarray(sh.neighbors[s]),
        jnp.asarray(sh.bounds[s]), jnp.asarray(qv), jnp.asarray(L),
        jnp.asarray(R), logn=sh.logn, m=sh.m, k=K,
        config=ref.SearchConfig(ef=EF)) for s in range(sh.n_shards)]
    ids, dists = rdist.merge_topk(jnp.stack([o[0] for o in outs]),
                                  jnp.stack([o[1] for o in outs]), K)
    return np.asarray(ids), np.asarray(dists)


def _in_range(ids, L, R) -> bool:
    return all(((row[row >= 0] >= lo) & (row[row >= 0] <= hi)).all()
               for row, lo, hi in zip(ids, L, R))


def test_build_sharded_shapes_bounds_padding_match_repro(
        ref, data, repro_sharded, port_sharded):
    """Same cut, same padded rows, same table shapes and dtypes; the
    compact encode of those rows is bit-identical too."""
    got, want = port_sharded[S], repro_sharded
    assert tuple(got.vectors.shape) == want.vectors.shape == (3, 334, D)
    assert tuple(got.neighbors.shape) == want.neighbors.shape
    assert got.logn == want.logn and got.m == want.m == 8
    np.testing.assert_array_equal(got.bounds.numpy(), want.bounds)
    np.testing.assert_array_equal(got.bounds.numpy(),
                                  [[0, 333], [334, 667], [668, 999]])
    # the sorted rows and the padded tail (shard 2's rows 332-333 repeat
    # rank 999) are the same array
    np.testing.assert_array_equal(got.vectors.numpy(), want.vectors)
    np.testing.assert_array_equal(got.vectors[2, 332].numpy(), data[5][999])
    assert got.neighbors.dtype == torch.int32
    assert str(want.neighbors.dtype) == "int32"
    assert got.nbytes == want.nbytes
    assert got.storage == StorageConfig()
    # compact: bf16 rows bit for bit, int16 ids at 334 rows a shard
    compact = build_sharded(data[0], data[1], S,
                            BuildConfig(m=8, ef_construction=32),
                            StorageConfig.compact(), device="cpu")
    want_bf16 = ref.storage.encode_vectors(want.vectors,
                                           ref.StorageConfig.compact())
    np.testing.assert_array_equal(storage_mod.to_numpy(compact.vectors),
                                  want_bf16.view(np.uint16))
    assert compact.neighbors.dtype == torch.int16
    assert compact.storage == StorageConfig.compact()


@pytest.mark.parametrize("case", ["S=0", "S=n+1", "int8", "pq", "split"])
def test_build_sharded_rejects_like_repro(ref, case):
    vectors = np.zeros((8, 4), np.float32)
    attrs = np.arange(8.0)
    n_shards, st = {"S=0": (0, None), "S=n+1": (9, None)}.get(case, (2, case))
    rst = pst = None
    if st == "split":
        rst = ref.StorageConfig(neighbor_dtype="split")
        pst = StorageConfig(neighbor_dtype="split")
    elif st is not None:
        rst = getattr(ref.StorageConfig, st)()
        pst = getattr(StorageConfig, st)()
    with pytest.raises(ValueError) as want:
        ref.dist.build_sharded(vectors, attrs, n_shards, storage=rst)
    with pytest.raises(ValueError) as got:
        build_sharded(vectors, attrs, n_shards, storage=pst, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_topk_bit_identical_to_repro(ref, seed):
    """Ties within and across shards, ``inf`` and -1 padding."""
    rng = np.random.default_rng(seed)
    s, b, k = 4, 16, 10
    ids = rng.integers(0, 5000, (s, b, k)).astype(np.int32)
    dists = np.sort(rng.integers(0, 6, (s, b, k)).astype(np.float32), -1)
    miss = rng.random((s, b, k)) < 0.25
    miss = np.cumsum(miss, -1) > 0          # a missing tail, as searches pad
    ids[miss] = -1
    dists[miss] = np.inf
    want_i, want_d = ref.dist.merge_topk(ref.jnp.asarray(ids),
                                         ref.jnp.asarray(dists), k)
    got_i, got_d = merge_topk(torch.as_tensor(ids), torch.as_tensor(dists), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_per_shard_search_on_repro_tables(ref, data, repro_sharded):
    """``repro``'s tables through the port's mesh-free path: recall@10
    within 0.01 of ``repro``'s against its ``brute_force``, every id in
    range and no padded row."""
    _, _, qv, L, R, _, gt = data
    carried = ShardedRangeIndex.from_numpy(vars(repro_sharded), device="cpu")
    assert carried.storage == StorageConfig()
    got, _ = _host_serve(carried, qv, L, R)
    want, _ = _repro_host_serve(ref, repro_sharded, qv, L, R)
    r_got, r_want = ref.recall(got, gt), ref.recall(want, gt)
    same = float(np.mean([np.array_equal(a, b) for a, b in zip(got, want)]))
    print(f"\nper-shard search on repro's tables: recall@10 port {r_got:.4f},"
          f" repro {r_want:.4f}; ids identical in {same:.3f} of rows")
    assert abs(r_got - r_want) <= 0.01
    assert _in_range(got, L, R) and got.max() <= N - 1


def _tiny_sharded_fields():
    rng = np.random.default_rng(0)
    return {"vectors": rng.standard_normal((2, 8, 4)).astype(np.float32),
            "neighbors": rng.integers(0, 8, (2, 8, 3, 2)).astype(np.int32),
            "bounds": np.array([[0, 8], [8, 16]], np.int32), "logn": 3,
            "m": 2}


def test_from_numpy_without_a_card_or_a_device_raises(monkeypatch):
    """No entry point stays on the CPU unasked: with no card and no
    device given, ``from_numpy`` raises ``resolve_device``'s error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedRangeIndex.from_numpy(_tiny_sharded_fields())


def test_from_numpy_places_the_tables_on_the_device_asked():
    carried = ShardedRangeIndex.from_numpy(_tiny_sharded_fields(),
                                           device="cpu")
    assert {t.device.type for t in (carried.vectors, carried.neighbors,
                                    carried.bounds)} == {"cpu"}
    assert carried.n_shards == 2 and carried.m == 2 and carried.logn == 3
    assert carried.bounds.dtype == torch.int32


def test_from_numpy_takes_bf16_as_uint16_bits(ref, repro_sharded):
    bf16 = ref.storage.encode_vectors(repro_sharded.vectors,
                                      ref.StorageConfig.compact())
    fields = dict(vars(repro_sharded), vectors=bf16, storage=None)
    a = ShardedRangeIndex.from_numpy(fields, device="cpu")
    b = ShardedRangeIndex.from_numpy(
        dict(fields, vectors=np.asarray(bf16).view(np.uint16)), device="cpu")
    assert a.vectors.dtype == b.vectors.dtype == torch.bfloat16
    assert torch.equal(a.vectors.view(torch.int16),
                       b.vectors.view(torch.int16))
    assert a.storage.vector_dtype == "bfloat16"
    assert a.nbytes == bf16.nbytes + repro_sharded.neighbors.nbytes \
        + repro_sharded.bounds.nbytes


def test_compact_ids_equal_decoded_twin():
    """bf16 vectors and int16 ids return the ids and distances of the f32
    twin built from their decoded values (``tests/test_distributed.py``'s
    compact case)."""
    n, d, s, b = 600, 12, 3, 8
    vectors, attrs, qv = vector_dataset(n, d, seed=17, queries=b)
    compact = build_sharded(vectors, attrs[:, 0], s,
                            BuildConfig(m=8, ef_construction=24),
                            StorageConfig.compact(), device="cpu")
    assert compact.vectors.dtype == torch.bfloat16
    assert compact.neighbors.dtype == torch.int16
    twin = ShardedRangeIndex(
        compact.vectors.float(),
        storage_mod.decode_neighbors(compact.neighbors),
        compact.bounds, compact.logn, compact.m)
    rng = np.random.default_rng(1)
    L = rng.integers(0, n // 2, b).astype(np.int32)
    R = (L + rng.integers(32, n // 2, b)).clip(max=n - 1).astype(np.int32)
    cfg = SearchConfig(ef=24)
    ids_c, d_c = _host_serve(compact, qv, L, R, cfg)
    ids_f, d_f = _host_serve(twin, qv, L, R, cfg)
    np.testing.assert_array_equal(ids_c, ids_f)
    np.testing.assert_array_equal(d_c, d_f)


def test_separate_builds_recall(ref, data, port_sharded):
    """The port's own sharded build: recall@10 >= 0.9 and within 0.05 of
    its single-shard build, as ``repro``'s test asks."""
    _, _, qv, L, R, _, gt = data
    ids3, _ = _host_serve(port_sharded[S], qv, L, R)
    ids1, _ = _host_serve(port_sharded[1], qv, L, R)
    r3, r1 = ref.recall(ids3, gt), ref.recall(ids1, gt)
    assert _in_range(ids3, L, R) and ids3.max() <= N - 1
    assert r3 >= 0.9, (r3, r1)
    assert r3 >= r1 - 0.05, (r3, r1)


def test_empty_clips_give_nothing(port_sharded, data):
    """A range that misses a shard returns only -1 / inf from it, and a
    range inside one shard merges to that shard's answer alone."""
    qv = data[2][:4]
    sh = port_sharded[S]
    L = np.array([0, 10, 400, 700], np.int32)
    R = np.array([100, 333, 600, 999], np.int32)
    q = torch.as_tensor(qv)
    ids, dists = shard_topk(*sh.shard(2, "cpu"), q, torch.as_tensor(L),
                            torch.as_tensor(R), logn=sh.logn, m=sh.m, k=K,
                            config=SearchConfig(ef=EF))
    assert (ids[:3] == -1).all() and torch.isinf(dists[:3]).all()
    assert (ids[3] >= 700).all()


def _rank_main(rank, world, root, data, model, logn, m, out):
    """One rank: its own process, one torch thread, gloo over a FileStore.
    Its shard and the queries come from files in ``root``: arguments over
    the spawn pipe's 64 KiB would start the ranks one after another."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(root / "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=30))
        layout = ShardLayout(data, model, device="cpu")
        shard = np.load(root / f"shard{layout.data_rank}.npz")
        batch = np.load(root / "queries.npz")
        vec, nbr, bnd = (torch.from_numpy(shard[f])
                         for f in ("vec", "nbr", "bnd"))
        ids, dists = rfann_serve_step(
            vec, nbr, bnd, batch["q"], batch["L"], batch["R"], layout=layout,
            logn=logn, m=m, k=K, config=SearchConfig(ef=EF))
        refused = []  # raised before any collective, so no rank waits
        for bad in (lambda: ShardLayout(data + 1, model, device="cpu"),
                    lambda: rfann_serve_step(
                        vec, nbr, bnd, batch["q"][:-1], batch["L"][:-1],
                        batch["R"][:-1], layout=layout, logn=logn, m=m, k=K)):
            try:
                bad()
            except ValueError:
                refused.append(True)
        out.put((rank, repr(layout), ids.numpy(), dists.numpy(), None,
                 len(refused)))
    except Exception:
        out.put((rank, None, None, None, traceback.format_exc(), 0))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("layout", [(2, 2), (3, 1)],
                         ids=["data2xmodel2", "data3xmodel1"])
def test_serve_step_over_gloo_ranks(layout, data, port_sharded, tmp_path):
    """Every rank returns the whole [B, k], equal bit for bit to the
    mesh-free path on the same shards; a wrong layout or an odd batch is
    refused."""
    n_data, model = layout
    world = n_data * model
    _, _, qv, L, R, _, _ = data
    sh = port_sharded[n_data]
    for s in range(n_data):
        np.savez(tmp_path / f"shard{s}.npz", **dict(zip(
            ("vec", "nbr", "bnd"), (t.numpy() for t in sh.shard(s, "cpu")))))
    np.savez(tmp_path / "queries.npz", q=qv, L=L, R=R)
    want_i, want_d = _host_serve(sh, qv, L, R)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, tmp_path, n_data, model, sh.logn, sh.m, out))
        for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            rank, lay, ids, dists, err, refused = out.get(
                timeout=RANK_TIMEOUT_S)
            assert err is None, f"rank {rank}:\n{err}"
            got[rank] = (lay, ids, dists, refused)
    except queue.Empty:
        pytest.fail(f"ranks {sorted(set(range(world)) - set(got))} gave no "
                    f"answer within {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    assert not any(p.is_alive() for p in procs)
    for rank, (lay, ids, dists, refused) in sorted(got.items()):
        assert f"-> ({rank // model}, {rank % model})" in lay
        # a layout that does not cover the world; a batch that does not
        # split over the model axis (every batch splits over model=1)
        assert refused == (2 if model > 1 else 1)
        np.testing.assert_array_equal(ids, want_i)
        np.testing.assert_array_equal(dists, want_d)


def test_layout_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        ShardLayout(1, 1, device="cpu")
