"""Index files between the two packages, and the port's integrity checks.

An index saved by ``repro`` loads in the port with identical arrays and
configs, and the reverse; a flipped bit or a truncated array raises the
port's ``IndexCorruptionError`` naming the field; ``from_numpy`` /
``to_numpy`` round-trip; and what this slice cannot hold yet (the storage
codecs) is refused with ``NotImplementedError``.
"""
import dataclasses
import hashlib

import msgpack
import numpy as np
import pytest
import torch

from repro import compressio as jcompressio
from repro.core import BuildConfig as JBuildConfig
from repro.core import RangeGraphIndex as JIndex
from repro.core import StorageConfig as JStorageConfig
from repro_torch import IndexCorruptionError, RangeGraphIndex, StorageConfig
from repro_torch import compressio


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    rng = np.random.default_rng(5)
    n, d = 128, 8
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    attrs = rng.uniform(0, 10, n)
    jidx = JIndex.build(vectors, attrs,
                        JBuildConfig(m=4, ef_construction=16,
                                     brute_threshold=16),
                        storage=JStorageConfig())
    path = tmp_path_factory.mktemp("io") / "jax_index.bin"
    jidx.save(str(path))
    return jidx, str(path)


def _same(tidx, jidx):
    np.testing.assert_array_equal(tidx.vectors.numpy(),
                                  np.asarray(jidx.vectors))
    np.testing.assert_array_equal(tidx.neighbors.numpy(),
                                  np.asarray(jidx.neighbors))
    np.testing.assert_array_equal(tidx.attrs, jidx.attrs)
    np.testing.assert_array_equal(tidx.perm, jidx.perm)
    assert (tidx.m, tidx.logn) == (jidx.m, jidx.logn)
    assert dataclasses.asdict(tidx.build_cfg) == \
        dataclasses.asdict(jidx.build_cfg)
    assert dataclasses.asdict(tidx.storage) == dataclasses.asdict(jidx.storage)


def test_jax_file_loads_in_the_port(saved):
    jidx, path = saved
    tidx = RangeGraphIndex.load(path, device="cpu")
    _same(tidx, jidx)
    assert tidx.vectors.dtype == torch.float32
    assert tidx.nbytes == jidx.nbytes


def test_port_file_loads_in_jax(saved, tmp_path):
    jidx, path = saved
    tidx = RangeGraphIndex.load(path, device="cpu")
    out = str(tmp_path / "port_index.bin")
    tidx.save(out)
    back = JIndex.load(out)
    _same(tidx, back)


def _payload(path):
    with open(path, "rb") as f:
        outer = msgpack.unpackb(compressio.decompress(f.read()))
    return msgpack.unpackb(outer["payload"])


def _write(path, payload, sha=None):
    raw = msgpack.packb(payload)
    digest = hashlib.sha256(raw).hexdigest() if sha is None else sha
    blob = msgpack.packb({"sha256": digest, "payload": raw})
    with open(path, "wb") as f:
        f.write(jcompressio.compress(blob, level=3))


@pytest.mark.parametrize("field", ["vectors", "neighbors", "attrs", "perm"])
def test_bit_flip_names_the_field(saved, tmp_path, field):
    _, path = saved
    p = _payload(path)
    data = bytearray(p[field]["data"])
    data[len(data) // 2] ^= 0x40
    p[field]["data"] = bytes(data)
    bad = str(tmp_path / f"flip_{field}.bin")
    _write(bad, p)
    with pytest.raises(IndexCorruptionError, match="checksum mismatch") \
            as ei:
        RangeGraphIndex.load(bad, device="cpu")
    assert ei.value.field == field
    assert field in str(ei.value)


def test_truncation_and_envelope(saved, tmp_path):
    _, path = saved
    p = _payload(path)
    p["neighbors"]["data"] = p["neighbors"]["data"][:-8]
    bad = str(tmp_path / "trunc.bin")
    _write(bad, p)
    with pytest.raises(IndexCorruptionError, match="truncated") as ei:
        RangeGraphIndex.load(bad, device="cpu")
    assert ei.value.field == "neighbors"
    _write(bad, _payload(path), sha="0" * 64)
    with pytest.raises(IndexCorruptionError) as ei:
        RangeGraphIndex.load(bad, device="cpu")
    assert ei.value.field == "envelope"
    with open(bad, "wb") as f:
        f.write(b"not an index")
    with pytest.raises(IndexCorruptionError) as ei:
        RangeGraphIndex.load(bad, device="cpu")
    assert ei.value.field == "envelope"
    assert issubclass(IndexCorruptionError, IOError)


def test_from_numpy_to_numpy_round_trip(saved):
    jidx, path = saved
    tidx = RangeGraphIndex.load(path, device="cpu")
    fields = tidx.to_numpy()
    assert set(fields) == {"vectors", "attrs", "perm", "neighbors", "m",
                           "logn", "build_cfg", "storage"}
    assert isinstance(fields["vectors"], np.ndarray)
    again = RangeGraphIndex.from_numpy(fields, device="cpu")
    _same(again, jidx)
    for k, v in again.to_numpy().items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, fields[k])
        else:
            assert v == fields[k]


def test_codecs_are_refused(saved, tmp_path):
    jidx, path = saved
    fields = RangeGraphIndex.load(path, device="cpu").to_numpy()
    with pytest.raises(NotImplementedError, match="codec"):
        RangeGraphIndex.from_numpy(
            {**fields, "storage": {**fields["storage"],
                                   "vector_dtype": "int8"}}, device="cpu")
    with pytest.raises(NotImplementedError, match="codec"):
        StorageConfig(neighbor_dtype="split").check_supported()
    with pytest.raises(NotImplementedError, match="codec"):
        RangeGraphIndex.from_numpy({**fields, "rerank": fields["vectors"]},
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="codec"):
        RangeGraphIndex.from_numpy(
            {**fields, "vectors": fields["vectors"].astype(np.float16)},
            device="cpu")
    int8 = jidx.astype_storage(JStorageConfig.int8())
    out = str(tmp_path / "int8.bin")
    int8.save(out)
    with pytest.raises(NotImplementedError, match="codec"):
        RangeGraphIndex.load(out, device="cpu")


def test_compressio_reads_both_codecs():
    data = b"iRangeGraph" * 100
    assert compressio.decompress(jcompressio.compress(data)) == data
    assert jcompressio.decompress(compressio.compress(data)) == data
    import zlib
    assert compressio.decompress(zlib.compress(data)) == data
