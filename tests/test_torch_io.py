"""Index files between the two packages, and the port's integrity checks.

An index saved by ``repro`` loads in the port with identical arrays and
configs, and the reverse; a flipped bit or a truncated array raises the
port's ``IndexCorruptionError`` naming the field; ``from_numpy`` /
``to_numpy`` round-trip. Codec files (int8, PQ with its int8 sidecar, bf16
with compact ids) cross in both directions with identical arrays, and a
flipped bit in any codec leaf is named. The envelope is packed by the
port's own ``core/msgpack_lite.py``, byte-equal to ``msgpack.packb`` on
index payloads; save and load run with ``msgpack``, ``zstandard`` and
``ml_dtypes`` blocked, as on the card's machine.
"""
import dataclasses
import hashlib
import os
import pathlib
import subprocess
import sys

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
from repro_torch.core import msgpack_lite
from repro_torch.core import storage

ROOT = pathlib.Path(__file__).resolve().parents[1]


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
                           "logn", "build_cfg", "storage", "rerank"}
    assert fields["rerank"] is None
    assert isinstance(fields["vectors"], np.ndarray)
    again = RangeGraphIndex.from_numpy(fields, device="cpu")
    _same(again, jidx)
    for k, v in again.to_numpy().items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, fields[k])
        else:
            assert v == fields[k]


CODECS = {
    "int8": JStorageConfig.int8(),
    "pq": JStorageConfig.pq(),
    "bf16": JStorageConfig.compact("bfloat16"),
}


@pytest.fixture(scope="module")
def codec_files(saved, tmp_path_factory):
    """``repro``'s index under each codec, and its file."""
    jidx, _ = saved
    d = tmp_path_factory.mktemp("codec_io")
    out = {}
    for name, cfg in CODECS.items():
        j = jidx.astype_storage(cfg)
        path = str(d / f"jax_{name}.bin")
        j.save(path)
        out[name] = (j, path)
    return out


def _leaves(t):
    if t is None:
        return []
    return list(t) if isinstance(t, tuple) else [t]


def _bits(a):
    a = storage.to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_codec(tidx, jidx):
    for name in ("vectors", "neighbors", "rerank"):
        got, want = getattr(tidx, name), getattr(jidx, name)
        assert type(got).__name__ == type(want).__name__ or (
            isinstance(got, torch.Tensor) and isinstance(want, np.ndarray))
        for g, w in zip(_leaves(got), _leaves(want), strict=True):
            g, w = _bits(g), _bits(w)
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tidx.attrs, jidx.attrs)
    np.testing.assert_array_equal(tidx.perm, jidx.perm)
    assert dataclasses.asdict(tidx.storage) == dataclasses.asdict(jidx.storage)
    assert tidx.nbytes == jidx.nbytes


@pytest.mark.parametrize("codec", list(CODECS))
def test_codec_file_jax_to_port(codec_files, codec):
    jidx, path = codec_files[codec]
    _same_codec(RangeGraphIndex.load(path, device="cpu"), jidx)


@pytest.mark.parametrize("codec", list(CODECS))
def test_codec_file_port_to_jax(codec_files, tmp_path, codec):
    jidx, path = codec_files[codec]
    out = str(tmp_path / f"port_{codec}.bin")
    RangeGraphIndex.load(path, device="cpu").save(out)
    _same_codec(RangeGraphIndex.load(out, device="cpu"), JIndex.load(out))
    _same_codec(RangeGraphIndex.load(out, device="cpu"), jidx)


def test_port_encoded_file_loads_in_jax(saved, tmp_path):
    """An index the port re-encodes itself (split ids, PQ + int8 sidecar)
    loads in ``repro`` with ``repro``'s own encoding of the same table."""
    jidx, path = saved
    tidx = RangeGraphIndex.load(path, device="cpu").astype_storage(
        StorageConfig.pq())
    out = str(tmp_path / "port_pq.bin")
    tidx.save(out)
    _same_codec(tidx, JIndex.load(out))
    _same_codec(tidx, jidx.astype_storage(JStorageConfig.pq()))


@pytest.mark.parametrize("codec,field", [
    ("int8", "vec_scales"), ("pq", "vec_codebook"), ("int8", "neighbors_lo"),
    ("pq", "rerank"), ("pq", "rerank_scales")])
def test_bit_flip_names_the_codec_field(codec_files, tmp_path, codec, field):
    _, path = codec_files[codec]
    p = _payload(path)
    data = bytearray(p[field]["data"])
    data[len(data) // 2] ^= 0x10
    p[field]["data"] = bytes(data)
    bad = str(tmp_path / f"flip_{field}.bin")
    _write(bad, p)
    with pytest.raises(IndexCorruptionError, match="checksum mismatch") \
            as ei:
        RangeGraphIndex.load(bad, device="cpu")
    assert ei.value.field == field


def _index_payloads(saved, codec_files):
    """The payloads the index writes: each file's inner map and envelope,
    and the port's own payload of the same index."""
    out = []
    for path in [saved[1]] + [p for _, p in codec_files.values()]:
        with open(path, "rb") as f:
            outer = msgpack.unpackb(compressio.decompress(f.read()))
        out += [outer, msgpack.unpackb(outer["payload"])]
    return out


def test_msgpack_lite_is_byte_equal(saved, codec_files):
    for obj in _index_payloads(saved, codec_files):
        raw = msgpack.packb(obj)
        assert msgpack_lite.packb(obj) == raw
        assert msgpack_lite.unpackb(raw) == msgpack.unpackb(raw)
    edge = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536,
            2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768,
            -32769, -2**31, -2**31 - 1, -2**63, 1.5, -0.0, "", "a" * 31,
            "a" * 32, "a" * 256, "é" * 40, b"", b"x" * 256, b"y" * 70000,
            [1] * 15, [1] * 16, (1, "a"), {str(i): i for i in range(16)},
            {"nest": {"d": [1.0, None, b"zz"]}}]
    for obj in edge:
        raw = msgpack.packb(obj)
        assert msgpack_lite.packb(obj) == raw, obj
        assert msgpack_lite.unpackb(raw) == msgpack.unpackb(raw)


def test_msgpack_lite_rejects_outside_the_subset():
    for obj in (object(), {1, 2}, 1j, np.int64(3), 2**64):
        with pytest.raises((TypeError, ValueError)):
            msgpack_lite.packb(obj)
    for raw in (b"\xc1", b"\x92\x01", b"\x01\x02", msgpack.packb({1: 2}),
                b"\xd4\x01\x02", b"\xa3\xff\xfe\xfd"):
        with pytest.raises(ValueError):
            msgpack_lite.unpackb(raw)


def test_save_load_with_codec_packages_blocked(codec_files, tmp_path):
    """The card's machine has no msgpack, zstandard or ml_dtypes: a zlib
    codec file round-trips there, and a zstd one raises RuntimeError."""
    _, path = codec_files["pq"]
    zlib_path = str(tmp_path / "pq_zlib.bin")
    with open(path, "rb") as f:
        blob = compressio.decompress(f.read())
    import zlib
    with open(zlib_path, "wb") as f:
        f.write(zlib.compress(blob, 3))
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro', 'msgpack', 'zstandard',"
        " 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from repro_torch import RangeGraphIndex, StorageConfig\n"
        "from repro_torch.core import storage\n"
        f"idx = RangeGraphIndex.load({zlib_path!r}, device='cpu')\n"
        "assert isinstance(idx.vectors, storage.PQVectors)\n"
        "bf = idx.astype_storage(StorageConfig.compact())\n"
        f"out = {str(tmp_path / 'again.bin')!r}\n"
        "for t in (idx, bf):\n"
        "    t.save(out)\n"
        "    back = RangeGraphIndex.load(out, device='cpu')\n"
        "    a, b = t.to_numpy(), back.to_numpy()\n"
        "    for k in ('vectors', 'neighbors', 'rerank'):\n"
        "        if a[k] is None:\n"
        "            assert b[k] is None\n"
        "            continue\n"
        "        for x, y in zip(*(v if isinstance(v, tuple) else (v,)\n"
        "                          for v in (a[k], b[k]))):\n"
        "            assert x.dtype == y.dtype\n"
        "            assert np.array_equal(x, y)\n"
        "assert bf.vectors.dtype == torch.bfloat16\n"
        "try:\n"
        f"    RangeGraphIndex.load({path!r}, device='cpu')\n"
        "except RuntimeError as e:\n"
        "    assert 'zstandard' in str(e)\n"
        "else:\n"
        "    raise AssertionError('a zstd file loaded without zstandard')\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_compressio_reads_both_codecs():
    data = b"iRangeGraph" * 100
    assert compressio.decompress(jcompressio.compress(data)) == data
    assert jcompressio.decompress(compressio.compress(data)) == data
    import zlib
    assert compressio.decompress(zlib.compress(data)) == data
