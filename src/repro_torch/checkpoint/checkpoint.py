"""Fault-tolerant checkpoints: msgpack + zstd or zlib, atomic, sha256
checksummed, newest K kept (port of ``repro/checkpoint/checkpoint.py``).

A file holds ``repro``'s msgpack byte for byte: the compressed msgpack of
``{"sha256": hex, "payload": raw}``, ``raw`` the msgpack of
``{"treedef", "leaves": [{"dtype", "shape", "data"}], "step", "extra"}``
with the leaves in ``jax.tree_util`` order (dict keys sorted; tuples,
lists and NamedTuples in order; None holds no leaf) and each leaf's bytes
little-endian. So a file ``repro`` wrote restores here and one written
here restores in ``repro``. bf16 leaves keep ``repro``'s dtype string
``"bfloat16"`` (there through ``ml_dtypes``; here the bytes are read and
written as uint16 and viewed as ``torch.bfloat16``). ``"treedef"`` is
written for the reader's eye and never read back.

One extension: msgpack's bin holds at most 4 GiB, so a payload past that
(qwen3-0.6b's parameters with their AdamW moments come to 7.2 GB) is
stored as a list of bins of at most 1 GiB, hashed as their concatenation;
``repro`` can write no such file and cannot read one.

Writes stream: each leaf is copied to the host once, hashed, then
compressed and written in slices to ``<dir>/step_<n>.ckpt.tmp``, synced
and renamed over ``step_<n>.ckpt``, so a preemption mid-write never
leaves a torn checkpoint. At level 0 (``RTORCH_COMPRESS_LEVEL=0``) with
zlib (the card's machine has no ``zstandard``) the stream is zlib's
stored blocks, written in one pass
with the hash, the adler32 and the write on three threads and no
compressor in the way; reads map the file and copy the stored blocks out
without zlib. ``restore`` places each leaf on the
device of the template's leaf (or on ``device``), with the template's
``requires_grad``, and a leaf whose template is a DTensor goes back onto
its mesh. A DTensor leaf is saved whole (``full_tensor()``), so a
checkpoint written on a mesh is the file written without one; in a
process group of several ranks rank 0 writes it. ``latest_step`` scans
the directory so a crashed run resumes without a side database.
"""
from __future__ import annotations

import hashlib
import mmap
import os
import re
import struct
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import compressio
from repro_torch.core import msgpack_lite
from repro_torch.sharding import partitioning as part

__all__ = ["save", "restore", "latest_step", "gc_old", "tree_flatten",
           "tree_unflatten"]

_NAME = re.compile(r"step_(\d+)\.ckpt$")
_BIN_MAX = 2**32 - 1            # msgpack's longest bin
_PART = 2**30                    # the parts of a longer payload
_SLICE = 64 * 2**20              # bytes handed to the compressor at a time
_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
           torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}


def tree_flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util`` order."""
    out: list = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (tuple, list)):
            for x in t:
                walk(x)
        elif t is not None:
            out.append(t)

    walk(tree)
    return out


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` in
    :func:`tree_flatten`'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(x) for x in t])
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _treedef(t) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(t))`` spells
    it for dicts, tuples, lists and NamedTuples (stored, never read
    back)."""
    if isinstance(t, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(t[k])}"
                               for k in sorted(t)) + "}"
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return f"CustomNode(namedtuple[{type(t).__name__}], [" + ", ".join(
            _treedef(x) for x in t) + "])"
    if isinstance(t, (tuple, list)):
        body = ", ".join(_treedef(x) for x in t)
        return f"({body}{',' if len(t) == 1 else ''})" \
            if isinstance(t, tuple) else f"[{body}]"
    return "None" if t is None else "*"


def _leaf(a):
    """(dtype string, shape, nbytes, a function giving a host view of the
    bytes) of one leaf; the copy to the host happens when it is called."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if t.dtype not in _DTYPES:
            raise TypeError(f"checkpoint: no dtype string for {t.dtype}")

        def host():
            h = t.contiguous().cpu().reshape(-1)
            return memoryview(h.view(torch.uint8).numpy()) if h.numel() \
                else memoryview(b"")

        return (_DTYPES[t.dtype], list(t.shape),
                t.numel() * t.element_size(), host)
    arr = np.asarray(a)
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    return (str(arr.dtype), list(arr.shape), arr.nbytes,
            lambda: memoryview(arr.reshape(-1).view(np.uint8)))


def _payload(tree, step, extra) -> list:
    """The payload's msgpack, as ``msgpack.packb`` writes ``{"treedef",
    "leaves": [{"dtype", "shape", "data"}], "step", "extra"}``: a list of
    byte fragments and, where each leaf's bytes go, ``(nbytes, host)``."""
    leaves = [_leaf(a) for a in tree_flatten(tree)]
    pk = msgpack_lite.packb
    items = [msgpack_lite.map_header(4) + pk("treedef")
             + pk("PyTreeDef(" + _treedef(tree) + ")") + pk("leaves")
             + msgpack_lite.array_header(len(leaves))]
    for dtype, shape, nbytes, host in leaves:
        items.append(msgpack_lite.map_header(3) + pk("dtype") + pk(dtype)
                     + pk("shape") + pk(shape) + pk("data")
                     + msgpack_lite.bin_header(nbytes))
        items.append((nbytes, host))
    items.append(pk("step") + pk(int(step)) + pk("extra") + pk(extra or {}))
    return items


def _body(items, total):
    """The outer map's payload value, lazily: ``(view, hashed)`` pairs,
    the payload's own bytes hashed, the bin headers around them not. One
    bin when the payload fits, else an array of bins of ``_PART``."""
    views = (memoryview(it).cast("B") if isinstance(it, bytes)
             else it[1]() for it in items)
    if total <= _BIN_MAX:
        yield memoryview(msgpack_lite.bin_header(total)), False
        for v in views:
            yield v, True
        return
    yield memoryview(msgpack_lite.array_header(-(-total // _PART))), False
    room = 0
    for v in views:
        while len(v):
            if room == 0:
                room = min(_PART, total)
                total -= room
                yield memoryview(msgpack_lite.bin_header(room)), False
            take = min(room, len(v))
            yield v[:take], True
            v, room = v[take:], room - take


def _head(digest: str) -> bytes:
    """The outer map up to its payload value."""
    pk = msgpack_lite.packb
    return msgpack_lite.map_header(2) + pk("sha256") + pk(digest) \
        + pk("payload")


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         extra=None) -> str:
    """Atomic checkpoint write of ``tree`` (tensors, numpy arrays and
    Python numbers in dicts, tuples, lists and NamedTuples) as
    ``<ckpt_dir>/step_<step>.ckpt``, then only the newest ``keep`` kept.
    ``extra``: a small dict of metadata. The compression level is the
    ``RTORCH_COMPRESS_LEVEL`` knob (3 when unset, ``repro``'s level).
    Returns the file's path.

    At level 0 where zlib is the codec (no ``zstandard``), the file is a
    zlib stream of stored blocks written in one pass: each leaf is copied
    to the host while the earlier ones are hashed, checksummed (adler32)
    and written on three threads, and the digest goes into its place at
    the end. Otherwise two passes: hash, then compress and write."""
    tree = part.full_tree(tree)     # a DTensor leaf is saved whole
    final = os.path.join(ckpt_dir, f"step_{step}.ckpt")
    if _rank() != 0:                # rank 0 of a process group writes
        _barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    items = _payload(tree, step, extra)
    total = sum(len(it) if isinstance(it, bytes) else it[0]
                for it in items)
    tmp = final + ".tmp"
    if compressio.level_of(None) == 0 and compressio.codec() == "zlib":
        _write_stored(tmp, items, total)
    else:
        _write_compressed(tmp, items, total)
    os.replace(tmp, final)
    gc_old(ckpt_dir, keep=keep)
    _barrier()
    return final


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    """Every rank of a process group of more than one waits here, so no
    rank reads a checkpoint before rank 0 has written it."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _write_compressed(path, items, total) -> None:
    body = list(_body(items, total))
    digest = hashlib.sha256()
    for v, hashed in body:
        if hashed:
            digest.update(v)
    body = [memoryview(_head(digest.hexdigest()))] + [v for v, _ in body]
    comp = compressio.compressor(sum(len(v) for v in body))
    with open(path, "wb") as f:
        for v in body:
            for off in range(0, len(v), _SLICE):
                f.write(comp.compress(v[off:off + _SLICE]))
        f.write(comp.flush())
        f.flush()
        os.fsync(f.fileno())


_STORED = 65535                 # bytes a stored deflate block holds
_ZLIB_HEAD = b"\x78\x01"        # deflate, 32 KiB window, no dictionary
# where the digest's 64 hex digits sit in a stored file: the zlib header,
# the first block's header, then the outer map's head
_DIGEST_IN_HEAD = len(msgpack_lite.map_header(2)
                      + msgpack_lite.packb("sha256")) + 2
_DIGEST_AT = len(_ZLIB_HEAD) + 5 + _DIGEST_IN_HEAD


def _adler32_combine(a1: int, a2: int, len2: int) -> int:
    """adler32 of A + B from adler32(A), adler32(B) and len(B) (zlib's
    ``adler32_combine``)."""
    base = 65521
    rem = len2 % base
    s1 = a1 & 0xFFFF
    s2 = (rem * s1) % base
    s1 = (s1 + (a2 & 0xFFFF) + base - 1) % base
    s2 = (s2 + ((a1 >> 16) & 0xFFFF) + ((a2 >> 16) & 0xFFFF) + base
          - rem) % base
    return s1 | (s2 << 16)


def _stored_blocks(fd, view) -> None:
    """Write ``view`` as stored deflate blocks, none final (``os.writev``,
    512 blocks a call)."""
    iov = []
    for off in range(0, len(view), _STORED):
        n = min(_STORED, len(view) - off)
        iov += [struct.pack("<BHH", 0, n, n ^ 0xFFFF), view[off:off + n]]
        if len(iov) >= 1024:
            _writev(fd, iov)
            iov = []
    if iov:
        _writev(fd, iov)


def _writev(fd, iov) -> None:
    done = os.writev(fd, iov)
    if done != sum(len(v) for v in iov):   # short: finish it plainly
        rest = b"".join(bytes(v) for v in iov)[done:]
        while rest:
            rest = rest[os.write(fd, rest):]


def _write_stored(path, items, total) -> None:
    hasher, summer, writer = (ThreadPoolExecutor(1) for _ in range(3))
    digest = hashlib.sha256()
    adler = [1, 0]              # the body's adler32 and length
    pending = []
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        def add(v):
            adler[0] = zlib.adler32(v, adler[0])
            adler[1] += len(v)

        def emit(v):
            pending.append(summer.submit(add, v))
            pending.append(writer.submit(_stored_blocks, fd, v))

        os.write(fd, _ZLIB_HEAD)
        _stored_blocks(fd, memoryview(_head("0" * 64)))
        small = bytearray()     # the payload's fragments, coalesced
        for v, hashed in _body(items, total):
            if hashed:
                pending.append(hasher.submit(digest.update, v))
                if len(v) < _STORED:
                    small += v
                    continue
            if small:
                emit(memoryview(bytes(small)))
                small.clear()
            for off in range(0, len(v), _SLICE):
                emit(v[off:off + _SLICE])
        if small:
            emit(memoryview(bytes(small)))
        for f in pending:
            f.result()
        head = _head(digest.hexdigest())
        whole = _adler32_combine(zlib.adler32(head), adler[0], adler[1])
        os.write(fd, b"\x01\x00\x00\xff\xff" + struct.pack(">I", whole))
        os.pwrite(fd, head[_DIGEST_IN_HEAD:_DIGEST_IN_HEAD + 64],
                  _DIGEST_AT)
        os.fsync(fd)
    finally:
        os.close(fd)
        for lane in (hasher, summer, writer):
            lane.shutdown()


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := _NAME.search(f))]
    return max(steps) if steps else None


def gc_old(ckpt_dir: str, *, keep: int = 3) -> None:
    steps = sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                   if (m := _NAME.search(f)))
    for s in steps[:-keep]:
        try:
            os.remove(os.path.join(ckpt_dir, f"step_{s}.ckpt"))
        except OSError:
            pass


def _unstore(data: memoryview) -> bytearray | None:
    """The bytes of a zlib stream made only of stored blocks (what
    ``save`` writes at level 0), copied out block by block; None for any
    other stream (zstd, or compressed blocks), which ``decompress``
    reads. The adler32 trailer is not checked: the payload's sha256 is."""
    if len(data) < 7 or bytes(data[:2]) != _ZLIB_HEAD:
        return None
    spans, pos, n_all = [], 2, 0
    while True:
        if pos + 5 > len(data) or data[pos] & ~1:
            return None
        n, nn = struct.unpack_from("<HH", data, pos + 1)
        if n ^ nn != 0xFFFF or pos + 5 + n > len(data):
            return None
        spans.append((pos + 5, n))
        n_all += n
        last, pos = data[pos] & 1, pos + 5 + n
        if last:
            break
    out = bytearray(n_all)
    at = 0
    for start, n in spans:
        out[at:at + n] = data[start:start + n]
        at += n
    return out


def _place(stored, leaves_t, device) -> list:
    """The stored leaves as tensors, each on ``device`` or its template
    leaf's device, checked against the template's count and shapes."""
    if len(stored) != len(leaves_t):
        raise ValueError(
            f"checkpoint has {len(stored)} leaves, template expects "
            f"{len(leaves_t)} -- structure changed?")
    out = []
    for meta, tmpl in zip(stored, leaves_t):
        a = _array(meta)
        want = tuple(tmpl.shape) if isinstance(tmpl, torch.Tensor) else \
            np.shape(tmpl)
        if tuple(a.shape) != tuple(want):
            raise ValueError(f"shape mismatch: ckpt {a.shape} vs template "
                             f"{tuple(want)}")
        dev = torch.device(device) if device is not None else (
            tmpl.device if isinstance(tmpl, torch.Tensor) else
            torch.device("cpu"))
        with warnings.catch_warnings():
            # read-only views of the file's bytes; .to and .clone copy
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(a)
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        t = t.to(dev) if dev.type != "cpu" else t.clone()
        if part.is_dtensor(tmpl):   # back onto the template's mesh
            t = part.shard_like(t, tmpl)
        if isinstance(tmpl, torch.Tensor) and tmpl.requires_grad and \
                t.is_floating_point():
            t.requires_grad_(True)
        out.append(t)
    return out


def _array(meta) -> np.ndarray:
    dtype = np.uint16 if meta["dtype"] == "bfloat16" else \
        np.dtype(meta["dtype"])
    return np.frombuffer(meta["data"], dtype=dtype).reshape(meta["shape"])


def restore(ckpt_dir: str, template, *, step: int | None = None,
            device=None):
    """Restore into the structure of ``template`` -> ``(tree, step,
    extra)``: the newest checkpoint, or ``step``'s. Each leaf keeps its
    stored dtype and goes to ``device``, or else to the device of the
    template's leaf (the CPU for a non-tensor leaf), a floating leaf
    requiring grad where the template's does. Raises ``ValueError`` when
    the leaf count or a shape differs, ``IOError`` on a bad checksum."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}.ckpt")
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
        with memoryview(m) as view:
            blob = _unstore(view)
        if blob is None:
            blob = compressio.decompress(m)
    outer = msgpack_lite.unpackb(blob, bin_views=True)
    digest, raw = outer["sha256"], outer["payload"]
    del outer
    if isinstance(raw, list):       # a payload past one bin
        raw = b"".join(raw)
        del blob
    # hashed on a thread while the leaves are read and placed
    with ThreadPoolExecutor(1) as pool:
        hashed = pool.submit(lambda: hashlib.sha256(raw).hexdigest())
        try:
            payload = msgpack_lite.unpackb(raw, bin_views=True)
            out = _place(payload["leaves"], tree_flatten(template), device)
            err = None
        except (ValueError, KeyError, TypeError) as e:
            err = e
        if hashed.result() != digest:
            raise IOError(f"checksum mismatch in {path}") from err
    if err is not None:
        raise err
    return tree_unflatten(template, out), step, payload["extra"]
