"""Checkpoint I/O timing: ``checkpoint/checkpoint.py``'s two level-0
writers and its two readers on one training state, the ``(params,
OptState)`` of an architecture, in one process so that each pair shares
a disk and a page cache.

  * write, one pass: ``save`` at ``RTORCH_COMPRESS_LEVEL=0`` with zlib,
    stored blocks with the hash, adler32 and the write on three threads;
  * write, two passes: the general path on the same state (hash, then
    zlib level 0 through ``compressio.compressor``);
  * read: the one-pass file's bytes through ``_unstore`` (stored blocks
    copied out of the mapped file) and through ``compressio.decompress``
    (zlib), held equal;
  * restore: ``checkpoint.restore`` of the one-pass file, held
    bit-identical to the state.

Reads are warm: each file was just written. Each time is the least of
``--repeats``. Needs zlib as the codec (no ``zstandard``): the one-pass
writer is zlib's.

Run: ``python -m repro_torch.bench.ckpt_io --arch qwen3-0.6b
--no-reduced`` on the card (its 7.2 GB state), or ``--device cpu`` (the
reduced config by default). Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import mmap
import os
import tempfile
import time

import torch

from repro_torch import compressio
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_arch
from repro_torch.core import knobs
from repro_torch.device import resolve_device
from repro_torch.models.api import Model
from repro_torch.train.optimizer import init_opt_state

__all__ = ["main", "measure"]


def _least(fn, repeats):
    best, out = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def _read(path, how):
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
        if how == "unstore":
            with memoryview(m) as view:
                return ckpt._unstore(view)
        return compressio.decompress(m)


def measure(state, out_dir, *, repeats=1) -> dict:
    """The record: seconds of each writer and reader on ``state``, the
    bytes, and the equality checks."""
    if compressio.codec() != "zlib":
        raise RuntimeError("ckpt_io: the one-pass writer needs zlib as "
                           "the codec ('zstandard' is installed)")
    old = knobs.raw("RTORCH_COMPRESS_LEVEL")
    os.environ["RTORCH_COMPRESS_LEVEL"] = "0"
    try:
        one = os.path.join(out_dir, "one_pass")
        two = os.path.join(out_dir, "two_pass")
        write_one, _ = _least(lambda: ckpt.save(one, 1, state, keep=1),
                              repeats)

        def plain():
            items = ckpt._payload(state, 1, None)
            total = sum(len(it) if isinstance(it, bytes) else it[0]
                        for it in items)
            os.makedirs(two, exist_ok=True)
            ckpt._write_compressed(os.path.join(two, "step_1.ckpt"),
                                   items, total)

        write_two, _ = _least(plain, repeats)
    finally:
        if old is None:
            del os.environ["RTORCH_COMPRESS_LEVEL"]
        else:
            os.environ["RTORCH_COMPRESS_LEVEL"] = old
    path_one = os.path.join(one, "step_1.ckpt")
    path_two = os.path.join(two, "step_1.ckpt")
    read_unstore, a = _least(lambda: _read(path_one, "unstore"), repeats)
    n_payload = len(a)
    read_zlib, b = _least(lambda: _read(path_one, "zlib"), repeats)
    same_bytes = a == b
    del a, b
    two_same = _read(path_two, "zlib") == _read(path_one, "zlib")
    restore_s, (tree, _, _) = _least(
        lambda: ckpt.restore(one, state), repeats)
    identical = all(
        torch.equal(x.cpu(), y.cpu()) for x, y in
        zip(ckpt.tree_flatten(tree), ckpt.tree_flatten(state)))
    return {
        "file_bytes_one_pass": os.path.getsize(path_one),
        "file_bytes_two_pass": os.path.getsize(path_two),
        "payload_bytes": n_payload,
        "write_one_pass_s": round(write_one, 3),
        "write_two_pass_s": round(write_two, 3),
        "read_unstore_s": round(read_unstore, 3),
        "read_zlib_decompress_s": round(read_zlib, 3),
        "restore_s": round(restore_s, 3),
        "reads_equal": same_bytes,
        "two_pass_payload_equal": two_same,
        "restored_bit_identical": identical,
        "repeats": repeats,
        "reads": "warm (each file just written)",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--dir", default=None,
                    help="where the files go (default: a temporary dir)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = Model(cfg).init(
        torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    state = (params, init_opt_state(params))
    with tempfile.TemporaryDirectory(dir=args.dir) as d:
        rec = {"arch": cfg.name, "device": str(dev),
               **measure(state, d, repeats=args.repeats)}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
