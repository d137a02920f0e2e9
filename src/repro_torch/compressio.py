"""Blob compression with graceful degradation.

Serialized indexes are zstd-compressed when the ``zstandard`` package is
available and fall back to stdlib ``zlib`` otherwise. Reads auto-detect the
codec from the frame magic, so artifacts written under one codec load under
the other environment as long as the writer's codec is importable.

The port's copy of ``repro/compressio.py``, with one difference:
``zstandard`` is imported where it is used (so ``import repro_torch`` works
on hosts without it). The default level is the ``RTORCH_COMPRESS_LEVEL``
knob (3 when unset), as ``repro``'s is ``REPRO_COMPRESS_LEVEL``; an
explicit ``level=`` wins.
"""
from __future__ import annotations

import zlib

from repro_torch.core import knobs as knobs_mod

__all__ = ["compress", "decompress"]

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _zstandard():
    try:
        import zstandard
    except ImportError:
        return None
    return zstandard


def compress(data: bytes, level: int | None = None) -> bytes:
    if level is None:
        level = knobs_mod.get_int("RTORCH_COMPRESS_LEVEL")
    zstd = _zstandard()
    if zstd is not None:
        return zstd.ZstdCompressor(level=level).compress(data)
    return zlib.compress(data, level)


def decompress(data: bytes) -> bytes:
    if data[:4] == _ZSTD_MAGIC:
        zstd = _zstandard()
        if zstd is None:
            raise RuntimeError(
                "blob is zstd-compressed but 'zstandard' is not installed"
            )
        return zstd.ZstdDecompressor().decompress(data)
    return zlib.decompress(data)
