"""Packed per-query visited sets for beam search (port of
``repro/core/bitset.py:24-71``).

A query's visited set is ``int32[B, ceil(n/32)]``: the words hold the same
bit pattern as the JAX package's ``uint32`` words (torch has no shifts,
``gather`` or ``scatter_add`` for ``uint32`` on the CPU), so bit 31 is the
mask ``-2**31``. Compare with JAX through ``.numpy().view(np.uint32)``.

``test_and_set`` reads the old bits, sets the new ones and suppresses
duplicate ids within a row (first occurrence wins), so callers get
exactly-once semantics per id. The scatter adds single-bit masks: after the
in-row dedup every updated (row, word, bit) is unique and was clear, so the
add is exactly OR and no signed overflow occurs.
"""
from __future__ import annotations

import torch

__all__ = ["make", "lookup", "test_and_set", "num_words"]

# bit 31 of an int32 word, as a mask
_SIGN_BIT = -(2**31)


def num_words(n: int) -> int:
    """Words per query for a dataset of n ids."""
    return (int(n) + 31) // 32


def make(B: int, n: int, device=None) -> torch.Tensor:
    """Empty bitset: int32[B, ceil(n/32)]."""
    return torch.zeros((B, num_words(n)), dtype=torch.int32, device=device)


def lookup(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """bits[B, W], ids int32[B, K] (-1 allowed) -> bool[B, K] membership."""
    safe = ids.clamp_min(0)
    word = torch.gather(bits, 1, (safe >> 5).long())
    bit = (word >> (safe & 31)) & 1
    return (bit == 1) & (ids >= 0)


def test_and_set(bits: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor):
    """Set bit ids[b, j] for every valid slot; report what was already set.

    ``bits`` int32[B, W] is updated IN PLACE and returned. ``ids`` int32[B,
    K] (-1 allowed, treated as invalid); ``valid`` bool[B, K].

    Returns ``(bits, seen)``: ``seen[b, j]`` is True when the id was already
    present *or* appeared earlier (lower j) in the same row, so
    ``valid & ~seen`` is the exactly-once "newly visited" mask.
    """
    valid = valid & (ids >= 0)
    safe = ids.clamp_min(0)
    seen = lookup(bits, torch.where(valid, ids, -1))

    # first occurrence wins within a row: dup[b, j] <=> exists i<j, id_i==id_j
    K = ids.shape[1]
    eq = (safe[:, :, None] == safe[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    earlier = torch.ones((K, K), dtype=torch.bool, device=ids.device).tril(-1)
    dup = (eq & earlier[None]).any(dim=2)

    new = valid & ~seen & ~dup
    s = safe & 31
    one_hot = torch.where(s == 31, _SIGN_BIT,
                          torch.ones_like(s) << s.clamp_max(30))
    mask = torch.where(new, one_hot, 0)
    bits.scatter_add_(1, (safe >> 5).long(), mask)
    return bits, seen | dup
