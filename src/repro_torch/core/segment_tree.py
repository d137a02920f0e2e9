"""Implicit segment-tree math for iRangeGraph (port of
``repro/core/segment_tree.py:26-80``).

The tree is a perfect binary tree over the padded rank domain
``[0, 2**logn)``. Objects carry ids equal to their attribute rank; layer 0
is the root (one segment of length ``2**logn``) and layer ``logn`` the
leaves. Everything is integer math on int32 tensors (or Python ints).
"""
from __future__ import annotations

import math

import torch

__all__ = ["num_layers", "seg_bounds", "scan_mask"]


def num_layers(n: int) -> int:
    """Number of layers (= logn + 1) for a dataset of n objects."""
    return int(math.ceil(math.log2(max(int(n), 2)))) + 1


def seg_bounds(u, lay, logn):
    """Inclusive [lo, hi] of the segment containing object ``u`` at ``lay``
    (elementwise; u broadcasts against lay)."""
    s = logn - lay
    lo = (u >> s) << s
    hi = lo + (1 << s) - 1
    return lo, hi


def scan_mask(u, L, R, logn, *, skip_layers: bool = True):
    """Layer-scan mask of Algorithm 1 for one object: bool[logn + 1],
    ``mask[lay]`` True iff u's edges at ``lay`` are scanned for ``[L, R]``.

    ``skip_layers=False`` is the naive variant that scans every layer down
    to the first segment fully covered by the range.
    """
    lays = torch.arange(logn + 1, dtype=torch.int32)
    u = torch.as_tensor(u, dtype=torch.int32)
    lo, hi = seg_bounds(u, lays, logn)
    inter_lo = torch.maximum(lo, torch.as_tensor(L, dtype=torch.int32))
    inter_hi = torch.minimum(hi, torch.as_tensor(R, dtype=torch.int32))
    terminal = (lo >= L) & (hi <= R)
    # argmax of an all-False vector is 0, as in jnp.argmax
    first_term = int(torch.argmax(terminal.to(torch.int8))) \
        if bool(terminal.any()) else 0
    reachable = lays <= first_term
    if not skip_layers:
        return reachable
    child_lo = torch.roll(inter_lo, -1)
    child_hi = torch.roll(inter_hi, -1)
    skip = (child_lo == inter_lo) & (child_hi == inter_hi)
    skip[logn] = False  # leaves have no child
    return reachable & ~skip
