"""Implicit segment-tree math for iRangeGraph (port of
``repro/core/segment_tree.py:26-125``).

The tree is a perfect binary tree over the padded rank domain
``[0, 2**logn)``. Objects carry ids equal to their attribute rank; layer 0
is the root (one segment of length ``2**logn``) and layer ``logn`` the
leaves. Everything is integer math on int32 tensors (or Python ints);
the baselines' range helpers (:func:`decompose_range`,
:func:`covering_segment`) are plain Python int recursion on the host.
"""
from __future__ import annotations

import math

import torch

__all__ = ["num_layers", "seg_bounds", "scan_mask", "decompose_range",
           "covering_segment"]


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
    """Layer-scan mask of Algorithm 1: bool[..., logn + 1],
    ``mask[..., lay]`` True iff u's edges at ``lay`` are scanned for
    ``[L, R]``. ``u``, ``L`` and ``R`` are ints or int32 tensors that
    broadcast together (one object, or a batch of them).

    ``skip_layers=False`` is the naive variant that scans every layer down
    to the first segment fully covered by the range.
    """
    u = torch.as_tensor(u, dtype=torch.int32)
    dev = u.device
    lays = torch.arange(logn + 1, dtype=torch.int32, device=dev)
    L = torch.as_tensor(L, dtype=torch.int32, device=dev)[..., None]
    R = torch.as_tensor(R, dtype=torch.int32, device=dev)[..., None]
    lo, hi = seg_bounds(u[..., None], lays, logn)
    inter_lo = torch.maximum(lo, L)
    inter_hi = torch.minimum(hi, R)
    terminal = (lo >= L) & (hi <= R)
    # argmax of an all-False row is 0, as in jnp.argmax (torch.argmax also
    # returns the first of equal maxima)
    first_term = torch.argmax(terminal.to(torch.int8), dim=-1, keepdim=True)
    reachable = lays <= first_term
    if not skip_layers:
        return reachable
    child_lo = torch.roll(inter_lo, -1, dims=-1)
    child_hi = torch.roll(inter_hi, -1, dims=-1)
    skip = (child_lo == inter_lo) & (child_hi == inter_hi) & (lays < logn)
    return reachable & ~skip


def decompose_range(L: int, R: int, logn: int):
    """Classic segment-tree decomposition of [L, R] (inclusive): a list of
    ``(lay, lo, hi)`` disjoint segments whose union is exactly [L, R], at
    most ``2 * logn`` of them (the BasicSearch baseline's segments)."""
    out = []

    def rec(lay, lo, hi):
        if hi < L or lo > R:
            return
        if L <= lo and hi <= R:
            out.append((lay, lo, hi))
            return
        mid = (lo + hi) // 2
        rec(lay + 1, lo, mid)
        rec(lay + 1, mid + 1, hi)

    rec(0, 0, (1 << logn) - 1)
    return out


def covering_segment(L: int, R: int, logn: int):
    """Smallest single segment covering [L, R] (the SuperPostfiltering
    baseline's): ``(lay, lo, hi)`` of the deepest tree node whose segment
    contains the whole query range."""
    lay, lo, hi = 0, 0, (1 << logn) - 1
    while lay < logn:
        mid = (lo + hi) // 2
        if R <= mid:
            lay, hi = lay + 1, mid
        elif L > mid:
            lay, lo = lay + 1, mid + 1
        else:
            break
    return lay, lo, hi
