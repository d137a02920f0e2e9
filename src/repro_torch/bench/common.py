"""Shared pieces of the port's benchmarks (``repro``'s
``benchmarks/common.py`` and ``hotpath.py::_elemental_table``).

Timing is by CUDA events on the card and by the host clock on the CPU;
every record names the device it ran on (:func:`device_info`).

The figure and table scripts (``fig*.py``, ``table*.py``,
``scalability.py``) share :data:`BENCH_DATASETS` (``repro``'s names, dims
and attribute kinds at its CPU sizes), :func:`build_index` with its cache,
:func:`make_searcher` and :func:`measure` (QPS with the card synchronised
around the timed call, recall@10 against ``brute_force``, mean distance
count). An ``n`` override scales every dataset's n by ``n /``
:data:`BASE_N` and changes nothing else: ``n=1_000_000`` builds the
largest at 1M.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import time

import numpy as np
import torch

from repro_torch.core import BuildConfig, RangeGraphIndex
from repro_torch.core import storage as storage_mod
from repro_torch.core.index import recall
from repro_torch.data import Workload, make_workload, vector_dataset
from repro_torch.device import resolve_device

__all__ = [
    "emit", "artifacts_dir", "time_calls", "device_info", "card_line",
    "elemental_table", "prune_parity", "PRUNE_TIE_RTOL", "PRUNE_MAX_DIFF",
    "BENCH_DATASETS", "BASE_N", "DEFAULT_K", "Workload", "make_workload",
    "dataset_n", "build_config", "build_index", "make_searcher", "measure",
    "write_record", "sync", "carry_smoke_ref", "update_smoke_ref",
]

# CPU-scale stand-ins for the paper's datasets (Table 1), as in ``repro``
BENCH_DATASETS = {
    # name: (n, dim, attr_kind)
    "wit-like": (8192, 128, "uniform"),
    "tripclick-like": (4096, 96, "clustered"),
    "ytaudio-like": (4096, 64, "uniform"),
}
BASE_N = 8192             # the largest dataset's n: what ``n`` replaces
DEFAULT_K = 10
# nodes per build step on the card: the chunk never changes the built
# table, only how many launches a level takes (``core/build.py``)
CUDA_BUILD_CHUNK = 32768
_CACHE: dict = {}

ROOT = pathlib.Path(__file__).resolve().parents[3]
SLEEP_CYCLES = 100_000_000  # a head start for the host: ~50 ms at 1.98 GHz
PRUNE_TIE_RTOL = 1e-5     # prune: a keep decision within this of du
PRUNE_MAX_DIFF = 1e-3     # prune: share of rows allowed to differ


def emit(rows) -> None:
    """Print ``name,us_per_call,derived`` CSV rows."""
    for r in rows:
        print(",".join(str(x) for x in r))


def artifacts_dir() -> str:
    d = ROOT / "artifacts"
    d.mkdir(parents=True, exist_ok=True)
    return str(d)


def card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def device_info(device: torch.device) -> dict:
    """What a record says of where it ran."""
    info = {"device_type": device.type, "torch": torch.__version__}
    if device.type == "cuda":
        info.update(device=torch.cuda.get_device_name(device),
                    card=card_line(), cuda=torch.version.cuda)
    else:
        info["device"] = "cpu"
    return info


def time_calls(fn, device: torch.device, *, iters=20, warmup=3,
               reduce="mean", reset=None) -> float:
    """Seconds per call of ``fn(i)`` (``i`` the call index, so a call
    that updates its inputs in place can take a fresh copy), after
    ``warmup`` calls: the mean over ``iters`` calls, or with
    ``reduce="min"`` the least single call. CUDA events on the card, the
    host clock on the CPU.

    ``reset(i)``, where given, runs before every call, outside what is
    timed (an input the call updates in place, an L2 flush): each call is
    then timed alone, and on the card its events are recorded behind a
    sleep kernel, so the host is ahead of the card and no host time (the
    wrapper's, reset's) falls between a pair."""
    for i in range(warmup):
        if reset is not None:
            reset(i)
        fn(i)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    if reduce not in ("mean", "min"):
        raise ValueError(f"unknown reduce {reduce!r}")
    if reduce == "mean" and reset is None:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                fn(warmup + i)
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) / 1e3 / iters
        t0 = time.perf_counter()
        for i in range(iters):
            fn(warmup + i)
        return (time.perf_counter() - t0) / iters
    if cuda:
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        if reset is not None:
            torch.cuda._sleep(SLEEP_CYCLES)
        for i, (start, end) in enumerate(pairs):
            if reset is not None:
                reset(warmup + i)
            start.record()
            fn(warmup + i)
            end.record()
            if reset is None:  # reduce="min": one call at a time
                torch.cuda.synchronize(device)
        torch.cuda.synchronize(device)
        secs = [a.elapsed_time(b) / 1e3 for a, b in pairs]
    else:
        secs = []
        for i in range(iters):
            if reset is not None:
                reset(warmup + i)
            t0 = time.perf_counter()
            fn(warmup + i)
            secs.append(time.perf_counter() - t0)
    return min(secs) if reduce == "min" else sum(secs) / len(secs)


def elemental_table(rng, n, m, logn):
    """Synthetic but structurally valid elemental-graph table: every edge
    stays inside its layer's segment, 15% of slots are -1 padding
    (``repro``'s ``benchmarks/hotpath.py::_elemental_table``; the same
    draws from the same generator give the same table)."""
    layers = logn + 1
    base = rng.integers(0, n, (n, layers, m)).astype(np.int32)
    u_ids = np.arange(n, dtype=np.int32)[:, None, None]
    shift = (logn - np.arange(layers, dtype=np.int32))[None, :, None]
    seg_lo = (u_ids >> shift) << shift
    seg_size = (1 << shift)
    nbrs = np.minimum(seg_lo + base % seg_size, n - 1).astype(np.int32)
    nbrs[rng.random(nbrs.shape) < 0.15] = -1
    return nbrs


def _near_tie(ids, du, vecs, m, alpha, fill) -> bool:
    """Replay the plain prune of one row in f64 and report whether any
    keep decision is a near tie, |alpha*cc - du| <= PRUNE_TIE_RTOL*du."""
    from repro_torch.kernels import ref

    ids, du, vecs = ids[None], du[None], vecs[None]
    C = ids.shape[1]
    v64 = vecs.double()
    xx = (v64 * v64).sum(-1)[0]
    kept = ref.prune_vecs(ids, du, vecs, m=m, alpha=alpha, fill=fill)[0]
    for kid in kept.tolist():
        if kid < 0:
            break
        p = int((ids[0] == kid).nonzero()[0, 0])
        cc = (xx - 2.0 * (v64[0] @ v64[0, p]) + xx[p]).clamp_min(0.0)
        d = du[0].double()
        live = torch.isfinite(d) & (ids[0] >= 0)
        gap = (alpha * cc - d).abs()
        if bool((live & (gap <= PRUNE_TIE_RTOL * d.abs())).any()):
            return True
    return C == 0


def prune_parity(got, want, cand, du, vecs, m, alpha=1.0,
                 fill=True) -> tuple[int, int, bool]:
    """The near-tie rule between two prunes of the same inputs (``vecs``
    the decoded candidate rows [B, C, d]): ``(rows differing, of them near
    ties, ok)``, ok when every differing row holds a near-tie keep
    decision and they are at most PRUNE_MAX_DIFF of the rows."""
    diff = (got != want).any(dim=1).nonzero()[:, 0].tolist()
    ties = sum(_near_tie(cand[r], du[r], vecs[r], m, alpha, fill)
               for r in diff)
    ok = ties == len(diff) and len(diff) <= PRUNE_MAX_DIFF * got.shape[0]
    return len(diff), ties, ok


# ---------------------------------------------------------------------------
# The figure and table scripts' harness (``repro``'s benchmarks/common.py)
# ---------------------------------------------------------------------------

def dataset_n(name: str, n: int | None = None) -> int:
    """A dataset's n: ``repro``'s, or scaled by ``n / BASE_N``."""
    base = BENCH_DATASETS[name][0]
    return base if n is None else max(int(round(base * n / BASE_N)), 2)


def build_config(device: torch.device, **kw) -> BuildConfig:
    """``BuildConfig(**kw)``, with the card's build chunk on the card."""
    if device.type == "cuda":
        kw.setdefault("chunk", CUDA_BUILD_CHUNK)
    return BuildConfig(**kw)


def build_index(name: str, *, n: int | None = None, m=16, efc=64, seed=0,
                storage=None, device=None) -> RangeGraphIndex:
    """The named dataset's index (cached by every argument): ``storage``
    an optional ``StorageConfig`` (None: ``storage.default_config()``),
    ``n`` the scale override."""
    dev = resolve_device(device)
    storage = storage or storage_mod.default_config()
    nn = dataset_n(name, n)
    key = (name, nn, m, efc, seed, storage, str(dev))
    if key not in _CACHE:
        _, dim, attr_kind = BENCH_DATASETS[name]
        vectors, attrs, _ = vector_dataset(nn, dim, seed=seed,
                                           attr_kind=attr_kind)
        _CACHE[key] = RangeGraphIndex.build(
            vectors, attrs[:, 0], build_config(dev, m=m, ef_construction=efc),
            device=dev, storage=storage)
    return _CACHE[key]


def make_searcher(index: RangeGraphIndex, *, config=None, bucket=True):
    """Bind an index and a ``SearchConfig`` into the ``search_fn(q, L, R,
    k)`` that :func:`measure` takes; ``bucket`` rounds k up to
    ``config.k_bucket`` as the serving engine does, and slices back."""
    from repro_torch.core.config import SearchConfig

    config = config or SearchConfig()

    def search_fn(q, L, R, k):
        kb = config.bucket_k(k) if bucket else k
        res = index.search_ranks(q, L, R, k=kb, config=config)
        if kb != k:
            res = res._replace(ids=res.ids[:, :k], dists=res.dists[:, :k])
        return res

    return search_fn


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(search_fn, wl: Workload, index, *, k=DEFAULT_K, warmup=True):
    """dict(qps, recall, mean_dists) of ``search_fn(q, L, R, k)`` on the
    workload: one timed call over every query, the card synchronised
    before it and the ids copied to the host inside it."""
    gt, _ = index.brute_force(wl.queries, wl.L, wl.R, k=k)
    if warmup:
        search_fn(wl.queries[:8], wl.L[:8], wl.R[:8], k)
    sync(index.device)
    t0 = time.perf_counter()
    res = search_fn(wl.queries, wl.L, wl.R, k)
    ids = storage_mod.to_numpy(res.ids)
    dt = time.perf_counter() - t0
    return {
        "qps": len(wl.queries) / dt,
        "recall": recall(ids, gt),
        "mean_dists": float(res.n_dists.float().mean()),
    }


def write_record(name: str, rows, columns, device: torch.device, *,
                 n=None, quick=False, seconds=None, notes=None,
                 out_dir=None) -> str:
    """Write ``BENCH_torch_<name>.json`` (rows, their columns, where and
    at what scale they ran) to ``out_dir`` or ``artifacts/``; returns the
    path."""
    doc = {
        "bench": name, "columns": list(columns),
        "rows": [list(r) for r in rows],
        "n": n, "quick": bool(quick), "seconds": seconds,
        "device_info": device_info(device), "card_line": card_line(),
        "notes": notes or {},
    }
    path = os.path.join(out_dir or artifacts_dir(), f"BENCH_torch_{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1,
                  default=lambda o: o.item() if hasattr(o, "item") else str(o))
    return path


def carry_smoke_ref(payload: dict, committed_path: str) -> dict:
    """Keep the committed record's ``smoke_ref`` on a full run
    (``repro``'s ``benchmarks/common.py::carry_smoke_ref``): those ratios
    were measured at smoke shapes, which a full run does not measure;
    ``--smoke --update-smoke-ref`` refreshes them."""
    if os.path.exists(committed_path):
        try:
            with open(committed_path) as f:
                old = json.load(f)
        except (OSError, json.JSONDecodeError):
            return payload
        if isinstance(old.get("smoke_ref"), dict):
            payload.setdefault("smoke_ref", old["smoke_ref"])
    return payload


def update_smoke_ref(committed_path: str, refs: dict) -> bool:
    """Write a smoke run's ratios into the committed record's
    ``smoke_ref`` (``--update-smoke-ref``); False when there is no
    committed record."""
    if not os.path.exists(committed_path):
        return False
    with open(committed_path) as f:
        doc = json.load(f)
    doc["smoke_ref"] = {k: round(float(v), 4) for k, v in refs.items()}
    with open(committed_path, "w") as f:
        json.dump(doc, f, indent=1)
    return True
