"""SearchExecutor: the one owner of the query pipeline's per-shape state
(port of ``repro/serve/executor.py``).

  * **Cache** keyed on ``(SearchConfig, batch_bucket, k_bucket)``, as in
    ``repro``. ``repro`` AOT-compiles one XLA program per key; the port
    runs eagerly and compiles nothing, so what a key holds is what its
    search prepares per shape: a :class:`_Program` with the padded query
    and range buffers on the index's device, into which each batch is
    copied, and one warm run of the search at that shape (the first call
    of a shape loads the kernel libraries and grows PyTorch's caching
    allocator; after it a batch of that shape allocates from the cache).
    ``stats["compiles"]`` counts cache entries exactly: a warmed executor
    adds none while it serves any batch size and k inside its grid.
  * **Batch-shape buckets**: a batch pads to the smallest power-of-two
    bucket (``core/config.py::pick_bucket``) by repeating its last row;
    the beam search is row-independent, so padded rows never change a real
    row's results (padding parity holds bit for bit).
  * **k buckets**: k rounds up to ``config.bucket_k(k)``; results slice
    back to the caller's k.
  * Batches above ``max_batch`` split into ``max_batch`` chunks.
  * **One lock** per executor. ``repro`` calls a compiled program by
    value, so two loops may share one warmed executor (``ServeConfig``'s
    interactive and batch traffic on one index). Here a cache entry owns
    its input buffers: two threads on one key could each copy in a batch
    and then search the other's rows. ``search_ranks`` holds the lock
    from the copy-in through the search to the slicing, and ``warmup``
    and ``close`` hold it while they change the cache; the results it
    returns are fresh tensors, never the entry's buffers, so what callers
    do with them needs no lock.

``serve/engine.py::ServingEngine`` is queueing and per-request stats over
this layer. The beam loop syncs with the host every ``ITER_BLOCK``
iterations (``core/search.py``), so no CUDA graph is captured per key.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core import config as config_mod
from repro_torch.core import knobs as knobs_mod
from repro_torch.core import search as search_mod
from repro_torch.core.config import SearchConfig
from repro_torch.serve.errors import ShutdownError

__all__ = ["SearchExecutor"]


class _Program:
    """One cache entry: the search at ``(config, bb, kb)`` over one index,
    with its padded input buffers on the index's device."""

    def __init__(self, index, config: SearchConfig, bb: int, kb: int):
        dev = index.device
        self.index, self.config, self.bb, self.kb = index, config, bb, kb
        self.q = torch.zeros((bb, index.dim), dtype=torch.float32, device=dev)
        self.L = torch.zeros((bb,), dtype=torch.int32, device=dev)
        self.R = torch.full((bb,), index.n - 1, dtype=torch.int32,
                            device=dev)
        self._search()  # the warm run

    def _search(self) -> search_mod.SearchResult:
        ix = self.index
        return search_mod.search_improvised(
            ix.vectors, ix.neighbors, self.q, self.L, self.R, logn=ix.logn,
            m_out=ix.m, k=self.kb, config=self.config,
            rerank_store=ix.rerank)

    def __call__(self, q: np.ndarray, L: np.ndarray, R: np.ndarray):
        """q f32[B, d], L / R int32[B] with B <= bb (host arrays): pad to
        bb by repeating the last row, copy in, search."""
        pad = self.bb - q.shape[0]
        if pad:
            q = np.concatenate([q, np.repeat(q[-1:], pad, axis=0)])
            L = np.concatenate([L, np.repeat(L[-1:], pad)])
            R = np.concatenate([R, np.repeat(R[-1:], pad)])
        self.q.copy_(torch.from_numpy(np.ascontiguousarray(q)))
        self.L.copy_(torch.from_numpy(np.ascontiguousarray(L)))
        self.R.copy_(torch.from_numpy(np.ascontiguousarray(R)))
        return self._search()


class SearchExecutor:
    def __init__(
        self,
        index,
        config: SearchConfig | None = None,
        *,
        max_batch: int = 64,
        batch_buckets: tuple[int, ...] | None = None,
        warmup: bool | None = None,
        faults=False,
    ):
        """index: a ``RangeGraphIndex`` (the port's). config: the default
        ``SearchConfig`` (per-call configs may differ; each is its own
        cache-key axis). batch_buckets: explicit padded batch shapes
        (ascending, ending at ``max_batch``); default the power-of-two
        ladder. warmup: fill the whole grid now (:meth:`warmup`); None
        means the ``RTORCH_SERVE_WARMUP`` knob (unset: False). faults:
        an explicit ``FaultConfig``/``FaultInjector`` injecting latency
        spikes into ``search_ranks`` (``serve/faults.py``); never taken
        from the environment here."""
        self.index = index
        self.config = config or SearchConfig()
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if batch_buckets is None:
            self.batch_buckets = config_mod.batch_buckets(self.max_batch)
        else:
            self.batch_buckets = tuple(sorted(int(b) for b in batch_buckets))
            if not self.batch_buckets or \
                    self.batch_buckets[-1] != self.max_batch:
                raise ValueError(
                    f"batch_buckets {batch_buckets} must be non-empty and "
                    f"end at max_batch={self.max_batch}"
                )
        if faults:
            from repro_torch.serve import faults as faults_mod

            self.faults = faults_mod.resolve(faults)
        else:
            self.faults = None
        self.closed = False
        # held across copy-in -> search -> slicing (see the module doc)
        self._lock = threading.Lock()
        self._cache: dict = {}   # (config, batch_bucket, k_bucket) -> program
        self.seen_k_buckets: set[int] = set()
        self.stats = {
            "compiles": 0, "warmup_compiles": 0, "cache_hits": 0,
            "batches": 0, "queries": 0, "index_bytes": int(index.nbytes),
        }
        if warmup is None:
            warmup = knobs_mod.get_bool("RTORCH_SERVE_WARMUP")
        if warmup:
            self.warmup()

    # -- bucket math ---------------------------------------------------------
    def batch_bucket(self, b: int) -> int:
        """The padded shape a ``b``-row batch runs at."""
        return config_mod.pick_bucket(b, self.batch_buckets)

    def program_grid(self, configs=None) -> int:
        """Cache entries the grid of ``configs`` (default: the executor's
        own) can hold: ``len(batch_buckets) * len(k_buckets)`` each."""
        configs = tuple(configs) if configs is not None else (self.config,)
        return sum(
            len(self.batch_buckets) * len(cfg.k_buckets()) for cfg in configs
        )

    # -- cache ---------------------------------------------------------------
    def _compile(self, cfg: SearchConfig, bb: int, kb: int, *,
                 warmup: bool = False) -> _Program:
        key = (cfg, bb, kb)
        prog = self._cache.get(key)
        if prog is not None:
            return prog
        prog = self._cache[key] = _Program(self.index, cfg, bb, kb)
        self.stats["compiles"] += 1
        if warmup:
            self.stats["warmup_compiles"] += 1
        return prog

    def warmup(self, batch_buckets=None, k_buckets=None, configs=None) -> int:
        """Fill the declared (config, batch_bucket, k_bucket) grid, by
        default every batch bucket times every ``config.k_buckets()`` of
        the default config. Returns the entries this call added."""
        configs = tuple(configs) if configs is not None else (self.config,)
        bbs = tuple(batch_buckets) if batch_buckets is not None \
            else self.batch_buckets
        with self._lock:
            before = self.stats["compiles"]
            for cfg in configs:
                kbs = tuple(k_buckets) if k_buckets is not None \
                    else cfg.k_buckets()
                kbs = sorted({cfg.bucket_k(kb) for kb in kbs})
                for bb in bbs:
                    bb = self.batch_bucket(int(bb))
                    for kb in kbs:
                        self._compile(cfg, bb, kb, warmup=True)
            return self.stats["compiles"] - before

    # -- execution -----------------------------------------------------------
    def search_ranks(self, queries, L, R, *, k: int,
                     config: SearchConfig | None = None
                     ) -> search_mod.SearchResult:
        """Bucketed, cached improvised search.

        queries f32[B, d], L/R int32[B] rank ranges (host arrays), any
        B >= 1 (batches beyond ``max_batch`` split). Returns a
        ``SearchResult`` of tensors on the index's device sliced back to
        ``[B, k]``: the same ids and distances as the direct
        ``search_improvised`` call at the same config. Thread-safe: calls
        from several threads run one at a time."""
        if self.closed:
            raise ShutdownError("SearchExecutor is closed")
        if self.faults is not None:
            self.faults.maybe_latency()
        cfg = config or self.config
        if k > cfg.ef:
            raise ValueError(
                f"requested k={k} exceeds the config's ef={cfg.ef}; "
                f"raise ef or lower k"
            )
        kb = cfg.bucket_k(k)
        q = np.asarray(queries, np.float32)
        L = np.asarray(L, np.int32).reshape(-1)
        R = np.asarray(R, np.int32).reshape(-1)
        B = q.shape[0]
        if B < 1:
            raise ValueError("empty query batch")
        with self._lock:
            if self.closed:
                raise ShutdownError("SearchExecutor is closed")
            parts = [
                self._run(q[s : s + self.max_batch],
                          L[s : s + self.max_batch],
                          R[s : s + self.max_batch], kb, cfg)
                for s in range(0, B, self.max_batch)
            ]
            self.seen_k_buckets.add(kb)
        res = parts[0] if len(parts) == 1 else search_mod.SearchResult(
            *(torch.cat(xs, dim=0) for xs in zip(*parts))
        )
        if kb == k:
            return res
        return res._replace(ids=res.ids[:, :k], dists=res.dists[:, :k])

    def close(self):
        """Release the cache and refuse further work (``search_ranks``
        raises ``ShutdownError``). Idempotent; stats survive."""
        with self._lock:
            self.closed = True
            self._cache.clear()

    def _run(self, q, L, R, kb, cfg):
        """One chunk of at most ``max_batch`` rows; the caller holds the
        lock, since the entry's buffers are shared."""
        B = q.shape[0]
        bb = self.batch_bucket(B)
        prog = self._cache.get((cfg, bb, kb))
        if prog is not None:
            self.stats["cache_hits"] += 1
        else:
            prog = self._compile(cfg, bb, kb)
        res = prog(q, L, R)
        self.stats["batches"] += 1
        self.stats["queries"] += B
        if bb == B:
            return res
        return search_mod.SearchResult(*(x[:B] for x in res))
