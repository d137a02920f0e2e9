"""What a ``--trace 1`` run records: the benchmark's own spans around calls
into the program's layers, the counters those calls return, and one
profiled stretch of the window.

Spans are taken with ``time.time_ns()``, the clock that ``torch.profiler``
stamps its events in, so the device's idle gaps can be put beside what the
host was doing. The profiler records the card's activity only, so it adds
no cost to the host's path.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from rfbench import yardstick

HOP_KERNEL = "hop_kernel"
TOP = 10
# a kernel's name in the breakdown, cut to this many characters
NAME_CHARS = 160


@dataclasses.dataclass
class Search:
    t0: int          # ns, time.time_ns()
    t1: int
    rows: int
    n_dists: int
    n_hops: int


@dataclasses.dataclass
class Recorder:
    """Spans and counters of one traced window."""
    searches: list = dataclasses.field(default_factory=list)
    flushes: list = dataclasses.field(default_factory=list)   # (t0, t1)
    submits: list = dataclasses.field(default_factory=list)   # (t0, t1)

    def wrap_search(self, executor):
        """Time ``executor.search_ranks`` to the end of its device work,
        and keep the counters of its ``SearchResult``."""
        inner = executor.search_ranks

        def search_ranks(*args, **kw):
            t0 = time.time_ns()
            res = inner(*args, **kw)
            n_dists = int(res.n_dists.sum())   # waits for the search
            n_hops = int(res.n_hops.sum())
            self.searches.append(Search(t0, time.time_ns(),
                                        int(res.ids.shape[0]), n_dists,
                                        n_hops))
            return res

        executor.search_ranks = search_ranks

    def host_ms_per_flush(self) -> float | None:
        """Mean over flushes of the flush's wall time less that of the
        searches under it."""
        if not self.flushes:
            return None
        total, j = 0, 0
        for f0, f1 in self.flushes:
            inner = 0
            while j < len(self.searches) and self.searches[j].t0 < f1:
                s = self.searches[j]
                if s.t0 >= f0:
                    inner += s.t1 - s.t0
                j += 1
            total += (f1 - f0) - inner
        return total / len(self.flushes) / 1e6

    def searches_in(self, lo: int, hi: int) -> list:
        return [s for s in self.searches if s.t0 >= lo and s.t1 <= hi]

    def host_spans(self, lo: int, hi: int) -> list[tuple[int, int, str]]:
        """Disjoint labelled spans of the host inside [lo, hi]: a client
        submitting, the engine outside the search, the search."""
        spans = [(a, b, "client.submit") for a, b in self.submits]
        for f0, f1 in self.flushes:
            t = f0
            for s in self.searches:
                if s.t0 >= f0 and s.t1 <= f1:
                    spans.append((t, s.t0, "engine.flush"))
                    spans.append((s.t0, s.t1, "executor.search_ranks"))
                    t = s.t1
            spans.append((t, f1, "engine.flush"))
        return sorted((max(a, lo), min(b, hi), n) for a, b, n in spans
                      if b > lo and a < hi and b > a)


def warm_profiler(device):
    """Start and stop the profiler once, in set-up: its first start in a
    process loads and initialises the tracing library, which took seconds
    on the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA], acc_events=True):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


class Stretch:
    """One profiled stretch of the window (the card's activity only)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             acc_events=True)
        self._prof.__enter__()
        time.sleep(0.05)   # the profiler can miss launches near its start
        torch.cuda.synchronize()
        self.t0 = time.time_ns()
        self.t1 = None

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        time.sleep(0.05)   # and near its end
        self._prof.__exit__(None, None, None)

    def read(self, rec: Recorder) -> dict:
        """Busy and idle seconds of the stretch, the hop kernel's device
        time, the searches inside it, and the breakdown. Raises where the
        profiler's clock base cannot be read: its events could then not be
        put beside the stretch's bounds and the host's spans."""
        from torch.autograd import DeviceType

        prof = self._prof
        base = prof.profiler.kineto_results.trace_start_ns()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.time_range.end > e.time_range.start]
        if not events:
            raise RuntimeError("the profiled stretch holds no device "
                               "operation")
        ivals = []
        by_name: dict[str, float] = {}
        hop_ns = 0.0
        for e in events:
            s = e.time_range.start * 1e3 + base
            t = e.time_range.end * 1e3 + base
            ivals.append((int(s), int(t)))
            name = e.name[:NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + (t - s)
            if HOP_KERNEL in e.name:
                hop_ns += t - s
        busy_all = yardstick.union(ivals)
        lo, hi = self.t0, self.t1
        busy_ns = sum(e - s for s, e in yardstick.clip(busy_all, lo, hi))
        idle = yardstick.gaps(busy_all, lo, hi)
        by_span = yardstick.overlap_by_label(idle, rec.host_spans(lo, hi))
        return {
            "window_s": (hi - lo) / 1e9,
            "busy_s": busy_ns / 1e9,
            "hop_s": hop_ns / 1e9,
            "searches": rec.searches_in(lo, hi),
            "device_ops": [[k, v / 1e9] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[k, v / 1e9] for k, v in sorted(
                by_span.items(), key=lambda kv: -kv[1])[:TOP]],
        }
