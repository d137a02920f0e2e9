"""Poisson load-generator SLO benchmark for the async serving loop (port of
``benchmarks/serve_slo.py``).

Drives ``serve/loop.py::AsyncServingEngine`` on a warmed ``SearchExecutor``
with open-loop Poisson arrivals (exponential inter-arrival gaps — requests
keep arriving whether or not the server keeps up, unlike a closed
benchmark loop) and records the latency/outcome distribution per leg:

  * ``nominal``  — target QPS at half the measured full-batch capacity:
    the steady-state SLO numbers (p50/p99 of served requests).
  * ``overload`` — 4x capacity against the bounded queue: admission
    control and deadline shedding take over; the interesting numbers are
    the shed/timeout/reject rates and that p99 of what IS served stays
    bounded.
  * ``chaos``    — overload plus fault injection (``serve/faults.py``:
    latency spikes of twice the deadline, flush errors, queue-full
    bursts): every request still resolves with exactly one terminal
    outcome.

Every leg records ``offered == resolved`` (``lost`` 0), the executor's
post-warmup cache entries (0: the loop serves from the grid warmed on the
caller's thread), how late the generator submitted each request against
its Poisson schedule, the executor's time a flush inside the loop
(``search_ms``: ``search_ranks`` in the worker thread, which waits for
the GIL the event loop holds), and how late each timeout was delivered
past its
deadline (``timeout_late_ms``: the legs use ``"reject"`` and shed expired
queued requests, so every timeout is one the reaper delivered while a
flush ran, and its lateness is how long the flush thread held the
reaper off). Capacity is a full-batch flush timed on the device
(``bench/common.py::time_calls``: CUDA events on the card).

``repro``'s ``--update-smoke-ref`` and the committed ``smoke_ref`` that
``benchmarks/ci_gate.py`` checks wait for that gate's port (ROADMAP item
11b); this module writes the record only.

Usage: ``python -m repro_torch.bench.serve_slo [--smoke] [--n N]
[--device cpu] [--duration 4.0] [--max-batch 32] [--deadline 0.25]
[--out-dir DIR]``. ``--n`` scales the dataset as ``bench/run.py`` does
(``--n 1000000``: ytaudio-like at 500,000 x 64); ``--smoke`` runs 1 s legs
at ``max_batch`` 16. The record goes to
``artifacts/BENCH_torch_serve_slo.json`` (``..._smoke.json`` with
``--smoke``), with the device and the ``nvidia-smi`` card line.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import time
from collections import Counter

import numpy as np

from repro_torch.bench import common
from repro_torch.core.config import SearchConfig, ServeConfig
from repro_torch.device import resolve_device
from repro_torch.serve import AsyncServingEngine, DeadlineExceededError, \
    FaultConfig, OverloadedError, Request, SearchExecutor, ShedError, \
    ShutdownError

OUTCOMES = ("ok", "rejected", "shed", "timeout", "shutdown", "failed")
# ``repro``'s defaults: the executor's batch and beam, each leg's length
# and the requests' deadline
MAX_BATCH = 32
EF = 64
DURATION_S = 4.0
DEADLINE_S = 0.25
# name -> (target QPS over capacity, arrival seed, fault injection)
LEGS = {
    "nominal": (0.5, 1, False),
    "overload": (4.0, 2, False),
    "chaos": (4.0, 3, True),
}


def measure_capacity(executor, wl, k, iters=5) -> float:
    """Queries/sec of a warmed full-batch flush — the denominator the
    nominal/overload QPS targets scale from, so the legs stress the same
    relative load on any host."""
    B = executor.max_batch
    q, L, R = wl.queries[:B], wl.L[:B], wl.R[:B]
    t = common.time_calls(lambda i: executor.search_ranks(q, L, R, k=k),
                          executor.index.device, iters=iters, warmup=2)
    return B / t


def serve_config(cap: float, *, max_batch: int,
                 deadline_s: float) -> ServeConfig:
    """The legs' policy. The queue is sized off measured capacity so that
    at overload the back of the queue waits ~2x the shed threshold: the
    shed path (not just admission rejects) is exercised on any host."""
    margin = deadline_s / 5
    max_queue = max(4 * max_batch, int(2 * cap * (deadline_s - margin)))
    return ServeConfig(
        deadline_s=deadline_s, max_queue=max_queue, backpressure="reject",
        max_wait_s=0.01, deadline_margin_s=margin,
    )


def leg_faults(inject: bool, deadline_s: float):
    """The chaos leg's injection (``repro``'s, seed 7), or none."""
    if not inject:
        return False
    return FaultConfig(
        kinds=("latency", "flush_error", "queue_full"),
        latency_s=2 * deadline_s, latency_rate=0.1,
        flush_error_rate=0.1, queue_full_rate=0.1, seed=7,
    )


def _pcts(x) -> dict:
    """n, p50, mean and max of seconds ``x``, in ms."""
    x = np.asarray(x, float)
    if not len(x):
        return {"n": 0, "p50": None, "mean": None, "max": None}
    return {"n": int(len(x)), "p50": float(np.percentile(x, 50) * 1e3),
            "mean": float(x.mean() * 1e3), "max": float(x.max() * 1e3)}


class TimedExecutor:
    """The executor as the loop sees it, with the seconds of each
    ``search_ranks`` call (one a flush, in the loop's worker thread)
    recorded: a span around the call into the executor layer."""

    def __init__(self, executor):
        self._executor = executor
        self.search_s: list[float] = []

    def __getattr__(self, name):
        return getattr(self._executor, name)

    def search_ranks(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return self._executor.search_ranks(*args, **kw)
        finally:
            self.search_s.append(time.perf_counter() - t0)


async def run_leg(index, executor, wl, *, qps, duration_s, serve_cfg,
                  faults, k, seed, served=None):
    """One open-loop Poisson leg; returns outcome counts + percentiles.
    ``served``: a list that receives ``(pool index, Result)`` of every
    served request (the caller's recall check)."""
    timed = TimedExecutor(executor)
    eng = AsyncServingEngine(
        index, serve=serve_cfg, executor=timed, faults=faults
    )
    rng = np.random.default_rng(seed)
    nq = len(wl.queries)
    # value-space bounds for the workload's rank ranges
    lo = index.attrs[wl.L]
    hi = index.attrs[wl.R]
    arrivals = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / qps)
        if t >= duration_s:
            break
        arrivals.append(t)
    outcomes: list[tuple[str, float]] = []
    late: list[float] = []

    async def fire(j, due):
        # sleep to the arrival's time on the schedule, not after the task
        # happened to start
        await asyncio.sleep(max(t_start + due - time.monotonic(), 0.0))
        i = j % nq
        t0 = time.monotonic()
        late.append(t0 - t_start - due)
        try:
            res = await eng.submit(Request(wl.queries[i], lo[i], hi[i], k=k))
            kind = "ok"
            if served is not None:
                served.append((i, res))
        except OverloadedError:
            kind = "rejected"
        except ShedError:
            kind = "shed"
        except DeadlineExceededError:
            kind = "timeout"
        except ShutdownError:
            kind = "shutdown"
        except Exception:  # noqa: BLE001 — typed flush failures
            kind = "failed"
        outcomes.append((kind, time.monotonic() - t0))

    t_start = time.monotonic()
    await asyncio.gather(*(
        asyncio.create_task(fire(j, a)) for j, a in enumerate(arrivals)
    ))
    await eng.aclose(drain=True)
    wall = time.monotonic() - t_start
    counts = Counter(kind for kind, _ in outcomes)
    ok_lat = np.array([l for kind, l in outcomes if kind == "ok"])
    offered = len(arrivals)
    out = {
        "target_qps": float(qps),
        "duration_s": float(duration_s),
        "offered": offered,
        "resolved": len(outcomes),
        "lost": offered - len(outcomes),
        **{kind: int(counts.get(kind, 0)) for kind in OUTCOMES},
        "shed_rate": counts.get("shed", 0) / max(offered, 1),
        "timeout_rate": counts.get("timeout", 0) / max(offered, 1),
        "reject_rate": counts.get("rejected", 0) / max(offered, 1),
        "achieved_qps": counts.get("ok", 0) / max(wall, 1e-9),
        "p50_ms": float(np.percentile(ok_lat, 50) * 1e3) if len(ok_lat)
        else None,
        "p99_ms": float(np.percentile(ok_lat, 99) * 1e3) if len(ok_lat)
        else None,
        "wall_s": wall,
        "generator_late_ms": _pcts(late),
        # the executor's time a flush inside the loop, GIL waits included
        # (a flush still running when the last request resolved is left
        # out: the leg does not wait for its worker thread)
        "search_ms": _pcts(timed.search_s),
        "timeout_late_ms": _pcts([l - serve_cfg.deadline_s
                                  for kind, l in outcomes
                                  if kind == "timeout"]),
        "engine": {kk: v for kk, v in eng.stats.items()
                   if isinstance(v, int)},
    }
    if eng.faults is not None:
        out["injected"] = dict(eng.faults.counts)
    return out


def leg_line(name: str, leg: dict) -> str:
    def ms(v):
        return "-" if v is None else f"{v:.1f}"

    tl = leg["timeout_late_ms"]
    return (f"{name}: target {leg['target_qps']:.0f} qps, offered "
            f"{leg['offered']}, ok {leg['ok']} (p50 {ms(leg['p50_ms'])}ms "
            f"p99 {ms(leg['p99_ms'])}ms), shed {leg['shed']}, timeout "
            f"{leg['timeout']} (late p50 {ms(tl['p50'])}ms max "
            f"{ms(tl['max'])}ms), rejected {leg['rejected']}, failed "
            f"{leg['failed']}, lost {leg['lost']}; search a flush mean "
            f"{ms(leg['search_ms']['mean'])}ms")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="ytaudio-like",
                    choices=sorted(common.BENCH_DATASETS))
    ap.add_argument("--n", type=int, default=None,
                    help="scale the dataset as bench/run.py does")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    ap.add_argument("--max-batch", type=int, default=MAX_BATCH)
    ap.add_argument("--duration", type=float, default=DURATION_S)
    ap.add_argument("--deadline", type=float, default=DEADLINE_S)
    ap.add_argument("--smoke", action="store_true",
                    help="short legs: a regression probe for the serving "
                         "loop, not a measurement")
    ap.add_argument("--out-dir", default=None,
                    help="where the JSON record goes (default: artifacts/)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.duration = 1.0
        args.max_batch = 16
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    index = common.build_index(args.dataset, n=args.n, device=dev)
    common.sync(dev)
    build_s = time.perf_counter() - t0
    k = common.DEFAULT_K
    executor = SearchExecutor(index, SearchConfig(ef=EF, k_bucket=k),
                              max_batch=args.max_batch)
    # warm exactly the grid the legs use, on this thread: every batch
    # bucket at one k (the first launches also build the kernels)
    warmed = executor.warmup(k_buckets=(k,))
    wl = common.make_workload(index, "mixed", n_queries=256)
    cap = measure_capacity(executor, wl, k)
    print(f"index {args.dataset} n={index.n} d={index.dim} built in "
          f"{build_s:.1f} s on {dev}; capacity ~{cap:.0f} qps "
          f"(max_batch={args.max_batch}, {warmed} entries warmed)",
          flush=True)

    serve_cfg = serve_config(cap, max_batch=args.max_batch,
                             deadline_s=args.deadline)
    legs = {}
    for name, (factor, seed, inject) in LEGS.items():
        legs[name] = asyncio.run(run_leg(
            index, executor, wl, qps=factor * cap,
            duration_s=args.duration, serve_cfg=serve_cfg,
            faults=leg_faults(inject, args.deadline), k=k, seed=seed,
        ))
        print(leg_line(name, legs[name]), flush=True)

    post_warmup = executor.stats["compiles"] - executor.stats[
        "warmup_compiles"]
    print(f"executor: {executor.stats['compiles']} entries, "
          f"{post_warmup} post-warmup", flush=True)
    payload = {
        "host": {**common.device_info(dev), "card_line": common.card_line(),
                 "smoke": args.smoke},
        "config": {
            "dataset": args.dataset, "n": index.n, "dim": index.dim,
            "n_override": args.n, "max_batch": args.max_batch,
            "duration_s": args.duration, "k": k, "ef": EF,
            "deadline_s": serve_cfg.deadline_s,
            "max_queue": serve_cfg.max_queue,
            "backpressure": serve_cfg.backpressure,
            "max_wait_s": serve_cfg.max_wait_s,
            "deadline_margin_s": serve_cfg.deadline_margin_s,
        },
        "build_s": build_s,
        "capacity_qps": float(cap),
        **legs,
        "serve": {
            "compiles": int(executor.stats["compiles"]),
            "warmup_compiles": int(executor.stats["warmup_compiles"]),
            "post_warmup_compiles": int(post_warmup),
        },
    }
    name = "BENCH_torch_serve_slo" + ("_smoke" if args.smoke else "")
    out_dir = args.out_dir or common.artifacts_dir()
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, name + ".json")
    with open(out, "w") as f:
        json.dump(payload, f, indent=2)
    print("wrote", out)
    bad = [name for name, leg in legs.items() if leg["lost"]]
    if bad or post_warmup:
        print(f"FAILED: lost requests in {bad}, {post_warmup} post-warmup "
              "entries")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
