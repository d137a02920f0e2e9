"""One run of one cell: set-up, the measured window, the comparison.

Set-up makes the deployment's data and the request pool from the seed,
builds the index with ``RangeGraphIndex.build``, starts a
``ServingEngine`` and warms the one shape the traffic uses. The window
drives the engine as a closed loop: every client has one request
outstanding; all of them are submitted, then flushed, and each client
sends the next request of the pool once its result is back. After the
window the peak memory is read, the index is checked, the program's state
is freed, and the reference judges every answer of the window.
"""
from __future__ import annotations

import dataclasses
import gc
import resource
import sys
import time
import types

import numpy as np
import torch

from rfbench import gen, judge, reference, spec, yardstick
from rfbench.trace import Recorder, Stretch, warm_profiler

# share of the window before the profiled stretch, and its most seconds
STRETCH_AT = 1 / 3
STRETCH_MAX_S = 5.0


def _program():
    """The system under test (imported here, so a checkout without it
    fails when a run starts)."""
    from repro_torch.core import build as build_mod
    from repro_torch.core import config as config_mod
    from repro_torch.core import index as index_mod
    from repro_torch.core import storage as storage_mod
    from repro_torch.serve import engine as engine_mod

    return types.SimpleNamespace(
        BuildConfig=build_mod.BuildConfig,
        SearchConfig=config_mod.SearchConfig,
        RangeGraphIndex=index_mod.RangeGraphIndex,
        StorageConfig=storage_mod.StorageConfig,
        decode_neighbors=storage_mod.decode_neighbors,
        ServingEngine=engine_mod.ServingEngine,
        Request=engine_mod.Request,
        Result=engine_mod.Result,
    )


@dataclasses.dataclass
class _Flush:
    """What the clients of one flush got back. The window only takes the
    result rows' arrays (no per-request work beyond that), and keeps no
    result object, so the collector's work does not grow with it; a flush
    in which some request failed keeps its list whole."""
    t_ret: float
    pidx: np.ndarray     # int64 [B], the pool request each client sent
    tsub: list           # [B] perf_counter() before each submit
    ids: list | None     # [B] arrays of k ids, None where a request failed
    dists: list | None
    out: list | None     # the engine's list, where a request failed

    def arrays(self, result_type, k):
        """(ok [B], ids [B, k], dists [B, k], lat [B])."""
        lat = self.t_ret - np.asarray(self.tsub)
        if self.out is None:
            return (np.ones(len(self.ids), bool), np.stack(self.ids),
                    np.stack(self.dists), lat)
        ok = np.array([isinstance(r, result_type) for r in self.out], bool)
        ids = np.full((len(self.out), k), -1, np.int64)
        dists = np.full((len(self.out), k), np.inf, np.float32)
        for j in ok.nonzero()[0]:
            ids[j], dists[j] = self.out[j].ids, self.out[j].dists
        return ok, ids, dists, lat


def host_usage(start: dict | None = None, wall: float | None = None):
    """The host's side of the window: this thread's and this process's
    CPU seconds, the process's involuntary context switches, and the
    machine's CPU ticks by kind (``/proc/stat``). With ``start`` (an
    earlier reading) and the window's ``wall`` seconds: the shares over the
    window. A thread share under 1 is time the host loop waited or was not
    run; steal is time the machine's host took from its CPUs."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    now = {"thread_s": time.thread_time(),
           "process_s": ru.ru_utime + ru.ru_stime,
           "involuntary_switches": ru.ru_nivcsw, "ticks": None}
    try:
        with open("/proc/stat") as f:
            now["ticks"] = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        pass
    if start is None:
        return now
    out = {"thread_cpu_share": (now["thread_s"] - start["thread_s"]) / wall,
           "process_cpu_share": (now["process_s"] - start["process_s"])
           / wall,
           "involuntary_switches": now["involuntary_switches"]
           - start["involuntary_switches"]}
    if now["ticks"] and start["ticks"]:
        d = [b - a for a, b in zip(start["ticks"], now["ticks"])]
        # user nice system idle iowait irq softirq steal
        out["machine_steal_share"] = d[7] / (sum(d) or 1)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels(device) -> float:
    """Build the port's CUDA kernels into the checkout's cache (its
    ``build/repro_torch/<hash>/``); 0.0 when they are built already."""
    if device.type != "cuda":
        return 0.0
    from repro_torch.kernels import _build

    return _build.build_all()


def run_cell(root, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float | None = None,
             log=None) -> dict:
    """Run the cell ``name`` once; returns the result line's fields."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = spec.load_cell(root, name)
    dep, traffic = cell.deployment, cell.traffic
    pg = _program()
    kernels_s = build_kernels(device)

    # -- set-up ---------------------------------------------------------------
    data, pool = gen.make(dep, traffic, seed, device)
    _sync(device)
    level_times = [] if trace else None
    t0 = time.perf_counter()
    vec_host = data.vectors.cpu().numpy()
    attrs_host = data.attrs.cpu().numpy()
    index = pg.RangeGraphIndex.build(
        vec_host, attrs_host, pg.BuildConfig(**dep["build"]), device=device,
        storage=pg.StorageConfig(**dep["storage"]), level_times=level_times)
    _sync(device)
    build_s = time.perf_counter() - t0
    del vec_host, attrs_host

    k = int(traffic["k"])
    clients = int(traffic["clients"])
    max_batch = int(traffic["max_batch"])
    engine = pg.ServingEngine(
        index, config=pg.SearchConfig(**traffic["search"]),
        max_batch=max_batch, warmup=False)
    engine.warmup(batch_buckets=[max_batch], k_buckets=[k])
    q_host = pool.q.cpu().numpy()
    lo_host = pool.lo.cpu().numpy()
    hi_host = pool.hi.cpu().numpy()
    reqs = [pg.Request(q_host[i], float(lo_host[i]), float(hi_host[i]), k)
            for i in range(q_host.shape[0])]
    P = len(reqs)
    # one flush of real requests through the engine, as the window sends
    for i in range(clients):
        engine.submit(reqs[i % P])
    engine.flush()
    _sync(device)
    compiles = engine.stats["compiles"]
    rec = Recorder() if trace else None
    if trace:
        rec.wrap_search(engine.executor)
        if device.type == "cuda":
            warm_profiler(device)
    # the pool and the index live for the whole run: the window's garbage
    # collections need not scan them
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    # -- the window -----------------------------------------------------------
    batches = []
    cursor = 0
    stretch = None
    clock, submit = time.perf_counter, engine.submit
    host0 = host_usage()
    t_win = time.perf_counter()
    deadline = t_win + seconds
    t_ret = t_win
    while t_ret < deadline:
        if trace and device.type == "cuda":
            elapsed = t_ret - t_win
            if stretch is None and elapsed >= STRETCH_AT * seconds:
                stretch = Stretch()
                stretch_len = min(STRETCH_MAX_S, STRETCH_AT * seconds)
                stretch_end = time.perf_counter() + stretch_len
            elif stretch is not None and stretch.t1 is None \
                    and t_ret >= stretch_end:
                stretch.stop()
        idx = (np.arange(cursor, cursor + clients) % P)
        cursor += clients
        tsub = []
        stamp = tsub.append
        a0 = time.time_ns() if trace else 0
        for p in idx.tolist():
            stamp(clock())
            submit(reqs[p])
        if trace:
            f0 = time.time_ns()
            rec.submits.append((a0, f0))
        out = engine.flush()
        t_ret = clock()
        if trace:
            rec.flushes.append((f0, time.time_ns()))
        try:
            batches.append(_Flush(t_ret, idx, tsub, [r.ids for r in out],
                                  [r.dists for r in out], None))
        except AttributeError:   # an exception in place of a result
            batches.append(_Flush(t_ret, idx, tsub, None, None, out))
    if stretch is not None and stretch.t1 is None:
        stretch.stop()
    window_s = t_ret - t_win
    host = host_usage(host0, window_s)
    flush_s = np.diff([t_win] + [b.t_ret for b in batches])
    log(f"window: {len(batches)} flushes of {clients} in {window_s:.3f} s; "
        f"a flush {flush_s.min():.4f} / {np.median(flush_s):.4f} / "
        f"{flush_s.max():.4f} s (least / median / most)")
    log("host in the window: " + ", ".join(f"{k} {v}" for k, v in
                                           host.items()))
    t_after = time.perf_counter()

    # -- after the window -----------------------------------------------------
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    perm_mismatch = int((torch.as_tensor(index.perm, device=device)
                         != data.order).sum())
    bad_edges = judge.table_faults(pg.decode_neighbors(index.neighbors),
                                   int(dep["n"]))
    new_compiles = engine.stats["compiles"] - compiles
    engine.close()
    del engine, index
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    attempted = clients * len(batches)
    parts = [b.arrays(pg.Result, k) for b in batches]
    got = np.concatenate([p[0] for p in parts])
    failed = attempted - int(got.sum())
    pidx = np.concatenate([b.pidx for b in batches])[got]
    ids = np.concatenate([p[1] for p in parts])[got]
    dists = np.concatenate([p[2] for p in parts])[got]
    lat = np.concatenate([p[3] for p in parts])[got]
    del parts, batches
    N_ok = len(pidx)

    t_ref = time.perf_counter()
    exact = reference.exact_topk(data, pool, k)
    numbers = judge.judge_answers(
        data, pool, exact, torch.from_numpy(pidx), torch.from_numpy(ids),
        torch.from_numpy(dists), k=k)
    log(f"after the window: {t_ref - t_after:.2f} s to collect, "
        f"{time.perf_counter() - t_ref:.2f} s for the reference and the "
        f"comparison")
    numbers.update(unanswered=failed, perm_mismatch=perm_mismatch,
                   bad_edges=bad_edges)
    correct, checks = judge.compare(numbers, cell.limits["checks"])

    def counts(searches):
        return dict(n_dists=sum(s.n_dists for s in searches),
                    n_hops=sum(s.n_hops for s in searches),
                    n_queries=sum(s.rows for s in searches),
                    n=int(dep["n"]), d=int(dep["d"]),
                    m=int(dep["build"]["m"]),
                    vector_dtype=dep["storage"]["vector_dtype"])

    ctx = types.SimpleNamespace(
        device_type=device.type, setup_s=setup_s, build_s=build_s,
        window_s=window_s, answered=N_ok, attempted=attempted,
        latencies=lat, numbers=numbers, level_times=level_times, rec=rec,
        stretch=None, deployment=dep, traffic=traffic,
        bytes_of=lambda searches: yardstick.search_bytes(**counts(searches)),
        hop_bytes_of=lambda searches: yardstick.hop_bytes(
            **counts(searches)))
    if stretch is not None:
        ctx.stretch = stretch.read(rec)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {
        "correct": bool(correct) and failed == 0,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace and ctx.stretch:
        result["device"]["busy_s"] = ctx.stretch["busy_s"]
        result["device"]["window_s"] = ctx.stretch["window_s"]
        result["breakdown"] = {"device_ops": ctx.stretch["device_ops"],
                               "idle_gaps": ctx.stretch["idle_gaps"]}
    log(f"setup: {setup_s:.3f} s, of which the kernels' build "
        f"{kernels_s:.3f} s (0 where the checkout had them) and the index "
        f"build {build_s:.3f} s; cache entries added in the window: "
        f"{new_compiles}")
    # outside the metrics: what explains a first run's set-up, and the
    # host's share of the window (the served path is host-bound)
    result["run"] = {"kernels_built_s": kernels_s, "window_s": window_s,
                     "flushes": len(flush_s), "host": host}
    result["checks"] = checks   # last: each number beside its limit
    return result
