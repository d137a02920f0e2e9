"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake
process group (port of ``repro/launch/dryrun.py``).

This is the proof that the distribution config holds together without
the hardware. A ``fake`` process group of the mesh's size stands in
for the cards: its collectives move nothing. Under ``FakeTensorMode``
the cell's real step runs on rank 0 of a 16 x 16 or 2 x 16 x 16
``DeviceMesh``: the parameters, optimizer state and inputs are DTensors
laid out by ``Model.param_shardings`` and ``launch/specs.py``, every
tensor is a fake one (shapes, no memory), and every op runs its plain
torch version (the kernels take raw pointers and cannot see a fake
tensor; ``repro`` likewise pins ``attention_impl="xla"``). Eager tracing
runs every layer, so a full-depth trace is exact: nothing is
extrapolated.

A dispatch mode below DTensor (:class:`LocalCost`) sees each rank-local
op and counts, for rank 0:

  * FLOPs by ``torch.utils.flop_counter``'s formulas on the local shapes
    (a replicated op counts once per rank);
  * bytes: every non-view op's input and output bytes, an eager count
    that overstates what a fused program moves (no XLA ``bytes accessed``
    here);
  * collectives: the output bytes of each collective the DTensors issue;
  * bytes per device: the peak of the live local storages, parameters,
    optimizer state and inputs included.

Records keep ``repro``'s keys (``hlo_gflops`` and ``hlo_gbytes`` global,
rank 0's count x ranks; ``collectives`` per device) and add
``param_bytes``, ``opt_state_bytes``, ``collectives_by_site`` (each
collective's bytes by the function or backward node that issued it),
``counted`` (how each figure was counted), ``replicated`` (regions that
computed the same on every rank of an axis they could split, a memory
cost) and ``hardware``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod --out d.jsonl
  python -m repro_torch.launch.dryrun --paper-system   # RFANN serve cell
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import PRODUCTION_SHAPES, mesh_of
from repro_torch.models.api import Model, count_params
from repro_torch.sharding import partitioning as part
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import build_decode_step, build_train_step

__all__ = ["LocalCost", "fake_group", "skip_reason", "trace_cell",
           "run_cell", "run_paper_system_cell", "mesh_name", "main"]

# ---------------------------------------------------------------------------
# hardware model: NVIDIA H100 SXM 80GB, from its data sheet (not measured)
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s a card (data sheet)
HBM_BW = 3.35e12             # bytes/s a card (data sheet)
HBM = 80e9                   # bytes a card (data sheet)
LINK_BW = 50e9               # bytes/s a GPU over the inter-node fabric:
                             # a 16-wide model axis spans two 8-GPU nodes
HARDWARE = {
    "card": "NVIDIA H100 SXM 80GB",
    "source": "data sheet, not measured",
    "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "hbm_bytes": HBM,
    "link_bw": LINK_BW,
}
COUNTED = {
    "flops": "torch.utils.flop_counter formulas on rank 0's local op "
             "shapes under FakeTensorMode, x ranks",
    "bytes": "every non-view local op's input + output bytes on rank 0, "
             "x ranks: an eager count, above what a fused program moves",
    "collectives": "output bytes of each collective rank 0 issued "
                   "(funcol and c10d), per device",
    "collectives_by_site": "the same bytes by where they were issued: "
                           "the innermost repro_torch function outside "
                           "sharding/partitioning.py in forward, the "
                           "autograd node in backward",
    "bytes_per_device": "peak live local storage bytes on rank 0 "
                        "(parameters, optimizer state and inputs included)",
    "depth": "every layer traced eagerly (no extrapolation)",
}

_COLL = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _local(t):
    return t.to_local() if part.is_dtensor(t) else t


def _meta_propagation():
    """DTensor's sharding propagator and the name of its method that runs
    an op on fake global-shape tensors to learn the output's metadata."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        if hasattr(ShardingPropagator, name):
            return ShardingPropagator, name
    raise RuntimeError("DTensor's tensor-meta propagation was not found: "
                       "its global-shape ops would count as rank-local work")


def _site() -> str:
    """Where a collective was issued: the autograd node running in
    backward, else the innermost function of the port outside
    ``sharding/partitioning.py`` and this module (``dir/file.py:fn``)."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return "backward:" + node.name()
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename.replace(os.sep, "/")
        if "/repro_torch/" in path and not path.endswith(
                ("/sharding/partitioning.py", "/launch/dryrun.py")):
            return f"{path.rsplit('/repro_torch/', 1)[1]}:{f.f_code.co_name}"
        f = f.f_back
    return "other"


class LocalCost(TorchDispatchMode):
    """Counts the rank-local ops below DTensor: FLOPs, bytes, collective
    bytes and the peak of live storage bytes. Ops on DTensors are left to
    DTensor (``NotImplemented``), whose local ops then come here; the ops
    DTensor runs on global shapes to propagate metadata are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_fns = flop_registry
        self.flops = 0
        self.bytes = 0
        self.by_site: dict = {}
        self.coll: dict = {}
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self._quiet = 0
        self._patched = None

    def __enter__(self):
        cls, name = _meta_propagation()
        orig = getattr(cls, name)

        def quiet(prop, *a, **kw):
            self._quiet += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                self._quiet -= 1

        setattr(cls, name, quiet)
        self._patched = (cls, name, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, name, orig = self._patched
        setattr(cls, name, orig)
        return super().__exit__(*exc)

    def _free(self, key):
        self.live -= self._storages.pop(key, 0)

    def hold(self, tree) -> int:
        """Track the storages of a tree's tensors (DTensors: their local
        shards) from now on; returns their bytes."""
        n = 0
        for leaf in _tensors(tree):
            n += self._track(_local(leaf))
        return n

    def _track(self, t) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return 0
        nbytes = st.nbytes()
        self._storages[key] = nbytes
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and not issubclass(
                t, torch._subclasses.fake_tensor.FakeTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        name = func._overloadpacket.__name__
        kind = _COLL.get(name)
        if kind is not None:
            if name.endswith("_") and args:   # c10d: outputs are args[0]
                nbytes = sum(t.nbytes for t in _tensors(args[0]))
            else:
                nbytes = sum(t.nbytes for t in _tensors(out))
            self.coll[kind] = self.coll.get(kind, 0) + nbytes
            self.coll["count_" + kind] = self.coll.get("count_" + kind,
                                                       0) + 1
            site = self.by_site.setdefault(_site(), {})
            site[kind] = site.get(kind, 0) + nbytes
            return out
        fn = self._flop_fns.get(func._overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes += sum(t.nbytes for t in _tensors((args, kwargs)))
            self.bytes += sum(t.nbytes for t in _tensors(out))
            for t in _tensors(out):
                self._track(t)
        return out


class _AssumeActive(TorchDispatchMode):
    """Answers a host read of a boolean (the beam loop's ``bool(active
    .any())``, which a fake tensor cannot answer) with ``True``, as the
    real loop sees while a query is active; any other read still raises."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default and \
                args[0].dtype == torch.bool:
            return True
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0 (one that is already open with that size is reused)."""
    if dist.is_initialized() and dist.get_backend() == "fake" and \
            dist.get_world_size() == world:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("another process group is open; the dry-run "
                           "opens its own fake one")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(shape: dict) -> str:
    return "x".join(str(n) for n in shape.values())


def skip_reason(arch: str, shape: str) -> str | None:
    cfg = get_arch(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 500k dense KV decode is out of scope "
                "per assignment (sub-quadratic archs only)")
    return None


def _fake_inputs(spec, sharding, mesh):
    """DTensors of fake zeros for a tree of BatchSpecs and shardings."""
    if isinstance(spec, dict):
        return {k: _fake_inputs(spec[k], sharding[k], mesh) for k in spec}
    if spec is None:
        return None
    local = torch.zeros(sharding.shard_shape(spec.shape), dtype=spec.dtype,
                        device=mesh.device_type)
    return part.from_shard(local, mesh, sharding.spec, spec.shape)


def _nbytes(tree) -> int:
    return sum(_local(t).nbytes for t in _tensors(tree))


def _trace(cfg, shape, mesh, microbatches) -> dict:
    """Run the cell's step once on fake DTensors; returns its counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = Model(cfg)
    part.REPLICATED.clear()
    cost = LocalCost()
    t0 = time.time()
    with FakeTensorMode(), part.use_global_mesh(mesh):
        params = model.abstract(mesh)
        ispecs = specs_mod.input_specs(cfg, shape)
        ishards = specs_mod.input_shardings(cfg, shape, mesh)
        out = {"param_bytes": _nbytes(params)}
        with cost:
            cost.hold(params)
            if shape.kind == "train":
                opt = init_opt_state(params)
                out["opt_state_bytes"] = _nbytes(opt)
                batch = _fake_inputs(ispecs["batch"], ishards["batch"], mesh)
                cost.hold(batch)
                step = build_train_step(model, AdamWConfig(),
                                        microbatches=microbatches)
                step(params, opt, batch)
            elif shape.kind == "prefill":
                inputs = _fake_inputs(ispecs["inputs"], ishards["inputs"],
                                      mesh)
                cost.hold(inputs)
                model.prefill(params, **inputs)
            else:
                token = _fake_inputs(ispecs["token"], ishards["token"], mesh)
                cache = _fake_inputs(ispecs["cache"], ishards["cache"], mesh)
                cost.hold((token, cache))
                build_decode_step(model)(params, token, cache,
                                         shape.seq_len - 1)
    out.update(seconds=time.time() - t0, flops=cost.flops,
               bytes=cost.bytes, coll=dict(cost.coll), by_site=cost.by_site,
               peak=cost.peak,
               replicated=dict(part.REPLICATED))
    return out


def _roofline(rec, flops, bytes_acc, coll, n_ranks) -> None:
    """repro's roofline keys from rank 0's counts."""
    coll = dict(coll)
    coll["total"] = sum(v for k, v in coll.items()
                        if not k.startswith("count"))
    rec["hlo_gflops"] = flops * n_ranks / 1e9            # global
    rec["hlo_gbytes"] = bytes_acc * n_ranks / 1e9        # global
    rec["collectives"] = {k: int(v) for k, v in coll.items()}  # per device
    rec["t_compute"] = flops / PEAK_FLOPS
    rec["t_memory"] = bytes_acc / HBM_BW
    rec["t_collective"] = coll["total"] / LINK_BW
    terms = {k: rec["t_" + k] for k in ("compute", "memory", "collective")}
    rec["bottleneck"] = max(terms, key=terms.get)


def trace_cell(cfg, shape, mesh_shape: dict) -> dict:
    """One (config x shape) cell on a fake mesh of ``mesh_shape`` (axis
    name -> size): the record, with the microbatch retry of train cells
    that do not fit a card's memory."""
    n_ranks = math.prod(mesh_shape.values())
    rec = {"arch": cfg.name, "shape": shape.name,
           "mesh": mesh_name(mesh_shape)}
    cfg = dataclasses.replace(cfg, attention_impl="torch")
    with fake_group(n_ranks):
        mesh = mesh_of(mesh_shape)
        # initial microbatch guess from a napkin activation model:
        # saved-resident activations ~ L * B_local * S * d * 2B
        microbatches = 1
        # a microbatch splits each rank's batch shard: 4x more while it
        # divides
        entry = part.logical_to_spec(("batch",), mesh_shape,
                                     (shape.global_batch,))[0]
        axes = entry if isinstance(entry, tuple) else (entry,) if entry \
            else ()
        shard = shape.global_batch // math.prod(mesh_shape[a] for a in axes)

        def more(mb):
            return mb < 16 and shard % (mb * 4) == 0

        if shape.kind == "train":
            b_local = shape.global_batch / mesh_shape["data"]
            act = cfg.n_layers * b_local * shape.seq_len * cfg.d_model * 2
            while act / microbatches > 4e9 and more(microbatches):
                microbatches *= 4
        t = _trace(cfg, shape, mesh, microbatches)
        rec["status"] = "ok"
        rec["compile_s"] = round(t["seconds"], 1)
        rec["bytes_per_device"] = t["peak"]
        if shape.kind == "train":
            while rec["bytes_per_device"] > HBM and more(microbatches):
                rec.setdefault("bytes_per_device_mb1",
                               rec["bytes_per_device"])
                microbatches *= 4
                t = _trace(cfg, shape, mesh, microbatches)
                rec["bytes_per_device"] = t["peak"]
                rec["compile_s"] += round(t["seconds"], 1)
            rec["microbatches"] = microbatches
    rec["param_bytes"] = t["param_bytes"]
    if "opt_state_bytes" in t:
        rec["opt_state_bytes"] = t["opt_state_bytes"]
    _roofline(rec, t["flops"], t["bytes"], t["coll"], n_ranks)
    rec["collectives_by_site"] = t["by_site"]
    # model flops (6 N D for train; 2 N D for a decode/prefill token pass)
    n_active = count_params(cfg, active_only=True)
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)
    factor = 6 if shape.kind == "train" else 2
    rec["model_gflops"] = factor * n_active * tokens / 1e9
    rec["useful_flop_frac"] = (
        rec["model_gflops"] / rec["hlo_gflops"] if t["flops"] else None)
    if microbatches > 1:
        rec["collective_note"] = (
            f"microbatching x{microbatches}: the trace ran every "
            f"microbatch, so the parameter all-gathers of each are counted "
            f"({rec['collectives'].get('all-gather', 0) / 1e9:.1f} "
            f"GB/device in all)")
    rec["replicated"] = t["replicated"]
    rec["counted"] = COUNTED
    rec["hardware"] = HARDWARE
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides: dict | None = None, mesh_shape: dict | None = None,
             batch: int | None = None, seq: int | None = None) -> dict:
    """One cell on a production mesh (or on ``mesh_shape``); ``batch`` /
    ``seq`` cut the shape's global batch and sequence (``"cut"`` in the
    record)."""
    mesh_shape = mesh_shape or PRODUCTION_SHAPES[multi_pod]
    print(f"# cell {arch} {shape_name} mesh={mesh_name(mesh_shape)}",
          file=sys.stderr, flush=True)
    reason = skip_reason(arch, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name,
                "mesh": mesh_name(mesh_shape),
                "status": "skipped", "reason": reason}
    cfg = dataclasses.replace(get_arch(arch), **(overrides or {}))
    shape = SHAPES[shape_name]
    cut = {k: v for k, v in (("global_batch", batch), ("seq_len", seq))
           if v is not None}
    rec = trace_cell(cfg, dataclasses.replace(shape, **cut), mesh_shape)
    if cut:
        rec["cut"] = cut
    return rec


def run_paper_system_cell(*, multi_pod: bool, n_per_shard=65536, dim=768,
                          m=16, ef=64, k=10, qbatch=4096,
                          vec_dtype="float32", nbr_dtype="int32",
                          mesh_shape: dict | None = None) -> dict:
    """The paper's own serve step on the production mesh (RFANN cell):
    ``core/distributed.py::rfann_serve_step`` on rank 0, shards over
    ``data``, the queries split over the other axes (``repro``'s
    ``("pod", "model")``). The beam loop runs one iteration
    (``max_iters=1``, its host check answered by :class:`_AssumeActive`):
    its prologue, one ``body`` and its epilogue, as XLA's cost analysis
    counts a ``while_loop`` body once."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import distributed as dist_mod
    from repro_torch.core.config import SearchConfig

    shape = mesh_shape or PRODUCTION_SHAPES[multi_pod]
    n_ranks = math.prod(shape.values())
    S = shape["data"]
    logn = int(math.ceil(math.log2(n_per_shard)))
    layers = logn + 1
    rec = {"arch": "iRangeGraph-serve",
           "shape": f"q{qbatch}_n{S * n_per_shard}", "mesh": mesh_name(shape)}
    cost = LocalCost()
    t0 = time.time()
    with fake_group(n_ranks):
        layout = dist_mod.ShardLayout(S, n_ranks // S, device="cpu")
        step = dist_mod.make_serve_step(layout, logn=logn, m=m, k=k,
                                        config=SearchConfig(ef=ef,
                                                            max_iters=1))
        with FakeTensorMode():
            args = (
                torch.empty((n_per_shard, dim), dtype=getattr(torch,
                                                              vec_dtype)),
                torch.empty((n_per_shard, layers, m),
                            dtype=getattr(torch, nbr_dtype)),
                torch.zeros((2,), dtype=torch.int32),
                torch.empty((qbatch, dim), dtype=getattr(torch, vec_dtype)),
                torch.zeros((qbatch,), dtype=torch.int32),
                torch.zeros((qbatch,), dtype=torch.int32),
            )
            with cost, _AssumeActive():
                cost.hold(args)
                step(*args)
    rec["status"] = "ok"
    rec["compile_s"] = round(time.time() - t0, 1)
    rec["bytes_per_device"] = cost.peak
    _roofline(rec, cost.flops, cost.bytes, cost.coll, n_ranks)
    rec["collectives_by_site"] = cost.by_site
    rec["counted"] = dict(COUNTED, depth="the beam loop's prologue, one "
                          "iteration of its body and its epilogue")
    rec["replicated"] = {}
    rec["hardware"] = HARDWARE
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--paper-system", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--override", default="",
                    help="cfg overrides k=v,... (hillclimb variants)")
    ap.add_argument("--skip-archs", default="",
                    help="comma-separated archs to skip (resume support)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="a (data, model) mesh in place of the production "
                         "ones")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the shape's global batch to this")
    ap.add_argument("--seq", type=int, default=None,
                    help="cut the shape's sequence length to this")
    args = ap.parse_args(argv)
    mesh_shape = None
    if args.mesh:
        data, model = (int(n) for n in args.mesh.lower().split("x"))
        mesh_shape = {"data": data, "model": model}

    overrides = {}
    for kv in filter(None, args.override.split(",")):
        k, v = kv.split("=")
        overrides[k] = {"true": True, "false": False}.get(
            v.lower(), v if not v.replace(".", "").isdigit()
            else (float(v) if "." in v else int(v))
        )

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]
    if mesh_shape is not None:
        meshes = [None]

    outf = None
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        outf = open(args.out, "w")

    def emit(rec):
        print(json.dumps(rec))
        sys.stdout.flush()
        if outf:
            outf.write(json.dumps(rec) + "\n")
            outf.flush()

    if args.paper_system:
        for mp in meshes:
            emit(run_paper_system_cell(
                multi_pod=bool(mp), mesh_shape=mesh_shape,
                vec_dtype=str(overrides.get("vec_dtype", "float32")),
                nbr_dtype=str(overrides.get("nbr_dtype", "int32"))))
    else:
        if args.all:
            skip = set(filter(None, args.skip_archs.split(",")))
            by_cost = sorted(ARCHS, key=lambda a: count_params(ARCHS[a]))
            cells = [(a, s) for a in by_cost if a not in skip
                     for s in SHAPES]
        else:
            if not (args.arch and args.shape):
                ap.error("--arch and --shape, or --all")
            cells = [(args.arch, args.shape)]
        for a, s in cells:
            for mp in meshes:
                try:
                    rec = run_cell(a, s, multi_pod=bool(mp),
                                   overrides=overrides, mesh_shape=mesh_shape,
                                   batch=args.batch, seq=args.seq)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    rec = {"arch": a, "shape": s,
                           "mesh": mesh_name(mesh_shape
                                             or PRODUCTION_SHAPES[mp]),
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                emit(rec)
    if outf:
        outf.close()


if __name__ == "__main__":
    main()
