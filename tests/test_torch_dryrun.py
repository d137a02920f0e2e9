"""The port's dry-run (``launch/dryrun.py``) and its renderer
(``bench/render_experiments.py``) on the CPU.

Held here:

  * counting below DTensor: on a 2 x 2 fake mesh a replicated matmul
    counts its FLOPs once per rank (the record's global figure is four
    times the product's), a batch-split one a quarter of them per rank,
    and DTensor's global-shape metadata ops count nothing;
  * reduced cells on a 2 x 2 fake mesh -- train, prefill and decode of a
    dense and a MoE config, and the paper's serve step -- give records
    with ``repro``'s keys, ``status`` "ok", FLOPs, bytes and a
    bottleneck, and ``model_gflops`` equal to ``repro``'s formula on
    ``repro``'s own parameter count;
  * on a 1 x 1 mesh the traced parameter and AdamW-state bytes equal
    those of the real tensors; the microbatch retry stops where 4x more
    microbatches no longer divide a rank's batch shard;
  * the production meshes on fake groups of 256 and 512 ranks;
  * the renderer's table on a fixed set of records is the text
    ``repro``'s renderer writes for them, but for the line that names the
    hardware model and the records' file name.
"""
import dataclasses
import importlib.util
import json
import math
import pathlib

import pytest
import torch

from repro_torch.bench import render_experiments as trender
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, mesh_of
from repro_torch.models import api
from repro_torch.sharding import partitioning as part
from repro_torch.train.optimizer import init_opt_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = {"data": 2, "model": 2}
REPRO_CELL_KEYS = {
    "arch", "shape", "mesh", "status", "compile_s", "bytes_per_device",
    "hlo_gflops", "hlo_gbytes", "collectives", "t_compute", "t_memory",
    "t_collective", "bottleneck", "model_gflops", "useful_flop_frac"}
REPRO_PAPER_KEYS = {
    "arch", "shape", "mesh", "status", "compile_s", "hlo_gflops",
    "hlo_gbytes", "collectives", "t_compute", "t_memory", "t_collective",
    "bottleneck"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matmul_cost(a_places):
    """LocalCost of a [64, 32] @ [32, 16] product on the 2 x 2 fake mesh,
    A in ``a_places``, B replicated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate

    cost = dryrun.LocalCost()
    with dryrun.fake_group(4):
        mesh = mesh_of(MESH)
        with FakeTensorMode(), part.use_global_mesh(mesh):
            a = part.shard_like(torch.empty(64, 32), _Like(mesh, a_places))
            b = part.shard_like(torch.empty(32, 16),
                                _Like(mesh, (Replicate(), Replicate())))
            with cost:
                out = a @ b
    return cost, out


@dataclasses.dataclass
class _Like:
    device_mesh: object
    placements: tuple


def test_a_replicated_matmul_counts_once_per_rank():
    from torch.distributed.tensor import Replicate, Shard

    cost, out = _matmul_cost((Replicate(), Replicate()))
    assert tuple(out.placements) == (Replicate(), Replicate())
    assert cost.flops == 2 * 64 * 32 * 16       # the whole product, rank 0
    rec = {}
    dryrun._roofline(rec, cost.flops, cost.bytes, cost.coll, 4)
    assert rec["hlo_gflops"] == 4 * 2 * 64 * 32 * 16 / 1e9
    # the batch split over data: a half a rank, no collective
    cost, out = _matmul_cost((Shard(0), Replicate()))
    assert cost.flops == 2 * 32 * 32 * 16
    assert not cost.coll
    # metadata propagation ran on global shapes and counted nothing: the
    # local product's bytes, under those of one global-shape product
    assert 4 * (32 * 32 + 32 * 16 + 32 * 16) <= cost.bytes \
        < 4 * (64 * 32 + 32 * 16 + 64 * 16)


@pytest.fixture(scope="module")
def cells():
    out = {}
    for arch in ("qwen3-0.6b", "granite-moe-1b-a400m"):
        cfg = ARCHS[arch].reduced(remat="full")
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = dataclasses.replace(SHAPES[name], seq_len=64,
                                        global_batch=8)
            out[arch, name] = (cfg, shape, dryrun.trace_cell(cfg, shape,
                                                             MESH))
    return out


@pytest.mark.parametrize("name", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_small_cells_give_repro_records(cells, arch, name):
    from repro.configs import ARCHS as JARCHS
    from repro.models.api import count_params as jcount

    cfg, shape, rec = cells[arch, name]
    assert REPRO_CELL_KEYS <= set(rec), REPRO_CELL_KEYS - set(rec)
    assert rec["status"] == "ok" and rec["mesh"] == "2x2"
    assert rec["hlo_gflops"] > 0 and rec["hlo_gbytes"] > 0
    assert rec["collectives"]["total"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["bytes_per_device"] >= rec["param_bytes"] > 0
    assert ("microbatches" in rec) == (shape.kind == "train")
    assert set(rec["counted"]) >= {"flops", "bytes", "collectives",
                                   "bytes_per_device"}
    assert "data sheet" in rec["hardware"]["source"]
    n_active = jcount(JARCHS[arch].reduced(remat="full"), active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    factor = 6 if shape.kind == "train" else 2
    assert rec["model_gflops"] == factor * n_active * tokens / 1e9
    moe = ARCHS[arch].n_experts > 0
    assert bool(rec["replicated"]) == moe, rec["replicated"]


@pytest.mark.parametrize("mesh_shape", [{"data": 4, "model": 1},
                                        {"data": 2, "model": 2}],
                         ids=["fsdp-4x1", "2x2"])
def test_train_collectives_are_the_sharding_designs(mesh_shape):
    """A reduced dense train step's collectives (output bytes a device)
    equal figures derived by hand from its parameter specs, so a torch
    version whose DTensor strategies move activations fails here. FSDP:
    each weight split on ``data`` is gathered once in forward, whole over
    data (its model split kept), and its gradient reduce-scattered to its
    shard; the tied table is gathered three times (the lookup, the
    logits, and the logits again when the checkpointed CE chunk
    recomputes them in backward) and its two gradients are
    reduce-scattered apart. Model parallel (model > 1): one all-reduce of
    a [B / data, S, d] activation for each row-parallel output in forward
    (the attention's and the MLP's output projections, and the lookup of
    the vocab-split table) and for each column-parallel input's gradient
    in backward (q, k, v, gate and up, and the logits' input); the CE
    reduces three [B / data, S] rows across the vocab's ranks (the max,
    the exp-sum, the target's logit) in forward and in its recompute.
    The mean's token count is one 4-byte all-reduce."""
    cfg = ARCHS["qwen3-0.6b"].reduced()
    gb, seq = 8, 16
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                global_batch=gb)
    rec = dryrun.trace_cell(cfg, shape, mesh_shape)
    gather = scatter = 0
    for path, d in part.leaves(api.Model(cfg).defs()):
        spec = part.logical_to_spec(d.axes, mesh_shape, d.shape)
        axes = [a for e in spec if e
                for a in ((e,) if isinstance(e, str) else e)]
        if "data" not in axes:
            continue
        nbytes = math.prod(d.shape) * 4
        tied = path == ("embed", "table")
        kept = math.prod(mesh_shape[a] for a in axes if a != "data")
        gather += (3 if tied else 1) * nbytes // kept
        scatter += (2 if tied else 1) * nbytes // math.prod(
            mesh_shape[a] for a in axes)
    coll = rec["collectives"]
    assert coll["all-gather"] == gather
    assert coll["reduce-scatter"] == scatter
    rows = gb // mesh_shape["data"] * seq * 4
    act = rows * cfg.d_model
    L = cfg.n_layers
    want = 4
    if mesh_shape["model"] > 1:
        want += (2 * L + 1) * act + (5 * L + 1) * act + 6 * rows
    by_site = rec["collectives_by_site"]
    assert sum(v.get(k, 0) for v in by_site.values() for k in v) == \
        coll["total"]
    got = sum(v.get("all-reduce", 0) for site, v in by_site.items()
              if not site.startswith("train/"))
    assert got == want, by_site


def test_paper_cell_gives_repro_record():
    rec = dryrun.run_paper_system_cell(multi_pod=False, n_per_shard=256,
                                       dim=16, qbatch=8, mesh_shape=MESH)
    assert REPRO_PAPER_KEYS <= set(rec), REPRO_PAPER_KEYS - set(rec)
    assert rec["status"] == "ok" and rec["shape"] == "q8_n512"
    assert rec["hlo_gflops"] > 0 and rec["collectives"]["total"] > 0
    # the serve step's two all-gathers over data: ids and distances
    assert rec["collectives"]["count_all-gather"] == 4
    assert "one iteration" in rec["counted"]["depth"]


def test_1x1_trace_holds_the_real_state_bytes():
    cfg = ARCHS["qwen3-0.6b"].reduced()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    rec = dryrun.trace_cell(cfg, shape, {"data": 1, "model": 1})
    params = api.Model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    opt = init_opt_state(params)
    nbytes = sum(t.nbytes for _, t in part.leaves(params))
    assert rec["param_bytes"] == nbytes
    assert rec["opt_state_bytes"] == 2 * nbytes + opt.step.nbytes


def test_microbatch_retry_stops_where_the_batch_shard_does(monkeypatch):
    # every trace "exceeds" the card: the retry goes 1 -> 4 and stops,
    # since 16 microbatches do not divide a shard of 8 rows
    monkeypatch.setattr(dryrun, "HBM", 1)
    cfg = ARCHS["qwen3-0.6b"].reduced()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=16)
    rec = dryrun.trace_cell(cfg, shape, MESH)
    assert rec["status"] == "ok" and rec["microbatches"] == 4
    assert rec["bytes_per_device_mb1"] > 0 and "collective_note" in rec


def test_production_meshes_on_fake_groups():
    for multi_pod, world in ((False, 256), (True, 512)):
        with dryrun.fake_group(world):
            mesh = make_production_mesh(multi_pod=multi_pod)
            assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
                dryrun.PRODUCTION_SHAPES[multi_pod]
    assert not torch.distributed.is_initialized()


def _records():
    hw = dryrun.HARDWARE
    ok = {"arch": "qwen3-0.6b", "shape": "train_4k", "status": "ok",
          "t_compute": 0.0529, "t_memory": 3.2963, "t_collective": 3.5463,
          "bytes_per_device": 15277359124, "bottleneck": "collective",
          "useful_flop_frac": 0.2801, "microbatches": 1, "hardware": hw}
    return [
        dict(ok, mesh="16x16"),
        dict(ok, mesh="16x16", arch="granite-20b", microbatches=4,
             useful_flop_frac=None, bytes_per_device=None),
        {"arch": "qwen3-0.6b", "shape": "long_500k", "mesh": "16x16",
         "status": "skipped", "reason": dryrun.skip_reason("qwen3-0.6b",
                                                           "long_500k")},
        {"arch": "xlstm-125m", "shape": "prefill_32k", "mesh": "16x16",
         "status": "error", "error": "RuntimeError: " + "x" * 80},
        dict(ok, mesh="2x16x16"),
        {"arch": "iRangeGraph-serve", "shape": "q4096_n1048576",
         "mesh": "16x16", "status": "ok", "t_compute": 2.7e-08,
         "t_memory": 7.7e-4, "t_collective": 1.3e-05,
         "bottleneck": "memory", "hardware": hw},
    ]


def test_render_matches_repro(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "render_experiments_repro", ROOT / "benchmarks" /
        "render_experiments.py")
    jrender = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jrender)
    recs = _records()
    head = "# Experiments\n\n<!-- ROOFLINE_TABLE -->\n\ntail\n"
    for d, names in (("j", ("dryrun_all.jsonl", "dryrun_paper.jsonl")),
                     ("t", (trender.ALL, trender.PAPER))):
        (tmp_path / d).mkdir()
        (tmp_path / d / names[0]).write_text(
            "".join(json.dumps(r) + "\n" for r in recs[:-1]))
        (tmp_path / d / names[1]).write_text(json.dumps(recs[-1]) + "\n")
        (tmp_path / d / "doc.md").write_text(head)
    jrender.ART = str(tmp_path / "j")
    jrender.EXP = str(tmp_path / "j" / "doc.md")
    for _ in range(2):   # a second render replaces the first
        jrender.main()
        trender.main(["--art", str(tmp_path / "t"),
                      "--doc", str(tmp_path / "t" / "doc.md")])
    want = (tmp_path / "j" / "doc.md").read_text()
    got = (tmp_path / "t" / "doc.md").read_text()
    hw_line = (f"Times from the {dryrun.HARDWARE['card']}'s "
               f"{dryrun.HARDWARE['source']}.\n")
    assert hw_line in got
    got = got.replace(hw_line, "").replace(trender.ALL, "dryrun_all.jsonl")
    assert got == want
    assert "| granite-20b | train_4k |" in got and "mb=4" in got
