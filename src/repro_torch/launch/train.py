"""Training launcher: ``python -m repro_torch.launch.train --arch
qwen3-0.6b`` (port of ``repro/launch/train.py``; on the card, or
``--device cpu``).

Trains the architecture's ``.reduced()`` variant by default, as
``repro``'s launcher does; ``--no-reduced`` trains the full config (in
``repro`` the flag cannot be turned off). Attention runs on its plain
torch version (``attention_impl="torch"``), differentiated by autograd,
as ``repro`` pins its XLA attention: the flash-attention kernel has no
backward. Seeded weights and data; checkpoints every ``--ckpt-every``
steps, and a run that finds a checkpoint in ``--ckpt-dir`` resumes from
it. At full width set ``RTORCH_COMPRESS_LEVEL=0``: qwen3-0.6b's state is
7.2 GB of random-looking f32, which compression hardly shrinks, and at
level 0 ``checkpoint/checkpoint.py`` writes it as stored blocks in one
pass.

``--mesh DATAxMODEL`` trains on a (data, model) mesh of data x model
ranks, one card each over NCCL (gloo with ``--device cpu``), spawned
here (a mesh of one rank runs in this process): the parameters and the
AdamW moments are DTensors laid out by ``Model.param_shardings``, the
batch splits over ``data``, and the step runs inside
``use_global_mesh``, as ``repro`` trains inside ``use_global_mesh(
make_local_mesh(1, 1))``. Each rank draws the same seeded weights and
batches and keeps its shard. A checkpoint holds every leaf whole
(``full_tensor()``), the file a run without the mesh writes, and
restores onto the mesh. ``--compress-grads`` runs without a mesh only.
Without ``--mesh`` the step runs on plain tensors on one card.
``--production-mesh`` is not offered: a 16 x 16 mesh exists here only
as the dry-run's ``fake`` process group, which computes nothing
(``launch/dryrun.py`` traces the production cells on it).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_arch
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.api import Model, count_params
from repro_torch.launch.mesh import batch_axes, make_local_mesh
from repro_torch.launch.specs import _maybe
from repro_torch.runtime.trainer import TrainLoopConfig, run_train_loop
from repro_torch.sharding import partitioning as part
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import build_train_step

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--reduced-overrides", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="train on a data x model mesh of as many ranks")
    args = ap.parse_args(argv)
    if args.mesh is None:
        return train(args)
    data, model = (int(n) for n in args.mesh.lower().split("x"))
    if args.compress_grads:
        ap.error("--compress-grads runs without --mesh only")
    if data * model == 1:
        return _rank_main(0, args, 1, 1, None)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        addr = f"tcp://localhost:{sock.getsockname()[1]}"
    torch.multiprocessing.spawn(_rank_main, args=(args, data, model, addr),
                                nprocs=data * model)
    return None


def _rank_main(rank, args, data, model, addr):
    """One rank of ``--mesh``: its process group, its card, the mesh."""
    world = data * model
    cpu = args.device is not None and resolve_device(args.device).type \
        == "cpu"
    if not cpu:
        torch.cuda.set_device(rank)
        args.device = f"cuda:{rank}"
    if addr is None:    # one rank: a store of its own
        store = dist.HashStore()
        dist.init_process_group("gloo" if cpu else "nccl", store=store,
                                rank=0, world_size=1)
    else:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group("gloo" if cpu else "nccl", init_method=addr,
                                rank=rank, world_size=world)
    try:
        mesh = make_local_mesh(data, model, device=args.device)
        with part.use_global_mesh(mesh):
            return train(args, mesh=mesh)
    finally:
        dist.destroy_process_group()


def train(args, mesh=None):
    """The run of :func:`main`'s arguments, on ``mesh`` when given."""
    dev = resolve_device(args.device)
    talk = mesh is None or dist.get_rank() == 0

    cfg = get_arch(args.arch)
    if args.reduced:
        over = {}
        for kv in filter(None, args.reduced_overrides.split(",")):
            k, v = kv.split("=")
            over[k] = type(getattr(cfg, k))(v) \
                if getattr(cfg, k) is not None else int(v)
        cfg = cfg.reduced(**over)
    cfg = dataclasses.replace(cfg, attention_impl="torch")
    model = Model(cfg)
    if talk:
        print(f"[train] arch={cfg.name} params="
              f"{count_params(cfg) / 1e6:.1f}M device={dev}"
              + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                 if mesh is not None else ""))

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20,
                          total_steps=args.steps)
    pipe = TokenPipeline(cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed,
                         encdec_dim=cfg.d_model if model.is_encdec else 0)
    batches = {}

    def place(batch):
        if mesh is None:
            return batch
        spec = (_maybe(mesh, batch_axes(mesh), args.batch),)
        return {k: part.shard_tensor(v, mesh, spec + (None,) * (v.ndim - 1))
                for k, v in batch.items()}

    def next_batch(step):  # deterministic replay for crash-restore
        while len(batches) <= step:
            batches[len(batches)] = place(pipe.next_batch(device=dev))
        return batches[step]

    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
    if mesh is not None:
        params = part.shard_tree(params, model.param_specs(mesh), mesh)
    state = (params, init_opt_state(params))
    step = build_train_step(model, opt_cfg, microbatches=args.microbatches,
                            compress=args.compress_grads)
    if args.compress_grads:
        state += (compression.init_error_state(params),)

        def step_fn(state, batch):
            p, o, m, e = step(*state[:2], batch, state[2])
            return (p, o, e), m
    else:
        def step_fn(state, batch):
            p, o, m = step(*state, batch)
            return (p, o), m

    loop_cfg = TrainLoopConfig(total_steps=args.steps,
                               ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every)
    _, hist = run_train_loop(step_fn, state, next_batch, loop_cfg,
                             log=print if talk else (lambda *a: None))
    losses = hist["loss"]
    if not talk:
        return losses
    if not losses:  # resumed at or past --steps
        print(f"[train] no step run: {args.ckpt_dir} holds step "
              f"{ckpt.latest_step(args.ckpt_dir)} of --steps {args.steps}")
        return losses
    print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(stragglers={hist['straggler_events']}, "
          f"restarts={hist['restarts']})")
    return losses


if __name__ == "__main__":
    main()
