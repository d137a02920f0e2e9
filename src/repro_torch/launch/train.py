"""Training launcher: ``python -m repro_torch.launch.train --arch
qwen3-0.6b`` (port of ``repro/launch/train.py``; on the card, or
``--device cpu``).

Trains the architecture's ``.reduced()`` variant by default, as
``repro``'s launcher does; ``--no-reduced`` trains the full config (in
``repro`` the flag cannot be turned off). One card, so no mesh and no
``--production-mesh``. Attention runs on its plain torch version
(``attention_impl="torch"``), differentiated by autograd, as ``repro``
pins its XLA attention: the flash-attention kernel has no backward.
Seeded weights and data; checkpoints every ``--ckpt-every`` steps, and a
run that finds a checkpoint in ``--ckpt-dir`` resumes from it. At full
width set ``RTORCH_COMPRESS_LEVEL=0``: qwen3-0.6b's state is 7.2 GB of
random-looking f32, which compression hardly shrinks, and at level 0
``checkpoint/checkpoint.py`` writes it as stored blocks in one pass.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_arch
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.api import Model, count_params
from repro_torch.runtime.trainer import TrainLoopConfig, run_train_loop
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
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

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
    print(f"[train] arch={cfg.name} params={count_params(cfg) / 1e6:.1f}M "
          f"device={dev}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20,
                          total_steps=args.steps)
    pipe = TokenPipeline(cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed,
                         encdec_dim=cfg.d_model if model.is_encdec else 0)
    batches = {}

    def next_batch(step):  # deterministic replay for crash-restore
        while len(batches) <= step:
            batches[len(batches)] = pipe.next_batch(device=dev)
        return batches[step]

    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
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
    _, hist = run_train_loop(step_fn, state, next_batch, loop_cfg)
    losses = hist["loss"]
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
