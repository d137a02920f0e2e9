"""Fault-tolerant training loop (port of ``repro/runtime/trainer.py``).

Wraps a train step with the machinery a long job needs:

  * auto-restore: on start, resume from the newest checkpoint if present;
  * periodic checkpoints (atomic, newest K kept) and a final one, unless
    the last periodic one holds the final step already;
  * a step watchdog: a wall-time EWMA a step; a step slower than
    ``straggler_factor`` x the EWMA counts as a straggler event, and one
    past ``straggler_deadline_s`` aborts;
  * crash-retry: a step that raises rolls back to the newest checkpoint
    and replays, up to ``max_restarts`` (the batches are a function of the
    step, so the replay sees the same data); with no checkpoint yet it
    retries from the state it had, which an in-place step must leave as
    it was when it fails (``train/optimizer.py::adamw_update`` writes
    nothing until every new value is computed);
  * preemption: SIGTERM sets a flag; the loop checkpoints and returns at
    the next step boundary.

Each step is synchronized with its device inside the ``try`` (where
``repro`` blocks on its metrics), so an asynchronous CUDA error fails the
step that raised it and its time is the device's too.
"""
from __future__ import annotations

import dataclasses
import signal
import time

import torch

from repro_torch.checkpoint import checkpoint as ckpt

__all__ = ["TrainLoopConfig", "run_train_loop"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    straggler_deadline_s: float | None = None
    max_restarts: int = 2
    log_every: int = 10


class _Preempt:
    def __init__(self):
        self.flag = False
        try:
            signal.signal(signal.SIGTERM, self._h)
        except ValueError:
            pass  # not on the main thread

    def _h(self, *_):
        self.flag = True


def _sync(metrics) -> None:
    """Wait for every CUDA device the metrics live on."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)


def run_train_loop(step_fn, init_state, next_batch, cfg: TrainLoopConfig,
                   *, log=print):
    """Run ``step_fn(state, batch) -> (state, metrics)`` from step 0 (or
    the newest checkpoint in ``cfg.ckpt_dir``) to ``cfg.total_steps``,
    ``next_batch(step)`` giving each step's batch (deterministic: a replay
    must see the same data). ``init_state`` is the template a checkpoint
    restores into. Returns ``(final state, {"loss": [per step],
    "straggler_events", "restarts"})``."""
    preempt = _Preempt()
    state = init_state
    start_step = 0
    if ckpt.latest_step(cfg.ckpt_dir) is not None:
        state, start_step, _ = ckpt.restore(cfg.ckpt_dir, init_state)
        log(f"[trainer] restored checkpoint at step {start_step}")

    saved_at = None

    def save(step):
        nonlocal saved_at
        ckpt.save(cfg.ckpt_dir, step, state, keep=cfg.keep)
        saved_at = step

    history = {"loss": [], "straggler_events": 0, "restarts": 0}
    ewma = None
    step = start_step
    restarts = 0
    while step < cfg.total_steps:
        batch = next_batch(step)
        t0 = time.perf_counter()
        try:
            state, metrics = step_fn(state, batch)
            _sync(metrics)
        except Exception as e:  # noqa: BLE001 -- the transient failure path
            restarts += 1
            history["restarts"] = restarts
            log(f"[trainer] step {step} failed ({type(e).__name__}: {e}); "
                f"restart {restarts}/{cfg.max_restarts}")
            if restarts > cfg.max_restarts:
                raise
            if ckpt.latest_step(cfg.ckpt_dir) is not None:
                state, step, _ = ckpt.restore(cfg.ckpt_dir, init_state)
                log(f"[trainer] rolled back to step {step}")
            continue
        dt = time.perf_counter() - t0

        if ewma is None:
            ewma = dt
        else:
            if dt > cfg.straggler_factor * ewma:
                history["straggler_events"] += 1
                log(f"[trainer] straggler: step {step} took {dt:.3f}s "
                    f"(ewma {ewma:.3f}s)")
            if (cfg.straggler_deadline_s is not None
                    and dt > cfg.straggler_deadline_s):
                raise TimeoutError(
                    f"step {step} exceeded deadline "
                    f"{cfg.straggler_deadline_s}s")
            ewma = 0.9 * ewma + 0.1 * dt

        loss = float(metrics.get("loss", float("nan")))
        history["loss"].append(loss)
        if step % cfg.log_every == 0:
            log(f"[trainer] step {step} loss {loss:.4f} "
                f"({dt * 1e3:.0f} ms/step)")
        step += 1

        if step % cfg.ckpt_every == 0 or preempt.flag:
            save(step)
            if preempt.flag:
                log("[trainer] preemption: checkpointed and exiting")
                return state, history

    if saved_at != step:    # repro writes the same step a second time
        save(step)
    return state, history
