"""The port's checkpoints and fault-tolerant trainer, on the CPU.

  * ``checkpoint/checkpoint.py``: round trip and retention, a shape
    mismatch and a leaf-count mismatch raise, a corrupted payload fails
    its checksum, as in ``tests/test_substrate.py``; a bf16 leaf; a full
    ``(params, OptState)`` file written by ``repro`` restores in the port
    bit-identical, and one written by the port restores in ``repro``
    bit-identical; both packages write the same msgpack bytes for the
    same tree;
    a payload past one msgpack bin (made small here) round-trips; the
    one-pass level-0 file of stored zlib blocks is a valid zlib stream of
    the same msgpack bytes, restores in both packages, and fails its
    checksum when a payload byte flips;
    ``restore(device=)`` and the template's ``requires_grad``;
  * ``runtime/trainer.py``: an injected crash at step 7 rolls back to the
    checkpoint of step 5 and ends at step 12 with one restart, as
    ``repro``'s test does; a step that fails in its update before the
    first checkpoint leaves the parameters as they were, and the retry
    goes on from them; SIGTERM checkpoints and returns at the next step
    boundary; a failure past ``max_restarts`` raises;
  * ``python -m repro_torch.launch.train --device cpu --steps 12`` on a
    reduced config: the loss falls.
"""
import dataclasses
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import ARCHS as JARCHS
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro_torch import compressio
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ARCHS
from repro_torch.data import TokenPipeline
from repro_torch.models import api
from repro_torch.runtime import trainer
from repro_torch.runtime.trainer import TrainLoopConfig, run_train_loop
from repro_torch.train import optimizer
from repro_torch.train.step import build_train_step

from test_torch_families import numpy_params
from test_torch_train import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat_np(tree):
    """Leaves in checkpoint order as (dtype name, bytes, shape)."""
    out = []
    for a in ckpt.tree_flatten(tree):
        if isinstance(a, torch.Tensor):
            t = a.detach()
            raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
            out.append((str(t.dtype).split(".")[1], raw.tobytes(),
                        tuple(t.shape)))
        else:
            a = np.asarray(a)
            out.append((str(a.dtype), a.tobytes(), a.shape))
    return out


def _state(seed=0):
    """A port (params, OptState) after one AdamW step of a reduced
    qwen3, its moments non-zero."""
    model = api.Model(ARCHS["qwen3-0.6b"].reduced(n_layers=2, vocab=128))
    params = api.params_from_numpy(model, numpy_params(model, seed),
                                   device="cpu")
    st = optimizer.init_opt_state(params)
    b = TokenPipeline(128, batch=2, seq=16, seed=seed).next_batch()
    params, st, _ = build_train_step(model, optimizer.AdamWConfig())(
        params, st, b)
    return model, (params, st)


def test_roundtrip_and_retention(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16) * 1.5},
            "n": torch.tensor(7, dtype=torch.int64)}
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, tree, keep=2, extra={"s": s})
    assert ckpt.latest_step(d) == 5
    assert sorted(f for f in os.listdir(d) if f.endswith(".ckpt")) == [
        "step_4.ckpt", "step_5.ckpt"]
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    got, step, extra = ckpt.restore(d, tree)
    assert step == 5 and extra == {"s": 5}
    assert torch.equal(got["a"], tree["a"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    assert got["n"].dtype == torch.int64 and int(got["n"]) == 7
    got4, step4, _ = ckpt.restore(d, tree, step=4)
    assert step4 == 4
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)


def test_shape_and_structure_mismatch_raise(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"a": torch.ones(4)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"a": torch.ones(3),
                                     "b": torch.ones(3)})


def test_corrupted_payload_fails_its_checksum(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"a": torch.arange(64, dtype=torch.float32)})
    path = os.path.join(d, "step_1.ckpt")
    from repro_torch.core import msgpack_lite
    with open(path, "rb") as f:
        outer = msgpack_lite.unpackb(compressio.decompress(f.read()))
    raw = bytearray(outer["payload"])
    raw[-20] ^= 0xFF
    outer["payload"] = bytes(raw)
    with open(path, "wb") as f:
        f.write(compressio.compress(msgpack_lite.packb(outer)))
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(d, {"a": torch.zeros(64)})


def test_repro_file_restores_in_the_port(tmp_path):
    """A (params, OptState) file from ``repro`` (after one of its own
    AdamW steps) restores in the port bit for bit, in jax.tree_util's
    leaf order, with a bf16 leaf beside it."""
    model, template = _state()
    jm = japi.Model(JARCHS["qwen3-0.6b"].reduced(n_layers=2, vocab=128))
    jp = jm.init(jax.random.PRNGKey(3))
    jo = jopt.init_opt_state(jp)
    g = jax.tree.map(lambda p: jnp.sin(p * 7.0), jp)
    jp, jo, _ = jax.jit(jopt.adamw_update, static_argnums=0)(
        jopt.AdamWConfig(), jp, g, jo)
    jp = dict(jp, bf=jnp.linspace(-3, 3, 10).astype(jnp.bfloat16))
    jckpt.save(str(tmp_path), 9, (jp, jo), extra={"who": "repro"})
    tmpl = (dict(template[0], bf=torch.zeros(10, dtype=torch.bfloat16)),
            template[1])
    (p, o), step, extra = ckpt.restore(str(tmp_path), tmpl)
    assert step == 9 and extra == {"who": "repro"}
    assert isinstance(o, optimizer.OptState) and o.step.dtype == torch.int32
    assert int(o.step) == 1
    want = [(str(np.asarray(a).dtype), np.asarray(a).tobytes(),
             np.asarray(a).shape)
            for a in jax.tree_util.tree_leaves((jp, jo))]
    assert _flat_np((p, o)) == want
    assert p["bf"].dtype == torch.bfloat16
    assert p["blocks"]["mixer"]["wq"].requires_grad     # as the template


def test_port_file_restores_in_repro(tmp_path):
    model, (p, o) = _state(1)
    p = dict(p, bf=torch.linspace(-3, 3, 10).to(torch.bfloat16))
    ckpt.save(str(tmp_path), 4, (p, o), extra={"who": "port"})
    jtmpl = (jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.bfloat16
                                              if t.dtype == torch.bfloat16
                                              else jnp.float32), p),
             jopt.OptState(jnp.int32(0),
                           *(jax.tree.map(lambda t: jnp.zeros(t.shape),
                                          m) for m in (o.mu, o.nu))))
    (jp, jo), step, extra = jckpt.restore(str(tmp_path), jtmpl)
    assert step == 4 and extra == {"who": "port"}
    got = [(str(np.asarray(a).dtype), np.asarray(a).tobytes(),
            np.asarray(a).shape)
           for a in jax.tree_util.tree_leaves((jp, jo))]
    assert got == _flat_np((p, o))
    assert jp["bf"].dtype == jnp.bfloat16 and int(jo.step) == 1


def test_both_packages_write_the_same_bytes(tmp_path):
    _, (p, o) = _state(2)
    jstate = (jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), p),
              jopt.OptState(jnp.int32(int(o.step)),
                            *(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                           m) for m in (o.mu, o.nu))))
    jckpt.save(str(tmp_path / "j"), 1, jstate)
    ckpt.save(str(tmp_path / "t"), 1, (p, o))
    blobs = []
    for side in "jt":
        with open(tmp_path / side / "step_1.ckpt", "rb") as f:
            blobs.append(compressio.decompress(f.read()))
    # the compressed streams may differ (one shot against streamed)
    assert blobs[0] == blobs[1]


def test_payload_past_one_bin_roundtrips(tmp_path, monkeypatch):
    """A payload longer than a msgpack bin holds (4 GiB; 100 bytes here)
    is written as a list of parts and restores whole."""
    monkeypatch.setattr(ckpt, "_BIN_MAX", 100)
    monkeypatch.setattr(ckpt, "_PART", 64)
    _, state = _state(3)
    ckpt.save(str(tmp_path), 2, state)
    got, _, _ = ckpt.restore(str(tmp_path), state)
    assert _flat_np(got) == _flat_np(state)


@pytest.mark.parametrize("parts", [False, True], ids=["one_bin",
                                                       "parts"])
def test_stored_level0_file(tmp_path, monkeypatch, parts):
    """``RTORCH_COMPRESS_LEVEL=0`` where zlib is the codec: one pass of
    stored blocks, the
    digest written into its place at the end. The file is a valid zlib
    stream (adler32 included) of the same msgpack bytes as the
    compressed path's; it restores in the port and in ``repro``; a
    flipped payload byte fails the checksum."""
    import zlib

    if parts:
        monkeypatch.setattr(ckpt, "_BIN_MAX", 100)
        monkeypatch.setattr(ckpt, "_PART", 64)
    _, (p, o) = _state(4)
    tree = (dict(p, bf=torch.linspace(-2, 2, 7).to(torch.bfloat16)), o)
    want = ckpt.save(str(tmp_path / "z"), 3, tree)
    with open(want, "rb") as f:
        want = compressio.decompress(f.read())
    monkeypatch.setattr(compressio, "codec", lambda: "zlib")
    monkeypatch.setenv("RTORCH_COMPRESS_LEVEL", "0")
    path = ckpt.save(str(tmp_path / "s"), 3, tree)
    with open(path, "rb") as f:
        raw = f.read()
    assert zlib.decompress(raw) == want
    got, step, _ = ckpt.restore(str(tmp_path / "s"), tree)
    assert step == 3 and _flat_np(got) == _flat_np(tree)
    if not parts:
        jtmpl = jax.tree.map(lambda t: jnp.zeros(t.shape, {
            torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32}.get(
                t.dtype, jnp.float32)), ckpt.tree_flatten(tree))
        jgot, _, _ = jckpt.restore(str(tmp_path / "s"), jtmpl)
        assert [np.asarray(a).tobytes() for a in jgot] == [
            b for _, b, _ in _flat_np(tree)]
    bad = bytearray(raw)
    bad[len(raw) // 2] ^= 0x01            # inside a leaf's data
    with open(path, "wb") as f:
        f.write(bytes(bad))
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(str(tmp_path / "s"), tree)


def test_adler32_combine():
    import zlib
    rng = np.random.default_rng(0)
    for n in (0, 1, 65520, 65521, 3 * 65521 + 7, 300_000):
        a, b = rng.bytes(1234), rng.bytes(n)
        assert ckpt._adler32_combine(zlib.adler32(a), zlib.adler32(b),
                                     n) == zlib.adler32(a + b)


def test_restore_device_and_requires_grad(tmp_path):
    tree = {"w": torch.ones(3, requires_grad=True), "i": torch.arange(3),
            "x": np.float32(2.5)}
    ckpt.save(str(tmp_path), 1, tree)
    got, _, _ = ckpt.restore(str(tmp_path), tree, device="cpu")
    assert got["w"].requires_grad and got["w"].is_leaf
    assert not got["i"].requires_grad
    assert got["x"].dtype == torch.float32 and float(got["x"]) == 2.5


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _loop_parts(seed):
    model = api.Model(ARCHS["qwen3-0.6b"].reduced(n_layers=2, vocab=128))
    params = api.params_from_numpy(model, numpy_params(model, seed),
                                   device="cpu")
    step = build_train_step(model, optimizer.AdamWConfig(
        lr=1e-3, warmup_steps=0, total_steps=100))
    pipe = TokenPipeline(128, batch=2, seq=16, seed=seed)
    batches = [pipe.next_batch() for _ in range(16)]
    return params, step, batches


def test_loop_restores_after_crash(tmp_path):
    params, step, batches = _loop_parts(3)
    crashed = {"done": False}

    def step_fn(state, batch):
        p, o = state
        if not crashed["done"] and int(o.step) == 7:
            crashed["done"] = True
            raise RuntimeError("injected device failure")
        p, o, m = step(p, o, batch)
        return (p, o), m

    cfg = TrainLoopConfig(total_steps=12, ckpt_dir=str(tmp_path),
                          ckpt_every=5, log_every=100)
    logs = []
    (p, o), hist = run_train_loop(step_fn, (params, optimizer.init_opt_state(
        params)), lambda s: batches[s], cfg, log=logs.append)
    assert hist["restarts"] == 1
    assert int(o.step) == 12
    assert ckpt.latest_step(str(tmp_path)) == 12
    assert any("rolled back to step 5" in line for line in logs)
    # steps 5 and 6 ran twice: before the crash and after the roll-back
    assert len(hist["loss"]) == 14


def _ones_like(tree):
    if isinstance(tree, dict):
        return {k: _ones_like(v) for k, v in tree.items()}
    return torch.ones_like(tree, requires_grad=False)


def test_crash_before_first_checkpoint_leaves_params(tmp_path):
    """The first step fails inside its AdamW update (a gradient leaf of
    the wrong shape, after the others were computed): the retry sees the
    parameters and moments exactly as they were, and the run completes."""
    params, step, batches = _loop_parts(4)
    before = _flat_np(params)
    seen = []

    def step_fn(state, batch):
        p, o = state
        seen.append(_flat_np(p))
        if len(seen) == 1:
            grads = _ones_like(p)
            # the last leaf in sorted order, reached after every other
            grads["final_norm"]["scale"] = torch.ones(3)
            optimizer.adamw_update(optimizer.AdamWConfig(), p, grads, o)
        p, o, m = step(p, o, batch)
        return (p, o), m

    cfg = TrainLoopConfig(total_steps=3, ckpt_dir=str(tmp_path),
                          ckpt_every=50, log_every=100)
    st0 = optimizer.init_opt_state(params)
    (p, o), hist = run_train_loop(step_fn, (params, st0),
                                  lambda s: batches[s], cfg,
                                  log=lambda *_: None)
    assert hist["restarts"] == 1 and int(o.step) == 3
    assert seen[0] == before and seen[1] == before


def test_preemption_checkpoints_and_returns(tmp_path):
    params, step, batches = _loop_parts(5)
    old = signal.getsignal(signal.SIGTERM)

    def step_fn(state, batch):
        p, o = state
        if int(o.step) == 3:
            handler = signal.getsignal(signal.SIGTERM)
            assert type(getattr(handler, "__self__", None)).__name__ == \
                "_Preempt", "the loop's SIGTERM hook is not installed"
            signal.raise_signal(signal.SIGTERM)
        p, o, m = step(p, o, batch)
        return (p, o), m

    cfg = TrainLoopConfig(total_steps=12, ckpt_dir=str(tmp_path),
                          ckpt_every=50, log_every=100)
    try:
        (p, o), hist = run_train_loop(
            step_fn, (params, optimizer.init_opt_state(params)),
            lambda s: batches[s], cfg, log=lambda *_: None)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert int(o.step) == 4 and len(hist["loss"]) == 4
    assert ckpt.latest_step(str(tmp_path)) == 4
    # a new run resumes from the checkpoint and finishes
    restored, hist2 = run_train_loop(
        lambda s, b: ((lambda r: ((r[0], r[1]), r[2]))(step(*s, b))),
        (params, optimizer.init_opt_state(params)), lambda s: batches[s],
        dataclasses.replace(cfg, total_steps=6), log=lambda *_: None)
    signal.signal(signal.SIGTERM, old)
    assert int(restored[1].step) == 6 and len(hist2["loss"]) == 2


def test_failures_past_max_restarts_raise(tmp_path):
    params, _, batches = _loop_parts(6)

    def step_fn(state, batch):
        raise RuntimeError("always")

    cfg = TrainLoopConfig(total_steps=3, ckpt_dir=str(tmp_path),
                          max_restarts=1, log_every=100)
    old = signal.getsignal(signal.SIGTERM)
    try:
        with pytest.raises(RuntimeError, match="always"):
            run_train_loop(step_fn, (params,), lambda s: batches[s], cfg,
                           log=lambda *_: None)
    finally:
        signal.signal(signal.SIGTERM, old)


def test_train_launcher_loss_falls(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-0.6b", "--device", "cpu", "--steps", "12", "--batch", "4",
         "--seq", "64", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-every", "4"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("[train] done: loss")
    first, final = (float(x) for x in
                    last.split("loss ")[1].split(" (")[0].split(" -> "))
    assert final < first
    assert ckpt.latest_step(str(tmp_path / "ck")) == 12
    assert "restarts=0" in last


def test_train_launcher_resumed_past_steps_runs_nothing(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    argv = ["--arch", "qwen3-0.6b", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    old = signal.getsignal(signal.SIGTERM)
    try:
        assert len(launch_train.main(argv)) == 2
        assert launch_train.main(argv) == []
    finally:
        signal.signal(signal.SIGTERM, old)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == (f"[train] no step run: {tmp_path} holds step 2 of "
                    f"--steps 2")
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_ckpt_io_times_both_writers_and_readers(tmp_path, monkeypatch):
    from repro_torch.bench import ckpt_io
    monkeypatch.setattr(compressio, "_zstandard", lambda: None)
    rec = ckpt_io.main(["--device", "cpu", "--dir", str(tmp_path)])
    assert rec["reads_equal"] and rec["two_pass_payload_equal"]
    assert rec["restored_bit_identical"]
    assert rec["file_bytes_one_pass"] > rec["payload_bytes"] > 0
    assert os.listdir(tmp_path) == []
