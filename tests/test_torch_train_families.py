"""``Model.loss`` and its gradients, for every model family, against
``repro``'s ``jax.value_and_grad``, on the CPU; and the three remat modes
against each other.

Each of the ten configs at ``.reduced()`` (f32; dense, MoE, gemma2's
local/global pairs with softcaps, zamba2's mamba groups and shared
attention, xLSTM, the encoder-decoder) gets one numpy parameter tree
(``test_torch_families.numpy_params``) on both sides and the same batch
(targets partly -1; seamless: 24 encoder frames). ``repro`` runs jitted,
attention at ``"xla"``. The loss agrees within 1e-5 and every gradient
leaf within 1e-4 of its max-abs (measured worst: 6.4e-6 relative, on
xLSTM). With ``remat`` ``"none"``, ``"full"`` and ``"dots"`` the port's
loss and gradients agree within 1e-6: the recompute repeats the forward
pass (MoE routing sorts stably; mamba2's and mLSTM's chunks are walked
in order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.models import api as japi
from repro_torch.configs import ARCHS
from repro_torch.models import api
from repro_torch.sharding.partitioning import leaves
from repro_torch.train.step import loss_and_grads

from test_torch_families import numpy_params
from test_torch_train import one_torch_thread  # noqa: F401

ARCH_IDS = sorted(ARCHS)
B, S = 2, 32        # S: a multiple of the reduced ssm_chunk (16)


@functools.cache
def _batch(name):
    cfg = ARCHS[name].reduced()
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][0, :5] = -1
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, 24, cfg.d_model)).astype(np.float32)
    return batch


def _port(name, remat="none"):
    model = api.Model(ARCHS[name].reduced(remat=remat))
    tree = numpy_params(api.Model(ARCHS[name].reduced()))
    params = api.params_from_numpy(model, tree, device="cpu")
    loss, metrics, grads = loss_and_grads(model, params, _batch(name))
    return float(loss), metrics, {p: g.numpy() for p, g in leaves(grads)}


@pytest.mark.parametrize("name", ARCH_IDS)
def test_loss_and_grads_match_repro(name):
    jm = japi.Model(dataclasses.replace(JARCHS[name].reduced(),
                                        attention_impl="xla"))
    tree = numpy_params(api.Model(ARCHS[name].reduced()))
    batch = {k: jnp.asarray(v) for k, v in _batch(name).items()}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), batch)
    loss, metrics, grads = _port(name)
    assert abs(loss - float(jl)) <= 1e-5
    assert abs(float(metrics["aux"]) - float(jmet["aux"])) <= 1e-5
    assert abs(float(metrics["nll"]) - float(jmet["nll"])) <= 1e-5
    want = dict(leaves(jax.tree.map(np.asarray, jg)))
    assert set(grads) == set(want)
    for path, g in grads.items():
        assert g is not None and np.isfinite(g).all(), path
        w = want[path]
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg="/".join(path))
    if ARCHS[name].n_experts:
        assert float(metrics["aux"]) > 0


@pytest.mark.parametrize("name", ARCH_IDS)
def test_remat_modes_agree(name):
    ref_loss, _, ref = _port(name, "none")
    for remat in ("full", "dots"):
        loss, _, grads = _port(name, remat)
        assert abs(loss - ref_loss) <= 1e-6, remat
        for path, g in grads.items():
            np.testing.assert_allclose(g, ref[path], rtol=0, atol=1e-6,
                                       err_msg=f"{remat} {'/'.join(path)}")


def test_remat_full_recomputes_in_backward():
    """Under ``"full"`` the saved activations are the units' inputs: the
    backward pass reruns each unit's forward (counted through a spy on
    the block function), which ``"none"`` never does."""
    from repro_torch.models import transformer

    calls = []
    inner = transformer.block_seq

    def spy(*args, **kw):
        calls.append(1)
        return inner(*args, **kw)

    transformer.block_seq = spy
    try:
        counts = {}
        for remat in ("none", "full"):
            calls.clear()
            _port("qwen3-0.6b", remat)
            counts[remat] = len(calls)
    finally:
        transformer.block_seq = inner
    n = ARCHS["qwen3-0.6b"].reduced().n_layers
    assert counts == {"none": n, "full": 2 * n}
