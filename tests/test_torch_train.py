"""The port's training pieces against ``repro``'s, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages;
``repro`` runs jitted, attention at ``attention_impl="xla"``, the port
its plain versions. Held here:

  * ``layers.cross_entropy`` and ``chunked_cross_entropy`` (padded vocab,
    targets of -1, the logit softcap, a chunk that divides S and one that
    does not): the loss within 1e-5, its gradients to the hidden states
    and the projection within 1e-5 of their max-abs;
  * ``lr_schedule`` and ``adamw_update`` on identical inputs within 1e-6
    (parameters, moments, grad norm, lr), with and without clipping; an
    update that fails midway writes nothing;
  * ``compress_grads``: the int8 codes bit-identical, the decompressed
    gradients and the error state within 1e-7 of ``repro``'s evaluated
    eagerly (jitted, XLA fuses the residual into an FMA, an ulp away),
    and error feedback;
  * ``build_train_step``: loss, grad_norm and lr of three steps, each
    from the same state on both sides, within 1e-5 relative (after a
    step the parameters are not compared elementwise: AdamW's first step
    moves an element by about lr times the sign of its gradient, and a
    gradient near 0 may take either sign in two sums); with compression
    too; microbatches 4 against 1 within 2e-4 (``repro``'s own bound);
    the loss falls (``repro``'s ``test_adamw_reduces_loss``);
  * ``TokenPipeline``: batches bit-identical to ``repro``'s;
  * ``Model.train_batch_specs``: the entries, shapes and dtypes of
    ``repro``'s for every architecture, and the pipeline's tokens and
    targets of those shapes and dtypes;
  * after a train step, ``Model.embed`` and ``prefill`` of the trained
    parameters (which require grad) build no autograd graph.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.step import build_train_step as jbuild_train_step
from repro_torch.configs import ARCHS
from repro_torch.data import TokenPipeline
from repro_torch.models import api
from repro_torch.models import layers
from repro_torch.sharding.partitioning import leaves
from repro_torch.train import compression, optimizer
from repro_torch.train.step import build_train_step

from test_torch_families import numpy_params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs tiny tensors, where torch's intra-op threads
    only spin and take cores from the files run beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a, copy=True))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _tree_np(tree):
    return {"/".join(p): _np(v) for p, v in leaves(tree)}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy().copy())


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

CE_CASES = {  # name -> (arch, S, chunk)
    "qwen3 one chunk": ("qwen3-0.6b", 32, 512),
    "qwen3 chunks of 8": ("qwen3-0.6b", 32, 8),
    "qwen3 chunk not dividing S": ("qwen3-0.6b", 24, 16),
    "gemma2 softcap chunks of 8": ("gemma2-9b", 32, 8),
    "gemma2 softcap chunk not dividing S": ("gemma2-9b", 24, 16),
}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_chunked_cross_entropy_matches_repro(case):
    arch, S, chunk = CE_CASES[case]
    cfg = ARCHS[arch].reduced()
    jcfg = JARCHS[arch].reduced()
    assert cfg.padded_vocab != cfg.vocab      # the padded tail is masked
    rng = np.random.default_rng(S + chunk)
    B, d = 3, cfg.d_model
    hidden = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((cfg.padded_vocab, d)) * 0.3).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    tgt[0, ::3] = -1
    tgt[2] = -1

    def jloss(h, w):
        return jlayers.chunked_cross_entropy(w, h, jnp.asarray(tgt), jcfg,
                                             chunk=chunk)

    jl, (jgh, jgw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(hidden), jnp.asarray(w))
    h_t, w_t = _t(hidden).requires_grad_(), _t(w).requires_grad_()
    tl = layers.chunked_cross_entropy(w_t, h_t, _t(tgt), cfg, chunk=chunk)
    gh, gw = torch.autograd.grad(tl, (h_t, w_t))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    for got, want in ((gh, jgh), (gw, jgw)):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_cross_entropy_matches_repro():
    """The full-logits CE on [B, S, padded_vocab] logits, softcap applied
    by the caller, targets of -1 ignored, the padded tail masked."""
    cfg = ARCHS["gemma2-9b"].reduced()
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 16, cfg.padded_vocab)) * 4).astype(
        np.float32)
    tgt = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    tgt[1, 5:] = -1
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(tgt),
                                 cfg.vocab, cfg.padded_vocab)
    got = layers.cross_entropy(_t(logits), _t(tgt), cfg.vocab,
                               cfg.padded_vocab)
    assert abs(float(got) - float(want)) <= 1e-5
    # every target ignored: 0, not a division by zero
    none = np.full_like(tgt, -1)
    assert float(layers.cross_entropy(_t(logits), _t(none), cfg.vocab,
                                      cfg.padded_vocab)) == 0.0


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_repro():
    for cfg in (optimizer.AdamWConfig(lr=3e-3, warmup_steps=2,
                                      total_steps=12),
                optimizer.AdamWConfig(warmup_steps=0, total_steps=10),
                optimizer.AdamWConfig(lr=1e-2, warmup_steps=7,
                                      total_steps=7, min_lr_frac=0.0)):
        jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
        for s in range(cfg.total_steps + 4):
            want = float(jopt.lr_schedule(jcfg, jnp.int32(s)))
            got = float(optimizer.lr_schedule(cfg, torch.tensor(
                s, dtype=torch.int32)))
            assert abs(got - want) <= 1e-6 * max(abs(want), 1e-3), (cfg, s)
            assert got == float(optimizer.lr_schedule(cfg, s))


def _adamw_inputs(seed, gscale):
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 8), "b": {"c": (8,), "d": (3, 4, 5)}, "s": ()}

    def draw(scale, positive=False):
        def one(shape):
            a = rng.standard_normal(shape).astype(np.float32) * scale
            return np.abs(a) if positive else a
        return {"w": one(shapes["w"]),
                "b": {k: one(v) for k, v in shapes["b"].items()},
                "s": one(shapes["s"])}

    return draw(1.0), draw(gscale), draw(0.1), draw(0.01, positive=True)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("gscale", [0.01, 10.0], ids=["unclipped",
                                                       "clipped"])
def test_adamw_update_matches_repro(gscale):
    p, g, m, v = _adamw_inputs(11, gscale)
    cfg = optimizer.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    js = jopt.OptState(jnp.int32(3), _map(jnp.asarray, m),
                       _map(jnp.asarray, v))
    jp, jst, jm = jax.jit(jopt.adamw_update, static_argnums=0)(
        jcfg, _map(jnp.asarray, p), _map(jnp.asarray, g), js)
    tp = _map(_t, p)
    ts = optimizer.OptState(torch.tensor(3, dtype=torch.int32),
                            _map(_t, m), _map(_t, v))
    out, st, om = optimizer.adamw_update(cfg, tp, _map(_t, g), ts)
    assert out is tp                                  # updated in place
    assert int(st.step) == 4 and int(jst.step) == 4
    assert (float(om["grad_norm"]) > cfg.clip_norm) == (gscale > 1)
    for got, want in ((om["grad_norm"], jm["grad_norm"]),
                      (om["lr"], jm["lr"])):
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    for got, want in ((tp, jp), (st.mu, jst.mu), (st.nu, jst.nu)):
        g_, w_ = _tree_np(got), _tree_np(jax.tree.map(np.asarray, want))
        for k in w_:
            np.testing.assert_allclose(g_[k], w_[k], rtol=0, atol=1e-6,
                                       err_msg=k)


def test_adamw_update_that_fails_midway_writes_nothing():
    p, g, m, v = _adamw_inputs(12, 1.0)
    tp, tm, tv = _map(_t, p), _map(_t, m), _map(_t, v)
    before = [_tree_np(t) for t in (tp, tm, tv)]
    bad = _map(_t, g)
    bad["w"] = torch.zeros(3, 3)       # the last leaf in sorted order
    st = optimizer.OptState(torch.tensor(0, dtype=torch.int32), tm, tv)
    with pytest.raises(RuntimeError):
        optimizer.adamw_update(optimizer.AdamWConfig(), tp, bad, st)
    for b, t in zip(before, (tp, tm, tv)):
        a = _tree_np(t)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(st.step) == 0


def test_compress_grads_matches_repro():
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((64, 64)).astype(np.float32),
         "b": {"c": (rng.standard_normal(37) * 1e-3).astype(np.float32),
               "z": np.zeros(5, np.float32)}}
    err = _map(lambda a: (a * 0.01).astype(np.float32), g)
    for leaf in ("w",):
        want_q, want_s = jax.jit(jcomp._quantize)(jnp.asarray(g[leaf]))
        got_q, got_s = compression.quantize(_t(g[leaf]))
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        assert float(got_s) == float(want_s)
    # eager: jitted, XLA contracts gf - q * scale into one FMA, which
    # moves the residual by an ulp (1.2e-7 at |gf| ~ 1)
    jh, je = jcomp.compress_grads(_map(jnp.asarray, g),
                                  _map(jnp.asarray, err))
    th, te = compression.compress_grads(_map(_t, g), _map(_t, err))
    for got, want in ((th, jh), (te, je)):
        g_, w_ = _tree_np(got), _tree_np(jax.tree.map(np.asarray, want))
        for k in w_:
            np.testing.assert_allclose(g_[k], w_[k], rtol=0, atol=1e-7,
                                       err_msg=k)
    # every leaf's codes equal: the decompressed values over the scale
    for k in ("w", "b/c"):
        scale = np.abs(_tree_np(_map(_t, g))[k]
                       + _tree_np(_map(_t, err))[k]).max() / 127
        np.testing.assert_array_equal(np.rint(_tree_np(th)[k] / scale),
                                      np.rint(_tree_np(jax.tree.map(
                                          np.asarray, jh))[k] / scale))
    assert not np.any(_tree_np(th)["b/z"])
    # error feedback: two rounds sum to twice the gradient within 2 steps
    e0 = compression.init_error_state(_map(_t, g))
    h1, e1 = compression.compress_grads(_map(_t, g), e0)
    np.testing.assert_allclose(e1["w"].numpy(), g["w"] - h1["w"].numpy(),
                               rtol=1e-6)
    h2, _ = compression.compress_grads(_map(_t, g), e1)
    scale = np.abs(g["w"]).max() / 127
    np.testing.assert_allclose((h1["w"] + h2["w"]).numpy(), 2 * g["w"],
                               atol=2.1 * scale)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _pair(arch="qwen3-0.6b", seed=0, **over):
    jcfg = dataclasses.replace(JARCHS[arch].reduced(n_layers=2, vocab=128,
                                                    **over),
                               attention_impl="xla")
    tcfg = ARCHS[arch].reduced(n_layers=2, vocab=128, **over)
    jm, tm = japi.Model(jcfg), api.Model(tcfg)
    tree = numpy_params(tm, seed)
    return jm, tm, tree


def _jstate(params, st):
    return _to_jax(params), jopt.OptState(
        jnp.int32(int(st.step)), _to_jax(st.mu), _to_jax(st.nu))


@pytest.mark.parametrize("compress", [False, True], ids=["plain",
                                                         "compressed"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_train_step_matches_repro(arch, compress):
    jm, tm, tree = _pair(arch)
    ocfg = optimizer.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=50)
    jocfg = jopt.AdamWConfig(**dataclasses.asdict(ocfg))
    jstep = jax.jit(jbuild_train_step(jm, jocfg, compress=compress))
    tstep = build_train_step(tm, ocfg, compress=compress)
    params = api.params_from_numpy(tm, tree, device="cpu")
    st = optimizer.init_opt_state(params)
    err = compression.init_error_state(params)
    pipe = TokenPipeline(tm.cfg.vocab, batch=4, seq=32, seed=0)
    for _ in range(3):
        batch = pipe.next_batch()
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jp, jo = _jstate(params, st)
        if compress:
            _, _, jmet, _ = jstep(jp, jo, jb, _to_jax(err))
            params, st, met, err = tstep(params, st, batch, err)
        else:
            _, _, jmet = jstep(jp, jo, jb)
            params, st, met = tstep(params, st, batch)
        assert set(met) == set(jmet) == {"loss", "nll", "aux", "grad_norm",
                                         "lr"}
        for k in ("loss", "grad_norm", "lr", "nll"):
            want = float(jmet[k])
            assert abs(float(met[k]) - want) <= 1e-5 * abs(want), (k, met)
        assert abs(float(met["aux"]) - float(jmet["aux"])) <= 1e-5
    assert int(st.step) == 3


def test_microbatches_match_full_batch():
    """As ``repro``'s test: 4 microbatches of 2 against one batch of 8,
    the parameters after one step within 2e-4."""
    _, tm, tree = _pair(seed=1)
    ocfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    b = TokenPipeline(tm.cfg.vocab, batch=8, seq=16, seed=1).next_batch()
    out = []
    for mb in (1, 4):
        params = api.params_from_numpy(tm, tree, device="cpu")
        step = build_train_step(tm, ocfg, microbatches=mb)
        params, _, met = step(params, optimizer.init_opt_state(params), b)
        out.append((_tree_np(params), float(met["loss"])))
    (p1, l1), (p4, l4) = out
    assert abs(l1 - l4) <= 1e-5
    assert max(float(np.abs(p1[k] - p4[k]).max()) for k in p1) < 2e-4
    with pytest.raises(ValueError, match="microbatches"):
        build_train_step(tm, ocfg, microbatches=3)(
            params, optimizer.init_opt_state(params), b)


def test_adamw_reduces_loss():
    """``repro``'s ``test_adamw_reduces_loss`` on the port: twelve steps
    on one batch take the loss below 0.9 x the first."""
    _, tm, tree = _pair()
    params = api.params_from_numpy(tm, tree, device="cpu")
    st = optimizer.init_opt_state(params)
    step = build_train_step(tm, optimizer.AdamWConfig(
        lr=5e-3, warmup_steps=2, total_steps=50))
    b = TokenPipeline(tm.cfg.vocab, batch=4, seq=32, seed=0).next_batch()
    losses = []
    for _ in range(12):
        params, st, met = step(params, st, b)
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
    assert float(met["grad_norm"]) > 0


def test_trained_params_serve_without_a_graph():
    """After a train step every parameter requires grad; embed and
    prefill still run under no_grad: outputs with no autograd graph."""
    _, tm, tree = _pair()
    params = api.params_from_numpy(tm, tree, device="cpu")
    step = build_train_step(tm, optimizer.AdamWConfig())
    b = TokenPipeline(tm.cfg.vocab, batch=2, seq=16, seed=4).next_batch()
    params, _, _ = step(params, optimizer.init_opt_state(params), b)
    assert all(p.requires_grad for _, p in leaves(params))
    emb = tm.embed(params, b["tokens"])
    logits, caches = tm.prefill(params, tokens=b["tokens"])
    for t in [emb, logits] + [c for _, c in leaves(caches)]:
        assert not t.requires_grad and t.grad_fn is None
    assert torch.isfinite(emb).all() and emb.shape == (2, tm.cfg.d_model)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("encdec_dim", [0, 16])
def test_token_pipeline_matches_repro(encdec_dim):
    kw = dict(vocab=300, batch=3, seq=70, seed=5, encdec_dim=encdec_dim)
    jp, tp = JTokenPipeline(**kw), TokenPipeline(**kw)
    for i in range(3):
        want = jp.next_batch()
        got = tp.next_batch(device="cpu" if i == 2 else None)
        assert set(got) == set(want)
        for k in want:
            g = got[k].numpy() if i == 2 else got[k]
            assert g.dtype == want[k].dtype, k
            np.testing.assert_array_equal(g, want[k])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_train_batch_specs_match_repro(name):
    cfg = ARCHS[name].reduced()
    got = api.Model(cfg).train_batch_specs(3, 16)
    want = japi.Model(JARCHS[name].reduced()).train_batch_specs(3, 16)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].shape == tuple(w.shape), k
        assert got[k].dtype == getattr(torch, str(w.dtype)), k
    batch = TokenPipeline(cfg.vocab, batch=3, seq=16).next_batch(
        device="cpu")
    for k in ("tokens", "targets"):
        assert (tuple(batch[k].shape), batch[k].dtype) == tuple(got[k])
