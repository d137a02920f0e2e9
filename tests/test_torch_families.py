"""Every model family of the port against ``repro``'s, on the CPU.

For each of the ten configs at ``.reduced()`` (f32, two layers or one
repeating unit, d = 64), one parameter tree is drawn with numpy from a
seed (:func:`numpy_params`) and handed to ``repro`` and, through
``models/api.py::params_from_numpy``, to the port; ``repro`` runs
attention at ``attention_impl="xla"`` and the port its plain version. On the same tokens (and frames, for the
encoder-decoder) the two agree within TOL = 1e-4 absolute on:

  * ``forward_seq``'s hidden states and MoE aux loss (the encoder-
    decoder: ``encode`` and ``decode_seq``);
  * ``prefill``'s last-position logits and every cache leaf;
  * four ``decode_step``s from equal caches (the port's prefill caches
    grown to S + 4 positions, handed to both): each step's logits and the
    final caches;
  * ``init_cache``'s tree, shapes, dtypes and values;
  * ``count_params``, total and active, exactly;
  * ``embed`` (the encoder-decoder: both raise).

Measured worst differences: 2.4e-6 on hidden states, 1.2e-6 on prefill
logits and caches, 1.1e-6 on decode logits and caches, 4.8e-7 on
embeddings (sums in other orders: XLA's einsums and ``repro``'s
associative scan against the port's chunk loop); the MoE routing
integers are identical (``tests/test_torch_decode.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCHS
from repro_torch.models import api, encdec, transformer
from repro_torch.sharding import partitioning as part

TOL = 1e-4
ARCH_IDS = sorted(ARCHS)
B, S, STEPS = 2, 32, 4      # S: a multiple of the reduced ssm_chunk (16)


def _leaves(tree, prefix=()):
    """(path, leaf) of a tree of dicts, tuples and lists, None kept."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (key,))
    elif isinstance(tree, (tuple, list)):
        for i, val in enumerate(tree):
            yield from _leaves(val, prefix + (i,))
    else:
        yield prefix, tree


def _np(x):
    return None if x is None else np.asarray(
        x.float().numpy() if isinstance(x, torch.Tensor) else x)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_jax(v) for v in tree)
    return None if tree is None else jnp.array(tree.numpy(), copy=True)


def assert_trees_close(got, want, tol=TOL):
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert (a is None) == (b is None), path
        if a is None:
            continue
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=str(path))


def numpy_params(model, seed=0):
    """A parameter tree for ``model`` drawn with numpy: N(0, 1) * scale
    where ``repro`` draws, and 1 or 0 plus N(0, 0.1) where it starts from
    a constant, so the gates, biases and decays are exercised too."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, d in part.leaves(model.defs()):
        a = rng.standard_normal(d.shape).astype(np.float32)
        a = a * d.scale if d.init == "normal" else \
            float(d.init == "ones") + 0.1 * a
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    return out


@functools.cache
def _pair(name):
    jcfg = dataclasses.replace(JARCHS[name].reduced(), attention_impl="xla")
    tcfg = ARCHS[name].reduced()
    jm, tm = japi.Model(jcfg), api.Model(tcfg)
    tree = numpy_params(tm)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = api.params_from_numpy(tm, tree, device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, (B, S + STEPS)).astype(np.int32)
    inputs = {"tokens": toks[:, :S]}
    if jm.is_encdec:
        inputs["frames"] = rng.standard_normal(
            (B, 24, jcfg.d_model)).astype(np.float32)
    return jm, jp, tm, tp, toks, inputs


@functools.cache
def _ref(name):
    """``repro``'s forward, prefill and embed of the pair's inputs, in
    one jitted call."""
    jm, jp, _, _, _, inputs = _pair(name)
    cfg = jm.cfg

    def run(p, inputs):
        if jm.is_encdec:
            enc = jencdec.encode(p, cfg, inputs["frames"])
            hidden, _ = jencdec.decode_seq(p, cfg, inputs["tokens"], enc)
            fwd = (enc, hidden)
            emb = None
        else:
            fwd = jtransformer.forward_seq(p, cfg, inputs["tokens"])[::2]
            emb = jm.embed(p, inputs["tokens"])
        return fwd, jm.prefill(p, **inputs), emb

    return jax.jit(run)(jp, {k: jnp.asarray(v) for k, v in inputs.items()})


@functools.cache
def _prefilled(name):
    _, _, tm, tp, _, inputs = _pair(name)
    return _ref(name)[1], tm.prefill(tp, **inputs)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_forward_seq_matches_repro(name):
    _, _, tm, tp, _, inputs = _pair(name)
    cfg = tm.cfg
    tok = torch.from_numpy(inputs["tokens"]).long()
    want = _ref(name)[0]
    if tm.is_encdec:
        enc = encdec.encode(tp, cfg, torch.from_numpy(inputs["frames"]))
        hidden, _ = encdec.decode_seq(tp, cfg, tok, enc)
        assert_trees_close((enc, hidden), want)
        return
    got, caches, aux = transformer.forward_seq(tp, cfg, tok)
    assert caches is None and got.shape == (B, S, cfg.d_model)
    assert_trees_close(got, want[0])
    np.testing.assert_allclose(float(aux), float(want[1]), rtol=0, atol=1e-5)
    if cfg.n_experts:
        assert float(aux) > 0


@pytest.mark.parametrize("name", ARCH_IDS)
def test_prefill_logits_and_caches_match_repro(name):
    (wl, wc), (gl, gc) = _prefilled(name)
    cfg = _pair(name)[2].cfg
    assert gl.shape == (B, cfg.padded_vocab)
    assert_trees_close(gl, wl)
    assert_trees_close(gc, wc)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_decode_steps_match_repro(name):
    jm, jp, tm, tp, toks, _ = _pair(name)
    _, (_, caches) = _prefilled(name)
    cache = tm.grow_cache(caches, S + STEPS)
    jcache = _to_jax(cache)
    jdec = jax.jit(jm.decode)
    for t in range(STEPS):
        tok = toks[:, S + t:S + t + 1]
        want, jcache = jdec(jp, jnp.asarray(tok), jcache, jnp.int32(S + t))
        got, out = tm.decode(tp, tok, cache, S + t)
        assert out is cache
        assert got.shape == (B, 1, tm.cfg.padded_vocab)
        assert_trees_close(got, want)
    assert_trees_close(cache, jcache)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_init_cache_matches_repro(name):
    jm, _, tm, _, _, _ = _pair(name)
    want = jm.init_cache(B, 40)
    got = tm.init_cache(B, 40, device="cpu")
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert (a is None) == (b is None), path
        if a is None:
            continue
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), str(path))
    # every leaf owns its memory: decode writes into it
    ptrs = [a.data_ptr() for _, a in g if a is not None and a.numel()]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_count_params_matches_repro(name):
    for cfg in (ARCHS[name], ARCHS[name].reduced()):
        jcfg = JARCHS[name] if cfg is ARCHS[name] else JARCHS[name].reduced()
        assert api.count_params(cfg) == japi.count_params(jcfg)
        assert api.count_params(cfg, active_only=True) == \
            japi.count_params(jcfg, active_only=True)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_embed_matches_repro(name):
    jm, jp, tm, tp, _, inputs = _pair(name)
    tok = inputs["tokens"]
    if tm.is_encdec:
        with pytest.raises(KeyError):
            jm.embed(jp, jnp.asarray(tok))
        with pytest.raises(ValueError, match="decoder-only"):
            tm.embed(tp, tok)
        return
    got = tm.embed(tp, tok)
    assert got.dtype == torch.float32 and got.shape == (B, tm.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(_ref(name)[2]),
                               rtol=0, atol=TOL)
