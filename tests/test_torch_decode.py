"""The port's serving path (prefill, decode, the step builders, MoE
routing, the ragged SSM chunks, the cache written in place), on the CPU.

Tolerances, all f32 at ``.reduced()`` widths, absolute:

  * decode against the forward pass (the port alone, teacher forcing) and
    prefill-then-decode against the forward over S + 1 tokens: 1e-4
    (measured at most 3.4e-7: one softmax over the cache against the
    plain attention's, the SSM and mLSTM recurrences against their chunk
    forms). MoE configs run at ``moe_capacity_factor=8.0`` here, as
    ``repro``'s ``test_decode_matches_forward`` does: at 1.25 a one-token
    step and the forward pass drop different tokens;
  * the greedy tokens of ``build_decode_step`` and MoE's ``top_e``,
    ``keep`` and sorted assignments: equal to ``repro``'s; MoE ``out``
    and ``aux``: 1e-5 (measured at most 1.2e-7);
  * mamba2 and mLSTM at S not a multiple of the chunk against ``repro``
    at a chunk that divides S (the chunking does not change the
    function): 1e-4 (measured 1.8e-7 and 1.9e-9).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import api as japi
from repro.models import mamba2 as jmamba
from repro.models import mlp as jmlp
from repro.models import xlstm as jxlstm
from repro.train import step as jstep
from repro_torch.configs import ARCHS
from repro_torch.launch import serve
from repro_torch.models import api, attention, encdec, mamba2, mlp, \
    transformer, xlstm
from repro_torch.train import step as tstep
from test_torch_families import numpy_params

TOL = 1e-4


def _model(name, seed=0, **over):
    cfg = ARCHS[name].reduced(**over)
    model = api.Model(cfg)
    return model, api.params_from_numpy(model, numpy_params(model, seed),
                                        device="cpu")


def _forward_logits(model, params, toks, frames=None):
    """Full-sequence logits [B, S, V] of the port."""
    cfg = model.cfg
    toks = torch.as_tensor(toks).long()
    if model.is_encdec:
        enc = encdec.encode(params, cfg, torch.from_numpy(frames))
        hidden, _ = encdec.decode_seq(params, cfg, toks, enc)
        return transformer.L.logits(params["embed"], None, hidden, cfg)
    hidden, _, _ = transformer.forward_seq(params, cfg, toks)
    return transformer.compute_logits(params, cfg, hidden)


def _empty_cache(model, params, B, S, frames):
    """A zero decode cache of S positions; the encoder-decoder's cross
    cache holds the encoder's K/V, as a prefill leaves it."""
    if not model.is_encdec:
        return model.init_cache(B, S, device="cpu")
    cfg = model.cfg
    cache = model.init_cache(B, S, enc_len=frames.shape[1], device="cpu")
    enc = encdec.encode(params, cfg, torch.from_numpy(frames))
    for i in range(cfg.n_layers):
        bp = transformer._layer(params["dec_blocks"], i)
        ck, cv = attention.cross_kv(bp["cross_attn"], cfg, enc)
        cache["cross"]["k"][i].copy_(ck)
        cache["cross"]["v"][i].copy_(cv)
    return cache


def _frames(model, B, seed=3):
    if not model.is_encdec:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, 12, model.cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "gemma2-9b", "xlstm-125m",
                                  "zamba2-1.2b", "granite-moe-1b-a400m",
                                  "seamless-m4t-large-v2"])
def test_decode_matches_forward(name):
    """Token-by-token decode from an empty cache reproduces the forward
    pass's logits (teacher forcing); S = 20 spans gemma2's window of 16
    and a ragged second SSM chunk."""
    model, params = _model(name, moe_capacity_factor=8.0)
    B, S = 2, 20
    toks = np.random.default_rng(3).integers(0, model.cfg.vocab, (B, S))
    frames = _frames(model, B)
    want = _forward_logits(model, params, toks, frames)
    cache = _empty_cache(model, params, B, S, frames)
    for t in range(S):
        got, cache = model.decode(params, toks[:, t:t + 1], cache, t)
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, t].numpy(),
                                   rtol=0, atol=TOL, err_msg=f"step {t}")


@pytest.mark.parametrize("name", ["qwen3-0.6b", "phi3-mini-3.8b",
                                  "gemma2-9b", "zamba2-1.2b", "xlstm-125m",
                                  "seamless-m4t-large-v2"])
def test_prefill_then_decode(name):
    """Prefill S tokens, grow the caches, decode token S: the logits of a
    forward pass over S + 1 tokens at its last position."""
    model, params = _model(name)
    B, S = 2, 17
    toks = np.random.default_rng(4).integers(0, model.cfg.vocab,
                                             (B, S + 1))
    frames = _frames(model, B)
    inputs = {"tokens": toks[:, :S]}
    if frames is not None:
        inputs["frames"] = frames
    logits_p, caches = tstep.build_prefill_step(model)(params, inputs)
    want = _forward_logits(model, params, toks, frames)
    np.testing.assert_allclose(logits_p.numpy(), want[:, S - 1].numpy(),
                               rtol=0, atol=TOL)
    cache = model.grow_cache(caches, S + 8)
    got, _ = model.decode(params, toks[:, S:], cache, S)
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, S].numpy(),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["seamless-m4t-large-v2",
                                  "granite-moe-1b-a400m"])
def test_greedy_decode_step_matches_repro(name):
    """``build_decode_step``'s greedy tokens equal ``repro``'s for four
    steps. The padded vocab tail's embedding rows are scaled up so that,
    unmasked, every argmax would land in the tail."""
    cfg = ARCHS[name].reduced()
    assert cfg.padded_vocab > cfg.vocab
    model = api.Model(cfg)
    tree = numpy_params(model, seed=5)
    tree["embed"]["table"][cfg.vocab:] *= 1e3
    params = api.params_from_numpy(model, tree, device="cpu")
    jm = japi.Model(dataclasses.replace(JARCHS[name].reduced(),
                                        attention_impl="xla"))
    jp = jax.tree.map(jnp.asarray, tree)
    B, S = 2, 9
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (B, S + 1))
    frames = _frames(model, B)
    inputs = {"tokens": toks[:, :S]}
    if frames is not None:
        inputs["frames"] = frames
    _, caches = model.prefill(params, **inputs)
    cache = model.grow_cache(caches, S + 4)
    jcache = jax.tree.map(lambda t: jnp.array(t.numpy(), copy=True), cache)
    step, jdec = tstep.build_decode_step(model), jax.jit(
        jstep.build_decode_step(jm))
    tok = jtok = toks[:, S:S + 1].astype(np.int32)
    logits, _ = model.decode(params, tok,
                             jax.tree.map(torch.clone, cache), S)
    assert (logits[:, 0].argmax(-1) >= cfg.vocab).all()  # unmasked: tail
    for t in range(4):
        tok, cache = step(params, tok, cache, S + t)
        jtok, jcache = jdec(jp, jnp.asarray(jtok), jcache, jnp.int32(S + t))
        assert tok.dtype == torch.int32 and tok.shape == (B, 1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        assert (tok >= 0).all() and (tok < cfg.vocab).all()


def _jax_route(p, cfg, xt):
    """``repro/models/mlp.py::moe``'s routing (lines 74-101), restated to
    expose what its function keeps internal."""
    T = xt.shape[0]
    e, k = cfg.n_experts, cfg.expert_top_k
    probs = jax.nn.softmax(xt @ p["router"], axis=-1)
    top_w, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = jnp.repeat(jnp.arange(T, dtype=jnp.int32), k)[order]
    C = int((T * k / e) * cfg.moe_capacity_factor) + 1
    counts = jnp.bincount(flat_e, length=e)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    keep = jnp.arange(T * k) - starts[se] < C
    return {"top_e": top_e, "se": se, "st": st, "keep": keep, "C": C}


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_routing_and_drops_match_repro(name):
    """At the config's capacity factor (1.25) with 96 tokens and a router
    leaning to expert 0 (past its capacity of 61), some assignments drop:
    top_e,
    the sorted assignments, the keep mask, C, out and aux equal
    ``repro``'s."""
    cfg = ARCHS[name].reduced()
    jcfg = JARCHS[name].reduced()
    rng = np.random.default_rng(8)
    p = {k: v[0] for k, v in numpy_params(api.Model(cfg))["blocks"][
        "ffn"].items()}
    p["router"] = p["router"] * 40
    p["router"][:, 0] += 0.05
    x = 1 + rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    r = mlp.route(tp, cfg, torch.from_numpy(x).reshape(96, -1))
    jr = _jax_route(jp, jcfg, jnp.asarray(x).reshape(96, -1))
    assert r["C"] == jr["C"]
    for key in ("top_e", "se", "st", "keep"):
        np.testing.assert_array_equal(r[key].numpy(), np.asarray(jr[key]),
                                      key)
    assert 0 < int((~r["keep"]).sum()) < r["keep"].numel()

    out, aux = mlp.moe(tp, cfg, torch.from_numpy(x))
    jout, jaux = jmlp.moe(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-5)


def test_moe_ties_take_the_lower_expert():
    """Equal router probabilities: ``lax.top_k`` takes the lower expert
    first, and so does the port."""
    cfg = ARCHS["granite-moe-1b-a400m"].reduced()
    p = {"router": torch.zeros((cfg.d_model, cfg.n_experts))}
    r = mlp.route(p, cfg, torch.ones((5, cfg.d_model)))
    want = np.asarray(jax.lax.top_k(jnp.full((5, cfg.n_experts), 0.25),
                                    cfg.expert_top_k)[1])
    np.testing.assert_array_equal(r["top_e"].numpy(), want)


def _mixer_params(model, kind):
    tree = numpy_params(model, seed=9)["blocks"]
    tree = tree[kind] if kind in tree else tree
    return {k: (v[0] if not isinstance(v, dict) else
                {kk: vv[0] for kk, vv in v.items()})
            for k, v in tree["mixer"].items()}


def test_mamba_ragged_last_chunk_matches_repro():
    """S = 24 with chunks of 16 (a last chunk of 8) against ``repro`` at
    chunks of 8, which divide S: output and final state."""
    model = api.Model(ARCHS["zamba2-1.2b"].reduced())
    cfg = model.cfg
    assert cfg.ssm_chunk == 16
    p = _mixer_params(model, None)
    x = np.random.default_rng(10).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    out, state = mamba2.mamba_seq(
        {k: (torch.from_numpy(v) if not isinstance(v, dict) else
             {kk: torch.from_numpy(vv) for kk, vv in v.items()})
         for k, v in p.items()}, cfg, torch.from_numpy(x))
    jcfg = JARCHS["zamba2-1.2b"].reduced(ssm_chunk=8)
    jout, jstate = jmamba.mamba_seq(jax.tree.map(jnp.asarray, p), jcfg,
                                    jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=TOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(jstate[key]), rtol=0, atol=TOL)


def test_mlstm_ragged_last_chunk_matches_repro():
    model = api.Model(ARCHS["xlstm-125m"].reduced())
    cfg = model.cfg
    p = _mixer_params(model, "m0")
    x = np.random.default_rng(11).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    out, state = xlstm.mlstm_seq(jax.tree.map(torch.from_numpy, p), cfg,
                                 torch.from_numpy(x), chunk=16)
    jout, jstate = jxlstm.mlstm_seq(jax.tree.map(jnp.asarray, p), cfg,
                                    jnp.asarray(x), chunk=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=TOL)
    for key in ("conv", "c", "n", "m"):
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(jstate[key]), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["gemma2-9b", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
def test_decode_writes_the_cache_in_place(name):
    """A decode step returns the tree it was given: every leaf keeps its
    storage, the K/V rows at ``pos`` change, the rows before it do not,
    and the cross cache stays as it was."""
    model, params = _model(name)
    B, S = 2, 10
    toks = np.random.default_rng(12).integers(0, model.cfg.vocab, (B, S))
    frames = _frames(model, B)
    inputs = {"tokens": toks[:, :S - 1]}
    if frames is not None:
        inputs["frames"] = frames
    cache = model.grow_cache(model.prefill(params, **inputs)[1], S + 2)
    before = jax.tree.map(torch.clone, cache)
    ptrs = jax.tree.map(lambda t: t.data_ptr(), cache)
    _, out = model.decode(params, toks[:, S - 1:], cache, S - 1)
    assert out is cache
    assert jax.tree.map(lambda t: t.data_ptr(), cache) == ptrs
    kv = cache["self"] if model.is_encdec else (
        cache["attn"] if "attn" in cache else cache["b"])
    old = before["self"] if model.is_encdec else (
        before["attn"] if "attn" in before else before["b"])
    for key in ("k", "v"):
        assert torch.equal(kv[key][..., :S - 1, :], old[key][..., :S - 1, :])
        assert not torch.equal(kv[key][..., S - 1, :], old[key][..., S - 1, :])
        assert not kv[key][..., S:, :].any()
    if model.is_encdec:
        assert torch.equal(cache["cross"]["k"], before["cross"]["k"])


def test_serve_launcher_runs_a_local_global_model():
    """``launch/serve.py --arch gemma2-9b --device cpu``: gemma2's reduced
    config embeds, indexes and serves (recall at this size: 1.0)."""
    qps, rec = serve.main(["--arch", "gemma2-9b", "--device", "cpu",
                           "--n", "256", "--queries", "32"])
    assert qps > 0 and rec >= 0.9
