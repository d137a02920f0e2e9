"""The port's model stack against ``repro``'s, on the CPU.

``repro``'s ``Model(get_arch("qwen3-0.6b").reduced())`` is initialised from
a seed and its parameters carried into the port
(``models/api.py::params_from_numpy``); both then embed the same token ids.
In f32 the embeddings agree within 1e-4 (matrix products and norms summed
in other orders; measured about 3e-7). With ``compute_dtype="bfloat16"``
they agree within 1e-2 absolute at magnitudes near 1, about three bf16
ulps: the two frameworks round to bf16 after different operations (XLA
fuses elementwise chains), and each position's hidden state carries that
through 2 layers before the f32 mean.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as jlayers
from repro.models.api import Model as JModel
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import layers
from repro_torch.models.api import Model, params_from_numpy

TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _pair(compute_dtype, **over):
    jcfg = dataclasses.replace(jget_arch("qwen3-0.6b").reduced(**over),
                               attention_impl="xla",
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(**over),
                               compute_dtype=compute_dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg)
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_embed_matches_jax(compute_dtype):
    jm, jp, tm, tp = _pair(compute_dtype)
    toks = np.random.default_rng(0).integers(
        0, jm.cfg.vocab, (6, 24)).astype(np.int32)
    want = np.asarray(jax.jit(jm.embed)(jp, toks))
    got = tm.embed(tp, toks)
    assert got.dtype == torch.float32 and got.shape == (6, jm.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL[compute_dtype])


def test_gelu_mlp_and_untied_head_carry():
    """The GELU MLP (tanh approximation, as ``jax.nn.gelu``) and a tree
    with ``head/w`` carry across and embed alike."""
    jm, jp, tm, tp = _pair("float32", mlp_kind="gelu", tie_embeddings=False,
                           qk_norm=False)
    assert "head" in tp and "w_gate" not in tp["blocks"]["ffn"]
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab, (3, 17)).astype(np.int32)
    np.testing.assert_allclose(tm.embed(tp, toks).numpy(),
                               np.asarray(jm.embed(jp, toks)), rtol=0,
                               atol=TOL["float32"])


def test_layers_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5)
    np.testing.assert_allclose(
        layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jlayers.rope(x, pos, 1e6)), rtol=0, atol=1e-6)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm({"scale": torch.from_numpy(scale)},
                        torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.rms_norm({"scale": scale}, x)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        layers.softcap(torch.from_numpy(x), 2.0).numpy(),
        np.asarray(jlayers.softcap(x, 2.0)), rtol=0, atol=1e-6)


def test_configs_are_repro_data():
    from repro.configs import ARCHS as JARCHS

    assert set(ARCHS) == set(JARCHS)
    for name, cfg in ARCHS.items():
        want = dataclasses.asdict(JARCHS[name])
        assert dataclasses.asdict(cfg) == want, name
        assert cfg.hd == JARCHS[name].hd
        assert cfg.padded_vocab == JARCHS[name].padded_vocab
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
            JARCHS[name].reduced())


def test_carry_rejects_a_mismatched_tree():
    jm, jp, tm, _ = _pair("float32")
    tree = jax.tree.map(np.asarray, jp)
    tree["embed"]["table"] = tree["embed"]["table"][:8]
    with pytest.raises(ValueError, match="embed/table"):
        params_from_numpy(tm, tree, device="cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tm, tree, device="cpu")


def test_init_draws_from_the_generator():
    tm = Model(get_arch("qwen3-0.6b").reduced())
    a = tm.init(torch.Generator().manual_seed(0), device="cpu")
    b = tm.init(torch.Generator().manual_seed(0), device="cpu")
    for path in (("embed", "table"), ("blocks", "mixer", "wq")):
        x, y = a, b
        for key in path:
            x, y = x[key], y[key]
        assert torch.equal(x, y)
    assert a["blocks"]["mixer"]["wq"].shape == (2, 64, 4, 16)
    assert torch.equal(a["final_norm"]["scale"], torch.ones(64))
    assert abs(float(a["embed"]["table"].std()) - 0.02) < 1e-3
    with pytest.raises(ValueError, match="generator"):
        tm.init(torch.Generator().manual_seed(0), device="meta")
