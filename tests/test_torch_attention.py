"""The port's attention against ``repro``'s, on the CPU.

The port's plain version (``repro_torch.kernels.ops.flash_attention`` on
CPU tensors, i.e. ``kernels/ref.py::attention``) is held against the Pallas
kernel run in interpret mode (``repro.kernels.ops.flash_attention(impl=
"pallas")``, small blocks so that every shape spans several) and against
``repro``'s reference, on the same numpy inputs, within 1e-5 in f32 (both
sum Dh products and the softmax in other orders). The grid covers causal
and bidirectional attention, GQA at g = 2 and 4, a window, a softcap,
``q_offset``, ragged Sq / Skv, an odd head dim (9), and Sq = 2048, where
both references chunk the queries (``block_q``). Where a row sees no key
the plain versions agree with each other (the mean of V) and the kernels,
not compared here, give 0 (``tests/test_torch_cuda.py`` pins that on the
card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

TOL = 1e-5

# B, Hq, Hkv, Sq, Skv, Dh, keyword arguments
CASES = {
    "causal": (1, 2, 2, 32, 32, 16, {}),
    "bidirectional": (2, 2, 2, 40, 40, 8, {"causal": False}),
    "gqa2_ragged": (1, 4, 2, 37, 37, 16, {}),
    "gqa4": (1, 8, 2, 48, 48, 8, {}),
    "window": (1, 2, 1, 64, 64, 16, {"window": 16}),
    "softcap": (1, 4, 2, 32, 32, 16, {"softcap": 20.0}),
    "q_offset": (2, 4, 2, 19, 53, 16, {"q_offset": 34}),
    "cross_ragged": (1, 2, 2, 21, 45, 12, {"causal": False}),
    "everything": (1, 4, 2, 45, 77, 8,
                   {"window": 24, "softcap": 30.0, "q_offset": 32}),
    # an odd head dim, as the card's bodies zero-fill it
    "odd_dh9_gqa2_ragged": (1, 4, 2, 29, 29, 9, {}),
}


def _inputs(B, Hq, Hkv, Sq, Skv, Dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, Hq, Sq, Dh), (B, Hkv, Skv, Dh), (B, Hkv, Skv, Dh)))


def _port(q, k, v, **kw):
    return ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               **kw).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_and_reference(case):
    B, Hq, Hkv, Sq, Skv, Dh, kw = CASES[case]
    q, k, v = _inputs(B, Hq, Hkv, Sq, Skv, Dh, seed=Sq * 100 + Skv)
    got = _port(q, k, v, **kw)
    assert got.dtype == np.float32 and got.shape == (B, Hq, Sq, Dh)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = jops.flash_attention(jq, jk, jv, impl="pallas", block_q=16,
                                  block_k=16, **kw)
    want = jref.attention(jq, jk, jv, **kw)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [{}, {"window": 300}], ids=["causal", "window"])
def test_long_sequence_chunks_queries(kw):
    """Sq = 2048: both references evaluate the queries in 512-row chunks."""
    q, k, v = _inputs(1, 2, 1, 2048, 2048, 8, seed=2048)
    got = _port(q, k, v, **kw)
    want = jref.attention(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_row_seeing_no_key_is_the_mean_of_v():
    """window 4 and q_offset 40 over 16 keys: queries at positions >= 20
    see none; the plain version returns the mean of V there, as
    ``repro``'s reference does."""
    q, k, v = _inputs(1, 2, 2, 8, 16, 8, seed=7)
    kw = {"window": 4, "q_offset": 40}
    got = _port(q, k, v, **kw)
    want = np.asarray(jref.attention(*(jnp.asarray(x) for x in (q, k, v)),
                                     **kw))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.broadcast_to(
        v.mean(axis=2, keepdims=True), got.shape), rtol=TOL, atol=TOL)


def test_bf16_in_bf16_out():
    q, k, v = _inputs(1, 4, 2, 32, 32, 16, seed=3)
    t = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    got = ops.flash_attention(*t)
    assert got.dtype == torch.bfloat16
    want = ops.flash_attention(*(x.float() for x in t))
    # one rounding of the f32 result to bf16: half an ulp, 2^-9 relative
    assert torch.allclose(got.float(), want, rtol=2.0 ** -8, atol=0)


def test_dispatch_tokens():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 8, 8, 8, 1))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k[:, :1].expand(1, 3, 8, 8), v, impl="torch")
    assert ops.launch_counts()["flash_attention"] == 0
