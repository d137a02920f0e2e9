"""The port's all-pairs distance against the JAX package's, on the CPU.

The same numpy inputs go through ``repro``'s Pallas kernel in interpret
mode (``pairwise_dist_kernel_call(interpret=True)``) and its jnp
reference, and through the port's plain version (``ref.pairwise_dist``)
and its dispatch (``ops.pairwise_dist``, "auto" on CPU tensors: the plain
version, no launch). ``repro``'s own sweep (tests/test_kernels.py): l2 and
ip, f32 and bf16, five shapes, tolerance 1e-4 for f32 and 3e-2 for bf16
as that test states (bf16 inputs widen exactly; the two sides sum in
other orders). Plus the ordering test and f16 inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.distance as jdist
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SHAPES = [(8, 8, 8), (16, 32, 24), (37, 65, 40), (128, 128, 64),
          (3, 200, 130)]
_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(bq, n, d, dtype):
    rng = np.random.default_rng(bq * 1000 + n + d)
    q = jnp.asarray(rng.standard_normal((bq, d)), dtype)
    x = jnp.asarray(rng.standard_normal((n, d)), dtype)
    # the same values on the torch side: bf16 crosses as its f32 widening
    tq = torch.from_numpy(np.asarray(q.astype(jnp.float32))).to(_TORCH[dtype])
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(_TORCH[dtype])
    return q, x, tq, tx


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bq,n,d", SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_pairwise_dist_matches_jax(metric, bq, n, d, dtype):
    q, x, tq, tx = _inputs(bq, n, d, dtype)
    kern = jdist.pairwise_dist_kernel_call(
        q, x, metric=metric, block_q=16, block_n=32, block_k=16,
        interpret=True)
    jplain = jref.pairwise_dist(q, x, metric=metric)
    tplain = tref.pairwise_dist(tq, tx, metric=metric)
    tops.reset_launch_counts()
    got = tops.pairwise_dist(tq, tx, metric=metric)
    assert tops.launch_counts()["pairwise_dist"] == 0
    assert got.dtype == torch.float32 and got.shape == (bq, n)
    assert torch.equal(got, tplain)
    tol = 1e-4 if dtype == jnp.float32 else 3e-2
    for want in (kern, jplain):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


def test_pairwise_dist_f16_widens_exactly():
    """f16 inputs give the f32 distances of their widened values."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((9, 40))).half()
    x = torch.from_numpy(rng.standard_normal((70, 40))).half()
    for metric in ("l2", "ip"):
        got = tops.pairwise_dist(q, x, metric=metric)
        want = tref.pairwise_dist(q.float(), x.float(), metric=metric)
        assert torch.equal(got, want)


def test_pairwise_dist_ordering_preserved():
    """Distances drive top-k choices; the ordering matches repro's kernel."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    x = rng.standard_normal((256, 32)).astype(np.float32)
    want = jdist.pairwise_dist_kernel_call(jnp.asarray(q), jnp.asarray(x),
                                           interpret=True)
    got = tops.pairwise_dist(torch.from_numpy(q), torch.from_numpy(x))
    np.testing.assert_array_equal(
        np.argsort(got.numpy(), axis=1)[:, :10],
        np.argsort(np.asarray(want), axis=1)[:, :10])


def test_pairwise_dist_rejects_unknown_metric():
    with pytest.raises(ValueError, match="metric"):
        tref.pairwise_dist(torch.ones(2, 3), torch.ones(4, 3), metric="cos")
