"""The port's eager prune oracle (``core/rng.py``) against the JAX
package's, on the CPU.

  * ``rng.prune`` and its batch form keep the same ids as ``repro``'s
    ``core/rng.py::prune`` on the same ``cc_dists``, bit for bit (the same
    f32 compares of the same values);
  * ``pairwise_sq_dists`` agrees with ``repro``'s to 1e-5 of its terms
    (other summation orders);
  * ``prune_batch``, ``ops.prune(impl="legacy")`` and
    ``BuildConfig(prune_impl="legacy")`` keep exactly the ids of
    ``impl="torch"``: the eager matrix is computed with the lazy prune's
    operations in its order;
  * ``ops.prune(impl="legacy")`` keeps ``repro``'s legacy ids on the same
    inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro.kernels import ops as jops
from repro_torch.core import build as tbuild
from repro_torch.core import rng as trng
from repro_torch.core import storage as tstorage
from repro_torch.kernels import ops as tops


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _problem(n=400, d=16, B=24, C=40, seed=0):
    """Build-shaped candidate lists: duplicates, invalid slots, an
    all-invalid row, an exact distance tie; no node is its own
    candidate."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    node = rng.integers(0, n, size=B)
    cand = rng.integers(-1, n, size=(B, C)).astype(np.int32)
    cand[:, 5] = cand[:, 2]
    cand[cand == node[:, None]] = -1
    cand[1] = -1
    cvec = table[np.maximum(cand, 0)]
    du = ((cvec - table[node][:, None, :]) ** 2).sum(-1).astype(np.float32)
    du = np.where(cand >= 0, du, np.inf).astype(np.float32)
    du[2, 7] = du[2, 3]
    return cand, du, table, cvec


def _cc(cvec):
    """Squared candidate distances computed once in f64, rounded to f32:
    the same cc_dists for both packages."""
    x = cvec.astype(np.float64)
    cc = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    return cc.astype(np.float32)


CASES = [(4, 1.0, True), (8, 1.0, True), (8, 1.2, True), (8, 1.0, False),
         (6, 1.5, False), (64, 1.0, True)]


@pytest.mark.parametrize("m,alpha,fill", CASES)
def test_prune_matches_jax_on_same_cc(m, alpha, fill):
    cand, du, _, cvec = _problem(seed=m)
    cc = _cc(cvec)
    want = jax.vmap(lambda i, d_, c: jrng.prune(
        i, d_, c, m=m, alpha=alpha, fill=fill))(
            jnp.asarray(cand), jnp.asarray(du), jnp.asarray(cc))
    got = trng.prune_batch_cc(_t(cand), _t(du), _t(cc), m=m, alpha=alpha,
                              fill=fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one row at a time, as repro's prune takes it
    for b in (0, 1, 2):
        row = trng.prune(_t(cand[b]), _t(du[b]), _t(cc[b]), m=m,
                         alpha=alpha, fill=fill)
        np.testing.assert_array_equal(row.numpy(), np.asarray(want[b]))
    assert (got[1] == -1).all()


def test_pairwise_sq_dists_matches_jax():
    _, _, _, cvec = _problem(seed=3)
    want = np.asarray(jrng.pairwise_sq_dists(jnp.asarray(cvec)))
    got = trng.pairwise_sq_dists(_t(cvec)).numpy()
    xx = (cvec.astype(np.float64) ** 2).sum(-1)
    tol = 1e-5 * (xx[:, :, None] + xx[:, None, :])
    assert np.all(np.abs(got - want) <= tol)
    assert (got >= 0).all()
    assert got.shape == cvec.shape[:2] + (cvec.shape[1],)


@pytest.mark.parametrize("m,alpha,fill", CASES)
def test_legacy_matches_torch_bit_for_bit(m, alpha, fill):
    cand, du, table, cvec = _problem(seed=10 + m)
    ids, dist, tbl, vecs = _t(cand), _t(du), _t(table), _t(cvec)
    want = tops.prune(ids, dist, tbl, m=m, alpha=alpha, fill=fill,
                      impl="torch")
    for got in (
        trng.prune_batch(ids, dist, vecs, m=m, alpha=alpha, fill=fill),
        tops.prune(ids, dist, tbl, m=m, alpha=alpha, fill=fill,
                   impl="legacy"),
        tops.prune(ids, dist, tbl, m=m, alpha=alpha, fill=fill,
                   impl="legacy", cand_vecs=vecs),
    ):
        assert torch.equal(got, want)


@pytest.mark.parametrize("m,alpha,fill", CASES[:4])
def test_legacy_matches_jax_legacy(m, alpha, fill):
    cand, du, table, _ = _problem(seed=20 + m)
    want = jops.prune(jnp.asarray(cand), jnp.asarray(du), jnp.asarray(table),
                      m=m, alpha=alpha, fill=fill, impl="legacy")
    got = tops.prune(_t(cand), _t(du), _t(table), m=m, alpha=alpha,
                     fill=fill, impl="legacy")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("codec", ["int8", "pq"])
def test_legacy_decodes_codec_tables(codec):
    cand, du, table, _ = _problem(seed=31, d=32)
    cfg = tstorage.StorageConfig.int8() if codec == "int8" \
        else tstorage.StorageConfig.pq()
    enc = tstorage.encode_vectors(_t(table), cfg)
    got = tops.prune(_t(cand), _t(du), enc, m=8, impl="legacy")
    want = tops.prune(_t(cand), _t(du), enc, m=8, impl="torch")
    assert torch.equal(got, want)


def test_prune_without_candidates():
    got = trng.prune_batch(torch.zeros((3, 0), dtype=torch.int32),
                           torch.zeros((3, 0)), torch.zeros((3, 0, 4)), m=5)
    assert got.shape == (3, 5) and (got == -1).all()


def test_legacy_build_gives_the_torch_table():
    rng = np.random.default_rng(7)
    vectors = rng.standard_normal((512, 16)).astype(np.float32)
    tables = {impl: tbuild.build_neighbor_table(
        vectors, tbuild.BuildConfig(m=8, ef_construction=24,
                                    brute_threshold=32, prune_impl=impl),
        device="cpu") for impl in ("legacy", "torch")}
    assert torch.equal(tables["legacy"], tables["torch"])
    assert (tables["legacy"][:, :-1] >= 0).any()


def test_unknown_prune_impl_raises():
    cand, du, table, _ = _problem()
    with pytest.raises(ValueError, match="unknown impl"):
        tops.prune(_t(cand), _t(du), _t(table), m=4, impl="pallas")
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.prune(_t(cand), _t(du), _t(table), m=4, impl="cuda")
