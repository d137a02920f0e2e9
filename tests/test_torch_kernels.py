"""The port's plain kernel versions against the JAX package's, on the CPU.

Every module of ``repro_torch`` that holds a CUDA kernel has a plain torch
version (``repro_torch/kernels/ref.py``); on CPU tensors the dispatch runs
it. Here the same numpy inputs go through ``repro`` (its jnp reference, or
the Pallas kernel in interpret mode) and through the port:

  * integer outputs (edge ids, newly-visited masks, bitset words compared
    through a uint32 view, kept prune ids) are bit-identical;
  * f32 distances agree to rtol=atol=1e-5 at d <= 24 (XLA and torch sum
    in different orders), and +inf masks agree exactly.

Plus the dispatch rules: "auto" on CPU tensors runs the plain version and
launches no kernel; "cuda" on CPU tensors raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jbitset
from repro.core import segment_tree as jseg
from repro.core import search as jsearch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bitset as tbitset
from repro_torch.core import segment_tree as tseg
from repro_torch.core import search as tsearch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_dists(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)


def _words(bits):
    """Port words (int32) as the JAX package's uint32 words."""
    return bits.numpy().view(np.uint32)


def _problem(n=300, d=24, m=4, B=6, W=3, seed=0, full_range=False):
    """A structurally unconstrained hop problem, as tests/test_hop.py
    builds it (edges may be junk ids or -1)."""
    rng = np.random.default_rng(seed)
    logn = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    table = rng.standard_normal((n, d)).astype(np.float32)
    nbrs = rng.integers(-1, n, size=(n, logn + 1, m)).astype(np.int32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    u = rng.integers(-1, n, size=(B, W)).astype(np.int32)
    if full_range:
        L = np.zeros(B, np.int32)
        R = np.full(B, n - 1, np.int32)
    else:
        L = rng.integers(0, n // 2, size=B).astype(np.int32)
        R = (L + rng.integers(0, n // 2, size=B)).astype(np.int32)
    pre = rng.integers(0, n, size=(B, 9)).astype(np.int32)
    exp_ok = rng.integers(0, 2, size=(B, W)).astype(bool)
    return dict(n=n, logn=logn, table=table, nbrs=nbrs, q=q, u=u,
                Lw=np.repeat(L, W), Rw=np.repeat(R, W), pre=pre,
                exp_ok=exp_ok, B=B, W=W)


# ---------------------------------------------------------------------------
# gather-distance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
def test_gather_dist_matches_jax(metric, jimpl):
    rng = np.random.default_rng(1)
    n, d, B, M = 200, 24, 5, 17
    table = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    ids = rng.integers(-1, n, size=(B, M)).astype(np.int32)
    ids[0] = -1  # an all-masked row
    want = jops.gather_dist(jnp.asarray(q), jnp.asarray(table),
                            jnp.asarray(ids), metric=metric, impl=jimpl)
    got = tops.gather_dist(_t(q), _t(table), _t(ids), metric=metric)
    _assert_dists(got, want)
    assert np.isinf(got[0].numpy()).all()


# ---------------------------------------------------------------------------
# segment tree + edge selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skip_layers", [True, False])
def test_scan_mask_matches_jax(skip_layers):
    rng = np.random.default_rng(2)
    logn = 9
    for _ in range(40):
        u = int(rng.integers(0, 1 << logn))
        L = int(rng.integers(0, 1 << logn))
        R = int(rng.integers(L, 1 << logn))
        want = np.asarray(jseg.scan_mask(u, L, R, logn,
                                         skip_layers=skip_layers))
        got = tseg.scan_mask(u, L, R, logn, skip_layers=skip_layers)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["random", "L>R", "L==R", "full"])
@pytest.mark.parametrize("skip_layers", [True, False])
def test_select_edges_matches_jax(case, skip_layers):
    rng = np.random.default_rng(3)
    n, m, F, m_out = 300, 4, 64, 8
    logn = int(np.ceil(np.log2(n)))
    nbrs = rng.integers(-1, n, size=(n, logn + 1, m)).astype(np.int32)
    us = rng.integers(-1, n, size=F).astype(np.int32)
    L = rng.integers(0, n, size=F).astype(np.int32)
    R = rng.integers(0, n, size=F).astype(np.int32)
    if case == "L>R":
        L, R = np.maximum(L, R) + 1, np.minimum(L, R)
    elif case == "L==R":
        R = L.copy()
        us[: F // 2] = L[: F // 2]  # the node is the whole range
    elif case == "full":
        L[:] = 0
        R[:] = n - 1
    want = jref.select_edges(jnp.asarray(nbrs), jnp.asarray(us),
                             jnp.asarray(L), jnp.asarray(R), logn=logn,
                             m_out=m_out, skip_layers=skip_layers)
    got = tops.select_edges(_t(nbrs), _t(us), _t(L), _t(R), logn=logn,
                            m_out=m_out, skip_layers=skip_layers)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_edge_scan_valid_matches_jax():
    rng = np.random.default_rng(4)
    n, m, F = 300, 4, 32
    logn = int(np.ceil(np.log2(n)))
    K = (logn + 1) * m
    flat = rng.integers(-1, n, size=(F, K)).astype(np.int32)
    us = rng.integers(-1, n, size=(F, 1)).astype(np.int32)
    L = rng.integers(0, n, size=(F, 1)).astype(np.int32)
    R = (L + rng.integers(0, n, size=(F, 1))).astype(np.int32)
    lay = (np.arange(K, dtype=np.int32) // m)[None, :]
    want = jref.edge_scan_valid(jnp.asarray(flat), jnp.asarray(us),
                                jnp.asarray(L), jnp.asarray(R),
                                jnp.asarray(lay), logn=logn)
    got = tref.edge_scan_valid(_t(flat), _t(us), _t(L), _t(R), _t(lay),
                               logn=logn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_edges_scalar_range_and_int16_table():
    rng = np.random.default_rng(5)
    n, m, F = 100, 4, 16
    logn = int(np.ceil(np.log2(n)))
    nbrs = rng.integers(-1, n, size=(n, logn + 1, m)).astype(np.int16)
    us = rng.integers(-1, n, size=F).astype(np.int32)
    want = jops.select_edges(jnp.asarray(nbrs), jnp.asarray(us), 10, 70,
                             logn=logn, m_out=6, impl="xla")
    got = tops.select_edges(_t(nbrs), _t(us), 10, 70, logn=logn, m_out=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# packed visited bitset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 100, 1000])
def test_bitset_test_and_set_matches_jax(n):
    """Includes bit 31 of a word (the int32 sign bit), duplicate ids within
    a row, -1 slots and n % 32 != 0."""
    rng = np.random.default_rng(6)
    B, K = 5, 40
    jb = jbitset.make(B, n)
    tb = tbitset.make(B, n)
    for step in range(3):
        ids = rng.integers(-1, n, size=(B, K)).astype(np.int32)
        ids[0, :4] = [31, 31, 63 % n, 31]
        ids[1, -2:] = [n - 1, n - 1]
        valid = rng.integers(0, 4, size=(B, K)) > 0
        jb, jseen = jbitset.test_and_set(jb, jnp.asarray(ids),
                                         jnp.asarray(valid))
        tb2, tseen = tbitset.test_and_set(tb, _t(ids), _t(valid))
        assert tb2 is tb  # updated in place
        np.testing.assert_array_equal(_words(tb), np.asarray(jb))
        np.testing.assert_array_equal(tseen.numpy(), np.asarray(jseen))
        look = rng.integers(-1, n, size=(B, 11)).astype(np.int32)
        np.testing.assert_array_equal(
            tbitset.lookup(tb, _t(look)).numpy(),
            np.asarray(jbitset.lookup(jb, jnp.asarray(look))))
    assert tbitset.num_words(n) == jbitset.num_words(n)


def test_bitset_sign_bit_word():
    bits = tbitset.make(1, 64)
    tbitset.test_and_set(bits, torch.tensor([[31, 0]], dtype=torch.int32),
                         torch.ones((1, 2), dtype=torch.bool))
    assert int(bits[0, 0]) == -(2**31) + 1
    assert _words(bits)[0, 0] == np.uint32(2**31 + 1)


# ---------------------------------------------------------------------------
# the whole hop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("timpl", ["torch", "composed"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("full_range", [False, True])
def test_hop_matches_jax(timpl, metric, full_range):
    p = _problem(full_range=full_range)
    jvis, _ = jbitset.test_and_set(jbitset.make(p["B"], p["n"]),
                                   jnp.asarray(p["pre"]),
                                   jnp.ones(p["pre"].shape, bool))
    want = jref.hop(jnp.asarray(p["q"]), jnp.asarray(p["table"]),
                    jnp.asarray(p["nbrs"]), jnp.asarray(p["u"]),
                    jnp.asarray(p["Lw"]), jnp.asarray(p["Rw"]), jvis,
                    jnp.asarray(p["exp_ok"]), logn=p["logn"], m_out=8,
                    metric=metric)
    tvis, _ = tbitset.test_and_set(tbitset.make(p["B"], p["n"]),
                                   _t(p["pre"]),
                                   torch.ones(p["pre"].shape, dtype=bool))
    got = tops.hop(_t(p["q"]), _t(p["table"]), _t(p["nbrs"]), _t(p["u"]),
                   _t(p["Lw"]), _t(p["Rw"]), tvis, _t(p["exp_ok"]),
                   logn=p["logn"], m_out=8, metric=metric, impl=timpl)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(_words(got[3]), np.asarray(want[3]))
    assert got[3] is tvis  # visited updated in place
    _assert_dists(got[1], want[1])


def test_hop_matches_jax_pallas_kernel():
    """The JAX megakernel (interpret mode) is the same contract."""
    p = _problem(seed=7)
    jvis = jbitset.make(p["B"], p["n"])
    want = jops.hop(jnp.asarray(p["q"]), jnp.asarray(p["table"]),
                    jnp.asarray(p["nbrs"]), jnp.asarray(p["u"]),
                    jnp.asarray(p["Lw"]), jnp.asarray(p["Rw"]), jvis,
                    jnp.asarray(p["exp_ok"]), logn=p["logn"], m_out=8,
                    impl="pallas")
    got = tops.hop(_t(p["q"]), _t(p["table"]), _t(p["nbrs"]), _t(p["u"]),
                   _t(p["Lw"]), _t(p["Rw"]), tbitset.make(p["B"], p["n"]),
                   _t(p["exp_ok"]), logn=p["logn"], m_out=8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(_words(got[3]), np.asarray(want[3]))
    _assert_dists(got[1], want[1])


# ---------------------------------------------------------------------------
# construction prune
# ---------------------------------------------------------------------------

def _prune_problem(seed=8, B=24, C=20, n=120, d=16):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    node = rng.integers(0, n, size=B)
    cand = rng.integers(-1, n, size=(B, C)).astype(np.int32)
    cand[:, 5] = cand[:, 2]           # duplicate ids
    # a node is never its own candidate (the build masks it): with du = 0
    # it would be kept first and make every later keep decision an exact
    # tie between two summation orders of the same distance
    cand[cand == node[:, None]] = -1
    cand[1] = -1                      # an all-invalid row
    cvec = table[np.maximum(cand, 0)]
    du = ((cvec - table[node][:, None, :]) ** 2).sum(-1).astype(np.float32)
    du = np.where(cand >= 0, du, np.inf).astype(np.float32)
    du[2, 7] = du[2, 3]               # an exact distance tie
    return cand, du, table, cvec


@pytest.mark.parametrize("alpha,fill", [(1.0, True), (1.2, True),
                                        (1.0, False), (1.5, False)])
@pytest.mark.parametrize("m", [4, 8])
def test_prune_matches_jax(alpha, fill, m):
    cand, du, table, cvec = _prune_problem()
    want = jops.prune(jnp.asarray(cand), jnp.asarray(du), jnp.asarray(table),
                      m=m, alpha=alpha, fill=fill, impl="xla")
    got = tops.prune(_t(cand), _t(du), _t(table), m=m, alpha=alpha,
                     fill=fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[1] == -1).all()
    # the caller-gathered form gives the same ids
    got_v = tops.prune(_t(cand), _t(du), _t(table), m=m, alpha=alpha,
                       fill=fill, cand_vecs=_t(cvec))
    np.testing.assert_array_equal(got_v.numpy(), got.numpy())


def test_prune_matches_jax_pallas_kernel():
    cand, du, table, _ = _prune_problem(seed=9, B=8)
    want = jops.prune(jnp.asarray(cand), jnp.asarray(du), jnp.asarray(table),
                      m=6, impl="pallas")
    got = tops.prune(_t(cand), _t(du), _t(table), m=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("C,d,staged,regime", [
    (80, 128, 80, "block"),             # the f32 build at d = 128: all rows
    (128, 128, 128, "block"),           # in one CTA, three CTAs an SM
    (33, 7, 33, "block"),
    (48, 1024, 16, "table"),            # qwen3-0.6b's reverse pass, C = 3m
    (128, 1024, 16, "table"),           # its brute levels
    (144, 1024, 16, "table"),           # its search levels, C = m + 128
    (48, 2048, 16, "table"),
    (128, 2048, 16, "table"),
    (144, 2048, 16, "table"),
    (8, 4096, 8, "table"),              # fewer candidates than columns
    (48, 3584, 15, "partial"),          # gemma2-9b's width: 17 rows do
    (48, 4096, 13, "partial"),          # not fit in one CTA
    (144, 4096, 13, "partial"),
    (128, 8192, 6, "partial"),          # chameleon-34b's width
    (144, 8192, 6, "partial"),
])
def test_prune_smem_plan_at_model_widths(C, d, staged, regime):
    """The prune's plan at every (C, d) a build at a model's width
    produces, one CTA a node: all C rows where three such CTAs fit on an
    SM, else the table regime where its CTA fits, else all C rows where
    they fit, else the partial regime, as many rows as fit beside the
    keep's row with the rest in global memory; inside the H100's 227 KB."""
    from repro_torch.kernels.prune import (SM_SMEM, SMEM_LIMIT,
                                           BLOCK_RESERVED, TABLE_K,
                                           smem_bytes, smem_plan,
                                           table_bytes)

    plan = smem_plan(C, d)
    assert (plan.staged, plan.regime) == (staged, regime)
    assert plan.bytes <= SMEM_LIMIT < 232448
    block = smem_bytes(C, d, C)
    three = SM_SMEM // (block + BLOCK_RESERVED) >= 3
    table_fits = table_bytes(C, d) <= SMEM_LIMIT
    assert (regime == "block") == (three or (not table_fits
                                             and block <= SMEM_LIMIT))
    assert (regime == "table") == (not three and table_fits)
    if regime == "table":
        assert plan.bytes == table_bytes(C, d) and staged == min(C, TABLE_K)
        return
    assert plan.bytes == smem_bytes(C, d, staged)
    row = (d + 3) // 4 * 16
    assert plan.bytes == (staged + (staged < C)) * row + 17 * C
    assert (regime == "partial") == (block > SMEM_LIMIT)
    assert staged <= C and (staged == C) == (regime != "partial")
    if regime == "partial":  # as many rows as fit, not one more
        assert smem_bytes(C, d, staged + 1) > SMEM_LIMIT


@pytest.mark.parametrize("C,d", [(20000, 4), (16, 60000), (70000, 4)])
def test_prune_smem_plan_raises_only_where_nothing_fits(C, d):
    """Only where not even the per-candidate state and the keep's row fit
    with no row staged (or C passes the kernel's 16-bit positions) does
    the plan raise; fewer candidates or a narrower row fit."""
    from repro_torch.kernels.prune import smem_plan

    with pytest.raises(ValueError, match="no row staged|fewer than"):
        smem_plan(C, d)
    fits = smem_plan(10000, 4) if d == 4 else smem_plan(16, 50000)
    assert fits.regime == "partial"


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_range_entry_ids_matches_jax():
    rng = np.random.default_rng(10)
    n = 1000
    L = rng.integers(0, n, size=64).astype(np.int32)
    R = (L + rng.integers(-3, 300, size=64)).astype(np.int32)
    R[:4] = L[:4] + np.array([0, 1, 2, 3])  # half-way rounding cases
    want = jsearch.range_entry_ids(jnp.asarray(L), jnp.asarray(R), n)
    got = tsearch.range_entry_ids(_t(L), _t(R), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_auto_on_cpu_runs_plain_and_launches_nothing():
    tops.reset_launch_counts()
    p = _problem(seed=11)
    q, table, nbrs = _t(p["q"]), _t(p["table"]), _t(p["nbrs"])
    ids = _t(p["pre"])
    np.testing.assert_array_equal(
        tops.gather_dist(q, table, ids).numpy(),
        tref.gather_dist(q, table, ids).numpy())
    tops.select_edges(nbrs, _t(p["u"][:, 0]), 0, 100, logn=p["logn"],
                      m_out=4)
    tops.hop(q, table, nbrs, _t(p["u"]), _t(p["Lw"]), _t(p["Rw"]),
             tbitset.make(p["B"], p["n"]), _t(p["exp_ok"]), logn=p["logn"],
             m_out=4)
    cand, du, tbl, _ = _prune_problem()
    tops.prune(_t(cand), _t(du), _t(tbl), m=4)
    qkv = torch.randn((3, 1, 2, 9, 8)).unbind(0)
    tops.flash_attention(*qkv)
    np.testing.assert_array_equal(
        tops.pairwise_dist(q, table).numpy(),
        tref.pairwise_dist(q, table).numpy())
    tops.prune(_t(cand), _t(du), _t(tbl), m=4, impl="legacy")
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
    assert "pairwise_dist" in tops.KERNELS


def test_cuda_impl_on_cpu_tensors_raises():
    p = _problem(seed=12)
    q, table, nbrs = _t(p["q"]), _t(p["table"]), _t(p["nbrs"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.gather_dist(q, table, _t(p["pre"]), impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.select_edges(nbrs, _t(p["u"][:, 0]), 0, 9, logn=p["logn"],
                          m_out=4, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.hop(q, table, nbrs, _t(p["u"]), _t(p["Lw"]), _t(p["Rw"]),
                 tbitset.make(p["B"], p["n"]), _t(p["exp_ok"]),
                 logn=p["logn"], m_out=4, impl="cuda")
    cand, du, tbl, _ = _prune_problem()
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.prune(_t(cand), _t(du), _t(tbl), m=4, impl="cuda")
    qkv = torch.randn((3, 1, 2, 9, 8)).unbind(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.flash_attention(*qkv, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.pairwise_dist(q, table, impl="cuda")
    # the kernel wrappers themselves refuse CPU tensors
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.KERNELS["gather_dist"](q, table, _t(p["pre"]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.KERNELS["flash_attention"](*qkv)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.KERNELS["pairwise_dist"](q, table)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.KERNELS["prune"](_t(cand), _t(du), _t(tbl), m=4)
    with pytest.raises(ValueError, match="unknown impl"):
        tops.gather_dist(q, table, _t(p["pre"]), impl="pallas")


def test_per_op_pin_routes_hop_through_composed():
    """An explicit edge_impl/dist_impl pin wins over impl (the JAX rule):
    the result equals the composed path's."""
    p = _problem(seed=13)
    args = (_t(p["q"]), _t(p["table"]), _t(p["nbrs"]), _t(p["u"]),
            _t(p["Lw"]), _t(p["Rw"]))
    a = tops.hop(*args, tbitset.make(p["B"], p["n"]), _t(p["exp_ok"]),
                 logn=p["logn"], m_out=8, impl="torch", dist_impl="torch")
    b = tops.hop(*args, tbitset.make(p["B"], p["n"]), _t(p["exp_ok"]),
                 logn=p["logn"], m_out=8, impl="composed")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
