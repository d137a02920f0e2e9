"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test skips (the decision is taken in
a fixture). On the card, run ``python -m pytest -m cuda
tests/test_torch_cuda.py``. This file imports torch and the port only, so
it runs where JAX is not installed. Small shapes that reach the kernels' edge
cases: d not a multiple of 4 (the scalar load path), n not a multiple of
32, bit 31 of a visited word, -1 everywhere, ip, alpha > 1, no fill, and
every stored layout of the vector table (f32, bf16, f16, int8 + scales, PQ
at dsub = 4 and, for d = 13, dsub = 1), and d = 1024, qwen3-0.6b's width,
where each lane loops over several 16-byte loads of a row. Integers are bit-identical;
distances agree within 1e-5 of the magnitude of their terms (``‖q‖² +
‖x‖²`` of the decoded row; both sum d products in other orders). The prune
runs at model widths too (d = 1024 and 8192, where only some candidate rows
fit in shared memory), and in each regime of its plan (all rows staged,
the table of dots and its lazy columns, some rows staged). Flash
attention agrees with its plain version over the variant grid, with q, k and v in the layout the projections leave
(``[B, S, H, Dh]`` viewed as ``[B, H, S, Dh]``), within 1e-5 in f32 and,
in bf16 and f16, one bf16 ulp plus that 1e-5 (both round one f32 result
once, summed in other orders), on the body its dtype and head dim name
(16-bit with Dh % 16 == 0: the tensor-core body, over every config's
head dim, GQA groups up to 48 and query lengths around its tiles; f32
with Dh % 4 == 0: the 3xTF32 body, over head dims from 4 to 256, GQA
groups and query lengths alike), and gives 0 on a row that sees no key,
as the TPU kernel does. The all-pairs distance
kernel runs ``repro``'s shape sweep (tests/test_kernels.py) and one ragged
large shape in f32, bf16 and f16, l2 and ip, within 1e-5 of its terms, the
16-bit types also within ``half_gate`` (and on dots that cancel to 0, from
aligned and unaligned rows); edge_select runs F not a multiple of its
CTA's warps, 48- and 24-byte layers, inactive rows and m_out above the
scanned ids; the
prune runs on every stored layout (bf16, f16, int8, PQ) at d = 128 and
1024, kept ids identical to the plain version's. gather_dist runs in every
regime of its launch plan (a query row over several tasks, one a task),
with a row of no valid slot, and the fused hop in both of its warp
counts; the fused hop's four outputs equal the composed hop's bit for
bit, distances included. The model stack's prefill runs the kernel
against an all-plain prefill (least row cosine 0.999) on gemma2's reduced
config at bf16 and Dh 256 and in the encoder-decoder's cross-attention
layout (a transposed q view, contiguous K/V, Sq != Skv, not causal).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitset
from repro_torch.core import storage
from repro_torch.kernels import ops, ref
from repro_torch.kernels.distance import half_gate, pairwise_dist_cuda
from repro_torch.kernels.edge_select import select_edges_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.gather_distance import gather_dist_cuda
from repro_torch.kernels.hop import hop_cuda
from repro_torch.kernels.prune import prune_cuda

pytestmark = pytest.mark.cuda

LAYOUTS = {
    "f32": storage.StorageConfig(),
    "bf16": storage.StorageConfig.compact("bfloat16"),
    "f16": storage.StorageConfig.compact("float16"),
    "int8": storage.StorageConfig.int8(),
    "pq": storage.StorageConfig.pq(),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: -m cuda)")
    return torch.device("cuda", 0)


def _close(got, want, q, table, ids):
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    qq = (q * q).sum(-1, keepdim=True).expand_as(want)
    dec = storage.decode_vectors(table)
    xx = (dec * dec).sum(-1)[ids.clamp_min(0).long()]
    tol = 1e-5 * (qq + xx)
    assert bool(((got - want).abs() <= tol)[fin].all())


def _problem(dev, n=333, d=24, m=4, B=7, W=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    logn = int(np.ceil(np.log2(n)))
    table = torch.randn((n, d), generator=g)
    nbrs = torch.randint(-1, n, (n, logn + 1, m), generator=g,
                         dtype=torch.int32)
    q = torch.randn((B, d), generator=g)
    u = torch.randint(-1, n, (B, W), generator=g, dtype=torch.int32)
    L = torch.randint(0, n // 2, (B,), generator=g, dtype=torch.int32)
    R = L + torch.randint(0, n // 2, (B,), generator=g, dtype=torch.int32)
    exp_ok = torch.rand((B, W), generator=g) < 0.7
    pre = torch.randint(0, n, (B, 9), generator=g, dtype=torch.int32)
    pre[0, :2] = 31  # bit 31 of word 0
    vis = bitset.make(B, n)
    bitset.test_and_set(vis, pre, torch.ones_like(pre, dtype=torch.bool))
    to = dict(device=dev)
    return dict(n=n, logn=logn, table=table.to(**to), nbrs=nbrs.to(**to),
                q=q.to(**to), u=u.to(**to), Lw=L.repeat_interleave(W).to(**to),
                Rw=R.repeat_interleave(W).to(**to), exp_ok=exp_ok.to(**to),
                vis=vis.to(**to))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("d", [24, 13, 128, 1024])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gather_dist(dev, d, metric, layout):
    p = _problem(dev, d=d)
    table = storage.encode_vectors(p["table"], LAYOUTS[layout])
    ids = torch.randint(-1, p["n"], (5, 37), device=dev, dtype=torch.int32)
    ids[1] = -1
    q = p["q"][:5].contiguous()
    ops.reset_launch_counts()
    got = gather_dist_cuda(q, table, ids, metric=metric)
    assert ops.layout_counts()[f"gather_dist[{layout}]"] == 1
    want = ref.gather_dist(q, table, ids, metric=metric)
    if metric == "l2":
        _close(got, want, q, table, ids)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# the gather's launch plan (kernels/gather_distance.py::plan) in each of
# its regimes: B = 1 and 64 split a query row's slots over several warps'
# tasks, 4,097 takes one query row a task (two at d = 1,024); d = 128 and
# 1,024 run the unrolled row widths, 13 and 24 the loop (13: scalar loads)
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("d", [13, 24, 128, 1024])
@pytest.mark.parametrize("M", [3, 37, 64])
@pytest.mark.parametrize("B", [1, 64, 4097])
def test_gather_dist_plan_regimes(dev, B, M, d, layout):
    from repro_torch.kernels.gather_distance import plan, rows_vec, \
        table_args

    g = torch.Generator().manual_seed(B + M + d)
    n = 777
    table = storage.encode_vectors(torch.randn((n, d), generator=g).to(dev),
                                   LAYOUTS[layout])
    q = torch.randn((B, d), generator=g).to(dev)
    ids = torch.randint(-1, n, (B, M), generator=g,
                        dtype=torch.int32).to(dev)
    ids[B // 2] = -1  # a row with no valid slot
    got = gather_dist_cuda(q, table, ids)
    want = ref.gather_dist(q, table, ids)
    _close(got, want, q, table, ids)
    assert bool(torch.isinf(got[B // 2]).all())
    t = table_args(table, dev)
    p = plan(B, M, t.layout, d, rows_vec(t))
    assert p.slots * p.split >= M and p.slots <= 64


# the hop's plan: 16 warps a CTA below 264 queries, 4 at or above
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize("B", [7, 300])
def test_hop_plan_regimes(dev, B, d, layout):
    p = _problem(dev, n=1000, d=d, m=8, B=B, W=4, seed=B)
    table = storage.encode_vectors(p["table"], LAYOUTS[layout])
    args = (p["q"], table, p["nbrs"], p["u"], p["Lw"], p["Rw"])
    got = hop_cuda(*args, p["vis"].clone(), p["exp_ok"], logn=p["logn"],
                   m_out=16)
    want = ref.hop(*args, p["vis"].clone(), p["exp_ok"], logn=p["logn"],
                   m_out=16)
    comp = ops.hop(*args, p["vis"].clone(), p["exp_ok"], logn=p["logn"],
                   m_out=16, impl="composed")
    for i in (0, 2, 3):
        assert torch.equal(got[i], want[i])
    for a, b in zip(got, comp):
        assert torch.equal(a, b)
    _close(got[1], want[1], p["q"], table, got[0])


@pytest.mark.parametrize("skip_layers", [True, False])
@pytest.mark.parametrize("case", ["random", "L>R", "L==R", "full",
                                  "F_ragged", "m12", "m6", "inactive",
                                  "m_out_above_scanned"])
def test_select_edges(dev, skip_layers, case):
    """The CTA's rows (eight warps, one frontier row each) in every case:
    F not a multiple of the warps, m = 12 (48-byte layers) and m = 6 (the
    4-byte copy), rows with u = -1, and m_out above the ids the scanned
    layers hold (a narrow range scans one layer)."""
    m = {"m12": 12, "m6": 6}.get(case, 8)
    B = 61 if case == "F_ragged" else 64
    p = _problem(dev, n=1000, m=m, B=B, W=1)
    us = p["u"].reshape(-1)
    L, R = p["Lw"].clone(), p["Rw"].clone()
    if case == "L>R":
        L, R = R + 1, L
    elif case == "L==R":
        R = L.clone()
        us = L.clone()
    elif case == "full":
        L[:] = 0
        R[:] = p["n"] - 1
    elif case == "inactive":
        us = torch.where(torch.arange(B, device=dev) % 3 == 0, -1, us)
    elif case == "m_out_above_scanned":
        us = L.clone()
        R = L + 1
    m_outs = (1, 8, 40) if case != "m_out_above_scanned" else (40, 200)
    for m_out in m_outs:
        got = select_edges_cuda(p["nbrs"], us, L, R, logn=p["logn"],
                                m_out=m_out, skip_layers=skip_layers)
        want = ref.select_edges(p["nbrs"], us, L, R, logn=p["logn"],
                                m_out=m_out, skip_layers=skip_layers)
        assert torch.equal(got, want)
        if case == "m_out_above_scanned":
            assert bool((want[:, m_out - 1] == -1).all())
        if case == "inactive":
            assert bool((got[us < 0] == -1).all())


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("d", [24, 13, 1024])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_hop(dev, d, metric, layout):
    p = _problem(dev, d=d)
    table = storage.encode_vectors(p["table"], LAYOUTS[layout])
    args = (p["q"], table, p["nbrs"], p["u"], p["Lw"], p["Rw"])
    vk, vp = p["vis"].clone(), p["vis"].clone()
    got = hop_cuda(*args, vk, p["exp_ok"], logn=p["logn"], m_out=8,
                   metric=metric)
    want = ref.hop(*args, vp, p["exp_ok"], logn=p["logn"], m_out=8,
                   metric=metric)
    for i in (0, 2, 3):
        assert torch.equal(got[i], want[i])
    assert got[3] is vk
    if metric == "l2":
        _close(got[1], want[1], p["q"], table, got[0])
    else:
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)
    # the dispatch's auto picks the kernel on CUDA tensors, and the
    # composed path gives the same integers
    ops.reset_launch_counts()
    comp = ops.hop(*args, p["vis"].clone(), p["exp_ok"], logn=p["logn"],
                   m_out=8, metric=metric, impl="composed")
    auto = ops.hop(*args, p["vis"].clone(), p["exp_ok"], logn=p["logn"],
                   m_out=8, metric=metric)
    for i in (0, 2, 3):
        assert torch.equal(comp[i], auto[i])
    # and the same distances, bit for bit: both run common.cuh warp_dists
    assert torch.equal(comp[1], auto[1])
    counts = ops.launch_counts()
    assert counts["hop"] == 1 and counts["select_edges"] == 1
    assert counts["gather_dist"] == 1
    layouts = ops.layout_counts()
    assert layouts[f"hop[{layout}]"] == 1
    assert layouts[f"gather_dist[{layout}]"] == 1


@pytest.mark.parametrize("alpha,fill", [(1.0, True), (1.3, True),
                                        (1.0, False)])
@pytest.mark.parametrize("C,d", [(20, 16), (80, 128), (128, 128), (33, 7)])
def test_prune(dev, alpha, fill, C, d):
    g = torch.Generator().manual_seed(C + d)
    n, B = 500, 64
    table = torch.randn((n, d), generator=g).to(dev)
    node = torch.randint(0, n, (B,), generator=g).to(dev)
    cand = torch.randint(-1, n, (B, C), generator=g,
                         dtype=torch.int32).to(dev)
    cand[:, 5] = cand[:, 2]
    cand = torch.where(cand == node[:, None].int(), -1, cand)
    cand[1] = -1
    cvec = table[cand.clamp_min(0).long()]
    du = torch.where(cand >= 0,
                     ((cvec - table[node][:, None, :]) ** 2).sum(-1),
                     torch.inf).contiguous()
    for m in (4, 16):
        got = prune_cuda(cand, du, table, m=m, alpha=alpha, fill=fill)
        want = ref.prune(cand, du, table, m=m, alpha=alpha, fill=fill)
        assert torch.equal(got, want)


@pytest.mark.parametrize("C,d,B", [(144, 1024, 512), (128, 8192, 96)])
def test_prune_at_model_width(dev, C, d, B):
    """Rows that do not fit in shared memory are read from global memory:
    kept ids still bit-identical to the plain version."""
    g = torch.Generator().manual_seed(d)
    n = 3000
    table = torch.randn((n, d), generator=g).to(dev)
    node = torch.randint(0, n, (B,), generator=g).to(dev)
    cand = torch.randint(-1, n, (B, C), generator=g,
                         dtype=torch.int32).to(dev)
    cand[:, 100] = cand[:, 3]           # a duplicate past the staged rows
    cand = torch.where(cand == node[:, None].int(), -1, cand).contiguous()
    cvec = table[cand.clamp_min(0).long()]
    du = torch.where(cand >= 0,
                     ((cvec - table[node][:, None, :]) ** 2).sum(-1),
                     torch.inf).contiguous()
    for alpha in (1.0, 1.2):
        got = prune_cuda(cand, du, table, m=16, alpha=alpha)
        want = ref.prune(cand, du, table, m=16, alpha=alpha)
        assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["bf16", "f16", "int8", "pq"])
@pytest.mark.parametrize("C,d,B", [(80, 128, 256), (144, 1024, 256)])
def test_prune_codec(dev, layout, C, d, B):
    """The prune's codec body: rows decoded once as gathered (staged as
    f32) and, at d = 1024 where only some rows fit in shared memory,
    decoded element by element in the sweeps: kept ids identical to the
    plain version on the decoded rows."""
    g = torch.Generator().manual_seed(C + d)
    n = 2000
    x = torch.randn((n, d), generator=g).to(dev)
    table = storage.encode_vectors(x, LAYOUTS[layout])
    dec = storage.decode_vectors(table)
    node = torch.randint(0, n, (B,), generator=g).to(dev)
    cand = torch.randint(-1, n, (B, C), generator=g,
                         dtype=torch.int32).to(dev)
    cand[:, C - 1] = cand[:, 3]          # a duplicate past the staged rows
    cand = torch.where(cand == node[:, None].int(), -1, cand).contiguous()
    cvec = dec[cand.clamp_min(0).long()]
    du = torch.where(cand >= 0,
                     ((cvec - dec[node][:, None, :]) ** 2).sum(-1),
                     torch.inf).contiguous()
    for alpha, fill in ((1.0, True), (1.2, False)):
        ops.reset_launch_counts()
        got = ops.prune(cand, du, table, m=16, alpha=alpha, fill=fill)
        assert ops.layout_counts()[f"prune[{layout}]"] == 1
        want = ref.prune(cand, du, table, m=16, alpha=alpha, fill=fill)
        assert torch.equal(got, want)
        # the plain versions on the decoded f32 rows give the same ids
        assert torch.equal(
            want, ref.prune(cand, du, dec, m=16, alpha=alpha, fill=fill))


# the prune's regimes (kernels/prune.py::smem_plan): one CTA with every row
# at d = 128, the table at qwen3-0.6b's widths (C = 8 below its 16
# columns), and one CTA that stages only some rows at d = 4096 and 8192
PRUNE_REGIMES = [(80, 128, "block"), (48, 1024, "table"),
                 (128, 1024, "table"), (144, 1024, "table"),
                 (144, 2048, "table"), (8, 4096, "table"),
                 (48, 4096, "partial"), (128, 8192, "partial")]


@pytest.mark.parametrize("C,d,regime,layout", [
    (C, d, regime, layout) for C, d, regime in PRUNE_REGIMES
    for layout in (LAYOUTS if d == 1024 and C != 128 else ["f32"])])
def test_prune_regime(dev, C, d, regime, layout):
    """Kept ids bit-identical to the plain version's in every regime, with
    duplicates whose copies sit at both ends of the row and on either side
    of the staged rows (the later copy the nearer in one row), a row whose
    staged rows are all -1 and one whose unstaged rows are, a row with
    fewer live candidates than m (the fill path), alpha 1.0 and 1.2 (a
    larger alpha suppresses fewer rows) and no fill; each launch counted
    in the regime its plan names."""
    from repro_torch.kernels.prune import smem_plan

    plan = smem_plan(C, d)
    assert plan.regime == regime
    staged = plan.staged
    g = torch.Generator().manual_seed(C + d)
    n, B = 3000, 64 if d > 2048 else 192
    x = torch.randn((n, d), generator=g).to(dev)
    table = storage.encode_vectors(x, LAYOUTS[layout])
    dec = storage.decode_vectors(table)
    node = torch.randint(0, n, (B,), generator=g).to(dev)
    cand = torch.randint(-1, n, (B, C), generator=g,
                         dtype=torch.int32).to(dev)
    cand[:, C - 1] = cand[:, 1]          # copies at both ends
    cand[:, min(staged, C - 2)] = cand[:, 2]  # one staged, one not
    cand[3, :staged] = -1                # every staged row -1
    cand[4, staged:] = -1                # every unstaged row -1
    cand[5, 6:] = -1                     # 6 candidates or fewer, m = 16
    cand = torch.where(cand == node[:, None].int(), -1, cand).contiguous()
    cvec = dec[cand.clamp_min(0).long()]
    du = torch.where(cand >= 0,
                     ((cvec - dec[node][:, None, :]) ** 2).sum(-1),
                     torch.inf)
    du[6, C - 1] = du[6, 1] * 0.5        # the later copy is the nearer
    du = du.contiguous()
    for alpha, fill in ((1.0, True), (1.2, True), (1.2, False)):
        ops.reset_launch_counts()
        got = prune_cuda(cand, du, table, m=16, alpha=alpha, fill=fill)
        assert prune_cuda.regime_launches[regime] == 1
        assert sum(prune_cuda.regime_launches.values()) == 1
        want = ref.prune(cand, du, table, m=16, alpha=alpha, fill=fill)
        assert torch.equal(got, want)
        assert bool((got[5, 6:] == -1).all())


def _keep_ranks(cand, du, kept):
    """Each kept id's rank in its row's (du, position) order (every
    candidate valid and distinct)."""
    C = cand.shape[1]
    pos = (cand[:, :, None] == kept[:, None, :]).int().argmax(1)
    dk = du.gather(1, pos)
    q = torch.arange(C, device=cand.device)[None, :, None]
    before = (du[:, :, None] < dk[:, None, :]) | (
        (du[:, :, None] == dk[:, None, :]) & (q < pos[:, None, :]))
    return before.sum(1)[kept >= 0]


@pytest.mark.parametrize("C,layout", [(48, "f32"), (144, "f32"),
                                      (144, "bf16"), (144, "int8")])
def test_prune_table_lazy_column(dev, C, layout):
    """The table regime's lazy column (a keep beyond a node's 16 nearest
    candidates): each node's 20 nearest are one row and near-copies of it,
    so the first keep suppresses the rest of the table's 16, and every
    later keep (rows in other directions, farther) is ranked 21 or more.
    Kept ids bit-identical to the plain version's at alpha 1.0 and 1.2."""
    from repro_torch.kernels.prune import smem_plan

    d, B, dup = 1024, 96, 20
    assert smem_plan(C, d).regime == "table"
    g = torch.Generator().manual_seed(C)
    u = torch.randn((B, 1, d), generator=g)
    e = torch.randn((B, 1, d), generator=g)
    e = 10 * e / e.norm(dim=-1, keepdim=True)
    eps = torch.randn((B, dup - 1, d), generator=g)
    eps = 0.05 * eps / eps.norm(dim=-1, keepdim=True)
    f = torch.randn((B, C - dup, d), generator=g)
    f = 12 * f / f.norm(dim=-1, keepdim=True)
    x = torch.cat([u, u + e, u + e + eps, u + f], 1)  # [B, 1 + C, d]
    x = x.reshape(B * (C + 1), d).to(dev)
    table = storage.encode_vectors(x, LAYOUTS[layout])
    dec = storage.decode_vectors(table)
    node = torch.arange(B, device=dev) * (C + 1)
    order = torch.argsort(torch.rand((B, C), generator=g), 1).to(dev)
    cand = (node[:, None] + 1 + order).to(torch.int32).contiguous()
    cvec = dec[cand.long()]
    du = ((cvec - dec[node][:, None, :]) ** 2).sum(-1).contiguous()
    for alpha in (1.0, 1.2):
        ops.reset_launch_counts()
        got = prune_cuda(cand, du, table, m=16, alpha=alpha)
        assert prune_cuda.regime_launches["table"] == 1
        want = ref.prune(cand, du, table, m=16, alpha=alpha)
        assert torch.equal(got, want)
        ranks = _keep_ranks(cand, du, want)
        assert int((ranks >= 16).sum()) == 15 * B  # 15 lazy columns a node


# repro's sweep (tests/test_kernels.py) and one ragged large shape
DIST_SHAPES = [(8, 8, 8), (16, 32, 24), (37, 65, 40), (128, 128, 64),
               (3, 200, 130), (1000, 70001, 131), (1, 300, 64), (50, 1, 128)]
DIST_BODY = {torch.float32: "tf32x3", torch.bfloat16: "wgmma",
             torch.float16: "wgmma"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("bq,n,d", DIST_SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pairwise_dist(dev, metric, bq, n, d, dtype):
    g = torch.Generator().manual_seed(bq * 1000 + n + d)
    q = torch.randn((bq, d), generator=g).to(dev, dtype)
    x = torch.randn((n, d), generator=g).to(dev, dtype)
    ops.reset_launch_counts()
    got = ops.pairwise_dist(q, x, metric=metric)
    assert ops.launch_counts()["pairwise_dist"] == 1
    assert ops.body_counts()[f"pairwise_dist[{DIST_BODY[dtype]}]"] == 1
    want = ref.pairwise_dist(q, x, metric=metric)
    assert got.dtype == torch.float32 and got.shape == (bq, n)
    qf, xf = q.float(), x.float()
    tol = 1e-5 * ((qf * qf).sum(1, keepdim=True) + (xf * xf).sum(1)[None])
    assert bool(((got - want).abs() <= tol).all())
    if dtype != torch.float32:
        gate = half_gate(got, q, x, metric=metric, plain=want)
        assert gate["over_plain"] == 0 and gate["over_exact"] == 0


def cancelling_inputs(bq, n, d, dtype, seed=0):
    """q [bq, d] and x [n, d] in ``dtype`` from a numpy seed, whose first
    halves of rows give dots that cancel exactly (q = [a, a], x = [b, -b],
    so q.x = 0 beside |q|.|x| of some d * 64) and whose other rows are
    plain normal draws (dots that do not cancel): the inputs on which the
    half types' gate is stated (kernels/distance.py::half_gate). Also used
    by tests/test_torch_tc_numerics.py and tests/test_torch_distance.py."""
    rng = np.random.default_rng(seed)
    h = d // 2
    a = rng.standard_normal((bq, h)) * 8
    b = rng.standard_normal((n, h)) * 8
    q = np.concatenate([a, a, np.zeros((bq, d - 2 * h))], 1)
    x = np.concatenate([b, -b, np.zeros((n, d - 2 * h))], 1)
    q[bq // 2:] = rng.standard_normal((bq - bq // 2, d)) * 8
    x[n // 2:] = rng.standard_normal((n - n // 2, d)) * 8
    return torch.from_numpy(q).to(dtype), torch.from_numpy(x).to(dtype)


def _shifted(t, offset):
    """t's values in a contiguous tensor that starts ``offset`` elements
    into its buffer (offset 1: rows not 16-byte aligned)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    v = buf[offset:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_pairwise_dist_half_gate_on_cancelling_dots(dev, metric, dtype,
                                                    offset):
    """Dots that cancel to 0 beside a large |q|.|x|: the wgmma body and the
    plain version both pass ``half_gate`` (against each other and against
    the exact result), from 16-byte-aligned rows and from rows one element
    off (the element loads)."""
    q, x = cancelling_inputs(128, 1000, 128, dtype)
    q, x = _shifted(q.to(dev), offset), _shifted(x.to(dev), offset)
    ops.reset_launch_counts()
    got = pairwise_dist_cuda(q, x, metric=metric)
    assert ops.body_counts()["pairwise_dist[wgmma]"] == 1
    want = ref.pairwise_dist(q, x, metric=metric)
    gate = half_gate(got, q, x, metric=metric, plain=want)
    assert gate["over_plain"] == 0 and gate["over_exact"] == 0, gate
    assert half_gate(want, q, x, metric=metric)["over_exact"] == 0


def test_pairwise_dist_rejects_bad_inputs(dev):
    q = torch.randn((4, 8), device=dev)
    x = torch.randn((6, 8), device=dev)
    with pytest.raises(TypeError):
        pairwise_dist_cuda(q, x.half())
    with pytest.raises(TypeError):
        pairwise_dist_cuda(q.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        pairwise_dist_cuda(q, torch.randn((8, 6), device=dev).t())
    with pytest.raises(ValueError, match="agree"):
        pairwise_dist_cuda(q, x[:, :5].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_dist_cuda(q, x.cpu())
    with pytest.raises(ValueError, match="metric"):
        pairwise_dist_cuda(q, x, metric="cos")


# B, Hq, Hkv, Sq, Skv, Dh, keyword arguments
FLASH = {
    "causal": (2, 4, 4, 32, 32, 128, {}),
    "embed_path": (8, 16, 8, 32, 32, 128, {}),
    "bidirectional": (2, 4, 2, 70, 70, 64, {"causal": False}),
    "gqa4_ragged": (1, 8, 2, 45, 45, 16, {}),
    "window": (1, 4, 2, 100, 100, 128, {"window": 24}),
    "softcap": (1, 4, 2, 64, 64, 256, {"softcap": 30.0}),
    "q_offset": (2, 4, 2, 19, 83, 128, {"q_offset": 64}),
    "cross_ragged": (1, 2, 1, 33, 97, 7, {"causal": False}),
    "everything": (1, 4, 2, 50, 130, 256,
                   {"window": 40, "softcap": 20.0, "q_offset": 80}),
    # head dims the bodies zero-fill to DP: rows of 2 to 500 bytes, by
    # TMA where they are multiples of 16 bytes, else by cp.async
    "dh1": (1, 4, 2, 33, 33, 1, {}),
    "dh8": (1, 4, 2, 40, 40, 8, {}),
    "dh40_window": (1, 4, 2, 70, 70, 40, {"window": 24}),
    "dh66_q_offset": (1, 4, 2, 45, 77, 66, {"q_offset": 32}),
    "dh72_bidirectional": (2, 4, 2, 50, 50, 72, {"causal": False}),
    "dh250_softcap": (1, 4, 2, 64, 64, 250, {"softcap": 30.0}),
}


def _qkv(dev, B, Hq, Hkv, Sq, Skv, Dh, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    # as the projections leave them: [B, S, H, Dh] viewed as [B, H, S, Dh]
    q = torch.randn((B, Sq, Hq, Dh), generator=g).to(dev, dtype)
    k = torch.randn((B, Skv, Hkv, Dh), generator=g).to(dev, dtype)
    v = torch.randn((B, Skv, Hkv, Dh), generator=g).to(dev, dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _bf16_tol(got, want):
    """One bf16 ulp at the larger magnitude, plus the f32 tolerance: both
    round one f32 result once, and those differ by their sum order (near
    0, where V's terms cancel, by more than an ulp of the output)."""
    _, e = torch.frexp(torch.maximum(got.float().abs(), want.float().abs()))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8) \
        + 1e-5


def _flash_body(dtype, Dh):
    """The body the dispatch must pick: the dtype alone, at any head dim
    up to 256."""
    return "tf32x3" if dtype == torch.float32 else "wgmma"


def _flash_loader(*ts):
    """The loader the dispatch must pick: TMA where every pointer is on
    16 bytes and every stride of a dim longer than 1 a positive multiple
    of 16 bytes, else cp.async."""
    def tma(t):
        es = t.element_size()
        return t.data_ptr() % 16 == 0 and all(
            st > 0 and st * es % 16 == 0
            for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)
    return "tma" if all(tma(t) for t in ts) else "cp.async"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_attention(dev, case, dtype):
    B, Hq, Hkv, Sq, Skv, Dh, kw = FLASH[case]
    q, k, v = _qkv(dev, B, Hq, Hkv, Sq, Skv, Dh, dtype, seed=Sq + Skv)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == 1
    body = _flash_body(dtype, Dh)
    assert ops.body_counts()[f"flash_attention[{body}]"] == 1
    loader = _flash_loader(q, k, v)
    assert ops.loader_counts()[f"flash_attention[{loader}]"] == 1
    want = ref.attention(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == (B, Hq, Sq, Dh)
    assert got.is_contiguous()
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        assert bool((err <= _bf16_tol(got, want)).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("Sq", [1, 31, 32, 33, 64, 100])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 48])
@pytest.mark.parametrize("Dh", [8, 40, 64, 66, 72, 96, 128, 192, 250, 256])
def test_flash_attention_tensor_core_grid(dev, Dh, g, Sq, dtype):
    """Every config's head dim through the tensor-core body, and head dims
    it zero-fills (by TMA at 16, 80 and 144-byte rows, by cp.async at 132
    and 500), GQA groups up to granite's 48:1, query lengths around the
    32-row packing and the 64-row tile; causal over Skv = Sq + 7 keys
    (q_offset 7), so ragged key tiles are masked, never merely zero."""
    Hkv = 2 if g < 48 else 1
    q, k, v = _qkv(dev, 1, g * Hkv, Hkv, Sq, Sq + 7, Dh, dtype,
                   seed=Dh + g + Sq)
    ops.reset_launch_counts()
    got = flash_attention_cuda(q, k, v, q_offset=7)
    assert ops.body_counts()["flash_attention[wgmma]"] == 1
    loader = "tma" if Dh % 8 == 0 else "cp.async"
    assert ops.loader_counts()[f"flash_attention[{loader}]"] == 1
    want = ref.attention(q, k, v, q_offset=7)
    err = (got.float() - want.float()).abs()
    assert bool((err <= _bf16_tol(got, want)).all())


@pytest.mark.parametrize("Sq", [1, 32, 33, 100])
@pytest.mark.parametrize("g", [1, 2, 48])
@pytest.mark.parametrize("Dh", [1, 4, 36, 64, 66, 100, 128, 196, 250, 256])
def test_flash_attention_tf32x3_grid(dev, Dh, g, Sq):
    """The 3xTF32 body over head dims that zero-fill to 64, 128, 192 and
    256 columns (by TMA where a row is a multiple of 16 bytes, else by
    cp.async), GQA groups and query lengths around its tiles, causal over
    Skv = Sq + 7 keys (q_offset 7): within 1e-5 of the plain version."""
    Hkv = 2 if g < 48 else 1
    q, k, v = _qkv(dev, 1, g * Hkv, Hkv, Sq, Sq + 7, Dh, torch.float32,
                   seed=Dh + g + Sq)
    ops.reset_launch_counts()
    got = flash_attention_cuda(q, k, v, q_offset=7)
    assert ops.body_counts()["flash_attention[tf32x3]"] == 1
    loader = "tma" if Dh % 4 == 0 else "cp.async"
    assert ops.loader_counts()[f"flash_attention[{loader}]"] == 1
    want = ref.attention(q, k, v, q_offset=7)
    assert float((got - want).abs().max()) <= 1e-5


def test_flash_attention_tensor_core_row_seeing_no_key_is_zero(dev):
    """As below, through the tensor-core body (bf16, Dh 64)."""
    q, k, v = _qkv(dev, 1, 2, 2, 8, 16, 64, torch.bfloat16, seed=1)
    ops.reset_launch_counts()
    got = flash_attention_cuda(q, k, v, window=4, q_offset=40)
    assert ops.body_counts()["flash_attention[wgmma]"] == 1
    assert torch.equal(got, torch.zeros_like(got))


def test_flash_attention_refuses_autograd(dev):
    """Under grad mode an input that requires grad makes the wrapper
    raise before it launches (the kernel has no backward, so its output
    would carry no gradient); under torch.no_grad() the same inputs
    launch."""
    qkv = _qkv(dev, 1, 2, 2, 8, 8, 64, torch.bfloat16, seed=5)
    for i in range(3):
        args = list(qkv)
        args[i] = args[i].detach().requires_grad_(True)
        ops.reset_launch_counts()
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention_cuda(*args)
        assert ops.launch_counts()["flash_attention"] == 0
        with torch.no_grad():
            flash_attention_cuda(*args)
        assert ops.launch_counts()["flash_attention"] == 1


def _in_rows(t, width, off=0):
    """t [B, H, S, Dh]'s values as a view of columns [off, off + Dh) of a
    [B, S, H, width] buffer, the projections' transposed layout."""
    buf = torch.zeros((t.shape[0], t.shape[2], t.shape[1], width),
                      dtype=t.dtype, device=t.device)
    buf[..., off:off + t.shape[-1]] = t.transpose(1, 2)
    return buf[..., off:off + t.shape[-1]].transpose(1, 2)


BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
# case -> (dtype, Dh): views TMA cannot read, and padded rows it can
TMA_VIEWS = {
    "q_2_bytes_off_bf16": (BF16, 128), "q_2_bytes_off_f16": (F16, 128),
    "q_4_bytes_off_bf16": (BF16, 128), "q_4_bytes_off_f32": (F32, 128),
    "rows_of_136_bytes_bf16": (BF16, 64), "rows_of_136_bytes_f32": (F32, 32),
    "kv_expanded_bf16": (BF16, 128), "kv_expanded_f32": (F32, 128),
    "padded_rows_dh66_bf16": (BF16, 66), "padded_rows_dh66_f32": (F32, 66),
}


@pytest.mark.parametrize("case", sorted(TMA_VIEWS))
def test_flash_attention_tensor_core_needs_tma_strides(dev, case):
    """Views TMA cannot read run the same body by the cp.async loader: a
    q view 2 or 4 bytes off its allocation (2- or 4-byte pieces), rows of
    136 bytes (8-byte pieces), K/V expanded over heads (a head stride of
    0); a head dim of 66 in rows padded to 72 goes by TMA, which
    zero-fills past 66. Each within 1e-5 (f32) or one bf16 ulp (16-bit)
    of the plain version."""
    dtype, Dh = TMA_VIEWS[case]
    B, Hq, Hkv, S = 2, 4, 2, 45
    q, k, v = _qkv(dev, B, Hq, Hkv, S, S, Dh, dtype, seed=11)
    es = q.element_size()
    if case.startswith("q_2_bytes_off") or case.startswith("q_4_bytes"):
        off = (2 if case.startswith("q_2") else 4) // es
        q = _in_rows(q, Dh + 8, off)
    elif case.startswith("rows_of_136_bytes"):
        q, k, v = (_in_rows(t, 136 // es) for t in (q, k, v))
    elif case.startswith("kv_expanded"):
        k, v = (t[:, :1].expand(B, Hkv, S, Dh) for t in (k, v))
    else:
        q, k, v = (_in_rows(t, 72) for t in (q, k, v))
    loader = "tma" if case.startswith("padded_rows") else "cp.async"
    assert _flash_loader(q, k, v) == loader
    ops.reset_launch_counts()
    got = flash_attention_cuda(q, k, v)
    assert ops.loader_counts()[f"flash_attention[{loader}]"] == 1
    assert ops.body_counts()[f"flash_attention[{_flash_body(dtype, Dh)}]"] \
        == 1
    want = ref.attention(q, k, v)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        assert bool((err <= _bf16_tol(got, want)).all())


def test_flash_attention_row_seeing_no_key_is_zero(dev):
    """window 4, q_offset 40, 16 keys: queries past position 19 see no key;
    the kernel gives 0 there (the TPU kernel's clamped denominator), the
    plain version the mean of V (the reference's additive mask)."""
    q, k, v = _qkv(dev, 1, 2, 2, 8, 16, 64, torch.float32, seed=1)
    got = flash_attention_cuda(q, k, v, window=4, q_offset=40)
    assert torch.equal(got, torch.zeros_like(got))
    plain = ref.attention(q, k, v, window=4, q_offset=40)
    assert torch.allclose(plain, v.mean(2, keepdim=True).expand_as(plain),
                          atol=1e-6)


def test_flash_attention_rejects_bad_inputs(dev):
    q, k, v = _qkv(dev, 1, 4, 2, 8, 8, 16, torch.float32, seed=2)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, k.double(), v)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(q[:, :3], k, v)
    with pytest.raises(ValueError, match="dense"):
        flash_attention_cuda(q, k.transpose(2, 3), v)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 2, 4, 264), device=dev)
        flash_attention_cuda(big, big, big)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q.cpu(), k, v)


def test_cuda_rejects_bad_inputs(dev):
    p = _problem(dev)
    with pytest.raises(TypeError):
        gather_dist_cuda(p["q"], p["table"].double(), p["u"])
    with pytest.raises(ValueError, match="contiguous"):
        gather_dist_cuda(p["q"], p["table"].t(), p["u"])
    with pytest.raises(ValueError, match="CUDA"):
        gather_dist_cuda(p["q"].cpu(), p["table"], p["u"])
    # a codec struct's every leaf is checked
    i8 = storage.encode_vectors(p["table"], LAYOUTS["int8"])
    with pytest.raises(TypeError):
        gather_dist_cuda(p["q"], i8._replace(scales=i8.scales.double()),
                         p["u"])
    with pytest.raises(ValueError, match="CUDA"):
        gather_dist_cuda(p["q"], i8._replace(codes=i8.codes.cpu()), p["u"])
    pq = storage.encode_vectors(p["table"], LAYOUTS["pq"])
    with pytest.raises(ValueError, match="agree"):
        gather_dist_cuda(p["q"], pq._replace(
            codebook=pq.codebook[:, :8].contiguous()),
                         p["u"])
    # the prune checks a codec table's every leaf too
    with pytest.raises(TypeError):
        ops.prune(p["u"], p["u"].float(), i8._replace(
            scales=i8.scales.double()), m=4, impl="cuda")
    with pytest.raises(ValueError, match="agree"):
        ops.prune(p["u"], p["u"].float(), pq._replace(
            codebook=pq.codebook[:, :8].contiguous()), m=4, impl="cuda")


@pytest.mark.parametrize("layout", ["bf16", "f16", "int8", "pq"])
def test_encode_on_card_matches_cpu(dev, layout):
    """The encodes run where the table lives; on the card they give the
    CPU's bits (the PQ encode sums in numpy's order, one IEEE op each)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((5000, 128), generator=g)
    on_card = storage.encode_vectors(x.to(dev), LAYOUTS[layout])
    on_cpu = storage.encode_vectors(x, LAYOUTS[layout])
    for a, b in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (on_card, on_cpu))):
        assert a.is_cuda
        assert torch.equal(a.cpu(), b)


def _cosine(a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.double().flatten(1), b.double().flatten(1), dim=-1).min())


def test_prefill_kernel_matches_plain_on_gemma2_reduced(dev):
    """gemma2's reduced config at bf16 and Dh 256 (window 16 over 80
    positions, attention softcap, sandwich norms): the kernel prefill's
    logits and K/V caches against an all-plain prefill, every launch on
    the tensor-core body."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.api import Model

    cfg = get_arch("gemma2-9b").reduced(head_dim=256,
                                        compute_dtype="bfloat16")
    model = Model(cfg)
    plain = Model(dataclasses.replace(cfg, attention_impl="torch"))
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    tokens = torch.randint(0, cfg.vocab, (3, 80), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    ops.reset_launch_counts()
    logits, caches = model.prefill(params, tokens=tokens)
    assert ops.body_counts()["flash_attention[wgmma]"] == cfg.n_layers
    want, want_caches = plain.prefill(params, tokens=tokens)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    assert bool(torch.isfinite(logits).all())
    assert _cosine(logits, want) >= 0.999
    for key in ("a", "b"):
        assert _cosine(caches[key]["k"][0], want_caches[key]["k"][0]) >= 0.999


def test_cross_attention_kernel_matches_plain(dev):
    """The encoder-decoder's cross-attention layout: q the projection's
    transposed view, K/V contiguous from ``cross_kv``, Sq != Skv and not
    causal; then a whole seamless prefill (reduced, bf16) against plain."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import attention
    from repro_torch.models.api import Model

    cfg = get_arch("seamless-m4t-large-v2").reduced(
        compute_dtype="bfloat16")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(2),
                        device=dev)
    p = {k: v[0] for k, v in params["dec_blocks"]["cross_attn"].items()}
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2, 40, cfg.d_model), generator=g, device=dev,
                    dtype=torch.bfloat16)
    enc = torch.randn((2, 72, cfg.d_model), generator=g, device=dev,
                      dtype=torch.bfloat16)
    kv = attention.cross_kv(p, cfg, enc)
    assert kv[0].is_contiguous() and kv[0].shape == (2, cfg.n_kv_heads, 72,
                                                     cfg.hd)
    pos = torch.arange(40, device=dev)
    ops.reset_launch_counts()
    got, _ = attention.attention(p, cfg, x, pos, causal=False, kv=kv)
    assert ops.body_counts()["flash_attention[wgmma]"] == 1
    want, _ = attention.attention(
        p, dataclasses.replace(cfg, attention_impl="torch"), x, pos,
        causal=False, kv=kv)
    assert _cosine(got, want) >= 0.999

    frames = torch.randn((2, 72, cfg.d_model), generator=g, device=dev)
    tokens = torch.randint(0, cfg.vocab, (2, 40), device=dev, generator=g)
    logits, _ = model.prefill(params, frames=frames, tokens=tokens)
    plain = Model(dataclasses.replace(cfg, attention_impl="torch"))
    want, _ = plain.prefill(params, frames=frames, tokens=tokens)
    assert _cosine(logits, want) >= 0.999
