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
fit in shared memory). Flash attention agrees with its plain version over
the variant grid, with q, k and v in the layout the projections leave
(``[B, S, H, Dh]`` viewed as ``[B, H, S, Dh]``), within 1e-5 in f32 and, in bf16, one ulp plus that 1e-5
(both round one f32 result once, summed in other orders), and gives 0 on
a row that sees no key, as the TPU kernel does. The all-pairs distance
kernel runs ``repro``'s shape sweep (tests/test_kernels.py) and one ragged
large shape in f32, bf16 and f16, l2 and ip, within 1e-5 of its terms; the
prune runs on every stored layout (bf16, f16, int8, PQ) at d = 128 and
1024, kept ids identical to the plain version's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitset
from repro_torch.core import storage
from repro_torch.kernels import ops, ref
from repro_torch.kernels.distance import pairwise_dist_cuda
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


@pytest.mark.parametrize("skip_layers", [True, False])
@pytest.mark.parametrize("case", ["random", "L>R", "L==R", "full"])
def test_select_edges(dev, skip_layers, case):
    p = _problem(dev, n=1000, m=8, B=64, W=1)
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
    for m_out in (1, 8, 40):
        got = select_edges_cuda(p["nbrs"], us, L, R, logn=p["logn"],
                                m_out=m_out, skip_layers=skip_layers)
        want = ref.select_edges(p["nbrs"], us, L, R, logn=p["logn"],
                                m_out=m_out, skip_layers=skip_layers)
        assert torch.equal(got, want)


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


# repro's sweep (tests/test_kernels.py) and one ragged large shape
DIST_SHAPES = [(8, 8, 8), (16, 32, 24), (37, 65, 40), (128, 128, 64),
               (3, 200, 130), (1000, 70001, 131)]


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
    want = ref.pairwise_dist(q, x, metric=metric)
    assert got.dtype == torch.float32 and got.shape == (bq, n)
    qf, xf = q.float(), x.float()
    tol = 1e-5 * ((qf * qf).sum(1, keepdim=True) + (xf * xf).sum(1)[None])
    assert bool(((got - want).abs() <= tol).all())


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_attention(dev, case, dtype):
    B, Hq, Hkv, Sq, Skv, Dh, kw = FLASH[case]
    q, k, v = _qkv(dev, B, Hq, Hkv, Sq, Skv, Dh, dtype, seed=Sq + Skv)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.attention(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == (B, Hq, Sq, Dh)
    assert got.is_contiguous()
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
