"""The tensor-core designs' arithmetic and host-side planning, on the CPU.

The redesigned kernels (``csrc/flash_attention.cu``'s 16-bit and 3xTF32
bodies and ``csrc/distance.cu``) run only on the card. What their designs claim about
rounding is checked here by emulating it in torch and holding the result
against ``repro``'s references (``repro.kernels.ref``), with the card
gates' own tolerances:

  * flash attention: 16-bit Q.K^T products exact in f32, the online softmax
    over 32-key tiles in f32 (exp2 of log2(e)-scaled logits), P split into
    P_hi + P_lo in V's type, both products accumulated in f32, the output
    rounded once -- within ``bf16_tol`` (one bf16 ulp plus 1e-5) of the
    reference at S >= 256; the same with P rounded once to bf16 is not,
    which is why the kernel splits P;
  * flash attention in f32 (the 3xTF32 body): Q (scaled), K, V and P each
    split into big = ``cvt.rna`` tf32 and small = a - big, the small half
    read truncated, three tf32 products a step with small x small dropped,
    each wgmma step's sum truncated to f32 (the big product and the two
    small ones of S in accumulators of their own), at a cut-down version
    of each f32 shape of the card's grid -- within FLASH_F32_TOL of the
    f64 attention; one TF32 pass, and P rounded once to tf32, are not;
  * pairwise distance: 3xTF32 (``cvt.rna`` to tf32 for the big parts, the
    hardware's truncation of the low 13 bits for the small ones, the
    small x small term dropped, f32 sums) within DIST_RTOL = 1e-5 of
    ``‖q‖² + ‖x‖²``; one TF32 product is not. The bf16/f16 wgmma body
    (each k16 step's exact products added to the f32 accumulator and
    truncated, steps in k order) and the port's plain version both pass
    ``kernels/distance.py::half_gate`` on dots that cancel to 0 beside a
    large |q|.|x|; rounding the output or the products to bf16 does not.

Then the wrappers' planning, which is pure Python: which flash body runs,
the tensor-core tiling (GQA heads packed into a 64-row tile at short S),
its shared memory and grid, whether strides allow TMA, and the pairwise
plan (tiles, 16-byte copies or element loads, shared memory). Inputs are made from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import distance as tdist
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref as tref
from test_torch_cuda import _shifted, cancelling_inputs

LOG2E = 1.4426950408889634
DIST_RTOL = 1e-5            # chip_smoke.py: relative to ‖q‖² + ‖x‖²
FLASH_F32_TOL = 1e-5        # chip_smoke.py: the f32 gate
SMEM_PER_BLOCK = 232_448    # the H100's largest dynamic shared memory
SMEM_PER_SM = 233_472       # 228 KB, 1 KB of it reserved per block


def bf16_tol(got, want):
    """chip_smoke.py's gate for 16-bit outputs: one bf16 ulp at the larger
    magnitude of the two, plus FLASH_F32_TOL."""
    _, e = torch.frexp(torch.maximum(got.float().abs(), want.float().abs()))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8) \
        + FLASH_F32_TOL


# -- flash attention --------------------------------------------------------

def emulate_flash(q, k, v, dtype, *, split=True, bk=32, causal=True,
                  scale=None):
    """The tensor-core body's arithmetic on 16-bit-valued f32 tensors q
    [B, Hq, S, Dh], k / v [B, Hkv, S, Dh]: scores in f32 (the products of
    16-bit values are exact) times ``scale`` (default ``1 / sqrt(Dh)``),
    the online softmax over ``bk``-key tiles in log2 units, P split into
    hi and lo in ``dtype`` (or rounded once), P.V summed in f32, the
    output rounded once to ``dtype``."""
    B, Hq, Sq, Dh = q.shape
    g = Hq // k.shape[1]
    Skv = k.shape[2]
    kk = k.repeat_interleave(g, 1)
    vv = v.repeat_interleave(g, 1)
    sl2 = (1.0 / Dh ** 0.5 if scale is None else scale) * LOG2E
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    o = torch.zeros((B, Hq, Sq, Dh))
    qpos = torch.arange(Sq)[:, None]
    for kt in range(0, Skv, bk):
        s = (q @ kk[:, :, kt:kt + bk].transpose(-1, -2)) * sl2
        if causal:
            kpos = torch.arange(kt, min(kt + bk, Skv))[None, :]
            s = torch.where(kpos <= qpos, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        hi = p.to(dtype).float()
        pv = hi @ vv[:, :, kt:kt + bk]
        if split:
            pv = pv + (p - hi).to(dtype).float() @ vv[:, :, kt:kt + bk]
        o = o * corr + pv
    return (o / l.clamp_min(1e-30)).to(dtype)


def _flash_case(S, dtype, seed):
    """q, k, v with 16-bit values (f32 tensors) and repro's reference
    attention on them, rounded once to ``dtype`` as the plain version's
    output is."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(dtype).float()
               for sh in ((1, 4, S, 128), (1, 2, S, 128), (1, 2, S, 128)))
    want = np.asarray(jref.attention(jnp.asarray(q.numpy()),
                                     jnp.asarray(k.numpy()),
                                     jnp.asarray(v.numpy())))
    return q, k, v, torch.from_numpy(want.copy()).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("S", [256, 512])
def test_flash_split_p_is_within_the_card_gate(S, dtype):
    q, k, v, want = _flash_case(S, dtype, seed=S)
    got = emulate_flash(q, k, v, dtype)
    assert bool(((got.float() - want.float()).abs()
                 <= bf16_tol(got, want)).all())


@pytest.mark.parametrize("S", [256, 512])
def test_flash_p_rounded_once_breaks_the_card_gate(S):
    """The same inputs with P rounded once to bf16 (8 bits of p): a
    tenth of the outputs fall outside the gate, some by 50x."""
    q, k, v, want = _flash_case(S, torch.bfloat16, seed=S)
    got = emulate_flash(q, k, v, torch.bfloat16, split=False)
    over = (got.float() - want.float()).abs() > bf16_tol(got, want)
    assert float(over.float().mean()) > 0.01


def _zero_pad(t, DP):
    """t's head dim zero-filled to DP columns, as either loader fills the
    body's shared memory."""
    return torch.nn.functional.pad(t, (0, DP - t.shape[-1]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_flash_zero_filled_head_dim_is_exact(dtype):
    """A 16-bit head dim the body zero-fills (Dh 72 -> DP 128, at Dh 72's
    scale): the emulation on the padded inputs equals the unpadded
    emulation exactly in its first 72 columns (zero columns add exact
    zeros to every score and feed only the output columns past Dh, which
    come out 0 and are never stored)."""
    rng = np.random.default_rng(72)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(dtype).float()
               for sh in ((1, 4, 80, 72), (1, 2, 80, 72), (1, 2, 80, 72)))
    want = emulate_flash(q, k, v, dtype)
    got = emulate_flash(*(_zero_pad(t, 128) for t in (q, k, v)), dtype,
                        scale=1.0 / 72 ** 0.5)
    assert torch.equal(got[..., :72], want)
    assert not bool(got[..., 72:].float().any())


def test_flash_emulation_without_rounding_is_the_reference():
    """The emulation itself is the reference's function: in f32 with no
    16-bit rounding it agrees within the f32 gate."""
    q, k, v, _ = _flash_case(256, torch.bfloat16, seed=3)
    want = np.asarray(jref.attention(jnp.asarray(q.numpy()),
                                     jnp.asarray(k.numpy()),
                                     jnp.asarray(v.numpy())))
    got = emulate_flash(q, k, v, torch.float32)
    assert float((got - torch.from_numpy(want.copy())).abs().max()) \
        <= FLASH_F32_TOL


# -- flash attention in f32: the 3xTF32 body ---------------------------------

def _rna(a):
    return ((a.view(torch.int32) + (1 << 12)) & ~0x1FFF).view(torch.float32)


def _trunc(a):
    return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _rz(v):
    """f64 -> f32 rounded toward zero (a wgmma step's accumulation)."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _steps(acc, pairs):
    """acc (f32) += each (a, b) product of tf32-valued f32 operands in
    turn, one wgmma step each: the exact sum, truncated to f32."""
    for a, b in pairs:
        acc = _rz(acc.double() + a.double() @ b.double())
    return acc


def emulate_flash_f32(q, k, v, *, mode="3xtf32", causal=True, window=None,
                      softcap=None, q_offset=0, bk=32, scale=None):
    """The 3xTF32 body's arithmetic on f32 q [B, Hq, Sq, Dh], k / v [B,
    Hkv, Skv, Dh]: S = (scale q).k^T in k8 steps (``scale`` by default
    ``1 / sqrt(Dh)``), the online softmax over
    ``bk``-key tiles in log2 units, P.V in 8-key steps. ``mode``:
    "3xtf32" as the kernel (big.big into one accumulator and small.big +
    big.small into another for S; small.big, big.small, big.big into O);
    "1xtf32": one tf32 product of the rna-rounded operands; "p_once": as
    the kernel but P rounded once to tf32 (P.V = rna(P).(V_big + V_small))."""
    B, Hq, Sq, Dh = q.shape
    g = Hq // k.shape[1]
    Skv = k.shape[2]
    kk_ = k.repeat_interleave(g, 1)
    vv = v.repeat_interleave(g, 1)
    qs = q * (1.0 / Dh ** 0.5 if scale is None else scale)
    qb, kb, vb = _rna(qs), _rna(kk_), _rna(vv)
    qsm, ksm, vsm = _trunc(qs - qb), _trunc(kk_ - kb), _trunc(vv - vb)
    big = torch.zeros((B, Hq, Sq, Skv))
    small = torch.zeros((B, Hq, Sq, Skv))
    for c in range(0, Dh, 8):
        sl = slice(c, c + 8)
        kt = lambda t: t[..., sl].transpose(-1, -2)  # noqa: E731
        big = _steps(big, [(qb[..., sl], kt(kb))])
        if mode != "1xtf32":
            small = _steps(small, [(qsm[..., sl], kt(kb)),
                                   (qb[..., sl], kt(ksm))])
    s_all = big + small
    qpos = torch.arange(Sq)[:, None] + q_offset
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    o = torch.zeros((B, Hq, Sq, Dh))
    for kt0 in range(0, Skv, bk):
        x = s_all[..., kt0:kt0 + bk]
        if softcap is not None:
            x = softcap * torch.tanh(x / softcap)
        x = x * LOG2E
        kpos = torch.arange(kt0, min(kt0 + bk, Skv))[None, :]
        ok = torch.ones_like(kpos <= qpos)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        x = torch.where(ok, x, -torch.inf)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        o = o * corr
        for j in range(0, p.shape[-1], 8):
            pj = p[..., j:j + 8]
            r = slice(kt0 + j, kt0 + j + 8)
            pb = _rna(pj)
            if mode == "1xtf32":
                o = _steps(o, [(pb, vb[..., r, :])])
            elif mode == "p_once":
                o = _steps(o, [(pb, vsm[..., r, :]), (pb, vb[..., r, :])])
            else:
                o = _steps(o, [(_trunc(pj - pb), vb[..., r, :]),
                               (pb, vsm[..., r, :]), (pb, vb[..., r, :])])
    return o / l.clamp_min(1e-30)


def attention_f64(q, k, v, *, causal=True, window=None, softcap=None,
                  q_offset=0):
    B, Hq, Sq, Dh = q.shape
    g = Hq // k.shape[1]
    qd = q.double() / Dh ** 0.5
    kd = k.double().repeat_interleave(g, 1)
    vd = v.double().repeat_interleave(g, 1)
    s = qd @ kd.transpose(-1, -2)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq)[:, None] + q_offset
    kpos = torch.arange(k.shape[2])[None, :]
    ok = torch.ones_like(kpos <= qpos)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    s = torch.where(ok, s, -torch.inf)
    return torch.softmax(s, -1) @ vd


# chip_smoke.py's f32 flash shapes, cut to one batch and a head or two
# (Hq, Hkv, Sq, Skv, Dh, keyword arguments)
F32_GRID = {
    "path f32": (4, 2, 32, 32, 128, {}),
    "window f32": (2, 1, 512, 512, 128, {"window": 128}),
    "softcap f32": (2, 1, 256, 256, 256, {"softcap": 50.0}),
    "bidirectional f32": (2, 2, 200, 200, 64, {"causal": False}),
    "q_offset f32": (2, 1, 100, 256, 128, {"q_offset": 156}),
    "Dh 100 f32": (2, 1, 256, 256, 100, {}),
}


@pytest.fixture(scope="module")
def f32_errors():
    """Per F32_GRID shape and emulation mode, the largest |difference|
    from the f64 attention, on randn inputs as the card's grid draws."""
    out = {}
    for i, (name, (Hq, Hkv, Sq, Skv, Dh, kw)) in enumerate(F32_GRID.items()):
        rng = np.random.default_rng(100 + i)
        q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)) for sh in ((1, Hq, Sq, Dh), (1, Hkv, Skv, Dh),
                                    (1, Hkv, Skv, Dh)))
        want = attention_f64(q, k, v, **kw)
        out[name] = {mode: float((emulate_flash_f32(q, k, v, mode=mode, **kw)
                                  .double() - want).abs().max())
                     for mode in ("3xtf32", "1xtf32", "p_once")}
    return out


@pytest.mark.parametrize("name", sorted(F32_GRID))
def test_flash_3xtf32_is_within_the_f32_gate(f32_errors, name):
    assert f32_errors[name]["3xtf32"] <= FLASH_F32_TOL, f32_errors[name]


@pytest.mark.parametrize("mode", ["1xtf32", "p_once"])
def test_flash_one_tf32_rounding_breaks_the_f32_gate(f32_errors, mode):
    """One TF32 pass, or P rounded once to tf32 beside split products,
    puts the output outside the 1e-5 gate at some shape of the grid."""
    worst = max(e[mode] for e in f32_errors.values())
    assert worst > FLASH_F32_TOL, f32_errors


def test_flash_3xtf32_emulation_agrees_with_repro():
    """The f64 attention the emulation is held to is ``repro``'s
    reference function: in f32 the two agree within the f32 gate."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((1, 4, 64, 128), (1, 2, 64, 128), (1, 2, 64, 128)))
    want = np.asarray(jref.attention(*(jnp.asarray(a) for a in (q, k, v))))
    got = attention_f64(*(torch.from_numpy(a) for a in (q, k, v)))
    assert float(np.abs(got.numpy() - want).max()) <= FLASH_F32_TOL


def test_flash_3xtf32_zero_filled_head_dim_agrees_with_pallas():
    """f32 Dh 66 as the 3xTF32 body runs it, zero-filled to DP 128 at Dh
    66's scale: within FLASH_F32_TOL of ``repro``'s Pallas kernel
    (interpret mode) on the unpadded inputs, its columns past 66 0."""
    rng = np.random.default_rng(66)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((1, 2, 64, 66), (1, 1, 64, 66), (1, 1, 64, 66)))
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), impl="pallas", block_q=32,
        block_k=32))
    got = emulate_flash_f32(*(_zero_pad(torch.from_numpy(a), 128)
                              for a in (q, k, v)), scale=1.0 / 66 ** 0.5)
    assert float(np.abs(got[..., :66].numpy() - want).max()) \
        <= FLASH_F32_TOL
    assert not bool(got[..., 66:].any())


# -- pairwise distance ------------------------------------------------------

def rna_tf32(a):
    """``cvt.rna.tf32.f32``: the low 13 bits rounded to nearest, ties away
    from zero (f32 is sign-magnitude, so adding half an ulp to the bits
    rounds the magnitude)."""
    return ((a.view(torch.int32) + (1 << 12)) & ~0x1FFF).view(torch.float32)


def trunc_tf32(a):
    """What the tensor core reads of an f32 operand: the low 13 bits
    cleared."""
    return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)


def dot_3xtf32(q, x):
    """The kernel's product: big = rna(a), small = a - big (exact in f32,
    read truncated), big.big + big.small + small.big in f32 (each product
    of two tf32 values is exact in f32)."""
    qb, xb = rna_tf32(q), rna_tf32(x)
    qs, xs = trunc_tf32(q - qb), trunc_tf32(x - xb)
    return qs @ xb.T + qb @ xs.T + qb @ xb.T


def dot_1xtf32(q, x):
    return rna_tf32(q) @ rna_tf32(x).T


def _dist_rel_err(bq, n, d, dot):
    rng = np.random.default_rng(bq * 1000 + n + d)
    q = rng.standard_normal((bq, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    want = torch.from_numpy(np.array(jref.pairwise_dist(jnp.asarray(q),
                                                        jnp.asarray(x))))
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    qq = (tq * tq).sum(1, keepdim=True)
    xx = (tx * tx).sum(1)[None]
    got = (qq - 2.0 * dot(tq, tx)) + xx       # the kernel's epilogue order
    return (got - want).abs() / (qq + xx)


DIST_CASES = [(64, 2000, 128), (37, 500, 131), (3, 200, 130),
              (16, 2048, 1024)]


@pytest.mark.parametrize("bq,n,d", DIST_CASES)
def test_pairwise_3xtf32_is_within_dist_rtol(bq, n, d):
    assert float(_dist_rel_err(bq, n, d, dot_3xtf32).max()) <= DIST_RTOL


@pytest.mark.parametrize("bq,n,d", DIST_CASES)
def test_pairwise_one_tf32_product_is_not(bq, n, d):
    assert float(_dist_rel_err(bq, n, d, dot_1xtf32).max()) > DIST_RTOL


def test_tf32_split_is_exact():
    """big + small == a in f32, and big has no low bits: the split loses
    nothing before the tensor core truncates small."""
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10_000).astype(np.float32) * 1e3)
    big = rna_tf32(a)
    assert torch.equal(big + (a - big), a)
    assert not bool((big.view(torch.int32) & 0x1FFF).any())
    assert float(((a - big).abs() / a.abs()).max()) <= 2.0 ** -11


def rz32(v):
    """f64 -> f32 rounded toward zero: how the tensor cores round while
    they accumulate."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def dot_wgmma_16bit(q, x):
    """The wgmma body's dot of 16-bit q and x: each m64n128k16 step adds
    its 16 exact products to the f32 accumulator and truncates once, the
    steps in k order."""
    qd, xd = q.double(), x.double()
    acc = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float32)
    for k in range(0, q.shape[1], 16):
        acc = rz32(acc.double() + qd[:, k:k + 16] @ xd[:, k:k + 16].T)
    return acc


def _half_out(q, x, dot, metric):
    """The kernel's epilogue on a dot: -dot, or (qq - 2 dot) + xx with
    the norms summed in f32."""
    if metric == "ip":
        return -dot
    qf, xf = q.float(), x.float()
    return ((qf * qf).sum(1, keepdim=True) - 2.0 * dot) \
        + (xf * xf).sum(1)[None]


HALF = [torch.bfloat16, torch.float16]


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "f16"])
def test_wgmma_16bit_sum_order_passes_half_gate(dtype, metric):
    q, x = cancelling_inputs(64, 512, 128, dtype)
    plain = tref.pairwise_dist(q, x, metric=metric)
    got = _half_out(q, x, dot_wgmma_16bit(q, x), metric)
    gate = tdist.half_gate(got, q, x, metric=metric, plain=plain)
    assert gate["over_plain"] == 0 and gate["over_exact"] == 0, gate
    assert gate["margin_exact"] < 0.1
    own = tdist.half_gate(plain, q, x, metric=metric)
    assert own["over_exact"] == 0 and own["margin_exact"] < 0.1, own
    # the cancelling dots are exactly 0: what the sums leave there is
    # rounding, far inside the gate
    assert float((q[:32].double() @ x[:256].double().T).abs().max()) == 0.0


@pytest.mark.parametrize("how", ["output", "products"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "f16"])
def test_half_gate_fails_bf16_rounding(dtype, metric, how):
    """The gate has teeth: the output rounded to bf16, or each product
    rounded to bf16 before the f32 sum, puts thousands of outputs over
    it, some by 20x or more."""
    q, x = cancelling_inputs(64, 512, 128, dtype)
    if how == "output":
        got = _half_out(q, x, dot_wgmma_16bit(q, x), metric).bfloat16()
    else:
        prod = q.float()[:, None, :] * x.float()[None, :, :]
        got = _half_out(q, x, prod.bfloat16().float().sum(-1), metric)
    gate = tdist.half_gate(got.float(), q, x, metric=metric)
    assert gate["over_exact"] > 1000 and gate["margin_exact"] > 20, gate


def test_half_gate_chunks_agree():
    """The gate's column chunks (GATE_CHUNK) change no count."""
    q, x = cancelling_inputs(16, 700, 64, torch.bfloat16)
    got = _half_out(q, x, dot_wgmma_16bit(q, x), "ip").bfloat16().float()
    whole = tdist.half_gate(got, q, x, metric="ip")
    old = tdist.GATE_CHUNK
    try:
        tdist.GATE_CHUNK = 128
        parts = tdist.half_gate(got, q, x, metric="ip")
    finally:
        tdist.GATE_CHUNK = old
    assert whole == parts


# -- planning ---------------------------------------------------------------

@pytest.mark.parametrize("dtype,Dh,body", [
    (torch.bfloat16, 128, "wgmma"), (torch.float16, 96, "wgmma"),
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.float32, 128, "tf32x3"), (torch.bfloat16, 7, "wgmma"),
    (torch.float16, 40, "wgmma"), (torch.float32, 7, "tf32x3"),
    (torch.float32, 4, "tf32x3"), (torch.float32, 100, "tf32x3"),
    (torch.float32, 256, "tf32x3"), (torch.float32, 66, "tf32x3"),
    (torch.bfloat16, 72, "wgmma"), (torch.bfloat16, 8, "wgmma"),
    (torch.float16, 66, "wgmma"), (torch.bfloat16, 40, "wgmma"),
    (torch.float32, 1, "tf32x3"), (torch.float32, 6, "tf32x3"),
])
def test_flash_body_by_dtype_and_head_dim(dtype, Dh, body):
    """Every head dim from 1 to 256 runs on a tensor-core body: wgmma for
    the 16-bit types, tf32x3 for f32."""
    assert tflash.body_of(dtype, Dh) == body
    assert body in tflash.BODIES


def _rows_of(plan, B, Hq, Hkv, Sq):
    """Every (b, head, position) each block's 64 rows hold, as the kernel
    maps them (blockIdx.x = (b * Hkv + kv head) * tiles + tile in group;
    row r: head r // RQ of the tile's P, position q0 + r % RQ), keeping
    the rows it writes."""
    g = Hq // Hkv
    tpg = -(-g // plan.P)
    seen = []
    for bx in range(plan.grid[0]):
        tg, rest = bx % tpg, bx // tpg
        kvh, b = rest % Hkv, rest // Hkv
        h0 = kvh * g + tg * plan.P
        for by in range(plan.grid[1]):
            q0 = by * plan.RQ
            for r in range(min(plan.P * plan.RQ, 64)):
                hd, pos = r // plan.RQ, q0 + r % plan.RQ
                if pos < Sq and tg * plan.P + hd < g:
                    seen.append((b, h0 + hd, pos))
    return seen


@pytest.mark.parametrize("B,Hq,Hkv,Sq", [
    (256, 16, 8, 32), (1, 16, 8, 4096), (2, 48, 1, 1), (1, 48, 1, 31),
    (1, 8, 2, 33), (3, 4, 4, 100), (1, 6, 2, 20), (2, 8, 2, 64)])
def test_flash_plan_covers_every_row_once(B, Hq, Hkv, Sq):
    plan = tflash.plan_tc(B, Hq, Hkv, Sq, Sq, 128)
    seen = _rows_of(plan, B, Hq, Hkv, Sq)
    assert len(seen) == len(set(seen)) == B * Hq * Sq
    assert plan.P * plan.RQ <= 64
    # every head of a tile shares its kv head
    g = Hq // Hkv
    assert plan.P <= g


def test_flash_plan_packs_the_embed_path():
    """qwen3-0.6b's embed call: g = 2 heads of S = 32 fill one 64-row
    tile, so each kv head's K/V tile is read once: B * Hkv blocks."""
    plan = tflash.plan_tc(256, 16, 8, 32, 32, 128)
    assert (plan.P, plan.RQ, plan.DP, plan.BK) == (2, 32, 128, 32)
    assert plan.grid == (256 * 8, 1)
    long = tflash.plan_tc(1, 16, 8, 4096, 4096, 128)
    assert (long.P, long.RQ) == (1, 64)
    assert long.grid == (16, 64)
    granite = tflash.plan_tc(1, 48, 1, 1, 77, 128)
    assert (granite.P, granite.RQ, granite.grid) == (48, 1, (1, 1))


@pytest.mark.parametrize("Dh", [16, 48, 64, 96, 128, 192, 256])
def test_flash_plan_shared_memory(Dh):
    """Q's 64 rows and two stages of K and V, in 64-column chunks, plus
    1 KB of alignment and the barriers: at most 96 KB (Dh 256), and four
    blocks an SM up to Dh 128."""
    plan = tflash.plan_tc(1, 4, 2, 100, 100, Dh)
    assert plan.DP == -(-Dh // 64) * 64 and plan.DP >= Dh
    nc = plan.DP // 64
    assert plan.smem_bytes == 1024 + nc * (64 * 128 + 4 * plan.BK * 128) + 64
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    if plan.DP <= 128:
        assert 4 * (plan.smem_bytes + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("B,Hq,Hkv,Sq", [
    (256, 16, 8, 32), (4, 16, 8, 512), (2, 48, 1, 1), (1, 48, 1, 31),
    (1, 8, 2, 33), (4, 16, 16, 200), (1, 6, 2, 20), (4, 16, 8, 100)])
def test_flash_tf32x3_plan_covers_every_row_once(B, Hq, Hkv, Sq):
    """The 3xTF32 body takes the tensor-core body's tiling: every row
    once, GQA heads packed at Sq <= 32 (the embed path's two heads of 32
    fill a tile, B * Hkv blocks), 64 positions of one head beyond."""
    plan = tflash.plan_tc(B, Hq, Hkv, Sq, Sq, 100, torch.float32)
    seen = _rows_of(plan, B, Hq, Hkv, Sq)
    assert len(seen) == len(set(seen)) == B * Hq * Sq
    assert plan.P * plan.RQ <= 64 and plan.P <= Hq // Hkv
    assert (plan.DP, plan.BK) == (128, 32)
    bf16 = tflash.plan_tc(B, Hq, Hkv, Sq, Sq, 128)
    assert (plan.P, plan.RQ, plan.grid) == (bf16.P, bf16.RQ, bf16.grid)
    if (B, Hq, Hkv, Sq) == (256, 16, 8, 32):
        assert (plan.P, plan.RQ, plan.grid) == (2, 32, (256 * 8, 1))


@pytest.mark.parametrize("Dh", range(4, 257, 4))
def test_flash_tf32x3_shared_memory(Dh):
    """The mirror of ``x3::tf32x3_smem``: Q and its small half (64 rows),
    K, V and the scratch tile (32 keys) in f32 at DP = Dh rounded up to
    64, 64 bytes of barriers, 896 of alignment headroom; within a block's
    232,448 B at every head dim, two blocks an SM up to DP 128."""
    plan = tflash.plan_tc(256, 16, 8, 32, 32, Dh, torch.float32)
    assert plan.DP == -(-Dh // 64) * 64
    assert plan.smem_bytes == tflash.tf32x3_smem(plan.DP) \
        == (2 * 64 + 3 * 32) * plan.DP * 4 + 64 + 896
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    if plan.DP <= 128:
        assert 2 * (plan.smem_bytes + 1024) <= SMEM_PER_SM
    assert tflash.body_of(torch.float32, Dh) == "tf32x3"


@pytest.mark.parametrize("Dh", [0, 257, 260])
def test_flash_tf32x3_plan_rejects_other_head_dims(Dh):
    with pytest.raises(ValueError, match="outside"):
        tflash.plan_tc(1, 2, 1, 8, 8, Dh, torch.float32)


@pytest.mark.parametrize("Dh", [0, 257, 264])
def test_flash_plan_rejects_other_head_dims(Dh):
    with pytest.raises(ValueError, match="outside"):
        tflash.plan_tc(1, 2, 1, 8, 8, Dh)


@pytest.mark.parametrize("dtype,Dh", [
    (torch.bfloat16, 7), (torch.bfloat16, 8), (torch.float16, 40),
    (torch.bfloat16, 66), (torch.bfloat16, 72), (torch.float32, 1),
    (torch.float32, 6), (torch.float32, 66)])
def test_flash_plan_takes_every_head_dim(dtype, Dh):
    """A head dim no multiple of 16 (16-bit) or 4 (f32) is zero-filled to
    DP, Dh rounded up to 64, with DP's shared memory."""
    plan = tflash.plan_tc(1, 2, 1, 8, 8, Dh, dtype)
    assert plan.DP == -(-Dh // 64) * 64
    f32 = dtype == torch.float32
    assert plan.smem_bytes == (tflash.tf32x3_smem if f32
                               else tflash.tc_smem)(plan.DP)


def test_tma_strides():
    """The projections' views ([B, S, H, Dh] as [B, H, S, Dh]) go in as
    they are; a length-1 dim's stride never matters; a stride or pointer
    off 16 bytes does not go in."""
    q = torch.zeros((2, 5, 4, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert tflash.tma_strides(q) == (5 * 4 * 64, 64, 4 * 64)
    one = torch.zeros((1, 1, 3, 64), dtype=torch.bfloat16)
    assert tflash.tma_strides(one) == (8, 8, 64)
    odd = torch.zeros((1, 2, 8, 68), dtype=torch.bfloat16)[..., :64]
    assert tflash.tma_strides(odd) is None          # 136-byte rows
    base = torch.zeros((1, 2, 8, 72), dtype=torch.bfloat16)
    shifted = base[..., 1:65]
    if shifted.data_ptr() % 16:
        assert tflash.tma_strides(shifted) is None  # 2 bytes off
    assert tflash.tma_strides(base[..., 8:]) is not None


def _view(shape, dtype, cut=None, transpose=True):
    """A zero tensor of ``shape`` ([B, S, H, D]), its last dim cut to
    ``cut`` (a slice), viewed as [B, H, S, ...] like the projections'
    outputs when ``transpose``."""
    t = torch.zeros(shape, dtype=dtype)
    if cut is not None:
        t = t[..., cut]
    return t.transpose(1, 2) if transpose else t


@pytest.mark.parametrize("dtype,shape,cut,transpose,loader,width", [
    # test_tma_strides' layouts
    (torch.bfloat16, (2, 5, 4, 64), None, True, "tma", 16),
    (torch.bfloat16, (1, 3, 1, 64), None, True, "tma", 16),
    (torch.bfloat16, (1, 8, 2, 68), slice(0, 64), False, "cp.async", 8),
    (torch.bfloat16, (1, 8, 2, 72), slice(1, 65), False, "cp.async", 2),
    (torch.bfloat16, (1, 8, 2, 72), slice(8, None), False, "tma", 16),
    # head dims in the projections' layout: Dh 72 bf16 (144-byte rows)
    # and Dh 100 f32 by TMA; f32 Dh 66 (264-byte head stride), bf16 Dh 66
    # and 7, and a q view 2 bytes off its allocation by cp.async
    (torch.bfloat16, (2, 5, 16, 72), None, True, "tma", 16),
    (torch.float32, (2, 5, 16, 100), None, True, "tma", 16),
    (torch.float32, (2, 5, 16, 66), None, True, "cp.async", 8),
    (torch.bfloat16, (2, 5, 16, 66), None, True, "cp.async", 4),
    (torch.bfloat16, (2, 5, 16, 7), None, True, "cp.async", 2),
    (torch.bfloat16, (2, 5, 16, 136), slice(1, 129), True, "cp.async", 2),
    (torch.float32, (2, 5, 16, 68), slice(1, 67), True, "cp.async", 4),
])
def test_flash_loader_of(dtype, shape, cut, transpose, loader, width):
    """TMA where ``tma_strides`` takes q, k and v; cp.async otherwise, in
    the widest pieces the pointer and strides allow."""
    t = _view(shape, dtype, cut, transpose)
    aligned = torch.zeros((1, 2, 3, t.shape[-1]), dtype=dtype)
    assert tflash.loader_of(t, t, t) == loader
    # one tensor TMA cannot read sends all three to cp.async
    assert tflash.loader_of(aligned, aligned, t) == loader
    if loader == "cp.async":
        assert tflash.copy_bytes(t) == width
    assert (tflash.tma_strides(t) is not None) == (loader == "tma")


def test_pairwise_grid():
    """One block per 64 x 128 output tile (the C entry then runs as many
    as the card holds at once, each walking tiles by the grid's stride)."""
    assert tdist.TILE == (64, 128)
    assert tdist.grid_of(64, 100_000) == 782
    assert tdist.grid_of(1000, 1_000_000) == 16 * 7813
    assert tdist.grid_of(1, 1) == 1
    assert tdist.grid_of(65, 129) == 4


@pytest.mark.parametrize("dtype,D,offset,vec", [
    (torch.bfloat16, 128, 0, True), (torch.float16, 136, 0, True),
    (torch.bfloat16, 130, 0, False), (torch.float16, 131, 0, False),
    (torch.bfloat16, 132, 0, False), (torch.bfloat16, 128, 1, False),
    (torch.float32, 128, 0, True), (torch.float32, 132, 0, True),
    (torch.float32, 130, 0, False), (torch.float32, 128, 2, False),
])
def test_pairwise_plan(dtype, D, offset, vec):
    """16-byte copies where a 16-byte piece of every row is whole and
    aligned (D a multiple of 8 16-bit or 4 f32 values, both pointers on 16
    bytes), else element loads; the body by dtype; shared memory within a
    block's 232,448 bytes: the aligned ring of two stages (f32: three) and
    the norms."""
    q = _shifted(torch.zeros((70, D), dtype=dtype), offset)
    x = _shifted(torch.zeros((300, D), dtype=dtype), offset)
    p = tdist.plan(q, x)
    assert p.vec == vec
    assert p.tiles == tdist.grid_of(70, 300) == 6
    f32 = dtype == torch.float32
    assert p.body == ("tf32x3" if f32 else "wgmma")
    stage = (64 + 128) * 128
    assert p.smem == 1024 + (3 if f32 else 2) * stage + (64 + 128) * 4
    assert p.smem <= SMEM_PER_BLOCK
    # four 16-bit blocks or three f32 blocks fit one SM's shared memory
    assert (4 if not f32 else 3) * (p.smem + 1024) <= SMEM_PER_SM
