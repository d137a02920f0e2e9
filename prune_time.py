#!/usr/bin/env python3
"""Time the prune, flash-attention and pairwise-distance kernels of one
source tree at the paths' shapes.

``python3 prune_time.py <src dir> [parts]`` imports ``repro_torch`` from
``<src dir>`` (a checkout's ``src``), builds its kernels, and times them
on the card; ``parts`` is a comma-separated subset of ``prune,
prune_designs,flash,pairwise,pairwise_exact`` (default: all but
prune_designs).

  * prune: n = 1,000,000 random f32 rows of d = 128, B = 16,384 nodes, C =
    80 candidates drawn from a 4,096-row segment (a search level) and C =
    128 (a brute level's whole segment); and n = 131,072 rows of d = 1,024
    (qwen3-0.6b's width), B = 4,096 nodes: C = 144 candidates from a
    4,096-row segment (a search level's chunk) on the f32 table and on
    its int8 encoding, C = 128 (a brute level) and C = 48 (the reverse
    pass's width); m = 16. Reports whether the kept ids equal the plain
    version's, and the tree's plan for the shape (``smem_plan``).
  * prune_designs (this tree's prune only): the prune's regimes against
    each other on the same inputs, each plan forced in place of
    ``smem_plan``'s: C = 80 at d = 128 (block, table); C = 144 at d =
    1,024 with random rows (table, partial: one CTA staging the rows that
    fit) and with du scaled by 0.93, so that more rows stay live a sweep,
    as in the lm build's chunk; and the partial regime where it is the
    plan, B = 1,024 nodes at C = 48, d = 4,096 and C = 144, d = 8,192,
    with the plain version's time; each also at 4 and 8 warps a CTA.
    Reports ms and whether the kept ids equal the plain version's.
  * flash: bf16, causal, Hq 16, Hkv 8, Dh 128, in the projections' layout
    ([B, S, H, Dh] viewed as [B, H, S, Dh]): the embed path's B = 256, S =
    32, and B = 1, S = 4,096. Reports the largest |difference| from the
    plain version.
  * pairwise: l2 at the roofline's shape (Bq = 64, N = 100,000, d = 128,
    f32) and at 1,000 x 1,000,000 (d = 128) in f32 and bf16. Reports the
    largest |difference| from the plain version over ‖q‖² + ‖x‖².
  * pairwise_exact (not timed): ip of the 1,000 queries against the
    131,072 rows of ``vector_dataset`` (64 clusters, d = 128, seed 0) in
    f32, bf16 and f16; the kernel and the plain version each against the
    exact dot (f64), and how many outputs of each fall outside the card
    gate's half-type tolerance (one bf16 ulp plus 1e-5) of the exact
    dot, and of each other.

Prints one JSON line: ms per launch by CUDA events over 20 launches (5 at
the long shapes) after 3 warm-ups, and the checks above. To compare two
trees, run it once per tree in turns (a, b, b, a) in one call on one card.
"""
import json
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402

PARTS = ("prune", "prune_designs", "flash", "pairwise", "pairwise_exact")
DEFAULT_PARTS = ("prune", "flash", "pairwise", "pairwise_exact")


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# name, n, d, B, C, candidates ("search": drawn from the node's 4,096-row
# segment; "brute": its whole 128-row segment), stored layout
PRUNE_SHAPES = (
    ("C80", 1_000_000, 128, 16384, 80, "search", "f32"),
    ("C128", 1_000_000, 128, 16384, 128, "brute", "f32"),
    ("d1024_C144", 131072, 1024, 4096, 144, "search", "f32"),
    ("d1024_C144_int8", 131072, 1024, 4096, 144, "search", "int8"),
    ("d1024_C128", 131072, 1024, 4096, 128, "brute", "f32"),
    ("d1024_C48", 131072, 1024, 4096, 48, "search", "f32"),
)


def prune_part(out, dev, g):
    from repro_torch.core import storage
    from repro_torch.kernels import prune

    m = 16
    tables = {}
    for name, n, d, B, C, kind, layout in PRUNE_SHAPES:
        if d not in tables:
            tables[d] = torch.randn((n, d), generator=g, device=dev)
        x = tables[d]
        table = x if layout == "f32" else storage.encode_vectors(
            x, storage.StorageConfig.int8())
        node = (torch.rand((B,), generator=g, device=dev) * n).long()
        if kind == "brute":
            cand = ((node >> 7) << 7)[:, None] + torch.arange(
                C, device=dev)[None, :]
        else:
            cand = ((node >> 12) << 12)[:, None] + (torch.rand(
                (B, C), generator=g, device=dev) * 4096).long()
        cand = torch.where((cand < n) & (cand != node[:, None]), cand, -1)
        cand = cand.to(torch.int32).contiguous()
        cvec = x[cand.clamp_min(0).long()]
        du = torch.where(cand >= 0, ((cvec - x[node][:, None, :]) ** 2)
                         .sum(-1), torch.inf).contiguous()
        del cvec
        same = torch.equal(prune.prune_cuda(cand, du, table, m=m),
                           ref.prune(cand, du, table, m=m))
        out[f"{name}_ms"] = time_ms(
            lambda: prune.prune_cuda(cand, du, table, m=m))
        out[f"{name}_same_as_plain"] = bool(same)
        out[f"{name}_plan"] = list(prune.smem_plan(C, d))


def prune_designs_part(out, dev, g):
    from repro_torch.kernels import prune

    def forced(C, d, regime):
        if regime == "block":
            return prune.Plan(C, prune.smem_bytes(C, d, C), regime)
        if regime == "table":
            return prune.Plan(min(C, prune.TABLE_K),
                              prune.table_bytes(C, d), regime)
        base = prune.smem_bytes(C, d, 0)
        staged = (prune.SMEM_LIMIT - base) // ((d + 3) // 4 * 16)
        return prune.Plan(staged, prune.smem_bytes(C, d, staged), regime)

    plan_of, warps_of = prune.smem_plan, prune.warps_of
    for name, n, d, B, C, scale, designs in (
            ("C80", 1_000_000, 128, 16384, 80, 1.0, ("block", "table")),
            ("d1024_C144", 131072, 1024, 4096, 144, 1.0,
             ("table", "partial")),
            ("d1024_C144_du093", 131072, 1024, 4096, 144, 0.93,
             ("table", "partial")),
            ("d4096_C48", 131072, 4096, 1024, 48, 1.0, ("partial",)),
            ("d8192_C144", 65536, 8192, 1024, 144, 1.0, ("partial",))):
        x = torch.randn((n, d), generator=g, device=dev)
        node = (torch.rand((B,), generator=g, device=dev) * n).long()
        cand = ((node >> 12) << 12)[:, None] + (torch.rand(
            (B, C), generator=g, device=dev) * 4096).long()
        cand = torch.where((cand < n) & (cand != node[:, None]), cand, -1)
        cand = cand.to(torch.int32).contiguous()
        cvec = x[cand.clamp_min(0).long()]
        du = (torch.where(cand >= 0, ((cvec - x[node][:, None, :]) ** 2)
                          .sum(-1), torch.inf) * scale).contiguous()
        del cvec
        want = ref.prune(cand, du, x, m=16)
        if d >= 4096:
            out[f"{name}_plain_ms"] = time_ms(
                lambda: ref.prune(cand, du, x, m=16), iters=3)
        for regime in designs:
            plan = forced(C, d, regime)
            prune.smem_plan = lambda C_, d_, plan=plan: plan
            for warps in (None, 4, 8):
                prune.warps_of = warps_of if warps is None else (
                    lambda p, w=warps: w)
                tag = f"{name}_{regime}" + (f"_w{warps}" if warps else "")
                got = prune.prune_cuda(cand, du, x, m=16)
                out[f"{tag}_same_as_plain"] = bool(torch.equal(got, want))
                out[f"{tag}_ms"] = time_ms(
                    lambda: prune.prune_cuda(cand, du, x, m=16))
                out[f"{tag}_plan"] = list(plan) + [prune.warps_of(plan)]
        prune.smem_plan, prune.warps_of = plan_of, warps_of
        del x, cand, du, want
        torch.cuda.empty_cache()


def flash_part(out, dev, g):
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    for name, B, S in (("flash_path", 256, 32), ("flash_S4096", 1, 4096)):
        q, k, v = (torch.randn((B, S, h, 128), generator=g, device=dev,
                               dtype=torch.bfloat16).transpose(1, 2)
                   for h in (16, 8, 8))
        err = (flash_attention_cuda(q, k, v).float()
               - ref.attention(q, k, v).float()).abs().max()
        out[f"{name}_ms"] = time_ms(lambda: flash_attention_cuda(q, k, v),
                                    iters=5 if S >= 4096 else 20)
        out[f"{name}_max_abs_err"] = float(err)
        del q, k, v


def pairwise_part(out, dev, g):
    from repro_torch.kernels.distance import pairwise_dist_cuda

    for name, Bq, N, dt in (("dist_roofline_f32", 64, 100_000, "float32"),
                            ("dist_1M_f32", 1000, 1_000_000, "float32"),
                            ("dist_1M_bf16", 1000, 1_000_000, "bfloat16")):
        dtype = getattr(torch, dt)
        q = torch.randn((Bq, 128), generator=g, device=dev).to(dtype)
        x = torch.randn((N, 128), generator=g, device=dev).to(dtype)
        got = pairwise_dist_cuda(q, x)
        want = ref.pairwise_dist(q, x)
        qf, xf = q.float(), x.float()
        terms = (qf * qf).sum(1, keepdim=True) + (xf * xf).sum(1)[None]
        out[f"{name}_max_rel_err"] = float(((got - want).abs()
                                            / terms).max())
        del got, want, terms, qf, xf
        out[f"{name}_ms"] = time_ms(lambda: pairwise_dist_cuda(q, x),
                                    iters=5 if N >= 1_000_000 else 20)
        del q, x
        torch.cuda.empty_cache()


def bf16_tol(got, want):
    """chip_smoke.py's half-type gate: one bf16 ulp at the larger
    magnitude, plus 1e-5."""
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8) \
        + 1e-5


def pairwise_exact_part(out, dev, g):
    from repro_torch.data import vector_dataset
    from repro_torch.kernels.distance import pairwise_dist_cuda

    x, _, q, _ = vector_dataset(131072, 128, seed=0, n_clusters=64,
                                attr_kind="uniform", queries=1000,
                                labels=True)
    x0 = torch.as_tensor(x, device=dev)
    q0 = torch.as_tensor(q, device=dev)
    for dt in ("float32", "bfloat16", "float16"):
        qd, xd = q0.to(getattr(torch, dt)), x0.to(getattr(torch, dt))
        exact = qd.double() @ xd.double().T
        ex = exact.float()
        kern = -pairwise_dist_cuda(qd, xd, metric="ip")
        plain = -ref.pairwise_dist(qd, xd, metric="ip")
        tag = f"exact_ip_{dt}"
        out[f"{tag}_kernel_max_err"] = float((kern.double() - exact)
                                             .abs().max())
        out[f"{tag}_plain_max_err"] = float((plain.double() - exact)
                                            .abs().max())
        for name, got in (("kernel", kern), ("plain", plain)):
            out[f"{tag}_{name}_over_gate"] = int(
                ((got - ex).abs() > bf16_tol(got, ex)).sum())
        out[f"{tag}_kernel_vs_plain_over_gate"] = int(
            ((kern - plain).abs() > bf16_tol(kern, plain)).sum())
        del exact, ex, kern, plain
    out["exact_ip_max_abs_dot"] = float((q0.double() @ x0.double().T)
                                        .abs().max())


def main():
    if not torch.cuda.is_available():
        sys.exit("prune_time: needs a CUDA card")
    parts = sys.argv[2].split(",") if len(sys.argv) > 2 else DEFAULT_PARTS
    if set(parts) - set(PARTS):
        sys.exit(f"prune_time: parts are a subset of {','.join(PARTS)}")
    _build.build_all()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    out = {"src": sys.argv[1]}
    for part in parts:
        globals()[f"{part}_part"](out, dev, g)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
