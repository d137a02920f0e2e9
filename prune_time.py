#!/usr/bin/env python3
"""Time the prune kernel of one source tree at the builds' shapes.

``python3 prune_time.py <src dir>`` imports
``repro_torch`` from ``<src dir>`` (a checkout's ``src``), builds its
kernels, and prunes seeded inputs on the card: n = 1,000,000 random f32
rows of d = 128, B = 16,384 nodes, C = 80 candidates drawn from a 4,096-row
segment (a search level) and C = 128 (a brute level's whole segment); and
n = 131,072 rows of d = 1,024 (qwen3-0.6b's width), B = 4,096 nodes, C =
144 candidates from a 4,096-row segment, where only some rows fit in
shared memory; m = 16. Prints one JSON line: ms per launch by CUDA events
over 20 launches after 3 warm-ups, and whether the kept ids equal the
plain version's. To compare two trees, run it once per tree in turns (a,
b, b, a) in one call on one card.
"""
import json
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.prune import prune_cuda  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("prune_time: needs a CUDA card")
    _build.build_all()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    m = 16
    out = {"src": sys.argv[1]}
    tables = {}
    for name, n, d, B, C in (("C80", 1_000_000, 128, 16384, 80),
                             ("C128", 1_000_000, 128, 16384, 128),
                             ("d1024_C144", 131072, 1024, 4096, 144)):
        if d not in tables:
            tables[d] = torch.randn((n, d), generator=g, device=dev)
        table = tables[d]
        node = (torch.rand((B,), generator=g, device=dev) * n).long()
        if C == 128:
            cand = ((node >> 7) << 7)[:, None] + torch.arange(
                128, device=dev)[None, :]
        else:
            cand = ((node >> 12) << 12)[:, None] + (torch.rand(
                (B, C), generator=g, device=dev) * 4096).long()
        cand = torch.where((cand < n) & (cand != node[:, None]), cand, -1)
        cand = cand.to(torch.int32).contiguous()
        cvec = table[cand.clamp_min(0).long()]
        du = torch.where(cand >= 0, ((cvec - table[node][:, None, :]) ** 2)
                         .sum(-1), torch.inf).contiguous()
        same = torch.equal(prune_cuda(cand, du, table, m=m),
                           ref.prune(cand, du, table, m=m))
        for _ in range(3):
            prune_cuda(cand, du, table, m=m)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            prune_cuda(cand, du, table, m=m)
        b.record()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = a.elapsed_time(b) / 20
        out[f"{name}_same_as_plain"] = bool(same)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
