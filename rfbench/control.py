"""The control and the planted faults of a cell, read on the card.

    python3 rfbench/control.py --workload <cell> --seeds 1,2,3

For each seed it makes the cell's data and pool as a run does, and puts
in the program's place, each judged as a run's answers are:

  * ``tf32``: the reference computed one precision step below the
    deployment's f32 (the control; ``reference.tf32_topk``);
  * ``unchanged``: a search whose beam never moves, answering with its
    entry points (the range's midpoint and quartiles);
  * ``half``: every second request answered with its neighbour's answer;
  * ``altered``: the first id of each answer moved to the next rank,
    its distance kept.

Each prints one JSON line of numbers. The benchmark's runs never call it;
the limits in ``rfbench/limits/<cell>.json`` were set from its readings
and from the program's.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def stand_ins(data, pool, exact, k):
    """(name, ids [P, k], dists [P, k]) of the control and each fault."""
    import torch

    from rfbench import reference

    ex_ids, ex_d, _ = exact
    n = data.vectors.shape[0]
    P = ex_ids.shape[0]
    tf_ids, tf_d = reference.tf32_topk(data, pool, k)
    out = [("tf32", tf_ids, tf_d)]
    # entry points: midpoint and quartiles of the request's rank range
    L, R = reference.value_ranks(data.sorted_attrs, pool.lo, pool.hi)
    fr = torch.tensor([0.5, 0.25, 0.75], device=L.device, dtype=torch.float64)
    ranks = (L[:, None] + torch.round((R - L)[:, None].double() * fr).long())
    ranks = ranks.clamp(0, n - 1)
    ent = data.order[ranks]
    d, _ = reference.true_dists(data.vectors, pool.q, ent)
    ids = torch.full((P, k), -1, dtype=torch.int64, device=L.device)
    dd = torch.full((P, k), torch.inf, dtype=torch.float64, device=L.device)
    ids[:, :3], dd[:, :3] = ent, d
    out.append(("unchanged", ids, dd))
    swap = torch.arange(P, device=L.device) ^ 1
    swap = torch.where(swap < P, swap, torch.arange(P, device=L.device))
    keep = (torch.arange(P, device=L.device) % 2 == 0)[:, None]
    out.append(("half", torch.where(keep, ex_ids, ex_ids[swap]),
                torch.where(keep, ex_d, ex_d[swap])))
    alt = ex_ids.clone()
    nxt = (data.rank_of[alt[:, 0].clamp_min(0)] + 1).clamp(max=n - 1)
    alt[:, 0] = torch.where(alt[:, 0] >= 0, data.order[nxt], -1)
    out.append(("altered", alt, ex_d))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from rfbench import gen, judge, reference, spec

    cell = spec.load_cell(ROOT, args.workload)
    k = int(cell.traffic["k"])
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        data, pool = gen.make(cell.deployment, cell.traffic, seed, device)
        exact = reference.exact_topk(data, pool, k)
        pidx = torch.arange(pool.q.shape[0])
        for name, ids, dists in stand_ins(data, pool, exact, k):
            nums = judge.judge_answers(data, pool, exact, pidx, ids.cpu(),
                                       dists.cpu(), k=k)
            ok, _ = judge.compare(
                {**nums, "unanswered": 0, "perm_mismatch": 0,
                 "bad_edges": 0}, cell.limits["checks"])
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "stand_in": name, "correct": ok, **nums}),
                  flush=True)
        del data, pool, exact
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
