"""The paper's figure and table scripts in one process (``repro``'s
``benchmarks/run.py``; the roofline, a kernel benchmark, runs on its own:
``bench/roofline.py``).

``python -m repro_torch.bench.run [--quick] [--only fig2,fig4] [--n N]
[--device cpu] [--out-dir DIR]`` prints the rows as CSV and writes one
``BENCH_torch_<name>.json`` per script (rows, columns, ``n``, seconds,
``device_info``, the ``nvidia-smi`` card line and the script's notes) to
``artifacts/`` or ``--out-dir``. ``--n`` scales every dataset (``bench/
common.py``): ``--n 1000000`` runs the largest at n = 1M on the card.
Indexes are cached across the scripts of one process. Exits 1 if a
script failed; the others still run.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from repro_torch.bench import (common, fig2_qps_recall, fig3_ablation,
                               fig4_oracle, fig5_multiattr, scalability,
                               table2_memory, table3_indexing)
from repro_torch.device import resolve_device

MODULES = {
    "fig2": "fig2_qps_recall",
    "table2": "table2_memory",
    "table3": "table3_indexing",
    "fig3": "fig3_ablation",
    "fig4": "fig4_oracle",
    "fig5": "fig5_multiattr",
    "scalability": "scalability",
}
_LOADED = {m.__name__.rsplit(".", 1)[1]: m for m in (
    fig2_qps_recall, fig3_ablation, fig4_oracle, fig5_multiattr,
    scalability, table2_memory, table3_indexing)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small sweeps (CI-sized)")
    ap.add_argument("--only", default=None,
                    help="comma-separated script names: " + ",".join(MODULES))
    ap.add_argument("--n", type=int, default=None,
                    help="scale every dataset's n so the largest is N")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    ap.add_argument("--out-dir", default=None,
                    help="where the JSON records go (default: artifacts/)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    names = list(MODULES)
    if args.only:
        keep = args.only.split(",")
        unknown = sorted(set(keep) - set(MODULES))
        if unknown:
            ap.error(f"unknown scripts {unknown}")
        names = [k for k in names if k in keep]

    failed = []
    print("table,col1,col2,col3,col4,col5,col6,col7,col8", flush=True)
    for name in names:
        mod = _LOADED[MODULES[name]]
        notes: dict = {}
        t0 = time.perf_counter()
        try:
            rows = mod.run(quick=args.quick, n=args.n, device=dev,
                           notes=notes)
        except Exception as e:  # noqa: BLE001 — keep the suite going
            traceback.print_exc()
            print(f"{name},ERROR,{type(e).__name__}: {e}", flush=True)
            failed.append(name)
            continue
        secs = time.perf_counter() - t0
        common.emit(rows)
        path = common.write_record(name, rows, mod.COLUMNS, dev, n=args.n,
                                   quick=args.quick, seconds=secs,
                                   notes=notes, out_dir=args.out_dir)
        print(f"# {name} done in {secs:.1f}s -> {path}", file=sys.stderr,
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
