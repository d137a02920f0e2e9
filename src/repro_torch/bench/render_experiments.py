"""Render the dry-run's roofline table and summary into a markdown file
(port of ``benchmarks/render_experiments.py``).

Reads ``<art>/dryrun_torch_all.jsonl`` and ``<art>/dryrun_torch_paper.jsonl``
(``launch/dryrun.py --out``) and replaces the ``<!-- ROOFLINE_TABLE -->``
marker of ``--doc``, or the block a previous render left; idempotent. The
table is ``repro``'s, row for row; its times come from the hardware model
the records name (the H100's data sheet), which a line under the table
says.

    python -m repro_torch.bench.render_experiments --art artifacts \\
        --doc EXPERIMENTS_torch.md
"""
from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["load", "fmt_cell", "render", "write", "main"]

ALL, PAPER = "dryrun_torch_all.jsonl", "dryrun_torch_paper.jsonl"
MARKER, DONE = "<!-- ROOFLINE_TABLE -->", "<!-- ROOFLINE_DONE -->"


def load(art, name):
    p = os.path.join(art, name)
    if not os.path.exists(p):
        return []
    with open(p) as f:
        return [json.loads(line) for line in f if line.strip()]


def fmt_cell(r):
    if r.get("status") == "skipped":
        return (f"| {r['arch']} | {r['shape']} | — | — | — | — | skipped | "
                f"{r['reason'][:58]} |")
    if r.get("status") != "ok":
        return (f"| {r['arch']} | {r['shape']} | — | — | — | — | ERROR | "
                f"{r.get('error', '')[:58]} |")
    if "t_compute" not in r:
        return None
    uf = r.get("useful_flop_frac")
    mb = r.get("microbatches", "")
    note = f"mb={mb}" if mb and mb != 1 else ""
    bpd = r.get("bytes_per_device")
    bpd = f"{bpd / 1e9:.1f}" if bpd else "—"
    return (
        f"| {r['arch']} | {r['shape']} | {r['t_compute']:.2e} | "
        f"{r['t_memory']:.2e} | {r['t_collective']:.2e} | {bpd} | "
        f"{r['bottleneck']} ({(uf or 0):.2f}) | {note} |"
    )


def render(recs) -> tuple[str, int, int]:
    """(the table and summary, cells ok on 16x16, cells ok on 2x16x16)."""
    single = [r for r in recs if r.get("mesh") == "16x16"]
    multi = [r for r in recs if r.get("mesh") == "2x16x16"]
    lines = [
        "| arch | shape | t_compute (s) | t_memory (s) | t_collective (s) |"
        " GB/dev | bottleneck (useful-FLOP frac) | notes |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in single:
        row = fmt_cell(r)
        if row:
            lines.append(row)
    n_ok_s = sum(1 for r in single if r.get("status") == "ok")
    n_skip = sum(1 for r in single if r.get("status") == "skipped")
    n_err = sum(1 for r in single if r.get("status") == "error")
    n_ok_m = sum(1 for r in multi if r.get("status") == "ok")
    lines.append("")
    lines.append(
        f"Single-pod 16x16: **{n_ok_s} compiled**, {n_skip} skipped "
        f"(policy), {n_err} errors. Multi-pod 2x16x16: **{n_ok_m} "
        f"compiled** (same skip policy). Full records: "
        f"`artifacts/{ALL}`."
    )
    hw = next((r["hardware"] for r in recs if "hardware" in r), None)
    if hw:
        lines.append(f"Times from the {hw['card']}'s {hw['source']}.")
    return "\n".join(lines), n_ok_s, n_ok_m


def write(doc_path, table) -> None:
    """Put ``table`` in place of the marker (or of a previous render)."""
    doc = ""
    if os.path.exists(doc_path):
        with open(doc_path) as f:
            doc = f.read()
    if MARKER in doc:
        doc = doc.replace(MARKER, table + "\n" + DONE)
    elif DONE in doc:  # re-render: replace the previously generated block
        head = doc.index("| arch | shape |")
        end = doc.index(DONE) + len(DONE)
        doc = doc[:head] + table + "\n" + DONE + doc[end:]
    else:
        print("marker missing; appending", file=sys.stderr)
        doc += "\n" + table + "\n" + DONE
    with open(doc_path, "w") as f:
        f.write(doc)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default="artifacts")
    ap.add_argument("--doc", default="EXPERIMENTS_torch.md")
    args = ap.parse_args(argv)
    table, n_ok_s, n_ok_m = render(load(args.art, ALL)
                                   + load(args.art, PAPER))
    write(args.doc, table)
    print(f"rendered {n_ok_s}+{n_ok_m} cells into {args.doc}")


if __name__ == "__main__":
    main()
