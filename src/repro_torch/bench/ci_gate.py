"""Benchmark gate of the port: keep its committed records honest (the
port's copy of ``repro``'s ``benchmarks/ci_gate.py``, with its checks,
names, defaults, flags and exit codes; it imports nothing of ``repro``).

Compares the ``--smoke`` runs just made (``BENCH_torch_hotpath_smoke.json``
from ``bench/hotpath.py``, ``BENCH_torch_build_smoke.json`` from
``bench/buildpath.py``, ``BENCH_torch_serve_slo_smoke.json`` from
``bench/serve_slo.py``, all in ``--smoke-dir``) against the committed
full-shape records (``BENCH_torch_hotpath.json``, ``BENCH_torch_build.json``,
``BENCH_torch_serve_slo.json`` in ``--artifacts``) and gates on two kinds
of drift:

  * **shape / correctness: hard fail** (exit 1): a record is missing or
    unparseable (the benchmark crashed), it lost a required section, a
    speedup ratio is not a positive finite number, the hot-path record
    lost its ``autotune`` picks, the build benchmark's backend parity
    failed, the compact-storage leg regressed (footprint ratio above
    ``--max-footprint-ratio`` 0.55, |recall@10 delta| above
    ``--max-recall-delta`` 0.01, neighbour-codec ids not identical), a
    quantized codec regressed (``_check_codecs``: int8 total ratio above
    ``--max-int8-ratio`` 0.35, PQ navigation ratio above
    ``--max-pq-nav-ratio`` 0.30 or total above ``--max-pq-total-ratio``
    0.40, |rerank recall@10 delta| above ``--max-recall-delta``, checked
    on the committed full record and on the smoke run, the smoke against
    the looser ``--max-smoke-recall-delta`` 0.05), the executor's cache
    took an entry after warmup or holds more than its ``configs x
    batch_buckets x k_buckets`` grid (``repro`` counts compiles; the
    port's executor counts cache entries under the same keys), or the
    SLO record lost a request or took a cache entry after warmup
    (``_check_slo``); or the ``# allow[R<n>]: <reason>`` markers that
    exempt a line from the port's contract checks grew past
    :data:`MAX_ALLOW_MARKERS` or one lacks its reason
    (``_check_allow_markers``, the counterpart of ``repro``'s
    ``_check_lint_baseline``: the port keeps no findings baseline).
  * **timing: soft warn** (exit 0, a ``::warning::`` line): a smoke
    ratio fell more than ``--tolerance`` (25%) below the committed one,
    an autotune pick drifted from the committed record's, the nominal
    p99 rose more than ``--slo-p99-tolerance`` or the overload shed rate
    moved more than ``--slo-shed-tolerance``. Under ``--strict`` they
    fail.

Baselines come from the committed records' ``smoke_ref`` (the same-shape
ratios ``--smoke --update-smoke-ref`` wrote on the card; full runs carry
it forward), else from the full-shape ratio. A ratio is compared with a
ratio: the gate never asks one to be above 1 (at smoke shapes some are
below it on the card).

Two things differ from ``repro``'s gate, neither in what it checks: the
records' names and directories (``--artifacts DIR``, ``--smoke-dir DIR``,
both by default ``artifacts/``), and two reads of the port's record
shapes: a record is a smoke record when its top level or its ``host``
says ``"smoke": true`` (both packages' benchmarks write it under
``host``), and an autotune pick may be a dict or, as the port records
picks scoped to their probe shapes, a list of them.

Usage: ``python -m repro_torch.bench.ci_gate [--tolerance 0.25] [--strict]
[--artifacts DIR] [--smoke-dir DIR]`` after ``bench.hotpath --smoke``,
``bench.buildpath --smoke`` and ``bench.serve_slo --smoke``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys

from repro_torch.bench import common

# (committed file, smoke file) -> list of (section, ratio key) to compare.
# Each ratio is a fused-vs-baseline speedup, so the gate is unit-free.
GATES = {
    ("BENCH_torch_hotpath.json", "BENCH_torch_hotpath_smoke.json"): [
        ("expansion_step", "speedup"),
        ("edge_select_step", "speedup"),
        ("hop_fused", "speedup"),
        ("serve_latency", "small_batch_speedup"),
    ],
    ("BENCH_torch_build.json", "BENCH_torch_build_smoke.json"): [
        (None, "prune_speedup_best"),
    ],
    # serving SLO record: no speedup ratios; gated by _check_slo instead
    ("BENCH_torch_serve_slo.json", "BENCH_torch_serve_slo_smoke.json"): [],
}


def _load(path, errors):
    if not os.path.exists(path):
        errors.append(f"missing artifact {path}")
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        errors.append(f"unreadable artifact {path}: {e}")
        return None


def _ratio(doc, section, key, label, errors):
    node = doc if section is None else doc.get(section)
    if not isinstance(node, dict) or key not in node:
        errors.append(f"{label}: required key {section or ''}.{key} missing")
        return None
    v = node[key]
    if not isinstance(v, (int, float)) or not math.isfinite(v) or not v > 0:
        errors.append(f"{label}: {section or ''}.{key} = {v!r} not a "
                      "positive finite ratio")
        return None
    return float(v)


def _baseline(committed, section, key, label, errors):
    """Committed reference ratio for a smoke measurement: the record's
    ``smoke_ref`` (the smoke's own shapes, measured on the card when the
    record was committed), else the full-shape ratio."""
    ref = committed.get("smoke_ref")
    rkey = f"{section}.{key}" if section else key
    if isinstance(ref, dict) and isinstance(ref.get(rkey), (int, float)) \
            and math.isfinite(ref[rkey]) and ref[rkey] > 0:
        return float(ref[rkey])
    return _ratio(committed, section, key, label, errors)


def _is_smoke(doc) -> bool:
    host = doc.get("host")
    return bool(doc.get("smoke")
                or (isinstance(host, dict) and host.get("smoke")))


def _check_storage(smoke, name, args, errors):
    """Compact-storage gate: the footprint ratio is arithmetic over
    dtypes, the neighbour codecs' ids are integer-exact and the recall
    delta at the pinned smoke config is reproducible, so every violation
    is hard."""
    sf = smoke.get("storage_footprint")
    if not isinstance(sf, dict):
        errors.append(f"{name}: storage_footprint section missing")
        return
    ratio = sf.get("footprint_ratio")
    if not isinstance(ratio, (int, float)) or not math.isfinite(ratio):
        errors.append(f"{name}: storage_footprint.footprint_ratio "
                      f"= {ratio!r} not a finite ratio")
    elif ratio > args.max_footprint_ratio:
        errors.append(
            f"{name}: compact/f32 footprint ratio {ratio:.3f} exceeds "
            f"{args.max_footprint_ratio} (compact storage stopped paying "
            "for itself)")
    else:
        print(f"ok: {name} footprint ratio {ratio:.3f} "
              f"<= {args.max_footprint_ratio}")
    delta = sf.get("recall_delta")
    if not isinstance(delta, (int, float)) or not math.isfinite(delta):
        errors.append(f"{name}: storage_footprint.recall_delta "
                      f"= {delta!r} not finite")
    elif abs(delta) > args.max_recall_delta:
        errors.append(
            f"{name}: compact recall@10 delta {delta:+.4f} exceeds "
            f"±{args.max_recall_delta}")
    else:
        print(f"ok: {name} compact recall delta {delta:+.4f}")
    if sf.get("neighbor_codec_ids_identical") is not True:
        errors.append(
            f"{name}: int16/int32 neighbor codecs returned different ids")
    if "neighbor_codec_ids_identical_split" in sf \
            and sf.get("neighbor_codec_ids_identical_split") is not True:
        errors.append(
            f"{name}: split/int32 neighbor codecs returned different ids")


def _check_codecs(doc, name, args, errors):
    """Quantized-codec gate, hard: int8's total footprint ratio <=
    ``--max-int8-ratio``; PQ's navigation ratio (vectors, neighbours,
    attributes: what the hot path reads) <= ``--max-pq-nav-ratio`` and
    its total with the rerank sidecar <= ``--max-pq-total-ratio``; both
    with |recall@10 delta| (with rerank) <= ``--max-recall-delta``, or on
    a smoke record <= ``--max-smoke-recall-delta`` (16 queries: a recall
    quantum of 1/160, below the full cap; the loose cap still trips when
    the rerank wiring breaks)."""
    sf = doc.get("storage_footprint")
    if not isinstance(sf, dict):
        return  # section-missing already reported for the smoke artifact
    checks = [
        ("int8", "footprint_ratio", args.max_int8_ratio),
        ("pq", "nav_footprint_ratio", args.max_pq_nav_ratio),
        ("pq", "footprint_ratio", args.max_pq_total_ratio),
    ]
    for tag, key, cap in checks:
        leg = sf.get(tag)
        if not isinstance(leg, dict):
            errors.append(f"{name}: storage_footprint.{tag} leg missing")
            continue
        v = leg.get(key)
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            errors.append(f"{name}: {tag}.{key} = {v!r} not finite")
        elif v > cap:
            errors.append(
                f"{name}: {tag} {key} {v:.3f} exceeds {cap} (the codec "
                "stopped paying for itself)")
        else:
            print(f"ok: {name} {tag} {key} {v:.3f} <= {cap}")
    recall_cap = (args.max_smoke_recall_delta if _is_smoke(doc)
                  else args.max_recall_delta)
    for tag in ("int8", "pq"):
        leg = sf.get(tag)
        if not isinstance(leg, dict):
            continue
        delta = leg.get("recall_delta")
        if not isinstance(delta, (int, float)) or not math.isfinite(delta):
            errors.append(f"{name}: {tag}.recall_delta = {delta!r} "
                          "not finite")
        elif abs(delta) > recall_cap:
            errors.append(
                f"{name}: {tag} recall@10 delta {delta:+.4f} exceeds "
                f"±{recall_cap} (rerank stopped holding the "
                "recall floor)")
        else:
            print(f"ok: {name} {tag} recall delta {delta:+.4f} "
                  f"<= ±{recall_cap}")


_AUTOTUNE_KINDS = ("hop", "gather_dist", "gather_dist_codec",
                   "edge_select", "prune")


def _pick_ok(pick) -> bool:
    """A recorded pick: a non-empty dict, or a non-empty list of dicts
    (the port's picks, one per probe shape, each with its ``"at"``)."""
    if isinstance(pick, dict):
        return bool(pick)
    return isinstance(pick, list) and bool(pick) \
        and all(isinstance(p, dict) for p in pick)


def _check_autotune(smoke, committed, name, errors, warnings):
    """Autotune-record gate: a missing or malformed ``autotune`` section
    means the benchmark stopped measuring or recording the launch-plan
    picks (hard); a changed pick only warns (picks are timings on pinned
    probe shapes, so they may move between hosts and runs)."""
    at = smoke.get("autotune")
    picks = at.get("picks") if isinstance(at, dict) else None
    if not isinstance(picks, dict):
        errors.append(f"{name}: autotune section missing or malformed")
        return
    missing = [k for k in _AUTOTUNE_KINDS if not _pick_ok(picks.get(k))]
    if missing:
        errors.append(f"{name}: autotune picks missing for {missing}")
        return
    print(f"ok: {name} autotune picks recorded for "
          f"{len(_AUTOTUNE_KINDS)} kernels")
    ref = (committed.get("autotune") or {}).get("picks")
    if not isinstance(ref, dict):
        return  # committed record predates the autotuner
    for kind in _AUTOTUNE_KINDS:
        want, got = ref.get(kind), picks.get(kind)
        if want is not None and got != want:
            warnings.append(
                f"{name} autotune pick drift for {kind}: smoke {got} vs "
                f"committed {want}")


def _check_serve(smoke, name, errors):
    """Executor cache gate, hard: a warmed executor serves its mixed
    workload with no new cache entry, and never holds more than its
    declared ``len(configs) * len(batch_buckets) * len(k_buckets)``
    grid; a change there means the cache keys or the bucket arithmetic
    broke."""
    sl = smoke.get("serve_latency")
    if not isinstance(sl, dict):
        errors.append(f"{name}: serve_latency section missing")
        return
    pwc = sl.get("post_warmup_compiles")
    if not isinstance(pwc, int):
        errors.append(f"{name}: serve_latency.post_warmup_compiles "
                      f"= {pwc!r} not an int")
    elif pwc != 0:
        errors.append(
            f"{name}: {pwc} post-warmup compiles (a warmed executor must "
            "serve its declared grid from cache)")
    else:
        print(f"ok: {name} zero post-warmup compiles")
    compiles, max_programs = sl.get("compiles"), sl.get("max_programs")
    if not isinstance(compiles, int) or not isinstance(max_programs, int) \
            or max_programs < 1:
        errors.append(f"{name}: serve_latency compile accounting missing "
                      f"(compiles={compiles!r}, max_programs="
                      f"{max_programs!r})")
    elif compiles > max_programs:
        errors.append(
            f"{name}: {compiles} compiled programs exceed the "
            f"{max_programs}-program (configs x batch_buckets x k_buckets) "
            "grid")
    else:
        print(f"ok: {name} {compiles} programs <= grid {max_programs}")


def _check_slo(smoke, committed, name, args, errors, warnings):
    """Serving-loop SLO gate over ``serve_slo.py --smoke``'s record.

    Hard: every leg (nominal, overload, chaos) shows ``resolved ==
    offered`` and ``lost == 0`` (a request that never resolved is a stuck
    future in the loop), the executor took no cache entry after warmup,
    and the nominal leg served (ok > 0, a finite p99). Soft: the nominal
    p99 and the overload shed rate against the committed ``smoke_ref``."""
    legs = ("nominal", "overload", "chaos")
    for leg in legs:
        doc = smoke.get(leg)
        if not isinstance(doc, dict):
            errors.append(f"{name}: {leg} leg missing")
            continue
        offered, resolved = doc.get("offered"), doc.get("resolved")
        lost = doc.get("lost")
        if not isinstance(offered, int) or not isinstance(resolved, int) \
                or not isinstance(lost, int):
            errors.append(f"{name}: {leg} outcome accounting missing "
                          f"(offered={offered!r}, resolved={resolved!r}, "
                          f"lost={lost!r})")
        elif lost != 0 or resolved != offered:
            errors.append(
                f"{name}: {leg} leg lost requests ({offered} offered, "
                f"{resolved} resolved) — every submit() must settle with "
                "exactly one terminal outcome")
        else:
            print(f"ok: {name} {leg} resolved {resolved}/{offered}")
    serve = smoke.get("serve")
    pwc = serve.get("post_warmup_compiles") if isinstance(serve, dict) \
        else None
    if not isinstance(pwc, int):
        errors.append(f"{name}: serve.post_warmup_compiles = {pwc!r} "
                      "not an int")
    elif pwc != 0:
        errors.append(
            f"{name}: {pwc} post-warmup compiles (the async loop's batch "
            "formation left the warmed bucket grid)")
    else:
        print(f"ok: {name} zero post-warmup compiles")
    nominal = smoke.get("nominal")
    if isinstance(nominal, dict):
        ok, p99 = nominal.get("ok"), nominal.get("p99_ms")
        if not isinstance(ok, int) or ok <= 0:
            errors.append(f"{name}: nominal leg served nothing (ok={ok!r})")
        elif not isinstance(p99, (int, float)) or not math.isfinite(p99):
            errors.append(f"{name}: nominal p99_ms = {p99!r} not finite")
        else:
            ref = committed.get("smoke_ref") or {}
            want = ref.get("nominal.p99_ms")
            if isinstance(want, (int, float)) and math.isfinite(want) \
                    and want > 0:
                rel = p99 / want - 1.0
                line = (f"{name} nominal.p99_ms: smoke {p99:.1f}ms vs "
                        f"committed {want:.1f}ms ({rel:+.0%})")
                if rel > args.slo_p99_tolerance:
                    warnings.append(line)
                else:
                    print("ok:", line)
        shed_ref = (committed.get("smoke_ref") or {}).get(
            "overload.shed_rate")
        overload = smoke.get("overload")
        got_shed = overload.get("shed_rate") if isinstance(overload, dict) \
            else None
        if isinstance(shed_ref, (int, float)) \
                and isinstance(got_shed, (int, float)):
            delta = got_shed - shed_ref
            line = (f"{name} overload.shed_rate: smoke {got_shed:.2f} vs "
                    f"committed {shed_ref:.2f} ({delta:+.2f})")
            if abs(delta) > args.slo_shed_tolerance:
                warnings.append(line)
            else:
                print("ok:", line)


# The port's contract checks (tests/test_torch_contracts.py: R1-R6) exempt
# a line only by a marker on it, "# allow[R<n>]: <reason>", and keep no
# findings baseline. Their count may only SHRINK: a new marker is argued
# in review, and this constant moves in the same commit, so that growth is
# a reviewable act instead of an accretion.
MAX_ALLOW_MARKERS = 3
MARKER = re.compile(r"#\s*allow\[(R\d+)\](:?)(.*)")


def marker_files(root=common.ROOT) -> list:
    """The files the markers are counted in: every module of the port,
    ``chip_smoke.py`` and ``prune_time.py``."""
    root = os.fspath(root)
    out = []
    for base, _, names in os.walk(os.path.join(root, "src", "repro_torch")):
        out += [os.path.join(base, n) for n in names if n.endswith(".py")]
    out += [os.path.join(root, n) for n in ("chip_smoke.py", "prune_time.py")]
    return sorted(p for p in out if os.path.exists(p))


def _check_allow_markers(errors, root=common.ROOT):
    count = 0
    for path in marker_files(root):
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                for m in MARKER.finditer(line):
                    count += 1
                    if not m.group(2) or not m.group(3).strip():
                        errors.append(
                            f"{os.path.relpath(path, root)}:{lineno}: "
                            f"allow[{m.group(1)}] marker has no reason — "
                            "every exempted line carries a one-line "
                            "justification after the colon")
    if count > MAX_ALLOW_MARKERS:
        errors.append(
            f"allow markers grew to {count} (max {MAX_ALLOW_MARKERS}): "
            "fix the new findings instead of exempting them, or justify "
            "the growth by raising MAX_ALLOW_MARKERS in this file in the "
            "same commit")
    else:
        print(f"ok: {count} allow markers <= {MAX_ALLOW_MARKERS}")
    return count


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tolerance", type=float, default=0.25,
                    help="max relative speedup regression before warning")
    ap.add_argument("--strict", action="store_true",
                    help="timing regressions fail instead of warning "
                         "(dedicated hardware only)")
    ap.add_argument("--max-footprint-ratio", type=float, default=0.55,
                    help="max compact/f32 nbytes ratio (hard fail)")
    ap.add_argument("--max-recall-delta", type=float, default=0.01,
                    help="max |recall@10 drift| under compact storage "
                         "(hard fail)")
    ap.add_argument("--max-int8-ratio", type=float, default=0.35,
                    help="max int8/f32 total footprint ratio (hard fail)")
    ap.add_argument("--max-pq-nav-ratio", type=float, default=0.30,
                    help="max PQ/f32 navigation footprint ratio: vectors "
                         "+ neighbors + attrs, no rerank sidecar "
                         "(hard fail)")
    ap.add_argument("--max-pq-total-ratio", type=float, default=0.40,
                    help="max PQ/f32 total footprint ratio incl. the "
                         "rerank sidecar (hard fail)")
    ap.add_argument("--max-smoke-recall-delta", type=float, default=0.05,
                    help="codec recall-delta cap applied to smoke records "
                         "(16-query workload: the full-bench 0.01 is below "
                         "the smoke recall quantum; this still trips when "
                         "the rerank wiring breaks)")
    ap.add_argument("--slo-p99-tolerance", type=float, default=1.0,
                    help="max relative nominal-p99 regression vs smoke_ref "
                         "before warning (latency on shared hosts is very "
                         "noisy, so the default is loose)")
    ap.add_argument("--slo-shed-tolerance", type=float, default=0.35,
                    help="max |overload shed-rate drift| vs smoke_ref "
                         "before warning")
    ap.add_argument("--artifacts", default=None,
                    help="directory of the committed records (default: "
                         "artifacts/)")
    ap.add_argument("--smoke-dir", default=None,
                    help="directory of the smoke records (default: "
                         "artifacts/)")
    args = ap.parse_args(argv)
    artifacts = args.artifacts or common.artifacts_dir()
    smoke_dir = args.smoke_dir or common.artifacts_dir()

    errors: list[str] = []
    warnings: list[str] = []

    _check_allow_markers(errors)

    for (committed_name, smoke_name), keys in GATES.items():
        committed = _load(os.path.join(artifacts, committed_name), errors)
        smoke = _load(os.path.join(smoke_dir, smoke_name), errors)
        if committed is None or smoke is None:
            continue
        # correctness flags are hard: a parity divergence is a real bug
        if smoke.get("parity") is False or committed.get("parity") is False:
            errors.append(f"{smoke_name}: backend parity check failed")
        if smoke_name == "BENCH_torch_hotpath_smoke.json":
            _check_storage(smoke, smoke_name, args, errors)
            _check_codecs(smoke, smoke_name, args, errors)
            _check_codecs(committed, committed_name, args, errors)
            _check_serve(smoke, smoke_name, errors)
            _check_autotune(smoke, committed, smoke_name, errors, warnings)
        if smoke_name == "BENCH_torch_serve_slo_smoke.json":
            _check_slo(smoke, committed, smoke_name, args, errors, warnings)
        for section, key in keys:
            want = _baseline(committed, section, key, committed_name, errors)
            got = _ratio(smoke, section, key, smoke_name, errors)
            if want is None or got is None:
                continue
            rel = got / want - 1.0
            line = (f"{smoke_name} {section or 'root'}.{key}: smoke "
                    f"{got:.2f}x vs committed {want:.2f}x ({rel:+.0%})")
            if rel < -args.tolerance:
                warnings.append(line)
            else:
                print("ok:", line)

    for w in warnings:
        print(f"::warning::bench-gate timing regression: {w}")
    for e in errors:
        print(f"::error::bench-gate: {e}")
    if errors:
        print(f"bench-gate: FAIL ({len(errors)} shape/correctness errors)")
        return 1
    if warnings and args.strict:
        print(f"bench-gate: FAIL ({len(warnings)} timing regressions, "
              "--strict)")
        return 1
    print(f"bench-gate: ok ({len(warnings)} timing warnings)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
