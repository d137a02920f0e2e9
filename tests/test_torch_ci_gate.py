"""The port's benchmark gate (``src/repro_torch/bench/ci_gate.py``) held
against ``repro``'s (``benchmarks/ci_gate.py``, standard library only,
loaded by path), on synthetic records written to ``tmp_path``.

Each case writes one record set under both packages' names, runs both
gates' ``main`` on it (``repro``'s with its ``ARTIFACTS`` pointed at the
set and a copy of ``lint_baseline.json`` beside it; the port's with
``--artifacts`` / ``--smoke-dir``), with and without ``--strict``, and
requires the same exit code and the same counts of ``::error::`` and
``::warning::`` lines. Then what only the port's gate reads (picks as
lists, ``host.smoke``, the ``allow`` markers) and a CPU round trip of
``--smoke --update-smoke-ref`` through ``bench/buildpath.py`` and
``bench/serve_slo.py`` into a temporary artifacts directory.
"""
import copy
import importlib.util
import json
import math
import pathlib
import shutil

import pytest
import torch

from repro_torch.bench import buildpath, ci_gate, common, serve_slo

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("hop", "gather_dist", "gather_dist_codec", "edge_select", "prune")
NAMES = {  # record -> (repro's committed name, the port's)
    "hotpath": ("BENCH_hotpath", "BENCH_torch_hotpath"),
    "build": ("BENCH_build", "BENCH_torch_build"),
    "slo": ("BENCH_serve_slo", "BENCH_torch_serve_slo"),
}


@pytest.fixture
def one_torch_thread():
    """The smokes' tensors are tiny: more intra-op threads only take
    cores from the test files run beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_gate():
    spec = importlib.util.spec_from_file_location(
        "repro_ci_gate", ROOT / "benchmarks" / "ci_gate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leg(offered=40, shed_rate=0.0, p99=80.0):
    return {"offered": offered, "resolved": offered, "lost": 0,
            "ok": offered, "p99_ms": p99, "shed_rate": shed_rate}


def _records() -> dict:
    """A valid set: record -> (committed, smoke)."""
    storage = {
        "footprint_ratio": 0.503, "recall_delta": -0.006,
        "neighbor_codec_ids_identical": True,
        "neighbor_codec_ids_identical_split": True,
        "int8": {"footprint_ratio": 0.325, "nav_footprint_ratio": 0.325,
                 "recall_delta": -0.005},
        "pq": {"footprint_ratio": 0.359, "nav_footprint_ratio": 0.266,
               "recall_delta": -0.008}}
    hot = {
        "expansion_step": {"speedup": 0.63},
        "edge_select_step": {"speedup": 20.6},
        "hop_fused": {"speedup": 18.3},
        "serve_latency": {"small_batch_speedup": 0.65,
                          "post_warmup_compiles": 0, "compiles": 32,
                          "max_programs": 32},
        "autotune": {"picks": {k: {"warps": 4} for k in KINDS}},
        "storage_footprint": storage}
    build = {"parity": True, "prune_speedup_best": 15.0}
    slo = {"nominal": _leg(), "overload": _leg(300, 0.3),
           "chaos": _leg(300, 0.3), "serve": {"post_warmup_compiles": 0}}
    out = {}
    for name, doc, ref in (
            ("hotpath", hot, {"expansion_step.speedup": 0.63,
                              "edge_select_step.speedup": 20.6,
                              "hop_fused.speedup": 18.3,
                              "serve_latency.small_batch_speedup": 0.65}),
            ("build", build, {"prune_speedup_best": 15.0}),
            ("slo", slo, {"nominal.p99_ms": 80.0,
                          "overload.shed_rate": 0.3})):
        committed = {**copy.deepcopy(doc), "host": {"smoke": False},
                     "smoke_ref": ref}
        smoke = {**copy.deepcopy(doc), "host": {"smoke": True},
                 "smoke": True}
        out[name] = [committed, smoke]
    return out


def _set(path, *keys):
    """A mutation setting ``doc[k0][k1]...`` of the smoke (or, with
    ``committed`` first, of the committed) record to the last key."""
    *keys, value = keys

    def apply(recs):
        which = 0 if keys[0] == "committed" else 1
        node = recs[path][which]
        ks = keys[1:] if keys[0] == "committed" else keys
        for k in ks[:-1]:
            node = node[k]
        if value is _DELETE:
            del node[ks[-1]]
        else:
            node[ks[-1]] = value
    return apply


_DELETE = object()
# name -> (mutation or a file action, exit, exit under --strict)
CASES = {
    "valid": (None, 0, 0),
    "missing smoke record": (("rm", "hotpath", 1), 1, 1),
    "missing committed record": (("rm", "build", 0), 1, 1),
    "unreadable record": (("garble", "slo", 1), 1, 1),
    "missing section": (_set("hotpath", "hop_fused", _DELETE), 1, 1),
    "parity false": (_set("build", "parity", False), 1, 1),
    "footprint ratio": (_set("hotpath", "storage_footprint",
                             "footprint_ratio", 0.6), 1, 1),
    "compact recall delta": (_set("hotpath", "storage_footprint",
                                  "recall_delta", -0.02), 1, 1),
    "full record codec delta over 0.01": (
        _set("hotpath", "committed", "storage_footprint", "pq",
             "recall_delta", -0.015), 1, 1),
    "smoke codec delta within 0.05": (
        _set("hotpath", "storage_footprint", "int8", "recall_delta",
             -0.03), 0, 0),
    "smoke codec delta over 0.05": (
        _set("hotpath", "storage_footprint", "pq", "recall_delta",
             -0.06), 1, 1),
    "int8 ratio": (_set("hotpath", "storage_footprint", "int8",
                        "footprint_ratio", 0.4), 1, 1),
    "neighbour codec ids": (_set("hotpath", "storage_footprint",
                                 "neighbor_codec_ids_identical", False),
                            1, 1),
    "autotune kind missing": (_set("hotpath", "autotune", "picks", "prune",
                                   _DELETE), 1, 1),
    "cache entry after warmup": (_set("hotpath", "serve_latency",
                                      "post_warmup_compiles", 1), 1, 1),
    "cache over its grid": (_set("hotpath", "serve_latency", "compiles",
                                 33), 1, 1),
    "lost request": (_set("slo", "chaos", "lost", 1), 1, 1),
    "unresolved request": (_set("slo", "overload", "resolved", 299), 1, 1),
    "nominal served nothing": (_set("slo", "nominal", "ok", 0), 1, 1),
    "slo entry after warmup": (_set("slo", "serve", "post_warmup_compiles",
                                    2), 1, 1),
    "ratio not finite": (_set("build", "prune_speedup_best", math.inf),
                         1, 1),
    "ratio drift": (_set("hotpath", "hop_fused", "speedup", 9.0), 0, 1),
    "ratio drift within tolerance": (_set("hotpath", "hop_fused",
                                          "speedup", 14.0), 0, 0),
    "pick drift": (_set("hotpath", "autotune", "picks", "hop",
                        {"warps": 8}), 0, 1),
    "p99 drift": (_set("slo", "nominal", "p99_ms", 200.0), 0, 1),
    "shed drift": (_set("slo", "overload", "shed_rate", 0.8), 0, 1),
}


def _write(tmp_path, recs, case) -> pathlib.Path:
    art = tmp_path / "artifacts"
    art.mkdir(parents=True)
    shutil.copy(ROOT / "lint_baseline.json", tmp_path / "lint_baseline.json")
    action = CASES[case][0]
    if callable(action):
        action(recs)
    for name, (ref_name, port_name) in NAMES.items():
        for which, doc in enumerate(recs[name]):
            suffix = "_smoke" if which else ""
            for stem in (ref_name, port_name):
                p = art / f"{stem}{suffix}.json"
                if isinstance(action, tuple) and action[1:] == (name, which):
                    if action[0] == "garble":
                        p.write_text("{not json")
                    continue
                p.write_text(json.dumps(doc))
    return art


def _verdict(capsys, rc) -> tuple[int, int, int]:
    out = capsys.readouterr().out.splitlines()
    return (rc, sum(line.startswith("::error::") for line in out),
            sum(line.startswith("::warning::") for line in out))


@pytest.mark.parametrize("strict", [False, True], ids=["soft", "strict"])
@pytest.mark.parametrize("case", list(CASES))
def test_gate_matches_repro(case, strict, tmp_path, capsys, monkeypatch,
                            ref_gate):
    art = _write(tmp_path, _records(), case)
    flags = ["--strict"] if strict else []
    monkeypatch.setattr(ref_gate, "ARTIFACTS", str(art))
    want = _verdict(capsys, ref_gate.main(flags))
    got = _verdict(capsys, ci_gate.main(
        flags + ["--artifacts", str(art), "--smoke-dir", str(art)]))
    assert got == want, (case, got, want)
    assert got[0] == CASES[case][2 if strict else 1], (case, got)
    if case == "valid":
        assert got == (0, 0, 0)


def _port_verdict(tmp_path, capsys, recs, *flags):
    art = _write(tmp_path, recs, "valid")
    return _verdict(capsys, ci_gate.main(
        list(flags) + ["--artifacts", str(art), "--smoke-dir", str(art)]))


def test_port_records_shapes(tmp_path, capsys):
    """What the port's records look like and ``repro``'s gate does not
    read: picks as lists scoped to their probe shapes, and ``smoke``
    only under ``host``, where both packages' benchmarks write it."""
    recs = _records()
    for doc in recs["hotpath"]:
        doc["autotune"]["picks"] = {
            k: [{"warps": 4, "at": {"B": 1000}}] for k in KINDS}
    del recs["hotpath"][1]["smoke"]
    recs["hotpath"][1]["storage_footprint"]["pq"]["recall_delta"] = -0.03
    assert _port_verdict(tmp_path / "a", capsys, recs) == (0, 0, 0)
    # an empty list is a missing pick; the full record keeps the 0.01 cap
    recs["hotpath"][1]["autotune"]["picks"]["prune"] = []
    assert _port_verdict(tmp_path / "b", capsys, recs)[:2] == (1, 1)
    recs = _records()
    recs["hotpath"][0]["storage_footprint"]["int8"]["recall_delta"] = -0.03
    assert _port_verdict(tmp_path / "c", capsys, recs)[:2] == (1, 1)


@pytest.mark.parametrize("lines,errors", [
    (["x = 1  # allow[R5]: a reason"], 0),
    (["x = 1  # allow[R5]:", "y = 2  # allow[R3] no colon"], 2),
    (["a = 1  # allow[R1]: one", "b = 2  # allow[R2]: two",
      "c = 3  # allow[R4]: three", "d = 4  # allow[R6]: four"], 1),
])
def test_allow_markers(tmp_path, lines, errors, capsys):
    mod = tmp_path / "src" / "repro_torch" / "m.py"
    mod.parent.mkdir(parents=True)
    mod.write_text("\n".join(lines) + "\n")
    errs = []
    count = ci_gate._check_allow_markers(errs, root=tmp_path)
    assert count == len(lines) and len(errs) == errors, errs


def test_allow_markers_of_the_port_are_at_the_cap():
    """The constant moves with the markers: a marker taken out lowers
    it, one added raises it in review."""
    errs = []
    assert ci_gate._check_allow_markers(errs) == ci_gate.MAX_ALLOW_MARKERS
    assert not errs
    assert len(ci_gate.marker_files()) > 50
    assert {p.rsplit("/", 1)[1] for p in ci_gate.marker_files()} >= {
        "chip_smoke.py", "prune_time.py", "ci_gate.py", "search.py"}


def test_gate_keeps_repro_flags_and_defaults(ref_gate):
    """Every flag and default of ``repro``'s ``main``, and the two path
    flags besides."""
    import argparse

    def flags(mod):
        seen = {}
        real = argparse.ArgumentParser.parse_args

        def spy(self, argv=None, namespace=None):
            seen.update({a.dest: a.default for a in self._actions
                         if a.dest != "help"})
            raise SystemExit(0)
        argparse.ArgumentParser.parse_args = spy
        try:
            with pytest.raises(SystemExit):
                mod.main([])
        finally:
            argparse.ArgumentParser.parse_args = real
        return seen

    want, got = flags(ref_gate), flags(ci_gate)
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"artifacts", "smoke_dir"}
    assert [c.__name__ for c in (ci_gate._check_storage,
                                 ci_gate._check_codecs,
                                 ci_gate._check_autotune,
                                 ci_gate._check_serve, ci_gate._check_slo,
                                 ci_gate._load, ci_gate._ratio,
                                 ci_gate._baseline)] == [
        c.__name__ for c in (ref_gate._check_storage, ref_gate._check_codecs,
                             ref_gate._check_autotune, ref_gate._check_serve,
                             ref_gate._check_slo, ref_gate._load,
                             ref_gate._ratio, ref_gate._baseline)]
    assert [len(v) for v in ci_gate.GATES.values()] == \
        [len(v) for v in ref_gate.GATES.values()]


@pytest.mark.parametrize("bench,argv,committed,keys", [
    (buildpath, ["--smoke", "--device", "cpu"], "BENCH_torch_build.json",
     ("prune_speedup_best",)),
    (serve_slo, ["--smoke", "--device", "cpu", "--n", "512"],
     "BENCH_torch_serve_slo.json",
     ("nominal.p99_ms", "overload.shed_rate")),
], ids=["buildpath", "serve_slo"])
def test_smoke_ref_round_trip(bench, argv, committed, keys, tmp_path,
                              monkeypatch, one_torch_thread):
    """``--smoke --update-smoke-ref`` on the CPU into a temporary
    artifacts directory: the smoke record is written there and its
    numbers become the committed record's ``smoke_ref``, the rest of the
    committed record untouched."""
    monkeypatch.setattr(common, "artifacts_dir", lambda: str(tmp_path))
    path = tmp_path / committed
    path.write_text(json.dumps({"bench": "committed", "smoke_ref": {
        "stale": 1.0}}))
    assert bench.main(argv + ["--update-smoke-ref"]) == 0
    doc = json.loads(path.read_text())
    smoke = json.loads((tmp_path / committed.replace(
        ".json", "_smoke.json")).read_text())
    assert doc["bench"] == "committed" and set(doc["smoke_ref"]) <= set(
        keys) and "stale" not in doc["smoke_ref"]
    for key, v in doc["smoke_ref"].items():
        node = smoke
        for k in key.split("."):
            node = node[k]
        assert v == round(float(node), 4)
    assert smoke["host"]["smoke"] is True
    if bench is buildpath:
        assert set(doc["smoke_ref"]) == {"prune_speedup_best"}
        best = max(r["torch_speedup"] for r in smoke["prune_step"])
        assert smoke["prune_speedup_best"] == best
        e2e = smoke["build_levels"]
        assert smoke["build_speedup"] == pytest.approx(
            e2e["legacy"]["total_s"] / e2e["torch"]["total_s"])
        assert smoke["config"]["fused_impl"] == "torch"
    else:
        assert "overload.shed_rate" in doc["smoke_ref"]
