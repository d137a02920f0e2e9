"""The port's hot-path benchmark (``bench/hotpath.py``) and launch-plan
autotuner (``kernels/autotune.py``) on the CPU.

  * ``python -m repro_torch.bench.hotpath --smoke --device cpu`` runs in
    process (its datasets cut to n = 512 here) and writes a record whose
    sections carry every key of ``repro``'s committed
    ``artifacts/BENCH_hotpath.json``; composed and fused hops were
    asserted identical; no pick outlives the run.
  * ``autotune`` on a fake ``run``: the default plan first, a candidate
    whose outputs differ refused, the fastest picked, ``repro``'s record
    keys.
  * A pick reaches ``gather_distance.plan`` and ``prune.smem_plan`` at the
    shape it was measured at and nowhere else, under an explicit override;
    ``clear_picks()`` restores today's plans; an override that does not
    fit raises instead of falling back.
"""
import json
import pathlib
import time

import pytest
import torch

from repro_torch.bench import common
from repro_torch.bench import hotpath
from repro_torch.kernels import autotune
from repro_torch.kernels import gather_distance as gd
from repro_torch.kernels import prune

ROOT = pathlib.Path(__file__).resolve().parents[1]
SECTIONS = ("expansion_step", "edge_select_step", "hop_fused",
            "storage_footprint", "serve_latency", "host", "config")


@pytest.fixture(autouse=True)
def _no_picks():
    autotune.clear_picks()
    yield
    autotune.clear_picks()


def _keys_cover(got: dict, want: dict, where: str):
    missing = set(want) - set(got)
    assert not missing, f"{where}: {sorted(missing)}"
    for k, v in want.items():
        if isinstance(v, dict) and k != "picks" and isinstance(got[k], dict):
            _keys_cover(got[k], v, f"{where}.{k}")


def test_hotpath_smoke_on_cpu_has_repro_schema(tmp_path, monkeypatch):
    monkeypatch.setitem(common.BENCH_DATASETS, "ytaudio-like",
                        (512, 64, "uniform"))
    out = tmp_path / "hp.json"
    payload = hotpath.main(["--smoke", "--device", "cpu", "--out",
                            str(out)])
    doc = json.loads(out.read_text())
    want = json.loads((ROOT / "artifacts" / "BENCH_hotpath.json")
                      .read_text())
    assert set(want) - {"smoke_ref"} <= set(doc)
    for sec in SECTIONS:
        _keys_cover(doc[sec], want[sec], sec)
    assert set(want["serve_latency"]["rows"][0]) <= \
        set(doc["serve_latency"]["rows"][0])
    assert set(want["search_sweep"][0]) <= set(doc["search_sweep"][0])
    assert {r["edge_impl"] for r in doc["search_sweep"]} == {"torch",
                                                             "argsort"}
    at = doc["autotune"]
    assert set(want["autotune"]) <= set(at) and at["timed"] is False
    rec_keys = set(want["autotune"]["records"]["hop"])
    for kind, recs in at["records"].items():
        assert [r["probe"] for r in recs] == [
            p["name"] for p in autotune.PROBES[kind]]
        for r in recs:
            assert rec_keys <= set(r) and r["best_ms"] is None
            assert r["candidates"][0]["params"] == r["default"]
    assert doc["hop_fused"]["outputs_identical"] is True
    assert doc["host"]["device"] == "cpu" and doc["card_line"] is None
    # the bucketed executor served inside its declared grid
    sl = doc["serve_latency"]
    assert sl["post_warmup_compiles"] == 0
    assert sl["compiles"] <= sl["max_programs"]
    assert payload["edge_select_step"]["edge_impl"] == "torch"
    assert autotune.all_picks() == {}


def test_autotune_api_on_a_fake_run():
    calls = []

    def run(split):
        calls.append(split)
        time.sleep(0.002 * split)
        out = torch.arange(4)
        return (out + 1, out) if split == 3 else (out, out)

    rec = autotune.autotune("gather_dist", run, iters=2, candidates=[
        {"split": 2}, {"split": 1}, {"split": 3}], device=torch.device(
            "cpu"))
    assert set(rec) >= {"kind", "best", "best_ms", "candidates"}
    assert rec["kind"] == "gather_dist" and rec["best"] == {"split": 1}
    assert rec["default"] == {"split": 2}
    assert [c["params"] for c in rec["candidates"]] == [{"split": 2},
                                                        {"split": 1}]
    assert rec["refused"] == [{"params": {"split": 3},
                               "why": "outputs differ from the default "
                                      "plan's"}]
    assert rec["default_ms"] == rec["candidates"][0]["ms"] > rec["best_ms"]
    assert calls.count(3) == 1                  # refused: never timed
    json.dumps(rec)
    with pytest.raises(ValueError, match="unknown kernel kind"):
        autotune.autotune("flash", run)
    # default candidates at the kind's first probe, the default plan first
    p = autotune.PROBES["hop"][0]
    cands = autotune.CANDIDATES["hop"](p)
    assert cands[0] == {"warps": gd.plan(
        p["B"], p["W"] * p["m_out"], "f32", p["d"], True,
        hop=(p["W"], p["K"])).warps}
    assert autotune.CANDIDATES["edge_select"](
        autotune.PROBES["edge_select"][0]) == [{}]


def test_time_calls_keeps_reset_outside():
    seen = []
    secs = common.time_calls(lambda i: seen.append(("call", i)),
                             torch.device("cpu"), iters=3, warmup=1,
                             reset=lambda i: (seen.append(("reset", i)),
                                              time.sleep(0.05)))
    assert secs < 0.05
    assert seen == [("reset", 0), ("call", 0), ("reset", 1), ("call", 1),
                    ("reset", 2), ("call", 2), ("reset", 3), ("call", 3)]


def test_pick_reaches_the_plans_at_its_shape_only():
    frontier = dict(B=1000, M=64, d=128)
    default = gd.plan(1000, 64, "f32", 128, True)
    assert autotune.merged("gather_dist", {}, **frontier) is None
    autotune.set_pick("gather_dist", {"split": 16, "at": frontier})
    o = autotune.merged("gather_dist", {}, **frontier)
    assert o == {"split": 16}
    assert gd.plan(1000, 64, "f32", 128, True, override=o).split == 16
    assert autotune.merged("gather_dist", {}, B=999, M=64, d=128) is None
    assert autotune.merged("gather_dist", {"split": 2}, **frontier) == {
        "split": 2}                             # an explicit override wins
    autotune.set_pick("prune", {"regime": "table", "warps": 8,
                                "at": {"C": 80, "d": 128}})
    o = autotune.merged("prune", {}, C=80, d=128)
    assert prune.smem_plan(80, 128, o).regime == "table"
    assert prune.smem_plan(80, 128).regime == "block"
    assert autotune.merged("prune", {}, C=128, d=128) is None
    picks = autotune.all_picks()
    autotune.clear_picks()
    assert autotune.merged("gather_dist", {}, **frontier) is None
    assert autotune.merged("prune", {}, C=80, d=128) is None
    assert gd.plan(1000, 64, "f32", 128, True) == default
    autotune.install(picks)
    assert autotune.all_picks() == picks
    # a pick without "at" applies to every shape, as repro's do
    autotune.clear_picks()
    autotune.install({"hop": {"warps": 8}})
    assert autotune.get_pick("hop", B=5, W=2, d=64) == {"warps": 8}
    assert autotune.get_pick("hop") == {"warps": 8}


def test_plans_with_no_override_are_todays():
    for B, M, d in ((1000, 64, 128), (64, 64, 1024), (32768, 3, 128)):
        p = gd.plan(B, M, "f32", d, True)
        assert gd.plan(B, M, "f32", d, True, override=None) == p
        assert gd.plan(B, M, "f32", d, True,
                       override={"split": p.split}) == p
    for C, d in ((80, 128), (144, 1024), (48, 4096)):
        p = prune.smem_plan(C, d)
        assert prune.smem_plan(C, d, prune.plan_params(p)) == p
        assert p.warps == prune.warps_of(p.bytes)


def test_oversized_candidates_raise():
    with pytest.raises(ValueError, match="slots a task"):
        gd.plan(1000, 128, "f32", 128, True, override={"split": 1})
    with pytest.raises(ValueError, match="warps"):
        gd.plan(8, 256, "f32", 128, True, hop=(16, 336),
                override={"warps": 4})
    with pytest.raises(ValueError, match="plan parameter"):
        gd.plan(8, 64, "f32", 128, True, override={"warps": 4})
    with pytest.raises(ValueError, match="shared memory"):
        prune.smem_plan(144, 1024, {"regime": "block"})
    with pytest.raises(ValueError, match="warps"):
        prune.smem_plan(80, 128, {"warps": 16})
    with pytest.raises(ValueError, match="regime"):
        prune.smem_plan(80, 128, {"regime": "partial"})
    with pytest.raises(ValueError, match="no staged"):
        prune.smem_plan(80, 128, {"regime": "table", "staged": 4})
    for kind, probes in autotune.PROBES.items():
        for p in probes:                # every offered candidate fits
            for c in autotune.CANDIDATES[kind](p):
                if kind == "prune":
                    prune.smem_plan(p["C"], p["d"], c)
                elif kind == "hop":
                    gd.plan(p["B"], p["W"] * p["m_out"], p["layout"],
                            p["d"], True, hop=(p["W"], p["K"]), override=c)
                elif kind != "edge_select":
                    gd.plan(p["B"], p["M"], p["layout"], p["d"], True,
                            override=c)
