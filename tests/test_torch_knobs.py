"""The port's typed knob registry and dispatch overrides against
``repro``'s (``repro/core/knobs.py``, ``repro/kernels/ops.py``).

  * Every ``repro`` knob but the TPU-mesh dry-run's has an ``RTORCH_*``
    counterpart of the same type, default and accepted values, tokens
    mapped ``pallas`` -> ``cuda``, ``xla`` -> ``torch``.
  * ``default_impl``'s precedence (per-op knob, then global knob, then the
    device) and the hop's resolution agree with ``repro``'s on the same
    environment, on the CPU and on the card (``repro`` resolving as on a
    TPU, the port for a CUDA tensor); ``repro``'s hop is observed through
    spies on the branches it takes.
  * Unknown and foreign tokens raise; ``cuda`` on CPU tensors raises,
    also through a knob.
  * ``RTORCH_STORAGE``, ``RTORCH_CHUNK_BUDGET_MB``,
    ``RTORCH_COMPRESS_LEVEL``, ``RTORCH_SERVE_WARMUP`` and the fault knobs
    reach their readers.

Knobs are set only with ``monkeypatch.setenv``.
"""
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knobs as rknobs
from repro.kernels import ops as rops
from repro_torch import compressio
from repro_torch.core import build as tbuild
from repro_torch.core import distributed as tdist
from repro_torch.core import knobs as tknobs
from repro_torch.core import storage as tstorage
from repro_torch.kernels import ops as tops

TO_PORT = {"pallas": "cuda", "xla": "torch"}
# tokens the port's table names beyond repro's doc cell: repro's global
# knob takes "legacy" too (its hop maps it to composed, ops.py:260-275),
# and says so only in its footer
EXTRA_TOKENS = {"RTORCH_IMPL": {"legacy"}}
COUNTERPARTS = [k.name for k in rknobs.REGISTRY
                if k.name != "REPRO_DRYRUN_DEVICES"]


def _port_name(name: str) -> str:
    return "RTORCH_" + name[len("REPRO_"):]


def _tokens(cell: str) -> set[str]:
    return set(re.findall(r"`([^`]+)`", cell))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith(("REPRO_", "RTORCH_")):
            monkeypatch.delenv(name)


@pytest.mark.parametrize("name", COUNTERPARTS)
def test_every_repro_knob_has_a_counterpart(name):
    r = rknobs.get(name)
    t = tknobs.get(_port_name(name))
    assert (t.type, t.section) == (r.type, r.section)
    assert t.default == r.default
    want = {TO_PORT.get(x, x) for x in _tokens(r.values)}
    assert _tokens(t.values) == want | EXTRA_TOKENS.get(t.name, set())


def test_registry_holds_only_counterparts():
    assert sorted(k.name for k in tknobs.REGISTRY) == sorted(
        _port_name(n) for n in COUNTERPARTS)
    with pytest.raises(ValueError, match="RTORCH_"):
        tknobs.Knob("REPRO_X", "str", None, "", "", "io")


def test_accessors_read_at_call_time(monkeypatch):
    assert tknobs.get_int("RTORCH_FAULT_SEED") == 0
    monkeypatch.setenv("RTORCH_FAULT_SEED", "7")
    assert tknobs.get_int("RTORCH_FAULT_SEED") == 7
    assert tknobs.get_int("RTORCH_FAULT_SEED", {}) == 0
    assert tknobs.get_int("RTORCH_FAULT_SEED", {"RTORCH_FAULT_SEED": "3"}) \
        == 3
    monkeypatch.setenv("RTORCH_SERVE_WARMUP", "off")
    assert tknobs.get_bool("RTORCH_SERVE_WARMUP") is False
    monkeypatch.setenv("RTORCH_SERVE_WARMUP", "1")
    assert tknobs.get_bool("RTORCH_SERVE_WARMUP") is True
    monkeypatch.setenv("RTORCH_FAULTS", " latency, ,queue_full ")
    assert tknobs.get_list("RTORCH_FAULTS") == ("latency", "queue_full")
    assert tknobs.get_float("RTORCH_FAULT_LATENCY_S", {}) == 0.02
    with pytest.raises(KeyError, match="not a registered knob"):
        tknobs.get_str("RTORCH_NOPE")
    # the accessors agree with repro's on the same strings
    env = {"REPRO_FAULTS": "a,b", "RTORCH_FAULTS": "a,b"}
    assert tknobs.get_list("RTORCH_FAULTS", env) == \
        rknobs.get_list("REPRO_FAULTS", env)


# ---------------------------------------------------------------------------
# dispatch precedence against repro's
# ---------------------------------------------------------------------------

class _Card:
    """Stands for a CUDA tensor where only the device is asked."""
    is_cuda = True
    device = "cuda:0"


CPU = torch.zeros(1)
PER_OP = {"dist": ("torch", "cuda"), "edge": ("torch", "cuda", "argsort"),
          "prune": ("torch", "cuda", "legacy"), "flash": ("torch", "cuda")}


def _set(monkeypatch, name, token):
    """RTORCH_<name> = token and REPRO_<name> = its repro token."""
    if token is not None:
        monkeypatch.setenv(f"RTORCH_{name}", token)
        monkeypatch.setenv(f"REPRO_{name}", {v: k for k, v in
                                             TO_PORT.items()}.get(token,
                                                                  token))


def _on_card(monkeypatch, card):
    if card:
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return _Card() if card else CPU


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("kind", sorted(PER_OP))
def test_default_impl_precedence_matches_repro(monkeypatch, kind, card):
    """Per-op knob, then the global one, then the device, as repro
    resolves REPRO_<KIND>_IMPL / REPRO_IMPL / the platform."""
    on = _on_card(monkeypatch, card)
    for glob in (None, "torch", "cuda"):
        for per in (None, *PER_OP[kind]):
            with monkeypatch.context() as m:
                _set(m, "IMPL", glob)
                _set(m, f"{kind.upper()}_IMPL", per)
                want = rops.default_impl(kind)
                got = tops.default_impl(kind, on)
                assert got == TO_PORT.get(want, want), (glob, per)
                assert got == (per or glob or ("cuda" if card else "torch"))


class _Took(Exception):
    pass


def _repro_hop(monkeypatch, edge_pin):
    """The branch repro's ops.hop takes under the current environment:
    ("pallas",), ("xla",) or ("composed", edge, dist), the inner impls
    resolved as the dispatched ops would resolve their "auto"."""
    seen = {}

    def sel(*a, impl="auto", **k):
        seen["edge"] = impl if impl != "auto" else rops.default_impl("edge")
        return jnp.zeros((2, 2), jnp.int32)

    def gd(*a, impl="auto", **k):
        raise _Took(("composed", seen["edge"],
                     impl if impl != "auto" else rops.default_impl("dist")))

    def fused(*a, **k):
        raise _Took(("pallas",))

    def plain(*a, **k):
        raise _Took(("xla",))

    monkeypatch.setattr(rops, "select_edges", sel)
    monkeypatch.setattr(rops, "gather_dist", gd)
    monkeypatch.setattr(rops._hop, "hop_kernel_call", fused)
    monkeypatch.setattr(rops._ref, "hop", plain)
    q = jnp.zeros((2, 4), jnp.float32)
    args = (q, jnp.zeros((8, 4), jnp.float32),
            jnp.zeros((8, 4, 2), jnp.int32), jnp.zeros((2, 1), jnp.int32),
            jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32),
            jnp.zeros((2, 1), jnp.uint32), jnp.ones((2, 1), bool))
    try:
        rops.hop(*args, logn=3, m_out=2, edge_impl=edge_pin)
    except _Took as e:
        return e.args[0]
    raise AssertionError("repro's hop took no branch")


def _port_hop(on, edge_pin):
    impl, e, d = tops.resolve_hop("auto", edge_pin, "auto", on)
    if impl != "composed":
        return (impl,)
    return ("composed", e if e != "auto" else tops.default_impl("edge", on),
            d if d != "auto" else tops.default_impl("dist", on))


@pytest.mark.parametrize("edge_pin", ["auto", "torch"])
@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
def test_hop_resolution_matches_repro(monkeypatch, card, edge_pin):
    """RTORCH_IMPL makes the hop composed (each inner op on the forced
    backend; legacy: the device's own), only RTORCH_HOP_IMPL or auto on
    the card fuses, a per-op pin routes through composed, a bad token
    raises. One difference, on the CPU with nothing set: repro's auto hop
    is the composition of its plain ops, the port's the one-program plain
    hop (kernels/ref.py::hop); both are the plain versions, with equal
    outputs."""
    on = _on_card(monkeypatch, card)
    pin = {"torch": "xla"}.get(edge_pin, edge_pin)
    for glob in (None, "torch", "cuda", "legacy", "argsort", "bogus"):
        for hop in (None, "torch", "cuda", "composed", "bogus"):
            with monkeypatch.context() as m:
                _set(m, "IMPL", glob)
                _set(m, "HOP_IMPL", hop)
                try:
                    want = _repro_hop(m, pin)
                except ValueError:
                    want = ValueError
                try:
                    got = _port_hop(on, edge_pin)
                except ValueError:
                    got = ValueError
                except RuntimeError:
                    got = RuntimeError
            if want is not ValueError:
                want = tuple(TO_PORT.get(x, x) for x in want)
            if not card and want == ("cuda",):
                # repro interprets the Pallas hop on the CPU; the port's
                # "cuda" on CPU tensors raises
                assert got is RuntimeError, (glob, hop, edge_pin)
                continue
            if (not card and glob is None and hop is None
                    and edge_pin == "auto"):
                assert want == ("composed", "torch", "torch")
                assert got == ("torch",)
                continue
            assert got == want, (glob, hop, edge_pin)


# ---------------------------------------------------------------------------
# tokens on real tensors
# ---------------------------------------------------------------------------

def _edge_problem():
    rng = np.random.default_rng(0)
    n, logn, m = 16, 4, 3
    nbrs = torch.as_tensor(rng.integers(-1, n, (n, logn + 1, m)),
                           dtype=torch.int32)
    us = torch.tensor([0, 5, 9, 15], dtype=torch.int32)
    return nbrs, us, logn, m


def test_unknown_and_foreign_tokens_raise(monkeypatch):
    nbrs, us, logn, m = _edge_problem()
    q, x = torch.zeros((2, 4)), torch.zeros((8, 4))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    cand = torch.zeros((2, 3), dtype=torch.int32)
    du = torch.ones((2, 3))

    def sel():
        return tops.select_edges(nbrs, us, 0, 15, logn=logn, m_out=m)

    def gat():
        return tops.gather_dist(q, x, ids)

    def prn():
        return tops.prune(cand, du, x, m=2)

    monkeypatch.setenv("RTORCH_IMPL", "legacy")   # the prune's token only
    prn()
    for f in (sel, gat, lambda: tops.pairwise_dist(q, x)):
        with pytest.raises(ValueError, match="unknown impl 'legacy'"):
            f()
    monkeypatch.setenv("RTORCH_IMPL", "argsort")  # edge selection's only
    assert torch.equal(sel(), tops.select_edges(
        nbrs, us, 0, 15, logn=logn, m_out=m, impl="torch"))
    for f in (gat, prn):
        with pytest.raises(ValueError, match="unknown impl 'argsort'"):
            f()
    monkeypatch.delenv("RTORCH_IMPL")
    monkeypatch.setenv("RTORCH_EDGE_IMPL", "legacy")
    with pytest.raises(ValueError, match="select_edges: unknown impl"):
        sel()
    monkeypatch.setenv("RTORCH_EDGE_IMPL", "")      # empty means unset
    sel()
    monkeypatch.setenv("RTORCH_DIST_IMPL", "pallas")  # repro's token
    with pytest.raises(ValueError, match="gather_dist: unknown impl"):
        gat()
    monkeypatch.setenv("RTORCH_HOP_IMPL", "argsort")
    with pytest.raises(ValueError, match="hop: unknown impl"):
        tops.resolve_hop("auto", "auto", "auto", CPU)
    monkeypatch.setenv("RTORCH_HOP_IMPL", "legacy")  # composed, as repro
    assert tops.resolve_hop("auto", "auto", "auto", CPU) == (
        "composed", "torch", "torch")


def test_cuda_on_cpu_tensors_raises_never_falls_back(monkeypatch):
    nbrs, us, logn, m = _edge_problem()
    q, x = torch.zeros((2, 4)), torch.zeros((8, 4))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tops.select_edges(nbrs, us, 0, 15, logn=logn, m_out=m, impl="cuda")
    for name in ("RTORCH_IMPL", "RTORCH_DIST_IMPL"):
        with monkeypatch.context() as mp:
            mp.setenv(name, "cuda")
            with pytest.raises(RuntimeError, match="needs CUDA tensors"):
                tops.pairwise_dist(q, x)
    # the global knob reaches the hop's inner ops, which raise too
    monkeypatch.setenv("RTORCH_IMPL", "cuda")
    assert tops.resolve_hop("auto", "auto", "auto", CPU)[0] == "composed"
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tops.select_edges(nbrs, us, 0, 15, logn=logn, m_out=m)
    monkeypatch.setenv("RTORCH_HOP_IMPL", "cuda")
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tops.resolve_hop("auto", "auto", "auto", CPU)


def test_argsort_token_matches_the_plain_version():
    rng = np.random.default_rng(3)
    n, logn, m = 64, 6, 4
    nbrs = torch.as_tensor(rng.integers(-1, n, (n, logn + 1, m)),
                           dtype=torch.int32)
    us = torch.as_tensor(rng.integers(-1, n, 40), dtype=torch.int32)
    L = torch.as_tensor(rng.integers(0, 32, 40), dtype=torch.int32)
    R = L + torch.as_tensor(rng.integers(0, 32, 40), dtype=torch.int32)
    for skip in (True, False):
        got = tops.select_edges(nbrs, us, L, R, logn=logn, m_out=m,
                                skip_layers=skip, impl="argsort")
        want = tops.select_edges(nbrs, us, L, R, logn=logn, m_out=m,
                                 skip_layers=skip, impl="torch")
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the other knobs reach their readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("token,want", [
    ("", tstorage.StorageConfig()), ("f32", tstorage.StorageConfig()),
    ("compact", tstorage.StorageConfig.compact()),
    ("F16", tstorage.StorageConfig.compact("float16")),
    ("int8", tstorage.StorageConfig.int8()),
    ("pq", tstorage.StorageConfig.pq())])
def test_storage_knob_moves_default_config(monkeypatch, token, want):
    from repro.core import storage as rstorage

    monkeypatch.setenv("RTORCH_STORAGE", token)
    monkeypatch.setenv("REPRO_STORAGE", token)
    got = tstorage.default_config()
    assert got == want
    assert got == tstorage.StorageConfig(**{
        f.name: getattr(rstorage.default_config(), f.name)
        for f in __import__("dataclasses").fields(got)})


def test_storage_knob_reaches_the_builds(monkeypatch):
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((64, 8)).astype(np.float32)
    attrs = rng.uniform(0, 1, 64)
    cfg = tbuild.BuildConfig(m=4, ef_construction=8, brute_threshold=16)
    monkeypatch.setenv("RTORCH_STORAGE", "bogus")
    with pytest.raises(ValueError, match="RTORCH_STORAGE"):
        tstorage.default_config()
    monkeypatch.setenv("RTORCH_STORAGE", "compact")
    from repro_torch import RangeGraphIndex

    idx = RangeGraphIndex.build(vectors, attrs, cfg, device="cpu")
    assert idx.vectors.dtype == torch.bfloat16
    assert idx.neighbors.dtype == torch.int16
    # an explicit storage wins over the knob
    idx = RangeGraphIndex.build(vectors, attrs, cfg, device="cpu",
                                storage=tstorage.StorageConfig())
    assert idx.vectors.dtype == torch.float32
    monkeypatch.setenv("RTORCH_STORAGE", "int8")
    with pytest.raises(ValueError, match="codec storage"):
        tdist.build_sharded(vectors, attrs, 2, cfg, device="cpu")


def test_chunk_budget_and_compress_level_knobs(monkeypatch):
    base = tbuild.auto_chunk(80, 128)
    monkeypatch.setenv("RTORCH_CHUNK_BUDGET_MB", "64")
    assert tbuild.auto_chunk(80, 128) == 4 * base
    assert tbuild.auto_chunk(80, 128, budget_bytes=16 << 20) == base
    blob = bytes(range(256)) * 64 + b"abc" * 4000
    monkeypatch.setenv("RTORCH_COMPRESS_LEVEL", "1")
    assert compressio.compress(blob) == compressio.compress(blob, level=1)
    assert compressio.decompress(compressio.compress(blob)) == blob
    monkeypatch.setenv("RTORCH_COMPRESS_LEVEL", "")
    assert compressio.compress(blob) == compressio.compress(blob, level=3)


def test_serve_warmup_and_fault_knobs(monkeypatch):
    from repro_torch import RangeGraphIndex, SearchConfig
    from repro_torch.serve import faults
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.executor import SearchExecutor

    rng = np.random.default_rng(1)
    idx = RangeGraphIndex.build(
        rng.standard_normal((64, 8)).astype(np.float32),
        rng.uniform(0, 1, 64),
        tbuild.BuildConfig(m=4, ef_construction=8, brute_threshold=16),
        device="cpu")
    cfg = SearchConfig(ef=8, k_bucket=8)
    assert SearchExecutor(idx, cfg, max_batch=2).stats["compiles"] == 0
    monkeypatch.setenv("RTORCH_SERVE_WARMUP", "1")
    ex = SearchExecutor(idx, cfg, max_batch=2)
    assert ex.stats["warmup_compiles"] == ex.program_grid() > 0
    eng = ServingEngine(idx, config=cfg, max_batch=2)
    assert eng.executor.stats["warmup_compiles"] > 0
    assert SearchExecutor(idx, cfg, max_batch=2,
                          warmup=False).stats["compiles"] == 0

    assert faults.resolve(None) is None
    monkeypatch.setenv("RTORCH_FAULTS", "latency,flush_error")
    monkeypatch.setenv("RTORCH_FAULT_SEED", "3")
    monkeypatch.setenv("RTORCH_FAULT_LATENCY_RATE", "0.5")
    inj = faults.resolve(None)
    assert inj.config == faults.FaultConfig(
        kinds=("latency", "flush_error"), latency_rate=0.5, seed=3)
    assert faults.resolve(False) is None


@pytest.mark.parametrize("name", ["RTORCH_IMPL", "RTORCH_HOP_IMPL",
                                  "RTORCH_STORAGE"])
def test_chip_smoke_refuses_a_set_dispatch_or_storage_knob(
        name, monkeypatch, capsys):
    """The smoke would run other backends than its main path names with no
    sign of it: it exits non-zero before anything else, printing no
    result (the check precedes the card's)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    import chip_smoke

    monkeypatch.setenv(name, "torch" if name != "RTORCH_STORAGE"
                       else "compact")
    with pytest.raises(SystemExit) as e:
        chip_smoke.run(None)
    assert e.value.code != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "knobs are set" in out.err and name in out.err
