"""Typed registry of every ``RTORCH_*`` environment knob the port reads
(the port's counterpart of ``repro/core/knobs.py``).

Each knob is declared once, with its name, type, default, accepted
values, one line of doc and the layer that reads it, and is read only
through the typed accessors here (:func:`get_str`, :func:`get_int`,
:func:`get_float`, :func:`get_bool`, :func:`get_list`). An unregistered
name raises ``KeyError``. ``tests/test_torch_contracts.py`` holds the
port to that (no ``os.environ`` / ``os.getenv`` with an ``RTORCH_`` key
outside this module, every ``RTORCH_*`` literal registered) and pins
``docs/KNOBS_torch.md`` to :func:`generate_markdown`.

The prefix is the port's own: ``REPRO_*`` belongs to the JAX package. Its
tokens map as ``pallas`` -> ``cuda`` and ``xla`` -> ``torch``; the
TPU-mesh dry-run's ``REPRO_DRYRUN_DEVICES`` has no counterpart here.

Accessors read the environment at call time, so a test's
``monkeypatch.setenv`` takes effect at once; pass ``env=`` to resolve
against another mapping.
"""
from __future__ import annotations

import dataclasses
import os

__all__ = [
    "Knob", "REGISTRY", "get", "raw", "get_str", "get_int", "get_float",
    "get_bool", "get_list", "generate_markdown", "PREFIX",
]

PREFIX = "RTORCH_"


@dataclasses.dataclass(frozen=True)
class Knob:
    """One registered environment knob (a row of docs/KNOBS_torch.md)."""

    name: str            # the RTORCH_* variable
    type: str            # "str" | "int" | "float" | "bool" | "list"
    default: object      # what the typed accessor returns when unset
    values: str          # accepted values (doc table cell)
    doc: str             # one-line effect (doc table cell)
    section: str         # doc section key (see _SECTIONS)
    consumed_by: str = ""  # the layer that reads it (dispatch table only)

    def __post_init__(self):
        if not self.name.startswith(PREFIX):
            raise ValueError(f"knob {self.name!r} must start with {PREFIX}")
        if self.type not in ("str", "int", "float", "bool", "list"):
            raise ValueError(f"knob {self.name}: unknown type {self.type!r}")


REGISTRY: tuple[Knob, ...] = (
    # -- kernel dispatch (kernels/ops.py) -----------------------------------
    Knob("RTORCH_IMPL", "str", None, "`cuda`, `torch`, `legacy`",
         "every `auto` dispatch at once (`legacy`: the prune's eager "
         "oracle, the hop composed; the hop: see below)", "dispatch",
         "`ops.py::default_impl`"),
    Knob("RTORCH_DIST_IMPL", "str", None, "`cuda`, `torch`",
         "gather+distance and all-pairs distance only", "dispatch",
         "`ops.gather_dist`, `ops.pairwise_dist`"),
    Knob("RTORCH_EDGE_IMPL", "str", None, "`cuda`, `torch`, `argsort`",
         "edge selection only", "dispatch", "`ops.select_edges`"),
    Knob("RTORCH_PRUNE_IMPL", "str", None, "`cuda`, `torch`, `legacy`",
         "construction prune only", "dispatch", "`ops.prune`"),
    Knob("RTORCH_HOP_IMPL", "str", None, "`cuda`, `torch`, `composed`",
         "the fused whole-hop kernel", "dispatch", "`ops.hop`"),
    Knob("RTORCH_FLASH_IMPL", "str", None, "`cuda`, `torch`",
         "flash attention only", "dispatch", "`ops.flash_attention`"),
    # -- storage codecs (core/storage.py::default_config) -------------------
    Knob("RTORCH_STORAGE", "str", None,
         "`f32` (default), `compact`, `f16`, `int8`, `pq`",
         "moves `storage.default_config()`, the `StorageConfig` a build "
         "uses when the caller passes `storage=None`", "storage"),
    # -- serving (serve/executor.py, serve/engine.py, serve/faults.py) ------
    Knob("RTORCH_SERVE_WARMUP", "bool", False, "unset / `1`",
         "every `SearchExecutor` / `ServingEngine` built with "
         "`warmup=None` fills its `configs × batch_buckets × k_buckets` "
         "cache grid at construction", "serve"),
    Knob("RTORCH_FAULTS", "list", (),
         "comma list of `latency`, `flush_error`, `queue_full`",
         "fault injection in `AsyncServingEngine` (`serve/loop.py` picks "
         "the env up by default; the sync engine and executor only when "
         "asked)", "serve"),
    Knob("RTORCH_FAULT_LATENCY_S", "float", 0.02, "float, default `0.02`",
         "injected latency spike duration", "serve"),
    Knob("RTORCH_FAULT_LATENCY_RATE", "float", 0.25, "float, default `0.25`",
         "fraction of flushes hit by a latency spike", "serve"),
    Knob("RTORCH_FAULT_FLUSH_ERROR_RATE", "float", 0.25, "float",
         "fraction of flushes that raise", "serve"),
    Knob("RTORCH_FAULT_QUEUE_FULL_RATE", "float", 0.25, "float",
         "fraction of admissions rejected as queue-full", "serve"),
    Knob("RTORCH_FAULT_SEED", "int", 0, "int",
         "deterministic fault schedule", "serve"),
    # -- build (core/build.py) ----------------------------------------------
    Knob("RTORCH_CHUNK_BUDGET_MB", "int", 16, "int, default `16`",
         "budget the build's chunk rule sizes its `[chunk, C, d]` f32 "
         "candidate block against (`core/build.py::auto_chunk`; clamped "
         "to [256, 8192] rows). `BuildConfig.chunk` overrides per build",
         "build"),
    # -- io -----------------------------------------------------------------
    Knob("RTORCH_COMPRESS_LEVEL", "int", 3, "int, default `3`",
         "compression level of serialized index blobs (`compressio.py`; "
         "zstd where installed, else zlib). An explicit `level=` wins",
         "io"),
)

_BY_NAME = {k.name: k for k in REGISTRY}

_TRUE_FALSE = {"0": False, "false": False, "no": False, "off": False}


def get(name: str) -> Knob:
    """The registered :class:`Knob`, or ``KeyError``."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"{name!r} is not a registered knob: declare it in "
            "repro_torch.core.knobs.REGISTRY and regenerate "
            "docs/KNOBS_torch.md"
        ) from None


def raw(name: str, env=None) -> str | None:
    """The raw string of a registered knob (``None`` when unset)."""
    knob = get(name)
    source = os.environ if env is None else env
    return source.get(knob.name)


def get_str(name: str, env=None) -> str | None:
    """The raw string, or the default when unset. Not stripped: checking
    tokens (and reading an empty string as unset) is the reader's job."""
    v = raw(name, env)
    return _BY_NAME[name].default if v is None else v


def get_int(name: str, env=None) -> int:
    v = raw(name, env)
    if v is None or not v.strip():
        return int(_BY_NAME[name].default)
    return int(v)


def get_float(name: str, env=None) -> float:
    v = raw(name, env)
    if v is None or not v.strip():
        return float(_BY_NAME[name].default)
    return float(v)


def get_bool(name: str, env=None) -> bool:
    """Unset or empty -> default; `0`/`false`/`no`/`off` -> False; else
    True."""
    v = raw(name, env)
    if v is None or not v.strip():
        return bool(_BY_NAME[name].default)
    return _TRUE_FALSE.get(v.strip().lower(), True)


def get_list(name: str, env=None) -> tuple[str, ...]:
    """A comma list -> tuple of stripped non-empty tokens."""
    v = raw(name, env)
    if v is None:
        return tuple(_BY_NAME[name].default)
    return tuple(t.strip() for t in v.split(",") if t.strip())


# ---------------------------------------------------------------------------
# docs/KNOBS_torch.md
# ---------------------------------------------------------------------------

_HEADER = """\
<!-- GENERATED FILE — do not edit by hand.
     Source: src/repro_torch/core/knobs.py::REGISTRY.
     Regenerate with: PYTHONPATH=src python -c "from repro_torch.core import
     knobs; open('docs/KNOBS_torch.md', 'w').write(knobs.generate_markdown())"
     (tests/test_torch_contracts.py fails when this file drifts.) -->

# KNOBS_torch — every `RTORCH_*` environment variable of the port

Every environment knob the PyTorch/CUDA port (`src/repro_torch/`) reads,
the values it takes and the layer that reads it. The port's counterparts
of `repro`'s `REPRO_*` knobs ([KNOBS.md](KNOBS.md)), with the port's
tokens (`pallas` -> `cuda`, `xla` -> `torch`); the TPU-mesh dry-run's
`REPRO_DRYRUN_DEVICES` has none. The programmatic way to set the same
things is `SearchConfig` / `StorageConfig` / `BuildConfig` arguments, which
win where both exist. Every knob is read through the typed registry
`src/repro_torch/core/knobs.py`, from which this file is generated.
"""

_SECTIONS: tuple[tuple[str, str, str], ...] = (
    ("dispatch", "Kernel dispatch", """\
Every op of `src/repro_torch/kernels/ops.py` takes an `impl` argument that
defaults to `"auto"`: the hand-written kernel on CUDA tensors, the plain
torch version on CPU tensors. The knobs move an `auto` dispatch without
touching call sites.
"""),
    ("storage", "Storage codecs", ""),
    ("serve", "Serving", ""),
    ("build", "Build", ""),
    ("io", "IO", ""),
)

_DISPATCH_FOOTER = """\
**Precedence.** A per-call `impl=` other than `"auto"` beats
`RTORCH_<OP>_IMPL`, which beats the global `RTORCH_IMPL`, which beats the
device's rule. Unknown tokens raise, and a token that belongs to one op
only (`legacy`: the prune; `argsort`: edge selection) raises in the
others, even through the global knob. `cuda` on CPU tensors raises; it
never falls back to `torch`.

**The hop.** `ops.hop` is asymmetric, as `repro`'s is: the global
`RTORCH_IMPL` does not launch the fused hop kernel. It resolves the hop's
`auto` to `composed` (select_edges -> visited test-and-set ->
gather_dist), so each inner op's `auto` takes the forced backend;
`RTORCH_IMPL=legacy` resolves it to `composed` with the inner ops on the
device's own rule. Only `RTORCH_HOP_IMPL=cuda`, or `auto` on the card,
launches the fused kernel. A hop with an explicit `edge_impl` /
`dist_impl` pin runs `composed` as well.
"""

_STORAGE_FOOTER = """\
`compact` = bf16 vectors + narrowed (int16/int32) neighbour ids; `f16` the
same with float16 vectors; `int8` = per-vector scaled int8 + split
segment-offset ids; `pq` = product-quantized vectors + split ids + an int8
rerank sidecar (pair with `SearchConfig(rerank=...)`). An explicit
`storage=StorageConfig(...)` always wins. Unknown tokens raise.
`core/distributed.py::build_sharded` reads it too, and raises for the
codecs it cannot stack (`int8`, `pq`).
"""

_CHIP_FOOTER = """\
## Where they are set

`chip_smoke.py` refuses to start when a dispatch or storage knob is set in
its environment (the main path would run other backends with no sign of
it); its `knobs[...]` phase sets each in the process, checks the launch
counts and ids, and restores it. The tests set knobs with
`monkeypatch.setenv` only.
"""


def generate_markdown() -> str:
    """The exact content of ``docs/KNOBS_torch.md``."""
    out = [_HEADER]
    for key, title, preamble in _SECTIONS:
        knobs = [k for k in REGISTRY if k.section == key]
        if not knobs:
            continue
        out.append(f"\n## {title}\n")
        if preamble:
            out.append("\n" + preamble)
        if key == "dispatch":
            out.append("\n| Variable | Values | Forces | Consumed by |\n"
                       "|---|---|---|---|\n")
            for k in knobs:
                out.append(f"| `{k.name}` | {k.values} | {k.doc} "
                           f"| {k.consumed_by} |\n")
            out.append("\n" + _DISPATCH_FOOTER)
        else:
            out.append("\n| Variable | Values | Effect |\n|---|---|---|\n")
            for k in knobs:
                out.append(f"| `{k.name}` | {k.values} | {k.doc} |\n")
            if key == "storage":
                out.append("\n" + _STORAGE_FOOTER)
    out.append("\n" + _CHIP_FOOTER)
    return "".join(out)
