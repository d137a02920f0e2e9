"""Run one cell of the benchmark once and print its result line.

    python3 rfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``checks`` last: each number compared beside its limit).
The same numbers close standard error. The run exits with another code
than 0, and prints no result, when no CUDA card is there, when the
program is not in the checkout, or when ``jax``, ``jaxlib``, ``flax`` or
``repro`` were loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str) -> int:
    print(f"rfbench: {msg}", file=sys.stderr, flush=True)
    return 2


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that this run must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    knobs = sorted(k for k in os.environ if k.startswith("RTORCH_"))
    if knobs:
        return fail(f"the program's knobs are set ({', '.join(knobs)}); "
                    "the benchmark measures its defaults")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        return fail(f"no program at {SRC / 'repro_torch'}")
    # one process with few threads: nothing on the measured path computes
    # on the host's cores in parallel, and idle workers only add noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # caches of the program's builds stay in the checkout, at fixed paths,
    # whatever the environment names
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    sys.path[:0] = [str(SRC), str(ROOT)]

    import torch

    from rfbench import spec
    from rfbench.cell import run_cell

    try:
        cell = spec.load_cell(ROOT, args.workload)
    except spec.SpecError as e:
        return fail(str(e))
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"found {torch.cuda.device_count()}")
    import repro_torch

    if pathlib.Path(repro_torch.__file__).resolve().parent != \
            (SRC / "repro_torch").resolve():
        return fail(f"repro_torch loaded from {repro_torch.__file__}, "
                    f"not from this checkout")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, t_start=T_START)

    bad = loaded_forbidden()
    if bad:
        return fail(f"loaded {', '.join(bad)} in the measuring process")
    print(f"card {card_line()}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        lim = "none" if c["limit"] is None else f"{c['limit'][0]} " \
            f"{c['limit'][1]}"
        print(f"check {name} {c['value']} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0


def card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def finite(x):
    """``x`` with every float that is not finite written as a string, so
    the line is strict JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and x != x or x in (float("inf"), float("-inf")):
        return str(x)
    return x


if __name__ == "__main__":
    sys.exit(main())
