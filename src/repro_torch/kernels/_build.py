"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles each ``repro_torch/csrc/<name>.cu`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), and ``ctypes`` loads it. Every pointer and the stream pass as
``c_void_p``; every C entry returns ``cudaGetLastError()`` after its launch
and :func:`check` raises when that is not 0.

The libraries go to ``build/repro_torch/<hash>/`` under the checkout's root
(``.gitignore`` lists ``build/``), keyed by a hash of every source in
``csrc/`` and of the compiler flags, so an edited source rebuilds and an
unchanged one loads the cached library. :func:`build_all` compiles every
missing library with one ``nvcc`` per source, all started together.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

__all__ = [
    "SOURCES", "build_all", "library", "check", "check_tensor",
    "stream_of", "ptxas_report",
]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gather_distance", "edge_select", "hop", "prune",
           "flash_attention", "distance")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def source_hash() -> str:
    """Hash of every file in ``csrc/`` and of the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build_dir() -> pathlib.Path:
    return BUILD_ROOT / source_hash()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("repro_torch: nvcc not found; cannot build kernels")


def build_all() -> float:
    """Compile every library that is not built yet, one ``nvcc`` per
    source, all at once. Returns the wall seconds spent (0.0 when every
    library was cached). Raises ``RuntimeError`` naming the failed sources
    with the compiler's output."""
    out_dir = _build_dir()
    todo = [s for s in SOURCES if not (out_dir / f"lib{s}.so").exists()]
    if not todo:
        return 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for s in todo:
        tmp = out_dir / f"lib{s}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / f"{s}.cu")]
        procs[s] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    for s, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{s}.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{s}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out_dir / f"lib{s}.so")
    if failed:
        raise RuntimeError("repro_torch: kernel build failed\n"
                           + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report() -> str:
    """The ``ptxas -v`` lines (registers, shared memory, spills) of the
    last build of each library."""
    lines = []
    for s in SOURCES:
        log = _build_dir() / f"{s}.log"
        if log.exists():
            lines += [f"[{s}] {ln.strip()}" for ln in
                      log.read_text(errors="replace").splitlines()
                      if "registers" in ln or "spill" in ln]
    return "\n".join(lines)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_build_dir() / f"lib{name}.so"))
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(rc: int, lib: str, op: str) -> None:
    """Raise when a C entry's ``cudaGetLastError()`` is not 0."""
    if rc != 0:
        msg = library(lib).rt_error_string(rc).decode()
        raise RuntimeError(f"{op}: CUDA launch failed ({rc}): {msg}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
                 device: torch.device) -> None:
    """The kernels take contiguous CUDA tensors of one dtype and rank, all
    on one device; raise on anything else."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: rank {t.dim()}, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_of(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
