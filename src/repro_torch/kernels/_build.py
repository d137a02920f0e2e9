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

import contextlib
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

import torch

__all__ = [
    "SOURCES", "build_all", "library", "check", "check_tensor",
    "stream_of", "on_device", "ptxas_report", "ptxas_summary",
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


_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def _kernel_name(mangled: str) -> str:
    """``flash_tc_kernel<bf16,128>`` from an Itanium-mangled kernel name:
    the first name ending in ``kernel`` of its (possibly nested) name,
    then the types, ``Li..E`` ints and ``Lb..E`` bools of its template."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    i = m.end()
    while True:
        d = re.match(r"\d+", mangled[i:])
        if not d:
            return mangled
        i += d.end()
        name = mangled[i:i + int(d.group())]
        i += len(name)
        if name.endswith("kernel"):
            break
    t = re.match(r"I(.*?E)E", mangled[i:])
    if not t:
        return name
    args = re.findall(r"L[ib](\d+)E|(13__nv_bfloat16|6__half|f)(?=L|E|$)",
                      t.group(1))
    return f"{name}<{','.join(n or _TYPES[ty] for n, ty in args)}>"


def ptxas_summary(name: str) -> list[dict]:
    """Per kernel function of ``csrc/<name>.cu``'s last build: its
    registers, spill stores and spill loads (bytes), from ``ptxas -v``."""
    log = _build_dir() / f"{name}.log"
    if not log.exists():
        return []
    out, fn = [], None
    for ln in log.read_text(errors="replace").splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = {"function": _kernel_name(m.group(1))}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if fn is not None and m:
            fn["spill_stores"], fn["spill_loads"] = map(int, m.groups())
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if fn is not None and m:
            fn["registers"] = int(m.group(1))
            out.append(fn)
            fn = None
    return out


def ptxas_report() -> str:
    """One line per kernel function of the last build of each library:
    registers and spills, from ``ptxas -v``."""
    return "\n".join(
        f"ptxas[{s}] {f['function']}: {f['registers']} registers, spill "
        f"stores {f['spill_stores']} B, spill loads {f['spill_loads']} B"
        for s in SOURCES for f in ptxas_summary(s))


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


# one C call for the current stream's handle, where torch has it
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_SAME_DEVICE = contextlib.nullcontext()


def stream_of(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as an integer handle."""
    if _RAW_STREAM is not None and device.index is not None:
        return _RAW_STREAM(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def on_device(device: torch.device):
    """A context in which ``device`` is the current card: nothing to do
    where it already is, the common case (entering ``torch.cuda.device``
    costs a search loop's launch several µs of host time)."""
    if device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)
