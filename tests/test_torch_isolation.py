"""The port stands alone: no JAX, nothing of ``repro``, no hidden fallback.

  * No file under ``src/repro_torch/`` (``core/``, ``kernels/``,
    ``configs/``, ``models/``, ``sharding/``, ``serve/``, ``launch/``,
    ``bench/``, ``train/``, ``checkpoint/``, ``runtime/``),
    and neither ``chip_smoke.py`` nor ``prune_time.py``, imports ``jax``, ``repro``, ``msgpack`` or
    ``ml_dtypes`` (an AST scan), nor ``zstandard`` outside
    ``compressio.py``, which imports it where it compresses and only when
    it is installed.
  * ``import repro_torch`` works with ``jax``, ``repro``, ``msgpack``,
    ``zstandard`` and ``ml_dtypes`` blocked (the card's machine lacks the
    last three).
  * Without a card, an entry point called without ``device`` raises
    ``RuntimeError`` instead of carrying on on the CPU, and
    ``chip_smoke.py`` exits non-zero printing no result, as it does when
    it stands alone in a directory.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BLOCKED = ("jax", "jaxlib", "repro", "msgpack", "zstandard", "ml_dtypes")


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.add(node.module)
    return out


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "prune_time.py"]
    assert len(files) > 10
    return files


def test_scan_covers_every_port_package():
    dirs = {p.parent.relative_to(PORT).as_posix() for p in _port_files()
            if PORT in p.parents}
    assert {"core", "kernels", "configs", "models", "sharding", "serve",
            "launch", "bench", "train", "checkpoint", "runtime"} <= dirs


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_repro_imports(path):
    banned = {"jax", "jaxlib", "repro", "msgpack", "ml_dtypes"}
    if path.name != "compressio.py":
        banned.add("zstandard")
    bad = {m for m in _imports(path) if m.split(".")[0] in banned}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_import_with_reference_and_codec_packages_blocked():
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "from repro_torch.kernels import ops, ref, _build\n"
        "from repro_torch.core import build, search, index, msgpack_lite\n"
        "import repro_torch.data, repro_torch.compressio\n"
        "from repro_torch import configs, serve\n"
        "from repro_torch.models import api, attention, transformer\n"
        "from repro_torch.models import encdec, mamba2, mlp, xlstm\n"
        "from repro_torch.train import step, optimizer, compression\n"
        "from repro_torch.checkpoint import checkpoint\n"
        "from repro_torch.runtime import trainer\n"
        "from repro_torch.launch import serve as launch_serve\n"
        "from repro_torch.launch import train as launch_train\n"
        "from repro_torch.sharding import partitioning\n"
        "import repro_torch.bench.roofline, repro_torch.bench.buildpath\n"
        "import repro_torch.bench.ckpt_io\n"
        "import repro_torch.bench.run, repro_torch.bench.fig2_qps_recall\n"
        "from repro_torch.core import baselines, multiattr\n"
        "from repro_torch.core import rng\n"
        "from repro_torch.kernels import distance\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is not taken")


def test_entry_points_raise_without_a_card(no_card):
    from repro_torch import RangeGraphIndex
    from repro_torch.core import build as tbuild
    from repro_torch.device import resolve_device

    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((32, 4)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        RangeGraphIndex.build(vectors, rng.uniform(size=32))
    with pytest.raises(RuntimeError, match="CUDA"):
        tbuild.build_neighbor_table(vectors)
    idx = RangeGraphIndex.build(vectors, rng.uniform(size=32), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        RangeGraphIndex.from_numpy(idx.to_numpy())


def test_benchmarks_raise_without_a_card(no_card, tmp_path):
    """The benchmarks measure the card unless told ``--device cpu``."""
    from repro_torch.bench import buildpath, roofline

    for mod in (roofline, buildpath):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(["--smoke", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def _smoke(cwd: pathlib.Path, script: pathlib.Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_chip_smoke_fails_without_a_card(no_card):
    out = _smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "cuda" in out.stderr.lower()


def test_chip_smoke_fails_alone(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    out = _smoke(tmp_path, lone)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
