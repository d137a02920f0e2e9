"""The launch plan of the gather-distance and hop kernels, on the CPU.

``kernels/gather_distance.py::plan`` makes every shape decision of
``csrc/gather_distance.cu`` and ``csrc/hop.cu``: the row width's
instantiation, the rows a warp keeps in flight, the tasks a query row's
slots are split over, warps per CTA and shared memory. The kernels run
only on the card (``tests/test_torch_cuda.py``); here the plan is held to what the kernels
assume of it: every (query row, slot) item lies in exactly one warp's
task of at most 64 slots, the tasks fill the card where the batch allows,
the shared memory fits, and the mirrored constants agree with the
kernels' sources. The tasks are also replayed in torch on the plain
version and held to ``kernels/ref.py::gather_dist`` and to the JAX
package's gather.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import gather_distance as gd
from repro_torch.kernels import ref

CSRC = gd._build.CSRC

# (B, M, layout, d): the main path's launches and the card tests' regimes
PATH_SHAPES = [
    (32768, 64, "f32", 128),     # the 1M build's sibling search
    (4096, 64, "f32", 1024),     # the lm build's
    (32768, 3, "f32", 128),      # the build's entries
    (1000, 3, "f32", 128),       # the search's entries
    (1000, 64, "f32", 128),      # the composed hop at the frontier
    (1000, 64, "pq", 128),
    (1000, 64, "int8", 128),
    (64, 64, "f32", 1024),       # the server's batch
    (64, 3, "f32", 1024),
]
GRID = [(B, M, lay, d) for B in (1, 64, 4097) for M in (3, 37, 64)
        for lay in gd.LAYOUTS for d in (13, 24, 128, 1024)]


def tasks(p, B, M):
    """The (query row, slot) items of each warp's task, as the kernel forms
    them: task w is query row w // split, slots (w % split) * slots on."""
    out = []
    for w in range(p.grid * p.warps):
        b, j0 = w // p.split, (w % p.split) * p.slots
        if b >= B:
            continue
        out.append([(b, j) for j in range(j0, min(j0 + p.slots, M))])
    return out


@pytest.mark.parametrize("B,M,layout,d", PATH_SHAPES + GRID[::7])
def test_plan_covers_every_item_once(B, M, layout, d):
    p = gd.plan(B, M, layout, d, True)
    cells = tasks(p, B, M)
    flat = [it for t in cells for it in t]
    assert sorted(flat) == [(b, j) for b in range(B) for j in range(M)]
    assert all(0 < len(t) <= gd.MAX_SLOTS for t in cells)
    assert p.warps == gd.WARPS and p.grid * p.warps >= B * p.split
    assert p.smem == gd.gather_smem(d, p.slots) <= gd.SMEM_LIMIT
    assert p.rows == gd.rows_in_flight(layout, p.vpl)


def test_plan_at_the_path_shapes():
    f32 = lambda B, M, d: gd.plan(B, M, "f32", d, True)  # noqa: E731
    # the 1M build and its entries: one query row a task
    for M in (64, 3):
        p = f32(32768, M, 128)
        assert (p.split, p.slots) == (1, M)
    assert f32(32768, 64, 128).rows == 4 and f32(4096, 64, 1024).rows == 1
    # the lm build: 4,096 query rows fill one wave
    assert f32(4096, 64, 1024).split == 1
    # the frontier and the server: a query row's slots over 4 and 16
    # tasks, within one wave
    assert (f32(1000, 64, 128).split, f32(1000, 64, 128).slots) == (4, 16)
    assert (f32(64, 64, 1024).split, f32(64, 64, 1024).slots) == (16, 4)
    for B, d in ((1000, 128), (64, 1024)):
        p = f32(B, 64, d)
        assert gd.SMS * 4 <= B * p.split <= gd.TASKS
    # the search's entries: too few slots to split
    assert f32(1000, 3, 128).split == 1

@pytest.mark.parametrize("layout,d,vec,vpl", [
    ("f32", 128, True, 1), ("f32", 1024, True, 8), ("bf16", 1024, True, 8),
    ("int8", 128, True, 1), ("f32", 256, True, 0), ("f32", 128, False, 0),
    ("f32", 13, False, 0), ("pq", 128, True, 0), ("pq", 1024, True, 0)])
def test_row_width_instantiation(layout, d, vec, vpl):
    assert gd.vpl_of(layout, d, vec) == vpl


def test_mirrored_constants_match_the_sources():
    """The row width's instantiation, rows_in_flight, the warp counts and
    both shared-memory formulas are written twice, in Python for the plan
    and in C++, where the entries derive them from the table: a drift
    would split a query row's slots by the wrong floor, or let a launch
    that cannot fit past the plan's ValueError."""
    common = (CSRC / "common.cuh").read_text()
    assert re.search(r"kMaxWarps = (\d+);", common).group(1) == \
        str(gd.MAX_WARPS)
    assert re.search(r"kMinWarpsPerSM = (\d+);", common).group(1) == \
        str(gd.WARPS_PER_SM)
    assert gd.VPLS == (1, 8)
    assert "return d / 128 == 1 || d / 128 == 8 ? d / 128 : 0;" in common
    body = re.search(r"constexpr int rows_in_flight\(\) \{(.*?)\n\}",
                     common, re.S).group(1)
    assert "unit = LAYOUT == kF32 ? 4 : 2;" in body
    assert "16 / ((VPL > 0 ? VPL : 1) * unit)" in body
    assert "LAYOUT == kPQ || VPL == 0 ? 4 : fit < 1 ? 1 : fit > 8 ? 8 : fit" \
        in body
    want = {("f32", 1): 4, ("f32", 8): 1, ("bf16", 1): 8, ("bf16", 8): 1,
            ("f16", 1): 8, ("f16", 8): 1, ("int8", 1): 8, ("int8", 8): 1}
    for lay in gd.LAYOUTS:
        for vpl in (0, 1, 8):
            assert gd.rows_in_flight(lay, vpl) == want.get((lay, vpl), 4)
    gather = (CSRC / "gather_distance.cu").read_text()
    assert re.search(r"kWarps = (\d+);", gather).group(1) == str(gd.WARPS)
    assert "kWarps) * (dp + ((2 * slots + 3) & ~3)) * 4" in gather
    assert gd.gather_smem(13, 3) == 4 * (16 + 8) * 4
    hop = (CSRC / "hop.cu").read_text()
    assert "WM * 16 + static_cast<size_t>(W) * 32 * 4 + 4" in hop
    assert gd.hop_smem(1024, 4, 336, 16) == \
        1024 * 4 + 16 + 4 * 336 * 4 + 64 * 16 + 4 * 128 + 4


@pytest.mark.parametrize("B,W,K,m_out,d,warps", [
    (1000, 4, 336, 16, 128, 4), (64, 4, 288, 16, 1024, 16),
    (7, 3, 40, 8, 24, 16), (300, 3, 40, 40, 13, 4)])
def test_hop_plan(B, W, K, m_out, d, warps):
    p = gd.plan(B, W * m_out, "f32", d, True, hop=(W, K))
    assert (p.split, p.slots, p.grid) == (1, W * m_out, B)
    assert p.warps == warps and W * m_out <= 32 * p.warps
    assert p.smem == gd.hop_smem(d, W, K, m_out)


def test_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        gd.plan(8, 64, "f32", 15000, True)
    with pytest.raises(ValueError, match="hop"):
        gd.plan(8, 64 * 16, "f32", 128, True, hop=(64, 336))
    with pytest.raises(ValueError, match="hop"):
        gd.plan(8, 64, "f32", 128, True, hop=(4, 20000))
    gd.plan(8, 64, "f32", 8192, True)  # chameleon-34b's width fits


def test_rows_vec_mirrors_alignment():
    x = torch.zeros((10, 128))
    a = gd.TableArgs("f32", x, None, 10, 128, 0)
    assert gd.rows_vec(a)
    assert not gd.rows_vec(a._replace(data=x.view(-1)[1:]))
    assert not gd.rows_vec(a._replace(d=13))
    h = torch.zeros((10, 128), dtype=torch.bfloat16)
    assert gd.rows_vec(gd.TableArgs("bf16", h, None, 10, 128, 0))
    assert not gd.rows_vec(gd.TableArgs("bf16", h.view(-1)[2:], None, 10,
                                        128, 0))
    book = torch.zeros((32, 256, 4))
    pq = gd.TableArgs("pq", torch.zeros((10, 32), dtype=torch.uint8), book,
                      10, 128, 32)
    assert gd.rows_vec(pq)
    assert not gd.rows_vec(pq._replace(d=96))


@pytest.mark.parametrize("B,M,d", [(5, 37, 24), (64, 64, 128), (600, 3, 16),
                                   (3, 64, 13)])
def test_tiles_replayed_give_the_plain_version_and_jax(B, M, d):
    """Each task's items computed alone, in the kernel's grouping, fill
    every output and give the plain version's values (to 1e-5: torch sums
    a smaller batch in another grouping), and those agree with the JAX
    package's gather (its jnp reference) to 1e-5."""
    rng = np.random.default_rng(B * M + d)
    n = 300
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    ids = rng.integers(-1, n, (B, M)).astype(np.int32)
    ids[0] = -1
    xt, qt, it = map(torch.from_numpy, (x, q, ids))
    want = ref.gather_dist(qt, xt, it)
    got = torch.full((B, M), float("nan"))
    p = gd.plan(B, M, "f32", d, d % 4 == 0)
    for cell in tasks(p, B, M):
        b = torch.tensor([c[0] for c in cell])
        j = torch.tensor([c[1] for c in cell])
        got[b, j] = ref.gather_dist(qt[b], xt, it[b, j][:, None])[:, 0]
    assert not bool(got.isnan().any())
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    jax_out = np.asarray(jref.gather_dist(jnp.asarray(q), jnp.asarray(x),
                                          jnp.asarray(ids)))
    fin = np.isfinite(jax_out)
    np.testing.assert_array_equal(fin, torch.isfinite(got).numpy())
    np.testing.assert_allclose(got.numpy()[fin], jax_out[fin], rtol=1e-5,
                               atol=1e-5)
