"""The port's mesh half against ``repro``'s, on the CPU.

Held here:

  * ``Model.param_specs`` of every architecture on both production meshes
    equal ``repro``'s spec for spec, and every local shard shape equals
    ``jax.sharding.NamedSharding(...).shard_shape`` (``repro``'s side on
    ``jax.sharding.AbstractMesh``, which needs no devices);
  * ``launch/specs.py``'s ``input_specs`` and ``input_shardings`` (the
    decode caches' leaf-path rules included) in every (arch x shape) cell,
    on both meshes, likewise; ``skip_reason`` agrees;
  * on a real 2 x 2 mesh of four gloo ranks (spawned, one torch thread
    each, weights carried from one numpy tree by ``params_from_numpy``),
    a reduced dense, MoE, Mamba2 hybrid and xLSTM config: the loss, every
    gradient and the prefill logits equal ``repro``'s meshless results
    within 1e-5 (gradients and logits: of their max-abs);
  * decode on gloo meshes, from the port's meshless prefill cache laid out
    by ``cache_shardings``, against ``repro``'s meshless decode from the
    same cache: four steps' logits and the final cache within 1e-5 of
    their max-abs, for a cache whose positions split over ``data``
    (``seq_shard=True``), the Mamba2 and xLSTM caches that
    ``partitioning.batch_local`` writes back, and a GQA config whose 2 KV
    heads do not divide a 4-wide ``model`` axis (q's heads split, k/v
    whole: flash takes each rank's KV heads; the cache's positions split
    over ``model``), whose loss, gradients and prefill logits are held
    too;
  * ``constrain`` returns its input object outside a mesh, and for a
    plain tensor inside one;
  * a checkpoint written by ``launch/train.py --mesh 1x1`` (one gloo rank)
    is the same bytes as one written without a mesh.

``repro`` and JAX are imported inside the tests only: each spawned rank
imports this module.
"""
import dataclasses
import datetime
import multiprocessing
import os
import queue
import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.models import api
from repro_torch.sharding import partitioning as part

MESHES = {"16x16": PRODUCTION_SHAPES[False],
          "2x16x16": PRODUCTION_SHAPES[True]}
NUMERIC_ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m", "zamba2-1.2b",
                 "xlstm-125m")
B, S = 4, 32
RANK_TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _abstract(shape: dict):
    from jax.sharding import AbstractMesh

    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _spec(p) -> tuple:
    """A ``PartitionSpec`` or a port spec as a tuple, trailing Nones off."""
    t = tuple(p)
    while t and t[-1] is None:
        t = t[:-1]
    return t


def _pairs(jtree, ttree, path=()):
    """(path, repro leaf, port leaf) over two congruent dict trees; a None
    subtree on the port's side is no leaf, as in a JAX tree."""
    if isinstance(ttree, dict):
        assert set(jtree) == {k for k, v in ttree.items() if v is not None}, \
            path
        for k, v in ttree.items():
            if v is not None:
                yield from _pairs(jtree[k], v, path + (k,))
        return
    yield path, jtree, ttree


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_repro(arch, mesh_name):
    from jax.sharding import NamedSharding as JNamedSharding

    from repro.configs import ARCHS as JARCHS
    from repro.models import api as japi

    shape = MESHES[mesh_name]
    jmesh = _abstract(shape)
    jspecs = japi.Model(JARCHS[arch]).param_specs(jmesh)
    model = api.Model(ARCHS[arch])
    tspecs_ = model.param_specs(shape)
    tshard = model.param_shardings(shape)
    defs = dict(part.leaves(model.defs()))
    n = 0
    for path, js, ts in _pairs(jspecs, tspecs_):
        assert _spec(js) == _spec(ts), (path, js, ts)
        sh = defs[path].shape
        want = JNamedSharding(jmesh, js).shard_shape(sh)
        assert part.NamedSharding(shape, ts).shard_shape(sh) == want, path
        assert dict(part.leaves(tshard))[path].shard_shape(sh) == want
        n += 1
    assert n == len(defs)


def _shape_of(x):
    return tuple(x.shape)


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_and_cache_shardings_match_repro(arch, shape_name):
    from jax.sharding import NamedSharding as JNamedSharding

    from repro.configs import ARCHS as JARCHS
    from repro.configs import SHAPES as JSHAPES
    from repro.launch import specs as jspecs_mod

    jcfg, tcfg = JARCHS[arch], ARCHS[arch]
    jin = jspecs_mod.input_specs(jcfg, JSHAPES[shape_name])
    tin = tspecs.input_specs(tcfg, SHAPES[shape_name])
    leaves_in = list(_pairs(jin, tin))
    for path, j, t in leaves_in:
        assert _shape_of(j) == _shape_of(t), path
        assert str(j.dtype) == str(t.dtype).removeprefix("torch."), path
    shapes = {path: _shape_of(t) for path, _, t in leaves_in}
    for name, mshape in MESHES.items():
        jmesh = _abstract(mshape)
        jsh = jspecs_mod.input_shardings(jcfg, JSHAPES[shape_name], jmesh)
        tsh = tspecs.input_shardings(tcfg, SHAPES[shape_name], mshape)
        got = list(_pairs(jsh, tsh))
        assert sorted(p for p, _, _ in got) == sorted(shapes)
        for path, j, t in got:
            assert _spec(j.spec) == _spec(t.spec), (name, path, j.spec, t)
            want = JNamedSharding(jmesh, j.spec).shard_shape(shapes[path])
            assert t.shard_shape(shapes[path]) == want, (name, path)


@pytest.fixture(scope="module")
def jdryrun():
    """``repro/launch/dryrun.py`` imported with the environment kept: it
    sets ``XLA_FLAGS`` when imported."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return dryrun


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_skip_reason_matches_repro(arch, jdryrun):
    for shape in SHAPES:
        assert tdryrun.skip_reason(arch, shape) == \
            jdryrun.skip_reason(arch, shape), (arch, shape)


def test_constrain_outside_a_mesh_returns_its_input():
    x = torch.ones(4, 8)
    assert part.constrain(x, "batch", "act_embed") is x
    assert part.global_mesh() is None
    with part.use_global_mesh({"data": 2, "model": 2}):
        assert part.constrain(x, "batch", "act_embed") is x


def test_logical_to_spec_falls_back_and_first_dim_wins():
    mesh = {"pod": 2, "data": 16, "model": 16}
    # xlstm's 4 heads do not divide 16: replicated
    assert part.logical_to_spec(("heads",), mesh, (4,)) == (None,)
    # expert and mlp both map to model: the first dim takes it
    assert part.logical_to_spec(("expert", "embed", "mlp"), mesh,
                                (32, 1024, 512)) == ("model", "data", None)
    assert part.logical_to_spec(("batch", None), mesh, (64, 3)) == \
        (("pod", "data"), None)
    assert part.logical_to_spec(("batch",), mesh, (16,)) == (None,)


# ---------------------------------------------------------------------------
# numerics on four gloo ranks
# ---------------------------------------------------------------------------

def _flat(tree):
    return {"/".join(p): v for p, v in part.leaves(tree)}


def _nest(flat):
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _mesh_rank(rank, root, out):
    """One rank of the 2 x 2 mesh: for each config, the loss, gradients
    and prefill logits of the carried weights on the mesh; rank 0 writes
    them whole."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.step import loss_and_grads

    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(root, "store"), 4),
            rank=rank, world_size=4, timeout=datetime.timedelta(seconds=30))
        mesh = make_local_mesh(2, 2, device="cpu")
        data = np.load(os.path.join(root, "batch.npz"))
        for arch in NUMERIC_ARCHS:
            model = api.Model(ARCHS[arch].reduced())
            tree = _nest(dict(np.load(os.path.join(root, f"{arch}.npz"))))
            params = api.params_from_numpy(model, tree, device="cpu")
            with part.use_global_mesh(mesh):
                dp = part.shard_tree(params, model.param_specs(mesh), mesh)
                tok = part.shard_tensor(torch.as_tensor(data["tokens"]),
                                        mesh, ("data", None))
                tgt = part.shard_tensor(torch.as_tensor(data["targets"]),
                                        mesh, ("data", None))
                loss, _, grads = loss_and_grads(
                    model, dp, {"tokens": tok, "targets": tgt})
                logits, _ = model.prefill(dp, tokens=tok)
                res = {"loss": loss.full_tensor().numpy(),
                       "logits": logits.full_tensor().numpy()}
                res.update({"grad/" + k: v.full_tensor().numpy()
                            for k, v in _flat(grads).items()})
                placed = [(type(pl).__name__, getattr(pl, "dim", None))
                          for pl in dp["embed"]["table"].placements]
            if rank == 0:
                np.savez(os.path.join(root, f"out_{arch}.npz"), **res)
        out.put((rank, placed, None))
    except Exception:
        out.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_loss_grads_prefill_on_a_2x2_gloo_mesh_match_repro(tmp_path):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as JARCHS
    from repro.models import api as japi

    from test_torch_families import numpy_params

    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    tgts = rng.integers(0, 256, (B, S)).astype(np.int32)
    np.savez(tmp_path / "batch.npz", tokens=toks, targets=tgts)
    trees = {}
    for arch in NUMERIC_ARCHS:
        trees[arch] = numpy_params(api.Model(ARCHS[arch].reduced()), seed=5)
        np.savez(tmp_path / f"{arch}.npz", **_flat(trees[arch]))

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank, args=(r, str(tmp_path), out))
             for r in range(4)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(4):
            rank, placed, err = out.get(timeout=RANK_TIMEOUT_S)
            assert err is None, f"rank {rank}:\n{err}"
            got[rank] = placed
    except queue.Empty:
        pytest.fail(f"ranks {sorted(set(range(4)) - set(got))} gave no "
                    f"answer within {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    # the embedding table [vocab, embed]: embed over data (mesh dim 0),
    # the vocab over model (mesh dim 1), on every rank
    assert all(v == [("Shard", 1), ("Shard", 0)] for v in got.values()), got

    for arch in NUMERIC_ARCHS:
        jm = japi.Model(dataclasses.replace(JARCHS[arch].reduced(),
                                            attention_impl="xla"))
        jp = jax.tree.map(jnp.asarray, trees[arch])
        batch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, batch)[0]))(jp)
        logits, _ = jax.jit(lambda p: jm.prefill(p, tokens=batch["tokens"])
                            )(jp)
        res = np.load(tmp_path / f"out_{arch}.npz")
        np.testing.assert_allclose(res["loss"], np.asarray(loss), rtol=1e-5,
                                   err_msg=arch)
        want = np.asarray(logits)
        assert np.abs(res["logits"] - want).max() <= \
            1e-5 * max(1.0, np.abs(want).max()), arch
        jg = _flat(jax.tree.map(np.asarray, grads))
        assert {"grad/" + k for k in jg} == \
            {k for k in res.files if k.startswith("grad/")}
        worst = 0.0
        for k, want in jg.items():
            have = res["grad/" + k]
            err = np.abs(have - want).max() / max(1e-3, np.abs(want).max())
            assert err <= 1e-5, (arch, k, err)
            worst = max(worst, err)
        lerr = np.abs(res["logits"] - np.asarray(logits)).max()
        print(f"{arch}: loss {float(res['loss'])} vs {float(loss)}, "
              f"logits max abs {lerr:.3g}, worst gradient error "
              f"{worst:.3g} of its max-abs")


# name, arch, config overrides, (data, model), batch, seq_shard
DECODE_CASES = (
    ("gqa-1x4", "qwen3-0.6b", {"n_kv_heads": 2}, (1, 4), B, False),
    ("seq-2x2", "qwen3-0.6b", {}, (2, 2), 1, True),
    ("zamba2-2x2", "zamba2-1.2b", {}, (2, 2), B, False),
    ("xlstm-2x2", "xlstm-125m", {}, (2, 2), B, False),
)
PREFILL, GROWN, STEPS = 16, 24, 4   # PREFILL: a multiple of ssm_chunk


def _decode_cfg(archs, arch, over):
    return dataclasses.replace(archs[arch].reduced(), **over)


def _run_ranks(target, root):
    """Four spawned gloo ranks running ``target(rank, root, out)``; their
    answers by rank."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, root, out))
             for r in range(4)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(4):
            rank, ans, err = out.get(timeout=RANK_TIMEOUT_S)
            assert err is None, f"rank {rank}:\n{err}"
            got[rank] = ans
    except queue.Empty:
        pytest.fail(f"ranks {sorted(set(range(4)) - set(got))} gave no "
                    f"answer within {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    return got


def _decode_rank(rank, root, out):
    """One rank: for each decode case, the meshless prefill cache grown to
    GROWN positions (saved by rank 0), laid out by ``cache_shardings``,
    then STEPS decode steps on the mesh; for the GQA case also the loss,
    gradients and prefill logits on the mesh. Rank 0 writes them whole."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import batch_axes, make_local_mesh
    from repro_torch.train.step import loss_and_grads

    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(root, "store"), 4),
            rank=rank, world_size=4, timeout=datetime.timedelta(seconds=30))
        data = np.load(os.path.join(root, "batch.npz"))
        places = {}
        for name, arch, over, (dm, mm), nb, seq_shard in DECODE_CASES:
            cfg = _decode_cfg(ARCHS, arch, over)
            model = api.Model(cfg)
            tree = _nest(dict(np.load(os.path.join(root, f"{name}.npz"))))
            params = api.params_from_numpy(model, tree, device="cpu")
            toks = torch.as_tensor(data["tokens"][:nb])
            _, caches = model.prefill(params, tokens=toks[:, :PREFILL])
            cache = model.grow_cache(caches, GROWN)
            res = {"cache0/" + k: v.numpy().copy()
                   for k, v in _flat(cache).items()}
            mesh = make_local_mesh(dm, mm, device="cpu")
            with part.use_global_mesh(mesh):
                dp = part.shard_tree(params, model.param_specs(mesh), mesh)
                sh = tspecs.cache_shardings(cfg, cache, mesh, nb,
                                            seq_shard=seq_shard)
                dc = part.shard_tree(cache, part.map_tree(
                    lambda s: s.spec, sh), mesh)
                tok_spec = (tspecs._maybe(mesh, batch_axes(mesh), nb), None)
                for t in range(STEPS):
                    tok = part.shard_tensor(
                        toks[:, PREFILL + t:PREFILL + t + 1], mesh, tok_spec)
                    logits, dc = model.decode(dp, tok, dc, PREFILL + t)
                    res[f"logits{t}"] = logits.full_tensor().numpy()
                res.update({"cache/" + k: v.full_tensor().numpy()
                            for k, v in _flat(dc).items()})
                if name.startswith("gqa"):
                    spec = ("data", None)
                    tok = part.shard_tensor(torch.as_tensor(data["tokens"]),
                                            mesh, spec)
                    tgt = part.shard_tensor(
                        torch.as_tensor(data["targets"]), mesh, spec)
                    loss, _, grads = loss_and_grads(
                        model, dp, {"tokens": tok, "targets": tgt})
                    logits, _ = model.prefill(dp, tokens=tok)
                    res["loss"] = loss.full_tensor().numpy()
                    res["prefill"] = logits.full_tensor().numpy()
                    res.update({"grad/" + k: v.full_tensor().numpy()
                                for k, v in _flat(grads).items()})
                places[name] = {k: tuple(str(pl) for pl in v.placements)
                                for k, v in _flat(dc).items()}
            if rank == 0:
                np.savez(os.path.join(root, f"out_{name}.npz"), **res)
        out.put((rank, places, None))
    except Exception:
        out.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _close(have, want, what):
    err = np.abs(have - want).max() / max(1e-3, np.abs(want).max())
    assert err <= 1e-5, (what, err)
    return err


def test_decode_and_gqa_on_gloo_meshes_match_repro(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as JARCHS
    from repro.models import api as japi

    from test_torch_families import numpy_params

    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    tgts = rng.integers(0, 256, (B, S)).astype(np.int32)
    np.savez(tmp_path / "batch.npz", tokens=toks, targets=tgts)
    trees = {}
    for name, arch, over, _, _, _ in DECODE_CASES:
        model = api.Model(_decode_cfg(ARCHS, arch, over))
        trees[name] = numpy_params(model, seed=6)
        np.savez(tmp_path / f"{name}.npz", **_flat(trees[name]))
    # the GQA case's q heads split over model while its KV heads stay
    # whole there, so flash takes the KV-slice branch
    gqa = api.Model(_decode_cfg(ARCHS, "qwen3-0.6b", {"n_kv_heads": 2}))
    mixer = gqa.param_specs({"data": 1, "model": 4})["blocks"]["mixer"]
    assert mixer["wq"][2] == "model" and mixer["wk"][2] is None

    got = _run_ranks(_decode_rank, str(tmp_path))
    # the KV caches [L, B, Hkv, S, Dh]: positions on model where the KV
    # heads cannot split (gqa-1x4), on data beside the heads on model
    # (seq-2x2); the recurrent states split their batch over data
    assert all(v == got[0] for v in got.values())
    assert got[0]["gqa-1x4"]["k"] == ("S(1)", "S(3)"), got[0]
    assert got[0]["seq-2x2"]["k"] == ("S(3)", "S(2)"), got[0]

    for name, arch, over, _, nb, _ in DECODE_CASES:
        jm = japi.Model(dataclasses.replace(
            _decode_cfg(JARCHS, arch, over), attention_impl="xla"))
        jp = jax.tree.map(jnp.asarray, trees[name])
        res = np.load(tmp_path / f"out_{name}.npz")
        jcache = jax.tree.map(jnp.asarray, _nest(
            {k[len("cache0/"):]: res[k] for k in res.files
             if k.startswith("cache0/")}))
        jdec = jax.jit(jm.decode)
        worst = 0.0
        for t in range(STEPS):
            tok = jnp.asarray(toks[:nb, PREFILL + t:PREFILL + t + 1])
            want, jcache = jdec(jp, tok, jcache, jnp.int32(PREFILL + t))
            worst = max(worst, _close(res[f"logits{t}"], np.asarray(want),
                                      (name, t)))
        for k, want in _flat(jax.tree.map(np.asarray, jcache)).items():
            worst = max(worst, _close(res["cache/" + k], want, (name, k)))
        if name.startswith("gqa"):
            batch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jm.loss(p, batch)[0]))(jp)
            logits, _ = jax.jit(lambda p: jm.prefill(
                p, tokens=batch["tokens"]))(jp)
            np.testing.assert_allclose(res["loss"], np.asarray(loss),
                                       rtol=1e-5)
            worst = max(worst, _close(res["prefill"], np.asarray(logits),
                                      (name, "prefill")))
            jg = _flat(jax.tree.map(np.asarray, grads))
            assert {"grad/" + k for k in jg} == \
                {k for k in res.files if k.startswith("grad/")}
            for k, want in jg.items():
                worst = max(worst, _close(res["grad/" + k], want, (name, k)))
        print(f"{name}: worst error {worst:.3g} of the max-abs")


def test_checkpoint_under_a_1x1_gloo_mesh_is_the_meshless_file(tmp_path):
    from repro_torch.launch import train

    argv = ["--arch", "qwen3-0.6b", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    meshed = train.main(argv + ["--mesh", "1x1",
                                "--ckpt-dir", str(tmp_path / "mesh")])
    plain = train.main(argv + ["--ckpt-dir", str(tmp_path / "plain")])
    assert meshed == plain
    a = (tmp_path / "mesh" / "step_2.ckpt").read_bytes()
    assert a == (tmp_path / "plain" / "step_2.ckpt").read_bytes()
    assert not torch.distributed.is_initialized()
