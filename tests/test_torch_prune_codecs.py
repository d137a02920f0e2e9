"""The prune on stored codec tables: the port against the JAX package's
Pallas kernel (its codec body, ``repro/kernels/prune.py:95-105``) in
interpret mode, on the CPU.

The port encodes the table (bit-identical to ``repro``'s encode) and both
sides prune the same candidates from it: ``repro`` through
``prune_kernel_call(interpret=True)``, which decodes the stored rows after
the row copy, and the port through ``ops.prune`` ("auto" on CPU tensors:
the plain version, decoding through ``storage.decode_rows``). On
well-separated data (no keep decision near a tie) the kept ids are
identical; the port's legacy and torch paths agree with each other too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import storage as jstorage
from repro.kernels import prune as jprune
from repro_torch.core import storage as tstorage
from repro_torch.kernels import ops as tops

CONFIGS = {
    "bf16": tstorage.StorageConfig.compact("bfloat16"),
    "f16": tstorage.StorageConfig.compact("float16"),
    "int8": tstorage.StorageConfig.int8(),
    "pq": tstorage.StorageConfig.pq(),
}


def _jax_table(enc):
    """The port's encoded table as ``repro``'s struct (same bits)."""
    if isinstance(enc, tstorage.Int8Vectors):
        return jstorage.Int8Vectors(jnp.asarray(enc.codes.numpy()),
                                    jnp.asarray(enc.scales.numpy()))
    if isinstance(enc, tstorage.PQVectors):
        return jstorage.PQVectors(jnp.asarray(enc.codes.numpy()),
                                  jnp.asarray(enc.codebook.numpy()))
    return jnp.asarray(tstorage.to_numpy(enc).view(np.uint16)).view(
        jnp.bfloat16) if enc.dtype == torch.bfloat16 \
        else jnp.asarray(enc.numpy())


def _problem(codec, n=256, d=16, B=8, C=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    enc = tstorage.encode_vectors(torch.from_numpy(x), CONFIGS[codec])
    dec = tstorage.decode_vectors(enc).numpy()
    node = rng.integers(0, n, size=B)
    cand = rng.integers(-1, n, size=(B, C)).astype(np.int32)
    cand[:, 5] = cand[:, 2]
    cand[cand == node[:, None]] = -1
    cvec = dec[np.maximum(cand, 0)]
    du = ((cvec - dec[node][:, None, :]) ** 2).sum(-1).astype(np.float32)
    du = np.where(cand >= 0, du, np.inf).astype(np.float32)
    return enc, cand, du


@pytest.mark.parametrize("codec", ["int8", "pq", "bf16"])
def test_codec_prune_matches_jax_kernel(codec):
    enc, cand, du = _problem(codec)
    want = jprune.prune_kernel_call(jnp.asarray(cand), jnp.asarray(du),
                                    _jax_table(enc), m=6, interpret=True)
    ids, dist = torch.from_numpy(cand), torch.from_numpy(du)
    tops.reset_launch_counts()
    got = tops.prune(ids, dist, enc, m=6)
    assert tops.launch_counts()["prune"] == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    legacy = tops.prune(ids, dist, enc, m=6, impl="legacy")
    assert torch.equal(legacy, got)


@pytest.mark.parametrize("codec", list(CONFIGS))
def test_codec_prune_equals_prune_on_decoded_rows(codec):
    """The codec table and its decoded f32 rows prune alike: the decode is
    the whole difference."""
    enc, cand, du = _problem(codec, seed=5, B=32, C=40, d=32)
    dec = tstorage.decode_vectors(enc)
    ids, dist = torch.from_numpy(cand), torch.from_numpy(du)
    for alpha, fill in ((1.0, True), (1.3, False)):
        assert torch.equal(
            tops.prune(ids, dist, enc, m=8, alpha=alpha, fill=fill),
            tops.prune(ids, dist, dec, m=8, alpha=alpha, fill=fill))
