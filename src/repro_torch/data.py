"""Deterministic synthetic data: the LM token stream and the RFANN
vectors, drawn with numpy.

Port-side copies of ``repro/data/pipeline.py::TokenPipeline`` (line 27)
and ``vector_dataset`` (line 78) and of
``benchmarks/common.py::make_workload`` (line 61): the same seeds give
the same arrays as the JAX package's, so a batch or a workload made here
and one made there are the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["TokenPipeline", "vector_dataset", "Workload", "make_workload"]


@dataclasses.dataclass
class TokenPipeline:
    """An endless seeded LM token stream: Zipfian unigrams with a bank of
    64 repeated 8-grams spliced in, so a small model has something to
    learn. Each batch is ``{"tokens", "targets"}`` int32 [batch, seq]
    (the targets the tokens shifted by one), plus ``"frames"`` f32
    [batch, seq, encdec_dim] when ``encdec_dim`` > 0 (the
    encoder-decoder's stub frontend)."""
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    encdec_dim: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._ngrams = self._rng.integers(
            0, self.vocab, size=(64, 8)).astype(np.int32)

    def next_batch(self, device=None) -> dict:
        """The next batch: numpy arrays, or tensors on ``device`` when one
        is given (``repro`` takes ``shardings=`` there)."""
        toks = self._rng.choice(
            self.vocab, size=(self.batch, self.seq + 1), p=self._probs
        ).astype(np.int32)
        for b in range(self.batch):
            for _ in range(max(1, self.seq // 64)):
                g = self._ngrams[self._rng.integers(0, len(self._ngrams))]
                pos = self._rng.integers(0, self.seq - len(g))
                toks[b, pos:pos + len(g)] = g
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.encdec_dim:
            batch["frames"] = self._rng.standard_normal(
                (self.batch, self.seq, self.encdec_dim)).astype(np.float32)
        if device is not None:
            batch = {k: torch.as_tensor(np.ascontiguousarray(v),
                                        device=device)
                     for k, v in batch.items()}
        return batch


def vector_dataset(
    n: int,
    dim: int,
    *,
    seed: int = 0,
    n_clusters: int = 64,
    attr_kind: str = "uniform",
    attr_vector_corr: float = 0.0,
    n_attrs: int = 1,
    queries: int = 0,
    labels: bool = False,
):
    """Clustered Gaussian-mixture vectors + attributes. Returns
    ``(vectors[n, dim], attrs[n, n_attrs], query_vectors or None)``, and
    with ``labels`` also each vector's cluster, ``int64[n]``."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 2.0
    assign = rng.integers(0, n_clusters, n)
    vectors = centers[assign] + rng.standard_normal((n, dim)).astype(
        np.float32
    )
    attrs = np.empty((n, n_attrs))
    for a in range(n_attrs):
        if attr_kind == "uniform":
            base = rng.uniform(0, 1e6, n)
        elif attr_kind == "clustered":
            base = (assign * 1000 + rng.uniform(0, 1000, n))
        elif attr_kind == "zipf":
            base = rng.zipf(1.5, n).astype(np.float64)
        else:
            raise ValueError(attr_kind)
        if attr_vector_corr > 0:
            # attribute correlates with the first principal direction
            proj = vectors @ centers[0] / np.linalg.norm(centers[0])
            base = (1 - attr_vector_corr) * base + attr_vector_corr * (
                (proj - proj.min()) / (np.ptp(proj) + 1e-9) * np.ptp(base)
            )
        attrs[:, a] = base
    qv = None
    if queries:
        qa = rng.integers(0, n_clusters, queries)
        qv = centers[qa] + rng.standard_normal((queries, dim)).astype(
            np.float32
        )
    if labels:
        return vectors, attrs, qv, assign
    return vectors, attrs, qv


@dataclasses.dataclass
class Workload:
    name: str
    L: np.ndarray
    R: np.ndarray
    queries: np.ndarray


def make_workload(index, kind: str, n_queries=128, seed=1) -> Workload:
    """Rank-space queries for ``index`` (anything with ``.n`` and ``.dim``).
    kind: ``'frac_<i>'`` (range fraction 2^-i) or ``'mixed'`` (i in 0..9)."""
    n, dim = index.n, index.dim
    rng = np.random.default_rng(seed)
    _, _, qv = vector_dataset(n, dim, seed=seed + 100, queries=n_queries)
    if kind.startswith("frac_"):
        i = int(kind.split("_")[1])
        spans = np.full(n_queries, max(n >> i, 8))
    else:
        fr = rng.integers(0, 10, n_queries)
        spans = np.maximum(n >> fr, 8)
    L = np.array([rng.integers(0, n - s + 1) for s in spans], np.int32)
    R = (L + spans - 1).astype(np.int32)
    return Workload(kind, L, R, qv)
