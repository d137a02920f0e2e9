"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of the tiny cell on the CPU with one fault
planted in the program: a search step that returns its state unchanged,
half of each batch left out (its rows answered with the others'
answers), and an answer altered where it is produced. The cell runs on
one chip, so there is no exchange between chips to leave out.
"""
from __future__ import annotations

import torch
from conftest import TINY_CELL

from rfbench.cell import run_cell


def _run(root):
    return run_cell(root, TINY_CELL, 424242, 0.5, False, torch.device("cpu"),
                    log=lambda msg: None)


def test_sound_run_is_correct(tiny_root):
    assert _run(tiny_root)["correct"] is True


def test_a_hop_that_leaves_the_state_unchanged(tiny_root, monkeypatch):
    from repro_torch.kernels import ops

    def stuck(q, table, nbrs, u, L, R, visited, exp_ok, **kw):
        B, W = u.shape
        M = kw["m_out"]
        return (torch.full((B, W * M), -1, dtype=torch.int32),
                torch.full((B, W * M), torch.inf),
                torch.zeros((B, W * M), dtype=torch.bool), visited)

    monkeypatch.setattr(ops, "hop", stuck)
    r = _run(tiny_root)
    assert r["correct"] is False
    assert r["checks"]["recall_at_10"]["value"] < 0.15


def test_half_of_the_batch_left_out(tiny_root, monkeypatch):
    from repro_torch.core import search as search_mod

    inner = search_mod.search_improvised

    def half(vectors, nbrs, queries, L, R, **kw):
        h = max(1, queries.shape[0] // 2)
        res = inner(vectors, nbrs, queries[:h], L[:h], R[:h], **kw)
        rep = torch.arange(queries.shape[0]) % h
        return search_mod.SearchResult(*(x[rep] for x in res))

    monkeypatch.setattr(search_mod, "search_improvised", half)
    r = _run(tiny_root)
    assert r["correct"] is False
    assert r["checks"]["out_of_range"]["value"] > 0


def test_an_answer_altered_where_it_is_produced(tiny_root, monkeypatch):
    from repro_torch.core import search as search_mod

    inner = search_mod.search_improvised

    def altered(*a, **kw):
        res = inner(*a, **kw)
        ids = res.ids.clone()
        ids[:, 0] = torch.where(ids[:, 0] >= 0, ids[:, 0] ^ 1, ids[:, 0])
        return res._replace(ids=ids)

    monkeypatch.setattr(search_mod, "search_improvised", altered)
    r = _run(tiny_root)
    assert r["correct"] is False
    assert r["checks"]["dist_gap"]["value"] > 1e-3
