"""Shared model layers: RMS norm, RoPE, embedding lookup, softcap, the
output projection and the next-token cross-entropy losses (port of
``repro/models/layers.py``).

On a mesh (DTensor activations) the lookup and the logits are constrained
as ``repro``'s; the lookup picks each rank's vocab slice in a
``local_map`` region (``_lookup_on_mesh``), the output projection is
``partitioning.local_linear`` (each rank's batch over its vocab slice),
and the CE runs on each rank's block of the vocab-sharded logits in a
``local_map`` region (``_nll_on_mesh``): the max, the exp-sum and the
target's logit reduce across the vocab's ranks, and the gradient of a
rank's logits is its own, so no rank gathers the vocab and the
collectives are the region's, not DTensor's choice.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import partitioning as part
from repro_torch.sharding.partitioning import ParamDef, constrain, \
    is_dtensor

__all__ = ["rms_norm", "rms_norm_def", "rope", "linear", "embed_def",
           "embed_lookup", "logits", "softcap", "cross_entropy",
           "chunked_cross_entropy"]


def rms_norm_def(d):
    return {"scale": ParamDef((d,), (None,), init="ones")}


def rms_norm(p, x, eps=1e-6):
    """RMS norm over the last dim, in f32, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def rope(x, positions, theta=10000.0):
    """x [B, S, H, Dh] or [B, S, Dh], rotated by absolute positions [S]
    (the two halves of the head dim as the real and imaginary parts)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs                 # [S, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == 4:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[None], sin[None]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def linear(x, w):
    """x [B, S, K] @ w [K, N] -> [B, S, N]: ``partitioning.local_linear``
    on a mesh."""
    if is_dtensor(w):
        return part.local_linear(x, w)
    return torch.einsum("bsd,df->bsf", x, w)


def embed_def(vocab, d):
    return {"table": ParamDef((vocab, d), ("vocab", "embed"))}


def embed_lookup(p, tokens, compute_dtype):
    """Rows of the table at ``tokens``, in ``compute_dtype``. Indexes
    first and casts the rows: the same values as casting the whole table
    first, as ``repro`` does, without a copy of it per call."""
    if is_dtensor(p["table"]):
        out = _lookup_on_mesh(p["table"], tokens).to(compute_dtype)
    else:
        out = p["table"][tokens].to(compute_dtype)
    return constrain(out, "batch", "seq", "act_embed")


def _lookup_on_mesh(table, tokens):
    """The lookup on a DTensor table [V, d] whose vocab may be split:
    the table gathered whole along d (FSDP's gather of a weight), then
    each rank picks the rows of its tokens that fall in its vocab slice,
    in a ``local_map`` region; the picks sum over the vocab's mesh dims
    (``Partial``), and the table's gradient, from each rank's own tokens,
    sums over the tokens' mesh dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    vocab = [i for i, pl in enumerate(table.placements) if pl == Shard(0)]
    if len(vocab) > 1:
        raise ValueError(f"table {table.placements}: the vocab on more than "
                         "one mesh dim")
    tp = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    table = table.redistribute(mesh, tp)
    if not is_dtensor(tokens):
        tokens = part.from_shard(tokens, mesh, (None,) * tokens.ndim,
                                 tokens.shape)
    kp = list(tokens.placements)
    if any(kp[i] != Replicate() for i in vocab) or any(
            pl != Replicate() and pl != Shard(0) for pl in kp):
        raise ValueError(f"tokens {tuple(kp)} on a table {tuple(tp)}: the "
                         "tokens may split over their batch only, off the "
                         "vocab's mesh dims")
    out_p = [Partial() if i in vocab else pl for i, pl in enumerate(kp)]
    grad_p = [pl if i in vocab else (Partial() if kp[i] == Shard(0)
                                     else Replicate())
              for i, pl in enumerate(tp)]

    def local(tab, tok):
        lo = mesh.get_local_rank(vocab[0]) * tab.shape[0] if vocab else 0
        idx = tok.long() - lo
        ok = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[idx.clamp(0, tab.shape[0] - 1)]
        return torch.where(ok[..., None], rows,
                           torch.zeros((), dtype=tab.dtype, device=tab.device))

    return local_map(local, out_placements=out_p, in_placements=(tp, kp),
                     in_grad_placements=(grad_p, kp),
                     device_mesh=mesh)(table, tokens)


def softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def logits(embed_p, head_p, x, cfg):
    """x [..., d] -> [..., padded_vocab] in x's dtype: the tied embedding
    table (``cfg.tie_embeddings``) or ``head/w``, then
    ``cfg.logit_softcap``."""
    w = embed_p["table"] if cfg.tie_embeddings else head_p["w"]
    out = _vocab_logits(x, w.to(x.dtype)) if is_dtensor(w) and x.ndim == 3 \
        else torch.einsum("...d,vd->...v", x, w.to(x.dtype))
    out = softcap(out, cfg.logit_softcap)
    return constrain(out, "batch", "seq", "act_vocab")


def _ce_terms(logits, targets, vocab, padded_vocab):
    """(sum of the masked NLL, count of targets >= 0), both f32 scalars:
    :func:`_nll_rows`, on DTensor logits in :func:`_nll_on_mesh`."""
    if is_dtensor(logits):
        nll = _nll_on_mesh(logits, targets, vocab, padded_vocab)
    else:
        nll = _nll_rows(logits, targets, 0, vocab, padded_vocab, ())
    mask = (targets >= 0).float()
    return (nll * mask).sum(), mask.sum()


def _nll_rows(lg, targets, lo, vocab, padded_vocab, groups):
    """Each row's NLL, f32 [...], from ``lg`` [..., V], the logits of the
    slice ``[lo, lo + V)`` of the padded vocab; ``groups``: the process
    groups the vocab is split over (none: ``lg`` holds it all). The
    logits stay in their dtype, the max and the exp-sum accumulate in
    f32, the padded tail is pushed out by a -1e30 bias in that dtype.
    Over a split vocab the max is taken across the groups without a
    gradient (its terms cancel), and the exp-sum and the target's logit
    (0 on the ranks whose slice lacks it) are summed across them."""
    ct = lg.dtype
    V = lg.shape[-1]
    if padded_vocab != vocab:
        pad = (torch.arange(lo, lo + V, device=lg.device) >= vocab).to(ct)
        lg = lg - pad * torch.tensor(1e30, dtype=ct, device=lg.device)
    m = lg.amax(dim=-1).float()
    if groups:
        m = _all_reduce(m.detach(), "max", groups)
    ex = torch.exp(lg - m[..., None].to(ct))
    logz = m + torch.log(
        _sum_across(ex.sum(dim=-1, dtype=torch.float32), groups))
    idx = targets.clamp_min(0).long() - lo
    ok = (idx >= 0) & (idx < V)
    gold = torch.gather(lg, -1, idx.clamp(0, V - 1)[..., None])[..., 0]
    gold = torch.where(ok, gold, torch.zeros((), dtype=ct, device=lg.device))
    return logz - _sum_across(gold.float(), groups)


def _all_reduce(t, op, groups):
    from torch.distributed import _functional_collectives as funcol

    for g in groups:
        t = funcol.all_reduce(t, op, g)
    return t


class _SumAcross(torch.autograd.Function):
    """The sum of ``t`` across ``groups``; its gradient is the output's,
    which every rank of the groups holds whole."""

    @staticmethod
    def forward(ctx, t, groups):
        return _all_reduce(t, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sum_across(t, groups):
    return _SumAcross.apply(t, groups) if groups else t


def _nll_on_mesh(logits, targets, vocab, padded_vocab):
    """:func:`_nll_rows` on each rank's block of DTensor logits [B, S, V]
    in a ``local_map`` region: the rows split as the logits' batch, the
    vocab on its own mesh dims, whose groups the region's reductions
    cross; the NLL [B, S] comes back split as the rows, whole on the
    vocab's dims. No rank gathers the vocab, in forward or backward."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    vocab_dims = [i for i, p in enumerate(logits.placements)
                  if p == Shard(vdim)]
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in logits.placements]
    lp = [Shard(vdim) if i in vocab_dims else p for i, p in enumerate(rows)]
    groups = [mesh.get_group(i) for i in vocab_dims if mesh.size(i) > 1]

    def fn(lg, tgt):
        lo = 0
        for i in vocab_dims:  # the vocab split outer mesh dim first
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
        return _nll_rows(lg, tgt, lo * lg.shape[-1], vocab, padded_vocab,
                         groups)

    if tuple(logits.placements) != tuple(lp):
        logits = logits.redistribute(mesh, lp)
    if tuple(targets.placements) != tuple(rows):
        targets = targets.redistribute(mesh, rows)
    return local_map(fn, out_placements=rows, in_placements=(lp, rows),
                     device_mesh=mesh)(logits, targets)


def _vocab_logits(x, w):
    """x [B, S, d] @ w [V, d]^T -> [B, S, V]; on a mesh as
    ``partitioning.local_linear`` (the vocab split kept: each rank makes
    its batch's logits over its vocab slice)."""
    if not is_dtensor(w):
        return torch.einsum("bsd,vd->bsv", x, w)
    return part.local_linear(x, w.t())


def cross_entropy(logits, targets, vocab, padded_vocab):
    """Masked next-token CE of ``logits`` [B, S, padded_vocab] (in the
    compute dtype) against ``targets`` int [B, S]; targets of -1 are
    ignored. Returns the mean over the counted targets, f32."""
    tot, cnt = _ce_terms(logits, targets, vocab, padded_vocab)
    return tot / cnt.clamp_min(1.0)


def chunked_cross_entropy(w, hidden, targets, cfg, *, chunk=512):
    """CE fused with the output projection ``w`` [padded_vocab, d] (the
    tied embedding or ``head/w``), a chunk of ``chunk`` positions at a
    time: each chunk's [B, chunk, V] logits are made, reduced and, under
    autograd, recomputed in backward (``torch.utils.checkpoint``, as
    ``repro``'s ``@jax.checkpoint``), so one chunk's logits live at a
    time. When ``chunk`` does not divide S the full logits are made."""
    B, S, d = hidden.shape
    ct = hidden.dtype
    Sc = min(chunk, S)
    if S % Sc:
        return cross_entropy(
            softcap(_vocab_logits(hidden, w.to(ct)), cfg.logit_softcap),
            targets, cfg.vocab, cfg.padded_vocab)

    def body(xb, tb, w):
        lg = softcap(_vocab_logits(xb, w.to(ct)), cfg.logit_softcap)
        # on a mesh: batch over the data axes, the vocab over model
        lg = constrain(lg, "batch", "seq", "act_vocab")
        return _ce_terms(lg, tb, cfg.vocab, cfg.padded_vocab)

    grad = torch.is_grad_enabled()
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, S, Sc):
        xb, tb = hidden[:, s:s + Sc], targets[:, s:s + Sc]
        t, c = (checkpoint(body, xb, tb, w, use_reentrant=False) if grad
                else body(xb, tb, w))
        tot, cnt = tot + t, cnt + c
    return tot / cnt.clamp_min(1.0)
