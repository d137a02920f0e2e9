"""Mean ``SearchResult.n_dists`` over the window's requests, from the
results of ``search_ranks``."""


def read(ctx):
    if not ctx.rec or not ctx.rec.searches:
        return None
    rows = sum(s.rows for s in ctx.rec.searches)
    return sum(s.n_dists for s in ctx.rec.searches) / rows
