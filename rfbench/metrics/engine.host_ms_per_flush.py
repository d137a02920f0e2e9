"""Per flush, the wall time of ``ServingEngine.flush`` less that of the
``SearchExecutor.search_ranks`` call under it, averaged over the window
(the benchmark's spans)."""


def read(ctx):
    return ctx.rec.host_ms_per_flush() if ctx.rec else None
