"""Requests answered in the window over the window's seconds (host
clock, from the first submit to the return of the last flush)."""


def read(ctx):
    return ctx.answered / ctx.window_s if ctx.window_s > 0 else None
