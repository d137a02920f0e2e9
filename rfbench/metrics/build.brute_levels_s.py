"""Summed seconds of the build's levels of kind "brute" (whole segments
as candidates, then the prune), from ``level_times``."""


def read(ctx):
    if not ctx.level_times:
        return None
    return sum(t["seconds"] for t in ctx.level_times
               if t["kind"] == "brute")
