"""Summed seconds of the build's levels of kind "search" (sibling beam
searches, then the prune), from ``level_times``."""


def read(ctx):
    if not ctx.level_times:
        return None
    return sum(t["seconds"] for t in ctx.level_times
               if t["kind"] == "search")
