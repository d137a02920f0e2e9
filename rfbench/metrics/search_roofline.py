"""The bytes the window's searches need (``yardstick.search_bytes``) over
the summed wall time of ``search_ranks`` at the published 3.35 TB/s, in
percent. On the card only. The ids in the count are an upper bound, so
the share is too."""
from rfbench import yardstick


def read(ctx):
    if ctx.device_type != "cuda" or not ctx.rec or not ctx.rec.searches:
        return None
    wall = sum(s.t1 - s.t0 for s in ctx.rec.searches) / 1e9
    return yardstick.roofline_pct(ctx.bytes_of(ctx.rec.searches), wall)
