"""The bytes the profiled stretch's searches need, less the entry
points' rows (``yardstick.hop_bytes``), over the hop kernel's device time
in that stretch (``torch.profiler``) at the published 3.35 TB/s, in
percent. The ids in the count are an upper bound, so the share is too."""
from rfbench import yardstick


def read(ctx):
    st = ctx.stretch
    if not st or not st.get("hop_s"):
        return None
    return yardstick.roofline_pct(ctx.hop_bytes_of(st["searches"]),
                                  st["hop_s"])
