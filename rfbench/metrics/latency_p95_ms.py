"""The 95th percentile of the latency, submit to the return of the
request's result, over every request answered in the window."""
from rfbench import yardstick


def read(ctx):
    if not len(ctx.latencies):
        return None
    return 1e3 * yardstick.p95(ctx.latencies)
