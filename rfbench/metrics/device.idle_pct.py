"""100 x (1 - the union of device operations' intervals over the
profiled stretch of the window)."""


def read(ctx):
    st = ctx.stretch
    if not st or st["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["window_s"])
