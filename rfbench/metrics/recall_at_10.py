"""Mean over every answer of the window: returned ids in the exact
in-range top-10, over min(10, the range's size) (``judge.py``)."""


def read(ctx):
    return ctx.numbers["recall_at_10"] if ctx.answered else None
