"""Wall seconds of ``RangeGraphIndex.build``, from vectors on the card to
a ready index, ending in a synchronise."""


def read(ctx):
    return ctx.build_s
