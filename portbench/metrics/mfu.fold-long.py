"""mfu.fold-long: model FLOPs of the pass's requests over (wall time x the configuration's published peak)."""


def read(ctx):
    return ctx.mfu_pct()
