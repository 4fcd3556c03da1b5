"""idle_share.fold-short: 1 - device busy time (union of device intervals) over the pass's wall time."""


def read(ctx):
    return ctx.idle_share_pct()
