"""favor_roofline.fold-long: the least time of the pass's FAVOR+ launches (counts.model) over their device time (kernel C-favor)."""


def read(ctx):
    return ctx.roofline_pct("C-favor", ctx.favor_bound_s)
