"""launches.fold-short: device kernel launches a request over the traced pass (the profiler's count)."""


def read(ctx):
    return ctx.launches_per_item()
