"""plain_ms.fold-long: device ms of the pass outside the port's hand-written kernels (kernels/*.json)."""


def read(ctx):
    return 1e3 * ctx.plain_device_s() if ctx.trace.device else None
