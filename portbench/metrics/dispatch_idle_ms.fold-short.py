"""dispatch_idle_ms.fold-short: the time inside the program's
`rf.predict.forward` spans with no device activity (the card waiting on
host dispatch), ms a request."""

from portbench import spans


def read(ctx):
    return spans.dispatch_idle_ms(ctx)
