"""entry_ms.fold-long: the program's `rf.predict.featurize` and
`rf.predict.to_device` spans (A3M parse, featurize, host-to-device), ms a
request."""

from portbench import spans


def read(ctx):
    return spans.entry_ms(ctx)
