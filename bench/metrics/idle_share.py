"""``idle_share.<cell>``: percent of the traced window in which no device
operation ran: 1 minus the union of the device intervals over the window
(``torch.profiler``)."""


def read(ctx):
    return 100.0 * ctx.trace.idle_share
