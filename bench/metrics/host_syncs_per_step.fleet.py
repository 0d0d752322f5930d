"""Synchronising calls the run loop makes a step: the calls that
``torch.cuda.set_sync_debug_mode`` flags over the traced chunks, over the
steps they hold."""


def read(ctx):
    return ctx.counters["host_syncs"] / ctx.trace.steps
