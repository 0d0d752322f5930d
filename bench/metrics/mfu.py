"""``mfu.<cell>`` of an FL cell (an LM cell has a reader of its own): the
cohorts' local training FLOPs in the window (admitted clients' SGD steps,
``cost/cnn.py``) over the window's host-clock length, as a share of the
H100's TF32 peak: the highest rate at which the float32 CNN may run with
cuDNN's TF32 on."""


def read(ctx):
    flops = ctx.work["trained_examples"] * ctx.cost("cnn").cost(ctx.spec.config)
    return 100.0 * (flops / ctx.work["window_s"] / ctx.peaks["tf32_flops"])
