"""K2 (``event_topk``): the ``k`` earliest of ``n`` float32 completion
times. Work: a comparison an entry, no arithmetic counted; bytes: the
times read once, ``k`` float32 times and ``k`` int64 indices written."""


def cost(n: int, k: int):
    """(FLOPs, bytes) of one call."""
    return 0, 4 * n + 12 * k
