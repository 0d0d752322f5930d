"""K1 (``fedavg_reduce``): the weighted sum of a stack of ``rows`` client
vectors of ``cols`` float32 values. Work: 2 FLOPs a stack entry; bytes:
the stack and the weights read once, the sum written once."""


def cost(rows: int, cols: int):
    """(FLOPs, bytes) of one call."""
    return 2 * rows * cols, 4 * (rows * cols + rows + cols)
