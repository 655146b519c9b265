"""The walk: the best slot's backpointers followed from the last frame to
the first, one int32 read a live frame, and the hypothesis written once.
No float operations: the bytes bind."""


def cost(frames: int, rows: int, max_len: int):
    return 0.0, 4.0 * (frames + rows * max_len)
