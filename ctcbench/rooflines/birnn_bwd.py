"""B2, one direction of the delta sweep: d_t = (g_t + d_next W^T) where
0 < h_t < clip, over ``frames`` live (row, frame) pairs.  Operations: the
product 2 H^2 and the add and mask 2 H a frame.  Bytes: g and h read, d
written in the io dtype, W read once.  At the cells' widths the
operations bind."""


def cost(hidden: int, frames: int, io_bytes: int = 2, w_bytes: int = 2):
    flops = frames * (2.0 * hidden * hidden + 2.0 * hidden)
    nbytes = 3.0 * frames * hidden * io_bytes + hidden * hidden * w_bytes
    return flops, nbytes
