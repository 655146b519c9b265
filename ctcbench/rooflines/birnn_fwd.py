"""B1, one direction of the forward recurrence over a launch's live
frames: h_t = clip(z_t + h_{t-1} W) on each of ``frames`` (row, frame)
pairs.  Operations: the product 2 H^2 and the add and clip 2 H a frame.
Bytes: z read and h written in the io dtype, W read once.  At the
cells' widths the operations bind."""


def cost(hidden: int, frames: int, io_bytes: int = 2, w_bytes: int = 2):
    flops = frames * (2.0 * hidden * hidden + 2.0 * hidden)
    nbytes = 2.0 * frames * hidden * io_bytes + hidden * hidden * w_bytes
    return flops, nbytes
