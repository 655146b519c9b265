"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit)."""

FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
         "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# element-wise float32 work (the CUDA cores, outside the tensor cores)
SCALAR_FLOPS = FLOPS["float32"]


def least_time(flops: float, nbytes: float, peak_flops: float):
    """(seconds, bound): the least time a chip at its peaks takes for the
    work, and whether operations or bytes set it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
