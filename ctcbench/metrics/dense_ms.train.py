"""Device ms of the matrix-product kernels (cuBLAS, CUTLASS) a step:
the dense layers forward and backward and the recurrence's dW."""
from ctcbench import kernels, readings


def read(rec, run):
    if rec["kind"] != "train":
        return None
    return readings.per_step_ms(rec, kernels.device_s(rec, kernels.GEMM))
