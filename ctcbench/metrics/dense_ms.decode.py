"""Device ms of the matrix-product kernels a decode call: the dense
layers' and projections' forward products."""
from ctcbench import kernels, readings


def read(rec, run):
    if rec["kind"] != "decode":
        return None
    return readings.per_step_ms(rec, kernels.device_s(rec, kernels.GEMM))
