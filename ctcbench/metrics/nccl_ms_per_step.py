"""Rank 0's device ms in NCCL kernels a step: the gradient sum and the
loss's sums over the cards."""
from ctcbench import kernels, readings


def read(rec, run):
    if rec["kind"] != "train" or run.workload["chips"] < 2:
        return None
    return readings.per_step_ms(rec, kernels.device_s(rec, kernels.NCCL))
