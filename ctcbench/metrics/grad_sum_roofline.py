"""The gradient sum's share of its roofline (``rooflines.grad_sum``): the
least time of the window's gradient sums, counted by the port as
``nccl_grad_sum`` in rank 0's launches, over rank 0's device time in
NCCL's kernels (the gradient sum with the loss's sums), in %.  None
where the record counts no gradient sum (a port that does not count its
collectives) or holds no NCCL device time."""
from ctcbench import kernels, readings
from ctcbench.rooflines import grad_sum


def read(rec, run):
    sums = rec.get("launches", {}).get("nccl_grad_sum", 0)
    if rec["kind"] != "train" or not sums:
        return None
    least = sums * grad_sum.least_s(run.cfg_file["port"]["model"],
                                    run.workload["chips"])
    return readings.share(least, kernels.device_s(rec, kernels.NCCL))
