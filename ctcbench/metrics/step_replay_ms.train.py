"""Mean ms the host spends in a step's CUDA graph replay (the port's span
``step.replay`` inside ``step.call``)."""
from ctcbench import port_spans


def read(rec, run):
    return port_spans.mean_ms(rec, "train", "step.replay")
