"""Mean ms a step takes to write its momentum and learning rate to the
card (the port's span ``step.scalars`` inside ``step.call``)."""
from ctcbench import port_spans


def read(rec, run):
    return port_spans.mean_ms(rec, "train", "step.scalars")
