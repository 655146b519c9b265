"""Mean ms a step waits in ``next()`` on the prefetch iterator (the
harness's span): the data and prefetch layer's wait."""


def read(rec, run):
    n, s = rec["spans"].get("input_wait", (0, 0.0))
    return 1e3 * s / n if n and rec["kind"] == "train" else None
