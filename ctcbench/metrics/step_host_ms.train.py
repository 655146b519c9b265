"""Mean ms from a step's call to its return on the host (the harness's
span around the compiled step)."""


def read(rec, run):
    n, s = rec["spans"].get("step_call", (0, 0.0))
    return 1e3 * s / n if n and rec["kind"] == "train" else None
