"""Mean ms the loader takes to hand over the next batch (the harness's
span around it; ``make_batch`` pads on the host)."""


def read(rec, run):
    n, s = rec["spans"].get("input", (0, 0.0))
    return 1e3 * s / n if n and rec["kind"] == "decode" else None
