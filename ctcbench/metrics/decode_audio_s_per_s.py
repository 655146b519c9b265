"""Live audio seconds decoded to hypotheses on the host in the window,
over the window's wall time."""


def read(rec, run):
    if rec["kind"] != "decode":
        return None
    return rec["audio_s"] / rec["window_s"]
