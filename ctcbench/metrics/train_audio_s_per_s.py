"""Live audio seconds the window's steps trained (frames of weight-1 rows
/ 100) over the window's wall time, which ends at a synchronise after
the last step.  On several cards, the job's total."""


def read(rec, run):
    if rec["kind"] != "train":
        return None
    return rec["audio_s"] / rec["window_s"]
