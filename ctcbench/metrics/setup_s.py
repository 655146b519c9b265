"""Set-up seconds: from process start to the window's first step or call
(imports, pool and weights from the seed, kernel builds where none are
cached, warm-up and graph captures)."""


def read(rec, run):
    return rec["setup_s"]
