"""On a card: a short run of each one-card cell prints one result line
with the keys a result line has, correct, its metrics and no JAX."""
import json
import subprocess
import sys

import pytest

from ctcbench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["timit_full_3layer.train_timit",
                                  "swbd_beam_decode.decode_swbd"])
def test_a_short_run(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "-m", "ctcbench.run", "--workload", cell, "--seed",
         str(2**32 + 9), "--seconds", "3", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(res)[-1] == "checks"
    bench = spec.benchmark()
    names = {m["name"] for m in spec.metrics_for(bench, cell, bool(trace))}
    assert set(res["metrics"]) == names
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
