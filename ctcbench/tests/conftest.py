"""CPU tests of the benchmark (``python -m pytest ctcbench/tests``).  Runs
at a tiny size drive the whole harness on the CPU, where the port runs
its plain versions; the tests that need a card carry the ``cuda`` marker
and skip without one."""
import copy
import os
import time

import pytest
import torch

from ctcbench import spec
from ctcbench.common import Run

# cells whose harness is kept but that BENCHMARK.json does not list yet
HELD = {
    "swbd_5layer_dp.train_swbd_dp4": {
        "name": "swbd_5layer_dp.train_swbd_dp4", "config": "swbd_5layer_dp",
        "traffic": "swbd_lengths", "chips": 4,
        "file": "ctcbench/configs/swbd_5layer_dp.json"},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs measure a card")


def tiny_run(name: str, seconds: float = 0.5, trace: bool = False,
             seed: int = 2**31 + 7) -> Run:
    """A run of the cell ``name`` on the CPU at a small size: H = 128,
    B = 4, buckets of 20/40/80 frames, 24 utterances; two gloo ranks where
    the cell has four cards.  (Below H ~ 128 the bf16 program and the fp8
    control read alike against float32: too few terms a sum.)"""
    bench = spec.benchmark()
    if name in HELD:
        w = dict(HELD[name])
        cf = copy.deepcopy(spec.load_json(os.path.join(spec.ROOT,
                                                       w.pop("file"))))
    else:
        w = dict(spec.workload(bench, name))
        cf = copy.deepcopy(spec.config_file(bench, w["config"]))
    cf["port"]["model"]["hidden_dim"] = 128
    cf["port"]["data"].update(batch_size=4, bucket_boundaries=[20, 40, 80],
                              max_frames=80)
    if cf["path"] == "decode":
        cf["port"]["decode"]["beam_width"] = 8
    tr = copy.deepcopy(spec.traffic_file(w["traffic"]))
    tr.update(utterances=24, frames_per_second=10, chars_per_second=2)
    if w["chips"] > 1:
        w["chips"] = 2
        cf["port"]["mesh"]["data"] = 2
    return Run(workload=w, cfg_file=cf, traffic=tr, seed=seed,
               seconds=seconds, trace=trace, t_start=time.time(),
               device="cpu")
