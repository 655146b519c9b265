"""The control, the reference at fp8 in the program's place, fails the
cells' limits, here at a small size on the CPU (the chip's readings at
the cells' sizes are in PERF.md), and reads worse than the program on the
same inputs."""
import pytest
import torch

from ctcbench import calibrate, checks, run as R, spec
from ctcbench.tests.conftest import tiny_run


def _readings(capsys, fn):
    import json
    capsys.readouterr()
    fn()
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


@pytest.mark.parametrize("name", ["timit_full_3layer.train_timit",
                                  "swbd_beam_decode.decode_swbd"])
def test_control_fails_where_the_program_passes(capsys, name):
    run = tiny_run(name, seed=2**31 + 201)
    control = calibrate._train_control if run.cfg_file["path"] == "train" \
        else calibrate._decode_control
    ctl = next(r for r in _readings(capsys, lambda: control(
        run, torch.device("cpu"))) if r["side"] == "control")["numbers"]
    prog = R.execute(spec.benchmark(), run)["checks"]
    assert not checks.is_correct(checks.verdict(ctl, run.cfg_file["limits"]))
    worse = [k for k in ctl if ctl[k] > 2 * prog[k]["value"]]
    assert worse, (ctl, prog)
