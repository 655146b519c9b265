"""Each kernel's count of operations and bytes against a hand count."""
import pytest

from ctcbench import flops, peaks
from ctcbench.rooflines import (beam_search, beam_walk, birnn_bwd, birnn_fwd,
                                ctc_alpha, ctc_beta)


def test_birnn_fwd_hand_count():
    # H = 4, 10 live frames, bf16 streams: 10 (2*16 + 2*4) operations;
    # z and h 10*4*2 bytes each, W 16*2
    assert birnn_fwd.cost(4, 10) == (400.0, 160.0 + 32.0)


def test_birnn_bwd_hand_count():
    # g, h read and d written: 3 * 10*4*2 bytes, W 32
    assert birnn_bwd.cost(4, 10) == (400.0, 240.0 + 32.0)


@pytest.mark.parametrize("mod", [ctc_alpha, ctc_beta])
def test_ctc_hand_count(mod):
    # one utterance, T = 5, L = 2: 5 * 5 cells, 5 * 3 emissions
    assert mod.cost(25, 15) == (12 * 25.0, 4.0 * (15 + 25))


def test_beam_hand_count():
    # 7 frames, 1 row, K = 2, A = 3, order 2, max_len 4
    assert beam_search.cost(7, 1, 2, 3, 2, 4) == (
        10 * 7 * 2 * 3.0, 4.0 * (7 * 3 + 9 + 4))
    assert beam_walk.cost(7, 1, 4) == (0.0, 4.0 * (7 + 4))


def test_least_time_names_its_bound():
    t, bound = peaks.least_time(989e12, 1.0, peaks.FLOPS["bfloat16"])
    assert bound == "operations" and t == pytest.approx(1.0)
    t, bound = peaks.least_time(1.0, 3.35e12, peaks.FLOPS["bfloat16"])
    assert bound == "bytes" and t == pytest.approx(1.0)


def test_model_flops_match_the_ports_estimate():
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.utils.profiling import flops_estimate
    for preset in ("2", "3"):
        cfg = get_config(preset)
        m = cfg.to_dict()["model"]
        assert flops.train_per_frame(m) * 32 * 100 == pytest.approx(
            flops_estimate(cfg, 32, 100))
