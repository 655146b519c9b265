"""The gradient sum's roofline: the hand count of its bytes at preset 3
against the port's model, the four-card cell's rank-0 record counting one
sum a step (two gloo ranks on the CPU), and the reader's silences."""
import pytest

from ctcbench import run as R, spec
from ctcbench.rooflines import grad_sum
from ctcbench.tests.conftest import tiny_run

MESH = "swbd_5layer_dp.train_swbd_dp4"


def _model():
    return spec.config_file(spec.benchmark(), "swbd_5layer_dp")["port"][
        "model"]


def test_hand_count_at_preset_3_is_the_ports_parameter_count():
    from tpu_ctc_torch.models.birnn import BiRNN
    m = _model()
    # pre: 120*1824 + 1824 and 1824*1824 + 1824; five layers of
    # 3*1824*1824 + 1824; out 1824*29 + 29
    assert grad_sum.parameters(m) == 53_516_189
    assert grad_sum.grad_bytes(m) == 214_064_756
    cfg = spec.port_config(spec.config_file(spec.benchmark(),
                                            "swbd_5layer_dp"))
    assert sum(p.numel() for p in BiRNN(cfg.model, device="cpu")
               .parameters()) == grad_sum.parameters(m)
    # each of 4 cards sends 3/4 of the bytes at 450 GB/s
    assert grad_sum.least_s(m, 4) == pytest.approx(
        0.75 * 214_064_756 / 450e9)


def test_a_rank0_record_counts_one_gradient_sum_a_step():
    run = tiny_run(MESH)
    rec = R.spawn(run)[0]
    assert rec["steps"] and rec["launches"]["nccl_grad_sum"] == len(
        rec["steps"])
    assert rec["launches"]["nccl_loss_sum"] == 3 * len(rec["steps"])


class _Run:
    workload = {"chips": 4}
    cfg_file = {"port": {"model": _model()}}


def _rec(launches, ops):
    return {"kind": "train", "steps": [{}] * 10, "launches": launches,
            "trace": {"busy_s": 1.0, "window_s": 1.0, "ops": ops}}


def test_the_reader_needs_the_counter_and_nccl_device_time():
    read = spec.reader("grad_sum_roofline")
    nccl = {"ncclDevKernel_AllReduce_Sum_f32_RING_LL": [40, 0.02]}
    least = grad_sum.least_s(_model(), 4)
    assert read(_rec({"nccl_grad_sum": 10}, nccl), _Run) == pytest.approx(
        100 * 10 * least / 0.02)
    # the parent's records: no counter
    assert read(_rec({"birnn_fwd": 50}, nccl), _Run) is None
    # no NCCL kernel in the trace, or no trace
    assert read(_rec({"nccl_grad_sum": 10}, {"k<true>": [1, 1.0]}),
                _Run) is None
    assert read(dict(_rec({"nccl_grad_sum": 10}, {}), trace=None),
                _Run) is None
