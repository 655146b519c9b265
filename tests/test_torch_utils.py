"""The port's profiling and device-time utilities against the JAX
package's (``tpu_ctc.utils.profiling``, ``tpu_ctc.utils.devtime``).

* ``flops_estimate`` gives the JAX function's count for presets 1-5 and
  two overrides; ``mfu`` divides by the H100 SXM's dense bf16 peak.
* ``_device_exec_ms`` sums device events (made-up ones here) and skips
  host events; ``device_time_ms`` raises without a card.
* ``trace`` writes a Chrome trace (the port's spans in it:
  ``tests/test_torch_spans.py``).
"""
import json
import os
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Interval

from tpu_ctc import config as jax_config
from tpu_ctc.utils import profiling as jax_profiling
from tpu_ctc_torch import config
from tpu_ctc_torch.utils import devtime, profiling

CASES = [("1", {}), ("2", {}), ("3", {}), ("4", {}), ("5", {}),
         ("2", {"model.num_post_layers": 2, "model.hidden_dim": 320}),
         ("1", {"model.num_pre_layers": 3, "model.vocab_size": 40,
                "model.num_bi_layers": 4})]


@pytest.mark.parametrize("preset,over", CASES)
def test_flops_estimate_equals_jax(preset, over):
    cfg = config.get_config(preset, **over)
    jcfg = jax_config.get_config(preset, **over)
    for batch, frames in ((1, 1), (32, 800), (64, 1600)):
        assert profiling.flops_estimate(cfg, batch, frames) == \
            jax_profiling.flops_estimate(jcfg, batch, frames)


def test_mfu_uses_the_h100_peak():
    cfg = config.get_config("2")
    assert profiling.H100_SXM_BF16_DENSE_FLOPS == 989e12
    assert profiling.mfu(cfg, 32, 800, 0.06) == (
        profiling.flops_estimate(cfg, 32, 800) / 0.06 / 989e12)
    assert not hasattr(profiling, "TPU_V5E_BF16_PEAK_FLOPS")


def _event(device_type, start, end, name="k"):
    return types.SimpleNamespace(device_type=device_type, name=name,
                                 time_range=Interval(start, end))


def test_device_exec_ms_sums_device_events():
    events = [_event(DeviceType.CPU, 0, 10_000, "aten::mm"),
              _event(DeviceType.CUDA, 100, 1600, "ctc_alpha_kernel<256>"),
              _event(DeviceType.CUDA, 2000, 2250, "Memset (Device)"),
              _event(DeviceType.CUDA, 3000, 3500, "ctc_beta_kernel<256>")]
    assert devtime._device_exec_ms(events) == pytest.approx(2.25)
    assert devtime._device_exec_ms(events, kernel="ctc_alpha") == \
        pytest.approx(1.5)
    assert devtime._device_exec_ms(
        events, kernel="ctc_alpha|ctc_beta") == pytest.approx(2.0)
    assert devtime._device_exec_ms(events[:1]) == 0.0


def test_device_events_of_a_host_trace_are_none():
    """``_device_events`` reads the profiler's own records: a trace of
    host work alone has no device event, and sums to 0 ms."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.randn(8, 8) @ torch.randn(8, 8)
    assert devtime._device_events(prof) == []
    assert devtime._device_exec_ms(devtime._device_events(prof)) == 0.0


def test_device_time_ms_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA card"):
        devtime.device_time_ms(lambda x: calls.append(x), 1)
    assert calls == []


def test_event_ms_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA card"):
        devtime.event_ms(lambda x: calls.append(x), 1)
    assert calls == []


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    with open(os.path.join(tmp_path, "t", "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    assert profiling.card_line("cpu") == "cpu"
