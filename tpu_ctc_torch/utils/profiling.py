"""Tracing and step timing.

Counterpart of ``tpu_ctc.utils.profiling``:

  * :func:`trace` -- a ``torch.profiler`` trace of any code region (CPU
    and, with a card, CUDA activity), written as a Chrome trace;
  * :class:`StepTimer` -- steady-state step timing (the first steps,
    which build kernels, are skipped), giving audio-seconds/s and
    step-time percentiles; a step's result on a card is synchronised
    before its time is taken;
  * :func:`flops_estimate` and :func:`mfu` -- the analytic FLOP count of a
    BiRNN train step and the model FLOP/s utilization it gives against a
    card's peak (by default the H100 SXM's dense bf16 tensor rate);
  * :func:`card_line` -- the card's name and power limit, which every
    measurement on a card is printed beside.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_ctc_torch.config import Config

# Dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet, without
# sparsity, at the 700 W power limit).
H100_SXM_BF16_DENSE_FLOPS = 989e12


def card_line(device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    a CUDA device (a card may be set below its 700 W maximum, and then runs
    slower); ``"cpu"`` for a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(index)], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a region; the trace is written to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(result) -> Optional[torch.Tensor]:
    """The first tensor of a tensor or a (nested) dict, list or tuple."""
    if isinstance(result, torch.Tensor):
        return result
    items = result.values() if isinstance(result, dict) else (
        result if isinstance(result, (list, tuple)) else ())
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


class StepTimer:
    """Collects per-step wall times; reports throughput and percentiles."""

    def __init__(self, frames_per_second: float = 100.0):
        self.times: List[float] = []
        self.audio_s: List[float] = []
        self.fps = frames_per_second
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()

    def stop(self, result=None, audio_seconds: float = 0.0):
        """End the step; a result on a card is waited for first
        (``torch.cuda.synchronize`` on its device)."""
        t = _first_tensor(result) if result is not None else None
        if t is not None and t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.times.append(time.time() - self._t0)
        self.audio_s.append(audio_seconds)

    def summary(self, skip_first: int = 1) -> Dict[str, float]:
        ts = np.asarray(self.times[skip_first:] or self.times)
        au = np.asarray(self.audio_s[skip_first:] or self.audio_s)
        out = {
            "steps": len(ts),
            "step_time_mean_s": float(ts.mean()),
            "step_time_p50_s": float(np.percentile(ts, 50)),
            "step_time_p95_s": float(np.percentile(ts, 95)),
        }
        if au.sum() > 0:
            out["audio_s_per_s"] = float(au.sum() / ts.sum())
        return out


def flops_estimate(cfg: Config, batch: int, frames: int) -> float:
    """Analytic train-step FLOPs for the BiRNN stack (fwd ~ 1x, bwd ~ 2x).

    Per bidirectional layer: one shared input projection (2*B*T*D*H) plus
    two recurrent matmul chains (2 * 2*B*T*H*H).
    """
    m = cfg.model
    d = m.input_dim
    h = m.hidden_dim
    fwd = 0.0
    for _ in range(m.num_pre_layers):
        fwd += 2.0 * batch * frames * d * h
        d = h
    for _ in range(m.num_bi_layers):
        fwd += 2.0 * batch * frames * d * h      # shared projection
        fwd += 2 * 2.0 * batch * frames * h * h  # two directions
        d = h
    for _ in range(m.num_post_layers):
        fwd += 2.0 * batch * frames * h * h
    fwd += 2.0 * batch * frames * h * m.vocab_size
    return 3.0 * fwd                              # fwd + ~2x bwd


def mfu(cfg: Config, batch: int, frames: int, step_time_s: float,
        peak: float = H100_SXM_BF16_DENSE_FLOPS) -> float:
    """Model FLOP/s utilization of one card for a measured step time."""
    return flops_estimate(cfg, batch, frames) / step_time_s / peak
