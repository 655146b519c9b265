"""STFT -> log-mel filterbank frontend.

Counterpart of ``tpu_ctc.frontend.features``: framing, Hann window, the
power spectrum, the mel filterbank product, log compression, per-utterance
CMVN, +/-k context stacking, pre-emphasis, dither and frame striding.
Every function runs on the device of its input tensors.

The power spectrum is one product of the framed waveform with windowed
cos/-sin rows (:func:`_dft_conv_kernels`, the reference's strided
convolution written as ``unfold`` + ``matmul``), in full f32: on a card
TF32 is switched off around the products, as the reference convolves at
``Precision.HIGHEST``.  ``stft_power(use_fft=True)`` keeps the explicit
framing + ``torch.fft.rfft`` path for cross-checking.  Dither draws from a
caller's ``torch.Generator``; JAX's PRNG draws are not reproduced.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_ctc_torch.config import FrontendConfig
from tpu_ctc_torch.ops.birnn_cuda import matmul_f32


def hann_window(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (matches common STFT conventions)."""
    n = torch.arange(length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / length)


def num_frames(num_samples: int, cfg: FrontendConfig) -> int:
    if num_samples < cfg.frame_length:
        return 0
    return 1 + (num_samples - cfg.frame_length) // cfg.hop_length


def frame_signal(x: torch.Tensor, frame_length: int,
                 hop_length: int) -> torch.Tensor:
    """Slice ``x [..., N]`` into overlapping frames ``[..., T, frame_length]``
    (a strided view)."""
    return x.unfold(-1, frame_length, hop_length)


@functools.lru_cache(maxsize=8)
def _dft_conv_kernels(frame_length: int, n_fft: int) -> np.ndarray:
    """Windowed real-DFT as conv kernels: [2*(n_fft//2+1), 1, frame_length]
    (cos rows, then -sin rows, each times the Hann window)."""
    n_bins = n_fft // 2 + 1
    n = np.arange(frame_length)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(frame_length)
                             / frame_length)
    mat = np.concatenate([np.cos(ang) * win[:, None],
                          -np.sin(ang) * win[:, None]], axis=1)
    return np.ascontiguousarray(mat.T[:, None, :]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_matrix(frame_length: int, n_fft: int) -> np.ndarray:
    """:func:`_dft_conv_kernels` as one [frame_length, 2*(n_fft//2+1)]
    matrix for the frames' product (shared: callers do not write it)."""
    return np.ascontiguousarray(_dft_conv_kernels(frame_length, n_fft)[:, 0].T)


def stft_power(x: torch.Tensor, cfg: FrontendConfig,
               use_fft: bool = False) -> torch.Tensor:
    """Power spectrogram ``[..., T, n_fft//2 + 1]`` of ``x [..., N]``.

    Default path: the frames times the windowed cos/-sin rows of
    :func:`_dft_conv_kernels` (one f32 product, TF32 off on a card);
    ``use_fft=True`` runs ``torch.fft.rfft`` on the windowed frames."""
    x = x.to(torch.float32)
    frames = frame_signal(x, cfg.frame_length, cfg.hop_length)
    if use_fft:
        frames = frames * hann_window(cfg.frame_length, frames.dtype,
                                      frames.device)
        spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)
        return torch.square(spec.real) + torch.square(spec.imag)
    if cfg.frame_length > cfg.n_fft:
        raise ValueError("frame_length > n_fft requires the fft path")
    n_bins = cfg.n_fft // 2 + 1
    kern = torch.from_numpy(_dft_matrix(cfg.frame_length, cfg.n_fft))
    ri = matmul_f32(frames, kern.to(x.device))    # [..., T, 2 * bins]
    return torch.square(ri[..., :n_bins]) + torch.square(ri[..., n_bins:])


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float, fmax: Optional[float]) -> np.ndarray:
    """Triangular mel filterbank matrix ``[n_fft//2+1, n_mels]`` (HTK mel
    scale), built in float64 numpy and returned as float32."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bin_freqs = np.arange(n_bins) * (sample_rate / n_fft)
    fb = np.zeros((n_bins, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - bin_freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def mel_energies(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Waveform ``[..., N]`` -> mel band energies ``[..., T, n_mels]``."""
    power = stft_power(x, cfg)
    fb = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft,
                                         cfg.n_mels, cfg.fmin, cfg.fmax))
    return matmul_f32(power, fb.to(power.device))


def log_mel(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Waveform ``[..., N]`` -> log-mel features ``[..., T, n_mels]``."""
    return torch.log(torch.clamp_min(mel_energies(x, cfg), cfg.log_floor))


def cmvn(feats: torch.Tensor, mask: Optional[torch.Tensor] = None,
         eps: float = 1e-8) -> torch.Tensor:
    """Per-utterance mean/variance normalization over valid frames.

    ``feats [..., T, D]``; ``mask [..., T]`` marks valid frames (1.0) vs
    padding (0.0).  Padded frames are zeroed on output."""
    if mask is None:
        mean = torch.mean(feats, dim=-2, keepdim=True)
        var = torch.mean(torch.square(feats - mean), dim=-2, keepdim=True)
        return (feats - mean) * torch.rsqrt(var + eps)
    m = mask[..., :, None].to(feats.dtype)
    denom = torch.clamp_min(torch.sum(m, dim=-2, keepdim=True), 1.0)
    mean = torch.sum(feats * m, dim=-2, keepdim=True) / denom
    var = torch.sum(torch.square(feats - mean) * m, dim=-2,
                    keepdim=True) / denom
    return (feats - mean) * torch.rsqrt(var + eps) * m


def stack_context(feats: torch.Tensor, context: int) -> torch.Tensor:
    """Concatenate +/-context frames: ``[..., T, D] -> [..., T, D*(2k+1)]``,
    edge frames edge-padded."""
    if context == 0:
        return feats
    shifts = []
    for k in range(-context, context + 1):
        if k < 0:
            pad = feats[..., :1, :].expand(
                *feats.shape[:-2], -k, feats.shape[-1])
            shifted = torch.cat([pad, feats[..., :k, :]], dim=-2)
        elif k > 0:
            pad = feats[..., -1:, :].expand(
                *feats.shape[:-2], k, feats.shape[-1])
            shifted = torch.cat([feats[..., k:, :], pad], dim=-2)
        else:
            shifted = feats
        shifts.append(shifted)
    return torch.cat(shifts, dim=-1)


def extract_features(x: torch.Tensor, cfg: FrontendConfig,
                     sample_lengths: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Waveform batch ``[B, N]`` -> ``(feats [B, T, F], frame_mask [B, T])``.

    ``sample_lengths [B]`` gives valid samples per utterance; frames whose
    window extends past the valid length are masked out.  With
    ``cfg.dither > 0``, Gaussian noise of that stddev is added first, drawn
    from ``generator`` (on its device, then moved to ``x``'s); callers pass
    one seeded per utterance (the manifest seeds it from the utterance
    index), and without one a generator seeded 0 repeats one noise pattern.
    With ``cfg.preemphasis > 0`` the whole waveform is pre-emphasized,
    y[n] = x[n] - c x[n-1] with y[0] = x[0]."""
    x = x.to(torch.float32)
    if cfg.dither > 0.0:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        noise = torch.randn(x.shape, generator=generator,
                            dtype=torch.float32, device=generator.device)
        x = x + cfg.dither * noise.to(x.device)
    if cfg.preemphasis > 0.0:
        prev = torch.nn.functional.pad(x[..., :-1], (1, 0))
        x = x - cfg.preemphasis * prev
    feats = log_mel(x, cfg)
    t = feats.shape[-2]
    if sample_lengths is None:
        mask = torch.ones(feats.shape[:-1], dtype=torch.float32,
                          device=feats.device)
    else:
        sl = torch.as_tensor(sample_lengths, device=feats.device)
        n_valid = torch.where(
            sl >= cfg.frame_length,
            1 + torch.div(sl - cfg.frame_length, cfg.hop_length,
                          rounding_mode="floor"), 0)
        mask = (torch.arange(t, device=feats.device)[None, :]
                < n_valid[..., None]).to(torch.float32)
        feats = feats * mask[..., None]
    if cfg.cmvn:
        feats = cmvn(feats, mask)
    feats = stack_context(feats, cfg.context)
    feats = feats * mask[..., None]
    if cfg.frame_stride > 1:
        feats = feats[..., ::cfg.frame_stride, :]
        mask = mask[..., ::cfg.frame_stride]
    return feats, mask


def frame_lengths_from_samples(sample_lengths: np.ndarray,
                               cfg: FrontendConfig) -> np.ndarray:
    """Host-side helper: valid frame count per utterance."""
    sl = np.asarray(sample_lengths)
    return np.where(sl >= cfg.frame_length,
                    1 + (sl - cfg.frame_length) // cfg.hop_length, 0)
