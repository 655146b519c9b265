"""The port's frontend (``tpu_ctc_torch.frontend.features``) against the JAX
package's, on the CPU, from the same seeded numpy waveforms.

Limits (``PERF.md`` §2):

* the power spectrum within 1e-5 of each frame's peak power;
* log-mel energies within 1e-3 where the band's mel energy is at least
  1e-6 of the frame's largest band (a band far from a pure tone holds f32
  rounding noise of the DFT's cancelling sums, whose log differs between
  two products by O(1)); white noise has no such band;
* CMVN'd features within 1e-3 on white noise (every band is loud in every
  frame), and the frame masks equal.

Dither cannot match JAX's PRNG draws; it is tested by its statistics, as
the reference tests it, and every comparison with JAX runs at dither 0.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ctc import config as jax_config
from tpu_ctc.frontend import features as JF
from tpu_ctc_torch import config
from tpu_ctc_torch.frontend import features as F

torch.set_num_threads(2)

POWER_TOL = 1e-5        # of the frame's peak power
LOUD = 1e-6             # a band is loud above this share of the frame's max
LOG_TOL = 1e-3          # log-mel and CMVN'd features


def _cfgs(**over):
    return (dataclasses.replace(config.FrontendConfig(), **over),
            dataclasses.replace(jax_config.FrontendConfig(), **over))


def _tone(n, freq=1000.0, rate=16000):
    return np.sin(2 * np.pi * freq * np.arange(n) / rate).astype(np.float32)


def numpy_stft_power(x, cfg):
    """Independent float64 numpy STFT (the reference tests' oracle)."""
    t = 1 + (len(x) - cfg.frame_length) // cfg.hop_length
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(cfg.frame_length)
                             / cfg.frame_length)
    out = np.zeros((t, cfg.n_fft // 2 + 1))
    for i in range(t):
        fr = x[i * cfg.hop_length: i * cfg.hop_length + cfg.frame_length] * win
        out[i] = np.abs(np.fft.rfft(fr, n=cfg.n_fft)) ** 2
    return out


class TestPieces:
    def test_window_framing_and_constants(self, rng):
        cfg, jcfg = _cfgs()
        np.testing.assert_allclose(F.hann_window(400).numpy(),
                                   np.asarray(JF.hann_window(400)),
                                   rtol=0, atol=1e-7)
        x = rng.randn(2, 3, 1000).astype(np.float32)
        np.testing.assert_array_equal(
            F.frame_signal(torch.from_numpy(x), 400, 160).numpy(),
            np.asarray(JF.frame_signal(jnp.asarray(x), 400, 160)))
        for n in (0, 399, 400, 401, 16000):
            assert F.num_frames(n, cfg) == JF.num_frames(n, jcfg)
        np.testing.assert_array_equal(F._dft_conv_kernels(400, 512),
                                      JF._dft_conv_kernels(400, 512))
        np.testing.assert_array_equal(
            F.mel_filterbank(16000, 512, 23, 20.0, None),
            JF.mel_filterbank(16000, 512, 23, 20.0, None))
        sl = np.array([0, 399, 400, 560, 16000])
        np.testing.assert_array_equal(F.frame_lengths_from_samples(sl, cfg),
                                      JF.frame_lengths_from_samples(sl, jcfg))

    @pytest.mark.parametrize("use_fft", [False, True])
    def test_power_matches_jax(self, rng, use_fft):
        cfg, jcfg = _cfgs()
        x = np.concatenate([rng.randn(1, 16000), 0.5 * _tone(16000)[None]]
                           ).astype(np.float32)
        got = F.stft_power(torch.from_numpy(x), cfg, use_fft=use_fft).numpy()
        want = np.asarray(JF.stft_power(jnp.asarray(x), jcfg,
                                        use_fft=use_fft))
        assert got.shape == want.shape == (2, 98, 257)
        peak = want.max(axis=-1, keepdims=True)
        assert np.all(np.abs(got - want) <= POWER_TOL * peak)

    def test_power_matches_numpy_oracle(self, rng):
        cfg, _ = _cfgs()
        x = rng.randn(16000).astype(np.float32)
        got = F.stft_power(torch.from_numpy(x), cfg).numpy()
        want = numpy_stft_power(x.astype(np.float64), cfg)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
        assert np.all(np.abs(got - want)
                      <= POWER_TOL * want.max(axis=-1, keepdims=True))

    def test_log_mel_of_a_pure_tone_in_its_loud_bands(self):
        cfg, jcfg = _cfgs(n_mels=40)
        x = 0.5 * _tone(8000)
        got = F.log_mel(torch.from_numpy(x), cfg).numpy()
        want = np.asarray(JF.log_mel(jnp.asarray(x), jcfg))
        mel = F.mel_energies(torch.from_numpy(x), cfg).numpy()
        loud = mel >= LOUD * mel.max(axis=-1, keepdims=True)
        assert 0 < loud.mean() < 1          # the tone leaves quiet bands
        assert np.abs(got - want)[loud].max() <= LOG_TOL

    def test_cmvn_and_context_match_jax(self, rng):
        feats = (3 * rng.randn(2, 10, 4) + 1).astype(np.float32)
        mask = np.ones((2, 10), np.float32)
        mask[1, 6:] = 0
        for m in (None, mask):
            got = F.cmvn(torch.from_numpy(feats),
                         None if m is None else torch.from_numpy(m))
            want = JF.cmvn(jnp.asarray(feats),
                           None if m is None else jnp.asarray(m))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        for k in (0, 1, 2):
            np.testing.assert_array_equal(
                F.stack_context(torch.from_numpy(feats), k).numpy(),
                np.asarray(JF.stack_context(jnp.asarray(feats), k)))

    def test_batched_matches_single(self, rng):
        cfg, _ = _cfgs()
        xs = torch.from_numpy(rng.randn(3, 8000).astype(np.float32))
        batched = F.log_mel(xs, cfg)
        for i in range(3):
            np.testing.assert_allclose(batched[i].numpy(),
                                       F.log_mel(xs[i], cfg).numpy(),
                                       rtol=1e-5, atol=1e-6)


class TestExtractFeatures:
    @pytest.mark.parametrize("over", [
        {},
        {"context": 1, "n_mels": 40},
        {"context": 2, "frame_stride": 3, "n_mels": 23},
        {"preemphasis": 0.97, "context": 1},
        {"cmvn": False, "context": 1, "frame_stride": 2},
    ])
    def test_matches_jax(self, rng, over):
        cfg, jcfg = _cfgs(**over)
        x = rng.randn(3, 16000).astype(np.float32)
        lens = np.array([16000, 9000, 300], np.int32)
        got, gmask = F.extract_features(torch.from_numpy(x), cfg,
                                        torch.from_numpy(lens))
        want, wmask = JF.extract_features(jnp.asarray(x), jcfg,
                                          jnp.asarray(lens))
        want, wmask = np.asarray(want), np.asarray(wmask)
        np.testing.assert_array_equal(gmask.numpy(), wmask)
        assert got.shape == want.shape
        assert got.shape[-1] == cfg.feature_dim
        assert np.abs(got.numpy() - want).max() <= LOG_TOL
        # padded frames are zero
        n1 = F.frame_lengths_from_samples(lens, cfg)
        assert np.abs(got.numpy()[1, -(-n1[1] // cfg.frame_stride):]).max() \
            == 0.0

    def test_without_lengths_matches_jax(self, rng):
        cfg, jcfg = _cfgs(context=1)
        x = rng.randn(2, 6000).astype(np.float32)
        got, mask = F.extract_features(torch.from_numpy(x), cfg)
        want, _ = JF.extract_features(jnp.asarray(x), jcfg)
        assert bool(mask.all())
        assert np.abs(got.numpy() - np.asarray(want)).max() <= LOG_TOL

    def test_preemphasis_equals_numpy_first(self, rng):
        cfg0, _ = _cfgs(n_mels=20)
        cfg_pe = dataclasses.replace(cfg0, preemphasis=0.97)
        x = rng.randn(2, 4000).astype(np.float32)
        lens = torch.tensor([4000, 3200])
        y = x.copy()
        y[:, 1:] = x[:, 1:] - 0.97 * x[:, :-1]
        f_ref, m_ref = F.extract_features(torch.from_numpy(y), cfg0, lens)
        f_pe, m_pe = F.extract_features(torch.from_numpy(x), cfg_pe, lens)
        assert torch.equal(m_ref, m_pe)
        np.testing.assert_allclose(f_pe.numpy(), f_ref.numpy(), rtol=1e-4,
                                   atol=1e-5)


class TestDither:
    def test_reproducible_decorrelated_and_bounded(self, rng):
        cfg0, _ = _cfgs(n_mels=20)
        cfg_d = dataclasses.replace(cfg0, dither=1.0 / 32768.0)
        x = torch.from_numpy(rng.randn(1, 4000).astype(np.float32) * 0.1)
        lens = torch.tensor([4000])
        f0, _ = F.extract_features(x, cfg0, lens)

        def dithered(seed):
            return F.extract_features(
                x, cfg_d, lens,
                generator=torch.Generator().manual_seed(seed))[0]
        f1, f2, f3 = dithered(3), dithered(3), dithered(4)
        assert torch.equal(f1, f2)                 # same generator state
        assert not torch.equal(f1, f3)             # another utterance's
        assert not torch.equal(f1, f0)
        np.testing.assert_allclose(f1.numpy(), f0.numpy(), atol=0.5)
        # without a generator: one fixed pattern (a generator seeded 0)
        assert torch.equal(F.extract_features(x, cfg_d, lens)[0],
                           dithered(0))

    def test_noise_std_is_the_configured_dither(self):
        """On silence, the mel energy of band m is the noise power
        sigma^2 sum(w^2) sum_f fb[f, m]; its mean over 600 frames and 40
        bands gives sigma within a few percent."""
        sigma = 0.01
        cfg = dataclasses.replace(config.FrontendConfig(), dither=sigma,
                                  cmvn=False)
        x = torch.zeros(1, 96160)
        feats, _ = F.extract_features(
            x, cfg, generator=torch.Generator().manual_seed(7))
        fb = F.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                              cfg.fmin, cfg.fmax)
        w2 = float((F.hann_window(cfg.frame_length) ** 2).sum())
        ratio = np.exp(feats[0].numpy().astype(np.float64)) / (
            w2 * fb.sum(axis=0))
        assert abs(np.sqrt(ratio.mean()) / sigma - 1.0) < 0.03

    def test_defaults_are_reference_neutral(self):
        cfg = config.FrontendConfig()
        assert cfg.preemphasis == 0.0 and cfg.dither == 0.0
