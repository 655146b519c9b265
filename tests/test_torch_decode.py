"""The port's decode slice end to end against the JAX package.

Preset 4 (``swbd_beam_decode``) narrowed to H = 64 and 2 bidirectional
layers at f32: the JAX ``make_beam_decoder`` and the port's, fed the same
npz weights (JAX ``init_params`` -> ``export_npz`` -> the port's loader)
and the same bucketed synthetic batch, must give equal hypotheses.  Also
the greedy path and the CLI on the CPU.  With the GRU char LM (JAX's GRU
carried over by ``params_from_jax``) the hypotheses must be equal too.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpu_ctc import config as jax_config
from tpu_ctc.decode import beam as jax_beam
from tpu_ctc.decode import greedy as jax_greedy
from tpu_ctc.decode import lm as jax_lm
from tpu_ctc.decode import neural_lm as jax_nlm
from tpu_ctc.models import birnn as jax_birnn
from tpu_ctc.train import checkpoint as jax_ckpt
from tpu_ctc_torch import config
from tpu_ctc_torch.data.bucketing import BucketedLoader
from tpu_ctc_torch.data.synthetic import SyntheticCorpus
from tpu_ctc_torch.decode import beam, greedy, lm, neural_lm
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.train import checkpoint
from tpu_ctc_torch.train.loop import batch_to_device_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = {"model.hidden_dim": 64, "model.num_bi_layers": 2,
          "model.compute_dtype": "float32", "model.init_scale": 0.2,
          "data.batch_size": 4}


def _jax_weights(cfg, tmp_path, seed=0):
    params = jax_birnn.init_params(jax.random.PRNGKey(seed), cfg.model)
    path = str(tmp_path / "w.npz")
    jax_ckpt.export_npz(path, params)
    return params, path


class TestGreedy:
    def test_matches_jax(self):
        r = np.random.RandomState(1)
        lp = np.log(r.dirichlet(np.ones(7) * 0.3, size=(3, 20))
                    ).astype(np.float32)
        mask = (np.arange(20)[None, :] < np.array([[20], [13], [5]])
                ).astype(np.float32)
        got = greedy.greedy_decode(torch.from_numpy(lp),
                                   torch.from_numpy(mask))
        want = jax_greedy.greedy_decode(lp, mask)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


class TestWholeSlice:
    def test_beam_decoder_matches_jax(self, tmp_path):
        jcfg = jax_config.get_config("swbd_beam_decode", **NARROW)
        tcfg = config.get_config("swbd_beam_decode", **NARROW)
        params, path = _jax_weights(jcfg, tmp_path, seed=3)
        model = checkpoint.load_npz(birnn.BiRNN(tcfg.model, device="cpu"), path)
        data = SyntheticCorpus(num_utterances=4, feature_dim=120,
                               min_chars=3, max_chars=9).all_utterances()
        label_seqs = [labels for _, labels in data]
        tlm = lm.train_ngram_lm(label_seqs, 29, order=3)
        jlm = jax_lm.train_ngram_lm(label_seqs, 29, order=3)
        batch = next(BucketedLoader(data, tcfg.data).epoch(0))[1]
        bd = batch_to_device_dict(batch)
        got = beam.make_beam_decoder(tcfg, lm=tlm, device="cpu")(model, bd)
        want = jax_beam.make_beam_decoder(jcfg, lm=jlm)(params, bd)
        got_h, got_l = (x.numpy() for x in got)
        want_h, want_l = (np.asarray(x) for x in want)
        np.testing.assert_array_equal(got_l, want_l)
        for i in range(len(got_l)):
            np.testing.assert_array_equal(got_h[i, :got_l[i]],
                                          want_h[i, :want_l[i]])
        assert got_l.min() > 0

    def test_beam_decoder_with_gru_matches_jax(self, tmp_path):
        over = {**NARROW, "decode.beam_width": 16}
        jcfg = jax_config.get_config("swbd_beam_decode", **over)
        tcfg = config.get_config("swbd_beam_decode", **over)
        params, path = _jax_weights(jcfg, tmp_path, seed=4)
        model = checkpoint.load_npz(birnn.BiRNN(tcfg.model, device="cpu"), path)
        data = SyntheticCorpus(num_utterances=4, feature_dim=120,
                               min_chars=3, max_chars=6).all_utterances()
        label_seqs = [labels for _, labels in data]
        jp = jax_nlm.init_params(jax.random.PRNGKey(5),
                                 jax_nlm.CharRNNLMConfig(29, 12, 20))
        tp = neural_lm.params_from_jax(
            {k: np.asarray(v) for k, v in jp.items()}, device="cpu")
        batch = next(BucketedLoader(data, tcfg.data).epoch(0))[1]
        bd = batch_to_device_dict(batch)
        got = beam.make_beam_decoder(
            tcfg, lm=lm.train_ngram_lm(label_seqs, 29, order=3),
            nlm_params=tp, device="cpu")(model, bd)
        want = jax_beam.make_beam_decoder(
            jcfg, lm=jax_lm.train_ngram_lm(label_seqs, 29, order=3),
            nlm_params=jp)(params, bd)
        got_h, got_l = (x.numpy() for x in got)
        want_h, want_l = (np.asarray(x) for x in want)
        np.testing.assert_array_equal(got_l, want_l)
        for i in range(len(got_l)):
            np.testing.assert_array_equal(got_h[i, :got_l[i]],
                                          want_h[i, :want_l[i]])

    @staticmethod
    def _fallback(tmp_path, caplog, over, gru_dims=None, order=3, seed=6,
                  limit=None):
        """The JAX decoder and the port's on one batch of a configuration
        that the fused kernels do not take: -> (port, JAX) outputs, after
        checking that the port's decoder for a CUDA device raises
        ``NotImplementedError`` matching ``limit`` before it touches the
        device, and that on the CPU each decoder logged its warning for the
        same configuration."""
        jcfg = jax_config.get_config("swbd_beam_decode", **NARROW, **over)
        tcfg = config.get_config("swbd_beam_decode", **NARROW, **over)
        params, path = _jax_weights(jcfg, tmp_path, seed=seed)
        model = checkpoint.load_npz(birnn.BiRNN(tcfg.model, device="cpu"), path)
        data = SyntheticCorpus(num_utterances=4, feature_dim=120,
                               min_chars=3, max_chars=6).all_utterances()
        label_seqs = [labels for _, labels in data]
        jp = tp = None
        if gru_dims:
            jp = jax_nlm.init_params(jax.random.PRNGKey(seed + 1),
                                     jax_nlm.CharRNNLMConfig(29, *gru_dims))
            tp = neural_lm.params_from_jax(
                {k: np.asarray(v) for k, v in jp.items()}, device="cpu")
        bd = batch_to_device_dict(next(BucketedLoader(data, tcfg.data)
                                       .epoch(0))[1])
        tlm = lm.train_ngram_lm(label_seqs, 29, order=order)
        with pytest.raises(NotImplementedError, match=limit):
            beam.make_beam_decoder(tcfg, lm=tlm, nlm_params=tp, device="cuda")
        caplog.set_level("WARNING")
        got = beam.make_beam_decoder(tcfg, lm=tlm, nlm_params=tp,
                                     device="cpu")
        want = jax_beam.make_beam_decoder(
            jcfg, lm=jax_lm.train_ngram_lm(label_seqs, 29, order=order),
            nlm_params=jp)
        said = {r.name: r.getMessage() for r in caplog.records}
        assert "does not support this configuration" in said["tpu_ctc.decode"]
        assert (said["tpu_ctc_torch.decode"].split(" — ")[0]
                == said["tpu_ctc.decode"].split(" — ")[0])
        assert "plain search" in said["tpu_ctc_torch.decode"]
        return (lambda: got(model, bd)), (lambda: want(params, bd))

    @staticmethod
    def _assert_same_hyps(got, want):
        got_h, got_l = (x.numpy() for x in got)
        want_h, want_l = (np.asarray(x) for x in want)
        np.testing.assert_array_equal(got_l, want_l)
        for i in range(len(got_l)):
            np.testing.assert_array_equal(got_h[i, :got_l[i]],
                                          want_h[i, :want_l[i]])

    def test_decoder_raises_for_a_neural_lm(self, tmp_path, caplog):
        """A GRU char LM over the kernels' dims (H = 300 > 256) raises for a
        CUDA device; on the CPU the port warns and decodes on the plain
        search, as the JAX decoder does on its XLA search, with equal
        hypotheses."""
        got, want = self._fallback(tmp_path, caplog,
                                   {"decode.beam_width": 8}, gru_dims=(8, 300),
                                   limit="hidden 300")
        self._assert_same_hyps(got(), want())

    def test_decoder_raises_for_a_wide_beam(self, tmp_path, caplog):
        """K = 257, past B6's 256, raises for a CUDA device; on the CPU the
        warning, then the plain search, with the JAX decoder's
        hypotheses."""
        got, want = self._fallback(tmp_path, caplog,
                                   {"decode.beam_width": 257}, limit="257")
        self._assert_same_hyps(got(), want())

    def test_decoder_raises_for_lm_order_4(self, tmp_path, caplog):
        """LM order 4 raises for a CUDA device; on the CPU both decoders
        warn, then both raise ValueError at the first decode (the searches'
        LM rows take orders <= 3)."""
        got, want = self._fallback(tmp_path, caplog,
                                   {"decode.beam_width": 8}, order=4,
                                   limit="LM order 4")
        with pytest.raises(ValueError, match="order<=3"):
            want()
        with pytest.raises(ValueError, match="order<=3"):
            got()


def _cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "tpu_ctc_torch.cli", *args],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=timeout)


class TestCli:
    def test_decode_beam_on_cpu_and_score(self, tmp_path):
        sets = []
        for k, v in {**NARROW, "data.batch_size": 4,
                     "decode.beam_width": 8}.items():
            sets += ["--set", f"{k}={v}"]
        out = _cli("decode", "--config", "4", *sets, "--synthetic", "4",
                   "--beam", "--device", "cpu", "--hyp-out", str(tmp_path))
        assert out.returncode == 0, out.stderr
        assert "decoded 4 utterances on cpu" in out.stdout
        sc = _cli("score", "--ref", str(tmp_path / "ref.trn"),
                  "--hyp", str(tmp_path / "hyp.trn"), "--unit", "char")
        assert sc.returncode == 0, sc.stderr
        assert sc.stdout.startswith("CER ")

    def test_decode_beam_with_neural_lm_on_cpu(self):
        """``decode --beam`` with ``decode.neural_lm`` trains the GRU char
        LM on the transcripts and fuses it into the search
        (``tests/test_neural_lm.py::TestNeuralLMCli``)."""
        over = {"model.hidden_dim": 16, "model.input_dim": 8,
                "model.compute_dtype": "float32", "data.batch_size": 4,
                "data.bucket_boundaries": "(80,)", "decode.beam_width": 8,
                "decode.neural_lm": True, "decode.neural_lm_hidden": 16,
                "decode.neural_lm_embed": 8, "decode.neural_lm_steps": 5,
                "decode.lm_order": 0}
        sets = []
        for k, v in over.items():
            sets += ["--set", f"{k}={v}"]
        out = _cli("decode", "--config", "1", *sets, "--synthetic", "8",
                   "--beam", "--device", "cpu")
        assert out.returncode == 0, out.stderr
        # the one utterance longer than the 80-frame bucket is dropped
        assert "decoded 7 utterances on cpu" in out.stdout
        assert "CER " in out.stdout and "WER " in out.stdout

    def test_decode_beam_with_an_unsupported_gru_on_cpu(self):
        """On the CPU a GRU over the kernels' dims (H = 300) is decoded by
        the plain search with a warning; before, ``cli decode`` trained the
        GRU and then refused it."""
        over = {"model.hidden_dim": 16, "model.input_dim": 8,
                "model.compute_dtype": "float32", "data.batch_size": 4,
                "data.bucket_boundaries": "(80,)", "decode.beam_width": 8,
                "decode.neural_lm": True, "decode.neural_lm_hidden": 300,
                "decode.neural_lm_embed": 8, "decode.neural_lm_steps": 3,
                "decode.lm_order": 0}
        sets = []
        for k, v in over.items():
            sets += ["--set", f"{k}={v}"]
        out = _cli("decode", "--config", "1", *sets, "--synthetic", "8",
                   "--beam", "--device", "cpu")
        assert out.returncode == 0, out.stderr
        assert "decoded 7 utterances on cpu" in out.stdout
        assert "does not support this configuration" in out.stderr

    def test_decode_refuses_lm_order_4_before_the_lms_train(self,
                                                            monkeypatch):
        """LM order 4, which every search refuses, raises before either LM
        trains (in process: training one would raise here)."""
        from tpu_ctc_torch import cli
        from tpu_ctc_torch.decode import lm as tlm

        def trained(*args, **kwargs):
            raise AssertionError("an LM trained before the order check")
        monkeypatch.setattr(tlm, "train_char_lm_from_data", trained)
        monkeypatch.setattr(neural_lm, "train_nlm_from_data", trained)
        with pytest.raises(ValueError, match="order<=3, got 4"):
            cli.main(["decode", "--config", "1", "--set",
                      "model.hidden_dim=8", "--set", "decode.lm_order=4",
                      "--set", "decode.neural_lm=True", "--synthetic", "2",
                      "--beam", "--device", "cpu"])

    def test_decode_greedy_with_jax_weights(self, tmp_path):
        jcfg = jax_config.get_config("1", **{"model.hidden_dim": 16})
        _, path = _jax_weights(jcfg, tmp_path)
        out = _cli("decode", "--config", "1", "--set", "model.hidden_dim=16",
                   "--synthetic", "3", "--weights", path, "--device", "cpu")
        assert out.returncode == 0, out.stderr
        assert "decoded 3 utterances on cpu" in out.stdout
        assert "CER " in out.stdout

    def test_print_config_matches_jax(self):
        out = _cli("print-config", "--config", "4")
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == jax_config.get_config("4").to_json(
            indent=2)

    def test_frontend_flags_raise(self):
        """``--synthetic-audio`` decodes, from features within 1e-3 of the
        JAX CLI's (``PERF.md`` §2; the tones carry white noise, so no band
        is quiet)."""
        out = _cli("decode", "--config", "1", "--synthetic-audio", "2",
                   "--device", "cpu")
        assert out.returncode == 0, out.stderr
        assert "decoded 2 utterances on cpu" in out.stdout
        from tpu_ctc import cli as jax_cli
        from tpu_ctc_torch import cli
        got, _ = cli._synthetic_audio_data(config.get_config("1"), 2)
        want, _ = jax_cli._synthetic_audio_data(jax_config.get_config("1"), 2)
        assert len(got) == len(want) == 2
        for (gf, gl), (wf, wl) in zip(got, want):
            assert gf.shape == wf.shape and gf.shape[1] == 69
            np.testing.assert_array_equal(gl, wl)
            assert np.abs(gf - wf).max() <= 1e-3
