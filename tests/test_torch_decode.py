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

    def test_decoder_raises_for_a_neural_lm(self):
        """A GRU char LM over the kernels' dims (H = 300 > 256) raises on
        every device while the config asks for the fused kernel."""
        cfg = config.get_config("4")
        gru = neural_lm.CharRNNLM(neural_lm.CharRNNLMConfig(29, 64, 300),
                                  device="cpu")
        with pytest.raises(NotImplementedError, match="hidden 300"):
            beam.make_beam_decoder(cfg, nlm_params=gru, device="cpu")
        plain = cfg.override(**{"decode.use_fused_kernel": False})
        beam.make_beam_decoder(plain, nlm_params=gru, device="cpu")

    def test_decoder_raises_for_a_wide_beam(self):
        cfg = config.get_config("4", **{"decode.beam_width": 257})
        with pytest.raises(NotImplementedError, match="257"):
            beam.make_beam_decoder(cfg, device="cpu")


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
        out = _cli("decode", "--config", "1", "--synthetic-audio", "2",
                   "--device", "cpu")
        assert out.returncode != 0 and "frontend" in out.stderr
