"""The port's weight bridge, its copied host modules and import hygiene.

The weight bridge must round-trip JAX ``init_params`` -> ``export_npz`` ->
the port's loader -> the port's ``export_npz`` bit for bit.  The modules
the port copies from the JAX package (config, synthetic data, bucketing,
the n-gram LM, host scoring) must give the same results as the originals.
The port never imports jax or ``tpu_ctc``, and its entry points default to
``cuda``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpu_ctc import config as jax_config
from tpu_ctc.data.bucketing import BucketedLoader as JaxLoader
from tpu_ctc.data.synthetic import SyntheticCorpus as JaxCorpus
from tpu_ctc.decode import lm as jax_lm
from tpu_ctc.decode import wer as jax_wer
from tpu_ctc.models import birnn as jax_birnn
from tpu_ctc.train import checkpoint as jax_ckpt
from tpu_ctc.train.loop import batch_to_device_dict as jax_batch_dict
from tpu_ctc_torch import config
from tpu_ctc_torch import resolve_device
from tpu_ctc_torch.data.bucketing import BucketedLoader
from tpu_ctc_torch.data.synthetic import SyntheticCorpus
from tpu_ctc_torch.decode import beam, lm, wer
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.train import checkpoint
from tpu_ctc_torch.train.loop import batch_to_device_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_weights(cfg, tmp_path, seed=0):
    params = jax_birnn.init_params(jax.random.PRNGKey(seed), cfg.model)
    path = str(tmp_path / "w.npz")
    jax_ckpt.export_npz(path, params)
    return params, path


def _cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "tpu_ctc_torch.cli", *args],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=timeout)


class TestWeightBridge:
    @pytest.mark.parametrize("preset,over", [
        ("swbd_beam_decode", {"model.hidden_dim": 32}),
        ("timit_subset_1layer", {}),
        ("default", {"model.num_post_layers": 1})])
    def test_round_trip_is_bitwise(self, tmp_path, preset, over):
        jcfg = jax_config.get_config(preset, **over)
        tcfg = config.get_config(preset, **over)
        _, path = _jax_weights(jcfg, tmp_path)
        model = checkpoint.load_npz(birnn.BiRNN(tcfg.model, device="cpu"), path)
        back = str(tmp_path / "back.npz")
        n = checkpoint.export_npz(model, back)
        with np.load(path) as a, np.load(back) as b:
            assert sorted(a.files) == sorted(b.files) and n == len(a.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])

    def test_params_from_jax_keys(self):
        flat = {"pre/0/w": np.ones((2, 3), np.float32),
                "bi/1/wf": np.zeros((3, 3), np.float32)}
        state = checkpoint.params_from_jax(flat)
        assert set(state) == {"pre.0.w", "bi.1.wf"}
        assert state["pre.0.w"].shape == (2, 3)

    def test_shape_mismatch_raises(self, tmp_path):
        jcfg = jax_config.get_config("default", **{"model.hidden_dim": 16})
        _, path = _jax_weights(jcfg, tmp_path)
        tcfg = config.get_config("default", **{"model.hidden_dim": 24})
        with pytest.raises(ValueError):
            checkpoint.load_npz(birnn.BiRNN(tcfg.model, device="cpu"), path)


class TestCopiedModules:
    @pytest.mark.parametrize("name", ["default", "1", "2", "3", "4", "5"])
    def test_presets_equal(self, name):
        assert (config.get_config(name).to_dict()
                == jax_config.get_config(name).to_dict())

    def test_override(self):
        over = {"model.hidden_dim": 77, "decode.beam_width": 9}
        assert (config.get_config("4", **over).to_json()
                == jax_config.get_config("4", **over).to_json())

    def test_synthetic_and_bucketing(self):
        kw = dict(num_utterances=9, feature_dim=12, min_chars=3,
                  max_chars=20)
        tdata = SyntheticCorpus(**kw).all_utterances()
        jdata = JaxCorpus(**kw).all_utterances()
        dcfg = config.DataConfig(batch_size=4, bucket_boundaries=(64, 160))
        jdcfg = jax_config.DataConfig(batch_size=4,
                                      bucket_boundaries=(64, 160))
        got = [batch_to_device_dict(b)
               for _, b in BucketedLoader(tdata, dcfg).epoch(1)]
        want = [jax_batch_dict(b)
                for _, b in JaxLoader(jdata, jdcfg).epoch(1)]
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in g:
                np.testing.assert_array_equal(g[key], w[key])

    def test_wer_host_functions(self):
        refs = {"a": "the cat sat", "b": "on the mat", "c": "x"}
        hyps = {"a": "the bat sat down", "b": "on mat"}
        for unit in ("word", "char"):
            assert (wer.score_corpus(refs, hyps, unit)
                    == jax_wer.score_corpus(refs, hyps, unit))
            assert (wer.format_score_line(wer.score_corpus(
                refs, hyps, unit)[0], unit) == jax_wer.format_score_line(
                    jax_wer.score_corpus(refs, hyps, unit)[0], unit))
        assert (wer.align_counts(list("kitten"), list("sitting"))
                == jax_wer.align_counts(list("kitten"), list("sitting")))

    def test_trn_round_trip(self, tmp_path):
        texts = {"utt1": "hello world", "utt2": "a b"}
        path = str(tmp_path / "h.trn")
        wer.write_trn(path, texts)
        assert wer.parse_trn(path) == jax_wer.parse_trn(path) == texts

    def test_lm_score_host(self):
        r = np.random.RandomState(0)
        seqs = [r.randint(1, 9, size=10) for _ in range(30)]
        tl = lm.train_ngram_lm(seqs, 9, order=3)
        jl = jax_lm.train_ngram_lm(seqs, 9, order=3)
        assert tl.score_host([3, 4], 5) == jl.score_host([3, 4], 5)
        assert lm.lm_perplexity(tl, seqs) == jax_lm.lm_perplexity(jl, seqs)


class TestImportHygiene:
    def test_no_jax_in_the_port(self):
        code = (
            "import importlib, os, pkgutil, sys\n"
            "import tpu_ctc_torch, torch_tools\n"
            "for pkg in (tpu_ctc_torch, torch_tools):\n"
            "    for m in pkgutil.walk_packages(pkg.__path__, "
            "pkg.__name__ + '.'):\n"
            "        importlib.import_module(m.name)\n"
            "bad = [n for n in sys.modules if n == 'jax' or "
            "n.startswith('jax.') or n == 'tpu_ctc' or "
            "n.startswith('tpu_ctc.')]\n"
            "assert not bad, bad\n"
            "root = os.getcwd()\n"
            "tools = os.path.join(root, 'tools') + os.sep\n"
            "bench = os.path.join(root, 'bench.py')\n"
            "files = {n: os.path.abspath(getattr(m, '__file__', None) or '')"
            " for n, m in list(sys.modules.items())}\n"
            "bad = [n for n, f in files.items() if f.startswith(tools) or "
            "f == bench]\n"
            "assert not bad, bad\n"
            "print(' '.join(n for n in sys.modules "
            "if n.startswith(('tpu_ctc_torch', 'torch_tools'))))\n")
        env = dict(os.environ, PYTHONPATH=REPO)
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, cwd=REPO, env=env, timeout=120)
        assert out.returncode == 0, out.stderr
        modules = out.stdout.split()
        assert len(modules) >= 20
        for name in ("decode.neural_lm", "frontend.features", "data.audio_io",
                     "data.manifest", "data.prefetch", "parallel.mesh",
                     "parallel.distributed", "parallel.seq_parallel",
                     "decode.cpp_decoder", "bench.reference_numpy",
                     "bench.bench", "bench.bench_ctc", "bench.bench_decode",
                     "bench.bench_scaling", "utils.profiling",
                     "utils.devtime", "parallel.tensor_parallel",
                     "parallel.pipeline", "decode.collective", "dryrun"):
            assert "tpu_ctc_torch." + name in modules
        for name in ("score", "make_manifest", "make_sample_corpus",
                     "sweep_decode", "preset_fit", "smoke_cuda_decode",
                     "mesh_steps", "eval_chain"):
            assert "torch_tools." + name in modules

    def test_sources_never_name_jax(self):
        paths = [os.path.join(REPO, "chip_smoke.py")]
        for sub in ("tpu_ctc_torch", "torch_tools"):
            for dirpath, _, files in os.walk(os.path.join(REPO, sub)):
                paths += [os.path.join(dirpath, f) for f in files
                          if f.endswith(".py")]
        for path in paths:
            text = open(path).read()
            assert "import jax" not in text, path
            assert "from tpu_ctc." not in text, path
            assert "from tpu_ctc import" not in text, path
            assert "import tpu_ctc." not in text, path

    def test_chip_smoke_fails_without_a_card_or_the_repo(self, tmp_path):
        """``chip_smoke.py`` alone in a directory exits non-zero (it cannot
        import the port) and prints no result; so does it in the repo
        without a card."""
        import shutil
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        dirs = [str(tmp_path)] + ([] if torch.cuda.is_available() else [REPO])
        for cwd in dirs:
            out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                                 capture_output=True, text=True, timeout=120)
            assert out.returncode != 0, cwd
            assert '"ok"' not in out.stdout, cwd

    def test_chip_smoke_stops_what_its_run_leaves(self):
        """The supervisor (``chip_smoke.supervise``) reaps the processes its
        run orphaned: one that ends within the grace, one that is killed
        after it; the run's exit code passes through."""
        child = ("import subprocess; subprocess.Popen(['sleep', '61']); "
                 "subprocess.Popen(['sleep', '0.5']); raise SystemExit(3)")
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; sys.exit(chip_smoke.supervise("
                "[sys.executable, '-c', sys.argv[2]], grace_s=2.0))")
        out = subprocess.run([sys.executable, "-c", code, REPO, child],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 3, out.stderr
        left = [x for x in out.stderr.splitlines() if "outlived" in x]
        assert len(left) == 2, out.stderr
        assert any("(killed): sleep 61" in x for x in left), left
        assert any("(ended): sleep 0.5" in x for x in left), left
        for line in left:
            pid = int(line.split()[2])
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)

    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            assert resolve_device().type == "cuda"
            return
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        with pytest.raises(RuntimeError):
            beam.make_beam_decoder(config.get_config("4"))
        assert resolve_device("cpu").type == "cpu"

    def test_model_default_device_is_cuda(self):
        mcfg = config.get_config("4", **{"model.hidden_dim": 8,
                                         "model.num_bi_layers": 1}).model
        if torch.cuda.is_available():
            assert birnn.BiRNN(mcfg).out.w.device.type == "cuda"
            return
        with pytest.raises(RuntimeError, match="CUDA"):
            birnn.BiRNN(mcfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            birnn.init_params(mcfg, seed=0)
        assert birnn.init_params(mcfg, seed=0,
                                 device="cpu").out.w.device.type == "cpu"

    def test_cli_default_device_fails_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        out = _cli("decode", "--config", "1", "--synthetic", "2")
        assert out.returncode != 0 and "CUDA" in out.stderr
