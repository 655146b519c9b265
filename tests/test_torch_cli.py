"""Audio in, text out on the CPU: the port's CLI round trip on a manifest
corpus, against the JAX CLI, and the train extras that path needs.

* ``train --data`` (with ``train.eval_beam``) -> ``decode --checkpoint
  --split valid --beam --hyp-out`` -> ``score``, and ``export-weights`` ->
  ``decode --weights`` giving the same hypotheses.  The trn files carry
  the manifest's ids.
* The greedy hypotheses of ``decode --weights`` equal the JAX CLI's
  ``decode --checkpoint`` on the same weights (its orbax checkpoint and
  the npz export of it) and the same manifest: equal text, utterance by
  utterance.
* ``models/birnn.py`` with ``model.remat``: loss and gradients bit-equal to
  the run without it, the forward sweeps run twice.
* ``train.optim.opt_state_from_jax``: an optax state carried over gives the
  optax chain's next update (1e-6, f32 of the same chain).
* ``decode.wer.batched_edit_distance`` against the JAX one and the host
  ``edit_distance``: equal integers.
"""
import contextlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_ctc import cli as jax_cli
from tpu_ctc import config as jax_config
from tpu_ctc.decode import wer as jax_wer
from tpu_ctc.train import checkpoint as jax_ckpt
from tpu_ctc.train import optim as jax_optim
from tpu_ctc.train import step as jax_step
from tpu_ctc_torch import cli, config
from tpu_ctc_torch.data import audio_io
from tpu_ctc_torch.data.alphabet import DEFAULT_ALPHABET
from tpu_ctc_torch.data.bucketing import BucketedLoader
from tpu_ctc_torch.data.manifest import write_manifest
from tpu_ctc_torch.data.synthetic import SyntheticCorpus, synthetic_audio_batch
from tpu_ctc_torch.decode import wer
from tpu_ctc_torch.decode.wer import parse_trn
from tpu_ctc_torch.ops import birnn_cuda
from tpu_ctc_torch.train import optim, step
from tpu_ctc_torch.train.loop import batch_to_device_dict

torch.set_num_threads(2)

# Preset 2 cut to size: its frontend (40 mels, context 1: 120 features),
# H = 16, one bidirectional layer, f32 compute, batches of 4.
SETS = ["--set", "model.hidden_dim=16", "--set", "model.num_bi_layers=1",
        "--set", "model.compute_dtype=float32",
        "--set", "data.batch_size=4",
        "--set", "data.bucket_boundaries=(100,200)",
        "--set", "decode.beam_width=8"]


def _make_corpus(root):
    """train (16) and valid (6) splits of tone waveforms with white noise,
    3-8 characters at 0.2 s each."""
    os.makedirs(root, exist_ok=True)
    for split, n, seed in (("train", 16, 0), ("valid", 6, 1)):
        audio, sl, labels, ll = synthetic_audio_batch(
            n, 16000 * 2, min_chars=3, max_chars=8, seed=seed,
            samples_per_char=3200)
        recs = []
        for i in range(n):
            name = f"{split}{i:03d}.wav"
            audio_io.write_wav(os.path.join(root, name), audio[i, :sl[i]],
                               16000)
            recs.append({"id": f"{split}-{i:03d}", "audio": name,
                         "text": DEFAULT_ALPHABET.decode(labels[i, :ll[i]]),
                         "samples": int(sl[i]), "rate": 16000})
        write_manifest(root, split, recs)
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _make_corpus(str(tmp_path_factory.mktemp("cli_corpus")))


def _run(capsys, main, *args):
    assert main(list(args)) == 0
    return capsys.readouterr().out


class TestRoundTrip:
    def test_train_decode_score_export(self, corpus, tmp_path, capsys,
                                       monkeypatch):
        from tpu_ctc_torch.decode import lm
        lm_sizes = []
        train_lm = lm.train_char_lm_from_data

        def recorded(data, cfg):
            lm_sizes.append(len(data))
            return train_lm(data, cfg)
        monkeypatch.setattr(lm, "train_char_lm_from_data", recorded)
        work = str(tmp_path / "run")
        out = _run(capsys, cli.main, "train", "--config", "2", *SETS,
                   "--set", "train.num_epochs=2", "--set", "train.log_every=1",
                   "--set", "train.eval_every=4",
                   "--set", "train.eval_beam=True",
                   "--data", corpus, "--work-dir", work, "--device", "cpu")
        assert "'step': 8" in out
        assert os.listdir(os.path.join(work, "checkpoints")) == [
            "step_00000008.pt"]
        with open(os.path.join(work, "metrics.jsonl")) as f:
            evals = [line for line in f if '"eval"' in line]
        assert len(evals) == 2 and '"beam_wer"' in evals[0] \
            and '"beam_cer"' in evals[0]

        hyp_ck = str(tmp_path / "hyp_ck")
        out = _run(capsys, cli.main, "decode", "--config", "2", *SETS,
                   "--checkpoint", os.path.join(work, "checkpoints"),
                   "--data", corpus, "--split", "valid", "--beam",
                   "--hyp-out", hyp_ck, "--device", "cpu")
        assert "decoded 6 utterances on cpu" in out
        assert lm_sizes == [16]         # the LM trains on the train split
        hyps = parse_trn(os.path.join(hyp_ck, "hyp.trn"))
        refs = parse_trn(os.path.join(hyp_ck, "ref.trn"))
        assert sorted(hyps) == sorted(refs) == [f"valid-{i:03d}"
                                                for i in range(6)]
        out = _run(capsys, cli.main, "score",
                   "--ref", os.path.join(hyp_ck, "ref.trn"),
                   "--hyp", os.path.join(hyp_ck, "hyp.trn"))
        assert "WER " in out and "CER " in out and "6 utts" in out

        npz = str(tmp_path / "w.npz")
        out = _run(capsys, cli.main, "export-weights", "--config", "2",
                   *SETS, "--checkpoint", os.path.join(work, "checkpoints"),
                   "--out", npz, "--device", "cpu")
        assert "(step 8)" in out
        hyp_w = str(tmp_path / "hyp_w")
        _run(capsys, cli.main, "decode", "--config", "2", *SETS,
             "--weights", npz, "--data", corpus, "--split", "valid",
             "--beam", "--hyp-out", hyp_w, "--device", "cpu")
        assert parse_trn(os.path.join(hyp_w, "hyp.trn")) == hyps

    def test_decode_without_a_checkpoint_fails(self, corpus, tmp_path,
                                               capsys):
        assert cli.main(["decode", "--config", "2", *SETS, "--checkpoint",
                         str(tmp_path), "--data", corpus,
                         "--device", "cpu"]) == 1
        assert "no checkpoint found" in capsys.readouterr().err

    def test_greedy_hypotheses_equal_the_jax_cli(self, corpus, tmp_path,
                                                 capsys):
        sets = [*SETS, "--set", "model.init_scale=0.3",
                "--set", "mesh.data=1"]
        over = jax_cli._parse_overrides(sets[1::2])
        jstate = jax_step.create_train_state(jax_config.get_config(
            "2", **over))
        ckdir = str(tmp_path / "jax_ckpt")
        mgr = jax_ckpt.make_manager(ckdir)
        jax_ckpt.save(mgr, jstate, 0, 0, force=True)
        mgr.wait_until_finished()
        npz = str(tmp_path / "w.npz")
        jax_ckpt.export_npz(npz, jstate.params)
        jh, th = str(tmp_path / "jax_hyp"), str(tmp_path / "torch_hyp")
        _run(capsys, jax_cli.main, "decode", "--config", "2", *sets,
             "--checkpoint", ckdir, "--data", corpus, "--split", "valid",
             "--hyp-out", jh)
        _run(capsys, cli.main, "decode", "--config", "2", *sets,
             "--weights", npz, "--data", corpus, "--split", "valid",
             "--hyp-out", th, "--device", "cpu")
        want = parse_trn(os.path.join(jh, "hyp.trn"))
        got = parse_trn(os.path.join(th, "hyp.trn"))
        assert len(want) == 6 and sum(len(h) for h in want.values()) > 0
        assert got == want
        assert parse_trn(os.path.join(th, "ref.trn")) == parse_trn(
            os.path.join(jh, "ref.trn"))


SMALL = {"model.hidden_dim": 32, "model.num_bi_layers": 2,
         "data.batch_size": 4, "data.bucket_boundaries": (48,),
         "data.sortagrad": False, "model.init_scale": 0.2}


@contextlib.contextmanager
def _calls_of(fn):
    """The calls of the Python function ``fn`` in this thread, counted by
    a profile hook (nothing is replaced): a list that grows by one a
    call."""
    calls, prev = [], sys.getprofile()

    def hook(frame, event, arg):
        if event == "call" and frame.f_code is fn.__code__:
            calls.append(1)
    sys.setprofile(hook)
    try:
        yield calls
    finally:
        sys.setprofile(prev)


class TestRemat:
    @pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
    def test_loss_and_gradients_bit_equal(self, cdt):
        cfg = config.get_config("2", **SMALL, **{"model.compute_dtype": cdt})
        data = SyntheticCorpus(8, feature_dim=cfg.model.input_dim,
                               min_chars=2, max_chars=5,
                               seed=1).all_utterances()
        batch = next(BucketedLoader(data, cfg.data).epoch(0))[1]
        bt = step.batch_to_tensors(batch_to_device_dict(batch), "cpu")
        state = step.create_train_state(cfg, device="cpu")

        def loss_and_grads(remat):
            c = cfg.override(**{"model.remat": remat})
            params = dict(state.model.named_parameters())
            # on the CPU each direction's forward sweep is the plain loop
            with _calls_of(birnn_cuda.fwd_recurrence_plain) as sweeps:
                loss, _ = step.loss_fn(state.model, c, bt)
                grads = torch.autograd.grad(loss, list(params.values()))
            return loss, dict(zip(params, grads)), len(sweeps)
        loss0, g0, n0 = loss_and_grads(False)
        loss1, g1, n1 = loss_and_grads(True)
        assert torch.equal(loss0, loss1)
        for k in g0:
            assert torch.equal(g0[k], g1[k]), k
        n_sweeps = 2 * cfg.model.num_bi_layers
        assert (n0, n1) == (n_sweeps, 2 * n_sweeps)


class TestOptStateFromJax:
    def test_carried_state_continues_the_optax_chain(self):
        ocfg = config.OptimConfig(momentum_start=0.5, momentum_ramp_steps=5)
        jcfg = jax_config.OptimConfig(momentum_start=0.5,
                                      momentum_ramp_steps=5)
        r = np.random.RandomState(4)
        shapes = {"pre/0/w": (5, 3), "out/b": (7,)}
        p0 = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
        grads = [{k: r.randn(*s).astype(np.float32)
                  for k, s in shapes.items()} for _ in range(4)]
        tx = jax_optim.make_optimizer(jcfg)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        js = tx.init(jp)
        for g in grads[:3]:
            upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp)
            jp = optax.apply_updates(jp, upd)
        inner = [s for s in js if hasattr(s, "inner_state")][0]
        ts = optim.opt_state_from_jax(
            {k: np.asarray(v) for k, v in inner.inner_state.trace.items()},
            np.asarray(inner.count), device="cpu")
        assert ts.count == 3 and set(ts.trace) == {"pre.0.w", "out.b"}
        tp = {k.replace("/", "."): torch.from_numpy(np.array(v))
              for k, v in jp.items()}
        upd, js = tx.update({k: jnp.asarray(v) for k, v in grads[3].items()},
                            js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = optim.apply_updates(tp, {k.replace("/", "."): torch.from_numpy(v)
                                      for k, v in grads[3].items()}, ts, ocfg)
        assert ts.count == 4
        for k, v in jp.items():
            np.testing.assert_allclose(tp[k.replace("/", ".")].numpy(),
                                       np.asarray(v), rtol=1e-6, atol=1e-6)


class TestBatchedEditDistance:
    @pytest.mark.parametrize("seed,n,m", [(0, 12, 9), (1, 5, 20), (2, 30, 30)])
    def test_matches_jax_and_the_host_distance(self, seed, n, m):
        r = np.random.RandomState(seed)
        b = 6
        refs = r.randint(1, 5, (b, n)).astype(np.int32)
        hyps = r.randint(1, 5, (b, m)).astype(np.int32)
        ref_lens = r.randint(0, n + 1, b).astype(np.int32)
        hyp_lens = r.randint(0, m + 1, b).astype(np.int32)
        ref_lens[0], hyp_lens[0] = n, m
        hyps[1, :min(n, m)] = refs[1, :min(n, m)]     # a near match
        got = wer.batched_edit_distance(
            torch.from_numpy(refs), torch.from_numpy(ref_lens),
            torch.from_numpy(hyps), torch.from_numpy(hyp_lens))
        want = jax_wer.batched_edit_distance(
            jnp.asarray(refs), jnp.asarray(ref_lens), jnp.asarray(hyps),
            jnp.asarray(hyp_lens))
        host = [wer.edit_distance(list(refs[i, :ref_lens[i]]),
                                  list(hyps[i, :hyp_lens[i]]))
                for i in range(b)]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.tolist() == host
        ref_lens = np.maximum(ref_lens, 1)
        host_cer = wer.cer([list(refs[i, :ref_lens[i]]) for i in range(b)],
                           [list(hyps[i, :hyp_lens[i]]) for i in range(b)])
        assert float(wer.batched_cer(
            torch.from_numpy(refs), torch.from_numpy(ref_lens),
            torch.from_numpy(hyps), torch.from_numpy(hyp_lens))) \
            == pytest.approx(host_cer, rel=1e-6)
