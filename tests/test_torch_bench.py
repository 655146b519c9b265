"""The port's benches on the CPU at tiny shapes, and its copy of the numpy
reference against the port's stack.

* ``bench.reference_numpy`` (a copy of the JAX package's, numpy only):
  its probability-space CTC against the port's ``losses/ctc_ref.py`` and
  its hand-written BRNN against the port's model with bridged weights
  (forward, and gradients through model and CTC), mirroring
  ``tests/test_reference_numpy.py``; and its outputs equal the JAX
  package's copy's.
* ``bench.bench``, ``bench.bench_ctc`` and ``bench.bench_decode`` with
  ``--device cpu``: one JSON line each with the JAX files' keys (and the
  renames: ``decode_vs_plain_search``; units per card, marked as the CPU's
  on the CPU).
* ``bench.bench_scaling --force-cpu-devices 2``: DP and SP over two gloo
  ranks; ``--strategy pp`` raises ``NotImplementedError``.
"""
import json

import numpy as np
import pytest
import torch

from tpu_ctc.bench import reference_numpy as jax_reference
from tpu_ctc_torch.bench import bench, bench_ctc, bench_decode, bench_scaling
from tpu_ctc_torch.bench.reference_numpy import (ReferenceBRNN,
                                                 ctc_loss_numpy, softmax)
from tpu_ctc_torch.config import ModelConfig
from tpu_ctc_torch.losses import ctc_ref
from tpu_ctc_torch.models import birnn

torch.set_num_threads(2)


class TestNumpyCTCvsTorch:
    def test_loss_and_grad_match(self, rng):
        for _ in range(5):
            t = rng.randint(6, 20)
            a = rng.randint(4, 9)
            n_l = rng.randint(1, min(t // 2, 6) + 1)
            logits = rng.randn(t, a).astype(np.float64)
            labels = rng.randint(1, a, n_l)
            probs = softmax(logits, axis=1)
            nll_np, grad_np = ctc_loss_numpy(probs.T, labels)
            jax_nll, jax_grad = jax_reference.ctc_loss_numpy(probs.T, labels)
            assert nll_np == jax_nll
            np.testing.assert_array_equal(grad_np, jax_grad)

            x = torch.tensor(logits[None], dtype=torch.float32,
                             requires_grad=True)
            lab = torch.tensor(labels[None], dtype=torch.int32)
            nll = ctc_ref.ctc_loss(x, lab, torch.tensor([t]),
                                   torch.tensor([n_l]))
            (g,) = torch.autograd.grad(nll.sum(), x)
            np.testing.assert_allclose(float(nll[0].detach()), nll_np,
                                       rtol=1e-4)
            np.testing.assert_allclose(g[0].numpy(), grad_np.T, rtol=1e-3,
                                       atol=1e-4)


def _bridged(ref: ReferenceBRNN, cfg: ModelConfig) -> birnn.BiRNN:
    """The port's model with the numpy reference's weights."""
    model = birnn.BiRNN(cfg, device="cpu")
    state = {}
    for kind, layers in (("pre", ref.pre), ("bi", ref.bi)):
        for i, layer in enumerate(layers):
            for k, v in layer.items():
                state[f"{kind}.{i}.{k}"] = torch.tensor(v, dtype=torch.float32)
    for k, v in ref.out.items():
        state[f"out.{k}"] = torch.tensor(v, dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    return model


class TestNumpyModelVsTorch:
    def test_forward_parity(self, rng):
        ref = ReferenceBRNN(input_dim=7, hidden_dim=12, vocab_size=9,
                            num_pre=1, num_bi=2, init_scale=0.1, seed=3)
        cfg = ModelConfig(input_dim=7, hidden_dim=12, num_pre_layers=1,
                          num_bi_layers=2, num_post_layers=0, vocab_size=9,
                          compute_dtype="float32")
        model = _bridged(ref, cfg)
        t = 15
        feats = rng.randn(t, 7).astype(np.float64)
        want = ref.forward(feats)                      # [T, A] posteriors
        np.testing.assert_array_equal(
            want, jax_reference.ReferenceBRNN(
                input_dim=7, hidden_dim=12, vocab_size=9, num_pre=1,
                num_bi=2, init_scale=0.1, seed=3).forward(feats))
        with torch.no_grad():
            logits = birnn.forward(model, cfg, torch.tensor(
                feats[None], dtype=torch.float32), torch.ones((1, t)))
        got = torch.softmax(logits[0], dim=-1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_grad_parity_handwritten_vs_autograd(self, rng):
        """The reference's hand-written backprop against torch autograd,
        end to end through the model and the CTC loss."""
        ref = ReferenceBRNN(input_dim=6, hidden_dim=10, vocab_size=8,
                            num_pre=1, num_bi=1, init_scale=0.1, seed=4)
        cfg = ModelConfig(input_dim=6, hidden_dim=10, num_pre_layers=1,
                          num_bi_layers=1, num_post_layers=0, vocab_size=8,
                          compute_dtype="float32")
        model = _bridged(ref, cfg)
        t, n_l = 12, 3
        feats = rng.randn(t, 6).astype(np.float64)
        labels = rng.randint(1, 8, n_l)
        nll_np, grads_np = ref.cost_and_grad(feats, labels)

        logits = birnn.forward(model, cfg, torch.tensor(
            feats[None], dtype=torch.float32), torch.ones((1, t)))
        nll = ctc_ref.ctc_loss(logits, torch.tensor(labels[None],
                                                    dtype=torch.int32),
                               torch.tensor([t]), torch.tensor([n_l])).sum()
        names = ["out.w", "bi.0.wf", "bi.0.wb", "bi.0.w", "pre.0.w"]
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(nll, [params[n] for n in names])
        np.testing.assert_allclose(float(nll.detach()), nll_np, rtol=1e-4)
        want = [grads_np["out"]["w"], grads_np["bi"][0]["wf"],
                grads_np["bi"][0]["wb"], grads_np["bi"][0]["w"],
                grads_np["pre"][0]["w"]]
        for name, g, w in zip(names, grads, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4,
                                       err_msg=name)


def _json_line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


# The root bench.py's keys, with decode_vs_xla_search renamed.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "decode_throughput",
              "decode_unit", "decode_vs_plain_search",
              "decode_neural_lm_throughput", "decode_preset4_throughput"}


class TestBenches:
    def test_bench_prints_one_line(self, capsys, monkeypatch):
        monkeypatch.setattr(bench, "PRESET4_SHAPE", (2, 8, 8))
        assert bench.main(["--steps", "2", "--hidden", "16", "--layers", "1",
                           "--batch", "4", "--frames", "9", "--cpu-utts", "1",
                           "--device", "cpu"]) == 0
        out = _json_line(capsys)
        assert set(out) == BENCH_KEYS
        assert out["metric"] == "train_throughput"
        assert out["unit"] == out["decode_unit"] == \
            "audio_seconds_per_second_on_cpu"
        assert bench.unit_for(torch.device("cuda")) == \
            "audio_seconds_per_second_per_card"
        assert all(isinstance(v, float) and v > 0 for k, v in out.items()
                   if k not in ("metric", "unit", "decode_unit"))

    def test_bench_ctc_prints_one_line(self, capsys):
        assert bench_ctc.main(["--batch", "3", "--frames", "20", "--labels",
                               "5", "--iters", "2", "--device", "cpu"]) == 0
        out = _json_line(capsys)
        assert set(out) == {"metric", "value", "unit", "vs_baseline"}
        assert out["metric"] == "ctc_grad_cells_per_s"
        assert out["unit"] == "Gcells/s (cpu wall clock)"
        assert out["vs_baseline"] > 0

    @pytest.mark.parametrize("extra", [
        ["--lm-order", "3", "--host-utts", "2"],
        ["--neural-lm", "16", "--sweep-beams", "4,130", "--skip-plain",
         "--host-utts", "1"]])
    def test_bench_decode_prints_one_line(self, capsys, extra):
        assert bench_decode.main(["--batch", "2", "--frames", "10", "--beam",
                                  "8", "--iters", "1", "--device", "cpu",
                                  *extra]) == 0
        out = _json_line(capsys)
        assert {"metric", "value", "unit", "vs_baseline"} <= set(out)
        assert out["metric"] == "decode_throughput"
        assert out["value"] > 0 and out["vs_baseline"] > 0
        if "--sweep-beams" in extra:
            assert set(out["beam_sweep"]) == {"4", "130"}

    @pytest.mark.parametrize("extra", [
        ["--beam", "257"], ["--vocab", "65"], ["--lm-order", "4"],
        ["--neural-lm", "300"], ["--sweep-beams", "64,300"]])
    def test_bench_decode_refuses_what_the_kernels_do_not_take(
            self, capsys, monkeypatch, extra):
        """On a card the device row is the kernels' path: a configuration
        B5 and B6 do not take raises before anything is timed, and the
        plain search never stands in for it."""
        import tpu_ctc_torch
        monkeypatch.setattr(tpu_ctc_torch, "resolve_device",
                            lambda device=None: torch.device("cuda"))
        with pytest.raises(NotImplementedError, match="beam_search kernel"):
            bench_decode.main(["--batch", "2", "--frames", "10", *extra])
        captured = capsys.readouterr()
        assert "ms/batch" not in captured.err and captured.out == ""

    @pytest.mark.parametrize("strategy", ["dp", "sp"])
    def test_scaling_on_gloo_ranks(self, capsys, strategy):
        assert bench_scaling.main([
            "--force-cpu-devices", "2", "--strategy", strategy,
            "--per-device-batch", "2", "--frames", "16", "--hidden", "16",
            "--layers", "1", "--steps", "1"]) == 0
        out = _json_line(capsys)
        assert out["metric"] == f"{strategy}_scaling_efficiency"
        assert out["unit"].startswith("t(1)/t(2)") and "(cpu)" in out["unit"]
        assert out["value"] > 0 and out["vs_baseline"] > 0

    def test_pipeline_scaling_is_not_ported(self, capsys):
        """``--strategy pp`` (once refused) runs: 2 gloo ranks as 2
        pipeline stages of one layer each, 4 microbatches of the fixed
        batch, against one rank."""
        assert bench_scaling.main([
            "--force-cpu-devices", "2", "--strategy", "pp",
            "--per-device-batch", "4", "--frames", "16", "--hidden", "16",
            "--layers", "2", "--steps", "1"]) == 0
        out = _json_line(capsys)
        assert out["metric"] == "pp_scaling_efficiency"
        assert out["unit"] == "t(1)/t(2) fixed batch (cpu)"
        assert out["value"] > 0 and out["vs_baseline"] > 0
