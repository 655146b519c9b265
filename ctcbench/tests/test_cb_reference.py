"""The reference against the port at tiny sizes on the CPU, in float32:
the same model, loss, step, LM and search by two independent routes."""

import numpy as np
import pytest
import torch

from ctcbench import weights
from ctcbench.reference import beam, ctc, lm, model, train
from tpu_ctc_torch.config import get_config


def _cfg():
    cfg = get_config("2", **{"model.hidden_dim": 16,
                             "model.compute_dtype": "float32",
                             "model.birnn_impl": "scan"})
    return cfg, cfg.to_dict()


def _batch(seed=0, b=3, t=12, d=120, vocab=29):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, t - 3, t - 5][:b], np.int32)
    feats = rng.standard_normal((b, t, d)).astype(np.float32)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    labels = rng.integers(1, vocab, (b, 4)).astype(np.int32)
    return {"feats": torch.tensor(feats * mask[:, :, None]),
            "frame_mask": torch.tensor(mask),
            "frame_lengths": torch.tensor(lengths),
            "labels": torch.tensor(labels),
            "label_lengths": torch.tensor([4, 3, 2][:b], dtype=torch.int32),
            "weights": torch.ones(b)}


def _port_model(cfg, w0):
    from tpu_ctc_torch.models.birnn import BiRNN
    m = BiRNN(cfg.model, device="cpu")
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(w0[k])
    return m


def test_log_posteriors_match_the_port():
    from tpu_ctc_torch.models import birnn
    cfg, d = _cfg()
    w0 = weights.make_weights(d["model"], {"std": 0.3}, 5, "cpu")
    b = _batch()
    port = birnn.log_posteriors(_port_model(cfg, w0), cfg.model, b["feats"],
                                b["frame_mask"])
    ref = model.log_posteriors(w0, d["model"], b["feats"], b["frame_mask"])
    live = b["frame_mask"] > 0
    torch.testing.assert_close(ref[live], port[live], atol=1e-5, rtol=1e-5)


def test_ctc_matches_the_port():
    from tpu_ctc_torch.losses import ctc_ref
    b = _batch()
    lp = torch.log_softmax(torch.randn(3, 12, 29), -1)
    got = ctc.nll(lp, b["labels"], b["frame_lengths"], b["label_lengths"])
    want = ctc_ref.ctc_loss_from_log_probs(lp, b["labels"], b["frame_lengths"],
                                           b["label_lengths"])
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def test_three_steps_match_the_ports_train_step():
    from tpu_ctc_torch.train import optim
    from tpu_ctc_torch.train.step import TrainState, train_step
    cfg, d = _cfg()
    w0 = weights.make_weights(d["model"], {"std": 0.1}, 6, "cpu")
    m = _port_model(cfg, w0)
    state = TrainState(0, m, optim.init_opt_state(dict(m.named_parameters())))
    batches = [_batch(s) for s in range(3)]
    losses, grad = [], None
    for i, b in enumerate(batches):
        state, metrics = train_step(state, b, cfg)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad = train.leaf_norms(state.opt_state.trace)
    ref = train.run_steps(w0, {"port": d}, batches)
    np.testing.assert_allclose(ref["losses"], losses, rtol=1e-5)
    for k in grad:
        assert ref["grad"][k] == pytest.approx(grad[k], rel=1e-4, abs=1e-7)
    change = train.leaf_norms({k: p - w0[k] for k, p in m.named_parameters()})
    for k in change:
        assert ref["change"][k] == pytest.approx(change[k], rel=1e-4,
                                                 abs=1e-7)


def test_lm_and_search_match_the_port():
    from tpu_ctc_torch.decode.beam import prefix_beam_search
    from tpu_ctc_torch.decode.lm import train_ngram_lm
    rng = np.random.default_rng(3)
    seqs = [rng.integers(1, 29, rng.integers(1, 30)) for _ in range(100)]
    table = lm.train(seqs, 29, 3, 0.25)
    np.testing.assert_array_equal(table, train_ngram_lm(seqs, 29, 3).logp)
    gen = torch.Generator().manual_seed(1)
    lp = torch.log_softmax(3 * torch.randn(4, 40, 29, generator=gen), -1)
    lens = torch.tensor([40, 33, 20, 7])
    tab = torch.tensor(table)
    want = prefix_beam_search(lp, lens, beam_width=8, max_len=24,
                              lm_table=tab, lm_order=3, lm_alpha=1.25,
                              lm_beta=1.5, prune_logp=-12.0)
    got = beam.search(lp, lens, 8, 24, tab, 3, 1.25, 1.5, -12.0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)
