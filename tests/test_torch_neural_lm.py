"""The port's GRU char LM and the GRU-LM beam search against the JAX package.

All inputs come from numpy seeds; the GRU weights are made by JAX's
``init_params`` and carried over with ``params_from_jax``, so both packages
compute with the same GRU.  The LM functions agree within 1e-5 (f32 sums in
other orders).  The searches with a GRU must give equal hypotheses and
lengths, with scores within 1e-4: the neural path is not bit-exact in the
reference either (torch and XLA take the matmuls' sums, exp and log in
other orders and ways).  The CUDA kernels B5 and B6 run only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); their GRU products'
arithmetic, the three-pass TF32 split, is held here to JAX's
``Precision.HIGHEST`` through its plain version
``ops.beam_cuda.split_tf32_matmul``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_ctc.decode import beam as jax_beam
from tpu_ctc.decode import neural_lm as jax_nlm
from tpu_ctc.decode.lm import train_ngram_lm as jax_train_ngram_lm
from tpu_ctc.ops import beam_pallas
from tpu_ctc_torch.decode import beam, neural_lm
from tpu_ctc_torch.decode.lm import train_ngram_lm
from tpu_ctc_torch.ops import beam_cuda

torch.set_num_threads(2)


def _jax_lm(seed, v, e, h):
    cfg = jax_nlm.CharRNNLMConfig(vocab_size=v, embed_dim=e, hidden_dim=h)
    return jax_nlm.init_params(jax.random.PRNGKey(seed), cfg)


def _bridged(jp):
    return neural_lm.params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def _posteriors(seed, b, t, a, scale=2.0):
    r = np.random.RandomState(seed)
    x = r.randn(b, t, a).astype(np.float32) * scale
    x = x - x.max(axis=-1, keepdims=True)
    lp = (x - np.log(np.exp(x).sum(axis=-1, keepdims=True))).astype(np.float32)
    lens = r.randint(max(1, t // 2), t + 1, size=b).astype(np.int32)
    lens[0] = t
    return lp, lens


def _seqs(seed, n, a, lo=3, hi=20):
    r = np.random.RandomState(seed)
    return [r.randint(1, a, size=r.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _assert_same(got, want, atol=1e-4):
    gh, gl, gs = (np.asarray(x) for x in got[:3])
    wh, wl, ws = (np.asarray(x) for x in want[:3])
    np.testing.assert_array_equal(gl, wl)
    for i in range(len(gl)):
        np.testing.assert_array_equal(gh[i, :gl[i]], wh[i, :wl[i]])
    np.testing.assert_allclose(gs, ws, rtol=0, atol=atol)


class TestLMFunctions:
    @pytest.mark.parametrize("v,e,h", [(29, 64, 128), (7, 10, 13)])
    def test_gru_step_log_probs_init_state(self, v, e, h):
        jp = _jax_lm(v + h, v, e, h)
        tp = _bridged(jp)
        r = np.random.RandomState(h)
        hs = (0.5 * r.randn(6, h)).astype(np.float32)
        ids = r.randint(0, v, 6)
        want = np.asarray(jax_nlm.gru_step(jp, jnp.asarray(hs),
                                           jnp.asarray(ids)))
        with torch.no_grad():
            got = neural_lm.gru_step(tp, torch.from_numpy(hs),
                                     torch.from_numpy(ids)).numpy()
            lp = neural_lm.log_probs(tp, torch.from_numpy(hs)).numpy()
            h0 = neural_lm.init_state(tp, (2, 3)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        want_lp = np.asarray(jax_nlm.log_probs(jp, jnp.asarray(hs)))
        live = np.arange(v) != 0
        np.testing.assert_allclose(lp[:, live], want_lp[:, live], rtol=0,
                                   atol=1e-5)
        assert (lp[:, 0] < -1e20).all() and (want_lp[:, 0] < -1e20).all()
        np.testing.assert_allclose(np.exp(lp).sum(-1), 1.0, atol=1e-5)
        want_h0 = np.asarray(jax_nlm.init_state(jp, (2, 3)))
        np.testing.assert_allclose(h0, want_h0, rtol=0, atol=1e-6)
        assert np.abs(h0).max() > 0       # one BOS step, not zeros

    def test_sequence_nll_and_gradient(self):
        jp = _jax_lm(3, 9, 8, 16)
        tp = _bridged(jp)
        seqs = _seqs(4, 5, 9, 2, 12)
        padded, lens = neural_lm.pad_label_seqs(seqs, max_len=12)
        want, grads = jax.value_and_grad(jax_nlm.sequence_nll)(
            jp, jnp.asarray(padded), jnp.asarray(lens))
        got = neural_lm.sequence_nll(tp, torch.from_numpy(padded),
                                     torch.from_numpy(lens))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
        for name, g in grads.items():
            g = np.asarray(g)
            np.testing.assert_allclose(
                getattr(tp, name).grad.numpy(), g, rtol=0,
                atol=1e-5 * max(1.0, float(np.abs(g).max())), err_msg=name)

    def test_adam_updates_match_optax(self):
        jp = _jax_lm(5, 9, 8, 16)
        tp = _bridged(jp)
        seqs = _seqs(6, 24, 9, 3, 16)
        padded, lens = neural_lm.pad_label_seqs(seqs, max_len=16)
        tx = optax.adam(3e-3)
        state = tx.init(jp)
        opt = torch.optim.Adam(tp.parameters(), lr=3e-3)
        r = np.random.RandomState(7)
        for _ in range(5):
            idx = r.randint(0, len(seqs), 8)
            want, grads = jax.value_and_grad(jax_nlm.sequence_nll)(
                jp, jnp.asarray(padded[idx]), jnp.asarray(lens[idx]))
            updates, state = tx.update(grads, state)
            jp = optax.apply_updates(jp, updates)
            got = neural_lm.adam_update(tp, opt, torch.from_numpy(padded[idx]),
                                        torch.from_numpy(lens[idx]))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        for name, p in jp.items():
            p = np.asarray(p)
            rel = (np.linalg.norm(getattr(tp, name).detach().numpy() - p)
                   / np.linalg.norm(p))
            assert rel < 1e-5, (name, rel)

    def test_nll_decreases_on_patterned_corpus(self):
        seqs = [np.array(([1, 2, 3] * 8)[:20], np.int32) for _ in range(32)]
        cfg = neural_lm.CharRNNLMConfig(vocab_size=5, embed_dim=16,
                                        hidden_dim=32)
        padded = torch.from_numpy(np.stack(seqs))
        lens = torch.full((len(seqs),), 20)
        with torch.no_grad():
            nll0 = float(neural_lm.sequence_nll(
                neural_lm.init_params(cfg, 0, device="cpu"), padded, lens))
        _, nll = neural_lm.train_char_rnn_lm(seqs, cfg, steps=200,
                                             batch_size=16, device="cpu")
        assert nll < nll0 * 0.5, (nll0, nll)

    def test_params_from_jax_checks_shapes(self):
        jp = {k: np.asarray(v) for k, v in _jax_lm(0, 6, 4, 8).items()}
        jp["wo"] = jp["wo"][:, :5]
        with pytest.raises(ValueError):
            neural_lm.params_from_jax(jp, device="cpu")


class TestSearchAgainstJax:
    @pytest.mark.parametrize("order", [0, 2])
    def test_against_xla_search(self, order):
        a = 8
        jp = _jax_lm(2, a, 8, 16)
        lp, lens = _posteriors(order + 1, 3, 15, a)
        kw = dict(beam_width=8, max_len=16, lm_alpha=0.6, lm_beta=0.3)
        tab, jtab = None, None
        if order:
            seqs = _seqs(8, 40, a)
            tab = train_ngram_lm(seqs, a, order=order).tables("cpu")
            jtab = jnp.asarray(jax_train_ngram_lm(seqs, a, order=order).logp)
        want = jax_beam.prefix_beam_search(
            jnp.asarray(lp), jnp.asarray(lens), nlm_params=jp,
            lm_table=jtab, lm_order=order, **kw)
        got = beam.prefix_beam_search(
            torch.from_numpy(lp), torch.from_numpy(lens),
            nlm_params=_bridged(jp), lm_table=tab, lm_order=order, **kw)
        _assert_same(got, want)

    @pytest.mark.parametrize("k,a,e,h,t", [(16, 29, 10, 13, 12),
                                           (160, 8, 8, 16, 10)])
    def test_against_pallas_kernel(self, k, a, e, h, t):
        """K = 16 at A = 29 with unaligned GRU dims (the narrow kernel B5),
        and K = 160 (the wide kernel B6), in interpret mode."""
        jp = _jax_lm(k, a, e, h)
        lp, lens = _posteriors(k + a, 2, t, a)
        kw = dict(beam_width=k, max_len=16, lm_alpha=0.6, lm_beta=0.3)
        want = beam_pallas.beam_search_pallas(
            jnp.asarray(lp), jnp.asarray(lens), nlm_params=jp, **kw)
        got = beam.prefix_beam_search(
            torch.from_numpy(lp), torch.from_numpy(lens),
            nlm_params=_bridged(jp), **kw)
        _assert_same(got, want)

    def test_host_decoder_with_gru(self):
        t, a, k = 8, 4, 8
        jp = _jax_lm(2, a, 8, 16)
        tp = _bridged(jp)
        lp, _ = _posteriors(3, 1, t, a, scale=1.5)
        kw = dict(beam_width=k, lm_alpha=0.6, lm_beta=0.3)
        h_best, h_score = beam.prefix_beam_search_host(
            lp[0], lm=neural_lm.CharRNNLMHost(tp), **kw)
        j_best, j_score = jax_beam.prefix_beam_search_host(
            lp[0], lm=jax_nlm.CharRNNLMHost(jp), **kw)
        assert h_best == j_best
        np.testing.assert_allclose(h_score, j_score, rtol=0, atol=1e-4)
        hyps, lens, scores = beam.prefix_beam_search(
            torch.from_numpy(lp), torch.tensor([t]), max_len=t,
            nlm_params=tp, **kw)
        assert hyps[0, :int(lens[0])].tolist() == h_best
        np.testing.assert_allclose(float(scores[0]), h_score, rtol=1e-3)

    def test_host_decoder_with_ngram(self):
        lp, _ = _posteriors(4, 1, 10, 6)
        seqs = _seqs(9, 30, 6)
        kw = dict(beam_width=6, lm_alpha=0.8, lm_beta=0.2)
        got = beam.prefix_beam_search_host(
            lp[0], lm=train_ngram_lm(seqs, 6, order=2), **kw)
        want = jax_beam.prefix_beam_search_host(
            lp[0], lm=jax_train_ngram_lm(seqs, 6, order=2), **kw)
        assert got == want

    def test_train_nlm_from_data(self):
        from tpu_ctc_torch.config import get_config
        cfg = get_config("4", **{"decode.neural_lm": True,
                                 "decode.neural_lm_embed": 8,
                                 "decode.neural_lm_hidden": 12,
                                 "decode.neural_lm_steps": 3})
        data = [(None, s) for s in _seqs(1, 10, 29)]
        model = neural_lm.train_nlm_from_data(data, cfg, device="cpu")
        assert model.wz.shape == (20, 12) and model.embed.shape == (29, 8)
        assert neural_lm.train_nlm_from_data(
            data, cfg.override(**{"decode.neural_lm": False})) is None


# |split - HIGHEST| on the GRU's products at E = 64, H = 128, A = 29: the
# operands' representation error is ~2^-22 relative (lo's rounding and the
# dropped lo * lo term) and the f32 sums add a few ulps of values up to 3,
# so 4e-6 holds with room (1.5e-6 seen); one TF32 pass (10 mantissa bits
# an operand) errs by ~7e-4.
SPLIT_TOL = 4e-6


class TestSplitTf32:
    @pytest.mark.parametrize("product", ["lm_rows", "z_r", "candidate"])
    def test_split_matches_highest(self, product):
        e, h, a = 64, 128, 29
        jp = {k: np.asarray(v) for k, v in _jax_lm(11, a, e, h).items()}
        r = np.random.RandomState(12)
        states = np.tanh(1.5 * r.randn(48, h)).astype(np.float32)
        w = {"lm_rows": jp["wo"],
             "z_r": np.concatenate([jp["wz"][e:], jp["wr"][e:]], axis=1),
             "candidate": jp["wh"][e:]}[product]
        want = np.asarray(jnp.dot(jnp.asarray(states), jnp.asarray(w),
                                  precision=jax.lax.Precision.HIGHEST))
        x, y = torch.from_numpy(states), torch.from_numpy(w.copy())
        err = np.abs(beam_cuda.split_tf32_matmul(x, y).numpy() - want).max()
        one_pass = (beam_cuda.tf32_round(x) @ beam_cuda.tf32_round(y)).numpy()
        err_one = np.abs(one_pass - want).max()
        assert err <= SPLIT_TOL, err
        assert err_one > 10 * SPLIT_TOL, err_one

    def test_tf32_round_keeps_ten_mantissa_bits(self):
        x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                          -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.0])
        got = beam_cuda.tf32_round(x).tolist()
        # ties go away from zero (cvt.rna)
        assert got == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                       -(1.0 + 2 ** -10), 1.0, 3.0]

    def test_plain_search_with_split_products(self, monkeypatch):
        """The plain GRU search with every GRU product taken in the split
        gives the f32 search's hypotheses, scores within 1e-4."""
        a = 29
        tp = _bridged(_jax_lm(13, a, 64, 128))
        lp, lens = _posteriors(14, 3, 200, a)
        kw = dict(beam_width=16, max_len=128, lm_alpha=0.8, lm_beta=0.4,
                  nlm_params=tp)
        args = (torch.from_numpy(lp), torch.from_numpy(lens))
        with torch.no_grad():
            want = beam.prefix_beam_search(*args, **kw)
            monkeypatch.setattr(neural_lm, "matmul_f32",
                                beam_cuda.split_tf32_matmul)
            got = beam.prefix_beam_search(*args, **kw)
        _assert_same(got, want, atol=1e-4)
        assert int(got[1].min()) > 0
