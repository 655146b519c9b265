"""The port's plain prefix beam search against the JAX package's searches.

Posteriors are peaked log-softmaxes of seeded numpy logits; the trigram
comes from ``train_ngram_lm`` on seeded label sequences, so both packages
see the same table.  Hypotheses and lengths must be equal; scores agree to
1e-4 (torch and XLA compute exp and log differently, and the error stays
in the last few f32 ulps of O(100) scores).  At the wide beams of kernel
B6 (K = 160-256) every slot's length must be equal and every slot's score
within 1e-4, position by position.  The CUDA kernels B5 and B6 run only on
a card (``chip_smoke.py`` holds them against this plain search); their
wrapper's host-side pieces (admission bar, backpointer walk, guards) are
tested here.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ctc.decode import beam as jax_beam
from tpu_ctc.decode.lm import train_ngram_lm as jax_train_ngram_lm
from tpu_ctc.ops import beam_pallas
from tpu_ctc_torch.decode import beam, neural_lm
from tpu_ctc_torch.decode.lm import train_ngram_lm
from tpu_ctc_torch.ops import beam_cuda

torch.set_num_threads(2)


def _posteriors(seed, b, t, a, scale=2.0):
    r = np.random.RandomState(seed)
    x = r.randn(b, t, a).astype(np.float32) * scale
    x = x - x.max(axis=-1, keepdims=True)
    lp = (x - np.log(np.exp(x).sum(axis=-1, keepdims=True))).astype(np.float32)
    lens = r.randint(max(1, t // 2), t + 1, size=b).astype(np.int32)
    lens[0] = t
    return lp, lens


def _trigram(seed, a, order=3):
    r = np.random.RandomState(seed)
    seqs = [r.randint(1, a, size=r.randint(3, 30)) for _ in range(200)]
    return train_ngram_lm(seqs, vocab_size=a, order=order), seqs


def _torch_search(lp, lens, lm=None, **kw):
    table = lm.tables("cpu") if lm is not None else None
    return beam.prefix_beam_search(
        torch.from_numpy(lp), torch.from_numpy(lens), lm_table=table,
        lm_order=lm.order if lm is not None else 0, **kw)


def _assert_same(got, want, atol=1e-4):
    gh, gl, gs = (np.asarray(x) for x in got)
    wh, wl, ws = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gl, wl)
    for i in range(len(gl)):
        np.testing.assert_array_equal(gh[i, :gl[i]], wh[i, :wl[i]])
    np.testing.assert_allclose(gs, ws, rtol=0, atol=atol)


class TestAgainstXlaSearch:
    @pytest.mark.parametrize("k,t,kw", [
        (8, 80, dict(lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)),
        (128, 40, dict(lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)),
        (8, 60, dict(lm_alpha=0.7, lm_beta=0.3, char_topk=5)),
        (16, 50, dict(lm_alpha=1.0, lm_beta=0.0, prune_logp=-3.0)),
    ])
    def test_trigram(self, k, t, kw):
        lp, lens = _posteriors(k + t, 4, t, 29)
        lm, seqs = _trigram(1, 29)
        want = jax_beam.prefix_beam_search(
            jnp.asarray(lp), jnp.asarray(lens), beam_width=k, max_len=48,
            lm_table=jnp.asarray(lm.logp), lm_order=3, **kw)
        got = _torch_search(lp, lens, lm, beam_width=k, max_len=48, **kw)
        _assert_same(got, want)

    @pytest.mark.parametrize("order", [0, 1, 2])
    def test_lower_orders(self, order):
        lp, lens = _posteriors(order, 3, 30, 9)
        lm = _trigram(2, 9, order)[0] if order else None
        kw = dict(beam_width=12, max_len=20, lm_alpha=0.9, lm_beta=0.2)
        want = jax_beam.prefix_beam_search(
            jnp.asarray(lp), jnp.asarray(lens),
            lm_table=jnp.asarray(lm.logp) if lm else None,
            lm_order=order, **kw)
        got = _torch_search(lp, lens, lm, **kw)
        _assert_same(got, want)

    def test_max_len_caps_hypotheses(self):
        lp, lens = _posteriors(9, 2, 40, 6, scale=4.0)
        kw = dict(beam_width=8, max_len=5)
        want = jax_beam.prefix_beam_search(jnp.asarray(lp), jnp.asarray(lens),
                                           **kw)
        got = _torch_search(lp, lens, **kw)
        _assert_same(got, want)
        assert int(got[1].max()) <= 5

    def test_lm_tables_match(self):
        lm, seqs = _trigram(3, 29)
        jlm = jax_train_ngram_lm(seqs, vocab_size=29, order=3)
        np.testing.assert_array_equal(lm.logp, jlm.logp)
        assert torch.equal(lm.tables("cpu"), torch.from_numpy(jlm.logp))


class TestWideBeams:
    """The n-gram plain search at B6's widths against the XLA search."""

    @pytest.mark.parametrize("k,t,kw", [
        (160, 20, dict(lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)),
        (200, 16, dict(lm_alpha=0.7, lm_beta=0.3, char_topk=6)),
        (256, 14, dict(lm_alpha=1.0, lm_beta=0.5, prune_logp=-9.0)),
    ])
    def test_trigram(self, k, t, kw):
        lp, lens = _posteriors(k + t, 2, t, 29)
        lm, _ = _trigram(5, 29)
        want = jax_beam.prefix_beam_search(
            jnp.asarray(lp), jnp.asarray(lens), beam_width=k, max_len=24,
            lm_table=jnp.asarray(lm.logp), lm_order=3, **kw)
        got = _torch_search(lp, lens, lm, beam_width=k, max_len=24, **kw)
        _assert_same(got, want)

    def test_every_slot_at_k200(self):
        """All 200 slots' final scores and lengths over 40 frames
        (``test_beam_pallas.py::TestWideBeam::test_beam_state_parity``)."""
        r = np.random.RandomState(9)
        x = r.randn(2, 40, 29).astype(np.float32) * 2
        lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(
            np.float32)
        lens = np.array([40, 33], np.int32)
        kw = dict(beam_width=200, max_len=48, return_beams=True)
        want = jax_beam.prefix_beam_search(jnp.asarray(lp),
                                           jnp.asarray(lens), **kw)
        got = _torch_search(lp, lens, **kw)
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                   rtol=0, atol=1e-4)
        assert (got[3].numpy() > -1e29).sum() == 400


def test_against_pallas_kernel_k128():
    lp, lens = _posteriors(11, 2, 16, 29)
    lm, _ = _trigram(4, 29)
    kw = dict(beam_width=128, max_len=24, lm_order=3, lm_alpha=1.25,
              lm_beta=1.5, prune_logp=-12.0)
    want = beam_pallas.beam_search_pallas(
        jnp.asarray(lp), jnp.asarray(lens), lm_table=jnp.asarray(lm.logp),
        **kw)
    got = beam.prefix_beam_search(torch.from_numpy(lp),
                                  torch.from_numpy(lens),
                                  lm_table=lm.tables("cpu"), **kw)
    _assert_same(got, want)


class TestWrapperHostSide:
    def test_cpu_tensors_run_the_plain_search(self):
        lp, lens = _posteriors(5, 2, 20, 8)
        before = beam_cuda.KERNEL.launches
        got = beam_cuda.beam_search(torch.from_numpy(lp),
                                    torch.from_numpy(lens), beam_width=8,
                                    max_len=16)
        want = _torch_search(lp, lens, beam_width=8, max_len=16)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert beam_cuda.KERNEL.launches == before

    def test_reconstruct_matches_jax(self):
        r = np.random.RandomState(6)
        b, t, k, max_len = 3, 25, 16, 30
        parent = r.randint(0, k, size=(b, t, k))
        char = r.randint(-1, 9, size=(b, t, k))          # -1 = stay
        bp = (parent + np.where(char >= 0, (char + 1) * 256, 0)
              ).astype(np.int32)
        best = r.randint(0, k, size=b).astype(np.int32)
        want, _ = beam_pallas._reconstruct(jnp.asarray(bp), jnp.asarray(best),
                                           jnp.zeros(b, jnp.int32), max_len)
        got = beam_cuda.reconstruct_plain(torch.from_numpy(bp),
                                          torch.from_numpy(best), max_len)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_admission_bar_matches_jax(self):
        lp, _ = _posteriors(7, 2, 10, 29)
        lp_ext = jnp.where(jnp.arange(29) == 0, jax_beam.NEG_INF,
                           jnp.asarray(lp))
        want = jax.lax.top_k(lp_ext, 6)[0][..., -1]
        got = beam_cuda.admission_bar(torch.from_numpy(lp), 6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @staticmethod
    def _gru(e, h, v=29):
        return neural_lm.CharRNNLM(neural_lm.CharRNNLMConfig(v, e, h),
                                   device="cpu")

    @pytest.mark.parametrize("k,a,order,nlm", [
        (257, 29, 3, None), (128, 65, 3, None), (64, 29, 4, None),
        (64, 29, 3, (64, 300))])
    def test_unsupported_configs_raise(self, k, a, order, nlm):
        gru = self._gru(*nlm) if nlm else None
        with pytest.raises(NotImplementedError):
            beam_cuda.check_supported(k, a, order, gru)

    def test_supported_config(self):
        beam_cuda.check_supported(128, 29, 3)
        beam_cuda.check_supported(200, 29, 3, self._gru(64, 128))
        beam_cuda.check_supported(256, 64, 0, self._gru(125, 250))
        with pytest.raises(NotImplementedError):          # E rounds to 136
            beam_cuda.check_supported(64, 29, 0, self._gru(129, 16))
        assert beam_cuda.kernel_for(128) is beam_cuda.KERNEL
        assert beam_cuda.kernel_for(129) is beam_cuda.WIDE_KERNEL
        assert beam_cuda.WIDE_KERNEL.library == beam_cuda.KERNEL.library

    @pytest.mark.parametrize("k,a,order,nlm", [
        (128, 29, 3, None), (200, 29, 3, (64, 128)), (256, 64, 0, (125, 250)),
        (257, 29, 3, None), (128, 65, 3, None), (64, 29, 4, None),
        (64, 29, 3, (64, 300)), (64, 29, 0, (129, 16))])
    def test_supported_matches_jax(self, k, a, order, nlm):
        """``supported`` says what ``beam_pallas.supported`` says: the
        decoder's choice between the kernels and the plain search."""
        gru = jp = None
        if nlm:
            gru = self._gru(*nlm, v=a)
            jp = {"embed": np.zeros((a, nlm[0])), "bz": np.zeros(nlm[1])}
        assert beam_cuda.supported(k, a, order, gru) == beam_pallas.supported(
            k, a, order, nlm_params=jp)

    def test_gru_layout(self):
        """H = 7 is padded to 8 with zero weights, biases and start."""
        gru = neural_lm.init_params(neural_lm.CharRNNLMConfig(9, 5, 7), 3,
                                    device="cpu")
        xw, wh, b, wo, bo, h_bos = beam_cuda.gru_layout(gru, 9, "cpu")
        assert (xw.shape, wh.shape, b.shape, wo.shape, bo.shape,
                h_bos.shape) == ((9, 24), (8, 24), (24,), (8, 9), (9,), (8,))
        with torch.no_grad():
            x = gru.embed[4]
            for g, w in enumerate((gru.wz, gru.wr, gru.wh)):
                torch.testing.assert_close(xw[4, 8 * g:8 * g + 7], x @ w[:5])
                assert torch.equal(wh[:7, 8 * g:8 * g + 7], w[5:])
                assert not xw[:, 8 * g + 7].any() and not wh[:, 8 * g + 7].any()
                assert not b[8 * g + 7]
            assert not wh[7].any() and not wo[7].any() and not h_bos[7]
            assert torch.equal(wo[:7], gru.wo) and torch.equal(bo, gru.bo)
            assert torch.equal(h_bos[:7], neural_lm.init_state(gru))
        with pytest.raises(ValueError):
            beam_cuda.gru_layout(gru, 29, "cpu")

    def test_cpu_tensors_run_the_plain_gru_search(self):
        lp, lens = _posteriors(6, 2, 12, 8)
        gru = neural_lm.init_params(neural_lm.CharRNNLMConfig(8, 6, 10), 1,
                                    device="cpu")
        before = (beam_cuda.KERNEL.launches, beam_cuda.WIDE_KERNEL.launches)
        kw = dict(beam_width=160, max_len=16, nlm_params=gru, lm_alpha=0.5)
        got = beam_cuda.beam_search(torch.from_numpy(lp),
                                    torch.from_numpy(lens), **kw)
        want = _torch_search(lp, lens, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert (beam_cuda.KERNEL.launches,
                beam_cuda.WIDE_KERNEL.launches) == before

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        lp, lens = _posteriors(5, 2, 20, 8)
        with pytest.raises(ValueError):
            beam_cuda.beam_search_cuda(torch.from_numpy(lp),
                                       torch.from_numpy(lens), 8, 16)

    def test_frame_breakdown_stamps_the_kernel(self):
        """torch_tools/beam_frame_breakdown.py stamps a copy of
        beam_search.cu at anchors in its text: each stamp's anchor must
        occur exactly once, and every phase boundary gets its stamp."""
        tool = _load(os.path.join("torch_tools", "beam_frame_breakdown.py"))
        with open(beam_cuda.KERNEL.source) as f:
            stamped = tool.stamp(f.read())
        assert [stamped.count(f"STAMP({i});") for i in range(9)] == [1] * 9
        assert len(tool.PHASES) == 8

    def test_insert_stamps_takes_one_anchor_of_each_stamp(self):
        """The breakdown tools' shared stamping: of a stamp's alternatives,
        the one whose anchor occurs exactly once is replaced; none, or an
        anchor that occurs twice, raises."""
        tool = _load(os.path.join("torch_tools", "kernel_stamps.py"))
        src = "a;\nb;\nb;\nc;\n"
        got = tool.insert_stamps(src, [("a;", "S0; a;"),
                                       [("x;", "?"), ("c;", "S1; c;")]],
                                 "src")
        assert got == "S0; a;\nb;\nb;\nS1; c;\n"
        for bad in ([("x;", "?")], [("b;", "?")],
                    [[("a;", "?"), ("c;", "?")]]):
            with pytest.raises(RuntimeError):
                tool.insert_stamps(src, bad, "src")

    @pytest.mark.parametrize("name,want", [
        ("beam_kernel<128, true>", (128, True)),
        ("beam_kernel<256, false>", (256, False)),
        ("_ZN47_GLOBAL__N__af532e0b_14_beam_search_cu_f5e8fde611beam_kernelI"
         "Li256ELb1EEEvPKfPKiS2_S2_PiPfiiiiiiffifNS_3GruENS_4SmemE",
         (256, True)),
        ("_ZN47_GLOBAL__N__af532e0b_14_beam_search_cu_f5e8fde611beam_kernelI"
         "Li128ELb0EEEvPKfPKiS2_S2_PiPfiiiiiiffifNS_3GruENS_4SmemE",
         (128, False)),
        ("mma_sweep_kernel<false>", None)])
    def test_chip_smoke_names_the_beam_instances(self, name, want):
        """chip_smoke.py phase 1 finds B5/B6's four instances in the SASS by
        name, demangled or not (without c++filt the names stay mangled)."""
        assert _load("chip_smoke.py").beam_instance(name) == want


def _load(rel_path):
    """A module of the repository that is not in a package, by path."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), rel_path)
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0] + "_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
