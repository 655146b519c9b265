"""The port's wrapper of the native C++ decoder (``cpp/ctc_beam.cpp``)
against the JAX package's wrapper and the port's host search.

Mirrors ``tests/test_cpp_decoder.py`` (no LM, a trigram, a batch):
hypotheses equal and scores within rtol 1e-5 of
``prefix_beam_search_host``, and the JAX package's ``cpp_decoder`` on the
same library gives the same outputs to the bit.  The batched plain search
in double (``prefix_beam_search(dtype=torch.float64)``) is its twin.  The
JAX wrapper is pointed at the library the port builds
(``build/tpu_ctc_torch/``), so no
test here runs ``make -C cpp``.  The library is built with ``g++``; a
failed build fails these tests.  Two processes that build at once each
load a whole library; a source that does not compile raises with the
compiler's output.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_ctc.decode import cpp_decoder as jax_cpp
from tpu_ctc.decode.lm import train_ngram_lm as jax_train_ngram_lm
from tpu_ctc_torch.decode import cpp_decoder
from tpu_ctc_torch.decode.beam import (prefix_beam_search,
                                       prefix_beam_search_host)
from tpu_ctc_torch.decode.lm import train_ngram_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def np_log_softmax(x):
    m = x.max(axis=-1, keepdims=True)
    e = x - m
    return e - np.log(np.exp(e).sum(axis=-1, keepdims=True))


@pytest.fixture
def jax_wrapper(monkeypatch):
    """The JAX package's wrapper, loading the port's build of the same
    source."""
    cpp_decoder.build()
    monkeypatch.setattr(jax_cpp, "_LIB_PATH", cpp_decoder.LIBRARY)
    monkeypatch.setattr(jax_cpp, "_lib", None)
    return jax_cpp


class TestCppParity:
    def test_no_lm(self, rng, jax_wrapper):
        for trial in range(5):
            t, a, k = rng.randint(5, 20), rng.randint(3, 8), 8
            log_probs = np_log_softmax(rng.randn(t, a).astype(np.float32)
                                       * 1.5)
            py_best, py_score = prefix_beam_search_host(log_probs,
                                                        beam_width=k)
            c_best, c_score = cpp_decoder.beam_search(log_probs,
                                                      beam_width=k)
            assert c_best == py_best, (trial, c_best, py_best)
            np.testing.assert_allclose(c_score, py_score, rtol=1e-5)
            assert jax_wrapper.beam_search(log_probs, beam_width=k) == (
                c_best, c_score)

    def test_with_trigram_lm(self, rng, jax_wrapper):
        t, a, k = 12, 5, 8
        seqs = [rng.randint(1, a, rng.randint(3, 10)) for _ in range(40)]
        lm = train_ngram_lm(seqs, vocab_size=a, order=3)
        jlm = jax_train_ngram_lm(seqs, vocab_size=a, order=3)
        log_probs = np_log_softmax(rng.randn(t, a).astype(np.float32) * 1.5)
        py_best, py_score = prefix_beam_search_host(
            log_probs, beam_width=k, lm=lm, lm_alpha=0.8, lm_beta=0.4)
        c_best, c_score = cpp_decoder.beam_search(
            log_probs, beam_width=k, lm=lm, lm_alpha=0.8, lm_beta=0.4)
        assert c_best == py_best
        np.testing.assert_allclose(c_score, py_score, rtol=1e-5)
        assert jax_wrapper.beam_search(
            log_probs, beam_width=k, lm=jlm, lm_alpha=0.8,
            lm_beta=0.4) == (c_best, c_score)

    def test_batch(self, rng, jax_wrapper):
        b, t, a, k = 3, 10, 5, 8
        log_probs = np_log_softmax(rng.randn(b, t, a).astype(np.float32))
        lengths = np.array([10, 6, 3], np.int32)
        hyps, lens, scores = cpp_decoder.beam_search_batch(
            log_probs, lengths, beam_width=k)
        for i in range(b):
            py_best, py_score = prefix_beam_search_host(
                log_probs[i], length=int(lengths[i]), beam_width=k)
            assert list(hyps[i][: lens[i]]) == py_best
            np.testing.assert_allclose(float(scores[i]), py_score, rtol=1e-5)
        for got, want in zip((hyps, lens, scores),
                             jax_wrapper.beam_search_batch(
                                 log_probs, lengths, beam_width=k)):
            np.testing.assert_array_equal(got, want)

    def test_the_plain_search_in_double_is_its_twin(self, rng):
        """``prefix_beam_search(dtype=float64)``, the batched search in
        double, gives the C++ decoder's hypotheses and scores (within the
        float32 rounding of the C++ output) with and without the trigram;
        the float32 search, as the kernels run it, within 1e-5."""
        b, t, a, k = 4, 40, 6, 16
        seqs = [rng.randint(1, a, rng.randint(3, 12)) for _ in range(60)]
        lm = train_ngram_lm(seqs, vocab_size=a, order=3)
        log_probs = np_log_softmax(rng.randn(b, t, a).astype(np.float32)
                                   * 2)
        lengths = np.array([40, 33, 17, 1], np.int32)
        for kw in ({}, dict(lm=lm, lm_alpha=1.25, lm_beta=1.5)):
            hc, lc, sc = cpp_decoder.beam_search_batch(
                log_probs, lengths, beam_width=k, max_len=24, **kw)
            table = kw.pop("lm", None)
            if table is not None:
                kw.update(lm_table=table.tables("cpu"), lm_order=3)
            for dtype, rtol in ((torch.float64, 1e-7), (torch.float32, 1e-5)):
                hp, lp_, sp = prefix_beam_search(
                    torch.from_numpy(log_probs), torch.from_numpy(lengths),
                    beam_width=k, max_len=24, dtype=dtype, **kw)
                np.testing.assert_array_equal(lp_.numpy(), lc)
                for i in range(b):
                    assert hp[i, :lc[i]].tolist() == hc[i, :lc[i]].tolist()
                np.testing.assert_allclose(sp.numpy(), sc, rtol=rtol)

    def test_the_kernel_rule_holds_on_the_cpu(self, rng):
        """``torch_tools/cpp_b5.py``'s rule (phase 13's C++ decoder against
        B5) with B5's plain version in its place on the CPU: the C++
        decoder equals the float64 search on every utterance, and the
        float32 search where the two do not part."""
        from torch_tools import cpp_b5
        b, t, a = 6, 60, 8
        seqs = [rng.randint(1, a, rng.randint(3, 12)) for _ in range(60)]
        lm = train_ngram_lm(seqs, vocab_size=a, order=3)
        lp = torch.from_numpy(np_log_softmax(
            rng.randn(b, t, a).astype(np.float32) * 2))
        lens = torch.from_numpy(np.array([60, 41, 30, 17, 9, 1], np.int32))
        r = cpp_b5.compare(lp, lens, lm, 16, 30, 1.25, 1.5, dev="cpu")
        assert r["n"] == b and r["b5_equals_f32"]
        assert cpp_b5.holds(r), cpp_b5.summary(r)


BUILD_AND_DECODE = """
import sys
import numpy as np
from tpu_ctc_torch.decode import cpp_decoder as c
c.LIBRARY = sys.argv[1]
c.build(force=True)
x = np.random.RandomState(0).randn(2, 9, 5).astype(np.float32)
lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
hyps, lens, scores = c.beam_search_batch(lp, np.array([9, 4], np.int32),
                                         beam_width=4)
print("DECODED", list(lens), float(scores[0]))
"""


class TestBuild:
    def test_two_builds_at_once_load_whole_libraries(self, tmp_path):
        library = tmp_path / "lib" / "libctcbeam.so"
        env = dict(os.environ, PYTHONPATH=REPO)
        procs = [subprocess.Popen(
            [sys.executable, "-c", BUILD_AND_DECODE, str(library)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for _ in range(2)]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
        decoded = [line for out in outs for line in out.splitlines()
                   if line.startswith("DECODED")]
        assert len(decoded) == 2 and decoded[0] == decoded[1]
        assert sorted(os.listdir(library.parent)) == ["libctcbeam.so"]

    def test_a_failed_build_raises_with_the_compiler_output(
            self, tmp_path, monkeypatch):
        bad = tmp_path / "bad.cpp"
        bad.write_text("int main( { return 0; }\n")
        monkeypatch.setattr(cpp_decoder, "SOURCE", str(bad))
        monkeypatch.setattr(cpp_decoder, "LIBRARY",
                            str(tmp_path / "out" / "libctcbeam.so"))
        monkeypatch.setattr(cpp_decoder, "_lib", None)
        with pytest.raises(RuntimeError, match="bad.cpp"):
            cpp_decoder.beam_search_batch(
                np.zeros((1, 2, 3), np.float32), np.array([2], np.int32))
        assert not cpp_decoder.available()
        assert os.listdir(tmp_path / "out") == []
