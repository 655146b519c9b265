"""The port's CTC loss against the JAX package, the torch oracle fixture
and ``torch.nn.functional.ctc_loss``.

Both of the port's paths are held here on the CPU: the oracle
(``losses/ctc_ref.py``, autograd through a loop over T) and the kernel
path (``ops/ctc_cuda.CtcDp`` with the plain alpha/beta sweeps that CPU
tensors take; kernels B3/B4 replace exactly those sweeps on a card, where
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold them against
them).  Inputs come from numpy seeds.  Tolerance is f32 summation order:
rtol 1e-5 and atol 1e-4 on NLLs of order 10-100 and on their gradients,
as the JAX package's own Pallas-vs-scan tests allow.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_ctc.losses import ctc_ref as jax_ref
from tpu_ctc.ops import ctc_pallas
from tpu_ctc_torch.data import bucketing
from tpu_ctc_torch.losses import ctc, ctc_ref
from tpu_ctc_torch.ops import ctc_cuda

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
RTOL, ATOL = 1e-5, 1e-4
IMPLS = ["jnp", "auto"]          # the oracle, the kernel path's glue


def _case(seed, b, t, a, lmax):
    r = np.random.RandomState(seed)
    logits = r.randn(b, t, a).astype(np.float32)
    labels = r.randint(1, a, (b, lmax)).astype(np.int32)
    tl = r.randint(max(2 * lmax + 1, 2), t + 1, b).astype(np.int32)
    ll = r.randint(0, lmax + 1, b).astype(np.int32)
    return logits, labels, tl, ll


def _port(impl, logits, labels, tl, ll, from_log_probs=False):
    """(nll, d sum(nll) / d input) of the port."""
    x = torch.from_numpy(np.array(logits)).requires_grad_(True)
    nll = ctc.ctc_loss(x, torch.from_numpy(labels), torch.from_numpy(tl),
                       torch.from_numpy(ll), impl=impl,
                       from_log_probs=from_log_probs)
    nll.sum().backward()
    return nll.detach().numpy(), x.grad.numpy()


def _jax(fn, logits, labels, tl, ll):
    args = [jnp.asarray(v) for v in (labels, tl, ll)]
    x = jnp.asarray(logits)
    return (np.asarray(fn(x, *args)),
            np.asarray(jax.grad(lambda v: jnp.sum(fn(v, *args)))(x)))


class TestAgainstJax:
    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("b,t,a,lmax", [
        (2, 16, 6, 4), (3, 40, 29, 12), (5, 33, 5, 3), (8, 48, 29, 10)])
    def test_nll_and_grad_match_the_scan(self, impl, b, t, a, lmax):
        case = _case(b * 100 + t, b, t, a, lmax)
        want, g_want = _jax(jax_ref.ctc_loss, *case)
        got, g_got = _port(impl, *case)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g_got, g_want, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_matches_the_pallas_kernel(self, impl):
        case = _case(7, 3, 24, 8, 5)
        want, g_want = _jax(ctc_pallas.ctc_loss, *case)
        got, g_got = _port(impl, *case)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g_got, g_want, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_from_log_probs(self, impl):
        logits, labels, tl, ll = _case(3, 3, 20, 7, 4)
        lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
        want, g_want = _jax(jax_ref.ctc_loss_from_log_probs, lp, labels, tl,
                            ll)
        got, g_got = _port(impl, lp, labels, tl, ll, from_log_probs=True)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g_got, g_want, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_neg_inf_log_probs(self, impl):
        """-inf vocab entries (a masked class) stay finite, as the Pallas
        path's test_neg_inf_log_probs requires."""
        b, t, a, lmax = 2, 20, 8, 4
        logits, labels, tl, ll = _case(11, b, t, a, lmax)
        labels = np.minimum(labels, a - 2)          # keep labels feasible
        lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
        lp[:, :, a - 1] = -np.inf
        want, g_want = _jax(jax_ref.ctc_loss_from_log_probs, lp, labels, tl,
                            ll)
        got, g_got = _port(impl, lp, labels, tl, ll, from_log_probs=True)
        assert np.all(np.isfinite(got)) and np.all(np.isfinite(g_got))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g_got, g_want, rtol=RTOL, atol=ATOL)

    def test_alignment_posteriors_and_mean(self):
        logits, labels, tl, ll = _case(5, 3, 18, 6, 4)
        lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
        args = [jnp.asarray(v) for v in (labels, tl, ll)]
        want = np.asarray(jax_ref.ctc_alignment_posteriors(jnp.asarray(lp),
                                                           *args))
        targs = [torch.from_numpy(v) for v in (labels, tl, ll)]
        got = ctc_ref.ctc_alignment_posteriors(torch.from_numpy(lp), *targs)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        mean = ctc_ref.ctc_loss_mean(torch.from_numpy(logits), *targs)
        np.testing.assert_allclose(
            float(mean), float(jax_ref.ctc_loss_mean(jnp.asarray(logits),
                                                     *args)), rtol=RTOL)

    def test_extend_labels(self):
        labels = np.array([[3, 3, 5, 0], [1, 2, 2, 2]], np.int32)
        ext, skip = ctc_ref.extend_labels(torch.from_numpy(labels))
        j_ext, j_skip = jax_ref.extend_labels(jnp.asarray(labels))
        np.testing.assert_array_equal(ext.numpy(), np.asarray(j_ext))
        np.testing.assert_array_equal(skip.numpy(), np.asarray(j_skip))


class TestSweeps:
    """The plain sweeps compute exactly what the Pallas kernels compute
    (interpret mode, unpacked: one utterance per 128-lane row)."""

    def _lattice(self, seed, b=8, t=16, lmax=20):
        logits, labels, tl, ll = _case(seed, b, t, 29, lmax // 4)
        tl[1], ll[2] = 0, 0                  # an empty row and no labels
        lp = torch.log_softmax(torch.from_numpy(logits), -1)
        return ctc_cuda.lattice(lp, torch.from_numpy(labels),
                                torch.from_numpy(tl), torch.from_numpy(ll))

    @staticmethod
    def _lanes(x, fill):
        """[B, S] -> the Pallas kernels' [B, 128] lane tile."""
        return jnp.pad(jnp.asarray(x.numpy()),
                       ((0, 0), (0, 128 - x.shape[1])), constant_values=fill)

    def test_alpha_plain_is_the_alpha_kernel(self):
        emit, skip, _, init, _, lengths = self._lattice(1)
        b, t, s = emit.shape
        want = ctc_pallas._run_alpha(
            jnp.pad(jnp.asarray(emit.numpy()),
                    ((0, 0), (0, 0), (0, 128 - s)),
                    constant_values=ctc_ref.NEG_INF),
            self._lanes(skip, 0.0), self._lanes(init, ctc_ref.NEG_INF),
            jnp.broadcast_to(jnp.asarray(lengths.numpy(), jnp.float32)[:, None],
                             (b, 128)), 8, 8, 128)
        got = ctc_cuda.alpha_plain(emit, skip, init, lengths)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, :s],
                                   rtol=1e-6, atol=1e-4)

    def test_beta_plain_is_the_beta_kernel(self):
        emit, _, skip2, _, final, lengths = self._lattice(2)
        b, t, s = emit.shape
        want = ctc_pallas._run_beta(
            jnp.pad(jnp.asarray(emit.numpy()),
                    ((0, 0), (0, 0), (0, 128 - s)),
                    constant_values=ctc_ref.NEG_INF),
            self._lanes(skip2, 0.0), self._lanes(final, ctc_ref.NEG_INF),
            jnp.broadcast_to(jnp.asarray(lengths.numpy(), jnp.float32)[:, None],
                             (b, 128)), 8, 8, 128)
        got = ctc_cuda.beta_plain(emit, skip2, final, lengths)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, :s],
                                   rtol=1e-6, atol=1e-4)

    @pytest.mark.parametrize("tl,ll", [         # 8 rows: one row group
        ([0, 1, 16, 21, 12, 16, 5, 30], [3, 3, 0, 5, 2, 5, 1, 4]),  # 0, 1, T, > T
        ([16, 9, 16, 2, 0, 1, 20, 7], [0] * 8),                     # S = 1
        ([16, 3, 20, 0, 1, 16, 9, 11], [1, 0, 1, 1, 0, 1, 1, 0])])  # S = 3
    def test_plain_sweeps_are_the_kernels_at_the_edges(self, tl, ll):
        """The edge cases of the card tests of B3/B4, plain sweeps against
        the Pallas kernels: empty rows, one frame, lengths past T, S = 1
        and S = 3."""
        b, t = 8, 16
        logits, labels, _, _ = _case(11, b, t, 29, max(ll) or 1)
        lp = torch.log_softmax(torch.from_numpy(logits), -1)
        # the lattice's width is the label columns it is given
        emit, skip, skip2, init, final, lengths = ctc_cuda.lattice(
            lp, torch.from_numpy(labels[:, :max(ll)]),
            torch.tensor(tl, dtype=torch.int32),
            torch.tensor(ll, dtype=torch.int32))
        s = emit.shape[2]
        assert s == 2 * max(ll) + 1
        pad = jnp.pad(jnp.asarray(emit.numpy()), ((0, 0), (0, 0), (0, 128 - s)),
                      constant_values=ctc_ref.NEG_INF)
        lens = jnp.broadcast_to(jnp.asarray(tl, jnp.float32)[:, None],
                                (b, 128))
        for want, got in (
                (ctc_pallas._run_alpha(pad, self._lanes(skip, 0.0),
                                       self._lanes(init, ctc_ref.NEG_INF),
                                       lens, 8, 8, 128),
                 ctc_cuda.alpha_plain(emit, skip, init, lengths)),
                (ctc_pallas._run_beta(pad, self._lanes(skip2, 0.0),
                                      self._lanes(final, ctc_ref.NEG_INF),
                                      lens, 8, 8, 128),
                 ctc_cuda.beta_plain(emit, skip2, final, lengths))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, :s],
                                       rtol=1e-6, atol=1e-4)

    def test_lse3_with_two_exps_is_bit_equal(self):
        """Kernels B3/B4 take the maximum's term as 1.0 (exp(0)) and exp
        only the other two, summing in the plain order: bit-equal to
        ``_logaddexp3`` whatever exp's rounding, ties and sentinels
        included (a float model of the kernel's lse3)."""
        r = np.random.RandomState(12)
        n = 20000
        x = r.randn(3, n).astype(np.float32) * 30
        pick = r.randint(0, 5, (3, n))
        x = np.where(pick == 0, ctc_ref.NEG_INF, x)           # dead
        x = np.where(pick == 1, x[0:1], x)                    # ties with a
        a, b, c = (torch.from_numpy(v.copy()) for v in x)
        m = torch.maximum(torch.maximum(a, b), c)
        c_max = c == m
        xx = torch.where(c_max, a, torch.where(a == m, b, a))
        yy = torch.where(c_max, b, c)
        ex, ey = torch.exp(xx - m), torch.exp(yy - m)
        one = torch.ones_like(m)
        total = torch.where(c_max, (ex + ey) + one, (one + ex) + ey)
        got = torch.where(m > ctc_ref.NEG_INF / 2,
                          m + torch.log(total + 1e-37),
                          torch.full_like(m, ctc_ref.NEG_INF))
        assert torch.equal(got, ctc_ref._logaddexp3(a, b, c))

    def test_turns_tool_anchor_is_in_the_kernel(self):
        """torch_tools/ctc_dp_turns.py rewrites copies of ctc_dp.cu at
        anchors in its text (lse3 with three exps, the intrinsics, the
        frame's clock stamps): each must occur exactly once."""
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "torch_tools", "ctc_dp_turns.py")
        spec = importlib.util.spec_from_file_location("turns", path)
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        with open(ctc_cuda.ALPHA.source) as f:
            src = f.read()
        for edits in (tool.EXP3, tool.FASTMATH, tool.STAMPS):
            assert [src.count(anchor) for anchor, _ in edits] == [1] * len(
                edits)

    def test_lattice_is_cut_to_the_longest_label(self):
        """The host cuts the label columns (``bucketing.cut_labels``: the
        longest label rounded up to 32, at most the padded width); the
        lattice is 2 L + 1 states for the L columns it gets, read from
        their shape: with label lengths whose values cannot reach the host
        it builds the same lattice."""
        logits, labels, tl, ll = _case(3, 8, 40, 29, 12)
        labels = np.pad(labels, ((0, 0), (0, 36)))        # padded to 48
        lp = torch.log_softmax(torch.from_numpy(logits), -1)
        arrays = bucketing.cut_labels({"labels": labels,
                                       "label_lengths": ll})
        assert arrays["labels"].shape == (8, 32)
        want = ctc_cuda.lattice(lp, torch.from_numpy(arrays["labels"]),
                                torch.from_numpy(tl), torch.from_numpy(ll))
        got = ctc_cuda.lattice(lp, torch.from_numpy(arrays["labels"]),
                               torch.from_numpy(tl),
                               _NoHostRead.of(torch.from_numpy(ll)))
        assert want[0].shape[2] == want[1].shape[1] == 2 * 32 + 1
        assert want[5].dtype == torch.int32
        for g, w in zip(got, want):
            assert torch.equal(g.as_subclass(torch.Tensor), w)
        with pytest.raises(AssertionError, match="host"):
            int(_NoHostRead.of(torch.from_numpy(ll)).max())

    def test_cpu_tensors_use_the_plain_sweeps(self):
        emit, skip, skip2, init, final, lengths = self._lattice(4)
        before = (ctc_cuda.ALPHA.launches, ctc_cuda.BETA.launches)
        assert torch.equal(ctc_cuda.alpha(emit, skip, init, lengths),
                           ctc_cuda.alpha_plain(emit, skip, init, lengths))
        assert torch.equal(ctc_cuda.beta(emit, skip2, final, lengths),
                           ctc_cuda.beta_plain(emit, skip2, final, lengths))
        assert (ctc_cuda.ALPHA.launches, ctc_cuda.BETA.launches) == before
        with pytest.raises(ValueError):
            ctc_cuda.alpha_cuda(emit, skip, init, lengths)
        with pytest.raises(ValueError):
            ctc_cuda.beta_cuda(emit, skip2, final, lengths)


class _NoHostRead(torch.Tensor):
    """A tensor whose values never reach the host: every read that a CUDA
    graph capture refuses (``int``, ``item``, ``max``, ...) raises."""

    @classmethod
    def of(cls, t):
        return torch.Tensor._make_subclass(cls, t)

    def _refuse(self, *args, **kwargs):
        raise AssertionError("a host read of a device value")

    __int__ = __float__ = __bool__ = __index__ = _refuse
    item = tolist = numpy = max = min = _refuse


class TestLabelWidth:
    """The host's label cut (``data.bucketing.cut_labels``, the longest
    label rounded up to 32 columns, at most the padded width) against the
    cut at the longest label and against the JAX package at the padded
    width.  The losses are bit-equal: the extra states are dead, and the
    final log-sum-exp adds only exact zeros for them.  The gradient's
    one-hot product sums over S, so its f32 order may move with the width:
    measured 0.0 in all three cases (the CPU's f32 product; the card's in
    ``tests/test_torch_cuda.py``), held to ``GAP``, an ulp of a gradient of
    magnitude ~8."""

    GAP = 1e-6

    @pytest.mark.parametrize("seed,b,t,pad,most", [
        (3, 6, 80, 48, 21), (4, 5, 120, 100, 37), (5, 8, 96, 64, 40)])
    def test_rounded_width(self, seed, b, t, pad, most):
        r = np.random.RandomState(seed)
        logits = r.randn(b, t, 29).astype(np.float32)
        labels = np.zeros((b, pad), np.int32)
        ll = r.randint(1, most + 1, b).astype(np.int32)
        ll[0] = most
        for i, n in enumerate(ll):
            labels[i, :n] = r.randint(1, 29, n)
        tl = r.randint(2 * most + 1, t + 1, b).astype(np.int32)
        width = bucketing.label_width(ll, pad)
        assert most < width <= pad and width % 32 == 0 or width == pad
        at_longest = _port("auto", logits, labels[:, :most], tl, ll)
        rounded = _port("auto", logits, labels[:, :width], tl, ll)
        np.testing.assert_array_equal(rounded[0], at_longest[0])
        gap = np.abs(rounded[1] - at_longest[1]).max()
        assert gap <= self.GAP, gap
        want, g_want = _jax(jax_ref.ctc_loss, logits, labels, tl, ll)
        for got, g_got in (at_longest, rounded):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g_got, g_want, rtol=RTOL, atol=ATOL)

    def test_width_rule(self):
        assert [bucketing.label_width(np.array(v), p) for v, p in (
            ([0, 0], 64), ([1, 5], 64), ([32], 64), ([33], 64), ([60], 50),
            ([3], 20), ([7], 0))] == [32, 32, 32, 64, 50, 20, 0]
        arrays = {"labels": np.ones((2, 32), np.int32),
                  "label_lengths": np.array([3, 4], np.int32)}
        assert bucketing.cut_labels(arrays) is arrays


class TestEmitGather:
    @pytest.mark.parametrize("seed,b,t,a,s", [(5, 4, 12, 29, 21),
                                              (6, 3, 40, 7, 81)])
    def test_forward_is_gather_backward_in_fixed_order(self, seed, b, t, a,
                                                       s):
        """``EmitGather``'s forward is ``torch.gather``'s bit for bit; its
        backward (one f32 product with the one-hot of ext) equals
        ``gather``'s scatter-add up to the order of each character's sum.
        A sum of n values in two orders differs by at most 2 (n - 1)
        2^-24 of the sum of their magnitudes; every other column (the
        blank, on every even lattice column) sums several."""
        r = np.random.RandomState(seed)
        lp = torch.from_numpy(r.randn(b, t, a).astype(np.float32))
        ext = torch.from_numpy(r.randint(1, a, (b, s)))
        ext[:, ::2] = 0                                 # the blanks
        g = torch.from_numpy(r.randn(b, t, s).astype(np.float32))
        x = lp.clone().requires_grad_()
        got = ctc_cuda.EmitGather.apply(x, ext)
        want = torch.gather(x, 2, ext[:, None, :].expand(b, t, s))
        assert torch.equal(got, want)
        d_got, = torch.autograd.grad(got, x, g)
        d_want, = torch.autograd.grad(want, x, g)
        onehot = F.one_hot(ext, a).to(torch.float32)          # [B, S, A]
        n = onehot.sum(1)[:, None, :]                           # [B, 1, A]
        bound = 2 * torch.clamp_min(n - 1, 0) * 2.0 ** -24 * (
            g.abs() @ onehot)
        assert torch.all((d_got - d_want).abs() <= bound)
        assert int(n.max()) > 1
        assert torch.equal(d_got == 0, n.expand_as(d_got) == 0)

    def test_the_loss_takes_it(self):
        """The lattice's emission gather is ``EmitGather``: the loss's
        gradient flows through it."""
        logits, labels, tl, ll = (torch.from_numpy(x) for x in
                                  _case(7, 3, 30, 9, 6))
        lp = torch.log_softmax(logits, -1).requires_grad_()
        emit = ctc_cuda.lattice(lp, labels, tl, ll)[0]
        names, todo = set(), [emit.grad_fn]
        while todo:
            fn = todo.pop()
            names.add(fn.name())
            todo += [f for f, _ in fn.next_functions if f is not None]
        assert "EmitGatherBackward" in names
        assert not any(n.startswith("Gather") for n in names)


class TestOracles:
    @pytest.mark.parametrize("impl", IMPLS)
    def test_torch_oracle_fixture(self, impl):
        d = np.load(os.path.join(DATA, "ctc_torch_oracle.npz"))
        for ci in range(int(d["num_cases"])):
            got, g_got = _port(impl, d[f"logits_{ci}"], d[f"labels_{ci}"],
                               d[f"tl_{ci}"], d[f"ll_{ci}"])
            np.testing.assert_allclose(got, d[f"loss_{ci}"], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(g_got, d[f"grad_{ci}"], rtol=RTOL,
                                       atol=ATOL)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_functional_ctc_loss(self, impl):
        logits, labels, tl, ll = _case(9, 4, 30, 12, 6)
        x = torch.from_numpy(logits).requires_grad_(True)
        want = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1),
                          torch.from_numpy(labels), torch.from_numpy(tl),
                          torch.from_numpy(ll), reduction="none")
        want.sum().backward()
        got, g_got = _port(impl, logits, labels, tl, ll)
        np.testing.assert_allclose(got, want.detach().numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(g_got, x.grad.numpy(), rtol=RTOL,
                                   atol=ATOL)


class TestEdgeCases:
    @pytest.mark.parametrize("impl", IMPLS)
    def test_infeasible_is_clamped_without_gradient(self, impl):
        logits = np.zeros((2, 3, 4), np.float32)
        labels = np.array([[1, 2, 3], [1, 0, 0]], np.int32)
        got, grad = _port(impl, logits, labels, np.array([2, 3], np.int32),
                          np.array([3, 1], np.int32))
        assert got[0] == pytest.approx(1e9) and got[1] < 10
        np.testing.assert_array_equal(grad[0], 0.0)
        assert np.abs(grad[1]).sum() > 0

    @pytest.mark.parametrize("impl", IMPLS)
    def test_label_len_zero(self, impl):
        logits, labels, tl, _ = _case(13, 3, 12, 5, 3)
        ll = np.array([0, 2, 0], np.int32)
        want, g_want = _jax(jax_ref.ctc_loss, logits, labels, tl, ll)
        got, g_got = _port(impl, logits, labels, tl, ll)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g_got, g_want, rtol=RTOL, atol=ATOL)
        # all blanks: -sum of the blank log probs over the live frames
        lp = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
        np.testing.assert_allclose(got[0], -lp[0, :tl[0], 0].sum(),
                                   rtol=RTOL)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_all_label_lengths_zero(self, impl):
        logits, labels, tl, _ = _case(17, 2, 9, 5, 2)
        ll = np.zeros(2, np.int32)
        want, g_want = _jax(jax_ref.ctc_loss, logits, labels, tl, ll)
        got, g_got = _port(impl, logits, labels, tl, ll)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g_got, g_want, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_zero_gradient_on_padding(self, impl):
        logits, labels, _, ll = _case(19, 2, 20, 6, 4)
        got, grad = _port(impl, logits, labels, np.array([12, 20], np.int32),
                          ll)
        np.testing.assert_array_equal(grad[0, 12:], 0.0)
        assert np.abs(grad[0, :12]).sum() > 0

    def test_unknown_impl_raises(self):
        logits, labels, tl, ll = _case(1, 1, 5, 4, 1)
        with pytest.raises(ValueError):
            ctc.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         torch.from_numpy(tl), torch.from_numpy(ll),
                         impl="nope")
