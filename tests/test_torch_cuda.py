"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither jax nor ``tpu_ctc``, so that it also runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)  Kernels B5
and B6 with an n-gram LM must equal the plain search exactly (hypotheses,
lengths, every slot's final state: they do the plain version's float steps
in the same order); with the GRU char LM the hypotheses must be equal and
the scores within 1e-4 (the GRU's products run on the tensor cores in the
three-pass TF32 split, f32-accurate, but sum in another order than the
plain version's matmuls), and two launches are bit-equal; the walk of
the best slot's backpointers equals the plain walk to the bit.  Kernels
B1 and B2 store bf16 states (deltas) that may round the other way where
the two sum the f32 dot in different orders: within 2^-6 |h| + 2e-2 at
bf16, 1e-4 at f32; two launches of a bf16 kernel are bit-equal; the wide
instance, planned at narrow widths, is bit-equal to the narrow one; both
directions of a layer in one launch (``birnn_cuda.plan``: 32 columns of W
a block) are bit-equal to one launch a direction, also through
``BiRecurrence`` and replayed in a CUDA graph, and launch counts read
direction sweeps (a fused launch sweeps two).  Kernels
B3 and B4 do the plain sweeps' float steps in the same order with
expf/logf: bit-equal, sentinels included.  The dense layers' bf16 GEMM
(f32 output) equals the f32 product of the same values up to the order of
its f32 sums.  The audio path: the frontend on the card within PERF.md
section 2's limits of the CPU's, prefetched batches bit-equal, and
``model.remat`` bit-equal (outside deterministic mode) with B1 launched
twice; two training steps from one state bit-equal.
The benches and tools: ``utils.devtime.device_time_ms`` of B3 within 20%
of its CUDA-event time, the C++ host decoder against B5 under the rule of
``torch_tools/cpp_b5.py`` (phase 13's) and
``torch_tools/smoke_cuda_decode.py`` passing.  The compiled step
(``train.graphs``, one CUDA graph per batch shape): the train step
bit-equal to the eager ``train_step`` in loss, metrics, parameters and
trace over 8 steps on two bucket shapes and two label widths (with and
without ``model.remat``), the eval step bit-equal to ``eval_step``, the
launch counts of the replays those of the eager steps, a capture leaving
the state as it was, replaced tensors refused, ``train.debug_nans``
eager, a replay's first kernel inside its ``step.replay`` span on the
profiler's clock; B1/B2 captured as cooperative kernel nodes; ``train.loop.train``
through the graphs bit-equal to the eager steps; the label cut's CTC loss
bit-equal.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from tpu_ctc_torch.config import get_config
from tpu_ctc_torch.decode import beam, neural_lm
from tpu_ctc_torch.decode.lm import train_ngram_lm
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.losses import ctc, ctc_ref
from tpu_ctc_torch.ops import beam_cuda, birnn_cuda, ctc_cuda
from tpu_ctc_torch.train import step

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _recurrence_inputs(seed, t, b, h):
    """z, W and lengths; the first utterance is full length and, where
    there are two or more, the last has length 0."""
    r = np.random.RandomState(seed)
    z = 3.0 * r.randn(t, b, h).astype(np.float32)
    w = (0.5 / np.sqrt(h)) * r.randn(h, h).astype(np.float32)
    lens = r.randint(1, t + 1, b).astype(np.int32)
    lens[0] = t
    if b > 1:
        lens[-1] = 0
    return torch.from_numpy(z), torch.from_numpy(w), torch.from_numpy(lens)


_C = birnn_cuda.COUNTERS


def _b1(z, w, lens, **kw):
    """One direction of B1 on the card, under the plan for its shape."""
    return birnn_cuda.fwd_recurrence(z, (w,), lens, **kw)[0]


def _b2(g, hs, wt, **kw):
    """One direction of B2 on the card, under the plan for its shape."""
    return birnn_cuda.bwd_recurrence(g, (hs,), (wt,), **kw)[0]


def _card_plan(dev, b, h, dtype, directions=1):
    """``birnn_cuda.plan`` on this card's SMs."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return birnn_cuda.plan(b, h, dtype, directions=directions, n_sm=n_sm)


def _fwd_sweeps():
    """B1's narrow direction sweeps so far: a fused launch sweeps two."""
    return birnn_cuda.direction_sweeps(
        {name: k.launches for name, k in _C.items()})["birnn_fwd"]


def _launch_twice(kernel, launch):
    """Two launches of a bf16 kernel on the same inputs: their outputs are
    bit-equal (the split-K partials are summed in a fixed order)."""
    before = kernel.launches
    got, again = launch(), launch()
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(got, again)
    return got.float()


# bf16 covers B in {1, 17, 64, 128} (the edges of 16-row mma tiles), H in
# {100, 200} (not a multiple of 16) and the preset widths 1024 and 1824,
# and T = 1.
@pytest.mark.parametrize("t,b,h,dtype", [
    (40, 16, 256, torch.bfloat16), (33, 5, 100, torch.bfloat16),
    (20, 128, 64, torch.bfloat16), (25, 7, 72, torch.float32),
    (1, 17, 100, torch.bfloat16), (30, 1, 200, torch.bfloat16),
    (12, 64, 1824, torch.bfloat16), (10, 128, 1024, torch.bfloat16)])
@pytest.mark.parametrize("reverse", [False, True])
def test_birnn_kernel_matches_plain(dev, t, b, h, dtype, reverse):
    z, w, lens = _recurrence_inputs(t * b + h, t, b, h)
    z, w, lens = z.to(dev, dtype), w.to(dev, dtype), lens.to(dev)

    def launch():
        return _b1(z, w, lens, reverse=reverse, clip=20.0)

    want = birnn_cuda.fwd_recurrence_plain(z, w, lens, reverse=reverse,
                                           clip=20.0).float()
    if dtype == torch.float32:
        before = _C["birnn_fwd"].launches
        got = launch().float()
        torch.cuda.synchronize()
        assert _C["birnn_fwd"].launches == before + 1
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        got = _launch_twice(_C["birnn_fwd"], launch)
        assert torch.all((got - want).abs() <= 2 ** -6 * want.abs() + 2e-2)
    for i, n in enumerate(lens.tolist()):
        assert torch.all(got[n:, i] == 0)


# The wide instance (H > 16 columns a resident block): at the widths that
# take it on an H100 (2560, 4096; 6016, bf16's ceiling), bf16 and f32.
@pytest.mark.parametrize("t,b,h,dtype", [
    (24, 16, 2560, torch.bfloat16), (20, 16, 2560, torch.float32),
    (16, 16, 4096, torch.bfloat16), (12, 17, 4096, torch.float32),
    (8, 128, 6016, torch.bfloat16)])
@pytest.mark.parametrize("reverse", [False, True])
def test_wide_birnn_kernels_match_plain(dev, t, b, h, dtype, reverse):
    """B1 (from zero and from h0) and B2 on its states against the plain
    loops, each launch counted on the wide kernel and none on the narrow
    one, two launches bit-equal."""
    if _card_plan(dev, b, h, dtype).code != "wide":
        pytest.skip(f"H={h} takes the narrow instance on this card")
    z, w, lens = _recurrence_inputs(t * b + h, t, b, h)
    z, w, lens = z.to(dev, dtype), w.to(dev, dtype), lens.to(dev)
    h0 = torch.rand((b, h), generator=torch.Generator().manual_seed(h)).to(
        dev, dtype)
    tol = ((lambda want: 1e-4 + 1e-4 * want.abs()) if dtype == torch.float32
           else (lambda want: 2 ** -6 * want.abs() + 2e-2))
    narrow = (_C["birnn_fwd"].launches, _C["birnn_bwd"].launches)
    for carry in (None, h0):
        got = _launch_twice(_C["birnn_fwd_wide"], lambda: (
            _b1(z, w, lens, reverse=reverse, clip=20.0, h0=carry)))
        want = birnn_cuda.fwd_recurrence_plain(z, w, lens, reverse=reverse,
                                               clip=20.0, h0=carry).float()
        assert torch.all((got - want).abs() <= tol(want))
    hs = got.to(dtype)
    g = z.flip(0)
    d = _launch_twice(_C["birnn_bwd_wide"], lambda: (
        _b2(g, hs, w.t(), reverse=not reverse, clip=20.0)))
    want = birnn_cuda.bwd_recurrence_plain(g, hs, w.t(), reverse=not reverse,
                                           clip=20.0).float()
    assert torch.all((d - want).abs() <= tol(want))
    assert (_C["birnn_fwd"].launches,
            _C["birnn_bwd"].launches) == narrow


@pytest.mark.parametrize("t,b,h,dtype", [
    (30, 32, 1024, torch.bfloat16), (25, 17, 100, torch.bfloat16),
    (20, 64, 512, torch.float32), (16, 5, 2000, torch.bfloat16),
    (24, 16, 2048, torch.bfloat16), (18, 16, 2048, torch.float32),
    (20, 16, 100, torch.float32), (12, 128, 1024, torch.bfloat16)])
def test_wide_instance_is_bit_equal_to_the_narrow_one(dev, t, b, h, dtype):
    """At a width both instances take, the wide one sums in the narrow
    one's order: planned for a card of fewer SMs (2 and 4 column tiles a
    block), B1 from h0 and B2 bit-equal to the narrow launch, each counted
    on its own instance's counter; B = 16 is a TP rank's rows under model =
    4 at preset 5."""
    z, w, lens = _recurrence_inputs(h + b, t, b, h)
    z, w, lens = z.to(dev, dtype), w.to(dev, dtype), lens.to(dev)
    h0 = torch.rand((b, h), generator=torch.Generator().manual_seed(b)).to(
        dev, dtype)
    narrow, tiles = _card_plan(dev, b, h, dtype), -(-h // 16)
    assert narrow.code == "narrow"
    hs = _b1(z, w, lens, reverse=True, clip=20.0, h0=h0, plan=narrow)
    d = _b2(z, hs, w.t(), reverse=False, clip=20.0, plan=narrow)
    for own in (2, 4):
        wide = birnn_cuda.plan(b, h, dtype, n_sm=-(-tiles // own))
        assert (wide.code, wide.cols) == ("wide", 16 * own)
        before = _C["birnn_fwd_wide"].launches, _C["birnn_bwd_wide"].launches
        assert torch.equal(hs, _b1(z, w, lens, reverse=True, clip=20.0,
                                   h0=h0, plan=wide))
        assert torch.equal(d, _b2(z, hs, w.t(), reverse=False, clip=20.0,
                                  plan=wide))
        assert (_C["birnn_fwd_wide"].launches,
                _C["birnn_bwd_wide"].launches) == (before[0] + 1,
                                                   before[1] + 1)


def test_wide_plan_and_limits_on_this_card(dev):
    """``check_supported`` on this card's SMs at the JAX ceiling (bf16
    6016, f32 4096) and above it; the C launcher's plan agrees with
    ``plan``'s grid and tiles a block."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for h, dtype in ((6016, torch.bfloat16), (4096, torch.float32)):
        birnn_cuda.check_supported(128, h, dtype, n_sm=n_sm)
        on_card = birnn_cuda.wide_plan(128, h, dtype)
        p = _card_plan(dev, 128, h, dtype)
        assert (on_card["grid"], on_card["own"]) == (p.grid, p.cols // 16)
        assert 0 < on_card["smem"] <= 232448
    for h, dtype in ((6017, torch.bfloat16), (4097, torch.float32)):
        with pytest.raises(NotImplementedError, match="JAX package"):
            birnn_cuda.check_supported(16, h, dtype, n_sm=n_sm)


def test_birnn_kernel_refuses_what_it_cannot_take(dev):
    z, w, lens = _recurrence_inputs(0, 4, 129, 32)
    with pytest.raises(NotImplementedError):
        _b1(z.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16),
            lens.to(dev), reverse=False, clip=20.0)
    with pytest.raises(NotImplementedError):                # mixed dtypes
        _b1(z[:, :8].to(dev), w.to(dev, torch.bfloat16), lens[:8].to(dev),
            reverse=False, clip=20.0)


def test_model_kernel_path_matches_plain(dev):
    cfg = get_config("swbd_beam_decode", **{"model.hidden_dim": 96,
                                            "model.num_bi_layers": 2})
    model = birnn.init_params(cfg.model, seed=1, device=dev)
    r = np.random.RandomState(2)
    feats = torch.from_numpy(r.randn(6, 50, 120).astype(np.float32)).to(dev)
    lens = torch.tensor([50, 44, 31, 50, 12, 1], device=dev)
    mask = (torch.arange(50, device=dev)[None] < lens[:, None]).float()
    before = _fwd_sweeps()
    got = birnn.log_posteriors(model, cfg.model, feats, mask)
    assert _fwd_sweeps() == before + 4
    want = birnn.log_posteriors(
        model, dataclasses.replace(cfg.model, birnn_impl="scan"), feats, mask)
    assert got.shape == (6, 50, 29) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-2)


@pytest.mark.parametrize("t,b,h,dtype", [
    (20, 128, 64, torch.bfloat16), (12, 32, 1024, torch.bfloat16),
    (8, 16, 1824, torch.bfloat16), (15, 7, 72, torch.float32),
    (9, 5, 1024, torch.float32), (6, 3, 1824, torch.float32),
    (1, 17, 100, torch.bfloat16), (30, 1, 200, torch.bfloat16),
    (6, 64, 1824, torch.bfloat16), (6, 128, 1024, torch.bfloat16)])
@pytest.mark.parametrize("reverse", [False, True])
def test_birnn_bwd_kernel_matches_plain(dev, t, b, h, dtype, reverse):
    z, w, lens = _recurrence_inputs(t * b + h + 1, t, b, h)
    z, w, lens = z.to(dev, dtype), w.to(dev, dtype), lens.to(dev)
    hs = birnn_cuda.fwd_recurrence_plain(z, w, lens, reverse=not reverse,
                                         clip=20.0)
    g = torch.from_numpy(np.random.RandomState(h).randn(t, b, h).astype(
        np.float32)).to(dev, dtype)

    def launch():
        return _b2(g, hs, w.t(), reverse=reverse, clip=20.0)

    want = birnn_cuda.bwd_recurrence_plain(g, hs, w.t(), reverse=reverse,
                                           clip=20.0).float()
    if dtype == torch.float32:
        before = _C["birnn_bwd"].launches
        got = launch().float()
        torch.cuda.synchronize()
        assert _C["birnn_bwd"].launches == before + 1
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        got = _launch_twice(_C["birnn_bwd"], launch)
        assert torch.all((got - want).abs() <= 2 ** -6 * want.abs() + 2e-2)
    assert torch.all(got[hs.float() <= 0] == 0)       # inactive frames


def test_bi_recurrence_grad_kernel_matches_plain(dev):
    t, b, h = 30, 6, 256
    z, w, lens = _recurrence_inputs(5, t, b, h)
    wb = w.flip(0).contiguous()
    g = torch.from_numpy(np.random.RandomState(6).randn(t, b, h).astype(
        np.float32)).to(dev)
    grads = []
    for plain in (False, True):
        zz, wf_, wb_ = (x.to(dev).requires_grad_(True) for x in (z, w, wb))
        out = birnn_cuda.bi_recurrence(zz, wf_, wb_, lens.to(dev), clip=20.0,
                                       compute_dtype=torch.float32,
                                       plain=plain)
        out.backward(g)
        grads.append((out.detach(), zz.grad, wf_.grad, wb_.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


_BI_NAMES = ("birnn_fwd", "birnn_bwd", "birnn_fwd_bi32", "birnn_bwd_bi32")


def _bi_counts():
    return tuple(_C[name].launches for name in _BI_NAMES)


def _bi_plan(dev, b, h):
    """The plan of both directions at this shape on this card; skips where
    they do not fit at once."""
    p = _card_plan(dev, b, h, torch.bfloat16, directions=2)
    if p.directions != 2:
        pytest.skip(f"H={h}, B={b}: both directions do not fit this card "
                    "at once")
    return p


def _fused_counts(n):
    """_bi_counts' change after n fused launches of B1 and of B2."""
    return [0, 0, n, n]


def _bi_inputs(dev, t, b, h):
    """z, wf, wb (bf16) and ragged lengths: the first row full, the second
    one frame long, the last 0 (where there are three rows or more)."""
    _bi_plan(dev, b, h)
    z, wf, lens = _recurrence_inputs(t + b + h, t, b, h)
    wb = _recurrence_inputs(t + b + h + 1, t, b, h)[1]
    if b > 2:
        lens[1] = 1
    return (z.to(dev, torch.bfloat16), wf.to(dev, torch.bfloat16),
            wb.to(dev, torch.bfloat16), lens.to(dev))


# the train cell's shape (preset 2: T = 800, B = 32, H = 1024), an odd one;
# at 32 columns a block presets 3 and 4 (H = 1824, B = 64 on one card, 16 a
# card under DP4) and a width of 69 16-column tiles, whose last block of
# 32 holds 16 live columns (H = 1104, over 2 x 66 blocks of 16 on 132 SMs)
@pytest.mark.parametrize("t,b,h", [(800, 32, 1024), (37, 5, 100),
                                   (800, 64, 1824), (800, 16, 1824),
                                   (301, 37, 1104)])
def test_fused_sweeps_equal_one_launch_a_direction(dev, t, b, h):
    """B1 and B2 of both directions in one launch (``plan``: 32 columns a
    block) are torch.equal to one launch a direction; a fused launch counts
    once on its own counter and none on B1's or B2's, and two are
    bit-equal."""
    z, wf, wb, lens = _bi_inputs(dev, t, b, h)
    g = torch.from_numpy(np.random.RandomState(h).randn(t, b, h).astype(
        np.float32)).to(dev, torch.bfloat16)
    c0 = _bi_counts()

    def fwd():
        return birnn_cuda.fwd_recurrence(z, (wf, wb), lens, reverse=False,
                                         clip=20.0)

    def bwd():
        return birnn_cuda.bwd_recurrence(g, hs, (wf.t(), wb.t()),
                                         reverse=True, clip=20.0)
    hs = fwd()
    hs_again = fwd()
    d = bwd()
    d_again = bwd()
    torch.cuda.synchronize()
    assert [y - x for x, y in zip(c0, _bi_counts())] == _fused_counts(2)
    want_hs = [_b1(z, w, lens, reverse=rev, clip=20.0)
               for w, rev in ((wf, False), (wb, True))]
    want_d = [_b2(g, h_, w.t(), reverse=rev, clip=20.0)
              for h_, w, rev in ((hs[0], wf, True), (hs[1], wb, False))]
    for got, again, want in zip((*hs, *d), (*hs_again, *d_again),
                                (*want_hs, *want_d)):
        assert torch.equal(got, again)
        assert torch.equal(got, want)
    for i, n in enumerate(lens.tolist()):
        assert torch.all(hs[0][n:, i] == 0) and torch.all(hs[1][n:, i] == 0)
    assert float(hs[0].float().abs().max()) > 0


@pytest.mark.parametrize("t,b,h", [(60, 32, 1024), (60, 64, 1824)])
def test_bi_recurrence_fused_is_bit_equal_to_unfused(dev, t, b, h):
    """``BiRecurrence`` at preset 2's width and at presets 3 and 4's in
    bf16: its output and its three gradients (dz, dwf, dwb) bit-equal with
    both directions in one launch (``bi_recurrence``'s plan) and under a
    plan of one direction a launch."""
    z, wf, wb, lens = _bi_inputs(dev, t, b, h)
    one = _card_plan(dev, b, h, torch.bfloat16)
    g = torch.from_numpy(np.random.RandomState(3).randn(t, b, h).astype(
        np.float32)).to(dev)

    def run(plan):
        zz, wf_, wb_ = (x.float().requires_grad_(True) for x in (z, wf, wb))
        c0 = _bi_counts()
        if plan is None:
            out = birnn_cuda.bi_recurrence(zz, wf_, wb_, lens, clip=20.0,
                                           compute_dtype=torch.bfloat16)
        else:       # z, wf, wb, lengths, clip, cdt, io, bidirectional, plan
            out = birnn_cuda.BiRecurrence.apply(
                zz, wf_, wb_, lens, 20.0, torch.bfloat16, torch.bfloat16,
                True, plan)
        out.backward(g)
        torch.cuda.synchronize()
        n = [y - x for x, y in zip(c0, _bi_counts())]
        return (out.detach(), zz.grad, wf_.grad, wb_.grad), n
    fused, n_fused = run(None)
    unfused, n_unfused = run(one)
    assert n_fused == _fused_counts(1)
    assert n_unfused == [2, 2, 0, 0]
    for got, want in zip(fused, unfused):
        assert torch.equal(got, want)
    assert float(fused[2].abs().max()) > 0 and float(fused[3].abs().max()) > 0


def test_fused_launch_takes_at_most_64_rows_at_32_columns(dev):
    """At H = 1824 a layer of 80 rows (over the 32-column instance's 64)
    sweeps one direction a launch, as ``plan`` says: two launches of B1
    and two of B2, none fused, and the sweeps equal the plain loops'
    within B1's and B2's limits."""
    t, b, h = 20, 80, 1824
    assert _card_plan(dev, b, h, torch.bfloat16, directions=2).directions \
        == 1
    z, wf, lens = _recurrence_inputs(t + b + h, t, b, h)
    wb = _recurrence_inputs(t + b + h + 1, t, b, h)[1]
    z, wf, wb, lens = (z.to(dev, torch.bfloat16), wf.to(dev, torch.bfloat16),
                       wb.to(dev, torch.bfloat16), lens.to(dev))
    g = z.flip(0).contiguous()
    c0 = _bi_counts()
    hs = birnn_cuda.fwd_recurrence(z, (wf, wb), lens, reverse=False,
                                   clip=20.0)
    d = birnn_cuda.bwd_recurrence(g, hs, (wf.t(), wb.t()), reverse=True,
                                  clip=20.0)
    torch.cuda.synchronize()
    assert [y - x for x, y in zip(c0, _bi_counts())] == [2, 2, 0, 0]
    plain = birnn_cuda.PLAIN
    want = (*birnn_cuda.fwd_recurrence(z, (wf, wb), lens, reverse=False,
                                       clip=20.0, plan=plain),
            *birnn_cuda.bwd_recurrence(g, hs, (wf.t(), wb.t()), reverse=True,
                                       clip=20.0, plan=plain))
    for got, ref in zip((*hs, *d), want):
        got, ref = got.float(), ref.float()
        assert torch.all((got - ref).abs() <= 2 ** -6 * ref.abs() + 2e-2)


def _lattice(dev, seed, b, t, a, lmax, tl=None, ll=None):
    r = np.random.RandomState(seed)
    lp = torch.log_softmax(torch.from_numpy(
        2.0 * r.randn(b, t, a).astype(np.float32)), -1)
    labels = torch.from_numpy(r.randint(1, a, (b, lmax)).astype(np.int32))
    if tl is None:
        tl = r.randint(2 * lmax + 1, t + 1, b)
    if ll is None:
        ll = r.randint(lmax // 2, lmax + 1, b)
        ll[0] = lmax
    return ctc_cuda.lattice(lp.to(dev), labels.to(dev),
                            torch.as_tensor(tl, dtype=torch.int32, device=dev),
                            torch.as_tensor(ll, dtype=torch.int32, device=dev))


def _assert_dp_close(got, want):
    """Bit-equal, sentinels included."""
    dead = want <= ctc_ref.NEG_INF / 2
    assert torch.equal(dead, got <= ctc_ref.NEG_INF / 2)
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("b,t,a,lmax,tl,ll", [
    (6, 90, 29, 20, None, None),
    (4, 300, 29, 127, None, None),                       # S = 255
    (5, 40, 12, 8, [40, 0, 40, 3, 17], [8, 2, 0, 8, 0]),  # empty, no labels,
    (3, 64, 29, 30, [20, 64, 64], [30, 0, 0])])           # infeasible
def test_ctc_kernels_match_plain(dev, b, t, a, lmax, tl, ll):
    emit, skip, skip2, init, final, lengths = _lattice(
        dev, b + t, b, t, a, lmax, tl, ll)
    before = (ctc_cuda.ALPHA.launches, ctc_cuda.BETA.launches)
    alpha = ctc_cuda.alpha_cuda(emit, skip, init, lengths)
    beta = ctc_cuda.beta_cuda(emit, skip2, final, lengths)
    torch.cuda.synchronize()
    assert (ctc_cuda.ALPHA.launches, ctc_cuda.BETA.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_dp_close(alpha, ctc_cuda.alpha_plain(emit, skip, init, lengths))
    _assert_dp_close(beta, ctc_cuda.beta_plain(emit, skip2, final, lengths))


def _chunk_frames(n_s):
    fn = ctc_cuda.ALPHA.lib().ctc_chunk_frames
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
    return fn(n_s)


# The edges of the redesigned sweeps: lengths 0, 1, T and past T; S = 1
# (no labels), S = 3 and S near MAX_STATES (chunks of 9 frames); T not a
# multiple of the chunk, so the last chunk (the first for beta) is short.
@pytest.mark.parametrize("b,t,a,lmax,tl,ll", [
    (4, 37, 29, 6, [0, 1, 37, 45], [6, 3, 6, 2]),
    (3, 33, 29, 0, [33, 10, 0], [0, 0, 0]),
    (3, 70, 29, 1, [70, 5, 71], [1, 0, 1]),
    (2, 40, 29, 511, [40, 41], [511, 300]),
    (3, 103, 12, 490, [103, 1, 99], [490, 2, 17])])
def test_ctc_kernels_bit_equal_at_the_edges(dev, b, t, a, lmax, tl, ll):
    emit, skip, skip2, init, final, lengths = _lattice(
        dev, b + t + lmax, b, t, a, lmax, tl, ll)
    n_s = emit.shape[2]
    assert n_s == 2 * lmax + 1 and t % _chunk_frames(n_s) != 0
    _assert_dp_close(ctc_cuda.alpha_cuda(emit, skip, init, lengths),
                     ctc_cuda.alpha_plain(emit, skip, init, lengths))
    _assert_dp_close(ctc_cuda.beta_cuda(emit, skip2, final, lengths),
                     ctc_cuda.beta_plain(emit, skip2, final, lengths))


def test_ctc_kernels_take_an_unaligned_lattice(dev):
    """emit starting 4 bytes past a 16-byte boundary (a view): the
    chunks' 16-byte copies and stores shift by its phase."""
    emit, skip, skip2, init, final, lengths = _lattice(dev, 5, 3, 50, 29, 9)
    flat = torch.empty(emit.numel() + 1, device=dev)
    view = flat[1:].view(emit.shape)
    view.copy_(emit)
    assert view.data_ptr() % 16 == 4
    _assert_dp_close(ctc_cuda.alpha_cuda(view, skip, init, lengths),
                     ctc_cuda.alpha_plain(emit, skip, init, lengths))
    _assert_dp_close(ctc_cuda.beta_cuda(view, skip2, final, lengths),
                     ctc_cuda.beta_plain(emit, skip2, final, lengths))


def test_ctc_loss_kernel_path_matches_the_oracle(dev):
    r = np.random.RandomState(3)
    b, t, a, lmax = 8, 120, 29, 30
    logits = torch.from_numpy(r.randn(b, t, a).astype(np.float32))
    labels = torch.from_numpy(r.randint(1, a, (b, lmax)).astype(np.int32))
    tl = torch.from_numpy(r.randint(70, t + 1, b).astype(np.int32))
    ll = torch.from_numpy(r.randint(0, lmax + 1, b).astype(np.int32))
    ll[1], tl[2], ll[2] = 0, 20, 30                      # blank-only; infeasible
    args = [x.to(dev) for x in (labels, tl, ll)]
    res = []
    for impl in ("auto", "jnp"):
        x = logits.to(dev).requires_grad_(True)
        nll = ctc.ctc_loss(x, *args, impl=impl)
        nll.sum().backward()
        res.append((nll.detach(), x.grad))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(res[0][1], res[1][1], rtol=1e-4, atol=1e-4)
    assert float(res[0][0][2]) == 1e9 and not res[0][1][2].any()


def test_ctc_kernels_refuse_what_they_cannot_take(dev):
    emit = torch.zeros((2, 4, 1025), device=dev)
    masks = torch.zeros((2, 1025), device=dev)
    lens = torch.tensor([4, 4], device=dev)
    with pytest.raises(NotImplementedError):
        ctc_cuda.alpha_cuda(emit, masks, masks, lens)
    with pytest.raises(ValueError):
        ctc_cuda.beta_cuda(emit, masks[:, :3], masks, lens)


def test_train_step_kernel_path_matches_plain(dev):
    over = {"model.hidden_dim": 128, "model.num_bi_layers": 2,
            "model.compute_dtype": "float32", "data.batch_size": 6}
    cfg = get_config("2", **over)
    plain = cfg.override(**{"model.birnn_impl": "scan", "ctc_impl": "jnp"})
    r = np.random.RandomState(4)
    batch = {"feats": r.randn(6, 60, 120).astype(np.float32),
             "frame_lengths": np.array([60, 55, 41, 60, 33, 48], np.int32),
             "labels": r.randint(1, 29, (6, 12)).astype(np.int32),
             "label_lengths": np.array([12, 9, 0, 5, 12, 7], np.int32),
             "weights": np.ones(6, np.float32)}
    batch["frame_mask"] = (np.arange(60)[None] < batch["frame_lengths"][:, None]
                           ).astype(np.float32)
    bt = step.batch_to_tensors(batch, dev)
    out = []
    for c in (cfg, plain):
        state = step.create_train_state(c, device=dev)
        counts = (_C["birnn_fwd"].launches, _C["birnn_bwd"].launches,
                  ctc_cuda.ALPHA.launches, ctc_cuda.BETA.launches)
        state, m = step.train_step(state, bt, c)
        after = (_C["birnn_fwd"].launches, _C["birnn_bwd"].launches,
                 ctc_cuda.ALPHA.launches, ctc_cuda.BETA.launches)
        out.append((m, dict(state.model.named_parameters()),
                    [y - x for x, y in zip(counts, after)]))
    assert out[0][2] == [4, 4, 1, 1] and out[1][2] == [0, 0, 0, 0]
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(out[0][0][key], out[1][0][key], rtol=1e-4,
                                   atol=0)
    for name, p in out[0][1].items():
        torch.testing.assert_close(p, out[1][1][name], rtol=1e-4, atol=1e-6)


def test_train_step_is_bit_reproducible(dev):
    """Two ``train_step`` calls from the same state on the same batch,
    outside PyTorch's deterministic mode, give bit-equal losses, gradient
    norms and parameters: the CTC glue's emission gather sums its gradient
    in a fixed order (``ctc_cuda.EmitGather``), not with atomics."""
    assert not torch.are_deterministic_algorithms_enabled()
    cfg = get_config("2", **{"model.hidden_dim": 256,
                             "model.num_bi_layers": 2, "data.batch_size": 8})
    r = np.random.RandomState(6)
    lens = np.array([80, 77, 64, 80, 51, 70, 80, 33], np.int32)
    batch = {"feats": r.randn(8, 80, 120).astype(np.float32),
             "frame_lengths": lens,
             "frame_mask": (np.arange(80)[None] < lens[:, None]).astype(
                 np.float32),
             "labels": r.randint(1, 29, (8, 20)).astype(np.int32),
             "label_lengths": np.array([20, 15, 9, 20, 1, 12, 18, 6],
                                       np.int32),
             "weights": np.ones(8, np.float32)}
    bt = step.batch_to_tensors(batch, dev)
    out = []
    for _ in range(2):
        state = step.create_train_state(cfg, device=dev)
        state, m = step.train_step(state, bt, cfg)
        out.append((m, dict(state.model.named_parameters())))
    for key in ("loss", "grad_norm"):
        assert torch.equal(out[0][0][key], out[1][0][key])
    for name, p in out[0][1].items():
        assert torch.equal(p, out[1][1][name]), name


def test_gru_lm_training_is_bit_reproducible(dev):
    """Two trainings of the GRU char LM on the same transcripts, as every
    GRU sweep and decode trains it (``train_char_rnn_lm``: Adam on the
    batches of one seed), outside PyTorch's deterministic mode, give
    bit-equal parameters: the decode of the valid split meets the LM that
    its (alpha, beta) was tuned for on dev."""
    assert not torch.are_deterministic_algorithms_enabled()
    r = np.random.RandomState(7)
    seqs = [r.randint(1, 29, r.randint(5, 60)).astype(np.int32)
            for _ in range(200)]
    cfg = neural_lm.CharRNNLMConfig(vocab_size=29, embed_dim=64,
                                    hidden_dim=128)
    runs = [dict(neural_lm.train_char_rnn_lm(seqs, cfg, steps=30,
                                             device=dev)[0]
                 .named_parameters()) for _ in range(2)]
    for name, p in runs[0].items():
        assert torch.equal(p, runs[1][name]), name


def test_gru_lm_graphed_training_is_the_eager_training(dev, monkeypatch):
    """On a card ``train_char_rnn_lm`` replays the NLL's forward and
    backward as CUDA graphs (``neural_lm.graphed_nll``): 30 Adam steps
    give parameters and a last NLL bit-equal to the same steps with the
    eager NLL."""
    r = np.random.RandomState(7)
    seqs = [r.randint(1, 29, r.randint(5, 60)).astype(np.int32)
            for _ in range(200)]
    cfg = neural_lm.CharRNNLMConfig(vocab_size=29, embed_dim=64,
                                    hidden_dim=128)
    graphed, nll = neural_lm.train_char_rnn_lm(seqs, cfg, steps=30,
                                               device=dev)
    monkeypatch.setattr(neural_lm, "graphed_nll", lambda *a: None)
    eager, eager_nll = neural_lm.train_char_rnn_lm(seqs, cfg, steps=30,
                                                   device=dev)
    assert nll == eager_nll
    for (name, p), q in zip(graphed.named_parameters(), eager.parameters()):
        assert torch.equal(p, q), name


def _posteriors(seed, b, t, a, scale=2.0):
    r = np.random.RandomState(seed)
    lp = torch.log_softmax(
        torch.from_numpy(scale * r.randn(b, t, a).astype(np.float32)), -1)
    lens = r.randint(1, t + 1, size=b).astype(np.int32)
    lens[0] = t
    return lp, torch.from_numpy(lens)


def _lm(seed, a, order):
    r = np.random.RandomState(seed)
    seqs = [r.randint(1, a, size=r.randint(3, 40)) for _ in range(200)]
    return train_ngram_lm(seqs, vocab_size=a, order=order)


@pytest.mark.parametrize("k,a,order,kw", [
    (128, 29, 3, dict(lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)),
    (8, 29, 3, dict(lm_alpha=0.7, lm_beta=0.3)),
    (64, 29, 2, dict(lm_alpha=1.0, lm_beta=0.5, prune_logp=-4.0)),
    (16, 9, 1, dict(lm_alpha=0.9, lm_beta=0.2)),
    (32, 29, 0, dict()),
    (100, 40, 3, dict(lm_alpha=1.25, lm_beta=1.5, char_topk=7)),
    (128, 64, 0, dict(prune_logp=-6.0)),
])
def test_beam_kernel_matches_plain(dev, k, a, order, kw):
    lp, lens = _posteriors(k + a + order, 6, 90, a)
    lp, lens = lp.to(dev), lens.to(dev)
    lm = _lm(order, a, order).tables(dev) if order else None
    args = dict(beam_width=k, max_len=40, lm_table=lm, lm_order=order, **kw)
    before = beam_cuda.KERNEL.launches
    got = beam_cuda.beam_search_cuda(lp, lens, **args)
    torch.cuda.synchronize()
    assert beam_cuda.KERNEL.launches == before + 1
    want = beam.prefix_beam_search(lp, lens, **args)
    assert torch.equal(got[1], want[1])
    for i in range(lp.shape[0]):
        n = int(got[1][i])
        assert torch.equal(got[0][i, :n], want[0][i, :n])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-3)


def test_beam_kernel_state_equals_plain_slot_by_slot(dev):
    lp, lens = _posteriors(7, 4, 120, 29)
    lp, lens = lp.to(dev), lens.to(dev)
    lm = _lm(3, 29, 3).tables(dev)
    kw = dict(lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)
    lp_k, lens_k, lm_k, _, _ = beam_cuda.prepare(lp, lens, 16, lm_table=lm,
                                                 lm_order=3)
    _, fin = beam_cuda.launch(lp_k, lens_k, 16, 64, lm=lm_k, lm_order=3,
                              **kw)
    *_, score, plen, _ = beam.prefix_beam_search(
        lp, lens, beam_width=16, max_len=64, lm_table=lm, lm_order=3,
        return_beams=True, **kw)
    torch.testing.assert_close(beam._lse2(fin[:, 0], fin[:, 1]), score,
                               rtol=0, atol=1e-3)
    live = score > -1e29
    assert torch.equal(fin[:, 2].to(torch.int32)[live], plen[live])


def test_beam_kernel_zero_length_utterance(dev):
    lp, _ = _posteriors(3, 2, 10, 29)
    lens = torch.tensor([10, 0], dtype=torch.int32)
    got = beam_cuda.beam_search_cuda(lp.to(dev), lens.to(dev), 8, 12)
    assert int(got[1][1]) == 0 and float(got[2][1]) == 0.0


@pytest.mark.parametrize("k,gru_h,limit", [(257, None, "257"),
                                           (16, 300, "hidden 300")])
def test_decoder_raises_for_what_the_kernel_lacks(dev, k, gru_h, limit):
    """What the kernels do not take (K = 257, a GRU with H = 300) raises on
    the card, naming the limit, and launches nothing: no plain search runs
    there in the kernels' place.  The kernel's own wrapper raises too."""
    cfg = get_config("4", **{"model.hidden_dim": 32,
                             "model.num_bi_layers": 1,
                             "decode.beam_width": k})
    gru = _gru(4, 29, 8, gru_h, dev) if gru_h else None
    before = [kern.launches for kern in (beam_cuda.KERNEL,
                                         beam_cuda.WIDE_KERNEL,
                                         beam_cuda.RECONSTRUCT)]
    with pytest.raises(NotImplementedError, match=limit):
        beam.make_beam_decoder(cfg, lm=_lm(3, 29, 3), nlm_params=gru,
                               device=dev)
    assert [kern.launches for kern in (beam_cuda.KERNEL,
                                       beam_cuda.WIDE_KERNEL,
                                       beam_cuda.RECONSTRUCT)] == before
    lp, lens = _posteriors(1, 2, 10, 29)
    with pytest.raises(NotImplementedError):
        beam_cuda.beam_search_cuda(lp.to(dev), lens.to(dev), 257, 12)


def test_cli_decode_refuses_what_the_kernel_lacks_before_the_lms_train(
        dev, monkeypatch):
    """On the card ``cli decode`` refuses a GRU over the kernels' dims
    before either LM trains."""
    from tpu_ctc_torch import cli
    from tpu_ctc_torch.decode import lm as tlm

    def trained(*args, **kwargs):
        raise AssertionError("an LM trained before the kernels' check")
    monkeypatch.setattr(tlm, "train_char_lm_from_data", trained)
    monkeypatch.setattr(neural_lm, "train_nlm_from_data", trained)
    with pytest.raises(NotImplementedError, match="hidden 300"):
        cli.main(["decode", "--config", "1", "--set", "model.hidden_dim=8",
                  "--set", "decode.neural_lm=True", "--set",
                  "decode.neural_lm_hidden=300", "--synthetic", "2",
                  "--beam"])


@pytest.mark.parametrize("b,t,k,max_len", [
    (3, 25, 16, 30), (70, 300, 256, 300), (1, 1, 1, 4), (33, 800, 128, 216)])
def test_reconstruct_kernel_equals_the_plain_walk(dev, b, t, k, max_len):
    r = np.random.RandomState(b + t)
    parent = r.randint(0, k, size=(b, t, k))
    char = np.where(r.rand(b, t, k) < 0.2, r.randint(0, 28, (b, t, k)), -1)
    bp = torch.from_numpy((parent + (char + 1) * 256).astype(np.int32))
    best = torch.from_numpy(r.randint(0, k, size=b))
    want = beam_cuda.reconstruct_plain(bp, best, max_len)
    before = beam_cuda.RECONSTRUCT.launches
    got = beam_cuda.reconstruct_cuda(bp.to(dev), best.to(dev), max_len)
    torch.cuda.synchronize()
    assert beam_cuda.RECONSTRUCT.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


def test_bf16_gemm_route_matches_the_f32_product(dev):
    """The dense products of bf16 operands run as one bf16 GEMM with an
    f32 output: within f32 sum order (1e-5 of the sum of |terms|) of the
    f32 product of the same values, which a bf16-rounded output (~4e-3)
    would miss; DotF32's backward still takes the f32 cotangent in f32."""
    r = np.random.RandomState(12)
    x = torch.from_numpy(r.randn(2, 400, 1824).astype(np.float32)).to(dev)
    w = torch.from_numpy(0.05 * r.randn(1824, 1024).astype(np.float32)).to(
        dev)
    g = torch.from_numpy(r.randn(2, 400, 1024).astype(np.float32)).to(dev)
    xb, wb = x.bfloat16(), w.bfloat16()
    scale = xb.float().abs().reshape(-1, 1824) @ wb.float().abs()
    got = birnn_cuda.matmul_bf16(xb.reshape(-1, 1824), wb)
    want = birnn_cuda.matmul_f32(xb.reshape(-1, 1824).float(), wb.float())
    assert got.dtype == torch.float32
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    assert not torch.equal(got, (xb.reshape(-1, 1824) @ wb).float())
    tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = birnn_cuda.dot_f32(tx, tw, torch.bfloat16)
    out.backward(g)
    assert bool(((out.reshape(-1, 1024) - want).abs() <= 1e-5 * scale).all())
    assert torch.equal(tx.grad, birnn_cuda.matmul_f32(
        g, wb.float().t()).bfloat16().float())
    assert torch.equal(tw.grad, birnn_cuda.matmul_f32(
        xb.float().reshape(-1, 1824).t(),
        g.reshape(-1, 1024)).bfloat16().float())
    h, d = xb[:, :, :1024].transpose(0, 1), g.bfloat16().transpose(0, 1)
    dw = birnn_cuda._weight_grad(h, d)
    dw_f32 = birnn_cuda.matmul_f32(h.reshape(-1, 1024).float().t(),
                                   d.reshape(-1, 1024).float())
    dw_scale = h.reshape(-1, 1024).float().abs().t() @ d.reshape(
        -1, 1024).float().abs()
    assert bool(((dw - dw_f32).abs() <= 1e-5 * dw_scale).all())


def _gru(seed, a, e, h, dev):
    return neural_lm.init_params(neural_lm.CharRNNLMConfig(a, e, h), seed,
                                 device=dev)


def _assert_search_equal(got, want, atol):
    assert torch.equal(got[1], want[1])
    for i in range(got[0].shape[0]):
        n = int(got[1][i])
        assert torch.equal(got[0][i, :n], want[0][i, :n])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=atol)


def _launch_gru_twice(lp, lens, args):
    """Two launches of B5 or B6 with the GRU on the same inputs, laid out
    as ``beam_search_cuda`` lays them out for ``args``: their backpointers
    and final states are bit-equal (every sum runs in a fixed order);
    returns the first launch's backpointers."""
    kw = dict(args)
    k, max_len = kw.pop("beam_width"), kw.pop("max_len")
    lp_k, lens_k, lm, thr, gru = beam_cuda.prepare(
        lp, lens, k, lm_table=kw.pop("lm_table", None),
        lm_order=kw.get("lm_order", 0), char_topk=kw.pop("char_topk", 0),
        nlm_params=kw.pop("nlm_params"))
    bp, fin = beam_cuda.launch(lp_k, lens_k, k, max_len, lm=lm, thr=thr,
                               gru=gru, **kw)
    bp2, fin2 = beam_cuda.launch(lp_k, lens_k, k, max_len, lm=lm, thr=thr,
                                 gru=gru, **kw)
    torch.cuda.synchronize()
    assert torch.equal(bp, bp2) and torch.equal(fin, fin2)
    return bp


def _check_gru_search(dev, k, a, order, e, h, kw, n_b, n_t):
    """B5 or B6 with the GRU: launched once by ``beam_search_cuda``, its
    hypotheses equal to the plain search's and its scores within 1e-4, and
    two launches bit-equal."""
    lp, lens = _posteriors(k + a + h + order, n_b, n_t, a)
    lp, lens = lp.to(dev), lens.to(dev)
    lm = _lm(order, a, order).tables(dev) if order else None
    args = dict(beam_width=k, max_len=40, lm_table=lm, lm_order=order,
                nlm_params=_gru(e + h, a, e, h, dev), **kw)
    kern = beam_cuda.kernel_for(k)
    other = (beam_cuda.KERNEL if kern is beam_cuda.WIDE_KERNEL
             else beam_cuda.WIDE_KERNEL)
    before = (kern.launches, other.launches)
    got = beam_cuda.beam_search_cuda(lp, lens, **args)
    torch.cuda.synchronize()
    assert (kern.launches, other.launches) == (before[0] + 1, before[1])
    _assert_search_equal(got, beam.prefix_beam_search(lp, lens, **args),
                         atol=1e-4)
    _launch_gru_twice(lp, lens, args)


# The GRU rows of B5 (K <= 128) and B6 (K in (128, 256]) include the
# kernels' limits: K in {1, 17, 129, 256} (one 16-row tile, a ragged one,
# B6's first width, its last), H in {24, 100, 256} (100 pads to 104), E in
# {8, 128}, A in {5, 64} (one 8-column tile, eight); (256, 64, 0, 8, 256)
# is the largest shared-memory plan.
LIMITS_KW = dict(lm_alpha=0.8, lm_beta=0.4)


@pytest.mark.parametrize("k,a,order,e,h,kw", [
    (8, 29, 0, 10, 13, dict(lm_alpha=0.6, lm_beta=0.3)),
    (64, 29, 3, 64, 128, dict(lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)),
    (128, 29, 3, 64, 128, dict(lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)),
    (64, 29, 2, 20, 50, dict(lm_alpha=0.7, lm_beta=0.3, char_topk=6)),
    (128, 29, 0, 33, 256, dict(lm_alpha=0.5, lm_beta=0.2, prune_logp=-5.0)),
    (1, 5, 0, 8, 24, LIMITS_KW), (17, 64, 0, 128, 100, LIMITS_KW),
    (17, 5, 0, 8, 256, LIMITS_KW), (1, 64, 0, 128, 256, LIMITS_KW),
])
def test_beam_kernel_with_gru_matches_plain(dev, k, a, order, e, h, kw):
    _check_gru_search(dev, k, a, order, e, h, kw, n_b=4, n_t=60)


@pytest.mark.parametrize("k,a,order,kw", [
    (160, 29, 3, dict(lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)),
    (200, 29, 3, dict(lm_alpha=0.7, lm_beta=0.3, char_topk=8)),
    (256, 29, 2, dict(lm_alpha=1.0, lm_beta=0.5)),
    (256, 64, 0, dict(prune_logp=-7.0)),
])
def test_wide_beam_kernel_matches_plain(dev, k, a, order, kw):
    """B6 with an n-gram LM: every slot's final (pb, pnb, plen) equals the
    plain search's."""
    lp, lens = _posteriors(k + a + order, 4, 70, a)
    lp, lens = lp.to(dev), lens.to(dev)
    lm = _lm(order, a, order).tables(dev) if order else None
    args = dict(beam_width=k, max_len=40, lm_table=lm, lm_order=order, **kw)
    before = (beam_cuda.KERNEL.launches, beam_cuda.WIDE_KERNEL.launches)
    got = beam_cuda.beam_search_cuda(lp, lens, **args)
    torch.cuda.synchronize()
    assert (beam_cuda.KERNEL.launches,
            beam_cuda.WIDE_KERNEL.launches) == (before[0], before[1] + 1)
    want = beam.prefix_beam_search(lp, lens, return_beams=True, **args)
    _assert_search_equal(got, want[:3], atol=0.0)
    kernel_args = {x: kw[x] for x in ("lm_alpha", "lm_beta", "prune_logp")
                   if x in kw}
    lp_k, lens_k, lm_k, thr, _ = beam_cuda.prepare(
        lp, lens, k, lm_table=lm, lm_order=order,
        char_topk=kw.get("char_topk", 0))
    _, fin = beam_cuda.launch(lp_k, lens_k, k, 40, lm=lm_k, lm_order=order,
                              thr=thr, **kernel_args)
    assert torch.equal(beam._lse2(fin[:, 0], fin[:, 1]), want[3])
    live = want[3] > -1e29            # a dead slot's length is not kept
    assert torch.equal(fin[:, 2].to(torch.int32)[live], want[4][live])


@pytest.mark.parametrize("k,a,order,e,h,kw", [
    (160, 29, 0, 8, 16, dict(lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)),
    (200, 29, 3, 64, 128, dict(lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)),
    (256, 29, 2, 10, 13, dict(lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)),
    (129, 5, 0, 128, 256, LIMITS_KW), (256, 64, 0, 8, 256, LIMITS_KW),
    (256, 29, 0, 128, 24, LIMITS_KW), (129, 64, 0, 8, 100, LIMITS_KW),
])
def test_wide_beam_kernel_with_gru_matches_plain(dev, k, a, order, e, h, kw):
    _check_gru_search(dev, k, a, order, e, h, kw, n_b=3, n_t=50)


def test_decoder_runs_the_wide_kernel_with_gru(dev):
    cfg = get_config("4", **{"model.hidden_dim": 32,
                             "model.num_bi_layers": 1,
                             "decode.beam_width": 200})
    model = birnn.init_params(cfg.model, seed=2, device=dev)
    r = np.random.RandomState(3)
    batch = {"feats": r.randn(3, 40, 120).astype(np.float32),
             "frame_lengths": np.array([40, 31, 22], np.int32),
             "labels": np.zeros((3, 10), np.int32)}
    batch["frame_mask"] = (np.arange(40)[None]
                           < batch["frame_lengths"][:, None]).astype(
                               np.float32)
    gru = _gru(4, 29, 16, 24, "cpu")
    before = beam_cuda.WIDE_KERNEL.launches
    hyps, lens = beam.make_beam_decoder(cfg, nlm_params=gru,
                                        device=dev)(model, batch)
    torch.cuda.synchronize()
    assert beam_cuda.WIDE_KERNEL.launches == before + 1
    assert hyps.shape == (3, 36) and hyps.is_cuda and lens.is_cuda


@pytest.mark.parametrize("k", [128, 200])
@pytest.mark.parametrize("extend", [False, True])
def test_beam_kernel_with_gru_extension_extremes(dev, k, extend):
    """A batch where no survivor ever extends (blank near-certain, every
    char pruned) and one where most do (blank near-impossible)."""
    r = np.random.RandomState(11)
    x = 2.0 * r.randn(4, 50, 29).astype(np.float32)
    x[..., 0] += -30.0 if extend else 30.0
    lp = torch.log_softmax(torch.from_numpy(x), -1).to(dev)
    lens = torch.tensor([50, 44, 31, 50], dtype=torch.int32, device=dev)
    kw = dict(lm_alpha=0.8, lm_beta=0.4, prune_logp=-12.0)
    nlm = _gru(4, 29, 16, 24, dev)
    args = dict(beam_width=k, max_len=60, nlm_params=nlm, **kw)
    got = beam_cuda.beam_search_cuda(lp, lens, **args)
    _assert_search_equal(got, beam.prefix_beam_search(lp, lens, **args),
                         atol=1e-4)
    bp = _launch_gru_twice(lp, lens, args)
    live = (torch.arange(50, device=dev)[None, :] < lens[:, None])
    share = float(((bp >> 8) > 0)[live].float().mean())
    if extend:
        assert share > 0.4
    else:
        assert share == 0.0 and not got[1].any()


def _waveforms(seed, b=4, n=48000):
    """White noise and noisy tones, lengths n down to n/4."""
    r = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    x = 0.1 * r.randn(b, n) + 0.5 * np.sin(
        2 * np.pi * (300 + 500 * np.arange(b))[:, None] * t)
    lens = np.linspace(n, n // 4, b).astype(np.int64)
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(lens)


@pytest.mark.parametrize("context,stride", [(1, 1), (2, 2)])
def test_frontend_on_the_card_matches_the_cpu(dev, context, stride):
    """The frontend's products run in f32 with TF32 off on the card: the
    power within 1e-5 of each frame's peak, the features within 1e-3
    (PERF.md section 2; no band of these waveforms is quiet)."""
    from tpu_ctc_torch.frontend import features as F
    cfg = dataclasses.replace(get_config("2").frontend, context=context,
                              frame_stride=stride)
    x, lens = _waveforms(0)
    p_cpu = F.stft_power(x, cfg)
    p_gpu = F.stft_power(x.to(dev), cfg).cpu()
    peak = p_cpu.amax(dim=-1, keepdim=True)
    assert bool(((p_gpu - p_cpu).abs() <= 1e-5 * peak).all())
    f_cpu, m_cpu = F.extract_features(x, cfg, lens)
    f_gpu, m_gpu = F.extract_features(x.to(dev), cfg, lens.to(dev))
    assert f_gpu.is_cuda and torch.equal(m_gpu.cpu(), m_cpu)
    assert float((f_gpu.cpu() - f_cpu).abs().max()) <= 1e-3


def test_prefetch_on_a_side_stream(dev):
    """Batches prefetched on a side stream equal the loader's own batches
    moved on the current stream, bit for bit, after a step reads them."""
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.prefetch import prefetch_to_device
    from tpu_ctc_torch.data.synthetic import SyntheticCorpus
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    cfg = get_config("2", **{"data.batch_size": 8,
                             "data.bucket_boundaries": (100, 200)})
    data = SyntheticCorpus(40, feature_dim=120, min_chars=2, max_chars=20,
                           seed=3).all_utterances()
    loader = BucketedLoader(data, cfg.data)
    got = []
    for cursor, batch, tensors in prefetch_to_device(loader.epoch(0), dev):
        assert all(t.is_cuda for t in tensors.values())
        got.append((cursor, {k: (t * 1).cpu() for k, t in tensors.items()}))
    want = list(loader.epoch(0))
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, g), (_, w) in zip(got, want):
        ref = step.batch_to_tensors(batch_to_device_dict(w), dev)
        for k in ref:
            assert torch.equal(g[k], ref[k].cpu()), k


def test_frontend_pool_prefetches_the_process_bits(dev, tmp_path):
    """One epoch of a small WAV corpus through ``prefetch_to_device``: a
    loader over ``ManifestDataset(workers=2)`` and one over the in-process
    dataset give bit-equal tensors on the card, and the pool's workers end
    with ``close``."""
    import multiprocessing

    from tpu_ctc_torch.data import audio_io
    from tpu_ctc_torch.data.alphabet import DEFAULT_ALPHABET
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.manifest import ManifestDataset, write_manifest
    from tpu_ctc_torch.data.prefetch import prefetch_to_device
    from tpu_ctc_torch.data.synthetic import synthetic_audio_batch
    cfg = get_config("2", **{"data.batch_size": 8,
                             "data.bucket_boundaries": (200, 400)})
    audio, sl, labels, ll = synthetic_audio_batch(
        24, 4 * 16000, min_chars=5, max_chars=25, seed=9,
        samples_per_char=2400)
    recs = []
    for i in range(len(sl)):
        audio_io.write_wav(str(tmp_path / f"u{i}.wav"), audio[i, :sl[i]],
                           16000)
        recs.append({"id": f"u{i}", "audio": f"u{i}.wav",
                     "text": DEFAULT_ALPHABET.decode(labels[i, :ll[i]]),
                     "samples": int(sl[i]), "rate": 16000})
    write_manifest(str(tmp_path), "train", recs)
    before = set(multiprocessing.active_children())
    pooled = ManifestDataset(str(tmp_path), cfg, workers=2)
    try:
        runs = []
        for ds in (pooled, ManifestDataset(str(tmp_path), cfg)):
            runs.append([(c, {k: t.cpu() for k, t in ts.items()})
                         for c, _, ts in prefetch_to_device(
                             BucketedLoader(ds, cfg.data).epoch(1), dev)])
    finally:
        pooled.close()
    assert set(multiprocessing.active_children()) == before
    assert len(runs[0]) == len(runs[1]) > 1
    for (c0, a), (c1, b) in zip(*runs):
        assert c0 == c1 and set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (c0, k)


@pytest.mark.parametrize("io", ["float32", "bfloat16"])
def test_remat_is_bit_equal_and_its_peak_memory(dev, io):
    """``model.remat``: loss and gradients bit-equal to the run without it
    (outside deterministic mode), B1 launched twice as often.  Remat keeps
    each layer's f32 projection in place of its two sweeps' states (the
    kernels take one dtype for the states and the products): with f32
    states (8 bytes an element against 4) the peak is lower; with bf16
    states (4 against 4) it is not asserted."""
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.synthetic import SyntheticCorpus
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    cfg = get_config("2", **{"model.hidden_dim": 512,
                             "model.compute_dtype": io,
                             "data.bucket_boundaries": (400,)})
    data = SyntheticCorpus(32, feature_dim=120, min_chars=20, max_chars=45,
                           seed=5).all_utterances()
    batch = next(BucketedLoader(data, cfg.data).epoch(0))[1]
    bt = step.batch_to_tensors(batch_to_device_dict(batch), dev)
    state = step.create_train_state(cfg, device=dev)

    def run(remat):
        c = cfg.override(**{"model.remat": remat})
        params = dict(state.model.named_parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _fwd_sweeps()
        loss, _ = step.loss_fn(state.model, c, bt)
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        return (loss, grads, _fwd_sweeps() - before,
                torch.cuda.max_memory_allocated())
    run(False)                                     # warm-up
    # outside deterministic mode: the CTC glue's gather sums its gradient
    # in a fixed order (ctc_cuda.EmitGather)
    assert not torch.are_deterministic_algorithms_enabled()
    loss0, g0, n0, peak0 = run(False)
    loss1, g1, n1, peak1 = run(True)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert (n0, n1) == (6, 12)
    if io == "float32":
        assert peak1 < peak0


# B1 from a nonzero carry (h0 seeded into the exchange buffer's first half)
@pytest.mark.parametrize("t,b,h,dtype", [
    (40, 16, 256, torch.bfloat16), (33, 5, 100, torch.bfloat16),
    (12, 64, 1824, torch.bfloat16), (25, 7, 72, torch.float32),
    (9, 5, 1024, torch.float32)])
@pytest.mark.parametrize("reverse", [False, True])
def test_birnn_kernel_from_h0_matches_plain(dev, t, b, h, dtype, reverse):
    z, w, lens = _recurrence_inputs(t * b + h + 7, t, b, h)
    h0 = torch.from_numpy(np.abs(2 * np.random.RandomState(h).randn(
        b, h)).astype(np.float32))
    z, w, lens, h0 = (z.to(dev, dtype), w.to(dev, dtype), lens.to(dev),
                      h0.to(dev, dtype))

    def launch(h0=h0):
        return _b1(z, w, lens, reverse=reverse, clip=20.0, h0=h0)

    want = birnn_cuda.fwd_recurrence_plain(z, w, lens, reverse=reverse,
                                           clip=20.0, h0=h0).float()
    if dtype == torch.float32:
        got = launch().float()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        got = _launch_twice(_C["birnn_fwd"], launch)
        assert torch.all((got - want).abs() <= 2 ** -6 * want.abs() + 2e-2)
    zero = torch.zeros_like(h0)
    assert torch.equal(launch(zero), launch(None))     # h0 = 0 is no h0
    assert not torch.equal(got, launch(zero).float())
    for i, n in enumerate(lens.tolist()):
        assert torch.all(got[n:, i] == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("reverse", [False, True])
def test_birnn_kernel_chunk_chain_is_one_sweep(dev, dtype, reverse):
    """Four chunks, each swept from the last stored state of the one before
    (sequence parallelism's carry), equal one sweep over all T bit for
    bit: the dot input is the stored state at every step either way."""
    t, b, h, n = 64, 32, 1024, 4
    z, w, lens = _recurrence_inputs(3, t, b, h)
    z, w, lens = z.to(dev, dtype), w.to(dev, dtype), lens.to(dev)
    whole = _b1(z, w, lens, reverse=reverse, clip=20.0)
    step_t = t // n
    starts = list(range(0, t, step_t))
    parts, carry = {}, None
    for s in (starts[::-1] if reverse else starts):
        local = torch.clamp(lens - s, 0, step_t)
        parts[s] = _b1(z[s:s + step_t], w, local, reverse=reverse,
                       clip=20.0, h0=carry)
        carry = parts[s][0] if reverse else parts[s][-1]
    assert torch.equal(torch.cat([parts[s] for s in starts]), whole)


@pytest.mark.parametrize("reverse", [False, True])
def test_carry_recurrence_grad_kernel_matches_plain(dev, reverse):
    """``CarryRecurrence`` on the kernels (B1 from h0, B2, the GEMMs)
    against its plain autograd at f32: hs, dz, dW and dh0 within 1e-4 of
    the largest magnitude."""
    t, b, h = 30, 6, 256
    z, w, lens = _recurrence_inputs(8 + reverse, t, b, h)
    r = np.random.RandomState(9)
    h0 = torch.from_numpy(np.abs(2 * r.randn(b, h)).astype(np.float32))
    g = torch.from_numpy(r.randn(b, t, h).astype(np.float32)).to(dev)
    mask = (torch.arange(t)[None] < lens[:, None]).float().to(dev)
    res = []
    for plain in (False, True):
        zz, ww, hh = (x.to(dev).requires_grad_(True)
                      for x in (z.transpose(0, 1).contiguous(), w, h0))
        out = birnn_cuda.carry_recurrence(zz, ww, hh, mask, reverse=reverse,
                                          clip=20.0,
                                          compute_dtype=torch.float32,
                                          plain=plain)
        out.backward(g)
        res.append((out.detach(), zz.grad, ww.grad, hh.grad))
    for got, want in zip(*res):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
    assert float(res[0][3].abs().max()) > 0                # dh0 reached


@pytest.mark.parametrize("reverse", [False, True])
def test_carry_backward_kernels_match_plain_bf16(dev, reverse):
    """At bf16 the backward (B2, dW, dh0) on the same forward states as its
    plain version: dz, dW and dh0 within 1e-2 of each one's norm (two
    forwards of their own would store states that round the other way and
    flip h > 0 at some units, chip_smoke.py phase 12)."""
    t, b, h = 30, 6, 256
    z, w, lens = _recurrence_inputs(10 + reverse, t, b, h)
    r = np.random.RandomState(11)
    bf = torch.bfloat16
    h0 = torch.from_numpy(np.abs(2 * r.randn(b, h)).astype(np.float32)).to(
        dev, bf)
    g = torch.from_numpy(r.randn(t, b, h).astype(np.float32)).to(dev)
    z, w, lens = z.to(dev, bf), w.to(dev), lens.to(dev)
    hs = _b1(z, w.to(bf), lens, reverse=reverse, clip=20.0, h0=h0)
    got, want = (birnn_cuda.carry_sweep_grad(
        g, hs, h0, w, reverse=reverse, clip=20.0, cdt=bf, plain=plain)
        for plain in (False, True))
    for a, ref in zip(got, want):
        assert float(torch.linalg.norm(a - ref)) <= 1e-2 * float(
            torch.linalg.norm(ref))
    assert float(got[2].abs().max()) > 0


def test_kernels_refuse_a_tensor_off_the_current_device(dev):
    """A launch runs on the calling thread's current device: a tensor on
    another one (the CPU here, another card when there are two) raises,
    naming both, before anything launches."""
    z, w, lens = _recurrence_inputs(1, 6, 4, 64)
    z, w, lens = z.to(dev), w.to(dev, torch.float32), lens.to(dev)
    with pytest.raises(ValueError, match="CUDA device"):
        _b1(z, w, lens, reverse=False, clip=20.0,
                                       h0=torch.zeros(4, 64))
    if torch.cuda.device_count() < 2:
        return
    other = torch.device("cuda", 1)
    before = _C["birnn_fwd"].launches
    with torch.cuda.device(0):
        with pytest.raises(ValueError, match="cuda:1 but the current "
                                             "device is cuda:0"):
            _b1(z.to(other), w.to(other), lens.to(other), reverse=False,
                clip=20.0)
    assert _C["birnn_fwd"].launches == before


NCCL_WORKER = """
import sys
import numpy as np, torch
from tpu_ctc_torch.config import get_config
from tpu_ctc_torch.data.bucketing import BucketedLoader
from tpu_ctc_torch.data.synthetic import SyntheticCorpus
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
from tpu_ctc_torch.train import step
from tpu_ctc_torch.train.loop import batch_to_device_dict

coord, rank = sys.argv[1], int(sys.argv[2])
dev = distributed.initialize(coord, 2, rank)
cfg = get_config("2", **{"model.hidden_dim": 256, "data.batch_size": 8,
                         "data.bucket_boundaries": (200,),
                         "mesh.data": 2})
data = SyntheticCorpus(16, feature_dim=120, min_chars=10, max_chars=20,
                       seed=4).all_utterances()
batches = [b for _, b in BucketedLoader(data, cfg.data).epoch(0)][:2]
mesh = mesh_lib.make_mesh(cfg.mesh)
state = step.create_train_state(cfg, device=dev)
step_fn, state = step.make_train_step(cfg, mesh, state)
losses = []
for b in batches:
    state, m = step_fn(state, step.batch_to_tensors(batch_to_device_dict(b),
                                                    dev, mesh))
    losses.append(float(m["loss"]))
flat = torch.cat([p.detach().reshape(-1).cpu()
                  for p in state.model.parameters()])
np.save(sys.argv[3] + f"/rank{rank}.npy", np.concatenate(
    [np.array(losses), flat.numpy()]))
del step_fn         # its graphs hold NCCL's communicators
torch.distributed.destroy_process_group()
"""


def test_two_rank_nccl_dp_step(dev, tmp_path):
    """Two NCCL ranks on two cards take DP steps of a narrow preset 2 (the
    compiled mesh step): the parameters are bit-equal across ranks and
    the losses within 1e-3 of one card's steps on the same global
    batches."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_WORKER, coord,
                               str(r), str(tmp_path)], cwd=repo,
                              env=dict(os.environ, PYTHONPATH=repo))
             for r in range(2)]
    assert [p.wait(timeout=600) for p in procs] == [0, 0]
    a, b = (np.load(tmp_path / f"rank{r}.npy") for r in range(2))
    assert np.array_equal(a, b)
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.synthetic import SyntheticCorpus
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    cfg = get_config("2", **{"model.hidden_dim": 256, "data.batch_size": 8,
                             "data.bucket_boundaries": (200,)})
    data = SyntheticCorpus(16, feature_dim=120, min_chars=10, max_chars=20,
                           seed=4).all_utterances()
    state = step.create_train_state(cfg, device=dev)
    for _, batch in list(BucketedLoader(data, cfg.data).epoch(0))[:2]:
        state, m = step.train_step(state, step.batch_to_tensors(
            batch_to_device_dict(batch), dev), cfg)
    np.testing.assert_allclose(a[1], float(m["loss"]), rtol=1e-3)


TP_WORKER = """
import sys
import numpy as np, torch
from tpu_ctc_torch.config import get_config
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
from tpu_ctc_torch.train import step

coord, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dev = distributed.initialize(coord, 2, rank)
cfg = get_config("2", **{"model.hidden_dim": 256, "mesh.data": 1,
                         "mesh.model": 2})
r = np.random.RandomState(3)
lens = r.randint(60, 121, 8)
arrays = {"feats": r.randn(8, 120, 120).astype(np.float32),
          "frame_mask": (np.arange(120)[None] < lens[:, None]).astype(
              np.float32),
          "frame_lengths": lens.astype(np.int32),
          "labels": r.randint(1, 29, (8, 20)).astype(np.int32),
          "label_lengths": r.randint(5, 20, 8).astype(np.int32),
          "weights": np.ones(8, np.float32)}
if rank == 0:
    np.savez(out + "/batch.npz", **arrays)
mesh = mesh_lib.make_mesh(cfg.mesh)
state = step.create_train_state(cfg, device=dev)
step_fn, state = step.make_train_step(cfg, mesh, state)
state, m = step_fn(state, step.batch_to_tensors(arrays, dev, mesh))
whole = step.full_state(state)
np.save(out + f"/rank{rank}.npy", np.concatenate(
    [[float(m["loss"])]] + [p.detach().reshape(-1).float().numpy()
                            for p in whole.model.parameters()]))
del step_fn         # its graphs hold NCCL's communicators
torch.distributed.destroy_process_group()
"""


def test_two_card_tp_step(dev, tmp_path):
    """Two NCCL ranks on two cards take a TP step (model = 2) of a narrow
    preset 2 (the compiled mesh step): the gathered parameters are
    bit-equal across ranks and the loss within 1e-3 of one card's step
    on the same batch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", TP_WORKER, coord,
                               str(r), str(tmp_path)], cwd=repo,
                              env=dict(os.environ, PYTHONPATH=repo))
             for r in range(2)]
    assert [p.wait(timeout=600) for p in procs] == [0, 0]
    a, b = (np.load(tmp_path / f"rank{r}.npy") for r in range(2))
    assert np.array_equal(a, b)
    cfg = get_config("2", **{"model.hidden_dim": 256})
    batch = dict(np.load(tmp_path / "batch.npz"))
    state = step.create_train_state(cfg, device=dev)
    _, m = step.train_step(state, step.batch_to_tensors(batch, dev), cfg)
    np.testing.assert_allclose(a[0], float(m["loss"]), rtol=1e-3)


MESH_GRAPH_WORKER = """
import faulthandler, json, sys
import numpy as np, torch
faulthandler.dump_traceback_later(300, exit=True)   # a hang shows its stack
from tpu_ctc_torch.config import get_config
from tpu_ctc_torch.data.bucketing import cut_labels
from tpu_ctc_torch.ops import kernels
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
from tpu_ctc_torch.train import graphs, step

coord, rank, out, over = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
dev = distributed.initialize(coord, 2, rank)
cfg = get_config("2", **{
    "model.hidden_dim": 128, "model.num_bi_layers": 2, "data.batch_size": 8,
    "optim.momentum_start": 0.5, "optim.momentum_ramp_steps": 9,
    "optim.lr_decay": 0.8, "optim.lr_decay_steps": 1, **json.loads(over)})
mesh = mesh_lib.make_mesh(cfg.mesh)


def batch(seed, t, longest):
    # the longest label in row 1 (data line 0's block under DP2); the rows
    # of data line 1 at most 20 characters, so their block alone cuts to 32
    r = np.random.RandomState(seed)
    lens = r.randint(2 * longest + 1, t + 1, 8).astype(np.int32)
    lens[0] = t
    ll = r.randint(1, 21, 8).astype(np.int32)
    ll[1] = longest
    labels = np.zeros((8, 128), np.int32)
    for i, n in enumerate(ll):
        labels[i, :n] = r.randint(1, 29, n)
    return {"feats": r.randn(8, t, 120).astype(np.float32),
            "frame_mask": (np.arange(t)[None] < lens[:, None]).astype(
                np.float32),
            "frame_lengths": lens, "labels": labels, "label_lengths": ll,
            "weights": np.ones(8, np.float32)}


def counts():
    return [k.launches for k in kernels()]


def tensors_of(state):
    return (list(state.model.parameters())
            + [state.opt_state.trace[k] for k in sorted(state.opt_state.trace)])


batches = [batch(i, t, n) for i, (t, n) in
           enumerate([(96, 20), (96, 40), (160, 20), (160, 40)])]
tensors = [step.batch_to_tensors(b, dev, mesh) for b in batches]
eager, ref = step.make_train_step(
    cfg, mesh, step.create_train_state(cfg, device=dev))
eager = getattr(eager, "eager", eager)    # the eager mesh step
fn, state = step.make_train_step(cfg, mesh,
                                 step.create_train_state(cfg, device=dev))
rec = {"compiled": isinstance(fn, graphs.CompiledTrainStep),
       "train_equal": [], "losses": [],
       "own_widths": [cut_labels(step.local_batch(b, mesh))["labels"].shape[1]
                      for b in batches]}
n_eager, n_graph = [0] * len(kernels()), [0] * len(kernels())
for i in [0, 2, 1, 3, 2, 0, 3, 1]:
    c0 = counts()
    ref, want = eager(ref, tensors[i])
    c1 = counts()
    state, got = fn(state, tensors[i])
    c2 = counts()
    n_eager = [n + b - a for n, a, b in zip(n_eager, c0, c1)]
    n_graph = [n + b - a for n, a, b in zip(n_graph, c1, c2)]
    rec["train_equal"].append(
        got.keys() == want.keys()
        and all(torch.equal(got[k], want[k]) for k in want)
        and all(torch.equal(a, b) for a, b in
                zip(tensors_of(state), tensors_of(ref))))
    rec["losses"].append(float(got["loss"]))
rec["train_launches"] = [n_graph, n_eager]
rec["names"] = [k.name for k in kernels()]
rec["widths"] = sorted(dict((k, s) for k, s, _ in key)["labels"][1]
                       for key in fn.graphs)
ev = step.make_eval_step(cfg, mesh, dev)
ev_eager = getattr(ev, "eager", ev)       # the eager mesh eval
rec["eval_compiled"] = isinstance(ev, graphs.CompiledEvalStep)
rec["eval_equal"] = []
n_eager, n_graph = [0] * len(kernels()), [0] * len(kernels())
for i in (0, 3, 0, 3):
    whole = step.batch_to_tensors(batches[i], dev)
    c0 = counts()
    want = ev_eager(state.model, whole)
    c1 = counts()
    got = ev(state.model, whole)
    c2 = counts()
    n_eager = [n + b - a for n, a, b in zip(n_eager, c0, c1)]
    n_graph = [n + b - a for n, a, b in zip(n_graph, c1, c2)]
    rec["eval_equal"].append(got.keys() == want.keys() and all(
        torch.equal(got[k], want[k]) for k in want))
rec["eval_launches"] = [n_graph, n_eager]
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(rec, f)
fn.release()        # the graphs hold NCCL's communicators
ev.release()
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""

MESH_OVERRIDES = {
    "dp2": {"mesh.data": 2},
    "sp2": {"mesh.data": 1, "mesh.seq": 2},
    "tp2": {"mesh.data": 1, "mesh.model": 2},
    "pp2": {"mesh.data": 1, "mesh.model": 2, "mesh.pipeline": True},
}


@pytest.mark.parametrize("mesh", list(MESH_OVERRIDES))
def test_two_card_compiled_mesh_step_is_the_eager_step(dev, tmp_path, mesh):
    """Two NCCL ranks on two cards (DP2, SP2, TP2 and PP2 of a narrow
    preset 2): ``make_train_step`` returns the compiled step, and over 8
    steps on two T buckets and two label widths, replayed out of order,
    with m and lr changing every step, its metrics, parameters and trace
    are bit-equal to the eager mesh step's after every step on both
    ranks, with equal launch counts; the loss is the same on both ranks.
    The labels are cut on the global batch: data line 1's block alone
    would cut the 40-character batches to 32 columns under DP2, yet every
    rank captures the global width, 64.  The compiled eval step (DP's
    gathered eval, TP's and PP's split eval, SP's whole-batch eval) is
    bit-equal to the eager one, with equal launch counts."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import json
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", MESH_GRAPH_WORKER,
                               coord, str(r), str(tmp_path),
                               json.dumps(MESH_OVERRIDES[mesh])], cwd=repo,
                              env=dict(os.environ, PYTHONPATH=repo))
             for r in range(2)]
    assert [p.wait(timeout=600) for p in procs] == [0, 0]
    recs = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    for rec in recs:
        assert rec["compiled"] and rec["eval_compiled"]
        assert all(rec["train_equal"]), rec["train_equal"]
        assert all(rec["eval_equal"]), rec["eval_equal"]
        graph_n, eager_n = rec["train_launches"]
        assert graph_n == eager_n and max(eager_n) > 0
        graph_n, eager_n = rec["eval_launches"]
        assert graph_n == eager_n and max(eager_n) > 0
        assert rec["widths"] == [32, 32, 64, 64], rec["widths"]
    assert recs[0]["losses"] == recs[1]["losses"]
    if mesh == "dp2":
        # the collectives are counted as the kernels are: one gradient sum
        # and three loss sums a step, eager and replayed alike
        for rec in recs:
            got = dict(zip(rec["names"], zip(*rec["train_launches"])))
            assert got["nccl_grad_sum"] == (8, 8)
            assert got["nccl_loss_sum"] == (24, 24)
        assert recs[1]["own_widths"] == [32, 32, 32, 32]
        assert recs[0]["own_widths"] == [32, 64, 32, 64]


CLI_FAIL_WORKER = """
import os, sys
from tpu_ctc_torch import cli
from tpu_ctc_torch.train import graphs

coord, rank, work = sys.argv[1], sys.argv[2], sys.argv[3]
host, port = coord.split(":")
os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, WORLD_SIZE="2",
                  RANK=rank, LOCAL_RANK=rank)
call, calls = graphs.CompiledTrainStep.__call__, []


def failing(self, state, batch):   # steps 1-2 captured and replayed
    calls.append(1)
    if len(calls) == 3:
        raise RuntimeError("the third step fails on every rank")
    return call(self, state, batch)


graphs.CompiledTrainStep.__call__ = failing
sys.exit(cli.main([
    "train", "--config", "2", "--synthetic", "48", "--work-dir", work,
    "--set", "model.hidden_dim=128", "--set", "model.num_bi_layers=1",
    "--set", "data.batch_size=8", "--set", "data.bucket_boundaries=(200,)",
    "--set", "mesh.data=2"]))
"""


def test_two_card_cli_train_exits_when_a_step_raises(dev, tmp_path):
    """``cli train`` on two NCCL ranks (DP2, the compiled step) whose third
    step raises on every rank exits with the error: the loop releases the
    graphs, which hold NCCL operations, before ``destroy_process_group``
    tears the communicators down (it would otherwise wait for ever)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    errs = [open(tmp_path / f"rank{r}.err", "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", CLI_FAIL_WORKER, coord,
                               str(r), str(tmp_path / "run")], cwd=repo,
                              stdout=subprocess.DEVNULL, stderr=errs[r],
                              env=dict(os.environ, PYTHONPATH=repo))
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for err in errs:
        err.seek(0)
        text = err.read()
        assert "the third step fails on every rank" in text, text[-2000:]
    assert rcs == [1, 1]


def test_device_time_of_b3_matches_its_event_time(dev):
    """``utils.devtime.device_time_ms`` of kernel B3, picked by its
    ``kernel=`` filter out of a call that launches B3 and B4, within 20%
    of B3's CUDA-event time over runs of back-to-back launches
    (``utils.devtime.event_ms``: a run keeps the card busy while the host
    prepares the next launch; an event pair around one call after a sync
    also times the wrapper's host work, ~0.05-0.1 ms).  Without the
    filter the call's device time also holds B4's, which takes about as
    long as B3's on this lattice."""
    from tpu_ctc_torch.utils.devtime import device_time_ms, event_ms
    emit, skip, skip2, init, final, lengths = _lattice(
        dev, 21, 32, 1600, 29, 120, tl=np.full(32, 1600),
        ll=np.full(32, 120))

    def b3():
        return ctc_cuda.alpha_cuda(emit, skip, init, lengths)

    def b3_b4():
        return b3(), ctc_cuda.beta_cuda(emit, skip2, final, lengths)

    ev_ms = event_ms(b3)
    dev_ms = device_time_ms(b3_b4, iters=10, kernel="ctc_alpha_kernel")
    assert abs(dev_ms - ev_ms) <= 0.2 * ev_ms, (dev_ms, ev_ms)
    assert device_time_ms(b3_b4, iters=10) >= 1.5 * dev_ms


def test_cpp_decoder_matches_b5(dev):
    """The native host decoder (double sums) against kernel B5 on the same
    posteriors and trigram, under the rule phase 13 of ``chip_smoke.py``
    holds them to (``torch_tools/cpp_b5.py``): B5 equal to the float32
    plain search, the C++ decoder to the float64 one, and the two equal
    where those do not part."""
    from torch_tools import cpp_b5
    lp, lens = _posteriors(31, 6, 120, 29)
    r = cpp_b5.compare(lp, lens, _lm(3, 29, 3), 32, 60, 1.25, 1.5, dev)
    assert cpp_b5.holds(r), cpp_b5.summary(r)


def test_smoke_cuda_decode_passes(dev):
    """``torch_tools/smoke_cuda_decode.py`` at the product shape (B = 32,
    T = 400, K = 64): every row agrees with the plain search."""
    from torch_tools import smoke_cuda_decode
    assert smoke_cuda_decode.main() == 0


# ---------------------------------------------------------------------------
# The compiled step (train.graphs): one CUDA graph per batch shape
# ---------------------------------------------------------------------------

def _graph_cfg(**extra):
    """Preset 2 cut to size, bf16, with a momentum ramp and a staircase
    decay that change m and lr at every step."""
    return get_config("2", **{
        "model.hidden_dim": 128, "model.num_bi_layers": 2,
        "data.batch_size": 8, "optim.momentum_start": 0.5,
        "optim.momentum_ramp_steps": 9, "optim.lr_decay": 0.8,
        "optim.lr_decay_steps": 1, **extra})


def _graph_batch(seed, t, longest, b=8):
    """A batch of ``b`` utterances padded to ``t`` frames and 128 label
    columns, labels of 1..``longest`` characters (the longest once)."""
    r = np.random.RandomState(seed)
    lens = r.randint(2 * longest + 1, t + 1, b).astype(np.int32)
    lens[0] = t
    ll = r.randint(1, longest + 1, b).astype(np.int32)
    ll[1] = longest
    labels = np.zeros((b, 128), np.int32)
    for i, n in enumerate(ll):
        labels[i, :n] = r.randint(1, 29, n)
    return {"feats": r.randn(b, t, 120).astype(np.float32),
            "frame_mask": (np.arange(t)[None] < lens[:, None]).astype(
                np.float32),
            "frame_lengths": lens, "labels": labels, "label_lengths": ll,
            "weights": np.ones(b, np.float32)}


def _state_tensors(state):
    return ([p.detach().clone() for p in state.model.parameters()]
            + [state.opt_state.trace[k].clone()
               for k in sorted(state.opt_state.trace)])


def _launches():
    from tpu_ctc_torch.ops import kernels
    return {k.name: k.launches for k in kernels()}


@pytest.mark.parametrize("remat", [False, True])
def test_graphed_train_step_is_the_eager_step(dev, remat):
    """``make_train_step`` on one card returns the compiled step; over 8
    steps on two bucket shapes and two label widths (32 and 64 columns),
    replayed out of order, with m and lr changing every step, its loss,
    metrics, parameters and trace are bit-equal to the eager
    ``train_step``'s after every step; a held metrics dict keeps its
    values after later replays; a capture leaves the state bit-identical
    and counts no launch; the launch counts of the replays equal the eager
    steps'.  ``model.remat`` is captured too."""
    from tpu_ctc_torch.parallel.mesh import make_mesh
    from tpu_ctc_torch.train import graphs
    cfg = _graph_cfg(**{"model.remat": remat})
    shapes = [(96, 20), (96, 40), (160, 20), (160, 40)]
    batches = [step.batch_to_tensors(_graph_batch(i, t, n), dev)
               for i, (t, n) in enumerate(shapes)]
    assert sorted({b["labels"].shape for b in batches}) == [
        (8, 32), (8, 64)]
    order = [0, 2, 1, 3, 2, 0, 3, 1]
    ref = step.create_train_state(cfg, device=dev)
    state = step.create_train_state(cfg, device=dev)
    fn, state = step.make_train_step(cfg, make_mesh(cfg.mesh), state)
    assert isinstance(fn, graphs.CompiledTrainStep)
    # a capture alone: the state bit-identical, no launch counted
    before, counts = _state_tensors(state), _launches()
    fn.capture(state, batches[3])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in
               zip(before, _state_tensors(state)))
    assert _launches() == counts and state.opt_state.count == 0
    held, eager_n, graph_n = [], {}, {}
    for i in order:
        c0 = _launches()
        ref, want = step.train_step(ref, batches[i], cfg)
        c1 = _launches()
        state, got = fn(state, batches[i])
        c2 = _launches()
        for k in c0:
            eager_n[k] = eager_n.get(k, 0) + c1[k] - c0[k]
            graph_n[k] = graph_n.get(k, 0) + c2[k] - c1[k]
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        for a, b in zip(_state_tensors(state), _state_tensors(ref)):
            assert torch.equal(a, b), i
        held.append((got, {k: v.clone() for k, v in want.items()}))
    assert state.step == ref.step == 8
    assert state.opt_state.count == ref.opt_state.count == 8
    for got, want in held:
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert graph_n == eager_n and birnn_cuda.direction_sweeps(
        eager_n)["birnn_fwd"] == (2 if remat else 1) * 4 * len(order)
    assert fn.stats()["shapes"] == 4


def test_graphed_train_step_refuses_replaced_tensors(dev):
    """A parameter replaced by a new tensor after the capture is refused
    (a replay would write to the old memory); a copy in place is taken,
    and the graph reads the new values as the eager step does."""
    from tpu_ctc_torch.parallel.mesh import make_mesh
    cfg = _graph_cfg()
    bt = step.batch_to_tensors(_graph_batch(3, 96, 20), dev)
    ref = step.create_train_state(cfg, device=dev)
    state = step.create_train_state(cfg, device=dev)
    fn, state = step.make_train_step(cfg, make_mesh(cfg.mesh), state)
    state, _ = fn(state, bt)
    ref, _ = step.train_step(ref, bt, cfg)
    with torch.no_grad():
        for s in (state, ref):
            s.model.out.w.mul_(0.5)                 # in place: taken
    state, got = fn(state, bt)
    ref, want = step.train_step(ref, bt, cfg)
    assert torch.equal(got["loss"], want["loss"])
    step._set_param(state.model, "out.w", state.model.out.w.detach().clone())
    with pytest.raises(RuntimeError, match="not the one its CUDA graphs"):
        fn(state, bt)
    # a step made again binds the new tensors; a trace replaced is refused
    fn, state = step.make_train_step(cfg, make_mesh(cfg.mesh), state)
    state, _ = fn(state, bt)
    trace = state.opt_state.trace
    trace["out.w"] = trace["out.w"].clone()
    with pytest.raises(RuntimeError, match="not the one its CUDA graphs"):
        fn(state, bt)


def test_replay_span_shares_the_cards_clock(dev):
    """Under a CUDA profiler, the compiled step's spans are recorded
    (``step.call`` around ``step.scalars``, ``step.copy_in``,
    ``step.replay``, ``step.clone``) and the first device kernel of the
    replay (the kernels correlated with its ``cudaGraphLaunch``) starts
    after its ``step.replay`` span starts and no later than 100 ms after
    the span ends: the port's spans and the card's events share one
    clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpu_ctc_torch.parallel.mesh import make_mesh
    from tpu_ctc_torch.utils import profiling
    cfg = _graph_cfg()
    bt = step.batch_to_tensors(_graph_batch(5, 96, 20), dev)
    state = step.create_train_state(cfg, device=dev)
    fn, state = step.make_train_step(cfg, make_mesh(cfg.mesh), state)
    state, _ = fn(state, bt)                        # captured, replayed
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = fn(state, bt)
        torch.cuda.synchronize()
    found = {}
    for s in profiling.spans():
        found.setdefault(s.name, []).append(s)
    profiling.reset()
    assert sorted(found) == ["step.call", "step.clone", "step.copy_in",
                             "step.replay", "step.scalars"]
    assert all(len(v) == 1 for v in found.values())
    assert {s.parent for n, (s,) in found.items() if n != "step.call"} == {
        "step.call"}
    (replay,) = found["step.replay"]
    events = list(prof.profiler.kineto_results.events())
    launches = {e.correlation_id() for e in events
                if e.name() == "cudaGraphLaunch"}
    assert len(launches) == 1, [e.name() for e in events
                                if e.device_type() != DeviceType.CUDA]
    kernels = sorted(
        e.start_ns() for e in events if e.device_type() == DeviceType.CUDA
        and not e.is_user_annotation()
        and (e.correlation_id() in launches
             or e.linked_correlation_id() in launches))
    assert kernels, "no device event correlated with the graph's launch"
    assert replay.start_ns <= kernels[0] <= replay.end_ns + 100_000_000, (
        replay, kernels[0])


def test_debug_nans_stays_eager_on_the_card(dev):
    """``train.debug_nans`` keeps the eager step on a card: a NaN gradient
    raises before the update, the state as it was."""
    from tpu_ctc_torch.parallel.mesh import make_mesh
    cfg = _graph_cfg(**{"train.debug_nans": True})
    state = step.create_train_state(cfg, device=dev)
    fn, state = step.make_train_step(cfg, make_mesh(cfg.mesh), state)
    assert getattr(fn, "func", None) is step.train_step
    bt = step.batch_to_tensors(_graph_batch(4, 96, 20), dev)
    bt["feats"][0, 0, 0] = float("nan")
    before = _state_tensors(state)
    with pytest.raises(FloatingPointError, match="debug_nans"):
        fn(state, bt)
    assert all(torch.equal(a, b) for a, b in
               zip(before, _state_tensors(state)))


def test_graphed_eval_step_is_eval_step(dev):
    """``make_eval_step`` on one card returns the compiled eval step:
    bit-equal to ``eval_step`` (hyp, hyp_len, nll) on two shapes replayed
    in turn, held outputs kept, the launches equal."""
    from tpu_ctc_torch.parallel.mesh import make_mesh
    from tpu_ctc_torch.train import graphs
    cfg = _graph_cfg()
    model = step.create_train_state(cfg, device=dev).model
    ev = step.make_eval_step(cfg, make_mesh(cfg.mesh), dev)
    assert isinstance(ev, graphs.CompiledEvalStep)
    batches = [step.batch_to_tensors(_graph_batch(i, t, n), dev)
               for i, (t, n) in enumerate([(96, 20), (160, 40)])]
    held = []
    for i in (0, 1, 0, 1):
        c0 = _launches()
        want = step.eval_step(model, cfg, batches[i])
        c1 = _launches()
        got = ev(model, batches[i])
        c2 = _launches()
        assert {k: c1[k] - c0[k] for k in c0} == {k: c2[k] - c1[k]
                                                   for k in c0}
        for k in want:
            assert torch.equal(got[k], want[k]), k
        held.append((got, want))
    for got, want in held:
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert ev.stats()["shapes"] == 2


# Driver API numbers (cuda.h): a kernel node's type, and the launch
# attribute that marks a cooperative launch.
_CU_GRAPH_NODE_TYPE_KERNEL = 0
_CU_LAUNCH_ATTRIBUTE_COOPERATIVE = 2


def _kernel_nodes(graph):
    """For each kernel node of a graph made with ``keep_graph=True`` (after
    its capture): whether it launches cooperatively, as the driver reads
    the node (``cuGraphKernelNodeGetAttribute``).  B1 and B2 wait at a
    grid barrier, which only a cooperative launch guarantees."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUDA driver error {err}")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != _CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        value = (ctypes.c_ubyte * 64)()        # CUlaunchAttributeValue
        check(cu.cuGraphKernelNodeGetAttribute(
            ctypes.c_void_p(node), _CU_LAUNCH_ATTRIBUTE_COOPERATIVE, value),
            "cuGraphKernelNodeGetAttribute")
        out.append(int.from_bytes(bytes(value[:4]), "little") != 0)
    return out


@pytest.mark.parametrize("kind", ["fwd", "fwd_h0", "bwd"])
def test_sweeps_are_captured_as_cooperative_nodes(dev, kind):
    """B1/B2's cooperative launch under stream capture: the graph holds
    one kernel node, cooperative as the driver reads it, and two replays
    give the eager launch's output bit for bit (each starts from a zeroed
    barrier counter: the zeroing is a node of the graph, in stream
    order)."""
    z, w, lens = _recurrence_inputs(5, 64, 8, 256)
    z, w, lens = (z.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16),
                  lens.to(dev))
    h0 = (torch.randn(8, 256, device=dev).clamp(0, 20).to(torch.bfloat16)
          if kind == "fwd_h0" else None)
    if kind == "bwd":
        hs = _b1(z, w, lens, reverse=False, clip=20.0)

        def launch():
            return _b2(z, hs, w.t().contiguous(), reverse=True, clip=20.0)
    else:
        def launch():
            return _b1(z, w, lens, reverse=False, clip=20.0, h0=h0)
    want = launch()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        out = launch()
    nodes = _kernel_nodes(g)
    g.instantiate()
    assert nodes.count(True) == 1, nodes
    for _ in range(2):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_fused_sweeps_replay_in_a_graph(dev):
    """B1 and B2 of both directions, each one cooperative launch, under
    stream capture: two cooperative kernel nodes, and replays on new
    inputs give the eager launches' outputs bit for bit (each direction's
    exchange buffer and counter are zeroed by nodes of the graph)."""
    t, b, h = 50, 32, 1024
    z, wf, wb, lens = _bi_inputs(dev, t, b, h)
    g = torch.zeros_like(z)
    wft, wbt = wf.t().contiguous(), wb.t().contiguous()

    def launch():
        hs = birnn_cuda.fwd_recurrence(z, (wf, wb), lens, reverse=False,
                                       clip=20.0)
        return (*hs, *birnn_cuda.bwd_recurrence(g, hs, (wft, wbt),
                                                reverse=True, clip=20.0))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = launch()
    nodes = _kernel_nodes(graph)
    graph.instantiate()
    assert nodes.count(True) == 2, nodes
    for seed in (1, 2):
        r = np.random.RandomState(seed)
        z.copy_(torch.from_numpy(3.0 * r.randn(t, b, h).astype(np.float32)))
        g.copy_(torch.from_numpy(r.randn(t, b, h).astype(np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(out, launch()):
            assert torch.equal(got, want)


def test_label_width_on_the_card(dev):
    """The host's label cut on the card: the CTC loss at the rounded width
    (32 columns) bit-equal to the cut at the longest label, the gradient
    within ``TestLabelWidth.GAP`` of ``tests/test_torch_ctc.py`` (the
    one-hot product sums over S)."""
    b = _graph_batch(8, 160, 27)
    x = torch.from_numpy(np.random.RandomState(9).randn(8, 160, 29).astype(
        np.float32)).to(dev)
    out = []
    for width in (27, 32):
        xr = x.clone().requires_grad_(True)
        nll = ctc.ctc_loss(xr, torch.as_tensor(b["labels"][:, :width],
                                               device=dev),
                           torch.as_tensor(b["frame_lengths"], device=dev),
                           torch.as_tensor(b["label_lengths"], device=dev))
        nll.sum().backward()
        out.append((nll.detach(), xr.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert float((out[0][1] - out[1][1]).abs().max()) <= 1e-6


def test_train_loop_runs_the_compiled_step(dev, tmp_path):
    """``train.loop.train`` on one card: the compiled step and eval step,
    captured while the prefetch thread pins and copies the next batches;
    the parameters bit-equal to the eager ``train_step`` over the same
    batches from the same seed, and the launches of the run those of its
    steps and evals."""
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.synthetic import SyntheticCorpus
    from tpu_ctc_torch.train import loop
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    cfg = _graph_cfg(**{"data.bucket_boundaries": (200, 400),
                        "train.num_epochs": 2, "train.eval_every": 3,
                        "train.log_every": 1, "train.checkpoint_every": 0})
    data = SyntheticCorpus(24, feature_dim=120, min_chars=5, max_chars=45,
                           seed=2).all_utterances()
    c0 = _launches()
    state, last = loop.train(cfg, data, eval_data=data[:8],
                             work_dir=str(tmp_path), device=dev)
    c1 = _launches()
    ref = step.create_train_state(cfg, device=dev)
    loader = BucketedLoader(data, cfg.data)
    n = 0
    for e in range(cfg.train.num_epochs):
        for _, b in loader.epoch(e):
            ref, _ = step.train_step(ref, step.batch_to_tensors(
                batch_to_device_dict(b), dev), cfg)
            n += 1
    assert state.step == ref.step == n and np.isfinite(last["loss"])
    for a, b in zip(_state_tensors(state), _state_tensors(ref)):
        assert torch.equal(a, b)
    evals = n // cfg.train.eval_every
    fwd = 2 * cfg.model.num_bi_layers
    sweeps = [birnn_cuda.direction_sweeps(c)["birnn_fwd"] for c in (c0, c1)]
    assert sweeps[1] - sweeps[0] == fwd * (n + evals * len(
        list(BucketedLoader(data[:8], cfg.data).epoch(0))))
    assert c1["ctc_beta"] - c0["ctc_beta"] == n
