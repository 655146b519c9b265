"""The port's BiRNN recurrence and acoustic model against the JAX package,
forward and backward.

Weights and inputs come from numpy seeds (the JAX PRNG has no torch
counterpart) and reach the port through the npz weight bridge.  At f32 the
port's plain recurrence must match both JAX paths, the XLA scan and the
Pallas kernel in interpret mode, to summation-order tolerance (1e-5).  At
bf16 it is held against the Pallas kernel only: the scan keeps z in f32,
the kernel (and the port) round z and each h_t to bf16 (tolerance 2e-2,
a few bf16 ulps of the O(1) states).  Kernel B1 itself runs only on a
CUDA card (``chip_smoke.py`` holds it against this plain version).

Gradients: the recurrence's custom backward (``BiRecurrence``, the plain
delta sweep that kernel B2 replaces on a card) against ``jax.vjp`` of the
Pallas ``bi_recurrence`` in interpret mode: dz, dwf and dwb at f32 within
1e-5 of the largest magnitude (dW sums T B products of values up to 20 in
another order), and at bf16 within 2e-2 of
the largest magnitude: both sides round g and every stored delta to bf16 at
the same points, so they differ only where an f32 sum taken in another
order rounds a stored bf16 value the other way.  The dense layers' gradient
rounds where JAX rounds: dx and dw of ``dot_f32`` are rounded to the
compute dtype (checked against ``jax.vjp`` exactly, up to f32 order).
"""
import dataclasses
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ctc.config import ModelConfig as JaxModelConfig
from tpu_ctc.models import birnn as jax_birnn
from tpu_ctc.ops import birnn_pallas
from tpu_ctc.train import checkpoint as jax_ckpt
from tpu_ctc_torch.config import ModelConfig, get_config
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.ops import birnn_cuda
from tpu_ctc_torch.train import checkpoint

torch.set_num_threads(2)


def _cfgs(hidden=16, input_dim=12, num_bi=2, dtype="float32", **kw):
    fields = dict(input_dim=input_dim, hidden_dim=hidden, num_pre_layers=2,
                  num_bi_layers=num_bi, vocab_size=7, compute_dtype=dtype,
                  init_scale=0.3, **kw)
    return JaxModelConfig(**fields), ModelConfig(**fields)


def _inputs(seed, b, t, d):
    r = np.random.RandomState(seed)
    feats = r.randn(b, t, d).astype(np.float32)
    lens = r.randint(1, t + 1, b)
    lens[0] = t
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    return feats, mask, lens.astype(np.int32)


def _both_models(jcfg, tcfg, tmp_path, seed=0):
    params = jax_birnn.init_params(jax.random.PRNGKey(seed), jcfg)
    path = str(tmp_path / "w.npz")
    jax_ckpt.export_npz(path, params)
    model = checkpoint.load_npz(birnn.BiRNN(tcfg, device="cpu"), path)
    return params, model


def _recurrence_inputs(seed, t, b, h, w_scale):
    r = np.random.RandomState(seed)
    z = r.randn(t, b, h).astype(np.float32)
    wf = (w_scale * r.randn(h, h)).astype(np.float32)
    wb = (w_scale * r.randn(h, h)).astype(np.float32)
    lens = r.randint(1, t + 1, b).astype(np.int32)
    lens[0] = t
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    return z, wf, wb, lens, mask


class TestRecurrence:
    @pytest.mark.parametrize("t,b,h", [(9, 2, 16), (24, 3, 40), (17, 5, 8)])
    def test_f32_matches_scan_and_pallas(self, t, b, h):
        z, wf, wb, lens, mask = _recurrence_inputs(t * 7 + h, t, b, h, 0.3)
        jcfg, tcfg = _cfgs(hidden=h)
        want_scan = jax_birnn.bi_recur_tm(
            jnp.asarray(z), jnp.asarray(wf), jnp.asarray(wb),
            jnp.asarray(mask), dataclasses.replace(jcfg, birnn_impl="scan"))
        want_pallas = birnn_pallas.bi_recurrence(
            jnp.asarray(z), jnp.asarray(wf), jnp.asarray(wb),
            jnp.asarray(mask), clip=20.0, compute_dtype="float32",
            time_major=True)
        got = birnn.bi_recur_tm(torch.from_numpy(z), torch.from_numpy(wf),
                                torch.from_numpy(wb), torch.from_numpy(mask),
                                tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_scan),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("t,b,h", [(12, 3, 32), (20, 2, 24)])
    def test_bf16_matches_pallas(self, t, b, h):
        z, wf, wb, lens, mask = _recurrence_inputs(t + h, t, b, h,
                                                   0.5 / np.sqrt(h))
        z = 3.0 * z
        want = birnn_pallas.bi_recurrence(
            jnp.asarray(z), jnp.asarray(wf), jnp.asarray(wb),
            jnp.asarray(mask), clip=20.0, compute_dtype="bfloat16",
            time_major=True)
        got = birnn_cuda.bi_recurrence(
            torch.from_numpy(z), torch.from_numpy(wf), torch.from_numpy(wb),
            torch.from_numpy(lens), clip=20.0, compute_dtype=torch.bfloat16)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)

    def test_padded_frames_hold_zero(self):
        z, wf, wb, lens, _ = _recurrence_inputs(3, 10, 4, 8, 0.3)
        hs = birnn_cuda.fwd_recurrence_plain(
            torch.from_numpy(z), torch.from_numpy(wf),
            torch.from_numpy(lens), reverse=True, clip=20.0)
        for i, n in enumerate(lens):
            assert torch.all(hs[n:, i] == 0)
            assert torch.all((hs[:n, i] >= 0) & (hs[:n, i] <= 20))

    def test_unidirectional(self):
        z, wf, wb, lens, mask = _recurrence_inputs(5, 11, 2, 8, 0.3)
        jcfg, tcfg = _cfgs(hidden=8, bidirectional=False)
        want = jax_birnn.bi_recur_tm(
            jnp.asarray(z), jnp.asarray(wf), jnp.asarray(wb),
            jnp.asarray(mask), dataclasses.replace(jcfg, birnn_impl="scan"))
        got = birnn.bi_recur_tm(torch.from_numpy(z), torch.from_numpy(wf),
                                torch.from_numpy(wb), torch.from_numpy(mask),
                                tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _flat(tree):
    """JAX param tree -> {'pre.0.w': array, ...} (the port's names)."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_vjp(z, wf, wb, mask, g, dtype, bidirectional=True):
    def f(z, wf, wb):
        return birnn_pallas.bi_recurrence(
            z, wf, wb, jnp.asarray(mask), clip=20.0, compute_dtype=dtype,
            time_major=True, bidirectional=bidirectional)
    out, vjp = jax.vjp(f, jnp.asarray(z), jnp.asarray(wf), jnp.asarray(wb))
    return [np.asarray(v) for v in (out, *vjp(jnp.asarray(g)))]


def _port_vjp(z, wf, wb, lens, g, dtype, bidirectional=True):
    z, wf, wb = (torch.from_numpy(v).requires_grad_(True)
                 for v in (z, wf, wb))
    out = birnn_cuda.bi_recurrence(z, wf, wb, torch.from_numpy(lens),
                                   clip=20.0, compute_dtype=dtype,
                                   bidirectional=bidirectional)
    out.backward(torch.from_numpy(g))
    return [v.detach().numpy() for v in (out, z.grad, wf.grad, wb.grad)]


class TestRecurrenceGrad:
    @pytest.mark.parametrize("t,b,h", [(9, 2, 16), (24, 3, 40), (17, 5, 8)])
    def test_f32_vjp_matches_pallas(self, t, b, h):
        z, wf, wb, lens, mask = _recurrence_inputs(t * 3 + h, t, b, h, 0.3)
        g = np.random.RandomState(t).randn(t, b, h).astype(np.float32)
        want = _jax_vjp(z, wf, wb, mask, g, "float32")
        got = _port_vjp(z, wf, wb, lens, g, torch.float32)
        for name, a, w in zip(("out", "dz", "dwf", "dwb"), got, want):
            np.testing.assert_allclose(a, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)

    @pytest.mark.parametrize("t,b,h", [(12, 3, 32), (20, 2, 24)])
    def test_bf16_vjp_matches_pallas(self, t, b, h):
        z, wf, wb, lens, mask = _recurrence_inputs(t + 2 * h, t, b, h,
                                                   0.5 / np.sqrt(h))
        z = 3.0 * z
        g = np.random.RandomState(h).randn(t, b, h).astype(np.float32)
        want = _jax_vjp(z, wf, wb, mask, g, "bfloat16")
        got = _port_vjp(z, wf, wb, lens, g, torch.bfloat16)
        for name, a, w in zip(("out", "dz", "dwf", "dwb"), got, want):
            np.testing.assert_allclose(a, w, rtol=0,
                                       atol=2e-2 * np.abs(w).max(),
                                       err_msg=name)

    def test_unidirectional_vjp(self):
        z, wf, wb, lens, mask = _recurrence_inputs(8, 10, 3, 12, 0.3)
        g = np.random.RandomState(1).randn(10, 3, 12).astype(np.float32)
        want = _jax_vjp(z, wf, wb, mask, g, "float32", bidirectional=False)
        got = _port_vjp(z, wf, wb, lens, g, torch.float32,
                        bidirectional=False)
        for name, a, w in zip(("out", "dz", "dwf", "dwb"), got, want):
            np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        assert not got[3].any()

    @pytest.mark.parametrize("reverse", [False, True])
    def test_delta_sweep_is_the_pallas_kernel(self, reverse):
        """bwd_recurrence_plain computes what _bwd_kernel computes."""
        t, b, h = 16, 16, 128                  # the kernel's own tiling
        z, wf, _, lens, _ = _recurrence_inputs(4 + reverse, t, b, h,
                                               0.5 / np.sqrt(h))
        hs = birnn_cuda.fwd_recurrence_plain(
            torch.from_numpy(3 * z), torch.from_numpy(wf),
            torch.from_numpy(lens), reverse=not reverse, clip=20.0)
        g = np.random.RandomState(3).randn(t, b, h).astype(np.float32)
        want = birnn_pallas._run_bwd(
            jnp.asarray(g), jnp.asarray(hs.numpy()), jnp.asarray(wf.T),
            reverse=reverse, clip=20.0, bb=16, tc=8, t_true=t)
        got = birnn_cuda.bwd_recurrence_plain(
            torch.from_numpy(g), hs, torch.from_numpy(wf).t(),
            reverse=reverse, clip=20.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dot_f32_vjp_rounds_where_jax_does(self, dtype):
        r = np.random.RandomState(6)
        x = r.randn(2, 5, 33).astype(np.float32)
        w = r.randn(33, 7).astype(np.float32)
        g = r.randn(2, 5, 7).astype(np.float32)
        cdt = getattr(jnp, dtype)
        _, vjp = jax.vjp(lambda x, w: jnp.dot(
            x.astype(cdt), w.astype(cdt), preferred_element_type=jnp.float32),
            jnp.asarray(x), jnp.asarray(w))
        dx, dw = vjp(jnp.asarray(g))
        tx, tw = (torch.from_numpy(v).requires_grad_(True) for v in (x, w))
        birnn_cuda.dot_f32(tx, tw, getattr(torch, dtype)).backward(
            torch.from_numpy(g))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_dot_f32_on_the_cpu_is_the_f32_product(self, dtype):
        """On the CPU ``dot_f32`` and its gradient are the f32 products of
        the rounded values, bit for bit: the bf16 GEMM runs on a card
        only."""
        r = np.random.RandomState(9)
        x = torch.from_numpy(r.randn(3, 4, 33).astype(np.float32))
        w = torch.from_numpy(r.randn(33, 7).astype(np.float32))
        g = torch.from_numpy(r.randn(3, 4, 7).astype(np.float32))
        tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = birnn_cuda.dot_f32(tx, tw, dtype)
        out.backward(g)
        xc, wc = x.to(dtype).float(), w.to(dtype).float()
        assert torch.equal(out, xc @ wc)
        assert torch.equal(tx.grad, (g @ wc.t()).to(dtype).float())
        assert torch.equal(tw.grad, (xc.reshape(-1, 33).t()
                                     @ g.reshape(-1, 7)).to(dtype).float())

    def test_model_grad_matches_jax(self, tmp_path):
        jcfg, tcfg = _cfgs(hidden=16)
        params, model = _both_models(jcfg, tcfg, tmp_path)
        feats, mask, _ = _inputs(3, 3, 11, jcfg.input_dim)
        cot = np.random.RandomState(5).randn(3, 11, 7).astype(np.float32)
        want = jax.grad(lambda p: jnp.sum(jax_birnn.forward(
            p, dataclasses.replace(jcfg, birnn_impl="pallas"),
            jnp.asarray(feats), jnp.asarray(mask)) * cot))(params)
        out = birnn.forward(model, tcfg, torch.from_numpy(feats),
                            torch.from_numpy(mask))
        (out * torch.from_numpy(cot)).sum().backward()
        flat = _flat(want)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), flat[name], rtol=1e-5,
                                       atol=1e-4, err_msg=name)

    def test_model_grad_matches_jax_bf16(self, tmp_path):
        """bf16 compute: the same rounding points on both sides (each dense
        layer's dx and dw rounded to bf16, g and the deltas stored in bf16),
        so the gradients differ only where a sum taken in another order
        rounds a bf16 value the other way: within 1e-2 of each parameter's
        gradient norm (2.5 bf16 ulps; see test_torch_train.py's
        test_bf16_gradient_tolerance_of_the_chip_check)."""
        jcfg, tcfg = _cfgs(hidden=32, dtype="bfloat16")
        params, model = _both_models(jcfg, tcfg, tmp_path, seed=1)
        feats, mask, _ = _inputs(4, 3, 13, jcfg.input_dim)
        cot = np.random.RandomState(6).randn(3, 13, 7).astype(np.float32)
        want = jax.grad(lambda p: jnp.sum(jax_birnn.forward(
            p, dataclasses.replace(jcfg, birnn_impl="pallas"),
            jnp.asarray(feats), jnp.asarray(mask)) * cot))(params)
        out = birnn.forward(model, tcfg, torch.from_numpy(feats),
                            torch.from_numpy(mask))
        (out * torch.from_numpy(cot)).sum().backward()
        flat = _flat(want)
        for name, p in model.named_parameters():
            err = np.linalg.norm(p.grad.numpy() - flat[name])
            assert err <= 1e-2 * np.linalg.norm(flat[name]), name


class TestModel:
    @pytest.mark.parametrize("impl", ["scan", "pallas"])
    def test_log_posteriors_f32(self, tmp_path, impl):
        jcfg, tcfg = _cfgs(hidden=24)
        params, model = _both_models(jcfg, tcfg, tmp_path)
        feats, mask, _ = _inputs(1, 3, 14, jcfg.input_dim)
        want = jax_birnn.log_posteriors(
            params, dataclasses.replace(jcfg, birnn_impl=impl),
            jnp.asarray(feats), jnp.asarray(mask))
        with torch.no_grad():
            got = birnn.log_posteriors(model, tcfg, torch.from_numpy(feats),
                                       torch.from_numpy(mask))
        assert got.shape == (3, 14, 7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    def test_scan_impl_equals_auto_on_cpu(self, tmp_path):
        _, tcfg = _cfgs(hidden=16)
        model = birnn.init_params(tcfg, seed=3, device="cpu")
        feats, mask, _ = _inputs(2, 2, 9, tcfg.input_dim)
        a = birnn.forward(model, tcfg, torch.from_numpy(feats),
                          torch.from_numpy(mask))
        b = birnn.forward(model, dataclasses.replace(tcfg, birnn_impl="scan"),
                          torch.from_numpy(feats), torch.from_numpy(mask))
        assert torch.equal(a, b)

    def test_dense_is_f32_unrounded(self):
        r = np.random.RandomState(4)
        x = torch.from_numpy(r.randn(5, 33).astype(np.float32))
        w = torch.from_numpy(r.randn(33, 7).astype(np.float32))
        got = birnn_cuda.dot_f32(x, w, torch.bfloat16)
        want = jnp.dot(jnp.asarray(x.numpy()).astype(jnp.bfloat16),
                       jnp.asarray(w.numpy()).astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5)
        # a bf16 matmul would round the output: the f32 form must differ
        assert not torch.equal(got, (x.bfloat16() @ w.bfloat16()).float())

    def test_init_params_seeded(self):
        _, tcfg = _cfgs(hidden=16)
        a = birnn.init_params(tcfg, seed=5, device="cpu")
        b = birnn.init_params(tcfg, seed=5, device="cpu")
        for (na, pa), (_, pb) in zip(a.named_parameters(),
                                     b.named_parameters()):
            assert torch.equal(pa, pb)
            if na.endswith(".b"):
                assert torch.all(pa == 0)
            else:
                assert 0.1 < float(pa.std()) < 0.5      # init_scale 0.3


def _preset_shape(name):
    """(batch, width, recurrence dtype) of a preset."""
    cfg = get_config(name)
    return (cfg.data.batch_size, cfg.model.hidden_dim,
            getattr(torch, cfg.model.compute_dtype))


_BF16, _F32 = torch.bfloat16, torch.float32
_COUNTERS = birnn_cuda.COUNTERS
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tpu_ctc_torch", "csrc", "birnn.cu")


def _launches():
    return {name: k.launches for name, k in _COUNTERS.items()}


class TestKernelGuards:
    def test_cpu_tensors_use_the_plain_loop(self):
        z, wf, _, lens, _ = _recurrence_inputs(6, 5, 2, 8, 0.3)
        before = _launches()
        a, = birnn_cuda.fwd_recurrence(torch.from_numpy(z),
                                       (torch.from_numpy(wf),),
                                       torch.from_numpy(lens), reverse=False,
                                       clip=20.0)
        b = birnn_cuda.fwd_recurrence_plain(
            torch.from_numpy(z), torch.from_numpy(wf),
            torch.from_numpy(lens), reverse=False, clip=20.0)
        assert torch.equal(a, b)
        assert _launches() == before

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        """A kernel's plan refuses CPU tensors: it never falls back to the
        plain loop."""
        z, wf, _, lens, _ = _recurrence_inputs(6, 5, 2, 8, 0.3)
        with pytest.raises(ValueError, match="CUDA device"):
            birnn_cuda.fwd_recurrence(
                torch.from_numpy(z), (torch.from_numpy(wf),),
                torch.from_numpy(lens), reverse=False, clip=20.0,
                plan=birnn_cuda.plan(2, 8, _F32))
        with pytest.raises(ValueError, match="launches no kernel"):
            birnn_cuda.launch(birnn_cuda.PLAIN, False, torch.from_numpy(z),
                              (torch.from_numpy(wf),),
                              (torch.from_numpy(lens),), reverse=False,
                              clip=20.0)
        # a plan of both directions a launch needs both directions' W
        with pytest.raises(ValueError, match="2 directions a launch for 1"):
            birnn_cuda.launch(birnn_cuda.plan(2, 8, _BF16, directions=2),
                              False, torch.from_numpy(z),
                              (torch.from_numpy(wf),),
                              (torch.from_numpy(lens),), reverse=False,
                              clip=20.0)

    def test_cpu_tensors_use_the_plain_delta_loop(self):
        z, wf, _, lens, _ = _recurrence_inputs(7, 6, 2, 8, 0.3)
        z, wf = torch.from_numpy(z), torch.from_numpy(wf)
        hs = birnn_cuda.fwd_recurrence_plain(z, wf, torch.from_numpy(lens),
                                             reverse=False, clip=20.0)
        before = _launches()
        a, = birnn_cuda.bwd_recurrence(z, (hs,), (wf.t(),), reverse=True,
                                       clip=20.0)
        b = birnn_cuda.bwd_recurrence_plain(z, hs, wf.t(), reverse=True,
                                            clip=20.0)
        assert torch.equal(a, b)
        assert _launches() == before
        with pytest.raises(ValueError):
            birnn_cuda.bwd_recurrence(z, (hs,), (wf.t(),), reverse=True,
                                      clip=20.0,
                                      plan=birnn_cuda.plan(2, 8, _F32))

    @pytest.mark.parametrize("b,h,dtype,refusal", [
        (64, 1824, torch.bfloat16, None), (128, 2048, torch.bfloat16, None),
        (129, 64, torch.bfloat16, "batch 129"),
        (129, 4096, torch.bfloat16, "batch 129"),
        (8, 64, torch.float16, "io dtype"),
        (64, 1824, torch.float32, None),
        (64, 16384, torch.bfloat16, "above the widths the JAX package"),
        # the last narrow width on 132 SMs, the first wide one, and the
        # JAX kernel's ceilings (birnn_pallas.supported pads H to 128
        # lanes: 6017 to 6144 and 4097 to 4224, over its VMEM budget)
        (128, 2112, torch.bfloat16, None), (128, 2112, torch.float32, None),
        (1, 2113, torch.bfloat16, None), (128, 6016, torch.bfloat16, None),
        (128, 4096, torch.float32, None),
        (1, 6017, torch.bfloat16, r"H=6017 at torch.bfloat16 is above"),
        (1, 4097, torch.float32, r"H=4097 at torch.float32 is above"),
        # each preset's width at its batch size and dtype (config.py)
        *[pytest.param(*_preset_shape(name), refusal, id=name)
          for name, refusal in (
              ("timit_subset_1layer", None), ("timit_full_3layer", None),
              ("swbd_5layer_dp", None), ("swbd_beam_decode", None),
              ("swbd_wide_tp", None))]])
    def test_supported_shapes(self, b, h, dtype, refusal):
        if refusal is None:
            birnn_cuda.check_supported(b, h, dtype)
        else:
            with pytest.raises(NotImplementedError, match=refusal) as err:
                birnn_cuda.check_supported(b, h, dtype)
            assert "tensor parallelism" not in str(err.value)

    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    def test_limits_are_the_jax_kernel_s(self, dtype):
        """``check_supported`` takes exactly the widths that
        ``birnn_pallas.supported`` admits for the dtype (B <= 128), and the
        plan is the narrow instance up to 16 columns a block on 132 SMs."""
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        for h in [1, 100, 2112, 2113, 3000, 4096, 4097, 5000, 6016, 6017,
                  6144, 8192]:
            want = birnn_pallas.supported(h, jdt)
            assert birnn_cuda.jax_admits(h, tdt) == want, h
            if want:
                birnn_cuda.check_supported(128, h, tdt)
                assert birnn_cuda.plan(128, h, tdt).code == (
                    "narrow" if h <= 2112 else "wide")
            else:
                with pytest.raises(NotImplementedError):
                    birnn_cuda.check_supported(128, h, tdt)

    @pytest.mark.parametrize("b,h,shape,grid", [
        (64, 1824, (2, 64, 1824), 114), (32, 1024, (2, 32, 1024), 64),
        (1, 100, (2, 16, 112), 7), (17, 200, (2, 32, 208), 13),
        (128, 2048, (2, 128, 2048), 128),
        (16, 4096, (2, 16, 4096), (128, 2)),
        (128, 6016, (2, 128, 6016), (126, 3)),
        (5, 2113, (2, 16, 2128), (67, 2))])
    def test_exchange_layout(self, b, h, shape, grid):
        """The zeroed exchange buffer pads B and H to multiples of 16, so
        its rows are 16-byte aligned for the bf16 kernel's copies; a narrow
        plan has one block per 16 columns, and its bf16 block's shared
        memory is its copy rings (8 warps x 4 stages x 4 KB) and W's 16
        padded columns; a wide plan deals the 16-column tiles over at most
        one block a SM (132), ``grid`` = (blocks, tiles a block)."""
        assert birnn_cuda.exchange_shape(b, h) == shape
        assert shape[2] * 2 % 16 == 0
        p = birnn_cuda.plan(b, h, _BF16)
        if isinstance(grid, tuple):
            assert p.code == "wide"
            assert (p.grid, p.cols // 16) == grid
            assert p.counters == ("birnn_fwd_wide", "birnn_bwd_wide")
            return
        assert (p.code, p.directions, p.cols, p.grid) == ("narrow", 1, 16,
                                                          grid)
        assert p.smem == 8 * 4 * 4096 + 16 * (shape[2] + 8) * 2
        assert p.counters == ("birnn_fwd", "birnn_bwd")

    def test_step_breakdown_anchors_match_the_kernel(self):
        """torch_tools/birnn_step_breakdown.py stamps a copy of birnn.cu at
        anchors in its text: each must occur exactly once."""
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "torch_tools",
            "birnn_step_breakdown.py")
        spec = importlib.util.spec_from_file_location("breakdown", path)
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        with open(_COUNTERS["birnn_fwd"].source) as f:
            src = f.read()
        for stamps in (tool.STAMPS, tool.WIDE_STAMPS):
            assert [src.count(anchor) for anchor, _ in stamps] == [1] * len(
                stamps)

    def test_refusal_counts_the_card_s_sms(self):
        """The plan follows the card's SMs: H = 1824 is narrow on 114 and
        wide on 113 (2 tiles a block); a card too small for 4 tiles a block
        refuses, naming its SMs."""
        birnn_cuda.check_supported(64, 1824, _BF16, n_sm=114)
        assert birnn_cuda.plan(64, 1824, _BF16, n_sm=114).code == "narrow"
        birnn_cuda.check_supported(64, 1824, _BF16, n_sm=113)
        p = birnn_cuda.plan(64, 1824, _BF16, n_sm=113)
        assert (p.code, p.grid, p.cols) == ("wide", 57, 32)
        with pytest.raises(NotImplementedError, match="over the 60 SMs"):
            birnn_cuda.check_supported(64, 4096, _BF16, n_sm=60)
        with pytest.raises(NotImplementedError, match="over the 60 SMs"):
            birnn_cuda.plan(64, 4096, _BF16, directions=2, n_sm=60)

    @pytest.mark.parametrize("b,h,dtype,directions,n_sm,want", [
        (32, 1024, _BF16, 2, 132, ("narrow", 2, 32, 64)),
        (32, 1056, _BF16, 2, 132, ("narrow", 2, 32, 66)),
        (32, 100, _BF16, 2, 132, ("narrow", 2, 32, 8)),
        (32, 1057, _BF16, 2, 132, ("narrow", 2, 32, 68)),
        (64, 1824, _BF16, 2, 132, ("narrow", 2, 32, 114)),
        (16, 1824, _BF16, 2, 132, ("narrow", 2, 32, 114)),
        (80, 1824, _BF16, 2, 132, ("narrow", 1, 16, 114)),
        (64, 1824, _BF16, 2, 100, ("wide", 1, 32, 57)),
        (64, 1104, _BF16, 2, 132, ("narrow", 2, 32, 70)),
        (64, 2080, _BF16, 2, 132, ("narrow", 2, 32, 130)),
        (64, 2081, _BF16, 2, 132, ("narrow", 1, 16, 131)),
        (32, 1024, _F32, 2, 132, ("narrow", 1, 16, 64)),
        (64, 1824, _F32, 2, 132, ("narrow", 1, 16, 114)),
        (32, 2560, _BF16, 2, 132, ("wide", 1, 32, 80)),
        (16, 4096, _BF16, 2, 132, ("wide", 1, 32, 128)),
        (32, 1024, _BF16, 1, 132, ("narrow", 1, 16, 64)),
        (64, 1824, _BF16, 1, 132, ("narrow", 1, 16, 114)),
        (32, 1024, _BF16, 2, 100, ("narrow", 2, 32, 64)),
        (32, 784, _BF16, 2, 100, ("narrow", 2, 32, 50)),
        # 65-128 rows at H <= 1056: one direction a launch
        (128, 1024, _BF16, 2, 132, ("narrow", 1, 16, 64)),
        (65, 100, _BF16, 2, 132, ("narrow", 1, 16, 7))])
    def test_both_directions_in_one_launch(self, b, h, dtype, directions,
                                           n_sm, want):
        """``plan``: one launch sweeps both directions of a bidirectional
        bf16 layer, 2 ceil(H / 32) blocks of 32 columns where B <= 64 and
        they fit one a SM with a block's shared memory (H <= 2080 on 132
        SMs; 1104: a last block of 16 live columns); else one direction a
        launch (B > 64, f32, the wide instance at 2560 and 4096, one
        direction asked, too few SMs), each with its counters."""
        p = birnn_cuda.plan(b, h, dtype, directions=directions, n_sm=n_sm)
        assert (p.code, p.directions, p.cols, p.grid) == want
        assert p.counters == tuple(birnn_cuda.INSTANCES[
            p.code, p.directions][1:])
        if p.directions == 2:
            assert p.grid == 2 * -(-h // 32) <= n_sm and b <= 64
            assert p.smem == 8 * 3 * 4096 + 32 * (-(-h // 16) * 16 + 8) * 2
            assert p.smem <= 232448

    @pytest.mark.parametrize("name,directions", [
        ("timit_subset_1layer", 1), ("timit_full_3layer", 2),
        ("swbd_5layer_dp", 2), ("swbd_beam_decode", 2),
        ("swbd_wide_tp", 1)])
    def test_which_presets_sweep_both_directions_at_once(self, name,
                                                         directions):
        """At the preset's batch on an H100 SXM, presets 2 (bf16, H = 1024,
        B = 32), 3 and 4 (H = 1824, B = 64, and 16 a card under DP4) take
        the one launch of both directions at 32 columns a block; preset 1
        (f32) and preset 5 (the wide instance) launch a direction at a
        time."""
        cfg = get_config(name)
        for n_b in {cfg.data.batch_size, max(1, cfg.data.batch_size // 4)}:
            p = birnn_cuda.plan(
                n_b, cfg.model.hidden_dim,
                getattr(torch, cfg.model.compute_dtype),
                directions=1 + cfg.model.bidirectional)
            assert p.directions == directions
            assert p.cols == 32 or directions == 1

    def test_fused_kernels_share_b1_s_library(self):
        """Every row of ``INSTANCES`` counts B1's and B2's launches on
        counters of their own, listed by ``ops.kernels()`` under today's
        names and built from B1's source; a fused launch counts as two
        direction sweeps, a wide one as none."""
        from tpu_ctc_torch.ops import kernels
        by_name = {k.name: k for k in kernels()}
        names = ["birnn_fwd", "birnn_bwd", "birnn_fwd_wide", "birnn_bwd_wide",
                 "birnn_fwd_bi32", "birnn_bwd_bi32"]
        assert list(_COUNTERS) == names
        for name in names:
            assert by_name[name] is _COUNTERS[name]
            assert by_name[name].library == _COUNTERS["birnn_fwd"].library
            assert by_name[name].source == _CSRC
        assert "birnn_fwd_bi" not in by_name
        assert birnn_cuda.direction_sweeps(
            {"birnn_fwd": 3, "birnn_fwd_bi32": 6, "birnn_bwd_bi32": 6,
             "ctc_beta": 6}) == {"birnn_fwd": 15, "birnn_bwd": 12}
        assert birnn_cuda.direction_sweeps(
            {"birnn_fwd": 1, "birnn_fwd_bi32": 5, "birnn_bwd_bi32": 5,
             "birnn_bwd": 2, "birnn_fwd_wide": 4}) == {"birnn_fwd": 11,
                                                       "birnn_bwd": 12}

    def test_plan_holds_the_kernel_s_constants(self):
        """The plan's copies of birnn.cu's constants, parsed from the
        source: a block's warps, a ring stage's bytes, the stages and rows
        a narrow block of each column count allows, the padding, the wide
        block's most tiles, a direction's counter stride; and the narrow
        rows of ``INSTANCES`` are the (directions, columns) that
        ``dispatch`` instantiates."""
        with open(_CSRC) as f:
            src = f.read()

        def const(name):
            m = re.search(rf"constexpr int {name} = ([^;]+);", src)
            return m.group(1)
        assert int(const("kThreads")) // 32 == birnn_cuda._WARPS
        assert const("kWarps") == "kThreads / 32"
        assert int(const("kStageBytes")) == birnn_cuda._STAGE_BYTES
        assert int(const("kMaxB")) == birnn_cuda.MAX_BATCH
        assert int(const("kCols")) == birnn_cuda._COLS
        assert int(const("kPad")) == birnn_cuda._PAD
        assert int(const("kKc")) == birnn_cuda._KC
        assert int(const("kMaxOwn")) == birnn_cuda._MAX_OWN
        assert int(const("kCountStride")) == birnn_cuda._COUNT_STRIDE
        stages = re.search(r"int ring_stages\(int cols\) \{\s*return cols == "
                           r"16 \? (\d+) : (\d+);", src)
        assert {16: int(stages.group(1)), 32: int(stages.group(2))} == (
            birnn_cuda._RING_STAGES)
        rows = re.search(r"int max_rows\(int cols\) \{\s*return cols == 16 "
                         r"\? kMaxB : (\d+);", src)
        assert {16: birnn_cuda.MAX_BATCH, 32: int(rows.group(1))} == (
            birnn_cuda._MAX_ROWS)
        launched = {(int(d), 16 if n == "kCols" else int(n)) for d, n in
                    re.findall(r"launch_sweeps<kBwd, (\d), (\w+)>\(", src)}
        assert launched == {(d, row[0]) for (code, d), row in
                            birnn_cuda.INSTANCES.items() if code == "narrow"}

    def test_cpu_tensors_sweep_both_directions_in_the_plain_loops(self):
        """``fwd_recurrence`` and ``bwd_recurrence`` of two directions on
        CPU tensors are the plain loops of each direction, and count no
        launch."""
        z, wf, wb, lens, _ = (torch.from_numpy(a) for a in
                              _recurrence_inputs(8, 7, 3, 8, 0.3))
        g = z.flip(0)
        before = _launches()
        hs_f, hs_b = birnn_cuda.fwd_recurrence(z, (wf, wb), lens,
                                               reverse=False, clip=20.0)
        assert torch.equal(hs_f, birnn_cuda.fwd_recurrence_plain(
            z, wf, lens, reverse=False, clip=20.0))
        assert torch.equal(hs_b, birnn_cuda.fwd_recurrence_plain(
            z, wb, lens, reverse=True, clip=20.0))
        d_f, d_b = birnn_cuda.bwd_recurrence(g, (hs_f, hs_b),
                                             (wf.t(), wb.t()), reverse=True,
                                             clip=20.0)
        assert torch.equal(d_f, birnn_cuda.bwd_recurrence_plain(
            g, hs_f, wf.t(), reverse=True, clip=20.0))
        assert torch.equal(d_b, birnn_cuda.bwd_recurrence_plain(
            g, hs_b, wb.t(), reverse=False, clip=20.0))
        assert _launches() == before
