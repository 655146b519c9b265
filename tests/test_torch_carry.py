"""B1 from a nonzero carry: the port's ``carry_recurrence`` and the model's
``_recurrence_with_carry`` against the JAX package, forward and backward.

Inputs come from numpy seeds.  The port's plain carry sweep (the CPU
version of kernel B1 from h0 and of ``CarryRecurrence``'s backward, kernel
B2 and the GEMMs on a card) is held against
``birnn_pallas.carry_recurrence`` in interpret mode, as
``tests/test_birnn_pallas.py`` runs it, in both directions, at f32 and
bf16, with rows whose length is below T (down to 0, where h0 must not
reach them) and a nonzero h0.  Outputs agree within the tolerances
``tests/test_torch_birnn.py`` states for B1's plain version (1e-5 at f32,
2e-2 at bf16).  dz, dW and dh0 agree within ``PERF.md`` section 2's
gradient tolerance, 1e-2 of each gradient's norm (at f32 also within 1e-5
of its largest magnitude).  At f32 the sweep also matches the XLA scan of
``models.birnn._recurrence_with_carry``.  From a zero carry the two
directions are bit-equal to ``bi_recurrence``'s, forward and backward,
and a chain of chunks, each seeded with the last state of the one before,
is bit-equal to one sweep over the whole T (at bf16 the dot input is the
stored bf16 state at every step, chunked or not).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ctc.config import ModelConfig as JaxModelConfig
from tpu_ctc.models import birnn as jax_birnn
from tpu_ctc.ops import birnn_pallas
from tpu_ctc_torch.config import ModelConfig
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.ops import birnn_cuda

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, b, t, h, lens=None):
    r = np.random.RandomState(seed)
    z = (3.0 * r.randn(b, t, h)).astype(np.float32)
    w = (0.5 / np.sqrt(h) * r.randn(h, h)).astype(np.float32)
    h0 = np.abs(2.0 * r.randn(b, h)).astype(np.float32)
    if lens is None:
        lens = r.randint(0, t + 1, b)
        lens[0] = t
    lens = np.asarray(lens)
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    g = r.randn(b, t, h).astype(np.float32)
    return z, w, h0, mask, g


def _jax_vjp(z, w, h0, mask, g, reverse, dtype):
    def f(z, w, h0):
        return birnn_pallas.carry_recurrence(
            z, w, h0, jnp.asarray(mask), reverse=reverse, clip=20.0,
            compute_dtype=dtype)
    out, vjp = jax.vjp(f, *(jnp.asarray(v) for v in (z, w, h0)))
    return [np.asarray(v) for v in (out, *vjp(jnp.asarray(g)))]


def _port_vjp(z, w, h0, mask, g, reverse, dtype):
    tz, tw, th = (torch.from_numpy(v).requires_grad_(True)
                  for v in (z, w, h0))
    out = birnn_cuda.carry_recurrence(
        tz, tw, th, torch.from_numpy(mask), reverse=reverse, clip=20.0,
        compute_dtype=getattr(torch, dtype))
    out.backward(torch.from_numpy(g))
    return [v.detach().numpy() for v in (out, tz.grad, tw.grad, th.grad)]


class TestCarryRecurrence:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("reverse", [False, True])
    @pytest.mark.parametrize("b,t,h,lens", [
        (3, 10, 16, [10, 6, 0]), (4, 13, 24, None), (2, 9, 32, [9, 9])])
    def test_matches_pallas_interpret(self, b, t, h, lens, reverse, dtype):
        z, w, h0, mask, g = _inputs(b * t + h + reverse, b, t, h, lens)
        want = _jax_vjp(z, w, h0, mask, g, reverse, dtype)
        got = _port_vjp(z, w, h0, mask, g, reverse, dtype)
        np.testing.assert_allclose(got[0], want[0], rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg="out")
        for name, a, ref in zip(("dz", "dw", "dh0"), got[1:], want[1:]):
            assert (np.linalg.norm(a - ref)
                    <= 1e-2 * np.linalg.norm(ref) + 1e-12), name
            if dtype == "float32":
                np.testing.assert_allclose(a, ref, rtol=1e-5,
                                           atol=1e-5 * np.abs(ref).max(),
                                           err_msg=name)

    def test_h0_reaches_only_live_first_frames(self):
        """A row whose first processed frame is dead keeps h = 0 and dh0 =
        0: length 0 forward, length < T reversed (its first processed frame
        is T - 1)."""
        z, w, h0, mask, g = _inputs(5, 3, 8, 16, [8, 5, 0])
        fwd = _port_vjp(z, w, h0, mask, g, False, "float32")
        rev = _port_vjp(z, w, h0, mask, g, True, "float32")
        assert not fwd[0][2].any() and not fwd[3][2].any()
        assert fwd[3][:2].any()
        assert rev[3][0].any() and not rev[3][1:].any()
        z0 = birnn_cuda.carry_recurrence(
            torch.from_numpy(z), torch.from_numpy(w), torch.zeros(3, 16),
            torch.from_numpy(mask), reverse=True, clip=20.0,
            compute_dtype=torch.float32)
        assert np.array_equal(rev[0][1:], z0.numpy()[1:])

    @pytest.mark.parametrize("reverse", [False, True])
    def test_with_carry_matches_jax_scan(self, reverse):
        z, w, h0, mask, _ = _inputs(7 + reverse, 3, 11, 16)
        fields = dict(input_dim=12, hidden_dim=16, vocab_size=7,
                      compute_dtype="float32")
        jcfg = dataclasses.replace(JaxModelConfig(**fields),
                                   birnn_impl="scan")
        want_hs, want_last = jax_birnn._recurrence_with_carry(
            jnp.asarray(z), jnp.asarray(w), jnp.asarray(mask), reverse,
            jnp.asarray(h0), cfg=jcfg)
        hs, last = birnn._recurrence_with_carry(
            torch.from_numpy(z), torch.from_numpy(w), torch.from_numpy(mask),
            reverse, torch.from_numpy(h0), cfg=ModelConfig(**fields))
        np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(last, hs[:, 0] if reverse else hs[:, -1])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_zero_h0_is_bi_recurrence(self, dtype):
        """From h0 = 0 the forward and reversed carry sweeps are the two
        directions of ``bi_recurrence``, bit for bit: their sum, dz, dwf and
        dwb."""
        z, w, _, mask, g = _inputs(9, 3, 12, 16)
        wb = np.ascontiguousarray(w[::-1])
        lens = torch.from_numpy(mask.sum(1).astype(np.int32))
        zt = torch.from_numpy(z).transpose(0, 1).contiguous()
        gt = torch.from_numpy(g).transpose(0, 1).contiguous()
        args = [torch.from_numpy(v).requires_grad_(True)
                for v in (z, w, wb)]
        h0 = torch.zeros(3, 16)
        out = (birnn_cuda.carry_recurrence(
            args[0], args[1], h0, torch.from_numpy(mask), reverse=False,
            clip=20.0, compute_dtype=dtype)
            + birnn_cuda.carry_recurrence(
            args[0], args[2], h0, torch.from_numpy(mask), reverse=True,
            clip=20.0, compute_dtype=dtype))
        out.backward(torch.from_numpy(g))
        bi = [zt.clone().requires_grad_(True),
              *(a.detach().clone().requires_grad_(True) for a in args[1:])]
        want = birnn_cuda.bi_recurrence(*bi, lens, clip=20.0,
                                        compute_dtype=dtype)
        want.backward(gt)
        assert torch.equal(out.transpose(0, 1), want)
        assert torch.equal(args[0].grad.transpose(0, 1), bi[0].grad)
        assert torch.equal(args[1].grad, bi[1].grad)
        assert torch.equal(args[2].grad, bi[2].grad)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("reverse", [False, True])
    def test_chain_of_chunks_is_one_sweep(self, reverse, dtype):
        """Chunks of 6 frames, each swept from the last stored state of the
        one before (the carry a sequence-parallel neighbour hands over),
        give the sweep over all 24 frames bit for bit."""
        z, w, _, mask, _ = _inputs(11, 4, 24, 16)
        zt = torch.from_numpy(z).transpose(0, 1).to(dtype)
        wt = torch.from_numpy(w).to(dtype)
        lens = torch.from_numpy(mask.sum(1).astype(np.int64))
        whole = birnn_cuda.fwd_recurrence_plain(zt, wt, lens,
                                                reverse=reverse, clip=20.0)
        starts = list(range(0, 24, 6))
        parts, h = {}, None
        for s in (starts[::-1] if reverse else starts):
            local = torch.clamp(lens - s, 0, 6)
            parts[s] = birnn_cuda.fwd_recurrence_plain(
                zt[s:s + 6], wt, local, reverse=reverse, clip=20.0, h0=h)
            h = parts[s][0] if reverse else parts[s][-1]
        assert torch.equal(torch.cat([parts[s] for s in starts]), whole)
