"""The port's optimizer, train step, checkpoints, loop and ``cli train``
against the JAX package, on the CPU.

* The optimizer chain against optax's ``make_optimizer`` over 8 steps:
  momentum ramp, weight decay, staircase lr decay, and clipping that does
  and does not trigger; parameters within 1e-6 (f32 of the same chain).
* Three ``train_step``s of preset 2 cut to H = 32 with one bidirectional
  layer and f32 compute, from the same npz weights and a zero trace,
  against JAX's jitted ``train_step``: loss and ``grad_norm`` within rtol
  1e-5, every parameter within 1e-6 + 1e-5 relative after each step (the
  two sides sum in other orders; the clipped update moves each weight by
  at most lr * 5).
* ``save``/``restore`` of the full state, the eval step, and the CLI:
  ``train --device cpu`` on a tiny config, ``--resume`` from its
  checkpoint, and the default device failing without a card.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_ctc import config as jax_config
from tpu_ctc.decode.greedy import collapse_ids as jax_collapse_ids
from tpu_ctc.losses import ctc_ref as jax_ref
from tpu_ctc.models import birnn as jax_birnn
from tpu_ctc.train import checkpoint as jax_ckpt
from tpu_ctc.train import optim as jax_optim
from tpu_ctc.train import step as jax_step
from tpu_ctc_torch import config
from tpu_ctc_torch.data.bucketing import BucketedLoader
from tpu_ctc_torch.data.synthetic import SyntheticCorpus
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.ops import birnn_cuda
from tpu_ctc_torch.train import checkpoint, loop, optim, step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Preset 2 cut to size: full input width and vocabulary, H = 32, one
# bidirectional layer, f32 compute, batches of 4 in one 48-frame bucket.
SMALL = {"model.hidden_dim": 32, "model.num_bi_layers": 1,
         "model.compute_dtype": "float32", "data.batch_size": 4,
         "data.bucket_boundaries": (48,), "data.sortagrad": False}


def _flat(tree):
    """JAX param tree -> {'pre.0.w': array, ...} (the port's names)."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batches(cfg, n=12, seed=1):
    data = SyntheticCorpus(n, feature_dim=cfg.model.input_dim, min_chars=2,
                           max_chars=5, seed=seed).all_utterances()
    return [loop.batch_to_device_dict(b)
            for _, b in BucketedLoader(data, cfg.data).epoch(0)]


def _python_float_updates(params, grads, trace, count, ocfg):
    """The optimizer chain as it ran with m and -lr as Python floats."""
    names = list(params)
    updates = [grads[k].to(torch.float32) for k in names]
    if ocfg.grad_clip_norm > 0:
        g_norm = optim.global_norm(updates)
        keep = g_norm < ocfg.grad_clip_norm
        updates = [torch.where(keep, u, (u / g_norm) * ocfg.grad_clip_norm)
                   for u in updates]
    if ocfg.weight_decay > 0:
        updates = [u + ocfg.weight_decay * params[k]
                   for u, k in zip(updates, names)]
    m = optim.momentum_at(ocfg, count)
    lr = -optim.learning_rate_at(ocfg, count)
    for k, u in zip(names, updates):
        trace[k].mul_(m).add_(u)
        u = u + m * trace[k] if ocfg.nesterov else trace[k]
        params[k].add_((lr * u).to(params[k].dtype))


class TestOptimizer:
    @pytest.mark.parametrize("over,scale", [
        ({}, 0.1),                                     # clip never triggers
        ({}, 30.0),                                    # clip always triggers
        ({"momentum_start": 0.5, "momentum_ramp_steps": 5,
          "weight_decay": 1e-3, "lr_decay": 0.5, "lr_decay_steps": 3}, 1.0),
        ({"nesterov": False, "grad_clip_norm": 0.0, "momentum": 0.9}, 2.0),
    ])
    def test_matches_optax(self, over, scale):
        ocfg = dataclasses.replace(config.OptimConfig(), **over)
        jcfg = dataclasses.replace(jax_config.OptimConfig(), **over)
        r = np.random.RandomState(len(over) + int(scale))
        shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
        p0 = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
        tx = jax_optim.make_optimizer(jcfg)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        js = tx.init(jp)
        tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        ts = optim.init_opt_state(tp)
        norms = []
        for i in range(8):
            # the global norm crosses 5 both ways when scale is near 1
            g = {k: (scale * (0.3 + i % 3) * r.randn(*s)).astype(np.float32)
                 for k, s in shapes.items()}
            norms.append(float(np.sqrt(sum((v ** 2).sum()
                                           for v in g.values()))))
            upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp)
            jp = optax.apply_updates(jp, upd)
            ts = optim.apply_updates(tp, {k: torch.from_numpy(v)
                                          for k, v in g.items()}, ts, ocfg)
            for k in shapes:
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"step {i} {k}")
        assert ts.count == 8
        if scale == 1.0:
            assert min(norms) < 5.0 < max(norms)

    @pytest.mark.parametrize("over", [
        {"momentum_start": 0.5, "momentum_ramp_steps": 5, "lr_decay": 0.5,
         "lr_decay_steps": 3, "weight_decay": 1e-3},
        {"momentum_start": 0.3, "momentum_ramp_steps": 7, "lr_decay": 0.7,
         "lr_decay_steps": 1, "nesterov": False, "learning_rate": 0.031}])
    def test_device_scalars_are_the_python_floats(self, over):
        """``apply_updates`` takes m and -lr as an f32 tensor
        (``step_scalars``, what a CUDA graph of the step reads): bit-equal
        over a momentum ramp and a staircase decay to the chain with the
        same values as Python floats, which f32 ops round once; each
        scalar is the f32 of the host formula.  (``test_matches_optax``
        holds the same chain against optax.)"""
        ocfg = dataclasses.replace(config.OptimConfig(), **over)
        r = np.random.RandomState(7)
        shapes = {"a": (5, 3), "b": (7,)}
        p0 = {k: r.randn(*v).astype(np.float32) for k, v in shapes.items()}
        got = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        want = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        state = optim.init_opt_state(got)
        trace = {k: torch.zeros_like(v) for k, v in want.items()}
        for count in range(9):
            g = {k: torch.from_numpy((2.0 * r.randn(*v)).astype(np.float32))
                 for k, v in shapes.items()}
            sc = optim.step_scalars(ocfg, count)
            assert sc.dtype == torch.float32 and sc.tolist() == [
                float(np.float32(optim.momentum_at(ocfg, count))),
                float(np.float32(-optim.learning_rate_at(ocfg, count)))]
            state = optim.apply_updates(got, g, state, ocfg,
                                        scalars=sc if count % 2 else None)
            _python_float_updates(want, g, trace, count, ocfg)
            for k in shapes:
                assert torch.equal(got[k], want[k]), (count, k)
                assert torch.equal(state.trace[k], trace[k]), (count, k)
        assert state.count == 9
        ramp = [optim.momentum_at(ocfg, c) for c in range(9)]
        decay = [optim.learning_rate_at(ocfg, c) for c in range(9)]
        assert len(set(ramp)) > 4 and len(set(decay)) > 2

    def test_schedules(self):
        ocfg = config.OptimConfig(momentum_start=0.5, momentum_ramp_steps=4,
                                  lr_decay=0.3, lr_decay_steps=2)
        ramp = jax_optim.momentum_schedule(
            jax_config.OptimConfig(momentum_start=0.5, momentum_ramp_steps=4))
        lr = optax.exponential_decay(1e-2, 2, 0.3, staircase=True)
        for count in range(8):
            assert optim.momentum_at(ocfg, count) == pytest.approx(
                float(ramp(count)), rel=1e-6)
            assert optim.learning_rate_at(ocfg, count) == pytest.approx(
                float(lr(count)), rel=1e-6)

    def test_global_norm(self):
        ts = [torch.ones(3, 4), 2 * torch.ones(5)]
        assert float(optim.global_norm(ts)) == pytest.approx(np.sqrt(32.0))


class TestTrainStep:
    def test_three_steps_match_jax(self, tmp_path):
        jcfg = jax_config.get_config("2", **SMALL)
        tcfg = config.get_config("2", **SMALL)
        jstate = jax_step.create_train_state(jcfg)
        path = str(tmp_path / "w.npz")
        jax_ckpt.export_npz(path, jstate.params)
        tstate = step.create_train_state(tcfg, device="cpu")
        checkpoint.load_npz(tstate.model, path)
        tx = jax_optim.make_optimizer(jcfg.optim)
        jfn = jax.jit(functools.partial(jax_step.train_step, cfg=jcfg, tx=tx))
        batches = _batches(tcfg)
        assert len(batches) == 3 and batches[0]["feats"].shape[1] == 48
        for i, bd in enumerate(batches):
            jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in bd.items()})
            tstate, tm = step.train_step(
                tstate, step.batch_to_tensors(bd, "cpu"), tcfg)
            for key in ("loss", "grad_norm", "loss_per_frame", "num_utts",
                        "num_frames"):
                assert float(tm[key]) == pytest.approx(float(jm[key]),
                                                       rel=1e-5), (i, key)
            want = _flat(jstate.params)
            for name, p in tstate.model.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), want[name],
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"step {i} {name}")
        assert tstate.step == 3 and int(jstate.step) == 3
        assert float(tm["grad_norm"]) > 5.0          # clipping was live

    def test_debug_nans_raises_before_the_update(self):
        """``train.debug_nans``: a NaN in the features makes the gradient
        norm NaN; with the flag the step raises FloatingPointError
        (what ``jax_debug_nans`` raises) and leaves the parameters and the
        optimizer state as they were.  Without it the step runs as before
        (no check), and on finite data the flag changes nothing."""
        on = config.get_config("2", **SMALL, **{"train.debug_nans": True})
        off = config.get_config("2", **SMALL)
        bd = step.batch_to_tensors(_batches(off)[0], "cpu")
        bad = dict(bd, feats=bd["feats"].clone())
        bad["feats"][0, 0, 0] = float("nan")
        res = {}
        for name, cfg in (("on", on), ("off", off)):
            st = step.create_train_state(cfg, device="cpu")
            before = {k: p.detach().clone()
                      for k, p in st.model.named_parameters()}
            if name == "on":
                with pytest.raises(FloatingPointError, match="debug_nans"):
                    step.train_step(st, bad, cfg)
                for k, p in st.model.named_parameters():
                    assert torch.equal(p, before[k]), k
                assert st.step == 0 and st.opt_state.count == 0 and not any(
                    bool(t.any()) for t in st.opt_state.trace.values())
            else:
                # the NaN frame's utterance clamps to the infeasible NLL,
                # so the loss stays finite; its gradient is NaN
                _, m = step.train_step(st, bad, cfg)
                assert not bool(torch.isfinite(m["grad_norm"]))
            st = step.create_train_state(cfg, device="cpu")
            st, m = step.train_step(st, bd, cfg)
            res[name] = (float(m["loss"]), {
                k: p.detach().clone() for k, p in st.model.named_parameters()})
        assert res["on"][0] == res["off"][0]
        for k, p in res["on"][1].items():
            assert torch.equal(p, res["off"][1][k]), k

    def test_bf16_gradient_tolerance_of_the_chip_check(self):
        """Derives phase 7's gradient bound in chip_smoke.py (1e-2 relative
        per parameter, kernel path against plain path, bf16 compute).

        The cotangent is rounded to bf16 at every dense layer's input and
        weight gradient (JAX's rounding points), so once two paths differ
        in any f32 sum those roundings differ by a bf16 ulp (2^-8) here and
        there.  Here the paths differ only in the CTC's summation order,
        and the gradients already differ by ~1.5e-3 (this size; 1.5-1.7e-3
        at H = 256-512, T = 200-400); bf16 against f32 is ~2e-2; a weight
        gradient paired with the wrong frame is off by O(1)."""
        tcfg = config.get_config("2", **{
            **SMALL, "model.hidden_dim": 128, "model.num_bi_layers": 3,
            "model.compute_dtype": "bfloat16",
            "data.bucket_boundaries": (96,)})
        data = SyntheticCorpus(4, feature_dim=120, min_chars=6, max_chars=11,
                               seed=1).all_utterances()
        bd = next(iter(BucketedLoader(data, tcfg.data).epoch(0)))[1]
        bt = step.batch_to_tensors(loop.batch_to_device_dict(bd), "cpu")
        model = birnn.init_params(tcfg.model, seed=0, device="cpu")

        def grads(cfg):
            loss, _ = step.loss_fn(model, cfg, bt)
            names = [n for n, _ in model.named_parameters()]
            return dict(zip(names, torch.autograd.grad(
                loss, list(model.parameters()))))

        def rel(a, b):
            return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        g = grads(tcfg)
        g_plain = grads(tcfg.override(**{"model.birnn_impl": "scan",
                                         "ctc_impl": "jnp"}))
        g32 = grads(tcfg.override(**{"model.compute_dtype": "float32"}))
        order = max(rel(g[n], g_plain[n]) for n in g)
        points = max(rel(g[n], g32[n]) for n in g)

        # dwf with d_f[t] paired with h_f[t] instead of h_f[t-1]
        r = np.random.RandomState(2)
        z = torch.from_numpy(r.randn(40, 4, 64).astype(np.float32))
        w = torch.from_numpy(0.1 * r.randn(64, 64).astype(np.float32))
        lens = torch.tensor([40, 33, 20, 7])
        hs = birnn_cuda.fwd_recurrence_plain(z.bfloat16(), w.bfloat16(), lens,
                                             reverse=False, clip=20.0)
        d = birnn_cuda.bwd_recurrence_plain(torch.randn_like(z).bfloat16(),
                                            hs, w.bfloat16().t(),
                                            reverse=True, clip=20.0)
        right = birnn_cuda._weight_grad(
            torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]), d)
        shifted = birnn_cuda._weight_grad(hs, d)
        assert order < 2.5e-3 < 1e-2 < points
        assert rel(shifted, right) > 0.1
    def test_eval_step_matches_jax_pieces(self, tmp_path):
        jcfg = jax_config.get_config("2", **SMALL)
        tcfg = config.get_config("2", **SMALL)
        params = jax_birnn.init_params(jax.random.PRNGKey(2), jcfg.model)
        path = str(tmp_path / "w.npz")
        jax_ckpt.export_npz(path, params)
        model = checkpoint.load_npz(birnn.BiRNN(tcfg.model, device="cpu"),
                                    path)
        bd = _batches(tcfg)[0]
        out = step.eval_step(model, tcfg, step.batch_to_tensors(bd, "cpu"))
        lp = jax_birnn.log_posteriors(params, jcfg.model,
                                      jnp.asarray(bd["feats"]),
                                      jnp.asarray(bd["frame_mask"]))
        hyp, hyp_len = jax_collapse_ids(
            jnp.argmax(lp, -1).astype(jnp.int32), jnp.asarray(bd["frame_mask"]))
        nll = jax_ref.ctc_loss_from_log_probs(
            lp, jnp.asarray(bd["labels"]), jnp.asarray(bd["frame_lengths"]),
            jnp.asarray(bd["label_lengths"]))
        np.testing.assert_array_equal(out["hyp_len"].numpy(),
                                      np.asarray(hyp_len))
        np.testing.assert_array_equal(out["hyp"].numpy(), np.asarray(hyp))
        np.testing.assert_allclose(out["nll"].numpy(), np.asarray(nll),
                                   rtol=1e-5)


def _step_shapes(cfg):
    """Every (B, T_pad, label width) a step can see once the labels are cut
    (``bucketing.cut_labels``): each bucket with every multiple of 32 below
    its padded width, and the padded width."""
    from tpu_ctc_torch.data.bucketing import LABEL_ALIGN, label_width
    out = set()
    for b, t, l_pad in BucketedLoader([], cfg.data).shape_keys():
        widths = {label_width(np.array([n]), l_pad)
                  for n in range(1, l_pad + 1)}
        assert all(w % LABEL_ALIGN == 0 or w == l_pad for w in widths)
        out |= {(b, t, w) for w in widths}
    return sorted(out)


class TestCompiledStep:
    """The compiled step (``train.graphs``: one CUDA graph per batch shape
    on a card) is made only on a card, for one rank or NCCL ranks: on the
    CPU ``make_train_step`` and ``make_eval_step`` return the eager step
    (gloo ranks too: ``tests/test_torch_parallel.py``), and the graphs'
    shape key and their bound come from host shapes alone.  The graphs
    themselves are held against the eager step on a card
    (``tests/test_torch_cuda.py``, meshes on two cards)."""

    def test_the_cpu_and_debug_nans_stay_eager(self):
        from tpu_ctc_torch.parallel.mesh import make_mesh
        cfg = config.get_config("2", **SMALL)
        mesh = make_mesh(cfg.mesh)
        assert mesh.size == 1
        for c in (cfg, cfg.override(**{"train.debug_nans": True})):
            st = step.create_train_state(c, device="cpu")
            fn, st2 = step.make_train_step(c, mesh, st)
            assert st2 is st
            assert isinstance(fn, functools.partial)
            assert fn.func is step.train_step
            assert step.eager_reason(c, mesh, "cpu").startswith("the CPU")
        bt = step.batch_to_tensors(_batches(cfg)[0], "cpu")
        ev = step.make_eval_step(cfg, mesh, "cpu")(st.model, bt)
        want = step.eval_step(st.model, cfg, bt)
        assert ev.keys() == want.keys()
        for k in want:
            assert torch.equal(ev[k], want[k]), k

    def test_train_releases_the_graphs_when_it_returns_or_raises(
            self, tmp_path, monkeypatch):
        """``loop.train`` releases its steps' graphs (on a mesh they keep
        NCCL's communicators alive, and ``destroy_process_group`` would
        wait for ever) when it returns and when a step raises, though the
        traceback keeps its frame."""
        cfg = config.get_config("2", **{**SMALL, "train.num_epochs": 1})
        data = SyntheticCorpus(10, feature_dim=120, min_chars=2, max_chars=5,
                               seed=3).all_utterances()
        released = []

        class Compiled:
            def __init__(self, fn, what, fail):
                self.fn, self.what, self.fail = fn, what, fail

            def __call__(self, *args):
                if self.fail:
                    raise RuntimeError("capture failed")
                return self.fn(*args)

            def release(self):
                released.append(self.what)

        for fail in (False, True):
            make_train, make_eval = step.make_train_step, step.make_eval_step
            monkeypatch.setattr(loop, "make_train_step", lambda *a: (
                lambda fn, st: (Compiled(fn, "train", fail), st))(
                    *make_train(*a)))
            monkeypatch.setattr(loop, "make_eval_step", lambda *a: Compiled(
                make_eval(*a), "eval", False))
            released.clear()
            if fail:
                with pytest.raises(RuntimeError, match="capture failed"):
                    loop.train(cfg, data, work_dir=str(tmp_path / "f"),
                               device="cpu")
            else:
                state, _ = loop.train(cfg, data, work_dir=str(tmp_path),
                                      device="cpu")
                assert state.step > 0
            assert sorted(released) == ["eval", "train"], (fail, released)

    def test_shape_keys_come_from_host_shapes(self):
        """The key of a batch's host arrays (the labels cut) is the key of
        the tensors a step gets; the (B, T, label width) shapes the cut
        allows bound the graphs a run can capture: 23 for preset 2
        (buckets 200, 400, 800; labels padded to 200, 256, 256), 6 at the
        accuracy chain's shape (buckets 80, 160, 320; labels padded to
        64)."""
        from tpu_ctc_torch.data.bucketing import cut_labels
        from tpu_ctc_torch.train import graphs
        cfg = config.get_config("2", **dict(
            SMALL, **{"data.bucket_boundaries": (400,)}))
        loader = BucketedLoader(SyntheticCorpus(
            12, feature_dim=cfg.model.input_dim, min_chars=2, max_chars=40,
            seed=3).all_utterances(), cfg.data)
        keys = set()
        for _, b in loader.epoch(0):
            host = cut_labels(loop.batch_to_device_dict(b))
            key = graphs.shape_key(host)
            assert key == graphs.shape_key(step.batch_to_tensors(host,
                                                                 "cpu"))
            assert dict((k, s) for k, s, _ in key)["labels"] in [
                (4, w) for _, _, w in _step_shapes(cfg)]
            keys.add(key)
        # labels of 9-38 characters padded to 256: widths 32 and 64
        assert sorted(dict((k, s) for k, s, _ in key)["labels"][1]
                      for key in keys) == [32, 64]
        p2 = config.get_config("2")
        chain = p2.override(**{"data.bucket_boundaries": (80, 160, 320),
                               "data.max_label_len": 64,
                               "data.batch_size": 16})
        assert [len(_step_shapes(c)) for c in (p2, chain)] == [23, 6]


class TestCheckpoint:
    def test_save_restore_round_trip(self, tmp_path):
        cfg = config.get_config("2", **SMALL)
        state = step.create_train_state(cfg, device="cpu")
        state, _ = step.train_step(
            state, step.batch_to_tensors(_batches(cfg)[0], "cpu"), cfg)
        d = str(tmp_path / "ck")
        assert checkpoint.save(d, state, epoch=2, batch_cursor=5) is not None
        assert checkpoint.save(d, state, epoch=2, batch_cursor=5) is None
        fresh = step.create_train_state(dataclasses.replace(cfg, seed=9),
                                        device="cpu")
        restored, epoch, cursor = checkpoint.restore(d, fresh)
        assert (restored.step, epoch, cursor) == (1, 2, 5)
        assert restored.opt_state.count == 1
        for (_, a), (_, b) in zip(state.model.named_parameters(),
                                  restored.model.named_parameters()):
            assert torch.equal(a, b)
        for key, tr in state.opt_state.trace.items():
            assert torch.equal(tr, restored.opt_state.trace[key])
            assert tr.abs().sum() > 0

    def test_keeps_the_newest(self, tmp_path):
        cfg = config.get_config("2", **SMALL)
        state = step.create_train_state(cfg, device="cpu")
        d = str(tmp_path / "ck")
        for s in range(5):
            state.step = s
            checkpoint.save(d, state, 0, s, keep=2)
        assert sorted(os.listdir(d)) == ["step_00000003.pt",
                                         "step_00000004.pt"]
        assert checkpoint.restore(str(tmp_path / "none"), state) is None


class TestLoop:
    def test_train_then_preempted_then_resumed(self, tmp_path, monkeypatch):
        cfg = config.get_config("2", **{**SMALL, "train.num_epochs": 2,
                                        "train.log_every": 1,
                                        "train.eval_every": 3})
        data = SyntheticCorpus(10, feature_dim=120, min_chars=2, max_chars=5,
                               seed=3).all_utterances()
        work = str(tmp_path / "run")
        state, metrics = loop.train(cfg, data[1:], eval_data=data[:1],
                                    work_dir=work, device="cpu")
        assert state.step == 6 and metrics["step"] == 6
        events = [json.loads(x) for x in open(os.path.join(
            work, "metrics.jsonl"))]
        kinds = [e["kind"] for e in events]
        assert kinds.count("train") == 6 and kinds.count("eval") == 2
        ev = next(e for e in events if e["kind"] == "eval")
        assert 0.0 <= ev["cer"] and ev["num_utts"] == 1

        class Preempted(loop.PreemptionGuard):
            def __init__(self):
                super().__init__(enable=False)
                self.requested = True
        monkeypatch.setattr(loop, "PreemptionGuard", Preempted)
        cfg3 = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, num_epochs=3))
        state, _ = loop.train(cfg3, data[1:], work_dir=work, resume=True,
                              device="cpu")
        assert state.step == 6
        _, epoch, cursor = checkpoint.restore(
            os.path.join(work, "checkpoints"),
            step.create_train_state(cfg3, device="cpu"))
        assert (epoch, cursor) == (2, 0)


def _cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "tpu_ctc_torch.cli", *args],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=timeout)


TINY = ["--config", "2", "--set", "model.hidden_dim=16",
        "--set", "model.num_bi_layers=1", "--set", "data.batch_size=4",
        "--set", "data.bucket_boundaries=(100,)", "--set", "train.log_every=1",
        "--synthetic", "12"]


class TestCli:
    def test_train_on_cpu_then_resume(self, tmp_path):
        work = str(tmp_path / "run")
        out = _cli("train", *TINY, "--set", "train.num_epochs=1",
                   "--device", "cpu", "--work-dir", work)
        assert out.returncode == 0, out.stderr
        assert "final metrics:" in out.stdout and "'step': 3" in out.stdout
        assert os.path.exists(os.path.join(work, "metrics.jsonl"))
        assert os.listdir(os.path.join(work, "checkpoints")) == [
            "step_00000003.pt"]
        out = _cli("train", *TINY, "--set", "train.num_epochs=2",
                   "--device", "cpu", "--work-dir", work, "--resume")
        assert out.returncode == 0, out.stderr
        assert "[ckpt] resumed at epoch 1 batch 0 step 3" in out.stdout
        assert "'step': 6" in out.stdout

    def test_train_default_device_fails_without_a_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        out = _cli("train", *TINY, "--work-dir", str(tmp_path))
        assert out.returncode != 0 and "CUDA" in out.stderr

    def test_train_data_flags_raise(self, tmp_path):
        """``--data`` trains on a manifest of audio files and writes a
        checkpoint."""
        from tpu_ctc_torch.data import audio_io
        from tpu_ctc_torch.data.manifest import write_manifest
        from tpu_ctc_torch.data.synthetic import synthetic_audio_batch
        corpus = str(tmp_path / "corpus")
        os.makedirs(corpus)
        audio, sl, labels, ll = synthetic_audio_batch(
            8, 16000, min_chars=2, max_chars=4, samples_per_char=2400)
        recs = []
        for i in range(8):
            audio_io.write_wav(os.path.join(corpus, f"{i}.wav"),
                               audio[i, :sl[i]], 16000)
            recs.append({"id": f"u{i}", "audio": f"{i}.wav",
                         "text": "abcd"[:int(ll[i])]})
        write_manifest(corpus, "train", recs)
        work = str(tmp_path / "run")
        out = _cli("train", "--config", "2", "--set", "model.hidden_dim=16",
                   "--set", "model.num_bi_layers=1",
                   "--set", "data.batch_size=4",
                   "--set", "data.bucket_boundaries=(100,)",
                   "--set", "train.num_epochs=1", "--set", "train.log_every=1",
                   "--data", corpus, "--device", "cpu", "--work-dir", work)
        assert out.returncode == 0, out.stderr
        assert "'step': 2" in out.stdout
        assert os.listdir(os.path.join(work, "checkpoints")) == [
            "step_00000002.pt"]
