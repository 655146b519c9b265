"""The port's tensor parallelism ('model' axis) against the JAX package's,
on the CPU.

The port runs as 2 or 4 gloo processes (``test_torch_parallel.launch``);
the JAX side runs ``make_train_step`` in this process on the 8-device
virtual CPU mesh with the same npz weights and the same three global
batches (``test_torch_parallel``'s tiny configuration: H = 32, two
bidirectional layers, B = 8, T = 96, f32).  Meshes data x model = 1 x 2,
2 x 2 and 1 x 4: losses and gradient norms over the 3 steps within rtol
1e-4 (the norm is the clip's global norm, live at 5, so a gradient summed
over the wrong ranks shows), the gathered parameters and trace within
rtol 1e-4, atol 1e-5, the replicated parameters bit-equal across ranks.
Beside them: ``param_partition_specs`` spec for spec, ``validate_tp``'s
errors in the JAX package's words, the collectives' gloo forms against
their definitions, the eval under TP against the one-card eval, and the
checkpoints across meshes: a TP 2 checkpoint restores in one process bit
for bit, a one-card (DP) checkpoint restores under TP 2 and steps.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpu_ctc import config as jax_config
from tpu_ctc.models import birnn as jax_birnn
from tpu_ctc.parallel import mesh as jax_mesh
from tpu_ctc.parallel import tensor_parallel as jax_tp
from tpu_ctc.train import step as jax_step
from tpu_ctc_torch import config
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.parallel import mesh as mesh_lib
from tpu_ctc_torch.parallel import tensor_parallel as tp
from tpu_ctc_torch.train import checkpoint, step

from test_torch_parallel import (STEPS, _flat, build, launch,  # noqa: E402
                                 tiny_fields, write_inputs)

torch.set_num_threads(2)

WORKER = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from tpu_ctc_torch import config as C
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
from tpu_ctc_torch.train import checkpoint, step

coord, rank, world, work, fields = sys.argv[1:6]
rank, world, f = int(rank), int(world), json.loads(fields)
distributed.initialize(coord, world, rank, device="cpu")
cfg = C.Config(model=C.ModelConfig(**f["model"]),
               optim=C.OptimConfig(**f["optim"]),
               data=C.DataConfig(**f["data"]),
               mesh=C.MeshConfig(**f["mesh"]),
               train=C.TrainConfig(**f["train"]))
mesh = mesh_lib.make_mesh(cfg.mesh)
data = np.load(work + "/batches.npz")
def arrays(i):
    return {k: data[f"{i}/{k}"] for k in step.BATCH_KEYS}

if f.get("restore"):     # a one-card checkpoint restored under this mesh
    state = step.create_train_state(cfg, device="cpu")
    checkpoint.restore(work + "/one_ckpt", state)
    step_fn, state = step.make_train_step(cfg, mesh, state)
    whole = step.full_state(state)
    out = {k: p.detach().numpy() for k, p in whole.model.named_parameters()}
    out.update({"trace/" + k: v.numpy()
                for k, v in whole.opt_state.trace.items()})
    state, m = step_fn(state, step.batch_to_tensors(
        step.local_batch(arrays(0), mesh), "cpu"))
    out["loss"] = np.array(float(m["loss"]))
    np.savez(f"{work}/restored_{rank}.npz", **out)
else:
    state = step.create_train_state(cfg, device="cpu")
    checkpoint.load_npz(state.model, work + "/w.npz")
    step_fn, state = step.make_train_step(cfg, mesh, state)
    assert step_fn.keywords["reduce_grads"] is not step._all_reduce_grads
    losses, norms = [], []
    for i in range(%d):
        state, m = step_fn(state, step.batch_to_tensors(
            step.local_batch(arrays(i), mesh), "cpu"))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    whole = step.full_state(state)
    out = {"losses": np.array(losses), "norms": np.array(norms)}
    out.update({k: p.detach().numpy()
                for k, p in whole.model.named_parameters()})
    out.update({"trace/" + k: v.numpy()
                for k, v in whole.opt_state.trace.items()})
    out.update({"own/" + k: p.detach().numpy()
                for k, p in state.model.named_parameters()})
    ev = step.make_eval_step(cfg, mesh)(state.model, step.batch_to_tensors(
        arrays(0), "cpu"))
    out.update({"eval/" + k: v.numpy() for k, v in ev.items()})
    np.savez(f"{work}/out_{rank}.npz", **out)
    if rank == 0:
        checkpoint.save(work + "/ckpt", whole, epoch=2, batch_cursor=5)
torch.distributed.barrier()
print(f"OK rank {rank}", flush=True)
""" % STEPS

CASES = {"tp2": (1, 2), "dp2xtp2": (2, 2), "tp4": (1, 4)}   # (data, model)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The npz inputs of ``test_torch_parallel`` and each case's JAX
    losses, gradient norms and parameters (JAX's seeded weights are the
    npz's)."""
    work = tmp_path_factory.mktemp("tp")
    batches = write_inputs(work)
    refs = {}
    for name, (nd, nm) in CASES.items():
        cfg = build(jax_config, tiny_fields(nd, 1, model=nm))
        mesh = jax_mesh.make_mesh(cfg.mesh, devices=jax.devices()[:nd * nm])
        step_fn, state = jax_step.make_train_step(
            cfg, mesh, jax_step.create_train_state(cfg))
        losses, norms = [], []
        with mesh:
            for bd in batches:
                state, m = step_fn(state, bd)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        refs[name] = (np.array(losses), np.array(norms),
                      _flat(state.params))
    return work, refs


def _run(tmp_path, src, fields, n):
    for f in ("w.npz", "batches.npz"):
        os.symlink(src / f, tmp_path / f)
    launch(WORKER, n, str(tmp_path), json.dumps(fields))
    return [np.load(tmp_path / f"out_{r}.npz") for r in range(n)]


class TestTensorParallelSteps:
    @pytest.mark.parametrize("name", list(CASES))
    def test_matches_jax_on_the_same_mesh(self, inputs, tmp_path, name):
        src, refs = inputs
        nd, nm = CASES[name]
        fields = tiny_fields(nd, 1, model=nm)
        outs = _run(tmp_path, src, fields, nd * nm)
        losses, norms, params = refs[name]
        np.testing.assert_allclose(outs[0]["losses"], losses, rtol=1e-4)
        np.testing.assert_allclose(outs[0]["norms"], norms, rtol=1e-4)
        assert norms.min() > 5.0                 # the clip was live
        for k, want in params.items():
            np.testing.assert_allclose(outs[0][k], want, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        specs = birnn.param_partition_specs(build(config, fields).model)
        for out in outs[1:]:
            for k in outs[0].files:              # the gathered state
                if not k.startswith("own/"):
                    assert np.array_equal(out[k], outs[0][k]), k
            for k, spec in specs.items():        # replicated, bit for bit
                if step.sharded_dim(spec) is None:
                    assert np.array_equal(out["own/" + k],
                                          outs[0]["own/" + k]), k
        self._eval_matches_one_card(fields, src, outs[0])
        if name == "tp2":
            self._restores_in_one_process(tmp_path, fields, outs[0])
            self._one_card_checkpoint_restores_under_tp(tmp_path, fields)

    @staticmethod
    def _eval_matches_one_card(fields, src, out):
        """The eval under TP (tp_forward, the logits gathered) gives the
        one-card eval's hypotheses, and its NLL within 1e-4."""
        cfg = build(config, dict(fields, mesh=dict(data=1, model=1, seq=1)))
        model = birnn.BiRNN(cfg.model, device="cpu")
        for k, p in model.named_parameters():
            step._set_param(model, k, torch.from_numpy(out[k].copy()))
        data = np.load(src / "batches.npz")
        batch = step.batch_to_tensors(
            {k: data[f"0/{k}"] for k in step.BATCH_KEYS}, "cpu")
        want = step.eval_step(model, cfg, batch)
        assert np.array_equal(out["eval/hyp_len"], want["hyp_len"].numpy())
        for b, n in enumerate(want["hyp_len"].numpy()):
            assert np.array_equal(out["eval/hyp"][b, :n],
                                  want["hyp"][b, :n].numpy())
        np.testing.assert_allclose(out["eval/nll"], want["nll"].numpy(),
                                   rtol=1e-4)

    @staticmethod
    def _restores_in_one_process(work, fields, out):
        """The checkpoint written under model = 2 is the one-card file: it
        restores into a one-process state bit for bit."""
        cfg = build(config, dict(fields, mesh=dict(data=1, model=1, seq=1)))
        state = step.create_train_state(cfg, device="cpu")
        state, epoch, cursor = checkpoint.restore(str(work / "ckpt"), state)
        assert (epoch, cursor, state.step, state.opt_state.count) == (
            2, 5, STEPS, STEPS)
        for k, p in state.model.named_parameters():
            assert np.array_equal(p.detach().numpy(), out[k]), k
        for k, v in state.opt_state.trace.items():
            assert np.array_equal(v.numpy(), out["trace/" + k]), k

    @staticmethod
    def _one_card_checkpoint_restores_under_tp(work, fields):
        """A one-card checkpoint (a DP run writes the same file) restores
        under model = 2: the shards gathered again are the file's
        tensors, and a TP step from it has a finite loss."""
        cfg = build(config, dict(fields, mesh=dict(data=1, model=1, seq=1)))
        state = step.create_train_state(cfg, device="cpu")
        checkpoint.load_npz(state.model, str(work / "w.npz"))
        data = np.load(work / "batches.npz")
        state, _ = step.train_step(state, step.batch_to_tensors(
            {k: data[f"0/{k}"] for k in step.BATCH_KEYS}, "cpu"), cfg)
        checkpoint.save(str(work / "one_ckpt"), state, epoch=1,
                        batch_cursor=1)
        launch(WORKER, 2, str(work), json.dumps(dict(fields, restore=True)))
        for r in range(2):
            got = np.load(work / f"restored_{r}.npz")
            for k, p in state.model.named_parameters():
                assert np.array_equal(got[k], p.detach().numpy()), k
            for k, v in state.opt_state.trace.items():
                assert np.array_equal(got["trace/" + k], v.numpy()), k
            assert np.isfinite(got["loss"])


class TestSpecsAndValidation:
    def test_partition_specs_match_jax(self):
        """``param_partition_specs`` spec for spec against the JAX tree's
        (a ``PartitionSpec`` is the tuple of its axes)."""
        for kw in (dict(num_pre_layers=2, num_bi_layers=3,
                        num_post_layers=1), dict(num_pre_layers=1)):
            jcfg = jax_config.ModelConfig(**kw)
            want = jax_birnn.param_partition_specs(jcfg)
            leaves = jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, P))[0]
            want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in kp): tuple(spec)
                    for kp, spec in leaves}
            got = birnn.param_partition_specs(config.ModelConfig(**kw))
            assert got == want
            names = {k for k, _ in birnn.BiRNN(config.ModelConfig(**kw),
                                               device="cpu")
                     .named_parameters()}
            assert set(got) == names

    @pytest.mark.parametrize("shape,model_kw,batch,match", [
        ((1, 3, 1), {}, 6, "hidden_dim % model axis"),
        ((2, 2, 1), {}, 6, r"\(batch_size / data axis\) divisible"),
        ((1, 2, 1), dict(num_pre_layers=0), 8, "num_pre_layers >= 1"),
        ((2, 2, 1), {}, 8, None)])
    def test_validate_tp_in_jax_words(self, shape, model_kw, batch, match):
        """Both packages' ``validate_tp`` raise the same words on the same
        configuration, and pass the same ones."""
        fields = tiny_fields(shape[0], 1, model=shape[1])
        fields["model"].update(model_kw)
        fields["data"]["batch_size"] = batch
        jmesh = jax.sharding.Mesh(
            np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
            jax_mesh.MESH_AXES)
        mesh = mesh_lib.Mesh(dict(zip(mesh_lib.MESH_AXES, shape)))
        for fn, cfg, m in ((jax_tp.validate_tp, build(jax_config, fields),
                            jmesh),
                           (tp.validate_tp, build(config, fields), mesh)):
            if match is None:
                fn(cfg, m)
            else:
                with pytest.raises(ValueError, match=match):
                    fn(cfg, m)


COLLECTIVES = """
import sys
import torch, torch.distributed as dist
from tpu_ctc_torch.config import MeshConfig
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
from tpu_ctc_torch.parallel import tensor_parallel as tp

coord, rank, n = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
distributed.initialize(coord, n, rank, device="cpu")
mesh = mesh_lib.make_mesh(MeshConfig(data=1, model=n, seq=1))
assert mesh.lines["model"] == tuple(range(n)) and "model" in mesh.groups
# rank r holds x_r = r + arange: the whole of each is known to every rank
xs = [float(r) + torch.arange(24 * n * n, dtype=torch.float32).reshape(
    4, 2 * n, 3 * n) for r in range(n)]
total = sum(xs)
for dim in (1, 2):
    per = total.shape[dim] // n
    got = tp.reduce_scatter(xs[rank], dim, mesh)
    assert torch.equal(got, total.narrow(dim, rank * per, per)), dim
    blocks = [x.narrow(dim, r * per, per) for r, x in enumerate(xs)]
    assert torch.equal(tp.all_gather(blocks[rank], dim, mesh),
                       torch.cat(blocks, dim))
# all-to-all batch-split -> H-split, and back
got = tp.all_to_all(xs[rank], 2, 1, mesh)
want = torch.cat([x.chunk(n, 2)[rank] for x in xs], 1)
assert torch.equal(got, want)
assert torch.equal(tp.all_to_all(got, 1, 2, mesh), xs[rank])
# the Functions' backwards are the transposes
x = xs[rank].clone().requires_grad_()
y = tp.ReduceScatter.apply(x, 1, mesh)
(g,) = torch.autograd.grad((y * (rank + 1)).sum(), x)
per = x.shape[1] // n
want = torch.cat([torch.full_like(x.narrow(1, 0, per), float(r + 1))
                  for r in range(n)], 1)
assert torch.equal(g, want)
dist.barrier()
dist.destroy_process_group()
print(f"OK process {rank}", flush=True)
"""


def test_collectives_on_gloo():
    """``reduce_scatter``, ``all_gather`` and ``all_to_all`` over a 'model'
    line of 4 gloo ranks against their definitions, exactly, and
    ``ReduceScatter``'s backward (an all-gather of the cotangent)."""
    outs = launch(COLLECTIVES, 4)
    assert all(f"OK process {r}" in o for r, o in enumerate(outs))
