"""The port's pipeline parallelism (GPipe over 'model') against the JAX
package's, on the CPU.

The port runs as 2 or 4 gloo processes (``test_torch_parallel.launch``);
the JAX side runs ``make_train_step`` with ``mesh.pipeline`` in this
process on the virtual CPU mesh.  ``test_torch_parallel``'s tiny
configuration (H = 32, two bidirectional layers, B = 8, T = 96, f32) as 2
stages of one layer each with M = 2 microbatches, at data x model = 1 x 2
and 2 x 2: losses and gradient norms over the 3 steps within rtol 1e-4,
the gathered (stacked) parameters within rtol 1e-4, atol 1e-5 of JAX's
stacked tree, the replicated parameters bit-equal across ranks, and the
eval under PP against the one-card eval of the same weights.  The port's
weights come from the JAX npz through ``stack_bi_params``, and
``stack_bi_params``/``unstack_bi_params`` round-trip as
``tests/test_pipeline.py`` holds JAX's.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from tpu_ctc import config as jax_config
from tpu_ctc.parallel import mesh as jax_mesh
from tpu_ctc.parallel import pipeline as jax_pipeline
from tpu_ctc.train import step as jax_step
from tpu_ctc_torch import config
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.parallel import pipeline
from tpu_ctc_torch.train import step

from test_torch_parallel import (STEPS, _flat, build, launch,  # noqa: E402
                                 tiny_fields, write_inputs)

torch.set_num_threads(2)

WORKER = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from tpu_ctc_torch import config as C
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib, pipeline
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
state = step.create_train_state(cfg, device="cpu")
with np.load(work + "/w.npz") as w:       # the JAX export, stacked
    stacked = pipeline.stack_bi_params({k: w[k] for k in w.files})
state.model.load_state_dict(checkpoint.params_from_jax(stacked))
step_fn, state = step.make_train_step(cfg, mesh, state)
data = np.load(work + "/batches.npz")
def arrays(i):
    return {k: data[f"{i}/{k}"] for k in step.BATCH_KEYS}
losses, norms = [], []
for i in range(%d):
    state, m = step_fn(state, step.batch_to_tensors(
        step.local_batch(arrays(i), mesh), "cpu"))
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
whole = step.full_state(state)
out = {"losses": np.array(losses), "norms": np.array(norms)}
out.update({k: p.detach().numpy() for k, p in whole.model.named_parameters()})
out.update({"own/" + k: p.detach().numpy()
            for k, p in state.model.named_parameters()})
ev = step.make_eval_step(cfg, mesh)(state.model, step.batch_to_tensors(
    arrays(0), "cpu"))
out.update({"eval/" + k: v.numpy() for k, v in ev.items()})
np.savez(f"{work}/out_{rank}.npz", **out)
torch.distributed.barrier()
print(f"OK rank {rank}", flush=True)
""" % STEPS

CASES = {"pp2": (1, 2), "dp2xpp2": (2, 2)}          # (data, stages)


def pp_fields(data, stages):
    return tiny_fields(data, 1, model=stages, pipeline=True,
                       pipeline_microbatches=2)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    work = tmp_path_factory.mktemp("pp")
    batches = write_inputs(work)
    refs = {}
    for name, (nd, ns) in CASES.items():
        cfg = build(jax_config, pp_fields(nd, ns))
        mesh = jax_mesh.make_mesh(cfg.mesh, devices=jax.devices()[:nd * ns])
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


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_pipeline(inputs, tmp_path, name):
    src, refs = inputs
    for f in ("w.npz", "batches.npz"):
        os.symlink(src / f, tmp_path / f)
    nd, ns = CASES[name]
    fields = pp_fields(nd, ns)
    launch(WORKER, nd * ns, str(tmp_path), json.dumps(fields))
    outs = [np.load(tmp_path / f"out_{r}.npz") for r in range(nd * ns)]
    losses, norms, params = refs[name]
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(outs[0]["norms"], norms, rtol=1e-4)
    assert norms.min() > 5.0                     # the clip was live
    assert set(params) == {k for k in outs[0].files
                           if "/" not in k and k not in ("losses", "norms")}
    for k, want in params.items():
        np.testing.assert_allclose(outs[0][k], want, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    specs = pipeline.pp_param_specs(build(config, fields).model)
    for out in outs[1:]:
        for k, spec in specs.items():            # replicated, bit for bit
            if not spec:
                assert np.array_equal(out["own/" + k], outs[0]["own/" + k]), k
        for k in ("eval/hyp", "eval/hyp_len", "eval/nll"):
            assert np.array_equal(out[k], outs[0][k]), k
    # the eval under PP against the one-card eval of the same weights
    cfg = build(config, tiny_fields(1, 1))
    model = birnn.BiRNN(cfg.model, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           pipeline.unstack_bi_params(
                               {k: outs[0][k] for k in params},
                               cfg.model.num_bi_layers).items()})
    data = np.load(src / "batches.npz")
    want = step.eval_step(model, cfg, step.batch_to_tensors(
        {k: data[f"0/{k}"] for k in step.BATCH_KEYS}, "cpu"))
    assert np.array_equal(outs[0]["eval/hyp_len"], want["hyp_len"].numpy())
    np.testing.assert_allclose(outs[0]["eval/nll"], want["nll"].numpy(),
                               rtol=1e-4)


def test_stack_unstack_roundtrip():
    """The port's flat ``stack_bi_params`` gives the JAX stacked tree's
    arrays by name, and ``unstack_bi_params`` gives the layers back (the
    counterpart of ``tests/test_pipeline.py::TestStacking``)."""
    jcfg = build(jax_config, tiny_fields(1, 1))
    params = jax.tree.map(np.asarray,
                          jax_step.create_train_state(jcfg).params)
    flat = _flat(params)
    stacked = pipeline.stack_bi_params(flat)
    want = _flat(jax_pipeline.stack_bi_params(params))
    assert set(stacked) == set(want)
    for k, v in want.items():
        assert np.array_equal(stacked[k], v), k
    assert stacked["bi.wf"].shape[0] == jcfg.model.num_bi_layers
    back = pipeline.unstack_bi_params(stacked, jcfg.model.num_bi_layers)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert np.array_equal(back[k], v), k
    # tensors, with '/' keys (an npz export), too
    t = {k.replace(".", "/"): torch.tensor(v) for k, v in flat.items()}
    assert torch.equal(pipeline.stack_bi_params(t)["bi/w"],
                       torch.tensor(want["bi.w"]))


def test_stacked_model_and_specs():
    """``create_train_state`` under ``mesh.pipeline`` stacks the layers
    (the JAX state's names), and ``pp_param_specs`` equals the JAX specs
    spec for spec."""
    from jax.sharding import PartitionSpec as P
    fields = pp_fields(1, 2)
    state = step.create_train_state(build(config, fields), device="cpu")
    names = [k for k, _ in state.model.named_parameters()]
    want = jax.tree_util.tree_flatten_with_path(
        jax_pipeline.pp_param_specs(build(jax_config, fields).model),
        is_leaf=lambda x: isinstance(x, P))[0]
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): tuple(spec) for kp, spec in want}
    assert pipeline.pp_param_specs(build(config, fields).model) == want
    assert sorted(names) == sorted(want)
    assert tuple(state.model.bi.wf.shape) == (2, 32, 32)


def test_microbatches_must_divide_the_local_batch():
    """The JAX loss's words for a local batch that M does not divide."""
    with pytest.raises(ValueError,
                       match="local batch 6 not divisible by 4 microbatches"):
        pipeline._check_micro(6, 4)
