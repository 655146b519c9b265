"""The port's mesh, process group and distributed train steps against the
JAX package, on the CPU.

The port runs as 2 or 4 gloo processes (one rank each, started as
``tests/test_distributed_multiproc.py`` starts its workers: ``python -c``
and a free port from a bound socket); the JAX side runs in this process on
the 8-device virtual CPU mesh (``tests/conftest.py``) with
``make_train_step`` as ``tests/test_seq_parallel.py`` calls it.  Both start
from the same weights (JAX's ``init_params`` through the npz bridge) and
take the same three global batches (an npz in ``tmp_path``), on the tiny
configuration of ``test_seq_parallel.py``: H = 32, two bidirectional
layers, B = 8, T = 96, f32.

Cases: DP (data 2 and 4), SP (seq 2 and 4), DP x SP (2 x 2), and SP with
``birnn_impl="pallas"`` on both sides (the JAX side's Pallas carry sweep in
interpret mode, the port's plain carry sweep on the CPU).  Losses and
gradient norms over the 3 steps agree within rtol 1e-4 and the parameters
within rtol 1e-4, atol 1e-5: the tolerances by which the JAX tests hold SP
and DP to one device (``test_seq_parallel.py:68-72``).  The gradient norm
is compared too because the clip at 5 hides a wrong gradient scale (a
factor n_seq) from the parameters.  After the steps the parameters are
bit-equal across ranks.  DP2 once more on batches from
``prefetch_to_device`` (the labels cut on the global batch), where
``make_train_step`` and ``make_eval_step`` stay eager on gloo ranks (no
CUDA graph over collectives that run through the host).  Beside them:
``resolve_mesh_shape`` (the cases of
``tests/test_sharding.py:61-73``), the step's configuration errors, a
two-process ``initialize`` with ``local_batch_slice`` and one all-reduce, a
checkpoint written under data = 2 and restored in one process, and ``cli
train`` under ``torch.distributed.run`` (torchrun) with DP and with SP
against the same command in one process, and DP from a WAV manifest.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpu_ctc import config as jax_config
from tpu_ctc.data.bucketing import BucketedLoader
from tpu_ctc.data.synthetic import SyntheticCorpus
from tpu_ctc.parallel import mesh as jax_mesh
from tpu_ctc.train import checkpoint as jax_ckpt
from tpu_ctc.train import step as jax_step
from tpu_ctc.train.loop import batch_to_device_dict
from tpu_ctc_torch import config
from tpu_ctc_torch.parallel import mesh as mesh_lib
from tpu_ctc_torch.train import checkpoint, step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def tiny_fields(data, seq, impl="auto", model=1, **mesh_kw):
    """The fields of ``test_seq_parallel.tiny_config`` (shared by both
    packages' ``Config``)."""
    return dict(
        model=dict(input_dim=12, hidden_dim=32, num_pre_layers=1,
                   num_bi_layers=2, vocab_size=29, compute_dtype="float32",
                   birnn_impl=impl),
        optim=dict(learning_rate=1e-2, momentum=0.9),
        data=dict(batch_size=8, max_frames=96, bucket_boundaries=(96,),
                  shuffle=False, seed=0, sortagrad=False),
        mesh=dict(data=data, model=model, seq=seq, **mesh_kw),
        train=dict(num_epochs=1, log_every=1, checkpoint_every=0,
                   eval_every=0, metrics_path=""))


def build(pkg, fields):
    return pkg.Config(
        model=pkg.ModelConfig(**fields["model"]),
        optim=pkg.OptimConfig(**fields["optim"]),
        data=pkg.DataConfig(**fields["data"]),
        mesh=pkg.MeshConfig(**fields["mesh"]),
        train=pkg.TrainConfig(**fields["train"]))


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
state = step.create_train_state(cfg, device="cpu")
checkpoint.load_npz(state.model, work + "/w.npz")
step_fn, state = step.make_train_step(cfg, mesh, state)
data = np.load(work + "/batches.npz")
losses, norms = [], []
for i in range(%d):
    arrays = {k: data[f"{i}/{k}"] for k in step.BATCH_KEYS}
    state, m = step_fn(state, step.batch_to_tensors(
        step.local_batch(arrays, mesh), "cpu"))
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
out = {"losses": np.array(losses), "norms": np.array(norms)}
out.update({k: p.detach().numpy() for k, p in state.model.named_parameters()})
out.update({"trace/" + k: v.numpy() for k, v in state.opt_state.trace.items()})
np.savez(f"{work}/out_{rank}.npz", **out)
if rank == 0:
    checkpoint.save(work + "/ckpt", state, epoch=2, batch_cursor=5)
torch.distributed.barrier()
print(f"OK rank {rank}", flush=True)
""" % STEPS

PREFETCH_WORKER = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from tpu_ctc_torch import config as C
from tpu_ctc_torch.data.bucketing import Batch
from tpu_ctc_torch.data.prefetch import prefetch_to_device
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
from tpu_ctc_torch.train import checkpoint, graphs, step

coord, rank, world, work, fields = sys.argv[1:6]
rank, world, f = int(rank), int(world), json.loads(fields)
distributed.initialize(coord, world, rank, device="cpu")
cfg = C.Config(model=C.ModelConfig(**f["model"]),
               optim=C.OptimConfig(**f["optim"]),
               data=C.DataConfig(**f["data"]),
               mesh=C.MeshConfig(**f["mesh"]),
               train=C.TrainConfig(**f["train"]))
mesh = mesh_lib.make_mesh(cfg.mesh)
for device in ("cpu", "cuda"):   # gloo stays eager, whatever the device
    assert "gloo" in step.eager_reason(cfg, mesh, device), device
state = step.create_train_state(cfg, device="cpu")
checkpoint.load_npz(state.model, work + "/w.npz")
step_fn, state = step.make_train_step(cfg, mesh, state)
assert step_fn.func is step.train_step, step_fn
eval_fn = step.make_eval_step(cfg, mesh, "cpu")
assert not isinstance(eval_fn, graphs.CompiledEvalStep), eval_fn
data = np.load(work + "/batches.npz")
batches = [(i, Batch(**{k: data[f"{i}/{k}"] for k in step.BATCH_KEYS}))
           for i in range(%d)]
losses, norms = [], []
for _, _, bt in prefetch_to_device(
        iter(batches), "cpu", select=lambda a: step.local_batch(a, mesh)):
    state, m = step_fn(state, bt)
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
out = {"losses": np.array(losses), "norms": np.array(norms)}
out.update({k: p.detach().numpy() for k, p in state.model.named_parameters()})
np.savez(f"{work}/out_{rank}.npz", **out)
torch.distributed.barrier()
print(f"OK rank {rank}", flush=True)
""" % STEPS

INIT_WORKER = """
import sys
import pytest, torch, torch.distributed as dist
from tpu_ctc_torch.config import MeshConfig
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib

coord, pid = sys.argv[1], int(sys.argv[2])
dev = distributed.initialize(coord, 2, pid, device="cpu")
assert dev == torch.device("cpu") and dist.get_world_size() == 2
assert distributed.initialize(coord, 2, pid, device="cpu") == dev  # again
mesh = distributed.hybrid_mesh(MeshConfig(data=-1, model=1, seq=1))
assert mesh.shape == {"data": 2, "model": 1, "seq": 1}, mesh.shape
assert mesh.axis_index("data") == pid and mesh.lines["data"] == (0, 1)
sl = distributed.local_batch_slice(8)
assert (sl.start, sl.stop) == (4 * pid, 4 * pid + 4), sl
x = torch.tensor([float(pid + 1)])
dist.all_reduce(x)
assert float(x) == 3.0, float(x)
distributed.assert_same_across_hosts(2.5, "same")
with pytest.raises(AssertionError, match="divergence"):
    distributed.assert_same_across_hosts(float(pid), "differs")
tp = mesh_lib.make_mesh(MeshConfig(data=1, model=2, seq=1))
assert tp.shape == {"data": 1, "model": 2, "seq": 1}, tp.shape
assert tp.lines["model"] == (0, 1) and tp.axis_index("model") == pid
assert set(tp.groups) == {"model"}
# leave together: a rank whose peer has gone can abort in gloo's teardown
dist.barrier()
dist.destroy_process_group()
print(f"OK process {pid}", flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(source, n, *args, timeout=180):
    """Run ``source`` as n processes (argv: coordinator, rank, n, args);
    raise with their output if any fails."""
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", source, coord, str(r), str(n), *args],
        cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}\n{err[-4000:]}"
    return [o for o, _ in outs]


def _flat(tree):
    """JAX param tree -> {'pre.0.w': array, ...} (the port's names)."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


CASES = {                       # name: (data, seq, birnn_impl)
    "dp2": (2, 1, "auto"), "dp4": (4, 1, "auto"),
    "sp2": (1, 2, "auto"), "sp4": (1, 4, "auto"),
    "dp2xsp2": (2, 2, "auto"), "sp2_pallas": (1, 2, "pallas"),
}


def write_inputs(work):
    """Write the npz inputs into ``work``: JAX's seeded weights
    (``w.npz``) and 3 global batches (``batches.npz``); returns the
    batches."""
    cfg1 = build(jax_config, tiny_fields(1, 1))
    corpus = SyntheticCorpus(num_utterances=24, feature_dim=12,
                             frames_per_char=7, min_chars=2, max_chars=8)
    batches = [batch_to_device_dict(b) for _, b in
               BucketedLoader(corpus.all_utterances(),
                              cfg1.data).epoch(0)][:STEPS]
    assert len(batches) == STEPS and batches[0]["feats"].shape == (8, 96, 12)
    np.savez(work / "batches.npz", **{f"{i}/{k}": v for i, b in
                                      enumerate(batches)
                                      for k, v in b.items()})
    jax_ckpt.export_npz(str(work / "w.npz"),
                        jax_step.create_train_state(cfg1).params)
    return batches


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The npz inputs (weights, 3 global batches) and each case's JAX
    losses, gradient norms and parameters, computed once."""
    work = tmp_path_factory.mktemp("mesh")
    batches = write_inputs(work)
    refs = {}
    for name, (data, seq, impl) in CASES.items():
        cfg = build(jax_config, tiny_fields(data, seq, impl))
        mesh = jax_mesh.make_mesh(cfg.mesh,
                                  devices=jax.devices()[:data * seq])
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


class TestDistributedSteps:
    @pytest.mark.parametrize("name", list(CASES))
    def test_matches_jax_on_the_same_mesh(self, inputs, tmp_path, name):
        src, refs = inputs
        for f in ("w.npz", "batches.npz"):
            os.symlink(src / f, tmp_path / f)
        data, seq, impl = CASES[name]
        launch(WORKER, data * seq, str(tmp_path),
               json.dumps(tiny_fields(data, seq, impl)))
        outs = [np.load(tmp_path / f"out_{r}.npz")
                for r in range(data * seq)]
        losses, norms, params = refs[name]
        np.testing.assert_allclose(outs[0]["losses"], losses, rtol=1e-4)
        np.testing.assert_allclose(outs[0]["norms"], norms, rtol=1e-4)
        assert norms.min() > 5.0                 # the clip was live
        for k, want in params.items():
            np.testing.assert_allclose(outs[0][k], want, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        for out in outs[1:]:                     # replicated, bit for bit
            for k in outs[0].files:
                assert np.array_equal(out[k], outs[0][k]), k
        if name == "dp2":
            self._restores_in_one_process(tmp_path, outs[0])

    @staticmethod
    def _restores_in_one_process(work, out):
        """The checkpoint written by rank 0 under data = 2 restores into a
        one-process state bit for bit: parameters, trace, count, step and
        the data cursor."""
        cfg = build(config, tiny_fields(1, 1))
        state = step.create_train_state(cfg, device="cpu")
        state, epoch, cursor = checkpoint.restore(str(work / "ckpt"), state)
        assert (epoch, cursor, state.step, state.opt_state.count) == (
            2, 5, STEPS, STEPS)
        for k, p in state.model.named_parameters():
            assert np.array_equal(p.detach().numpy(), out[k]), k
        for k, v in state.opt_state.trace.items():
            assert np.array_equal(v.numpy(), out["trace/" + k]), k

    def test_dp2_from_the_prefetch_path_stays_eager(self, inputs, tmp_path):
        """Two gloo ranks on the CPU: ``make_train_step`` and
        ``make_eval_step`` return the eager steps (``eager_reason`` names
        gloo, on either device: its collectives run through the host),
        and DP2 steps on batches from ``prefetch_to_device`` (the labels
        cut on the global batch, then the rank's block) agree with JAX's
        DP step within the tolerances above, bit-equal across ranks."""
        src, refs = inputs
        for f in ("w.npz", "batches.npz"):
            os.symlink(src / f, tmp_path / f)
        launch(PREFETCH_WORKER, 2, str(tmp_path),
               json.dumps(tiny_fields(2, 1)))
        outs = [np.load(tmp_path / f"out_{r}.npz") for r in range(2)]
        losses, norms, params = refs["dp2"]
        np.testing.assert_allclose(outs[0]["losses"], losses, rtol=1e-4)
        np.testing.assert_allclose(outs[0]["norms"], norms, rtol=1e-4)
        for k, want in params.items():
            np.testing.assert_allclose(outs[0][k], want, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        for k in outs[0].files:
            assert np.array_equal(outs[1][k], outs[0][k]), k

    def test_two_process_initialize(self):
        outs = launch(INIT_WORKER, 2)
        assert [f"OK process {i}" in o for i, o in enumerate(outs)] == [
            True, True]


class TestMesh:
    @pytest.mark.parametrize("mesh,n,want", [
        (dict(data=-1, model=2, seq=1), 8, (4, 2, 1)),
        (dict(data=3, model=2, seq=1), 8, ValueError),
        (dict(data=-1, model=1, seq=4), 8, (2, 1, 4)),
        (dict(data=-1, model=-1, seq=1), 8, ValueError),
        (dict(data=-1, model=3, seq=1), 8, ValueError)])
    def test_resolve_mesh_shape(self, mesh, n, want):
        """The cases of ``tests/test_sharding.py:61-73``, and both
        packages' answers on each."""
        for pkg, lib in ((jax_config, jax_mesh), (config, mesh_lib)):
            cfg = pkg.MeshConfig(**mesh)
            if want is ValueError:
                with pytest.raises(ValueError):
                    lib.resolve_mesh_shape(cfg, n)
            else:
                assert lib.resolve_mesh_shape(cfg, n) == want

    def test_one_process_mesh(self):
        mesh = mesh_lib.make_mesh(config.MeshConfig(data=-1, model=1, seq=1))
        assert tuple(mesh.shape) == mesh_lib.MESH_AXES
        assert mesh.shape == {"data": 1, "model": 1, "seq": 1}
        assert mesh.size == 1 and mesh.axis_index("seq") == 0
        assert mesh.groups == {}

    def test_shard_batch_blocks(self):
        mesh = mesh_lib.Mesh({"data": 2, "model": 1, "seq": 2}, rank=3,
                             lines={"data": (1, 3), "seq": (2, 3)})
        x = np.arange(4 * 6 * 2).reshape(4, 6, 2)
        got = mesh_lib.shard_batch(mesh, {"x": x, "y": x[:, 0, 0]},
                                   {"x": ("data", "seq", None),
                                    "y": ("data",)})
        assert np.array_equal(got["x"], x[2:, 3:])
        assert np.array_equal(got["y"], x[2:, 0, 0])
        with pytest.raises(ValueError, match="does not split"):
            mesh_lib.shard_batch(mesh, {"x": x[:, :5]},
                                 {"x": ("data", "seq")})


class TestStepValidation:
    """``make_train_step``'s configuration errors, with the JAX package's
    words, raised before anything runs (the meshes have no process group:
    a collective would fail): the compositions the JAX package refuses,
    and TP's and PP's own checks (TP and PP steps themselves run in
    ``test_torch_tensor_parallel.py`` and ``test_torch_pipeline.py``)."""

    @pytest.mark.parametrize("mesh_kw,shape,error,match", [
        (dict(model=2, seq=4), (1, 2, 4), ValueError, "PARITY.md"),
        (dict(model=2, seq=4, pipeline=True, pipeline_microbatches=2),
         (1, 2, 4), ValueError, "PARITY.md"),
        (dict(model=1, seq=1, pipeline=True), (2, 1, 1), ValueError,
         "requires model axis"),
        (dict(model=8, seq=1), (1, 8, 1), ValueError,
         r"\(batch_size / data axis\) divisible by the model axis"),
        # 2 layers over 4 stages: the port's check names the stages, the
        # JAX package's layer-axis sharding its divisor
        (dict(model=4, seq=1, pipeline=True), (2, 4, 1), ValueError,
         "divisible by 4")])
    def test_errors(self, mesh_kw, shape, error, match):
        fields = tiny_fields(shape[0], **mesh_kw)
        if mesh_kw["model"] == 8:        # 8 rows a rank: 1 row per shard
            fields["data"]["batch_size"] = 4
        mesh = mesh_lib.Mesh(dict(zip(mesh_lib.MESH_AXES, shape)))
        state = step.create_train_state(build(config, fields), device="cpu")
        before = [p.detach().clone() for p in state.model.parameters()]
        with pytest.raises(error, match=match):
            step.make_train_step(build(config, fields), mesh, state)
        assert all(torch.equal(a, b) for a, b in
                   zip(before, state.model.parameters()))
        if error is ValueError:      # the JAX package says the same
            jcfg = build(jax_config, fields)
            with pytest.raises(error, match=match):
                jax_step.make_train_step(
                    jcfg, jax_mesh.make_mesh(jcfg.mesh),
                    jax_step.create_train_state(jcfg))

    def test_model_axis_refused_by_make_mesh(self):
        """A 'model' axis that does not cover the ranks is refused, as
        ``resolve_mesh_shape`` refuses any axis (one process here)."""
        with pytest.raises(ValueError, match="does not cover 1 devices"):
            mesh_lib.make_mesh(config.MeshConfig(data=1, model=4, seq=1))


CLI_SET = ["--set", "model.hidden_dim=16", "--set", "model.num_bi_layers=1",
           "--set", "data.batch_size=4", "--set",
           "data.bucket_boundaries=(100,)", "--set", "train.num_epochs=1",
           "--set", "train.log_every=1", "--set", "train.eval_every=3",
           "--set", "model.compute_dtype=float32"]


def _cli_train(work, *extra, nproc=0, source=("--synthetic", "13")):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    run = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(nproc), "-m", "tpu_ctc_torch.cli"]
           if nproc else [sys.executable, "-m", "tpu_ctc_torch.cli"])
    res = subprocess.run(
        [*run, "train", "--config", "2", "--device", "cpu", *CLI_SET,
         *source, "--work-dir", str(work), *extra],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr[-4000:]
    return res.stdout


def _wav_corpus(root, n=13):
    """A manifest of ``n`` tone waveforms of 3-6 characters (<= 90
    frames: one bucket of 100), as ``--data`` reads it."""
    from tpu_ctc_torch.data import audio_io
    from tpu_ctc_torch.data.alphabet import DEFAULT_ALPHABET
    from tpu_ctc_torch.data.manifest import write_manifest
    from tpu_ctc_torch.data.synthetic import synthetic_audio_batch
    audio, sl, labels, ll = synthetic_audio_batch(
        n, 16000, min_chars=3, max_chars=6, seed=5, samples_per_char=2400)
    os.makedirs(root, exist_ok=True)
    recs = []
    for i in range(n):
        audio_io.write_wav(os.path.join(root, f"u{i:02d}.wav"),
                           audio[i, :sl[i]], 16000)
        recs.append({"id": f"u{i:02d}", "audio": f"u{i:02d}.wav",
                     "text": DEFAULT_ALPHABET.decode(labels[i, :ll[i]]),
                     "samples": int(sl[i]), "rate": 16000})
    write_manifest(root, "train", recs)
    return root


class TestCliUnderTorchrun:
    @pytest.mark.parametrize("mesh,data", [
        pytest.param("mesh.data=2", False, id="mesh.data=2"),
        pytest.param("mesh.seq=2", False, id="mesh.seq=2"),
        pytest.param("mesh.model=2", False, id="mesh.model=2"),
        pytest.param("mesh.data=2", True, id="mesh.data=2-from-audio")])
    def test_two_ranks_match_one_process(self, tmp_path, mesh, data):
        """``cli train`` under torchrun with 2 ranks (DP, or SP or TP with
        data = 1), from synthetic features or (DP) from a WAV manifest,
        where each rank featurizes only its rows: rank 0 alone prints and
        writes the metrics (3 steps, one eval) and the checkpoint, whose
        parameters agree with the same command in one process."""
        source = (("--data", _wav_corpus(str(tmp_path / "corpus"))) if data
                  else ("--synthetic", "13"))
        out = _cli_train(tmp_path / "ranks", "--set", mesh, nproc=2,
                         source=source)
        _cli_train(tmp_path / "one", source=source)
        assert out.count("final metrics:") == 1
        events = [json.loads(x) for x in open(
            tmp_path / "ranks" / "metrics.jsonl")]
        kinds = [e["kind"] for e in events]
        assert kinds.count("train") == 3 and kinds.count("eval") == 1
        cfg = config.get_config("2", **{"model.hidden_dim": 16,
                                        "model.num_bi_layers": 1})
        a, b = (checkpoint.restore(str(tmp_path / d / "checkpoints"),
                                   step.create_train_state(cfg, "cpu"))[0]
                for d in ("ranks", "one"))
        assert a.step == b.step == 3
        for (k, p), (_, q) in zip(a.model.named_parameters(),
                                  b.model.named_parameters()):
            np.testing.assert_allclose(p.detach().numpy(),
                                       q.detach().numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
