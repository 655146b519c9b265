"""The port's collective decode against the JAX package's, on the CPU.

The JAX side runs ``tpu_ctc.decode.collective.make_collective_decoder`` in
this process on 1 and 2 devices of the virtual CPU mesh; the port runs in
this process (one rank) and as 2 gloo processes
(``test_torch_parallel.launch``), from the same weights (JAX's
``init_params`` through the npz bridge), the same batch (adversarial
lengths: the long utterances first, so the deal moves them) and the same
trigram.  Hypotheses and lengths must be equal, with and without the
length-balancing redistribution, and in greedy mode.  Beside them:
``snake_assignment`` equal to JAX's permutation on ragged lengths with
ties, and the same ``ValueError`` for a batch the shards do not divide.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ctc import config as jax_config
from tpu_ctc.data.bucketing import make_batch
from tpu_ctc.decode import collective as jax_collective
from tpu_ctc.decode import lm as jax_lm
from tpu_ctc.models import birnn as jax_birnn
from tpu_ctc.parallel import mesh as jax_mesh
from tpu_ctc.train import checkpoint as jax_ckpt
from tpu_ctc.train.loop import batch_to_device_dict
from tpu_ctc_torch import config
from tpu_ctc_torch.decode import collective, lm
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.parallel import mesh as mesh_lib
from tpu_ctc_torch.train import checkpoint

from test_torch_parallel import launch  # noqa: E402

torch.set_num_threads(2)

MODEL = dict(input_dim=10, hidden_dim=16, num_pre_layers=1, num_bi_layers=1,
             vocab_size=6, compute_dtype="float32")
DECODE = dict(beam_width=8)
LABELS = [np.array([1, 2, 3, 4]), np.array([2, 3, 1]), np.array([5, 1, 2])]
MODES = {"beam": (True, False), "beam_redist": (True, True),
         "greedy": (False, False)}       # name: (use_beam, redistribute)


def cfg_of(pkg, data):
    return pkg.Config(model=pkg.ModelConfig(**MODEL),
                      decode=pkg.DecodeConfig(**DECODE),
                      data=pkg.DataConfig(batch_size=8, max_frames=24,
                                          bucket_boundaries=(24,)),
                      mesh=pkg.MeshConfig(data=data, model=1, seq=1))


WORKER = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from tpu_ctc_torch import config as C
from tpu_ctc_torch.decode import collective, lm
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
from tpu_ctc_torch.train import checkpoint

coord, rank, world, work, spec = sys.argv[1:6]
rank, world, spec = int(rank), int(world), json.loads(spec)
distributed.initialize(coord, world, rank, device="cpu")
cfg = C.Config(model=C.ModelConfig(**spec["model"]),
               decode=C.DecodeConfig(**spec["decode"]),
               mesh=C.MeshConfig(data=world, model=1, seq=1))
mesh = mesh_lib.make_mesh(cfg.mesh)
model = checkpoint.load_npz(birnn.BiRNN(cfg.model, device="cpu"),
                            work + "/w.npz")
tri = lm.train_ngram_lm([np.array(x) for x in spec["labels"]], 6, order=3)
batch = dict(np.load(work + "/batch.npz"))
out = {}
for name, (use_beam, redist) in spec["modes"].items():
    dec = collective.make_collective_decoder(
        cfg, mesh, lm=tri, use_beam=use_beam, max_len=24,
        redistribute=redist, device="cpu")
    hyps, lens = dec(model, batch)
    out[name + "/hyps"], out[name + "/lens"] = hyps.numpy(), lens.numpy()
np.savez(f"{work}/out_{rank}.npz", **out)
torch.distributed.barrier()
print(f"OK rank {rank}", flush=True)
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Weights, batch and each mode's JAX hypotheses at 1 and 2 devices."""
    work = tmp_path_factory.mktemp("collective")
    rng = np.random.RandomState(3)
    utts = [(rng.randn(n, 10).astype(np.float32),
             rng.randint(1, 6, 3).astype(np.int32))
            for n in (24, 24, 23, 22, 10, 12, 10, 11)]
    bd = batch_to_device_dict(make_batch(utts, t_pad=24, l_pad=6,
                                         batch_size=8))
    np.savez(work / "batch.npz", **bd)
    params = jax_birnn.init_params(jax.random.PRNGKey(0),
                                   cfg_of(jax_config, 1).model)
    jax_ckpt.export_npz(str(work / "w.npz"), params)
    tri = jax_lm.train_ngram_lm(LABELS, vocab_size=6, order=3)
    refs = {}
    for n in (1, 2):
        jcfg = cfg_of(jax_config, n)
        mesh = jax_mesh.make_mesh(jcfg.mesh, devices=jax.devices()[:n])
        for name, (use_beam, redist) in MODES.items():
            with mesh:
                h, ln = jax_collective.make_collective_decoder(
                    jcfg, mesh, lm=tri, use_beam=use_beam, max_len=24,
                    redistribute=redist)(params, bd)
            refs[n, name] = (np.asarray(h), np.asarray(ln))
    return work, bd, refs


def _assert_same(got_h, got_l, want_h, want_l):
    assert np.array_equal(np.asarray(got_l), want_l)
    assert np.array_equal(np.asarray(got_h), want_h)


@pytest.mark.parametrize("name", list(MODES))
def test_one_rank_matches_jax(setup, name):
    work, bd, refs = setup
    cfg = cfg_of(config, 1)
    model = checkpoint.load_npz(birnn.BiRNN(cfg.model, device="cpu"),
                                str(work / "w.npz"))
    mesh = mesh_lib.make_mesh(cfg.mesh)
    use_beam, redist = MODES[name]
    h, ln = collective.make_collective_decoder(
        cfg, mesh, lm=lm.train_ngram_lm(LABELS, 6, order=3),
        use_beam=use_beam, max_len=24, redistribute=redist,
        device="cpu")(model, bd)
    _assert_same(h, ln, *refs[1, name])


def test_two_ranks_match_jax(setup, tmp_path):
    """Two gloo ranks, each mode: every rank returns every hypothesis,
    equal to JAX's on 2 devices (and to the one-device decode: the
    redistribution is invisible in the results)."""
    work, _, refs = setup
    for f in ("w.npz", "batch.npz"):
        os.symlink(work / f, tmp_path / f)
    spec = dict(model=MODEL, decode=DECODE, modes=MODES,
                labels=[x.tolist() for x in LABELS])
    launch(WORKER, 2, str(tmp_path), json.dumps(spec))
    outs = [np.load(tmp_path / f"out_{r}.npz") for r in range(2)]
    for name in MODES:
        for out in outs:
            _assert_same(out[name + "/hyps"], out[name + "/lens"],
                         *refs[2, name])
        if name != "greedy":
            _assert_same(outs[0][name + "/hyps"], outs[0][name + "/lens"],
                         *refs[1, name])


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_snake_assignment_matches_jax(n):
    rng = np.random.RandomState(n)
    lens = rng.randint(5, 40, size=8 * 3).astype(np.int32)
    lens[:6] = 17                                 # ties keep index order
    want = np.asarray(jax_collective.snake_assignment(jnp.asarray(lens), n))
    got = collective.snake_assignment(lens, n).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert sorted(got.tolist()) == list(range(len(lens)))


def test_snake_assignment_refuses_a_ragged_batch():
    lens = np.arange(10, dtype=np.int32)
    for fn in (lambda: jax_collective.snake_assignment(jnp.asarray(lens), 4),
               lambda: collective.snake_assignment(lens, 4)):
        with pytest.raises(ValueError,
                           match="batch 10 not divisible by 4 shards"):
            fn()


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_over_gloo_ranks(n):
    """``python -m tpu_ctc_torch.dryrun`` under torchrun over n gloo ranks:
    the DP, DP x TP, DP x SP (4 ranks) and DP x PP steps with finite
    losses, then the collective decode, one line each on rank 0."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", "tpu_ctc_torch.dryrun",
         "--device", "cpu"], capture_output=True, text=True, cwd=repo,
        env=env, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr[-4000:]
    lines = [x for x in res.stdout.splitlines()
             if x.startswith(f"dryrun_multichip({n}):")]
    meshes = [("'data': 4, 'model': 1, 'seq': 1" if n == 4 else
               "'data': 2, 'model': 1, 'seq': 1"),
              ("'data': 2, 'model': 2, 'seq': 1" if n == 4 else
               "'data': 1, 'model': 2, 'seq': 1")]
    assert len(lines) == (5 if n == 4 else 4), res.stdout
    assert all(x.endswith(" ok") for x in lines)
    assert meshes[0] in lines[0] and meshes[1] in lines[1]
    assert "collective decode" in lines[-1] and f"hyps=({2 * n}," in lines[-1]
