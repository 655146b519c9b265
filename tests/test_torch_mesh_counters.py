"""The mesh step's collectives counted beside the kernels in
``ops.kernels()``, on the CPU.

Two gloo ranks take eager DP steps of preset 3's shape (2 dense and 5
bidirectional layers, input 120, vocab 29, bf16 products) at H = 128,
B = 4 and 40 frames: each step makes one flat all-reduce of the
gradients (``nccl_grad_sum``), whose buffer holds every parameter, and
one all-reduce for each of the loss's three sums (``nccl_loss_sum``),
all in the forward: the sum's backward is the identity and makes none.
A one-rank step counts neither, and a compiled step's replay adds what
its capture counted (a stub graph: no card here).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_ctc_torch import config
from tpu_ctc_torch.ops import kernels
from tpu_ctc_torch.parallel import mesh as mesh_lib
from tpu_ctc_torch.train import graphs, step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
SMALL = {"model.hidden_dim": 128, "data.batch_size": 4,
         "data.bucket_boundaries": (20, 40, 80), "data.max_frames": 80}
COLLECTIVES = ("nccl_grad_sum", "nccl_loss_sum")


def batch(seed, rows=4, t=40):
    r = np.random.RandomState(seed)
    lens = r.randint(t // 2, t + 1, rows).astype(np.int32)
    ll = r.randint(1, 8, rows).astype(np.int32)
    labels = np.zeros((rows, 32), np.int32)
    for i, n in enumerate(ll):
        labels[i, :n] = r.randint(1, 29, n)
    return {"feats": r.randn(rows, t, 120).astype(np.float32),
            "frame_mask": (np.arange(t)[None] < lens[:, None]).astype(
                np.float32),
            "frame_lengths": lens, "labels": labels, "label_lengths": ll,
            "weights": np.ones(rows, np.float32)}


def counts():
    return {k.name: k.launches for k in kernels()}


def delta(before):
    return {k: n - before[k] for k, n in counts().items() if n != before[k]}


DP_WORKER = """
import json, sys
import torch
import torch.distributed as dist
from tpu_ctc_torch import config
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
from tpu_ctc_torch.train import step
from tests.test_torch_mesh_counters import SMALL, STEPS, batch, counts, delta

coord, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
distributed.initialize(coord, 2, rank, device="cpu")
cfg = config.get_config("3", **SMALL, **{"mesh.data": 2})
mesh = mesh_lib.make_mesh(cfg.mesh)
state = step.create_train_state(cfg, device="cpu")
fn, state = step.make_train_step(cfg, mesh, state)
sizes = []
all_reduce = dist.all_reduce


def spy(t, *a, **kw):
    sizes.append(t.numel())
    return all_reduce(t, *a, **kw)


dist.all_reduce = spy
rec = {"eager": fn is getattr(fn, "eager", fn), "steps": [],
       "params": sum(p.numel() for p in state.model.parameters())}
for i in range(STEPS):
    tensors = step.batch_to_tensors(batch(i), "cpu", mesh)
    before, sizes[:] = counts(), []
    state, m = fn(state, tensors)
    rec["steps"].append({"launches": delta(before), "sizes": list(sizes)})
# the loss alone: its forward makes the sums, its backward none
loss_fn = step.make_dp_loss_fn(cfg, mesh)
before = counts()
with torch.enable_grad():
    loss, _ = loss_fn(state.model, tensors)
rec["forward"] = delta(before)
before = counts()
loss.backward()
rec["backward"] = delta(before)
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(rec, f)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """Each rank's record of STEPS eager DP2 steps on two gloo ranks."""
    out = tmp_path_factory.mktemp("dp2")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", DP_WORKER, coord, str(r), str(out)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o}\n{e[-4000:]}"
    return [json.load(open(out / f"rank{r}.json")) for r in range(2)]


def test_the_registry_lists_the_collectives_after_the_kernels():
    names = [k.name for k in kernels()]
    assert names[-2:] == list(COLLECTIVES)
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("rank", [0, 1])
def test_one_gradient_sum_a_step_over_every_parameter(dp2, rank):
    rec = dp2[rank]
    assert rec["eager"] and len(rec["steps"]) == STEPS
    for s in rec["steps"]:
        assert s["launches"]["nccl_grad_sum"] == 1
        # the three loss sums are scalars; the one flat buffer is the rest
        assert sorted(s["sizes"]) == [1, 1, 1, rec["params"]]


@pytest.mark.parametrize("rank", [0, 1])
def test_the_loss_sums_are_counted_where_they_are_made(dp2, rank):
    rec = dp2[rank]
    for s in rec["steps"]:
        assert s["launches"]["nccl_loss_sum"] == 3
    assert rec["forward"] == {"nccl_loss_sum": 3}
    assert "nccl_loss_sum" not in rec["backward"]
    assert "nccl_grad_sum" not in rec["forward"]


def test_a_one_rank_step_counts_neither():
    cfg = config.get_config("3", **SMALL, **{"mesh.data": 1})
    mesh = mesh_lib.make_mesh(cfg.mesh)
    state = step.create_train_state(cfg, device="cpu")
    fn, state = step.make_train_step(cfg, mesh, state)
    before = counts()
    fn(state, step.batch_to_tensors(batch(0), "cpu", mesh))
    assert not set(delta(before)) & set(COLLECTIVES)


class _StubGraph:
    def replay(self):
        pass


def test_a_replay_adds_the_collectives_its_capture_counted():
    """``Graph.run`` adds a capture's counts at every replay, the
    collectives' as the kernels'."""
    captured = [{"nccl_grad_sum": 1, "nccl_loss_sum": 3}.get(k.name, 0)
                for k in kernels()]
    b = {k: torch.as_tensor(v) for k, v in batch(0).items()}
    g = graphs.Graph(_StubGraph(), {k: torch.zeros_like(b[k])
                                    for k in step.BATCH_KEYS},
                     {"loss": torch.ones(())}, captured, 0.0)
    before = counts()
    for _ in range(3):
        g.run(b)
    assert delta(before) == {"nccl_grad_sum": 3, "nccl_loss_sum": 9}
