"""Multi-rank dry run: one step of every parallel layout, then the
collective decode, at tiny shapes.

Counterpart of ``__graft_entry__.dryrun_multichip``: over the N ranks of
the process group it runs, each at the JAX function's shapes (H = 64, two
bidirectional layers, B = 2 N, T = 32, f32), one train step of

  * DP ('data' = N),
  * DP x TP ('model' = 2 when N is even),
  * DP x SP ('seq' = 2 when 4 divides N),
  * DP x PP ('model' = 2 stages, 2 microbatches, when N is even),

asserting a finite loss, then the collective decode
(``decode.collective``) over 'data' with the length-balancing
redistribution, asserting a hypothesis for every utterance.  Rank 0 prints
one line a run.  Kernels B1-B5 run on a card; ``--device cpu`` runs the
plain versions on gloo ranks.

    torchrun --standalone --nproc-per-node 4 -m tpu_ctc_torch.dryrun
    torchrun --standalone --nproc-per-node 2 -m tpu_ctc_torch.dryrun \\
        --device cuda:0 --backend gloo         # two ranks on one card
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m tpu_ctc_torch.dryrun --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _batch(n_batch: int, t_pad: int, seed: int):
    from tpu_ctc_torch.data.bucketing import make_batch
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    rng = np.random.RandomState(seed)
    utts = [(rng.randn(rng.randint(8, t_pad), 16).astype(np.float32),
             rng.randint(1, 29, 3).astype(np.int32))
            for _ in range(n_batch)]
    return batch_to_device_dict(make_batch(utts, t_pad=t_pad, l_pad=8,
                                           batch_size=n_batch))


def dryrun_multichip(n: int, dev, log=print) -> None:
    """The dry run over the process group's n ranks on ``dev``."""
    from tpu_ctc_torch.config import (Config, DataConfig, MeshConfig,
                                      ModelConfig, OptimConfig, TrainConfig)
    from tpu_ctc_torch.decode.collective import make_collective_decoder
    from tpu_ctc_torch.models import birnn
    from tpu_ctc_torch.parallel.mesh import make_mesh
    from tpu_ctc_torch.train.step import (batch_to_tensors,
                                          create_train_state, make_train_step)

    model_axis = 2 if n % 2 == 0 and n >= 2 else 1
    seq_axis = 2 if n % 4 == 0 and n >= 4 else 1

    def one_step(mesh_cfg, t_pad):
        cfg = Config(
            model=ModelConfig(input_dim=16, hidden_dim=64, num_pre_layers=1,
                              num_bi_layers=2, vocab_size=29,
                              compute_dtype="float32"),
            optim=OptimConfig(learning_rate=1e-2),
            data=DataConfig(batch_size=2 * n, max_frames=t_pad,
                            bucket_boundaries=(t_pad,)),
            mesh=mesh_cfg,
            train=TrainConfig(num_epochs=1, metrics_path=""))
        mesh = make_mesh(cfg.mesh)
        assert mesh.size == n, mesh.shape
        state = create_train_state(cfg, device=dev)
        step_fn, state = make_train_step(cfg, mesh, state)
        batch = batch_to_tensors(_batch(cfg.data.batch_size, t_pad, 0),
                                 dev, mesh)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        assert np.isfinite(loss), f"non-finite loss {loss} ({mesh_cfg})"
        log(f"dryrun_multichip({n}): mesh={mesh.shape} loss={loss:.3f} ok")

    def one_decode(t_pad):
        cfg = Config(
            model=ModelConfig(input_dim=16, hidden_dim=64, num_pre_layers=1,
                              num_bi_layers=1, vocab_size=29,
                              compute_dtype="float32"),
            data=DataConfig(batch_size=2 * n, max_frames=t_pad,
                            bucket_boundaries=(t_pad,)),
            mesh=MeshConfig(data=-1, model=1, seq=1))
        mesh = make_mesh(cfg.mesh)
        model = birnn.init_params(cfg.model, seed=0, device=dev)
        dec = make_collective_decoder(cfg, mesh, use_beam=True, max_len=16,
                                      redistribute=True, device=dev)
        hyps, _ = dec(model, _batch(cfg.data.batch_size, t_pad, 1))
        assert hyps.shape[0] == cfg.data.batch_size
        log(f"dryrun_multichip({n}): collective decode mesh={mesh.shape} "
            f"hyps={tuple(hyps.shape)} ok")

    one_step(MeshConfig(data=-1, model=1, seq=1), 32)
    one_step(MeshConfig(data=-1, model=model_axis, seq=1), 32)
    if seq_axis > 1:
        one_step(MeshConfig(data=-1, model=1, seq=seq_axis), 32)
    if model_axis > 1:
        one_step(MeshConfig(data=-1, model=model_axis, seq=1,
                            pipeline=True, pipeline_microbatches=2), 32)
    one_decode(32)


def main(argv=None) -> int:
    import torch.distributed as dist

    from tpu_ctc_torch.parallel import distributed
    from tpu_ctc_torch.parallel.mesh import world

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="cuda (default: cuda:LOCAL_RANK), cuda:N, or cpu "
                        "(gloo ranks)")
    p.add_argument("--backend", default=None,
                   help="nccl or gloo (default: nccl on cards, gloo on the "
                        "CPU); gloo lets ranks share one card")
    args = p.parse_args(argv)
    dev = distributed.initialize(device=args.device, backend=args.backend)
    n, rank = world()
    try:
        dryrun_multichip(n, dev, log=print if rank == 0 else (lambda _: 0))
        if dist.is_initialized():
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
