"""Scaling-efficiency harness of the port: DP (weak scaling), SP and PP
(fixed batch) over ranks of one host.

Counterpart of ``tpu_ctc.bench.bench_scaling``.  Each point of the sweep is
one mesh of N ranks, one process each, started together
(``parallel.distributed.spawn_ranks``, as ``chip_smoke.py``'s phase 12
starts its ranks): NCCL with one card a rank, or with
``--force-cpu-devices N`` N gloo ranks on the CPU, which is a functional
check only (CPU timings say nothing about NVLink scaling).  Every rank
builds the same seeded batch and takes its block of it
(``train.step.batch_to_tensors(..., mesh=)``), steps ``make_train_step``
(on NCCL ranks its CUDA graphs: the first step captures) 3 times to warm
up and then ``--steps`` times; rank 0's wall clock of those steps gives
the point's step time.

  * ``--strategy dp``: 'data' = N, the batch grows with the ranks
    (``--per-device-batch`` each); efficiency = t(1) / t(N), 1.0 being
    perfect weak scaling.
  * ``--strategy sp``: 'seq' = N at a fixed batch (the frames split over
    the ranks); t(1) / t(N) is the speedup.
  * ``--strategy pp``: 'model' = N pipeline stages (``mesh.pipeline``,
    4 microbatches) at a fixed batch: t(1) / t(N) shows the GPipe schedule's
    idle ticks, (S - 1) / (S + M - 1) of a stage's, and its replicated
    dense layers (``--layers`` must divide over the stages).

Prints ONE JSON line {"metric": "<strategy>_scaling_efficiency", ...}.

Run: python -m tpu_ctc_torch.bench.bench_scaling [--strategy dp|sp]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

FRAMES_PER_SECOND = 100.0
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WARMUP = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def scaling_config(n_dev, batch, frames, hidden, layers, strategy):
    from tpu_ctc_torch.config import (Config, DataConfig, MeshConfig,
                                      ModelConfig, OptimConfig, TrainConfig)
    mesh = {"dp": dict(data=n_dev, model=1, seq=1),
            "sp": dict(data=1, model=1, seq=n_dev),
            "pp": dict(data=1, model=n_dev, seq=1, pipeline=n_dev > 1,
                       pipeline_microbatches=4)}[strategy]
    return Config(
        model=ModelConfig(input_dim=120, hidden_dim=hidden, num_pre_layers=1,
                          num_bi_layers=layers, vocab_size=29),
        optim=OptimConfig(learning_rate=1e-3),
        data=DataConfig(batch_size=batch, max_frames=frames,
                        bucket_boundaries=(frames,)),
        mesh=MeshConfig(**mesh),
        train=TrainConfig(metrics_path=""))


def rank_main(spec_json: str) -> None:
    """One rank of a point: join the group, step, print ``RANK {...}``
    (the step walls and the last loss)."""
    import torch.distributed as dist

    from tpu_ctc_torch.bench.bench import sync
    from tpu_ctc_torch.data.bucketing import make_batch
    from tpu_ctc_torch.parallel import distributed
    from tpu_ctc_torch.parallel.mesh import make_mesh
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    from tpu_ctc_torch.train.step import (batch_to_tensors,
                                          create_train_state, make_train_step)

    spec = json.loads(spec_json)
    dev = distributed.initialize(spec["coord"], spec["world"], spec["rank"],
                                 device=spec["device"],
                                 backend=spec["backend"])
    try:
        cfg = scaling_config(spec["world"], spec["batch"], spec["frames"],
                             spec["hidden"], spec["layers"],
                             spec["strategy"])
        frames, batch = spec["frames"], spec["batch"]
        rng = np.random.RandomState(0)
        utts = [(rng.randn(frames, 120).astype(np.float32),
                 rng.randint(1, 29, min(40, frames // 3)).astype(np.int32))
                for _ in range(batch)]
        b = make_batch(utts, t_pad=frames, l_pad=48, batch_size=batch)
        mesh = make_mesh(cfg.mesh)
        state = create_train_state(cfg, device=dev)
        step_fn, state = make_train_step(cfg, mesh, state)
        bt = batch_to_tensors(batch_to_device_dict(b), dev, mesh)
        for _ in range(WARMUP):
            state, m = step_fn(state, bt)
        sync(dev)
        dist.barrier()
        t0 = time.time()
        for _ in range(spec["steps"]):
            state, m = step_fn(state, bt)
        sync(dev)
        dt = (time.time() - t0) / spec["steps"]
        loss = float(m["loss"])
        print("RANK " + json.dumps({"rank": spec["rank"], "step_s": dt,
                                    "loss": loss, "mesh": mesh.shape}),
              flush=True)
        del step_fn     # its graphs hold NCCL's communicators
        dist.barrier()
    finally:
        dist.destroy_process_group()


def measure(n_dev, *, per_dev_batch, frames, hidden, layers, steps,
            strategy="dp", fixed_batch=0, device="cuda", timeout=900):
    """One strategy/mesh point of ``n_dev`` ranks (NCCL on cards
    ``cuda:0..n_dev-1``, or gloo on the CPU for ``device="cpu"``);
    returns (step seconds, audio-s/s of the whole job)."""
    from tpu_ctc_torch.parallel import distributed
    batch = fixed_batch or per_dev_batch * n_dev
    scaling_config(n_dev, batch, frames, hidden, layers, strategy)
    on_card = device != "cpu"
    coord = f"127.0.0.1:{distributed.free_port()}"
    commands = []
    for r in range(n_dev):
        spec = dict(coord=coord, rank=r, world=n_dev,
                    device=f"cuda:{r}" if on_card else "cpu",
                    backend="nccl" if on_card else "gloo", batch=batch,
                    frames=frames, hidden=hidden, layers=layers, steps=steps,
                    strategy=strategy)
        commands.append([sys.executable, "-c",
                         "import sys; from tpu_ctc_torch.bench.bench_scaling"
                         " import rank_main; rank_main(sys.argv[1])",
                         json.dumps(spec)])
    recs = distributed.spawn_ranks(commands, cwd=ROOT,
                                   env=dict(os.environ, PYTHONPATH=ROOT),
                                   timeout=timeout)
    dt = recs[0]["step_s"]
    loss = recs[0]["loss"]
    if not np.isfinite(loss):
        raise FloatingPointError(f"{n_dev} rank(s): loss {loss}")
    thr = batch * frames / FRAMES_PER_SECOND / dt
    log(f"[scaling] {n_dev} rank(s), mesh {recs[0]['mesh']}: batch {batch}, "
        f"step {dt * 1e3:.1f} ms, {thr:,.0f} audio-s/s total, "
        f"loss={loss:.3f}")
    return dt, thr


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--per-device-batch", type=int, default=32)
    p.add_argument("--frames", type=int, default=400)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--device-counts", type=str, default="",
                   help="comma list, default: 1 and all available")
    p.add_argument("--force-cpu-devices", type=int, default=0,
                   help="N gloo ranks on the CPU (functional check)")
    p.add_argument("--strategy", choices=("dp", "sp", "pp"), default="dp",
                   help="dp: weak-scaled data parallel; sp: FIXED batch "
                        "sharded over 'seq'; pp: FIXED batch through "
                        "pipeline stages over 'model'")
    p.add_argument("--fixed-batch", type=int, default=0,
                   help="override the global batch (default: "
                        "per-device-batch, weak-scaled only for dp)")
    args = p.parse_args(argv)

    if args.force_cpu_devices:
        device, avail = "cpu", args.force_cpu_devices
    else:
        import torch

        from tpu_ctc_torch import resolve_device
        device = resolve_device(None).type          # raises without a card
        avail = torch.cuda.device_count()
    counts = ([int(x) for x in args.device_counts.split(",") if x]
              or sorted({1, avail}))
    counts = [c for c in counts if c <= avail]
    fixed = args.fixed_batch
    if args.strategy != "dp" and not fixed:
        fixed = args.per_device_batch      # sp: fixed batch by default
    kw = dict(per_dev_batch=args.per_device_batch, frames=args.frames,
              hidden=args.hidden, layers=args.layers, steps=args.steps,
              strategy=args.strategy, fixed_batch=fixed, device=device)
    results = {c: measure(c, **kw) for c in counts}
    base_dt = results[counts[0]][0]
    n_max = counts[-1]
    eff = base_dt / results[n_max][0]
    if args.strategy == "dp":
        log(f"[scaling] weak-scaling efficiency at {n_max} ranks: {eff:.3f}")
    else:
        log(f"[scaling] {args.strategy} t(1)/t({n_max}) at fixed batch: "
            f"{eff:.3f}")
    print(json.dumps({
        "metric": f"{args.strategy}_scaling_efficiency",
        "value": round(eff, 4),
        "unit": f"t(1)/t({n_max}) "
                + ("weak scaling" if args.strategy == "dp"
                   else "fixed batch") + f" ({device})",
        "vs_baseline": round(results[n_max][1] / results[counts[0]][1], 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
