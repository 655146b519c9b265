"""The readings that a cell's limits (``limits`` in its configuration
file) are set from: the program's numbers over many seeds (the lower
readings), and the control's and the faults' over a few (the upper).

    python3 -m ctcbench.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 4]

The program's readings are whole runs of the cell with a short window
(``run.execute``: set-up, the window's own path, the check); on several
cards the ranks take every seed in one process group.  The control is the
reference in the program's place one precision below the configuration's:
fp8 products (``reference.quant.fp8``) for the model's bf16, a bfloat16
search for the search's float32; it is held to the float32 reference as
the program is.  A training cell also reads
two faults planted in that reference: half of each batch left out (the
mean over the rest) and, on several cards, rank 0's gradient alone (the
sum over the cards left out).  One JSON line a reading.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ctcbench import checks, common, spec
from ctcbench.generator import make_pool
from ctcbench.run import cell_module, execute, make_run
from ctcbench.weights import make_weights, stream_seed


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def program(bench, run0, seeds) -> None:
    if run0.workload["chips"] == 1:
        for s in seeds:
            res = execute(bench, dataclasses.replace(
                run0, seed=s, t_start=time.time()))
            emit(side="program", seed=s, correct=res["correct"],
                 numbers={k: v["value"] for k, v in res["checks"].items()},
                 metrics={k: v["value"] for k, v in res["metrics"].items()})
        return
    from tpu_ctc_torch.parallel.distributed import free_port, spawn_ranks
    n = run0.workload["chips"]
    coord = f"localhost:{free_port()}"
    cuda = run0.device == "cuda"
    cmds = [[sys.executable, "-m", "ctcbench.calibrate", "--rank",
             json.dumps({"run": dataclasses.asdict(dataclasses.replace(
                 run0, rank=r, world=n, coord=coord,
                 device=f"cuda:{r}" if cuda else run0.device)),
                 "seeds": seeds})] for r in range(n)]
    per_rank = spawn_ranks(cmds, cwd=spec.ROOT, env=dict(os.environ),
                           timeout=60 * len(seeds) + 120)
    mod = cell_module(run0.cfg_file)
    for s, records in zip(seeds, zip(*per_rank)):
        run = dataclasses.replace(run0, seed=s)
        got = mod.check(run, list(records), None,
                        "cuda:0" if cuda else run0.device)
        emit(side="program", seed=s, correct=checks.is_correct(got),
             numbers={k: v["value"] for k, v in got.items()})


def rank_main(arg: str) -> int:
    import torch.distributed as dist
    from tpu_ctc_torch.parallel import distributed
    a = json.loads(arg)
    run = common.Run(**a["run"])
    distributed.initialize(run.coord, run.world, run.rank, device=run.device)
    out = []
    try:
        for s in a["seeds"]:
            rec, _ = cell_module(run.cfg_file).measure(
                dataclasses.replace(run, seed=s))
            rec.pop("steps")
            out.append(rec)
    finally:
        dist.destroy_process_group()
    print("RANK " + json.dumps(out), flush=True)
    return 0


def _train_control(run, dev) -> None:
    from ctcbench.reference.model import no_tf32
    from ctcbench.reference.quant import fp8
    from ctcbench.reference.train import run_steps
    from ctcbench.train_cell import check_batches
    no_tf32()
    cf = run.cfg_file
    pool = make_pool(run.traffic, stream_seed(run.seed, "pool"),
                     cf["port"]["model"]["vocab_size"], dev)
    batches = check_batches(run, pool, dev)
    w0 = make_weights(cf["port"]["model"], cf["weights"], run.seed, dev)
    ref = run_steps(w0, cf, batches)
    emit(side="control", seed=run.seed, numbers=checks.train_numbers(
        run_steps(w0, cf, batches, q=fp8), ref))
    half = []
    for b in batches:
        w = b["weights"].clone()
        w[w.shape[0] // 2:] = 0
        half.append(dict(b, weights=w))
    emit(side="fault_half_batch", seed=run.seed,
         numbers=checks.train_numbers(run_steps(w0, cf, half), ref))
    n = run.workload["chips"]
    if n > 1:
        # rank 0's block: the first B / n rows of the global batch
        rows = [(torch.arange(b["weights"].shape[0], device=dev)
                 < cf["port"]["data"]["batch_size"] // n).float()
                for b in batches]
        emit(side="fault_no_exchange", seed=run.seed,
             numbers=checks.train_numbers(
                 run_steps(w0, cf, batches, rows=rows), ref))


def _decode_control(run, dev) -> None:
    from ctcbench.decode_cell import (SAMPLED_CALLS, numbers,
                                      reference_forward, search)
    from ctcbench.reference.quant import fp8
    cf = run.cfg_file
    pool = make_pool(run.traffic, stream_seed(run.seed, "pool"),
                     cf["port"]["model"]["vocab_size"], dev)
    ldr = common.loader(pool, run.config)
    plan = list(common.plan(ldr, run.traffic["start_epoch"], 1))
    longest = max(b for b, _ in plan)
    rng = np.random.default_rng(stream_seed(run.seed, "sample"))
    pick = [next(e for e in plan if e[0] == longest)] + [
        plan[int(i)] for i in rng.choice(len(plan), SAMPLED_CALLS,
                                         replace=False)]
    table, refs = reference_forward(run, pool, pick, dev)
    _, ctl = reference_forward(run, pool, pick, dev, q=fp8)
    lps = [lp for _, lp in ctl]
    outs = [search(run, table, b, lp, torch.bfloat16) for b, lp in ctl]
    emit(side="control", seed=run.seed,
         numbers=numbers(run, table, refs, lps, outs))


def control(bench, name: str, seeds) -> None:
    for s in seeds:
        run = make_run(bench, name, s, 0.0, False, time.time())
        dev = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
        if run.cfg_file["path"] == "train":
            _train_control(run, dev)
        else:
            _decode_control(run, dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--rank", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank:
        return rank_main(args.rank)
    bench = spec.benchmark()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if seeds:
        program(bench, make_run(bench, args.workload, seeds[0], args.seconds,
                                False, time.time()), seeds)
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    if ctl:
        control(bench, args.workload, ctl)
    return 0


if __name__ == "__main__":
    sys.exit(main())
