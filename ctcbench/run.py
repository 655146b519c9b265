"""One run of one cell of ``BENCHMARK.json``.

    python3 -m ctcbench.run --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

Exits non-zero without a result where the card(s) the cell needs are not
there.  A one-card cell runs in this process; a cell on several cards
starts one process a card (``parallel.distributed.spawn_ranks``), each a
rank of an NCCL group, and this process gathers rank 0's record, the
cards' peaks and busy seconds, then runs the check on card 0 once the
ranks have ended.  The last line of standard output is the result; the
last lines of standard error are the numbers compared, each beside its
limit.  ``--trace 1`` reads the per-layer metrics from a profiled window.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from ctcbench import spec  # noqa: E402
from ctcbench.common import Run  # noqa: E402

# modules of JAX and of the JAX package, by their whole top-level name
JAX_NAMES = frozenset({"jax", "jaxlib", "flax", "tpu_ctc"})
RANK_TIMEOUT = 330


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def jax_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & JAX_NAMES)


def cell_module(cfg_file: dict):
    return importlib.import_module(f"ctcbench.{cfg_file['path']}_cell")


def make_run(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             t_start: float) -> Run:
    w = spec.workload(bench, name)
    return Run(workload=w, cfg_file=spec.config_file(bench, w["config"]),
               traffic=spec.traffic_file(w["traffic"]), seed=seed,
               seconds=seconds, trace=trace, t_start=t_start)


def spawn(run: Run) -> list:
    """One process a card, each ``--rank`` of this run; their records."""
    from tpu_ctc_torch.parallel.distributed import free_port, spawn_ranks
    n = run.workload["chips"]
    coord = f"localhost:{free_port()}"
    cmds = []
    for r in range(n):
        rank = dataclasses.replace(
            run, rank=r, world=n, coord=coord,
            device=f"cuda:{r}" if run.device == "cuda" else run.device)
        cmds.append([sys.executable, "-m", "ctcbench.run", "--rank",
                     json.dumps(dataclasses.asdict(rank))])
    return spawn_ranks(cmds, cwd=spec.ROOT, env=dict(os.environ),
                       timeout=RANK_TIMEOUT)


def rank_main(rank_json: str) -> int:
    """A rank of a cell on several cards: measure, print ``RANK {record}``."""
    import torch.distributed as dist
    from tpu_ctc_torch.parallel import distributed
    run = Run(**json.loads(rank_json))
    distributed.initialize(run.coord, run.world, run.rank, device=run.device)
    try:
        record, _ = cell_module(run.cfg_file).measure(run)
    finally:
        dist.destroy_process_group()
    found = jax_loaded()
    if found:
        log(f"ctcbench: rank {run.rank} loaded {found}")
        return 3
    print("RANK " + json.dumps(record), flush=True)
    return 0


def execute(bench: dict, run: Run) -> dict:
    """Measure, read the metrics, check; the result's dict."""
    mod = cell_module(run.cfg_file)
    if run.workload["chips"] == 1:
        record, keep = mod.measure(run)
        records, ref_device = [record], run.device
    else:
        records, keep = spawn(run), None
        ref_device = "cuda:0" if run.device == "cuda" else run.device
    rec = mod.finish(run, records)
    rec["setup_s"] = rec["setup_end"] - run.t_start
    metrics = spec.read_metrics(
        spec.metrics_for(bench, run.workload["name"], run.trace), rec, run)
    checks = mod.check(run, records, keep, ref_device)
    if "captures" in rec:
        checks["captures_in_window"] = {
            "value": float(rec["captures"]["in_window"]), "limit": 0.0}
    from ctcbench.checks import is_correct
    device = {"platform": "gpu" if rec["device_kind"] != "cpu" else "cpu",
              "kind": rec["device_kind"], "count": run.workload["chips"],
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": is_correct(checks), "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": device}
    if run.trace:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = rec["trace"]["breakdown"]
    log(f"ctcbench: {run.workload['name']} seed {run.seed}: "
        f"{rec['attempted']} attempted, {len(rec['steps'])} "
        f"{'steps' if rec['kind'] == 'train' else 'calls'} in "
        f"{rec['window_s']:.3f} s; setup {rec['setup_s']:.3f} s")
    log("ctcbench: set-up " + ", ".join(f"{w} at {t:.3f} s"
                                        for w, t in rec["stages"]))
    log(f"ctcbench: launches in the window {json.dumps(rec['launches'])}")
    if "captures" in rec:
        log(f"ctcbench: graph shapes {rec['captures']['shapes']}, "
            f"captured in the window {rec['captures']['in_window']}")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank:
        return rank_main(args.rank)
    if args.workload is None or args.seed is None or args.seconds is None:
        p.error("--workload, --seed and --seconds are required")
    bench = spec.benchmark()
    run = make_run(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), T_START)
    import torch
    chips = run.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"ctcbench: {args.workload} needs {chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" found")
        return 2
    result = execute(bench, run)
    found = jax_loaded()
    if found:
        log(f"ctcbench: JAX or the JAX package was loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
