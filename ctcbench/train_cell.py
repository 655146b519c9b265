"""A training cell: the pool through the port's loader and prefetch into
the compiled step of ``make_train_step``, on one card or on a mesh of
ranks (one process a card; rank 0's record carries the job's numbers).

Set-up makes the pool and the weights from the seed, builds the step,
captures the graph of every (bucket, label width) shape that the pool's
batches give in the epochs the window can reach (found on the host from
the loader's plan), and takes the first CHECK_STEPS steps through the
same iterator and step, reading what the check compares.  The window then
steps on until ``--seconds`` have passed and ends at a synchronise.
"""
from __future__ import annotations

import gc
import hashlib
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ctcbench import checks, common
from ctcbench.generator import make_pool
from ctcbench.trace import Spans, profiler, summarise
from ctcbench.weights import make_weights, stream_seed

CHECK_STEPS = 3
MAX_STEPS_PER_S = 400        # far above any step rate: bounds the plan


def _norms(tensors) -> dict:
    return {k: float(torch.linalg.vector_norm(t.detach().double()))
            for k, t in tensors.items()}


def _digest(model) -> str:
    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _tensors(arrays, device) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in arrays.items()}


def shapes(run, ldr) -> dict:
    """One (bucket, ids) batch for each graph key the window can meet:
    (bucket, label width) over the epochs it can reach."""
    from tpu_ctc_torch.data.bucketing import _label_pad_for, label_width
    cfg = ldr.cfg
    lens = np.array([len(lab) for _, lab in ldr.dataset])
    n_epochs = 1 + int((run.seconds + 10) * MAX_STEPS_PER_S
                       / max(1, ldr.num_batches(1)))
    found = {}
    for b, ids in common.plan(ldr, run.traffic["start_epoch"], n_epochs):
        t_pad = cfg.bucket_boundaries[b]
        key = (b, label_width(lens[ids], _label_pad_for(t_pad,
                                                         cfg.max_label_len)))
        found.setdefault(key, (b, ids))
    return found


def measure(run) -> Tuple[dict, Optional[dict]]:
    from tpu_ctc_torch.data.bucketing import cut_labels
    from tpu_ctc_torch.data.prefetch import prefetch_to_device
    from tpu_ctc_torch.models.birnn import BiRNN
    from tpu_ctc_torch.parallel.mesh import make_mesh
    from tpu_ctc_torch.train import optim
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    from tpu_ctc_torch.train.step import (TrainState, local_batch,
                                          local_rows, make_train_step)

    cfg = run.config
    dev = torch.device(run.device)
    stages: List[list] = []
    model_spec = run.cfg_file["port"]["model"]
    pool = make_pool(run.traffic, stream_seed(run.seed, "pool"),
                     model_spec["vocab_size"], dev)
    common.stage(run, stages, "pool")
    w0 = make_weights(model_spec, run.cfg_file["weights"], run.seed, dev)
    model = BiRNN(cfg.model, device=dev)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(w0[k])
    state = TrainState(0, model, optim.init_opt_state(
        dict(model.named_parameters())))
    mesh = make_mesh(cfg.mesh)
    flag = None
    if run.world > 1:
        import torch.distributed as dist
        flag = dist.new_group(backend="gloo")
    step_fn, state = make_train_step(cfg, mesh, state)
    common.stage(run, stages, "weights and step")
    ldr = common.loader(pool, cfg)
    rows = local_rows(mesh, cfg.data.batch_size)
    select = (lambda a: local_batch(a, mesh)) if mesh.size > 1 else None

    def local(arrays):
        arrays = cut_labels(arrays)
        return arrays if select is None else select(arrays)

    capture = getattr(step_fn, "capture", None)
    if capture is not None:
        for b, ids in shapes(run, ldr).values():
            batch = common.host_batch(ldr, b, ids)
            capture(state, _tensors(local(batch_to_device_dict(batch)), dev))
    common.stage(run, stages, "graph captures")
    it = prefetch_to_device(common.batches(ldr, run.traffic["start_epoch"]),
                            dev, size=2, select=select)
    losses = []
    grad = None
    for i in range(CHECK_STEPS):
        _, batch, tensors = next(it)
        state, m = step_fn(state, tensors)
        losses.append(m["loss"])
        if i == 0:
            common.sync(dev)
            grad = _norms(state.opt_state.trace)
    common.sync(dev)
    program = {"losses": [float(x) for x in losses], "grad": grad,
               "change": _norms({k: p - w0[k] for k, p
                                 in model.named_parameters()})}
    del w0
    common.stage(run, stages, f"{CHECK_STEPS} checked steps")

    spans = Spans(keep=run.trace)
    steps: List[dict] = []
    window_losses = []
    graphs = len(getattr(step_fn, "graphs", {}))
    before = common.launches()
    prof = profiler() if run.trace else None
    if prof is not None:
        prof.start()
    common.sync(dev)
    if flag is not None:
        torch.distributed.barrier(group=flag)
    t_setup = time.time()
    t0 = time.time_ns()
    limit = int(run.seconds * 1e9)
    while True:
        with spans.span("input_wait"):
            _, batch, tensors = next(it)
        with spans.span("step_call"):
            state, m = step_fn(state, tensors)
        window_losses.append(m["loss"])
        steps.append(common.work(batch, rows))
        stop = time.time_ns() - t0 >= limit
        if flag is not None:
            with spans.span("stop_flag"):
                f = torch.tensor([int(stop)], dtype=torch.int32)
                torch.distributed.all_reduce(
                    f, op=torch.distributed.ReduceOp.MAX, group=flag)
                stop = bool(f[0])
        if stop:
            break
    common.sync(dev)
    if flag is not None:
        torch.distributed.barrier(group=flag)
    t1 = time.time_ns()
    summary = None
    if prof is not None:
        prof.stop()
        summary = summarise(prof, t0, t1, spans)
        del prof
    it.close()
    window_losses = [float(x) for x in window_losses]
    if run.world > 1:
        program["digest"] = _digest(model)
    record = {
        "kind": "train", "rank": run.rank, "stages": stages,
        "setup_end": t_setup, "window_s": (t1 - t0) / 1e9,
        "steps": steps, "spans": spans.totals,
        "launches": common.launch_delta(before),
        "captures": {"shapes": len(getattr(step_fn, "graphs", {})),
                     "in_window": len(getattr(step_fn, "graphs", {}))
                     - graphs},
        "attempted": len(steps), "failed": common.nonfinite(window_losses),
        "memory_peak_bytes": common.memory_peak(dev),
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "trace": summary, "program": program,
    }
    if hasattr(step_fn, "release"):
        step_fn.release()
    del step_fn, state, model, it
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return record, {"pool": pool}


def check(run, records: List[dict], keep: Optional[dict], device) -> dict:
    """The reference's CHECK_STEPS steps on the batches the program took
    first, from the same seeded weights, against rank 0's readings; on a
    mesh the ranks' parameters too."""
    from ctcbench.reference.model import no_tf32
    from ctcbench.reference.train import run_steps

    dev = torch.device(device)
    no_tf32()
    pool = keep["pool"] if keep else make_pool(
        run.traffic, stream_seed(run.seed, "pool"),
        run.cfg_file["port"]["model"]["vocab_size"], dev)
    w0 = make_weights(run.cfg_file["port"]["model"], run.cfg_file["weights"],
                      run.seed, dev)
    ref = run_steps(w0, run.cfg_file, check_batches(run, pool, dev))
    numbers = checks.train_numbers(records[0]["program"], ref)
    if len(records) > 1:
        first = records[0]["program"]["digest"]
        numbers["ranks_apart"] = float(sum(
            r["program"]["digest"] != first for r in records[1:]))
    return checks.verdict(numbers, run.cfg_file["limits"])


def check_batches(run, pool, dev) -> List[dict]:
    """The reference's copies of the CHECK_STEPS batches the program took
    first (which utterances, from the loader's plan of the first epoch)."""
    ldr = common.loader(pool, run.config)
    bounds = ldr.cfg.bucket_boundaries
    out = []
    for b, ids in common.plan(ldr, run.traffic["start_epoch"], 1):
        out.append(_tensors(common.ref_batch(pool, ids, bounds[b]), dev))
        if len(out) == CHECK_STEPS:
            return out
    return out


def finish(run, records: List[dict]) -> dict:
    """The job's record: rank 0's, with the device's busy seconds averaged
    over the ranks and the peak memory of the fullest card."""
    rec = dict(records[0])
    rec["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in records)
    if rec.get("trace"):
        rec["trace"] = dict(rec["trace"], busy_s=float(np.mean(
            [r["trace"]["busy_s"] for r in records])))
    rec["audio_s"] = sum(s["audio_frames"] for s in rec["steps"]) / \
        run.traffic["frames_per_second"]
    return rec
