#!/usr/bin/env python
"""Preset fit check of the port: device-memory budget arithmetic, and a
training step at the preset's width on the card with its measured peak.

Counterpart of ``tools/preset_fit.py``:

  1. ``--budget`` prints the analytic memory budget of a preset's training
     step at its shipped shape (params, optimizer state, training
     activations, CTC tensors), the same bytes as the JAX tool's, against
     the card's memory (``torch.cuda.get_device_properties``), or against
     ``--card-gib`` on the CPU;
  2. ``--step`` trains the preset's model at its real width on the current
     card (``--batch``/``--frames`` cut the batch to fit) and prints the
     measured peak (``torch.cuda.max_memory_allocated``) beside the
     budget's ``total`` at that shape, a check the JAX tool could not
     make.  ``--preset 5 --step`` raises kernel B1's own refusal (H = 4096
     is over B1/B2's H <= 2112 on one card), which stays until B1/B2 take
     that width (ROADMAP queue A item 9);
  3. ``--tp-dryrun`` raises ``NotImplementedError``: tensor parallelism is
     not ported yet (ROADMAP queue A item 9).

Usage:
  python3 torch_tools/preset_fit.py --preset 2 --budget --step
  python3 torch_tools/preset_fit.py --preset 3 --budget --step --batch 8
  python3 torch_tools/preset_fit.py --preset 5 --budget --card-gib 80 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

if __package__ in (None, ""):          # run as a script, not imported
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

GB = 1024 ** 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def param_bytes(cfg):
    """Bytes of the model's parameters (shapes only: built on the meta
    device)."""
    from tpu_ctc_torch.models import birnn
    model = birnn.BiRNN(cfg.model, device="meta")
    return sum(p.numel() * p.element_size() for p in model.parameters())


def budget(cfg, batch, frames, tp):
    """Training-step device-memory budget in bytes, itemized.

    Activation model of the JAX tool: the recurrence streams z/h/g per
    direction per bi layer in the model's compute dtype (bf16 = 2 B) at
    [T, B, H], and the backward pass keeps the saved forward streams plus
    one delta stream live; pre/post/output layers hold [T, B, H]
    activations each.  CTC holds [B, T, A] log-probs plus its lattice
    tensors (small next to the H-sized streams).
    """
    m = cfg.model
    h, t, b = m.hidden_dim, frames, batch
    io_bytes = 2 if m.compute_dtype == "bfloat16" else 4
    p = param_bytes(cfg)
    opt = p                                   # Nesterov velocity (f32)
    tbh = t * b * h * io_bytes
    # per bi layer: input x + per-direction (z, h, g) saved for backward
    act_bi = m.num_bi_layers * (1 + 2 * 3) * tbh
    act_dense = (m.num_pre_layers + m.num_post_layers + 1) * tbh
    act_ctc = b * t * m.vocab_size * 4 * 3    # log-probs, grads, lattice
    bwd_scratch = 2 * tbh                     # live delta + dx per sweep
    total = p + opt + act_bi + act_dense + act_ctc + bwd_scratch
    rows = {
        "params": p, "optimizer_state": opt,
        "bi_layer_streams": act_bi, "dense_activations": act_dense,
        "ctc_tensors": act_ctc, "bwd_scratch": bwd_scratch,
        "total": total,
    }
    # TP would divide the H-sharded streams and weights by the model axis;
    # CTC/output tensors stay batch-replicated per shard.
    rows["total_per_tp_shard"] = (
        (p + opt + act_bi + act_dense + bwd_scratch) // tp + act_ctc)
    return rows


def card_bytes(args) -> int:
    """The memory to judge against: the card's, or ``--card-gib``."""
    if args.card_gib:
        return int(args.card_gib * GB)
    import torch

    from tpu_ctc_torch import resolve_device
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("--budget on the CPU needs --card-gib")
    return torch.cuda.get_device_properties(dev).total_memory


def cmd_budget(cfg, args):
    tp = max(cfg.mesh.model, 1)
    shipped = budget(cfg, cfg.data.batch_size, cfg.data.max_frames, tp)
    print(f"preset {cfg.name}: H={cfg.model.hidden_dim}, "
          f"{cfg.model.num_bi_layers} bi layers, shipped shape "
          f"B={cfg.data.batch_size} T={cfg.data.max_frames}, TP={tp}")
    for k, v in shipped.items():
        print(f"  {k:>22}: {v / GB:7.2f} GiB")
    card = card_bytes(args) / GB
    fits1 = shipped["total"] / GB < card * 0.9
    fits_tp = shipped["total_per_tp_shard"] / GB < card * 0.9
    print(f"  one card ({card:.1f} GiB): "
          f"{'FITS' if fits1 else 'DOES NOT FIT'} on one card; "
          f"per-TP{tp}-shard {'FITS' if fits_tp else 'DOES NOT FIT'}")
    # the largest one-card training shape the arithmetic admits
    if not fits1:
        b = cfg.data.batch_size
        while b > 1 and budget(cfg, b, cfg.data.max_frames, 1)["total"] \
                / GB > card * 0.8:
            b //= 2
        print(f"  largest one-card batch at T={cfg.data.max_frames}: ~{b} "
              f"({budget(cfg, b, cfg.data.max_frames, 1)['total'] / GB:.1f} "
              f"GiB)")
    return shipped


def cmd_step(cfg, args):
    """Init and train-step the preset's model at its real width on
    ``--device`` (batch and frames cut by --batch/--frames); on a card the
    measured peak memory of the steps beside the budget's total."""
    import torch

    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.config import DataConfig, MeshConfig
    from tpu_ctc_torch.data.bucketing import make_batch
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    from tpu_ctc_torch.train.step import (batch_to_tensors,
                                          create_train_state, train_step)
    from tpu_ctc_torch.utils.profiling import card_line

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        cfg,
        data=DataConfig(batch_size=args.batch, max_frames=args.frames,
                        bucket_boundaries=(args.frames,)),
        mesh=MeshConfig(data=1, model=1, seq=1))
    est = budget(cfg, args.batch, args.frames, 1)["total"]
    log(f"[preset-fit] stepping H={cfg.model.hidden_dim} at "
        f"B={args.batch} T={args.frames} (est {est / GB:.2f} GiB) on "
        f"{card_line(dev)}")
    rng = np.random.RandomState(0)
    utts = [(rng.randn(args.frames, cfg.model.input_dim).astype(np.float32),
             rng.randint(1, cfg.model.vocab_size, 24).astype(np.int32))
            for _ in range(args.batch)]
    batch = make_batch(utts, t_pad=args.frames, l_pad=32,
                       batch_size=args.batch)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    state = create_train_state(cfg, device=dev)
    bt = batch_to_tensors(batch_to_device_dict(batch), dev)
    t0 = time.time()
    state, m = train_step(state, bt, cfg)
    loss0 = float(m["loss"])
    first_s = time.time() - t0
    steps = 3
    t0 = time.time()
    for _ in range(steps):
        state, m = train_step(state, bt, cfg)
    loss = float(m["loss"])
    dt = (time.time() - t0) / steps
    if not np.isfinite(loss):
        raise FloatingPointError(f"preset {cfg.name}: loss {loss}")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    audio = args.batch * args.frames / 100.0
    print(json.dumps({
        "preset": cfg.name, "hidden": cfg.model.hidden_dim,
        "batch": args.batch, "frames": args.frames,
        "first_step_s": round(first_s, 2), "step_ms": round(dt * 1e3, 1),
        "audio_s_per_s": round(audio / dt, 1),
        "loss0": round(loss0, 3), "loss": round(loss, 3),
        "budget_total_bytes": est, "peak_bytes": peak,
        "peak_over_budget": round(peak / est, 3) if peak else None,
        "device": card_line(dev),
    }), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="5")
    p.add_argument("--budget", action="store_true")
    p.add_argument("--step", action="store_true")
    p.add_argument("--tp-dryrun", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--frames", type=int, default=400)
    p.add_argument("--card-gib", type=float, default=0.0,
                   help="judge the budget against this many GiB instead of "
                        "the card's memory (needed on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.parallel.mesh import not_ported
    cfg = get_config(args.preset)
    if args.tp_dryrun:
        raise not_ported(max(cfg.mesh.model, 2))
    if args.budget or not args.step:
        cmd_budget(cfg, args)
    if args.step:
        cmd_step(cfg, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
