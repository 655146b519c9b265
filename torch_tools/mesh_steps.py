#!/usr/bin/env python3
"""Training steps on meshes of NCCL ranks, one card each, timed in turns.

Each mesh ``DxS`` (data x seq) runs ``chip_smoke.spawn_ranks``: D x S
processes, one per card, take the same global batches of
``chip_smoke.preset3_batches`` (preset 3, B = 64, 400-800 frames) through
``make_train_step``; ``1x1`` is one process on one card (the compiled
step, one CUDA graph per batch shape; the meshes of several ranks run
``train_step`` eagerly).  ``tpN`` runs preset 5 (H = 4096) under tensor
parallelism, model = N, at a global B = 16 N, T = 800 (preset 5's B = 64
at N = 4);
``ppN`` runs preset 2 as N pipeline stages (N divides its 3 layers), 4
microbatches, B = 32, T = 800; both through ``chip_smoke.spawn_mesh14``
on ``chip_smoke.synthetic_batches``.  The meshes run in the order given
and then in reverse (turns), and each run prints the median step time of
the steps after the first, the audio-s/s of the global batch, the first
loss, and whether the ranks' (replicated) parameters are bit-equal.
Needs as many cards as the largest mesh (a TP or PP mesh with fewer runs
gloo ranks sharing card 0: a functional check, not a time).

    python3 torch_tools/mesh_steps.py --meshes 1x1,2x1,1x2     # ~2 min
    python3 torch_tools/mesh_steps.py --meshes tp4,pp3,tp2
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def split_step(mesh: str, steps: int) -> None:
    """A ``tpN`` or ``ppN`` mesh: its step time, audio-s/s, first loss."""
    from tpu_ctc_torch.config import get_config
    n = int(mesh[2:])
    if mesh.startswith("tp"):
        preset, batch, over = "5", 16 * n, {"mesh.model": n}
    else:
        preset, batch, over = "2", 32, {
            "mesh.model": n, "mesh.pipeline": True,
            "mesh.pipeline_microbatches": 4}
    spec = dict(kind="train", preset=preset, steps=steps, batch=batch,
                frames=800, seed=1, overrides={"mesh.data": 1, **over})
    recs, backend = chip_smoke.spawn_mesh14(n, spec)
    batches = chip_smoke.synthetic_batches(get_config(preset), steps, batch,
                                           800, seed=1)
    audio = float(np.mean([b["frame_lengths"].sum() / 100
                           for b in batches[1:]]))
    step_s = float(np.median(recs[0]["walls"][1:]))
    same = len({rec["replicated"] for rec in recs}) == 1
    print(f"mesh {mesh} (preset {preset}, {backend}): step "
          f"{step_s * 1e3:.1f} ms (median of steps 2-{steps}), "
          f"{audio / step_s:.1f} audio-s/s, first loss "
          f"{recs[0]['losses'][0]:.4f}, replicated parameters bit-equal "
          f"across ranks: {same}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="1x1,2x1,1x2",
                    help="comma-separated meshes: DxS (data x seq, preset "
                         "3), tpN (preset 5), ppN (preset 2)")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    meshes = args.meshes.split(",")
    print(f"card: {chip_smoke.card_line()} ({chip_smoke.card_count()} "
          f"cards)", flush=True)
    _, batches = chip_smoke.preset3_batches(args.steps)
    audio = float(np.mean([int(b.frame_lengths.sum()) / 100
                           for b in batches[1:]]))
    for mesh in meshes + meshes[::-1]:
        if mesh.startswith(("tp", "pp")):
            split_step(mesh, args.steps)
            continue
        data, seq = (int(x) for x in mesh.split("x"))
        world = data * seq
        recs = chip_smoke.spawn_ranks(
            world, "nccl", [f"cuda:{r}" for r in range(world)], data, seq,
            steps=args.steps)
        step_s = float(np.median(recs[0]["walls"][1:]))
        same = len({rec["params"] for rec in recs}) == 1
        print(f"mesh data={data} seq={seq}: step {step_s * 1e3:.1f} ms "
              f"(median of steps 2-{args.steps}), {audio / step_s:.1f} "
              f"audio-s/s, first loss {recs[0]['losses'][0]:.4f}, "
              f"parameters bit-equal across ranks: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
