#!/usr/bin/env python3
"""Preset 3's training step on meshes of NCCL ranks, one card each, timed
in turns.

Each mesh ``DxS`` (data x seq) runs ``chip_smoke.spawn_ranks``: D x S
processes, one per card, take the same global batches of
``chip_smoke.preset3_batches`` (B = 64, 400-800 frames) through
``make_train_step``; ``1x1`` is one process on one card (``train_step``
itself).  The meshes run in the order given and then in reverse (turns),
and each run prints the median step time of the steps after the first,
the audio-s/s of the global batch, the first loss, and whether the ranks'
parameters are bit-equal.  Needs as many cards as the largest mesh.

    python3 torch_tools/mesh_steps.py --meshes 1x1,2x1,1x2     # ~2 min
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="1x1,2x1,1x2",
                    help="comma-separated data x seq meshes")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    meshes = [tuple(int(x) for x in m.split("x"))
              for m in args.meshes.split(",")]
    print(f"card: {chip_smoke.card_line()} ({chip_smoke.card_count()} "
          f"cards)", flush=True)
    _, batches = chip_smoke.preset3_batches(args.steps)
    audio = float(np.mean([int(b.frame_lengths.sum()) / 100
                           for b in batches[1:]]))
    for data, seq in meshes + meshes[::-1]:
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
