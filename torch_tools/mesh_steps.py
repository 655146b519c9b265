#!/usr/bin/env python3
"""Training steps on meshes of NCCL ranks, one card each: the compiled
step against the eager one, in turns.

Each mesh ``DxS`` (data x seq) runs ``chip_smoke.spawn_ranks``: D x S
processes, one per card, take the same global batches of
``chip_smoke.preset3_batches`` (preset 3, B = 64, 400-800 frames) through
``make_train_step``; ``1x1`` is one process on one card.  ``chainDxS`` is
the same on the accuracy chain's shape (``chip_smoke.mesh_batches``:
preset 2 at H = 512, B = 16, buckets 80/160/320, labels <= 64), where the
eager step's host time is the largest share of a step.  ``tpN`` runs
preset 5 (H = 4096) under tensor parallelism, model = N, at a global
B = 16 N, T = 800 (preset 5's B = 64 at N = 4); ``ppN`` runs preset 2 as
N pipeline stages (N divides its 3 layers), 4 microbatches, B = 32,
T = 800; both through ``chip_smoke.spawn_mesh14`` on
``chip_smoke.synthetic_batches``.

Every rank holds two states from one seed: the compiled step's (one CUDA
graph per batch shape, every shape captured before the turns) and the
eager mesh step's (the compiled step's ``eager``), stepped over the
batches in the turns compiled, eager, eager, compiled
(``chip_smoke.step_turns``).  Each turn prints its ms a step (each step
synchronised), the global batches' audio-s/s and the host ms of a step
to its return; then the shapes captured with their warm-up + capture
seconds, whether the two are bit-equal on every rank (metrics at every
step, parameters, trace, launch counts; a mesh where they differ is
named, the others still run, and the exit code is 1), the first loss
and whether the ranks' (replicated) parameters are bit-equal.
Needs as many cards as the largest mesh (a TP or PP mesh with fewer runs
gloo ranks sharing card 0, which stay eager: a functional check, not a
time).

    python3 torch_tools/mesh_steps.py --meshes 1x1,2x1,1x2     # ~2 min
    python3 torch_tools/mesh_steps.py --meshes chain2x1,tp4,pp3
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TURNS = ("graphs", "eager", "eager", "graphs")


def split_step(mesh: str, steps: int):
    """A ``tpN`` or ``ppN`` mesh: (ranks' records, each step's audio
    seconds)."""
    from tpu_ctc_torch.config import get_config
    n = int(mesh[2:])
    if mesh.startswith("tp"):
        preset, batch, over = "5", 16 * n, {"mesh.model": n}
    else:
        preset, batch, over = "2", 32, {
            "mesh.model": n, "mesh.pipeline": True,
            "mesh.pipeline_microbatches": 4}
    spec = dict(kind="train", preset=preset, steps=steps, batch=batch,
                frames=800, seed=1, overrides={"mesh.data": 1, **over},
                turns=TURNS)
    recs, _ = chip_smoke.spawn_mesh14(n, spec)
    batches = chip_smoke.synthetic_batches(get_config(preset), steps, batch,
                                           800, seed=1)
    return recs, [float(b["frame_lengths"].sum()) / 100 for b in batches]


def grid_step(mesh: str, steps: int):
    """A ``DxS`` or ``chainDxS`` mesh: (ranks' records, each step's audio
    seconds)."""
    shape = "chain" if mesh.startswith("chain") else "preset3"
    data, seq = (int(x) for x in mesh.removeprefix("chain").split("x"))
    world = data * seq
    recs = chip_smoke.spawn_ranks(
        world, "nccl", [f"cuda:{r}" for r in range(world)], data, seq,
        steps=steps, shape=shape, turns=TURNS)
    _, batches = chip_smoke.mesh_batches(shape, steps)
    return recs, [float((b.frame_lengths * b.weights).sum()) / 100
                  for b in batches]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="1x1,2x1,1x2",
                    help="comma-separated meshes: DxS (data x seq, preset "
                         "3), chainDxS (the chain's shape), tpN (preset "
                         "5), ppN (preset 2)")
    ap.add_argument("--steps", type=int, default=4,
                    help="global batches a turn (preset 3, TP, PP)")
    ap.add_argument("--chain-steps", type=int, default=12,
                    help="global batches a turn at the chain's shape")
    args = ap.parse_args()
    print(f"card: {chip_smoke.card_line()} ({chip_smoke.card_count()} "
          f"cards)", flush=True)
    failed = []
    for mesh in args.meshes.split(","):
        if mesh.startswith(("tp", "pp")):
            recs, audio = split_step(mesh, args.steps)
        else:
            recs, audio = grid_step(mesh, args.chain_steps
                                    if mesh.startswith("chain")
                                    else args.steps)
        try:
            chip_smoke.describe_turns("mesh_steps", f"mesh {mesh}", recs,
                                      audio)
        except AssertionError as e:     # report it, measure the rest
            print(f"mesh {mesh}: FAILED: {e}", flush=True)
            failed.append(mesh)
        same = len({rec["replicated"] for rec in recs}) == 1
        print(f"mesh {mesh}: {len(recs)} ranks, {recs[0]['mesh']}; first "
              f"loss {recs[0]['runs'][0]['losses'][0]:.4f}; replicated "
              f"parameters bit-equal across ranks: {same}", flush=True)
    if failed:
        print(f"compiled and eager steps differ on {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
