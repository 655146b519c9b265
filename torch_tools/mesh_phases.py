#!/usr/bin/env python3
"""``chip_smoke.py``'s mesh phases alone, each with its wall time: the
kernels' build (phase 1's), phase 12's one-rank NCCL step and captured
all-reduce, phase 12's meshes (on 2 or more cards DP2 and SP2, on 4 or
more DP2 x SP2 too, NCCL ranks one card each, the compiled step against
the eager one), then phase 14's TP (preset 5) and PP (preset 2) runs.
The same functions and checks as the smoke, without its other phases:
the quick proof that the mesh paths hold on a machine with several
cards, and the time they add to the smoke there.

    python3 torch_tools/mesh_phases.py            # phases 12 and 14
    python3 torch_tools/mesh_phases.py --no14     # phase 12 only
    python3 torch_tools/mesh_phases.py --no12     # phase 14's TP, PP only
    # phase 12 part 5 alone: preset 2 from audio under DP2, SP2 and TP2,
    # once for each checkout in turn (its ranks import that tree's package;
    # e.g. an earlier commit unpacked with git archive into build/parent)
    python3 torch_tools/mesh_phases.py --audio build/parent,.,.,build/parent
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


# a tree from before the row exchange has no RowExchange to count
OLD_TREE_SHIM = """
from tpu_ctc_torch.parallel import mesh as _mesh
if not hasattr(_mesh, "RowExchange"):
    _mesh.RowExchange = type("RowExchange", (), {"calls": 0, "seconds": 0.0})
"""


def audio_trees(trees, epochs=2):
    """Phase 12 part 5's meshes from audio (``cs.AUDIO_MESHES``), once for
    each checkout of ``trees`` in turn, its ranks importing that tree's
    package, against this tree's reference on one corpus.  The checks of
    this tree's runs hold (raise); another tree's failed checks are
    printed: its numbers are the ones measured beside this tree's."""
    import shutil
    here = os.path.dirname(os.path.abspath(cs.__file__))
    root = os.path.join(here, "build", "mesh_phases_audio")
    shutil.rmtree(root, ignore_errors=True)
    reference = cs.mesh_audio_reference(root, 0, cs.AUDIO_MESHES)
    for tree in trees:
        tree = os.path.abspath(tree)
        ours = os.path.samefile(tree, here)
        # each tree's runs start from no work directory (metrics, evals)
        shutil.rmtree(os.path.join(root, "work"), ignore_errors=True)
        t1 = time.time()
        recs, backend, devs = cs.spawn_mesh_audio(
            root, tree, (cs.AUDIO_RANK_WORKER if ours else
                         OLD_TREE_SHIM + cs.AUDIO_RANK_WORKER),
            cs.AUDIO_MESHES, epochs, reference[3])
        phase = f"mesh audio ({os.path.relpath(tree, here)})"
        for name in cs.AUDIO_MESHES:
            failed, _ = cs.mesh_audio_report(phase, name, recs, reference,
                                             "not run", epochs)
            if failed and ours:
                raise AssertionError("; ".join(failed))
            for msg in failed:
                cs.log(f"{phase}: NOT HELD: {msg}")
        cs.log(f"{phase}: {backend} ranks on {devs}, "
               f"{time.time() - t1:.1f} s")
    shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no12", action="store_true",
                    help="leave out phase 12 (the one-rank step, DP, SP)")
    ap.add_argument("--no14", action="store_true",
                    help="leave out phase 14 (TP and PP)")
    ap.add_argument("--audio", metavar="TREE,...",
                    help="only phase 12's meshes from audio, once for each "
                         "checkout (its package) in turn")
    args = ap.parse_args()
    t0 = time.time()
    cs.phase_build()
    cs.log(f"built in {time.time() - t0:.1f} s")
    if args.audio:
        audio_trees(args.audio.split(","))
        print(cs.card_line(), flush=True)
        return 0
    if not args.no12:
        t1 = time.time()
        _, ref = cs.phase_mesh_one()
        cs.phase_mesh_ranks(ref)
        cs.log(f"phase 12 took {time.time() - t1:.1f} s "
               f"({time.time() - t0:.1f} s in)")
    if not args.no14:
        t1 = time.time()
        cs.phase_tp_preset5()
        cs.phase_pp_preset2()
        cs.log(f"phase 14's TP and PP took {time.time() - t1:.1f} s "
               f"({time.time() - t0:.1f} s in)")
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
