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
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no14", action="store_true",
                    help="leave out phase 14 (TP and PP)")
    args = ap.parse_args()
    t0 = time.time()
    cs.phase_build()
    cs.log(f"built in {time.time() - t0:.1f} s")
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
    cs.log(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
