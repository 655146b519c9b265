#!/usr/bin/env python3
"""The decodes of ``chip_smoke.py`` phases 4 and 10, for two checkouts of
the port, timed in turns on one NVIDIA GPU.

    python3 torch_tools/gru_decode_turns.py --parent DIR [--passes 5]

DIR holds another commit's tree (``git archive REV | tar -x -C DIR``).
Four runs, in the order parent, this, this, parent, are each a process of
its own that imports ``tpu_ctc_torch`` from its checkout (its kernels
built under that checkout's ``build/``) and decodes phase 10's 64
utterances with preset 4: at K = 128 with the trigram alone (phase 4's
search), then at K = 128 and at K = 200 with the GRU char LM fused beside
the trigram.  Each prints, for each decode, the audio seconds decoded a
second (the median wall of ``--passes`` passes after a warm-up) and, from
one more pass under torch.profiler, the device's busy time and its idle
share of that pass (an upper bound: the profiler lengthens the pass).  The
first run trains the GRU char LM as phase 10 does and saves it under
``build/``; every run decodes with those weights.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_PATH = os.path.join(ROOT, "build", "gru_decode_turns", "nlm.pt")
# (label, beam width, with the GRU char LM)
DECODES = [("trigram K=128", 128, False), ("GRU K=128", 128, True),
           ("GRU K=200", 200, True)]


def chip_smoke_module():
    """This checkout's ``chip_smoke.py``: its functions import
    ``tpu_ctc_torch`` from ``sys.path``, so from the checkout under test."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str, passes: int) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import tpu_ctc_torch
    from tpu_ctc_torch.decode import neural_lm
    from tpu_ctc_torch.ops import _build
    if not tpu_ctc_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {tpu_ctc_torch.__file__}, not {tree}")
    from tpu_ctc_torch.ops import beam_cuda, birnn_cuda, ctc_cuda
    smoke = chip_smoke_module()
    # the checkout's own kernels (another commit may have other ones)
    _build.build_all([k for m in (beam_cuda, birnn_cuda, ctc_cuda)
                      for k in vars(m).values()
                      if isinstance(k, _build.CudaKernel)])
    cfg, data, lm, model, batches, n_frames = smoke.gru_decode_setup(0)
    if os.path.exists(LM_PATH):
        saved = torch.load(LM_PATH)
        nlm = neural_lm.CharRNNLM(neural_lm.CharRNNLMConfig(**saved["cfg"]),
                                  device="cuda")
        nlm.load_state_dict(saved["state"])
    else:
        nlm = neural_lm.train_nlm_from_data(data, cfg, device="cuda")
        os.makedirs(os.path.dirname(LM_PATH), exist_ok=True)
        torch.save({"cfg": dataclasses.asdict(nlm.cfg),
                    "state": nlm.state_dict()}, LM_PATH)
    for name, k, gru in DECODES:
        run = smoke.gru_decode_pass(cfg, k, lm, nlm if gru else None, model,
                                    batches)
        run()                                   # warm-up
        walls = []
        for _ in range(passes):
            torch.cuda.synchronize()
            t0 = time.time()
            run()
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
        wall = float(np.median(walls))
        prof = smoke.device_breakdown(run, name)
        rec = {"decode": name, "audio_s_per_s": n_frames / 100 / wall,
               "wall_ms": wall * 1e3, "walls_ms": [w * 1e3 for w in walls]}
        if prof is not None:
            rec.update(profiled_wall_ms=prof[0], busy_ms=prof[1],
                       idle_share=1 - prof[1] / prof[0])
        print("RESULT " + json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another commit's tree")
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(os.path.abspath(args.worker), args.passes)
        return 0
    import torch
    if not torch.cuda.is_available() or not args.parent:
        print("needs a CUDA device and --parent", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke_module().card_line()}", flush=True)
    if os.path.exists(LM_PATH):
        os.remove(LM_PATH)
    trees = {"parent": os.path.abspath(args.parent), "this": ROOT}
    results = {}
    for name in ("parent", "this", "this", "parent"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             trees[name], "--passes", str(args.passes)],
            capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"{name}: exit {out.returncode}")
        for line in out.stdout.splitlines():
            if line.startswith("RESULT "):
                rec = json.loads(line[len("RESULT "):])
                results.setdefault((name, rec["decode"]), []).append(rec)
                print(f"{name:6s} {rec['decode']}: "
                      f"{rec['audio_s_per_s']:.1f} audio-s/s (wall "
                      f"{rec['wall_ms']:.1f} ms, passes "
                      f"{[round(w, 1) for w in rec['walls_ms']]}), device "
                      f"busy {rec.get('busy_ms', float('nan')):.1f} ms of a "
                      f"{rec.get('profiled_wall_ms', float('nan')):.1f} ms "
                      f"profiled pass, idle share <= "
                      f"{rec.get('idle_share', float('nan')):.3f}",
                      flush=True)
            elif line.startswith("  device"):
                print(f"  {name:6s} {line.strip()}", flush=True)
    for k, _, _ in DECODES:
        for name in ("parent", "this"):
            rates = [r["audio_s_per_s"] for r in results[(name, k)]]
            idle = [r.get("idle_share", float("nan"))
                    for r in results[(name, k)]]
            print(f"{k} {name:6s}: audio-s/s {rates}, idle share <= "
                  f"{[round(x, 3) for x in idle]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
