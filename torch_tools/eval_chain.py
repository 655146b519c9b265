#!/usr/bin/env python
"""The accuracy chain of ``docs/EVAL.md`` on the port: raw SPHERE audio in,
a trained preset-2 model, dev-tuned LM decodes, and the valid split's WER
ladder with paired-bootstrap confidence intervals out.

Each step runs as a user runs it, as a subprocess of the port's own tools
and CLI with ``--device`` passed through:

  1. ``torch_tools/make_sample_corpus.py --n N --seed S``: a NIST-SPHERE
     tree in a TIMIT layout;
  2. ``torch_tools/make_manifest.py --layout timit --val-frac 0.28
     --dev-frac 0.09``: train, dev and valid splits by id hash (with
     ``--data DIR``, steps 1-2 were made already: DIR's manifests);
  3. ``python -m tpu_ctc_torch.cli train --config 2`` at H = 512, B = 16,
     buckets (80, 160, 320), labels <= 64: one run a learning rate into one
     work dir, each after the first with ``--resume`` (the anneal:
     0.02 to epoch 90, 0.005 to 260, 0.0015 to 300), then
     ``export-weights`` of the final checkpoint; with ``--init-weights
     NPZ`` (an ``export-weights`` file, e.g. the JAX package's initial
     weights) the first run resumes a checkpoint of those weights at
     step 0;
  4. ``torch_tools/sweep_decode.py --split dev`` over (lm_alpha, lm_beta)
     for three systems at K = 64: the trigram, the GRU char LM alone
     (``decode.lm_order=0 decode.neural_lm=True``) and both, the GRU
     trained for ``--nlm-steps`` Adam steps;
  5. ``cli decode --split valid --hyp-out`` greedy and for each system at
     its dev-best point, the trigram again at K = 200 (kernel B6), then
     ``torch_tools/score.py --ci`` for each and ``--hyp2`` for (greedy,
     trigram), (trigram, GRU), (GRU, both) and (trigram, trigram at
     K = 200); a pair that the tool refuses (an utterance empty in one
     system only) is recorded with its error.

Beside them, in this process: the loader's batch plan (the step count
the runs must reach), the train split read and featurized once by
``ManifestDataset`` (the frontend's share of an epoch), and, while the
sweeps run, two trainings of the GRU char LM as the decodes train it,
compared bit for bit.

Every CLI and sweep subprocess runs under :func:`counted_main`, which
writes the process's kernel launch counts at exit; the JSON holds them by
stage and summed.  The export and the three sweeps, the five decodes and
the scores are independent: ``--jobs N`` runs N of them at once (default
1, one stage at a time).  Progress goes to stderr, each subprocess's
stdout and stderr to ``OUT/logs/<stage>.out`` and ``.log``, and every
number to ``OUT/eval_chain.json``.
The ladder holds when greedy WER > trigram WER > GRU WER with each gap's
paired 95% CI above 0 (the JSON's ``ladder``); the exit code is 0 either
way, and non-zero only when a step fails.

Usage:
  python3 torch_tools/eval_chain.py --out build/eval_chain      # the card
  python3 torch_tools/eval_chain.py --out /tmp/c --device cpu --n 24 \\
      --hidden 16 --layers 1 --epochs 2,3 --lrs 0.02,0.005 --nlm-steps 5 \\
      --trigram-grid 1.0,1.5/0.5,1.5 --gru-grid 1.0,1.5/0.5,1.5 \\
      --both-grid 1.0,1.5/0.5,1.5 --set model.compute_dtype=float32 \\
      --set "data.bucket_boundaries=(400,)"
"""
from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# docs/EVAL.md's dev grids (docs/sweep_{trigram,gru,both}.json): ALPHAS/BETAS
TRIGRAM_GRID = "0.75,1.0,1.25,1.5,1.75,2.0/0.5,1.0,1.5,2.0,2.5,3.0"
GRU_GRID = "0.75,1.0,1.25,1.5,1.75/0.5,1.5,2.5"
BOTH_GRID = "0.5,0.75,1.0,1.25/0.0,0.5,1.5"
# The decode systems: their config overrides on top of the chain's.
SYSTEMS = {"trigram": [],
           "gru": ["decode.lm_order=0", "decode.neural_lm=True"],
           "both": ["decode.lm_order=3", "decode.neural_lm=True"]}
# Paired comparisons of the valid split: (worse, better) as docs/EVAL.md
# orders them, and K = 200 against K = 64.
PAIRS = [("greedy", "trigram"), ("trigram", "gru"), ("gru", "both"),
         ("trigram", "trigram_k200")]
SCORE = re.compile(r"(WER|CER) ([\d.]+)%  \[sub (\d+) ins (\d+) del (\d+) "
                   r"/ (\d+) \w+, (\d+) utts, (\d+) missing hyps\]"
                   r"(?:  95% CI \[([\d.]+), ([\d.]+)\])?")
PAIRED = re.compile(r"paired bootstrap hyp-hyp2: ([+-][\d.]+) "
                    r"\[([+-][\d.]+), ([+-][\d.]+)\] "
                    r"P\(hyp2 better\)=([\d.]+)")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def counted_main(out: str, target: str, *argv: str) -> None:
    """Run ``target`` (a module name, or a script path ending in ``.py``)
    as ``__main__`` with ``argv``, as ``python -m target argv`` or
    ``python target argv`` would; at exit write this process's kernel
    launch counts to ``out`` as JSON."""
    import atexit
    import runpy

    from tpu_ctc_torch.ops import kernels

    def dump():
        with open(out, "w") as f:
            json.dump({k.name: k.launches for k in kernels()}, f)
    atexit.register(dump)
    sys.argv = [target, *argv]
    if target.endswith(".py"):
        runpy.run_path(target, run_name="__main__")
    else:
        runpy.run_module(target, run_name="__main__", alter_sys=True)


class Chain:
    """The stages' subprocesses, their outputs, walls and launch counts;
    up to ``jobs`` independent stages run at once."""

    def __init__(self, out: str, jobs: int = 1):
        self.logs = os.path.join(out, "logs")
        os.makedirs(self.logs, exist_ok=True)
        self.jobs = jobs
        self.wall_s = {}
        self.launches = {}
        self.env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        if jobs > 1:    # the host's cores shared out, not oversubscribed
            self.env["OMP_NUM_THREADS"] = str(max(
                1, len(os.sched_getaffinity(0)) // jobs))
            # and each stage's frontend pool (manifest.host_workers())
            self.env["LOCAL_WORLD_SIZE"] = str(jobs)

    def _start(self, stage: str, target: str, argv, counted: bool):
        if counted:
            cmd = [sys.executable, "-c",
                   "import sys; from torch_tools.eval_chain import "
                   "counted_main; counted_main(*sys.argv[1:])",
                   os.path.join(self.logs, f"{stage}.launches.json"),
                   target, *argv]
        elif target.endswith(".py"):
            cmd = [sys.executable, target, *argv]
        else:
            cmd = [sys.executable, "-m", target, *argv]
        log(f"[chain] {stage}: {target} {' '.join(argv)}")
        with open(os.path.join(self.logs, f"{stage}.out"), "w") as out, \
                open(os.path.join(self.logs, f"{stage}.log"), "w") as err:
            return subprocess.Popen(cmd, cwd=REPO, env=self.env,
                                    stdout=out, stderr=err), time.time()

    def _finish(self, stage: str, proc, t0, counted: bool, check: bool):
        proc.wait()
        self.wall_s[stage] = time.time() - t0
        with open(os.path.join(self.logs, f"{stage}.log")) as f:
            err = f.read()
        if proc.returncode != 0:
            log(err[-4000:])
            msg = (f"[chain] {stage} failed with exit code {proc.returncode}"
                   f" (log: {self.logs}/{stage}.log)")
            if check:
                raise SystemExit(msg)
            log(msg)
            return None
        if counted:
            with open(os.path.join(self.logs,
                                   f"{stage}.launches.json")) as f:
                self.launches[stage] = json.load(f)
        log(f"[chain] {stage}: done in {self.wall_s[stage]:.1f} s")
        with open(os.path.join(self.logs, f"{stage}.out")) as f:
            return f.read()

    def run_all(self, stages, counted=True, check=True):
        """Each (stage, target, argv) in a subprocess from the repo root,
        ``jobs`` at a time; returns {stage: its stdout}.  When one fails:
        raises SystemExit, or with ``check=False`` gives None."""
        outs, running = {}, []
        try:
            for stage, target, argv in stages:
                running.append((stage, *self._start(stage, target, argv,
                                                    counted)))
                if len(running) == self.jobs:
                    stage, proc, t0 = running.pop(0)
                    outs[stage] = self._finish(stage, proc, t0, counted,
                                               check)
            while running:
                stage, proc, t0 = running.pop(0)
                outs[stage] = self._finish(stage, proc, t0, counted, check)
        finally:
            for _, proc, _ in running:    # interrupted: stop the children
                proc.kill()
                proc.wait()
        return outs

    def run(self, stage: str, target: str, argv, counted=True, check=True):
        return self.run_all([(stage, target, argv)], counted, check)[stage]


def data_steps(tree: str, man: str, n: int, seed: int):
    """Steps 1-2 as (stage, script, argv): the SPHERE corpus of ``n``
    utterances from ``seed`` under ``tree``, and its train, dev and valid
    manifests under ``man`` (what ``--data`` takes)."""
    return [("corpus", "torch_tools/make_sample_corpus.py",
             ["--out", tree, "--n", str(n), "--seed", str(seed)]),
            ("manifest", "torch_tools/make_manifest.py",
             ["--layout", "timit", "--src", tree, "--out", man, "--split",
              "train", "--val-frac", "0.28", "--dev-frac", "0.09"])]


def grid(spec: str):
    alphas, _, betas = spec.partition("/")
    return alphas, betas


def sets(pairs):
    return [a for p in pairs for a in ("--set", p)]


def parse_scores(text: str):
    """{'WER': {...}, 'CER': {...}} of ``format_score_line`` lines (the
    first of each unit)."""
    out = {}
    for m in SCORE.finditer(text):
        if m.group(1) in out:
            continue
        rec = {"rate": float(m.group(2)) / 100, "sub": int(m.group(3)),
               "ins": int(m.group(4)), "del": int(m.group(5)),
               "ref_tokens": int(m.group(6)), "utts": int(m.group(7)),
               "missing_hyps": int(m.group(8))}
        if m.group(9) is not None:
            rec["ci95"] = [float(m.group(9)) / 100, float(m.group(10)) / 100]
        out[m.group(1)] = rec
    return out


def read_jsonl(path: str, skip: int = 0):
    with open(path) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    return lines[skip:]


def train_plan(manifests: str, cfg, epochs):
    """Steps of the CLI's runs as the loader plans them (the CLI holds the
    first tenth of the train split out for eval), and the held-in
    utterances."""
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.manifest import ManifestDataset
    data = ManifestDataset(manifests, cfg, split="train")
    held_in = data[max(len(data) // 10, 1):]
    loader = BucketedLoader(held_in, cfg.data)
    ends = []
    steps = 0
    for e in range(epochs[-1]):
        steps += loader.num_batches(e)
        if e + 1 in epochs:
            ends.append(steps)
    return {"batches_per_epoch": loader.num_batches(1),
            "batches_epoch0": loader.num_batches(0),
            "dropped": loader.num_dropped, "utts": len(held_in),
            "steps_at_run_end": ends}, held_in


def frontend_once(held_in, cfg):
    """Seconds to read the held-in train split's audio files alone, and to
    read and featurize them with ``ManifestDataset`` (the loader's work of
    an epoch), on this host."""
    from tpu_ctc_torch.data import audio_io
    base = held_in.base
    t0 = time.time()
    for i in held_in.indices:
        audio_io.read_audio(os.path.join(base.manifest_dir,
                                         base.records[i]["audio"]),
                            target_rate=cfg.frontend.sample_rate)
    reads = time.time() - t0
    t0 = time.time()
    frames = 0
    for i in range(len(held_in)):
        frames += len(held_in[i][0])
    return {"reads_s": reads, "reads_and_frontend_s": time.time() - t0,
            "frames": frames}


def gru_twice(manifests: str, cfg, device: str):
    """Train the decodes' GRU char LM twice on the train split's
    transcripts, as ``cli decode`` and ``sweep_decode`` do; are the two
    bit-equal?"""
    import torch

    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.data.manifest import ManifestDataset
    from tpu_ctc_torch.decode.neural_lm import train_nlm_from_data
    cfg = cfg.override(**{"decode.neural_lm": True})
    data = ManifestDataset(manifests, cfg, split="train")
    dev = resolve_device(device)
    runs, walls = [], []
    for _ in range(2):
        t0 = time.time()
        runs.append({k: v.detach().cpu()
                     for k, v in train_nlm_from_data(data, cfg,
                                                     device=dev).state_dict()
                     .items()})
        walls.append(time.time() - t0)
    diffs = {k: float((runs[0][k] - runs[1][k]).abs().max()) for k in runs[0]}
    return {"bit_equal": all(torch.equal(runs[0][k], runs[1][k])
                             for k in runs[0]),
            "max_abs_diff": diffs, "train_s": walls,
            "steps": cfg.decode.neural_lm_steps}


def saved_step(ckdir: str) -> int:
    """The step of the newest checkpoint in ``ckdir``: a run's last save
    is its end, whether or not its last step was logged."""
    return max(int(m.group(1)) for m in map(
        re.compile(r"step_(\d+)\.pt$").search, os.listdir(ckdir)) if m)


def summarize_run(lines, wall_s, steps):
    """A train run's numbers from its ``metrics.jsonl`` lines and its
    final step."""
    train = [x for x in lines if x.get("kind") == "train"]
    ends = [x for x in lines if x.get("kind") == "epoch_end"]
    walls = [b["wall_s"] - a["wall_s"] for a, b in zip(ends, ends[1:])]
    walls.sort()
    return {
        "steps": steps,
        "epochs": [ends[0]["epoch"], ends[-1]["epoch"] + 1] if ends else None,
        "first_loss": train[0]["loss"] if train else None,
        "last_loss": train[-1]["loss"] if train else None,
        "first_loss_per_frame": train[0]["loss_per_frame"] if train
        else None,
        "last_loss_per_frame": train[-1]["loss_per_frame"] if train else None,
        "logged": len(train),
        "evals": [{k: x[k] for k in ("step", "cer", "nll")}
                  for x in lines if x.get("kind") == "eval"],
        "wall_s": wall_s,
        "median_epoch_wall_s": walls[len(walls) // 2] if walls else None,
        # the wall of the logging windows, per step: steps, loader waits
        # and host work, without saves and evals
        "median_step_time_s": sorted(x["step_time_s"] for x in train)[
            len(train) // 2] if train else None,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True, help="work directory")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("--n", type=int, default=1100, help="utterances")
    p.add_argument("--seed", type=int, default=1, help="the corpus's seed")
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--epochs", default="90,260,300",
                   help="the epoch each run trains to")
    p.add_argument("--lrs", default="0.02,0.005,0.0015",
                   help="each run's learning rate")
    p.add_argument("--nlm-steps", type=int, default=600,
                   help="Adam steps of the GRU char LM")
    p.add_argument("--trigram-grid", default=TRIGRAM_GRID,
                   help="ALPHAS/BETAS of the trigram sweep")
    p.add_argument("--gru-grid", default=GRU_GRID)
    p.add_argument("--both-grid", default=BOTH_GRID)
    p.add_argument("--jobs", type=int, default=1,
                   help="independent stages (the sweeps, the decodes, the "
                        "scores) run this many at a time")
    p.add_argument("--data", metavar="DIR",
                   help="manifests made by steps 1-2 already "
                        "(make_manifest.py's --out): skip those steps")
    p.add_argument("--init-weights", metavar="NPZ",
                   help="start the first run from these weights (an "
                        "export-weights npz, e.g. the JAX package's initial "
                        "ones) instead of the seeded init")
    p.add_argument("--set", action="append", default=[], metavar="PATH=VAL",
                   help="config override after the chain's own, for every "
                        "train, sweep and decode")
    args = p.parse_args(argv)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))

    from tpu_ctc_torch.cli import _parse_overrides
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.utils.profiling import card_line

    out = os.path.abspath(args.out)
    tree = os.path.join(out, "tree")
    man = os.path.abspath(args.data or os.path.join(out, "manifests"))
    work, hyp = os.path.join(out, "train"), os.path.join(out, "hyp")
    epochs = [int(x) for x in args.epochs.split(",")]
    lrs = [float(x) for x in args.lrs.split(",")]
    if len(epochs) != len(lrs):
        raise SystemExit("--epochs and --lrs need one value a run")
    base = [f"model.hidden_dim={args.hidden}",
            f"model.num_bi_layers={args.layers}", "data.batch_size=16",
            "data.bucket_boundaries=(80,160,320)", "data.max_label_len=64",
            *args.set]
    common = ["--config", "2", *sets(base), "--data", man]
    dev = ["--device", args.device]
    nlm = [f"decode.neural_lm_steps={args.nlm_steps}"]
    cfg = get_config("2", **_parse_overrides(base + nlm))
    chain = Chain(out, args.jobs)
    t_start = time.time()
    result = {"device": args.device, "card": card_line(args.device),
              "args": vars(args)}     # the card's name and power limit

    # 1-2. the corpus and its manifests
    if not args.data:
        for stage, target, argv in data_steps(tree, man, args.n, args.seed):
            chain.run(stage, target, argv, counted=False)
    result["splits"] = {}
    for split in ("train", "dev", "valid"):
        with open(os.path.join(man, f"{split}.jsonl")) as f:
            result["splits"][split] = sum(1 for x in f if x.strip())
    log(f"[chain] splits {result['splits']}")

    # 3. training: one run a learning rate, the later ones resumed
    plan, held_in = train_plan(man, cfg, epochs)
    result["plan"] = plan
    result["frontend_once"] = frontend_once(held_in, cfg)
    log(f"[chain] plan {plan}; frontend {result['frontend_once']}")
    metrics = os.path.join(work, "metrics.jsonl")
    if args.init_weights:       # a checkpoint at step 0 that run 0 resumes
        from tpu_ctc_torch.train import checkpoint
        from tpu_ctc_torch.train.step import create_train_state
        state = create_train_state(cfg, device="cpu")
        checkpoint.load_npz(state.model, args.init_weights)
        checkpoint.save(os.path.join(work, "checkpoints"), state, 0, 0)
    runs = []
    for i, (ep, lr) in enumerate(zip(epochs, lrs)):
        seen = len(read_jsonl(metrics)) if os.path.exists(metrics) else 0
        stdout = chain.run(
            f"train{i}", "tpu_ctc_torch.cli",
            ["train", *common, *sets([f"train.num_epochs={ep}",
                                      f"optim.learning_rate={lr}"]),
             "--work-dir", work, *dev,
             *(["--resume"] if i or args.init_weights else [])])
        run = summarize_run(read_jsonl(metrics, seen),
                            chain.wall_s[f"train{i}"],
                            saved_step(os.path.join(work, "checkpoints")))
        run.update(learning_rate=lr, to_epoch=ep,
                   resumed=re.findall(r"\[ckpt\] resumed at epoch (\d+) "
                                      r"batch (\d+) step (\d+)", stdout))
        runs.append(run)
        log(f"[chain] train{i}: {json.dumps(run)}")
    result["train"] = runs

    # 4. the dev sweeps, and beside them (this process, a thread: the
    # sweeps are subprocesses) the GRU char LM as each decode trains it,
    # twice
    twice = {}

    def train_twice():
        t0 = time.time()
        try:
            twice["result"] = gru_twice(man, cfg, args.device)
        except BaseException as e:      # raised again below
            twice["error"] = e
        chain.wall_s["gru_twice"] = time.time() - t0

    thread = threading.Thread(target=train_twice)
    thread.start()
    ckpt = ["--checkpoint", os.path.join(work, "checkpoints")]
    grids = {"trigram": args.trigram_grid, "gru": args.gru_grid,
             "both": args.both_grid}
    npz = os.path.join(out, "weights.npz")
    try:        # the final checkpoint's export beside them
        outs = chain.run_all([
            ("export", "tpu_ctc_torch.cli",
             ["export-weights", *common, *ckpt, "--out", npz, *dev])] + [
            (f"sweep_{name}", "torch_tools/sweep_decode.py",
             [*common, *sets(nlm + SYSTEMS[name]), "--split", "dev", *ckpt,
              "--alphas", grid(spec)[0], "--betas", grid(spec)[1], *dev])
            for name, spec in grids.items()])
    finally:
        thread.join()
    if "error" in twice:
        raise twice["error"]
    final_step = int(re.search(r"\(step (\d+)\)", outs["export"]).group(1))
    result["final_step"] = final_step
    result["steps_equal_plan"] = final_step == plan["steps_at_run_end"][-1]
    result["sweeps"] = {}
    for name in grids:
        result["sweeps"][name] = json.loads(
            outs[f"sweep_{name}"].strip().splitlines()[-1])
        log(f"[chain] sweep_{name}: best "
            f"{result['sweeps'][name]['best']}")
    result["gru_twice"] = twice["result"]
    log(f"[chain] gru_twice: bit-equal {result['gru_twice']['bit_equal']}")

    # 5. the valid split, once a system
    decodes = {"greedy": []}
    for name in SYSTEMS:
        best = result["sweeps"][name]["best"]
        decodes[name] = ["--beam", *sets(nlm + SYSTEMS[name] + [
            f"decode.lm_alpha={best['alpha']}",
            f"decode.lm_beta={best['beta']}"])]
    decodes["trigram_k200"] = decodes["trigram"] + sets(
        ["decode.beam_width=200"])
    outs = chain.run_all([
        (f"decode_{name}", "tpu_ctc_torch.cli",
         ["decode", *common, "--split", "valid", *ckpt, *extra,
          "--hyp-out", os.path.join(hyp, name), *dev])
        for name, extra in decodes.items()])
    result["valid"] = {}
    for name in decodes:
        result["valid"][name] = parse_scores(outs[f"decode_{name}"])
        log(f"[chain] decode_{name}: {result['valid'][name]['WER']}")

    # the scoring tool: each system's CI, then the paired bootstraps
    trn = {name: ["--ref", os.path.join(hyp, name, "ref.trn"),
                  "--hyp", os.path.join(hyp, name, "hyp.trn")]
           for name in decodes}
    outs = chain.run_all(
        [(f"score_{name}", "torch_tools/score.py", [*trn[name], "--ci"])
         for name in decodes] +
        [(f"score_{a}_{b}", "torch_tools/score.py",
          [*trn[a], "--hyp2", os.path.join(hyp, b, "hyp.trn")])
         for a, b in PAIRS], counted=False, check=False)
    for name in decodes:
        if outs[f"score_{name}"] is None:
            raise SystemExit(f"[chain] score_{name} failed")
        result["valid"][name]["WER"]["ci95"] = \
            parse_scores(outs[f"score_{name}"])["WER"]["ci95"]
    result["paired"] = {}
    for a, b in PAIRS:
        stdout = outs[f"score_{a}_{b}"]
        if stdout is None:      # e.g. an empty hypothesis in one system
            with open(os.path.join(chain.logs, f"score_{a}_{b}.log")) as f:
                result["paired"][f"{a}-{b}"] = {
                    "error": f.read().strip().splitlines()[-1]}
            continue
        m = PAIRED.search(stdout)
        result["paired"][f"{a}-{b}"] = {
            "diff": float(m.group(1)) / 100,
            "ci95": [float(m.group(2)) / 100, float(m.group(3)) / 100],
            "p_second_better": float(m.group(4))}
        log(f"[chain] {a} - {b}: {result['paired'][f'{a}-{b}']}")

    from tpu_ctc_torch.decode.wer import parse_trn
    k64 = parse_trn(os.path.join(hyp, "trigram", "hyp.trn"))
    k200 = parse_trn(os.path.join(hyp, "trigram_k200", "hyp.trn"))
    result["k200"] = {"utts": len(k64),
                      "differ": sum(k64[u] != k200.get(u) for u in k64),
                      "identical": k64 == k200}
    wer = {k: v["WER"]["rate"] for k, v in result["valid"].items()}
    lows = {k: v.get("ci95", [float("nan")])[0]
            for k, v in result["paired"].items()}
    result["ladder"] = {
        "greedy_gt_trigram": wer["greedy"] > wer["trigram"],
        "trigram_gt_gru": wer["trigram"] > wer["gru"],
        "greedy_trigram_ci_excludes_0": lows["greedy-trigram"] > 0,
        "trigram_gru_ci_excludes_0": lows["trigram-gru"] > 0}
    result["ladder"]["holds"] = all(result["ladder"].values())

    # launches by stage and summed; B5's n-gram and GRU instances told
    # apart by the stage's system
    result["launches_by_stage"] = chain.launches
    total = {}
    for counts in chain.launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    result["launches"] = total
    result["beam_search_by_lm"] = {
        "ngram": sum(c.get("beam_search", 0) for s, c in
                     chain.launches.items() if s.endswith("trigram")),
        "gru": sum(c.get("beam_search", 0) for s, c in
                   chain.launches.items()
                   if s.endswith("gru") or s.endswith("both"))}
    result["wall_s"] = dict(chain.wall_s, total=time.time() - t_start)
    path = os.path.join(out, "eval_chain.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    log(f"[chain] ladder {result['ladder']}; K=200 {result['k200']}")
    log(f"[chain] wrote {path} in {result['wall_s']['total']:.1f} s")
    return 0


if __name__ == "__main__":
    if __package__ in (None, ""):          # run as a script, not imported
        sys.path.insert(0, REPO)
    sys.exit(main())
