"""The accuracy chain of ``docs/EVAL.md`` at a cut size on the CPU, against
the JAX package.

A SPHERE corpus of 24 utterances (``torch_tools/make_sample_corpus.py``)
and its timit manifests go through preset 2 cut to H = 16, one
bidirectional layer, f32 compute, one bucket and batches of 4:

* the anneal: two CLI runs into one work dir, 2 epochs at one learning
  rate, then ``--resume`` to 3 at another, by the port's CLI and by the JAX
  CLI, both from the JAX package's initial weights (a JAX checkpoint at
  step 0, carried into a port checkpoint with ``params_from_jax``): the
  same step, epoch and cursor at the end, every logged loss within 1e-4
  relative, the final parameters within 1e-4 of their norm;
* the decodes: the port's greedy and trigram-beam ``hyp.trn`` of the
  valid split equal the JAX CLI's on the same weights (the port's trained
  checkpoint, exported and written into a JAX checkpoint);
* the scoring: ``torch_tools/score.py --ci --hyp2`` prints the same lines
  as ``tools/score.py`` on those trn files;
* ``torch_tools/eval_chain.py --device cpu`` end to end at the same size,
  and the keys of its JSON.

The weights start at ``model.init_scale=0.3``: at the preset's 0.01 most
utterances decode to empty text after 9 steps, and at 1.0 the losses are
~1e4 and the two packages' gradients part after one step.  Both scoring
tools refuse a paired bootstrap where an utterance is empty in one system
only, so the tools are compared on systems without empty hypotheses; the
end-to-end case starts at 1.0, where every utterance decodes to text and
every pair is scored.

Run as a script, the file decodes the valid split of the full chain's
corpus with the JAX package on the CPU from the weights that the port
trained (``eval_chain.py``'s ``weights.npz``), greedy and trigram beam at
the dev-best point, and holds each against the port's hypotheses with the
paired bootstrap; or (``jax-init``) writes the JAX package's initial
weights of the chain's model as an npz, which ``eval_chain.py
--init-weights`` starts the port's training from:

  JAX_PLATFORMS=cpu python -m tests.test_torch_eval_chain \\
      --chain build/eval_chain --data MANIFESTS --out build/cross
  JAX_PLATFORMS=cpu python -m tests.test_torch_eval_chain jax-init \\
      --out build/jax_init.npz
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpu_ctc import cli as jax_cli
from tpu_ctc import config as jax_config
from tpu_ctc.train import checkpoint as jax_ckpt
from tpu_ctc.train import step as jax_step
from tpu_ctc_torch import cli, config
from tpu_ctc_torch.decode.wer import parse_trn
from tpu_ctc_torch.ops import kernels
from tpu_ctc_torch.train import checkpoint
from tpu_ctc_torch.train.step import create_train_state
from torch_tools import eval_chain, make_manifest, make_sample_corpus, score
from torch_tools.eval_chain import sets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)

# Preset 2 cut to size, as the chain passes it to every command.
CUT = ["model.hidden_dim=16", "model.num_bi_layers=1",
       "model.compute_dtype=float32", "model.init_scale=0.3",
       "data.batch_size=4", "data.bucket_boundaries=(400,)",
       "data.max_label_len=64", "decode.beam_width=8", "train.log_every=1",
       "mesh.data=1"]
RUNS = [(2, 0.02), (3, 0.005)]          # (to epoch, learning rate)
# greedy, and the trigram beam at two (alpha, beta)
POINTS = {"greedy": None, "trigram": (1.0, 3.0), "trigram_b": (0.75, 3.0)}


def jax_tool(name):
    """``tools/<name>.py`` as the module ``jax_tool_<name>``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_checkpoint_from_npz(npz: str, jcfg, directory: str) -> None:
    """An ``export-weights`` npz as a JAX checkpoint at step 0 (what the
    JAX CLI's ``decode --checkpoint`` reads)."""
    state = jax_step.create_train_state(jcfg)
    state = state._replace(params=jax_ckpt.import_npz(npz, state.params))
    mgr = jax_ckpt.make_manager(directory)
    jax_ckpt.save(mgr, state, 0, 0, force=True)
    mgr.wait_until_finished()
    mgr.close()


def jax_decode(over, data, ckdir, out, beam_point=None):
    """``python -m tpu_ctc.cli decode --split valid`` (greedy, or the beam
    at (alpha, beta)) writing ``out``/hyp.trn."""
    argv = ["decode", "--config", "2", *sets(over), "--data", data,
            "--split", "valid", "--checkpoint", ckdir, "--hyp-out", out]
    if beam_point is not None:
        argv += ["--beam", *sets([f"decode.lm_alpha={beam_point[0]}",
                                  f"decode.lm_beta={beam_point[1]}"])]
    assert jax_cli.main(argv) == 0


def make_manifests(root):
    """The chain's steps 1-2 at 24 utterances under ``root``."""
    assert make_sample_corpus.main(["--out", str(root / "tree"), "--n", "24",
                                    "--seed", "1"]) == 0
    assert make_manifest.main(["--layout", "timit", "--src",
                               str(root / "tree"), "--out",
                               str(root / "m"), "--split", "train",
                               "--val-frac", "0.28", "--dev-frac",
                               "0.09"]) == 0
    return str(root / "m")


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    return make_manifests(tmp_path_factory.mktemp("chain"))


def _train_lines(work):
    with open(os.path.join(work, "metrics.jsonl")) as f:
        return [x for x in map(json.loads, f) if x["kind"] == "train"]


def anneal(manifests, root):
    """Both CLIs' two runs from the JAX package's initial weights under
    ``root``; returns their work dirs and the JAX config."""
    over = jax_cli._parse_overrides(CUT)
    jcfg = jax_config.get_config("2", **over)
    jstate = jax_step.create_train_state(jcfg)
    jwork, twork = str(root / "jax"), str(root / "torch")
    mgr = jax_ckpt.make_manager(os.path.join(jwork, "checkpoints"))
    jax_ckpt.save(mgr, jstate, 0, 0, force=True)
    mgr.wait_until_finished()
    mgr.close()
    npz = str(root / "init.npz")
    jax_ckpt.export_npz(npz, jstate.params)
    state = create_train_state(config.get_config("2", **over), device="cpu")
    with np.load(npz) as f:
        state.model.load_state_dict(checkpoint.params_from_jax(
            {k: f[k] for k in f.files}))
    checkpoint.save(os.path.join(twork, "checkpoints"), state, 0, 0)
    for epochs, lr in RUNS:
        argv = ["train", "--config", "2", *sets(CUT + [
            f"train.num_epochs={epochs}", f"optim.learning_rate={lr}"]),
            "--data", manifests, "--resume"]
        assert jax_cli.main([*argv, "--work-dir", jwork]) == 0
        assert cli.main([*argv, "--work-dir", twork, "--device", "cpu"]) == 0
    return jwork, twork, jcfg


@pytest.fixture(scope="module")
def annealed(manifests, tmp_path_factory):
    return anneal(manifests, tmp_path_factory.mktemp("anneal"))


def test_anneal_equals_the_jax_cli(annealed):
    jwork, twork, jcfg = annealed
    want, got = _train_lines(jwork), _train_lines(twork)
    assert [(x["step"], x["epoch"]) for x in got] == \
        [(x["step"], x["epoch"]) for x in want]
    assert len(got) == 9 and got[-1]["epoch"] == RUNS[-1][0] - 1
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-4), g["step"]
    assert got[-1]["loss"] < got[0]["loss"]

    mgr = jax_ckpt.make_manager(os.path.join(jwork, "checkpoints"))
    jstate, jepoch, jbatch = jax_ckpt.restore(
        mgr, jax_step.create_train_state(jcfg))
    mgr.close()
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        flat[".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp)] = np.asarray(leaf)
    ckpts = sorted(os.listdir(os.path.join(twork, "checkpoints")))
    payload = torch.load(os.path.join(twork, "checkpoints", ckpts[-1]),
                         weights_only=True)
    assert (payload["step"], payload["epoch"], payload["batch"]) == \
        (int(jstate.step), jepoch, jbatch) == (9, RUNS[-1][0], 0)
    assert set(payload["params"]) == set(flat)
    for k, v in flat.items():
        gap = np.linalg.norm(payload["params"][k].numpy() - v)
        assert gap <= 1e-4 * np.linalg.norm(v), k


def test_decodes_equal_the_jax_cli(annealed, manifests, tmp_path, capsys):
    _, twork, jcfg = annealed
    npz = str(tmp_path / "w.npz")
    ck = ["--checkpoint", os.path.join(twork, "checkpoints")]
    assert cli.main(["export-weights", "--config", "2", *sets(CUT), *ck,
                     "--out", npz, "--device", "cpu"]) == 0
    jck = str(tmp_path / "jax_ckpt")
    jax_checkpoint_from_npz(npz, jcfg, jck)
    trn = {}
    for name, point in POINTS.items():
        jout, tout = str(tmp_path / f"jax_{name}"), str(tmp_path / name)
        jax_decode(CUT, manifests, jck, jout, point)
        extra = [] if point is None else ["--beam", *sets(
            [f"decode.lm_alpha={point[0]}", f"decode.lm_beta={point[1]}"])]
        assert cli.main(["decode", "--config", "2", *sets(CUT), "--data",
                         manifests, "--split", "valid", *ck, *extra,
                         "--hyp-out", tout, "--device", "cpu"]) == 0
        want = parse_trn(os.path.join(jout, "hyp.trn"))
        got = parse_trn(os.path.join(tout, "hyp.trn"))
        assert len(got) == 8 and got == want, name
        trn[name] = {k: os.path.join(tout, f"{k}.trn") for k in ("ref",
                                                                 "hyp")}
        trn[name]["texts"] = got
    # after 9 steps the model is still leaving its blank phase: greedy
    # emits characters for some utterances, the beam's insertion bonus
    # (beta) for all of them
    assert 0 < sum(map(bool, trn["greedy"]["texts"].values())) < 8
    assert all(trn["trigram"]["texts"].values())
    assert all(trn["trigram_b"]["texts"].values())
    capsys.readouterr()

    # the scoring tools on the port's trn files print the same lines: each
    # system's score and CI, and a paired bootstrap of two systems (both
    # tools refuse a pair where an utterance is empty in one only)
    theirs = jax_tool("score")
    for unit in ("word", "char"):
        for args in (["--hyp", trn["greedy"]["hyp"]],
                     ["--hyp", trn["trigram"]["hyp"], "--hyp2",
                      trn["trigram_b"]["hyp"]]):
            args = ["--ref", trn["greedy"]["ref"], *args, "--ci", "--unit",
                    unit]
            assert score.main(args) == 0
            ours = capsys.readouterr().out
            assert theirs.main(args) == 0
            assert ours == capsys.readouterr().out
            assert len(ours.splitlines()) == (3 if "--hyp2" in args else 1)


def test_eval_chain_end_to_end(manifests, tmp_path):
    out = str(tmp_path / "chain")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "torch_tools", "eval_chain.py"),
         "--out", out, "--data", manifests, "--device", "cpu", "--hidden",
         "16",
         "--layers", "1", "--epochs", ",".join(str(e) for e, _ in RUNS),
         "--lrs", ",".join(str(lr) for _, lr in RUNS), "--nlm-steps", "5",
         "--jobs", "5", "--trigram-grid", "1.0,1.5/0.5,1.5", "--gru-grid",
         "1.0,1.5/0.5,1.5", "--both-grid", "1.0,1.5/0.0,0.5",
         *sets(c for c in CUT if not c.startswith(
             ("mesh.", "model.init", "train.log_every"))),
         # a run's last step unlogged: its step count is its checkpoint's
         "--set", "model.init_scale=1.0", "--set", "train.log_every=4"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(out, "eval_chain.json")) as f:
        res = json.load(f)
    assert set(res) >= {"card", "splits", "plan", "frontend_once", "train",
                        "final_step", "steps_equal_plan", "sweeps",
                        "gru_twice", "valid", "paired", "k200", "ladder",
                        "launches", "launches_by_stage", "wall_s"}
    assert res["splits"] == {"train": 12, "dev": 4, "valid": 8}
    assert res["steps_equal_plan"] and res["final_step"] == 9
    assert [r["steps"] for r in res["train"]] == \
        res["plan"]["steps_at_run_end"] == [6, 9]
    assert [r["logged"] for r in res["train"]] == [1, 1]
    assert res["train"][1]["resumed"] == [["2", "0", "6"]]
    assert all(np.isfinite(r["last_loss_per_frame"]) for r in res["train"])
    assert [len(res["sweeps"][s]["grid"]) for s in eval_chain.SYSTEMS] == \
        [4, 4, 4]
    assert res["gru_twice"]["bit_equal"]
    assert set(res["valid"]) == {"greedy", "trigram", "gru", "both",
                                 "trigram_k200"}
    for name, r in res["valid"].items():
        lo, hi = r["WER"]["ci95"]
        assert r["WER"]["utts"] == 8 and lo <= r["WER"]["rate"] <= hi, name
        assert 0 <= r["CER"]["rate"], name
    assert set(res["paired"]) == {f"{a}-{b}" for a, b in eval_chain.PAIRS}
    for pair in res["paired"].values():
        assert pair["ci95"][0] <= pair["diff"] <= pair["ci95"][1]
    assert set(res["ladder"]) == {
        "greedy_gt_trigram", "trigram_gt_gru", "greedy_trigram_ci_excludes_0",
        "trigram_gru_ci_excludes_0", "holds"}
    assert res["card"] == "cpu" and set(res["launches"]) == {
        k.name for k in kernels()}
    assert set(res["launches_by_stage"]) == {
        "train0", "train1", "export", "sweep_trigram", "sweep_gru",
        "sweep_both", *(f"decode_{n}" for n in res["valid"])}
    assert res["k200"]["utts"] == 8


def chain_overrides(hidden, layers, extra):
    """The config overrides ``eval_chain.py`` passes every command."""
    return [f"model.hidden_dim={hidden}", f"model.num_bi_layers={layers}",
            "data.batch_size=16", "data.bucket_boundaries=(80,160,320)",
            "data.max_label_len=64", *extra, "mesh.data=1"]


def jax_init(argv=None):
    """The JAX package's initial weights (``create_train_state``, as its
    CLI's first run starts) of the chain's model, as an npz."""
    p = argparse.ArgumentParser(prog="test_torch_eval_chain jax-init")
    p.add_argument("--out", required=True, help="the npz to write")
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--set", action="append", default=[],
                   help="as eval_chain.py's --set")
    args = p.parse_args(argv)
    over = chain_overrides(args.hidden, args.layers, args.set)
    jcfg = jax_config.get_config("2", **jax_cli._parse_overrides(over))
    state = jax_step.create_train_state(jcfg)
    jax_ckpt.export_npz(args.out, state.params)
    print(f"[jax-init] {args.out}: preset 2 at H={args.hidden}, "
          f"{args.layers} layers, init_scale {jcfg.model.init_scale}, seed "
          f"{jcfg.seed}", flush=True)
    return 0


def cross_decode(argv=None):
    """The JAX package's decode of the port's trained weights (see the
    module's docstring); prints and writes ``OUT/cross_decode.json``."""
    p = argparse.ArgumentParser()
    p.add_argument("--chain", required=True,
                   help="eval_chain.py's --out (eval_chain.json, "
                        "weights.npz, hyp/)")
    p.add_argument("--data", required=True, help="the chain's manifests")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    with open(os.path.join(args.chain, "eval_chain.json")) as f:
        chain = json.load(f)
    a = chain["args"]
    over = chain_overrides(a["hidden"], a["layers"], a["set"])
    jcfg = jax_config.get_config("2", **jax_cli._parse_overrides(over))
    ck = os.path.join(os.path.abspath(args.out), "jax_ckpt")
    jax_checkpoint_from_npz(os.path.join(args.chain, "weights.npz"), jcfg,
                            ck)
    best = chain["sweeps"]["trigram"]["best"]
    result = {}
    theirs = jax_tool("score")
    for name, point in (("greedy", None),
                        ("trigram", (best["alpha"], best["beta"]))):
        out = os.path.join(args.out, name)
        jax_decode(over, args.data, ck, out, point)
        card = os.path.join(args.chain, "hyp", name)
        got = parse_trn(os.path.join(out, "hyp.trn"))
        want = parse_trn(os.path.join(card, "hyp.trn"))
        argv = ["--ref", os.path.join(card, "ref.trn"), "--hyp",
                os.path.join(card, "hyp.trn"), "--hyp2",
                os.path.join(out, "hyp.trn"), "--ci"]
        print(f"[cross] {name}: the card (hyp) against the JAX package on "
              f"the CPU (hyp2)", flush=True)
        assert theirs.main(argv) == 0
        refs = parse_trn(os.path.join(card, "ref.trn"))
        d, lo, hi, pb = theirs.paired_bootstrap(refs, want, got, "word")
        result[name] = {"utts": len(want),
                        "differ": sum(want[u] != got.get(u) for u in want),
                        "jax_wer": theirs.score_corpus(refs, got, "word")[0][
                            "error_rate"],
                        "card_wer": theirs.score_corpus(refs, want, "word")[
                            0]["error_rate"],
                        "paired_diff": d, "ci95": [lo, hi],
                        "ci_contains_0": lo <= 0 <= hi}
        print(f"[cross] {name}: {json.dumps(result[name])}", flush=True)
    with open(os.path.join(args.out, "cross_decode.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["jax-init"]:
        sys.exit(jax_init(sys.argv[2:]))
    sys.exit(cross_decode())
