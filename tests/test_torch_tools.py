"""The port's tools (``torch_tools/``) against the JAX package's
(``tools/``), on the same inputs.

The JAX tools are scripts that put ``tools/`` on ``sys.path``; they are
loaded here from their files under names of their own (``jax_tool_*``),
so a bare ``import make_manifest`` elsewhere in the worker cannot hand a
test the wrong module, and the port's tools are imported as the package
``torch_tools``.

* ``make_manifest``: ``normalize_text``, the dir (features and audio),
  tsv and timit records, and the ``--val-frac``/``--dev-frac`` split
  equal the JAX tool's.
* ``make_sample_corpus``: the same tree byte for byte (SPHERE and WAV).
* ``score``: the same printed lines (CI, a second system, per utterance).
* ``sweep_decode``: on a tiny manifest, with weights bridged from a JAX
  checkpoint, the same grid and the same WER at every point as
  ``tools/sweep_decode.py``.
* ``preset_fit``: ``param_bytes`` and ``budget`` in the same bytes for
  presets 1-5; ``--budget`` on the CPU against ``--card-gib``;
  ``--tp-dryrun`` raises.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from tpu_ctc import config as jax_config
from tpu_ctc.train import checkpoint as jax_ckpt
from tpu_ctc.train.step import create_train_state as jax_train_state
from tpu_ctc_torch import config
from tpu_ctc_torch.data import audio_io
from tpu_ctc_torch.train import checkpoint
from tpu_ctc_torch.train.step import create_train_state
from torch_tools import (make_manifest, make_sample_corpus, preset_fit,
                         score, sweep_decode)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def jax_tool(name):
    """``tools/<name>.py`` as the module ``jax_tool_<name>``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("text", ["Hello, World! it's 42.", "  A  B  ",
                                  "THE-cat's\tHAT;\nok", ""])
def test_normalize_text_equals_jax(text):
    assert make_manifest.normalize_text(text) == \
        jax_tool("make_manifest").normalize_text(text)


def _corpus(root, audio):
    rng = np.random.RandomState(0)
    for i in range(5):
        arr = (rng.randn(8000) if audio else rng.randn(50, 23)).astype(
            np.float32)
        np.save(root / f"utt{i}.npy", arr)
        (root / f"utt{i}.txt").write_text(f"Hello, world {i}!")
    audio_io.write_wav(str(root / "wav0.wav"),
                       rng.randn(4000).astype(np.float32) * 0.1, 16000)
    (root / "wav0.txt").write_text("a wav file")
    with open(root / "list.tsv", "w") as f:
        for i in range(3):
            f.write(f"t{i}\tutt{i}.npy\tTSV line {i}\n")
        f.write("broken line\n")
    return root


@pytest.mark.parametrize("audio", [False, True])
def test_records_equal_jax(tmp_path, audio):
    (tmp_path / "src").mkdir()
    src = _corpus(tmp_path / "src", audio)
    theirs = jax_tool("make_manifest")
    out = str(tmp_path / "out")
    assert list(make_manifest.records_from_dir(str(src), out)) == \
        list(theirs.records_from_dir(str(src), out))
    assert list(make_manifest.records_from_tsv(str(src / "list.tsv"))) == \
        list(theirs.records_from_tsv(str(src / "list.tsv")))


def test_timit_records_equal_jax(tmp_path):
    root = tmp_path / "timit"
    assert make_sample_corpus.main(["--out", str(root), "--n", "3",
                                    "--format", "wav"]) == 0
    spk = root / "dr1" / "spk000"
    np.save(spk / "su0009.WAV.npy", np.zeros(800, np.float32))
    (spk / "su0009.TXT").write_text("0 800 An extra, converted one.\n")
    want = list(jax_tool("make_manifest").records_from_timit(str(root)))
    assert len(want) == 4
    assert list(make_manifest.records_from_timit(str(root))) == want


def test_split_equals_jax(tmp_path):
    (tmp_path / "src").mkdir()
    src = _corpus(tmp_path / "src", audio=False)
    outs = {}
    for name, main in (("torch", make_manifest.main),
                       ("jax", jax_tool("make_manifest").main)):
        out = tmp_path / name
        assert main(["--layout", "dir", "--src", str(src), "--out", str(out),
                     "--val-frac", "0.3", "--dev-frac", "0.3",
                     "--alphabet-out", str(out / "alphabet.json")]) == 0
        outs[name] = _tree(out)
    assert set(outs["torch"]) == {"train.jsonl", "valid.jsonl", "dev.jsonl",
                                  "alphabet.json"}
    assert outs["torch"] == outs["jax"]


@pytest.mark.parametrize("fmt", ["sphere", "wav"])
def test_sample_corpus_byte_identical(tmp_path, capsys, fmt):
    args = ["--n", "4", "--words-max", "3", "--seed", "3", "--format", fmt]
    assert make_sample_corpus.main(["--out", str(tmp_path / "t"), *args]) == 0
    assert jax_tool("make_sample_corpus").main(
        ["--out", str(tmp_path / "j"), *args]) == 0
    ours, theirs = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert len(ours) == 8 and ours == theirs
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace(str(tmp_path / "t"), "") == \
        lines[1].replace(str(tmp_path / "j"), "")


def test_score_prints_the_same_lines(tmp_path, capsys):
    ref, hyp, hyp2 = (tmp_path / n for n in ("ref.trn", "hyp.trn",
                                             "hyp2.trn"))
    ref.write_text("the cat sat (u1)\nhello world (u2)\na b c d (u3)\n")
    hyp.write_text("the bat sat (u1)\nhello world (u2)\na c d e (u3)\n")
    hyp2.write_text("the cat sat (u1)\nhello (u2)\na b c d (u3)\n")
    args = ["--ref", str(ref), "--hyp", str(hyp), "--hyp2", str(hyp2),
            "--ci", "--per-utt"]
    theirs = jax_tool("score")
    for unit in ("word", "char"):
        assert score.main([*args, "--unit", unit]) == 0
        ours = capsys.readouterr().out
        assert theirs.main([*args, "--unit", unit]) == 0
        assert ours == capsys.readouterr().out
        assert len(ours.splitlines()) == 6
    assert score.align_counts(list("abc"), list("abcd")) == (0, 1, 0)


SWEEP_OVER = {"model.hidden_dim": 16, "data.batch_size": 4,
              "data.bucket_boundaries": (48,), "data.max_label_len": 24,
              "decode.beam_width": 8, "model.init_scale": 0.5}


def test_sweep_decode_equals_jax(tmp_path, capsys):
    """The same manifest and weights through both sweeps: the same grid
    and the same error rate at every point (CER: on random weights every
    word is wrong, so WER would not tell the points apart)."""
    from tpu_ctc_torch.data.manifest import write_manifest
    rng = np.random.RandomState(0)
    words = ["hello", "world", "cat", "dog"]
    data = tmp_path / "data"
    data.mkdir()
    for i in range(6):
        np.save(data / f"utt{i}.npy", rng.randn(40, 23).astype(np.float32))
        (data / f"utt{i}.txt").write_text(
            " ".join(words[(i + j) % 4] for j in range(i % 3 + 1)))
    recs = list(make_manifest.records_from_dir(str(data)))
    write_manifest(str(data), "train", recs)
    write_manifest(str(data), "dev", recs[:4])

    jcfg = jax_config.get_config("1").override(**SWEEP_OVER)
    jstate = jax_train_state(jcfg)
    jck = str(tmp_path / "jax_ck")
    mgr = jax_ckpt.make_manager(jck)
    jax_ckpt.save(mgr, jstate, epoch=0, batch_cursor=0, force=True)
    mgr.wait_until_finished()
    mgr.close()
    npz = str(tmp_path / "w.npz")
    jax_ckpt.export_npz(npz, jstate.params)

    cfg = config.get_config("1").override(**SWEEP_OVER)
    state = create_train_state(cfg, device="cpu")
    checkpoint.load_npz(state.model, npz)
    ck = str(tmp_path / "ck")
    checkpoint.save(ck, state, epoch=0, batch_cursor=0)

    argv = [*[a for k, v in SWEEP_OVER.items() for a in ("--set", f"{k}={v}")],
            "--config", "1",
            "--data", str(data), "--split", "dev", "--alphas", "0.5,1.0",
            "--betas", "0.0,2.0", "--unit", "char"]
    assert sweep_decode.main([*argv, "--checkpoint", ck, "--device",
                              "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_tool("sweep_decode").main([*argv, "--checkpoint", jck]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours["n_utts"] == 4 and len(ours["grid"]) == 4
    assert len({r["error_rate"] for r in ours["grid"]}) > 1
    assert ours == theirs


@pytest.mark.parametrize("preset", ["1", "2", "3", "4", "5"])
def test_preset_budget_equals_jax(preset):
    theirs = jax_tool("preset_fit")
    cfg, jcfg = config.get_config(preset), jax_config.get_config(preset)
    assert preset_fit.param_bytes(cfg) == theirs.param_bytes(jcfg)
    for batch, frames, tp in ((cfg.data.batch_size, cfg.data.max_frames,
                               max(cfg.mesh.model, 1)), (8, 400, 1),
                              (1, 16, 4)):
        assert preset_fit.budget(cfg, batch, frames, tp) == \
            theirs.budget(jcfg, batch, frames, tp)


def test_preset_fit_cli_on_the_cpu(capsys):
    assert preset_fit.main(["--preset", "5", "--budget", "--card-gib", "80",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "total:   33.29 GiB" in out and "one card (80.0 GiB): FITS" in out
    with pytest.raises(SystemExit, match="--card-gib"):
        preset_fit.main(["--preset", "2", "--budget", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        preset_fit.main(["--preset", "5", "--tp-dryrun"])


@pytest.mark.parametrize("name", ["beam_frame_breakdown",
                                  "birnn_step_breakdown", "ctc_dp_turns",
                                  "kernel_stamps"])
def test_loading_a_tool_keeps_the_jax_tools_importable(monkeypatch, name):
    """Loading a port tool from its file, as the kernels' tests do, puts
    no directory on ``sys.path`` that holds namesakes of the JAX tools: a
    bare ``import sweep_decode`` in the JAX package's tests must still
    find ``tools/``."""
    import sys
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"{name}_path_check", os.path.join(REPO, "torch_tools", f"{name}.py"))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    here = os.path.join(REPO, "torch_tools")
    assert not [p for p in sys.path
                if os.path.abspath(p or os.curdir) == here]
