"""A whole run on the CPU at a small size, with the timed path broken
underneath, comes out not correct: for each fault a cell can have.  The
same run unbroken comes out correct.

The runs are held to limits of this size (``SMALL_LIMITS``): at H = 128
the bf16 program reads up to ~1e-2 against float32 on a worst leaf (the
cells' limits are set from readings at their own widths, where sums have
~100x more terms), and every fault here reads 0.1 or more."""
import dataclasses
import os

import pytest
import torch

from ctcbench import run as R, spec
from ctcbench.tests.conftest import tiny_run

TRAIN = "timit_full_3layer.train_timit"
DECODE = "swbd_beam_decode.decode_swbd"
MESH = "swbd_5layer_dp.train_swbd_dp4"


SMALL_LIMITS = {"loss_rel": 1e-3, "grad_leaf": 0.03, "update_leaf": 0.03,
                "ranks_apart": 0.0, "lp_gap": 0.75, "hyp_mismatch": 0.0}


def _correct(run) -> bool:
    limits = {k: SMALL_LIMITS[k] for k in run.cfg_file["limits"]}
    run = dataclasses.replace(run, cfg_file=dict(run.cfg_file, limits=limits))
    return R.execute(spec.benchmark(), run)["correct"]


@pytest.mark.parametrize("name", [TRAIN, DECODE, MESH])
def test_unbroken_run_is_correct(name):
    assert _correct(tiny_run(name))


def test_state_left_unchanged(monkeypatch):
    from tpu_ctc_torch.train import optim

    def unchanged(params, grads, state, cfg, **kw):
        return optim.OptState(state.trace, state.count + 1)
    monkeypatch.setattr(optim, "apply_updates", unchanged)
    assert not _correct(tiny_run(TRAIN))


def test_half_of_the_batch_left_out_in_training(monkeypatch):
    from tpu_ctc_torch.train import step
    loss_fn = step.loss_fn

    def half(model, cfg, batch, reduce=lambda x: x):
        w = batch["weights"].clone()
        w[w.shape[0] // 2:] = 0
        return loss_fn(model, cfg, dict(batch, weights=w), reduce)
    monkeypatch.setattr(step, "loss_fn", half)
    assert not _correct(tiny_run(TRAIN))


def _broken_search(monkeypatch, alter):
    from tpu_ctc_torch.ops import beam_cuda
    search = beam_cuda.beam_search

    def broken(*a, **kw):
        return alter(*(x.clone() for x in search(*a, **kw)))
    monkeypatch.setattr(beam_cuda, "beam_search", broken)


def test_a_token_altered_where_it_is_produced(monkeypatch):
    def alter(hyps, lens, scores):
        hyps[:, 0] = hyps[:, 0] % 28 + 1          # another char
        return hyps, torch.clamp_min(lens, 1), scores
    _broken_search(monkeypatch, alter)
    assert not _correct(tiny_run(DECODE))


def test_half_of_the_batch_left_out_in_decoding(monkeypatch):
    def alter(hyps, lens, scores):
        half = lens.shape[0] // 2
        lens[half:] = 0
        return hyps, lens, scores
    _broken_search(monkeypatch, alter)
    assert not _correct(tiny_run(DECODE))


def test_the_exchange_between_cards_left_out(tmp_path, monkeypatch):
    """Each rank keeps its own gradient: the sum over the ranks is
    replaced by the identity in every rank's process."""
    (tmp_path / "sitecustomize.py").write_text(
        "import tpu_ctc_torch.train.step as s\n"
        "s._all_reduce_grads = lambda grads: list(grads)\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), spec.ROOT, os.environ.get("PYTHONPATH", "")]))
    assert not _correct(tiny_run(MESH))
