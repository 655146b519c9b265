"""The port's eval job (``train.loop.evaluate``) against the JAX package's,
on the CPU.

``test_torch_parallel``'s tiny configuration (H = 32, one dense pre-layer,
two bidirectional layers, B = 8, T = 96, f32) with JAX's seeded weights
(the npz of ``write_inputs``), a trigram char LM trained on a synthetic
train split, and a 16-utterance synthetic eval split (two batches of 8):

* ``max_batches``: ``evaluate(..., max_batches=1)`` gives JAX's
  ``evaluate(..., max_batches=1)`` on the same batches and weights (greedy
  CER, NLL within 1e-5, the utterance count, the beam WER/CER), and counts
  fewer utterances than the whole split.
* ``train.eval_beam`` on a mesh that splits the model: 2 gloo ranks under
  TP (``mesh.model=2``) and as 2 PP stages run ``evaluate`` with the split
  eval of ``make_eval_step`` and a beam decoder whose search records what
  it decodes.  The beam WER/CER and every hypothesis equal the one-card
  ``evaluate``'s on the same weights (which under PP are the gathered
  stacked model, unstacked), the searched log posteriors are the one-card
  model's within 1e-5 (the split forward sums in another order: ~1e-6),
  and under TP the hypotheses equal JAX's ``make_beam_decoder`` on the
  unsharded params.  The reference raises on PP's stacked params
  (``ROADMAP.md``, "Known reference behaviours"), so PP has no JAX
  comparison.
"""
import inspect
import json
import os

import jax
import numpy as np
import pytest
import torch

from tpu_ctc import config as jax_config
from tpu_ctc.decode import beam as jax_beam
from tpu_ctc.decode import lm as jax_lm
from tpu_ctc.parallel import mesh as jax_mesh
from tpu_ctc.train import checkpoint as jax_ckpt
from tpu_ctc.train import loop as jax_loop
from tpu_ctc.train import step as jax_step
from tpu_ctc_torch import config
from tpu_ctc_torch.data.bucketing import BucketedLoader
from tpu_ctc_torch.data.synthetic import SyntheticCorpus
from tpu_ctc_torch.decode import beam, lm
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.train import checkpoint, loop, step

from test_torch_parallel import launch, tiny_fields, write_inputs  # noqa: E402

torch.set_num_threads(2)

BEAM = 8                      # the beam width of every decode here


def corpora():
    """(train split for the LM, eval split): synthetic, seeded."""
    kw = dict(feature_dim=12, frames_per_char=7, min_chars=2, max_chars=8)
    return (SyntheticCorpus(num_utterances=24, seed=1, **kw).all_utterances(),
            SyntheticCorpus(num_utterances=16, seed=2, **kw).all_utterances())


def fields(**mesh_kw):
    f = tiny_fields(1, 1, **mesh_kw)
    f["decode"] = dict(beam_width=BEAM)
    return f


def build_cfg(pkg, f):
    """Either package's ``Config`` from :func:`fields`."""
    return pkg.Config(
        model=pkg.ModelConfig(**f["model"]),
        optim=pkg.OptimConfig(**f["optim"]),
        data=pkg.DataConfig(**f["data"]),
        mesh=pkg.MeshConfig(**f["mesh"]),
        decode=pkg.DecodeConfig(**f["decode"]),
        train=pkg.TrainConfig(**f["train"]))


WORKER_HEAD = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from tpu_ctc_torch import config as C
from tpu_ctc_torch.data.bucketing import BucketedLoader
from tpu_ctc_torch.data.synthetic import SyntheticCorpus
from tpu_ctc_torch.decode import beam
from tpu_ctc_torch.decode.lm import train_char_lm_from_data
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib, pipeline
from tpu_ctc_torch.train import checkpoint, loop, step
"""
WORKER_BODY = """

coord, rank, world, work, fields = sys.argv[1:6]
rank, world, f = int(rank), int(world), json.loads(fields)
distributed.initialize(coord, world, rank, device="cpu")
cfg = build_cfg(C, f)
mesh = mesh_lib.make_mesh(cfg.mesh)
state = step.create_train_state(cfg, device="cpu")
with np.load(work + "/w.npz") as w:
    flat = {k: w[k] for k in w.files}
if cfg.mesh.pipeline:
    flat = pipeline.stack_bi_params(flat)
state.model.load_state_dict(checkpoint.params_from_jax(flat))
step_fn, state = step.make_train_step(cfg, mesh, state)
train, held = corpora()
decode, searched = spy_decoder(cfg, train_char_lm_from_data(train, cfg))
ev = loop.evaluate(state.model, cfg, BucketedLoader(held, cfg.data), "cpu",
                   beam_decode_fn=decode, eval_fn=step.make_eval_step(cfg, mesh))
whole = step.full_state(state)
out = {"ev/" + k: np.array(v) for k, v in ev.items()}
for i, (lp, hyp, hyp_len) in enumerate(searched):
    out.update({f"lp/{i}": lp, f"hyp/{i}": hyp, f"hyp_len/{i}": hyp_len})
params = {k: p.detach().numpy() for k, p in whole.model.named_parameters()}
if cfg.mesh.pipeline:
    params = pipeline.unstack_bi_params(params, cfg.model.num_bi_layers)
out.update({"param/" + k: v for k, v in params.items()})
np.savez(f"{work}/out_{rank}.npz", **out)
torch.distributed.barrier()
print(f"OK rank {rank}", flush=True)
"""


def spy_decoder(cfg, ngram):
    """``make_beam_decoder``'s decode whose search records, for each batch,
    the log posteriors it searched and its hypotheses; returns (decode,
    the list of records)."""
    searched = []
    make_search = beam.make_beam_search

    def recording(*args, **kw):
        search = make_search(*args, **kw)

        def run(log_probs, lengths, max_len, *a, **k):
            hyps, lens, scores = search(log_probs, lengths, max_len, *a, **k)
            searched.append((log_probs.detach().numpy().copy(),
                             hyps.numpy(), lens.numpy()))
            return hyps, lens, scores
        return run
    beam.make_beam_search = recording
    try:
        decode = beam.make_beam_decoder(cfg, lm=ngram, device="cpu")
    finally:
        beam.make_beam_search = make_search
    return decode, searched


# The ranks run this module's helpers without importing it (it imports
# JAX): their source goes into the worker.
WORKER = (WORKER_HEAD + "\n".join(inspect.getsource(fn) for fn in (
    corpora, build_cfg, spy_decoder)) + WORKER_BODY)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The work directory holding JAX's seeded weights (``w.npz``), and
    those weights as a flat '/'-keyed dict."""
    work = tmp_path_factory.mktemp("eval")
    write_inputs(work)
    with np.load(work / "w.npz") as w:
        return work, {k: w[k] for k in w.files}


def jax_params(work, jcfg):
    """JAX's params tree of the npz in ``work``."""
    return jax_ckpt.import_npz(str(work / "w.npz"),
                               jax_step.create_train_state(jcfg).params)


def one_card(flat, f):
    """The port's one-card ``evaluate`` of the npz weights ``flat`` (a
    '/'-keyed dict): (its result, its search records)."""
    cfg = build_cfg(config, f)
    model = birnn.BiRNN(cfg.model, device="cpu")
    model.load_state_dict(checkpoint.params_from_jax(flat))
    train, held = corpora()
    decode, searched = spy_decoder(cfg, lm.train_char_lm_from_data(train, cfg))
    ev = loop.evaluate(model, cfg, BucketedLoader(held, cfg.data), "cpu",
                       beam_decode_fn=decode)
    return ev, searched


class TestMaxBatches:
    def test_one_batch_matches_jax(self, weights):
        work, flat = weights
        f = fields()
        tcfg, jcfg = build_cfg(config, f), build_cfg(jax_config, f)
        model = checkpoint.load_npz(birnn.BiRNN(tcfg.model, device="cpu"),
                                    str(work / "w.npz"))
        params = jax_params(work, jcfg)
        train, held = corpora()
        loader = BucketedLoader(held, tcfg.data)
        ngram = lm.train_char_lm_from_data(train, tcfg)
        got = loop.evaluate(model, tcfg, loader, "cpu", max_batches=1,
                            beam_decode_fn=beam.make_beam_decoder(
                                tcfg, lm=ngram, device="cpu"))
        whole = loop.evaluate(model, tcfg, loader, "cpu")
        mesh = jax_mesh.make_mesh(jcfg.mesh, devices=jax.devices()[:1])
        with mesh:
            want = jax_loop.evaluate(
                params, jcfg, loader, jax_step.make_eval_step(jcfg, mesh),
                max_batches=1, beam_decode_fn=jax_beam.make_beam_decoder(
                    jcfg, lm=jax_lm.train_char_lm_from_data(train, jcfg)))
        assert got["num_utts"] == want["num_utts"] == 8 < whole["num_utts"]
        assert got["cer"] == want["cer"]
        np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-5)
        assert (got["beam_wer"], got["beam_cer"]) == (want["beam_wer"],
                                                      want["beam_cer"])


MESHES = {"tp2": dict(model=2),
          "pp2": dict(model=2, pipeline=True, pipeline_microbatches=2)}


@pytest.mark.parametrize("name", list(MESHES))
def test_eval_beam_decodes_the_whole_model(weights, tmp_path, name):
    src, flat = weights
    f = fields(**MESHES[name])
    os.symlink(src / "w.npz", tmp_path / "w.npz")
    launch(WORKER, 2, str(tmp_path), json.dumps(f))
    outs = [np.load(tmp_path / f"out_{r}.npz") for r in range(2)]
    gathered = {k[len("param/"):].replace(".", "/"): outs[0][k]
                for k in outs[0].files
                if k.startswith("param/")}
    assert gathered.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(gathered[k], flat[k])
    want_ev, want = one_card(gathered, fields())
    for out in outs:
        for k in ("beam_wer", "beam_cer", "cer", "num_utts"):
            assert float(out["ev/" + k]) == want_ev[k], k
        np.testing.assert_allclose(float(out["ev/nll"]), want_ev["nll"],
                                   rtol=1e-5)
        assert len(want) == 2 and f"lp/{len(want)}" not in out.files
        for i, (lp, hyp, hyp_len) in enumerate(want):
            np.testing.assert_allclose(out[f"lp/{i}"], lp, rtol=0, atol=1e-5)
            np.testing.assert_array_equal(out[f"hyp_len/{i}"], hyp_len)
            np.testing.assert_array_equal(out[f"hyp/{i}"], hyp)
    if MESHES[name].get("pipeline"):
        return
    jcfg = build_cfg(jax_config, fields())
    train, held = corpora()
    decode = jax_beam.make_beam_decoder(
        jcfg, lm=jax_lm.train_char_lm_from_data(train, jcfg))
    params = jax_params(src, jcfg)
    batches = [loop.batch_to_device_dict(b) for _, b in
               BucketedLoader(held, build_cfg(config, fields()).data).epoch(0)]
    for i, bd in enumerate(batches):
        j_hyp, j_len = (np.asarray(x) for x in decode(params, bd))
        np.testing.assert_array_equal(outs[0][f"hyp_len/{i}"], j_len)
        for b, n in enumerate(j_len):
            np.testing.assert_array_equal(outs[0][f"hyp/{i}"][b, :n],
                                          j_hyp[b, :n])
