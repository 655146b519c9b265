"""The port's loader on a mesh and its frontend pool, on the CPU.

On ``tests/test_torch_data.py``'s corpus (WAV, SPHERE, ``.npy`` features,
an 8 kHz mu-law file resampled to 16 kHz, a record without length
metadata; B = 4, buckets (60, 120, 250), frame stride 2):

* a rank's loader (``BucketedLoader(rows=train.step.local_rows(...))``) on
  a mesh built by hand for each rank (no process group: the loader needs
  only the rank's coordinates) reads the payloads of its rows' utterances
  only: on data = 2 fewer than one rank's whole pass, whole rows under
  data x seq, every row under seq alone.  The counterpart of
  ``tests/test_streaming.py::test_host_shard_reads_only_its_items``,
  which the port does not copy: the reference's hosts take a strided
  share of the batch plan, and the port's ranks keep the global batches;
* the arrays a rank copies (``local_batch`` of its loader's batch, and the
  tensors of ``prefetch_to_device`` with ``select``) are bit-equal to the
  block of the one-rank global batch under DP2, SP2 and DP2 x SP2, from
  the first batch and resumed mid-epoch, and the global metadata (lengths,
  labels, weights, the batch's audio seconds) is whole;
* a pool of 2 spawned workers (``ManifestDataset(workers=2)``) gives every
  item bit-equal to ``ds[i]`` in this process, dither on and off;
* a worker's exception reaches the consumer of ``prefetch_to_device`` and
  of ``train.loop.train``, and leaves no live child process;
* the JAX package's ``ManifestDataset`` through its ``BucketedLoader``
  against the port's with the pool: the same plan, lengths and labels, and
  features within ``PERF.md`` §2's frontend limits (1e-3 in the bands loud
  in every frame);
* ``torch_tools/audio_path_breakdown.py`` at a cut size on the CPU.
"""
import json
import multiprocessing
import os

import numpy as np
import pytest
import torch

from test_torch_data import FEAT_TOL, _cfgs, _loud_in_every_frame, _make_corpus
from tpu_ctc.data import manifest as jax_manifest
from tpu_ctc.data.bucketing import BucketedLoader as JaxLoader
from tpu_ctc_torch.data.bucketing import BucketedLoader
from tpu_ctc_torch.data.manifest import ManifestDataset, write_manifest
from tpu_ctc_torch.data.prefetch import prefetch_to_device
from tpu_ctc_torch.parallel import mesh as mesh_lib
from tpu_ctc_torch.train import loop, step
from tpu_ctc_torch.train.loop import batch_to_device_dict

torch.set_num_threads(2)

MESHES = {"dp2": (2, 1, 1), "sp2": (1, 1, 2), "dp2xsp2": (2, 1, 2)}


def hand_mesh(shape, rank):
    """Rank ``rank``'s view of a (data, model, seq) grid, as ``make_mesh``
    lays it out (data-major), without process groups."""
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    coord = tuple(int(c[0]) for c in np.nonzero(grid == rank))
    lines = {axis: tuple(int(r) for r in
                         grid[coord[:a] + (slice(None),) + coord[a + 1:]])
             for a, axis in enumerate(mesh_lib.MESH_AXES)}
    return mesh_lib.Mesh(dict(zip(mesh_lib.MESH_AXES, shape)), rank, lines)


def live_children():
    """The live child processes of this one (pools' workers among them)."""
    return set(multiprocessing.active_children())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _make_corpus(str(tmp_path_factory.mktemp("loader_corpus")))


@pytest.fixture(scope="module")
def pooled(corpus):
    """The corpus with a pool of 2 workers, shared by this module's tests."""
    ds = ManifestDataset(corpus, _cfgs()[0], workers=2)
    yield ds
    ds.close()
    assert not live_children()


class Recording(ManifestDataset):
    """``ManifestDataset`` in this process that records what it reads."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.read = []

    def __getitem__(self, i):
        self.read.append(i)
        return super().__getitem__(i)


class TestRankRows:
    @pytest.mark.parametrize("name", list(MESHES))
    def test_rank_reads_only_its_rows(self, corpus, name):
        cfg = _cfgs()[0]
        full = Recording(corpus, cfg)
        plan = BucketedLoader(full, cfg.data)._epoch_order(1)
        for _ in BucketedLoader(full, cfg.data).epoch(1):
            pass
        shape = MESHES[name]
        covered = set()
        for rank in range(int(np.prod(shape))):
            mesh = hand_mesh(shape, rank)
            rows = step.local_rows(mesh, cfg.data.batch_size)
            ds = Recording(corpus, cfg)
            for _ in BucketedLoader(ds, cfg.data, rows=rows).epoch(1):
                pass
            if shape[0] == 1:          # seq alone: every rank every row
                assert rows is None and ds.read == full.read
                continue
            want = [ids[j] for _, ids in plan
                    for j in sorted({r % len(ids) for r in rows})]
            assert ds.read == want and ds.payload_reads == len(want)
            assert ds.payload_reads < full.payload_reads
            covered |= set(ds.read)
        assert shape[0] == 1 or covered == set(full.read)

    @pytest.mark.parametrize("name", list(MESHES))
    @pytest.mark.parametrize("start", [0, 2])
    def test_rank_block_bit_equal_to_the_global_batch(self, pooled, name,
                                                      start):
        cfg = pooled.cfg
        whole = ManifestDataset(pooled.manifest_dir, cfg)
        want = list(BucketedLoader(whole, cfg.data).epoch(1, start))
        shape = MESHES[name]
        for rank in range(int(np.prod(shape))):
            mesh = hand_mesh(shape, rank)
            loader = BucketedLoader(
                pooled, cfg.data, rows=step.local_rows(mesh,
                                                       cfg.data.batch_size))
            got = list(prefetch_to_device(
                loader.epoch(1, start), "cpu",
                select=lambda a: step.local_batch(a, mesh)))
            assert [c for c, _, _ in got] == [c for c, _ in want]
            for (_, batch, tens), (_, full) in zip(got, want):
                block = step.local_batch(batch_to_device_dict(full), mesh)
                assert set(tens) == set(block)
                for k, v in block.items():
                    assert tens[k].dtype == torch.from_numpy(v).dtype
                    np.testing.assert_array_equal(tens[k].numpy(), v, k)
                for k in ("frame_mask", "frame_lengths", "labels",
                          "label_lengths", "weights", "utt_indices"):
                    np.testing.assert_array_equal(getattr(batch, k),
                                                  getattr(full, k), k)
                assert batch.audio_seconds() == full.audio_seconds()

    def test_eval_rows_follow_the_eval_step(self):
        """The rows an eval loader featurizes are the rows the mesh's eval
        step reads: the rank's block under DP, TP and PP, every row (None)
        where every rank evaluates the whole batch (SP, DP x SP)."""
        cfg = _cfgs()[0]
        pp = cfg.override(**{"mesh.pipeline": True})
        for c, shape, rank, want in ((cfg, (2, 1, 1), 1, [2, 3]),
                                     (cfg, (2, 2, 1), 2, [2, 3]),
                                     (pp, (2, 2, 1), 1, [0, 1]),
                                     (cfg, (1, 2, 1), 1, None),
                                     (cfg, (2, 1, 2), 3, None),
                                     (cfg, (1, 1, 2), 1, None)):
            got = step.eval_rows(c, hand_mesh(shape, rank))
            assert (got is None if want is None
                    else list(got) == want), (shape, rank, got)


class TestPool:
    @pytest.mark.parametrize("dither", [0.0, 1e-3])
    def test_items_bit_equal_to_the_process(self, corpus, pooled, dither):
        cfg = _cfgs()[0].override(**{"frontend.dither": dither})
        here = ManifestDataset(corpus, cfg)
        ds = (pooled if dither == 0.0
              else ManifestDataset(corpus, cfg, workers=2))
        try:
            ids = list(range(len(here)))[::-1]
            reads = ds.payload_reads
            got = ds.fetch(ids)()
            assert ds.payload_reads == reads + len(ids)
            for i, (f, labels) in zip(ids, got):
                want_f, want_l = here[i]
                assert f.dtype == want_f.dtype and f.shape == want_f.shape
                np.testing.assert_array_equal(f, want_f, str(i))
                np.testing.assert_array_equal(labels, want_l)
        finally:
            if ds is not pooled:
                ds.close()
        if dither:
            assert not np.array_equal(got[0][0], ManifestDataset(
                corpus, _cfgs()[0])[ids[0]][0])

    def _broken(self, corpus, tmp_path):
        """The corpus with one record whose file is missing."""
        with open(os.path.join(corpus, "train.jsonl")) as f:
            recs = [json.loads(x) for x in f if x.strip()]
        for r in recs:
            for k in ("audio", "feats"):
                if k in r:
                    r[k] = os.path.join(corpus, r[k])
        recs.insert(1, {"id": "gone", "audio": str(tmp_path / "gone.wav"),
                        "text": "gone", "samples": 8000, "rate": 16000})
        root = str(tmp_path / "broken")
        write_manifest(root, "train", recs)
        return root

    def test_worker_error_reaches_the_consumer(self, corpus, tmp_path):
        cfg = _cfgs()[0]
        before = live_children()
        ds = ManifestDataset(self._broken(corpus, tmp_path), cfg, workers=2)
        seen = []
        with pytest.raises(FileNotFoundError, match="gone.wav"):
            for cursor, _, _ in prefetch_to_device(
                    BucketedLoader(ds, cfg.data).epoch(0), "cpu"):
                seen.append(cursor)
        assert len(seen) < BucketedLoader(ds, cfg.data).num_batches(0)
        assert live_children() - before
        ds.close()
        assert live_children() == before

    def test_train_stops_with_the_error_and_its_pool(self, corpus, tmp_path):
        cfg = _cfgs()[0].override(**{
            "model.input_dim": 120, "model.hidden_dim": 8,
            "model.num_bi_layers": 1, "model.num_pre_layers": 1,
            "model.compute_dtype": "float32", "train.num_epochs": 1,
            "train.log_every": 1})
        before = live_children()
        ds = ManifestDataset(self._broken(corpus, tmp_path), cfg, workers=2)
        with pytest.raises(FileNotFoundError, match="gone.wav"):
            loop.train(cfg, ds, work_dir=str(tmp_path / "w"), device="cpu")
        assert live_children() == before


def test_jax_loader_against_the_pool(corpus, pooled):
    cfg, jcfg = _cfgs()
    jds = jax_manifest.ManifestDataset(corpus, jcfg)
    k = 2 * cfg.frontend.context + 1
    want = list(JaxLoader(jds, jcfg.data).epoch(1))
    got = list(BucketedLoader(pooled, cfg.data).epoch(1))
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, a), (_, b) in zip(got, want):
        for key in ("frame_mask", "frame_lengths", "labels", "label_lengths",
                    "weights"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
        np.testing.assert_array_equal(a.utt_indices, b.utt_indices)
        for row, i in enumerate(a.utt_indices):
            t = int(a.frame_lengths[row])
            loud = np.tile(_loud_in_every_frame(pooled, int(i)), k)
            if t:
                err = np.abs(a.feats[row, :t] - np.asarray(b.feats)[row, :t])
                assert err[:, loud].max() <= FEAT_TOL, int(i)
        assert not np.asarray(a.feats)[a.frame_mask == 0].any()


def test_pool_size_comes_from_the_host(monkeypatch):
    from tpu_ctc_torch.data.manifest import host_workers
    cpus = len(os.sched_getaffinity(0))
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert host_workers() == max(cpus - 1, 0)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert host_workers() == max(cpus // 2 - 1, 0)


def test_audio_path_breakdown_on_the_cpu(tmp_path):
    """``torch_tools/audio_path_breakdown.py`` at a cut size on the CPU
    (the chain's shape; preset 2's 800-frame step is slow on the CPU), in
    process and with a pool of 2: every stage measured, the pool's runs
    without the in-process split of reads and frontend, and no device
    number (the CPU has none); and preset 2's tone corpus read back."""
    from torch_tools import audio_path_breakdown as apb
    out = tmp_path / "ap.json"
    before = live_children()
    assert apb.main(["--device", "cpu", "--shapes", "chain", "--utts", "8",
                     "--hidden", "8", "--layers", "1", "--batch", "4",
                     "--epochs", "2", "--workers", "0,2", "--no-per-batch",
                     "--out", str(tmp_path / "c"), "--json", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["card"] == "cpu" and len(rec["shapes"]) == 1
    shape = rec["shapes"][0]
    assert shape["per_utterance"]["read_ms"] > 0
    assert shape["in_memory"]["idle"] is None
    assert [r["workers"] for r in shape["runs"]] == [0, 2]
    for run in shape["runs"]:
        assert run["rate"] > 0 and run["idle"] is None
        assert run["dataset_rate"] > 0 and run["batches"]
        split = {"read_ms", "frontend_ms"} <= set(run["medians"])
        assert split == (run["workers"] == 0)
        assert {"fetch_ms", "make_batch_ms", "pin_copy_ms", "get_wait_ms",
                "step_host_ms", "step_wall_ms"} <= set(run["medians"])
    assert live_children() == before
    cfg = _cfgs()[0].override(**{"frontend.frame_stride": 1})
    waves = apb.tone_corpus(str(tmp_path / "tones"), cfg.frontend, 0,
                            splits=(("train", 2),))
    ds = ManifestDataset(str(tmp_path / "tones"), cfg)
    assert len(ds) == 2 and len(waves["train"][1]) == 2
    assert [len(ds[i][0]) for i in range(2)] == list(ds.frame_lengths)
