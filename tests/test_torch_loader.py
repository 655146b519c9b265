"""The port's loader on a mesh and its frontend pool, on the CPU.

On ``tests/test_torch_data.py``'s corpus (WAV, SPHERE, ``.npy`` features,
an 8 kHz mu-law file resampled to 16 kHz, a record without length
metadata; B = 4, buckets (60, 120, 250), frame stride 2):

* a rank's loader built with its share of the rows its step reads
  (``BucketedLoader(rows=)`` of ``train.step.feature_rows``) on a mesh
  built by hand for each rank (no process group: the share needs only
  the rank's coordinates) reads the payloads of that share's utterances
  only, fewer than one rank's whole pass, each row by one rank of a
  'model' or 'seq' line, the ranks together every utterance, on DP2, SP2,
  DP2 x SP2, TP2 and DP2 x TP2; the eval's share follows the eval step's
  rows.  The counterpart of
  ``tests/test_streaming.py::test_host_shard_reads_only_its_items``,
  which the port does not copy: the reference's hosts take a strided
  share of the batch plan, and the port's ranks keep the global batches;
* ``train.loop.rank_loader`` on 2 and 4 gloo ranks (one process each):
  the shares exchanged over the loader's own group give every rank's
  prefetched train tensors and eval rows bit-equal to those of the fully
  featurized global batch (DP2, SP2, TP2, PP2; DP2 x SP2, DP2 x TP2,
  SP4), a rank whose loader fails makes the others raise, and loaders
  closed mid-epoch on every rank leave none waiting;
* the arrays a rank copies (``local_batch`` of its loader's batch, and the
  tensors of ``prefetch_to_device`` with ``select``) are bit-equal to the
  block of the one-rank global batch under DP2, SP2 and DP2 x SP2, from
  the first batch and resumed mid-epoch, and the global metadata (lengths,
  labels, weights, the batch's audio seconds) is whole;
* every rank's block carries the global batch's label width (one graph
  key on every rank of a mesh), with the CTC loss of the old per-rank
  cut;
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
from tpu_ctc_torch.data.bucketing import BucketedLoader, cut_labels
from tpu_ctc_torch.data.manifest import ManifestDataset, write_manifest
from tpu_ctc_torch.data.prefetch import prefetch_to_device
from tpu_ctc_torch.parallel import mesh as mesh_lib
from tpu_ctc_torch.train import loop, step
from tpu_ctc_torch.train.loop import batch_to_device_dict

torch.set_num_threads(2)

MESHES = {"dp2": (2, 1, 1), "sp2": (1, 1, 2), "dp2xsp2": (2, 1, 2),
          "tp2": (1, 2, 1), "dp2xtp2": (2, 2, 1)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        """A rank's loader built with its share of the rows its step reads
        (``step.feature_rows``) reads the payloads of that share's
        utterances only: on a 'model' or 'seq' line each rank half of the
        line's block, each row by one rank of the line, and the ranks
        together every utterance of the epoch."""
        cfg = _cfgs()[0]
        n_b = cfg.data.batch_size
        full = Recording(corpus, cfg)
        plan = BucketedLoader(full, cfg.data)._epoch_order(1)
        for _ in BucketedLoader(full, cfg.data).epoch(1):
            pass
        shape = MESHES[name]
        covered = set()
        for rank in range(int(np.prod(shape))):
            mesh = hand_mesh(shape, rank)
            read = step.local_rows(mesh, n_b)
            ranks, shares = step.feature_rows(mesh, n_b, read)
            assert len(ranks) == shape[1] * shape[2] and rank in ranks
            mine = shares[ranks.index(rank)]
            dealt = np.sort(np.concatenate(shares))
            assert np.array_equal(dealt, np.arange(n_b) if read is None
                                  else np.sort(read))     # each row once
            ds = Recording(corpus, cfg)
            for _ in BucketedLoader(ds, cfg.data, rows=mine).epoch(1):
                pass
            want = [ids[j] for _, ids in plan
                    for j in sorted({r % len(ids) for r in mine})]
            assert ds.read == want and ds.payload_reads == len(want)
            assert ds.payload_reads < full.payload_reads
            covered |= set(ds.read)
        assert covered == set(full.read)

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
                block = step.local_batch(cut_labels(
                    batch_to_device_dict(full)), mesh)
                assert set(tens) == set(block)
                for k, v in block.items():
                    assert tens[k].dtype == torch.from_numpy(v).dtype
                    np.testing.assert_array_equal(tens[k].numpy(), v, k)
                for k in ("frame_mask", "frame_lengths", "labels",
                          "label_lengths", "weights", "utt_indices"):
                    np.testing.assert_array_equal(getattr(batch, k),
                                                  getattr(full, k), k)
                assert batch.audio_seconds() == full.audio_seconds()

    @pytest.mark.parametrize("name", ["dp2", "dp2xsp2"])
    def test_every_rank_gets_the_global_label_width(self, name):
        """The prefetch thread cuts the labels on the global batch before it
        keeps the rank's block, so every rank of the mesh gets the same
        label width, the key of the same CUDA graph at the same step: here
        a 40-character label in data line 0's rows makes the global width
        64, where data line 1's rows alone would cut to 32.  Each rank's
        CTC loss at the global width equals the loss at its block's own
        cut bit for bit (the extra states are dead)."""
        from tpu_ctc_torch.data.bucketing import make_batch
        from tpu_ctc_torch.losses import ctc
        r = np.random.RandomState(5)
        n_b, t = 8, 120
        lens = [40] + [int(x) for x in r.randint(5, 21, n_b - 1)]
        utts = [(r.randn(int(r.randint(100, t + 1)), 6).astype(np.float32),
                 (np.arange(n) % 28 + 1).astype(np.int32)) for n in lens]
        full = make_batch(utts, t_pad=t, l_pad=64, batch_size=n_b)
        shape = MESHES[name]
        logits = torch.from_numpy(r.randn(n_b, t, 29).astype(np.float32))
        for rank in range(int(np.prod(shape))):
            mesh = hand_mesh(shape, rank)
            (_, _, tens), = prefetch_to_device(
                iter([(0, full)]), "cpu",
                select=lambda a: step.local_batch(a, mesh))
            own = cut_labels(step.local_batch(batch_to_device_dict(full),
                                              mesh))
            assert tens["labels"].shape[1] == 64, (rank, tens["labels"].shape)
            assert own["labels"].shape[1] == (
                64 if mesh.axis_index("data") == 0 else 32)
            rows = step.local_rows(mesh, n_b)
            got, want = (ctc.ctc_loss(
                logits[rows], torch.as_tensor(np.asarray(labels)),
                tens["frame_lengths"], tens["label_lengths"])
                for labels in (tens["labels"], own["labels"]))
            assert torch.equal(got, want), rank

    def test_eval_rows_follow_the_eval_step(self):
        """The rows a mesh's eval step reads (``step.eval_rows``): the
        rank's block under DP, TP and PP (each rank evaluates its block and
        the outputs are gathered), every row (None) where every rank
        evaluates the whole batch (SP, DP x SP); and the share of them
        that the rank's eval loader featurizes (``step.feature_rows``):
        the block alone under pure DP, every other row of it over a TP or
        PP line, and under SP the rows dealt over the whole mesh."""
        cfg = _cfgs()[0]
        pp = cfg.override(**{"mesh.pipeline": True})
        for c, shape, rank, want, share in (
                (cfg, (2, 1, 1), 1, [2, 3], [2, 3]),
                (cfg, (2, 2, 1), 2, [2, 3], [2]),
                (pp, (2, 2, 1), 1, [0, 1], [1]),
                (cfg, (1, 2, 1), 1, None, [1, 3]),
                (cfg, (2, 1, 2), 3, None, [3]),
                (cfg, (1, 1, 2), 1, None, [1, 3])):
            mesh = hand_mesh(shape, rank)
            got = step.eval_rows(c, mesh)
            assert (got is None if want is None
                    else list(got) == want), (shape, rank, got)
            ranks, shares = step.feature_rows(mesh, c.data.batch_size, got)
            assert list(shares[ranks.index(rank)]) == share, (shape, rank)


EXCHANGE_WORKER = r"""
import json, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from tpu_ctc_torch.data.bucketing import BucketedLoader, cut_labels
from tpu_ctc_torch.data.manifest import ManifestDataset
from tpu_ctc_torch.data.prefetch import prefetch_to_device
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
from tpu_ctc_torch.train import loop, step
from tpu_ctc_torch.train.loop import batch_to_device_dict

coord, rank, world, work, corpus, meshes = sys.argv[1:7]
rank, world = int(rank), int(world)
distributed.initialize(coord, world, rank, device="cpu")
with open(work + "/cfg.pkl", "rb") as f:
    cfg = pickle.load(f)


class Recording(ManifestDataset):
    def __init__(self, *a, fail=None, **kw):
        super().__init__(*a, **kw)
        self.read, self.fail = [], fail

    def __getitem__(self, i):
        if i == self.fail:
            raise FileNotFoundError(f"utterance {i} is gone")
        self.read.append(i)
        return super().__getitem__(i)


out = {}
for name, (d, m, s, pp) in json.loads(meshes).items():
    c = cfg.override(**{"mesh.data": d, "mesh.model": m, "mesh.seq": s,
                        "mesh.pipeline": pp})
    mesh = mesh_lib.make_mesh(c.mesh)
    for kind in ("train", "eval"):
        ds = Recording(corpus, cfg)
        loader = loop.rank_loader(ds, c, mesh, eval=kind == "eval")
        mesh_lib.RowExchange.calls = 0
        if kind == "train":   # the prefetch thread's batches, resumed at 1
            got = [(cur, {k: t.numpy() for k, t in tens.items()})
                   for cur, _, tens in prefetch_to_device(
                       loader.epoch(1, 1), "cpu",
                       select=lambda a: step.local_batch(a, mesh))]
        else:                 # evaluate's: the global batch, unselected
            got = [(cur, cut_labels(batch_to_device_dict(b)))
                   for cur, b in loader.epoch(0)]
        loader.close()
        out[f"{name}/{kind}"] = {"reads": ds.read, "rows": loader.rows,
                                 "batches": got,
                                 "exchanges": mesh_lib.RowExchange.calls}
# a rank whose loader fails makes its line's other ranks raise; a loader
# closed mid-epoch on every rank (preemption, evaluate's max_batches)
# leaves no rank waiting
c = cfg.override(**{"mesh.data": 1, "mesh.model": world})
mesh = mesh_lib.make_mesh(c.mesh)
loader = loop.rank_loader(Recording(corpus, cfg), c, mesh)
plan = loader._epoch_order(0)
loader.dataset.fail = plan[1][1][rank % len(plan[1][1])] if rank == 1 else -1
try:
    for _ in prefetch_to_device(loader.epoch(0), "cpu"):
        pass
    raised = None
except Exception as e:
    raised = f"{type(e).__name__}: {e}"
for _ in range(2):
    for _ in loader.epoch(0):
        break
loader.close()
out["abort"] = raised
with open(f"{work}/out_{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print(f"OK rank {rank}", flush=True)
"""

# name: (data, model, seq, pipeline), by the ranks that run them
EXCHANGE_MESHES = {
    2: {"dp2": (2, 1, 1, False), "sp2": (1, 1, 2, False),
        "tp2": (1, 2, 1, False), "pp2": (1, 2, 1, True)},
    4: {"dp2xsp2": (2, 1, 2, False), "dp2xtp2": (2, 2, 1, False),
        "sp4": (1, 1, 4, False)}}


class TestRowExchange:
    @pytest.mark.parametrize("world", [2, 4])
    def test_each_row_featurized_once_and_blocks_bit_equal(self, corpus,
                                                          tmp_path, world):
        """``train.loop.rank_loader`` on ``world`` gloo ranks, one process
        each, for each mesh: every rank featurizes only its share of the
        rows its step reads, each row by exactly one rank of its line, the
        line's reads together cover its block, and the shares exchanged
        over the loader's own group make the prefetched train tensors
        (resumed mid-epoch) bit-equal to ``local_batch`` of the fully
        featurized global batch, and the eval loader's rows that the eval
        step reads bit-equal to the global batch's.  Then a rank whose
        loader fails makes the other raise (no wait), and loaders closed
        mid-epoch on every rank leave none waiting."""
        import pickle
        import socket
        import subprocess
        import sys
        cfg = _cfgs()[0]
        n_b = cfg.data.batch_size
        with open(tmp_path / "cfg.pkl", "wb") as f:
            pickle.dump(cfg, f)
        meshes = EXCHANGE_MESHES[world]
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{sock.getsockname()[1]}"
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-c", EXCHANGE_WORKER, coord, str(r),
             str(world), str(tmp_path), corpus, json.dumps(meshes)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
        outs = [p.communicate(timeout=240) for p in procs]
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r}:\n{out}\n{err[-4000:]}"
        got = []
        for r in range(world):
            with open(tmp_path / f"out_{r}.pkl", "rb") as f:
                got.append(pickle.load(f))
        whole = ManifestDataset(corpus, cfg)
        want = {"train": dict(BucketedLoader(whole, cfg.data).epoch(1, 1)),
                "eval": dict(BucketedLoader(whole, cfg.data).epoch(0))}
        for name, (d, m, s, pp) in meshes.items():
            c = cfg.override(**{"mesh.pipeline": pp})
            for kind, epoch, start in (("train", 1, 1), ("eval", 0, 0)):
                plan = BucketedLoader(whole, cfg.data)._epoch_order(epoch)
                reads = {}
                for r in range(world):
                    mesh = hand_mesh((d, m, s), r)
                    read = (step.eval_rows(c, mesh) if kind == "eval"
                            else step.local_rows(mesh, n_b))
                    ranks, shares = step.feature_rows(mesh, n_b, read)
                    rec = got[r][f"{name}/{kind}"]
                    mine = shares[ranks.index(r)]
                    assert rec["rows"] == list(mine), (name, kind, r)
                    assert rec["reads"] == [
                        ids[j] for _, ids in plan[start:]
                        for j in sorted({q % len(ids) for q in mine})]
                    line = reads.setdefault(ranks, [[], set(), shares])
                    line[0].extend(rec["reads"])
                    line[1] |= {ids[q % len(ids)] for _, ids in plan[start:]
                                for q in (range(n_b) if read is None
                                          else read)}
                    if len(ranks) > 1:
                        assert len(rec["reads"]) < sum(
                            len(ids) for _, ids in plan[start:])
                    for cur, arrays in rec["batches"]:
                        full = cut_labels(batch_to_device_dict(
                            want[kind][cur]))
                        if kind == "train":
                            block = step.local_batch(full, mesh)
                        else:
                            rows = np.arange(n_b) if read is None else read
                            block = {k: v[rows] for k, v in full.items()}
                            arrays = {k: v[rows] for k, v in arrays.items()}
                        assert set(arrays) == set(block)
                        for k, v in block.items():
                            np.testing.assert_array_equal(
                                arrays[k], v, f"{name} {kind} {r} {cur} {k}")
                    assert [cur for cur, _ in rec["batches"]] == list(
                        range(start, len(plan)))
                    # one exchange a batch where a line shares the rows
                    assert rec["exchanges"] == (len(rec["batches"])
                                                if len(ranks) > 1 else 0)
                # a line's reads cover its block's utterances, and each
                # row of a full batch is read by one rank of the line
                for ranks, (line, block, shares) in reads.items():
                    assert set(line) == block, (name, kind, ranks)
                    assert len(line) == sum(
                        len({q % len(ids) for q in share})
                        for _, ids in plan[start:] for share in shares)
                    rows = np.sort(np.concatenate(shares))
                    assert len(set(rows)) == len(rows), (name, kind)
        assert got[1]["abort"].startswith("FileNotFoundError"), got[1]
        assert all(got[r]["abort"].startswith("RuntimeError") and
                   "[1]" in got[r]["abort"] for r in range(world)
                   if r != 1), [g["abort"] for g in got]


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
