"""The port's audio readers, manifest dataset and prefetch against the JAX
package's, on the CPU.

* ``audio_io``: files written by one package and read by the other give
  the same samples (bit-equal), rates, headers and resampling.
* ``ManifestDataset``: on one on-disk corpus (WAV and SPHERE audio, ``.npy``
  features, an 8 kHz mu-law file resampled to 16 kHz), the port's frame
  lengths equal the reference's, and its features are within 1e-3 of the
  reference's in every band that is loud (mel energy >= 1e-6 of the
  frame's largest band) in every frame of the utterance (``PERF.md`` §2:
  CMVN mixes a band's frames, so a band with a quiet frame is left out).
  The waveforms carry white noise, so only the resampled file's bands
  above 4 kHz are quiet.  Lazy reads mirror ``tests/test_streaming.py``.
* ``prefetch_to_device``: order, cursors, the tensors, a raising loader and
  an early stop.
"""
import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from tpu_ctc import config as jax_config
from tpu_ctc.data import audio_io as jax_audio_io
from tpu_ctc.data import manifest as jax_manifest
from tpu_ctc_torch import config
from tpu_ctc_torch.data import audio_io
from tpu_ctc_torch.data.bucketing import BucketedLoader
from tpu_ctc_torch.data.manifest import (DatasetView, ManifestDataset,
                                         load_manifest_dataset,
                                         write_manifest)
from tpu_ctc_torch.data.prefetch import prefetch_to_device
from tpu_ctc_torch.decode.lm import label_seqs_of
from tpu_ctc_torch.frontend import features as F
from tpu_ctc_torch.train.loop import batch_to_device_dict
from tpu_ctc_torch.train.step import batch_to_tensors

torch.set_num_threads(2)

FEAT_TOL = 1e-3
LOUD = 1e-6


def _over():
    return dict(
        frontend=dict(sample_rate=16000, context=1, frame_stride=2),
        data=dict(batch_size=4, max_frames=400,
                  bucket_boundaries=(60, 120, 250), seed=3, shuffle=True,
                  sortagrad=False))


def _cfgs():
    """The same config in both packages (``tests/test_streaming.py``'s)."""
    out = []
    for mod in (config, jax_config):
        base = mod.get_config("default")
        o = _over()
        out.append(dataclasses.replace(
            base, frontend=mod.FrontendConfig(**o["frontend"]),
            data=mod.DataConfig(**o["data"])))
    return out


def _noisy_tone(rng, n, freq, rate=16000):
    return (0.3 * np.sin(2 * np.pi * freq * np.arange(n) / rate)
            + 0.02 * rng.randn(n)).astype(np.float32)


def _make_corpus(root, n=12, seed=0):
    """WAV, SPHERE, .npy-feature and 8 kHz mu-law records, lengths 0.3-2 s
    (one of exactly 400 samples: a single frame)."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    recs = []
    for i in range(n):
        n_s = 400 if i == 3 else int((0.3 + 1.7 * rng.rand()) * 16000)
        wav = _noisy_tone(rng, n_s, 200 + 50 * i)
        text = " ".join(["hello", "world", "test"][: 1 + i % 3])
        if i % 4 == 1:
            name = f"u{i:03d}.sph"
            audio_io.write_sphere(os.path.join(root, name), wav, 16000)
        elif i % 4 == 2:
            name = f"u{i:03d}.npy"
            feats = rng.randn(40 + i, 40).astype(np.float32)
            np.save(os.path.join(root, name), feats)
            recs.append({"id": f"u{i:03d}", "feats": name, "text": text,
                         "frames": 40 + i})
            continue
        else:
            name = f"u{i:03d}.wav"
            audio_io.write_wav(os.path.join(root, name), wav, 16000)
        recs.append({"id": f"u{i:03d}", "audio": name, "text": text,
                     "samples": n_s, "rate": 16000})
    wav8k = _noisy_tone(rng, 12000, 300, rate=8000)
    audio_io.write_sphere(os.path.join(root, "r8k.sph"), wav8k, 8000,
                          coding="ulaw")
    recs.append({"id": "r8k", "audio": "r8k.sph", "text": "hi",
                 "samples": 12000, "rate": 8000})
    recs.append({"id": "nometa", "audio": "u000.wav", "text": "no meta"})
    write_manifest(root, "train", recs)
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _make_corpus(str(tmp_path_factory.mktemp("torch_corpus")))


def _loud_in_every_frame(ds, i):
    """[n_mels] bands of utterance i whose mel energy is >= LOUD of the
    frame's largest band in every valid frame (all bands for features)."""
    rec = ds.records[i]
    fe = ds.cfg.frontend
    if "audio" not in rec:
        return np.ones(fe.n_mels, bool)
    wav, _ = audio_io.read_audio(ds._abspath(rec["audio"]),
                                 target_rate=fe.sample_rate)
    mel = F.mel_energies(torch.from_numpy(wav), fe).numpy()
    return (mel >= LOUD * mel.max(axis=-1, keepdims=True)).all(axis=0)


class TestAudioIO:
    @pytest.mark.parametrize("fmt", ["wav", "sph-pcm", "sph-ulaw",
                                     "wav-f32"])
    @pytest.mark.parametrize("writer_is_port", [True, False])
    def test_round_trip_against_the_reference(self, tmp_path, rng, fmt,
                                              writer_is_port):
        w, r = ((audio_io, jax_audio_io) if writer_is_port
                else (jax_audio_io, audio_io))
        wav = (0.5 * rng.randn(3000)).clip(-1, 1).astype(np.float32)
        path = str(tmp_path / ("a.sph" if fmt.startswith("sph") else "a.wav"))
        if fmt == "wav":
            w.write_wav(path, wav, 16000)
        elif fmt == "wav-f32":
            np.save(path[:-4] + ".npy", wav)
            path = path[:-4] + ".npy"
        else:
            w.write_sphere(path, wav, 8000,
                           coding="ulaw" if fmt == "sph-ulaw" else "pcm")
        got, rate = r.read_audio(path)
        want, want_rate = w.read_audio(path)
        assert rate == want_rate
        np.testing.assert_array_equal(got, want)
        assert r.audio_info(path) == w.audio_info(path)
        assert (r.num_samples(path, target_rate=16000)
                == w.num_samples(path, target_rate=16000))

    def test_resample_and_codecs_equal_the_reference(self, rng):
        x = rng.randn(4001).astype(np.float32)
        for a, b in ((8000, 16000), (16000, 8000), (22050, 16000)):
            np.testing.assert_array_equal(audio_io.resample(x, a, b),
                                          jax_audio_io.resample(x, a, b))
        np.testing.assert_array_equal(audio_io._mulaw_decode_table(),
                                      jax_audio_io._mulaw_decode_table())
        np.testing.assert_array_equal(audio_io._alaw_decode_table(),
                                      jax_audio_io._alaw_decode_table())


class TestManifestParity:
    def test_frame_lengths_and_labels_equal_the_reference(self, corpus):
        cfg, jcfg = _cfgs()
        ds = ManifestDataset(corpus, cfg)
        jds = jax_manifest.ManifestDataset(corpus, jcfg)
        np.testing.assert_array_equal(ds.frame_lengths, jds.frame_lengths)
        assert ds.payload_reads == 0
        for a, b in zip(ds._labels, jds._labels):
            np.testing.assert_array_equal(a, b)
        assert [r["id"] for r in ds.records] == [r["id"] for r in jds.records]

    def test_features_match_the_reference(self, corpus):
        cfg, jcfg = _cfgs()
        ds = ManifestDataset(corpus, cfg)
        jds = jax_manifest.ManifestDataset(corpus, jcfg)
        k = 2 * cfg.frontend.context + 1
        quiet_seen = False
        for i in range(len(ds)):
            got, labels = ds[i]
            want, _ = jds[i]
            assert got.shape == want.shape, i
            assert got.shape[0] == ds.frame_lengths[i], i
            loud = np.tile(_loud_in_every_frame(ds, i), k)
            quiet_seen |= not loud.all()
            if got.size:
                err = np.abs(got - want)[:, loud].max()
                assert err <= FEAT_TOL, (ds.records[i]["id"], err)
        assert quiet_seen          # the 8 kHz file's upper bands

    def test_dither_is_seeded_by_the_utterance(self, corpus):
        cfg, _ = _cfgs()
        cfg = cfg.override(**{"frontend.dither": 1e-3})
        a, b = ManifestDataset(corpus, cfg), ManifestDataset(corpus, cfg)
        np.testing.assert_array_equal(a[0][0], b[0][0])
        # the same file under another index gets other noise
        assert a.records[-1]["audio"] == a.records[0]["audio"]
        assert not np.array_equal(a[0][0], a[len(a) - 1][0])


class TestLazyDataset:
    def test_frame_lengths_without_payload_reads(self, corpus):
        cfg, _ = _cfgs()
        ds = ManifestDataset(corpus, cfg)
        fl = ds.frame_lengths
        assert ds.payload_reads == 0 and len(fl) == len(ds)
        view = ds[2:7]
        assert isinstance(view, DatasetView)
        np.testing.assert_array_equal(view.frame_lengths, fl[2:7])
        np.testing.assert_array_equal(view[1:3].frame_lengths, fl[3:5])
        assert [len(x) for x in label_seqs_of(view)] == [
            len(ds._labels[i]) for i in range(2, 7)]
        assert ds.payload_reads == 0

    def test_lazy_matches_eager_and_metadata(self, corpus):
        cfg, _ = _cfgs()
        ds = ManifestDataset(corpus, cfg)
        eager = load_manifest_dataset(corpus, cfg)
        for i in range(len(ds)):
            f_lazy, l_lazy = ds[i]
            np.testing.assert_array_equal(f_lazy, eager[i][0])
            np.testing.assert_array_equal(l_lazy, eager[i][1])
            assert f_lazy.shape[0] == ds.frame_lengths[i]

    def test_loader_streams_only_consumed_batches(self, corpus):
        cfg, _ = _cfgs()
        ds = ManifestDataset(corpus, cfg)
        loader = BucketedLoader(ds, cfg.data)
        assert ds.payload_reads == 0
        next(loader.epoch(0))
        assert 0 < ds.payload_reads <= cfg.data.batch_size

    def test_lru_cache_bounds(self, corpus):
        cfg, _ = _cfgs()
        ds = ManifestDataset(corpus, cfg, cache_items=4)
        for i in range(12):
            ds[i % 6]
        assert len(ds._cache) <= 4
        before = ds.payload_reads
        ds[5]
        assert ds.payload_reads == before


class TestPrefetch:
    def test_order_cursors_and_tensors(self, corpus):
        cfg, _ = _cfgs()
        loader = BucketedLoader(ManifestDataset(corpus, cfg), cfg.data)
        plain = list(loader.epoch(1, start_batch=1))
        got = list(prefetch_to_device(loader.epoch(1, start_batch=1),
                                      "cpu"))
        assert [c for c, _, _ in got] == [c for c, _ in plain] \
            == list(range(1, loader.num_batches(1)))
        for (_, batch, dev), (_, want) in zip(got, plain):
            ref = batch_to_tensors(batch_to_device_dict(want), "cpu")
            assert set(dev) == set(ref)
            for k in ref:
                assert dev[k].dtype == ref[k].dtype
                assert torch.equal(dev[k], ref[k]), k
            np.testing.assert_array_equal(batch.utt_indices,
                                          want.utt_indices)

    def test_loader_error_reaches_the_consumer(self, corpus):
        cfg, _ = _cfgs()
        loader = BucketedLoader(ManifestDataset(corpus, cfg), cfg.data)

        def failing():
            it = loader.epoch(0)
            yield next(it)
            raise OSError("disk gone")
        got = []
        with pytest.raises(OSError, match="disk gone"):
            for item in prefetch_to_device(failing(), "cpu"):
                got.append(item[0])
        assert got == [0]

    def test_early_stop_ends_the_thread(self):
        made = []

        def endless():
            i = 0
            while True:
                made.append(i)
                yield i, _tiny_batch(i)
                i += 1
        before = threading.active_count()
        it = prefetch_to_device(endless(), "cpu", size=2)
        assert next(it)[0] == 0
        it.close()
        deadline = time.time() + 10
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.05)
        assert threading.active_count() == before
        assert len(made) <= 5          # it stopped a few batches ahead


def _tiny_batch(i):
    from tpu_ctc_torch.data.bucketing import make_batch
    return make_batch([(np.full((3, 2), i, np.float32),
                        np.array([1], np.int32))], 4, 2, 1, indices=[i])
