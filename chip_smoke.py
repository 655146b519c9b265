#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_ctc_torch``) on one NVIDIA GPU.

Drives the port's two main paths and holds each CUDA kernel on them
against its plain PyTorch version on the same inputs:

  1. the card: name and power limit, and the build of every kernel from
     ``tpu_ctc_torch/csrc`` (one ``nvcc`` per source, all started together),
     with each compiled kernel's registers and spill bytes, and the number
     of tensor-core (HMMA) instructions in each of the four instances of
     B5/B6's template: nonzero in the GRU instances, zero in the n-gram
     ones;
  2. kernel B1 (``ops/birnn_cuda.py``, the forward BiRNN recurrence) at
     H = 1824, B = 64, T = 800, bf16, both directions; its time also in
     microseconds a step;
  3. kernel B5 (``ops/beam_cuda.py``, the fused prefix beam search) at
     B = 64, T = 800, A = 29, K = 128 with a trigram, and the walk of the
     best slot's backpointers (``reconstruct_cuda``, a kernel of the same
     source) bit-equal to the plain walk; the wrapper's time with the walk
     kernel and with the plain walk;
  4. serving, end to end: preset 4 (``swbd_beam_decode``: 2 dense
     pre-layers and 5 bidirectional layers at H = 1824, vocab 29, bf16
     compute; K = 128 with a trigram char LM), 64 synthetic utterances
     (400-800 frames) through ``BucketedLoader`` and ``make_beam_decoder``
     on random seeded weights; the walk and the wrapper on its posteriors;
     the dense layers' bf16 GEMMs against the f32 GEMMs they replaced
     (log posteriors, device ms);
  5. kernel B2 (``ops/birnn_cuda.py``, the backward delta sweep) at
     H = 1024, B = 32, T = 800, bf16, both directions, on states that B1
     computed at that shape (held against B1's plain version and timed
     too: preset 2's B1);
  6. kernels B3 and B4 (``ops/ctc_cuda.py``, the CTC alpha and beta sweeps)
     at B = 32, T = 800, A = 29, labels of 50-100 characters (S <= 201),
     bit-equal to the plain sweeps, with ``torch.nn.functional.ctc_loss``
     timed beside them (``torch_tools/ctc_dp_turns.py`` times them against
     another commit's source);
  7. training, end to end: preset 2 (``timit_full_3layer``: 1 dense
     pre-layer and 3 bidirectional layers at H = 1024, bf16 compute,
     Nesterov SGD with clipping at 5) on 64 synthetic utterances (two
     800-frame batches of 32), the step of ``make_train_step`` as
     ``train`` calls it (on one card the compiled step: one CUDA graph per
     batch shape) from seeded random weights, bit-equal over its 6 steps
     on both batches to the eager ``train_step`` from the same seed (loss,
     metrics, parameters, trace), each one's ms and host ms a step, idle
     share and device operations a step, the launches, the capture's
     seconds and shapes, and the reserved memory; the CTC loss at the
     label width rounded up to 32 against the longest label; the loss and
     gradients against the plain path and against the f32 GEMMs that the
     bf16 GEMMs replaced; two steps from the same seeded state on the same
     batch, outside PyTorch's deterministic mode, bit-equal in loss and
     parameters;
  8. kernel B5's GRU char-LM branch at B = 64, T = 800, A = 29, K = 128,
     a seeded GRU at E = 64, H = 128, and the trigram;
  9. kernel B6 (K in (128, 256], the same source) at K = 256 with the
     trigram (equal to the plain search slot by slot) and at K = 200 with
     the GRU and the trigram;
 10. the GRU decode end to end, as ``cli decode --beam --set
     decode.neural_lm=True`` runs it: ``train_nlm_from_data`` trains the GRU
     char LM (300 Adam steps) on the transcripts of 64 synthetic
     utterances, then preset 4 decodes them at K = 128 (B5) and at K = 200
     (B6) with the GRU fused beside the trigram; the walk and the wrapper
     on each K's posteriors;
 11. audio in, text out: 96 + 32 synthetic tone waveforms of 4-8 s written
     as a manifest corpus (WAV files) under ``build/chip_smoke_audio``; the
     frontend (``frontend/features.py``, preset 2's 40 mels and context 1)
     on 64 of them on the card and on the CPU against a float64 numpy
     oracle, with its times and the CPU rate of ``ManifestDataset``; the
     frontend pool (``ManifestDataset(workers=host_workers())``: worker
     processes forked by a fork server) bit-equal to the in-process dataset on every utterance;
     ``torch_tools/audio_path_breakdown.py`` at preset 2's shape and the
     accuracy chain's (reads, the frontend's operators and the rest,
     ``make_batch``, pin and copy, the consumer's wait, the step's host
     time, the device's idle share, ``ManifestDataset`` alone and beside
     the step), in process and with the pool, each path's ms a step and
     audio-s/s beside the same batches in memory (the compiled step, and
     the eager one's ms, host ms and idle share beside it) and phase 7's;
     ``cli
     train --config 2 --data`` (two epochs, ``train.eval_beam``: B1-B5 and
     the walk), the loss on one batch from the seeded weights and from the
     checkpoint; ``model.remat`` bit-equal (outside deterministic mode)
     with B1 launched twice as often and both peaks printed;
     ``cli decode --checkpoint --split valid --beam``, ``score``,
     ``export-weights`` and ``decode --weights`` (the same hypotheses, the
     manifest's ids); ``batched_edit_distance`` on the card equal to the
     host's; ``cli decode --config 4 --data --beam`` and its loop timed and
     profiled with the frontend in the wall, in process and with the pool,
     beside phase 4's; prefetched batches bit-equal to the loader's own,
     in process and through the pool.

 12. B1 from a nonzero carry and the distributed step: B1 from h0 at
     preset 3's width (H = 1824, B = 64, bf16) over T = 1600 as 4 chunks
     of 400 and at preset 2's (H = 1024, B = 32) over T = 800 as 2
     chunks, both directions, each chunk against the plain loop from the
     same h0 and the chain bit-equal to one sweep, a chunk from h0 timed
     beside the same chunk from zero; ``CarryRecurrence``'s backward (B2,
     the GEMMs) against its plain autograd at preset 2's width; preset 3
     (``swbd_5layer_dp``) at B = 64 for 3 steps through ``make_mesh`` and
     ``make_train_step`` with a one-rank NCCL group (the compiled step),
     bit-equal to ``train_step``, and the step's gradient all-reduce
     captured in a CUDA graph over that group, two replays bit-equal to
     the eager call; then the same steps over several ranks
     (``nvidia-smi -L``): on 2 or more cards NCCL ranks, one card each,
     DP2 and SP2, each the compiled step (one CUDA
     graph per batch shape, collectives included) against the eager mesh
     step from the same seed, bit-equal in metrics, parameters, trace and
     launch counts on every rank, with the shapes captured and their
     capture seconds; on one card SP2 as two gloo ranks sharing it, which
     stay eager (the phase prints why); each mesh's loss within 1e-3 of
     one card's, the parameters bit-equal across ranks, with the step
     time and audio-s/s; then preset 2 from audio (96 WAV files, 32
     more to evaluate) through ``train.loop.train`` under DP2, SP2 and
     TP2 (two gloo ranks sharing one card, or NCCL ranks on two; one
     spawn for the three), each rank's loader featurizing only its share
     of the rows its step reads in its own frontend pool (on a 'seq' or
     'model' line half of them, the other half exchanged over a gloo
     group of the loader's own): each rank's payload reads per epoch and
     per eval (about half of one rank's), its blocks bit-equal to
     ``local_batch`` of one card's global batches, the parameters
     bit-equal across ranks, the row exchanges' ms, the job's audio-s/s
     beside the same mesh on the same blocks in memory.
 13. the benchmarks and the tools: ``tpu_ctc_torch.bench.bench`` at its
     defaults (the CPU reference on one utterance) with its JSON line (the
     compiled step's audio-s/s; the eager step's beside it on stderr) and
     the step's MFU; ``bench_ctc`` at its shape (3 calls a row, 2 of the
     plain loop), its spot check and B3 +
     B4's device time within 20% of their CUDA-event time over runs of
     back-to-back launches at its shape (phase 6's single-call medians
     scaled to T = 1600 printed beside it);
     ``bench_decode --preset4 --skip-plain`` and ``bench_decode
     --host-utts 1``; the C++ host decoder (``decode/cpp_decoder.py``)
     against B5 on phase 3's posteriors and trigram (no pruning: the C++
     search has none), beside the plain search in float32 and in float64:
     the C++ decoder equal to the float64 search everywhere, and to B5
     (hypotheses, scores within ``torch_tools/cpp_b5.py``'s limit) on
     every utterance where the float32 and float64 searches do not part;
     ``torch_tools/smoke_cuda_decode.py``; ``preset_fit --budget --step`` for presets 2
     and 3 (B = 8), the budget beside the measured peak; ``bench_scaling
     --strategy dp`` over 1 and all the cards ``nvidia-smi -L`` lists;
     then the tools under ``build/chip_smoke_tools``:
     ``make_sample_corpus``, ``make_manifest --layout timit``, a 2-point
     ``sweep_decode`` of phase 11's checkpoint on the card, ``cli decode``
     at its best point (its CER printed beside the sweep's) and
     ``score``.  The benches' launches are not a main path's: the counts
     are zeroed before the phase and not read.
 14. preset 5's width and the 'model' axis: B1/B2's wide instance (H
     above 16 columns a resident block) at H = 4096, B = 16 (a rank's rows
     of preset 5 under model = 4), T = 1600, bf16 and f32, against the
     plain loops (B1 from zero and from h0 both ways, B2 on B1's states),
     two launches bit-equal, timed with its bound and launch plan (the f32
     sweeps faster than the plain f32 loops timed beside them), and B1
     at H = 1824 still on the narrow instance; preset 5 (H = 4096, 2 dense
     + 5 bidirectional layers) under tensor parallelism, model = 2 at a
     global B = 8, T = 200 (two gloo ranks sharing the card, or NCCL ranks
     on 2-3 cards; model = 4 at B = 64, T = 800 on 4 or more), bf16 and
     f32, 2 steps against one card's ``train_step``; preset 2 as 3
     pipeline stages, M = 4, B = 32, T = 400; on NCCL ranks both the
     compiled step against the eager mesh step, as in phase 12 (gloo
     ranks stay eager, and the phase says so); the collective decode of
     preset 4 over 2 ranks with the length-balancing redistribution, its
     hypotheses on phase 4's posteriors bit-equal to the one-card decode;
     ``python -m tpu_ctc_torch.dryrun`` under torchrun over 2 ranks (run
     beside phase 15's ``eval_chain.py``, whose walls no check reads, so
     that it shares the card with no timed part).  The
     wide instance's records (``birnn_fwd_wide``, ``birnn_bwd_wide``) are
     kernels of their own in the JSON line, and B1's and B2's records
     carry their ``wide_launches`` and ``wide_ms``.
 15. the accuracy chain of ``docs/EVAL.md`` at a cut size.  First each
     of its kernels at the shapes the chain gives them against its plain
     version, at its own phase's limits: B1/B2 bf16 at H = 512, B = 16,
     T = 320; B3/B4 at B = 16, T = 320, S <= 129; B5 at K = 64 with the
     trigram, the GRU and both, the walk; B6 at K = 200 with the trigram.
     Then ``torch_tools/eval_chain.py`` (each step a subprocess of the
     port's tools and CLI) on 120 synthesized SPHERE utterances (the
     corpus and its manifests made in process and passed with
     ``--data``), preset 2
     at H = 512 with 3 bidirectional layers trained 60 + 15 + 5 epochs in
     three runs at 0.02, 0.005 and 0.0015 (the later two resumed), 2 x 2
     dev sweeps of the trigram, the GRU char LM (50 Adam steps) and both,
     the valid split decoded greedy, by each system at its dev-best point
     and by the trigram at K = 200, and scored with CIs and paired
     bootstraps, every pair scored; the losses finite and falling, the
     steps the loader's plan, B1-B4 launched in training, B5's n-gram and
     GRU instances, B6 and the walk in the decodes; the ladder's WERs
     printed (a cut model: not the accuracy result) and whether two GRU
     trainings are bit-equal.

Each main path (phases 4, 7, both widths of 10, phase 11's training and
its decodes, phase 12's mesh runs (the compiled step's turn where the
ranks are NCCL's), phase 14's TP, PP and
collective-decode runs, the ranks' launches summed, and phase 15's
chain, its subprocesses' launches summed) is
run with every launch count set to 0 just before it and
read just after (a CUDA graph's replay adds the launches its capture
made, ``tpu_ctc_torch/train/graphs.py``); a kernel's ``launches`` in the
record is the sum over the paths that run it.  The profile of each
path prints its dense GEMMs' device ms.  B5 has two records,
told apart by ``variant``: ``trigram`` (phase 3, launched on phase 4's
and phase 11's paths) and ``gru+trigram`` (phase 8, launched on phase
10's).  The GRU's sums run in
another order in a kernel than in the plain version's matmuls, so over 800
frames its scores drift apart by float rounding: the GRU checks hold
hypotheses equal on every utterance whose top-2 beam gap exceeds 1e-2 and
scores within 1e-2, and explain every utterance that fails: its beams must
first part where two candidates tied within that drift swap places at the
beam boundary (searched over the utterance's length, the probes of every
such utterance sharing one batch of the phase's B rows a pass).  Every check raises on failure, so
the script exits non-zero and prints no result line.  Every time, of a
kernel and of its plain version alike, is the median of CUDA-event times of
single calls after a warm-up call (``REPS`` calls of a kernel,
``PLAIN_REPS`` of a plain version; a plain beam search's warm-up call is
its check's own).  The last two lines are the per-kernel
JSON record (B1's with ``h0_launches``, its launches from a carry on the
sequence-parallel ranks) and ``{"ok": true, "device": {...}}``.

The script runs the phases in a child process of its own
(``chip_smoke.py --run``) and is the child subreaper of that run, so a
process orphaned anywhere below it (a pool's worker, a rank of torchrun,
the multiprocessing resource tracker) becomes its child.  When the run has
ended it waits up to ten seconds for such processes to end, kills the
rest, and names each on stderr: no process it started outlives it.
Each line of the run's log starts with its seconds since the start, and
each phase (and each bench and tool of phase 13) ends with its wall
time: the script must finish well inside the 1200 s that the card's
check gives it.

    python3 chip_smoke.py                 # all fifteen phases, one card
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM bandwidth and its operations
# over the peak rate of their type.  The data sheet's 67 TFLOP/s of f32
# counts an FMA as two operations; scalar adds, multiplies and compares
# issue at half that, one per FP32 lane per clock.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS = 989e12
SCALAR_INSTR_PER_S = 67e12 / 2
# B5 and B6 take the GRU's products on the tensor cores in the three-pass
# TF32 split (f32 accuracy, as the reference's Precision.HIGHEST): three
# TF32 products for each, so the f32-accurate rate is a third of the dense
# TF32 peak (495 TFLOP/s).
TF32_SPLIT_FLOP_PER_S = 495e12 / 3
REPS = 5                        # timed calls per kernel, after a warm-up
PLAIN_REPS = 1                  # timed calls per plain version (each
                                # 50-3500 ms: the run's time limit)

BIRNN_SOURCE = "tpu_ctc_torch/csrc/birnn.cu"          # B1 and B2
B1_REPLACES = "tpu_ctc/ops/birnn_pallas.py:103"
B5_SOURCE = "tpu_ctc_torch/csrc/beam_search.cu"
B5_REPLACES = "tpu_ctc/ops/beam_pallas.py:197"
# (K, kNlm) of the four instances of beam_kernel<kMaxK, kNlm>: B5 and B6,
# each with and without the GRU
BEAM_INSTANCES = [(128, False), (128, True), (256, False), (256, True)]
B6_REPLACES = "tpu_ctc/ops/beam_pallas.py:696"
B2_REPLACES = "tpu_ctc/ops/birnn_pallas.py:167"
B34_SOURCE = "tpu_ctc_torch/csrc/ctc_dp.cu"
# The walk replaces the reference's jax.lax.scan, not a Pallas kernel.
WALK_REPLACES = "tpu_ctc/ops/beam_pallas.py:1191"
KERNEL_ORDER = ["birnn_fwd", "birnn_fwd_wide", "birnn_bwd",
                "birnn_bwd_wide", "ctc_alpha", "ctc_beta", "beam_search",
                "beam_search_wide", "beam_reconstruct"]
# f32 products on the FP32 pipe: the data sheet's 67 TFLOP/s counts an FMA
# as two operations, as a product's 2 M N K does.
F32_FMA_OPS = 67e12
# Device kernels of the dense products (cuBLAS names them so on an H100).
GEMM_NAME = re.compile(r"gemm|nvjet|xmma|cutlass", re.IGNORECASE)
B3_REPLACES = "tpu_ctc/ops/ctc_pallas.py:134"
B4_REPLACES = "tpu_ctc/ops/ctc_pallas.py:190"
# Phase 7's bound on |g_kernel - g_plain| / |g_plain| per parameter.  The
# two paths share every bf16 rounding point and differ only in the order
# of f32 sums, but the cotangent is rounded to bf16 at each dense layer, so
# a change of order flips bf16 ulps there.  On the CPU, with the paths
# differing in the CTC's sum order alone, the gradients differ by
# 1.5-1.7e-3; bf16 against f32 by ~2e-2; a weight gradient paired with the
# wrong frame by O(1) (tests/test_torch_train.py::
# test_bf16_gradient_tolerance_of_the_chip_check).
GRAD_REL_TOL = 1e-2
LOSS_REL_TOL = 1e-3
# Phase 4's bound on |lp_bf16_gemms - lp_f32_gemms|: the dense layers' bf16
# GEMMs (f32 output) change only the order of the f32 sums (2.9e-5 on an
# H100); an output rounded to bf16 would move log posteriors of |lp| ~3 by
# ~2^-9 |logit|, several 1e-3.
GEMM_LP_TOL = 1e-3
# The GRU-LM searches (phases 8-10): hypotheses are compared where the
# plain search's top-2 beam gap exceeds GRU_GAP, scores within GRU_TOL (the
# reference's own kernel drifts ~2e-3 from its XLA search over 400 frames).
GRU_GAP = 1e-2
GRU_TOL = 1e-2
# Phase 11's frontend limits (PERF.md section 2): the power spectrum within
# POWER_TOL of each frame's peak power; features within FEAT_TOL in the
# bands whose mel energy is at least LOUD of the frame's largest band in
# every frame of the utterance.
POWER_TOL = 1e-5
FEAT_TOL = 1e-3
LOUD = 1e-6


_T0 = time.time()


def log(msg: str) -> None:
    """Print ``msg`` after the seconds since this module was imported: the
    run's clock, which tells where its time goes."""
    print(f"[{time.time() - _T0:7.1f}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median time of one ``fn()`` call in ms, after one warm-up call:
    CUDA events around each of ``reps`` calls."""
    fn()
    return warm_ms(fn, reps)


def warm_ms(fn, reps: int) -> float:
    """:func:`time_ms` of a ``fn`` that has just run once (its warm-up):
    a plain beam search, whose check's call warms it, takes seconds."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def all_kernels():
    from tpu_ctc_torch.ops import kernels
    return kernels()


@contextlib.contextmanager
def f32_dense_products():
    """The dense products as the parent commit ran them: each bf16 GEMM
    replaced by the f32 GEMM (TF32 off) of the same values."""
    from tpu_ctc_torch.ops import birnn_cuda
    saved = birnn_cuda.matmul_bf16
    birnn_cuda.matmul_bf16 = lambda a, b: birnn_cuda.matmul_f32(
        a.to(torch.float32), b.to(torch.float32))
    try:
        yield
    finally:
        birnn_cuda.matmul_bf16 = saved


@contextlib.contextmanager
def plain_walk():
    """``beam_search_cuda`` as the parent commit ran it: the backpointer
    walk as a loop of gathers from the host."""
    from tpu_ctc_torch.ops import beam_cuda
    saved = beam_cuda.reconstruct_cuda
    beam_cuda.reconstruct_cuda = beam_cuda.reconstruct_plain
    try:
        yield
    finally:
        beam_cuda.reconstruct_cuda = saved


def demangle(names):
    """Kernel names as ``c++filt`` shows them (template arguments kept,
    namespace and parameters dropped); the names unchanged without it."""
    try:
        full = subprocess.run(["c++filt"], input="\n".join(names),
                              capture_output=True, text=True,
                              timeout=60).stdout.splitlines()
    except OSError:
        full = []
    if len(full) != len(names):
        return list(names)
    return [f.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for f in full]


def sass_mma_counts(library: str):
    """{kernel: number of HMMA (tensor-core) instructions} in a built
    library's SASS (``cuobjdump --dump-sass``, beside ``nvcc``)."""
    from tpu_ctc_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    return dict(zip(demangle(list(counts)), counts.values()))


def beam_instance(name: str):
    """(K, kNlm) of an instance of B5/B6's ``beam_kernel<kMaxK, kNlm>``
    from its name, demangled or mangled; None for another kernel."""
    m = (re.search(r"beam_kernel<(\d+), (true|false)>", name)
         or re.search(r"beam_kernelILi(\d+)ELb([01])E", name))
    return None if m is None else (int(m.group(1)),
                                   m.group(2) in ("true", "1"))


def ptxas_summary(build_log: str):
    """One line per compiled kernel of an ``nvcc -Xptxas -v`` log: its
    name (demangled where ``c++filt`` exists), registers and spill bytes."""
    rows, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), ""
        elif name and "spill" in line:
            spill = ", ".join(p.strip() for p in line.split(",")[1:])
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            rows.append([name, f"{regs.group(1) if regs else '?'} "
                               f"registers, {spill}"])
            name = None
    names = demangle([r[0] for r in rows])
    return [f"{n}: {rest}" for n, (_, rest) in zip(names, rows)]


def phase_build():
    from tpu_ctc_torch.ops import _build
    log(f"phase 1: card {card_line()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    logs = _build.build_all(all_kernels())
    log(f"phase 1: built {len(logs)} kernels from "
        f"{len({k.library for k in all_kernels()})} sources in "
        f"{time.time() - t0:.1f} s")
    shown = set()
    for kern in all_kernels():
        if kern.library in shown:
            continue
        shown.add(kern.library)
        for line in ptxas_summary(logs[kern.name]):
            log(f"  ptxas {os.path.basename(kern.source)} {line}")
    # B5/B6's GRU instances run their products on the tensor cores; the
    # n-gram instances have no tensor-core path.
    from tpu_ctc_torch.ops import beam_cuda
    found = {}
    for name, n in sass_mma_counts(beam_cuda.KERNEL.library).items():
        log(f"  sass {os.path.basename(beam_cuda.KERNEL.source)} {name}: "
            f"{n} HMMA instructions")
        inst = beam_instance(name)
        if inst is not None:
            found[inst] = n
            if (n > 0) != inst[1]:
                raise AssertionError(f"{name}: {n} HMMA instructions")
    if sorted(found) != BEAM_INSTANCES:
        raise AssertionError(f"beam_kernel instances in the SASS: "
                             f"{sorted(found)}, expected {BEAM_INSTANCES}")


def run_main_path(run):
    """``run()`` with every launch count set to 0 just before it; returns
    (its result, {kernel name: launches during it})."""
    for kern in all_kernels():
        kern.launches = 0
    out = run()
    return out, {k.name: k.launches for k in all_kernels()}


def phase_birnn(reps: int, n_t=800, n_b=64, n_h=1824, dev="cuda",
                phase="phase 2"):
    """B1 against its plain loop: H = 1824, B = 64, T = 800, bf16."""
    from tpu_ctc_torch.ops import birnn_cuda
    r = np.random.RandomState(1)
    z = torch.from_numpy(3.0 * r.randn(n_t, n_b, n_h).astype(np.float32))
    w = torch.from_numpy((0.5 / np.sqrt(n_h))
                         * r.randn(2, n_h, n_h).astype(np.float32))
    lens = torch.from_numpy(r.randint(n_t // 2, n_t + 1, n_b).astype(np.int32))
    z, w, lens = (z.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16),
                  lens.to(dev))
    err, states = 0.0, []
    for d, reverse in enumerate((False, True)):
        got = birnn_cuda.fwd_recurrence_cuda(z, w[d], lens, reverse=reverse,
                                             clip=20.0).float()
        states.append(got)
        torch.cuda.synchronize()
        want = birnn_cuda.fwd_recurrence_plain(z, w[d], lens,
                                               reverse=reverse,
                                               clip=20.0).float()
        diff = (got - want).abs()
        # bf16 h_t: the two sum the f32 dot in different orders, so a
        # stored state may round the other way (one bf16 ulp is 2^-8 of
        # its value); the recurrence (gain ~0.5) does not amplify it.
        tol = 2 ** -6 * want.abs() + 2e-2
        bad = int((diff > tol).sum())
        err = max(err, float(diff.max()))
        log(f"{phase}: B1 H={n_h} B={n_b} T={n_t} "
            f"{'reversed' if reverse else 'forward'} max abs "
            f"err {float(diff.max()):.3e}, {bad} beyond tolerance, "
            f"max |h| {float(want.abs().max()):.2f}")
        if bad:
            raise AssertionError("B1 disagrees with its plain version")
    ms = time_ms(lambda: birnn_cuda.fwd_recurrence_cuda(
        z, w[0], lens, reverse=False, clip=20.0), reps)
    plain_ms = time_ms(lambda: birnn_cuda.fwd_recurrence_plain(
        z, w[0], lens, reverse=False, clip=20.0), PLAIN_REPS)
    # What the timed forward sweep needs: z read at live frames only (a
    # padded frame's h is 0 whatever z holds), hs written in full, W and
    # the lengths read once; h_{t-1} @ W at each live frame over the
    # nonzero entries of h_{t-1} alone (a sparse product: the clipped-ReLU
    # zeros add nothing).
    live_tb = (torch.arange(n_t, device=dev)[:, None] < lens[None, :])
    hs_f = states[0]
    prev_nnz = torch.cat([torch.zeros_like(hs_f[:1]), hs_f[:-1]]).ne(0).sum(2)
    n_bytes = ((int(live_tb.sum()) + n_t * n_b) * n_h * 2 + n_h * n_h * 2
               + n_b * 4)
    n_ops = 2 * n_h * int((prev_nnz * live_tb).sum())
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_TENSOR_OPS)
    log(f"{phase}: B1 one direction {ms:.3f} ms ({ms * 1e3 / n_t:.2f} us a "
        f"step), plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"library: none (no PyTorch call computes a clipped-ReLU "
        f"recurrence)")
    return dict(name="birnn_fwd", route="cuda", source=BIRNN_SOURCE,
                replaces=B1_REPLACES, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def peaked_posteriors(seed, n_b, n_t, a=29):
    """log_softmax of 2 N(0, 1) logits (tools/smoke_tpu_decode.py)."""
    r = np.random.RandomState(seed)
    lp = torch.log_softmax(
        torch.from_numpy(2.0 * r.randn(n_b, n_t, a).astype(np.float32)), -1)
    lens = torch.from_numpy(r.randint(n_t // 2, n_t + 1, n_b).astype(np.int32))
    return lp, lens


def seeded_trigram(seed, a=29):
    from tpu_ctc_torch.decode.lm import train_ngram_lm
    r = np.random.RandomState(seed)
    seqs = [r.randint(1, a, size=r.randint(20, 120)) for _ in range(500)]
    return train_ngram_lm(seqs, vocab_size=a, order=3)


def check_walk(phase: str, lp, lens, kw, reps: int = REPS):
    """The search of ``kw`` (``beam_search_cuda``'s arguments) on lp, lens:
    the walk kernel's hypotheses bit-equal to the plain walk's on the
    kernel's backpointers, then the times of the search kernel, the walk
    kernel, the plain walk, and the wrapper (input prep, search, argmax,
    walk) with the walk kernel and, as before, with the plain walk.
    Returns (walk ms, plain walk ms)."""
    from tpu_ctc_torch.decode import beam
    from tpu_ctc_torch.ops import beam_cuda
    k, max_len = kw["beam_width"], kw["max_len"]
    prep = beam_cuda.prepare(lp, lens, k, lm_table=kw.get("lm_table"),
                             lm_order=kw.get("lm_order", 0),
                             char_topk=kw.get("char_topk", 0),
                             nlm_params=kw.get("nlm_params"))

    def search():
        return beam_cuda.launch(
            prep[0], prep[1], k, max_len, lm=prep[2],
            lm_order=kw.get("lm_order", 0), lm_alpha=kw.get("lm_alpha", 1.0),
            lm_beta=kw.get("lm_beta", 0.0), prune_logp=kw.get("prune_logp"),
            thr=prep[3], gru=prep[4])

    bp, fin = search()
    best = torch.argmax(beam._lse2(fin[:, 0], fin[:, 1]), dim=1)
    got = beam_cuda.reconstruct_cuda(bp, best, max_len)
    want = beam_cuda.reconstruct_plain(bp, best, max_len)
    if not torch.equal(got, want):
        raise AssertionError(f"{phase}: the walk kernel's hypotheses differ "
                             f"from the plain walk's")
    ms_search = time_ms(search, reps)
    ms_walk = time_ms(lambda: beam_cuda.reconstruct_cuda(bp, best, max_len),
                      reps)
    ms_plain = time_ms(lambda: beam_cuda.reconstruct_plain(bp, best,
                                                           max_len), reps)
    ms_wrap = time_ms(lambda: beam_cuda.beam_search_cuda(lp, lens, **kw),
                      reps)
    with plain_walk():
        ms_wrap_plain = time_ms(lambda: beam_cuda.beam_search_cuda(
            lp, lens, **kw), reps)
    log(f"{phase}: walk kernel hyps bit-equal to the plain walk's "
        f"(B={lp.shape[0]}, T={lp.shape[1]}, K={k}); search kernel "
        f"{ms_search:.3f} ms, walk kernel {ms_walk:.4f} ms, plain walk "
        f"{ms_plain:.3f} ms; wrapper (prep, search, argmax, walk) "
        f"{ms_wrap:.3f} ms, with the plain walk {ms_wrap_plain:.3f} ms")
    return ms_walk, ms_plain


def phase_beam(reps: int, n_b=64, n_t=800, k=128, max_len=216, dev="cuda",
               phase="phase 3"):
    """B5 against the plain search: B = 64, T = 800, A = 29, K = 128."""
    from tpu_ctc_torch.decode import beam
    from tpu_ctc_torch.ops import beam_cuda
    a = 29
    lp, lens = peaked_posteriors(2, n_b, n_t, a)
    lp, lens = lp.to(dev), lens.to(dev)
    lm = seeded_trigram(3, a).tables(dev)
    kw = dict(beam_width=k, max_len=max_len, lm_table=lm, lm_order=3,
              lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)
    got = beam_cuda.beam_search_cuda(lp, lens, **kw)
    want = beam.prefix_beam_search(lp, lens, **kw)
    err = float((got[2] - want[2]).abs().max())
    same = bool(torch.equal(got[1], want[1]) and torch.equal(
        got[0] * (torch.arange(max_len, device=dev) < got[1][:, None]),
        want[0] * (torch.arange(max_len, device=dev) < want[1][:, None])))
    log(f"{phase}: B5 K={k} B={n_b} T={n_t} hyps equal: {same}, max score err {err:.3e}, "
        f"mean hyp length {float(got[1].float().mean()):.1f}")
    if not same or err > 1e-3:
        raise AssertionError("B5 disagrees with the plain search")
    lp_k, lens_k, lm_k, _, _ = beam_cuda.prepare(lp, lens, k, lm_table=lm,
                                                lm_order=3)
    ms = time_ms(lambda: beam_cuda.launch(
        lp_k, lens_k, k, max_len, lm=lm_k, lm_order=3, lm_alpha=1.25,
        lm_beta=1.5, prune_logp=-12.0), reps)
    walk_ms, walk_plain_ms = check_walk(phase, lp, lens, kw, reps)
    plain_ms = warm_ms(lambda: beam.prefix_beam_search(lp, lens, **kw),
                       PLAIN_REPS)
    live = int(lens.sum())
    # the posteriors read and the backpointers written at live frames only
    n_bytes = (live * a * 4 + n_b * 4 + a ** 3 * 4 + live * k * 4
               + n_b * 3 * k * 4)
    # What the search needs per live frame, whatever the method: for each of
    # the A K candidates the add of its posterior, the LM lookup, the
    # alpha lm + beta (a multiply and an add) and one compare to select it;
    # for each of the K beams one log-sum-exp of (pb, pnb) (max, subtract,
    # exp, log, add).  All are counted at the scalar issue rate, which the
    # lookups and exp/log (slower units) do not reach: a lower bound.
    n_ops = live * (5 * a * k + 5 * k)
    b_ms, b_by = bound_ms(n_bytes, n_ops, SCALAR_INSTR_PER_S)
    log(f"{phase}: B5 {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); library: none (no PyTorch call computes "
        f"a prefix beam search)")
    # The walk needs the T backpointers on the best slot's path (one word
    # each), best and the hypotheses written; a few scalar operations per
    # frame.
    w_bytes = n_b * n_t * 4 + n_b * 8 + n_b * max_len * 4
    w_ms, w_by = bound_ms(w_bytes, 4 * n_b * n_t, SCALAR_INSTR_PER_S)
    log(f"{phase}: walk kernel {walk_ms:.4f} ms, plain walk "
        f"{walk_plain_ms:.3f} ms, bound {w_ms:.6f} ms ({w_by}); library: "
        f"none (no PyTorch call follows backpointers)")
    return [dict(name="beam_search", variant="trigram",
                 paths=("decode", "audio_train", "audio_decode",
                        "collective", "chain_ngram"),
                 route="cuda", source=B5_SOURCE, replaces=B5_REPLACES,
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=None),
            dict(name="beam_reconstruct",
                 paths=("decode", "gru", "audio_train", "audio_decode",
                        "collective", "chain"),
                 route="cuda", source=B5_SOURCE, replaces=WALK_REPLACES,
                 max_abs_err=0.0, ms=walk_ms, plain_ms=walk_plain_ms,
                 bound_ms=w_ms, bound_by=w_by, library_ms=None)]


def phase_end_to_end(seed: int, n_utts=64, dev="cuda", **overrides):
    """Preset 4 at full width: 64 synthetic utterances, one batch."""
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.synthetic import SyntheticCorpus
    from tpu_ctc_torch.decode import beam
    from tpu_ctc_torch.decode.lm import train_char_lm_from_data
    from tpu_ctc_torch.decode.wer import format_score_line, score_corpus
    from tpu_ctc_torch.models import birnn
    from tpu_ctc_torch.ops import beam_cuda, birnn_cuda
    from tpu_ctc_torch.train.loop import batch_to_device_dict

    cfg = get_config("swbd_beam_decode", **overrides)
    corpus = SyntheticCorpus(n_utts, feature_dim=cfg.model.input_dim,
                             min_chars=50, max_chars=100, seed=seed)
    data = corpus.all_utterances()
    lm = train_char_lm_from_data(data, cfg)
    model = birnn.init_params(cfg.model, seed=seed, device=dev)
    decode = beam.make_beam_decoder(cfg, lm=lm, device=dev)
    batches = [b for _, b in BucketedLoader(data, cfg.data).epoch(0)]
    n_frames = sum(int(b.frame_lengths[b.weights > 0].sum()) for b in batches)
    log(f"phase 4: preset {cfg.name}: {birnn.count_params(model)} params, "
        f"{len(batches)} batch(es) of {[b.feats.shape for b in batches]}, "
        f"{n_frames} frames")

    def run():
        return [decode(model, batch_to_device_dict(b)) for b in batches]

    run()                                   # warm-up: cuBLAS, LM table
    torch.cuda.synchronize()
    t0 = time.time()
    outs, launches = run_main_path(run)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: n for k, n in launches.items() if n}
    log(f"phase 4: decoded in {wall:.3f} s = {n_frames / 100 / wall:.1f} "
        f"audio-s/s; launches on the path {launches}")
    for kern in (birnn_cuda.KERNEL, beam_cuda.KERNEL, beam_cuda.RECONSTRUCT):
        if not launches.get(kern.name):
            raise AssertionError(f"kernel {kern.name} was not launched on "
                                 f"the main path")

    refs, hyps = {}, {}
    checked = agree = 0
    for batch, (hyp, hyp_len) in zip(batches, outs):
        feats = torch.as_tensor(batch.feats, device=dev)
        mask = torch.as_tensor(batch.frame_mask, device=dev)
        lens = torch.as_tensor(batch.frame_lengths, device=dev)
        with torch.no_grad():
            lp = birnn.log_posteriors(model, cfg.model, feats, mask)
            lp_plain = birnn.log_posteriors(
                model, dataclasses.replace(cfg.model, birnn_impl="scan"),
                feats, mask)
            with f32_dense_products():
                lp_f32 = birnn.log_posteriors(model, cfg.model, feats, mask)
        if lp.shape != (len(hyp), batch.feats.shape[1], 29) or not bool(
                torch.isfinite(lp).all()):
            raise AssertionError(f"log posteriors {tuple(lp.shape)} not "
                                 f"finite or of the wrong shape")
        lp_err = float((lp - lp_plain).abs().max())
        gemm_err = float((lp - lp_f32).abs().max())
        log(f"phase 4: log posteriors kernel vs plain max abs err "
            f"{lp_err:.3e} (limit 5e-2); bf16 GEMMs vs the f32 GEMMs they "
            f"replaced max abs err {gemm_err:.3e} (limit {GEMM_LP_TOL}) "
            f"(max |log posterior| {float(lp.abs().max()):.1f})")
        if lp_err > 5e-2:
            raise AssertionError("the model's kernel path disagrees with "
                                 "its plain path")
        if gemm_err > GEMM_LP_TOL:
            raise AssertionError("the dense layers' bf16 GEMMs disagree "
                                 "with the f32 GEMMs of the same values")
        max_len = int(hyp.shape[1])
        ph, pl, _, score, _, _ = beam.prefix_beam_search(
            lp, lens, beam_width=cfg.decode.beam_width, max_len=max_len,
            lm_table=lm.tables(dev), lm_order=lm.order,
            lm_alpha=cfg.decode.lm_alpha, lm_beta=cfg.decode.lm_beta,
            prune_logp=cfg.decode.prune_logp, return_beams=True)
        top2 = torch.topk(score, 2, dim=1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu()
        hyp, hyp_len, ph, pl = (x.cpu().numpy() for x in (hyp, hyp_len,
                                                           ph, pl))
        for i in range(len(hyp)):
            if batch.weights[i] <= 0:
                continue
            utt = int(batch.utt_indices[i])
            refs[utt] = corpus.alphabet.decode(
                batch.labels[i][:batch.label_lengths[i]])
            hyps[utt] = corpus.alphabet.decode(hyp[i][:hyp_len[i]])
            if float(gap[i]) > 1e-3:
                checked += 1
                agree += int(hyp_len[i] == pl[i] and np.array_equal(
                    hyp[i][:hyp_len[i]], ph[i][:pl[i]]))
    log(f"phase 4: hyps equal the plain search on {agree} of {checked} "
        f"utterances with a top-2 beam gap > 1e-3")
    if agree != checked:
        raise AssertionError("decoded hypotheses disagree with the plain "
                             "search")
    cer = score_corpus(refs, hyps, "char")[0]
    log(f"phase 4: {format_score_line(cer, 'char')} (random weights: not "
        f"a model quality number)")
    check_walk("phase 4", lp, lens, dict(
        beam_width=cfg.decode.beam_width, max_len=max_len,
        lm_table=lm.tables(dev), lm_order=lm.order,
        lm_alpha=cfg.decode.lm_alpha, lm_beta=cfg.decode.lm_beta,
        prune_logp=cfg.decode.prune_logp))
    bd = device_breakdown(run, "phase 4")
    with f32_dense_products():
        device_breakdown(run, "phase 4 with the f32 GEMMs")
    return launches, {"rate": n_frames / 100 / wall,
                      "idle": None if bd is None else round(
                          1 - bd[1] / bd[0], 3)}


def phase_birnn_bwd(reps: int, n_t=800, n_b=32, n_h=1024, dev="cuda",
                    phase="phase 5"):
    """B2 against its plain loop: H = 1024, B = 32, T = 800, bf16, both
    directions, on states that B1 computed from random projections."""
    from tpu_ctc_torch.ops import birnn_cuda
    r = np.random.RandomState(5)
    z = torch.from_numpy(3.0 * r.randn(n_t, n_b, n_h).astype(np.float32))
    w = torch.from_numpy((0.5 / np.sqrt(n_h))
                         * r.randn(n_h, n_h).astype(np.float32))
    g = torch.from_numpy(r.randn(n_t, n_b, n_h).astype(np.float32))
    lens = torch.from_numpy(r.randint(n_t // 2, n_t + 1, n_b).astype(np.int32))
    z, w, g, lens = (z.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16),
                     g.to(dev, torch.bfloat16), lens.to(dev))
    wt = w.t().contiguous()
    err, states, deltas = 0.0, {}, {}
    # the forward direction's deltas run right to left over its states
    for reverse in (True, False):
        hs = birnn_cuda.fwd_recurrence_cuda(z, w, lens, reverse=not reverse,
                                            clip=20.0)
        torch.cuda.synchronize()
        hs_want = birnn_cuda.fwd_recurrence_plain(
            z, w, lens, reverse=not reverse, clip=20.0).float()
        bad_h = int(((hs.float() - hs_want).abs()
                     > 2 ** -6 * hs_want.abs() + 2e-2).sum())
        log(f"{phase}: B1 at H={n_h} B={n_b} T={n_t} "
            f"{'forward' if reverse else 'reversed'}: max abs err "
            f"{float((hs.float() - hs_want).abs().max()):.3e}, {bad_h} "
            f"beyond tolerance")
        if bad_h:
            raise AssertionError("B1 disagrees with its plain version")
        states[reverse] = hs
        got = birnn_cuda.bwd_recurrence_cuda(g, hs, wt, reverse=reverse,
                                             clip=20.0).float()
        deltas[reverse] = got
        torch.cuda.synchronize()
        want = birnn_cuda.bwd_recurrence_plain(g, hs, wt, reverse=reverse,
                                               clip=20.0).float()
        diff = (got - want).abs()
        # bf16 d_t: as for B1, a stored delta may round the other way
        tol = 2 ** -6 * want.abs() + 2e-2
        bad = int((diff > tol).sum())
        err = max(err, float(diff.max()))
        log(f"{phase}: B2 {'right to left' if reverse else 'left to right'}"
            f" max abs err {float(diff.max()):.3e}, {bad} beyond tolerance,"
            f" max |d| {float(want.abs().max()):.2f}, active share "
            f"{float(((hs.float() > 0) & (hs.float() < 20)).float().mean()):.3f}")
        if bad:
            raise AssertionError("B2 disagrees with its plain version")
    hs = states[True]
    ms = time_ms(lambda: birnn_cuda.bwd_recurrence_cuda(
        g, hs, wt, reverse=True, clip=20.0), reps)
    plain_ms = time_ms(lambda: birnn_cuda.bwd_recurrence_plain(
        g, hs, wt, reverse=True, clip=20.0), PLAIN_REPS)
    # What the timed right-to-left sweep needs: hs read in full (it alone
    # says which units are active), d written in full, g read at active
    # units only (an inactive unit's d is 0 whatever g holds), W^T read
    # once; d_{t+1} @ W^T only for the active units of frame t and over
    # the nonzero entries of d_{t+1} (a sparse product).
    act = (hs.float() > 0) & (hs.float() < 20.0)
    d_r = deltas[True]
    next_nnz = torch.cat([d_r[1:], torch.zeros_like(d_r[:1])]).ne(0).sum(2)
    n_bytes = ((2 * n_t * n_b * n_h + int(act.sum())) * 2
               + n_h * n_h * 2)
    n_ops = 2 * int((act.sum(2) * next_nnz).sum())
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_TENSOR_OPS)
    fwd_ms = time_ms(lambda: birnn_cuda.fwd_recurrence_cuda(
        z, w, lens, reverse=False, clip=20.0), reps)
    log(f"{phase}: B2 one direction {ms:.3f} ms ({ms * 1e3 / n_t:.2f} us a "
        f"step), plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"library: none (no PyTorch call computes a clipped-ReLU delta "
        f"sweep)")
    log(f"{phase}: B1 one direction at this shape (H={n_h}, B={n_b}, "
        f"T={n_t}) {fwd_ms:.3f} ms ({fwd_ms * 1e3 / n_t:.2f} us a step)")
    return dict(name="birnn_bwd", route="cuda", source=BIRNN_SOURCE,
                replaces=B2_REPLACES, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def dp_close(got, want, what, phase="phase 6"):
    """Max abs error over live states; raises unless the kernel's output
    is bit-equal to the plain sweep's, dead states (<= NEG_INF / 2) and
    their sentinel values included."""
    from tpu_ctc_torch.losses.ctc_ref import NEG_INF
    dead = want <= NEG_INF / 2
    diff = (got - want).abs()[~dead]
    err = float(diff.max()) if diff.numel() else 0.0
    same = torch.equal(got, want)
    log(f"{phase}: {what} max abs err {err:.3e} on {diff.numel()} live "
        f"states (max |value| {float(want.abs()[~dead].max()):.1f}), "
        f"{int(dead.sum())} dead states; bit-equal to the plain sweep: "
        f"{same}")
    if not same:
        raise AssertionError(f"{what} is not bit-equal to its plain sweep")
    return err


def ctc_inputs(n_b=32, n_t=800, a=29, chars=(50, 100), dev="cuda"):
    """Phase 6's seeded inputs: log probs [B, T, A], labels [B, L], label
    lengths and frame lengths (T / 2 .. T)."""
    r = np.random.RandomState(6)
    lp, _ = peaked_posteriors(7, n_b, n_t, a)
    labels = torch.from_numpy(r.randint(1, a, (n_b, chars[1])).astype(
        np.int32))
    lab_len = torch.from_numpy(r.randint(chars[0], chars[1] + 1, n_b).astype(
        np.int32))
    frames = torch.from_numpy(r.randint(n_t // 2, n_t + 1, n_b).astype(
        np.int32))
    return tuple(x.to(dev) for x in (lp, labels, lab_len, frames))


def phase_ctc(reps: int, n_b=32, n_t=800, a=29, chars=(50, 100),
              dev="cuda", phase="phase 6"):
    """B3 and B4 against their plain sweeps: B = 32, T = 800, A = 29,
    labels of 50-100 characters (S <= 201)."""
    import torch.nn.functional as F
    from tpu_ctc_torch.ops import ctc_cuda
    lp, labels, lab_len, frames = ctc_inputs(n_b, n_t, a, chars, dev)
    emit, skip, skip2, init, final, lengths = ctc_cuda.lattice(
        lp, labels, frames, lab_len)
    n_s = emit.shape[2]
    err_a = dp_close(ctc_cuda.alpha_cuda(emit, skip, init, lengths),
                     ctc_cuda.alpha_plain(emit, skip, init, lengths),
                     f"B3 alpha (B={n_b}, T={n_t}, S={n_s})", phase)
    err_b = dp_close(ctc_cuda.beta_cuda(emit, skip2, final, lengths),
                     ctc_cuda.beta_plain(emit, skip2, final, lengths),
                     f"B4 beta (B={n_b}, T={n_t}, S={n_s})", phase)
    ms_a = time_ms(lambda: ctc_cuda.alpha_cuda(emit, skip, init, lengths),
                   reps)
    ms_b = time_ms(lambda: ctc_cuda.beta_cuda(emit, skip2, final, lengths),
                   reps)
    plain_a = time_ms(lambda: ctc_cuda.alpha_plain(emit, skip, init, lengths),
                      PLAIN_REPS)
    plain_b = time_ms(lambda: ctc_cuda.beta_plain(emit, skip2, final,
                                                  lengths), PLAIN_REPS)

    # The library yardstick: one F.ctc_loss call on the same log probs
    # (time-major), forward for B3, forward + backward less forward for B4.
    lp_req = lp.detach().transpose(0, 1).contiguous().requires_grad_(True)

    def lib_fwd():
        return F.ctc_loss(lp_req, labels, frames, lab_len, reduction="none")

    def lib_fwd_bwd():
        lib_fwd().sum().backward()

    lib_ms = time_ms(lib_fwd, reps)
    lib_total = time_ms(lib_fwd_bwd, reps)
    lib_err = float((lib_fwd().detach() - ctc_cuda.ctc_loss_from_log_probs(
        lp, labels, frames, lab_len)).abs().max())
    lp_port = lp.detach().clone().requires_grad_(True)

    def port_fwd_bwd():
        ctc_cuda.ctc_loss_from_log_probs(lp_port, labels, frames,
                                         lab_len).sum().backward()

    port_total = time_ms(port_fwd_bwd, reps)
    live_states = int(frames.sum()) * n_s
    # emit is read at live frames only (alpha freezes after a row's length,
    # beta is NEG_INF there); alpha or beta is written in full; the two
    # masks and the lengths are read once
    n_bytes = ((int(frames.sum()) + n_b * n_t) * n_s * 4
               + 2 * n_b * n_s * 4 + n_b * 4)
    n_ops = 13 * live_states      # 2 max, 3 sub, 3 exp, 3 add, log, add
    b_ms, b_by = bound_ms(n_bytes, n_ops, SCALAR_INSTR_PER_S)
    log(f"{phase}: B3 {ms_a:.4f} ms ({ms_a * 1e6 / n_t:.0f} ns a frame), "
        f"plain {plain_a:.1f} ms; B4 {ms_b:.4f} ms ({ms_b * 1e6 / n_t:.0f} ns "
        f"a frame), plain {plain_b:.1f} ms; bound each {b_ms:.4f} ms "
        f"({b_by})")
    log(f"{phase}: library F.ctc_loss forward {lib_ms:.3f} ms, forward + "
        f"backward {lib_total:.3f} ms (NLL vs the port's max abs err "
        f"{lib_err:.3e}); the port's loss with gradient {port_total:.3f} ms")
    common = dict(route="cuda", source=B34_SOURCE, bound_ms=b_ms,
                  bound_by=b_by)
    return [dict(name="ctc_alpha", replaces=B3_REPLACES, max_abs_err=err_a,
                 ms=ms_a, plain_ms=plain_a, library_ms=lib_ms, **common),
            dict(name="ctc_beta", replaces=B4_REPLACES, max_abs_err=err_b,
                 ms=ms_b, plain_ms=plain_b,
                 library_ms=max(lib_total - lib_ms, 0.0), **common)]


def rel_err(a, b) -> float:
    return float(torch.linalg.norm((a - b).float())
                 / torch.linalg.norm(b.float()).clamp_min(1e-30))


def state_tensors(state):
    """The parameters and the trace of a train state, in a fixed order."""
    trace = state.opt_state.trace
    return list(state.model.parameters()) + [trace[k] for k in sorted(trace)]


def timed_steps(step_fn, state, tensors, order):
    """``step_fn`` over ``tensors[i]`` for i in ``order``, synchronised
    at both ends; returns (state, metrics of each step, wall s, each
    call's host ms up to its return)."""
    metrics, host = [], []
    torch.cuda.synchronize()
    t0 = time.time()
    for i in order:
        h0 = time.perf_counter()
        state, m = step_fn(state, tensors[i])
        host.append((time.perf_counter() - h0) * 1e3)
        metrics.append(m)
    torch.cuda.synchronize()
    return state, metrics, time.time() - t0, host


def phase_train(seed: int, steps=6, n_utts=64, chars=(50, 100), dev="cuda",
                **overrides):
    """Preset 2 at full width and depth on two 800-frame batches of 32,
    from seeded random weights: the eager ``train_step`` and the step that
    ``make_train_step`` returns on one card (one CUDA graph per batch
    shape), which is the main path, held bit-equal to it."""
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.synthetic import SyntheticCorpus
    from tpu_ctc_torch.losses import ctc
    from tpu_ctc_torch.models import birnn
    from tpu_ctc_torch.parallel.mesh import make_mesh
    from tpu_ctc_torch.train import graphs, step
    from tpu_ctc_torch.train.loop import batch_to_device_dict

    cfg = get_config("timit_full_3layer", **overrides)
    corpus = SyntheticCorpus(n_utts, feature_dim=cfg.model.input_dim,
                             min_chars=chars[0], max_chars=chars[1],
                             seed=seed)
    batches = [b for _, b in BucketedLoader(corpus.all_utterances(),
                                            cfg.data).epoch(0)]
    tensors = [step.batch_to_tensors(batch_to_device_dict(b), dev)
               for b in batches]
    ref = step.create_train_state(cfg, device=dev)
    log(f"phase 7: preset {cfg.name}: {birnn.count_params(ref.model)} "
        f"params, {len(batches)} batch(es) of "
        f"{[b.feats.shape for b in batches]}, labels up to "
        f"{max(int(b.label_lengths.max()) for b in batches)}, cut to "
        f"{[tuple(t['labels'].shape) for t in tensors]} columns")
    eager = functools.partial(step.train_step, cfg=cfg)
    order = [i % len(tensors) for i in range(1, steps + 1)]

    ref, m0 = eager(ref, tensors[0])           # warm-up: cuBLAS, buffers
    first_loss = float(m0["loss"])
    torch.cuda.synchronize()
    (ref, want, eager_wall, eager_host), eager_launches = run_main_path(
        lambda: timed_steps(eager, ref, tensors, order))
    reserved_eager = torch.cuda.memory_reserved()

    # the main path: make_train_step's compiled step from the same seed
    state = step.create_train_state(cfg, device=dev)
    step_fn, state = step.make_train_step(cfg, make_mesh(cfg.mesh), state)
    if not isinstance(step_fn, graphs.CompiledTrainStep):
        raise AssertionError(f"make_train_step gave {step_fn} on one card")
    state, g0 = step_fn(state, tensors[0])     # captures batch 0's shape
    for t in tensors:                          # and the others, no step
        step_fn.capture(state, t)
    cap = step_fn.stats()
    (state, got, wall, host), launches = run_main_path(
        lambda: timed_steps(step_fn, state, tensors, order))
    reserved = torch.cuda.memory_reserved()
    same = torch.equal(g0["loss"], m0["loss"]) and all(
        torch.equal(g[k], w[k]) for g, w in zip(got, want) for k in w) and \
        all(torch.equal(a, b) for a, b in zip(state_tensors(state),
                                               state_tensors(ref)))
    frames = sum(int(batches[i].frame_lengths.sum()) for i in order)
    per = {k: n / steps for k, n in launches.items()}
    log(f"phase 7: compiled step: {cap['shapes']} shape(s) captured in "
        f"{[round(x, 3) for x in cap['capture_s']]} s (warm-up and capture "
        f"each); {steps} steps on both batches bit-equal to the eager "
        f"train_step (loss, metrics, parameters, trace): {same}")
    log(f"phase 7: {steps} steps in {wall:.3f} s = {wall / steps * 1e3:.2f} "
        f"ms a step, {frames / 100 / wall:.1f} audio-s/s, host "
        f"{np.median(host):.3f} ms a step to return (compiled); eager "
        f"{eager_wall / steps * 1e3:.2f} ms a step, "
        f"{frames / 100 / eager_wall:.1f} audio-s/s, host "
        f"{np.median(eager_host):.3f} ms; launches on the path {launches} "
        f"({per} a step; the eager steps' {eager_launches})")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in state_tensors(state))
    log(f"phase 7: reserved device memory {reserved_eager / 2 ** 30:.2f} "
        f"GiB after the eager steps, {reserved / 2 ** 30:.2f} GiB with the "
        f"compiled step's graphs and its own state of "
        f"{state_bytes / 2 ** 30:.2f} GiB")
    if not same:
        raise AssertionError("the compiled train step differs from the "
                             "eager train_step")
    n_bi = cfg.model.num_bi_layers
    want_n = {"birnn_fwd": 2 * n_bi * steps, "birnn_bwd": 2 * n_bi * steps,
              "birnn_fwd_wide": 0, "birnn_bwd_wide": 0,
              "ctc_alpha": steps, "ctc_beta": steps, "beam_search": 0,
              "beam_search_wide": 0, "beam_reconstruct": 0}
    for name, n in launches.items():
        if want_n[name] and n == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"training path")
    if launches != want_n or eager_launches != want_n:
        raise AssertionError(f"launches {launches} (eager "
                             f"{eager_launches}), expected {want_n}")
    losses = [float(m["loss"]) for m in got]
    log(f"phase 7: losses {[round(x, 2) for x in [first_loss] + losses]}, "
        f"grad norms {[round(float(m['grad_norm']), 1) for m in got]}")

    bt0 = tensors[0]
    with torch.no_grad():
        after = float(step.loss_fn(state.model, cfg, bt0)[0])
    log(f"phase 7: loss on the first batch {first_loss:.3f} before, "
        f"{after:.3f} after {steps + 1} steps")
    if not (np.isfinite(after) and after < first_loss):
        raise AssertionError("training did not lower the loss")

    # the host's label cut: the CTC loss at the rounded width against the
    # cut at the longest label, on this batch's logits
    with torch.no_grad():
        logits = birnn.forward(state.model, cfg.model, bt0["feats"],
                               bt0["frame_mask"]).float()
    longest = int(batches[0].label_lengths.max())
    cut = []
    for width in (longest, bt0["labels"].shape[1]):
        x = logits.clone().requires_grad_(True)
        nll = ctc.ctc_loss(x, bt0["labels"][:, :width], bt0["frame_lengths"],
                           bt0["label_lengths"])
        nll.sum().backward()
        cut.append((nll.detach(), x.grad))
    width_gap = float((cut[0][1] - cut[1][1]).abs().max())
    log(f"phase 7: label columns {longest} (the longest) against "
        f"{bt0['labels'].shape[1]} (rounded up to 32): losses bit-equal "
        f"{torch.equal(cut[0][0], cut[1][0])}; gradient max abs gap "
        f"{width_gap:.3g} (max |g| {float(cut[0][1].abs().max()):.3g})")
    if not torch.equal(cut[0][0], cut[1][0]) or width_gap > 1e-5:
        raise AssertionError("the label cut moved the CTC loss or gradient")

    plain = cfg.override(**{"model.birnn_impl": "scan", "ctc_impl": "jnp"})

    def loss_and_grads(c):
        params = dict(state.model.named_parameters())
        with torch.enable_grad():
            loss, _ = step.loss_fn(state.model, c, bt0)
            grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params, grads))

    def compare(a, b):
        loss_rel = abs(a[0] - b[0]) / abs(b[0])
        g_rel = {k: rel_err(a[1][k], b[1][k]) for k in a[1]}
        worst = max(g_rel, key=g_rel.get)
        return loss_rel, g_rel[worst], worst

    res = [loss_and_grads(cfg), loss_and_grads(plain)]
    loss_rel, g_worst, worst = compare(*res)
    log(f"phase 7: kernel vs plain path: loss {res[0][0]:.4f} vs "
        f"{res[1][0]:.4f} (rel {loss_rel:.2e}, limit {LOSS_REL_TOL}); "
        f"gradient rel err max {g_worst:.2e} ({worst}), limit "
        f"{GRAD_REL_TOL}")
    with f32_dense_products():
        res_f32 = loss_and_grads(cfg)
    f32_loss_rel, f32_worst, f32_name = compare(res[0], res_f32)
    log(f"phase 7: bf16 GEMMs vs the f32 GEMMs they replaced (kernel path): "
        f"loss rel {f32_loss_rel:.2e}, gradient rel err max "
        f"{f32_worst:.2e} ({f32_name})")
    if (max(loss_rel, f32_loss_rel) > LOSS_REL_TOL
            or max(g_worst, f32_worst) > GRAD_REL_TOL):
        raise AssertionError("the training step's kernel path disagrees "
                             "with its plain path or with its f32 GEMMs")
    # two steps from the same seeded state, outside deterministic mode
    assert not torch.are_deterministic_algorithms_enabled()
    twins = []
    for _ in range(2):
        s0 = step.create_train_state(cfg, device=dev)
        s1, m = step.train_step(s0, tensors[1], cfg)
        twins.append((m["loss"], list(s1.model.parameters())))
    same = torch.equal(twins[0][0], twins[1][0]) and all(
        torch.equal(a, b) for a, b in zip(twins[0][1], twins[1][1]))
    log(f"phase 7: two train_steps from the same state outside "
        f"deterministic mode: loss and parameters bit-equal {same}")
    if not same:
        raise AssertionError("two runs of one training step differ")
    del twins, s0, s1
    torch.cuda.reset_peak_memory_stats()
    eager_bd = device_breakdown(lambda: eager(ref, tensors[1]),
                                "phase 7 eager")
    log(f"phase 7: peak device memory of one eager step "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    bd = device_breakdown(lambda: step_fn(state, tensors[1]),
                          "phase 7 compiled")
    with f32_dense_products():
        device_breakdown(lambda: eager(ref, tensors[1]),
                         "phase 7 eager with the f32 GEMMs")

    def idle(b):
        return None if b is None else round(1 - b[1] / b[0], 3)
    if eager_bd is not None:
        log(f"phase 7: device operations a step (profiler, eager) "
            f"{eager_bd[2]}, compiled {None if bd is None else bd[2]}; idle "
            f"share eager {idle(eager_bd)}, compiled {idle(bd)}")
    return launches, {"ms": wall / steps * 1e3, "rate": frames / 100 / wall,
                      "idle": idle(bd), "eager_ms": eager_wall / steps * 1e3,
                      "eager_rate": frames / 100 / eager_wall,
                      "eager_idle": idle(eager_bd)}


def seeded_gru(seed, a, e, h, dev="cuda"):
    from tpu_ctc_torch.decode import neural_lm
    return neural_lm.init_params(neural_lm.CharRNNLMConfig(a, e, h), seed,
                                 device=dev)


def gru_search_bound(bp, lens, a, k, n_e, n_h):
    """(bytes, scalar operations, product FMAs, extensions, beams) a GRU +
    trigram search needs on this run's data: the n-gram search's work
    (``phase_beam``) and the per-char input table xw (A E 3H FMAs, made
    once) as scalar operations, the GRU's weights read once, and as
    products the LM rows' A H FMAs for every live beam at every live frame
    and 3 H H FMAs for every survivor that extends.  A dead slot's
    backpointer is 0, like one live stay of slot 0, so beams are counted
    live by nonzero backpointers: one too few at most."""
    n_b, n_t, _ = bp.shape
    live_t = (torch.arange(n_t, device=bp.device)[None, :]
              < lens[:, None].to(bp.device))                  # [B, T]
    live = int(lens.sum())
    ext = int((((bp >> 8) > 0) & live_t[:, :, None]).sum())
    nz = (bp != 0).sum(2)                                     # [B, T]
    beams = int(live_t[:, 0].sum()) + int(
        (nz[:, :-1] * live_t[:, 1:]).sum())
    n_bytes = (live * a * 4 + n_b * 4 + a ** 3 * 4 + live * k * 4
               + n_b * 3 * k * 4
               + (a * 3 * n_h + 3 * n_h * n_h + 3 * n_h + n_h * a + a + n_h)
               * 4)
    n_ops = live * (5 * a * k + 5 * k) + a * n_e * 3 * n_h
    n_fma = beams * a * n_h + ext * 3 * n_h * n_h
    return n_bytes, n_ops, n_fma, ext, beams


def gru_bound_ms(n_bytes, n_ops, n_fma):
    """(ms, bound_by) of a GRU search: its bytes over HBM bandwidth or, if
    longer, its scalar operations at the scalar rate plus its products
    (2 FLOP an FMA) at the f32-accurate tensor rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / SCALAR_INSTR_PER_S
             + 2 * n_fma / TF32_SPLIT_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walk_slots(bp, lens, max_len: int):
    """Every slot's prefix in each row of the packed backpointers bp
    [N, T, K] int32, walked from the row's last live frame (lens [N]):
    [N, K, max_len] int32.  ``beam_cuda.reconstruct_plain``'s walk (a
    gather a frame) for all the slots of all the rows at once."""
    n, n_t, k = bp.shape
    slot = torch.arange(k, device=bp.device).expand(n, k)
    live = torch.arange(n_t, device=bp.device)[:, None] < lens.to(
        bp.device)[None, :]                                     # [T, N]
    chars = torch.full((n_t, n, k), -1, dtype=torch.int64, device=bp.device)
    for t in range(n_t - 1, -1, -1):
        entry = bp[:, t].gather(1, slot).to(torch.int64)
        chars[t] = torch.where(live[t, :, None], entry // 256 - 1, -1)
        slot = torch.where(live[t, :, None], entry % 256, slot)
    emitted = chars >= 0
    pos = torch.cumsum(emitted.to(torch.int64), dim=0) - 1
    pos = torch.where(emitted, pos, torch.full_like(pos, max_len))
    hyps = torch.zeros((n, k, max_len + 1), dtype=torch.int32,
                       device=bp.device)
    hyps.scatter_(2, pos.permute(1, 2, 0),
                  torch.clamp(chars, min=0).permute(1, 2, 0).to(torch.int32))
    return hyps[:, :, :max_len]


def narrow(ends, n_b: int, probe, agree):
    """The search of :func:`first_divergences`: for each utterance i of
    ``ends`` (its frame count), the frames (lo, hi) between which its two
    searches first part (agree(slots at lo), not at hi = lo + 1; lo = hi
    where they never part), with every probe's slots ({(i, t): slots}).
    ``probe(rows)`` returns the slots of up to ``n_b`` (i, t) at once."""
    bounds = {i: (0, end) for i, end in ends.items()}
    seen, first = {}, True
    while first or any(hi - lo > 1 for lo, hi in bounds.values()):
        open_ = [i for i, (lo, hi) in bounds.items() if first or hi - lo > 1]
        per = max(n_b // len(open_), 1)
        rows = []
        for i in open_:
            lo, hi = bounds[i]
            pts = np.unique(np.linspace(lo, hi, per + 1).round()
                            .astype(int)[1:])
            rows += [(i, int(t)) for t in pts
                     if lo < t and (i, int(t)) not in seen]
        for at in range(0, len(rows), n_b):
            seen.update(probe(rows[at:at + n_b]))
        for i in open_:
            lo, hi = bounds[i]
            if first and agree(seen[i, hi]):
                bounds[i] = (hi, hi)        # the beams never part
                continue
            ts = sorted(t for (j, t) in seen if j == i and lo < t <= hi)
            parted = next(t for t in ts if not agree(seen[i, t]))
            bounds[i] = (max([lo] + [t for t in ts if t < parted]), parted)
        first = False
    return bounds, seen


def first_divergences(lp, lens, odd, kw):
    """Where the kernel's and the plain search's beams first part on each
    utterance i of ``odd``: a search over the frames for the first after
    which some slot's prefix, length or score (within 1e-3) differs.
    Returns {i: (that frame or None, the largest difference of the two
    sides' sorted live slot scores after it)}.  While the beams agree,
    every candidate's score agrees within their drift, so the first
    parting can only swap candidates tied within it at the beam boundary:
    the sorted scores still agree.  A wrong score shows there.

    Each probe cuts an utterance to its first t frames, and the probes of
    all the utterances share batches: a pass fills the batch's B rows
    with copies of the utterances still open, each row cut at one of its
    probe frames (its length set to t), and runs the kernel and the plain
    search once on it.  A row's search reads no other row, and the batch
    keeps its B rows, so every row rounds as the whole batch cut to its
    first t frames does (the plain search's matmuls round by the batch's
    shape).  A pass probes up to B / (open utterances) frames of each,
    evenly over its interval (at first its last frame, where the two must
    part), and narrows the interval to the first pair of adjacent probes
    whose beams agree and part: a bisection with as many probes a pass as
    the batch has rows."""
    from tpu_ctc_torch.decode import beam
    from tpu_ctc_torch.ops import beam_cuda
    k, max_len = kw["beam_width"], kw["max_len"]
    n_b = lp.shape[0]
    pos = torch.arange(max_len, device=lp.device)

    def probe(rows):
        """{(i, t): the kernel's and the plain search's slots of utterance
        i cut at t frames} for up to B (i, t), in one batch."""
        pad = rows + [rows[-1]] * (n_b - len(rows))
        idx = torch.tensor([i for i, _ in pad], device=lp.device)
        n = torch.tensor([t for _, t in pad], dtype=lens.dtype,
                         device=lens.device)
        x = lp[idx, :max(t for _, t in pad)]
        lp_k, lens_k, lm_k, thr, gru = beam_cuda.prepare(
            x, n, k, lm_table=kw["lm_table"], lm_order=kw["lm_order"],
            char_topk=kw.get("char_topk", 0), nlm_params=kw["nlm_params"])
        bp, fin = beam_cuda.launch(
            lp_k, lens_k, k, max_len, lm=lm_k, lm_order=kw["lm_order"],
            lm_alpha=kw["lm_alpha"], lm_beta=kw["lm_beta"],
            prune_logp=kw["prune_logp"], thr=thr, gru=gru)
        want = beam.prefix_beam_search(x, n, return_beams=True, **kw)
        pre = walk_slots(bp, n, max_len)
        i, t = rows[0]      # the walk of every slot is the plain walk's
        if not torch.equal(pre[0], beam_cuda.reconstruct_plain(
                bp[:1, :t].expand(k, -1, -1),
                torch.arange(k, device=lp.device), max_len)):
            raise AssertionError("walk_slots differs from the plain walk")
        return {(i, t): (beam._lse2(fin[r, 0], fin[r, 1]), fin[r, 2].int(),
                         pre[r], want[3][r], want[4][r], want[5][r])
                for r, (i, t) in enumerate(rows)}

    def agree(slots):
        sk, nk, pre_k, sp, n_p, pre_p = slots
        live = sp > -1e29
        if not (torch.equal(live, sk > -1e29)
                and torch.equal(nk[live], n_p[live])):
            return False
        mask = (pos[None, :] < n_p[:, None]) & live[:, None]
        return (torch.equal(pre_k * mask, pre_p * mask)
                and float((sk - sp).abs()[live].max()) <= 1e-3)

    bounds, seen = narrow({i: int(lens[i]) for i in odd}, n_b, probe, agree)
    out = {}
    for i, (lo, hi) in bounds.items():
        if lo == hi:
            out[i] = (None, 0.0)
            continue
        sk, _, _, sp, _, _ = seen[i, hi]
        sk, sp = sk[sk > -1e29].sort().values, sp[sp > -1e29].sort().values
        out[i] = ((hi - 1, float("inf")) if sk.numel() != sp.numel() else
                  (hi - 1, float((sk - sp).abs().max())))
    return out


def check_gru_search(phase, what, lp, lens, kw, got, want_beams):
    """Hold a GRU search's (hyps, lens, scores) against the plain search's
    return_beams output on the same inputs (``kw``): hypotheses equal on
    every utterance whose top-2 gap > GRU_GAP and scores within GRU_TOL.
    An utterance that fails either must be explained: its beams first part
    at a swap of candidates tied within rounding at the beam boundary
    (:func:`first_divergences`), on at most a quarter of the utterances.
    Returns the max score error over the other utterances."""
    hyp, hyp_len, score = got
    ph, pl, ps, slots = want_beams[:4]
    diff = (score - ps).abs()
    top2 = torch.topk(slots, 2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    checked = agree = 0
    odd = []
    for i in range(hyp.shape[0]):
        n = int(hyp_len[i])
        same = n == int(pl[i]) and torch.equal(hyp[i, :n], ph[i, :n])
        if float(gap[i]) > GRU_GAP:
            checked += 1
            agree += int(same)
        if (float(gap[i]) > GRU_GAP and not same) or float(diff[i]) > GRU_TOL:
            odd.append(i)
    err = max((float(diff[i]) for i in range(len(diff)) if i not in odd),
              default=0.0)
    log(f"{phase}: {what}: hyps equal on {agree} of {checked} utterances "
        f"with a top-2 gap > {GRU_GAP} ({hyp.shape[0]} in all); max score "
        f"err {err:.3e} (limit {GRU_TOL}) on the {hyp.shape[0] - len(odd)} "
        f"utterances without a boundary tie")
    t0 = time.time()
    parted = first_divergences(lp, lens, odd, kw) if odd else {}
    if odd:
        log(f"{phase}: {len(odd)} utterance(s) searched for where the beams "
            f"part in {time.time() - t0:.1f} s")
    for i in odd:
        frame, sorted_err = parted[i]
        log(f"{phase}:   utt {i}: score err {float(diff[i]):.3e}; the beams "
            f"first part at frame {frame} of {int(lens[i])}, where the sorted "
            f"slot scores differ by {sorted_err:.3e}")
        if frame is None or sorted_err > 1e-3:
            raise AssertionError(f"{what}: utterance {i} disagrees with the "
                                 f"plain search, not at a boundary tie")
    if checked == 0 or len(odd) > hyp.shape[0] // 4:
        raise AssertionError(f"{what} disagrees with the plain search")
    return err


def phase_beam_gru(reps: int, phase: str, k: int, n_b=64, n_t=800,
                   max_len=216, lm_order=3, dev="cuda"):
    """B5 (K <= 128) or B6 with the GRU char LM (E = 64, H = 128, seeded)
    and the trigram (none with ``lm_order=0``) against the plain search:
    B = 64, T = 800, A = 29."""
    from tpu_ctc_torch.decode import beam
    from tpu_ctc_torch.ops import beam_cuda
    a, n_e, n_h = 29, 64, 128
    lp, lens = peaked_posteriors(8, n_b, n_t, a)
    lp, lens = lp.to(dev), lens.to(dev)
    lm = seeded_trigram(3, a).tables(dev) if lm_order else None
    gru = seeded_gru(9, a, n_e, n_h, dev)
    kw = dict(beam_width=k, max_len=max_len, lm_table=lm, lm_order=lm_order,
              lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0, nlm_params=gru)
    what, variant = (("GRU + trigram", "gru+trigram") if lm_order
                     else ("GRU", "gru"))
    kern = beam_cuda.kernel_for(k)
    before = kern.launches
    got = beam_cuda.beam_search_cuda(lp, lens, **kw)
    torch.cuda.synchronize()
    if kern.launches != before + 1:
        raise AssertionError(f"{kern.name} was not launched")
    want = beam.prefix_beam_search(lp, lens, return_beams=True, **kw)
    err = check_gru_search(phase, f"{kern.name} K={k} B={n_b} T={n_t} "
                           f"{what}", lp, lens, kw, got, want)
    prep = beam_cuda.prepare(lp, lens, k, lm_table=lm, lm_order=lm_order,
                             nlm_params=gru)

    def run_kernel():
        return beam_cuda.launch(prep[0], prep[1], k, max_len, lm=prep[2],
                                lm_order=lm_order, lm_alpha=1.25,
                                lm_beta=1.5, prune_logp=-12.0, gru=prep[4])

    bp, fin = run_kernel()
    bp2, fin2 = run_kernel()
    if not (torch.equal(bp, bp2) and torch.equal(fin, fin2)):
        raise AssertionError(f"{kern.name}: two launches on the same "
                             f"inputs differ")
    log(f"{phase}: two launches give bit-equal backpointers and states")
    ms = time_ms(run_kernel, reps)
    plain_ms = warm_ms(lambda: beam.prefix_beam_search(lp, lens, **kw),
                       PLAIN_REPS)
    n_bytes, n_ops, n_fma, ext, beams = gru_search_bound(bp, lens, a, k,
                                                         n_e, n_h)
    b_ms, b_by = gru_bound_ms(n_bytes, n_ops, n_fma)
    scalar_ms, _ = bound_ms(n_bytes, n_ops + n_fma, SCALAR_INSTR_PER_S)
    log(f"{phase}: {kern.name} K={k} {what} {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}: {ext} GRU steps "
        f"of extending survivors, LM rows of {beams} live beams over "
        f"{int(lens.sum())} live frames; {n_fma:.4g} product FMAs at the "
        f"f32-accurate tensor rate; {scalar_ms:.4f} ms with every FMA at "
        f"the scalar rate); library: none (no PyTorch call computes a "
        f"prefix beam search)")
    # phase 15 launches B5's GRU instance and B6 (K = 200, trigram)
    return dict(name=kern.name, variant=variant,
                paths=("gru", "chain_gru" if k <= 128 else "chain"),
                route="cuda", source=B5_SOURCE,
                replaces=B5_REPLACES if k <= 128 else B6_REPLACES,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_wide_ngram(reps: int, k=256, n_b=64, n_t=800, max_len=216,
                     dev="cuda", phase="phase 9"):
    """B6 with the trigram against the plain search at K = 256: hypotheses,
    lengths and every slot's final score and length equal."""
    from tpu_ctc_torch.decode import beam
    from tpu_ctc_torch.ops import beam_cuda
    a = 29
    lp, lens = peaked_posteriors(4, n_b, n_t, a)
    lp, lens = lp.to(dev), lens.to(dev)
    lm = seeded_trigram(3, a).tables(dev)
    kw = dict(lm_alpha=1.25, lm_beta=1.5, prune_logp=-12.0)
    prep = beam_cuda.prepare(lp, lens, k, lm_table=lm, lm_order=3)

    def run_kernel():
        return beam_cuda.launch(prep[0], prep[1], k, max_len, lm=prep[2],
                                lm_order=3, **kw)

    bp, fin = run_kernel()
    got = beam_cuda.beam_search_cuda(lp, lens, k, max_len, lm_table=lm,
                                     lm_order=3, **kw)
    want = beam.prefix_beam_search(lp, lens, beam_width=k, max_len=max_len,
                                   lm_table=lm, lm_order=3,
                                   return_beams=True, **kw)
    slots = beam._lse2(fin[:, 0], fin[:, 1])
    live = want[3] > -1e29
    same = bool(torch.equal(got[1], want[1]) and torch.equal(
        got[0] * (torch.arange(max_len, device=dev) < got[1][:, None]),
        want[0] * (torch.arange(max_len, device=dev) < want[1][:, None]))
        and torch.equal(slots, want[3]) and torch.equal(
            fin[:, 2].to(torch.int32)[live], want[4][live]))
    err = float((got[2] - want[2]).abs().max())
    log(f"{phase}: beam_search_wide K={k} B={n_b} T={n_t} trigram: hyps and all {k} slots' "
        f"scores and lengths equal: {same}, max score err {err:.3e}, "
        f"{int(live.sum())} live slots")
    if not same or err != 0.0:
        raise AssertionError("B6 disagrees with the plain search")
    ms = time_ms(run_kernel, reps)
    plain_ms = warm_ms(lambda: beam.prefix_beam_search(
        lp, lens, beam_width=k, max_len=max_len, lm_table=lm, lm_order=3,
        **kw), PLAIN_REPS)
    live_f = int(lens.sum())
    n_bytes = (live_f * a * 4 + n_b * 4 + a ** 3 * 4 + live_f * k * 4
               + n_b * 3 * k * 4)
    n_ops = live_f * (5 * a * k + 5 * k)
    b_ms, b_by = bound_ms(n_bytes, n_ops, SCALAR_INSTR_PER_S)
    log(f"{phase}: beam_search_wide K={k} trigram {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by})")


def gru_decode_setup(seed: int, n_utts=64, dev="cuda", **overrides):
    """Phase 10's inputs: preset 4 with the GRU char LM on, 64 synthetic
    utterances, their trigram, the model's seeded random weights, the
    batches and their frame count."""
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.synthetic import SyntheticCorpus
    from tpu_ctc_torch.decode.lm import train_char_lm_from_data
    from tpu_ctc_torch.models import birnn

    cfg = get_config("swbd_beam_decode", **{"decode.neural_lm": True,
                                            **overrides})
    corpus = SyntheticCorpus(n_utts, feature_dim=cfg.model.input_dim,
                             min_chars=50, max_chars=100, seed=seed)
    data = corpus.all_utterances()
    lm = train_char_lm_from_data(data, cfg)
    model = birnn.init_params(cfg.model, seed=seed, device=dev)
    batches = [b for _, b in BucketedLoader(data, cfg.data).epoch(0)]
    n_frames = sum(int(b.frame_lengths[b.weights > 0].sum()) for b in batches)
    return cfg, data, lm, model, batches, n_frames


def gru_decode_pass(cfg, k, lm, nlm, model, batches, dev="cuda"):
    """One decode of every batch at beam width ``k``, as ``cli decode``
    runs it: a function that returns [(hyps, lengths)] a batch."""
    from tpu_ctc_torch.decode import beam
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    decode = beam.make_beam_decoder(cfg.override(**{"decode.beam_width": k}),
                                    lm=lm, nlm_params=nlm, device=dev)

    def run():
        return [decode(model, batch_to_device_dict(b)) for b in batches]
    return run


def phase_gru_decode(seed: int, n_utts=64, dev="cuda", **overrides):
    """The GRU decode end to end: the GRU char LM trained as the CLI trains
    it, then preset 4 at K = 128 and K = 200 over 64 utterances."""
    from tpu_ctc_torch.decode import beam, neural_lm
    from tpu_ctc_torch.decode.lm import label_seqs_of
    from tpu_ctc_torch.models import birnn
    from tpu_ctc_torch.ops import beam_cuda, birnn_cuda

    cfg, data, lm, model, batches, n_frames = gru_decode_setup(
        seed, n_utts, dev, **overrides)
    t0 = time.time()
    nlm = neural_lm.train_nlm_from_data(data, cfg, device=dev)
    train_s = time.time() - t0
    padded, plens = neural_lm.pad_label_seqs(label_seqs_of(data))
    padded = torch.from_numpy(padded).to(dev)
    plens = torch.from_numpy(plens).to(dev)
    with torch.no_grad():
        nll0 = float(neural_lm.sequence_nll(neural_lm.init_params(
            nlm.cfg, 0, device=dev), padded, plens))
        nll = float(neural_lm.sequence_nll(nlm, padded, plens))
    log(f"phase 10: GRU char LM (E={nlm.cfg.embed_dim}, "
        f"H={nlm.cfg.hidden_dim}) trained {cfg.decode.neural_lm_steps} Adam "
        f"steps in {train_s:.1f} s: corpus NLL {nll0:.3f} -> {nll:.3f} "
        f"nats a char")
    if not nll < nll0:
        raise AssertionError("the GRU char LM did not train")
    all_launches, rates = {}, {}
    for k, kern in ((128, beam_cuda.KERNEL), (200, beam_cuda.WIDE_KERNEL)):
        run = gru_decode_pass(cfg, k, lm, nlm, model, batches, dev)
        run()                               # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        outs, launches = run_main_path(run)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: n for name, n in launches.items() if n}
        rates[k] = n_frames / 100 / wall
        log(f"phase 10: K={k} decoded {n_frames} frames in {wall:.3f} s = "
            f"{rates[k]:.1f} audio-s/s; launches on the path {launches}")
        want = {birnn_cuda.KERNEL.name: 2 * cfg.model.num_bi_layers
                * len(batches), kern.name: len(batches),
                beam_cuda.RECONSTRUCT.name: len(batches)}
        if launches != want:
            raise AssertionError(f"launches {launches}, expected {want}")
        for name, n in launches.items():
            all_launches[name] = all_launches.get(name, 0) + n
        for batch, (hyp, hyp_len) in zip(batches, outs):
            feats = torch.as_tensor(batch.feats, device=dev)
            mask = torch.as_tensor(batch.frame_mask, device=dev)
            lens = torch.as_tensor(batch.frame_lengths, device=dev)
            with torch.no_grad():
                lp = birnn.log_posteriors(model, cfg.model, feats, mask)
            if not bool(torch.isfinite(lp).all()):
                raise AssertionError("log posteriors not finite")
            kw = dict(beam_width=k, max_len=int(hyp.shape[1]),
                      lm_table=lm.tables(dev), lm_order=lm.order,
                      lm_alpha=cfg.decode.lm_alpha,
                      lm_beta=cfg.decode.lm_beta,
                      prune_logp=cfg.decode.prune_logp, nlm_params=nlm)
            got = beam_cuda.beam_search_cuda(lp, lens, **kw)
            if not (torch.equal(got[0], hyp) and torch.equal(got[1],
                                                             hyp_len)):
                raise AssertionError("the decoder's output is not the "
                                     "kernel's")
            check_gru_search("phase 10", f"preset 4 at K={k}", lp, lens, kw,
                             got, beam.prefix_beam_search(
                                 lp, lens, return_beams=True, **kw))
            check_walk(f"phase 10 K={k}", lp, lens, kw)
        device_breakdown(run, f"phase 10 K={k}")
    return all_launches, rates


def oracle_frontend(x, lens, fe):
    """The frontend in float64 numpy, written out from its definition:
    power [B, T, bins], mel energies [B, T, M], features [B, T, F] and the
    frame mask [B, T] of waveforms x [B, N] with lens [B] valid samples."""
    from tpu_ctc_torch.frontend.features import mel_filterbank
    x = x.astype(np.float64)
    frames = np.lib.stride_tricks.sliding_window_view(
        x, fe.frame_length, axis=1)[:, ::fe.hop_length]
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(fe.frame_length)
                             / fe.frame_length)
    spec = np.fft.rfft(frames * win, n=fe.n_fft, axis=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = mel_filterbank(fe.sample_rate, fe.n_fft, fe.n_mels, fe.fmin,
                        fe.fmax).astype(np.float64)
    mel = power @ fb
    feats = np.log(np.maximum(mel, fe.log_floor))
    n_t = feats.shape[1]
    n_valid = np.where(lens >= fe.frame_length,
                       1 + (lens - fe.frame_length) // fe.hop_length, 0)
    mask = (np.arange(n_t)[None, :] < n_valid[:, None]).astype(np.float64)
    m = mask[..., None]
    feats = feats * m
    denom = np.maximum(m.sum(axis=1, keepdims=True), 1.0)
    mean = (feats * m).sum(axis=1, keepdims=True) / denom
    var = ((feats - mean) ** 2 * m).sum(axis=1, keepdims=True) / denom
    feats = (feats - mean) / np.sqrt(var + 1e-8) * m
    k = fe.context
    idx = np.clip(np.arange(n_t)[:, None] + np.arange(-k, k + 1)[None, :],
                  0, n_t - 1)                                   # [T, 2k+1]
    feats = feats[:, idx, :].reshape(len(x), n_t, -1) * m
    return power, mel, feats, mask


def loud_bands(mel):
    """Bands whose mel energy is at least LOUD of the frame's largest band:
    [..., T, M] bool.  Elsewhere a band holds little more than the rounding
    noise of the DFT's cancelling sums, whose log differs between two
    correct products by O(1)."""
    return mel >= LOUD * mel.max(axis=-1, keepdims=True)


def check_frontend_limits(what, power, feats, mask, want_power, want_mel,
                          want_feats, want_mask, fe):
    """Hold a frontend result against another under PERF.md section 2's
    limits: the power within POWER_TOL of each frame's peak; the features
    (after CMVN and context) within FEAT_TOL in the bands that are loud in
    every valid frame of their utterance (CMVN mixes a band's frames).
    Returns (power err / peak, feature err, share of features compared)."""
    if not np.array_equal(mask, want_mask):
        raise AssertionError(f"{what}: frame masks differ")
    live = want_mask > 0
    peak = want_power.max(axis=-1, keepdims=True)
    p_err = float((np.abs(power - want_power) / peak)[live].max())
    loud = np.where(live[..., None], loud_bands(want_mel), True).all(axis=1)
    loud = np.tile(loud, 2 * fe.context + 1)[:, None, :] & live[..., None]
    f_err = float(np.abs(feats - want_feats)[loud].max())
    share = float(loud.sum() / (live.sum() * feats.shape[-1]))
    log(f"phase 11: frontend {what}: power err {p_err:.2e} of the frame's "
        f"peak (limit {POWER_TOL}); features err {f_err:.2e} (limit "
        f"{FEAT_TOL}) on the {share:.3f} of live features in bands loud "
        f"in every frame")
    if p_err > POWER_TOL or f_err > FEAT_TOL or share < 0.25:
        raise AssertionError(f"frontend {what} out of its limits")
    return p_err, f_err


def check_batched_cer(what, hyp_dir, dev="cuda"):
    """``batched_edit_distance`` and ``batched_cer`` on the card against the
    host's ``edit_distance`` and ``cer`` on a decode's trn files: equal
    integers, equal CER."""
    from tpu_ctc_torch.data.alphabet import DEFAULT_ALPHABET
    from tpu_ctc_torch.decode import wer
    refs = wer.parse_trn(f"{hyp_dir}/ref.trn")
    hyps = wer.parse_trn(f"{hyp_dir}/hyp.trn")
    r_ids = [DEFAULT_ALPHABET.encode(refs[u]) for u in sorted(refs)]
    h_ids = [DEFAULT_ALPHABET.encode(hyps[u]) for u in sorted(refs)]

    def pad(seqs):
        out = np.zeros((len(seqs), max(1, max(map(len, seqs)))), np.int32)
        for i, seq in enumerate(seqs):
            out[i, :len(seq)] = seq
        return torch.from_numpy(out).to(dev), torch.tensor(
            [len(seq) for seq in seqs], dtype=torch.int32, device=dev)
    (rt, rl), (ht, hl) = pad(r_ids), pad(h_ids)
    d_dev = wer.batched_edit_distance(rt, rl, ht, hl).cpu().tolist()
    d_host = [wer.edit_distance(r, h) for r, h in zip(r_ids, h_ids)]
    cer_dev = float(wer.batched_cer(rt, rl, ht, hl))
    cer_host = wer.cer(r_ids, h_ids)
    log(f"phase 11: batched_cer on the card ({what}) {cer_dev:.6f}, host "
        f"cer {cer_host:.6f}; distances equal on "
        f"{sum(a == b for a, b in zip(d_dev, d_host))} of {len(d_host)} "
        f"utterances (hypotheses of {min(map(len, h_ids))}-"
        f"{max(map(len, h_ids))} characters)")
    if d_dev != d_host or abs(cer_dev - cer_host) > 1e-6:
        raise AssertionError("batched_edit_distance disagrees with the host")


def phase_audio(seed: int, phase7, phase4, keep_checkpoint: str,
                dev="cuda"):
    """Audio in, text out on the card: the frontend, a manifest corpus,
    the frontend pool's bits, ``torch_tools/audio_path_breakdown.py`` at
    preset 2's and the chain's shapes in process and with the pool, ``cli
    train --data`` (preset 2, with ``train.eval_beam``), remat, the
    checkpoint's decode and score, ``export-weights``, preset 4 from audio
    in process and with the pool, ``batched_cer`` and the prefetch.  The
    trained checkpoint is copied to ``keep_checkpoint`` (phase 13 sweeps
    it).  Returns ({path: launches}, {"workers=N": preset 2's audio-s/s
    from audio})."""
    import shutil

    from torch_tools import audio_path_breakdown as apb
    from tpu_ctc_torch import cli
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.manifest import ManifestDataset, host_workers
    from tpu_ctc_torch.data.prefetch import prefetch_to_device
    from tpu_ctc_torch.decode import wer
    from tpu_ctc_torch.frontend import features as F
    from tpu_ctc_torch.ops import birnn_cuda
    from tpu_ctc_torch.train import checkpoint, step
    from tpu_ctc_torch.train.loop import batch_to_device_dict

    cfg2 = get_config("timit_full_3layer")
    fe = cfg2.frontend
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_audio")
    shutil.rmtree(root, ignore_errors=True)
    data_dir, work = os.path.join(root, "corpus"), os.path.join(root, "run")
    waves = apb.tone_corpus(data_dir, fe, seed)

    # the frontend: card, CPU and the float64 oracle on 64 waveforms
    x_np, sl_np = waves["train"][0][:64], waves["train"][1][:64]
    x, sl = torch.from_numpy(x_np), torch.from_numpy(sl_np.astype(np.int64))
    want = oracle_frontend(x_np, sl_np, fe)
    got = {}
    for where, xx, ll in (("cuda", x.to(dev), sl.to(dev)), ("cpu", x, sl)):
        p = F.stft_power(xx, fe).cpu().numpy()
        f, m = F.extract_features(xx, fe, ll)
        got[where] = (p, f.cpu().numpy(), m.cpu().numpy())
    pc, fc, mc = got["cpu"]
    check_frontend_limits("cuda vs float64 oracle", *got["cuda"], *want, fe)
    check_frontend_limits("cpu vs float64 oracle", *got["cpu"], *want, fe)
    check_frontend_limits("cuda vs cpu", *got["cuda"], pc,
                          F.mel_energies(x, fe).numpy(), fc, mc, fe)
    audio_s = float(sl_np.sum()) / fe.sample_rate
    gpu_ms = time_ms(lambda: F.extract_features(x.to(dev), fe, sl.to(dev)),
                     REPS)
    t0 = time.time()
    for _ in range(3):
        F.extract_features(x, fe, sl)
    cpu_ms = (time.time() - t0) / 3 * 1e3
    ds = ManifestDataset(data_dir, cfg2)
    t0 = time.time()
    for i in range(len(ds)):
        ds[i]
    per_utt_s = time.time() - t0
    ds_audio_s = float(waves["train"][1].sum()) / fe.sample_rate
    log(f"phase 11: frontend on {len(x_np)} waveforms ({audio_s:.1f} audio "
        f"s, {fe.n_mels} mels, context {fe.context}): card {gpu_ms:.3f} ms "
        f"({audio_s / gpu_ms * 1e3:.0f} audio-s/s, host-to-device copy "
        f"included); CPU {cpu_ms:.1f} ms ({audio_s / cpu_ms * 1e3:.0f} "
        f"audio-s/s, {torch.get_num_threads()} threads); ManifestDataset one "
        f"utterance at a time (WAV read included) {ds_audio_s:.1f} audio s "
        f"in {per_utt_s:.3f} s = {ds_audio_s / per_utt_s:.0f} audio-s/s")

    # the frontend pool: every utterance of the corpus bit-equal to the
    # in-process dataset's
    workers = host_workers()
    n_same = n_all = 0
    for split in ("train", "valid"):
        here = ManifestDataset(data_dir, cfg2, split=split)
        pooled = ManifestDataset(data_dir, cfg2, split=split,
                                 workers=workers)
        try:
            got = pooled.fetch(list(range(len(pooled))))()
        finally:
            pooled.close()
        for i, (f, lab) in enumerate(got):
            want_f, want_l = here[i]
            n_same += bool(np.array_equal(f, want_f) and f.dtype ==
                           want_f.dtype and np.array_equal(lab, want_l))
            n_all += 1
    log(f"phase 11: frontend pool of host_workers() = {workers} worker "
        f"processes: {n_same} of {n_all} utterances bit-equal to the "
        f"in-process ManifestDataset")
    if n_same != n_all or not workers:
        raise AssertionError("the frontend pool's features differ from the "
                             "in-process path (or the host gave no pool)")

    # the audio path taken apart at preset 2's and the chain's shapes,
    # in process and with the pool (torch_tools/audio_path_breakdown.py);
    # preset 2 on 256 waveforms: an epoch of 4 batches would be a quarter
    # the first batch's wait, which a real corpus's epoch spreads thin
    import argparse
    parts = {}
    for shape, utts, epochs in (("preset2", 256, 2), ("chain", 304, 2)):
        args = argparse.Namespace(
            hidden=0, layers=0, batch=0, utts=utts, epochs=epochs,
            seed=seed, per_batch=False,
            out=os.path.join(root, "audio_path"))
        parts[shape] = apb.run_shape(shape, ["0", "host"], args, dev,
                                     log=lambda m: log("phase 11: " + m))
    for shape, rec in parts.items():
        mem, eag = rec["in_memory"], rec["in_memory_eager"]
        log(f"phase 11: {shape} on features in memory: compiled step "
            f"{mem['ms']:.2f} ms a step, {mem['rate']:.1f} audio-s/s, host "
            f"{mem['host_ms']:.3f} ms, idle share <= {mem['idle']} "
            f"({rec['graphs']['shapes']} shapes captured); eager train_step "
            f"{eag['ms']:.2f} ms, {eag['rate']:.1f} audio-s/s, host "
            f"{eag['host_ms']:.3f} ms, idle share <= {eag['idle']}")
        for run in rec["runs"]:
            log(f"phase 11: {shape} from audio, {run['workers']} workers: "
                f"{run['ms']:.2f} ms a step, {run['rate']:.1f} audio-s/s "
                f"({run['rate'] / rec['in_memory']['rate']:.3f} of the same "
                f"batches in memory, {rec['in_memory']['rate']:.1f}), idle "
                f"share <= {run['idle']}")
    log(f"phase 11: phase 7 (preset 2, features in memory, 800 frames): "
        f"{phase7['ms']:.1f} ms a step, {phase7['rate']:.1f} audio-s/s, "
        f"idle share <= {phase7['idle']}; preset 2 from audio with the pool "
        f"at {parts['preset2']['runs'][1]['rate'] / phase7['rate']:.3f} of "
        f"it")

    # cli train --data: preset 2 from the audio files
    train_ds = ManifestDataset(data_dir, cfg2)
    n_eval = max(len(train_ds) // 10, 1)
    epochs = 2
    n_steps = epochs * BucketedLoader(train_ds[n_eval:],
                                      cfg2.data).num_batches(0)
    sets = ["--set", f"train.num_epochs={epochs}",
            "--set", "train.log_every=1",
            "--set", f"train.checkpoint_every={n_steps}",
            "--set", f"train.eval_every={n_steps}",
            "--set", "train.eval_beam=True"]
    t0 = time.time()
    rc, train_launches = run_main_path(lambda: cli.main(
        ["train", "--config", "2", "--data", data_dir, "--work-dir", work,
         *sets]))
    train_wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"cli train exited {rc}")
    with open(os.path.join(work, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    steps = [e for e in events if e["kind"] == "train"]
    evals = [e for e in events if e["kind"] == "eval"]
    if len(steps) != n_steps or len(evals) != 1 or "beam_cer" not in \
            evals[0]:
        raise AssertionError(f"cli train logged {len(steps)} steps and "
                             f"{evals}, expected {n_steps} and one beam eval")
    st = [e["step_time_s"] for e in steps[1:]]
    rate = float(np.median([e["audio_s_per_s"] for e in steps[1:]]))
    n_bi = cfg2.model.num_bi_layers
    log(f"phase 11: cli train --config 2 --data: {n_steps} steps in "
        f"{train_wall:.1f} s (with the LM, eval and checkpoint); steps 2-"
        f"{n_steps}: median {np.median(st) * 1e3:.1f} ms a step, "
        f"{rate:.1f} audio-s/s (each step synchronised by log_every=1); "
        f"eval {json.dumps({k: evals[0][k] for k in ('cer', 'beam_wer', 'beam_cer', 'num_utts')})}; "
        f"launches on the path {train_launches}")
    for name in ("birnn_fwd", "birnn_bwd", "ctc_alpha", "ctc_beta",
                 "beam_search", "beam_reconstruct"):
        if not train_launches.get(name):
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"audio training path")
    if (train_launches["birnn_bwd"] != 2 * n_bi * n_steps
            or train_launches["ctc_beta"] != n_steps):
        raise AssertionError(f"launches {train_launches} for {n_steps} steps")
    state0 = step.create_train_state(cfg2, device=dev)
    state1 = checkpoint.restore(os.path.join(work, "checkpoints"),
                                step.create_train_state(cfg2, device=dev))[0]
    loader = BucketedLoader(train_ds[n_eval:], cfg2.data)
    batches = [b for _, b in loader.epoch(0)]
    big = max(batches, key=lambda b: b.feats.shape[1])
    bt = step.batch_to_tensors(batch_to_device_dict(big), dev)
    with torch.no_grad():
        before = float(step.loss_fn(state0.model, cfg2, bt)[0])
        after = float(step.loss_fn(state1.model, cfg2, bt)[0])
    log(f"phase 11: loss on a {tuple(big.feats.shape)} batch {before:.3f} "
        f"from the seeded weights, {after:.3f} from the checkpoint (step "
        f"{state1.step}); per step {[round(e['loss'], 2) for e in steps]}")
    if not (np.isfinite(after) and after < before):
        raise AssertionError("training from audio did not lower the loss")

    state = step.create_train_state(cfg2, device=dev)

    # remat: one preset-2 step's loss and gradients, same batch, weights,
    # outside PyTorch's deterministic mode (the CTC glue's gather sums its
    # gradient in a fixed order: ops/ctc_cuda.EmitGather)
    def loss_grads(remat):
        c = cfg2.override(**{"model.remat": remat})
        params = dict(state.model.named_parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = birnn_cuda.KERNEL.launches
        loss, _ = step.loss_fn(state.model, c, bt)
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        return (loss, grads, birnn_cuda.KERNEL.launches - n0,
                torch.cuda.max_memory_allocated() / 2 ** 30)
    def bit_equal(a, b):
        return bool(torch.equal(a[0], b[0])) and all(
            torch.equal(x, y) for x, y in zip(a[1], b[1]))
    loss_grads(False)
    twice = bit_equal(loss_grads(False), loss_grads(False))
    l0, g0, n0, peak0 = loss_grads(False)
    l1, g1, n1, peak1 = loss_grads(True)
    same = bit_equal((l0, g0), (l1, g1))
    log(f"phase 11: remat: loss and gradients bit-equal {same}; B1 launches "
        f"{n0} without, {n1} with; peak device memory of the step "
        f"{peak0:.3f} GiB without, {peak1:.3f} GiB with; two runs without "
        f"remat bit-equal: {twice}")
    if not (same and twice) or (n0, n1) != (2 * n_bi, 4 * n_bi):
        raise AssertionError("remat changed the loss, the gradients or the "
                             "launch count")

    # round trip: decode the checkpoint, score, export, decode the npz
    hyp_dir, npz = os.path.join(root, "hyp"), os.path.join(root, "w.npz")
    ckpt_dir = os.path.join(work, "checkpoints")
    t0 = time.time()
    rc, dec_launches = run_main_path(lambda: cli.main(
        ["decode", "--config", "2", "--checkpoint", ckpt_dir, "--data",
         data_dir, "--split", "valid", "--beam", "--hyp-out", hyp_dir]))
    if rc != 0 or cli.main(["score", "--ref", f"{hyp_dir}/ref.trn",
                            "--hyp", f"{hyp_dir}/hyp.trn"]) != 0:
        raise AssertionError("cli decode or score failed")
    hyps = wer.parse_trn(f"{hyp_dir}/hyp.trn")
    refs = wer.parse_trn(f"{hyp_dir}/ref.trn")
    ids = [r["id"] for r in ManifestDataset(data_dir, cfg2,
                                            split="valid").records]
    if sorted(hyps) != sorted(ids) or sorted(refs) != sorted(ids):
        raise AssertionError("the trn files do not carry the manifest's ids")
    log(f"phase 11: cli decode --config 2 --checkpoint --split valid --beam: "
        f"{len(hyps)} utterances in {time.time() - t0:.1f} s; launches "
        f"{dec_launches}")
    if cli.main(["export-weights", "--config", "2", "--checkpoint", ckpt_dir,
                 "--out", npz]) != 0 or cli.main(
            ["decode", "--config", "2", "--weights", npz, "--data", data_dir,
             "--split", "valid", "--beam", "--hyp-out", hyp_dir + "_w"]) != 0:
        raise AssertionError("export-weights or decode --weights failed")
    same = wer.parse_trn(f"{hyp_dir}_w/hyp.trn") == hyps
    log(f"phase 11: export-weights then decode --weights: hypotheses "
        f"identical to the --checkpoint decode: {same}")
    if not same:
        raise AssertionError("decode --weights differs from --checkpoint")

    # preset 4 from audio: the CLI, then its loop timed and profiled
    cfg4 = get_config("swbd_beam_decode")
    t0 = time.time()
    rc, p4_launches = run_main_path(lambda: cli.main(
        ["decode", "--config", "4", "--data", data_dir, "--beam",
         "--hyp-out", hyp_dir + "_4"]))
    if rc != 0:
        raise AssertionError("cli decode --config 4 failed")
    log(f"phase 11: cli decode --config 4 --data --beam (random weights, "
        f"init and LM included) {time.time() - t0:.1f} s; launches "
        f"{p4_launches}")
    # batched_edit_distance on the card against the host's, on the
    # hypotheses of both decodes (the trained checkpoint's and preset 4's)
    check_batched_cer("valid split, the checkpoint", hyp_dir, dev)
    check_batched_cer("train split, preset 4", hyp_dir + "_4", dev)
    from tpu_ctc_torch.decode.beam import make_beam_decoder
    from tpu_ctc_torch.decode.lm import train_char_lm_from_data
    from tpu_ctc_torch.models import birnn
    model4 = birnn.init_params(cfg4.model, seed=0, device=dev)
    decode4 = make_beam_decoder(
        cfg4, lm=train_char_lm_from_data(ManifestDataset(data_dir, cfg4),
                                         cfg4), device=dev)
    for n_w in (0, workers):
        ds4 = ManifestDataset(data_dir, cfg4, workers=n_w)
        loader4 = BucketedLoader(ds4, cfg4.data)

        def decode_pass():
            out = [decode4(model4, batch_to_device_dict(b))
                   for _, b in loader4.epoch(0)]
            torch.cuda.synchronize()
            return out
        try:
            decode_pass()
            t0 = time.time()
            decode_pass()
            wall4 = time.time() - t0
            bd4 = device_breakdown(decode_pass,
                                   f"phase 11 preset 4 from audio, {n_w} "
                                   f"workers")
        finally:
            ds4.close()
        frames4 = int(ds4.frame_lengths.sum())
        idle4 = None if bd4 is None else round(1 - bd4[1] / bd4[0], 3)
        log(f"phase 11: preset 4 from audio, {n_w} frontend workers, "
            f"{len(ds4)} utterances in {loader4.num_batches(0)} batches of "
            f"{cfg4.data.batch_size} (K={cfg4.decode.beam_width}, trigram): "
            f"{wall4:.3f} s with the frontend = "
            f"{frames4 / 100 / wall4:.1f} audio-s/s, idle share <= {idle4}; "
            f"phase 4 (features in memory): {phase4['rate']:.1f} audio-s/s, "
            f"idle share <= {phase4['idle']}")

    # prefetch: the batches bit-equal to the loader's own, moved
    n_eq = 0
    for (c1, b1, t1), (c2, b2) in zip(
            prefetch_to_device(loader.epoch(1), dev), loader.epoch(1)):
        want_t = step.batch_to_tensors(batch_to_device_dict(b2), dev)
        if c1 != c2 or set(t1) != set(want_t) or not all(
                torch.equal(t1[k], want_t[k]) for k in want_t):
            raise AssertionError(f"prefetched batch {c1} differs")
        n_eq += 1
    pooled = ManifestDataset(data_dir, cfg2, workers=workers)
    try:
        for (c1, b1, t1), (c2, b2) in zip(
                prefetch_to_device(BucketedLoader(pooled[n_eval:], cfg2.data)
                                   .epoch(1), dev), loader.epoch(1)):
            want_t = step.batch_to_tensors(batch_to_device_dict(b2), dev)
            if c1 != c2 or set(t1) != set(want_t) or not all(
                    torch.equal(t1[k], want_t[k]) for k in want_t):
                raise AssertionError(f"batch {c1} prefetched from the pool "
                                     f"differs")
            n_eq += 1
    finally:
        pooled.close()
    log(f"phase 11: prefetch: {n_eq} batches (one epoch in process, one "
        f"through the pool) bit-equal to the in-process loader's own moved "
        f"without it")
    shutil.rmtree(keep_checkpoint, ignore_errors=True)
    shutil.copytree(ckpt_dir, keep_checkpoint)
    shutil.rmtree(root, ignore_errors=True)
    one_rank = {f"workers={run['workers']}": run["rate"]
                for run in parts["preset2"]["runs"]}
    return {"audio_train": train_launches,
            "audio_decode": {k: dec_launches.get(k, 0) + p4_launches.get(k, 0)
                             for k in dec_launches}}, one_rank


def chunk_chain(z, w, lens, reverse, n_chunks, plain_check):
    """B1 over z [T, B, H] as ``n_chunks`` chunks, each from the last state
    of the one before (sequence parallelism's carry), in the sweep's
    order; each chunk held against the plain loop from the same h0 when
    ``plain_check``.  Returns (the chained states [T, B, H], the worst
    error against the plain loop, the states beyond tolerance, the middle
    chunk's (z, lengths, h0))."""
    from tpu_ctc_torch.ops import birnn_cuda
    n_t = z.shape[0]
    size = n_t // n_chunks
    starts = list(range(0, n_t, size))
    parts, carry, err, bad, middle = {}, None, 0.0, 0, None
    for s in (starts[::-1] if reverse else starts):
        local = torch.clamp(lens - s, 0, size).to(torch.int32)
        zc = z[s:s + size]
        got = birnn_cuda.fwd_recurrence_cuda(zc, w, local, reverse=reverse,
                                             clip=20.0, h0=carry)
        if plain_check:
            want = birnn_cuda.fwd_recurrence_plain(
                zc, w, local, reverse=reverse, clip=20.0, h0=carry).float()
            diff = (got.float() - want).abs()
            err = max(err, float(diff.max()))
            bad += int((diff > 2 ** -6 * want.abs() + 2e-2).sum())
        if s == starts[n_chunks // 2]:
            middle = (zc, local, carry)
        parts[s] = got
        carry = got[0] if reverse else got[-1]
    return torch.cat([parts[s] for s in starts]), err, bad, middle


def phase_carry(reps: int, dev="cuda"):
    """Phase 12, parts 1 and 2: B1 from h0 at preset 3's width (H = 1824,
    B = 64, bf16) over T = 1600 as 4 chunks of 400 and at preset 2's
    (H = 1024, B = 32) over T = 800 as 2 chunks, both directions: each
    chunk against the plain loop from the same h0, the chain against one
    sweep over T (bit-equal), a chunk from h0 timed beside the same chunk
    from zero; then ``CarryRecurrence``'s backward at preset 2's width
    against its plain autograd."""
    from tpu_ctc_torch.ops import birnn_cuda
    worst, out = 0.0, {}
    for n_h, n_b, n_t, n_chunks in ((1824, 64, 1600, 4), (1024, 32, 800, 2)):
        r = np.random.RandomState(n_h)
        z = torch.from_numpy(3.0 * r.randn(n_t, n_b, n_h).astype(
            np.float32)).to(dev, torch.bfloat16)
        w = torch.from_numpy((0.5 / np.sqrt(n_h)) * r.randn(
            2, n_h, n_h).astype(np.float32)).to(dev, torch.bfloat16)
        lens = torch.from_numpy(r.randint(n_t // 4, n_t + 1, n_b).astype(
            np.int32)).to(dev)
        lens[0] = n_t
        for d, reverse in enumerate((False, True)):
            whole = birnn_cuda.fwd_recurrence_cuda(z, w[d], lens,
                                                   reverse=reverse, clip=20.0)
            chain, err, bad, middle = chunk_chain(z, w[d], lens, reverse,
                                                  n_chunks, True)
            torch.cuda.synchronize()
            same = torch.equal(chain, whole)
            worst = max(worst, err)
            log(f"phase 12: B1 from h0, H={n_h} B={n_b} T={n_t} as "
                f"{n_chunks} chunks {'reversed' if reverse else 'forward'}: "
                f"max abs err against the plain loop {err:.3e}, {bad} beyond "
                f"tolerance; the chain bit-equal to one sweep: {same}")
            if bad or not same:
                raise AssertionError("B1 from h0 disagrees with its plain "
                                     "version or with one sweep")
        zc, local, h0 = middle
        ms_h0 = time_ms(lambda: birnn_cuda.fwd_recurrence_cuda(
            zc, w[1], local, reverse=True, clip=20.0, h0=h0), reps)
        ms_zero = time_ms(lambda: birnn_cuda.fwd_recurrence_cuda(
            zc, w[1], local, reverse=True, clip=20.0), reps)
        log(f"phase 12: B1 chunk of {zc.shape[0]} frames at H={n_h}, "
            f"B={n_b}: {ms_h0:.3f} ms from h0, {ms_zero:.3f} ms from zero")
        out[n_h] = (ms_h0, ms_zero)

    # CarryRecurrence's backward (B2 and the GEMMs) against plain autograd.
    # Held on the same forward states: with a forward of its own each path
    # stores bf16 states that round the other way here and there, a few
    # hundred units then sit on the other side of h > 0, and the masked
    # deltas there move dz and dW by ~1e-2 of their norm (plain against
    # plain with the f32 sums in another order does the same on the CPU:
    # 663 flips, dz 1.3e-2).  The independent paths are printed too.
    n_t, n_b, n_h = 400, 32, 1024
    r = np.random.RandomState(12)
    z = torch.from_numpy(3.0 * r.randn(n_b, n_t, n_h).astype(np.float32))
    w = torch.from_numpy((0.5 / np.sqrt(n_h)) * r.randn(n_h, n_h).astype(
        np.float32))
    h0 = torch.from_numpy(np.abs(2 * r.randn(n_b, n_h)).astype(np.float32))
    g = torch.from_numpy(r.randn(n_b, n_t, n_h).astype(np.float32)).to(dev)
    lens = torch.from_numpy(r.randint(n_t // 2, n_t + 1, n_b))
    lens[0] = n_t            # a live first frame both ways: dh0 nonzero
    mask = (torch.arange(n_t)[None] < lens[:, None]).float().to(dev)
    bf = torch.bfloat16
    for reverse in (False, True):
        res = []
        for plain in (False, True):
            args = [x.to(dev).requires_grad_(True) for x in (z, w, h0)]
            hs = birnn_cuda.carry_recurrence(
                *args, mask, reverse=reverse, clip=20.0, compute_dtype=bf,
                plain=plain)
            hs.backward(g)
            res.append([hs.detach()] + [a.grad for a in args])
        flips = int(((res[0][0] > 0) != (res[1][0] > 0)).sum())
        own = {name: rel_err(a, b) for name, a, b in
               zip(("hs", "dz", "dW", "dh0"), *res)}
        hs_io = res[0][0].transpose(0, 1).to(bf).contiguous()
        h0_io, w_d = h0.to(dev, bf), w.to(dev)
        g_t = g.transpose(0, 1)
        same = [birnn_cuda.carry_sweep_grad(
            g_t, hs_io, h0_io, w_d, reverse=reverse, clip=20.0, cdt=bf,
            plain=plain) for plain in (False, True)]
        held = {name: rel_err(a, b) for name, a, b in
                zip(("dz", "dW", "dh0"), *same)}
        log(f"phase 12: CarryRecurrence H={n_h} B={n_b} T={n_t} bf16 "
            f"{'reversed' if reverse else 'forward'}: backward (B2, the "
            f"GEMMs) against the plain backward on the same states, rel err "
            + ", ".join(f"{k} {v:.2e}" for k, v in held.items())
            + f" (limit {GRAD_REL_TOL}); whole paths each with its own "
            f"forward: " + ", ".join(f"{k} {v:.2e}" for k, v in own.items())
            + f", {flips} units on the other side of h > 0")
        if max(held.values()) > GRAD_REL_TOL or own["hs"] > GRAD_REL_TOL:
            raise AssertionError("CarryRecurrence's gradients disagree")
    return worst, out


def preset3_batches(n_steps: int):
    """The global batches of phase 12's steps: preset 3 (``swbd_5layer_dp``)
    at B = 64 on synthetic utterances of 400-800 frames."""
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.synthetic import SyntheticCorpus
    cfg = get_config("swbd_5layer_dp")
    corpus = SyntheticCorpus(64 * n_steps, feature_dim=cfg.model.input_dim,
                             min_chars=50, max_chars=100, seed=12)
    return cfg, [b for _, b in BucketedLoader(corpus.all_utterances(),
                                              cfg.data).epoch(0)][:n_steps]


CHAIN_SET = {"model.hidden_dim": 512, "data.batch_size": 16,
             "data.bucket_boundaries": (80, 160, 320),
             "data.max_label_len": 64}


def mesh_batches(shape: str, n_steps: int):
    """(config, global batches) of a mesh run: ``preset3`` is
    :func:`preset3_batches`; ``chain`` the accuracy chain's shape
    (``docs/EVAL.md``: preset 2 at H = 512, B = 16, buckets (80, 160,
    320), labels <= 64) on synthetic utterances of 5-38 characters (40-304
    frames: every bucket, label widths 32 and 64)."""
    if shape == "preset3":
        return preset3_batches(n_steps)
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.synthetic import SyntheticCorpus
    cfg = get_config("timit_full_3layer", **CHAIN_SET)
    corpus = SyntheticCorpus(16 * n_steps, feature_dim=cfg.model.input_dim,
                             min_chars=5, max_chars=38, seed=15)
    return cfg, [b for _, b in BucketedLoader(corpus.all_utterances(),
                                              cfg.data).epoch(0)][:n_steps]


def step_turns(cfg, mesh, dev, tensors, turns=("graphs", "eager")):
    """This rank's run of the compiled mesh step against the eager one:
    two states from the same seed, one through ``make_train_step`` (the
    compiled step where ``step.eager_reason`` gives no reason) and one
    through ``make_train_step`` stepped by the compiled step's ``eager``
    (the eager mesh step it captures); each turn of ``turns``
    steps one of them over ``tensors`` (on a mesh that stays eager only
    the eager turns run); the graphs of every shape are captured before
    the first turn (the state left as it was), so no turn's step holds a
    capture.  Returns (the record, the first turn's state):
    per turn its kind, losses, synchronised step walls and host seconds
    to the step's return, and launches (the first turn's counts zeroed
    just before it: the main path); the graphs' shapes and capture
    seconds; whether every step's metrics and the final parameters and
    trace are bit-equal between the two states and the launch counts
    equal; and a hash of the replicated parameters."""
    import hashlib
    from tpu_ctc_torch.train import graphs, step
    why = step.eager_reason(cfg, mesh, dev)
    kinds = ["eager"] if why else ["graphs", "eager"]
    fns, states = {}, {}
    for kind in kinds:
        fn, states[kind] = step.make_train_step(
            cfg, mesh, step.create_train_state(cfg, device=dev))
        fns[kind] = fn if kind == "graphs" else getattr(fn, "eager", fn)
    if not why:
        if not isinstance(fns["graphs"], graphs.CompiledTrainStep):
            raise AssertionError(f"an NCCL mesh's step {fns['graphs']}")
        for bt in tensors:      # every shape captured before the turns
            fns["graphs"].capture(states["graphs"], bt)
    seen = {k: [] for k in kinds}
    counts = {k: {} for k in kinds}
    runs = []
    for kind in [k for k in turns if k in fns]:
        walls, hosts, losses = [], [], []

        def run():
            for bt in tensors:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states[kind], m = fns[kind](states[kind], bt)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                hosts.append(t1 - t0)
                seen[kind].append({k: v.cpu() for k, v in m.items()})
                losses.append(float(m["loss"]))
        _, launches = run_main_path(run)
        for k, n in launches.items():
            counts[kind][k] = counts[kind].get(k, 0) + n
        runs.append({"kind": kind, "losses": losses, "walls": walls,
                     "hosts": hosts, "launches": launches})
    main = states[runs[0]["kind"]]
    rec = {"eager_reason": why, "runs": runs}
    if not why:
        a, b = states["graphs"], states["eager"]
        rec["stats"] = fns["graphs"].stats()
        rec["bit_equal"] = {
            "metrics": len(seen["graphs"]) == len(seen["eager"]) and all(
                x.keys() == y.keys() and all(torch.equal(x[k], y[k])
                                             for k in x)
                for x, y in zip(seen["graphs"], seen["eager"])),
            "parameters": all(torch.equal(p, q) for p, q in zip(
                a.model.parameters(), b.model.parameters())),
            "trace": all(torch.equal(a.opt_state.trace[k],
                                     b.opt_state.trace[k])
                         for k in a.opt_state.trace),
            "launches": counts["graphs"] == counts["eager"]}
    h = hashlib.sha256()
    for k, p in main.model.named_parameters():
        if step.sharded_dim((main.specs or {}).get(k, ())) is None:
            h.update(p.detach().cpu().numpy().tobytes())
    rec["replicated"] = h.hexdigest()
    if not why:         # its graphs hold NCCL's communicators
        fns["graphs"].release()
    return rec, main


def describe_turns(phase: str, what: str, recs, audio):
    """Print a mesh run's compiled-against-eager record (ranks' records
    of :func:`step_turns`; ``audio``: the audio seconds of each step's
    global batch) and raise unless, where the step is compiled, every
    rank's graphs are bit-equal to its eager step (metrics at every step,
    parameters, trace, launch counts); returns rank 0's main turn (the
    first)."""
    rec = recs[0]
    if rec["eager_reason"]:
        log(f"{phase}: {what}: the eager step, not graphs: "
            f"{rec['eager_reason']}")
        return rec["runs"][0]
    for run in rec["runs"]:
        log(f"{phase}: {what}: {run['kind']} turn (rank 0): "
            f"{float(np.mean(run['walls'])) * 1e3:.2f} ms a step "
            f"(steps synchronised), {sum(audio) / sum(run['walls']):.1f} "
            f"audio-s/s, host {float(np.median(run['hosts'])) * 1e3:.3f} "
            f"ms a step to its return (median)")
    equal = [r["bit_equal"] for r in recs]
    ok = all(all(e.values()) for e in equal)
    log(f"{phase}: {what}: compiled step, {rec['stats']['shapes']} shape(s) "
        f"captured in "
        f"{[round(x, 3) for x in rec['stats']['capture_s']]} s (warm-up + "
        f"capture, rank 0); bit-equal to the eager mesh step on every "
        f"rank (metrics every step, parameters, trace, launch counts): "
        f"{ok} {equal[0]}")
    if not ok:
        raise AssertionError(f"{what}: the compiled mesh step differs from "
                             f"the eager one: {equal}")
    return rec["runs"][0]


def phase_mesh_one(steps=3, dev="cuda"):
    """Phase 12, part 3: preset 3 at B = 64 through ``make_mesh`` and
    ``make_train_step`` with a one-rank NCCL group (the compiled step: one
    CUDA graph per batch shape), against ``train_step`` from the same seed
    on the same batches: loss and parameters bit-equal (outside
    deterministic mode: the CTC glue's gather sums its gradient in a fixed
    order)."""
    import torch.distributed as dist
    from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
    from tpu_ctc_torch.train import graphs, step
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    cfg, batches = preset3_batches(steps)
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0,
                           device=dev)
    try:
        mesh = mesh_lib.make_mesh(cfg.mesh)
        log(f"phase 12: one-rank {dist.get_backend()} group, mesh "
            f"{mesh.shape}; preset {cfg.name}, batches "
            f"{[b.feats.shape for b in batches]}")
        tensors = [step.batch_to_tensors(batch_to_device_dict(b), dev)
                   for b in batches]
        state = step.create_train_state(cfg, device=dev)
        step_fn, state = step.make_train_step(cfg, mesh, state)
        if not isinstance(step_fn, graphs.CompiledTrainStep):
            raise AssertionError(f"one-rank mesh step {step_fn}")

        walls = []

        def run():
            nonlocal state
            out = []
            for bt in tensors:
                torch.cuda.synchronize()
                t0 = time.time()
                state, m = step_fn(state, bt)
                out.append(float(m["loss"]))
                walls.append(time.time() - t0)
            return out
        losses, launches = run_main_path(run)
        ref = step.create_train_state(cfg, device=dev)
        ref_losses = []
        for bt in tensors:
            ref, m = step.train_step(ref, bt, cfg)
            ref_losses.append(float(m["loss"]))
        same = losses == ref_losses and all(
            torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                              ref.model.parameters()))
        step_s = float(np.median(walls[1:]))
        audio = float(np.mean([int(b.frame_lengths.sum()) / 100
                               for b in batches[1:]]))
        log(f"phase 12: mesh path (the compiled step, "
            f"{step_fn.stats()['shapes']} shape(s) captured), {steps} steps: "
            f"step {step_s * 1e3:.1f} ms (median of steps 2-3) = "
            f"{audio / step_s:.1f} audio-s/s; losses "
            f"{[round(x, 4) for x in losses]}; loss and parameters bit-equal "
            f"to train_step: {same}; launches on the path {launches}")
        if not same:
            raise AssertionError("the one-rank mesh step differs from "
                                 "train_step")
        if launches["birnn_fwd"] != 10 * steps:
            raise AssertionError(f"launches {launches}")
        captured_all_reduce(state, dev)
    finally:
        dist.destroy_process_group()
    return launches, ref_losses


def captured_all_reduce(state, dev="cuda"):
    """One NCCL collective in a CUDA graph, on the card this run has: the
    step's gradient all-reduce (``train.step._all_reduce_grads``, one
    all-reduce of the flattened gradients) over the one-rank NCCL world,
    captured after a warm-up on a side stream, then replayed on two new
    sets of values, each bit-equal to the eager call on the same
    values.  (Several ranks' graphs need several cards: phases 12 and 14
    hold them where ``nvidia-smi -L`` lists enough.)"""
    from tpu_ctc_torch.train import step
    grads = [torch.zeros_like(p) for p in state.model.parameters()]
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        step._all_reduce_grads(grads)
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = step._all_reduce_grads(grads)
    same = []
    for seed in (1, 2):
        gen = torch.Generator(device=dev).manual_seed(seed)
        vals = [torch.randn(g.shape, generator=gen, device=dev).to(g.dtype)
                for g in grads]
        for g, v in zip(grads, vals):
            g.copy_(v)
        graph.replay()
        want = step._all_reduce_grads([v.clone() for v in vals])
        same.append(all(torch.equal(a, b) for a, b in zip(out, want)))
    log(f"phase 12: the step's gradient all-reduce (_all_reduce_grads, "
        f"{sum(g.numel() for g in grads)} values) captured in a CUDA graph "
        f"over the one-rank NCCL group; 2 replays on new values bit-equal "
        f"to the eager call: {same}")
    if not all(same):
        raise AssertionError("a captured NCCL all-reduce differs from the "
                             "eager one")


RANK_WORKER = r"""
import faulthandler, json, sys
import torch, torch.distributed as dist
faulthandler.dump_traceback_later(540, exit=True)   # a hang shows its stack
sys.path.insert(0, sys.argv[6])
import chip_smoke
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
from tpu_ctc_torch.train import step
from tpu_ctc_torch.train.loop import batch_to_device_dict

coord, rank, world, backend, dev, _, spec = sys.argv[1:8]
rank, world, spec = int(rank), int(world), json.loads(spec)
dev = distributed.initialize(coord, world, rank, device=dev, backend=backend)
cfg, batches = chip_smoke.mesh_batches(spec["shape"], spec["steps"])
cfg = cfg.override(**{"mesh.data": spec["data"], "mesh.seq": spec["seq"]})
mesh = mesh_lib.make_mesh(cfg.mesh)
tensors = [step.batch_to_tensors(batch_to_device_dict(b), dev, mesh)
           for b in batches]
rec, _ = chip_smoke.step_turns(cfg, mesh, dev, tensors, spec["turns"])
rec.update(rank=rank, mesh=mesh.shape)
print("RANK " + json.dumps(rec), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def card_count() -> int:
    listed = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                            text=True, check=True, timeout=60).stdout
    return sum(1 for line in listed.splitlines() if line.startswith("GPU "))


def spawn_ranks(world: int, backend: str, devs, data: int, seq: int,
                steps: int = 3, shape: str = "preset3",
                turns=("graphs", "eager"), timeout: int = 600):
    """The first ``steps`` global batches of :func:`mesh_batches`
    (``shape``) through ``make_train_step`` on a mesh of ``world`` ranks
    (one process each on ``devs[r]``, ``backend``, mesh data x seq), the
    compiled step against the eager one in ``turns``
    (:func:`step_turns`); returns each rank's record."""
    from tpu_ctc_torch.parallel import distributed
    root = os.path.dirname(os.path.abspath(__file__))
    coord = f"127.0.0.1:{distributed.free_port()}"
    spec = json.dumps({"shape": shape, "steps": steps, "data": data,
                       "seq": seq, "turns": list(turns)})
    return distributed.spawn_ranks(
        [[sys.executable, "-c", RANK_WORKER, coord, str(r), str(world),
          backend, devs[r], root, spec]
         for r in range(world)], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), timeout=timeout)


def phase_mesh_ranks(ref_losses):
    """Phase 12, part 4: preset 3 over several ranks for 3 steps on phase
    12's global batches.  On 2 or more cards NCCL ranks, one card each:
    DP2 (data = 2) and SP2 (seq = 2), each the compiled step (one CUDA
    graph per batch shape) against the eager mesh step from the same
    seed (:func:`step_turns`: bit-equal in metrics, parameters, trace and
    launch counts on every rank).  On one
    card SP2 as 2 gloo ranks sharing it (NCCL refuses two ranks on one
    device; gloo sums CUDA tensors), which stays eager (gloo's
    collectives run through the host).  On 4 or more cards DP2 x SP2
    (data = 2, seq = 2) as well, the same way.  The losses against the one-card
    step's within LOSS_REL_TOL, the parameters bit-equal across ranks.
    Returns {mesh name: launches of its main run, ranks summed}."""
    count = card_count()
    if count >= 2:
        backend = "nccl"
        meshes = [(2, 1), (1, 2)] + ([(2, 2)] if count >= 4 else [])
    else:
        backend, meshes = "gloo", [(1, 2)]
    _, batches = preset3_batches(3)
    audio = float(np.mean([int(b.frame_lengths.sum()) / 100
                           for b in batches[1:]]))
    out = {}
    for data, seq in meshes:
        world = data * seq
        devs = ([f"cuda:{r}" for r in range(world)] if backend == "nccl"
                else ["cuda:0"] * world)
        name = f"data={data} seq={seq}"
        log(f"phase 12: nvidia-smi -L lists {count} card(s): {world} "
            f"{backend} ranks on {devs}, mesh {name}")
        recs = spawn_ranks(world, backend, devs, data, seq)
        first = describe_turns("phase 12", f"preset 3 on {name}", recs,
                               [int(b.frame_lengths.sum()) / 100
                                for b in batches])
        losses = first["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        same = len({rec["replicated"] for rec in recs}) == 1
        step_s = float(np.median(first["walls"][1:]))
        launches = {k: sum(rec["runs"][0]["launches"][k] for rec in recs)
                    for k in first["launches"]}
        log(f"phase 12: {world} ranks ({backend}), mesh {recs[0]['mesh']}: "
            f"losses {[round(x, 4) for x in losses]} against one card's "
            f"{[round(x, 4) for x in ref_losses]} (rel {rel:.2e}, limit "
            f"{LOSS_REL_TOL}); parameters bit-equal across ranks: {same}; "
            f"step {step_s * 1e3:.1f} ms (median of steps 2-3) = "
            f"{audio / step_s:.1f} audio-s/s; launches on the path (all "
            f"ranks) {launches}")
        if rel > LOSS_REL_TOL or not same:
            raise AssertionError(f"the multi-rank step on {name} disagrees")
        if launches["birnn_fwd"] == 0 or launches["birnn_bwd"] == 0:
            raise AssertionError(f"the step on {name} launched no B1 or B2")
        out[name] = launches
    return out


AUDIO_RANK_WORKER = r"""
import faulthandler, hashlib, json, os, sys, time
import torch, torch.distributed as dist
faulthandler.dump_traceback_later(540, exit=True)   # a hang shows its stack
sys.path.insert(0, sys.argv[6])
import chip_smoke
from tpu_ctc_torch.config import get_config
from tpu_ctc_torch.data.manifest import ManifestDataset, host_workers
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
from tpu_ctc_torch.train import loop, step

coord, rank, world, backend, dev, _, corpus, spec = sys.argv[1:9]
rank, world, spec = int(rank), int(world), json.loads(spec)
dev = distributed.initialize(coord, world, rank, device=dev, backend=backend)
real = loop.prefetch_to_device


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


runs = []
for name, overrides in spec["meshes"].items():
    cfg = get_config("timit_full_3layer", **overrides, **spec["set"])
    mesh = mesh_lib.make_mesh(cfg.mesh)
    train = ManifestDataset(corpus, cfg, workers=host_workers())
    valid = ManifestDataset(corpus, cfg, split="valid")
    epochs, hashes, kept = [], {}, []

    def traced(iterator, device, size=2, select=None):
        # the loop's own prefetch, each epoch's payload reads recorded
        epochs.append(train.payload_reads)
        for cursor, batch, tb in real(iterator, device, size=size,
                                      select=select):
            if len(epochs) == 1:
                hashes[cursor] = digest(tb[k] for k in sorted(tb))
                kept.append((batch.audio_seconds(), tb))
            yield cursor, batch, tb
        epochs[-1] = train.payload_reads - epochs[-1]

    loop.prefetch_to_device = traced
    mesh_lib.RowExchange.calls, mesh_lib.RowExchange.seconds = 0, 0.0
    work = os.path.join(spec["work"], name, str(rank))
    (state, _), launches = chip_smoke.run_main_path(lambda: loop.train(
        cfg, train, valid, work_dir=work, device=dev, mesh=mesh))
    params = digest(step.full_state(state).model.parameters())
    exchanged = [mesh_lib.RowExchange.seconds, mesh_lib.RowExchange.calls]
    # the same mesh on the first epoch's blocks in memory: a fresh state,
    # a pass to capture the graphs (NCCL ranks), then a timed one
    mem = step.create_train_state(cfg, device=dev)
    step_fn, mem = step.make_train_step(cfg, mesh, mem)
    if hasattr(step_fn, "release"):
        for _, tb in kept:
            mem, _ = step_fn(mem, tb)
    torch.cuda.synchronize()
    t0 = time.time()
    for _, tb in kept:
        mem, _ = step_fn(mem, tb)
    torch.cuda.synchronize()
    mem_s = time.time() - t0
    if hasattr(step_fn, "release"):
        step_fn.release()   # its graphs hold NCCL's communicators
    # the loop's own windows (log_every=1: a step and its loader wait,
    # without the evals), written by rank 0: the job's rate past epoch 1
    logged, evals = [], 0
    if rank == 0:
        with open(os.path.join(work, "metrics.jsonl")) as f:
            events = [json.loads(x) for x in f]
        logged = [e for e in events if e["kind"] == "train"]
        evals = sum(e["kind"] == "eval" for e in events)
    late = logged[len(kept):]
    runs.append({
        "name": name, "rank": rank, "mesh": mesh.shape,
        "workers": host_workers(), "epochs": epochs,
        "eval_reads": valid.payload_reads, "evals": evals,
        "hashes": hashes, "launches": launches, "params": params,
        "losses": [e["loss"] for e in logged],
        "rate": (sum(e["audio_s_per_s"] * e["step_time_s"] for e in late)
                 / sum(e["step_time_s"] for e in late)) if late else None,
        "step_s": sum(e["step_time_s"] for e in late) / max(len(late), 1),
        "exchange_s": exchanged,
        "memory_rate": sum(a for a, _ in kept) / mem_s})
    del state, mem, kept
    dist.barrier()
print("RANK " + json.dumps({"rank": rank, "runs": runs}), flush=True)
dist.destroy_process_group()
"""

# phase 12 part 5's meshes from audio: a 'data', a 'seq' and a 'model' line
AUDIO_MESHES = {name: {"mesh.data": d, "mesh.model": m, "mesh.seq": q}
                for name, (d, m, q) in (("DP2", (2, 1, 1)), ("SP2", (1, 1, 2)),
                                        ("TP2", (1, 2, 1)))}


def hand_mesh(shape: dict, rank: int):
    """Rank ``rank``'s view of a (data, model, seq) grid as ``make_mesh``
    lays it out (data-major), without process groups."""
    from tpu_ctc_torch.parallel import mesh as mesh_lib
    dims = [shape[a] for a in mesh_lib.MESH_AXES]
    grid = np.arange(int(np.prod(dims))).reshape(dims)
    coord = tuple(int(c[0]) for c in np.nonzero(grid == rank))
    lines = {axis: tuple(int(r) for r in
                         grid[coord[:a] + (slice(None),) + coord[a + 1:]])
             for a, axis in enumerate(mesh_lib.MESH_AXES)}
    return mesh_lib.Mesh(dict(shape), rank, lines)


def mesh_audio_reference(root: str, seed: int, meshes=AUDIO_MESHES):
    """Phase 12, part 5's corpus under ``root`` (phase 11's 96 training
    waveforms and 32 valid ones) and what its ranks must give: {(mesh
    name, rank): {cursor: the sha256 of the rank's block of one card's
    global batch of the first epoch}}, one rank's payload reads an epoch
    and an eval's, and the epoch's batches."""
    import hashlib

    from torch_tools import audio_path_breakdown as apb
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.data.bucketing import BucketedLoader, cut_labels
    from tpu_ctc_torch.data.manifest import ManifestDataset
    from tpu_ctc_torch.train import step
    from tpu_ctc_torch.train.loop import batch_to_device_dict

    cfg = get_config("timit_full_3layer")
    apb.tone_corpus(root, cfg.frontend, seed)
    whole = ManifestDataset(root, cfg)
    batches = list(BucketedLoader(whole, cfg.data).epoch(0))
    want = {}
    for name, axes in meshes.items():
        shape = {k.split(".")[1]: v for k, v in axes.items()}
        for r in range(2):
            mesh = hand_mesh(shape, r)
            want[name, r] = {}
            for cursor, batch in batches:
                block = step.local_batch(cut_labels(batch_to_device_dict(
                    batch)), mesh)
                h = hashlib.sha256()
                for k in sorted(block):
                    h.update(torch.as_tensor(block[k]).numpy().tobytes())
                want[name, r][str(cursor)] = h.hexdigest()
    one_eval = len(ManifestDataset(root, cfg, split="valid"))
    return want, whole.payload_reads, one_eval, len(batches)


def spawn_mesh_audio(root: str, tree: str, worker: str, meshes, epochs: int,
                     steps: int):
    """``worker`` (:data:`AUDIO_RANK_WORKER`) on two ranks importing the
    package of the checkout ``tree``: NCCL ranks on two cards, or two gloo
    ranks sharing one.  Returns (each rank's record, backend, devices)."""
    from tpu_ctc_torch.parallel import distributed
    backend, devs = (("nccl", ["cuda:0", "cuda:1"]) if card_count() >= 2
                     else ("gloo", ["cuda:0", "cuda:0"]))
    spec = json.dumps({
        "meshes": meshes, "work": os.path.join(root, "work"),
        "set": {"train.num_epochs": epochs, "train.log_every": 1,
                "train.eval_every": steps, "train.checkpoint_every": 0}})
    coord = f"127.0.0.1:{distributed.free_port()}"
    recs = distributed.spawn_ranks(
        [[sys.executable, "-c", worker, coord, str(r), "2", backend,
          devs[r], tree, root, spec] for r in range(2)],
        cwd=tree, env=dict(os.environ, PYTHONPATH=tree,
                           LOCAL_WORLD_SIZE="2"), timeout=600)
    return recs, backend, devs


def mesh_audio_report(phase: str, name: str, recs, reference, one_rank,
                      epochs: int):
    """Logs mesh ``name``'s run from audio against ``reference``
    (:func:`mesh_audio_reference`'s) and returns (the checks it failed,
    its launches with the ranks summed)."""
    want, one_reads, one_eval, steps = reference
    got = [run for rec in recs for run in rec["runs"] if run["name"] == name]
    same = [rec["hashes"] == want[name, rec["rank"]] for rec in got]
    params_same = len({rec["params"] for rec in got}) == 1
    reads = [rec["epochs"] for rec in got]
    evals = [rec["eval_reads"] / got[0]["evals"] for rec in got]
    rate = got[0]["rate"]
    launches = {k: sum(rec["launches"][k] for rec in got)
                for k in got[0]["launches"]}
    log(f"{phase}: {name} from audio: payload reads per epoch {reads} "
        f"against one rank's {one_reads}, an eval's {evals} against "
        f"{one_eval}; each rank's first-epoch blocks bit-equal to "
        f"local_batch of one card's global batches: {same} ({steps} "
        f"batches); parameters bit-equal across ranks: {params_same}; "
        f"losses {[round(x, 3) for x in got[0]['losses']]}")
    mem = got[0]["memory_rate"]
    ex = [f"{s / max(n, 1) * 1e3:.1f} ms x {n}"
          for s, n in (rec["exchange_s"] for rec in got)]
    log(f"{phase}: {name} from audio: each rank's row exchanges {ex}")
    log(f"{phase}: {name} from audio: the job {rate:.1f} audio-s/s "
        f"(epochs 2-{epochs}, {got[0]['step_s'] * 1e3:.1f} ms a step, "
        f"the loop's own windows); the same mesh on the first epoch's "
        f"blocks in memory {mem:.1f} audio-s/s ({rate / mem:.3f} of it); "
        f"one rank from audio (phase 11): {one_rank}; launches on the path "
        f"(both ranks) {launches}")
    failed = []
    if not all(same) or not params_same:
        failed.append(f"{name} from audio: a rank's blocks differ from "
                      f"one card's, or the ranks' parameters differ")
    if any(r > one_reads * 0.75 for rank in reads for r in rank) or \
            any(e > one_eval * 0.75 for e in evals):
        failed.append(f"{name} from audio: a rank read more than its "
                      f"share of the rows")
    if not (launches.get("birnn_fwd") and launches.get("birnn_bwd")):
        failed.append(f"{name} from audio launched no B1 or B2")
    return failed, launches


def phase_mesh_audio(seed: int, one_rank, epochs: int = 2,
                     meshes=AUDIO_MESHES):
    """Phase 12, part 5: preset 2 from audio on two ranks under DP2, SP2
    and TP2 (``AUDIO_MESHES``), through ``train.loop.train`` as ``cli
    train --data`` runs it: NCCL ranks on two cards, or two gloo ranks
    sharing one, each with its own frontend pool (``host_workers()``
    under ``LOCAL_WORLD_SIZE=2``), for ``epochs`` epochs of phase 11's 96
    training waveforms (the first a warm-up), each followed by an eval of
    its 32 valid ones.  Each rank's payload reads per epoch, and per eval,
    at most 0.75 of one rank's: a rank featurizes its share of the rows
    its step reads (on a 'model' or 'seq' line half of them, the other
    half exchanged); its prefetched arrays of the first epoch bit-equal to
    ``local_batch`` of one card's global batches; the parameters bit-equal
    across ranks (gathered under TP); the job's audio-s/s past the first
    epoch (the loop's own windows: a step and its loader wait, without
    the evals) beside the same mesh's step on the first epoch's blocks in
    memory.  One spawn of the two ranks runs the meshes in turn.  Returns
    {mesh name: launches, ranks summed}."""
    import shutil
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "chip_smoke_mesh_audio")
    shutil.rmtree(root, ignore_errors=True)
    reference = mesh_audio_reference(root, seed, meshes)
    t0 = time.time()
    recs, backend, devs = spawn_mesh_audio(root, here, AUDIO_RANK_WORKER,
                                           meshes, epochs, reference[3])
    log(f"phase 12: preset 2 from audio on {', '.join(meshes)} ({backend} "
        f"ranks on {devs}, {recs[0]['runs'][0]['workers']} frontend "
        f"workers each): {time.time() - t0:.1f} s; one rank reads "
        f"{reference[1]} payloads an epoch, {reference[2]} an eval")
    out = {}
    for name in meshes:
        failed, out[name] = mesh_audio_report("phase 12", name, recs,
                                              reference, one_rank, epochs)
        if failed:
            raise AssertionError("; ".join(failed))
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Phase 13: the benchmarks and the tools
# ---------------------------------------------------------------------------

def run_tool(what: str, main, argv, phase: str = "phase 13"):
    """``main(argv)`` (a bench's or a tool's) with its stdout and stderr
    logged line by line as ``<phase>: <what>: ...``, then its wall time;
    raises unless it returns 0.  Returns its stdout's lines."""
    import io
    out, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        for line in err.getvalue().splitlines() + out.getvalue().splitlines():
            log(f"{phase}: {what}: {line}")
        log(f"{phase}: {what} took {time.time() - t0:.1f} s")
    if rc != 0:
        raise AssertionError(f"{what} returned {rc}")
    return out.getvalue().splitlines()


def bench_json(what: str, lines, may_be_null=()):
    """The JSON object on the last of a bench's stdout lines; raises where
    a value other than those in ``may_be_null`` is null."""
    rec = json.loads(lines[-1])
    nulls = [k for k, v in rec.items() if v is None and k not in may_be_null]
    if nulls:
        raise AssertionError(f"{what}: null in place of {nulls}")
    return rec


def cpp_against_b5(dev="cuda"):
    """The native C++ decoder (double sums, ``decode/cpp_decoder.py``)
    against kernel B5 on phase 3's posteriors and trigram (B = 64,
    T = 800, K = 128, alpha 1.25, beta 1.5, no pruning or char cap: the
    C++ search takes neither), with the plain search in float32 and in
    float64 on the card beside them, under ``torch_tools/cpp_b5.py``'s
    rule (PERF.md section 2).  The C++ search runs slices of the batch at
    once; its rate is the audio over the slices' summed times (one
    core's rate)."""
    from torch_tools import cpp_b5
    lp, lens = peaked_posteriors(2, 64, 800)
    r = cpp_b5.compare(lp, lens, seeded_trigram(3), 128, 216, 1.25, 1.5, dev)
    audio = float(lens.sum()) / 100
    log(f"phase 13: cpp against B5 (B=64, T=800, K=128, trigram): "
        f"{cpp_b5.summary(r)}; cpp {audio / r['cpp_cpu_s']:.1f} audio-s/s a "
        f"core ({r['cpp_cpu_s']:.1f} s on {cpp_b5.THREADS} threads, "
        f"{r['cpp_wall_s']:.1f} s wall)")
    if not cpp_b5.holds(r):
        raise AssertionError("the C++ decoder disagrees with B5")


def tools_round_trip(checkpoint_dir: str, dev="cuda"):
    """The tools on a corpus under ``build/chip_smoke_tools``:
    ``make_sample_corpus`` (24 SPHERE utterances in a TIMIT layout), then
    ``make_manifest --layout timit`` with valid and dev splits, then a
    2-point ``sweep_decode`` (CER) of phase 11's checkpoint (preset 2) on
    the dev split on the card, then ``cli decode`` of the dev split at the
    best point and ``score`` of its trn files.  Each must run and print
    its line; the decode's CER is printed beside the sweep's, not held to
    it: phase 11's checkpoint has taken a few steps and decodes empty
    hypotheses, so every grid point reads 100% whatever alpha and beta
    do."""
    import shutil

    from tpu_ctc_torch import cli
    from torch_tools import make_manifest, make_sample_corpus, score
    from torch_tools import sweep_decode
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_tools")
    tree, data, hyp = (os.path.join(root, d) for d in ("tree", "manifest",
                                                       "hyp"))
    for d in (tree, data, hyp):
        shutil.rmtree(d, ignore_errors=True)
    run_tool("make_sample_corpus", make_sample_corpus.main,
             ["--out", tree, "--n", "24", "--seed", "13"])
    run_tool("make_manifest", make_manifest.main,
             ["--layout", "timit", "--src", tree, "--out", data,
              "--val-frac", "0.2", "--dev-frac", "0.4"])
    lines = run_tool("sweep_decode", sweep_decode.main, [
        "--config", "2", "--data", data, "--split", "dev", "--checkpoint",
        checkpoint_dir, "--alphas", "1.0", "--betas", "0.5,1.5", "--unit",
        "char", "--device", dev])
    best = bench_json("sweep_decode", lines)["best"]
    decoded = run_tool("cli decode", cli.main, [
        "decode", "--config", "2", "--checkpoint", checkpoint_dir, "--data",
        data, "--split", "dev", "--beam", "--hyp-out", hyp, "--device", dev,
        "--set", f"decode.lm_alpha={best['alpha']}",
        "--set", f"decode.lm_beta={best['beta']}"])
    cer = float(re.search(r"CER ([\d.]+)%", "\n".join(decoded)).group(1))
    line = run_tool("score", score.main, [
        "--ref", os.path.join(hyp, "ref.trn"), "--hyp",
        os.path.join(hyp, "hyp.trn"), "--unit", "char"])[0]
    log(f"phase 13: tools round trip: best point {best}; the decode's CER at "
        f"it {cer:.2f}%; score of its trn files (trailing spaces dropped): "
        f"{line}")
    if "CER" not in line:
        raise AssertionError(f"score printed no CER: {line}")
    shutil.rmtree(root, ignore_errors=True)


def ctc_event_ms_at_bench_shape(dev="cuda"):
    """B3 + B4 on ``bench_ctc``'s inputs at its defaults (B = 32,
    T = 1600, L = 120) as phase 6 launches them, each timed with CUDA
    events around runs of back-to-back launches
    (``utils.devtime.event_ms``)."""
    from tpu_ctc_torch.bench import bench_ctc
    from tpu_ctc_torch.ops import ctc_cuda
    from tpu_ctc_torch.utils.devtime import event_ms
    logits, labels, tl, ll = bench_ctc.inputs(device=dev)
    emit, skip, skip2, init, final, lengths = ctc_cuda.lattice(
        torch.log_softmax(logits, -1), labels, tl, ll)
    return (event_ms(ctc_cuda.alpha_cuda, emit, skip, init, lengths)
            + event_ms(ctc_cuda.beta_cuda, emit, skip2, final, lengths))


def phase_tools(phase6, checkpoint_dir: str, dev="cuda"):
    """Phase 13: the port's benches and tools on the card, each JSON line
    printed; B3 + B4's device time in ``bench_ctc`` (T = 1600) within 20%
    of their CUDA-event time on its lattice
    (:func:`ctc_event_ms_at_bench_shape`; phase 6's single-call medians
    scaled by 1600 / 800 are printed beside it).  The benches' launches
    are no main path's: the counts are zeroed first and not read."""
    from tpu_ctc_torch.bench import (bench, bench_ctc, bench_decode,
                                     bench_scaling)
    from torch_tools import preset_fit, smoke_cuda_decode
    for kern in all_kernels():
        kern.launches = 0
    t0 = time.time()
    bench_json("bench.bench", run_tool(
        "bench.bench", bench.main, ["--cpu-utts", "1"]))

    ran = {}

    def ctc_bench(_):
        # at its shape, 3 calls a row (2 of the plain loop)
        ran["results"], cells = bench_ctc.run(iters=3)
        print(json.dumps(bench_ctc.report(ran["results"], cells, dev)))
        return 0
    bench_json("bench_ctc", run_tool("bench_ctc", ctc_bench, []))
    got = ran["results"]["b3"] + ran["results"]["b4"]
    want = ctc_event_ms_at_bench_shape()
    ms6 = {r["name"]: r["ms"] for r in phase6}
    scaled = (ms6["ctc_alpha"] + ms6["ctc_beta"]) * 1600 / 800
    log(f"phase 13: bench_ctc B3 + B4 device time {got:.4f} ms a call at "
        f"T=1600; CUDA events around runs of 10 launches of phase 6's "
        f"kernels on its lattice {want:.4f} ms ({got / want - 1:+.1%}, limit "
        f"20%); phase 6's single-call event medians scaled to T=1600 "
        f"{scaled:.4f} ms ({got / scaled - 1:+.1%}: a single call's events "
        f"also time the wrapper's host work, which T does not scale)")
    if abs(got - want) > 0.2 * want:
        raise AssertionError("bench_ctc's B3 + B4 device time is off their "
                             "event time")

    # preset 4's shape runs no host decoder (minutes at T = 1600), so its
    # vs_baseline is null by the bench's design
    bench_json("bench_decode --preset4", run_tool(
        "bench_decode --preset4", bench_decode.main,
        ["--preset4", "--skip-plain"]), may_be_null=("vs_baseline",))
    bench_json("bench_decode", run_tool(
        "bench_decode", bench_decode.main,
        ["--host-utts", "1"]))
    cpp_against_b5(dev)
    run_tool("smoke_cuda_decode", lambda _: smoke_cuda_decode.main(), [])
    for preset, extra in (("2", []), ("3", ["--batch", "8"])):
        lines = run_tool(f"preset_fit --preset {preset}", preset_fit.main,
                         ["--preset", preset, "--budget", "--step", *extra])
        step = json.loads(lines[-1])
        log(f"phase 13: preset {preset} at B={step['batch']} "
            f"T={step['frames']}: budget total "
            f"{step['budget_total_bytes'] / 2**30:.3f} GiB, measured peak "
            f"{step['peak_bytes'] / 2**30:.3f} GiB "
            f"({step['peak_over_budget']} of the budget)")
    counts = ",".join(str(c) for c in sorted({1, card_count()}))
    bench_json("bench_scaling", run_tool(
        "bench_scaling --strategy dp", bench_scaling.main,
        ["--strategy", "dp", "--device-counts", counts]))
    tools_round_trip(checkpoint_dir, dev)
    log(f"phase 13: benches and tools passed in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 14: preset 5's width (B1/B2's wide instance), TP, PP, the
# collective decode and the dry run
# ---------------------------------------------------------------------------

def sweep_bound(hs, lens, n_h, itemsize, peak, bwd_active=None, d=None):
    """Bound of one timed sweep, as phases 2 and 5 count it: B1 reads z at
    live frames, writes hs, reads W once and multiplies h_{t-1} @ W over
    its nonzero entries at live frames; B2 (``bwd_active``, the units
    0 < h < clip, and its deltas ``d``, right to left) reads hs and g at
    active units, writes d and multiplies d_{t+1} @ W^T for the active
    units over d_{t+1}'s nonzero entries."""
    n_t, n_b = hs.shape[:2]
    if bwd_active is None:
        live = (torch.arange(n_t, device=hs.device)[:, None] < lens[None, :])
        prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]).ne(0).sum(2)
        n_bytes = ((int(live.sum()) + n_t * n_b) * n_h + n_h * n_h) \
            * itemsize + n_b * 4
        n_ops = 2 * n_h * int((prev * live).sum())
    else:
        nxt = torch.cat([d[1:], torch.zeros_like(d[:1])]).ne(0).sum(2)
        n_bytes = (2 * n_t * n_b * n_h + int(bwd_active.sum())
                   + n_h * n_h) * itemsize
        n_ops = 2 * int((bwd_active.sum(2) * nxt).sum())
    return bound_ms(n_bytes, n_ops, peak)


def phase_wide_birnn(reps: int, n_t=1600, n_b=16, n_h=4096, dev="cuda"):
    """Phase 14, part 1: B1/B2's wide instance at preset 5's width and a
    rank's rows under model = 4 (H = 4096, B = 16, T = 1600), bf16 and
    f32, against the plain loops: B1 from zero and from h0 both ways, B2
    on B1's states both ways (B1's limit, 2^-6 |x| + 2e-2, for both), two
    launches bit-equal; times, bounds and the launch plan; B1 at H = 1824
    still on the narrow instance."""
    from tpu_ctc_torch.ops import birnn_cuda as bc
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(14)   # on the card
        z = 3.0 * torch.randn((n_t, n_b, n_h), generator=gen, device=dev)
        w = (0.5 / np.sqrt(n_h)) * torch.randn((n_h, n_h), generator=gen,
                                               device=dev)
        g = torch.randn((n_t, n_b, n_h), generator=gen, device=dev)
        h0 = torch.rand((n_b, n_h), generator=gen, device=dev)
        lens = torch.randint(n_t // 2, n_t + 1, (n_b,), generator=gen,
                             device=dev, dtype=torch.int32)
        z, w, g, h0 = (x.to(dtype) for x in (z, w, g, h0))
        wt = w.t().contiguous()
        name = str(dtype).removeprefix("torch.")
        if bc.instance(n_h, dtype, torch.cuda.get_device_properties(
                0).multi_processor_count) != "wide":
            raise AssertionError(f"H={n_h} {name} does not take the wide "
                                 f"instance")
        plan = bc.wide_plan(n_b, n_h, dtype)
        counts = (bc.WIDE_KERNEL.launches, bc.WIDE_BWD_KERNEL.launches)

        def check(what, got, want):
            got, want = got.float(), want.float()
            diff = (got - want).abs()
            bad = int((diff > 2 ** -6 * want.abs() + 2e-2).sum())
            log(f"phase 14: wide {what} {name}: max abs err "
                f"{float(diff.max()):.3e}, {bad} beyond tolerance, max "
                f"|value| {float(want.abs().max()):.2f}")
            if bad:
                raise AssertionError(f"wide {what} disagrees with its plain "
                                     f"version")
            return float(diff.max())

        err_f = err_b = 0.0
        states = {}
        for reverse in (False, True):
            for carry in (None, h0):
                got = bc.fwd_recurrence_cuda(z, w, lens, reverse=reverse,
                                             clip=20.0, h0=carry)
                torch.cuda.synchronize()
                want = bc.fwd_recurrence_plain(z, w, lens, reverse=reverse,
                                               clip=20.0, h0=carry)
                err_f = max(err_f, check(
                    f"B1 {'reversed' if reverse else 'forward'} from "
                    f"{'h0' if carry is not None else 'zero'}", got, want))
            states[reverse] = got
        again = bc.fwd_recurrence_cuda(z, w, lens, reverse=True, clip=20.0,
                                       h0=h0)
        same_f = torch.equal(again, states[True])
        deltas = {}
        for reverse in (True, False):   # the forward direction's: right to left
            hs = bc.fwd_recurrence_cuda(z, w, lens, reverse=not reverse,
                                        clip=20.0)
            got = bc.bwd_recurrence_cuda(g, hs, wt, reverse=reverse,
                                         clip=20.0)
            torch.cuda.synchronize()
            want = bc.bwd_recurrence_plain(g, hs, wt, reverse=reverse,
                                           clip=20.0)
            err_b = max(err_b, check(
                f"B2 {'right to left' if reverse else 'left to right'}",
                got, want))
            deltas[reverse] = (hs, got)
        hs_f, d_f = deltas[True]
        same_b = torch.equal(bc.bwd_recurrence_cuda(
            g, hs_f, wt, reverse=True, clip=20.0), d_f)
        log(f"phase 14: wide {name}: two launches bit-equal: B1 {same_f}, "
            f"B2 {same_b}")
        if not (same_f and same_b):
            raise AssertionError("two launches of the wide instance differ")
        if (bc.WIDE_KERNEL.launches == counts[0]
                or bc.WIDE_BWD_KERNEL.launches == counts[1]):
            raise AssertionError("the wide instance was not launched")
        ms_f = time_ms(lambda: bc.fwd_recurrence_cuda(
            z, w, lens, reverse=False, clip=20.0), reps)
        ms_b = time_ms(lambda: bc.bwd_recurrence_cuda(
            g, hs_f, wt, reverse=True, clip=20.0), reps)
        plain_f = time_ms(lambda: bc.fwd_recurrence_plain(
            z, w, lens, reverse=False, clip=20.0), 1)
        plain_b = time_ms(lambda: bc.bwd_recurrence_plain(
            g, hs_f, wt, reverse=True, clip=20.0), 1)
        item = torch.tensor([], dtype=dtype).element_size()
        peak = BF16_TENSOR_OPS if dtype == torch.bfloat16 else F32_FMA_OPS
        bf = sweep_bound(states[False], lens, n_h, item, peak)
        bb = sweep_bound(hs_f, lens, n_h, item, peak,
                         bwd_active=(hs_f.float() > 0) & (hs_f.float() < 20),
                         d=d_f)
        log(f"phase 14: wide {name} at H={n_h} B={n_b} T={n_t}: grid "
            f"{plan['grid']} blocks of 256 threads, {plan['own']} column "
            f"tiles a block, {plan['cached']} pieces of W kept in shared "
            f"memory ({'a warp' if item == 2 else 'a block'}), "
            f"{plan['smem']} B of shared memory a block")
        log(f"phase 14: wide {name}: B1 one direction {ms_f:.3f} ms "
            f"({ms_f * 1e3 / n_t:.2f} us a step), plain {plain_f:.3f} ms, "
            f"bound {bf[0]:.4f} ms ({bf[1]}); B2 one direction {ms_b:.3f} "
            f"ms ({ms_b * 1e3 / n_t:.2f} us a step), plain {plain_b:.3f} "
            f"ms, bound {bb[0]:.4f} ms ({bb[1]}); library: none")
        if dtype == torch.float32 and not (ms_f < plain_f and
                                           ms_b < plain_b):
            raise AssertionError("the f32 wide sweeps are slower than the "
                                 "plain f32 loops")
        if dtype == torch.bfloat16:
            out["birnn_fwd_wide"] = dict(
                name="birnn_fwd_wide", route="cuda", source=BIRNN_SOURCE,
                replaces=B1_REPLACES, max_abs_err=err_f, ms=ms_f,
                plain_ms=plain_f, bound_ms=bf[0], bound_by=bf[1],
                library_ms=None)
            out["birnn_bwd_wide"] = dict(
                name="birnn_bwd_wide", route="cuda", source=BIRNN_SOURCE,
                replaces=B2_REPLACES, max_abs_err=err_b, ms=ms_b,
                plain_ms=plain_b, bound_ms=bb[0], bound_by=bb[1],
                library_ms=None)
    # H = 1824 (preset 3/4's width) still takes the narrow instance
    r = np.random.RandomState(2)
    z = torch.from_numpy(r.randn(64, 64, 1824).astype(np.float32)).to(
        dev, torch.bfloat16)
    w = torch.from_numpy((0.5 / np.sqrt(1824)) * r.randn(1824, 1824).astype(
        np.float32)).to(dev, torch.bfloat16)
    counts = (bc.KERNEL.launches, bc.WIDE_KERNEL.launches)
    bc.fwd_recurrence_cuda(z, w, torch.full((64,), 64, dtype=torch.int32,
                                            device=dev), reverse=False,
                           clip=20.0)
    narrow = (bc.KERNEL.launches - counts[0], bc.WIDE_KERNEL.launches
              - counts[1])
    log(f"phase 14: B1 at H=1824: narrow launches {narrow[0]}, wide "
        f"{narrow[1]}")
    if narrow != (1, 0):
        raise AssertionError("B1 at H=1824 did not take the narrow instance")
    return [out["birnn_fwd_wide"], out["birnn_bwd_wide"]]


def synthetic_batches(cfg, n_steps: int, batch: int, frames: int, seed: int):
    """``n_steps`` global batches of ``batch`` seeded utterances of
    frames/2 .. frames frames and 10-30 characters (the arrays of
    ``train.loop.batch_to_device_dict``)."""
    from tpu_ctc_torch.data.bucketing import make_batch
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        utts = [(rng.randn(rng.randint(frames // 2, frames + 1),
                           cfg.model.input_dim).astype(np.float32),
                 rng.randint(1, cfg.model.vocab_size,
                             rng.randint(10, 31)).astype(np.int32))
                for _ in range(batch)]
        out.append(batch_to_device_dict(make_batch(
            utts, t_pad=frames, l_pad=32, batch_size=batch)))
    return out


MESH14_WORKER = r"""
import faulthandler, json, sys, time
import numpy as np, torch, torch.distributed as dist
faulthandler.dump_traceback_later(840, exit=True)   # a hang shows its stack
sys.path.insert(0, sys.argv[6])
import chip_smoke
from tpu_ctc_torch.config import get_config
from tpu_ctc_torch.parallel import distributed, mesh as mesh_lib
from tpu_ctc_torch.train import step

coord, rank, world, backend, dev, _, specs = sys.argv[1:8]
rank, world, specs = int(rank), int(world), json.loads(specs)
dev = distributed.initialize(coord, world, rank, device=dev, backend=backend)


def run(spec):
    cfg = get_config(spec["preset"], **spec["overrides"])
    mesh = mesh_lib.make_mesh(cfg.mesh)
    rec = {"rank": rank, "mesh": mesh.shape}
    if spec["kind"] == "train":
        batches = chip_smoke.synthetic_batches(
            cfg, spec["steps"], spec["batch"], spec["frames"], spec["seed"])
        tensors = [step.batch_to_tensors(b, dev, mesh) for b in batches]
        rec2, state = chip_smoke.step_turns(
            cfg, mesh, dev, tensors, spec.get("turns", ("graphs", "eager")))
        rec.update(rec2)
        if spec.get("out"):                 # the gathered parameters
            whole = step.full_state(state)
            if rank == 0:
                torch.save({k: p.detach() for k, p in
                            whole.model.named_parameters()}, spec["out"])
    else:                               # the collective decode of preset 4
        from tpu_ctc_torch.decode.collective import make_collective_decoder
        from tpu_ctc_torch.models import birnn
        model, lm, bd, max_len = chip_smoke.preset4_decode_inputs(cfg, dev)
        dec = make_collective_decoder(cfg, mesh, lm=lm, use_beam=True,
                                      max_len=max_len, redistribute=True,
                                      device=dev)
        dec(model, bd)                                  # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        (hyps, lens), launches = chip_smoke.run_main_path(
            lambda: dec(model, bd))
        torch.cuda.synchronize()
        wall = time.time() - t0
        ref = torch.load(spec["posteriors"])
        n = mesh.axis_size("data")
        rows = slice(rank * len(ref["lp"]) // n,
                     (rank + 1) * len(ref["lp"]) // n)
        with torch.no_grad():
            lp = birnn.log_posteriors(
                model, cfg.model,
                torch.as_tensor(bd["feats"][rows], device=dev),
                torch.as_tensor(bd["frame_mask"][rows], device=dev))
        same_lp = torch.equal(lp.cpu(), ref["lp"][rows])
        h2, l2 = dec.from_posteriors(ref["lp"][rows].to(dev),
                                     ref["lens"][rows].to(dev),
                                     ref["mask"][rows].to(dev))
        if rank == 0:
            torch.save({"hyps": hyps.cpu(), "lens": lens.cpu(),
                        "hyps_same_lp": h2.cpu(), "lens_same_lp": l2.cpu()},
                       spec["out"])
        rec.update(launches=launches, wall=wall,
                   posteriors_bit_equal=same_lp)
    return rec


# one spec, or a list run in turn (one spawn of the ranks for all)
recs = [run(spec) for spec in specs] if isinstance(specs, list) else \
    run(specs)
print("RANK " + json.dumps(recs), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def spawn_mesh14(world: int, spec, timeout: int = 900):
    """``world`` ranks of MESH14_WORKER on ``spec`` (or a list of specs,
    run in turn by the same ranks): NCCL ranks one card each when
    ``nvidia-smi -L`` lists enough cards, else gloo ranks sharing card 0
    (NCCL refuses two ranks on one device).  Returns (each rank's record,
    or its list of records, one a spec; backend)."""
    from tpu_ctc_torch.parallel import distributed
    count = card_count()
    if count >= world:
        backend, devs = "nccl", [f"cuda:{r}" for r in range(world)]
    else:
        backend, devs = "gloo", ["cuda:0"] * world
    root = os.path.dirname(os.path.abspath(__file__))
    coord = f"127.0.0.1:{distributed.free_port()}"
    recs = distributed.spawn_ranks(
        [[sys.executable, "-c", MESH14_WORKER, coord, str(r), str(world),
          backend, devs[r], root, json.dumps(spec)] for r in range(world)],
        cwd=root, env=dict(os.environ, PYTHONPATH=root), timeout=timeout)
    return recs, backend


def one_card_reference(cfg, batches, dev="cuda"):
    """``train_step`` of ``cfg`` (one card, its seeded weights) over the
    batches: (losses, initial parameters, parameters after), the
    parameters on the CPU."""
    from tpu_ctc_torch.train import step
    state = step.create_train_state(cfg, device=dev)
    init = {k: p.detach().cpu().clone()
            for k, p in state.model.named_parameters()}
    losses = []
    for b in batches:
        state, m = step.train_step(state, step.batch_to_tensors(b, dev), cfg)
        losses.append(float(m["loss"]))
    after = {k: p.detach().cpu() for k, p in state.model.named_parameters()}
    del state
    torch.cuda.empty_cache()
    return losses, init, after


def param_gaps(gathered, ref):
    """{name: |p - p_one| / |p_one - p_init|}: each parameter's distance
    from one card's after the steps, over one card's update of it."""
    _, init, after = ref
    return {k: float((gathered[k].float() - want.float()).norm())
            / max(float((want - init[k]).float().norm()), 1e-30)
            for k, want in after.items()}


def check_mesh_train(what, recs, backend, ref, gathered, audio_s,
                     limits=None):
    """Losses within LOSS_REL_TOL of one card's, replicated parameters
    bit-equal across ranks, each gathered parameter's gap from one card's
    (:func:`param_gaps`) within ``limits[name]`` (default GRAD_REL_TOL,
    §2's gradient limit); where the ranks are NCCL's, the compiled step
    bit-equal to the eager mesh step on every rank
    (:func:`describe_turns`)."""
    ref_losses = ref[0]
    first = describe_turns("phase 14", what, recs,
                           [audio_s] * len(recs[0]["runs"][0]["walls"]))
    losses = first["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    same = len({rec["replicated"] for rec in recs}) == 1
    gaps = param_gaps(gathered, ref)
    limits = limits or {k: GRAD_REL_TOL for k in gaps}
    worst_k = max(gaps, key=lambda k: gaps[k] / limits[k])
    step_s = float(np.median(first["walls"][1:] or first["walls"]))
    launches = {k: sum(rec["runs"][0]["launches"][k] for rec in recs)
                for k in first["launches"]}
    log(f"phase 14: {what}: {len(recs)} {backend} ranks, mesh "
        f"{recs[0]['mesh']}: losses {[round(x, 4) for x in losses]} against "
        f"one card's {[round(x, 4) for x in ref_losses]} (rel {rel:.2e}, "
        f"limit {LOSS_REL_TOL}); replicated parameters bit-equal across "
        f"ranks: {same}; worst parameter |p - p_one| / |p_one - p_init| "
        f"{gaps[worst_k]:.2e} ({worst_k}, limit {limits[worst_k]:.2e}); "
        f"step {step_s * 1e3:.1f} ms = {audio_s / step_s:.1f} audio-s/s; "
        f"launches on the path (all ranks) "
        f"{ {k: n for k, n in launches.items() if n} }")
    if rel > LOSS_REL_TOL or not same or gaps[worst_k] > limits[worst_k]:
        raise AssertionError(f"{what} disagrees with one card's step")
    return launches


def phase_tp_preset5(steps=2):
    """Phase 14, part 2: preset 5 (``swbd_wide_tp``: 2 dense and 5
    bidirectional layers at H = 4096, bf16) under tensor parallelism at
    full width: model = 2 at a global B = 8, T = 200 (two gloo ranks
    sharing the card, or NCCL ranks on 2-3 cards), or model = 4 at B = 64,
    T = 800 on 4 or more cards; 2 steps against one card's ``train_step``
    of preset 5 on the same batches.  At bf16 a parameter's gap from one
    card's moves with the order of f32 sums alone (one card with the f32
    GEMMs in place of the bf16 ones moves the first layer's by ~6e-2 of
    its update), so there each gap is held to GRAD_REL_TOL plus twice
    that one-card gap; the same run at an f32 compute dtype (the wide
    instance's f32 kernels) holds every gap to GRAD_REL_TOL."""
    from tpu_ctc_torch.config import get_config
    world, batch, frames = ((4, 64, 800) if card_count() >= 4
                            else (2, 8, 200))
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "chip_smoke_tp.pt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    launches, specs = {}, []
    dtypes = ("bfloat16", "float32")
    for dtype in dtypes:     # one spawn of the ranks runs both
        specs.append(dict(kind="train", preset="5", steps=steps, batch=batch,
                          frames=frames, seed=5, out=f"{out}.{dtype}",
                          overrides={"mesh.data": 1, "mesh.model": world,
                                     "model.compute_dtype": dtype}))
    log(f"phase 14: preset 5 under TP, model = {world}, global B={batch} "
        f"T={frames}, {steps} steps, in {' then '.join(dtypes)}")
    ranks, backend = spawn_mesh14(world, specs)
    for spec, dtype, recs in zip(specs, dtypes, zip(*ranks)):
        cfg = get_config("5", **{"model.compute_dtype": dtype})
        log(f"phase 14: preset {cfg.name} (H={cfg.model.hidden_dim}, "
            f"{cfg.model.num_pre_layers} dense + {cfg.model.num_bi_layers} "
            f"bidirectional layers, {dtype}) under TP: against one card")
        batches = synthetic_batches(cfg, steps, batch, frames, seed=5)
        gathered = torch.load(spec["out"])
        os.remove(spec["out"])
        recs = list(recs)
        one = cfg.override(**{"mesh.model": 1})
        ref = one_card_reference(one, batches)
        limits = None
        if dtype == "bfloat16":
            with f32_dense_products():
                other = one_card_reference(one, batches)
            floor = param_gaps(other[2], ref)
            limits = {k: GRAD_REL_TOL + 2 * g for k, g in floor.items()}
            worst = max(floor, key=floor.get)
            log(f"phase 14: one card, f32 GEMMs against bf16 GEMMs: worst "
                f"parameter gap {floor[worst]:.2e} ({worst})")
        audio = float(np.mean([b["frame_lengths"].sum() / 100
                               for b in batches]))
        got = check_mesh_train(f"preset 5 TP {dtype}", recs, backend, ref,
                               gathered, audio, limits)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    if not launches["birnn_fwd_wide"] or not launches["birnn_bwd_wide"]:
        raise AssertionError("the TP step did not take B1/B2's wide "
                             "instance")
    return launches


def phase_pp_preset2(steps=2, stages=3, batch=32, frames=400):
    """Phase 14, part 3: preset 2 (3 bidirectional layers at H = 1024,
    bf16) as 3 pipeline stages with M = 4 microbatches (gloo ranks sharing
    the card, or NCCL ranks on 3 or more cards), 2 steps at B = 32,
    T = 400 against one card's ``train_step``, the gaps held as part 2's
    bf16 gaps."""
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.parallel.pipeline import stack_bi_params
    cfg = get_config("2")
    batches = synthetic_batches(cfg, steps, batch, frames, seed=2)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_pp.pt")
    spec = dict(kind="train", preset="2", steps=steps, batch=batch,
                frames=frames, seed=2, out=out,
                overrides={"mesh.data": 1, "mesh.model": stages,
                           "mesh.pipeline": True,
                           "mesh.pipeline_microbatches": 4})
    log(f"phase 14: preset {cfg.name} as {stages} pipeline stages, M = 4, "
        f"B={batch} T={frames}, {steps} steps")
    recs, backend = spawn_mesh14(stages, spec)
    gathered = torch.load(out)
    os.remove(out)

    def stacked(ref):
        return (ref[0], stack_bi_params(ref[1]), stack_bi_params(ref[2]))
    ref = stacked(one_card_reference(cfg, batches))
    with f32_dense_products():
        other = stacked(one_card_reference(cfg, batches))
    limits = {k: GRAD_REL_TOL + 2 * g
              for k, g in param_gaps(other[2], ref).items()}
    audio = float(np.mean([b["frame_lengths"].sum() / 100
                           for b in batches]))
    return check_mesh_train("preset 2 PP", recs, backend, ref, gathered,
                            audio, limits)


def preset4_decode_inputs(cfg, dev="cuda"):
    """Phase 4's decode inputs: preset 4's seeded model, the trigram of the
    64 synthetic transcripts, their one batch (host arrays) and its
    ``max_len`` as ``make_beam_decoder`` sets it."""
    from tpu_ctc_torch.data.bucketing import BucketedLoader
    from tpu_ctc_torch.data.synthetic import SyntheticCorpus
    from tpu_ctc_torch.decode.lm import train_char_lm_from_data
    from tpu_ctc_torch.models import birnn
    from tpu_ctc_torch.train.loop import batch_to_device_dict
    corpus = SyntheticCorpus(64, feature_dim=cfg.model.input_dim,
                             min_chars=50, max_chars=100, seed=0)
    data = corpus.all_utterances()
    lm = train_char_lm_from_data(data, cfg)
    model = birnn.init_params(cfg.model, seed=0, device=dev)
    batch = [b for _, b in BucketedLoader(data, cfg.data).epoch(0)][0]
    bd = batch_to_device_dict(batch)
    max_len = min(int(bd["labels"].shape[1]) * 2 + 16,
                  int(bd["feats"].shape[1]))
    return model, lm, bd, max_len


def phase_collective_decode(world=2, dev="cuda"):
    """Phase 14, part 4: preset 4's collective decode over 2 ranks with
    the length-balancing redistribution, its hypotheses bit-equal to the
    one-card decode (phase 4's) on the same posteriors."""
    from tpu_ctc_torch.config import get_config
    from tpu_ctc_torch.decode.beam import make_beam_search
    from tpu_ctc_torch.models import birnn
    cfg = get_config("swbd_beam_decode")
    model, lm, bd, max_len = preset4_decode_inputs(cfg, dev)
    feats, mask, lens = (torch.as_tensor(bd[k], device=dev) for k in (
        "feats", "frame_mask", "frame_lengths"))
    with torch.no_grad():
        lp = birnn.log_posteriors(model, cfg.model, feats, mask)
    hyps, hyp_lens, _ = make_beam_search(cfg, lm, device=dev)(lp, lens,
                                                               max_len)
    root = os.path.dirname(os.path.abspath(__file__))
    lp_path = os.path.join(root, "build", "chip_smoke_lp.pt")
    out = os.path.join(root, "build", "chip_smoke_collective.pt")
    torch.save({"lp": lp.cpu(), "lens": lens.cpu(), "mask": mask.cpu()},
               lp_path)
    spec = dict(kind="decode", preset="swbd_beam_decode", out=out,
                posteriors=lp_path, overrides={"mesh.data": world})
    recs, backend = spawn_mesh14(world, spec)
    got = torch.load(out)
    for path in (out, lp_path):
        os.remove(path)
    same = (torch.equal(got["hyps_same_lp"], hyps.cpu())
            and torch.equal(got["lens_same_lp"], hyp_lens.cpu()))
    agree = int(sum(torch.equal(got["hyps"][i, :int(got["lens"][i])],
                                hyps.cpu()[i, :int(hyp_lens[i])])
                    and int(got["lens"][i]) == int(hyp_lens[i])
                    for i in range(len(hyps))))
    lp_equal = all(rec["posteriors_bit_equal"] for rec in recs)
    launches = {k: sum(rec["launches"][k] for rec in recs)
                for k in recs[0]["launches"]}
    audio = int(bd["frame_lengths"].sum()) / 100
    wall = max(rec["wall"] for rec in recs)
    log(f"phase 14: collective decode of preset 4 over {world} {backend} "
        f"ranks with redistribute: hypotheses on phase 4's posteriors "
        f"bit-equal to the one-card decode: {same}; the whole path's "
        f"(each rank's own posteriors, bit-equal to one card's: "
        f"{lp_equal}) equal on {agree} of {len(hyps)} utterances; "
        f"{wall:.3f} s = {audio / wall:.1f} audio-s/s; launches on the "
        f"path (all ranks) { {k: n for k, n in launches.items() if n} }")
    if not same or (lp_equal and agree != len(hyps)):
        raise AssertionError("the collective decode disagrees with one "
                             "card's")
    if not launches["beam_search"] or not launches["birnn_fwd"]:
        raise AssertionError("the collective decode launched no B1 or B5")
    return launches


def start_dryrun(world=2):
    """Phase 14, part 5, started: ``python -m tpu_ctc_torch.dryrun`` under
    torchrun over 2 ranks (NCCL one card each, or gloo ranks sharing card
    0), in the background while phase 15's chain runs (nothing timed runs
    beside it); :func:`check_dryrun` waits for it."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    extra = ([] if card_count() >= world
             else ["--device", "cuda:0", "--backend", "gloo"])
    out = tempfile.TemporaryFile("w+")      # no pipe to fill meanwhile
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), "-m", "tpu_ctc_torch.dryrun",
         *extra], stdout=out, stderr=subprocess.STDOUT, text=True,
        cwd=root, env=dict(os.environ, PYTHONPATH=root))
    return proc, out


def check_dryrun(started, timeout=600):
    """The dry run's four ``dryrun_multichip`` lines, each logged; raises
    unless it exits 0 with all four."""
    proc, f = started
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    f.seek(0)
    out, err = f.read(), ""
    f.close()
    lines = [x for x in out.splitlines() if x.startswith("dryrun_multichip")]
    for line in lines:
        log(f"phase 14: {line}")
    if proc.returncode != 0 or len(lines) != 4:
        log(out[-3000:] + err[-3000:])
        raise AssertionError("the dry run failed")


# ---------------------------------------------------------------------------
# Phase 15: the accuracy chain of docs/EVAL.md at a cut size
# ---------------------------------------------------------------------------

# torch_tools/eval_chain.py at its full widths (H = 512, 3 bidirectional
# layers, B = 16, buckets (80, 160, 320)) on a cut corpus, epochs and GRU
# training, with 2 x 2 grids, its independent stages nine at a time (the
# nine scores in one wave); the full chain is its defaults.  300 steps at the first rate take the model
# out of its blank phase (the full chain's eval CER is 0.45 at step 200),
# so that every system decodes text and every pair is scored.
CHAIN_N, CHAIN_SEED = 120, 1   # the cut chain's corpus, made in process
CHAIN_CUT = ["--jobs", "9", "--epochs", "60,75,80", "--lrs",
             "0.02,0.005,0.0015", "--nlm-steps", "50", "--trigram-grid",
             "1.0,1.75/0.5,1.5", "--gru-grid", "1.0,1.5/0.5,1.5",
             "--both-grid", "0.75,1.0/0.0,0.5"]


def phase_chain_kernels(records, reps: int, dev="cuda"):
    """Phase 15's kernels at the shapes the chain gives them, each held
    against its plain version at its own phase's limits: B1 and B2 in bf16
    at H = 512, B = 16, T = 320 (the longest bucket); B3 and B4 at B = 16,
    T = 320, labels of 32-64 characters (S <= 129); B5 at K = 64 and
    max_len 144 with the trigram, the GRU alone and both, the walk; B6 at
    K = 200 with the trigram.  A record's ``max_abs_err`` becomes the
    larger of its phase's and this one's."""
    shape = dict(n_b=16, n_t=320, dev=dev)
    beam = dict(shape, k=64, max_len=144)
    checked = [
        phase_birnn(reps, n_h=512, phase="phase 15", **shape),
        phase_birnn_bwd(reps, n_h=512, phase="phase 15", **shape),
        *phase_ctc(reps, chars=(32, 64), phase="phase 15", **shape),
        *phase_beam(reps, phase="phase 15", **beam),
        phase_beam_gru(reps, "phase 15", lm_order=0, **beam),
        phase_beam_gru(reps, "phase 15", **beam)]
    phase_wide_ngram(reps, k=200, max_len=144, phase="phase 15", **shape)
    for got in checked:     # the GRU alone is the GRU instance's record
        for rec in records:
            if rec["name"] == got["name"] and rec.get("variant", "")[:3] \
                    == got.get("variant", "")[:3]:
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         got["max_abs_err"])


def phase_chain(timeout=600):
    """Phase 15: ``torch_tools/eval_chain.py`` on the card at
    :data:`CHAIN_CUT` under ``build/chip_smoke_chain`` (removed at the
    end): SPHERE corpus, manifests, three training runs (the later two
    resumed at another learning rate), three dev sweeps, four valid
    decodes and the trigram again at K = 200, the scoring tool.  Asserts
    finite losses that fall, the step count of the loader's plan, each
    resume at the previous run's end, every paired bootstrap scored (no
    system decodes an utterance to empty text where another does not),
    and launches of B1-B4 in training,
    of B5's n-gram and GRU instances in the sweeps and decodes, of B6 at
    K = 200 and of the walk; prints the ladder's WERs (a cut model: not the
    accuracy result) and whether two GRU char-LM trainings are bit-equal.
    Returns the chain's launches, summed over its subprocesses (each
    starts at 0), as paths: ``chain`` all but B5's, ``chain_ngram`` and
    ``chain_gru`` B5's n-gram and GRU instances."""
    import shutil
    import importlib
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_chain")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.time()
    # steps 1-2 (the corpus and its manifests) here, in process: two
    # processes fewer to start; the chain takes them with --data
    from torch_tools import eval_chain
    man = os.path.join(out, "manifests")
    for stage, target, argv in eval_chain.data_steps(
            os.path.join(out, "tree"), man, CHAIN_N, CHAIN_SEED):
        tool = importlib.import_module(
            "torch_tools." + os.path.basename(target)[:-3])
        run_tool(stage, tool.main, argv, phase="phase 15")
    # its own process group: a timeout stops the chain's subprocesses too
    proc = subprocess.Popen(
        [sys.executable, os.path.join("torch_tools", "eval_chain.py"),
         "--out", out, "--data", man, *CHAIN_CUT],
        cwd=os.path.dirname(os.path.abspath(__file__)), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    for line in err.splitlines():
        if line.startswith("[chain]") and ("done in" in line or
                                           "failed" in line):
            log(f"phase 15: {line}")
    if proc.returncode != 0:
        for line in err.splitlines()[-40:]:
            log(f"phase 15: {line}")
        raise AssertionError(f"eval_chain.py returned {proc.returncode}")
    with open(os.path.join(out, "eval_chain.json")) as f:
        res = json.load(f)
    shutil.rmtree(out, ignore_errors=True)
    runs, plan = res["train"], res["plan"]
    log(f"phase 15: splits {res['splits']}; plan {plan['batches_epoch0']} "
        f"batches in epoch 0, {plan['batches_per_epoch']} after, "
        f"{plan['dropped']} dropped; frontend over the held-in train split "
        f"{res['frontend_once']['reads_and_frontend_s']:.2f} s "
        f"(reads {res['frontend_once']['reads_s']:.2f} s)")
    for i, r in enumerate(runs):
        log(f"phase 15: run {i} (lr {r['learning_rate']}, to epoch "
            f"{r['to_epoch']}): steps {r['steps']}, loss {r['first_loss']:.3f}"
            f" -> {r['last_loss']:.3f}, a frame {r['first_loss_per_frame']:.4f}"
            f" -> {r['last_loss_per_frame']:.4f}, {r['wall_s']:.1f} s, "
            f"epoch {r['median_epoch_wall_s']} s, resumed {r['resumed']}")
    # per frame: the logged batches come from buckets of other lengths
    losses = [x for r in runs for x in (r["first_loss_per_frame"],
                                        r["last_loss_per_frame"])]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the chain's losses do not fall: {losses}")
    if [r["steps"] for r in runs] != plan["steps_at_run_end"] or \
            not res["steps_equal_plan"]:
        raise AssertionError(f"steps {[r['steps'] for r in runs]}, final "
                             f"{res['final_step']}, the loader's plan "
                             f"{plan['steps_at_run_end']}")
    epochs = [r["to_epoch"] for r in runs]
    for i in range(1, len(runs)):
        want = [[str(epochs[i - 1]), "0", str(plan["steps_at_run_end"][i - 1])]]
        if runs[i]["resumed"] != want:
            raise AssertionError(f"run {i} resumed at {runs[i]['resumed']}, "
                                 f"not {want}")
    for name, sw in res["sweeps"].items():
        log(f"phase 15: dev sweep {name}: best {sw['best']} of "
            f"{len(sw['grid'])} points")
    wers = ", ".join(f"{k} {100 * v['WER']['rate']:.2f}% "
                     f"[{100 * v['WER']['ci95'][0]:.2f}, "
                     f"{100 * v['WER']['ci95'][1]:.2f}]"
                     for k, v in res["valid"].items())
    log(f"phase 15: valid WER (cut; not the accuracy result): {wers}")
    log(f"phase 15: paired {res['paired']}; K=200 against K=64: "
        f"{res['k200']['differ']} of {res['k200']['utts']} hypotheses differ")
    refused = [k for k, v in res["paired"].items() if "ci95" not in v]
    if refused:
        raise AssertionError(f"paired bootstraps refused: {refused}")
    gru = res["gru_twice"]
    log(f"phase 15: two GRU char-LM trainings ({gru['steps']} steps, "
        f"{gru['train_s'][0]:.1f} s and {gru['train_s'][1]:.1f} s): "
        f"bit-equal {gru['bit_equal']} (largest difference "
        f"{max(gru['max_abs_diff'].values()):.3g})")
    by = res["launches_by_stage"]
    trained = {k: sum(by[s][k] for s in by if s.startswith("train"))
               for k in ("birnn_fwd", "birnn_bwd", "ctc_alpha", "ctc_beta")}
    decoded = {"beam_search (n-gram)": res["beam_search_by_lm"]["ngram"],
               "beam_search (GRU)": res["beam_search_by_lm"]["gru"],
               "beam_search_wide (K=200)":
                   by["decode_trigram_k200"]["beam_search_wide"],
               "beam_reconstruct": res["launches"]["beam_reconstruct"]}
    log(f"phase 15: launches in training {trained}; in the sweeps and "
        f"decodes {decoded}; all {res['launches']}")
    if not all(trained.values()) or not all(decoded.values()):
        raise AssertionError("a kernel of the chain was not launched")
    log(f"phase 15: chain passed in {time.time() - t0:.1f} s "
        f"(stages: {', '.join(f'{k} {v:.1f}' for k, v in res['wall_s'].items())})")
    return {"chain": dict(res["launches"], beam_search=0),
            "chain_ngram": {"beam_search": res["beam_search_by_lm"]["ngram"]},
            "chain_gru": {"beam_search": res["beam_search_by_lm"]["gru"]}}


def device_breakdown(run, phase: str):
    """One more pass of ``run`` under torch.profiler: device time by
    kernel name and the device's idle share of the pass (the profiler's
    own overhead lengthens the pass, so the idle share is an upper
    bound) and the device time of the dense GEMMs (kernels named as
    ``GEMM_NAME`` matches).  Returns (wall ms, device busy ms, device
    operations: kernels, copies and sets), or None when the profiler saw
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # device-side events only (kernels, copies): an operator's row would
    # count its kernels' time a second time
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"{phase}: profiler recorded no device time: breakdown not "
            "measured")
        return None
    gemm = [r for r in rows if GEMM_NAME.search(r[2])]
    gemm_ms = sum(r[0] for r in gemm)
    ops = sum(r[1] for r in rows)
    log(f"{phase}: profiled pass {wall_ms:.1f} ms wall, device busy "
        f"{busy:.1f} ms, idle share <= {1 - busy / wall_ms:.3f}; {ops} "
        f"device operations; dense GEMMs {gemm_ms:.2f} ms in "
        f"{sum(r[1] for r in gemm)} launches")
    for ms, count, name in sorted(rows, reverse=True)[:8]:
        log(f"  device {ms:9.2f} ms  x{count:<5d} {name[:90]}")
    return wall_ms, busy, ops


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import tpu_ctc_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.time()
    marks = [t_start]

    def took(what):     # each phase's wall, for the run's time limit
        marks.append(time.time())
        log(f"chip_smoke: {what} took {marks[-1] - marks[-2]:.1f} s "
            f"({marks[-1] - t_start:.1f} s in)")
    phase_build()
    took("phase 1")
    records = [phase_birnn(REPS), *phase_beam(REPS)]
    took("phases 2-3")
    decode_launches, phase4 = phase_end_to_end(seed=0)
    took("phase 4")
    records += [phase_birnn_bwd(REPS), *phase_ctc(REPS)]
    took("phases 5-6")
    train_launches, phase7 = phase_train(seed=0)
    took("phase 7")
    records.append(phase_beam_gru(REPS, "phase 8", k=128))
    phase_wide_ngram(REPS)
    records.append(phase_beam_gru(REPS, "phase 9", k=200))
    took("phases 8-9")
    gru_launches, _ = phase_gru_decode(seed=0)
    took("phase 10")
    kept = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_tools", "checkpoint")
    audio_paths, one_rank = phase_audio(seed=0, phase7=phase7,
                                        phase4=phase4, keep_checkpoint=kept)
    took("phase 11")
    paths = {"decode": decode_launches, "train": train_launches,
             "gru": gru_launches, **audio_paths}
    carry_err, _ = phase_carry(REPS)
    paths["mesh_one"], ref_losses = phase_mesh_one()
    mesh_runs = phase_mesh_ranks(ref_losses)
    paths.update({f"mesh {name}": n for name, n in mesh_runs.items()})
    paths.update({f"mesh_audio {name}": n for name, n in
                  phase_mesh_audio(seed=0, one_rank=one_rank).items()})
    took("phase 12")
    phase_tools(records, kept)
    took("phase 13")
    records += phase_wide_birnn(REPS)
    paths["tp"] = phase_tp_preset5()
    paths["pp"] = phase_pp_preset2()
    paths["collective"] = phase_collective_decode()
    took("phase 14")
    phase_chain_kernels(records, REPS)
    dryrun = start_dryrun()     # phase 14's last part, beside the chain
    try:
        paths.update(phase_chain())
    except BaseException:
        dryrun[0].kill()    # its ranks are ended with the run's others
        raise
    check_dryrun(dryrun)
    took("phase 15 (and the dry run)")
    for rec in records:  # a variant counts the paths that run it
        rec["launches"] = sum(paths[p].get(rec["name"], 0)
                              for p in rec.pop("paths", paths))
        if rec["name"] == "birnn_fwd":  # every SP sweep starts from h0
            rec["h0_launches"] = sum(n["birnn_fwd"] for name, n in
                                     mesh_runs.items() if "seq=2" in name)
            rec["max_abs_err"] = max(rec["max_abs_err"], carry_err)
    wide = {rec["name"]: rec for rec in records
            if rec["name"].endswith("_wide") and "replaces" in rec
            and rec["name"].startswith("birnn")}
    for rec in records:  # B1 and B2 carry their wide instance's numbers
        if rec["name"] + "_wide" in wide:
            rec["wide_launches"] = wide[rec["name"] + "_wide"]["launches"]
            rec["wide_ms"] = wide[rec["name"] + "_wide"]["ms"]
    if not all(rec["launches"] for rec in wide.values()):
        raise AssertionError("a wide B1/B2 instance was not launched on "
                             "the main paths")
    records.sort(key=lambda rec: KERNEL_ORDER.index(rec["name"]))
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [
        {k: rec[k] for k in ("name", "variant", "route", "source",
                             "replaces", "launches", "h0_launches",
                             "wide_launches", "max_abs_err", "ms",
                             "wide_ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms") if k in rec}
        for rec in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# The supervisor: no process of the run outlives the script
# ---------------------------------------------------------------------------

PR_SET_CHILD_SUBREAPER = 36     # <linux/prctl.h>


def children(pid: int):
    """The processes whose parent is ``pid``, read from /proc: [(pid,
    command line, True for a zombie)]."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, IndexError, ValueError):
            continue             # it ended while we read
        if int(ppid) == pid:
            out.append((int(name), cmd.strip()[:300], state == "Z"))
    return out


def stop_children(grace_s: float):
    """Reap this process's children until it has none: each gets until
    ``grace_s`` from now to end on its own, then SIGKILL; a child's own
    orphans come here in turn (the subreaper).  Returns the children that
    were alive after the run (not zombies), as (pid, command line, "ended"
    or "killed")."""
    import signal
    seen, deadline = {}, time.time() + grace_s
    while True:
        live = []
        for pid, cmd, zombie in children(os.getpid()):
            if not zombie:
                seen.setdefault(pid, [cmd, "ended"])
            try:
                done = os.waitpid(pid, os.WNOHANG)[0]
            except ChildProcessError:
                done = pid
            if not done:
                live.append(pid)
        if not live:
            return [(pid, cmd, how) for pid, (cmd, how) in seen.items()]
        if time.time() < deadline:
            time.sleep(0.1)
            continue
        for pid in live:
            seen[pid][1] = "killed"
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        for pid in live:
            with contextlib.suppress(ChildProcessError):
                os.waitpid(pid, 0)


def supervise(cmd=None, grace_s: float = 10.0) -> int:
    """Run ``cmd`` (by default :func:`main` as ``chip_smoke.py --run``) in
    a child process, its output passed through, as that run's child
    subreaper; then stop every process the run left
    (:func:`stop_children`) and name each on stderr.  Returns the run's
    exit code."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")
    proc = subprocess.Popen(cmd or [sys.executable, os.path.abspath(__file__),
                                    "--run"])
    try:
        rc = proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        left = stop_children(grace_s)
    for pid, cmd, how in left:
        print(f"chip_smoke: process {pid} outlived the run ({how}): {cmd}",
              file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main() if sys.argv[1:] == ["--run"] else supervise())
