#!/usr/bin/env python3
"""Kernels B3 and B4 (``tpu_ctc_torch/csrc/ctc_dp.cu``, the CTC alpha and
beta sweeps) against other versions of their source, timed in turns on one
NVIDIA GPU at ``chip_smoke.py`` phase 6's shape (B = 32, T = 800, A = 29,
labels of 50-100 characters).

Builds into ``build/ctc_dp_turns/`` (git-ignored), in parallel:

  this      the source as it is;
  exp3      the same source with lse3 taking all three exps (the maximum's
            exp(0) too), as the plain version writes it: what the staging
            of emit and of the outputs gives alone;
  fastmath  lse3 with the __expf/__logf intrinsics: not bit-equal to the
            plain sweeps, so never a candidate; its time says what the
            precise expf/logf cost on the chain;
  stamped   the source with SM clock stamps in B3's frame loop (lane 0 of
            each warp of block 0, frames 100-115): at the frame's start,
            once the neighbours and emit are loaded, once lse3 is done,
            once the state's alpha is stored, and after the frame's
            barrier;
  parent    with ``--parent FILE``, a ``ctc_dp.cu`` of another commit with
            the same C interface (``git show REV:tpu_ctc_torch/csrc/
            ctc_dp.cu > build/p.cu``);
  NAME      with ``--version NAME=FILE`` (repeatable), any other such
            source, for example one with a single change undone.

Each version's alpha and beta must equal the plain sweeps to the bit
(fastmath's are only reported).  Then each is timed (CUDA events around
single calls, median of 7 after a warm-up) in the order parent, the
versions, exp3, this, then the same backwards (then fastmath), and the
time of a frame (a sweep's time over T) is printed beside it.  Last, the stamped B3's frame
in SM cycles, median over the 16 frames, phase by phase, with the clock
rate from ``%globaltimer`` over the same frames (read once a frame
between the barrier and the next frame's start, where it lengthens the
frame).

    python3 torch_tools/ctc_dp_turns.py [--parent OLD_CTC_DP_CU]
        [--version NAME=CTC_DP_CU ...]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "torch_tools"))

import chip_smoke  # noqa: E402
import kernel_stamps  # noqa: E402
from tpu_ctc_torch.ops import _build, ctc_cuda  # noqa: E402

OUT = os.path.join(ROOT, "build", "ctc_dp_turns")
# lse3 as the plain version sums it: three exps, the maximum's included.
EXP3 = [(
    "  const bool c_max = c == m;\n"
    "  const float x = c_max ? a : (a == m ? b : a);\n"
    "  const float y = c_max ? b : c;\n"
    "  const float ex = expf(x - m);\n"
    "  const float ey = expf(y - m);\n"
    "  const float sum = c_max ? (ex + ey) + 1.0f : (1.0f + ex) + ey;\n",
    "  const float sum = expf(a - m) + expf(b - m) + expf(c - m);\n")]


FASTMATH = [("  const float ex = expf(x - m);\n  const float ey = expf(y - m);\n",
             "  const float ex = __expf(x - m);\n  const float ey = __expf(y - m);\n"),
            ("  const float out = m + logf(sum + kLogFloor);",
             "  const float out = m + __logf(sum + kLogFloor);")]
STAMP_DEF = """
__device__ unsigned long long g_stamps[16 * 8 * 8];  // [frame 16][warp 8][8]
#define STAMP(i) \\
  if (blockIdx.x == 0 && (threadIdx.x & 31) == 0 && t >= 100 && t < 116) { \\
    unsigned long long v; \\
    if ((i) == 3) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v) :: "memory"); \\
    else asm volatile("mov.u64 %0, %%clock64;" : "=l"(v) :: "memory"); \\
    g_stamps[((t - 100) * 8 + (threadIdx.x >> 5)) * 8 + (i)] = v; \\
  }
// an instruction that waits for x, so that the next stamp follows it
#define WAIT_ON(x) { unsigned w_; asm volatile("mov.b32 %0, %1;" : "=r"(w_) \\
    : "r"(__float_as_uint(x)) : "memory"); }
"""
STAMPS = [
    ("constexpr float kNegInf = -1e30f;",
     STAMP_DEF + "constexpr float kNegInf = -1e30f;"),
    ("      const int t = t0 + j;\n      const float et",
     "      const int t = t0 + j;\n      STAMP(3);\n      STAMP(0);\n"
     "      const float et"),
    ("        a = lse3(a, s1, s2) + et;\n",
     "        WAIT_ON(s1); WAIT_ON(s2); WAIT_ON(et); STAMP(4);\n"
     "        const float l3 = lse3(a, s1, s2);\n"
     "        WAIT_ON(l3); STAMP(5);\n        a = l3 + et;\n"),
    ("      if (on) oin[j * n_s] = a;\n      if (j == nf - 1) fence_async_shared();\n"
     "      __syncthreads();\n",
     "      if (on) oin[j * n_s] = a;\n      STAMP(1);\n"
     "      if (j == nf - 1) fence_async_shared();\n      __syncthreads();\n"
     "      STAMP(2);\n"),
    ('extern "C" {',
     'extern "C" {\nint read_stamps(unsigned long long* h) {\n'
     '  return (int)cudaMemcpyFromSymbol(h, g_stamps, sizeof(g_stamps));\n}'),
]


def variant(name: str, edits) -> str:
    """Write this source with ``edits`` applied as ``<OUT>/ctc_dp_<name>.cu``;
    returns its path."""
    with open(os.path.join(_build.CSRC, "ctc_dp.cu")) as f:
        src = kernel_stamps.insert_stamps(f.read(), edits, "ctc_dp.cu")
    path = os.path.join(OUT, f"ctc_dp_{name}.cu")
    os.makedirs(OUT, exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return path


def frame_breakdown(kernels, run_a) -> None:
    """B3's frame in SM cycles from the stamped build's clock stamps."""
    run_a()
    torch.cuda.synchronize()
    buf = np.zeros(16 * 8 * 8, dtype=np.uint64)
    read = kernels["stamped"][0].lib().read_stamps
    read.argtypes = [ctypes.c_void_p]
    if read(buf.ctypes.data) != 0:
        raise RuntimeError("reading the stamps failed")
    st = buf.reshape(16, 8, 8).astype(np.int64)
    ghz = (st[-1, 0, 0] - st[0, 0, 0]) / max(st[-1, 0, 3] - st[0, 0, 3], 1)
    print(f"B3 frames 100-115 of block 0, SM cycles (clock {ghz:.2f} GHz): "
          f"loads ready, lse3, add and stores, barrier wait, barrier to the "
          f"next frame's start, period")
    for w in range(8):
        if not st[:, w, 0].any():
            continue
        # stamps in the order they are taken: 0, 4, 5, 1, 2
        cols = [np.median(st[:, w, b] - st[:, w, a])
                for a, b in ((0, 4), (4, 5), (5, 1), (1, 2))]
        cols.append(np.median(st[1:, w, 0] - st[:-1, w, 2]))
        cols.append(np.median(np.diff(st[:, w, 0])))
        print(f"  warp {w}: " + " ".join(f"{int(c):5d}" for c in cols),
              flush=True)


def build(sources):
    """{name: .cu path} -> {name: (alpha CudaKernel, beta CudaKernel)}."""
    kernels = {}
    for name, lib in kernel_stamps.build(OUT, sources).items():
        handle = ctypes.CDLL(lib)
        pair = []
        for kname in ("ctc_alpha", "ctc_beta"):
            kern = _build.CudaKernel(kname, source="ctc_dp")
            kern.library, kern._lib = lib, handle
            pair.append(kern)
        kernels[name] = tuple(pair)
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a ctc_dp.cu of another commit to time")
    ap.add_argument("--version", action="append", default=[],
                    metavar="NAME=FILE", help="another ctc_dp.cu to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}", flush=True)
    sources = {"this": os.path.join(_build.CSRC, "ctc_dp.cu"),
               "exp3": variant("exp3", EXP3),
               "fastmath": variant("fastmath", FASTMATH),
               "stamped": variant("stamped", STAMPS)}
    if args.parent:
        sources["parent"] = os.path.abspath(args.parent)
    for spec in args.version:
        name, path = spec.split("=", 1)
        sources[name] = os.path.abspath(path)
    kernels = build(sources)

    lp, labels, lab_len, frames = chip_smoke.ctc_inputs()
    emit, skip, skip2, init, final, lengths = ctc_cuda.lattice(
        lp, labels, frames, lab_len)
    n_t, n_s = emit.shape[1], emit.shape[2]
    want_a = ctc_cuda.alpha_plain(emit, skip, init, lengths)
    want_b = ctc_cuda.beta_plain(emit, skip2, final, lengths)

    def sweeps(name):
        alpha, beta = kernels[name]
        return (lambda: ctc_cuda._launch(alpha, "ctc_alpha_launch", emit,
                                         skip, init, lengths),
                lambda: ctc_cuda._launch(beta, "ctc_beta_launch", emit,
                                         skip2, final, lengths))

    for name in sources:
        run_a, run_b = sweeps(name)
        same = torch.equal(run_a(), want_a) and torch.equal(run_b(), want_b)
        print(f"{name:8s}: alpha and beta bit-equal to the plain sweeps: "
              f"{same}", flush=True)
        if not same and name != "fastmath":
            raise AssertionError(f"{name} disagrees with the plain sweeps")
    names = ((["parent"] if args.parent else [])
             + [spec.split("=", 1)[0] for spec in args.version]
             + ["exp3", "this"])
    order = names + names[::-1] + ["fastmath"]
    print(f"B={emit.shape[0]} T={n_t} S={n_s}, live frames "
          f"{int(frames.sum())}", flush=True)
    for name in order:
        run_a, run_b = sweeps(name)
        ms_a = chip_smoke.time_ms(run_a, 7)
        ms_b = chip_smoke.time_ms(run_b, 7)
        print(f"{name:8s}: B3 {ms_a:.4f} ms ({ms_a * 1e6 / n_t:.0f} ns a "
              f"frame), B4 {ms_b:.4f} ms ({ms_b * 1e6 / n_t:.0f} ns a frame)",
              flush=True)
    frame_breakdown(kernels, sweeps("stamped")[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
