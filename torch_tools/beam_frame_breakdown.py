#!/usr/bin/env python3
"""Where a frame of kernels B5 and B6 (``tpu_ctc_torch/csrc/beam_search.cu``)
goes, on one NVIDIA GPU.

Builds into ``build/beam_breakdown/`` (git-ignored) the source as it is and
a copy with time stamps (``%globaltimer``) at the boundaries of a frame,
written by thread 0 of the first and the last block over frames 100-115.
The stamped copy exists only there, never in the package.  Then it

  0. measures the card's mma.sync issue rate, TF32 m16n8k8 (what B5/B6's
     GRU products run on) and bf16 m16n8k16: 16 warps on every SM, each
     with 8 independent accumulator chains;
  1. times the kernel (CUDA events around single launches, median of 5
     after a warm-up) at ``chip_smoke.py``'s shapes: B = 64, T = 800,
     A = 29 with the trigram, with the GRU char LM (E = 64, H = 128) at
     K = 128 (phase 8) and K = 200 (phase 9), and without it at K = 128
     (phase 3) and K = 256 (phase 9).  With ``--parent FILE`` (a
     ``beam_search.cu`` of another commit with the same C interface) it
     times that source too, in turns: parent, this, this, parent;
  2. prints, for each shape, the median over the 16 stamped frames of each
     phase of a frame (ns): totals (frame row, beam totals), LM rows (the
     GRU's), mate fold (and stay candidates), grid (candidate grid),
     select (radix select of the K-th key), compaction (survivors in
     enumeration order), rebuild (beam state, backpointers) and GRU step
     (the survivors' GRU states), and the frame's period.  With
     ``--parent`` the parent's source is stamped too, where its frame has
     the same boundaries.

    python3 torch_tools/beam_frame_breakdown.py [--parent OLD_BEAM_SEARCH_CU]
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

import chip_smoke  # noqa: E402
from torch_tools import kernel_stamps  # noqa: E402
from tpu_ctc_torch.ops import _build, beam_cuda  # noqa: E402

OUT = os.path.join(ROOT, "build", "beam_breakdown")
PHASES = ["totals", "LM rows", "mate fold", "grid", "select", "compaction",
          "rebuild", "GRU step"]
# (name, K, GRU, posterior seed): the shapes of chip_smoke.py phases 8, 9, 3
SHAPES = [("GRU K=128", 128, True, 8), ("GRU K=200", 200, True, 8),
          ("trigram K=128", 128, False, 2), ("trigram K=256", 256, False, 4)]
N_B, N_T, A, MAX_LEN = 64, 800, 29, 216
STAMP_DEF = """
__device__ unsigned long long g_stamps[512];  // [block 2][frame 16][16]
__device__ __forceinline__ unsigned long long stamp_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) \\
  if (tid == 0 && (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1) && \\
      t >= 100 && t < 116) \\
    g_stamps[((blockIdx.x ? 1 : 0) * 16 + (t - 100)) * 16 + (i)] = \\
        stamp_ns();
"""
MMA_RATE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <bool kTf32>
__global__ void __launch_bounds__(512) rate(float* out, int iters) {
  const uint32_t a0 = threadIdx.x, a1 = 1, a2 = 2, a3 = 3, b0 = 5, b1 = 7;
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (kTf32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.0f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// TFLOP/s of `iters` rounds on every SM (tf32 or bf16), or < 0 on error.
extern "C" double mma_tflops(int tf32, int iters, float* out) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  auto fn = tf32 ? rate<true> : rate<false>;
  fn<<<sms, 512>>>(out, 100);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  fn<<<sms, 512>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  if (cudaGetLastError() != cudaSuccess) return -1.0;
  const double flop = 2.0 * 16 * 8 * (tf32 ? 8 : 16) * 16 * 8 * sms;
  return flop * iters / (ms * 1e-3) / 1e12;
}
"""
# Each stamp: alternatives of (anchor, text that replaces it); the second
# ones are the anchors of an older source's GRU step.
STAMPS = [
    [("template <int kMaxK, bool kNlm>\n__global__",
      STAMP_DEF + "template <int kMaxK, bool kNlm>\n__global__")],
    [("    // ---- frame row, totals",
      "    STAMP(0);\n    // ---- frame row, totals")],
    [("    const float bar = use_thr ? s_bar : 0.0f;\n",
      "    const float bar = use_thr ? s_bar : 0.0f;\n    STAMP(1);\n")],
    [("    // ---- mate fold and stay candidates",
      "    STAMP(2);\n    // ---- mate fold and stay candidates")],
    [("    // ---- candidate grid in enumeration order",
      "    STAMP(3);\n    // ---- candidate grid in enumeration order")],
    [("    // ---- the K-th largest key",
      "    STAMP(4);\n    // ---- the K-th largest key")],
    [("    // ---- survivors in enumeration order",
      "    STAMP(5);\n    // ---- survivors in enumeration order")],
    [("    // ---- rebuild the beams, write backpointers",
      "    STAMP(6);\n    // ---- rebuild the beams, write backpointers")],
    [("    if constexpr (kNlm) {\n      gru_rebuild(",
      "    STAMP(7);\n    if constexpr (kNlm) {\n      gru_rebuild("),
     ("    // ---- the survivors' GRU states",
      "    STAMP(7);\n    // ---- the survivors' GRU states")],
    [("  }\n  __syncthreads();\n  if (tid < k) {\n    float* f = fin",
      "    STAMP(8);\n  }\n  __syncthreads();\n  if (tid < k) {\n"
      "    float* f = fin")],
    [('extern "C" {',
      'extern "C" {\nint read_stamps(unsigned long long* h) {\n'
      '  return (int)cudaMemcpyFromSymbol(h, g_stamps, sizeof(g_stamps));\n}')],
]


def stamp(src: str) -> str:
    """The source with every stamp inserted; raises where a stamp's anchor
    is not found exactly once."""
    return kernel_stamps.insert_stamps(src, STAMPS, "beam_search.cu")


def inputs(k, gru, seed, dev="cuda"):
    lp, lens = chip_smoke.peaked_posteriors(seed, N_B, N_T, A)
    lm = chip_smoke.seeded_trigram(3, A).tables(dev)
    nlm = chip_smoke.seeded_gru(9, A, 64, 128, dev) if gru else None
    return beam_cuda.prepare(lp.to(dev), lens.to(dev), k, lm_table=lm,
                             lm_order=3, nlm_params=nlm)


def launch(lib, prep, k):
    """One launch of the kernel in library ``lib`` through the wrapper."""
    kern = beam_cuda.kernel_for(k)
    saved, kern._lib = kern._lib, lib
    try:
        return beam_cuda.launch(prep[0], prep[1], k, MAX_LEN, lm=prep[2],
                                lm_order=3, lm_alpha=1.25, lm_beta=1.5,
                                prune_logp=-12.0, gru=prep[4])
    finally:
        kern._lib = saved


def breakdown(lib, prep, k, label):
    launch(lib, prep, k)
    torch.cuda.synchronize()
    buf = np.zeros(512, dtype=np.uint64)
    read = lib.read_stamps
    read.argtypes = [ctypes.c_void_p]
    if read(buf.ctypes.data) != 0:
        raise RuntimeError("reading the stamps failed")
    st = buf.reshape(2, 16, 16).astype(np.int64)
    print(f"  {label}: ns, median of frames 100-115 "
          f"({', '.join(PHASES)}; period)")
    for blk, name in ((0, "first"), (1, "last")):
        d = np.median(np.diff(st[blk, :, :9], axis=1), axis=0)
        period = np.median(np.diff(st[blk, :, 0]))
        print(f"    {name} block: {' '.join(f'{int(x):6d}' for x in d)}"
              f"  | {int(period)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a beam_search.cu of another commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}", flush=True)
    os.makedirs(OUT, exist_ok=True)
    sources = {"this": os.path.join(_build.CSRC, "beam_search.cu")}
    if args.parent:
        sources["parent"] = os.path.abspath(args.parent)
    for name in list(sources):
        try:
            text = stamp(open(sources[name]).read())
        except RuntimeError as err:
            print(f"{name}: not stamped ({err})")
            continue
        path = os.path.join(OUT, f"{name}_stamped.cu")
        with open(path, "w") as f:
            f.write(text)
        sources[name + "_stamped"] = path
    rate_src = os.path.join(OUT, "mma_rate.cu")
    with open(rate_src, "w") as f:
        f.write(MMA_RATE_CU)
    sources["mma_rate"] = rate_src
    libs = {name: ctypes.CDLL(lib)
            for name, lib in kernel_stamps.build(OUT, sources).items()}
    fn = libs["mma_rate"].mma_tflops
    fn.restype = ctypes.c_double
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty(1 << 20, device="cuda")
    for tf32, what in ((1, "m16n8k8 tf32"), (0, "m16n8k16 bf16")):
        print(f"mma.sync {what}: {fn(tf32, 20000, out.data_ptr()):.1f} "
              f"TFLOP/s (every SM, 16 warps, 8 chains a warp)", flush=True)
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    for label, k, gru, seed in SHAPES:
        prep = inputs(k, gru, seed)
        times = [chip_smoke.time_ms(lambda: launch(libs[n], prep, k), 5)
                 for n in order]
        print(f"{label}: " + ", ".join(f"{n} {ms:.3f} ms"
                                       for n, ms in zip(order, times)),
              flush=True)
        for name in ("parent", "this"):
            if name + "_stamped" in libs:
                breakdown(libs[name + "_stamped"], prep, k, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
