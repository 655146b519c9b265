#!/usr/bin/env python3
"""Where a step of kernels B1 and B2 (``tpu_ctc_torch/csrc/birnn.cu``) goes,
on one NVIDIA GPU.

Builds two libraries into ``build/birnn_breakdown/`` (git-ignored): the
source as it is, and a copy with time stamps (``%globaltimer``) at the
phases of a step, written by lane 0 of warps 0, 3, 4 and 7 of the first and
the last block over steps 100-115 of the sweep.  The stamped copy exists
only there, never in the package.  Then it

  1. times B1 and B2 (one direction, bf16, all utterances at full length) at
     preset 4's shape (H = 1824, B = 64, T = 800) and preset 2's (H = 1024,
     B = 32, T = 800), CUDA events around single calls, median of 7 after a
     warm-up; with ``--parent FILE`` (a ``birnn.cu`` of another commit with
     the same C interface, or one whose B1 launcher predates its ``h0``
     argument) it times that source too, in turns: parent, this, this,
     parent;
  2. prints, for each shape, the median over the 16 stamped steps of each
     phase's time from the step's start (ns): the wait for the previous step
     passed, the first ring stage landed, the k loop done, the block barrier
     passed, the warp's arrival at the grid barrier (warps that store the
     new state only), the step's end.

    python3 torch_tools/birnn_step_breakdown.py [--parent OLD_BIRNN_CU]

The parent's kernel reads its exchange buffer as [2, B, H]; the wrapper
passes the zeroed [2, B_pad, H_pad] buffer, which holds it.
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
from tpu_ctc_torch.ops import _build, birnn_cuda  # noqa: E402

OUT = os.path.join(ROOT, "build", "birnn_breakdown")
SHAPES = [(800, 64, 1824), (800, 32, 1024)]
PHASES = ["start", "waited", "stage 0", "k loop", "barrier", "arrived", "end"]
STAMP_DEF = """
__device__ unsigned long long g_stamps[2048];  // [block 2][step 16][warp 8][8]
#define STAMP(i) \\
  if ((blockIdx.x == 0 || blockIdx.x == gridDim.x - 1) && lane == 0 && \\
      s >= 100 && s < 116) \\
    g_stamps[((blockIdx.x ? 1 : 0) * 16 + (s - 100)) * 64 + warp * 8 + (i)] = \\
        global_ns();
"""
# (anchor in birnn.cu, text that replaces it)
STAMPS = [
    ("constexpr unsigned long long kHangNs",
     STAMP_DEF + "constexpr unsigned long long kHangNs"),
    ("    if (s > 0) {  // every block's values of step s - 1 are in src",
     "    STAMP(0);\n    if (s > 0) {"),
    ("    auto fetch = [&](int st) {", "    STAMP(1);\n    auto fetch = [&](int st) {"),
    ("      __syncwarp();                  // ... for every lane; slot st - 1 is free",
     "      __syncwarp();\n      if (st == 0) STAMP(2);"),
    ("    __syncwarp();  // every lane is done with the ring",
     "    __syncwarp();\n    STAMP(3);"),
    ("    __syncthreads();\n\n    if (epi) {",
     "    __syncthreads();\n    STAMP(4);\n    if (epi) {"),
    ("      if (lane == 0) arrive(count);",
     "      if (lane == 0) arrive(count);\n      STAMP(5);"),
    ("      }\n    }\n  }\n}\n\n// The f32 sweep",
     "      }\n    }\n    STAMP(6);\n  }\n}\n\n// The f32 sweep"),
    ('extern "C" {',
     'extern "C" {\nint read_stamps(unsigned long long* h) {\n'
     '  return (int)cudaMemcpyFromSymbol(h, g_stamps, sizeof(g_stamps));\n}'),
]


class _WithoutCarry:
    """The B1 launcher of a source that predates its h0 argument, called
    as the current one is, with the h0 slot (null in this tool) dropped."""

    def __init__(self, fn):
        self.fn, self.restype, self.argtypes = fn, None, None

    def __call__(self, *args):
        if args[3].value is not None:
            raise ValueError("this birnn.cu's B1 takes no h0")
        self.fn.restype = self.restype
        self.fn.argtypes = self.argtypes[:3] + self.argtypes[4:]
        return self.fn(*args[:3], *args[4:])


class _OldLibrary:
    def __init__(self, handle):
        self.birnn_fwd_launch = _WithoutCarry(handle.birnn_fwd_launch)
        self.birnn_bwd_launch = handle.birnn_bwd_launch


def build(sources):
    """{name: .cu path} -> {name: (fwd CudaKernel, bwd CudaKernel)}, built
    in parallel."""
    kernels = {}
    for name, lib in kernel_stamps.build(OUT, sources).items():
        handle = ctypes.CDLL(lib)
        with open(sources[name]) as f:
            if "const void* h0" not in f.read():
                handle = _OldLibrary(handle)
        pair = []
        for kname in ("birnn_fwd", "birnn_bwd"):
            kern = _build.CudaKernel(kname, source="birnn")
            kern.library, kern._lib = lib, handle
            pair.append(kern)
        kernels[name] = tuple(pair)
    return kernels


def stamped_source() -> str:
    with open(os.path.join(_build.CSRC, "birnn.cu")) as f:
        src = kernel_stamps.insert_stamps(f.read(), STAMPS, "birnn.cu")
    path = os.path.join(OUT, "birnn_stamped.cu")
    os.makedirs(OUT, exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return path


def inputs(t, b, h):
    r = np.random.RandomState(1)
    z = 3.0 * r.randn(t, b, h).astype(np.float32)
    w = (0.5 / np.sqrt(h)) * r.randn(h, h).astype(np.float32)
    g = r.randn(t, b, h).astype(np.float32)
    z, w, g = (torch.from_numpy(a).to("cuda", torch.bfloat16)
               for a in (z, w, g))
    return z, w, torch.full((b,), t, dtype=torch.int32, device="cuda"), g


def sweep(kern, x, w, third, bwd):
    return birnn_cuda._sweep_cuda(kern, x, w, third, reverse=bwd, clip=20.0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a birnn.cu of another commit to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}", flush=True)
    sources = {"this": os.path.join(_build.CSRC, "birnn.cu"),
               "stamped": stamped_source()}
    if args.parent:
        sources["parent"] = os.path.abspath(args.parent)
    kernels = build(sources)
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]

    for t, b, h in SHAPES:
        z, w, lens, g = inputs(t, b, h)
        wt = w.t().contiguous()
        for name in order:
            fwd, bwd = kernels[name]
            hs = sweep(fwd, z, w, lens, False)
            ms_f = chip_smoke.time_ms(lambda: sweep(fwd, z, w, lens, False),
                                     7)
            ms_b = chip_smoke.time_ms(lambda: sweep(bwd, g, wt, hs, True), 7)
            print(f"H={h} B={b} T={t} {name:6s}: B1 {ms_f:.3f} ms "
                  f"({ms_f * 1e3 / t:.2f} us a step), B2 {ms_b:.3f} ms "
                  f"({ms_b * 1e3 / t:.2f} us a step)", flush=True)

        fwd, _ = kernels["stamped"]
        sweep(fwd, z, w, lens, False)
        torch.cuda.synchronize()
        buf = np.zeros(2048, dtype=np.uint64)
        read = fwd.lib().read_stamps
        read.argtypes = [ctypes.c_void_p]
        if read(buf.ctypes.data) != 0:
            raise RuntimeError("reading the stamps failed")
        st = buf.reshape(2, 16, 8, 8).astype(np.int64)
        print(f"H={h} B={b}: ns from the step's start, median of steps "
              f"100-115 ({', '.join(PHASES[1:])})")
        n_store = -(-b // 16)          # warps that store the new state
        for blk, label in ((0, "first"), (1, "last")):
            for wp in (0, 3, 4, 7):
                rel = np.median(st[blk, :, wp, :7] - st[blk, :, wp, :1], 0)
                cells = [f"{int(x):7d}" if (i != 5 or wp < n_store) else
                         "      -" for i, x in enumerate(rel)][1:]
                print(f"  {label} block, warp {wp}: {' '.join(cells)}")
            period = np.median(np.diff(st[blk, :, 0, 0]))
            print(f"  {label} block: step period {int(period)} ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
