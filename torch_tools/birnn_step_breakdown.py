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
     the same C interface: ``birnn_fwd_launch`` and ``birnn_bwd_launch``
     taking a plan) it times that source too, in turns: parent, this, this,
     parent;
  2. prints, for each shape, the median over the 16 stamped steps of each
     phase's time from the step's start (ns): the wait for the previous step
     passed, the first ring stage landed, the k loop done, the block barrier
     passed, the warp's arrival at the grid barrier (warps that store the
     new state only), the step's end;
  3. both directions of a layer in one launch of 32 columns of W a block
     (``birnn_fwd_bi32``, ``birnn_bwd_bi32``) at presets 3 and 4's width
     (H = 1824, T = 800, B = 64 and a DP4 rank's 16) and at preset 2's
     shape: their times beside one direction's launch and the ratio r of
     the two (a fused step over one direction's), then item 2's phases of
     a fused B1 step at H = 1824, B = 64, the first block sweeping
     direction 0 and the last direction 1.

Every launch goes through ``birnn_cuda.launch`` under the plan of
``birnn_cuda.plan_for`` on this card, through the library built from each
source.

    python3 torch_tools/birnn_step_breakdown.py [--parent OLD_BIRNN_CU]

The parent's kernel reads its exchange buffer as [2, B, H]; the wrapper
passes the zeroed [2, B_pad, H_pad] buffer, which holds it.

``--wide`` does the same for the wide instance (``mma_wide_kernel``,
``f32_wide_kernel``) at preset 5's rank shape under model = 4 (H = 4096,
B = 16, T = 1600), bf16 and f32: it times B1 and B2 (median of 3, in
turns with ``--parent``), then stamps each source's wide kernels
(``WIDE_STAMPS``: lane 0 of every warp of the first and the last block,
steps 100-115) and splits a step of warp 0 of the first block into four
parts: the grid barrier's wait, the state's fetch (the wait for the first
copy stage of the pass over the state), the k loop with W's streamed
pieces, and the epilogue (the partials' sum, the stores and the
arrival).

    python3 torch_tools/birnn_step_breakdown.py --wide [--parent OLD_BIRNN_CU]
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


# ---- the wide instance ------------------------------------------------------
WIDE_SHAPE = (1600, 16, 4096)          # T, B, H: preset 5's rank at model 4
WSLOTS = 12                            # stamps a warp records each step
WSTAMP_DEF = """
__device__ unsigned long long g_wstamps[3072];  // [block 2][step 16][warp 8][12]
#define WSTAMP(i) \\
  if ((blockIdx.x == 0 || blockIdx.x == gridDim.x - 1) && \\
      (threadIdx.x & 31) == 0 && s >= 100 && s < 116) \\
    g_wstamps[((blockIdx.x ? 1 : 0) * 16 + (s - 100)) * 96 + \\
              (threadIdx.x >> 5) * 12 + (i)] = global_ns();
"""
READ_WSTAMPS = ('extern "C" {',
                'extern "C" {\nint read_wstamps(unsigned long long* h) {\n'
                '  return (int)cudaMemcpyFromSymbol(h, g_wstamps, '
                'sizeof(g_wstamps));\n}')


def _split_bf16(r):
    """mma_wide_kernel's slots (one pass over the state for all of a
    block's tiles): slot 0 the step's start, 1 the grid barrier passed, 2
    the first stage in, 3 the k loop done, 4 the block's partials in, 5 the
    stores of the new state done, 6 the arrival, 7 the HBM stores and the
    next inputs issued."""
    return {"barrier wait": r[1] - r[0], "state fetch": r[2] - r[1],
            "k loop and W stream": r[3] - r[2], "epilogue": r[7] - r[3]}


def _split_f32(r):
    """f32_wide_kernel's slots: slot 0 the step's start, 1 the grid
    barrier passed, 2 the first chunk in, 3 the k loop done, 4 the stores
    of the new state done, 5 the arrival, 6 the next inputs issued."""
    return {"barrier wait": r[1] - r[0], "state fetch": r[2] - r[1],
            "k loop and W stream": r[3] - r[2], "epilogue": r[6] - r[3]}


# The wide kernels' stamps (anchor in birnn.cu, text that replaces it), and
# by dtype the function that splits warp 0's slots of a step.
WIDE_STAMPS = [
    ("constexpr int kMaxOwn = 4;",
     WSTAMP_DEF + "constexpr int kMaxOwn = 4;"),
    ("      // W's first stages do not depend on the state: before "
     "the wait",
     "      if (pass == 0) WSTAMP(0);"),
    ("        if (lane == 0) wait_count(count, gridDim.x * (unsigned "
     "int)s);\n        __syncwarp();\n      }",
     "        if (lane == 0) wait_count(count, gridDim.x * (unsigned "
     "int)s);\n        __syncwarp();\n      }\n"
     "      if (pass == 0) WSTAMP(1);"),
    ("        __syncwarp();  // stage st is in for every lane; slot "
     "st - 1 is free\n        if (st + kWideStages - 1 < nk) {",
     "        __syncwarp();\n        if (pass == 0 && st == 0) "
     "WSTAMP(2);\n        if (st + kWideStages - 1 < nk) {"),
    ("      __syncwarp();  // the ring is free for this warp's "
     "partials",
     "      __syncwarp();\n      if (pass == 0) WSTAMP(3);"),
    ("      __syncthreads();  // every warp's partials of the pass "
     "are in",
     "      __syncthreads();\n      if (pass == 0) WSTAMP(4);"),
    ("      __syncthreads();  // the stores are in; the partials are "
     "read\n      if (pass == n_pass - 1 && tid == 0) arrive(count);",
     "      if (pass == 0) WSTAMP(5);\n      __syncthreads();\n"
     "      if (pass == n_pass - 1 && tid == 0) arrive(count);\n"
     "      if (pass == 0) WSTAMP(6);"),
    ("        load_units(reverse ? t - 1 : t + 1, 0);\n    }\n  }\n}",
     "        load_units(reverse ? t - 1 : t + 1, 0);\n"
     "      if (pass == 0) WSTAMP(7);\n    }\n  }\n}"),
    ("    // W's first chunks do not depend on the state: before the "
     "wait",
     "    WSTAMP(0);"),
    ("      if (tid == 0) wait_count(count, nblk * (unsigned int)s);"
     "\n      __syncthreads();\n    }",
     "      if (tid == 0) wait_count(count, nblk * (unsigned int)s);"
     "\n      __syncthreads();\n    }\n    WSTAMP(1);"),
    ("      __syncthreads();  // chunk kc is in; stage (kc - 1) % "
     "depth is free",
     "      __syncthreads();\n      if (kc == 0) WSTAMP(2);"),
    ("    cp_async_wait<0>();\n\n    float4 ov[kR];",
     "    cp_async_wait<0>();\n    WSTAMP(3);\n    float4 ov[kR];"),
    ("    __syncthreads();  // the block's stores are in; the stages "
     "are free\n    if (tid == 0) arrive(count);",
     "    WSTAMP(4);\n    __syncthreads();\n"
     "    if (tid == 0) arrive(count);\n    WSTAMP(5);"),
    ("    if (s + 1 < n_t) load_rows(reverse ? t - 1 : t + 1);\n  }\n}",
     "    if (s + 1 < n_t) load_rows(reverse ? t - 1 : t + 1);\n"
     "    WSTAMP(6);\n  }\n}"),
    READ_WSTAMPS]
WIDE_SPLIT = {"bf16": _split_bf16, "f32": _split_f32}


def wide_stamped_source(path: str, name: str) -> str:
    """A copy of ``path`` with the wide stamps, under ``OUT``."""
    with open(path) as f:
        src = kernel_stamps.insert_stamps(f.read(), WIDE_STAMPS, path)
    out = os.path.join(OUT, f"{name}_wide_stamped.cu")
    os.makedirs(OUT, exist_ok=True)
    with open(out, "w") as f:
        f.write(src)
    return out


def wide_inputs(dtype):
    t, b, h = WIDE_SHAPE
    r = np.random.RandomState(5)
    z = 3.0 * r.randn(t, b, h).astype(np.float32)
    w = (0.5 / np.sqrt(h)) * r.randn(h, h).astype(np.float32)
    g = r.randn(t, b, h).astype(np.float32)
    z, w, g = (torch.from_numpy(a).to("cuda", dtype) for a in (z, w, g))
    return z, w, torch.full((b,), t, dtype=torch.int32, device="cuda"), g


def sweep(lib, x, w, third, bwd):
    """One direction of B1 (B2 with ``bwd``) through the library ``lib``
    under this card's plan, the narrow or the wide instance by width."""
    return birnn_cuda.launch(None, bwd, x, (w,), (third,), reverse=bwd,
                             clip=20.0, lib=lib)[0]


def main_wide(args) -> int:
    sources = {"this": os.path.join(_build.CSRC, "birnn.cu")}
    if args.parent:
        sources["parent"] = os.path.abspath(args.parent)
    for name in list(sources):
        sources[name + "_stamped"] = wide_stamped_source(sources[name], name)
    libs = build(sources)
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    t, b, h = WIDE_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        dname = "bf16" if dtype == torch.bfloat16 else "f32"
        z, w, lens, g = wide_inputs(dtype)
        wt = w.t().contiguous()
        for name in order:
            lib = libs[name]
            hs = sweep(lib, z, w, lens, False)
            ms_f = chip_smoke.time_ms(lambda: sweep(lib, z, w, lens, False),
                                      3)
            ms_b = chip_smoke.time_ms(lambda: sweep(lib, g, wt, hs, True), 3)
            print(f"wide {dname} H={h} B={b} T={t} {name:6s}: B1 "
                  f"{ms_f:.3f} ms ({ms_f * 1e3 / t:.2f} us a step), B2 "
                  f"{ms_b:.3f} ms ({ms_b * 1e3 / t:.2f} us a step)",
                  flush=True)
        for name in sources:
            if name.endswith("_stamped"):
                continue
            lib = libs[name + "_stamped"]
            sweep(lib, z, w, lens, False)
            torch.cuda.synchronize()
            buf = np.zeros(3072, dtype=np.uint64)
            read = lib.read_wstamps
            read.argtypes = [ctypes.c_void_p]
            if read(buf.ctypes.data) != 0:
                raise RuntimeError("reading the stamps failed")
            st = buf.reshape(2, 16, 8, WSLOTS).astype(np.int64)
            parts = [WIDE_SPLIT[dname](st[0, i, 0]) for i in range(15)]
            period = np.median(np.diff(st[0, :, 0, 0]))
            cells = ", ".join(f"{k} {int(np.median([p[k] for p in parts]))}"
                              for k in parts[0])
            print(f"wide {dname} {name}: a step of warp 0, first block, ns "
                  f"(median of steps 100-114): {cells}; step period "
                  f"{int(period)}", flush=True)
            for blk, label in ((0, "first"), (1, "last")):
                for wp in range(8):
                    rel = np.median(st[blk, :, wp] - st[blk, :, wp, :1], 0)
                    used = st[blk, 0, wp] != 0
                    print(f"  {label} block, warp {wp}: slots "
                          + " ".join(f"{int(x):7d}" if u else "      -"
                                     for x, u in zip(rel[1:], used[1:])))
    return 0


def build(sources):
    """{name: .cu path} -> {name: the loaded library}, built in
    parallel."""
    return {name: ctypes.CDLL(lib)
            for name, lib in kernel_stamps.build(OUT, sources).items()}


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


# T, B, H of item 3: presets 3 and 4 (the first is stamped), then preset 2
FUSED_SHAPES = [(800, 64, 1824), (800, 16, 1824), (800, 32, 1024)]


def fused_sweep(lib, x, ws, thirds, bwd):
    """Both directions in one 32-column launch through the library
    ``lib``."""
    p = birnn_cuda.plan_for(x, directions=2)
    if p.directions != 2:
        raise RuntimeError("the launch of both directions does not fit "
                           "this card at this shape")
    return birnn_cuda.launch(p, bwd, x, ws, thirds, reverse=bwd, clip=20.0,
                             lib=lib)


def print_stamps(lib, what: str, n_store: int) -> None:
    """Item 2's table from the stamped library's last launch: for the
    first and the last block, warps 0, 3, 4, 7, each phase's ns from the
    step's start (median of steps 100-115); arrivals of the n_store warps
    that store the new state only."""
    buf = np.zeros(2048, dtype=np.uint64)
    read = lib.read_stamps
    read.argtypes = [ctypes.c_void_p]
    if read(buf.ctypes.data) != 0:
        raise RuntimeError("reading the stamps failed")
    st = buf.reshape(2, 16, 8, 8).astype(np.int64)
    print(f"{what}: ns from the step's start, median of steps 100-115 "
          f"({', '.join(PHASES[1:])})")
    for blk, label in ((0, "first"), (1, "last")):
        for wp in (0, 3, 4, 7):
            rel = np.median(st[blk, :, wp, :7] - st[blk, :, wp, :1], 0)
            cells = [f"{int(x):7d}" if (i != 5 or wp < n_store) else
                     "      -" for i, x in enumerate(rel)][1:]
            print(f"  {label} block, warp {wp}: {' '.join(cells)}")
        period = np.median(np.diff(st[blk, :, 0, 0]))
        print(f"  {label} block: step period {int(period)} ns")


def main_fused(libs) -> None:
    """Item 3: the 32-column launch of both directions at FUSED_SHAPES."""
    lib = libs["this"]
    for t, b, h in FUSED_SHAPES:
        z, wf, lens, g = inputs(t, b, h)
        wb = wf.flip(0).contiguous()
        ws_t = (wf.t().contiguous(), wb.t().contiguous())
        hs = fused_sweep(lib, z, (wf, wb), (lens,), False)
        ms = {"B1": chip_smoke.time_ms(lambda: fused_sweep(
                  lib, z, (wf, wb), (lens,), False), 7),
              "B2": chip_smoke.time_ms(lambda: fused_sweep(
                  lib, g, ws_t, hs, True), 7)}
        one = {"B1": chip_smoke.time_ms(
                   lambda: sweep(lib, z, wf, lens, False), 7),
               "B2": chip_smoke.time_ms(
                   lambda: sweep(lib, g, ws_t[0], hs[0], True), 7)}
        for k in ms:
            print(f"H={h} B={b} T={t} both directions, 32 columns a block: "
                  f"{k} {ms[k]:.3f} ms ({ms[k] * 1e3 / t:.2f} us a step); "
                  f"one direction {one[k]:.3f} ms, twice it "
                  f"{2 * one[k]:.3f} ms; r = {ms[k] / one[k]:.3f}",
                  flush=True)
    t, b, h = FUSED_SHAPES[0]
    z, wf, lens, g = inputs(t, b, h)
    wb = wf.flip(0).contiguous()
    fused_sweep(libs["stamped"], z, (wf, wb), (lens,), False)
    torch.cuda.synchronize()
    print_stamps(libs["stamped"], f"H={h} B={b} both directions, 32 columns "
                 f"a block (first block direction 0, last direction 1)",
                 2 * -(-b // 16))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a birnn.cu of another commit to time")
    ap.add_argument("--wide", action="store_true",
                    help="the wide instance at H = 4096, B = 16, T = 1600")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}", flush=True)
    if args.wide:
        return main_wide(args)
    sources = {"this": os.path.join(_build.CSRC, "birnn.cu"),
               "stamped": stamped_source()}
    if args.parent:
        sources["parent"] = os.path.abspath(args.parent)
    libs = build(sources)
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]

    for t, b, h in SHAPES:
        z, w, lens, g = inputs(t, b, h)
        wt = w.t().contiguous()
        for name in order:
            lib = libs[name]
            hs = sweep(lib, z, w, lens, False)
            ms_f = chip_smoke.time_ms(lambda: sweep(lib, z, w, lens, False),
                                      7)
            ms_b = chip_smoke.time_ms(lambda: sweep(lib, g, wt, hs, True), 7)
            print(f"H={h} B={b} T={t} {name:6s}: B1 {ms_f:.3f} ms "
                  f"({ms_f * 1e3 / t:.2f} us a step), B2 {ms_b:.3f} ms "
                  f"({ms_b * 1e3 / t:.2f} us a step)", flush=True)

        sweep(libs["stamped"], z, w, lens, False)
        torch.cuda.synchronize()
        print_stamps(libs["stamped"], f"H={h} B={b}", -(-b // 16))
    main_fused(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
