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
     new state only), the step's end;
  3. both directions of a layer in one launch of 32 columns of W a block
     (``birnn_fwd_bi32``, ``birnn_bwd_bi32``) at presets 3 and 4's width
     (H = 1824, T = 800, B = 64 and a DP4 rank's 16) and, forced, at
     preset 2's shape (where the package takes 16 columns): their times
     beside one direction's launch and the ratio r of the two (a fused
     step over one direction's), then item 2's phases of a fused B1 step
     at H = 1824, B = 64, the first block sweeping direction 0 and the
     last direction 1.

    python3 torch_tools/birnn_step_breakdown.py [--parent OLD_BIRNN_CU]

The parent's kernel reads its exchange buffer as [2, B, H]; the wrapper
passes the zeroed [2, B_pad, H_pad] buffer, which holds it.

``--wide`` does the same for the wide instance (``mma_wide_kernel``,
``f32_wide_kernel``) at preset 5's rank shape under model = 4 (H = 4096,
B = 16, T = 1600), bf16 and f32: it times B1 and B2 (median of 3, in
turns with ``--parent``), then stamps each source's wide kernels (the
stamps of the design whose anchors the source holds, ``WIDE_DESIGNS``:
lane 0 of every warp of the first and the last block, steps 100-115) and
splits a step of warp 0 of the first block into four parts: the grid
barrier's wait, the state's fetch (the wait for the first copy stage of
each pass over the state), the k loop with W's streamed pieces, and the
epilogue (the partials' sum, the stores and the arrival).

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


def _split_tile_passes_bf16(r):
    """The first wide design's mma_wide_kernel (a pass over the state for
    each of a block's 2 tiles): slot 0 the step's start, 1 + 4 i tile i's start (after the
    grid barrier for i = 0), 2 + 4 i its first stage in, 3 + 4 i its k
    loop done, 4 + 4 i the block's partials in; 9 the arrival."""
    return {"barrier wait": r[1] - r[0],
            "state fetch": (r[2] - r[1]) + (r[6] - r[5]),
            "k loop and W stream": (r[3] - r[2]) + (r[7] - r[6]),
            "epilogue": (r[4] - r[3]) + (r[5] - r[4]) + (r[8] - r[7])
                        + (r[9] - r[8])}


def _split_tile_passes_f32(r):
    """The first wide design's f32_wide_kernel: slot 0 the step's start, 1 + 3 i tile i's
    first chunk in, 2 + 3 i its k loop done, 3 + 3 i its epilogue done;
    7 the arrival, 8 the grid barrier passed."""
    return {"barrier wait": r[8] - r[7],
            "state fetch": (r[1] - r[0]) + (r[4] - r[3]),
            "k loop and W stream": (r[2] - r[1]) + (r[5] - r[4]),
            "epilogue": (r[3] - r[2]) + (r[6] - r[5]) + (r[7] - r[6])}


def _split_one_pass_bf16(r):
    """The one-pass design's mma_wide_kernel (one pass over the state for
    all of a block's tiles):
    slot 0 the step's start, 1 the grid barrier passed, 2 the first stage
    in, 3 the k loop done, 4 the block's partials in, 5 the stores of the
    new state done, 6 the arrival, 7 the HBM stores and the next inputs
    issued."""
    return {"barrier wait": r[1] - r[0], "state fetch": r[2] - r[1],
            "k loop and W stream": r[3] - r[2], "epilogue": r[7] - r[3]}


def _split_one_pass_f32(r):
    """The one-pass design's f32_wide_kernel: slot 0 the step's start, 1 the grid
    barrier passed, 2 the first chunk in, 3 the k loop done, 4 the stores
    of the new state done, 5 the arrival, 6 the next inputs issued."""
    return {"barrier wait": r[1] - r[0], "state fetch": r[2] - r[1],
            "k loop and W stream": r[3] - r[2], "epilogue": r[6] - r[3]}


def _padded_weights(w):
    """W as the first wide design takes it: zero-padded to [H_pad,
    H_pad]."""
    pad = birnn_cuda.exchange_shape(1, w.shape[0])[2] - w.shape[0]
    return torch.nn.functional.pad(w, (0, pad, 0, pad))


# Each design: its stamps (anchor in birnn.cu, replacement), by dtype the
# function that splits warp 0's slots of a step, and the layout of W its
# wide kernels take.  A source is stamped with the design all of whose
# anchors it holds once.
WIDE_DESIGNS = {
    "tile passes": {
        "stamps": [
            ("constexpr int kMaxOwn = 4;",
             WSTAMP_DEF + "constexpr int kMaxOwn = 4;"),
            ("    if (s > 0) {  // the grid's values of step s - 1 are all "
             "in src",
             "    WSTAMP(0);\n    if (s > 0) {"),
            ("      const int n_st = (nk + tps - 1) / tps;",
             "      WSTAMP(1 + 4 * i);\n"
             "      const int n_st = (nk + tps - 1) / tps;"),
            ("        __syncwarp();  // stage st is in for every lane; slot "
             "st - 1 is free",
             "        __syncwarp();\n        if (st == 0) WSTAMP(2 + 4 * i);"),
            ("      __syncwarp();  // the ring is free for this warp's "
             "partial",
             "      __syncwarp();\n      WSTAMP(3 + 4 * i);"),
            ("      __syncthreads();  // every warp's partial of tile i is "
             "in its ring",
             "      __syncthreads();\n      WSTAMP(4 + 4 * i);"),
            ("      if (!lane) arrive(count);\n    }",
             "      if (!lane) arrive(count);\n    }\n    WSTAMP(9);"),
            ("      const int jt = blockIdx.x + i * nblk, j0 = jt * kCols;",
             "      if (i == 0) WSTAMP(0);\n"
             "      const int jt = blockIdx.x + i * nblk, j0 = jt * kCols;"),
            ("        __syncthreads();  // chunk kc is in; stage (kc - 1) % 3 "
             "is free",
             "        __syncthreads();\n        if (kc == 0) WSTAMP(1 + 3 * i);"),
            ("      cp_async_wait<0>();\n\n#pragma unroll\n      for (int r = 0;"
             " r < 2; ++r) {",
             "      cp_async_wait<0>();\n      WSTAMP(2 + 3 * i);\n"
             "#pragma unroll\n      for (int r = 0; r < 2; ++r) {"),
            ("      __syncthreads();  // the stages are free for the next "
             "tile",
             "      __syncthreads();\n      WSTAMP(3 + 3 * i);"),
            ("    if (tid == 0) {\n      arrive(count);\n      wait_count("
             "count, nblk * (unsigned int)(s + 1));\n    }\n    "
             "__syncthreads();\n  }\n}\n\n// Shared memory",
             "    WSTAMP(7);\n    if (tid == 0) {\n      arrive(count);\n"
             "      wait_count(count, nblk * (unsigned int)(s + 1));\n    }\n"
             "    __syncthreads();\n    WSTAMP(8);\n  }\n}\n\n"
             "// Shared memory"),
            READ_WSTAMPS],
        "bf16": _split_tile_passes_bf16, "f32": _split_tile_passes_f32,
        "weights": _padded_weights},
    "one pass": {
        "stamps": [
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
            READ_WSTAMPS],
        "bf16": _split_one_pass_bf16, "f32": _split_one_pass_f32,
        "weights": birnn_cuda.wide_weights},
}


def wide_design(src: str) -> str:
    """The name of the design whose wide stamps ``src`` takes."""
    for name, d in WIDE_DESIGNS.items():
        if all(src.count(a) == 1 for a, _ in d["stamps"]):
            return name
    raise RuntimeError("birnn.cu matches no design of WIDE_DESIGNS")


def wide_stamped_source(path: str, name: str):
    """A copy of ``path`` with its design's wide stamps, under ``OUT``;
    returns (its path, the design's name)."""
    with open(path) as f:
        src = f.read()
    design = wide_design(src)
    src = kernel_stamps.insert_stamps(src, WIDE_DESIGNS[design]["stamps"],
                                      path)
    out = os.path.join(OUT, f"{name}_wide_stamped.cu")
    os.makedirs(OUT, exist_ok=True)
    with open(out, "w") as f:
        f.write(src)
    return out, design


def wide_inputs(dtype):
    t, b, h = WIDE_SHAPE
    r = np.random.RandomState(5)
    z = 3.0 * r.randn(t, b, h).astype(np.float32)
    w = (0.5 / np.sqrt(h)) * r.randn(h, h).astype(np.float32)
    g = r.randn(t, b, h).astype(np.float32)
    z, w, g = (torch.from_numpy(a).to("cuda", dtype) for a in (z, w, g))
    return z, w, torch.full((b,), t, dtype=torch.int32, device="cuda"), g


def wide_pair(kernels, name):
    """The wide fwd and bwd CudaKernels over the library of ``name``."""
    fwd, bwd = kernels[name]
    pair = []
    for kern, wname in ((fwd, "birnn_fwd_wide"), (bwd, "birnn_bwd_wide")):
        wk = _build.CudaKernel(wname, source="birnn")
        wk.library, wk._lib = kern.library, kern._lib
        pair.append(wk)
    return pair


def wide_sweep(kern, x, w, third, bwd, design):
    """One wide sweep through ``kern`` (a library of ``design``), W laid
    out as that design takes it."""
    base = birnn_cuda.BWD_KERNEL if bwd else birnn_cuda.KERNEL
    saved = birnn_cuda._WIDE[base.name], birnn_cuda.wide_weights
    birnn_cuda._WIDE[base.name] = kern
    birnn_cuda.wide_weights = WIDE_DESIGNS[design]["weights"]
    try:
        return birnn_cuda._sweep_cuda(base, x, w, third, reverse=bwd,
                                      clip=20.0, wide=True)
    finally:
        birnn_cuda._WIDE[base.name], birnn_cuda.wide_weights = saved


def main_wide(args) -> int:
    sources = {"this": os.path.join(_build.CSRC, "birnn.cu")}
    if args.parent:
        sources["parent"] = os.path.abspath(args.parent)
    stamped = {}
    for name in list(sources):
        path, design = wide_stamped_source(sources[name], name)
        sources[name + "_stamped"] = path
        stamped[name] = design
    kernels = build(sources)
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    t, b, h = WIDE_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        dname = "bf16" if dtype == torch.bfloat16 else "f32"
        z, w, lens, g = wide_inputs(dtype)
        wt = w.t().contiguous()
        for name in order:
            fwd, bwd = wide_pair(kernels, name)
            design = stamped[name]
            hs = wide_sweep(fwd, z, w, lens, False, design)
            ms_f = chip_smoke.time_ms(
                lambda: wide_sweep(fwd, z, w, lens, False, design), 3)
            ms_b = chip_smoke.time_ms(
                lambda: wide_sweep(bwd, g, wt, hs, True, design), 3)
            print(f"wide {dname} H={h} B={b} T={t} {name:6s}: B1 "
                  f"{ms_f:.3f} ms ({ms_f * 1e3 / t:.2f} us a step), B2 "
                  f"{ms_b:.3f} ms ({ms_b * 1e3 / t:.2f} us a step)",
                  flush=True)
        for name in sources:
            if name.endswith("_stamped") or name not in stamped:
                continue
            fwd, _ = wide_pair(kernels, name + "_stamped")
            wide_sweep(fwd, z, w, lens, False, stamped[name])
            torch.cuda.synchronize()
            buf = np.zeros(3072, dtype=np.uint64)
            read = fwd.lib().read_wstamps
            read.argtypes = [ctypes.c_void_p]
            if read(buf.ctypes.data) != 0:
                raise RuntimeError("reading the stamps failed")
            st = buf.reshape(2, 16, 8, WSLOTS).astype(np.int64)
            split = WIDE_DESIGNS[stamped[name]][dname]
            parts = [split(st[0, i, 0]) for i in range(15)]
            period = np.median(np.diff(st[0, :, 0, 0]))
            cells = ", ".join(f"{k} {int(np.median([p[k] for p in parts]))}"
                              for k in parts[0])
            print(f"wide {dname} {name} ({stamped[name]} design): a step "
                  f"of warp 0, first block, ns (median of steps 100-114): "
                  f"{cells}; step period {int(period)}", flush=True)
            for blk, label in ((0, "first"), (1, "last")):
                for wp in range(8):
                    rel = np.median(st[blk, :, wp] - st[blk, :, wp, :1], 0)
                    used = st[blk, 0, wp] != 0
                    print(f"  {label} block, warp {wp}: slots "
                          + " ".join(f"{int(x):7d}" if u else "      -"
                                     for x, u in zip(rel[1:], used[1:])))
    return 0


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


# T, B, H of item 3: presets 3 and 4 (the first is stamped), then preset 2
FUSED_SHAPES = [(800, 64, 1824), (800, 16, 1824), (800, 32, 1024)]


def fused_sweep(lib_kern, x, ws, thirds, bwd):
    """Both directions in one 32-column launch through the library of
    ``lib_kern`` (a CudaKernel of :func:`build`), at any width that fits
    (``bi_grid``'s choice of 16 columns overridden)."""
    kern = _build.CudaKernel("birnn_bwd_bi32" if bwd else "birnn_fwd_bi32",
                             source="birnn")
    kern.library, kern._lib = lib_kern.library, lib_kern._lib
    saved = birnn_cuda._BI[bwd, 32], birnn_cuda.bi_grid
    birnn_cuda._BI[bwd, 32] = kern
    birnn_cuda.bi_grid = lambda n_b, n_h, *a, **k: (2 * -(-n_h // 32), 32)
    try:
        out = birnn_cuda._bi_sweep_cuda(bwd, x, ws, thirds, clip=20.0)
    finally:
        birnn_cuda._BI[bwd, 32], birnn_cuda.bi_grid = saved
    if out is None:
        raise RuntimeError("the 32-column launch of both directions did not "
                           "engage at this shape on this card")
    return out


def print_stamps(lib_kern, what: str, n_store: int) -> None:
    """Item 2's table from the stamped library's last launch: for the
    first and the last block, warps 0, 3, 4, 7, each phase's ns from the
    step's start (median of steps 100-115); arrivals of the n_store warps
    that store the new state only."""
    buf = np.zeros(2048, dtype=np.uint64)
    read = lib_kern.lib().read_stamps
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


def main_fused(kernels) -> None:
    """Item 3: the 32-column launch of both directions at FUSED_SHAPES."""
    fwd, bwd = kernels["this"]
    for t, b, h in FUSED_SHAPES:
        z, wf, lens, g = inputs(t, b, h)
        wb = wf.flip(0).contiguous()
        ws_t = (wf.t().contiguous(), wb.t().contiguous())
        hs = fused_sweep(fwd, z, (wf, wb), (lens, lens), False)
        ms = {"B1": chip_smoke.time_ms(lambda: fused_sweep(
                  fwd, z, (wf, wb), (lens, lens), False), 7),
              "B2": chip_smoke.time_ms(lambda: fused_sweep(
                  fwd, g, ws_t, hs, True), 7)}
        one = {"B1": chip_smoke.time_ms(
                   lambda: sweep(fwd, z, wf, lens, False), 7),
               "B2": chip_smoke.time_ms(
                   lambda: sweep(bwd, g, ws_t[0], hs[0], True), 7)}
        for k in ms:
            print(f"H={h} B={b} T={t} both directions, 32 columns a block: "
                  f"{k} {ms[k]:.3f} ms ({ms[k] * 1e3 / t:.2f} us a step); "
                  f"one direction {one[k]:.3f} ms, twice it "
                  f"{2 * one[k]:.3f} ms; r = {ms[k] / one[k]:.3f}",
                  flush=True)
    t, b, h = FUSED_SHAPES[0]
    z, wf, lens, g = inputs(t, b, h)
    wb = wf.flip(0).contiguous()
    stamped, _ = kernels["stamped"]
    fused_sweep(stamped, z, (wf, wb), (lens, lens), False)
    torch.cuda.synchronize()
    print_stamps(stamped, f"H={h} B={b} both directions, 32 columns a block "
                 f"(first block direction 0, last direction 1)",
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
        print_stamps(fwd, f"H={h} B={b}", -(-b // 16))
    main_fused(kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
