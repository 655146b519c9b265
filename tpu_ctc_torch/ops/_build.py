"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each kernel source ``tpu_ctc_torch/csrc/<name>.cu`` becomes
``build/tpu_ctc_torch/lib<name>.so`` under the repository root (``build/``
is git-ignored).  Nothing is compiled when a module is imported: the first
launch builds, and :func:`build_all` builds several sources in parallel
(one ``nvcc`` process each).  Each source is self-contained (no shared
header), so the library is stale exactly when its one ``.cu`` is newer.
Several processes (the ranks of a distributed run) may build at once: each
``nvcc`` writes a file of its own in the build directory, which is then
renamed over the library (``os.replace``), so a process that loads the
library finds either no file or a whole one.
Two kernels of one source (the BiRNN forward and backward sweeps, the CTC
alpha and beta sweeps) are two :class:`CudaKernel` objects, each with its
own launch count, over one library.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tpu_ctc_torch")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): the CUDA kernels are built "
                           "from source at first use")
    return path


class CudaKernel:
    """One kernel library: its source, the loaded library once built, and
    ``launches``, the number of kernel launches made through its wrapper
    (the wrapper adds one per launch)."""

    def __init__(self, name: str, source: str = ""):
        self.name = name
        source = source or name
        self.source = os.path.join(CSRC, source + ".cu")
        self.library = os.path.join(BUILD_DIR, f"lib{source}.so")
        self.launches = 0
        self._lib = None
        self.build_log = ""

    def command(self, out: str) -> List[str]:
        return [_nvcc(), *ARCH, "-std=c++17", "-O3", "-lineinfo",
                "-Xptxas", "-v", "-shared", "-Xcompiler",
                "-fPIC", "-o", out, self.source]

    def _fresh(self) -> bool:
        return (os.path.exists(self.library) and os.path.getmtime(
            self.library) >= os.path.getmtime(self.source))

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first when missing or stale."""
        if self._lib is None:
            if not self._fresh():
                build_all([self])
            self._lib = ctypes.CDLL(self.library)
        return self._lib


def build_all(kernels: Sequence[CudaKernel]) -> Dict[str, str]:
    """Compile every kernel's source at once, one ``nvcc`` per library;
    raise with the compiler's output if any fails.  Returns name -> nvcc
    log (kernels that share a library share its log)."""
    by_lib: Dict[str, CudaKernel] = {}
    for k in kernels:
        by_lib.setdefault(k.library, k)
    procs = []
    for k in by_lib.values():
        directory = os.path.dirname(k.library)
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=directory)
        os.close(fd)
        procs.append((k, tmp, subprocess.Popen(
            k.command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for k, tmp, p in procs:
        k.build_log = p.communicate()[0]
        if p.returncode != 0:
            failed.append(f"{k.name}: nvcc exit {p.returncode}\n"
                          f"{k.build_log}")
            os.remove(tmp)
        else:
            os.replace(tmp, k.library)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for k in kernels:
        k.build_log = by_lib[k.library].build_log
    return {k.name: k.build_log for k in kernels}


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(what: str, *tensors) -> ctypes.c_void_p:
    """The current stream of the calling thread's current CUDA device, on
    which a launcher runs its kernel; raises if a tensor of the launch
    (None entries are skipped) lies on another device."""
    import torch
    current = torch.device("cuda", torch.cuda.current_device())
    for t in tensors:
        if t is not None and t.device != current:
            raise ValueError(
                f"{what} kernel: a tensor is on {t.device} but the current "
                f"device is {current}; the kernel launches on the current "
                f"device (torch.cuda.set_device)")
    return ctypes.c_void_p(torch.cuda.current_stream(current).cuda_stream)
