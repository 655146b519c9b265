"""Kernel libraries built by several processes at once, as the ranks of a
distributed run build them on a cold ``build/``.

Each build writes a file of its own in the build directory and renames it
over the library, so a process that loads the library finds a whole file or
none.  A fake ``nvcc`` on ``PATH`` stands in for the compiler: it writes a
real shared library (Python's ``_ctypes`` extension) to its ``-o`` path in
two halves with a pause between them, as a linker writes its output in
place.  Two builders of one stub source run at once, the second starting
while the first's output is half written; each must load the library with
``ctypes`` and the file must be whole.
"""
import ctypes
import os
import sys
import threading
import time

import _ctypes

from tpu_ctc_torch.ops import _build

FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["STUB_PAYLOAD"], "rb") as f:
    data = f.read()
with open(out, "wb") as f:
    f.write(data[: len(data) // 2])
    f.flush()
    open(os.environ["STUB_HALF"], "w").close()
    time.sleep(1.0)
    f.write(data[len(data) // 2:])
print("ptxas info    : stub")
"""


def test_two_builders_at_once_load_whole_files(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    half = tmp_path / "half"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("STUB_PAYLOAD", _ctypes.__file__)
    monkeypatch.setenv("STUB_HALF", str(half))
    source = tmp_path / "stub.cu"
    source.write_text("// a stub source\n")
    library = tmp_path / "build" / "libstub.so"
    library.parent.mkdir()
    kernels = []
    for _ in range(2):
        kern = _build.CudaKernel("stub")
        kern.source, kern.library = str(source), str(library)
        kernels.append(kern)
    results = {}

    def load(i):
        try:
            results[i] = kernels[i].lib()
        except Exception as e:  # reported below
            results[i] = e

    first = threading.Thread(target=load, args=(0,))
    first.start()
    deadline = time.time() + 60
    while not half.exists():
        assert time.time() < deadline, "the fake nvcc never started"
        time.sleep(0.01)
    second = threading.Thread(target=load, args=(1,))
    second.start()
    first.join(120)
    second.join(120)
    for i in range(2):
        assert isinstance(results[i], ctypes.CDLL), results[i]
        assert "stub" in kernels[i].build_log
    with open(_ctypes.__file__, "rb") as f:
        assert library.read_bytes() == f.read()
    assert sorted(os.listdir(library.parent)) == ["libstub.so"]
