"""What the kernel breakdown tools (``birnn_step_breakdown.py``,
``beam_frame_breakdown.py``) share: a kernel source with time stamps
inserted at anchors in its text, and the parallel build of such copies
into a directory under ``build/`` (git-ignored), never into the package.
"""
from __future__ import annotations

import os
import sys
from typing import Dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpu_ctc_torch.ops import _build  # noqa: E402


def insert_stamps(src: str, stamps, what: str) -> str:
    """``src`` with every stamp inserted.  A stamp is (anchor, text that
    replaces it) or a list of such alternatives; exactly one alternative's
    anchor must occur exactly once in ``src``, else this raises."""
    for stamp in stamps:
        alternatives = stamp if isinstance(stamp, list) else [stamp]
        hits = [(a, t) for a, t in alternatives if src.count(a) == 1]
        if len(hits) != 1:
            raise RuntimeError(f"no single anchor in {what} for "
                               f"{alternatives[0][0]!r}")
        src = src.replace(*hits[0])
    return src


def build(out_dir: str, sources: Dict[str, str]) -> Dict[str, str]:
    """{name: .cu path} -> {name: path of lib<name>.so in ``out_dir``},
    compiled in parallel by the package's own ``nvcc`` command."""
    os.makedirs(out_dir, exist_ok=True)
    kernels = []
    for name, src in sources.items():
        kern = _build.CudaKernel(name)
        kern.source = src
        kern.library = os.path.join(out_dir, f"lib{name}.so")
        kernels.append(kern)
    _build.build_all(kernels)
    return {k.name: k.library for k in kernels}
