"""ctypes wrapper for the native C++ prefix beam-search decoder.

Counterpart of ``tpu_ctc.decode.cpp_decoder``.  ``cpp/ctc_beam.cpp`` is
the repository's native host decoder: the exact dict-based algorithm of
:func:`tpu_ctc_torch.decode.beam.prefix_beam_search_host`, summing in
double, with an n-gram LM of order <= 3.  It is a third oracle beside the
plain search and kernels B5/B6, and the compiled host decoder that the
decode bench measures the card against.

:func:`build` compiles it with ``g++`` and ``cpp/Makefile``'s flags into
``build/tpu_ctc_torch/libctcbeam.so`` (``build/`` is git-ignored); nothing
is written under ``cpp/``, whose own library belongs to the JAX package's
wrapper.  Each build writes a file of its own in the build directory and
renames it over the library, so processes that build at once (test
workers, ranks) each load a whole file.  A library older than its source
is rebuilt.  Nothing falls back: when the build fails,
:func:`beam_search_batch` raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from tpu_ctc_torch.decode.lm import NGramCharLM

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "cpp", "ctc_beam.cpp")
LIBRARY = os.path.join(_ROOT, "build", "tpu_ctc_torch", "libctcbeam.so")
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall"]
_lib = None


def _fresh() -> bool:
    return (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE))


def build(force: bool = False) -> str:
    """Compile the library unless it is fresh (or ``force``); returns the
    compiler's output and raises ``RuntimeError`` with it on failure."""
    if _fresh() and not force:
        return ""
    directory = os.path.dirname(LIBRARY)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=directory)
    os.close(fd)
    try:
        out = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared", "-o", tmp,
             SOURCE], capture_output=True, text=True)
    except OSError as e:
        os.remove(tmp)
        raise RuntimeError(f"libctcbeam build failed: {e}") from e
    if out.returncode != 0:
        os.remove(tmp)
        raise RuntimeError(f"libctcbeam build failed (exit "
                           f"{out.returncode}):\n{out.stdout}{out.stderr}")
    os.replace(tmp, LIBRARY)
    return out.stdout + out.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(LIBRARY)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.ctc_beam_search_batch.restype = ctypes.c_int
    lib.ctc_beam_search_batch.argtypes = [
        f32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, f32p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, i32p, i32p, f32p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads (a failed build raises in
    :func:`beam_search_batch`)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def beam_search_batch(log_probs: np.ndarray,
                      lengths: np.ndarray,
                      beam_width: int = 64,
                      blank: int = 0,
                      lm: Optional[NGramCharLM] = None,
                      lm_alpha: float = 1.0,
                      lm_beta: float = 0.0,
                      max_len: int = 128
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode a [B, T, A] batch on the host with the native decoder.

    Returns (hyps [B, max_len] int32, lens [B] int32, scores [B] f32).
    ``lm_beta`` is added to every extension, with or without ``lm``, as
    the C++ source does.
    """
    lib = _load()
    log_probs = np.ascontiguousarray(log_probs, dtype=np.float32)
    if log_probs.ndim != 3:
        raise ValueError(f"log_probs must be [B, T, A], got "
                         f"{log_probs.shape}")
    b, t, a = log_probs.shape
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    if lengths.shape != (b,) or lengths.min(initial=0) < 0 \
            or lengths.max(initial=0) > t:
        raise ValueError(f"lengths {lengths} for log_probs of shape "
                         f"{log_probs.shape}")
    out_ids = np.zeros((b, max_len), dtype=np.int32)
    out_lens = np.zeros(b, dtype=np.int32)
    out_scores = np.zeros(b, dtype=np.float32)
    table = None
    if lm is not None:
        table = np.ascontiguousarray(lm.logp, dtype=np.float32)
        if table.size != a ** lm.order:
            raise ValueError(f"LM table of {table.size} entries for order "
                             f"{lm.order} and vocab {a}")
        table_p = table.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        order = lm.order
    else:
        table_p, order = None, 0
    rc = lib.ctc_beam_search_batch(
        log_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        b, t, a, beam_width, blank, table_p, order,
        ctypes.c_float(lm_alpha), ctypes.c_float(lm_beta), max_len,
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"ctc_beam_search_batch failed with code {rc}")
    return out_ids, out_lens, out_scores


def beam_search(log_probs: np.ndarray, **kw) -> Tuple[List[int], float]:
    """Single-utterance convenience wrapper."""
    hyps, lens, scores = beam_search_batch(
        log_probs[None], np.array([log_probs.shape[0]], np.int32), **kw)
    return list(hyps[0][: lens[0]]), float(scores[0])
