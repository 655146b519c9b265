"""Checkpoints of the full train state, and the npz weight bridge.

:func:`save` and :func:`restore` keep the whole training state (params,
the optimizer's trace and count, the step, and the data cursor: epoch and
batch) with ``torch.save`` as ``<dir>/step_<N>.pt``, the newest
``keep`` files kept: a preempted run resumes where it stopped, as the JAX
package's orbax checkpoints do.  Orbax checkpoints are not read here.

``tpu_ctc.train.checkpoint.export_npz`` (and ``python -m tpu_ctc.cli
export-weights``) writes the parameter tree as one npz with '/'-joined
keys: ``pre/0/w``, ``bi/2/wf``, ``out/b``.  The port's
``models.birnn.BiRNN`` names the same leaves with '.' (``pre.0.w``), in the
same layouts, so the map is a key rename.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_CKPT = re.compile(r"step_(\d+)\.pt$")


def _steps(directory: str):
    """Sorted (step, path) of the checkpoints in ``directory``."""
    found = []
    for path in glob.glob(os.path.join(directory, "step_*.pt")):
        m = _CKPT.search(os.path.basename(path))
        if m:
            found.append((int(m.group(1)), path))
    return sorted(found)


def save(directory: str, state, epoch: int, batch_cursor: int,
         keep: int = 3) -> Optional[str]:
    """Write ``state`` (a ``train.step.TrainState``) and the data cursor;
    returns the path, or None when this step is on disk already (a resume
    that made no new steps).  Older files beyond ``keep`` are removed."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{state.step:08d}.pt")
    if os.path.exists(path):
        return None
    payload = {
        "params": {k: v.detach().cpu()
                   for k, v in state.model.state_dict().items()},
        "trace": {k: v.cpu() for k, v in state.opt_state.trace.items()},
        "count": int(state.opt_state.count),
        "step": int(state.step),
        "epoch": int(epoch),
        "batch": int(batch_cursor),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for _, old in _steps(directory)[:-keep] if keep > 0 else []:
        os.remove(old)
    return path


def restore(directory: str, state) -> Optional[Tuple[object, int, int]]:
    """Load the newest checkpoint of ``directory`` into ``state`` (its
    model and trace tensors are overwritten in place, on their devices);
    returns (state, epoch, batch), or None when there is none."""
    found = _steps(directory)
    if not found:
        return None
    payload = torch.load(found[-1][1], map_location="cpu", weights_only=True)
    with torch.no_grad():
        for key, val in state.model.state_dict().items():
            val.copy_(payload["params"][key])
        for key, val in state.opt_state.trace.items():
            val.copy_(payload["trace"][key])
    state.opt_state.count = payload["count"]
    state.step = payload["step"]
    return state, payload["epoch"], payload["batch"]


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat '/'-keyed arrays -> a ``BiRNN`` state dict ('.'-keyed)."""
    return {key.replace("/", "."): torch.from_numpy(np.array(arr))
            for key, arr in flat.items()}


def load_npz(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load an ``export_npz`` file into ``model`` in place (every key must
    match, shapes are checked by ``load_state_dict``)."""
    with np.load(path) as data:
        state = params_from_jax({k: data[k] for k in data.files})
    want = model.state_dict()
    for key, val in state.items():
        if key in want and tuple(val.shape) != tuple(want[key].shape):
            raise ValueError(f"shape mismatch for {key!r}: file "
                             f"{tuple(val.shape)} vs model "
                             f"{tuple(want[key].shape)}")
    model.load_state_dict(state, strict=True)
    return model


def export_npz(model: torch.nn.Module, path: str) -> int:
    """Write ``model``'s parameters with the JAX export's '/'-joined keys;
    returns the number of arrays written."""
    flat = {key.replace(".", "/"): val.detach().cpu().numpy()
            for key, val in sorted(model.state_dict().items())}
    np.savez(path, **flat)
    return len(flat)
