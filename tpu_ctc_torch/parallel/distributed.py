"""Process-group bring-up, this rank's share of a batch, and a cross-rank
check.

Counterpart of ``tpu_ctc.parallel.distributed``.  JAX brings up one
process per host and lets the compiler drive the host's chips; here every
card is a rank of its own (one process each, as ``torchrun
--nproc-per-node`` starts them), joined by ``torch.distributed``: NCCL
between cards, gloo on the CPU.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from tpu_ctc_torch import resolve_device
from tpu_ctc_torch.config import MeshConfig
from tpu_ctc_torch.parallel.mesh import Mesh, make_mesh, world


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               backend: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.

    Without arguments the group comes from torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``); ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id`` give it explicitly.  The device
    is ``device`` (default ``cuda``); a CUDA device without an index
    becomes ``cuda:LOCAL_RANK`` and is made current before anything else
    touches the card.  The backend is NCCL for a CUDA device and gloo on
    the CPU unless ``backend`` names one.  Idempotent; a single process
    with no coordinator and no ``WORLD_SIZE`` joins no group."""
    dev = resolve_device(device)
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda",
                               int(os.environ.get("LOCAL_RANK", process_id)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if coordinator_address is None and "WORLD_SIZE" not in os.environ:
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=(f"tcp://{coordinator_address}"
                              if coordinator_address else "env://"),
        world_size=num_processes, rank=process_id,
        device_id=dev if backend == "nccl" else None)
    return dev


def hybrid_mesh(cfg: MeshConfig) -> Mesh:
    """The mesh whose ``data`` axis crosses nodes and whose ``seq`` lines
    stay within one.  torchrun numbers ranks node-major (node 0's
    ``nproc-per-node`` ranks first) and :func:`make_mesh` fills the grid
    data-major, so when ``seq`` divides the ranks of a node this is
    :func:`make_mesh`'s own order."""
    return make_mesh(cfg)


def local_batch_slice(global_batch: int) -> slice:
    """This rank's slice of a global batch (uniform split over ranks)."""
    n, i = world()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} ranks")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def assert_same_across_hosts(value: float, tag: str = "") -> None:
    """Debug guard: raise unless a host-computed scalar is the same on
    every rank (one all-reduce of the value)."""
    n, _ = world()
    if n == 1:
        return
    x = torch.tensor([value], dtype=torch.float64, device=(
        torch.cuda.current_device() if dist.get_backend() == "nccl"
        else "cpu"))          # NCCL sums on the card, gloo on the host
    dist.all_reduce(x)
    total, expected = float(x[0]), value * n
    if abs(total - expected) > 1e-6 * max(abs(expected), 1.0):
        raise AssertionError(
            f"cross-rank divergence in {tag}: local={value} sum={total}")
