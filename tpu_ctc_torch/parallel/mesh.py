"""The device mesh over the ranks of a ``torch.distributed`` process group.

Counterpart of ``tpu_ctc.parallel.mesh``.  The JAX package builds one
logical ``jax.sharding.Mesh`` with the named axes ``('data', 'model',
'seq')`` and lets the compiler insert the collectives; here each rank is
one process on one card, the mesh is the same (data, model, seq) grid of
ranks, and the collectives are explicit calls on a process group for each
line of an axis:

  * ``data``: utterance-batch data parallelism; gradients all-reduce here;
  * ``model``: tensor parallelism (``parallel.tensor_parallel``) or, with
    ``mesh.pipeline``, the stages of pipeline parallelism
    (``parallel.pipeline``);
  * ``seq``: time-axis sequence parallelism (the BiRNN carry rings).

Ranks fill the grid data-major, as ``np.asarray(devices).reshape(shape)``
orders the JAX mesh's devices, so the ranks of one ``seq`` line are
neighbours (one node under torchrun) and the ``data`` axis is the one that
crosses nodes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_ctc_torch.config import MeshConfig

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
MESH_AXES = (AXIS_DATA, AXIS_MODEL, AXIS_SEQ)


def world() -> Tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def resolve_mesh_shape(cfg: MeshConfig, n_devices: Optional[int] = None):
    """Resolve (data, model, seq) sizes; a single -1 absorbs leftover devices."""
    if n_devices is None:
        n_devices = world()[0]
    sizes = [cfg.data, cfg.model, cfg.seq]
    n_auto = sum(1 for s in sizes if s == -1)
    if n_auto > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {cfg}")
    fixed = math.prod(s for s in sizes if s != -1)
    if n_auto == 1:
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes {fixed}")
        sizes = [n_devices // fixed if s == -1 else s for s in sizes]
    elif fixed != n_devices:
        raise ValueError(f"mesh {sizes} does not cover {n_devices} devices")
    return tuple(sizes)


@dataclasses.dataclass
class Mesh:
    """The (data, model, seq) grid of ranks as seen from one rank.

    ``shape`` maps each axis to its size (``dict(jax_mesh.shape)``);
    ``lines`` maps an axis to the global ranks of this rank's line along
    it, in axis order, and ``groups`` to that line's process group (absent
    for an axis of size 1).  A mesh built by hand from a shape alone (no
    groups) serves the step's configuration checks."""
    shape: Dict[str, int]
    rank: int = 0
    lines: Dict[str, Tuple[int, ...]] = dataclasses.field(default_factory=dict)
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        line = self.lines.get(axis)
        return line.index(self.rank) if line else 0

    def group(self, axis: str):
        return self.groups.get(axis)


def make_mesh(cfg: MeshConfig = MeshConfig()) -> Mesh:
    """The mesh of ``cfg`` over the default process group (one rank without
    one).  Every rank must call it, in the same order as its other group
    constructions: it makes one ``dist.new_group`` per line of each axis
    of size > 1, axis by axis in the order data, model, seq."""
    n, rank = world()
    shape = resolve_mesh_shape(cfg, n)
    grid = np.arange(n).reshape(shape)
    mesh = Mesh(dict(zip(MESH_AXES, shape)), rank)
    coord = tuple(int(c[0]) for c in np.nonzero(grid == rank))
    for a, axis in enumerate(MESH_AXES):
        # every line along the axis: the grid with that axis moved last
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        mine = tuple(int(r) for r in grid[coord[:a] + (slice(None),)
                                          + coord[a + 1:]])
        mesh.lines[axis] = mine
        if len(mine) == 1:
            continue
        for line in lines:
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks)
            if tuple(ranks) == mine:
                mesh.groups[axis] = group
    return mesh


def shard_batch(mesh: Mesh, arrays: Dict[str, np.ndarray],
                specs: Dict[str, tuple]) -> Dict[str, np.ndarray]:
    """This rank's block of each array of a global batch: ``specs[k][i]``
    names the mesh axis that dimension i of ``arrays[k]`` is split over
    (equal blocks, in axis order), or None.  A dimension that an axis does
    not divide raises."""
    out = {}
    for k, x in arrays.items():
        idx = []
        for dim, axis in enumerate(specs.get(k, ())):
            n = 1 if axis is None else mesh.axis_size(axis)
            if n == 1:
                idx.append(slice(None))
                continue
            if x.shape[dim] % n:
                raise ValueError(f"batch {k!r} dimension {dim} of size "
                                 f"{x.shape[dim]} does not split over "
                                 f"{axis}={n}")
            per = x.shape[dim] // n
            i = mesh.axis_index(axis)
            idx.append(slice(i * per, (i + 1) * per))
        out[k] = x[tuple(idx)]
    return out


def gather_blocks(mesh: Mesh, x, axis: str, dim: int):
    """The blocks of ``x`` along dimension ``dim`` from every rank of this
    rank's ``axis`` line, in axis order (the inverse of
    :func:`shard_batch`): one all-reduce of the zero-padded whole, exact
    for any dtype the backend sums.  Not differentiable."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if n == 1:
        return x
    t = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * t
    full = x.new_zeros(shape)
    full.narrow(dim, i * t, t).copy_(x)
    dist.all_reduce(full, group=mesh.group(axis))
    return full


def shift(x: torch.Tensor, mesh: Mesh, axis: str, forward: bool = True,
          ring: bool = False) -> torch.Tensor:
    """Every rank of this rank's ``axis`` line hands ``x`` to the next rank
    (``forward``) or the previous one and gets what its neighbour handed
    it: around the line's ring when ``ring``, else zeros at its end (JAX's
    ``ppermute`` over the pairs (i, i + 1)).  Every rank of the line calls
    it.  NCCL's ``batch_isend_irecv`` between cards; on gloo (the CPU, or
    ranks sharing one card) an all-reduce of an [n, ...] buffer in which
    each rank fills its own row (a sum with zeros is exact)."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    group, line = mesh.group(axis), mesh.lines[axis]
    step = 1 if forward else -1
    src, dst = i - step, i + step
    if ring:
        src, dst = src % n, dst % n
    if dist.get_backend(group) == "nccl":
        got = torch.zeros_like(x)
        ops = []
        if 0 <= dst < n:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), line[dst],
                                  group))
        if 0 <= src < n:
            ops.append(dist.P2POp(dist.irecv, got, line[src], group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[i] = x
    dist.all_reduce(buf, group=group)
    return buf[src] if 0 <= src < n else torch.zeros_like(x)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable as
    :class:`ReplicatedSum`."""
    return ReplicatedSum.apply(x, group)


class ReplicatedSum(torch.autograd.Function):
    """Sum over a group whose every rank goes on to compute the same loss:
    the backward is the identity (each rank's parameter gradients are then
    summed by the step, so the sum's cotangent must count once)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None
