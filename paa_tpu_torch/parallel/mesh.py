"""Meshes of ranks for the attack's parallel axes, over ``torch.distributed``.

Port of ``paa_tpu/parallel/mesh.py``. The JAX package lays its devices out
as a ``jax.sharding.Mesh`` and lets XLA insert the collectives; here the
program is SPMD, one process per rank, started by ``torchrun``
(``python -m torch.distributed.run``), and a :class:`Mesh` lays the world's
ranks out the same way:

  * ``("data",)`` — the batch split over every rank (:func:`data_mesh`);
  * ``("data", "model")`` — dp × Megatron tp, ``model`` the minor axis, so
    rank ``r`` sits at ``(r // tp, r % tp)`` (:func:`tp_mesh`);
  * ``("sweep", "data")`` — one ε cell per sweep slice, its batch split over
    the slice's data axis (:func:`sweep_mesh`).

Each rank keeps its coordinate on every axis and one process group per axis
slice that holds it. :func:`decide_mesh` is the one home of the run-level
choice and of its flag-named errors, word for word the reference's.

Without a process group (one process, or a test of the layouts alone) a
mesh is its layout: rank 0's coordinates and no groups; a collective over
an axis longer than 1 then raises.

**Backend rule.** :func:`init_process_group` joins the group that
``torchrun``'s environment describes with ``nccl`` when every rank of the
node has a card of its own, and with ``gloo`` on the CPU or when ranks
share a card (NCCL refuses two ranks on one device; gloo all-reduces and
broadcasts CUDA tensors through the host). The choice is logged once.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("paa_tpu")


def world_size() -> int:
    """The number of ranks: the process group's, else ``torchrun``'s
    ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    """This process's rank in the world: the process group's, else
    ``torchrun``'s ``RANK``, else 0."""
    return dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", "0"))


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0 only."""
    return rank() == 0


def backend_for(device: torch.device) -> str:
    """``nccl`` when every rank of the node has a card of its own, ``gloo``
    on the CPU or when ranks share a card."""
    if device.type != "cuda":
        return "gloo"
    ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if ranks_here <= torch.cuda.device_count() else "gloo"


def init_process_group(device: torch.device, timeout_s: float = 600.0) -> bool:
    """Join the process group ``torchrun`` started this process in, once.

    Reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` from
    the environment; ``timeout_s`` bounds the rendezvous and every
    collective. Returns whether the run has more than one rank; with one
    (no ``torchrun``) it does nothing."""
    if world_size() <= 1:
        return False
    if not dist.is_initialized():
        backend = backend_for(device)
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
        if dist.get_rank() == 0:
            logger.info("torch.distributed: %d ranks over %s on %s", dist.get_world_size(),
                        backend, device.type)
    return True


def _comm_device() -> torch.device:
    """Where a collective's own buffers live: NCCL takes CUDA tensors only."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes in the reference's order, this rank's
    coordinate on each axis and the process group of its slice along each
    axis (None for an axis of size 1, and for every axis of a layout)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    coords: dict
    groups: dict

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def group(self, axis: str):
        if self.shape[axis] > 1 and self.groups[axis] is None:
            raise RuntimeError(f"the mesh {self.shape} has no process group: it is a layout only")
        return self.groups[axis]

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` over ``axis`` in place (every rank of the slice gets the
        same bits) and return it; identity on an axis of size 1."""
        if self.shape.get(axis, 1) > 1:
            dist.all_reduce(t, group=self.group(axis))
        return t

    def broadcast(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` of the first rank of this rank's slice along ``axis``, in
        place; identity on an axis of size 1."""
        if self.shape.get(axis, 1) > 1:
            group = self.group(axis)
            dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return t

    def gather_rows(self, local: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """The rows of every rank on ``axis`` in global order: an all-reduce
        of a zero-filled buffer that holds this rank's rows (gloo has no
        all-gather of CUDA tensors)."""
        n = self.shape.get(axis, 1)
        if n == 1:
            return local
        b = local.shape[0]
        out = local.new_zeros((n * b,) + tuple(local.shape[1:]))
        out[self.coords[axis] * b:(self.coords[axis] + 1) * b] = local
        return self.all_reduce(out, axis)


def _mesh(axis_names: tuple[str, ...], sizes: tuple[int, ...]) -> Mesh:
    """The mesh over every rank of the world, its groups made (a collective
    call: every rank builds the same meshes in the same order)."""
    n = math.prod(sizes)
    if not dist.is_initialized():
        return Mesh(axis_names, sizes, {a: 0 for a in axis_names}, {a: None for a in axis_names})
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks needs a world of {n} ranks, "
                         f"have {dist.get_world_size()}")
    me = dist.get_rank()
    ranks = np.arange(n).reshape(sizes)
    coords = {a: int(c) for a, c in zip(axis_names, np.unravel_index(me, sizes))}
    groups = {}
    for i, axis in enumerate(axis_names):
        groups[axis] = None
        if sizes[i] == 1:
            continue
        # every slice along this axis, in rank order; new_group is collective
        for members in np.moveaxis(ranks, i, -1).reshape(-1, sizes[i]).tolist():
            group = dist.new_group(members)
            if me in members:
                groups[axis] = group
    return Mesh(axis_names, sizes, coords, groups)


def data_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over ``data`` (pure data-parallel attack step)."""
    return _mesh(("data",), (n_devices or world_size(),))


def tp_mesh(n_model: int, n_devices: int | None = None) -> Mesh:
    """2-D ``(data, model)`` mesh: batch data-parallel × Megatron tensor
    parallelism over the encoder (parallel/tp.py). ``n_model`` must divide
    the device count; the remainder becomes the data axis. ``model`` is the
    minor axis: the ranks of one model slice are neighbours."""
    n = n_devices or world_size()
    if n % n_model != 0:
        raise ValueError(f"n_model={n_model} must divide device count {n}")
    return _mesh(("data", "model"), (n // n_model, n_model))


def decide_mesh(tp: int, batch_size: int, n_devices: int | None = None) -> Mesh | None:
    """The mesh a single attack run will use, and the one error site of the
    run-level divisibility checks: ``tp > 1`` → the ``(data, model)`` mesh;
    otherwise every rank on the ``data`` axis when the batch divides over
    them; else ``None``, and every rank runs the one-device step on the
    whole batch."""
    n = n_devices or world_size()
    if tp > 1:
        if n % tp:
            raise ValueError(f"--tp {tp} must divide the device count {n}")
        n_data = n // tp
        if n_data > 1 and batch_size % n_data:
            raise ValueError(
                f"batch_size {batch_size} must divide over the data axis "
                f"({n_data} = {n} devices / tp {tp})"
            )
        return tp_mesh(tp, n_devices=n)
    if n > 1 and batch_size % n == 0:
        return data_mesh(n_devices=n)
    return None


def sweep_mesh(n_sweep: int, n_devices: int | None = None) -> Mesh:
    """2-D ``(sweep, data)`` mesh. ``n_sweep`` must divide the device count;
    the remainder becomes the data axis (``n_sweep`` = ranks, data = 1 is
    one cell per card, the reference's one job per GPU)."""
    n = n_devices or world_size()
    if n % n_sweep != 0:
        raise ValueError(f"n_sweep={n_sweep} must divide device count {n}")
    return _mesh(("sweep", "data"), (n_sweep, n // n_sweep))


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` from world rank ``src`` on every rank, in place; identity with
    one rank."""
    if world_size() > 1:
        dist.broadcast(t, src=src)
    return t


def agree(values) -> list[float]:
    """Rank 0's ``values`` (floats) on every rank: the decisions that gate a
    collective (early stop, the best epoch) then take the same branch on
    every rank even where ranks computed them apart."""
    if world_size() <= 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=_comm_device())
    dist.broadcast(t, src=0)
    return t.tolist()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()
