"""The ray mesh: contiguous ray blocks over devices and processes.

The counterpart of ``quadray_tpu.parallel.mesh``. The reference scales
with a pthread pool over scanlines on one node (RooT_linux.cpp:547-630);
the JAX package's scale axis is a ``Mesh`` over the flat ray dimension,
each device owning a contiguous ray block, the scene replicated, the frame
gathered (SURVEY.md §2.7, §5.8). Here the mesh is ``RayMesh``: this
process's block owners (a list of ``torch.device``s, which may repeat:
four blocks on ``cuda:0``, or N blocks on ``cpu``, the counterpart of
JAX's forced-host-device CPU mesh) and the ``torch.distributed`` process
group the other ranks' blocks live in. Blocks are contiguous in the global
ray order: rank-major, then local device. Every rank holds the same
number of blocks. ``all_gather_rows`` and ``all_reduce_sum`` are the
mesh's two collectives (the JAX ``shard_map`` gather and ``pmean``'s
sum); with no group they return their input. Gloo takes CPU and CUDA
tensors, NCCL CUDA tensors on the rank's own card only.

A rank's default devices are its own card: under an initialised process
group, the visible card at the rank modulo the card count (one rank a
card, ranks numbered host by host), the card ``init_distributed`` makes
the current device; in a single process, every visible card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """``devices``: this process's ray-block owners, in block order;
    ``group``: the process group of every rank's blocks, or None for a
    single process."""
    devices: Tuple[torch.device, ...]
    group: Optional[object] = None

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def size(self) -> int:
        """Ray blocks over every rank (the JAX ``mesh.devices.size``)."""
        return len(self.devices) * self.world

    def blocks(self, npad: int):
        """(device, first row, last row) of each of this process's blocks
        of ``npad`` rays (a multiple of ``size``)."""
        m = npad // self.size
        first = self.rank * len(self.devices)
        return [(d, (first + i) * m, (first + i + 1) * m)
                for i, d in enumerate(self.devices)]

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` where the group's backend takes it: on its own
        device for gloo (CPU or CUDA tensors), on this rank's card (the
        current device) for NCCL; a ``cpu:gloo,cuda:nccl`` group sends
        CPU tensors through gloo and CUDA tensors through NCCL."""
        backend = dist.get_backend(self.group)
        nccl = backend == "nccl" or (t.is_cuda and "cuda:nccl" in backend)
        dev = (torch.device("cuda", torch.cuda.current_device()) if nccl
               else t.device)
        return t.detach().to(dev, copy=True).contiguous()

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along dim 0 in
        rank order, on ``t``'s device."""
        if self.group is None:
            return t
        x = self._staged(t)
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts).to(t.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, on ``t``'s device."""
        if self.group is None:
            return t
        x = self._staged(t)
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x.to(t.device)


def own_card(n_cards: int) -> int:
    """This rank's card among ``n_cards`` visible ones: the rank modulo
    the count under an initialised process group, else 0."""
    return dist.get_rank() % n_cards if dist.is_initialized() else 0


def default_devices() -> Tuple[torch.device, ...]:
    """This process's default block owners: its own card under an
    initialised process group, every visible card in a single process.
    Raises where no CUDA device is visible (never the CPU by default)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "ray_mesh: no CUDA device is visible; pass devices, for "
            "example [torch.device('cpu')] * 8, to run on the CPU")
    if dist.is_initialized():
        return (torch.device("cuda", own_card(n)),)
    return tuple(torch.device("cuda", i) for i in range(n))


def ray_mesh(devices=None) -> RayMesh:
    """A mesh of one ray block per entry of ``devices`` (default:
    ``default_devices()``; a caller asks for the CPU by passing CPU
    devices), over the default process group when ``torch.distributed``
    is initialised. Raises where no CUDA device is visible and none was
    named, and where the ranks hold different block counts."""
    if devices is None:
        devices = default_devices()
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("ray_mesh: no devices")
    group = dist.group.WORLD if dist.is_initialized() else None
    mesh = RayMesh(devices, group)
    if group is not None:
        # equal counts iff world * sum(n^2) == sum(n)^2
        n = len(devices)
        s1, s2 = (int(v) for v in mesh.all_reduce_sum(
            torch.tensor([n, n * n], dtype=torch.int64)))
        if mesh.world * s2 != s1 * s1:
            raise ValueError(f"ray_mesh: the ranks hold different block "
                             f"counts ({s1} blocks over {mesh.world} "
                             f"ranks, {n} here)")
    return mesh


def pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult
