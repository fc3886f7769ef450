"""Multi-process distribution on ``torch.distributed`` (SURVEY.md §5.8).

The counterpart of ``quadray_tpu.parallel.distributed``. The reference is
single-process shared memory (pthread barriers, RooT_linux.cpp:547-630);
the JAX package scales out with ``jax.distributed``, one process a host.
Here a rank is one process with its own ray blocks (``parallel.mesh``);
the ranks meet through ``init_process_group`` over TCP.

Env-gated so single-process operation needs no configuration:

  QUADRAY_COORDINATOR=host:port   rendezvous address (rank 0 listens)
  QUADRAY_NUM_PROCESSES=N         world size
  QUADRAY_PROCESS_ID=i            this process's rank

``init_distributed()`` is a no-op without them; the helpers then behave
as in one process. Unless the caller names a backend, the group is
``cpu:gloo,cuda:nccl`` where CUDA is visible (a collective on the rank's
CUDA tensors goes through NCCL, one on CPU tensors through gloo) and gloo
otherwise; each rank is bound to its own card (``parallel.mesh``
``own_card``), which is also its default ray block. NCCL takes one rank
a card: two ranks on one card pass ``backend="gloo"``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from quadray_tpu_torch.parallel.mesh import RayMesh, own_card, ray_mesh


def init_distributed(backend: Optional[str] = None) -> bool:
    """Join the process group from the QUADRAY_* env (no-op returning
    False without them; True, and nothing more, once joined) and make
    this rank's own card the current device where CUDA is visible.
    Raises where the rendezvous fails."""
    coord = os.environ.get("QUADRAY_COORDINATOR")
    if not coord:
        return False
    if dist.is_initialized():
        return True
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl" if cuda and dist.is_nccl_available()
                   else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}",
        world_size=int(os.environ["QUADRAY_NUM_PROCESSES"]),
        rank=int(os.environ["QUADRAY_PROCESS_ID"]))
    if cuda:
        torch.cuda.set_device(own_card(torch.cuda.device_count()))
    return True


def global_ray_mesh(devices=None):
    """The mesh over every rank's blocks: this rank's ``devices`` (when
    None, ``ray_mesh``'s default: this rank's own card) over the default
    process group, each rank holding as many; single-process, just
    ``ray_mesh``. Torch has no global device list, so each rank names its
    own devices."""
    return ray_mesh(devices)


def assemble_frame(img) -> np.ndarray:
    """Host frame assembly: every rank's piece (equal shapes) concatenated
    along the first axis in rank order, as numpy on every rank (the
    JAX ``process_allgather(tiled=True)``); single-process, a copy to the
    host."""
    img = torch.as_tensor(img)
    if dist.is_initialized() and dist.get_world_size() > 1:
        img = RayMesh((img.device,), dist.group.WORLD).all_gather_rows(img)
    return img.detach().cpu().numpy()


def scaling_report(render_fn: Callable[[object], object],
                   device_counts: Optional[List[int]] = None,
                   frames: int = 3, devices=None) -> Dict:
    """Scaling harness: time ``render_fn(mesh)`` over meshes of growing
    block count, best of ``frames`` after a warm-up, and report speedup
    and parallel efficiency against the smallest mesh. ``devices`` are
    the blocks' owners in order (default: every visible CUDA device;
    they may repeat, for blocks on one card, which measure the cost of
    sharding and not scaling). render_fn must wait for its frame."""
    devs = list(ray_mesh(devices).devices)
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devs)]
    if max(device_counts) > len(devs):
        raise ValueError(f"scaling_report: {max(device_counts)} blocks "
                         f"asked of {len(devs)} devices")
    rows = []
    for n in device_counts:
        mesh = ray_mesh(devs[:n])
        render_fn(mesh)  # warm-up
        best = float("inf")
        for _ in range(frames):
            t0 = time.perf_counter()
            render_fn(mesh)
            best = min(best, time.perf_counter() - t0)
        rows.append({"devices": n, "seconds_per_frame": best})
    base = rows[0]
    for r in rows:
        speedup = base["seconds_per_frame"] / r["seconds_per_frame"]
        r["speedup"] = speedup
        r["efficiency"] = speedup * base["devices"] / r["devices"]
    kind = (torch.cuda.get_device_name(devs[0]) if devs[0].type == "cuda"
            else devs[0].type)
    return {"process_count": dist.get_world_size()
            if dist.is_initialized() else 1,
            "device_kind": kind, "rows": rows}
