"""Dry run of the parallel layer, and its multi-process worker.

``dryrun_multichip(n)`` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: over an n-block mesh it runs the
sharded render, one ``make_train_step``, one ``make_train_step_fast`` and
a 2-step ``make_train_scan_fast`` at that function's shapes (test01,
32x16, ``TraceConfig(max_segments=4, stack=2)``, K = 4).

The worker is one rank of a ``torch.distributed`` run over localhost,
started once per rank (each its own process: CUDA does not survive
``fork``):

    python -m quadray_tpu_torch.dryrun --rank 0 --world 2 --port 29512 \\
        --device cpu &
    python -m quadray_tpu_torch.dryrun --rank 1 --world 2 --port 29512 \\
        --device cpu

It joins the group through ``init_distributed`` (``--backend``, default
``init_distributed``'s: ``cpu:gloo,cuda:nccl`` where CUDA is visible,
gloo otherwise; NCCL takes one rank a card, so two ranks on one card
pass gloo), builds ``global_ray_mesh`` with one block a rank (on CUDA its
default: the rank's own card), and checks: an ``all_reduce``;
``assemble_frame``; the
sharded frame of test01 at 100x60 (3,000 rays a block for two ranks, not
a whole number of warps) bitwise the one-process ``render_cuda`` frame,
and the ranks' rows of it assembled bitwise too; one sharded fast train
step equal to the same step on an in-process mesh of as many blocks,
its loss, params and Adam's first moment (0.1 x the gradient after one
step), bitwise on the CPU and on the card (every sum of the step runs in
one fixed order: replay's backward and its row sums have no atomics; the
all-reduce of two ranks adds two terms, which commute); its params and
first moment equal on every rank. It prints
``OK rank i`` and
a JSON line of digests, and exits non-zero on any failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.trace import TraceConfig
from quadray_tpu_torch.parallel import train as tr
from quadray_tpu_torch.parallel.distributed import (
    assemble_frame, global_ray_mesh, init_distributed)
from quadray_tpu_torch.parallel.mesh import RayMesh, ray_mesh
from quadray_tpu_torch.parallel.render import (check_replicas,
                                               render_sharded_cuda)
from quadray_tpu_torch.scene.compile import compile_scene

# __graft_entry__.dryrun_multichip's shapes
WIDTH, HEIGHT, K_PATHS = 32, 16, 4
CFG = TraceConfig(max_segments=4, stack=2)
# the worker's frame
FRAME_W, FRAME_H = 100, 60


def _finite(name: str, x) -> None:
    if not bool(torch.isfinite(torch.as_tensor(x)).all()):
        raise RuntimeError(f"{name} is not finite")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The four runs of the JAX dry run over an ``n_devices``-block mesh
    (CUDA: every visible card in turn, blocks repeating where there are
    fewer cards; CPU: ``n_devices`` blocks on the host). Returns the
    losses; raises on a non-finite one or a frame of the wrong shape."""
    dev = torch.device(device)
    owners = ray_mesh().devices if dev.type == "cuda" else (dev,)
    mesh = ray_mesh([owners[i % len(owners)] for i in range(n_devices)])
    sc = compile_scene(load_scene("test01"), device=mesh.devices[0])

    img = render_sharded_cuda(sc, WIDTH, HEIGHT, mesh, cfg=CFG)
    if tuple(img.shape) != (HEIGHT, WIDTH, 3):
        raise RuntimeError(f"sharded frame of shape {tuple(img.shape)}")
    _finite("the sharded frame", img)
    target = torch.zeros((WIDTH * HEIGHT, 3), device=sc.device)

    step_fn, opt_init = tr.make_train_step(WIDTH, HEIGHT, cfg=CFG, mesh=mesh)
    params = tr.extract_params(sc)
    _, _, loss = step_fn(params, opt_init(params), sc, target)
    _finite("make_train_step's loss", loss)

    fstep, fopt_init = tr.make_train_step_fast(
        sc, WIDTH, HEIGHT, cfg=CFG, k_paths=K_PATHS, mesh=mesh)
    _, _, floss = fstep(params, fopt_init(params), sc, target)
    _finite("make_train_step_fast's loss", floss)

    run_fn, sopt_init = tr.make_train_scan_fast(
        sc, WIDTH, HEIGHT, cfg=CFG, k_paths=K_PATHS, mesh=mesh)
    _, _, slosses = run_fn(params, sopt_init(params), sc, target, 2)
    _finite("make_train_scan_fast's losses", slosses)
    print(f"dryrun_multichip({n_devices}): loss={float(loss):.6f} "
          f"fast_loss={float(floss):.6f} "
          f"scan_loss={float(slosses[-1]):.6f} OK", flush=True)
    return {"loss": float(loss), "fast_loss": float(floss),
            "scan_losses": [float(x) for x in slosses]}


def digest(t: torch.Tensor) -> str:
    """A short hex digest of a tensor's bytes."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def flat_params(params) -> torch.Tensor:
    """Every parameter flattened, in sorted field order."""
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


def train_task(device):
    """test01 with every surface moved by +0.05, its clean render the
    target (the recovery task of tests/test_torch_train.py)."""
    sc = compile_scene(load_scene("test01"), device=device)
    target = torch.clamp(ck.render_cuda(sc, WIDTH, HEIGHT, 1, CFG),
                         0.0, 1.0).reshape(-1, 3)
    return dataclasses.replace(sc, s_pos=sc.s_pos + 0.05), target


def worker(rank: int, world: int, port: int, device: str,
           backend: Optional[str] = None) -> dict:
    """One rank of the multi-process check (module docstring)."""
    os.environ["QUADRAY_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["QUADRAY_NUM_PROCESSES"] = str(world)
    os.environ["QUADRAY_PROCESS_ID"] = str(rank)
    if not init_distributed(backend):
        raise RuntimeError("init_distributed did not engage")
    if not init_distributed(backend):
        raise RuntimeError("init_distributed is not idempotent")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = global_ray_mesh(None if dev.type == "cuda" else [dev])
    if mesh.devices != (dev,) or mesh.size != world or mesh.rank != rank:
        raise RuntimeError(f"mesh of {mesh.size} blocks on "
                           f"{mesh.devices}, rank {mesh.rank}")

    x = mesh.all_reduce_sum(torch.arange(8, dtype=torch.float32,
                                         device=dev) + rank)
    want = torch.arange(8, dtype=torch.float32) * world \
        + world * (world - 1) / 2
    if x.device != dev or not torch.equal(x.cpu(), want):
        raise RuntimeError(f"all_reduce gave {x.tolist()}")
    asm = assemble_frame(torch.full((2, 3), float(rank), device=dev))
    if asm.shape != (2 * world, 3) or float(asm.sum()) != \
            3.0 * world * (world - 1):
        raise RuntimeError(f"assemble_frame gave {asm.tolist()}")

    sc = compile_scene(load_scene("test01"), device=dev)
    frame = render_sharded_cuda(sc, FRAME_W, FRAME_H, mesh)
    one = ck.render_cuda(sc, FRAME_W, FRAME_H)
    if not torch.equal(frame, one):
        raise RuntimeError("the sharded frame differs from render_cuda's")
    rows = FRAME_H // world
    asm = assemble_frame(frame[rank * rows:(rank + 1) * rows])
    if not np.array_equal(asm, one[:rows * world].cpu().numpy()):
        raise RuntimeError("the assembled frame differs from render_cuda's")

    sc_p, target = train_task(dev)
    p0 = tr.extract_params(sc_p)
    got = []
    for m in (mesh, RayMesh((dev,) * world)):
        step_fn, opt_init = tr.make_train_step_fast(
            sc_p, WIDTH, HEIGHT, cfg=CFG, k_paths=K_PATHS, mesh=m)
        params, state, loss = step_fn(p0, opt_init(p0), sc_p, target)
        got.append((loss, flat_params(params), flat_params(state.mu)))
    (loss, flat, mu), (l_local, f_local, mu_local) = got
    _finite("the sharded step's params", flat)
    same = (torch.equal(loss, l_local) and torch.equal(flat, f_local)
            and torch.equal(mu, mu_local))
    if not same:
        raise RuntimeError(f"the {world}-rank step differs from the "
                           f"in-process {world}-block step")
    every = mesh.all_gather_rows(torch.cat([flat, mu])[None, :])
    if not all(torch.equal(every[r], every[0]) for r in range(world)):
        raise RuntimeError("the ranks' params or moments differ after the "
                           "step")

    # a rank whose scene differs from rank 0's fails on every rank
    moved = dataclasses.replace(sc, s_pos=sc.s_pos + float(rank))
    try:
        check_replicas(moved, mesh)
    except RuntimeError as e:
        refused = str(e)
    else:
        refused = None
    if (refused is None) == (world > 1):
        raise RuntimeError(f"check_replicas on differing scenes: {refused}")
    out = {"rank": rank, "world": world,
           "backend": str(torch.distributed.get_backend()),
           "device": str(dev), "blocks": mesh.size,
           "all_reduce": x.tolist(), "frame": digest(frame),
           "params": digest(flat), "mu": digest(mu), "loss": float(loss),
           "bitwise_in_process": same, "refused": refused}
    print(f"OK rank {rank}: " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", choices=["cpu", "cuda"], required=True)
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="default: init_distributed's")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    worker(args.rank, args.world, args.port, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
