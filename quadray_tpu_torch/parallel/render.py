"""Sharded rendering over the ray mesh.

The counterpart of ``quadray_tpu.parallel.render``, which replaces the
reference's scanline-interleaved thread pool (engine.cpp:3458-3477,
tracer.cpp:1142-1151): the camera rays are made once, padded to a
multiple of the mesh's block count with ``dirs = 1``, and split in
contiguous blocks; the scene is replicated, one copy a distinct device;
each block is traced to completion on its own device (no synchronisation
between blocks per bounce); the blocks are gathered, across ranks too,
clipped to the ``n`` real rays and averaged over the AA sub-samples.

  * ``render_sharded``: the plain tracers per block (``ops.trace``
    ``trace_rays``, or ``trace_rays_diff`` when ``differentiable``), as
    the JAX function runs jnp.
  * ``render_sharded_cuda``: one Whitted kernel launch a block
    (``ops.cuda_kernel.trace_rays_cuda``), the counterpart of
    ``render_sharded_pallas``; each device's replica is packed once,
    through ``_get_packed``'s cache. CPU blocks take the plain tracer, as
    ``trace_rays_cuda`` does.

Rays are independent and culling changes no bit, so a sharded frame is
bitwise the unsharded one for any block count. Where the mesh spans
ranks, each compiles its own scene; a digest of every field is gathered
each call and a rank whose scene differs from rank 0's raises.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.rays import camera_rays, resolve_aa
from quadray_tpu_torch.ops.trace import (TraceConfig, trace_rays,
                                         trace_rays_diff)
from quadray_tpu_torch.parallel.mesh import RayMesh, pad_to
from quadray_tpu_torch.scene.compile import FIELDS, SceneArrays


def _digest(sc: SceneArrays) -> int:
    h = hashlib.sha256()
    for k in FIELDS:
        a = np.ascontiguousarray(getattr(sc, k).detach().cpu().numpy())
        h.update(f"{k}{a.dtype}{a.shape}".encode() + a.tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


# a replica of the scene on each block's device (the scene's own device
# takes the scene itself), and the scene's digest, per scene object
replica = ck._SceneCache(lambda sc, dev: sc if sc.device == dev
                         else sc.to(dev), FIELDS)
_scene_digest = ck._SceneCache(_digest, FIELDS)


def check_replicas(sc: SceneArrays, mesh: RayMesh) -> None:
    """Raises unless every rank of the mesh holds the same scene (a digest
    of every field, gathered; a collective, so every rank calls it)."""
    if mesh.group is None:
        return
    mine = torch.tensor([_scene_digest(sc)], dtype=torch.int64)
    every = mesh.all_gather_rows(mine)
    bad = [r for r in range(mesh.world) if int(every[r]) != int(every[0])]
    if bad:
        raise RuntimeError(f"the scene of rank(s) {bad} differs from rank "
                           "0's: each rank must compile the same scene")


def sharded_rays(sc: SceneArrays, width: int, height: int, fsaa: int,
                 blocks: int):
    """The camera rays as the sharded paths take them: (org (3,), dirs
    (npad, 3), t_min (npad,), n), padded to a multiple of ``blocks`` with
    ``dirs = 1``; t_min is the camera's pov distance."""
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, width, height, fsaa)
    n = dirs.shape[0]
    npad = pad_to(n, blocks)
    if npad != n:
        dirs = torch.cat([dirs, torch.ones((npad - n, 3), dtype=dirs.dtype,
                                           device=dirs.device)])
    return org, dirs, sc.cam_pov.expand(npad), n


def _sharded_trace(trace, sc: SceneArrays, org, dirs, t_min, mesh: RayMesh):
    """``trace(sc, org, dirs, t_min)`` on each of this process's blocks on
    the block's device; every rank's blocks gathered in ray order onto
    the scene's device."""
    outs = []
    for dev, a, b in mesh.blocks(dirs.shape[0]):
        cols = trace(replica(sc, dev), org.to(dev), dirs[a:b].to(dev),
                     t_min[a:b].to(dev))
        outs.append(cols.to(sc.device))
    return mesh.all_gather_rows(torch.cat(outs))


def _render(trace, sc, width, height, mesh, fsaa):
    check_replicas(sc, mesh)
    org, dirs, t_min, n = sharded_rays(sc, width, height, fsaa, mesh.size)
    cols = _sharded_trace(trace, sc, org, dirs, t_min, mesh)
    return resolve_aa(torch.clamp(cols[:n], 0.0, 1.0), width, height, fsaa)


def render_sharded(sc: SceneArrays, width: int, height: int, mesh: RayMesh,
                   fsaa: int = 1, cfg: TraceConfig = TraceConfig(),
                   differentiable: bool = False):
    """Full-frame sharded render through the plain tracers -> (H, W, 3)
    linear radiance on the scene's device. ``differentiable`` traces with
    ``trace_rays_diff``; gradients cross the in-process gather, not a
    gather across ranks."""
    fn = trace_rays_diff if differentiable else trace_rays
    return _render(lambda s, o, d, t: fn(s, o, d, t, cfg), sc, width,
                   height, mesh, fsaa)


def render_sharded_cuda(sc: SceneArrays, width: int, height: int,
                        mesh: RayMesh, fsaa: int = 1,
                        cfg: TraceConfig = TraceConfig()):
    """Full-frame sharded render through the CUDA kernel, one Whitted
    launch a block (``ck.launches`` rises by this process's block count)
    -> (H, W, 3) linear radiance on the scene's device, bitwise
    ``render_cuda``'s. CPU blocks take the plain tracer."""
    return _render(lambda s, o, d, t: ck.trace_rays_cuda(s, o, d, t, cfg),
                   sc, width, height, mesh, fsaa)
