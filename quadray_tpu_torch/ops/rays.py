"""Primary-ray generation with supersampling offsets.

Reference semantics: rt_Scene::render ray steppers (engine.cpp:3032-3055,
3256-3259) aim at pixel centers of an x_res-normalized screen plane at
distance ``pov`` along the camera normal; AA packs 2x/4x rotated-grid
sub-samples per pixel (render_slice, engine.cpp:3465-3550). Rays come out
flat in pixel order (H, W, S): N = H*W*S. Same formula and f32 operation
order as ``quadray_tpu.ops.rays.camera_rays``.
"""

from __future__ import annotations

import torch

F32 = torch.float32

# rotated-grid AA sub-pixel offsets (engine.cpp:3480-3550, RT_FSAA_REGULAR=0,
# as = 0.25, ar = 0.08)
_AS, _AR = 0.25, 0.08
AA_OFFSETS = {
    1: [(0.0, 0.0)],
    # 2x "alternating" pattern uses offsets (-ar+as, +ar+as), (+ar-as, -ar-as)
    2: [(-_AR + _AS, +_AR + _AS), (+_AR - _AS, -_AR - _AS)],
    4: [(-_AR - _AS, +_AR - _AS), (-_AR + _AS, -_AR - _AS),
        (+_AR - _AS, +_AR + _AS), (+_AR + _AS, -_AR + _AS)],
}


def camera_rays(cam_pos, cam_hor, cam_ver, cam_nrm, cam_pov,
                width: int, height: int, fsaa: int = 1):
    """Return (org (3,), dirs (H*W*S, 3)) on the camera tensors' device.

    dir(x, y) = nrm*pov + hor*((x+0.5+dx)/W - 0.5)
                        + ver*((y+0.5+dy)/W - 0.5*H/W)
    (engine.cpp:3040-3046 corner aim + 3256-3259 pixel scale and
    half-pixel centering; both axes divide by W). Python constants are
    rounded to f32 first, as JAX's weak types are.
    """
    dev = cam_pos.device
    # f32 constants as 0-dim host tensors: a CUDA op reads them as
    # scalars, where a copy to the card would wait for the stream
    c = lambda v: torch.tensor(v, dtype=F32)
    xs = torch.arange(width, dtype=F32, device=dev)
    ys = torch.arange(height, dtype=F32, device=dev)
    factor = c(1.0 / width)
    half_aspect = c(0.5 * (height / width))
    dirs = []
    for (dx, dy) in AA_OFFSETS[fsaa]:
        u = (xs + c(0.5 + dx)) * factor - c(0.5)          # (W,)
        v = (ys + c(0.5 + dy)) * factor - half_aspect     # (H,)
        d = (cam_nrm[None, None, :] * cam_pov
             + cam_hor[None, None, :] * u[None, :, None]
             + cam_ver[None, None, :] * v[:, None, None])  # (H, W, 3)
        dirs.append(d)
    # (H, W, S, 3) -> (H*W*S, 3): subsample axis last so the per-pixel
    # reduction is a simple reshape-mean
    return cam_pos, torch.stack(dirs, dim=2).reshape(-1, 3)


def resolve_aa(colors, width: int, height: int, fsaa: int):
    """Average sub-samples back to (H, W, 3) (the pairwise-horizontal-add
    reduction of tracer.cpp:5241-5308, done as a mean)."""
    return colors.reshape(height, width, fsaa, 3).mean(dim=2)
