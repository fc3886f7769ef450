"""Numeric debugging tools — the RT_QUAD_DEBUG / RT_SHOW_* analogs.

The PyTorch counterpart of ``quadray_tpu.utils.debug``. The reference can
capture the full quadric-solver state of a chosen pixel (tracer.h:289-406,
tracer.cpp:4465-4516, RT_QUAD_DEBUG) and paint diagnostic overlays
(SHOW_TILES/SHOW_BOUND, tracer.cpp:158-420). Here the equivalents are
functions over the plain tracer (``ops.trace``), on the scene's device,
unculled, in the tracer's element type at the time of the call (float64
after ``set_element(torch.float64)``, with the scene upcast by
``scene_astype``): the data a kernel-vs-golden investigation needs.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from quadray_tpu_torch.scene.compile import SceneArrays
from quadray_tpu_torch.ops import trace
from quadray_tpu_torch.ops.rays import camera_rays
from quadray_tpu_torch.ops.trace import (
    BIG, I32, TraceConfig, _apply3, _bounce, _fresh_state, intersect)


def _vec(v, dev):
    return torch.as_tensor(np.asarray(v, np.float64), dtype=trace.ELEMENT,
                           device=dev)[None, :]


def solver_state(sc: SceneArrays, org, d):
    """Per-surface quadric solver state for ONE ray: the inf_* debug
    block analog (a, b, c, disc). org/d: (3,). Returns one dict per real
    surface: srf, kind, a, b, c, disc."""
    dev = sc.device
    org, d = _vec(org, dev), _vec(d, dev)
    rel = org[:, None, :] - sc.s_pos[None, :, :]
    inv_b = sc.s_inv[None, :, :, :]
    o_l = _apply3(inv_b, rel[..., 0], rel[..., 1], rel[..., 2])
    d_l = _apply3(inv_b, d[:, None, 0], d[:, None, 1], d[:, None, 2])
    sci = sc.s_sci[None, :, :]
    scjh = sc.s_scjh[None, :, :]
    a = torch.sum(sci * d_l * d_l, -1)
    b = torch.sum((sci * o_l - scjh) * d_l, -1)
    c = (torch.sum(sci * o_l * o_l, -1) - 2.0 * torch.sum(scjh * o_l, -1)
         - sc.s_sciw[None, :])
    disc = b * b - a * c
    kind = sc.s_kind.cpu().tolist()
    a, b, c, disc = (v[0].cpu().tolist() for v in (a, b, c, disc))
    return [dict(srf=s, kind=kind[s], a=a[s], b=b[s], c=c[s], disc=disc[s])
            for s in range(len(kind)) if kind[s] != 0]


def debug_pixel(sc: SceneArrays, px: int, py: int, width: int, height: int,
                cfg: TraceConfig = TraceConfig(stack=4, max_segments=16),
                log=None) -> List[dict]:
    """Trace ONE pixel's full path, returning (and optionally logging)
    per-segment records: hit surface/side/t, throughput, accumulated
    color, origin bookkeeping — the quad-debug pixel capture. Each step is
    one bounce of the plain tracer's loop (``ops.trace._bounce``), the
    loop ``trace_rays`` runs. Records have the JAX tool's keys."""
    _, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                          sc.cam_pov, width, height, 1)
    idx = py * width + px
    d = dirs[idx:idx + 1]
    st = _fresh_state(sc.cam_pos[None, :], d, sc.cam_pov.reshape(1),
                      cfg.stack)
    big = torch.full((1,), BIG, dtype=trace.ELEMENT, device=d.device)
    row = lambda v: v[0].cpu().tolist()
    records = []
    for seg in range(cfg.max_segments):
        if not bool(st["active"][0]):
            break
        h = intersect(sc, st["org"], st["dir"], st["tmin"], big, st["osrf"],
                      st["oside"], st["thru"], origin_loc=st["oloc"])
        rec = dict(
            segment=seg, srf=int(h["srf"][0]), side=int(h["side"][0]),
            t=float(h["t"][0]), hit=bool(h["hit"][0]), x=row(h["x"]),
            thr=row(st["thr"]), acc=row(st["acc"]),
            depth=int(st["depth"][0]), thru=bool(st["thru"][0]),
            osrf=int(st["osrf"][0]), sp=int(st["sp"][0]))
        records.append(rec)
        if log:
            log(f"seg{seg}: srf={rec['srf']} side={rec['side']} "
                f"t={rec['t']:.6f} depth={rec['depth']} "
                f"thru={rec['thru']} thr={rec['thr']} acc={rec['acc']}")
        st = _bounce(sc, cfg, st)[0]
    records.append(dict(segment="final", acc=row(st["acc"])))
    if log:
        log(f"final acc = {records[-1]['acc']}")
    return records


def overlay_hit_ids(sc: SceneArrays, width: int, height: int) -> np.ndarray:
    """SHOW_TILES analog: color each pixel by its primary hit surface id
    (hashed to RGB) — visualizes the scene structure / permutation."""
    org1, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver,
                             sc.cam_nrm, sc.cam_pov, width, height, 1)
    n = dirs.shape[0]
    dev = dirs.device
    h = intersect(sc, org1[None, :].expand(n, 3), dirs,
                  sc.cam_pov.expand(n),
                  torch.full((n,), BIG, dtype=trace.ELEMENT, device=dev),
                  torch.full((n,), -1, dtype=I32, device=dev),
                  torch.ones((n,), dtype=I32, device=dev),
                  torch.zeros((n,), dtype=torch.bool, device=dev))
    ids = h["srf"].cpu().numpy()
    rgb = np.zeros((n, 3), np.uint8)
    m = ids >= 0
    rgb[m, 0] = (ids[m] * 97 + 31) % 256
    rgb[m, 1] = (ids[m] * 57 + 101) % 256
    rgb[m, 2] = (ids[m] * 17 + 201) % 256
    return rgb.reshape(height, width, 3)
