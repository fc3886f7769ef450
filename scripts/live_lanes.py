"""Count the live lanes of the Whitted kernel's warps, segment by segment.

    python3 scripts/live_lanes.py [--scenes test13 demo02 test14 demo03]
        [--size 800 480] [--device cuda] [--coop 0 1 2 4 8 16 32]

Runs the plain tracer (ops/trace.py ``_bounce``, the default TraceConfig)
on a scene's camera rays in the kernel's launch order, one segment at a
time, and records which rays are still active before each segment. A warp
is 32 consecutive rays, as the kernel's threads take them. Prints, per
scene, one JSON line: each ray's segment count (mean, max, the share with
5 or more), each warp's length in segments (median, p90, max), the lane
use (lane-segments over 32 x warp-segments) and the share of
warp-segments that run with at most 1, 2, 4 and 8 live lanes. For each
--coop value c it also counts what the kernel's cooperative tail
(csrc/whitted.cu) would run: each warp leaves the per-lane loop at the
first segment with at most c live lanes, so it runs that many warp-wide
per-lane segments, then one ray's segment at a time for the rest
(``per_lane``, ``coop``: sums over the warps; ``longest``: the most a warp
runs of both together). Culling changes no ray's path, so the count is
the unculled tracer's. The tracer is plain PyTorch: ``--device cpu`` runs
it on the CPU (at 96x64, a few minutes a heavy scene).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WARP = 32


def active_masks(sc, width: int, height: int) -> torch.Tensor:
    """(S, N) bool: ray i is active before segment s (launch order)."""
    from quadray_tpu_torch.ops.rays import camera_rays
    from quadray_tpu_torch.ops.trace import (
        CHUNK, TraceConfig, _bounce, _fresh_state)
    cfg = TraceConfig()
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, width, height, 1)
    n = dirs.shape[0]
    org = org[None, :].expand(n, 3)
    t_min = sc.cam_pov.expand(n)
    rows = []   # per chunk: a list of (chunk,) masks
    with torch.no_grad():
        for i in range(0, n, CHUNK):
            st = _fresh_state(org[i:i + CHUNK], dirs[i:i + CHUNK],
                              t_min[i:i + CHUNK], cfg.stack)
            seg = []
            while len(seg) < cfg.max_segments and bool(st["active"].any()):
                seg.append(st["active"].cpu())
                st, _ = _bounce(sc, cfg, st)
            rows.append(seg)
    depth = max(len(r) for r in rows)
    out = torch.zeros((depth, n), dtype=torch.bool)
    for k, seg in enumerate(rows):
        for s, m in enumerate(seg):
            out[s, k * CHUNK:k * CHUNK + m.shape[0]] = m
    return out


def summarize(act: torch.Tensor, coops) -> dict:
    depth, n = act.shape
    if n % WARP:
        act = torch.cat([act, torch.zeros((depth, WARP - n % WARP),
                                          dtype=torch.bool)], dim=1)
    segs = act.sum(0)[:n].double()
    lanes = act.reshape(depth, -1, WARP)
    live = lanes.sum(2)                        # (S, G)
    wlen = (live > 0).sum(0).double()          # (G,)
    wseg = int((live > 0).sum())
    out = {"rays": n, "segments_mean": float(segs.mean()),
           "segments_max": int(segs.max()),
           "rays_5_or_more": float((segs >= 5).double().mean()),
           "warps": live.shape[1],
           "warp_length_median": float(wlen.median()),
           "warp_length_p90": float(torch.quantile(wlen, 0.9)),
           "warp_length_max": int(wlen.max()),
           "warp_segments": wseg,
           "lane_use": float(act.sum()) / (WARP * max(wseg, 1))}
    for k in (1, 2, 4, 8):
        out[f"warp_segments_le_{k}"] = float(
            ((live > 0) & (live <= k)).sum()) / max(wseg, 1)
    # the cooperative tail: switch at the first segment with 1..c lanes
    segs_g = act.sum(0).reshape(-1, WARP)     # (G, 32) each ray's segments
    for c in coops:
        few = (live > 0) & (live <= c)
        has = few.any(0)
        switch = torch.where(has, few.int().argmax(0), wlen.long())   # (G,)
        per_lane = switch.double()
        # lanes live at the switch run their remaining segments one by one
        alive = lanes[switch.clamp(max=depth - 1), torch.arange(
            lanes.shape[1])] & has[:, None]
        rest = ((segs_g - switch[:, None]).clamp(min=0) * alive).sum(1)
        out[f"coop_{c}"] = {"per_lane": int(per_lane.sum()),
                            "coop": int(rest.sum()),
                            "longest": int((per_lane + rest).max())}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenes", nargs="+",
                    default=["test13", "demo02", "test14", "demo03"])
    ap.add_argument("--size", nargs=2, type=int, default=[800, 480],
                    metavar=("W", "H"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--coop", nargs="+", type=int,
                    default=[0, 1, 2, 4, 8, 16, 32])
    args = ap.parse_args()
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.scene import schema as S
    from quadray_tpu_torch.scene.compile import compile_scene
    dev = torch.device(args.device)
    label = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    w, h = args.size
    for name in args.scenes:
        sd = load_scene(name)
        sc = compile_scene(S.SceneDef(root=sd.root,
                                      opts=S.OPTS_FULL & ~sd.opts),
                           device=dev)
        res = summarize(active_masks(sc, w, h), args.coop)
        print(json.dumps({"scene": name, "size": [w, h], "device": label,
                          **res}), flush=True)


if __name__ == "__main__":
    main()
