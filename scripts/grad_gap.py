"""Trace the float32 gap between the all-surface route's two gradients to
the rays that make it, on the CPU.

    python3 scripts/grad_gap.py [--scene test18] [--schlick] [--seed 3]
        [--size 24 16] [--top 5]

The scene is compiled on the CPU as tests/test_torch_diff_fused.py does
(every option the scene leaves off turned on), its camera rays at --size,
TraceConfig(max_segments=8, stack=4) (--schlick: Schlick's Fresnel), and
a colour gradient g drawn from numpy's RandomState(--seed), as the
tests' ``_grads``. It prints, for every differentiable field, the gap
between ops/diff.py trace_rays_fused (its plain versions) and autograd
over ops/trace.py trace_rays_diff, of the field's largest, in float32 and
in float64, and each float32 route's distance from the float64 gradient.
Then, where the float32 gap's worst element is a surface table's, each
ray's term of it in the batch: the fused route's from its plain
backward's per-ray-bounce row gradients (backward_rows_plain's wide
mode), autograd's from the whole batch with g kept at that ray alone
(for each ray that hits the surface; the gradient is linear in g), and
the float64 term from the fused route in float64; the sum over rays of
the two routes' difference against the whole gap, the --top rays by
their difference with their share of the gap, and for each its float64
term, each route's distance from it (of the term) and its bounces
(surface, + a push, - a pop). About 30 s at 24x16.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from quadray_tpu_torch.models.scenes.loader import load_scene  # noqa: E402
from quadray_tpu_torch.ops import diff, trace  # noqa: E402
from quadray_tpu_torch.ops.rays import camera_rays  # noqa: E402
from quadray_tpu_torch.ops.trace import TraceConfig  # noqa: E402
from quadray_tpu_torch.parallel.train import DIFFERENTIABLE_FIELDS  # noqa: E402
from quadray_tpu_torch.scene import schema as S  # noqa: E402
from quadray_tpu_torch.scene.compile import compile_scene  # noqa: E402

# each surface field's first row of the stab table (row_gather.row_tables)
STAB_COLUMN = {"s_pos": 0, "s_inv": 3, "s_sci": 12, "s_scjh": 15,
               "s_sciw": 18}


def grads(route, sc, rays, g, cfg, el):
    """{field: gradient of sum(g * route(sc, *rays, cfg))} in ``el``."""
    trace.set_element(el)
    try:
        sc = trace.scene_astype(sc, el)
        leaves = {k: getattr(sc, k).clone().requires_grad_(True)
                  for k in DIFFERENTIABLE_FIELDS}
        cols = route(dataclasses.replace(sc, **leaves),
                     *(r.to(el) for r in rays), cfg)
        (cols * g.to(el)).sum().backward()
    finally:
        trace.set_element(torch.float32)
    return {k: v.grad for k, v in leaves.items()}


def fused_terms(sc, rays, g, cfg, el, srf: int, col: int):
    """(K, N) each ray-bounce's term of stab[col, srf]'s gradient: the
    fused route's per-ray-bounce row gradients (backward_rows_plain's wide
    mode, the same values its sums add) where the bounce hit ``srf``."""
    trace.set_element(el)
    try:
        sc = trace.scene_astype(sc, el)
        _, tf, ti = diff.forward_plain(sc, *(r.to(el) for r in rays), cfg)
        g_s, _, ids, _ = diff.backward_rows_plain(
            g.to(el), diff.tables(sc), tf, ti, cfg.stack, cfg.schlick, True)
    finally:
        trace.set_element(torch.float32)
    k, n = tf.shape[0], tf.shape[2]
    hit = ids[0].reshape(k, n) == srf
    return torch.where(hit, g_s[col].reshape(k, n), 0.0).double()


def autograd_terms(sc, rays, g, cfg, k: str, idx, rays_in):
    """(N,) each ray's term of field ``k``'s gradient at ``idx`` in float32
    over trace_rays_diff, for the rays ``rays_in`` (0 elsewhere): the
    whole batch traced with g kept at that ray alone, so that the ray's
    values come from the same batched operations as in the whole
    gradient and every other ray's are zero."""
    out = torch.zeros(g.shape[0], dtype=torch.float64)
    for i in rays_in:
        gi = torch.zeros_like(g)
        gi[i] = g[i]
        out[i] = float(grads(trace.trace_rays_diff, sc, rays, gi, cfg,
                             torch.float32)[k][idx])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="test18")
    ap.add_argument("--schlick", action="store_true")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--size", type=int, nargs=2, default=(24, 16))
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--all-rays", action="store_true")
    a = ap.parse_args()
    torch.set_num_threads(1)
    sd = load_scene(a.scene)
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device="cpu")
    w, h = a.size
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, w, h, 1)
    n = dirs.shape[0]
    rays = (org[None, :].expand(n, 3).contiguous(), dirs.contiguous(),
            sc.cam_pov.expand(n).contiguous())
    g = torch.from_numpy(np.random.RandomState(a.seed).standard_normal(
        (n, 3)))
    cfg = TraceConfig(max_segments=8, stack=4, schlick=a.schlick)
    routes = {"fused": diff.trace_rays_fused,
              "autograd": trace.trace_rays_diff}
    f32 = {r: grads(f, sc, rays, g, cfg, torch.float32)
           for r, f in routes.items()}
    f64 = {r: grads(f, sc, rays, g, cfg, torch.float64)
           for r, f in routes.items()}
    print(f"{a.scene} {w}x{h} seed {a.seed} schlick={a.schlick}: of each "
          "field's largest gradient")
    worst = None
    for k in DIFFERENTIABLE_FIELDS:
        top = float(f64["autograd"][k].abs().max())
        if top == 0.0:
            continue
        gap = (f32["fused"][k] - f32["autograd"][k]).abs()
        rel = float(gap.max()) / top
        gap64 = float((f64["fused"][k] - f64["autograd"][k]).abs().max())
        off = {r: float((f32[r][k].double() - f64["autograd"][k]).abs().max())
               / top for r in routes}
        print(f"  {k}: float32 gap {rel:.2e}, float64 gap "
              f"{gap64 / top:.2e}; float32 from float64: fused "
              f"{off['fused']:.2e}, autograd {off['autograd']:.2e}")
        if worst is None or rel > worst[1]:
            worst = (k, rel, int(gap.argmax()), top)
    k, rel, j, top = worst
    idx = tuple(int(x) for x in np.unravel_index(j, f32["fused"][k].shape))
    total = float(f32["fused"][k][idx] - f32["autograd"][k][idx])
    print(f"worst: {k}{list(idx)}, gap {total:.6e} ({rel:.2e} of "
          f"{top:.6e})")
    if k not in STAB_COLUMN:
        print("not a surface table's field: no per-ray terms")
        return
    srf = idx[0]
    col = STAB_COLUMN[k] + (idx[1] if len(idx) > 1 else 0)
    _, _, ti = diff.forward_plain(sc, *rays, cfg)
    fl = ti[:, 0]
    on = (((fl & diff.HIT) != 0) & ((fl & diff.SRF_BITS) == srf)).any(0)
    rays_in = range(n) if a.all_rays else torch.nonzero(on)[:, 0].tolist()
    bounce = fused_terms(sc, rays, g, cfg, torch.float32, srf, col)
    terms = np.stack([
        bounce.sum(0).numpy(),
        autograd_terms(sc, rays, g, cfg, k, idx, rays_in).numpy(),
        fused_terms(sc, rays, g, cfg, torch.float64, srf, col).sum(0).numpy()],
        1)
    d = terms[:, 0] - terms[:, 1]
    print(f"the fused route's ray-bounce terms: the largest "
          f"{float(bounce.abs().max()):.6e}, their magnitudes summed "
          f"{float(bounce.abs().sum()):.6e}, times float32's unit roundoff "
          f"{float(bounce.abs().sum()) * 2.0 ** -24:.3e}")
    print(f"{int(on.sum())} rays hit surface {srf}, autograd's terms of "
          f"{len(rays_in)}; per-ray terms summed in "
          f"float64: fused {terms[:, 0].sum():.6e} (its gradient "
          f"{float(f32['fused'][k][idx]):.6e}), autograd "
          f"{terms[:, 1].sum():.6e} "
          f"({float(f32['autograd'][k][idx]):.6e}), float64 "
          f"{terms[:, 2].sum():.6e}; the two routes' difference summed "
          f"{d.sum():.6e} (the whole gap {total:.6e})")
    for i in np.argsort(-np.abs(d))[:a.top]:
        t64 = terms[i, 2]
        scale = max(abs(t64), 1e-300)
        path = []
        for b in range(fl.shape[0]):
            f = int(fl[b, i])
            if not f & diff.ACTIVE:
                break
            srf_b = f & diff.SRF_BITS if f & diff.HIT else None
            path.append(f"{srf_b}" + ("+" if f & diff.PUSH else "")
                        + ("-" if f & diff.POP else ""))
        print(f"  ray {i} (pixel {i % w}, {i // w}): fused - autograd "
              f"{d[i]:.6e} ({d[i] / total:.1%} of the gap); float64 term "
              f"{t64:.6e}; from it, of the term: fused "
              f"{(terms[i, 0] - t64) / scale:.2e}, autograd "
              f"{(terms[i, 1] - t64) / scale:.2e}; bounces (surface, + a "
              f"push, - a pop) {' '.join(path)}")


if __name__ == "__main__":
    main()
