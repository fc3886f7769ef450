"""Progressive path tracer — PT mode, plain PyTorch version.

The counterpart of ``quadray_tpu.ops.pt`` (reference: tracer.cpp:2374-2703,
5176-5215; seeds engine.cpp:3652-3685): a per-lane LCG, tent-filtered
sub-pixel jitter, cosine-hemisphere diffuse bounces, both Fresnel branches
at the top levels and a defensively sampled one below, walked as a split
tree with a bounded per-lane sibling stack over the intersect/material
machinery of ``ops/trace.py``.

This is the plain version of the PT kernel of ``csrc/whitted.cu``
(``whitted_pt_launch``, replacing the TPU kernel ``_trace_tiled_pt``): the
CPU path of ``Scene.render_pt_pass`` runs it, and the kernel is checked
against it on the card.

Seeds are int32 tensors holding the bits of the JAX package's uint32
seeds (PyTorch's CPU integers have no uint32 multiply-add or logical
shift): the LCG steps in int64 masked to 32 bits.

Where the JAX package's two versions differ, this one follows its jnp
``trace_pt``:
  * one iteration count M for the whole call: the loop runs while any
    lane is active, and every lane draws four uniforms per iteration, so
    every output seed is its input seed advanced 4*M draws (the Pallas
    kernel counts M per grid block of 8192 lanes). The call is therefore
    never split into chunks;
  * emission is read from the hit surface's ``s_emis`` row, LIGHT-tagged
    or not (the Pallas kernel reads LIGHT-tagged rows only; compile_scene
    leaves the others zero);
  * a continuation's origin on the surface it leaves is taken from its
    world hit point, not from the local hit (the Pallas kernel, and the
    Whitted tracers, reuse the local hit: ``intersect``'s
    ``origin_loc``).
The cosine and sine of the hemisphere angle go through float64 and are
rounded once, as the kernel computes them.
"""

from __future__ import annotations

import math

import torch

from quadray_tpu_torch.scene.compile import (
    SceneArrays, PROP_LIGHT, PROP_DIFFUSE, PROP_OPAQUE)
from quadray_tpu_torch.ops.trace import (
    Cull, TraceConfig, count_work, intersect, material_index, texture_color,
    fresnel_terms, _dot3, _rsqrt, _sqrt, BIG)

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

LCG_A = 214013
LCG_C = 2531011
_M32 = 0xFFFFFFFF

PT_SHALLOW = 2    # top levels where BOTH Fresnel branches are followed
#                   (the reference skips the split while inf_DEPTH >
#                   RT_STACK_DEPTH-2, tracer.cpp:3430-3433)
PT_STACK = 6      # pending-sibling stack slots per lane: the top-2
#                   both-branch levels push at most 2 each, and deep
#                   nodes push only for mixed diffuse+specular materials,
#                   so 6 covers the reference's depth-10 trees with slack


def _u32(seed):
    """int32 seed bits -> int64 in [0, 2^32)."""
    return seed.to(I64) & _M32


def _i32(x):
    """int64 in [0, 2^32) -> int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(I32)


def lcg_next(seed):
    """One LCG step x <- x*214013 + 2531011 mod 2^32 (tracer.h:48-53)."""
    return _i32((_u32(seed) * LCG_A + LCG_C) & _M32)


def lcg_uniform(seed):
    """Advance seed; return (new_seed, uniform in [0,1)): the top 24 bits
    over 2^24, exact in f32."""
    s = (_u32(seed) * LCG_A + LCG_C) & _M32
    return _i32(s), (s >> 8).to(F32) * (1.0 / 16777216.0)


def lcg_jump(seed, k: int):
    """The seed after k LCG steps, in O(log k) steps: x -> A x + C with
    (A, C) the k-fold composition of (LCG_A, LCG_C) mod 2^32. The plain
    version of the kernel's seed tail (``pt_seed_tail``)."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    a_k, c_k = 1, 0               # identity
    a_p, c_p = LCG_A, LCG_C       # the 2^j-fold step
    while k:
        if k & 1:                 # apply (a_p, c_p) after (a_k, c_k)
            a_k, c_k = (a_p * a_k) & _M32, (a_p * c_k + c_p) & _M32
        a_p, c_p = (a_p * a_p) & _M32, (a_p * c_p + c_p) & _M32
        k >>= 1
    return _i32((_u32(seed) * a_k + c_k) & _M32)


def tent_jitter(u):
    """smallpt-style tent filter over [-1, 1] (tracer.cpp:1218-1285)."""
    r = 2.0 * u
    return torch.where(r < 1.0, _sqrt(torch.clamp(r, min=1e-12)) - 1.0,
                       1.0 - _sqrt(torch.clamp(2.0 - r, min=1e-12)))


def init_seeds(n: int, frame_seed: int = 1, device="cuda"):
    """Per-lane decorrelated seeds (reset_pseed analog): int32 bits."""
    lane = torch.arange(n, dtype=I64, device=device)
    s = _i32((lane * 2654435761 + frame_seed) & _M32)
    for _ in range(3):
        s = lcg_next(s)
    return s


def _cos_sin(phi):
    """cos and sin of an f32 angle, taken in float64 and rounded once."""
    p = phi.double()
    return torch.cos(p).float(), torch.sin(p).float()


def _cosine_hemisphere(n, u1, u2):
    """Cosine-weighted direction about unit normal n (N,3); u1/u2 (N,).
    The basis is the Pallas kernel's spelling of the jnp cross products
    (pallas_kernel.py:1543-1562)."""
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    near_z = torch.abs(nz) < 0.9
    ax = torch.where(near_z, 0.0, 1.0).to(F32)
    az = torch.where(near_z, 1.0, 0.0).to(F32)
    t1x = -az * ny
    t1y = az * nx - ax * nz
    t1z = ax * ny
    t1n = _rsqrt(torch.clamp(t1x * t1x + t1y * t1y + t1z * t1z, min=1e-20))
    t1x, t1y, t1z = t1x * t1n, t1y * t1n, t1z * t1n
    t2x = ny * t1z - nz * t1y
    t2y = nz * t1x - nx * t1z
    t2z = nx * t1y - ny * t1x
    r = _sqrt(torch.clamp(u1, min=0.0))
    phi = torch.tensor(2.0 * math.pi, dtype=F32) * u2
    cs, sn = _cos_sin(phi)
    x = r * cs
    y = r * sn
    z = _sqrt(torch.clamp(1.0 - u1, min=0.0))
    return torch.stack([t1x * x + t2x * y + nx * z,
                        t1y * x + t2y * y + ny * z,
                        t1z * x + t2z * y + nz * z], dim=-1)


def trace_pt(sc: SceneArrays, org, dirs, t_min, seeds,
             cfg: TraceConfig = TraceConfig(), stats=None):
    """One path-traced sample per lane via the reference's SPLIT-TREE
    walk (PT mode of render0; see ``quadray_tpu.ops.pt.trace_pt``). Per
    hit: emission is gathered; DIFFUSE surfaces spawn one cosine-hemisphere
    child weighted tex*l_dff, Russian-rouletted below depth-5;
    transparent surfaces follow both Fresnel branches at the top
    PT_SHALLOW levels and one sampled branch below; opaque reflective
    surfaces follow the mirror branch. Pending siblings wait on a
    PT_STACK-slot stack; a lane still active after 6*(depth+1) nodes is
    cut. org (3,) or (N,3), dirs (N,3), t_min (N,) f32; seeds (N,) int32.
    Returns (radiance (N,3) f32, seeds (N,) int32).

    Culling (``cfg.cull`` through ``cuda_kernel.cull_gates``, PT's gate:
    reach only): each node tests only the surfaces whose bounding spheres
    its own ray may reach (``Cull.rays``, ``ray_reach``), which changes no
    output bit. The kernel's lanes pull samples from a work queue, so its
    warps hold nodes of unrelated samples in an order this version cannot
    repeat; each lane there tests the same per-ray mask as here, so the
    counts below are the kernel's surface tests.

    ``stats``, a dict or None, gets the nodes run added in as "walks"
    (``count_work``) and the surface tests of those nodes that the masks
    keep and skip, "nearest_tests_kept"/"_culled" (where the gate
    culls); where it holds the key "sample_nodes", that
    becomes the (N,) int32 count of the nodes each sample ran."""
    N = dirs.shape[0]
    dev = dirs.device
    SD = PT_STACK
    if org.dim() == 1:
        org = org[None, :].expand(N, 3)
    zi = lambda *s: torch.zeros((N,) + s, dtype=I32, device=dev)
    zf = lambda *s: torch.zeros((N,) + s, dtype=F32, device=dev)
    org, dirs, tmin = org.to(F32), dirs.to(F32), t_min.to(F32)
    thr = torch.ones((N, 3), dtype=F32, device=dev)
    osrf, oside, dep, sp = zi() - 1, zi() + 1, zi(), zi()
    thru = torch.zeros((N,), dtype=torch.bool, device=dev)
    acc = zf(3)
    active = torch.ones((N,), dtype=torch.bool, device=dev)
    seed = seeds
    st_org, st_dir, st_thr = zf(SD, 3), zf(SD, 3), zf(SD, 3)
    st_dep, st_osrf, st_oside = zi(SD), zi(SD), zi(SD)
    st_thru = torch.zeros((N, SD), dtype=torch.bool, device=dev)
    slot_ids = torch.arange(SD, dtype=I32, device=dev)[None, :]
    lanes = torch.arange(N, device=dev)
    big = torch.full((N,), BIG, dtype=F32, device=dev)
    nodes = zi() if stats is not None and "sample_nodes" in stats else None
    cull = Cull(sc, cfg, pt=True)

    # tree-node cap: a depth-D path sees D+1 hits; the split tree
    # multiplies node count by < 4 in practice
    it = 0
    while it < 6 * (cfg.depth + 1) and bool(active.any()):
        count_work(stats, "walks", active)
        if nodes is not None:
            nodes += active.to(I32)
        h = intersect(sc, org, dirs, tmin, big, osrf, oside, thru,
                      reach=cull.rays(org, dirs, active, stats))
        hit = h["hit"] & active
        midx = material_index(sc, h["srf"], h["side"])
        props = sc.m_props[midx]
        tex = texture_color(sc, midx, h["p"])

        # emission (array-accumulated light radiance, the smallpt emitter)
        sside = torch.where(h["side"] > 0, 0, 1)
        emis = sc.s_emis[torch.clamp(h["srf"], min=0).long(), sside]
        acc = acc + torch.where(hit[:, None], thr * emis, 0.0)

        c_rfl, c_trn, refr_dir, _ = fresnel_terms(sc, midx, dirs, h["n"])

        # fixed per-node draw order: u1, u2 hemisphere; u_rr roulette;
        # u_split Fresnel choice
        seed, u1 = lcg_uniform(seed)
        seed, u2 = lcg_uniform(seed)
        seed, u_rr = lcg_uniform(seed)
        seed, u_split = lcg_uniform(seed)

        emissive = (props & PROP_LIGHT) != 0
        can_rec = hit & ~emissive & (dep < cfg.depth)

        # Fresnel branch weights (TR section; opaque mirrors take the RF
        # section: deterministic, never split)
        opaque = (props & PROP_OPAQUE) != 0
        shallow = dep < PT_SHALLOW
        s_rt = torch.clamp(c_rfl + c_trn, min=1e-30)
        qd = 0.25 + 0.5 * c_rfl / s_rt
        chose_rfl = u_split < qd
        w_rfl = torch.where(shallow, c_rfl,
                            torch.where(chose_rfl, c_rfl / qd, 0.0))
        w_trn = torch.where(
            shallow, c_trn,
            torch.where(chose_rfl, 0.0,
                        c_trn / torch.clamp(1.0 - qd, min=1e-30)))
        w_rfl = torch.where(opaque, c_rfl, w_rfl)
        w_trn = torch.where(opaque, 0.0, w_trn)

        # diffuse child: weight tex*l_dff, RR below split depth
        deep_rr = dep >= (cfg.depth - 5)
        q = torch.clamp(tex.amax(dim=-1), 1e-4, 1.0)
        rr_kill = deep_rr & (u_rr >= q)
        dq = torch.where(deep_rr, 1.0 / q, 1.0)
        dif_mod = tex * sc.m_dff[midx][:, None] * dq[:, None]
        have_dif = can_rec & ((props & PROP_DIFFUSE) != 0) & ~rr_kill
        have_trn = can_rec & (w_trn > 0.0)
        have_rfl = can_rec & (w_rfl > 0.0)

        ddotn = _dot3(dirs, h["n"])
        refl_dir = dirs - 2.0 * ddotn[:, None] * h["n"]
        diff_dir = _cosine_hemisphere(h["n"], u1, u2)

        # continue with the diffuse child (the reference's PT section
        # recurses before TR/RF); pending siblings pushed rfl-then-trn so
        # the transmit child pops first
        cont_dif = have_dif
        cont_trn = ~cont_dif & have_trn
        cont_rfl = ~cont_dif & ~cont_trn & have_rfl
        for pred, pdir, w, pthru in (
                (have_rfl & ~cont_rfl, refl_dir, w_rfl, False),
                (have_trn & ~cont_trn, refr_dir, w_trn, True)):
            ok = pred & (sp < SD)
            oh = (slot_ids == sp[:, None]) & ok[:, None]
            oh3 = oh[:, :, None]
            st_org = torch.where(oh3, h["x"][:, None, :], st_org)
            st_dir = torch.where(oh3, pdir[:, None, :], st_dir)
            st_thr = torch.where(oh3, (thr * w[:, None])[:, None, :], st_thr)
            st_dep = torch.where(oh, (dep + 1)[:, None], st_dep)
            st_osrf = torch.where(oh, h["srf"][:, None], st_osrf)
            st_oside = torch.where(oh, h["side"][:, None], st_oside)
            st_thru = torch.where(oh, pthru, st_thru)
            sp = sp + ok.to(I32)

        cont = cont_dif | cont_trn | cont_rfl
        c3 = lambda m: m[:, None]
        n_dir = torch.where(c3(cont_dif), diff_dir,
                            torch.where(c3(cont_trn), refr_dir, refl_dir))
        n_thr = torch.where(
            c3(cont_dif), thr * dif_mod,
            torch.where(c3(cont_trn), thr * w_trn[:, None],
                        thr * w_rfl[:, None]))

        # lanes whose node finished pop a pending sibling
        can_pop = ~cont & (sp > 0)
        psp = torch.clamp(sp - 1, min=0).long()
        grab = lambda stk: stk[lanes, psp]

        def upd(new, popped, old):
            if new.dim() == 2:
                return torch.where(c3(cont), new,
                                   torch.where(c3(can_pop), popped, old))
            return torch.where(cont, new, torch.where(can_pop, popped, old))

        org = upd(h["x"], grab(st_org), org)
        dirs = upd(n_dir, grab(st_dir), dirs)
        thr = upd(n_thr, grab(st_thr), thr)
        tmin = torch.where(cont | can_pop, 0.0, tmin)
        osrf = upd(h["srf"], grab(st_osrf), osrf)
        oside = upd(h["side"], grab(st_oside), oside)
        thru = upd(cont_trn, grab(st_thru), thru)
        dep = upd(dep + 1, grab(st_dep), dep)
        active = cont | can_pop
        sp = torch.where(can_pop, psp.to(I32), sp)
        it += 1
    if nodes is not None:
        stats["sample_nodes"] = nodes
    return acc, seed


def pt_camera_rays(sc: SceneArrays, width: int, height: int, seeds):
    """Primary rays with per-sample tent-filter jitter; returns (org (3,),
    dirs (W*H, 3), seeds advanced two draws), on the seeds' device."""
    dev = seeds.device
    c = lambda v: torch.tensor(v, dtype=F32)
    seeds, ux = lcg_uniform(seeds)
    seeds, uy = lcg_uniform(seeds)
    jx = tent_jitter(ux) * 0.5
    jy = tent_jitter(uy) * 0.5
    xs = torch.arange(width, dtype=F32, device=dev)[None, :].expand(
        height, width).reshape(-1)
    ys = torch.arange(height, dtype=F32, device=dev)[:, None].expand(
        height, width).reshape(-1)
    factor = c(1.0 / width)
    u = (xs + 0.5 + jx) * factor - 0.5
    v = (ys + 0.5 + jy) * factor - c(0.5 * (height / width))
    dirs = (sc.cam_nrm[None, :] * sc.cam_pov
            + sc.cam_hor[None, :] * u[:, None]
            + sc.cam_ver[None, :] * v[:, None])
    return sc.cam_pos, dirs, seeds
