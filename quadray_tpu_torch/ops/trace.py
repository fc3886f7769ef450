"""Whitted ray tracer — plain PyTorch version of the CUDA kernel.

The counterpart of ``quadray_tpu.ops.trace`` (the JAX package's pure-jnp
reference tracer), written on dense tensors: rays on a flat lane axis N,
surfaces broadcast over the padded axis NS, and the iterative branch-stack
Whitted loop (each bounce continues with one branch and pushes the other
with its throughput). Stable b-mixed Vieta roots with the nan-root rule,
structural root sides, the two-plane factored determinant, near-zero
determinant root sorting, the conic apex nudge, clip programs with
ENTER/LEAVE accumulators, the CHECK_SIDE self-skip, any-hit shadows with
the CHECK_SHAD blocker rule, exact/Schlick/metal Fresnel and TIR all
follow the JAX tracer (see its module docstring for the reference lines).

This is the plain version of ``csrc/whitted.cu``: the CPU path of
``Scene.render`` runs it, and the CUDA kernel is checked against it on the
card. Both compute in f32, with every 3-term contraction written as a
left-to-right mul/add chain (never a matmul, never an FMA: an ulp is
enough to flip the exact boundary cases the reference relies on, e.g.
test11's lights lying exactly on pane planes).

Deviations from the JAX tracer's arithmetic, so that this tracer and the
CUDA kernel can agree bitwise on the card:
  * sqrt and rsqrt are taken in float64 and rounded back to f32, which is
    correctly rounded in practice: the kernel uses the correctly rounded
    ``__fsqrt_rn`` / ``__frsqrt_rn``, while torch's f32 sqrt/rsqrt are off
    by an ulp on some inputs (rsqrt on about a quarter of them on the CPU).
  * the specular power is ``exp(pow * log(cos))``, as the Pallas kernel
    computes it (pallas_kernel.py:1769), in place of ``power(cos, pow)``.
On the CPU, XLA also contracts the jitted JAX tracer's mul/add pairs into
FMAs, so this tracer and the JAX one agree to within a few f32 ulps, not
bitwise.

``trace_paths`` is the plain version of the path-record kernel (the
``EMIT_PATHS`` mode of ``csrc/whitted.cu``, the TPU kernel's
``_trace_tiled_paths``): the same loop, capped at K segments, that also
writes one i32 record per segment for trace-replay training
(``ops/replay.py``). ``trace_rays_diff`` runs the loop for a fixed
``cfg.max_segments`` under autograd: the all-surface differentiable
reference the replay gradients are held against. ``trace_rays_emit`` and
``trace_rays_resume`` are the plain versions of the two rounds of
two-round retirement (the kernel's EMIT and RESUME modes, the TPU
kernel's ``_trace_tiled_emit`` / ``_trace_tiled_resume``): the same loop
stopped after k1 segments with its state packed into 21 rows, and
started again from such rows.

``set_element(torch.float64)`` runs this tracer in double precision (the
reference's fp64 element tier, as ``quadray_tpu.ops.trace.set_element``):
the caller upcasts the scene (``scene_astype``) and the rays. The CUDA
kernels stay f32 and refuse f64 tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from quadray_tpu_torch.scene.compile import (
    FIELDS, SceneArrays, PROP_LIGHT, PROP_METAL, PROP_OPAQUE, PROP_REFLECT,
    PROP_REFRACT, PROP_DIFFUSE, PROP_SPECULAR, PROP_GAMMA, PROP_FRESNEL,
    PROP_TRANSP, CLIP_SURF, CLIP_ENTER, CLIP_LEAVE)

F32 = torch.float32
I32 = torch.int32
ELEMENT = F32   # the plain tracer's element type: float32, or float64
#                 (set_element); read it through the module, at call time
BIG = 1e30   # a Python float: each tensor it meets rounds it to its own type
D_EPS = 1e-11   # RT_DEPS_THRESHOLD (object.h:41): near-zero determinant
T_EPS = 1e-7    # RT_TEPS_THRESHOLD (object.h:42): root sorting / apex nudge


class TraceConfig(NamedTuple):
    """Same fields and defaults as ``quadray_tpu.ops.trace.TraceConfig``.
    unroll/cull/cand/lsort/sub/chunk tune the TPU kernel's culling and
    tiling. The CUDA kernel of this package reads depth, max_segments,
    stack and cutoff, and cull, lsort and unroll through
    ``ops.cuda_kernel.cull_gates``; cand, sub and chunk are the TPU's
    candidate lists and block heights, which it has no use for."""
    depth: int = 10          # RT_STACK_DEPTH (tracer.h:46)
    max_segments: int = 48   # iteration cap for the branch-stack loop
    stack: int = 10          # branch-stack capacity per lane
    cutoff: float = 1.0 / 1024.0  # throughput cutoff for continuations
    d_eps: float = 0.0       # determinant epsilon (srf_D_EPS analog)
    schlick: bool = False    # RT_FEAT_SCHLICK: Schlick instead of exact
    # dielectric Fresnel on the transparency path
    unroll: int = 16
    cull: bool = True
    cand: bool = True
    lsort: bool = True
    sub: int = 64
    chunk: int = 32


def set_element(dtype) -> None:
    """RT_ELEMENT analog (rtbase.h:331-361): switch the plain tracer's
    element type, a module-level setting as in the JAX package. The
    reference ships an fp32/fp64 binary matrix (core_make_x64.mk:44
    x64f32/x64f64); here the same tracer code runs in either precision.
    In float64 the scene tables must be upcast by the caller
    (``scene_astype``), integer tables stay int32, sqrt and rsqrt are
    plain float64 operations, BIG is float64(1e30), and the tracer runs
    unculled (the cull masks are the f32 kernel's), as the JAX jnp tracer
    always does. The two-round modes and the CUDA kernels are f32 only."""
    global ELEMENT
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"element type must be float32 or float64, got "
                         f"{dtype}")
    ELEMENT = dtype


def scene_astype(sc: SceneArrays, dtype) -> SceneArrays:
    """``sc`` with every floating-point field cast to ``dtype`` (the
    integer tables unchanged): the scene of the fp64 tier."""
    return dataclasses.replace(sc, **{
        k: getattr(sc, k).to(dtype) for k in FIELDS
        if getattr(sc, k).is_floating_point()})


def _sqrt(x):
    """Correctly rounded sqrt: taken in float64 and rounded back to x's
    type (a no-op round for float64)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _rsqrt(x):
    return torch.rsqrt(x.double()).to(x.dtype)


def clip(x, lo: float, hi: float):
    """jnp.clip: x limited to [lo, hi], NaN kept, as minimum(maximum(x,
    lo), hi), whose gradient at a tie with either bound is one half, as
    JAX's is (torch.clamp passes all of it). The bounds are zero-dim CPU
    tensors, which a CUDA x takes as scalars: no copy, no launch."""
    return torch.minimum(torch.maximum(x, torch.tensor(lo, dtype=x.dtype)),
                         torch.tensor(hi, dtype=x.dtype))


def _sgn(x):
    """+1 where x >= 0, else -1 (f32)."""
    return torch.where(x >= 0.0, 1.0, -1.0).to(ELEMENT)


def _dot3(a, b):
    """Left-to-right a.x*b.x + a.y*b.y + a.z*b.z over the last axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _apply3(m, vx, vy, vz):
    """y_i = sum_j m[..., i, j] v_j, left-to-right."""
    return torch.stack([m[..., i, 0] * vx + m[..., i, 1] * vy
                        + m[..., i, 2] * vz for i in range(3)], dim=-1)


def _apply3t(m, vx, vy, vz):
    """Transposed apply: y_i = sum_j m[..., j, i] v_j (normal transform)."""
    return torch.stack([m[..., 0, i] * vx + m[..., 1, i] * vy
                        + m[..., 2, i] * vz for i in range(3)], dim=-1)


def _eval_implicit(kind, sci, scjh, sciw, p):
    """F(p) per surface kind: plane -> p_k; quadric -> sci.p^2-2 scjh.p-sciw."""
    quad = _dot3(sci * p, p) - 2.0 * _dot3(scjh, p) - sciw
    return torch.where(kind == 1, p[..., 2], quad)


def _safe_div(num, den, fallback=BIG):
    bad = torch.abs(den) < 1e-30
    return torch.where(bad, fallback, num / torch.where(bad, 1.0, den))


def _root(num, den):
    """nan-root handling (tracer.cpp:4585-4600): zero numerator -> root 0;
    zero denominator (nonzero numerator) -> invalid."""
    den = torch.where(num == 0.0, 1.0, den)
    ok = den != 0.0
    return torch.where(ok, num / torch.where(ok, den, 1.0), BIG), ok


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def intersect(sc: SceneArrays, org, dirs, t_min, t_max,
              origin_srf, origin_side, pass_thru,
              shadow: bool = False, origin_loc=None, reach=None,
              per_surface: bool = False, gather=None, tape: bool = False):
    """Nearest valid hit over all surfaces (see quadray_tpu.ops.trace).

    org/dirs (N,3); t_min/t_max (N,); origin_srf (N,) i32 (-1 none);
    origin_side (N,) i32; pass_thru (N,) bool; origin_loc (N,3) local hit
    on the originating surface, reused as that surface's local origin;
    reach (N, NS) bool or None: the surfaces each ray tests (a cull mask,
    ``Cull``), the others give no hit.
    Returns dict t, srf (-1 miss), side, x, p, n, hit, and with
    ``per_surface`` t_srf (N, NS), each surface's nearest valid root (BIG:
    none), the candidates the nearest fold picks from; with ``shadow``,
    the (N,) bool any-hit over surfaces that block light. ``gather``
    (the differentiable route's ``Gathered``): the hit surface's inverse
    transform comes from its gathered rows, returned as ``rows``, in
    place of the lookup ``sc.s_inv[bs]``. ``tape``: the nearest hit's
    apex-nudge flag ``hm`` (N,) bool is returned too (the fused
    differentiable route's tape, ``ops.diff``).
    """
    NS = sc.s_pos.shape[0]
    dev = org.device
    sid = torch.arange(NS, dtype=I32, device=dev)
    rel = org[:, None, :] - sc.s_pos[None, :, :]
    inv_b = sc.s_inv[None]                              # (1, NS, 3, 3)
    o_l = _apply3(inv_b, rel[..., 0], rel[..., 1], rel[..., 2])
    d_l = _apply3(inv_b, dirs[:, None, 0], dirs[:, None, 1],
                  dirs[:, None, 2])                     # (N, NS, 3)
    if origin_loc is not None:
        own = sid[None, :] == origin_srf[:, None]       # (N, NS)
        o_l = torch.where(own[..., None], origin_loc[:, None, :], o_l)

    sci = sc.s_sci[None]
    scjh = sc.s_scjh[None]
    kind = sc.s_kind[None]                              # (1, NS)

    # quadric: F(o + t d) = a t^2 + 2 b t + c (tracer.cpp:4388-4447)
    a = _dot3(sci * d_l, d_l)
    b = _dot3(sci * o_l - scjh, d_l)
    c = _eval_implicit(kind, sci, scjh, sc.s_sciw[None], o_l)

    is_plane = kind == 1
    is_tp = kind == 3
    # two-plane exact factored determinant (tracer.cpp:4239-4246)
    cross = o_l[..., 0] * d_l[..., 2] - o_l[..., 2] * d_l[..., 0]
    disc_tp = torch.abs(sci[..., 0] * sci[..., 2]) * cross * cross
    disc = torch.where(is_tp, disc_tp, b * b - a * c)
    quad_ok = disc >= 0.0
    sq = torch.where(disc > 0.0, _sqrt(torch.where(disc > 0.0, disc, 1.0)),
                     0.0)
    # stable b-mixed roots (tracer.cpp:4518-4547): slot 0 = entering /
    # outer side, slot 1 = leaving / inner side, structurally
    q = -(b + _sgn(b) * sq)
    b_pos = b > 0.0
    t1, ok1 = _root(torch.where(b_pos, q, c), torch.where(b_pos, a, q))
    t2, ok2 = _root(torch.where(b_pos, c, q), torch.where(b_pos, q, a))

    # near-zero determinant root sorting (tracer.cpp:4572-4623)
    dmask = quad_ok & (disc < D_EPS) & ~is_plane
    sgn_a = _sgn(a)
    u = (t1 - t2) * sgn_a
    tdff = torch.where(u >= 0.0, -0.5 * u - torch.abs(T_EPS * t1),
                       0.0) * sgn_a
    tdff = torch.where(dmask & ok1 & ok2, tdff, 0.0)
    t1 = t1 + tdff
    t2 = t2 - tdff

    # plane: t = -o_k / d_k with the division-free exact t-window
    num_pl = -o_l[..., 2]
    den_pl = d_l[..., 2]
    t_pl = _safe_div(num_pl, den_pl)
    pos_d = den_pl > 0.0
    tmin_d = t_min[:, None] * den_pl
    tmax_d = t_max[:, None] * den_pl
    win_pl = ((den_pl != 0.0)
              & torch.where(pos_d, num_pl > tmin_d, num_pl < tmin_d)
              & torch.where(pos_d, num_pl < tmax_d, num_pl > tmax_d))

    root_a = torch.where(is_plane, t_pl, torch.where(quad_ok & ok1, t1, BIG))
    root_b = torch.where(is_plane, BIG, torch.where(quad_ok & ok2, t2, BIG))
    roots = torch.stack([root_a, root_b], dim=-1)       # (N, NS, 2)

    side_pl = torch.where(d_l[..., 2] < 0.0, 1, -1).to(I32)
    # constants are made on the device, never copied from the host, so
    # that a CUDA graph can hold a bounce: a root pair's slots 0 and 1,
    # their sides +1 and -1
    slot = torch.arange(2, dtype=I32, device=dev)
    side_q = (1 - 2 * slot).expand(roots.shape)
    side_r = torch.where(is_plane[..., None], side_pl[..., None], side_q)

    p_r = o_l[:, :, None, :] + roots[..., None] * d_l[:, :, None, :]
    x_r = org[:, None, None, :] + roots[..., None] * dirs[:, None, None, :]

    # conic singularity (CC_glb, tracer.cpp:1706-1860): near the apex the
    # clip/normal point becomes a T_EPS nudge from the apex
    sing = sc.s_sing[None, :, None]
    cyl = sing == 2
    hm = (sing > 0) & dmask[..., None] & (_dot3(p_r, p_r) < T_EPS)
    o3 = o_l[:, :, None, :]
    ratio = torch.abs(_safe_div(
        sci[..., 0] + torch.where(cyl[..., 0], 0.0, sci[..., 1]),
        sci[..., 2], 0.0))[..., None].expand(hm.shape)
    acc = torch.where(cyl, 1.0, 2.0)
    inv_r = T_EPS * _rsqrt(torch.clamp(ratio + acc, min=1e-30))
    inner = side_r < 0
    a_neg = (a < 0.0)[..., None]
    ij_flip = torch.where(inner & ~a_neg, -1.0, 1.0)
    k_flip = torch.where(~inner & a_neg, -1.0, 1.0)
    adj_i = _sgn(o3[..., 0]) * ij_flip * inv_r
    adj_j = torch.where(cyl, 0.0, _sgn(o3[..., 1]) * ij_flip * inv_r)
    # (sqrt of a where-guarded 0: sqrt'(0) = inf would turn the masked-off
    # gradient of trace_rays_diff into NaN)
    sq_ratio = torch.where(ratio > 0.0,
                           _sqrt(torch.where(ratio > 0.0, ratio, 1.0)), 0.0)
    adj_k = _sgn(o3[..., 2]) * k_flip * sq_ratio * inv_r
    adj = torch.stack([adj_i, adj_j, adj_k], dim=-1)
    p_r = torch.where(hm[..., None], adj, p_r)
    x_adj = sc.s_pos[None, :, None, :] + _apply3(
        sc.s_fwd[None, :, None], adj_i, adj_j, adj_k)
    x_r = torch.where(hm[..., None], x_adj, x_r)

    # gradient at the (possibly adjusted) hit point (plane: +K)
    g_r = torch.where(is_plane[..., None, None],
                      (torch.arange(3, device=dev) == 2).to(ELEMENT),
                      sci[:, :, None, :] * p_r - scjh[:, :, None, :])

    # validity: strict t window; planes use the division-free window
    in_win = (roots > t_min[:, None, None]) & (roots < t_max[:, None, None])
    valid = torch.where(is_plane[..., None] & (slot == 0),
                        win_pl[..., None], in_win)
    valid &= torch.isfinite(roots) & (roots < BIG)
    valid &= sc.s_kind[None, :, None] > 0              # padding
    # axis clips in the canonical frame (tracer.cpp:1883-1927)
    valid &= ((p_r >= sc.s_cmin[None, :, None, :])
              & (p_r <= sc.s_cmax[None, :, None, :])).all(dim=-1)

    # custom clip programs with accum segments (CC_cyc, tracer.cpp:1939-2160)
    mask = valid
    saved = torch.ones_like(valid)
    for j in range(sc.c_op.shape[1]):
        opj = sc.c_op[:, j]
        refj = torch.clamp(sc.c_ref[:, j], min=0).long()
        with record_function("lookup.clip_refs"):
            r_pos, r_inv, r_kind, r_sci, r_scjh, r_sciw = (
                t[refj] for t in (sc.s_pos, sc.s_inv, sc.s_kind, sc.s_sci,
                                  sc.s_scjh, sc.s_sciw))
        relc = x_r - r_pos[None, :, None, :]
        pc = _apply3(r_inv[None, :, None],
                     relc[..., 0], relc[..., 1], relc[..., 2])
        v = _eval_implicit(r_kind[None, :, None],
                           r_sci[None, :, None, :],
                           r_scjh[None, :, None, :],
                           r_sciw[None, :, None], pc)
        keep = torch.where(sc.c_side[None, :, None, j] >= 0.0,
                           v <= 0.0, v >= 0.0)
        is_srf = (opj == CLIP_SURF)[None, :, None]
        is_ent = (opj == CLIP_ENTER)[None, :, None]
        is_lve = (opj == CLIP_LEAVE)[None, :, None]
        saved = torch.where(is_ent, mask, saved)
        mask = torch.where(is_srf, mask & keep,
                           torch.where(is_ent, torch.ones_like(mask),
                                       torch.where(is_lve, saved & ~mask,
                                                   mask)))
    valid = mask

    # exact self-intersection skip (CHECK_SIDE, tracer.cpp:523-540)
    same = sid[None, :, None] == origin_srf[:, None, None]
    allowed = torch.where(pass_thru[:, None, None],
                          side_r != origin_side[:, None, None],
                          side_r == origin_side[:, None, None])
    valid &= ~same | allowed
    if reach is not None:
        valid &= reach[:, :, None]

    if shadow:
        # blocker rule (CHECK_SHAD): emissive and unbent fully-transparent
        # surfaces don't occlude
        mat_idx = torch.where(side_r > 0, sc.s_mat[None, :, None, 0],
                              sc.s_mat[None, :, None, 1]).long()
        props = sc.m_props[mat_idx]
        blocks = (((props & PROP_LIGHT) == 0)
                  & ~(((props & PROP_TRANSP) != 0)
                      & ((props & PROP_REFRACT) == 0)))
        return (valid & blocks).flatten(1).any(dim=1)

    N = org.shape[0]
    t_cand = torch.where(valid, roots, BIG).reshape(N, NS * 2)
    t, best = torch.min(t_cand, dim=1)      # first index among ties
    hit = t < BIG
    bs = best // 2
    br = best % 2
    lanes = torch.arange(N, device=dev)
    with record_function("lookup.take"):
        side, g, x, p = (arr[lanes, bs, br] for arr in (side_r, g_r, x_r,
                                                         p_r))
    rows = None
    if gather is None:
        with record_function("lookup.tables"):
            inv = sc.s_inv[bs]
    else:
        rows = gather(bs, side)
        inv = rows.inv
    n_w = _apply3t(inv, g[:, 0], g[:, 1], g[:, 2])
    n_w = n_w * side[:, None].to(ELEMENT)
    n_w = n_w * _rsqrt(torch.clamp(_dot3(n_w, n_w), min=1e-30))[:, None]
    out = dict(t=t, srf=torch.where(hit, bs.to(I32), -1), side=side,
               x=x, p=p, n=n_w, hit=hit)
    if rows is not None:
        out["rows"] = rows
    if tape:
        out["hm"] = hm[lanes, bs, br]
    if per_surface:
        out["t_srf"] = t_cand.reshape(N, NS, 2).amin(dim=2)
    return out


# ---------------------------------------------------------------------------
# bounding-sphere culling: the plain version of the kernel's warp masks
# ---------------------------------------------------------------------------

WARP = 32   # rays per bundle: the lanes of a warp


def _butterfly(v, op):
    """op-reduce the last axis (a power of two) as the kernel's
    __shfl_xor_sync butterfly does (offsets 16, 8, 4, 2, 1); every lane
    ends with the same value, (G, L) -> (G, 1)."""
    lanes = torch.arange(v.shape[-1], device=v.device)
    k = v.shape[-1] // 2
    while k:
        v = op(v, v[..., lanes ^ k])
        k //= 2
    return v[..., :1]


NO_SRF = 0x7FFFFFF   # the kernel's no_hit surface id


def coop_fold(t, ids, kept, lanes: int = WARP):
    """The nearest pass of the CUDA kernel's cooperative tail (whitted.cu
    ``nearest_coop``), step for step, for tests: each ray's kept surfaces,
    in row order, are dealt out by rank (the k-th kept one to lane k mod
    ``lanes``), each lane folds its share in order with the kernel's rule
    (a root counts if t < BIG; it wins on a smaller t, or an equal t and a
    smaller original id), then the lanes are reduced by the xor butterfly
    on (t, id) with the same rule.

    t (N, S) f32: each surface's nearest root for each ray, the surfaces in
    table-row order; ids (S,) int: their original ids (unique); kept (N, S)
    bool: the mask. Returns (t (N,) f32, id (N,) int64): BIG and NO_SRF
    where no kept root counts. ``lanes`` = 1 is the serial walk."""
    N, S = t.shape
    R = -(-max(S, 1) // lanes)
    # kept surfaces first, in row order: position k is rank k
    order = torch.argsort((~kept).to(torch.int8), dim=1, stable=True)
    have = torch.arange(S, device=t.device)[None, :] < kept.sum(1,
                                                                 keepdim=True)
    pad = R * lanes - S
    tt = torch.nn.functional.pad(torch.gather(t, 1, order), (0, pad))
    ii = torch.nn.functional.pad(ids.to(torch.int64)[order], (0, pad))
    hv = torch.nn.functional.pad(have, (0, pad))
    tt, ii, hv = (v.reshape(N, R, lanes) for v in (tt, ii, hv))
    bt = torch.full((N, lanes), BIG, dtype=ELEMENT, device=t.device)
    bi = torch.full((N, lanes), NO_SRF, dtype=torch.int64, device=t.device)
    for j in range(R):   # round j: lane l folds the kept surface of rank
        # j * lanes + l
        tj, ij = tt[:, j], ii[:, j]
        take = hv[:, j] & (tj < BIG) & ((tj < bt) | ((tj == bt) & (ij < bi)))
        bt = torch.where(take, tj, bt)
        bi = torch.where(take, ij, bi)
    lane = torch.arange(lanes, device=t.device)
    k = lanes // 2
    while k:
        ot, oi = bt[:, lane ^ k], bi[:, lane ^ k]
        take = (ot < bt) | ((ot == bt) & (oi < bi))
        bt = torch.where(take, ot, bt)
        bi = torch.where(take, oi, bi)
        k //= 2
    return bt[:, 0], bi[:, 0]


def bundle_reach(org, dirs, on, spheres, shadow: bool):
    """Which bounding spheres a bundle of rays may reach: the reach test
    of the CUDA kernel's warp masks (pallas_kernel.py:1020-1133 per
    bundle), with the kernel's f32 operations in its order.

    org, dirs (G, L, 3) f32: G bundles of L rays (L = WARP, the lanes of
    a warp); on (G, L) bool, the rays in the bundle; spheres (4, S) f32
    rows cx, cy, cz, radius (+inf: unbounded). A nearest-hit ray is the
    half-line org + t dirs, t >= 0; a shadow ray the segment t in [0, 1].
    Bound: an origin box (centre c0, radius r0) and either a direction
    cone (axis the mean of the unit directions, half-angle the widest
    ray's) or, for shadow rays, a capsule from c0 to the endpoints' box.
    Slack 1.0005 and 1e-4 on the radii, 1e-4 on the cone's cosine; a
    comparison that gives NaN or inf comes out as "reach". Returns (G, S)
    bool; a bundle with no ray reaches nothing."""
    f = lambda v, fill: torch.where(on, v, fill)
    mn = lambda v: _butterfly(f(v, BIG), torch.minimum)
    mx = lambda v: _butterfly(f(v, -BIG), torch.maximum)

    def ball(px, py, pz):
        lo = [mn(p) for p in (px, py, pz)]
        hi = [mx(p) for p in (px, py, pz)]
        ex, ey, ez = (h - l for h, l in zip(hi, lo))
        return ([0.5 * (l + h) for l, h in zip(lo, hi)],
                0.5 * _sqrt(ex * ex + ey * ey + ez * ez))

    ox, oy, oz = org.unbind(-1)
    dx, dy, dz = dirs.unbind(-1)
    (c0x, c0y, c0z), r0 = ball(ox, oy, oz)
    r0 = r0 * 1.0005 + 1e-4
    scx, scy, scz, srs = (s[None, :] for s in spheres)
    lcx, lcy, lcz = scx - c0x, scy - c0y, scz - c0z       # (G, S)
    if shadow:
        (c1x, c1y, c1z), r1 = ball(ox + dx, oy + dy, oz + dz)
        ux, uy, uz = c1x - c0x, c1y - c0y, c1z - c0z
        uu = ux * ux + uy * uy + uz * uz
        brad = torch.maximum(r0, r1 * 1.0005 + 1e-4)
        tp = torch.clamp((lcx * ux + lcy * uy + lcz * uz)
                         / torch.clamp(uu, min=1e-30), 0.0, 1.0)
        qx, qy, qz = lcx - tp * ux, lcy - tp * uy, lcz - tp * uz
        re = srs + brad
        reach = ~(qx * qx + qy * qy + qz * qz > re * re)
    else:
        ilen = _rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-30))
        dhx, dhy, dhz = dx * ilen, dy * ilen, dz * ilen
        sx, sy, sz = (_butterfly(f(v, 0.0), torch.add)
                      for v in (dhx, dhy, dhz))
        an = _rsqrt(torch.clamp(sx * sx + sy * sy + sz * sz, min=1e-30))
        bax, bay, baz = sx * an, sy * an, sz * an
        cosmin = _butterfly(f(dhx * bax + dhy * bay + dhz * baz, 1.0),
                            torch.minimum)
        cosw = torch.clamp(cosmin - 1e-4, -1.0, 1.0)
        sinw = _sqrt(torch.clamp(1.0 - cosw * cosw, min=0.0))
        d_ax = lcx * bax + lcy * bay + lcz * baz
        dist2 = lcx * lcx + lcy * lcy + lcz * lcz
        perp = _sqrt(torch.clamp(dist2 - d_ax * d_ax, min=0.0))
        # signed distance to the cone's boundary; negative inside it
        reach = ~(perp * cosw - d_ax * sinw > srs + r0)
    return reach & on.any(dim=1, keepdim=True)


def ray_reach(org, dirs, spheres):
    """Which bounding spheres each ray may reach: the per-ray test of the
    CUDA PT kernel's masks (whitted.cu ``ray_reaches``), with its f32
    operations in its order. org, dirs (N, 3) f32, a ray being the
    half-line org + t dirs, t >= 0; spheres (4, S) f32 rows cx, cy, cz,
    radius (+inf: unbounded). A sphere is kept unless its centre c lies
    farther than its radius from the ray's line (|c - o|^2 - ((c - o).dh)^2
    with dh the unit direction) or behind o by more than its radius, the
    radius widened by 1e-4 and the squares by 1e-5 |c - o|^2 for f32
    rounding; a comparison that gives NaN or inf comes out as "reach".
    Returns (N, S) bool."""
    dx, dy, dz = (v[:, None] for v in dirs.unbind(-1))
    il = _rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-30))
    dhx, dhy, dhz = dx * il, dy * il, dz * il
    ox, oy, oz = (v[:, None] for v in org.unbind(-1))
    scx, scy, scz, srs = (s[None, :] for s in spheres)
    lcx, lcy, lcz = scx - ox, scy - oy, scz - oz              # (N, S)
    d_ax = lcx * dhx + lcy * dhy + lcz * dhz
    dist2 = lcx * lcx + lcy * lcy + lcz * lcz
    re = srs + 1e-4
    lim = re * re + 1e-5 * dist2
    return ~((dist2 - d_ax * d_ax > lim) | ((d_ax < 0.0) & (d_ax * d_ax > lim)))


def seg_reach(org, dirs, spheres):
    """Which bounding spheres each shadow ray may reach: the per-ray test
    of the CUDA kernel's shadow masks in the two-round modes (whitted.cu
    ``seg_reaches``), with its f32 operations in its order. org, dirs (N,
    3) f32, a ray being the segment org + t dirs, t in [0, 1] (dirs
    unnormalised: the hit point to the light); spheres (4, S) f32 rows cx,
    cy, cz, radius (+inf: unbounded). A sphere is kept unless the point of
    the segment nearest its centre c (t = (c - o).d / |d|^2 clamped to [0,
    1]) lies farther than its radius from c, the radius widened by 1e-4 and
    the squares by 1e-5 (|c - o|^2 + |d|^2) for f32 rounding; a comparison
    that gives NaN or inf comes out as "reach". Returns (N, S) bool."""
    dx, dy, dz = (v[:, None] for v in dirs.unbind(-1))
    ox, oy, oz = (v[:, None] for v in org.unbind(-1))
    scx, scy, scz, srs = (s[None, :] for s in spheres)
    lcx, lcy, lcz = scx - ox, scy - oy, scz - oz              # (N, S)
    re = srs + 1e-4
    dd = dx * dx + dy * dy + dz * dz
    tp = torch.clamp((lcx * dx + lcy * dy + lcz * dz)
                     / torch.clamp(dd, min=1e-30), 0.0, 1.0)
    qx, qy, qz = lcx - tp * dx, lcy - tp * dy, lcz - tp * dz
    dist2 = lcx * lcx + lcy * lcy + lcz * lcz
    lim = re * re + 1e-5 * (dist2 + dd)
    return ~(qx * qx + qy * qy + qz * qz > lim)


def _unpack_bits(words, n: int):
    """(..., NW) i32 words -> (..., n) bool, bit b of word w = column
    32w + b (the packing of ``cuda_kernel._pack_bits``)."""
    shift = torch.arange(32, device=words.device)
    bits = (words[..., None].to(torch.int64) >> shift) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :n] != 0


class Cull:
    """The CUDA kernel's cull masks for the plain tracer's rays: lanes in
    bundles of WARP consecutive rays per segment (a call's rays in launch
    order), reach bits (``bundle_reach``) ANDed, in a shadow pass, with
    the OR of the bundle's receivers' ``shad_msk`` rows and, in a nearest
    pass, with the OR of its previous hits' ``cont_msk`` rows, as
    ``cuda_kernel.cull_gates`` switches them. The masks come back on the
    original surface order, for ``intersect``'s ``reach``. ``stats`` get
    the surface tests the masks keep and skip (``count_work``). With
    ``own``, ``nearest`` and ``shadow`` refine each ray's bundle mask by
    its own reach bits (``ray_reach``, ``seg_reach``) and its own static
    row (the two-round modes' per-ray masks). With ``pt``, the path
    tracer's gate and its per-ray masks (``rays``)."""

    def __init__(self, sc: SceneArrays, cfg: TraceConfig, pt: bool = False):
        from quadray_tpu_torch.ops.cuda_kernel import (
            _get_cull_plain, _get_struct, cull_gates)
        struct = _get_struct(sc)
        self.gates = cull_gates(struct, cfg, pt)
        n = self.n = struct.n_real
        dev = sc.device
        self.ns = sc.s_pos.shape[0]
        self.perm = torch.tensor(struct.perm[:n], dtype=torch.long,
                                 device=dev)
        self.row_of = torch.zeros((self.ns,), dtype=torch.long, device=dev)
        self.row_of[self.perm] = torch.arange(n, device=dev)
        self.blk = torch.tensor(struct.blk[:n], device=dev) != 0
        self.nl = struct.nl
        if not self.gates.cull:
            return
        ps, _ = _get_cull_plain.tables(sc, struct)
        self.spheres = ps["bsph_t"][:, 0, :n]
        nw = -(-self.ns // 32)
        if self.gates.lsort:
            self.shad = _unpack_bits(
                ps["shad_msk"].reshape(self.ns, struct.nl, nw), n)
        if self.gates.cont:
            self.cont = _unpack_bits(ps["cont_msk"].reshape(self.ns, 2, nw),
                                     n)

    def _bundles(self, v, fill):
        """(N, ...) per ray -> (G, WARP, ...) in bundles, padded with fill."""
        N = v.shape[0]
        G = -(-N // WARP)
        out = torch.full((G * WARP,) + v.shape[1:], fill, dtype=v.dtype,
                         device=v.device)
        out[:N] = v
        return out.reshape((G, WARP) + v.shape[1:])

    def _mask(self, org, dirs, on, shadow, rows_bits, total, key, stats,
              reach_own=None, own_min: int = 0):
        """(N, NS) bool on the original order: the bundle's mask of each
        ray; rows_bits (N, n) bool, each ray's static-mask row or None.
        With ``reach_own`` ((N, n) bool: each ray's own reach bits), each
        ray of a bundle whose mask keeps more than ``own_min`` surfaces
        refines it by its own reach bits and its own row, as the kernel's
        two-round modes do (whitted.cu ``nearest_own``/``occluded_own``)."""
        N = on.shape[0]
        if self.gates.cull:
            m = bundle_reach(self._bundles(org, 0.0),
                             self._bundles(dirs, 0.0),
                             self._bundles(on, False), self.spheres, shadow)
        else:
            m = self._bundles(on, False).any(dim=1, keepdim=True) \
                .expand(-1, self.n)
        if shadow:
            m = m & self.blk
        if rows_bits is not None:
            m = m & self._bundles(rows_bits & on[:, None], False).any(dim=1)
        per_ray = m.repeat_interleave(WARP, dim=0)[:N]
        if reach_own is not None:
            own = per_ray & reach_own
            if rows_bits is not None:
                own = own & rows_bits
            refine = (m.sum(dim=1) > own_min).repeat_interleave(
                WARP)[:N]
            per_ray = torch.where(refine[:, None], own, per_ray)
        if stats is not None:
            kept = int((per_ray & on[:, None]).sum())
            count_work(stats, key + "_kept", kept)
            count_work(stats, key + "_culled", int(on.sum()) * total - kept)
        out = torch.zeros((N, self.ns), dtype=torch.bool, device=on.device)
        out[:, self.perm] = per_ray
        return out

    def rays(self, org, dirs, on, stats=None):
        """The mask of a PT node's nearest pass: each ray that is ``on``
        keeps the surfaces its own ray may reach (``ray_reach``), as the
        kernel's lanes do, counted in ``stats``; None, and no count,
        where the gate does not cull (every surface)."""
        if not self.gates.cull:
            return None
        m = ray_reach(org, dirs, self.spheres) & on[:, None]
        kept = int(m.sum())
        count_work(stats, "nearest_tests_kept", kept)
        count_work(stats, "nearest_tests_culled",
                   int(on.sum()) * self.n - kept)
        out = torch.zeros((on.shape[0], self.ns), dtype=torch.bool,
                          device=on.device)
        out[:, self.perm] = m
        return out

    def nearest(self, st, act, stats=None, own=None):
        """The mask of a segment's nearest pass over the state ``st``:
        the cont rows are those of each ray's previous hit (``orow``, -1
        where the ray has none: a primary ray, a popped branch, the first
        resumed segment), all bits where it has none. ``own`` (an int):
        each ray refines a bundle mask that keeps more than ``own``
        surfaces by its own (``ray_reach``); None, the bundle's alone."""
        rows = None
        if self.gates.cont:
            orow = st["orow"]
            side = (st["oside"] <= 0).long()
            rows = torch.where((orow >= 0)[:, None],
                               self.cont[orow.clamp(min=0), side], True)
        reach = None
        if own is not None:
            reach = (ray_reach(st["org"], st["dir"], self.spheres)
                     if self.gates.cull else torch.ones_like(act)[:, None])
        return self._mask(st["org"], st["dir"], act, False, rows, self.n,
                          "nearest_tests", stats, reach, own or 0)

    def shadow(self, org, dirs, need, srf, light: int, stats=None,
               own=None):
        """The mask of the shadow pass toward active light ``light`` from
        the hits ``srf`` (original ids) of the rays that ``need`` it.
        ``own``: as for ``nearest``, with ``seg_reach``."""
        rows = None
        if self.gates.lsort:
            rows = self.shad[self.row_of[srf.clamp(min=0).long()], light]
        reach = None
        if own is not None:
            reach = (seg_reach(org, dirs, self.spheres)
                     if self.gates.cull else torch.ones_like(need)[:, None])
        return self._mask(org, dirs, need, True, rows,
                          int(self.blk.sum()), "shadow_tests", stats, reach,
                          own or 0)


# ---------------------------------------------------------------------------
# materials + shading
# ---------------------------------------------------------------------------

def material_index(sc: SceneArrays, srf, side):
    s = torch.clamp(srf, min=0).long()
    return torch.where(side > 0, sc.s_mat[s, 0], sc.s_mat[s, 1]).long()


def _mat(sc: SceneArrays, midx, rows, name: str):
    """Each ray's material field ``m_<name>`` ("props", "col", "dff",
    ...): the lookup ``sc.m_<name>[midx]``, or with ``rows`` (a
    ``Gathered``'s) the gathered row."""
    if rows is not None:
        return rows.mat[name]
    with record_function("lookup.tables"):
        return getattr(sc, "m_" + name)[midx]


class Gathered:
    """The differentiable route's reads of the trained float tables: each
    bounce gathers its rays' rows of the surface and material tables
    (``ops.row_gather.row_tables``, built once a trace) at their nearest
    hits in one ``RowGather`` call, in place of a lookup at each site
    (``sc.s_inv[bs]``, ``sc.m_dff[midx]``, ...), whose backward autograd
    runs as ``index_put_`` with accumulate: a sort, then each table row's
    gradients summed serially. The gather's backward sums them in the
    kernel's fixed tree (``row_sum_plain``), with no atomics. A call
    ``(bs, side)`` returns the rows: ``inv`` (N, 3, 3) the hit surface's
    inverse transform, ``mat`` the material's fields by name, ``midx``
    the side-picked material (``material_index``'s), for the lookups of
    fields that do not train (the texture's)."""

    def __init__(self, sc: SceneArrays):
        from quadray_tpu_torch.ops import row_gather as rg
        self.sc, self.gather = sc, rg.RowGather.apply
        self.stab, self.mtab = rg.row_tables(sc)
        self.names = rg.MATERIAL_FIELDS

    def __call__(self, bs, side):
        sc = self.sc
        with record_function("lookup.tables"):
            srows, midx, mrows, _, props = self.gather(
                self.stab, self.mtab, sc.s_kind, sc.s_mat, sc.m_props,
                bs.to(I32), side > 0)
        n = bs.shape[0]
        # s_inv's nine rows as (N, 3, 3), [n, j, i] = row 3 + 3j + i
        inv = srows[3:12].reshape(3, 3, n).permute(2, 0, 1)
        mat = dict(zip(self.names, mrows.unbind(0)), props=props,
                   col=mrows[0:3].T)
        return _Rows(inv, mat, midx.long())


class _Rows(NamedTuple):
    inv: torch.Tensor
    mat: dict
    midx: torch.Tensor


def texture_color(sc: SceneArrays, midx, p_local, rows=None, tape=None):
    """Texture fetch (MT_tex, tracer.cpp:2297-2321): integer mask/shift
    addressing over pow-2 dims; UV = local I,J; gamma decode x^2 when the
    GAMMA prop is on (PAINT_COLX, tracer.cpp:664-673). ``rows``: see
    ``_mat``; ``tape``, a dict or None, gets the texel read as "texel"
    (N,) i32, -1 where the material has no texture."""
    props = _mat(sc, midx, rows, "props")
    base = sc.m_tex_base[midx]
    u = p_local[..., 0] - sc.m_tex_off[midx, 0]
    v = p_local[..., 1] - sc.m_tex_off[midx, 1]
    xdim = (sc.m_tex_xmask[midx] + 1).to(ELEMENT)
    ydim = (sc.m_tex_ymask[midx] + 1).to(ELEMENT)
    ix = torch.floor(u * xdim / sc.m_tex_scl[midx, 0]).to(I32)
    iy = torch.floor(v * ydim / sc.m_tex_scl[midx, 1]).to(I32)
    ix = ix & sc.m_tex_xmask[midx]
    iy = iy & sc.m_tex_ymask[midx]
    idx = torch.clamp(base, min=0) + (iy << sc.m_tex_xshift[midx]) + ix
    idx = torch.clamp(idx, 0, sc.tex_data.shape[0] - 1).long()
    if tape is not None:
        tape["texel"] = torch.where(base >= 0, idx.to(I32), -1)
    col = torch.where((base >= 0)[..., None], sc.tex_data[idx],
                      _mat(sc, midx, rows, "col"))
    gamma = ((props & PROP_GAMMA) != 0) & (sc.use_gamma > 0)
    return torch.where(gamma[..., None], col * col, col)


def count_work(stats, key: str, mask) -> None:
    """Adds the lanes set in ``mask`` (or ``mask`` itself, an int) into
    ``stats[key]``; a no-op when ``stats`` is None. The plain tracers
    count the work their kernels must do for a call (for its bound):
    "walks", nearest-hit walks over every surface (Whitted segments, PT
    nodes); "shadow_open" and "shadow_blocked", shadow rays that no
    blocker stops (every blocker is tested) and that one does (at least
    one test). With a ``Cull``, the Whitted tracers also count the surface
    tests its masks keep and skip: "nearest_tests_kept"/"_culled" over
    the real surfaces of each walk, "shadow_tests_kept"/"_culled" over
    the blockers of each shadow ray (before any early-out)."""
    if stats is not None:
        stats[key] = stats.get(key, 0) + (
            mask if isinstance(mask, int) else int(mask.sum()))


def shade(sc: SceneArrays, cfg: TraceConfig, x, p, n, ray_d, srf, side, hit,
          stats=None, cull=None, own=None, rows=None, tape=None):
    """Local color: ambient + per-light diffuse/specular with hard shadows
    (LT_reg..LT_end, tracer.cpp:2709-3180). Returns (col (N, 3), unlit
    (N,) i32): bit 16+l of ``unlit`` is set where active light l is not
    unoccluded-lit (the path record's light bits, pallas_kernel.py:1747),
    for the first 16 light rows. ``stats``: see ``count_work``; ``cull``,
    a ``Cull`` or None, masks each shadow pass (``own``: per ray, see
    ``Cull.nearest``); ``rows``: see ``_mat``; ``tape``, a dict or None,
    gets the texel read (``texture_color``) and, as "vis", each light
    row's (N,) bool "lit and unshadowed" in a list."""
    midx = material_index(sc, srf, side) if rows is None else rows.midx
    props = _mat(sc, midx, rows, "props")
    tex = texture_color(sc, midx, p, rows, tape)
    if tape is not None:
        tape["vis"] = []
    col = tex * sc.amb_col[None, :]
    zero_t = torch.zeros_like(x[:, 0])
    unlit = torch.zeros_like(srf)
    for li in range(sc.l_pos.shape[0]):
        lvec = sc.l_pos[li][None, :] - x                # L = pos - hit
        r_dot = _dot3(lvec, n)
        lit = (r_dot > 0.0) & (sc.l_on[li] > 0) & hit
        reach = (cull.shadow(x, lvec, lit, srf, li, stats, own)
                 if cull is not None and li < cull.nl else None)
        # shadow any-hit along hit -> light, t in (0, 1)
        occ = intersect(sc, x, lvec, zero_t, torch.ones_like(zero_t),
                        srf, side, torch.zeros_like(lit), shadow=True,
                        origin_loc=p, reach=reach)
        hm = lit & ~occ
        if tape is not None:
            tape["vis"].append(hm)
        count_work(stats, "shadow_open", hm)
        count_work(stats, "shadow_blocked", lit & occ)
        if li < 16:
            unlit = unlit | ((~hm & (sc.l_on[li] > 0)).to(I32) << (16 + li))
        r2 = _dot3(lvec, lvec)
        r = _sqrt(torch.clamp(r2, min=1e-30))
        attn = _rsqrt(torch.clamp(
            sc.l_cnt[li] + sc.l_lnr[li] * r + sc.l_qdr[li] * r2, min=1e-30))
        dfs = torch.where(hm & ((props & PROP_DIFFUSE) != 0),
                          r_dot / r * attn * _mat(sc, midx, rows, "dff"),
                          0.0)
        # specular: reflect L about n, dot with view ray
        rl = lvec - 2.0 * r_dot[:, None] * n
        sdot = _dot3(rl, ray_d)
        cosr = sdot * _rsqrt(torch.clamp(_dot3(ray_d, ray_d) * r2,
                                         min=1e-30))
        spc_on = hm & (sdot > 0.0) & ((props & PROP_SPECULAR) != 0)
        cosr = clip(torch.where(spc_on, cosr, 1.0), 1e-6, 1.0)
        spc = torch.where(
            spc_on, torch.exp(_mat(sc, midx, rows, "pow") * torch.log(cosr))
            * _mat(sc, midx, rows, "spc"), 0.0)
        lcol = sc.l_col[li][None, :]
        metal = (props & PROP_METAL) != 0
        contrib_metal = tex * lcol * (dfs + spc)[:, None]
        contrib_plain = tex * lcol * dfs[:, None] + lcol * spc[:, None]
        col = col + torch.where(metal[:, None], contrib_metal, contrib_plain)
    return torch.where(((props & PROP_LIGHT) != 0)[:, None], tex, col), unlit


def fresnel_metal_fast(dot, rcp, ext2):
    """Approximate conductor reflectance (FRESNEL_METAL fast,
    tracer.cpp:3730-3752)."""
    t = 2.0 * dot * rcp
    c2 = dot * dot
    g = rcp * rcp + ext2
    x0 = c2 + g
    x1 = c2 * g + 1.0
    rs = _safe_div(x0 + t, x0 - t, 1.0)
    rp = _safe_div(x1 + t, x1 - t, 1.0)
    return torch.abs(-0.5 * (rs + rp))


def fresnel_metal_slow(dot, rcp, ext2):
    """Exact conductor reflectance via the a^2/b^2 formulation
    (FRESNEL_METAL_SLOW, tracer.cpp:3682-3726), in the JAX function's
    operation order. Like the JAX tracer, the trace uses the fast one."""
    c2 = dot * dot
    sin2 = 1.0 - c2
    n2 = rcp * rcp
    t0 = n2 - ext2 - sin2
    u = _sqrt(t0 * t0 + 4.0 * n2 * ext2)
    a2 = torch.abs(0.5 * (t0 + u))
    twoac = 2.0 * _sqrt(a2) * dot                  # negative
    rs = _safe_div(c2 + u + twoac, c2 + u - twoac, 1.0)
    rp_f = _safe_div(c2 * u + sin2 * sin2 + twoac * sin2,
                     c2 * u + sin2 * sin2 - twoac * sin2, 1.0)
    return torch.abs(-0.5 * (rs + rs * rp_f))


def fresnel_schlick(dot, eta, sq):
    """Schlick approximation (RT_FEAT_SCHLICK, tracer.cpp:3355-3381)."""
    x = torch.where(eta > 1.0, 1.0 - sq, 1.0 + dot)
    r = _safe_div(eta - 1.0, eta + 1.0, 1.0)
    r0 = r * r
    x5 = (x * x) * (x * x) * x
    return r0 + (1.0 - r0) * x5


def fresnel_terms(sc: SceneArrays, midx, d, n, schlick: bool = False,
                  rows=None):
    """Effective reflect/refract weights + refraction direction (TR
    section, tracer.cpp:3182-3424, and the RF-section reflectivity
    Fresnel for opaque reflective materials, tracer.cpp:3671-3830).
    ``rows``: see ``_mat``."""
    props = _mat(sc, midx, rows, "props")
    eta = _mat(sc, midx, rows, "rfr")
    trn = _mat(sc, midx, rows, "trn")
    rfl = _mat(sc, midx, rows, "rfl")

    dlen = _rsqrt(torch.clamp(_dot3(d, d), min=1e-30))
    rhat = d * dlen[:, None]
    dot = _dot3(rhat, n)                                # negative
    ed = eta * dot
    k = 1.0 - eta * eta + ed * ed
    refracts = (props & PROP_REFRACT) != 0
    tir = (k < 0.0) & refracts
    sq = torch.where(k > 0.0, _sqrt(torch.where(k > 0.0, k, 1.0)), 0.0)
    refr_dir = torch.where(refracts[:, None],
                           eta[:, None] * rhat - n * (ed + sq)[:, None],
                           rhat)

    fres_prop = ((props & PROP_FRESNEL) != 0) & (sc.use_fresnel > 0)
    fres_on = fres_prop & ((props & PROP_OPAQUE) == 0)
    if schlick:
        F = fresnel_schlick(dot, eta, sq)
    else:
        rs = _safe_div(ed + sq, ed - sq, 1.0)
        rp = _safe_div(dot + eta * sq, dot - eta * sq, 1.0)
        F = 0.5 * (rs * rs + rp * rp)
    F = torch.where(fres_on, clip(F, 0.0, 1.0), 0.0)
    # TIR folds transparency into reflectivity only under Fresnel
    F = torch.where(tir & fres_on, 1.0, F)
    c_trn = torch.where(tir, 0.0, trn * (1.0 - F))
    c_rfl = rfl + trn * F

    rf_on = (fres_prop & ((props & PROP_OPAQUE) != 0)
             & ((props & PROP_REFLECT) != 0))
    rcp = _safe_div(torch.ones_like(eta), eta, 0.0)     # mat_C_RCP
    ext = _mat(sc, midx, rows, "ext")
    f_metal = fresnel_metal_fast(dot, rcp, ext * ext)
    rs_o = _safe_div(ed + sq, ed - sq, 1.0)
    rp_o = _safe_div(dot + eta * sq, dot - eta * sq, 1.0)
    f_plain = torch.abs(-0.5 * (rs_o * rs_o + rp_o * rp_o))
    f_rf = torch.where((props & PROP_METAL) != 0, f_metal, f_plain)
    c_rfl = torch.where(rf_on, rfl * f_rf, c_rfl)
    return c_rfl, c_trn, refr_dir, tir


# ---------------------------------------------------------------------------
# the iterative Whitted loop
# ---------------------------------------------------------------------------

# rays traced at a time by trace_rays: bounds the dense (rays x surfaces
# x 2 roots) temporaries to a few hundred MB on many-surface scenes
CHUNK = 1 << 15


def trace_rays(sc: SceneArrays, org, dirs, t_min, cfg: TraceConfig,
               stats=None, own=None):
    """Trace N rays to completion; returns (N, 3) linear radiance.
    Rays are independent, so they are traced CHUNK at a time. ``stats``,
    a dict or None, gets the call's work added in (``count_work``).
    ``own``: None, or per-ray masks from a bounce on (``_run``), as the
    kernel's OWN instantiation takes them after the camera segment
    (``(1, cuda_kernel.EMIT_OWN_MIN_KEPT)``); the same bits either way."""
    return _chunked(sc, org, dirs, t_min, cfg, 0, stats=stats, own=own)[0]


def trace_paths(sc: SceneArrays, org, dirs, t_min,
                cfg: TraceConfig = TraceConfig(), k_paths: int = 8,
                stats=None):
    """Trace N rays for at most K = k_paths segments and record each
    segment (``pallas_kernel.py`` ``trace_paths`` :2296, max_segments = K
    as :2260). Returns (colors (N, 3) f32, paths (K, N) i32); the record
    of segment k of lane i is ``paths[k, i]``:
      bits 0-11  original id of the hit surface (0 on a miss);
      bit 12     side > 0 (a miss has side +1);
      bits 13-14 continuation: 0 stop, 1 reflect, 2 transmit;
      bit 15     hit;
      bit 16+l   active light l is NOT unoccluded-lit.
    A lane that retired before segment k records 0 there. Single-branch
    scenes with at most 16 active lights only (ValueError otherwise), as
    the TPU kernel asserts (:499, :504, :2306). As in the kernel, a lane
    never pushes a branch: where trained parameters let an opaque
    material transmit, the reflection goes on and the transmission is
    dropped. ``stats``: as for ``trace_rays``."""
    from quadray_tpu_torch.ops.cuda_kernel import check_paths_struct, \
        _get_struct
    check_paths_struct(_get_struct(sc))
    return _chunked(sc, org, dirs, t_min,
                    cfg._replace(max_segments=k_paths), k_paths, push=False,
                    stats=stats)


def _chunked(sc, org, dirs, t_min, cfg, k_paths, push=True, stats=None,
             own=None):
    N = dirs.shape[0]
    if org.dim() == 1:
        org = org[None, :].expand(N, 3)
    el = ELEMENT
    cull = Cull(sc, cfg) if el == F32 else None
    outs = [_trace_chunk(sc, org[i:i + CHUNK].to(el),
                         dirs[i:i + CHUNK].to(el),
                         t_min[i:i + CHUNK].to(el), cfg, k_paths, push,
                         stats=stats, cull=cull, own=own)
            for i in range(0, N, CHUNK)]
    if not outs:
        return (torch.zeros((0, 3), dtype=el, device=dirs.device),
                torch.zeros((k_paths, 0), dtype=I32, device=dirs.device))
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs], dim=1))


def trace_rays_diff(sc: SceneArrays, org, dirs, t_min, cfg: TraceConfig):
    """Differentiable variant of trace_rays (``quadray_tpu.ops.trace``
    :725): the same bounce run exactly cfg.max_segments times, unchunked,
    under autograd; gradients reach every float field of ``sc`` that
    requires grad. The all-surface reference for the replay gradients.
    Each bounce reads the trained float tables at its hits through one
    row gather (``Gathered``; ``csrc/replay.cu`` on the card, f32 only),
    so the colors are ``trace_rays``'s bit for bit and the tables'
    gradients are summed in the gather kernel's fixed order."""
    N = dirs.shape[0]
    if org.dim() == 1:
        org = org[None, :].expand(N, 3)
    el = ELEMENT
    if dirs.device.type != "cpu" and el != F32:
        raise ValueError(f"trace_rays_diff: the row gather's kernels take "
                         f"float32, the element type is {el}; the float64 "
                         f"tier runs on the CPU")
    return _trace_chunk(sc, org.to(el), dirs.to(el), t_min.to(el), cfg,
                        0, fixed=True, gather=Gathered(sc))[0]


def _trace_chunk(sc: SceneArrays, org, dirs, t_min, cfg: TraceConfig,
                 k_paths: int = 0, push: bool = True, fixed: bool = False,
                 stats=None, cull=None, own=None, gather=None):
    """Returns (acc (N, 3), paths (k_paths, N) i32); ``push`` lets a lane
    push the transmission where both branches go on; ``fixed`` runs all
    cfg.max_segments bounces instead of stopping once every lane retired;
    ``cull``, ``own`` and ``gather``: see ``_run``."""
    st, paths = _run(sc, cfg, _fresh_state(org, dirs, t_min, cfg.stack),
                     k_paths, push, fixed, stats, cull, own, gather)
    return st["acc"], paths


def _fresh_state(org, dirs, t_min, D: int):
    """The loop state of new rays: unit throughput, no origin surface,
    active, nothing accumulated, an empty D-slot branch stack. ``orow``,
    the permuted table row of the hit a ray continues from (-1: none, as
    after a pop), only picks the cull's cont rows."""
    N = dirs.shape[0]
    dev = dirs.device
    zi = lambda *s: torch.zeros((N,) + s, dtype=I32, device=dev)
    zf = lambda *s: torch.zeros((N,) + s, dtype=ELEMENT, device=dev)
    return dict(
        org=org.clone(), dir=dirs.clone(),
        thr=torch.ones((N, 3), dtype=ELEMENT, device=dev),
        depth=zi(), osrf=zi() - 1, oside=zi() + 1, orow=zi() - 1,
        thru=torch.zeros((N,), dtype=torch.bool, device=dev),
        oloc=zf(3), tmin=t_min.clone(),
        active=torch.ones((N,), dtype=torch.bool, device=dev),
        acc=zf(3), sp=zi(),
        st_org=zf(D, 3), st_dir=zf(D, 3), st_thr=zf(D, 3),
        st_depth=zi(D), st_srf=zi(D), st_side=zi(D), st_oloc=zf(D, 3),
    )


def _run(sc: SceneArrays, cfg: TraceConfig, st, k_paths: int = 0,
         push: bool = True, fixed: bool = False, stats=None, cull=None,
         own=None, gather=None):
    """At most cfg.max_segments bounces from the loop state ``st``, whose
    rays are in the kernel's launch order (``cull``, a ``Cull`` or None,
    bundles them by it; ``own``, None or (the first bounce, the kept
    count): from that bounce on, each ray refines its bundle's masks that
    keep more than that count by its own, ``Cull.nearest``; ``gather``, a
    ``Gathered`` or None: the differentiable route's table reads);
    returns (the state after them, paths (k_paths, N) i32)."""
    paths = torch.zeros((k_paths, st["org"].shape[0]), dtype=I32,
                        device=st["org"].device)
    it = 0
    while it < cfg.max_segments and (fixed or bool(st["active"].any())):
        st, rec = _bounce(sc, cfg, st, push, stats, cull,
                          own[1] if own and it >= own[0] else None, gather)
        if it < k_paths:
            paths[it] = rec
        it += 1
    return st, paths


# ---------------------------------------------------------------------------
# two-round retirement (the plain versions of the EMIT and RESUME modes of
# csrc/whitted.cu, the TPU kernel's _trace_tiled_emit / _trace_tiled_resume)
# ---------------------------------------------------------------------------

# rows of the (21, N) resumable ray state, in the TPU kernel's tile order
# (pallas_kernel.py:2518-2520, 2560-2563); the i32 rows hold int32 bits
STATE_ROWS = ("ox", "oy", "oz", "dx", "dy", "dz", "tmn", "thr_r", "thr_g",
              "thr_b", "depth", "osrf", "oside", "thru", "olx", "oly", "olz",
              "active", "acc_r", "acc_g", "acc_b")
STATE_I32 = (10, 11, 12, 13, 17)   # depth, osrf, oside, thru, active
ACTIVE_ROW = 17


def _check_single_branch(sc: SceneArrays):
    """The two-round modes' preconditions: a single-branch scene, and the
    f32 element type (the state rows hold int32 bits in f32 words)."""
    from quadray_tpu_torch.ops.cuda_kernel import _get_struct, \
        check_rounds_struct
    if ELEMENT != F32:
        raise ValueError("the two-round modes are f32 only")
    check_rounds_struct(_get_struct(sc))


def _pack_state(st) -> torch.Tensor:
    """The loop state as the (21, N) f32 rows of STATE_ROWS."""
    bits = lambda v: v.to(I32).view(F32)
    rows = ([st["org"][:, c] for c in range(3)]
            + [st["dir"][:, c] for c in range(3)] + [st["tmin"]]
            + [st["thr"][:, c] for c in range(3)]
            + [bits(st[k]) for k in ("depth", "osrf", "oside", "thru")]
            + [st["oloc"][:, c] for c in range(3)] + [bits(st["active"])]
            + [st["acc"][:, c] for c in range(3)])
    return torch.stack(rows)


def _unpack_state(state, D: int):
    """The loop state of the rays of a (21, N) state, branch stack empty."""
    st = _fresh_state(state[0:3].T, state[3:6].T, state[6], D)
    ints = lambda r: state[r].contiguous().view(I32)
    st.update(thr=state[7:10].T.clone(), depth=ints(10).clone(),
              osrf=ints(11).clone(), oside=ints(12).clone(),
              thru=ints(13) != 0, oloc=state[14:17].T.clone(),
              active=ints(ACTIVE_ROW) != 0, acc=state[18:21].T.clone())
    return st


def trace_rays_emit(sc: SceneArrays, org, dirs, t_min, cfg: TraceConfig,
                    k1: int, stats=None):
    """Round 1 of two-round retirement (``pallas_kernel.py``
    ``_trace_tiled_emit`` :2525): at most k1 segments per ray. Returns
    (colors (N, 3) f32 after them, state (21, N) f32: the resumable ray
    state, rows STATE_ROWS). A ray that retired keeps its last ray with
    thru 0 and active 0, as the TPU kernel's single-branch update leaves
    it. Single-branch scenes only (ValueError otherwise): no lane pushes a
    branch. The cull masks are the kernel's: the bundles' for the camera
    segment and after it each ray's own within a bundle mask that keeps
    more than ``cuda_kernel.EMIT_OWN_MIN_KEPT`` surfaces. ``stats``: as
    for ``trace_rays``."""
    from quadray_tpu_torch.ops.cuda_kernel import EMIT_OWN_MIN_KEPT
    _check_single_branch(sc)
    if k1 < 1:
        raise ValueError(f"k1 must be >= 1, got {k1}")
    N = dirs.shape[0]
    if org.dim() == 1:
        org = org[None, :].expand(N, 3)
    cfg1 = cfg._replace(max_segments=k1)
    cull = Cull(sc, cfg)
    cols = torch.zeros((N, 3), dtype=F32, device=dirs.device)
    state = torch.zeros((len(STATE_ROWS), N), dtype=F32, device=dirs.device)
    for i in range(0, N, CHUNK):
        st = _fresh_state(org[i:i + CHUNK].to(F32), dirs[i:i + CHUNK].to(F32),
                          t_min[i:i + CHUNK].to(F32), cfg.stack)
        st, _ = _run(sc, cfg1, st, push=False, stats=stats, cull=cull,
                     own=(1, EMIT_OWN_MIN_KEPT))
        cols[i:i + CHUNK] = st["acc"]
        state[:, i:i + CHUNK] = _pack_state(st)
    return cols, state


def trace_rays_resume(sc: SceneArrays, state, cols, cfg: TraceConfig,
                      k1: int, stats=None):
    """Round 2 (``pallas_kernel.py`` ``_trace_tiled_resume`` :2572): every
    active ray of ``state`` (from ``trace_rays_emit`` with the same k1)
    runs at most cfg.max_segments - k1 more segments, its color sums
    starting from the emitted acc, so the result is the f32 chain of
    ``trace_rays``. Returns new (N, 3) colors: ``cols`` where a ray had
    retired. The active rays run in ascending order, as the kernel's RESUME
    takes them (``cuda_kernel.compact_active``), each with its own cull
    masks within a bundle mask that keeps more than
    ``cuda_kernel.RESUME_OWN_MIN_KEPT`` surfaces, as in the kernel's dense
    mode. Single-branch scenes only. ``stats``: as for ``trace_rays``."""
    from quadray_tpu_torch.ops.cuda_kernel import RESUME_OWN_MIN_KEPT
    _check_single_branch(sc)
    out = cols.clone()
    cfg2 = cfg._replace(max_segments=cfg.max_segments - k1)
    if cfg2.max_segments <= 0:
        return out
    alive = torch.nonzero(state[ACTIVE_ROW].contiguous().view(I32) != 0)[:, 0]
    cull = Cull(sc, cfg)
    for i in range(0, alive.shape[0], CHUNK):
        ids = alive[i:i + CHUNK]
        st = _unpack_state(state[:, ids], cfg.stack)
        st, _ = _run(sc, cfg2, st, push=False, stats=stats, cull=cull,
                     own=(0, RESUME_OWN_MIN_KEPT))
        out[ids] = st["acc"]
    return out


def _bounce(sc: SceneArrays, cfg: TraceConfig, st, push_ok: bool = True,
            stats=None, cull=None, own=None, gather=None, tape=None):
    """One bounce of the iterative Whitted loop (quadray_tpu.ops.trace
    _make_body): shade the nearest hit, continue with the reflection if
    it carries weight, else the refraction, pushing the refraction when
    both do (unless ``push_ok`` is False); lanes that cannot continue pop
    the branch stack. Returns the new state and the segment's path record
    (see trace_paths). ``own``: per-ray masks (``Cull.nearest``);
    ``gather``: a ``Gathered`` (the differentiable route) or None;
    ``tape``: a list or None, which gets a dict of what the bounce decided
    appended (``ops.diff``'s tape)."""
    N = st["org"].shape[0]
    D = cfg.stack
    act = st["active"]
    count_work(stats, "walks", act)
    h = intersect(sc, st["org"], st["dir"], st["tmin"],
                  torch.full((N,), BIG, dtype=ELEMENT, device=act.device),
                  st["osrf"], st["oside"], st["thru"],
                  origin_loc=st["oloc"],
                  reach=None if cull is None else cull.nearest(st, act,
                                                               stats, own),
                  gather=gather, tape=tape is not None)
    hit = h["hit"] & act
    rows = h.get("rows")
    taped = None if tape is None else {}
    local, unlit = shade(sc, cfg, h["x"], h["p"], h["n"], st["dir"],
                         h["srf"], h["side"], hit, stats, cull, own, rows,
                         taped)
    midx = (material_index(sc, h["srf"], h["side"]) if rows is None
            else rows.midx)
    c_rfl, c_trn, refr_dir, _ = fresnel_terms(sc, midx, st["dir"], h["n"],
                                              cfg.schlick, rows)
    # local color weight uses the ORIGINAL material rfl/trn (TR_mix,
    # tracer.cpp:3566-3571), not the Fresnel-modulated values
    # jnp.maximum's gradient: one half at a tie with 0 (rfl + trn == 1)
    local_w = (1.0 - _mat(sc, midx, rows, "trn")
               - _mat(sc, midx, rows, "rfl"))
    local_w = torch.maximum(local_w, torch.tensor(0.0, dtype=local_w.dtype))
    acc = st["acc"] + torch.where(hit[:, None],
                                  st["thr"] * local * local_w[:, None], 0.0)

    deep_ok = st["depth"] < cfg.depth
    thr_rfl = st["thr"] * c_rfl[:, None]
    thr_trn = st["thr"] * c_trn[:, None]
    go_rfl = hit & deep_ok & (thr_rfl.amax(dim=-1) > cfg.cutoff)
    go_trn = hit & deep_ok & (thr_trn.amax(dim=-1) > cfg.cutoff)
    ddotn = _dot3(st["dir"], h["n"])
    refl_dir = st["dir"] - 2.0 * ddotn[:, None] * h["n"]

    # push the refraction branch where both continue
    push = go_rfl & go_trn & (st["sp"] < D) & push_ok
    slot = torch.where(push, st["sp"], D)
    oh = slot[:, None] == torch.arange(D, dtype=I32, device=act.device)

    def put(stk, val):
        if stk.dim() == 3:
            return torch.where(oh[..., None], val[:, None, :], stk)
        return torch.where(oh, val[:, None], stk)

    st_org = put(st["st_org"], h["x"])
    st_dir = put(st["st_dir"], refr_dir)
    st_thr = put(st["st_thr"], thr_trn)
    st_depth = put(st["st_depth"], st["depth"] + 1)
    st_srf = put(st["st_srf"], h["srf"])
    st_side = put(st["st_side"], h["side"])
    st_oloc = put(st["st_oloc"], h["p"])
    sp = st["sp"] + push.to(I32)

    # continue with reflection if live, else refraction, else pop
    cont = go_rfl | go_trn
    # the segment's path record (record_path, pallas_kernel.py:1871-1886);
    # a miss keeps the kernel's initial side +1 (pallas_kernel.py:1192)
    kind = torch.where(cont, torch.where(go_rfl, 1, 2), 0).to(I32)
    rec = ((torch.where(hit, h["srf"], 0) & 0xFFF)
           | ((~h["hit"] | (h["side"] > 0)).to(I32) << 12)
           | (kind << 13) | (hit.to(I32) << 15) | unlit)
    rec = torch.where(act, rec, 0)
    can_pop = act & ~cont & (sp > 0)
    psp = torch.clamp(sp - 1, min=0).long()
    if tape is not None:
        tape.append(dict(act=act, hit=hit, srf=h["srf"], side=h["side"],
                         own=hit & (h["srf"] == st["osrf"]), hm=h["hm"],
                         kind=kind, push=push, pop=can_pop,
                         slot=torch.where(push, st["sp"], psp.to(I32)),
                         **taped))
    lanes = torch.arange(N, device=act.device)

    def grab(stk):
        with record_function("lookup.grab"):
            return stk[lanes, psp]

    def sel(c, a_, b_):
        return torch.where(c[:, None] if a_.dim() == 2 else c, a_, b_)

    def upd(new, popped, old):
        return sel(cont, new, sel(can_pop, popped, old))

    return dict(
        org=upd(h["x"], grab(st_org), st["org"]),
        dir=upd(sel(go_rfl, refl_dir, refr_dir), grab(st_dir), st["dir"]),
        thr=upd(sel(go_rfl, thr_rfl, thr_trn), grab(st_thr), st["thr"]),
        depth=upd(st["depth"] + 1, grab(st_depth), st["depth"]),
        osrf=upd(h["srf"], grab(st_srf), st["osrf"]),
        oside=upd(h["side"], grab(st_side), st["oside"]),
        orow=(torch.where(cont, cull.row_of[h["srf"].clamp(min=0).long()],
                          -1) if cull is not None else st["orow"]),
        oloc=upd(h["p"], grab(st_oloc), st["oloc"]),
        thru=torch.where(cont, ~go_rfl, can_pop),   # popped = refraction
        tmin=torch.where(cont | can_pop, 0.0, st["tmin"]),
        active=act & (cont | can_pop),
        acc=acc,
        sp=torch.where(can_pop, psp.to(I32), sp),
        st_org=st_org, st_dir=st_dir, st_thr=st_thr, st_depth=st_depth,
        st_srf=st_srf, st_side=st_side, st_oloc=st_oloc,
    ), rec


def render(sc: SceneArrays, width: int, height: int, fsaa: int = 1,
           cfg: TraceConfig = TraceConfig()):
    """Full frame through the plain tracer: (H, W, 3) linear radiance."""
    from quadray_tpu_torch.ops.rays import camera_rays, resolve_aa
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, width, height, fsaa)
    t_min = sc.cam_pov.expand(dirs.shape[0])
    cols = torch.clamp(trace_rays(sc, org, dirs, t_min, cfg), 0.0, 1.0)
    return resolve_aa(cols, width, height, fsaa)


def to_frame(img, use_gamma) -> torch.Tensor:
    """Linear radiance to a uint8 frame with the reference's approximate
    gamma encode sqrt(x) (FRAME_COLX, tracer.cpp:988-997)."""
    img = torch.clamp(img, 0.0, 1.0)
    img = torch.where(use_gamma > 0, _sqrt(img), img)
    return torch.round(img * 255.0).to(torch.uint8)
