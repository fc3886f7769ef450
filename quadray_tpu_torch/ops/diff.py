"""The all-surface differentiable route in one forward and one backward
launch: the training step of ``parallel/train.py`` ``make_train_step``.

The counterpart of the JAX ``trace_rays_diff`` (``quadray_tpu/ops/
trace.py:725``) under ``jax.value_and_grad`` inside ``make_train_step``'s
jitted step (``quadray_tpu/parallel/train.py:250``), which XLA compiles
into one executable. ``ops/trace.py`` ``trace_rays_diff`` runs the same
bounces under autograd, some twenty thousand small kernels a step on the
card; it stays as the reference these are held against. Here:

  * the forward is the Whitted kernel's unculled walk with a TAPE
    (``csrc/whitted.cu`` ``whitted_tape_launch``: a thread a ray, its f32
    chain ``trace_rays``'s, so the colors are ``trace_rays``'s bit for
    bit); for each ray and bounce it records what the bounce decided and,
    where it hit, the entry state (``forward_plain`` is its plain version,
    the plain tracer's own bounce with a tape);
  * the backward (``csrc/diff.cu`` ``diff_backward_launch``) runs each
    ray's bounces in reverse, recomputes the hit that the nearest fold
    picked from the saved state, for that one surface and root, and
    applies the adjoint written out by hand (``_adjoint``), through the
    branch stack; it sums the gradients of the table rows, the lights and
    the ambient itself, each warp's 32 rays a bounce into its accumulators
    (an xor butterfly per leaf and per row the warp hit), then in
    ``replay``'s fixed order of warps, blocks and groups, with no atomics,
    so a step is the same bits run after run. Tables whose accumulators do
    not fit a block's shared memory (``rows_wide``) take the wide mode:
    each bounce's row gradients to device memory, summed per table row by
    the row gather's backward (``row_gather.row_sum_plain``'s order).

The gradient reaches only the picked hit: the clip programs, the validity
window and the shadow any-hit are masks, so the colors are a function of
the hit's entry state, its surface's row and its material's row (and the
lights and the ambient), and the adjoint is replay's along the branch
stack, with the apex nudge, the near-zero determinant root sort, the
two-plane determinant and the own-surface origin that replay omits.

The tape of a ray's bounce k: ``tf`` (K, 12, N) the entry state (origin,
direction, throughput, local origin on the origin surface), ``ti`` (K, 2 +
ceil(NL / 32), N) i32: the flags word (HIT, SIDE, ... below), the texel
the hit read (-1: none) and one bit a light row, lit and unshadowed. Its
contract (``tape_read``): the flags word of every ray and bounce (0 after
the ray retired), the rest only where the flags have HIT; the backward
reads nothing else, and takes zeros for the rest of a bounce without a
hit, so the kernel leaves those words unwritten (``forward_plain`` writes
zeros there).

The kernels take float32 and raise otherwise (the plain versions on the
CPU also take float64); both take exact and Schlick Fresnel
(``cfg.schlick``) and any stack: a ray pushes at most once a bounce, so
it holds at most d = min(stack, max_segments) slots, which the kernels
keep in local memory up to 16 and past that in a device-memory scratch
(``stack_scratch``, slot-major for the backward); the backward counts each
bounce's slot from the pushes and pops (``stack_slots``), not from the
tape's 4-bit field, touches a slot only where a bounce pushes or pops
(the plain version zeroes them and touches one every bounce: the same
bits), and starts each warp of 32 rays at its last live bounce
(``last_live``, ``warp_bounces``).

The adjoint splits ties as autograd does on ``trace_rays_diff``:
``torch.maximum``'s and ``clip``'s one half, ``torch.where``'s gradient
to the taken branch only, ``torch.clamp(min=)``'s whole gradient at the
bound, ``torch.abs``'s 0 at 0, the where-guarded sqrts and divisions no
NaN. sqrt and rsqrt are correctly rounded (``trace._sqrt``/``_rsqrt``;
``__fsqrt_rn``/``__frsqrt_rn`` in the kernel), exp and log PyTorch's (the
card's ``expf``/``logf``), so that on the card the kernels and the plain
versions agree bit for bit. Not differentiated: the rays, and the scene
fields no float row of the tables holds (``s_fwd``, which the nudge
reads, and the texture atlas): ``trace_rays_fused`` raises where they
require grad.
"""

from __future__ import annotations

import ctypes
import dataclasses
from types import SimpleNamespace

import torch

from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops import replay as rp
from quadray_tpu_torch.ops import row_gather as rg
from quadray_tpu_torch.ops import trace
from quadray_tpu_torch.ops.trace import BIG, D_EPS, T_EPS, TraceConfig, \
    _rsqrt, _sqrt
from quadray_tpu_torch.scene.compile import (
    FIELDS, SceneArrays, PROP_LIGHT, PROP_METAL, PROP_OPAQUE, PROP_REFLECT,
    PROP_REFRACT, PROP_DIFFUSE, PROP_SPECULAR, PROP_GAMMA, PROP_FRESNEL)

F32 = torch.float32
I32 = torch.int32
TAPE_ROWS = 12   # org 0-2, dir 3-5, thr 6-8, oloc 9-11
# the flags word of a ray's bounce
SRF_BITS = 0xFFFF                   # the hit surface's id (0 on a miss)
HIT, SIDE, OWN, NUDGE = 1 << 16, 1 << 17, 1 << 18, 1 << 19
KIND_SHIFT = 20                     # 0 stop, 1 reflect, 2 transmit
PUSH, POP = 1 << 22, 1 << 23
SLOT_SHIFT = 24                     # the pushed or popped slot, 4 bits
SLOT_MASK = 15                      # (stack_slots counts the slot itself)
ACTIVE = 1 << 28
LIGHT_ROWS = rp.LIGHT_ROWS
SURFACE_ROWS, MATERIAL_ROWS = rg.SURFACE_ROWS, rg.MATERIAL_ROWS

# slots a thread's branch stack holds in local memory (the kernels'
# largest instantiation; more go to a device-memory scratch, which the
# Whitted kernel shares: cuda_kernel.stack_scratch)
LOCAL_SLOTS = ck.MAX_STACK
SLOT_FLOATS = ck.SLOT   # a forward slot; the backward's 12
stack_slots_held, stack_scratch = ck.stack_slots_held, ck.stack_scratch
# the shared memory a backward block may have (the H100's opt-in 227 KB):
# tables whose accumulators need more take the wide mode (rows_wide)
ROWS_SMEM_BYTES = 232448

# calls of the forward (tape) and backward wrappers and of the light sums
# (each launches its kernels; the wide mode's row sums count in
# row_gather.backward_launches)
launches = 0
backward_launches = 0
light_sum_launches = 0


def tape_words(nl: int) -> int:
    """i32 words of a bounce's tape: flags, texel, the lights' bits."""
    return 2 + -(-nl // 32)


def tape_read(ti):
    """The tape's contract: the words the backward reads, from the flags
    words of ``ti`` (K, W, N): masks (K, 12, N) of tf and (K, W, N) of
    ti, the flags word of every ray and bounce, the rest only where the
    flags have HIT. The forward kernel writes these words and no other."""
    hit = (ti[:, 0] & HIT) != 0
    mi = hit[:, None, :].expand(-1, ti.shape[1], -1).clone()
    mi[:, 0] = True
    return hit[:, None, :].expand(-1, TAPE_ROWS, -1), mi


def _bits(t):
    return t.contiguous().view(torch.int64 if t.element_size() == 8
                               else torch.int32)


def tape_differs(tf, ti, tf2, ti2) -> int:
    """The words of the contract (``tape_read`` of ti's flags) in which
    the tape (tf2, ti2) is not bitwise (tf, ti); 0: the backward reads the
    same tape from either."""
    mf, mi = tape_read(ti)
    return int(((_bits(tf) != _bits(tf2)) & mf).sum()
               + ((ti != ti2) & mi).sum())


# ---------------------------------------------------------------------------
# the forward: the plain tracer's bounce with a tape
# ---------------------------------------------------------------------------

def _tape_words(r: dict, nl: int):
    """A bounce's (words, N) i32 tape from ``trace._bounce``'s record."""
    hit = r["hit"]
    b = lambda m: m.to(I32)
    flags = ((torch.where(hit, r["srf"], 0) & SRF_BITS)
             | (b(hit) << 16) | (b(hit & (r["side"] > 0)) << 17)
             | (b(r["own"]) << 18) | (b(hit & r["hm"]) << 19)
             | (r["kind"] << KIND_SHIFT) | (b(r["push"]) << 22)
             | (b(r["pop"]) << 23)
             | (torch.where(r["push"] | r["pop"], r["slot"] & SLOT_MASK, 0)
                << SLOT_SHIFT)
             | (b(r["act"]) << 28))
    words = [flags, torch.where(hit, r["texel"], -1)]
    for w in range(-(-nl // 32)):
        word = torch.zeros_like(flags)
        for l in range(32 * w, min(nl, 32 * w + 32)):
            word = word | (b(r["vis"][l] & hit) << (l - 32 * w))
        words.append(word)
    return torch.stack(words)


def forward_plain(sc: SceneArrays, org, dirs, t_min, cfg: TraceConfig,
                  stats=None):
    """``trace_rays``'s colors (N, 3), bit for bit, and the tape: tf (K,
    12, N) in the element type and ti (K, tape_words(NL), N) i32, K =
    cfg.max_segments (module docstring). The plain tracer's bounce
    (``trace._bounce``, unculled, every bounce of the fixed count);
    ``stats``: as for ``trace.trace_rays``."""
    N, dev, el = dirs.shape[0], dirs.device, trace.ELEMENT
    if org.dim() == 1:
        org = org[None, :].expand(N, 3)
    st = trace._fresh_state(org.to(el), dirs.to(el), t_min.to(el), cfg.stack)
    K, nl = cfg.max_segments, sc.l_pos.shape[0]
    tf = torch.zeros((K, TAPE_ROWS, N), dtype=el, device=dev)
    ti = torch.zeros((K, tape_words(nl), N), dtype=I32, device=dev)
    for k in range(K):
        rec = []
        state = torch.cat([st["org"], st["dir"], st["thr"], st["oloc"]],
                          dim=1).T
        st, _ = trace._bounce(sc, cfg, st, stats=stats, tape=rec)
        (r,) = rec
        tf[k] = torch.where(r["act"], state, 0.0)
        ti[k] = torch.where(r["act"], _tape_words(r, nl), 0)
    return st["acc"], tf, ti


# ---------------------------------------------------------------------------
# the backward: each bounce recomputed from the tape, the adjoint by hand
# ---------------------------------------------------------------------------

class Tables(SimpleNamespace):
    """What the backward reads of a scene: the differentiable tables stab
    (19, NS), mtab (10, NM), ltab (NL, 10), amb (3,), and s_kind, s_sing,
    s_mat, m_props, s_fwd (NS, 9), tex (T, 3), use_gamma, use_fresnel."""


def tables(sc: SceneArrays, rows=None) -> Tables:
    """The scene's Tables; ``rows``: (stab, mtab, ltab, amb) already built
    from its fields, else built here."""
    if rows is None:
        rows = rg.row_tables(sc) + (rp.light_table(sc), sc.amb_col)
    stab, mtab, ltab, amb = rows
    ns = sc.s_pos.shape[0]
    return Tables(stab=stab, mtab=mtab, ltab=ltab,
                  amb=amb, s_kind=sc.s_kind, s_sing=sc.s_sing,
                  s_mat=sc.s_mat, m_props=sc.m_props,
                  s_fwd=sc.s_fwd.reshape(ns, 9), tex=sc.tex_data,
                  use_gamma=sc.use_gamma, use_fresnel=sc.use_fresnel)


def _w(c, a, b):
    return torch.where(c, a, b)


def _pm(c, like):
    """+1 where c, else -1, in like's type."""
    return torch.where(c, 1.0, -1.0).to(like.dtype)


def _sgn(x):
    return _pm(x >= 0.0, x)


def _sdiv_grad(q, den, g):
    """(d num, d den) of ``_safe_div(num, den)`` = q: none where |den| <
    1e-30, whose quotient is the fallback, nor where g is 0 (no inf * 0)."""
    bad = torch.abs(den) < 1e-30
    return (torch.where(bad, 0.0, g / den),
            torch.where(bad | (g == 0.0), 0.0, -(g * (q / den))))


def _root(num, den):
    """``trace._root`` with its effective denominator: (t, ok, den')."""
    den2 = torch.where(num == 0.0, 1.0, den)
    ok = den2 != 0.0
    return torch.where(ok, num / torch.where(ok, den2, 1.0), BIG), ok, den2


def _lights_bit(words, l: int):
    return ((words[2 + l // 32] >> (l % 32)) & 1) != 0


def _recompute(T: Tables, tfk, tik, schlick: bool = False):
    """A bounce's forward from its tape, for the surface and root the
    nearest fold picked: ``intersect``'s scalar form, ``shade``,
    ``fresnel_terms`` (``schlick``: its Schlick form), ``local_w`` and the
    continuations, in the plain tracer's operations and order; returns
    the locals."""
    flags = tik[0]
    bs = (flags & SRF_BITS).long()
    sidep = (flags & SIDE) != 0
    own = (flags & OWN) != 0
    nudge = (flags & NUDGE) != 0
    texel = tik[1]
    textured = texel >= 0
    m = torch.where(sidep, T.s_mat[bs, 0], T.s_mat[bs, 1]).long()
    (px, py, pz, i00, i01, i02, i10, i11, i12, i20, i21, i22,
     sx, sy, sz, jx, jy, jz, sw) = T.stab[:, bs]
    (mc0_r, mc0_g, mc0_b, m_dff, m_spc, m_pow, m_rfl, m_trn, m_rfr,
     m_ext) = T.mtab[:, m]
    f = T.s_fwd[bs].T
    skind = T.s_kind[bs]
    sing = T.s_sing[bs]
    props = T.m_props[m]
    ox, oy, oz, dx, dy, dz, tr, tg, tb, olx, oly, olz = tfk

    # intersect, for the picked surface (ops/trace.py intersect)
    rx, ry, rz = ox - px, oy - py, oz - pz
    lx0 = i00 * rx + i01 * ry + i02 * rz
    ly0 = i10 * rx + i11 * ry + i12 * rz
    lz0 = i20 * rx + i21 * ry + i22 * rz
    lx, ly, lz = _w(own, olx, lx0), _w(own, oly, ly0), _w(own, olz, lz0)
    ex = i00 * dx + i01 * dy + i02 * dz
    ey = i10 * dx + i11 * dy + i12 * dz
    ez = i20 * dx + i21 * dy + i22 * dz
    is_pl = skind == 1
    is_tp = skind == 3
    a = sx * ex * ex + sy * ey * ey + sz * ez * ez
    ux, uy, uz = sx * lx - jx, sy * ly - jy, sz * lz - jz
    b = ux * ex + uy * ey + uz * ez
    c = (sx * lx * lx + sy * ly * ly + sz * lz * lz
         - 2.0 * (jx * lx + jy * ly + jz * lz) - sw)
    cross = lx * ez - lz * ex
    sxz = sx * sz
    asxz = torch.abs(sxz)
    disc = _w(is_tp, asxz * cross * cross, b * b - a * c)
    quad_ok = disc >= 0.0
    dpos = disc > 0.0
    sq = _w(dpos, _sqrt(_w(dpos, disc, 1.0)), 0.0)
    sgn_b = _sgn(b)
    qq = -(b + sgn_b * sq)
    b_pos = b > 0.0
    n1, d1 = _w(b_pos, qq, c), _w(b_pos, a, qq)
    n2, d2_ = _w(b_pos, c, qq), _w(b_pos, qq, a)
    t1r, ok1, dd1 = _root(n1, d1)
    t2r, ok2, dd2 = _root(n2, d2_)
    dmask = quad_ok & (disc < D_EPS)
    sgn_a = _sgn(a)
    u = (t1r - t2r) * sgn_a
    upos = u >= 0.0
    tdf = _w(upos, -0.5 * u - torch.abs(T_EPS * t1r), 0.0) * sgn_a
    srt = dmask & ok1 & ok2
    tdff = _w(srt, tdf, 0.0)
    t1 = t1r + tdff
    t2 = t2r - tdff
    t_pl = trace._safe_div(-lz, ez, BIG)
    slot_b = ~is_pl & ~sidep
    t = _w(is_pl, t_pl, _w(slot_b, t2, t1))
    hx0, hy0, hz0 = lx + t * ex, ly + t * ey, lz + t * ez
    wx0, wy0, wz0 = ox + t * dx, oy + t * dy, oz + t * dz
    # the apex nudge (CC_glb): the picked root's point, T_EPS from the apex
    cyl = sing == 2
    num_r = sx + _w(cyl, 0.0, sy)
    qr = trace._safe_div(num_r, sz, 0.0)
    ratio = torch.abs(qr)
    racc = ratio + _w(cyl, 1.0, 2.0)
    rr = _rsqrt(torch.clamp(racc, min=1e-30))
    inv_r = T_EPS * rr
    rpos = ratio > 0.0
    sqr = _w(rpos, _sqrt(_w(rpos, ratio, 1.0)), 0.0)
    a_neg = a < 0.0
    ij = _w(~sidep & ~a_neg, -1.0, 1.0)
    kf = _w(sidep & a_neg, -1.0, 1.0)
    sxl, syl, szl = _sgn(lx), _sgn(ly), _sgn(lz)
    six, siy = sxl * ij, syl * ij
    skz = szl * kf
    skq = skz * sqr
    ai = six * inv_r
    aj = _w(cyl, 0.0, siy * inv_r)
    ak = skq * inv_r
    hx, hy, hz = _w(nudge, ai, hx0), _w(nudge, aj, hy0), _w(nudge, ak, hz0)
    wx = _w(nudge, px + (f[0] * ai + f[1] * aj + f[2] * ak), wx0)
    wy = _w(nudge, py + (f[3] * ai + f[4] * aj + f[5] * ak), wy0)
    wz = _w(nudge, pz + (f[6] * ai + f[7] * aj + f[8] * ak), wz0)
    # the normal: inv^T (sci p - scjh), +K on a plane, to the hit side
    gx = _w(is_pl, 0.0, sx * hx - jx)
    gy = _w(is_pl, 0.0, sy * hy - jy)
    gz = _w(is_pl, 1.0, sz * hz - jz)
    sf = _pm(sidep, ox)
    nrx = (i00 * gx + i10 * gy + i20 * gz) * sf
    nry = (i01 * gx + i11 * gy + i21 * gz) * sf
    nrz = (i02 * gx + i12 * gy + i22 * gz) * sf
    qn = nrx * nrx + nry * nry + nrz * nrz
    nn = _rsqrt(torch.clamp(qn, min=1e-30))
    nx, ny, nz = nrx * nn, nry * nn, nrz * nn

    # shade (the texture's color carries no gradient)
    bit = lambda p_: (props & p_) != 0
    ug, uf = T.use_gamma > 0, T.use_fresnel > 0
    tcol = T.tex[torch.clamp(texel, min=0).long()].T
    mt_r = _w(textured, tcol[0], mc0_r)
    mt_g = _w(textured, tcol[1], mc0_g)
    mt_b = _w(textured, tcol[2], mc0_b)
    gam = bit(PROP_GAMMA) & ug
    mc_r = _w(gam, mt_r * mt_r, mt_r)
    mc_g = _w(gam, mt_g * mt_g, mt_g)
    mc_b = _w(gam, mt_b * mt_b, mt_b)
    metal, diffuse = bit(PROP_METAL), bit(PROP_DIFFUSE)
    specular, emis = bit(PROP_SPECULAR), bit(PROP_LIGHT)
    refracts = bit(PROP_REFRACT)
    fres_prop = bit(PROP_FRESNEL) & uf
    fres = fres_prop & ~bit(PROP_OPAQUE)
    rf_mask = fres_prop & bit(PROP_OPAQUE) & bit(PROP_REFLECT)
    d2 = dx * dx + dy * dy + dz * dz
    v = SimpleNamespace(**locals())
    col_r, col_g, col_b = mc_r * T.amb[0], mc_g * T.amb[1], mc_b * T.amb[2]
    for l in range(T.ltab.shape[0]):
        li = _light(T.ltab, l, v, _lights_bit(tik, l))
        col_r = col_r + li.term_r
        col_g = col_g + li.term_g
        col_b = col_b + li.term_b
    v.col_r = _w(emis, mc_r, col_r)
    v.col_g = _w(emis, mc_g, col_g)
    v.col_b = _w(emis, mc_b, col_b)

    # fresnel_terms
    v.dl = dl = _rsqrt(torch.clamp(d2, min=1e-30))
    v.rhx, v.rhy, v.rhz = rhx, rhy, rhz = dx * dl, dy * dl, dz * dl
    v.dot = dot = rhx * nx + rhy * ny + rhz * nz
    v.eta = eta = m_rfr
    v.ed = ed = eta * dot
    v.ksn = ksn = 1.0 - eta * eta + ed * ed
    v.tir = tir = (ksn < 0.0) & refracts
    v.kpos = kpos = ksn > 0.0
    v.sqk = sqk = _w(kpos, _sqrt(_w(kpos, ksn, 1.0)), 0.0)
    v.esq = esq = ed + sqk
    v.rfx = _w(refracts, eta * rhx - nx * esq, rhx)
    v.rfy = _w(refracts, eta * rhy - ny * esq, rhy)
    v.rfz = _w(refracts, eta * rhz - nz * esq, rhz)
    v.den_rs = den_rs = ed - sqk
    v.rs = rs = trace._safe_div(esq, den_rs, 1.0)
    v.es = es = eta * sqk
    v.den_rp = den_rp = dot - es
    v.rp = rp_ = trace._safe_div(dot + es, den_rp, 1.0)
    v.s_f = s_f = rs * rs + rp_ * rp_
    v.schlick = schlick
    if schlick:
        # trace.fresnel_schlick
        v.big = big = eta > 1.0
        v.xs = xs = _w(big, 1.0 - sqk, 1.0 + dot)
        v.den_r = den_r = eta + 1.0
        v.r = r = trace._safe_div(eta - 1.0, den_r, 1.0)
        v.r0 = r0 = r * r
        v.xx = xx = xs * xs
        v.x4 = x4 = xx * xx
        v.x5 = x5 = x4 * xs
        v.fr0 = fr0 = r0 + (1.0 - r0) * x5
    else:
        v.fr0 = fr0 = 0.5 * s_f
    fr = _w(fres, trace.clip(fr0, 0.0, 1.0), 0.0)
    v.fr = fr = _w(tir & fres, 1.0, fr)
    v.c_trn = _w(tir, 0.0, m_trn * (1.0 - fr))
    v.c_rfl0 = c_rfl0 = m_rfl + m_trn * fr
    v.rcp = rcp = trace._safe_div(torch.ones_like(eta), eta, 0.0)
    v.ext2 = ext2 = m_ext * m_ext
    v.t2m = t2m = 2.0 * dot * rcp
    v.c2 = c2 = dot * dot
    v.gg = gg = rcp * rcp + ext2
    v.x0 = x0 = c2 + gg
    v.x1 = x1 = c2 * gg + 1.0
    v.den_a = den_a = x0 - t2m
    v.fa = fa = trace._safe_div(x0 + t2m, den_a, 1.0)
    v.den_b = den_b = x1 - t2m
    v.fb = fb = trace._safe_div(x1 + t2m, den_b, 1.0)
    v.vm = vm = -0.5 * (fa + fb)
    v.vp = vp = -0.5 * s_f
    v.f_rf = f_rf = _w(metal, torch.abs(vm), torch.abs(vp))
    v.c_rfl = _w(rf_mask, m_rfl * f_rf, c_rfl0)
    v.lw0 = lw0 = 1.0 - m_trn - m_rfl
    v.lw = torch.maximum(lw0, torch.zeros((), dtype=lw0.dtype,
                                          device=lw0.device))
    v.ddn = ddn = dx * nx + dy * ny + dz * nz
    v.t2d = 2.0 * ddn
    return v


def _light(ltab, l: int, v, vis):
    """Light l's term of the bounce's color (``shade``'s operations and
    order; ``vis``: lit and unshadowed), with what its adjoint reads."""
    lpx, lpy, lpz, lcr, lcg, lcb, _, cnt, lnr, qdr = (
        ltab[l, j] for j in range(LIGHT_ROWS))
    lvx = lpx - v.wx
    lvy = lpy - v.wy
    lvz = lpz - v.wz
    r_dot = lvx * v.nx + lvy * v.ny + lvz * v.nz
    r2 = lvx * lvx + lvy * lvy + lvz * lvz
    r = _sqrt(torch.clamp(r2, min=1e-30))
    den = cnt + lnr * r + qdr * r2
    attn = _rsqrt(torch.clamp(den, min=1e-30))
    don = vis & v.diffuse
    dfs = _w(don, r_dot / r * attn * v.m_dff, 0.0)
    t2r = 2.0 * r_dot
    rlx = lvx - t2r * v.nx
    rly = lvy - t2r * v.ny
    rlz = lvz - t2r * v.nz
    sdot = rlx * v.dx + rly * v.dy + rlz * v.dz
    d2r2 = v.d2 * r2
    rs2 = _rsqrt(torch.clamp(d2r2, min=1e-30))
    cosr0 = sdot * rs2
    spc_on = vis & (sdot > 0.0) & v.specular
    cosr_s = _w(spc_on, cosr0, 1.0)
    cosr = trace.clip(cosr_s, 1e-6, 1.0)
    lg = torch.log(cosr)
    e = torch.exp(v.m_pow * lg)
    spc = _w(spc_on, e * v.m_spc, 0.0)
    tm = dfs + spc
    mclc_r = v.mc_r * lcr
    mclc_g = v.mc_g * lcg
    mclc_b = v.mc_b * lcb
    term_r = _w(v.metal, mclc_r * tm, mclc_r * dfs + lcr * spc)
    term_g = _w(v.metal, mclc_g * tm, mclc_g * dfs + lcg * spc)
    term_b = _w(v.metal, mclc_b * tm, mclc_b * dfs + lcb * spc)
    return SimpleNamespace(**locals())


def _adjoint(v, T: Tables, tik, g_acc, gn, gsl):
    """A hit bounce's adjoint. g_acc: the colors' gradient (3 rows); gn:
    the next state's (origin, direction, throughput, local origin: 12
    rows); gsl: the pushed slot's (12 rows, zero where nothing was
    pushed). Returns (the surface row's 19 gradients, the material row's
    10, the lights' 10 each and the ambient's 3, the entry state's 12),
    each (N,). csrc/diff.cu ``adjoint`` is this, line for line, but for
    the Schlick branch (``v.schlick``), which the kernels have not."""
    W = _w
    flags = tik[0]
    kind = (flags >> KIND_SHIFT) & 3
    is_rfl, is_trn = kind == 1, kind == 2
    cont = kind > 0
    push = (flags & PUSH) != 0
    dx, dy, dz, nx, ny, nz = v.dx, v.dy, v.dz, v.nx, v.ny, v.nz
    tr, tg, tb = v.tr, v.tg, v.tb
    # the next state: org = x, dir = reflect ? mr : rf, thr = thr * w, oloc
    # = p; the pushed slot: x, rf, thr * c_trn, p
    gwx = W(cont, gn[0], 0.0) + W(push, gsl[0], 0.0)
    gwy = W(cont, gn[1], 0.0) + W(push, gsl[1], 0.0)
    gwz = W(cont, gn[2], 0.0) + W(push, gsl[2], 0.0)
    gmrx = W(is_rfl, gn[3], 0.0)
    gmry = W(is_rfl, gn[4], 0.0)
    gmrz = W(is_rfl, gn[5], 0.0)
    grfx = W(is_trn, gn[3], 0.0) + W(push, gsl[3], 0.0)
    grfy = W(is_trn, gn[4], 0.0) + W(push, gsl[4], 0.0)
    grfz = W(is_trn, gn[5], 0.0) + W(push, gsl[5], 0.0)
    gtlr = W(is_rfl, gn[6], 0.0)
    gtlg = W(is_rfl, gn[7], 0.0)
    gtlb = W(is_rfl, gn[8], 0.0)
    gttr = W(is_trn, gn[6], 0.0) + W(push, gsl[6], 0.0)
    gttg = W(is_trn, gn[7], 0.0) + W(push, gsl[7], 0.0)
    gttb = W(is_trn, gn[8], 0.0) + W(push, gsl[8], 0.0)
    ghx = W(cont, gn[9], 0.0) + W(push, gsl[9], 0.0)
    ghy = W(cont, gn[10], 0.0) + W(push, gsl[10], 0.0)
    ghz = W(cont, gn[11], 0.0) + W(push, gsl[11], 0.0)
    # trl = thr c_rfl, trn = thr c_trn
    g_crfl = gtlr * tr + gtlg * tg + gtlb * tb
    g_ctrn = gttr * tr + gttg * tg + gttb * tb
    gtr = gtlr * v.c_rfl + gttr * v.c_trn
    gtg = gtlg * v.c_rfl + gttg * v.c_trn
    gtb = gtlb * v.c_rfl + gttb * v.c_trn
    # mr = d - (2 ddn) n, ddn = d . n
    gddn = -2.0 * (gmrx * nx + gmry * ny + gmrz * nz)
    gnx = gddn * dx - v.t2d * gmrx
    gny = gddn * dy - v.t2d * gmry
    gnz = gddn * dz - v.t2d * gmrz
    gdx = gmrx + gddn * nx
    gdy = gmry + gddn * ny
    gdz = gmrz + gddn * nz

    # c_rfl = rf_mask ? m_rfl * f_rf : m_rfl + m_trn * fr
    g_frf = W(v.rf_mask, g_crfl * v.m_rfl, 0.0)
    g_crfl0 = W(v.rf_mask, 0.0, g_crfl)
    g_rfl = W(v.rf_mask, g_crfl * v.f_rf, 0.0) + g_crfl0
    g_fr = g_crfl0 * v.m_trn
    g_trn = g_crfl0 * v.fr
    # c_trn = tir ? 0 : m_trn * (1 - fr)
    g_trn = g_trn + W(v.tir, 0.0, g_ctrn * (1.0 - v.fr))
    g_fr = g_fr - W(v.tir, 0.0, g_ctrn * v.m_trn)
    # fr = (tir & fres) ? 1 : fres ? clip(fr0, 0, 1) : 0
    g_fr0 = rp._clip_grad(v.fr0, 0.0, 1.0, W(v.fres & ~v.tir, g_fr, 0.0))
    if v.schlick:
        # fr0 = r0 + (1 - r0) x5, x5 = (xs^2)^2 xs, r0 = r^2,
        # r = (eta - 1) / (eta + 1), xs = eta > 1 ? 1 - sqk : 1 + dot
        g_sf = torch.zeros_like(g_fr0)
        g_x5 = g_fr0 * (1.0 - v.r0)
        g_r0 = g_fr0 - g_fr0 * v.x5
        g_x4 = g_x5 * v.xs
        g_xs = g_x5 * v.x4
        g_xx = 2.0 * g_x4 * v.xx
        g_xs = g_xs + 2.0 * g_xx * v.xs
        gnr, gdr = _sdiv_grad(v.r, v.den_r, 2.0 * g_r0 * v.r)
        g_eta_s = gnr + gdr
        g_sqk_s = -W(v.big, g_xs, 0.0)
        g_dot_s = W(v.big, 0.0, g_xs)
    else:
        g_sf = 0.5 * g_fr0
    # f_rf = metal ? |vm| : |vp|
    g_vm = W(v.metal, g_frf, 0.0) * rp._sgn0(v.vm)
    g_sf = g_sf + -0.5 * (W(v.metal, 0.0, g_frf) * rp._sgn0(v.vp))
    g_fab = -0.5 * g_vm
    gna, gda = _sdiv_grad(v.fa, v.den_a, g_fab)
    gnb, gdb = _sdiv_grad(v.fb, v.den_b, g_fab)
    gx0 = gna + gda
    gx1 = gnb + gdb
    gt2m = (gna - gda) + (gnb - gdb)
    gc2 = gx1 * v.gg + gx0
    ggg = gx1 * v.c2 + gx0
    grcp = 2.0 * ggg * v.rcp + gt2m * (2.0 * v.dot)
    g_ext = 2.0 * ggg * v.m_ext
    gdot = 2.0 * gc2 * v.dot + 2.0 * (gt2m * v.rcp)
    if v.schlick:
        gdot = gdot + g_dot_s
    _, g_rfr = _sdiv_grad(v.rcp, v.eta, grcp)
    # s_f = rs^2 + rp^2
    grs = 2.0 * g_sf * v.rs
    grp = 2.0 * g_sf * v.rp
    gns, gds = _sdiv_grad(v.rs, v.den_rs, grs)
    ged = gns + gds
    gsqk = gns - gds
    gnp, gdp = _sdiv_grad(v.rp, v.den_rp, grp)
    gdot = gdot + (gnp + gdp)
    ges = gnp - gdp
    geta = ges * v.sqk
    gsqk = gsqk + ges * v.eta
    if v.schlick:
        geta = geta + g_eta_s
        gsqk = gsqk + g_sqk_s
    # rf = refracts ? eta rh - n (ed + sqk) : rh
    gqx = W(v.refracts, grfx, 0.0)
    gqy = W(v.refracts, grfy, 0.0)
    gqz = W(v.refracts, grfz, 0.0)
    grhx = W(v.refracts, 0.0, grfx) + v.eta * gqx
    grhy = W(v.refracts, 0.0, grfy) + v.eta * gqy
    grhz = W(v.refracts, 0.0, grfz) + v.eta * gqz
    geta = geta + (gqx * v.rhx + gqy * v.rhy + gqz * v.rhz)
    gesq = -(gqx * nx + gqy * ny + gqz * nz)
    gnx = gnx - gqx * v.esq
    gny = gny - gqy * v.esq
    gnz = gnz - gqz * v.esq
    ged = ged + gesq
    gsqk = gsqk + gesq
    # sqk = ksn > 0 ? sqrt(ksn) : 0; ksn = 1 - eta^2 + ed^2; ed = eta dot
    gksn = W(v.kpos, gsqk / (2.0 * W(v.kpos, v.sqk, 1.0)), 0.0)
    geta = geta - 2.0 * gksn * v.eta
    ged = ged + 2.0 * gksn * v.ed
    geta = geta + ged * v.dot
    gdot = gdot + ged * v.eta
    g_rfr = g_rfr + geta
    # dot = rh . n; rh = d dl; dl = rsqrt(max(d2, 1e-30))
    grhx = grhx + gdot * nx
    grhy = grhy + gdot * ny
    grhz = grhz + gdot * nz
    gnx = gnx + gdot * v.rhx
    gny = gny + gdot * v.rhy
    gnz = gnz + gdot * v.rhz
    gdx = gdx + grhx * v.dl
    gdy = gdy + grhy * v.dl
    gdz = gdz + grhz * v.dl
    gdl = grhx * dx + grhy * dy + grhz * dz
    g_d2 = rp._clampmin_grad(v.d2, 1e-30, -0.5 * gdl * (v.dl * v.dl * v.dl))

    # acc += (thr col) lw
    gar, gag, gab = g_acc
    glw = gar * (tr * v.col_r) + gag * (tg * v.col_g) + gab * (tb * v.col_b)
    gcr = gar * v.lw * tr
    gcg = gag * v.lw * tg
    gcb = gab * v.lw * tb
    gtr = gtr + gar * v.lw * v.col_r
    gtg = gtg + gag * v.lw * v.col_g
    gtb = gtb + gab * v.lw * v.col_b
    # lw = max(1 - m_trn - m_rfl, 0): one half at the tie
    glw0 = W(v.lw0 < 0.0, 0.0, W(v.lw0 == 0.0, 0.5 * glw, glw))
    g_trn = g_trn - glw0
    g_rfl = g_rfl - glw0
    # col = emis ? mc : ambient + lights
    gmr = W(v.emis, gcr, 0.0)
    gmg = W(v.emis, gcg, 0.0)
    gmb = W(v.emis, gcb, 0.0)
    gcr = W(v.emis, 0.0, gcr)
    gcg = W(v.emis, 0.0, gcg)
    gcb = W(v.emis, 0.0, gcb)
    zero = torch.zeros_like(dx)
    g_dff = g_spc = g_pow = zero
    g_lights = []
    for l in range(T.ltab.shape[0]):
        li = _light(T.ltab, l, v, _lights_bit(tik, l))
        # term = metal ? (mc lc) tm : (mc lc) dfs + lc spc; tm = dfs + spc
        gqr = W(v.metal, gcr * li.tm, gcr * li.dfs)
        gqg = W(v.metal, gcg * li.tm, gcg * li.dfs)
        gqb = W(v.metal, gcb * li.tm, gcb * li.dfs)
        gdfs = gcr * li.mclc_r + gcg * li.mclc_g + gcb * li.mclc_b
        gspc = W(v.metal, gdfs, gcr * li.lcr + gcg * li.lcg + gcb * li.lcb)
        glcr = W(v.metal, 0.0, gcr * li.spc) + gqr * v.mc_r
        glcg = W(v.metal, 0.0, gcg * li.spc) + gqg * v.mc_g
        glcb = W(v.metal, 0.0, gcb * li.spc) + gqb * v.mc_b
        gmr = gmr + gqr * li.lcr
        gmg = gmg + gqg * li.lcg
        gmb = gmb + gqb * li.lcb
        # spc = spc_on ? exp(m_pow log(cosr)) m_spc : 0
        ge = W(li.spc_on, gspc * v.m_spc, 0.0)
        g_spc = g_spc + W(li.spc_on, gspc * li.e, 0.0)
        gy = ge * li.e
        g_pow = g_pow + gy * li.lg
        gcos = gy * v.m_pow / li.cosr
        gcos0 = W(li.spc_on, rp._clip_grad(li.cosr_s, 1e-6, 1.0, gcos), 0.0)
        # cosr0 = sdot rsqrt(max(d2 r2, 1e-30))
        gsdot = gcos0 * li.rs2
        gd2r2 = rp._clampmin_grad(li.d2r2, 1e-30, -0.5 * (gcos0 * li.sdot)
                                  * (li.rs2 * li.rs2 * li.rs2))
        g_d2 = g_d2 + gd2r2 * li.r2
        gr2 = gd2r2 * v.d2
        # sdot = rl . d; rl = lv - (2 r_dot) n
        grlx = gsdot * dx
        grly = gsdot * dy
        grlz = gsdot * dz
        gdx = gdx + gsdot * li.rlx
        gdy = gdy + gsdot * li.rly
        gdz = gdz + gsdot * li.rlz
        grdot = -2.0 * (grlx * nx + grly * ny + grlz * nz)
        gnx = gnx - li.t2r * grlx
        gny = gny - li.t2r * grly
        gnz = gnz - li.t2r * grlz
        # dfs = don ? ((r_dot / r) attn) m_dff : 0
        a1 = li.r_dot / li.r
        a2 = a1 * li.attn
        g_dff = g_dff + W(li.don, gdfs * a2, 0.0)
        ga2 = W(li.don, gdfs * v.m_dff, 0.0)
        ga1 = ga2 * li.attn
        gattn = ga2 * a1
        grdot = grdot + ga1 / li.r
        gr = -(ga1 * (a1 / li.r))
        # attn = rsqrt(max(cnt + lnr r + qdr r2, 1e-30))
        gden = rp._clampmin_grad(li.den, 1e-30, -0.5 * gattn
                                 * (li.attn * li.attn * li.attn))
        gr = gr + gden * li.lnr
        gr2 = gr2 + gden * li.qdr
        # r = sqrt(max(r2, 1e-30)); r2 = lv . lv; r_dot = lv . n
        gr2 = gr2 + rp._clampmin_grad(li.r2, 1e-30, gr / (2.0 * li.r))
        glvx = grlx + 2.0 * gr2 * li.lvx + grdot * nx
        glvy = grly + 2.0 * gr2 * li.lvy + grdot * ny
        glvz = grlz + 2.0 * gr2 * li.lvz + grdot * nz
        gnx = gnx + grdot * li.lvx
        gny = gny + grdot * li.lvy
        gnz = gnz + grdot * li.lvz
        # lv = l_pos - w
        gwx = gwx - glvx
        gwy = gwy - glvy
        gwz = gwz - glvz
        g_lights += [glvx, glvy, glvz, glcr, glcg, glcb, zero, gden,
                     gden * li.r, gden * li.r2]
    # ambient: col0 = mc amb
    g_lights += [gcr * v.mc_r, gcg * v.mc_g, gcb * v.mc_b]
    gmr = gmr + gcr * T.amb[0]
    gmg = gmg + gcg * T.amb[1]
    gmb = gmb + gcb * T.amb[2]
    # mc = gam ? mt^2 : mt; mt = textured ? texel : m_col
    gmr = W(v.gam, 2.0 * gmr * v.mt_r, gmr)
    gmg = W(v.gam, 2.0 * gmg * v.mt_g, gmg)
    gmb = W(v.gam, 2.0 * gmb * v.mt_b, gmb)
    gmr = W(v.textured, 0.0, gmr)
    gmg = W(v.textured, 0.0, gmg)
    gmb = W(v.textured, 0.0, gmb)
    # d2 = d . d
    gdx = gdx + 2.0 * g_d2 * dx
    gdy = gdy + 2.0 * g_d2 * dy
    gdz = gdz + 2.0 * g_d2 * dz

    # n = nr rsqrt(max(nr . nr, 1e-30)), nr = (I^T g) sf
    gnrx = gnx * v.nn
    gnry = gny * v.nn
    gnrz = gnz * v.nn
    gnn = gnx * v.nrx + gny * v.nry + gnz * v.nrz
    gqn = rp._clampmin_grad(v.qn, 1e-30, -0.5 * gnn * (v.nn * v.nn * v.nn))
    gnrx = gnrx + 2.0 * gqn * v.nrx
    gnry = gnry + 2.0 * gqn * v.nry
    gnrz = gnrz + 2.0 * gqn * v.nrz
    gmx = gnrx * v.sf
    gmy = gnry * v.sf
    gmz = gnrz * v.sf
    gi00, gi10, gi20 = gmx * v.gx, gmx * v.gy, gmx * v.gz
    gi01, gi11, gi21 = gmy * v.gx, gmy * v.gy, gmy * v.gz
    gi02, gi12, gi22 = gmz * v.gx, gmz * v.gy, gmz * v.gz
    ggx = W(v.is_pl, 0.0, v.i00 * gmx + v.i01 * gmy + v.i02 * gmz)
    ggy = W(v.is_pl, 0.0, v.i10 * gmx + v.i11 * gmy + v.i12 * gmz)
    ggz = W(v.is_pl, 0.0, v.i20 * gmx + v.i21 * gmy + v.i22 * gmz)
    # g = s h - j (not on planes)
    gsx = ggx * v.hx
    gsy = ggy * v.hy
    gsz = ggz * v.hz
    ghx = ghx + ggx * v.sx
    ghy = ghy + ggy * v.sy
    ghz = ghz + ggz * v.sz
    gjx = -ggx
    gjy = -ggy
    gjz = -ggz

    # the nudge: h = adj, w = pos + fwd adj (no gradient to t, o, d)
    nudge = v.nudge
    gpx = W(nudge, gwx, 0.0)
    gpy = W(nudge, gwy, 0.0)
    gpz = W(nudge, gwz, 0.0)
    f = v.f
    gai = W(nudge, ghx + (f[0] * gwx + f[3] * gwy + f[6] * gwz), 0.0)
    gaj = W(nudge & ~v.cyl, ghy + (f[1] * gwx + f[4] * gwy + f[7] * gwz),
            0.0)
    gak = W(nudge, ghz + (f[2] * gwx + f[5] * gwy + f[8] * gwz), 0.0)
    ginv_r = gai * v.six + gaj * v.siy + gak * v.skq
    gsqr = gak * v.skz * v.inv_r
    gracc = rp._clampmin_grad(v.racc, 1e-30, -0.5 * (T_EPS * ginv_r)
                              * (v.rr * v.rr * v.rr))
    gratio = gracc + W(v.rpos, gsqr / (2.0 * W(v.rpos, v.sqr, 1.0)), 0.0)
    gqr = gratio * rp._sgn0(v.qr)
    gnum_r, gsz_r = _sdiv_grad(v.qr, v.sz, gqr)
    gsx = gsx + gnum_r
    gsy = gsy + W(v.cyl, 0.0, gnum_r)
    gsz = gsz + gsz_r
    # h = l + t e; w = o + t d
    gwx = W(nudge, 0.0, gwx)
    gwy = W(nudge, 0.0, gwy)
    gwz = W(nudge, 0.0, gwz)
    ghx = W(nudge, 0.0, ghx)
    ghy = W(nudge, 0.0, ghy)
    ghz = W(nudge, 0.0, ghz)
    gox, goy, goz = gwx, gwy, gwz
    gt = (gwx * dx + gwy * dy + gwz * dz) + (ghx * v.ex + ghy * v.ey
                                             + ghz * v.ez)
    gdx = gdx + v.t * gwx
    gdy = gdy + v.t * gwy
    gdz = gdz + v.t * gwz
    glx, gly, glz = ghx, ghy, ghz
    gex = v.t * ghx
    gey = v.t * ghy
    gez = v.t * ghz
    # t = plane ? t_pl : slot_b ? t1r - tdff : t1r + tdff
    gtpl = W(v.is_pl, gt, 0.0)
    gt1 = W(v.is_pl | v.slot_b, 0.0, gt)
    gt2 = W(~v.is_pl & v.slot_b, gt, 0.0)
    gnum_p, gden_p = _sdiv_grad(v.t_pl, v.ez, gtpl)
    glz = glz - gnum_p
    gez = gez + gden_p
    # tdff = srt ? (u >= 0 ? -0.5 u - |T_EPS t1r| : 0) sgn_a : 0,
    # u = (t1r - t2r) sgn_a
    gtdf = W(v.srt, gt1 - gt2, 0.0)
    gX = W(v.upos, gtdf * v.sgn_a, 0.0)
    gu = -0.5 * gX
    gt1r = gt1 - (gX * rp._sgn0(T_EPS * v.t1r)) * T_EPS + gu * v.sgn_a
    gt2r = gt2 - gu * v.sgn_a
    gn1, gd1 = _root_grad2(v.n1, v.t1r, v.ok1, v.dd1, gt1r)
    gn2, gd2 = _root_grad2(v.n2, v.t2r, v.ok2, v.dd2, gt2r)
    gqq = W(v.b_pos, gn1, gd1) + W(v.b_pos, gd2, gn2)
    gc = W(v.b_pos, gn2, gn1)
    ga = W(v.b_pos, gd1, gd2)
    # qq = -(b + sgn_b sq); sq = disc > 0 ? sqrt(disc) : 0
    gb = -gqq
    gsq = -(gqq * v.sgn_b)
    gdisc = W(v.dpos, gsq / (2.0 * W(v.dpos, v.sq, 1.0)), 0.0)
    gdtp = W(v.is_tp, gdisc, 0.0)
    gdq = W(v.is_tp, 0.0, gdisc)
    # disc = tp ? (|sx sz| cross) cross : b b - a c
    gcross = 2.0 * gdtp * (v.asxz * v.cross)
    gsxz = gdtp * (v.cross * v.cross) * rp._sgn0(v.sxz)
    gsx = gsx + gsxz * v.sz
    gsz = gsz + gsxz * v.sx
    glx = glx + gcross * v.ez
    gez = gez + gcross * v.lx
    glz = glz - gcross * v.ex
    gex = gex - gcross * v.lz
    gb = gb + 2.0 * gdq * v.b
    ga = ga - gdq * v.c
    gc = gc - gdq * v.a
    # a = sum s e e
    gsx = gsx + ga * v.ex * v.ex
    gsy = gsy + ga * v.ey * v.ey
    gsz = gsz + ga * v.ez * v.ez
    gex = gex + 2.0 * ga * v.sx * v.ex
    gey = gey + 2.0 * ga * v.sy * v.ey
    gez = gez + 2.0 * ga * v.sz * v.ez
    # b = sum (s l - j) e
    gux = gb * v.ex
    guy = gb * v.ey
    guz = gb * v.ez
    gex = gex + gb * v.ux
    gey = gey + gb * v.uy
    gez = gez + gb * v.uz
    gsx = gsx + gux * v.lx
    gsy = gsy + guy * v.ly
    gsz = gsz + guz * v.lz
    glx = glx + gux * v.sx
    gly = gly + guy * v.sy
    glz = glz + guz * v.sz
    gjx = gjx - gux
    gjy = gjy - guy
    gjz = gjz - guz
    # c = sum s l l - 2 sum j l - sw
    gsx = gsx + gc * v.lx * v.lx
    gsy = gsy + gc * v.ly * v.ly
    gsz = gsz + gc * v.lz * v.lz
    glx = glx + 2.0 * gc * v.sx * v.lx - 2.0 * gc * v.jx
    gly = gly + 2.0 * gc * v.sy * v.ly - 2.0 * gc * v.jy
    glz = glz + 2.0 * gc * v.sz * v.lz - 2.0 * gc * v.jz
    gjx = gjx - 2.0 * gc * v.lx
    gjy = gjy - 2.0 * gc * v.ly
    gjz = gjz - 2.0 * gc * v.lz
    gsw = -gc
    # l = own ? oloc : I (o - p); e = I d
    golx = W(v.own, glx, 0.0)
    goly = W(v.own, gly, 0.0)
    golz = W(v.own, glz, 0.0)
    glx = W(v.own, 0.0, glx)
    gly = W(v.own, 0.0, gly)
    glz = W(v.own, 0.0, glz)
    gi00 = gi00 + glx * v.rx + gex * dx
    gi01 = gi01 + glx * v.ry + gex * dy
    gi02 = gi02 + glx * v.rz + gex * dz
    gi10 = gi10 + gly * v.rx + gey * dx
    gi11 = gi11 + gly * v.ry + gey * dy
    gi12 = gi12 + gly * v.rz + gey * dz
    gi20 = gi20 + glz * v.rx + gez * dx
    gi21 = gi21 + glz * v.ry + gez * dy
    gi22 = gi22 + glz * v.rz + gez * dz
    grx = v.i00 * glx + v.i10 * gly + v.i20 * glz
    gry = v.i01 * glx + v.i11 * gly + v.i21 * glz
    grz = v.i02 * glx + v.i12 * gly + v.i22 * glz
    gdx = gdx + (v.i00 * gex + v.i10 * gey + v.i20 * gez)
    gdy = gdy + (v.i01 * gex + v.i11 * gey + v.i21 * gez)
    gdz = gdz + (v.i02 * gex + v.i12 * gey + v.i22 * gez)
    gox = gox + grx
    goy = goy + gry
    goz = goz + grz
    g_srow = [gpx - grx, gpy - gry, gpz - grz, gi00, gi01, gi02, gi10,
              gi11, gi12, gi20, gi21, gi22, gsx, gsy, gsz, gjx, gjy, gjz, gsw]
    g_mrow = [gmr, gmg, gmb, g_dff, g_spc, g_pow, g_rfl, g_trn, g_rfr, g_ext]
    return (g_srow, g_mrow, g_lights,
            [gox, goy, goz, gdx, gdy, gdz, gtr, gtg, gtb, golx, goly, golz])


def _root_grad2(num, t, ok, den, g):
    """(d num, d den) of ``trace._root(num, den)`` = t, ok, its effective
    denominator den (1 where num == 0): none where the root is invalid,
    none to the denominator where num == 0, nor where g is 0."""
    return (torch.where(ok, g / den, 0.0),
            torch.where((num == 0.0) | ~ok | (g == 0.0), 0.0,
                        -(g * (t / den))))


def stack_slots(ti):
    """Each bounce's pushed or popped slot (K, N) int64 (0 where neither),
    counted from the tape's pushes and pops before it: a push fills the
    slot at the stack's height, a pop empties the one below it. The tape's
    own slot field is this modulo 16."""
    pushes, pops = (ti[:, 0] & PUSH) != 0, (ti[:, 0] & POP) != 0
    step = pushes.long() - pops.long()
    height = torch.cumsum(step, dim=0) - step       # before each bounce
    return torch.where(pushes, height, torch.where(pops, height - 1, 0))


def last_live(ti):
    """Each ray's last live bounce (N,) int64: the last whose flags have a
    hit, a push or a pop (a pop can come without a hit), -1 where none.
    After it a ray's reverse pass changes nothing (no adjoint, no slot, the
    next state's gradient kept), so ``diff_bwd_kernel``'s warp starts at
    its lanes' largest (``warp_bounces``)."""
    live = (ti[:, 0] & (HIT | PUSH | POP)) != 0
    ks = torch.arange(ti.shape[0], device=ti.device)[:, None]
    return torch.where(live, ks, -1).amax(dim=0)


def warp_bounces(ti):
    """The bounces each warp of 32 consecutive rays runs in the backward
    kernel (ceil(N / 32),) int64: one more than its lanes' largest
    ``last_live`` (0: the warp runs none)."""
    last = torch.nn.functional.pad(last_live(ti), (0, -ti.shape[2] % rp.WARP),
                                   value=-1)
    return last.view(-1, rp.WARP).amax(dim=1) + 1


def rows_wide(T: Tables, smem: int = ROWS_SMEM_BYTES) -> bool:
    """Whether the backward takes the wide mode: its BWD_WARPS warps'
    accumulators of every column (``table_columns``) need more than
    ``smem`` bytes of a block's shared memory."""
    return 4 * rp.BWD_WARPS * table_columns(T) > smem


def table_columns(T: Tables) -> int:
    """The partials' columns: the lights' 10 NL and the ambient's 3, then
    stab's 19 NS and mtab's 10 NM, each row-major."""
    return (LIGHT_ROWS * T.ltab.shape[0] + 3 + SURFACE_ROWS * T.stab.shape[1]
            + MATERIAL_ROWS * T.mtab.shape[1])


def _row_tiles(g, ids, hit, rows: int):
    """(F rows, ceil(N / 32)): for each table row r, the tile sums
    (``replay._tile_sums``) of g (F, N) masked to the rays whose row is r
    (+0.0 elsewhere), in (F, rows) row-major order."""
    tiles = [rp._tile_sums(torch.where(hit & (ids == r), g, 0.0))
             for r in range(rows)]
    return torch.stack(tiles, dim=1).reshape(g.shape[0] * rows, -1)


def backward_rows_plain(g_cols, T: Tables, tf, ti, stack: int,
                        schlick: bool = False, wide: bool = False):
    """The backward kernel's per-ray work: the bounces in reverse, each
    hit recomputed from the tape (``_recompute``, ``schlick`` its Fresnel;
    only the words ``tape_read`` names are read, a bounce without a hit
    on zeros) and its adjoint (``_adjoint``) taken; a popped slot's
    gradient kept until its push (the slots from ``stack_slots``, so any
    stack depth).
    Returns (g_s, g_m, ids, tiles). tiles: the tables' gradients summed
    per tile of 32 rays, the tiles' sums added bounce after bounce from
    +0.0: columns ``table_columns`` (the lights', the ambient's, then
    stab's and mtab's, each leaf masked to the rays that hit its row), or
    with ``wide`` the lights' and ambient's 10 NL + 3 only, and then g_s
    (19, K N) and g_m (10, K N) each bounce's row gradients (+0.0 where
    the bounce has no hit) and ids (2, K N) i32 their row ids (surface,
    material; 0 where no hit), which are None otherwise."""
    K, _, N = tf.shape
    dev, el = tf.device, tf.dtype
    ns, nm = T.stab.shape[1], T.mtab.shape[1]
    nla = LIGHT_ROWS * T.ltab.shape[0] + 3
    g_acc = (g_cols[:, 0], g_cols[:, 1], g_cols[:, 2])
    g_s = g_m = ids = None
    if wide:
        g_s = torch.empty((SURFACE_ROWS, K * N), dtype=el, device=dev)
        g_m = torch.empty((MATERIAL_ROWS, K * N), dtype=el, device=dev)
        ids = torch.empty((2, K * N), dtype=I32, device=dev)
    cols = nla if wide else table_columns(T)
    tiles = torch.zeros((cols, -(-N // rp.WARP)), dtype=el, device=dev)
    gn = torch.zeros((TAPE_ROWS, N), dtype=el, device=dev)
    gs = torch.zeros((N, max(stack, 1), TAPE_ROWS), dtype=el, device=dev)
    lanes = torch.arange(N, device=dev)
    pushes, pops = (ti[:, 0] & PUSH) != 0, (ti[:, 0] & POP) != 0
    slots = stack_slots(ti)
    for k in reversed(range(K)):
        flags = ti[k, 0]
        hit = (flags & HIT) != 0
        # the tape's contract (tape_read): a bounce without a hit has its
        # flags alone, the rest read as zeros
        tfk = torch.where(hit, tf[k], 0.0)
        tik = torch.cat([flags[None], torch.where(hit, ti[k, 1:], 0)])
        push, pop, slot = pushes[k], pops[k], slots[k]
        cur = gs[lanes, slot].T
        gsl = torch.where(push, cur, 0.0)
        v = _recompute(T, tfk, tik, schlick)
        g_srow, g_mrow, g_light, g_in = _adjoint(v, T, tik, g_acc, gn, gsl)
        tile = rp._tile_sums(torch.where(hit, torch.stack(g_light), 0.0))
        if wide:
            at = slice(k * N, (k + 1) * N)
            g_s[:, at] = torch.where(hit, torch.stack(g_srow), 0.0)
            g_m[:, at] = torch.where(hit, torch.stack(g_mrow), 0.0)
            ids[0, at] = torch.where(hit, v.bs.to(I32), 0)
            ids[1, at] = torch.where(hit, v.m.to(I32), 0)
        else:
            tile = torch.cat([tile,
                              _row_tiles(torch.stack(g_srow), v.bs, hit, ns),
                              _row_tiles(torch.stack(g_mrow), v.m, hit, nm)])
        tiles = tiles + tile
        gs[lanes, slot] = torch.where(push, 0.0, torch.where(
            pop, cur + gn, cur)).T
        gn = torch.where(hit, torch.stack(g_in), torch.where(pop, 0.0, gn))
    return g_s, g_m, ids, tiles


def _split(g_la, T: Tables, wide_rows=None):
    """The gradients (stab (19, NS), mtab (10, NM), ltab (NL, 10), amb
    (3,)) from the summed columns g_la (``table_columns``, or the lights'
    and ambient's only with ``wide_rows``, the row sums' (stab, mtab))."""
    ns, nm, nl = T.stab.shape[1], T.mtab.shape[1], T.ltab.shape[0]
    nla = LIGHT_ROWS * nl + 3
    if wide_rows is None:
        wide_rows = (g_la[nla:nla + SURFACE_ROWS * ns].view(SURFACE_ROWS, ns),
                     g_la[nla + SURFACE_ROWS * ns:].view(MATERIAL_ROWS, nm))
    return wide_rows + (g_la[:LIGHT_ROWS * nl].view(nl, LIGHT_ROWS),
                        g_la[LIGHT_ROWS * nl:nla])


def backward_plain(g_cols, T: Tables, tf, ti, stack: int,
                   schlick: bool = False, wide: bool = False):
    """The gradients (stab (19, NS), mtab (10, NM), ltab (NL, 10), amb
    (3,)) of sum(g_cols * colors), in the kernels' order:
    ``backward_rows_plain``'s tiles summed by ``replay._block_sums``; with
    ``wide`` (the wide mode's plain version) its row gradients summed over
    all K x N entries by ``row_gather.row_sum_plain``."""
    g_s, g_m, ids, tiles = backward_rows_plain(g_cols, T, tf, ti, stack,
                                               schlick, wide)
    g_la = rp._block_sums(tiles)
    if not wide:
        return _split(g_la, T)
    return _split(g_la, T, (rg.row_sum_plain(g_s, ids[0], T.stab.shape[1]),
                            rg.row_sum_plain(g_m, ids[1], T.mtab.shape[1])))


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int
# the C entry point's arguments, in csrc/diff.cu order
ARGTYPES = {"diff_backward_launch": [_VOIDP] * 20 + [_INT] * 10 + [_VOIDP],
            "diff_backward_occupancy": [_INT] * 3 + [_VOIDP]}


def _lib():
    from quadray_tpu_torch.ops._build import load_library
    lib = load_library("diff")
    if lib.diff_backward_launch.argtypes is None:
        for fn, types in ARGTYPES.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def forward_kernel(sc: SceneArrays, struct, org, dirs, t_min,
                   cfg: TraceConfig):
    """forward_plain's outputs from ``whitted_tape_launch`` (csrc/
    whitted.cu) on the scene packed unculled from its current fields (one
    launch of csrc/pack.cu): colors (N, 3), tf, ti, the tape written as
    its contract says (``tape_read``: the words it names are forward_
    plain's bit for bit, the others are left as ``torch.empty`` gave
    them)."""
    global launches
    dev = dirs.device
    if dev.type != "cuda":
        raise ValueError(f"diff forward: unsupported device {dev}")
    ps = ck.pack_scene(sc, struct, cull=False)
    rays, tabs = ck._launch_inputs("trace_rays_fused", sc, org, dirs, t_min,
                                   struct, ps)
    n, k, nlr = dirs.shape[0], cfg.max_segments, sc.l_pos.shape[0]
    words = tape_words(nlr)
    out = torch.empty((3, n), dtype=F32, device=dev)
    tf = torch.empty((k, TAPE_ROWS, n), dtype=F32, device=dev)
    ti = torch.empty((k, words, n), dtype=I32, device=dev)
    deep = stack_scratch(n, cfg, SLOT_FLOATS, dev, "diff forward")
    with torch.cuda.device(dev):
        err = ck._lib().whitted_tape_launch(
            rays.data_ptr(), out.data_ptr(), tf.data_ptr(), ti.data_ptr(),
            *tabs, n, struct.n_real, struct.nc, struct.nl, words, cfg.depth,
            k, cfg.stack, cfg.cutoff, int(cfg.schlick),
            None if deep is None else deep.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"diff forward (tape) launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out.T, tf, ti


def _check_tables(T: Tables, dev):
    ns, nm, nl = T.stab.shape[1], T.mtab.shape[1], T.ltab.shape[0]
    for name, t, dtype, shape in (
            ("stab", T.stab, F32, (SURFACE_ROWS, ns)),
            ("mtab", T.mtab, F32, (MATERIAL_ROWS, nm)),
            ("ltab", T.ltab, F32, (nl, LIGHT_ROWS)), ("amb", T.amb, F32, (3,)),
            ("s_fwd", T.s_fwd, F32, (ns, 9)),
            ("tex", T.tex, F32, (T.tex.shape[0], 3)),
            ("s_kind", T.s_kind, I32, (ns,)), ("s_sing", T.s_sing, I32, (ns,)),
            ("s_mat", T.s_mat, I32, (ns, 2)), ("m_props", T.m_props, I32, (nm,)),
            ("use_gamma", T.use_gamma, F32, ()),
            ("use_fresnel", T.use_fresnel, F32, ())):
        ck._check(name, t, dtype, shape, dev)
    return ns, nm, nl


def backward_rows_kernel(g_cols, T: Tables, tf, ti, cfg: TraceConfig,
                         wide: bool = False):
    """``diff_backward_launch``: (g_s, g_m, ids, lpart), lpart each
    block's partial (ceil(N / 128), columns) of the columns of
    backward_rows_plain's tiles, which ``replay._block_sums`` of those
    tiles equals bitwise once ``light_sums_kernel`` adds it; with
    ``wide``, g_s, g_m and ids backward_rows_plain's bitwise, else None.
    ``cfg``: its stack and Schlick Fresnel."""
    global backward_launches
    dev = g_cols.device
    if dev.type != "cuda":
        raise ValueError(f"diff backward: unsupported device {dev}")
    ns, nm, nl = _check_tables(T, dev)
    k, _, n = tf.shape
    words = tape_words(nl)
    ck._check("g_cols", g_cols, F32, (n, 3), dev)
    ck._check("tf", tf, F32, (k, TAPE_ROWS, n), dev)
    ck._check("ti", ti, I32, (k, words, n), dev)
    if cfg.max_segments != k:
        raise ValueError(f"the tape holds {k} bounces, cfg.max_segments "
                         f"is {cfg.max_segments}")
    cols = LIGHT_ROWS * nl + 3 if wide else table_columns(T)
    blocks = -(-n // (rp.BWD_WARPS * rp.WARP))
    g_s = g_m = ids = None
    if wide:
        g_s = torch.empty((SURFACE_ROWS, k * n), dtype=F32, device=dev)
        g_m = torch.empty((MATERIAL_ROWS, k * n), dtype=F32, device=dev)
        ids = torch.empty((2, k * n), dtype=I32, device=dev)
    lpart = torch.empty((blocks, cols), dtype=F32, device=dev)
    deep = stack_scratch(blocks * rp.BWD_WARPS * rp.WARP, cfg, TAPE_ROWS,
                         dev, "diff backward", slot_major=True)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = _lib().diff_backward_launch(
            T.stab.data_ptr(), T.mtab.data_ptr(), T.ltab.data_ptr(),
            T.amb.data_ptr(), T.s_fwd.data_ptr(), T.tex.data_ptr(),
            T.s_kind.data_ptr(), T.s_sing.data_ptr(), T.s_mat.data_ptr(),
            T.m_props.data_ptr(), T.use_gamma.data_ptr(),
            T.use_fresnel.data_ptr(), tf.data_ptr(), ti.data_ptr(),
            g_cols.data_ptr(), ptr(g_s), ptr(g_m), ptr(ids),
            lpart.data_ptr(), ptr(deep), n, k, words, ns, nm, nl,
            T.tex.shape[0], cfg.stack, int(cfg.schlick), int(wide),
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"diff backward launch failed: CUDA error {err}")
    backward_launches += 1
    return g_s, g_m, ids, lpart


def backward_occupancy(cfg: TraceConfig, columns: int) -> int:
    """The backward kernel's blocks an SM holds at once, for cfg's stack
    and ``columns`` of partials (``table_columns``, or 10 NL + 3 wide)."""
    blocks = ctypes.c_int(0)
    err = _lib().diff_backward_occupancy(
        cfg.stack, cfg.max_segments, 4 * rp.BWD_WARPS * columns,
        ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"diff backward occupancy: CUDA error {err}")
    return blocks.value


def light_sums_kernel(lpart):
    """``replay_light_sums_launch``: the partials' sums (columns,),
    bitwise ``replay._block_sums`` of the tiles they came from."""
    global light_sum_launches
    dev = lpart.device
    blocks, nla = lpart.shape
    lgroup = torch.empty((max(1, -(-blocks // rp.LIGHT_GROUP)), nla),
                         dtype=F32, device=dev)
    g_la = torch.empty((nla,), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        err = rg._lib().replay_light_sums_launch(
            lpart.data_ptr(), lgroup.data_ptr(), g_la.data_ptr(), blocks,
            nla, _stream(dev))
    if err != 0:
        raise RuntimeError(f"light sums launch failed: CUDA error {err}")
    light_sum_launches += 1
    return g_la


def backward_kernel(g_cols, T: Tables, tf, ti, cfg: TraceConfig,
                    smem: int = ROWS_SMEM_BYTES):
    """backward_plain's outputs from the kernels (``wide`` = rows_wide(T,
    smem), so ``smem`` 0 forces the wide mode): the backward launch and
    the light sums, and in the wide mode between them the row sums (csrc/
    replay.cu row_gather_backward_launch) over all K x N entries."""
    wide = rows_wide(T, smem)
    g_s, g_m, ids, lpart = backward_rows_kernel(g_cols, T, tf, ti, cfg, wide)
    rows = None
    if wide:
        rows = rg._backward(g_s, g_m, ids[0], ids[1], T.stab.shape[1],
                            T.mtab.shape[1])
    return _split(light_sums_kernel(lpart), T, rows)


# ---------------------------------------------------------------------------
# the autograd Function and the route's entry point
# ---------------------------------------------------------------------------

# scene fields that require grad get none from this route: no table row
# holds them (the module docstring)
UNDIFFERENTIATED = ("s_fwd", "tex_data")


class _Run(SimpleNamespace):
    """One call's inputs: ``sc`` (every field detached), ``struct`` (the
    kernels' KernelStruct, None on the CPU), the rays, ``cfg``, ``plain``
    (the plain versions, else the kernels)."""

    def forward(self):
        if self.plain:
            return forward_plain(self.sc, self.org, self.dirs, self.t_min,
                                 self.cfg)
        return forward_kernel(self.sc, self.struct, self.org, self.dirs,
                              self.t_min, self.cfg)

    def backward(self, g_cols, T: Tables, tf, ti):
        if self.plain:
            return backward_plain(g_cols, T, tf, ti, self.cfg.stack,
                                  self.cfg.schlick, rows_wide(T))
        return backward_kernel(g_cols, T, tf, ti, self.cfg)


class TraceDiff(torch.autograd.Function):
    """``trace_rays_diff``'s colors (N, 3), differentiable in stab, mtab,
    ltab and amb (``tables``' first four, built from the scene's fields
    with their autograd history): the forward launch and its tape, and the
    backward launches (``_Run``) on the Tables of these four."""

    @staticmethod
    def forward(ctx, run, stab, mtab, ltab, amb):
        cols, tf, ti = run.forward()
        ctx.run = run
        ctx.save_for_backward(tf, ti, stab, mtab, ltab, amb)
        return cols

    @staticmethod
    def backward(ctx, g_cols):
        tf, ti, *rows = ctx.saved_tensors
        T = tables(ctx.run.sc, tuple(rows))
        grads = ctx.run.backward(g_cols.contiguous(), T, tf, ti)
        return (None,) + tuple(g if w else None for g, w in zip(
            grads, ctx.needs_input_grad[1:5]))


def trace_rays_fused(sc: SceneArrays, org, dirs, t_min, cfg: TraceConfig):
    """``trace_rays_diff``'s colors and gradients: on CUDA tensors one
    forward launch (``forward_kernel``, on the scene's KernelStruct, found
    in ``cuda_kernel``'s cache by its integer tables' identity) and, in
    the backward, one backward launch and its light sums
    (``backward_kernel``; wide tables also the row sums), or a raise; on
    CPU tensors the plain versions (``forward_plain``, ``backward_plain``
    in the same mode), in the element type (the fp64 tier runs on the
    CPU). Either takes Schlick Fresnel and any stack.
    Differentiable in every field the tables hold; the rays, ``s_fwd`` and
    the texture atlas must not require grad (ValueError)."""
    dev = dirs.device
    plain = dev.type == "cpu"
    if not plain and trace.ELEMENT != F32:
        raise ValueError(f"trace_rays_fused: the kernels take float32, the "
                         f"element type is {trace.ELEMENT}; the float64 "
                         f"tier runs on the CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"trace_rays_fused: unsupported device {dev}")
    if sc.s_pos.shape[0] > SRF_BITS + 1:
        raise ValueError(f"the tape holds at most {SRF_BITS + 1} surfaces")
    for name, t in [("org", org), ("dirs", dirs), ("t_min", t_min)] + [
            (k, getattr(sc, k)) for k in UNDIFFERENTIATED]:
        if t.requires_grad:
            raise ValueError(f"trace_rays_fused: {name} is not "
                             f"differentiated and must not require grad")
    # the trained fields detached; the integer tables keep their identity,
    # by which cuda_kernel's cache finds the scene's structure
    det = dataclasses.replace(sc, **{k: getattr(sc, k).detach()
                                     for k in FIELDS
                                     if getattr(sc, k).requires_grad})
    run = _Run(sc=det, struct=None if plain else ck._get_struct(sc),
               org=org, dirs=dirs, t_min=t_min, cfg=cfg, plain=plain)
    return TraceDiff.apply(run, *rg.row_tables(sc), rp.light_table(sc),
                           sc.amb_col)
