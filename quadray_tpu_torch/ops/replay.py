"""Trace-replay differentiation: the fast training path.

The counterpart of ``quadray_tpu.ops.replay``. The differentiable pixel
function is split in two:

  * the path-record kernel (``ops.cuda_kernel.trace_paths``, the
    ``EMIT_PATHS`` mode of ``csrc/whitted.cu``) traces the rays and writes
    a per-segment PATH RECORD (hit surface id, side, continuation kind,
    per-light shadow bits; layout in ``ops.trace.trace_paths``);
  * ``replay_color`` re-evaluates the color as a differentiable function
    of the scene parameters along those saved paths, O(N*K) work with row
    gathers, no per-surface loop; autograd differentiates it. It is the
    reference: the training step runs ``replay_color_fused`` (below), the
    same colors in one forward and one backward launch, its gradient an
    adjoint written out by hand.

The discrete path structure is detached (piecewise-constant in the
parameters): gradients are valid where the hit/branch assignment is
locally constant, and visibility-edge pixels are masked by the caller.

The arithmetic follows the JAX replay (stable b-mixed Vieta roots per
side slot, exact Fresnel and TIR, metal fast/plain RF-Fresnel, metal
blending, attenuation, gamma decode) with its known primal deltas from
the kernel: textured materials replay their plain color, and the conic
apex nudge and D_EPS root sorting are omitted (measure-zero sets).

Where the JAX replay looks rows up with a one-hot contraction (a TPU
choice: the backward of a take is a serialized scatter-add), this one
gathers a segment's rows with ``ops.row_gather.RowGather``
(``csrc/replay.cu``): a gather kernel forward, and a backward that sums
each table row's gradient with no atomics in one fixed order, so a step
is the same bits run after run; on the card a contraction would be a
matrix product, and geometry takes no matmul or TF32 here. Integer
tables are gathered as integers. The gradient guards are the JAX
replay's: the 1e-20 floors under the sqrt of the determinant and of the
refraction term, and where-guarded divisions (``_safe_div``, ``_root``),
so that no ``inf * 0`` reaches a masked-off branch's gradient.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from quadray_tpu_torch.ops import row_gather as rg
from quadray_tpu_torch.ops.cuda_kernel import MAX_PATH_LIGHTS, _check
from quadray_tpu_torch.ops.row_gather import RowGather, row_tables
from quadray_tpu_torch.ops.trace import TraceConfig, _root, _safe_div, clip
from quadray_tpu_torch.scene.compile import (
    SceneArrays, PROP_LIGHT, PROP_METAL, PROP_OPAQUE, PROP_REFLECT,
    PROP_REFRACT, PROP_DIFFUSE, PROP_SPECULAR, PROP_GAMMA, PROP_FRESNEL)

F32 = torch.float32


def record_ids(rec):
    """A segment's record (N,) i32 -> (surface ids (N,) i32, saved side
    (N,) bool)."""
    return rec & 0xFFF, ((rec >> 12) & 1) == 1


def replay_color(sc: SceneArrays, org, dirs, t_min, paths,
                 cfg: TraceConfig = TraceConfig()):
    """Differentiable color along saved paths.

    org (N, 3) or (3,), dirs (N, 3), paths (K, N) i32 path records.
    Returns (N, 3) linear colors, differentiable w.r.t. every float field
    of ``sc`` that requires grad (surface transforms and coefficients,
    materials, lights, ambient). ``t_min`` and ``cfg`` are taken for the
    JAX signature; the records already hold what they decide."""
    del t_min, cfg
    N = dirs.shape[0]
    K = paths.shape[0]
    NL = sc.l_pos.shape[0]
    if org.dim() == 1:
        org = org[None, :].expand(N, 3)

    # the tables whose rows are gathered per lane
    stab, mtab = row_tables(sc)
    use_gamma = sc.use_gamma > 0.0
    use_fresnel = sc.use_fresnel > 0.0
    amb_r, amb_g, amb_b = sc.amb_col[0], sc.amb_col[1], sc.amb_col[2]

    ox, oy, oz = org[:, 0], org[:, 1], org[:, 2]
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    thr_r = thr_g = thr_b = torch.ones((N,), dtype=F32, device=dirs.device)
    acc_r = acc_g = acc_b = torch.zeros((N,), dtype=F32, device=dirs.device)

    for k in range(K):
        rec = paths[k]
        srf, sidep = record_ids(rec)
        sf = torch.where(sidep, 1.0, -1.0)
        kindc = (rec >> 13) & 3
        hit = ((rec >> 15) & 1) != 0
        hitf = hit.to(F32)

        # the surface's rows and, through the side-picked material, the
        # material's (csrc/replay.cu, one launch a segment)
        srows, _, mrows, skind, props = RowGather.apply(
            stab, mtab, sc.s_kind, sc.s_mat, sc.m_props, srf, sidep)
        (px, py, pz, i00, i01, i02, i10, i11, i12, i20, i21, i22,
         sx, sy, sz, jx, jy, jz, sw) = srows

        rx, ry, rz = ox - px, oy - py, oz - pz
        lx = i00 * rx + i01 * ry + i02 * rz
        ly = i10 * rx + i11 * ry + i12 * rz
        lz = i20 * rx + i21 * ry + i22 * rz
        ex = i00 * dx + i01 * dy + i02 * dz
        ey = i10 * dx + i11 * dy + i12 * dz
        ez = i20 * dx + i21 * dy + i22 * dz

        is_pl = skind == 1
        is_tp = skind == 3

        # quadric roots, side slot picked by the SAVED side (slot a =
        # outer/entering, slot b = inner/leaving)
        a = sx * ex * ex + sy * ey * ey + sz * ez * ez
        b = (sx * lx - jx) * ex + (sy * ly - jy) * ey + (sz * lz - jz) * ez
        c = (sx * lx * lx + sy * ly * ly + sz * lz * lz
             - 2.0 * (jx * lx + jy * ly + jz * lz) - sw)
        cross = lx * ez - lz * ex
        disc = torch.where(is_tp, torch.abs(sx * sz) * cross * cross,
                           b * b - a * c)
        # plane lanes carry a degenerate quadric (disc == 0) whose sqrt
        # has an infinite derivative: the floor keeps inf * 0 out of the
        # masked branch's gradient and caps the tangent-ray derivative
        disc = torch.where(is_pl, 1.0, torch.clamp(disc, min=1e-20))
        sq = torch.sqrt(disc)
        sgn_b = torch.where(b >= 0.0, 1.0, -1.0)
        qq = -(b + sgn_b * sq)
        b_pos = b > 0.0
        t1, _ = _root(torch.where(b_pos, qq, c), torch.where(b_pos, a, qq))
        t2, _ = _root(torch.where(b_pos, c, qq), torch.where(b_pos, qq, a))
        t_qd = torch.where(sidep, t1, t2)
        t_pl = _safe_div(-lz, ez, 0.0)
        t = torch.where(is_pl, t_pl, t_qd)
        t = torch.where(hit, t, 0.0)

        hx = lx + t * ex
        hy = ly + t * ey
        hz = lz + t * ez
        wx = ox + t * dx
        wy = oy + t * dy
        wz = oz + t * dz

        gx = torch.where(is_pl, 0.0, sx * hx - jx)
        gy = torch.where(is_pl, 0.0, sy * hy - jy)
        gz = torch.where(is_pl, 1.0, sz * hz - jz)
        nx = (i00 * gx + i10 * gy + i20 * gz) * sf
        ny = (i01 * gx + i11 * gy + i21 * gz) * sf
        nz = (i02 * gx + i12 * gy + i22 * gz) * sf
        nn = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                     min=1e-30))
        nx, ny, nz = nx * nn, ny * nn, nz * nn

        (mc_r, mc_g, mc_b, m_dff, m_spc, m_pow, m_rfl, m_trn, m_rfr,
         m_ext) = mrows
        bit = lambda p: (props & p) != 0
        gam = bit(PROP_GAMMA) & use_gamma
        mc_r = torch.where(gam, mc_r * mc_r, mc_r)
        mc_g = torch.where(gam, mc_g * mc_g, mc_g)
        mc_b = torch.where(gam, mc_b * mc_b, mc_b)

        col_r = mc_r * amb_r
        col_g = mc_g * amb_g
        col_b = mc_b * amb_b
        metal = bit(PROP_METAL)
        diffuse = bit(PROP_DIFFUSE)
        specular = bit(PROP_SPECULAR)
        d2 = dx * dx + dy * dy + dz * dz
        for l in range(NL):
            lon = sc.l_on[l]
            lvx = sc.l_pos[l, 0] - wx
            lvy = sc.l_pos[l, 1] - wy
            lvz = sc.l_pos[l, 2] - wz
            lcr = sc.l_col[l, 0] * lon
            lcg = sc.l_col[l, 1] * lon
            lcb = sc.l_col[l, 2] * lon
            r_dot = lvx * nx + lvy * ny + lvz * nz
            # rows past the 16 recorded lights are pad rows (lon == 0)
            hm = (((rec >> (16 + l)) & 1) == 0 if l < MAX_PATH_LIGHTS
                  else torch.ones_like(hit))
            r2 = lvx * lvx + lvy * lvy + lvz * lvz
            r = torch.sqrt(torch.clamp(r2, min=1e-30))
            attn = torch.rsqrt(torch.clamp(
                sc.l_cnt[l] + sc.l_lnr[l] * r + sc.l_qdr[l] * r2, min=1e-30))
            dfs = torch.where(hm & diffuse, r_dot / r * attn * m_dff, 0.0)
            rlx = lvx - 2.0 * r_dot * nx
            rly = lvy - 2.0 * r_dot * ny
            rlz = lvz - 2.0 * r_dot * nz
            sdot = rlx * dx + rly * dy + rlz * dz
            cosr = sdot * torch.rsqrt(torch.clamp(d2 * r2, min=1e-30))
            spc_on = hm & (sdot > 0.0) & specular
            cosr = clip(torch.where(spc_on, cosr, 1.0), 1e-6, 1.0)
            spc = torch.where(spc_on,
                              torch.exp(m_pow * torch.log(cosr)) * m_spc, 0.0)
            tm_ = dfs + spc
            col_r = col_r + torch.where(metal, mc_r * lcr * tm_,
                                        mc_r * lcr * dfs + lcr * spc)
            col_g = col_g + torch.where(metal, mc_g * lcg * tm_,
                                        mc_g * lcg * dfs + lcg * spc)
            col_b = col_b + torch.where(metal, mc_b * lcb * tm_,
                                        mc_b * lcb * dfs + lcb * spc)

        emis = bit(PROP_LIGHT)
        col_r = torch.where(emis, mc_r, col_r)
        col_g = torch.where(emis, mc_g, col_g)
        col_b = torch.where(emis, mc_b, col_b)

        # Fresnel / refraction continuation weights (TR + RF sections)
        dl = torch.rsqrt(torch.clamp(d2, min=1e-30))
        rhx, rhy, rhz = dx * dl, dy * dl, dz * dl
        dot = rhx * nx + rhy * ny + rhz * nz
        eta = m_rfr
        ed = eta * dot
        ksn = 1.0 - eta * eta + ed * ed
        refracts = bit(PROP_REFRACT)
        tir = (ksn < 0.0) & refracts
        # 1e-20 floor, not 0: for eta == 1 materials ksn == dot^2, EXACTLY
        # 0 on grazing lanes, where sqrt'(0) = inf would turn the gradient
        # NaN; the floor perturbs sqk by <= 1e-10
        sqk = torch.sqrt(torch.clamp(ksn, min=1e-20))
        rfx = torch.where(refracts, eta * rhx - nx * (ed + sqk), rhx)
        rfy = torch.where(refracts, eta * rhy - ny * (ed + sqk), rhy)
        rfz = torch.where(refracts, eta * rhz - nz * (ed + sqk), rhz)
        fres_lanes = bit(PROP_FRESNEL) & ~bit(PROP_OPAQUE) & use_fresnel
        rs = _safe_div(ed + sqk, ed - sqk, 1.0)
        rp = _safe_div(dot + eta * sqk, dot - eta * sqk, 1.0)
        Fr = clip(0.5 * (rs * rs + rp * rp), 0.0, 1.0)
        Fr = torch.where(fres_lanes, Fr, 0.0)
        # TIR reflectivity fold only under Fresnel (tracer.cpp:3268-3301)
        Fr = torch.where(tir & fres_lanes, 1.0, Fr)
        c_trn = torch.where(tir, 0.0, m_trn * (1.0 - Fr))
        c_rfl = m_rfl + m_trn * Fr
        # RF-section Fresnel for opaque reflective Fresnel materials
        rf_mask = (bit(PROP_OPAQUE) & bit(PROP_REFLECT)
                   & bit(PROP_FRESNEL) & use_fresnel)
        rcp = _safe_div(torch.ones_like(m_rfr), m_rfr, 0.0)
        ext2 = m_ext * m_ext
        t2m = 2.0 * dot * rcp
        c2 = dot * dot
        gg = rcp * rcp + ext2
        x0 = c2 + gg
        x1 = c2 * gg + 1.0
        f_metal = torch.abs(-0.5 * (_safe_div(x0 + t2m, x0 - t2m, 1.0)
                                    + _safe_div(x1 + t2m, x1 - t2m, 1.0)))
        f_plain = torch.abs(-0.5 * (rs * rs + rp * rp))
        f_rf = torch.where(metal, f_metal, f_plain)
        c_rfl = torch.where(rf_mask, m_rfl * f_rf, c_rfl)

        # jnp.maximum's gradient: one half at a tie with 0
        lw = 1.0 - m_trn - m_rfl
        lw = torch.maximum(lw, torch.tensor(0.0, dtype=lw.dtype))
        acc_r = acc_r + hitf * thr_r * col_r * lw
        acc_g = acc_g + hitf * thr_g * col_g * lw
        acc_b = acc_b + hitf * thr_b * col_b * lw

        if k + 1 == K:
            break
        # continuation (saved branch kind)
        is_rfl = kindc == 1
        is_trn = kindc == 2
        cont = kindc > 0
        ddn = dx * nx + dy * ny + dz * nz
        mrx = dx - 2.0 * ddn * nx
        mry = dy - 2.0 * ddn * ny
        mrz = dz - 2.0 * ddn * nz
        dx = torch.where(is_rfl, mrx, torch.where(is_trn, rfx, dx))
        dy = torch.where(is_rfl, mry, torch.where(is_trn, rfy, dy))
        dz = torch.where(is_rfl, mrz, torch.where(is_trn, rfz, dz))
        wsel = torch.where(is_rfl, c_rfl, torch.where(is_trn, c_trn, 1.0))
        thr_r = torch.where(cont, thr_r * wsel, thr_r)
        thr_g = torch.where(cont, thr_g * wsel, thr_g)
        thr_b = torch.where(cont, thr_b * wsel, thr_b)
        ox = torch.where(cont, wx, ox)
        oy = torch.where(cont, wy, oy)
        oz = torch.where(cont, wz, oz)

    return torch.stack([acc_r, acc_g, acc_b], dim=-1)


# ---------------------------------------------------------------------------
# the fused replay: one forward and one backward launch for all K segments
# ---------------------------------------------------------------------------
#
# ``replay_color_fused`` computes replay_color's colors and their gradient
# without autograd's per-op graph: ``replay_forward_launch`` (csrc/
# replay.cu) runs every segment of a ray in one thread and saves each
# segment's entry state (origin, direction, throughput) and row ids;
# ``replay_backward_launch`` runs the segments in reverse, recomputes each
# from its saved state and applies the adjoint written out by hand below
# (``_adjoint``). Each segment's 19 + 10 row gradients a ray are summed
# per table row by the row gather's backward (``row_gather.row_sum_plain``
# order) over all K x N entries at once; the light and ambient gradients
# are summed in a fixed order without atomics (``_tile_sums``,
# ``_block_sums``). ``replay_plain`` is the same arithmetic in PyTorch, in
# the kernels' order: the CPU's path, and the kernels' bitwise reference
# on the card. The adjoint splits ties as JAX does: jnp.maximum's and
# jnp.clip's one half, torch.where's gradient to the taken branch only,
# the 1e-20 / 1e-30 floors passing nothing below them, the guarded
# divisions no inf * 0.

LIGHT_ROWS = 10     # a light's row: pos 0-2, col 3-5, on, cnt, lnr, qdr
STATE_ROWS = 9      # a segment's entry state: org 0-2, dir 3-5, thr 6-8
BWD_WARPS = 4       # warps a backward block (the light sums' order)
LIGHT_GROUP = 32    # backward blocks a group of the light sums
WARP = rg.WARP
SURFACE_ROWS, MATERIAL_ROWS = rg.SURFACE_ROWS, rg.MATERIAL_ROWS

# calls of the fused forward and backward wrappers (each launches its
# kernels; the backward's row sums count in row_gather.backward_launches)
launches = 0
backward_launches = 0

def light_table(sc: SceneArrays):
    """(NL, 10): each light's pos, col, on, cnt, lnr, qdr, differentiable
    in those fields."""
    return torch.cat([sc.l_pos, sc.l_col, sc.l_on[:, None], sc.l_cnt[:, None],
                      sc.l_lnr[:, None], sc.l_qdr[:, None]], dim=1)


def _bit(props, p):
    return (props & p) != 0


def _clampmin_grad(x, lo: float, g):
    """torch.clamp(x, min=lo)'s gradient: all of g at x >= lo."""
    return torch.where(x >= lo, g, 0.0)


def _clip_grad(x, lo: float, hi: float, g):
    """``clip``'s gradient (minimum(maximum(x, lo), hi)): one half at a
    tie with either bound, none outside."""
    m = torch.maximum(x, torch.tensor(lo, dtype=x.dtype))
    gm = torch.where(m > hi, 0.0, torch.where(m == hi, 0.5 * g, g))
    return torch.where(x < lo, 0.0, torch.where(x == lo, 0.5 * gm, gm))


def _sgn0(x):
    """torch.abs's derivative: +1, -1, and 0 at 0."""
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, 0.0))


def _sdiv_grad(q, den, g):
    """(d num, d den) of ``_safe_div(num, den)`` = q: none where |den| <
    1e-30, whose quotient is the fallback."""
    bad = torch.abs(den) < 1e-30
    return (torch.where(bad, 0.0, g / den),
            torch.where(bad, 0.0, -(g * (q / den))))


def _light(ltab, l: int, v, hm):
    """Light l's term of a segment's color, with what its adjoint reads;
    replay_color's operations in its order."""
    lpx, lpy, lpz, lcr0, lcg0, lcb0, lon, cnt, lnr, qdr = (
        ltab[l, f] for f in range(LIGHT_ROWS))
    lvx = lpx - v.wx
    lvy = lpy - v.wy
    lvz = lpz - v.wz
    lcr = lcr0 * lon
    lcg = lcg0 * lon
    lcb = lcb0 * lon
    r_dot = lvx * v.nx + lvy * v.ny + lvz * v.nz
    r2 = lvx * lvx + lvy * lvy + lvz * lvz
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    den = cnt + lnr * r + qdr * r2
    attn = torch.rsqrt(torch.clamp(den, min=1e-30))
    don = hm & v.diffuse
    dfs = torch.where(don, r_dot / r * attn * v.m_dff, 0.0)
    t2r = 2.0 * r_dot
    rlx = lvx - t2r * v.nx
    rly = lvy - t2r * v.ny
    rlz = lvz - t2r * v.nz
    sdot = rlx * v.dx + rly * v.dy + rlz * v.dz
    d2r2 = v.d2 * r2
    rs2 = torch.rsqrt(torch.clamp(d2r2, min=1e-30))
    cosr0 = sdot * rs2
    spc_on = hm & (sdot > 0.0) & v.specular
    cosr_s = torch.where(spc_on, cosr0, 1.0)
    cosr = clip(cosr_s, 1e-6, 1.0)
    lg = torch.log(cosr)
    e = torch.exp(v.m_pow * lg)
    spc = torch.where(spc_on, e * v.m_spc, 0.0)
    tm = dfs + spc
    mclc_r = v.mc_r * lcr
    mclc_g = v.mc_g * lcg
    mclc_b = v.mc_b * lcb
    term_r = torch.where(v.metal, mclc_r * tm, mclc_r * dfs + lcr * spc)
    term_g = torch.where(v.metal, mclc_g * tm, mclc_g * dfs + lcg * spc)
    term_b = torch.where(v.metal, mclc_b * tm, mclc_b * dfs + lcb * spc)
    return SimpleNamespace(**locals())


def _segment(srows, mrows, skind, props, rec, o, d, ltab, amb, ug, uf,
             last: bool):
    """One segment of replay_color from its entry state o, d (3 rows of
    (N,) each): its color (before the throughput and lw), lw and the next
    direction's candidates, and every intermediate the adjoint reads
    (returned as a namespace of the locals)."""
    ox, oy, oz = o
    dx, dy, dz = d
    (px, py, pz, i00, i01, i02, i10, i11, i12, i20, i21, i22,
     sx, sy, sz, jx, jy, jz, sw) = srows
    sidep = ((rec >> 12) & 1) == 1
    sf = torch.where(sidep, 1.0, -1.0)
    kindc = (rec >> 13) & 3
    hit = ((rec >> 15) & 1) != 0
    hitf = hit.to(F32)

    rx, ry, rz = ox - px, oy - py, oz - pz
    lx = i00 * rx + i01 * ry + i02 * rz
    ly = i10 * rx + i11 * ry + i12 * rz
    lz = i20 * rx + i21 * ry + i22 * rz
    ex = i00 * dx + i01 * dy + i02 * dz
    ey = i10 * dx + i11 * dy + i12 * dz
    ez = i20 * dx + i21 * dy + i22 * dz
    is_pl = skind == 1
    is_tp = skind == 3
    a = sx * ex * ex + sy * ey * ey + sz * ez * ez
    ux = sx * lx - jx
    uy = sy * ly - jy
    uz = sz * lz - jz
    b = ux * ex + uy * ey + uz * ez
    c = (sx * lx * lx + sy * ly * ly + sz * lz * lz
         - 2.0 * (jx * lx + jy * ly + jz * lz) - sw)
    cross = lx * ez - lz * ex
    sxz = sx * sz
    disc0 = torch.where(is_tp, torch.abs(sxz) * cross * cross, b * b - a * c)
    disc = torch.where(is_pl, 1.0, torch.clamp(disc0, min=1e-20))
    sq = torch.sqrt(disc)
    sgn_b = torch.where(b >= 0.0, 1.0, -1.0)
    qq = -(b + sgn_b * sq)
    b_pos = b > 0.0
    # the saved side's root: slot a (sidep) is root(qq, a) where b > 0,
    # else root(c, qq); slot b the other
    use_q = sidep == b_pos
    num_s = torch.where(use_q, qq, c)
    den_s = torch.where(use_q, a, qq)
    t_qd, _ = _root(num_s, den_s)
    t_pl = _safe_div(-lz, ez, 0.0)
    t = torch.where(hit, torch.where(is_pl, t_pl, t_qd), 0.0)

    hx = lx + t * ex
    hy = ly + t * ey
    hz = lz + t * ez
    wx = ox + t * dx
    wy = oy + t * dy
    wz = oz + t * dz
    gx = torch.where(is_pl, 0.0, sx * hx - jx)
    gy = torch.where(is_pl, 0.0, sy * hy - jy)
    gz = torch.where(is_pl, 1.0, sz * hz - jz)
    nrx = (i00 * gx + i10 * gy + i20 * gz) * sf
    nry = (i01 * gx + i11 * gy + i21 * gz) * sf
    nrz = (i02 * gx + i12 * gy + i22 * gz) * sf
    qn = nrx * nrx + nry * nry + nrz * nrz
    nn = torch.rsqrt(torch.clamp(qn, min=1e-30))
    nx, ny, nz = nrx * nn, nry * nn, nrz * nn

    (mc0_r, mc0_g, mc0_b, m_dff, m_spc, m_pow, m_rfl, m_trn, m_rfr,
     m_ext) = mrows
    gam = _bit(props, PROP_GAMMA) & ug
    mc_r = torch.where(gam, mc0_r * mc0_r, mc0_r)
    mc_g = torch.where(gam, mc0_g * mc0_g, mc0_g)
    mc_b = torch.where(gam, mc0_b * mc0_b, mc0_b)
    metal = _bit(props, PROP_METAL)
    diffuse = _bit(props, PROP_DIFFUSE)
    specular = _bit(props, PROP_SPECULAR)
    emis = _bit(props, PROP_LIGHT)
    refracts = _bit(props, PROP_REFRACT)
    fres = _bit(props, PROP_FRESNEL) & ~_bit(props, PROP_OPAQUE) & uf
    rf_mask = (_bit(props, PROP_OPAQUE) & _bit(props, PROP_REFLECT)
               & _bit(props, PROP_FRESNEL) & uf)
    d2 = dx * dx + dy * dy + dz * dz
    lw0 = 1.0 - m_trn - m_rfl
    lw = torch.maximum(lw0, torch.tensor(0.0, dtype=lw0.dtype))
    if last:
        return SimpleNamespace(**locals())

    # Fresnel / refraction continuation weights (TR + RF sections)
    dl = torch.rsqrt(torch.clamp(d2, min=1e-30))
    rhx, rhy, rhz = dx * dl, dy * dl, dz * dl
    dot = rhx * nx + rhy * ny + rhz * nz
    eta = m_rfr
    ed = eta * dot
    ksn = 1.0 - eta * eta + ed * ed
    tir = (ksn < 0.0) & refracts
    sqk = torch.sqrt(torch.clamp(ksn, min=1e-20))
    esq = ed + sqk
    rfx = torch.where(refracts, eta * rhx - nx * esq, rhx)
    rfy = torch.where(refracts, eta * rhy - ny * esq, rhy)
    rfz = torch.where(refracts, eta * rhz - nz * esq, rhz)
    den_rs = ed - sqk
    rs = _safe_div(esq, den_rs, 1.0)
    es = eta * sqk
    den_rp = dot - es
    rp = _safe_div(dot + es, den_rp, 1.0)
    s_f = rs * rs + rp * rp
    fr0 = 0.5 * s_f
    fr = torch.where(fres, clip(fr0, 0.0, 1.0), 0.0)
    fr = torch.where(tir & fres, 1.0, fr)
    c_trn = torch.where(tir, 0.0, m_trn * (1.0 - fr))
    c_rfl0 = m_rfl + m_trn * fr
    rcp = _safe_div(torch.ones_like(m_rfr), m_rfr, 0.0)
    ext2 = m_ext * m_ext
    t2m = 2.0 * dot * rcp
    c2 = dot * dot
    gg = rcp * rcp + ext2
    x0 = c2 + gg
    x1 = c2 * gg + 1.0
    den_a = x0 - t2m
    fa = _safe_div(x0 + t2m, den_a, 1.0)
    den_b = x1 - t2m
    fb = _safe_div(x1 + t2m, den_b, 1.0)
    vm = -0.5 * (fa + fb)
    vp = -0.5 * s_f
    f_rf = torch.where(metal, torch.abs(vm), torch.abs(vp))
    c_rfl = torch.where(rf_mask, m_rfl * f_rf, c_rfl0)

    # continuation (saved branch kind)
    is_rfl = kindc == 1
    is_trn = kindc == 2
    cont = kindc > 0
    ddn = dx * nx + dy * ny + dz * nz
    t2d = 2.0 * ddn
    mrx = dx - t2d * nx
    mry = dy - t2d * ny
    mrz = dz - t2d * nz
    wsel = torch.where(is_rfl, c_rfl, torch.where(is_trn, c_trn, 1.0))
    return SimpleNamespace(**locals())


def _color(v, ltab, amb, rec):
    """The segment's color: ambient, the lights, emission."""
    col_r = v.mc_r * amb[0]
    col_g = v.mc_g * amb[1]
    col_b = v.mc_b * amb[2]
    for l in range(ltab.shape[0]):
        li = _light(ltab, l, v, _lit(rec, l, v.hit))
        col_r = col_r + li.term_r
        col_g = col_g + li.term_g
        col_b = col_b + li.term_b
    return (torch.where(v.emis, v.mc_r, col_r),
            torch.where(v.emis, v.mc_g, col_g),
            torch.where(v.emis, v.mc_b, col_b))


def _lit(rec, l: int, like):
    """Light l unshadowed on the segment (rows past the 16 recorded
    lights are pad rows, counted as unshadowed)."""
    if l < MAX_PATH_LIGHTS:
        return ((rec >> (16 + l)) & 1) == 0
    return torch.ones_like(like)


def _adjoint(v, rec, ltab, amb, g_acc, g_next):
    """A segment's adjoint: from the color's gradient g_acc (3 rows) and
    the next state's (g_next: origin, direction, throughput, 3 rows each;
    None after the last segment), (the surface row's 19 gradients, the
    material row's 10, the lights' 10 each and the ambient's 3, the entry
    state's 9), each (N,). csrc/replay.cu ``adjoint`` is this, line for
    line."""
    W = torch.where
    dx, dy, dz, nx, ny, nz = v.dx, v.dy, v.dz, v.nx, v.ny, v.nz
    zero = torch.zeros_like(dx)
    gox = goy = goz = gwx = gwy = gwz = zero
    gnx = gny = gnz = gdx = gdy = gdz = zero
    gtr = gtg = gtb = zero
    g_rfl = g_trn = g_ext = g_rfr = g_d2 = zero
    if g_next is not None:
        (gox_n, goy_n, goz_n, gdx_n, gdy_n, gdz_n, gtr_n, gtg_n,
         gtb_n) = g_next
        tr, tg, tb = v.thr
        # o' = cont ? w : o; thr' = cont ? thr * wsel : thr
        gwx = W(v.cont, gox_n, 0.0)
        gwy = W(v.cont, goy_n, 0.0)
        gwz = W(v.cont, goz_n, 0.0)
        gox = W(v.cont, 0.0, gox_n)
        goy = W(v.cont, 0.0, goy_n)
        goz = W(v.cont, 0.0, goz_n)
        gtr = W(v.cont, gtr_n * v.wsel, gtr_n)
        gtg = W(v.cont, gtg_n * v.wsel, gtg_n)
        gtb = W(v.cont, gtb_n * v.wsel, gtb_n)
        gwsel = W(v.cont, gtr_n * tr + gtg_n * tg + gtb_n * tb, 0.0)
        # wsel = rfl ? c_rfl : trn ? c_trn : 1; d' = rfl ? mr : trn ? rf : d
        g_crfl = W(v.is_rfl, gwsel, 0.0)
        g_ctrn = W(v.is_rfl, 0.0, W(v.is_trn, gwsel, 0.0))
        gmrx = W(v.is_rfl, gdx_n, 0.0)
        gmry = W(v.is_rfl, gdy_n, 0.0)
        gmrz = W(v.is_rfl, gdz_n, 0.0)
        grfx = W(v.is_rfl, 0.0, W(v.is_trn, gdx_n, 0.0))
        grfy = W(v.is_rfl, 0.0, W(v.is_trn, gdy_n, 0.0))
        grfz = W(v.is_rfl, 0.0, W(v.is_trn, gdz_n, 0.0))
        keep = ~(v.is_rfl | v.is_trn)
        gdx = W(keep, gdx_n, 0.0) + gmrx
        gdy = W(keep, gdy_n, 0.0) + gmry
        gdz = W(keep, gdz_n, 0.0) + gmrz
        # mr = d - (2 ddn) n, ddn = d . n
        gddn = -2.0 * (gmrx * nx + gmry * ny + gmrz * nz)
        gnx = gddn * dx - v.t2d * gmrx
        gny = gddn * dy - v.t2d * gmry
        gnz = gddn * dz - v.t2d * gmrz
        gdx = gdx + gddn * nx
        gdy = gdy + gddn * ny
        gdz = gdz + gddn * nz

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
        g_fr0 = _clip_grad(v.fr0, 0.0, 1.0, W(v.fres & ~v.tir, g_fr, 0.0))
        g_sf = 0.5 * g_fr0
        # f_rf = metal ? |vm| : |vp|
        g_vm = W(v.metal, g_frf, 0.0) * _sgn0(v.vm)
        g_sf = g_sf + -0.5 * (W(v.metal, 0.0, g_frf) * _sgn0(v.vp))
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
        _, g_rfr = _sdiv_grad(v.rcp, v.m_rfr, grcp)
        # s_f = rs^2 + rp^2; rs = (ed + sqk) / (ed - sqk); rp = (dot + es)
        # / (dot - es), es = eta sqk
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
        # sqk = sqrt(max(ksn, 1e-20)); ksn = 1 - eta^2 + ed^2; ed = eta dot
        gksn = _clampmin_grad(v.ksn, 1e-20, gsqk / (2.0 * v.sqk))
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
        g_d2 = _clampmin_grad(v.d2, 1e-30,
                              -0.5 * gdl * (v.dl * v.dl * v.dl))

    # acc += ((hitf thr) col) lw, col the segment's color
    gar, gag, gab = g_acc
    tr, tg, tb = v.thr
    col_r, col_g, col_b = v.col
    htr, htg, htb = v.hitf * tr, v.hitf * tg, v.hitf * tb
    glw = gar * (htr * col_r) + gag * (htg * col_g) + gab * (htb * col_b)
    gcr = gar * v.lw * htr
    gcg = gag * v.lw * htg
    gcb = gab * v.lw * htb
    gtr = gtr + gar * v.lw * col_r * v.hitf
    gtg = gtg + gag * v.lw * col_g * v.hitf
    gtb = gtb + gab * v.lw * col_b * v.hitf
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
    g_dff = g_spc = g_pow = zero
    g_lights = []
    for l in range(ltab.shape[0]):
        li = _light(ltab, l, v, _lit(rec, l, v.hit))
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
        # lc = l_col * on
        lon = ltab[l, 6]
        g_on = glcr * ltab[l, 3] + glcg * ltab[l, 4] + glcb * ltab[l, 5]
        # spc = spc_on ? exp(m_pow log(cosr)) m_spc : 0
        ge = W(li.spc_on, gspc * v.m_spc, 0.0)
        g_spc = g_spc + W(li.spc_on, gspc * li.e, 0.0)
        gy = ge * li.e
        g_pow = g_pow + gy * li.lg
        gcos = gy * v.m_pow / li.cosr
        gcos0 = W(li.spc_on, _clip_grad(li.cosr_s, 1e-6, 1.0, gcos), 0.0)
        # cosr0 = sdot rsqrt(max(d2 r2, 1e-30))
        gsdot = gcos0 * li.rs2
        gd2r2 = _clampmin_grad(li.d2r2, 1e-30, -0.5 * (gcos0 * li.sdot)
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
        gden = _clampmin_grad(li.den, 1e-30, -0.5 * gattn
                              * (li.attn * li.attn * li.attn))
        gr = gr + gden * li.lnr
        gr2 = gr2 + gden * li.qdr
        # r = sqrt(max(r2, 1e-30)); r2 = lv . lv; r_dot = lv . n
        gr2 = gr2 + _clampmin_grad(li.r2, 1e-30, gr / (2.0 * li.r))
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
        g_lights += [glvx, glvy, glvz, glcr * lon, glcg * lon, glcb * lon,
                     g_on, gden, gden * li.r, gden * li.r2]
    # ambient: col0 = mc amb
    g_lights += [gcr * v.mc_r, gcg * v.mc_g, gcb * v.mc_b]
    gmr = gmr + gcr * amb[0]
    gmg = gmg + gcg * amb[1]
    gmb = gmb + gcb * amb[2]
    # mc = gam ? mc0^2 : mc0
    gmr = W(v.gam, 2.0 * gmr * v.mc0_r, gmr)
    gmg = W(v.gam, 2.0 * gmg * v.mc0_g, gmg)
    gmb = W(v.gam, 2.0 * gmb * v.mc0_b, gmb)
    # d2 = d . d
    gdx = gdx + 2.0 * g_d2 * dx
    gdy = gdy + 2.0 * g_d2 * dy
    gdz = gdz + 2.0 * g_d2 * dz

    # n = nr rsqrt(max(nr . nr, 1e-30)), nr = (I^T g) sf
    gnrx = gnx * v.nn
    gnry = gny * v.nn
    gnrz = gnz * v.nn
    gnn = gnx * v.nrx + gny * v.nry + gnz * v.nrz
    gqn = _clampmin_grad(v.qn, 1e-30, -0.5 * gnn * (v.nn * v.nn * v.nn))
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
    ghx = ggx * v.sx
    ghy = ggy * v.sy
    ghz = ggz * v.sz
    gjx = -ggx
    gjy = -ggy
    gjz = -ggz
    # w = o + t d; h = l + t e
    gox = gox + gwx
    goy = goy + gwy
    goz = goz + gwz
    gt = (gwx * dx + gwy * dy + gwz * dz) + (ghx * v.ex + ghy * v.ey
                                             + ghz * v.ez)
    gdx = gdx + v.t * gwx
    gdy = gdy + v.t * gwy
    gdz = gdz + v.t * gwz
    glx, gly, glz = ghx, ghy, ghz
    gex = v.t * ghx
    gey = v.t * ghy
    gez = v.t * ghz
    # t = hit ? (plane ? t_pl : t_qd) : 0
    gth = W(v.hit, gt, 0.0)
    gtpl = W(v.is_pl, gth, 0.0)
    gtqd = W(v.is_pl, 0.0, gth)
    # t_pl = -lz / ez (guarded)
    gnum, gden_pl = _sdiv_grad(v.t_pl, v.ez, gtpl)
    glz = glz - gnum
    gez = gez + gden_pl
    # t_qd = root(num_s, den_s): none where the root is invalid or 0 / x
    num0 = v.num_s == 0.0
    den2 = W(num0, 1.0, v.den_s)
    ok = den2 != 0.0
    gnum_r = W(ok, gtqd / den2, 0.0)
    gden_r = W(num0, 0.0, W(ok, -(gtqd * (v.t_qd / den2)), 0.0))
    gqq = W(v.use_q, gnum_r, gden_r)
    gc = W(v.use_q, 0.0, gnum_r)
    ga = W(v.use_q, gden_r, 0.0)
    # qq = -(b + sgn_b sq); sq = sqrt(disc)
    gb = -gqq
    gsq = -(gqq * v.sgn_b)
    gdisc = W(v.is_pl, 0.0, _clampmin_grad(v.disc0, 1e-20,
                                           gsq / (2.0 * v.sq)))
    gdtp = W(v.is_tp, gdisc, 0.0)
    gdq = W(v.is_tp, 0.0, gdisc)
    # disc0 = tp ? (|sx sz| cross) cross : b b - a c
    av = torch.abs(v.sxz)
    gcross = 2.0 * gdtp * (av * v.cross)
    gsxz = gdtp * (v.cross * v.cross) * _sgn0(v.sxz)
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
    # l = I (o - p); e = I d
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
    g_srow = [-grx, -gry, -grz, gi00, gi01, gi02, gi10, gi11, gi12,
              gi20, gi21, gi22, gsx, gsy, gsz, gjx, gjy, gjz, gsw]
    g_mrow = [gmr, gmg, gmb, g_dff, g_spc, g_pow, g_rfl, g_trn, g_rfr, g_ext]
    return (g_srow, g_mrow, g_lights,
            [gox, goy, goz, gdx, gdy, gdz, gtr, gtg, gtb])


def _tile_sums(x):
    """(F, ceil(N / 32)): each tile of 32 consecutive rays of x (F, N)
    summed by an xor butterfly over its lanes (+0.0 past the last ray),
    as a warp's __shfl_xor_sync sum does."""
    nf, n = x.shape
    nt = -(-n // WARP)
    y = x.new_zeros((nf, nt * WARP))
    y[:, :n] = x
    y = y.view(nf, nt, WARP)
    h = WARP // 2
    while h:
        y = y[..., :h] + y[..., h:2 * h]
        h //= 2
    return y[..., 0]


def _block_sums(tiles):
    """(F,): the tiles' sums (F, T) added from +0.0 in tile order within
    each block of BWD_WARPS tiles (the backward kernel's partials), the
    blocks' from +0.0 in block order within each group of LIGHT_GROUP
    blocks (``light_group_kernel``), then the groups' from +0.0 in group
    order (``light_sum_kernel``). Padding adds +0.0 to sums that began at
    +0.0, which changes no bit."""
    groups = _ordered(_ordered(tiles, BWD_WARPS), LIGHT_GROUP)
    if groups.shape[1] == 0:
        return tiles.new_zeros((tiles.shape[0],))
    return _ordered(groups, groups.shape[1])[:, 0]


def _ordered(x, per: int):
    """(F, ceil(C / per)): the columns of x (F, C) in consecutive runs of
    per, each run added from +0.0 in column order."""
    nf, c = x.shape
    runs = -(-c // per)
    y = x.new_zeros((nf, runs * per))
    y[:, :c] = x
    y = y.view(nf, runs, per)
    out = x.new_zeros((nf, runs))
    for u in range(per):
        out = out + y[..., u]
    return out


def forward_plain(stab, mtab, ltab, amb, s_kind, s_mat, m_props, use_gamma,
                  use_fresnel, org, dirs, paths):
    """replay_color's colors (N, 3), bit for bit on the card, with what
    the backward reads: each segment's entry state (K, 9, N) (org, dir,
    throughput) and row ids (2, K, N) i32 (surface, material)."""
    N, K = dirs.shape[0], paths.shape[0]
    ug, uf = use_gamma > 0.0, use_fresnel > 0.0
    if org.dim() == 1:
        org = org[None, :].expand(N, 3)
    o = (org[:, 0], org[:, 1], org[:, 2])
    d = (dirs[:, 0], dirs[:, 1], dirs[:, 2])
    thr = (torch.ones((N,), dtype=F32, device=dirs.device),) * 3
    acc = (torch.zeros((N,), dtype=F32, device=dirs.device),) * 3
    states, ids = [], []
    for k in range(K):
        rec = paths[k]
        srf, sidep = record_ids(rec)
        srows, midx, mrows, skind, props = rg.gather_plain(
            stab, mtab, s_kind, s_mat, m_props, srf, sidep)
        states.append(torch.stack([*o, *d, *thr]))
        ids.append(torch.stack([srf, midx]))
        last = k + 1 == K
        v = _segment(srows, mrows, skind, props, rec, o, d, ltab, amb, ug,
                     uf, last)
        col = _color(v, ltab, amb, rec)
        acc = tuple(a + v.hitf * t * c * v.lw
                    for a, t, c in zip(acc, thr, col))
        if last:
            break
        d = (torch.where(v.is_rfl, v.mrx, torch.where(v.is_trn, v.rfx, v.dx)),
             torch.where(v.is_rfl, v.mry, torch.where(v.is_trn, v.rfy, v.dy)),
             torch.where(v.is_rfl, v.mrz, torch.where(v.is_trn, v.rfz, v.dz)))
        thr = tuple(torch.where(v.cont, t * v.wsel, t) for t in thr)
        o = tuple(torch.where(v.cont, w, p)
                  for w, p in zip((v.wx, v.wy, v.wz), o))
    return (torch.stack(acc, dim=-1), torch.stack(states),
            torch.stack(ids, dim=1))


def backward_plain(g_cols, stab, mtab, ltab, amb, s_kind, s_mat, m_props,
                   use_gamma, use_fresnel, paths, state, ids):
    """The gradients (stab (19, NS), mtab (10, NM), ltab (NL, 10), amb
    (3,)) of sum(g_cols * replay colors), in the backward kernels' order:
    ``backward_rows_plain``, then the row gradients summed over all K x N
    entries by ``row_gather.row_sum_plain`` and the lights' and ambient's
    tile sums by ``_block_sums``."""
    g_s, g_m, tiles = backward_rows_plain(
        g_cols, stab, mtab, ltab, amb, s_kind, s_mat, m_props, use_gamma,
        use_fresnel, paths, state, ids)
    nl = ltab.shape[0]
    g_stab = rg.row_sum_plain(g_s, ids[0].reshape(-1), stab.shape[1])
    g_mtab = rg.row_sum_plain(g_m, ids[1].reshape(-1), mtab.shape[1])
    g_la = _block_sums(tiles)
    return (g_stab, g_mtab, g_la[:LIGHT_ROWS * nl].view(nl, LIGHT_ROWS),
            g_la[LIGHT_ROWS * nl:])


def backward_rows_plain(g_cols, stab, mtab, ltab, amb, s_kind, s_mat,
                        m_props, use_gamma, use_fresnel, paths, state, ids):
    """The backward kernel's per-ray work: segments in reverse, each
    recomputed from its saved state (``_adjoint`` on its live rays: hit,
    or continued; the others pass the next state's gradient through and
    give +0.0). Returns each segment's row gradients g_s (19, K N) and g_m
    (10, K N), and the lights' and ambient's gradients (10 NL + 3, ceil(N /
    32)) summed per tile of 32 rays (``_tile_sums``), the tiles' sums
    added segment after segment."""
    del s_mat
    N, K = g_cols.shape[0], paths.shape[0]
    NL = ltab.shape[0]
    ug, uf = use_gamma > 0.0, use_fresnel > 0.0
    g_acc = (g_cols[:, 0], g_cols[:, 1], g_cols[:, 2])
    g_s = g_cols.new_empty((SURFACE_ROWS, K * N))
    g_m = g_cols.new_empty((MATERIAL_ROWS, K * N))
    tiles = g_cols.new_zeros((LIGHT_ROWS * NL + 3, -(-N // WARP)))
    g_next = None
    for k in reversed(range(K)):
        rec = paths[k]
        st = state[k]
        ids_s, ids_m = ids[0, k], ids[1, k]
        srows = torch.index_select(stab, 1, ids_s)
        mrows = torch.index_select(mtab, 1, ids_m)
        o, d = (st[0], st[1], st[2]), (st[3], st[4], st[5])
        v = _segment(srows, mrows, s_kind[ids_s], m_props[ids_m], rec, o,
                     d, ltab, amb, ug, uf, k + 1 == K)
        v.thr = (st[6], st[7], st[8])
        v.col = _color(v, ltab, amb, rec)
        live = v.hit | (v.kindc != 0)
        g_srow, g_mrow, g_light, g_state = _adjoint(v, rec, ltab, amb, g_acc,
                                                    g_next)
        at = slice(k * N, (k + 1) * N)
        g_s[:, at] = torch.where(live, torch.stack(g_srow), 0.0)
        g_m[:, at] = torch.where(live, torch.stack(g_mrow), 0.0)
        tiles = tiles + _tile_sums(torch.where(live, torch.stack(g_light),
                                               0.0))
        passed = (torch.zeros_like(g_acc[0]),) * 9 if g_next is None \
            else g_next
        g_next = tuple(torch.where(live, a, b)
                       for a, b in zip(g_state, passed))
    return g_s, g_m, tiles


def _table_args(sc: SceneArrays):
    """What the fused replay reads of a scene: the differentiable tables
    (stab, mtab, ltab, amb) and the integer tables and flags."""
    stab, mtab = row_tables(sc)
    return (stab, mtab, light_table(sc), sc.amb_col, sc.s_kind, sc.s_mat,
            sc.m_props, sc.use_gamma, sc.use_fresnel)


class ReplayColor(torch.autograd.Function):
    """Colors (N, 3) along saved paths, differentiable in stab, mtab,
    ltab and amb: on CUDA tensors the fused kernels (``plain`` False),
    else ``forward_plain`` / ``backward_plain``."""

    @staticmethod
    def forward(ctx, plain, stab, mtab, ltab, amb, s_kind, s_mat, m_props,
                use_gamma, use_fresnel, org, dirs, paths):
        fwd = forward_plain if plain else _forward_kernel
        cols, state, ids = fwd(stab, mtab, ltab, amb, s_kind, s_mat,
                               m_props, use_gamma, use_fresnel, org, dirs,
                               paths)
        ctx.plain = plain
        ctx.save_for_backward(stab, mtab, ltab, amb, s_kind, s_mat, m_props,
                              use_gamma, use_fresnel, paths, state, ids)
        return cols

    @staticmethod
    def backward(ctx, g_cols):
        bwd = backward_plain if ctx.plain else _backward_kernel
        grads = bwd(g_cols.contiguous(), *ctx.saved_tensors)
        want = ctx.needs_input_grad[1:5]
        return (None,) + tuple(g if w else None
                               for g, w in zip(grads, want)) + (None,) * 8


def _fused(plain: bool, sc: SceneArrays, org, dirs, paths):
    if org.requires_grad or dirs.requires_grad:
        raise ValueError("replay_color_fused: the rays are not "
                         "differentiated; org and dirs must not require "
                         "grad")
    return ReplayColor.apply(plain, *_table_args(sc), org, dirs, paths)


def replay_color_fused(sc: SceneArrays, org, dirs, t_min, paths,
                       cfg: TraceConfig = TraceConfig()):
    """``replay_color``'s colors and gradients in one forward and one
    backward launch for all K segments (csrc/replay.cu
    ``replay_forward_launch``, ``replay_backward_launch``) on CUDA
    tensors, which launch the kernels or raise; CPU tensors take the
    plain versions (``replay_plain``). Differentiable in every float
    field replay_color is but the rays (ValueError if org or dirs require
    grad). ``t_min`` and ``cfg`` as replay_color."""
    del t_min, cfg
    dev = dirs.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"replay_color_fused: unsupported device {dev}")
    return _fused(dev.type == "cpu", sc, org, dirs, paths)


def replay_plain(sc: SceneArrays, org, dirs, t_min, paths,
                 cfg: TraceConfig = TraceConfig()):
    """The fused replay's plain version on any device: replay_color's
    forward arithmetic and the hand-written backward in the kernels'
    order (``forward_plain``, ``backward_plain``)."""
    del t_min, cfg
    return _fused(True, sc, org, dirs, paths)


def _check_tables(stab, mtab, ltab, amb, s_kind, s_mat, m_props, use_gamma,
                  use_fresnel, dev):
    ns, nm, nl = stab.shape[1], mtab.shape[1], ltab.shape[0]
    for name, t, dtype, shape in (
            ("stab", stab, F32, (SURFACE_ROWS, ns)),
            ("mtab", mtab, F32, (MATERIAL_ROWS, nm)),
            ("ltab", ltab, F32, (nl, LIGHT_ROWS)), ("amb", amb, F32, (3,)),
            ("s_kind", s_kind, torch.int32, (ns,)),
            ("s_mat", s_mat, torch.int32, (ns, 2)),
            ("m_props", m_props, torch.int32, (nm,)),
            ("use_gamma", use_gamma, F32, ()),
            ("use_fresnel", use_fresnel, F32, ())):
        _check(name, t, dtype, shape, dev)
    return ns, nm, nl


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _forward_kernel(stab, mtab, ltab, amb, s_kind, s_mat, m_props,
                    use_gamma, use_fresnel, org, dirs, paths):
    """forward_plain's outputs from ``replay_forward_launch``."""
    global launches
    dev = dirs.device
    if dev.type != "cuda":
        raise ValueError(f"replay_forward: unsupported device {dev}")
    ns, nm, nl = _check_tables(stab, mtab, ltab, amb, s_kind, s_mat,
                               m_props, use_gamma, use_fresnel, dev)
    n, k = dirs.shape[0], paths.shape[0]
    _check("dirs", dirs, F32, (n, 3), dev)
    _check("paths", paths, torch.int32, (k, n), dev)
    if org.dim() == 1:
        _check("org", org, F32, (3,), dev)
        org_stride = 0
    elif (tuple(org.shape) == (n, 3) and org.dtype == F32
          and org.device == dev and org.stride(1) == 1
          and org.stride(0) in (0, 3)):
        org_stride = org.stride(0)
    else:
        raise ValueError(f"org: need f32 (3,) or (N, 3) rows of stride 0 or "
                         f"3 on {dev}, got {org.dtype} {tuple(org.shape)} "
                         f"strides {org.stride()} on {org.device}")
    cols = torch.empty((n, 3), dtype=F32, device=dev)
    state = torch.empty((k, STATE_ROWS, n), dtype=F32, device=dev)
    ids = torch.empty((2, k, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = rg._lib().replay_forward_launch(
            stab.data_ptr(), mtab.data_ptr(), ltab.data_ptr(),
            amb.data_ptr(), s_kind.data_ptr(), s_mat.data_ptr(),
            m_props.data_ptr(), use_gamma.data_ptr(), use_fresnel.data_ptr(),
            org.data_ptr(), dirs.data_ptr(), paths.data_ptr(),
            cols.data_ptr(), state.data_ptr(), ids.data_ptr(), n, k, ns, nm,
            nl, org_stride, _stream(dev))
    if err != 0:
        raise RuntimeError(f"replay forward launch failed: CUDA error {err}")
    launches += 1
    return cols, state, ids


def _backward_kernel(g_cols, stab, mtab, ltab, amb, s_kind, s_mat, m_props,
                     use_gamma, use_fresnel, paths, state, ids):
    """backward_plain's outputs from the kernels: ``backward_rows_kernel``,
    then the row gather's backward kernel sums the row gradients over all
    K x N entries."""
    nl = ltab.shape[0]
    g_s, g_m, g_la = backward_rows_kernel(
        g_cols, stab, mtab, ltab, amb, s_kind, s_mat, m_props, use_gamma,
        use_fresnel, paths, state, ids)
    g_stab, g_mtab = rg._backward(g_s, g_m, ids[0].reshape(-1),
                                  ids[1].reshape(-1), stab.shape[1],
                                  mtab.shape[1])
    return (g_stab, g_mtab, g_la[:LIGHT_ROWS * nl].view(nl, LIGHT_ROWS),
            g_la[LIGHT_ROWS * nl:])


def backward_rows_kernel(g_cols, stab, mtab, ltab, amb, s_kind, s_mat,
                         m_props, use_gamma, use_fresnel, paths, state, ids):
    """``replay_backward_launch``: each segment's row gradients g_s (19, K
    N) and g_m (10, K N), bitwise backward_rows_plain's, and the lights'
    and ambient's gradients (10 NL + 3,), bitwise _block_sums of its
    tiles."""
    global backward_launches
    dev = g_cols.device
    if dev.type != "cuda":
        raise ValueError(f"replay_backward: unsupported device {dev}")
    n, k = g_cols.shape[0], paths.shape[0]
    ns, nm, nl = _check_tables(stab, mtab, ltab, amb, s_kind, s_mat,
                               m_props, use_gamma, use_fresnel, dev)
    _check("paths", paths, torch.int32, (k, n), dev)
    _check("g_cols", g_cols, F32, (n, 3), dev)
    _check("state", state, F32, (k, STATE_ROWS, n), dev)
    _check("ids", ids, torch.int32, (2, k, n), dev)
    nla = LIGHT_ROWS * nl + 3
    g_s = torch.empty((SURFACE_ROWS, k * n), dtype=F32, device=dev)
    g_m = torch.empty((MATERIAL_ROWS, k * n), dtype=F32, device=dev)
    blocks = -(-n // (BWD_WARPS * WARP))
    lpart = torch.empty((blocks, nla), dtype=F32, device=dev)
    lgroup = torch.empty((-(-blocks // LIGHT_GROUP), nla), dtype=F32,
                         device=dev)
    g_la = torch.empty((nla,), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        err = rg._lib().replay_backward_launch(
            stab.data_ptr(), mtab.data_ptr(), ltab.data_ptr(),
            amb.data_ptr(), s_kind.data_ptr(), s_mat.data_ptr(),
            m_props.data_ptr(), use_gamma.data_ptr(), use_fresnel.data_ptr(),
            paths.data_ptr(), state.data_ptr(), ids.data_ptr(),
            g_cols.data_ptr(), g_s.data_ptr(), g_m.data_ptr(),
            lpart.data_ptr(), lgroup.data_ptr(), g_la.data_ptr(), n, k, ns,
            nm, nl, _stream(dev))
    if err != 0:
        raise RuntimeError(f"replay backward launch failed: CUDA error {err}")
    backward_launches += 1
    return g_s, g_m, g_la
