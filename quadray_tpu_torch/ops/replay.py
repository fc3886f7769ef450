"""Trace-replay differentiation: the fast training path.

The counterpart of ``quadray_tpu.ops.replay``. The differentiable pixel
function is split in two:

  * the path-record kernel (``ops.cuda_kernel.trace_paths``, the
    ``EMIT_PATHS`` mode of ``csrc/whitted.cu``) traces the rays and writes
    a per-segment PATH RECORD (hit surface id, side, continuation kind,
    per-light shadow bits; layout in ``ops.trace.trace_paths``);
  * ``replay_color`` re-evaluates the color as a differentiable function
    of the scene parameters along those saved paths, O(N*K) work with row
    gathers, no per-surface loop; autograd differentiates it.

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

import torch

from quadray_tpu_torch.ops.cuda_kernel import MAX_PATH_LIGHTS
from quadray_tpu_torch.ops.row_gather import RowGather
from quadray_tpu_torch.ops.trace import TraceConfig, _root, _safe_div, clip
from quadray_tpu_torch.scene.compile import (
    SceneArrays, PROP_LIGHT, PROP_METAL, PROP_OPAQUE, PROP_REFLECT,
    PROP_REFRACT, PROP_DIFFUSE, PROP_SPECULAR, PROP_GAMMA, PROP_FRESNEL)

F32 = torch.float32


def row_tables(sc: SceneArrays):
    """The tables replay gathers rows of: the surface table, transposed
    (19, NS): pos 0-2, inv 3-11, sci 12-14, scjh 15-17, sciw 18; the
    material table (10, NM): col 0-2, dff, spc, pow, rfl, trn, rfr, ext.
    Both contiguous, differentiable in the scene's fields."""
    ns = sc.s_pos.shape[0]
    stab = torch.cat([sc.s_pos, sc.s_inv.reshape(ns, 9), sc.s_sci,
                      sc.s_scjh, sc.s_sciw[:, None]], dim=1).T.contiguous()
    mtab = torch.stack([
        sc.m_col[:, 0], sc.m_col[:, 1], sc.m_col[:, 2], sc.m_dff,
        sc.m_spc, sc.m_pow, sc.m_rfl, sc.m_trn, sc.m_rfr, sc.m_ext])
    return stab, mtab


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
