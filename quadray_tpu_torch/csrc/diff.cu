// The all-surface differentiable route's backward for NVIDIA Hopper
// (sm_90a): the adjoint of trace_rays_diff's bounces, written out by hand.
//
// Replaces the reverse pass of jax.value_and_grad over the JAX
// trace_rays_diff inside make_train_step's jitted step
// (quadray_tpu/parallel/train.py:250, quadray_tpu/ops/trace.py:725), which
// XLA compiles into the step's one executable; on the card the autograd
// route (ops/trace.py trace_rays_diff) ran it as some twenty thousand
// small kernels. Its plain version is ops/diff.py backward_rows_plain
// (_recompute and _adjoint), which this file follows operation for
// operation, so that on the card the two give the same bits.
//
//   diff_backward_launch   a thread a ray runs its bounces in reverse from
//                          the forward's tape (csrc/whitted.cu
//                          tape_kernel): each hit is recomputed for the
//                          surface and root the nearest fold picked (the
//                          scalar form of intersect: quadric Vieta roots,
//                          the two-plane determinant, the near-zero
//                          determinant sort, the plane root, the apex
//                          nudge, the normal), then shade, fresnel_terms,
//                          local_w and the continuations, and their
//                          adjoint is taken; a popped slot's adjoint waits
//                          in the thread's stack until the bounce that
//                          pushed it. Each block's partial of the tables'
//                          gradients: a warp's xor butterfly a bounce for
//                          each table row a live lane of it hit (the
//                          leaves masked by the lanes' row ids) and for
//                          the lights and the ambient, into the warp's
//                          accumulators in shared memory, the warps in
//                          order; csrc/replay.cu replay_light_sums_launch
//                          adds the partials in block and group order. No
//                          atomics: a step is the same bits run after
//                          run. Wide tables (the accumulators past the
//                          shared memory a block may have; ops/diff.py
//                          ROWS_SMEM_BYTES) take the second mode, which
//                          writes each bounce's 19 surface and 10 material
//                          row gradients and row ids in (F, K*N) layout
//                          for csrc/replay.cu row_gather_backward_launch
//                          to sum per table row, the lights and the
//                          ambient as above.
//
// What bounds it on the H100: at 384,000 rays and 8 bounces it reads the
// flags word of every ray-bounce and the rest of the tape of a hit (test17:
// 12.3 + 26.7 MB) and writes each block's partial (3,000 blocks x 215
// floats); the arithmetic, some 2,000 FP32 operations a hit plus the row
// butterflies, is about 5 GFLOP. Both are far below a millisecond; the
// recompute's dependent chains and the divergence of rays that stop at
// different bounces make it latency-bound. (The wide mode writes 29
// row-gradient floats and 2 ids a ray a bounce, 381 MB, as before.)
//
// The branch stack's adjoints: CAP slots in local memory (4, 8 or 16: the
// least that holds d = min(stack, K) slots, since a ray pushes at most
// once a bounce), else (CAP 0) d slots a thread of a device-memory scratch.
// Each bounce's slot is counted from the tape's pushes and pops
// (ops/diff.py stack_slots), not read from its 4-bit field.
//
// f32 rules: built with --fmad=false, IEEE division (ops/_build.py
// NVCC_FLAGS); sqrt and rsqrt are __fsqrt_rn/__frsqrt_rn (the plain
// version's correctly rounded _sqrt/_rsqrt), exp and log expf/logf
// (PyTorch's CUDA exp and log).

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int BWD_WARPS = 4;                   // warps a block (replay's)
constexpr int BWD_THREADS = BWD_WARPS * WARP;  // the light sums' order
constexpr int SF = 19, MF = 10;                // surface / material floats
constexpr int LROW = 10;                       // a light's row
constexpr int TAPE_F = 12;                     // a bounce's entry state
constexpr unsigned T_SRF = 0xFFFFu, T_HIT = 1u << 16, T_SIDE = 1u << 17,
                   T_OWN = 1u << 18, T_NUDGE = 1u << 19, T_PUSH = 1u << 22,
                   T_POP = 1u << 23;
constexpr int T_KIND_SHIFT = 20, T_SLOT_SHIFT = 24;
constexpr int P_LIGHT = 1 << 0, P_METAL = 1 << 1, P_OPAQUE = 1 << 2,
              P_REFLECT = 1 << 3, P_REFRACT = 1 << 4, P_DIFFUSE = 1 << 5,
              P_SPECULAR = 1 << 6, P_GAMMA = 1 << 8, P_FRESNEL = 1 << 9;
constexpr float BIG = 1e30f;
constexpr float D_EPS = 1e-11f;
constexpr float T_EPS = 1e-7f;

struct Tabs {
  const float* stab;   // (19, ns)
  const float* mtab;   // (10, nm)
  const float* ltab;   // (nl, 10)
  const float* amb;    // (3,)
  const int* s_kind;   // (ns,)
  const int* s_sing;   // (ns,)
  const int* s_mat;    // (ns, 2)
  const int* m_props;  // (nm,)
  const float* s_fwd;  // (ns, 9)
  const float* tex;    // (nt, 3)
  int ns, nm, nl, nt;
  int schlick;         // Schlick's F (TraceConfig.schlick)
};

// torch.clamp(x, min=lo), torch.maximum / minimum: NaN propagates
__device__ __forceinline__ float clampmin(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}
__device__ __forceinline__ float clampmin_grad(float x, float lo, float g) {
  return x >= lo ? g : 0.0f;
}
__device__ __forceinline__ float clip_grad(float x, float lo, float hi,
                                           float g) {
  const float m = tmax(x, lo);
  const float gm = m > hi ? 0.0f : (m == hi ? 0.5f * g : g);
  return x < lo ? 0.0f : (x == lo ? 0.5f * gm : gm);
}
__device__ __forceinline__ float sgn(float x) {
  return x >= 0.0f ? 1.0f : -1.0f;
}
__device__ __forceinline__ float sgn0(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ float sdiv(float num, float den, float fb) {
  const bool bad = fabsf(den) < 1e-30f;
  return bad ? fb : num / (bad ? 1.0f : den);
}
// (d num, d den) of sdiv(num, den) = q; none where g is 0
__device__ __forceinline__ void sdiv_grad(float q, float den, float g,
                                          float& gn, float& gd) {
  const bool bad = fabsf(den) < 1e-30f;
  gn = bad ? 0.0f : g / den;
  gd = (bad || g == 0.0f) ? 0.0f : -(g * (q / den));
}
// trace._root with its effective denominator
__device__ __forceinline__ float root(float num, float den, bool& ok,
                                      float& den2) {
  den2 = num == 0.0f ? 1.0f : den;
  ok = den2 != 0.0f;
  return ok ? num / (ok ? den2 : 1.0f) : BIG;
}
__device__ __forceinline__ void root_grad(float num, float t, bool ok,
                                          float den, float g, float& gn,
                                          float& gd) {
  gn = ok ? g / den : 0.0f;
  gd = (num == 0.0f || !ok || g == 0.0f) ? 0.0f : -(g * (t / den));
}

// a bounce: ops/diff.py _recompute's locals
struct Bnc {
  // the tape
  float ox, oy, oz, dx, dy, dz, tr, tg, tb, olx, oly, olz;
  int bs, m, skind, sing, props;
  bool sidep, own, nudge, textured;
  // rows
  float px, py, pz, i00, i01, i02, i10, i11, i12, i20, i21, i22;
  float sx, sy, sz, jx, jy, jz, sw;
  float mc0_r, mc0_g, mc0_b, m_dff, m_spc, m_pow, m_rfl, m_trn, m_rfr, m_ext;
  float f[9];
  // geometry
  bool is_pl, is_tp, dpos, b_pos, ok1, ok2, upos, srt, slot_b, cyl, rpos;
  float rx, ry, rz, lx, ly, lz, ex, ey, ez, a, ux, uy, uz, b, c, cross, sxz;
  float asxz, disc, sq, sgn_b, qq, n1, d1, n2, d2_, t1r, dd1, t2r, dd2;
  float sgn_a, t_pl, t, qr, racc, rr, inv_r, sqr, six, siy, skz, skq;
  float hx, hy, hz, wx, wy, wz, gx, gy, gz, sf, nrx, nry, nrz, qn, nn;
  float nx, ny, nz;
  // shading
  bool gam, metal, diffuse, specular, emis, refracts, fres, rf_mask;
  float mt_r, mt_g, mt_b, mc_r, mc_g, mc_b, d2, col_r, col_g, col_b;
  // Fresnel, the local weight and the reflection
  bool tir, kpos;
  float dl, rhx, rhy, rhz, dot, eta, ed, ksn, sqk, esq, rfx, rfy, rfz;
  float den_rs, rs, es, den_rp, rp, s_f, fr0, fr, c_trn, c_rfl0, rcp, ext2;
  float t2m, c2, gg, x0, x1, den_a, fa, den_b, fb, vm, vp, f_rf, c_rfl;
  float lw0, lw, ddn, t2d;
  // Schlick's F (fresnel_schlick)
  bool big;
  float xs, den_r, r, r0, xx, x4, x5;
};

// a light's term: ops/diff.py _light's locals
struct Light {
  float lpx, lpy, lpz, lcr, lcg, lcb, cnt, lnr, qdr;
  float lvx, lvy, lvz, r_dot, r2, r, den, attn, dfs, t2r;
  float rlx, rly, rlz, sdot, d2r2, rs2, cosr0, cosr_s, cosr, lg, e, spc, tm;
  float mclc_r, mclc_g, mclc_b, term_r, term_g, term_b;
  bool don, spc_on;
};

__device__ __forceinline__ void light(Light& q, const Tabs& t, int l,
                                      const Bnc& v, bool vis) {
  const float* lt = t.ltab + l * LROW;
  q.lpx = __ldg(lt);
  q.lpy = __ldg(lt + 1);
  q.lpz = __ldg(lt + 2);
  q.lcr = __ldg(lt + 3);
  q.lcg = __ldg(lt + 4);
  q.lcb = __ldg(lt + 5);
  q.cnt = __ldg(lt + 7);
  q.lnr = __ldg(lt + 8);
  q.qdr = __ldg(lt + 9);
  q.lvx = q.lpx - v.wx;
  q.lvy = q.lpy - v.wy;
  q.lvz = q.lpz - v.wz;
  q.r_dot = q.lvx * v.nx + q.lvy * v.ny + q.lvz * v.nz;
  q.r2 = q.lvx * q.lvx + q.lvy * q.lvy + q.lvz * q.lvz;
  q.r = __fsqrt_rn(clampmin(q.r2, 1e-30f));
  q.den = q.cnt + q.lnr * q.r + q.qdr * q.r2;
  q.attn = __frsqrt_rn(clampmin(q.den, 1e-30f));
  q.don = vis && v.diffuse;
  q.dfs = q.don ? q.r_dot / q.r * q.attn * v.m_dff : 0.0f;
  q.t2r = 2.0f * q.r_dot;
  q.rlx = q.lvx - q.t2r * v.nx;
  q.rly = q.lvy - q.t2r * v.ny;
  q.rlz = q.lvz - q.t2r * v.nz;
  q.sdot = q.rlx * v.dx + q.rly * v.dy + q.rlz * v.dz;
  q.d2r2 = v.d2 * q.r2;
  q.rs2 = __frsqrt_rn(clampmin(q.d2r2, 1e-30f));
  q.cosr0 = q.sdot * q.rs2;
  q.spc_on = vis && (q.sdot > 0.0f) && v.specular;
  q.cosr_s = q.spc_on ? q.cosr0 : 1.0f;
  q.cosr = clip(q.cosr_s, 1e-6f, 1.0f);
  q.lg = logf(q.cosr);
  q.e = expf(v.m_pow * q.lg);
  q.spc = q.spc_on ? q.e * v.m_spc : 0.0f;
  q.tm = q.dfs + q.spc;
  q.mclc_r = v.mc_r * q.lcr;
  q.mclc_g = v.mc_g * q.lcg;
  q.mclc_b = v.mc_b * q.lcb;
  q.term_r = v.metal ? q.mclc_r * q.tm : q.mclc_r * q.dfs + q.lcr * q.spc;
  q.term_g = v.metal ? q.mclc_g * q.tm : q.mclc_g * q.dfs + q.lcg * q.spc;
  q.term_b = v.metal ? q.mclc_b * q.tm : q.mclc_b * q.dfs + q.lcb * q.spc;
}

// light l lit and unshadowed at the bounce (its tape bit; none where lw
// is null: a bounce without a hit, whose light words the tape leaves
// unwritten)
__device__ __forceinline__ bool vis_bit(const int* __restrict__ lw, size_t n,
                                        int l) {
  return lw != nullptr &&
         (((unsigned)lw[(size_t)(l / 32) * n] >> (l % 32)) & 1u);
}

// ops/diff.py _recompute: the bounce of tape state st (12 floats) and
// flags/texel, its light bits at lw (a word every n; null: none lit)
__device__ __forceinline__ void recompute(Bnc& v, const Tabs& t, bool ug,
                                          bool uf, const float (&st)[TAPE_F],
                                          unsigned flags, int texel,
                                          const int* __restrict__ lw,
                                          size_t n) {
  v.ox = st[0]; v.oy = st[1]; v.oz = st[2];
  v.dx = st[3]; v.dy = st[4]; v.dz = st[5];
  v.tr = st[6]; v.tg = st[7]; v.tb = st[8];
  v.olx = st[9]; v.oly = st[10]; v.olz = st[11];
  v.bs = (int)(flags & T_SRF);
  v.sidep = (flags & T_SIDE) != 0u;
  v.own = (flags & T_OWN) != 0u;
  v.nudge = (flags & T_NUDGE) != 0u;
  v.textured = texel >= 0;
  // an id off its table stops the launch, as an index's device check does
  if (v.bs >= t.ns || texel >= t.nt) __trap();
  v.m = __ldg(t.s_mat + 2 * v.bs + (v.sidep ? 0 : 1));
  if (v.m < 0 || v.m >= t.nm) __trap();
  const float* S = t.stab;
  const int ns = t.ns, s = v.bs;
  v.px = __ldg(S + 0 * ns + s);
  v.py = __ldg(S + 1 * ns + s);
  v.pz = __ldg(S + 2 * ns + s);
  v.i00 = __ldg(S + 3 * ns + s);
  v.i01 = __ldg(S + 4 * ns + s);
  v.i02 = __ldg(S + 5 * ns + s);
  v.i10 = __ldg(S + 6 * ns + s);
  v.i11 = __ldg(S + 7 * ns + s);
  v.i12 = __ldg(S + 8 * ns + s);
  v.i20 = __ldg(S + 9 * ns + s);
  v.i21 = __ldg(S + 10 * ns + s);
  v.i22 = __ldg(S + 11 * ns + s);
  v.sx = __ldg(S + 12 * ns + s);
  v.sy = __ldg(S + 13 * ns + s);
  v.sz = __ldg(S + 14 * ns + s);
  v.jx = __ldg(S + 15 * ns + s);
  v.jy = __ldg(S + 16 * ns + s);
  v.jz = __ldg(S + 17 * ns + s);
  v.sw = __ldg(S + 18 * ns + s);
  const float* M = t.mtab;
  const int nm = t.nm, m = v.m;
  v.mc0_r = __ldg(M + 0 * nm + m);
  v.mc0_g = __ldg(M + 1 * nm + m);
  v.mc0_b = __ldg(M + 2 * nm + m);
  v.m_dff = __ldg(M + 3 * nm + m);
  v.m_spc = __ldg(M + 4 * nm + m);
  v.m_pow = __ldg(M + 5 * nm + m);
  v.m_rfl = __ldg(M + 6 * nm + m);
  v.m_trn = __ldg(M + 7 * nm + m);
  v.m_rfr = __ldg(M + 8 * nm + m);
  v.m_ext = __ldg(M + 9 * nm + m);
  for (int j = 0; j < 9; ++j) v.f[j] = __ldg(t.s_fwd + 9 * s + j);
  v.skind = __ldg(t.s_kind + s);
  v.sing = __ldg(t.s_sing + s);
  v.props = __ldg(t.m_props + m);

  // intersect, for the picked surface
  v.rx = v.ox - v.px;
  v.ry = v.oy - v.py;
  v.rz = v.oz - v.pz;
  const float lx0 = v.i00 * v.rx + v.i01 * v.ry + v.i02 * v.rz;
  const float ly0 = v.i10 * v.rx + v.i11 * v.ry + v.i12 * v.rz;
  const float lz0 = v.i20 * v.rx + v.i21 * v.ry + v.i22 * v.rz;
  v.lx = v.own ? v.olx : lx0;
  v.ly = v.own ? v.oly : ly0;
  v.lz = v.own ? v.olz : lz0;
  v.ex = v.i00 * v.dx + v.i01 * v.dy + v.i02 * v.dz;
  v.ey = v.i10 * v.dx + v.i11 * v.dy + v.i12 * v.dz;
  v.ez = v.i20 * v.dx + v.i21 * v.dy + v.i22 * v.dz;
  v.is_pl = v.skind == 1;
  v.is_tp = v.skind == 3;
  v.a = v.sx * v.ex * v.ex + v.sy * v.ey * v.ey + v.sz * v.ez * v.ez;
  v.ux = v.sx * v.lx - v.jx;
  v.uy = v.sy * v.ly - v.jy;
  v.uz = v.sz * v.lz - v.jz;
  v.b = v.ux * v.ex + v.uy * v.ey + v.uz * v.ez;
  v.c = v.sx * v.lx * v.lx + v.sy * v.ly * v.ly + v.sz * v.lz * v.lz -
        2.0f * (v.jx * v.lx + v.jy * v.ly + v.jz * v.lz) - v.sw;
  v.cross = v.lx * v.ez - v.lz * v.ex;
  v.sxz = v.sx * v.sz;
  v.asxz = fabsf(v.sxz);
  v.disc = v.is_tp ? v.asxz * v.cross * v.cross : v.b * v.b - v.a * v.c;
  const bool quad_ok = v.disc >= 0.0f;
  v.dpos = v.disc > 0.0f;
  v.sq = v.dpos ? __fsqrt_rn(v.dpos ? v.disc : 1.0f) : 0.0f;
  v.sgn_b = sgn(v.b);
  v.qq = -(v.b + v.sgn_b * v.sq);
  v.b_pos = v.b > 0.0f;
  v.n1 = v.b_pos ? v.qq : v.c;
  v.d1 = v.b_pos ? v.a : v.qq;
  v.n2 = v.b_pos ? v.c : v.qq;
  v.d2_ = v.b_pos ? v.qq : v.a;
  v.t1r = root(v.n1, v.d1, v.ok1, v.dd1);
  v.t2r = root(v.n2, v.d2_, v.ok2, v.dd2);
  const bool dmask = quad_ok && v.disc < D_EPS;
  v.sgn_a = sgn(v.a);
  const float u = (v.t1r - v.t2r) * v.sgn_a;
  v.upos = u >= 0.0f;
  const float tdf =
      (v.upos ? -0.5f * u - fabsf(T_EPS * v.t1r) : 0.0f) * v.sgn_a;
  v.srt = dmask && v.ok1 && v.ok2;
  const float tdff = v.srt ? tdf : 0.0f;
  const float t1 = v.t1r + tdff;
  const float t2 = v.t2r - tdff;
  v.t_pl = sdiv(-v.lz, v.ez, BIG);
  v.slot_b = !v.is_pl && !v.sidep;
  v.t = v.is_pl ? v.t_pl : (v.slot_b ? t2 : t1);
  const float hx0 = v.lx + v.t * v.ex, hy0 = v.ly + v.t * v.ey,
              hz0 = v.lz + v.t * v.ez;
  const float wx0 = v.ox + v.t * v.dx, wy0 = v.oy + v.t * v.dy,
              wz0 = v.oz + v.t * v.dz;
  // the apex nudge
  v.cyl = v.sing == 2;
  const float num_r = v.sx + (v.cyl ? 0.0f : v.sy);
  v.qr = sdiv(num_r, v.sz, 0.0f);
  const float ratio = fabsf(v.qr);
  v.racc = ratio + (v.cyl ? 1.0f : 2.0f);
  v.rr = __frsqrt_rn(clampmin(v.racc, 1e-30f));
  v.inv_r = T_EPS * v.rr;
  v.rpos = ratio > 0.0f;
  v.sqr = v.rpos ? __fsqrt_rn(v.rpos ? ratio : 1.0f) : 0.0f;
  const bool a_neg = v.a < 0.0f;
  const float ij = (!v.sidep && !a_neg) ? -1.0f : 1.0f;
  const float kf = (v.sidep && a_neg) ? -1.0f : 1.0f;
  v.six = sgn(v.lx) * ij;
  v.siy = sgn(v.ly) * ij;
  v.skz = sgn(v.lz) * kf;
  v.skq = v.skz * v.sqr;
  const float ai = v.six * v.inv_r;
  const float aj = v.cyl ? 0.0f : v.siy * v.inv_r;
  const float ak = v.skq * v.inv_r;
  v.hx = v.nudge ? ai : hx0;
  v.hy = v.nudge ? aj : hy0;
  v.hz = v.nudge ? ak : hz0;
  v.wx = v.nudge ? v.px + (v.f[0] * ai + v.f[1] * aj + v.f[2] * ak) : wx0;
  v.wy = v.nudge ? v.py + (v.f[3] * ai + v.f[4] * aj + v.f[5] * ak) : wy0;
  v.wz = v.nudge ? v.pz + (v.f[6] * ai + v.f[7] * aj + v.f[8] * ak) : wz0;
  // the normal
  v.gx = v.is_pl ? 0.0f : v.sx * v.hx - v.jx;
  v.gy = v.is_pl ? 0.0f : v.sy * v.hy - v.jy;
  v.gz = v.is_pl ? 1.0f : v.sz * v.hz - v.jz;
  v.sf = v.sidep ? 1.0f : -1.0f;
  v.nrx = (v.i00 * v.gx + v.i10 * v.gy + v.i20 * v.gz) * v.sf;
  v.nry = (v.i01 * v.gx + v.i11 * v.gy + v.i21 * v.gz) * v.sf;
  v.nrz = (v.i02 * v.gx + v.i12 * v.gy + v.i22 * v.gz) * v.sf;
  v.qn = v.nrx * v.nrx + v.nry * v.nry + v.nrz * v.nrz;
  v.nn = __frsqrt_rn(clampmin(v.qn, 1e-30f));
  v.nx = v.nrx * v.nn;
  v.ny = v.nry * v.nn;
  v.nz = v.nrz * v.nn;

  // shade
  const int tx = texel >= 0 ? texel : 0;
  v.mt_r = v.textured ? __ldg(t.tex + 3 * tx) : v.mc0_r;
  v.mt_g = v.textured ? __ldg(t.tex + 3 * tx + 1) : v.mc0_g;
  v.mt_b = v.textured ? __ldg(t.tex + 3 * tx + 2) : v.mc0_b;
  const int p = v.props;
  v.gam = (p & P_GAMMA) && ug;
  v.mc_r = v.gam ? v.mt_r * v.mt_r : v.mt_r;
  v.mc_g = v.gam ? v.mt_g * v.mt_g : v.mt_g;
  v.mc_b = v.gam ? v.mt_b * v.mt_b : v.mt_b;
  v.metal = p & P_METAL;
  v.diffuse = p & P_DIFFUSE;
  v.specular = p & P_SPECULAR;
  v.emis = p & P_LIGHT;
  v.refracts = p & P_REFRACT;
  const bool fres_prop = (p & P_FRESNEL) && uf;
  v.fres = fres_prop && !(p & P_OPAQUE);
  v.rf_mask = fres_prop && (p & P_OPAQUE) && (p & P_REFLECT);
  v.d2 = v.dx * v.dx + v.dy * v.dy + v.dz * v.dz;
  float col_r = v.mc_r * __ldg(t.amb);
  float col_g = v.mc_g * __ldg(t.amb + 1);
  float col_b = v.mc_b * __ldg(t.amb + 2);
  for (int l = 0; l < t.nl; ++l) {
    Light q;
    light(q, t, l, v, vis_bit(lw, n, l));
    col_r = col_r + q.term_r;
    col_g = col_g + q.term_g;
    col_b = col_b + q.term_b;
  }
  v.col_r = v.emis ? v.mc_r : col_r;
  v.col_g = v.emis ? v.mc_g : col_g;
  v.col_b = v.emis ? v.mc_b : col_b;

  // fresnel_terms
  v.dl = __frsqrt_rn(clampmin(v.d2, 1e-30f));
  v.rhx = v.dx * v.dl;
  v.rhy = v.dy * v.dl;
  v.rhz = v.dz * v.dl;
  v.dot = v.rhx * v.nx + v.rhy * v.ny + v.rhz * v.nz;
  v.eta = v.m_rfr;
  v.ed = v.eta * v.dot;
  v.ksn = 1.0f - v.eta * v.eta + v.ed * v.ed;
  v.tir = (v.ksn < 0.0f) && v.refracts;
  v.kpos = v.ksn > 0.0f;
  v.sqk = v.kpos ? __fsqrt_rn(v.kpos ? v.ksn : 1.0f) : 0.0f;
  v.esq = v.ed + v.sqk;
  v.rfx = v.refracts ? v.eta * v.rhx - v.nx * v.esq : v.rhx;
  v.rfy = v.refracts ? v.eta * v.rhy - v.ny * v.esq : v.rhy;
  v.rfz = v.refracts ? v.eta * v.rhz - v.nz * v.esq : v.rhz;
  v.den_rs = v.ed - v.sqk;
  v.rs = sdiv(v.esq, v.den_rs, 1.0f);
  v.es = v.eta * v.sqk;
  v.den_rp = v.dot - v.es;
  v.rp = sdiv(v.dot + v.es, v.den_rp, 1.0f);
  v.s_f = v.rs * v.rs + v.rp * v.rp;
  if (t.schlick) {
    v.big = v.eta > 1.0f;
    v.xs = v.big ? 1.0f - v.sqk : 1.0f + v.dot;
    v.den_r = v.eta + 1.0f;
    v.r = sdiv(v.eta - 1.0f, v.den_r, 1.0f);
    v.r0 = v.r * v.r;
    v.xx = v.xs * v.xs;
    v.x4 = v.xx * v.xx;
    v.x5 = v.x4 * v.xs;
    v.fr0 = v.r0 + (1.0f - v.r0) * v.x5;
  } else {
    v.fr0 = 0.5f * v.s_f;
  }
  const float fr = v.fres ? clip(v.fr0, 0.0f, 1.0f) : 0.0f;
  v.fr = (v.tir && v.fres) ? 1.0f : fr;
  v.c_trn = v.tir ? 0.0f : v.m_trn * (1.0f - v.fr);
  v.c_rfl0 = v.m_rfl + v.m_trn * v.fr;
  v.rcp = sdiv(1.0f, v.eta, 0.0f);
  v.ext2 = v.m_ext * v.m_ext;
  v.t2m = 2.0f * v.dot * v.rcp;
  v.c2 = v.dot * v.dot;
  v.gg = v.rcp * v.rcp + v.ext2;
  v.x0 = v.c2 + v.gg;
  v.x1 = v.c2 * v.gg + 1.0f;
  v.den_a = v.x0 - v.t2m;
  v.fa = sdiv(v.x0 + v.t2m, v.den_a, 1.0f);
  v.den_b = v.x1 - v.t2m;
  v.fb = sdiv(v.x1 + v.t2m, v.den_b, 1.0f);
  v.vm = -0.5f * (v.fa + v.fb);
  v.vp = -0.5f * v.s_f;
  v.f_rf = v.metal ? fabsf(v.vm) : fabsf(v.vp);
  v.c_rfl = v.rf_mask ? v.m_rfl * v.f_rf : v.c_rfl0;
  v.lw0 = 1.0f - v.m_trn - v.m_rfl;
  v.lw = tmax(v.lw0, 0.0f);
  v.ddn = v.dx * v.nx + v.dy * v.ny + v.dz * v.nz;
  v.t2d = 2.0f * v.ddn;
}

struct Grads {
  float s[SF];       // the surface row's
  float m[MF];       // the material row's
  float st[TAPE_F];  // the entry state's
};

// ops/diff.py _adjoint, line for line. gn: the next state's gradient;
// gsl: the pushed slot's (zero where nothing was pushed). Each light's
// and the ambient's gradients go to add(base, 1, 0, values, count): the
// partials' columns base + j (add's form: column base + j stride + row).
template <class Add>
__device__ __forceinline__ void adjoint(const Bnc& v, const Tabs& t,
                                        unsigned flags,
                                        const int* __restrict__ lw, size_t n,
                                        float gar, float gag, float gab,
                                        const float (&gn)[TAPE_F],
                                        const float (&gsl)[TAPE_F], Add& add,
                                        Grads& out) {
  const int kind = (flags >> T_KIND_SHIFT) & 3;
  const bool is_rfl = kind == 1, is_trn = kind == 2, cont = kind > 0;
  const bool push = (flags & T_PUSH) != 0u;
  const float dx = v.dx, dy = v.dy, dz = v.dz, nx = v.nx, ny = v.ny,
              nz = v.nz;
  const float tr = v.tr, tg = v.tg, tb = v.tb;
  float gwx = (cont ? gn[0] : 0.0f) + (push ? gsl[0] : 0.0f);
  float gwy = (cont ? gn[1] : 0.0f) + (push ? gsl[1] : 0.0f);
  float gwz = (cont ? gn[2] : 0.0f) + (push ? gsl[2] : 0.0f);
  const float gmrx = is_rfl ? gn[3] : 0.0f;
  const float gmry = is_rfl ? gn[4] : 0.0f;
  const float gmrz = is_rfl ? gn[5] : 0.0f;
  const float grfx = (is_trn ? gn[3] : 0.0f) + (push ? gsl[3] : 0.0f);
  const float grfy = (is_trn ? gn[4] : 0.0f) + (push ? gsl[4] : 0.0f);
  const float grfz = (is_trn ? gn[5] : 0.0f) + (push ? gsl[5] : 0.0f);
  const float gtlr = is_rfl ? gn[6] : 0.0f;
  const float gtlg = is_rfl ? gn[7] : 0.0f;
  const float gtlb = is_rfl ? gn[8] : 0.0f;
  const float gttr = (is_trn ? gn[6] : 0.0f) + (push ? gsl[6] : 0.0f);
  const float gttg = (is_trn ? gn[7] : 0.0f) + (push ? gsl[7] : 0.0f);
  const float gttb = (is_trn ? gn[8] : 0.0f) + (push ? gsl[8] : 0.0f);
  float ghx = (cont ? gn[9] : 0.0f) + (push ? gsl[9] : 0.0f);
  float ghy = (cont ? gn[10] : 0.0f) + (push ? gsl[10] : 0.0f);
  float ghz = (cont ? gn[11] : 0.0f) + (push ? gsl[11] : 0.0f);
  const float g_crfl = gtlr * tr + gtlg * tg + gtlb * tb;
  const float g_ctrn = gttr * tr + gttg * tg + gttb * tb;
  float gtr = gtlr * v.c_rfl + gttr * v.c_trn;
  float gtg = gtlg * v.c_rfl + gttg * v.c_trn;
  float gtb = gtlb * v.c_rfl + gttb * v.c_trn;
  const float gddn = -2.0f * (gmrx * nx + gmry * ny + gmrz * nz);
  float gnx = gddn * dx - v.t2d * gmrx;
  float gny = gddn * dy - v.t2d * gmry;
  float gnz = gddn * dz - v.t2d * gmrz;
  float gdx = gmrx + gddn * nx;
  float gdy = gmry + gddn * ny;
  float gdz = gmrz + gddn * nz;

  const float g_frf = v.rf_mask ? g_crfl * v.m_rfl : 0.0f;
  const float g_crfl0 = v.rf_mask ? 0.0f : g_crfl;
  float g_rfl = (v.rf_mask ? g_crfl * v.f_rf : 0.0f) + g_crfl0;
  float g_fr = g_crfl0 * v.m_trn;
  float g_trn = g_crfl0 * v.fr;
  g_trn = g_trn + (v.tir ? 0.0f : g_ctrn * (1.0f - v.fr));
  g_fr = g_fr - (v.tir ? 0.0f : g_ctrn * v.m_trn);
  const float g_fr0 =
      clip_grad(v.fr0, 0.0f, 1.0f, (v.fres && !v.tir) ? g_fr : 0.0f);
  float g_sf, g_eta_s = 0.0f, g_sqk_s = 0.0f, g_dot_s = 0.0f;
  if (t.schlick) {
    // fr0 = r0 + (1 - r0) x5, x5 = (xs^2)^2 xs, r0 = r^2,
    // r = (eta - 1) / (eta + 1), xs = eta > 1 ? 1 - sqk : 1 + dot
    g_sf = 0.0f;
    const float g_x5 = g_fr0 * (1.0f - v.r0);
    const float g_r0 = g_fr0 - g_fr0 * v.x5;
    const float g_x4 = g_x5 * v.xs;
    float g_xs = g_x5 * v.x4;
    const float g_xx = 2.0f * g_x4 * v.xx;
    g_xs = g_xs + 2.0f * g_xx * v.xs;
    float gnr, gdr;
    sdiv_grad(v.r, v.den_r, 2.0f * g_r0 * v.r, gnr, gdr);
    g_eta_s = gnr + gdr;
    g_sqk_s = -(v.big ? g_xs : 0.0f);
    g_dot_s = v.big ? 0.0f : g_xs;
  } else {
    g_sf = 0.5f * g_fr0;
  }
  const float g_vm = (v.metal ? g_frf : 0.0f) * sgn0(v.vm);
  g_sf = g_sf + -0.5f * ((v.metal ? 0.0f : g_frf) * sgn0(v.vp));
  const float g_fab = -0.5f * g_vm;
  float gna, gda, gnb, gdb;
  sdiv_grad(v.fa, v.den_a, g_fab, gna, gda);
  sdiv_grad(v.fb, v.den_b, g_fab, gnb, gdb);
  const float gx0 = gna + gda;
  const float gx1 = gnb + gdb;
  const float gt2m = (gna - gda) + (gnb - gdb);
  const float gc2 = gx1 * v.gg + gx0;
  const float ggg = gx1 * v.c2 + gx0;
  const float grcp = 2.0f * ggg * v.rcp + gt2m * (2.0f * v.dot);
  const float g_ext = 2.0f * ggg * v.m_ext;
  float gdot = 2.0f * gc2 * v.dot + 2.0f * (gt2m * v.rcp);
  if (t.schlick) gdot = gdot + g_dot_s;
  float g_unused, g_rfr;
  sdiv_grad(v.rcp, v.eta, grcp, g_unused, g_rfr);
  const float grs = 2.0f * g_sf * v.rs;
  const float grp = 2.0f * g_sf * v.rp;
  float gns, gds, gnp, gdp;
  sdiv_grad(v.rs, v.den_rs, grs, gns, gds);
  float ged = gns + gds;
  float gsqk = gns - gds;
  sdiv_grad(v.rp, v.den_rp, grp, gnp, gdp);
  gdot = gdot + (gnp + gdp);
  const float ges = gnp - gdp;
  float geta = ges * v.sqk;
  gsqk = gsqk + ges * v.eta;
  if (t.schlick) {
    geta = geta + g_eta_s;
    gsqk = gsqk + g_sqk_s;
  }
  const float gqx = v.refracts ? grfx : 0.0f;
  const float gqy = v.refracts ? grfy : 0.0f;
  const float gqz = v.refracts ? grfz : 0.0f;
  float grhx = (v.refracts ? 0.0f : grfx) + v.eta * gqx;
  float grhy = (v.refracts ? 0.0f : grfy) + v.eta * gqy;
  float grhz = (v.refracts ? 0.0f : grfz) + v.eta * gqz;
  geta = geta + (gqx * v.rhx + gqy * v.rhy + gqz * v.rhz);
  const float gesq = -(gqx * nx + gqy * ny + gqz * nz);
  gnx = gnx - gqx * v.esq;
  gny = gny - gqy * v.esq;
  gnz = gnz - gqz * v.esq;
  ged = ged + gesq;
  gsqk = gsqk + gesq;
  const float gksn =
      v.kpos ? gsqk / (2.0f * (v.kpos ? v.sqk : 1.0f)) : 0.0f;
  geta = geta - 2.0f * gksn * v.eta;
  ged = ged + 2.0f * gksn * v.ed;
  geta = geta + ged * v.dot;
  gdot = gdot + ged * v.eta;
  g_rfr = g_rfr + geta;
  grhx = grhx + gdot * nx;
  grhy = grhy + gdot * ny;
  grhz = grhz + gdot * nz;
  gnx = gnx + gdot * v.rhx;
  gny = gny + gdot * v.rhy;
  gnz = gnz + gdot * v.rhz;
  gdx = gdx + grhx * v.dl;
  gdy = gdy + grhy * v.dl;
  gdz = gdz + grhz * v.dl;
  const float gdl = grhx * dx + grhy * dy + grhz * dz;
  float g_d2 =
      clampmin_grad(v.d2, 1e-30f, -0.5f * gdl * (v.dl * v.dl * v.dl));

  const float glw =
      gar * (tr * v.col_r) + gag * (tg * v.col_g) + gab * (tb * v.col_b);
  float gcr = gar * v.lw * tr;
  float gcg = gag * v.lw * tg;
  float gcb = gab * v.lw * tb;
  gtr = gtr + gar * v.lw * v.col_r;
  gtg = gtg + gag * v.lw * v.col_g;
  gtb = gtb + gab * v.lw * v.col_b;
  const float glw0 =
      v.lw0 < 0.0f ? 0.0f : (v.lw0 == 0.0f ? 0.5f * glw : glw);
  g_trn = g_trn - glw0;
  g_rfl = g_rfl - glw0;
  float gmr = v.emis ? gcr : 0.0f;
  float gmg = v.emis ? gcg : 0.0f;
  float gmb = v.emis ? gcb : 0.0f;
  gcr = v.emis ? 0.0f : gcr;
  gcg = v.emis ? 0.0f : gcg;
  gcb = v.emis ? 0.0f : gcb;
  float g_dff = 0.0f, g_spc = 0.0f, g_pow = 0.0f;
  for (int l = 0; l < t.nl; ++l) {
    Light q;
    light(q, t, l, v, vis_bit(lw, n, l));
    const float gqr = v.metal ? gcr * q.tm : gcr * q.dfs;
    const float gqg = v.metal ? gcg * q.tm : gcg * q.dfs;
    const float gqb = v.metal ? gcb * q.tm : gcb * q.dfs;
    const float gdfs = gcr * q.mclc_r + gcg * q.mclc_g + gcb * q.mclc_b;
    const float gspc =
        v.metal ? gdfs : gcr * q.lcr + gcg * q.lcg + gcb * q.lcb;
    const float glcr = (v.metal ? 0.0f : gcr * q.spc) + gqr * v.mc_r;
    const float glcg = (v.metal ? 0.0f : gcg * q.spc) + gqg * v.mc_g;
    const float glcb = (v.metal ? 0.0f : gcb * q.spc) + gqb * v.mc_b;
    gmr = gmr + gqr * q.lcr;
    gmg = gmg + gqg * q.lcg;
    gmb = gmb + gqb * q.lcb;
    const float ge = q.spc_on ? gspc * v.m_spc : 0.0f;
    g_spc = g_spc + (q.spc_on ? gspc * q.e : 0.0f);
    const float gy = ge * q.e;
    g_pow = g_pow + gy * q.lg;
    const float gcos = gy * v.m_pow / q.cosr;
    const float gcos0 =
        q.spc_on ? clip_grad(q.cosr_s, 1e-6f, 1.0f, gcos) : 0.0f;
    const float gsdot = gcos0 * q.rs2;
    const float gd2r2 = clampmin_grad(
        q.d2r2, 1e-30f, -0.5f * (gcos0 * q.sdot) * (q.rs2 * q.rs2 * q.rs2));
    g_d2 = g_d2 + gd2r2 * q.r2;
    float gr2 = gd2r2 * v.d2;
    const float grlx = gsdot * dx;
    const float grly = gsdot * dy;
    const float grlz = gsdot * dz;
    gdx = gdx + gsdot * q.rlx;
    gdy = gdy + gsdot * q.rly;
    gdz = gdz + gsdot * q.rlz;
    float grdot = -2.0f * (grlx * nx + grly * ny + grlz * nz);
    gnx = gnx - q.t2r * grlx;
    gny = gny - q.t2r * grly;
    gnz = gnz - q.t2r * grlz;
    const float a1 = q.r_dot / q.r;
    const float a2 = a1 * q.attn;
    g_dff = g_dff + (q.don ? gdfs * a2 : 0.0f);
    const float ga2 = q.don ? gdfs * v.m_dff : 0.0f;
    const float ga1 = ga2 * q.attn;
    const float gattn = ga2 * a1;
    grdot = grdot + ga1 / q.r;
    float gr = -(ga1 * (a1 / q.r));
    const float gden = clampmin_grad(
        q.den, 1e-30f, -0.5f * gattn * (q.attn * q.attn * q.attn));
    gr = gr + gden * q.lnr;
    gr2 = gr2 + gden * q.qdr;
    gr2 = gr2 + clampmin_grad(q.r2, 1e-30f, gr / (2.0f * q.r));
    const float glvx = grlx + 2.0f * gr2 * q.lvx + grdot * nx;
    const float glvy = grly + 2.0f * gr2 * q.lvy + grdot * ny;
    const float glvz = grlz + 2.0f * gr2 * q.lvz + grdot * nz;
    gnx = gnx + grdot * q.lvx;
    gny = gny + grdot * q.lvy;
    gnz = gnz + grdot * q.lvz;
    gwx = gwx - glvx;
    gwy = gwy - glvy;
    gwz = gwz - glvz;
    const float gl[LROW] = {glvx, glvy, glvz, glcr,       glcg,
                            glcb, 0.0f, gden, gden * q.r, gden * q.r2};
    add(l * LROW, 1, 0, gl, LROW);
  }
  {
    const float ga[3] = {gcr * v.mc_r, gcg * v.mc_g, gcb * v.mc_b};
    add(t.nl * LROW, 1, 0, ga, 3);
  }
  gmr = gmr + gcr * __ldg(t.amb);
  gmg = gmg + gcg * __ldg(t.amb + 1);
  gmb = gmb + gcb * __ldg(t.amb + 2);
  gmr = v.gam ? 2.0f * gmr * v.mt_r : gmr;
  gmg = v.gam ? 2.0f * gmg * v.mt_g : gmg;
  gmb = v.gam ? 2.0f * gmb * v.mt_b : gmb;
  gmr = v.textured ? 0.0f : gmr;
  gmg = v.textured ? 0.0f : gmg;
  gmb = v.textured ? 0.0f : gmb;
  gdx = gdx + 2.0f * g_d2 * dx;
  gdy = gdy + 2.0f * g_d2 * dy;
  gdz = gdz + 2.0f * g_d2 * dz;

  float gnrx = gnx * v.nn;
  float gnry = gny * v.nn;
  float gnrz = gnz * v.nn;
  const float gnn = gnx * v.nrx + gny * v.nry + gnz * v.nrz;
  const float gqn =
      clampmin_grad(v.qn, 1e-30f, -0.5f * gnn * (v.nn * v.nn * v.nn));
  gnrx = gnrx + 2.0f * gqn * v.nrx;
  gnry = gnry + 2.0f * gqn * v.nry;
  gnrz = gnrz + 2.0f * gqn * v.nrz;
  const float gmx = gnrx * v.sf;
  const float gmy = gnry * v.sf;
  const float gmz = gnrz * v.sf;
  float gi00 = gmx * v.gx, gi10 = gmx * v.gy, gi20 = gmx * v.gz;
  float gi01 = gmy * v.gx, gi11 = gmy * v.gy, gi21 = gmy * v.gz;
  float gi02 = gmz * v.gx, gi12 = gmz * v.gy, gi22 = gmz * v.gz;
  const float ggx = v.is_pl ? 0.0f : v.i00 * gmx + v.i01 * gmy + v.i02 * gmz;
  const float ggy = v.is_pl ? 0.0f : v.i10 * gmx + v.i11 * gmy + v.i12 * gmz;
  const float ggz = v.is_pl ? 0.0f : v.i20 * gmx + v.i21 * gmy + v.i22 * gmz;
  float gsx = ggx * v.hx;
  float gsy = ggy * v.hy;
  float gsz = ggz * v.hz;
  ghx = ghx + ggx * v.sx;
  ghy = ghy + ggy * v.sy;
  ghz = ghz + ggz * v.sz;
  float gjx = -ggx;
  float gjy = -ggy;
  float gjz = -ggz;

  // the nudge
  const bool nudge = v.nudge;
  const float gpx = nudge ? gwx : 0.0f;
  const float gpy = nudge ? gwy : 0.0f;
  const float gpz = nudge ? gwz : 0.0f;
  const float* f = v.f;
  const float gai =
      nudge ? ghx + (f[0] * gwx + f[3] * gwy + f[6] * gwz) : 0.0f;
  const float gaj = (nudge && !v.cyl)
                        ? ghy + (f[1] * gwx + f[4] * gwy + f[7] * gwz)
                        : 0.0f;
  const float gak =
      nudge ? ghz + (f[2] * gwx + f[5] * gwy + f[8] * gwz) : 0.0f;
  const float ginv_r = gai * v.six + gaj * v.siy + gak * v.skq;
  const float gsqr = gak * v.skz * v.inv_r;
  const float gracc = clampmin_grad(
      v.racc, 1e-30f, -0.5f * (T_EPS * ginv_r) * (v.rr * v.rr * v.rr));
  const float gratio =
      gracc + (v.rpos ? gsqr / (2.0f * (v.rpos ? v.sqr : 1.0f)) : 0.0f);
  const float gqr = gratio * sgn0(v.qr);
  float gnum_r, gsz_r;
  sdiv_grad(v.qr, v.sz, gqr, gnum_r, gsz_r);
  gsx = gsx + gnum_r;
  gsy = gsy + (v.cyl ? 0.0f : gnum_r);
  gsz = gsz + gsz_r;
  gwx = nudge ? 0.0f : gwx;
  gwy = nudge ? 0.0f : gwy;
  gwz = nudge ? 0.0f : gwz;
  ghx = nudge ? 0.0f : ghx;
  ghy = nudge ? 0.0f : ghy;
  ghz = nudge ? 0.0f : ghz;
  float gox = gwx, goy = gwy, goz = gwz;
  const float gt =
      (gwx * dx + gwy * dy + gwz * dz) + (ghx * v.ex + ghy * v.ey + ghz * v.ez);
  gdx = gdx + v.t * gwx;
  gdy = gdy + v.t * gwy;
  gdz = gdz + v.t * gwz;
  float glx = ghx, gly = ghy, glz = ghz;
  float gex = v.t * ghx;
  float gey = v.t * ghy;
  float gez = v.t * ghz;
  const float gtpl = v.is_pl ? gt : 0.0f;
  const float gt1 = (v.is_pl || v.slot_b) ? 0.0f : gt;
  const float gt2 = (!v.is_pl && v.slot_b) ? gt : 0.0f;
  float gnum_p, gden_p;
  sdiv_grad(v.t_pl, v.ez, gtpl, gnum_p, gden_p);
  glz = glz - gnum_p;
  gez = gez + gden_p;
  const float gtdf = v.srt ? gt1 - gt2 : 0.0f;
  const float gX = v.upos ? gtdf * v.sgn_a : 0.0f;
  const float gu = -0.5f * gX;
  const float gt1r = gt1 - (gX * sgn0(T_EPS * v.t1r)) * T_EPS + gu * v.sgn_a;
  const float gt2r = gt2 - gu * v.sgn_a;
  float gn1, gd1, gn2, gd2;
  root_grad(v.n1, v.t1r, v.ok1, v.dd1, gt1r, gn1, gd1);
  root_grad(v.n2, v.t2r, v.ok2, v.dd2, gt2r, gn2, gd2);
  const float gqq = (v.b_pos ? gn1 : gd1) + (v.b_pos ? gd2 : gn2);
  float gc = v.b_pos ? gn2 : gn1;
  float ga = v.b_pos ? gd1 : gd2;
  float gb = -gqq;
  const float gsq = -(gqq * v.sgn_b);
  const float gdisc = v.dpos ? gsq / (2.0f * (v.dpos ? v.sq : 1.0f)) : 0.0f;
  const float gdtp = v.is_tp ? gdisc : 0.0f;
  const float gdq = v.is_tp ? 0.0f : gdisc;
  const float gcross = 2.0f * gdtp * (v.asxz * v.cross);
  const float gsxz = gdtp * (v.cross * v.cross) * sgn0(v.sxz);
  gsx = gsx + gsxz * v.sz;
  gsz = gsz + gsxz * v.sx;
  glx = glx + gcross * v.ez;
  gez = gez + gcross * v.lx;
  glz = glz - gcross * v.ex;
  gex = gex - gcross * v.lz;
  gb = gb + 2.0f * gdq * v.b;
  ga = ga - gdq * v.c;
  gc = gc - gdq * v.a;
  gsx = gsx + ga * v.ex * v.ex;
  gsy = gsy + ga * v.ey * v.ey;
  gsz = gsz + ga * v.ez * v.ez;
  gex = gex + 2.0f * ga * v.sx * v.ex;
  gey = gey + 2.0f * ga * v.sy * v.ey;
  gez = gez + 2.0f * ga * v.sz * v.ez;
  const float gux = gb * v.ex;
  const float guy = gb * v.ey;
  const float guz = gb * v.ez;
  gex = gex + gb * v.ux;
  gey = gey + gb * v.uy;
  gez = gez + gb * v.uz;
  gsx = gsx + gux * v.lx;
  gsy = gsy + guy * v.ly;
  gsz = gsz + guz * v.lz;
  glx = glx + gux * v.sx;
  gly = gly + guy * v.sy;
  glz = glz + guz * v.sz;
  gjx = gjx - gux;
  gjy = gjy - guy;
  gjz = gjz - guz;
  gsx = gsx + gc * v.lx * v.lx;
  gsy = gsy + gc * v.ly * v.ly;
  gsz = gsz + gc * v.lz * v.lz;
  glx = glx + 2.0f * gc * v.sx * v.lx - 2.0f * gc * v.jx;
  gly = gly + 2.0f * gc * v.sy * v.ly - 2.0f * gc * v.jy;
  glz = glz + 2.0f * gc * v.sz * v.lz - 2.0f * gc * v.jz;
  gjx = gjx - 2.0f * gc * v.lx;
  gjy = gjy - 2.0f * gc * v.ly;
  gjz = gjz - 2.0f * gc * v.lz;
  const float gsw = -gc;
  const float golx = v.own ? glx : 0.0f;
  const float goly = v.own ? gly : 0.0f;
  const float golz = v.own ? glz : 0.0f;
  glx = v.own ? 0.0f : glx;
  gly = v.own ? 0.0f : gly;
  glz = v.own ? 0.0f : glz;
  gi00 = gi00 + glx * v.rx + gex * dx;
  gi01 = gi01 + glx * v.ry + gex * dy;
  gi02 = gi02 + glx * v.rz + gex * dz;
  gi10 = gi10 + gly * v.rx + gey * dx;
  gi11 = gi11 + gly * v.ry + gey * dy;
  gi12 = gi12 + gly * v.rz + gey * dz;
  gi20 = gi20 + glz * v.rx + gez * dx;
  gi21 = gi21 + glz * v.ry + gez * dy;
  gi22 = gi22 + glz * v.rz + gez * dz;
  const float grx = v.i00 * glx + v.i10 * gly + v.i20 * glz;
  const float gry = v.i01 * glx + v.i11 * gly + v.i21 * glz;
  const float grz = v.i02 * glx + v.i12 * gly + v.i22 * glz;
  gdx = gdx + (v.i00 * gex + v.i10 * gey + v.i20 * gez);
  gdy = gdy + (v.i01 * gex + v.i11 * gey + v.i21 * gez);
  gdz = gdz + (v.i02 * gex + v.i12 * gey + v.i22 * gez);
  gox = gox + grx;
  goy = goy + gry;
  goz = goz + grz;
  const float gs[SF] = {gpx - grx, gpy - gry, gpz - grz, gi00, gi01,
                        gi02,      gi10,      gi11,      gi12, gi20,
                        gi21,      gi22,      gsx,       gsy,  gsz,
                        gjx,       gjy,       gjz,       gsw};
  const float gm[MF] = {gmr,   gmg,   gmb,   g_dff, g_spc,
                        g_pow, g_rfl, g_trn, g_rfr, g_ext};
  const float gst[TAPE_F] = {gox, goy, goz, gdx, gdy, gdz,
                             gtr, gtg, gtb, golx, goly, golz};
  for (int j = 0; j < SF; ++j) out.s[j] = gs[j];
  for (int j = 0; j < MF; ++j) out.m[j] = gm[j];
  for (int j = 0; j < TAPE_F; ++j) out.st[j] = gst[j];
}

// a ray's reverse pass between bounces: the next state's gradient and the
// branch stack's slots' (ops/diff.py backward_rows_plain's gn, gs): CAP
// slots in local memory, or (CAP 0) d slots at gs in device memory
template <int CAP>
struct Back {
  float gn[TAPE_F];
  float gs[CAP][TAPE_F];
  __device__ __forceinline__ float* slot(int s) { return gs[s]; }
  __device__ __forceinline__ int cap() const { return CAP; }
  __device__ __forceinline__ void init(float*, int) {
    for (int j = 0; j < TAPE_F; ++j) gn[j] = 0.0f;
    for (int s = 0; s < CAP; ++s)
      for (int j = 0; j < TAPE_F; ++j) gs[s][j] = 0.0f;
  }
};
template <>
struct Back<0> {
  float gn[TAPE_F];
  float* gs;
  int d;
  __device__ __forceinline__ float* slot(int s) { return gs + s * TAPE_F; }
  __device__ __forceinline__ int cap() const { return d; }
  __device__ __forceinline__ void init(float* deep, int slots) {
    gs = deep;
    d = slots;
    for (int j = 0; j < TAPE_F; ++j) gn[j] = 0.0f;
    for (int j = 0; j < d * TAPE_F; ++j) gs[j] = 0.0f;
  }
};

// the stack's height after ray ii's last bounce: its pushes less its pops
__device__ __forceinline__ int stack_height(const int* __restrict__ ti,
                                            int words, int n, int ii,
                                            int k_segs) {
  int h = 0;
  for (int k = 0; k < k_segs; ++k) {
    const unsigned f = (unsigned)ti[(size_t)k * words * n + ii];
    h += ((f & T_PUSH) != 0u ? 1 : 0) - ((f & T_POP) != 0u ? 1 : 0);
  }
  return h;
}

// bounce k of ray ii (ii = i, or the last ray for a lane past it, `in`
// false): its recompute and adjoint where `any` (some lane of the warp
// has a hit there; the others compute along and are masked, as the
// plain version's torch.where is), the stack and the next state's
// gradient moved on. The tape's contract (ops/diff.py tape_read): the
// flags word of every bounce, the rest only of a hit, so a lane whose
// bounce has no hit loads nothing else and computes along on zeros (the
// entry state, texel 0, no light lit), whose results are masked away.
// h: the stack's height after the bounce, before it on return; the
// pushed or popped slot is counted from it. The tables'
// gradients go to add(base, stride, row, values, count) (value j to
// column base + j stride + row of the partials): the lights' and
// ambient's, and, unless `wide`, the surface row's (columns 10 nl + 3 +
// j ns + s) and the material row's (10 nl + 3 + 19 ns + j nm + m); wide,
// the row gradients and ids are written to g_s, g_m and ids.
template <int CAP, class Add>
__device__ __forceinline__ void back_bounce(
    Back<CAP>& bk, int& h, const Tabs& t, bool ug, bool uf,
    const float* __restrict__ tf, const int* __restrict__ ti, int words,
    float gar, float gag, float gab, bool wide, float* __restrict__ g_s,
    float* __restrict__ g_m, int* __restrict__ ids, int ii, bool in,
    bool any, int n, int k, int k_segs, Add& add) {
  const size_t kn = (size_t)k_segs * n;
  const size_t at = (size_t)k * n + ii;
  const int* tw = ti + (size_t)k * words * n + ii;
  const unsigned flags = (unsigned)tw[0];
  const bool hit = (flags & T_HIT) != 0u;
  const bool push = (flags & T_PUSH) != 0u;
  const bool pop = (flags & T_POP) != 0u;
  h -= (push ? 1 : 0) - (pop ? 1 : 0);
  const int slot = push ? h : (pop ? h - 1 : 0);
  if (slot < 0 || slot >= bk.cap()) __trap();
  float* cur = bk.slot(slot);
  float gsl[TAPE_F];
  for (int j = 0; j < TAPE_F; ++j) gsl[j] = push ? cur[j] : 0.0f;
  Grads o;
  int s = 0, m = 0;
  if (any) {
    float st[TAPE_F];
    const float* ts = tf + (size_t)k * TAPE_F * n + ii;
    for (int j = 0; j < TAPE_F; ++j) st[j] = hit ? ts[(size_t)j * n] : 0.0f;
    const int* lw = hit ? tw + 2 * (size_t)n : nullptr;
    Bnc v;
    recompute(v, t, ug, uf, st, flags, hit ? tw[n] : 0, lw, n);
    adjoint(v, t, flags, lw, n, gar, gag, gab, bk.gn, gsl, add, o);
    s = v.bs;
    m = v.m;
    if (!wide) {
      const int base = LROW * t.nl + 3;
      add(base, t.ns, s, o.s, SF);
      add(base + SF * t.ns, t.nm, m, o.m, MF);
    }
  } else {
    for (int j = 0; j < SF; ++j) o.s[j] = 0.0f;
    for (int j = 0; j < MF; ++j) o.m[j] = 0.0f;
    for (int j = 0; j < TAPE_F; ++j) o.st[j] = 0.0f;
  }
  if (wide && in) {
    for (int j = 0; j < SF; ++j) g_s[j * kn + at] = hit ? o.s[j] : 0.0f;
    for (int j = 0; j < MF; ++j) g_m[j * kn + at] = hit ? o.m[j] : 0.0f;
    ids[at] = hit ? s : 0;
    ids[kn + at] = hit ? m : 0;
  }
  for (int j = 0; j < TAPE_F; ++j) {
    const float c = cur[j];
    cur[j] = push ? 0.0f : (pop ? c + bk.gn[j] : c);
    bk.gn[j] = hit ? o.st[j] : (pop ? 0.0f : bk.gn[j]);
  }
}

// The sums over a warp's lanes of V values y[0..V) a lane (V a power of
// two, at most 32), each the xor butterfly's: x[p] + x[p ^ h] for h = 16,
// 8, 4, 2, 1, the same tree for every value as a butterfly of that value
// alone, so the same bits (replay.cu's tile sums, replay._tile_sums). A
// step of the first log2 V keeps half of a lane's values (the upper half
// where the lane has bit h) and trades the other half with lane p ^ h: V
// / 2 + V / 4 + ... + 1 shuffles in all, where a butterfly a value takes
// 5 V. Lane p returns the sum of value p * V / 32.
template <int V>
__device__ __forceinline__ float warp_sums(float (&y)[V], int lane) {
#pragma unroll
  for (int h = WARP / 2; h >= 1; h /= 2) {
    const int n = V * h / (WARP / 2);   // values a lane holds before it
    if (n >= 2) {
      const bool up = (lane & h) != 0;
#pragma unroll
      for (int j = 0; j < n / 2; ++j) {
        const float keep = up ? y[j + n / 2] : y[j];
        const float send = up ? y[j] : y[j + n / 2];
        y[j] = keep + __shfl_xor_sync(FULL, send, h);
      }
    } else {
      y[0] = y[0] + __shfl_xor_sync(FULL, y[0], h);
    }
  }
  return y[0];
}

// a[v * stride] += the warp's sum of x[v] over the lanes where `mine`
// (+0.0 elsewhere), v < count <= V, each added by the lane that holds it
template <int V>
__device__ __forceinline__ void warp_add(float* a, int stride,
                                         const float* x, int count,
                                         bool mine, int lane) {
  float y[V];
#pragma unroll
  for (int j = 0; j < V; ++j) y[j] = (j < count && mine) ? x[j] : 0.0f;
  const float s = warp_sums<V>(y, lane);
  const int v = lane * V / WARP;
  if (lane == v * (WARP / V) && v < count) a[v * stride] += s;
}

// acc: BWD_WARPS x nla floats of dynamic shared memory, nla = 10 nl + 3
// (+ 19 ns + 10 nm unless `wide`); a block's rays' tables' gradients: each
// bounce, for each row a live lane of the warp hit, the xor butterfly of
// each leaf masked by the lanes' row ids (warp_add: the leaves together,
// each sum added into the warp's accumulator by the lane that holds it;
// the lights and the ambient are one row that every live lane holds), at
// the end the warps in order into the block's partial.
// deep (CAP 0): d slot adjoints a thread, (gridDim.x * 128, d, 12) f32.
template <int CAP>
__global__ void __launch_bounds__(BWD_THREADS)
    diff_bwd_kernel(Tabs t, const float* __restrict__ use_gamma,
                    const float* __restrict__ use_fresnel,
                    const float* __restrict__ tf, const int* __restrict__ ti,
                    int words, const float* __restrict__ g_cols, int wide,
                    float* __restrict__ g_s, float* __restrict__ g_m,
                    int* __restrict__ ids, float* __restrict__ lpart, int n,
                    int k_segs, float* __restrict__ deep, int d) {
  extern __shared__ float lacc[];
  const int nla = LROW * t.nl + 3 + (wide ? 0 : SF * t.ns + MF * t.nm);
  for (int j = threadIdx.x; j < BWD_WARPS * nla; j += blockDim.x)
    lacc[j] = 0.0f;
  __syncthreads();
  const int i = blockIdx.x * BWD_THREADS + threadIdx.x;
  const bool in = i < n;
  const int ii = in ? i : n - 1;
  const int lane = threadIdx.x & (WARP - 1);
  float* acc = lacc + (threadIdx.x / WARP) * nla;
  const bool ug = __ldg(use_gamma) > 0.0f, uf = __ldg(use_fresnel) > 0.0f;
  const float gar = g_cols[(size_t)ii * 3 + 0];
  const float gag = g_cols[(size_t)ii * 3 + 1];
  const float gab = g_cols[(size_t)ii * 3 + 2];
  Back<CAP> bk;
  bk.init(CAP > 0 ? nullptr : deep + (size_t)i * d * TAPE_F, d);
  int h = stack_height(ti, words, n, ii, k_segs);
  for (int k = k_segs - 1; k >= 0; --k) {
    const unsigned flags = (unsigned)ti[(size_t)k * words * n + ii];
    const bool live = in && (flags & T_HIT) != 0u;
    const bool any = __any_sync(FULL, live);
    // every lane calls add (`any` is the warp's, so the warp is
    // converged): the rows in the order of their first live lane, the
    // leaves of each summed at once (warp_add; count is 3, 10 or 19)
    auto add = [&](int base, int stride, int row, const float* x,
                   int count) {
      unsigned todo = __ballot_sync(FULL, live);
      while (todo != 0u) {
        const int r = __shfl_sync(FULL, row, __ffs(todo) - 1);
        const bool mine = live && row == r;
        todo &= ~__ballot_sync(FULL, mine);
        float* a = acc + base + r;
        if (count <= 4)
          warp_add<4>(a, stride, x, count, mine, lane);
        else if (count <= 16)
          warp_add<16>(a, stride, x, count, mine, lane);
        else
          warp_add<32>(a, stride, x, count, mine, lane);
      }
    };
    back_bounce(bk, h, t, ug, uf, tf, ti, words, gar, gag, gab, wide != 0,
                g_s, g_m, ids, ii, in, any, n, k, k_segs, add);
  }
  __syncthreads();
  for (int f = threadIdx.x; f < nla; f += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < BWD_WARPS; ++u) s += lacc[u * nla + f];
    lpart[(size_t)blockIdx.x * nla + f] = s;
  }
}

// the accumulators' bytes past the default 48 KB
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

using BwdKernel = void (*)(Tabs, const float*, const float*, const float*,
                           const int*, int, const float*, int, float*,
                           float*, int*, float*, int, int, float*, int);

// the instantiation for d slots: the least of 4, 8 and 16 local slots
// that holds them, else the device-memory scratch
BwdKernel bwd_kernel(int d) {
  return d <= 4    ? diff_bwd_kernel<4>
         : d <= 8  ? diff_bwd_kernel<8>
         : d <= 16 ? diff_bwd_kernel<16>
                   : diff_bwd_kernel<0>;
}

}  // namespace

// The backward. Tables: stab (19, ns), mtab (10, nm), ltab (nl, 10), amb
// (3,), s_fwd (ns, 9), tex (nt, 3) f32; s_kind, s_sing (ns,), s_mat (ns,
// 2), m_props (nm,) i32; use_gamma, use_fresnel () f32. The tape: tf (k,
// 12, n) f32, ti (k, words, n) i32; g_cols (n, 3); stack and schlick the
// TraceConfig's. Out: lpart (ceil(n / 128), 10 nl + 3 + 19 ns + 10 nm),
// each block's partial of the lights', the ambient's, stab's and mtab's
// gradients in that order (replay_light_sums_launch adds them). With
// `wide`: lpart (ceil(n / 128), 10 nl + 3), and g_s (19, k n), g_m (10, k
// n) f32 and ids (2, k n) i32, each bounce's row gradients and row ids
// (+0.0 and 0 where it has no hit); otherwise those three are not read.
// deep: where d = min(stack, k) > 16, (ceil(n / 128) * 128, d, 12) f32 of
// scratch, otherwise not read. Returns the CUDA error of the launch.
extern "C" int diff_backward_launch(
    const float* stab, const float* mtab, const float* ltab, const float* amb,
    const float* s_fwd, const float* tex, const int* s_kind,
    const int* s_sing, const int* s_mat, const int* m_props,
    const float* use_gamma, const float* use_fresnel, const float* tf,
    const int* ti, const float* g_cols, float* g_s, float* g_m, int* ids,
    float* lpart, float* deep, int n, int k, int words, int ns, int nm,
    int nl, int nt, int stack, int schlick, int wide, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (ns <= 0 || nm <= 0 || nl < 0 || nt <= 0 || stack < 0 ||
      words < 2 + (nl + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const int d = stack < k ? stack : k;
  if ((d > 16 && deep == nullptr) ||
      (wide && (g_s == nullptr || g_m == nullptr || ids == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Tabs t{stab,  mtab, ltab, amb, s_kind, s_sing, s_mat, m_props,
               s_fwd, tex,  ns,   nm,  nl,     nt,     schlick};
  const int nla = LROW * nl + 3 + (wide ? 0 : SF * ns + MF * nm);
  const size_t bytes = sizeof(float) * BWD_WARPS * nla;
  const BwdKernel kern = bwd_kernel(d);
  cudaError_t err = allow_smem((const void*)kern, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<(n + BWD_THREADS - 1) / BWD_THREADS, BWD_THREADS, bytes,
         (cudaStream_t)stream>>>(t, use_gamma, use_fresnel, tf, ti, words,
                                 g_cols, wide, g_s, g_m, ids, lpart, n, k,
                                 deep, d);
  return (int)cudaGetLastError();
}

// The backward's blocks an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for a stack of
// min(stack, k) slots and `bytes` of accumulators, into *blocks. Returns
// the CUDA error.
extern "C" int diff_backward_occupancy(int stack, int k, int bytes,
                                       int* blocks) {
  const BwdKernel kern = bwd_kernel(stack < k ? stack : k);
  cudaError_t err = allow_smem((const void*)kern, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, BWD_THREADS, (size_t)bytes);
}
