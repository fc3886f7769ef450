"""The all-surface route in one forward and one backward launch
(``ops/diff.py``: ``csrc/whitted.cu`` ``tape_kernel`` and ``csrc/diff.cu``
``diff_backward_launch``), the training step of ``make_train_step``.

On the CPU, at 24x16 with ``TraceConfig(max_segments=8, stack=4)``, on
test15 (two-plane surfaces, two apex-singular cylinders, a texture, metal,
two lights; plus rays aimed at the cylinders' apexes), test17 and test18:
the plain forward's colors bitwise ``trace_rays``'s; the hand-written
adjoint's gradient of every differentiable field against autograd's over
``trace_rays_diff``; each branch of the adjoint taken at least once; the
JAX ``trace_rays_diff`` under ``jax.value_and_grad`` on test15; the
kernels' per-ray code (``tape_ray``, ``back_bounce`` and what they call)
built with g++ behind a shim, bitwise the plain versions in both of the
backward's modes (the table rows summed in its accumulators, or, wide,
written out), with Schlick Fresnel and with a stack past 16 slots
(DEEP_CFG on test18); the two row orders against each other and
autograd; the step's launches. The ``cuda`` cases run on the card with
    python -m pytest tests/test_torch_diff_fused.py --noconftest -q -m cuda
(JAX is imported only inside the test that uses it).
"""

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops import diff
from quadray_tpu_torch.ops import replay as rp
from quadray_tpu_torch.ops import trace
from quadray_tpu_torch.ops.rays import camera_rays
from quadray_tpu_torch.ops.trace import TraceConfig
from quadray_tpu_torch.parallel import train as ttrain
from quadray_tpu_torch.parallel.mesh import ray_mesh
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import FIELDS, compile_scene

torch.set_num_threads(1)

W, H = 24, 16
CFG = TraceConfig(max_segments=8, stack=4)
SCENES = ("test15", "test17", "test18")
CPU = torch.device("cpu")
BITS = lambda t: t.contiguous().view(torch.int32)
# the adjoint against autograd over trace_rays_diff, of each field's
# largest gradient: in float64 both are exact to rounding (measured
# 1e-13 apart); in float32 each route's own rounding differs: 1.7e-6 on
# test15, 1.5e-6 on test17 and, on test18, 3.8e-5 on s_sci, all of it one
# ray's (a reflection, then five off the inside of the glass sphere, each
# from the local origin of the one before), which each route puts 1e-3
# of its own term off the float64 gradient, on either side. The row sums
# are not the cause: the adjoint's are within 7e-8 of the exact sum of
# its terms. GRAD_RTOL is not met there in float32. With Schlick Fresnel
# test18's gap is 6.9e-5, autograd's own rounding of its sums over rays
# (test_schlick_gradients_match_autograd_f32): GRAD_RTOL_F32 is not met.
GRAD_RTOL = 1e-5
GRAD_RTOL_F32 = 5e-5
# a stack past the kernels' 16 local slots: with no throughput cutoff each
# hit on test18's glass both reflects and transmits, so its rays' stacks
# pass 16 slots (23 at 24x16; at the default cutoff they stop at 5)
DEEP_CFG = TraceConfig(depth=24, max_segments=48, stack=24, cutoff=0.0)
# tests/test_torch_diff_step.py's bounds against the JAX step: the loss,
# and the gradient as optax's first moment (0.1 x) is held there
LOSS_RTOL, MU_RTOL, MU_ATOL = 1e-4, 1e-4, 1e-8
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "quadray_tpu_torch", "csrc")
# a float NaN's bits, what the tests fill the words of a tape with that
# its contract does not read
NAN_BITS = int(np.float32(np.nan).view(np.int32))


def _compiled(name, device=CPU):
    sd = load_scene(name)
    return compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         device=device)


def _rays(sc, w=W, h=H, apex=False):
    """The camera rays (org (N, 3), dirs, t_min); with ``apex``, 16 more
    rays a singular surface aimed at its apex (its s_pos) from the camera,
    the first exactly and the others off by 1e-2 to 1e-6, t_min 0."""
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, w, h, 1)
    n = dirs.shape[0]
    org = org[None, :].expand(n, 3)
    t_min = sc.cam_pov.expand(n)
    if apex:
        rs = np.random.RandomState(5)
        extra = []
        for s in torch.nonzero(sc.s_sing > 0)[:, 0].tolist():
            for j in range(16):
                off = rs.uniform(-1.0, 1.0, 3) * (
                    0.0 if j == 0 else 10.0 ** -rs.randint(2, 7))
                extra.append(sc.s_pos[s] + torch.from_numpy(
                    off.astype(np.float32)) - sc.cam_pos)
        d2 = torch.stack(extra)
        org = torch.cat([org, sc.cam_pos.expand(d2.shape[0], 3)])
        dirs = torch.cat([dirs, d2])
        t_min = torch.cat([t_min, torch.zeros(d2.shape[0])])
    return org.contiguous(), dirs.contiguous(), t_min.contiguous()


_CASES = {}


def _case(name):
    """(scene, rays, forward_plain's colors, tf, ti), float32. On test15
    its first light moves beside the camera, which lights the apexes the
    extra rays hit, so that their colors depend on the nudged point."""
    if name not in _CASES:
        sc = _compiled(name)
        if name == "test15":
            lp = sc.l_pos.clone()
            lp[0] = sc.cam_pos + torch.tensor([0.5, 0.0, 1.0])
            sc = dataclasses.replace(sc, l_pos=lp)
        rays = _rays(sc, apex=name == "test15")
        _CASES[name] = (sc, rays) + diff.forward_plain(sc, *rays, CFG)
    return _CASES[name]


@pytest.mark.parametrize("name", SCENES)
def test_forward_bitwise_trace_rays(name):
    """The plain forward's colors are trace_rays's bit for bit; its tape
    holds zeros after each ray retired."""
    sc, rays, cols, tf, ti = _case(name)
    assert torch.equal(BITS(cols), BITS(trace.trace_rays(sc, *rays, CFG)))
    dead = (ti[:, 0] & diff.ACTIVE) == 0
    assert bool(dead.any())
    assert bool((ti.permute(1, 0, 2)[:, dead] == 0).all())
    assert bool((tf.permute(1, 0, 2)[:, dead] == 0).all())


def _grads(fn, sc, rays, el):
    leaves = {k: getattr(sc, k).clone().requires_grad_(True)
              for k in ttrain.DIFFERENTIABLE_FIELDS}
    s2 = dataclasses.replace(sc, **leaves)
    g = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (rays[1].shape[0], 3))).to(el).to(rays[1].device)
    cols = fn(s2, *rays, CFG)
    (cols * g).sum().backward()
    return cols.detach(), {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("el", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", SCENES)
def test_gradients_match_autograd(name, el):
    """sum(g * colors)'s gradient of every differentiable field, the
    plain adjoint against autograd over trace_rays_diff, within GRAD_RTOL
    (float64) or GRAD_RTOL_F32 of that field's largest; the colors bit
    for bit; no NaN. In float32 the camera rays only: test15's rays
    jittered off the apexes graze the two planes, their gradients reach
    1e6 (s_scjh) and each route's f32 rounding differs by percents
    there; in float64 every ray, the nudged ones lit."""
    sc, rays = _case(name)[:2]
    if el == torch.float32:
        rays = tuple(r[:W * H] for r in rays)
    trace.set_element(el)
    try:
        sc = trace.scene_astype(sc, el)
        rays = tuple(r.to(el) for r in rays)
        want_c, want = _grads(trace.trace_rays_diff, sc, rays, el)
        got_c, got = _grads(diff.trace_rays_fused, sc, rays, el)
    finally:
        trace.set_element(torch.float32)
    assert torch.equal(got_c, want_c)
    rtol = GRAD_RTOL if el == torch.float64 else GRAD_RTOL_F32
    for k in ttrain.DIFFERENTIABLE_FIELDS:
        assert not bool(torch.isnan(got[k]).any()), k
        err = (got[k] - want[k]).abs().max()
        assert err <= rtol * want[k].abs().max(), (k, float(err))


def test_schlick_gradients_match_autograd_f32():
    """test_gradients_match_autograd's float32 case with Schlick Fresnel
    on test17 (test15 has no Fresnel): the colors bit for bit, every
    field's gradient within GRAD_RTOL_F32 of autograd's. Not on test18,
    where s_sci's gap is 6.9e-5 of its largest (scripts/grad_gap.py
    --schlick): there the fused route is 1.5e-6 from the float64
    gradient and autograd's 9.0e-6, and autograd's own per-ray terms (its
    g one ray at a time) add up to 8.1e-6 less than its whole gradient,
    so the gap is autograd's float32 rounding of its sums over rays; in
    float64 the two are 6e-14 apart (test_plain_route_takes_what_the_
    kernels_lack holds them to GRAD_RTOL)."""
    sc, rays = _case("test17")[:2]
    cfg = CFG._replace(schlick=True)
    want_c, want = _grads(lambda *a: trace.trace_rays_diff(*a[:-1], cfg),
                          sc, rays, torch.float32)
    got_c, got = _grads(lambda *a: diff.trace_rays_fused(*a[:-1], cfg),
                        sc, rays, torch.float32)
    assert torch.equal(got_c, want_c)
    assert not torch.equal(got_c, trace.trace_rays(sc, *rays, CFG))
    for k in ttrain.DIFFERENTIABLE_FIELDS:
        assert not bool(torch.isnan(got[k]).any()), k
        err = (got[k] - want[k]).abs().max()
        assert err <= GRAD_RTOL_F32 * want[k].abs().max(), (k, float(err))


def _stack_tops(ti):
    """Each bounce's stack height after it, from the tape's push/pop."""
    fl = ti[:, 0]
    step = ((fl & diff.PUSH) != 0).to(torch.int32) - (
        (fl & diff.POP) != 0).to(torch.int32)
    return torch.cumsum(step, dim=0)


def test_every_branch_is_taken():
    """On these inputs the tapes hold, at least once each: the apex
    nudge, a two-plane (kind 3) hit, total internal reflection, a push,
    a pop, a full stack (cfg.stack branches pending), a hit on the origin
    surface (its local origin reused) and a textured hit."""
    seen = dict(nudge=0, kind3=0, tir=0, push=0, pop=0, full=0, own=0,
                texture=0)
    for name in SCENES:
        sc, _, _, tf, ti = _case(name)
        fl = ti[:, 0]
        hit = (fl & diff.HIT) != 0
        seen["nudge"] += int(((fl & diff.NUDGE) != 0).sum())
        seen["push"] += int(((fl & diff.PUSH) != 0).sum())
        seen["pop"] += int(((fl & diff.POP) != 0).sum())
        seen["own"] += int(((fl & diff.OWN) != 0).sum())
        seen["texture"] += int((hit & (ti[:, 1] >= 0)).sum())
        seen["kind3"] += int((hit & (sc.s_kind[(fl & diff.SRF_BITS).long()]
                                     == 3)).sum())
        seen["full"] += int((_stack_tops(ti) == CFG.stack).sum())
        T = diff.tables(sc)
        for k in range(CFG.max_segments):
            v = diff._recompute(T, tf[k], ti[k])
            seen["tir"] += int((v.tir & hit[k]).sum())
    assert all(n > 0 for n in seen.values()), seen


def test_matches_jax_value_and_grad():
    """One jax.value_and_grad of the JAX trace_rays_diff on test15 (the
    step's weighted squared error against the clean render, the surfaces
    moved by +0.05) against the port's route on the same arrays: the loss
    and every field's gradient within tests/test_torch_diff_step.py's
    bounds."""
    import jax
    import jax.numpy as jnp
    from quadray_tpu.models.scenes.loader import load_scene as jload
    from quadray_tpu.ops.rays import camera_rays as jrays
    from quadray_tpu.ops.trace import TraceConfig as JConfig
    from quadray_tpu.ops.trace import trace_rays_diff as jdiff
    from quadray_tpu.scene import schema as JS
    from quadray_tpu.scene.compile import compile_scene as jcompile
    from quadray_tpu_torch.scene.compile import scene_arrays_from_numpy
    sd = jload("test15")
    j = jcompile(JS.SceneDef(root=sd.root, opts=JS.OPTS_FULL & ~sd.opts))
    sc = scene_arrays_from_numpy({k: np.asarray(getattr(j, k))
                                  for k in FIELDS}, device="cpu")
    target = trace.clip(trace.render(sc, W, H, 1, CFG), 0.0, 1.0).reshape(
        -1, 3)
    j = j.replace(s_pos=j.s_pos + 0.05)
    sc = dataclasses.replace(sc, s_pos=sc.s_pos + 0.05)
    org1, jdirs = jrays(j.cam_pos, j.cam_hor, j.cam_ver, j.cam_nrm,
                        j.cam_pov, W, H, 1)
    n = jdirs.shape[0]
    jorg = jnp.broadcast_to(org1[None, :], (n, 3))
    jtmin = jnp.full((n,), j.cam_pov, jnp.float32)
    tgt = jnp.asarray(target.numpy())
    fields = ttrain.DIFFERENTIABLE_FIELDS

    def jloss(params):
        cols = jdiff(j.replace(**params), jorg, jdirs, jtmin,
                     JConfig(max_segments=8, stack=4))
        return jnp.sum((jnp.clip(cols, 0.0, 1.0) - tgt) ** 2) / (n * 3.0)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        {k: getattr(j, k) for k in fields})
    leaves = {k: getattr(sc, k).clone().requires_grad_(True)
              for k in fields}
    cols = diff.trace_rays_fused(dataclasses.replace(sc, **leaves),
                                 *_rays(sc), CFG)
    loss = ttrain._weighted_mse(cols, target, torch.ones(n))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    for k in fields:
        np.testing.assert_allclose(0.1 * leaves[k].grad.numpy(),
                                   0.1 * np.asarray(jg[k]), rtol=MU_RTOL,
                                   atol=MU_ATOL, err_msg=k)


# ---- the kernels' per-ray code on the CPU ------------------------------------

SHIM = r"""
#include <math.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __restrict__
#define __global__
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline void __trap() { abort(); }
// the plain versions' correctly rounded sqrt and rsqrt (ops/trace.py)
static inline float __fsqrt_rn(float x) { return sqrtf(x); }
static inline float __frsqrt_rn(float x) {
  return (float)(1.0 / sqrt((double)x));
}
static inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
static inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
static inline int __float2int_rz(float x) { return (int)x; }
// exp and log are PyTorch's, as the card's expf/logf are PyTorch's there
typedef float (*f2f)(float);
static f2f exp_cb, log_cb;
extern "C" void set_math(f2f e, f2f l) { exp_cb = e; log_cb = l; }
static inline float shim_expf(float x) { return exp_cb(x); }
static inline float shim_logf(float x) { return log_cb(x); }
#define expf shim_expf
#define logf shim_logf
// the warp's collectives, which the culled walks use and the code built
// here never reaches
template <class T> static inline T __shfl_sync(unsigned, T v, int, int = 32) { return v; }
template <class T> static inline T __shfl_xor_sync(unsigned, T v, int, int = 32) { return v; }
template <class T> static inline T __shfl_up_sync(unsigned, T v, int, int = 32) { return v; }
static inline unsigned __ballot_sync(unsigned, int p) { return p ? 1u : 0u; }
static inline bool __any_sync(unsigned, int p) { return p; }
static inline unsigned __reduce_or_sync(unsigned, unsigned v) { return v; }
static inline unsigned __reduce_add_sync(unsigned, unsigned v) { return v; }
static inline int __popc(unsigned v) { return __builtin_popcount(v); }
static inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
static inline void __syncwarp(unsigned = 0xffffffffu) {}
template <class T> static inline T atomicAdd(T* p, T v) { T o = *p; *p += v; return o; }
template <class T> static inline T atomicMax(T* p, T v) { T o = *p; if (v > o) *p = v; return o; }
struct Dim3 { unsigned x, y, z; };
static Dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
"""
# tape_kernel's grid, one thread after another
FWD_HOST_LOOP = r"""
extern "C" void tape_host(const float* rays, float* out, float* tf, int* ti,
    const float* sp_f, const int* sp_i, const float* cl_f, const float* mat_f,
    const int* mat_i, const float* lg_f, const float* misc, const int* tex_pk,
    const float* tex_lut, const float* bsph, const int* shad, const int* cont,
    int rows, int n, int ns, int nc, int nl, int words, int depth,
    int max_segments, int stack, float cutoff, int schlick, float* deep) {
  const Tables T{sp_f, sp_i, cl_f, mat_f, mat_i, lg_f, misc, tex_pk, tex_lut,
                 bsph, shad, cont, ns, nc, nl, (rows + 31) / 32,
                 (rows + 127) / 128 * 128};
  const Cfg cfg{depth, max_segments, stack, cutoff, 0, 0, 0, schlick};
  const int d = stack < max_segments ? stack : max_segments;
  for (int i = 0; i < n; ++i) {
    if (d <= 4) tape_ray<4>(rays, out, tf, ti, n, words, T, cfg, i);
    else if (d <= 8) tape_ray<8>(rays, out, tf, ti, n, words, T, cfg, i);
    else if (d <= 16) tape_ray<16>(rays, out, tf, ti, n, words, T, cfg, i);
    else tape_ray<0>(rays, out, tf, ti, n, words, T, cfg, i, deep, d);
  }
}
"""
# diff_bwd_kernel's loop, one ray alone (its warp: itself, or, all_any,
# a warp in which another lane hits at every bounce, so that a bounce
# without a hit computes along and is masked); each bounce's values given
# to the kernel's add by a lane with a hit kept at their columns, (k, n,
# columns): the ray's leaves, +0.0 in the columns of the rows it did not
# hit
BWD_HOST_LOOP = r"""
struct RayAdd {
  float* acc;
  bool live;
  void operator()(int base, int stride, int row, const float* x, int count) {
    if (!live) return;
    for (int j = 0; j < count; ++j) acc[base + j * stride + row] = x[j];
  }
};
template <int CAP>
static void bwd_rays(const Tabs& t, int ug, int uf, const float* tf,
    const int* ti, const float* g_cols, int wide, float* g_s, float* g_m,
    int* ids, float* lray, int cols, float* deep, int d, int n, int k,
    int words, int all_any) {
  for (int i = 0; i < n; ++i) {
    Back<CAP> bk;
    bk.init(deep, d);
    int h = stack_height(ti, words, n, i, k);
    for (int kk = k - 1; kk >= 0; --kk) {
      const bool hit = (ti[(size_t)kk * words * n + i] & (1 << 16)) != 0;
      RayAdd add{lray + ((size_t)kk * n + i) * cols, hit};
      back_bounce(bk, h, t, ug, uf, tf, ti, words, g_cols[3 * i],
                  g_cols[3 * i + 1], g_cols[3 * i + 2], wide != 0, g_s, g_m,
                  ids, i, true, hit || all_any != 0, n, kk, k, add);
    }
  }
}
extern "C" void bwd_host(const float* stab, const float* mtab,
    const float* ltab, const float* amb, const float* s_fwd, const float* tex,
    const int* s_kind, const int* s_sing, const int* s_mat, const int* m_props,
    int ug, int uf, const float* tf, const int* ti, const float* g_cols,
    float* g_s, float* g_m, int* ids, float* lray, float* deep, int n, int k,
    int words, int ns, int nm, int nl, int nt, int stack, int schlick,
    int wide, int all_any) {
  const Tabs t{stab, mtab, ltab, amb, s_kind, s_sing, s_mat, m_props, s_fwd,
               tex, ns, nm, nl, nt, schlick};
  const int d = stack < k ? stack : k;
  const int cols = 10 * nl + 3 + (wide ? 0 : 19 * ns + 10 * nm);
  if (d <= 4)
    bwd_rays<4>(t, ug, uf, tf, ti, g_cols, wide, g_s, g_m, ids, lray, cols,
                deep, d, n, k, words, all_any);
  else if (d <= 8)
    bwd_rays<8>(t, ug, uf, tf, ti, g_cols, wide, g_s, g_m, ids, lray, cols,
                deep, d, n, k, words, all_any);
  else if (d <= 16)
    bwd_rays<16>(t, ug, uf, tf, ti, g_cols, wide, g_s, g_m, ids, lray, cols,
                 deep, d, n, k, words, all_any);
  else
    bwd_rays<0>(t, ug, uf, tf, ti, g_cols, wide, g_s, g_m, ids, lray, cols,
                deep, d, n, k, words, all_any);
}
"""
F2F = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)
_EXP = F2F(lambda x: torch.exp(torch.tensor([x], dtype=torch.float32)).item())
_LOG = F2F(lambda x: torch.log(torch.tensor([x], dtype=torch.float32)).item())


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """csrc/whitted.cu's device code up to its first __global__ (with
    common.cuh; tape_ray and segment<> in TAPE mode) and csrc/diff.cu's
    up to its first warp collective (back_bounce and what it calls), each
    built with g++ behind a shim, -ffp-contract=off as nvcc's
    --fmad=false."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernels' per-ray code on the CPU"
    common = open(os.path.join(CSRC, "common.cuh")).read().replace(
        "#pragma once", "").replace("#include <cuda_runtime.h>", "")
    w = open(os.path.join(CSRC, "whitted.cu")).read()
    w = w[w.index("namespace {"):w.index(
        "// The two rounds of two-round retirement")]
    d = open(os.path.join(CSRC, "diff.cu")).read()
    d = d[d.index("namespace {"):d.index(
        "// The sums over a warp's lanes")]
    out = tmp_path_factory.mktemp("diff")
    libs = []
    for name, body in (("w", common + w + "}\n" + FWD_HOST_LOOP),
                       ("d", d + "}\n" + BWD_HOST_LOOP)):
        (out / f"{name}.cpp").write_text(SHIM + body)
        subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-w",
                        "-shared", "-fPIC", "-o", str(out / f"{name}.so"),
                        str(out / f"{name}.cpp")], check=True)
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.set_math(_EXP, _LOG)
        libs.append(lib)
    return libs


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _poisoned(tf, ti):
    """(tf, ti) with every word the tape's contract does not read
    (``diff.tape_read``) NaN (its bits in ti) and the unread texels
    2**30."""
    mf, mi = diff.tape_read(ti)
    ti2 = torch.where(mi, ti, NAN_BITS)
    ti2[:, 1] = torch.where(mi[:, 1], ti[:, 1], 2 ** 30)
    return torch.where(mf, tf, float("nan")), ti2


def _tape_host(rehearsal, sc, rays, cfg, like_tf, like_ti):
    """tape_ray on every ray (tape_kernel's grid, one thread after
    another) on the scene packed unculled as the step packs it, into a
    tape filled with NaN's bits: (colors (3, n), tf, ti)."""
    wl = rehearsal[0]
    org, dirs, t_min = rays
    n, words = dirs.shape[0], like_ti.shape[1]
    struct = ck.scene_struct(sc)
    ps = ck.pack_scene(sc, struct, cull=False)   # alive while tabs point in
    tabs = ck._scene_tables(sc, struct, ps, CPU)
    rays_soa = torch.cat([org.T, dirs.T, t_min[None]]).contiguous()
    out = torch.empty((3, n))
    tf2 = torch.full_like(like_tf, float("nan"))
    ti2 = torch.full_like(like_ti, NAN_BITS)
    d = diff.stack_slots_held(cfg)
    deep = torch.zeros((n, max(d, 1), diff.SLOT_FLOATS))
    wl.tape_host(_p(rays_soa), _p(out), _p(tf2), _p(ti2),
                 *(ctypes.c_void_p(p) for p in tabs[:12]), tabs[12], n,
                 struct.n_real, struct.nc, struct.nl, words, cfg.depth,
                 cfg.max_segments, cfg.stack, ctypes.c_float(cfg.cutoff),
                 int(cfg.schlick), _p(deep))
    return out, tf2, ti2


def _bwd_host(rehearsal, sc, cfg, tf, ti, g, wide, all_any=False):
    """back_bounce's bounces in reverse on the tape (tf, ti): (g_s, g_m,
    ids, tiles) as backward_rows_plain returns them, each bounce's values
    given to the kernel's add summed per tile in the kernel's order;
    all_any: every bounce run as in a warp where another lane hits."""
    dl = rehearsal[1]
    T = diff.tables(sc)
    k, words, n = ti.shape
    cols = diff.LIGHT_ROWS * T.ltab.shape[0] + 3 + (
        0 if wide else diff.table_columns(T) - diff.LIGHT_ROWS
        * T.ltab.shape[0] - 3)
    lray = torch.zeros((k, n, cols))
    if wide:
        gs2 = torch.empty((diff.SURFACE_ROWS, k * n))
        gm2 = torch.empty((diff.MATERIAL_ROWS, k * n))
        ids2 = torch.empty((2, k * n), dtype=torch.int32)
    else:
        gs2 = gm2 = ids2 = torch.empty(0)
    deep = torch.zeros((max(diff.stack_slots_held(cfg), 1), diff.TAPE_ROWS))
    dl.bwd_host(*map(_p, (T.stab, T.mtab, T.ltab, T.amb,
                          T.s_fwd.contiguous(), T.tex, T.s_kind,
                          T.s_sing, T.s_mat, T.m_props)),
                int(T.use_gamma > 0), int(T.use_fresnel > 0), _p(tf),
                _p(ti), _p(g), _p(gs2), _p(gm2), _p(ids2), _p(lray),
                _p(deep), n, k, words, T.stab.shape[1], T.mtab.shape[1],
                T.ltab.shape[0], T.tex.shape[0], cfg.stack,
                int(cfg.schlick), int(wide), int(all_any))
    tiles = torch.zeros((cols, -(-n // rp.WARP)))
    for kk in reversed(range(k)):
        tiles = tiles + rp._tile_sums(lray[kk].T)
    return (gs2, gm2, ids2, tiles) if wide else (None, None, None, tiles)


def _rehearse(rehearsal, sc, rays, cfg, cols, tf, ti):
    """tape_ray on every ray against forward_plain's cols, tf and ti, on
    the scene packed unculled as the step packs it: the colors bit for
    bit, the tape's words that its contract reads (``diff.tape_read``)
    too, and no other word written; back_bounce's bounces in reverse
    against backward_rows_plain in both modes: its tiles, each bounce's
    values given to the kernel's add summed per tile in the kernel's
    order (the table rows' too, or, wide, its g_s, g_m and ids written):
    all bit for bit."""
    out, tf2, ti2 = _tape_host(rehearsal, sc, rays, cfg, tf, ti)
    assert torch.equal(BITS(out.T), BITS(cols))
    assert diff.tape_differs(tf, ti, tf2, ti2) == 0
    mf, mi = diff.tape_read(ti)
    assert bool(torch.isnan(tf2[~mf]).all())
    assert bool((ti2[~mi] == NAN_BITS).all())

    g = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (tf.shape[2], 3)).astype(np.float32))
    for wide in (False, True):
        want = diff.backward_rows_plain(g, diff.tables(sc), tf, ti, cfg.stack,
                                        cfg.schlick, wide)
        got = _bwd_host(rehearsal, sc, cfg, tf, ti, g, wide)
        for x, y in zip(got, want):
            if y is not None:
                assert torch.equal(BITS(x), BITS(y)), wide


@pytest.mark.parametrize("name", SCENES)
def test_kernel_code_bitwise_plain(rehearsal, name):
    """The kernels' per-ray code against the plain versions (``_rehearse``)
    on the three scenes at cfg (8, 4)."""
    sc, rays, cols, tf, ti = _case(name)
    _rehearse(rehearsal, sc, rays, CFG, cols, tf, ti)


@pytest.mark.parametrize("what, name", [("schlick", "test17"),
                                        ("schlick", "test18"),
                                        ("deep_stack", "test18")])
def test_kernel_code_schlick_and_deep_stack_bitwise_plain(rehearsal, what,
                                                          name):
    """``_rehearse`` with Schlick Fresnel at cfg (8, 4) (its colors not
    the exact Fresnel's) and with DEEP_CFG, whose stacks pass 16 slots
    (the kernels' device-memory scratch; the tape's 4-bit slot field is
    stack_slots modulo 16)."""
    sc, rays = _case(name)[:2]
    cfg = CFG._replace(schlick=True) if what == "schlick" else DEEP_CFG
    cols, tf, ti = diff.forward_plain(sc, *rays, cfg)
    if what == "schlick":
        assert not torch.equal(cols, _case(name)[2])
    else:
        assert int(_stack_tops(ti).max()) > diff.LOCAL_SLOTS
        fl = ti[:, 0]
        moved = (fl & (diff.PUSH | diff.POP)) != 0
        field = (fl >> diff.SLOT_SHIFT) & diff.SLOT_MASK
        assert torch.equal(diff.stack_slots(ti)[moved] % 16,
                           field[moved].long())
    _rehearse(rehearsal, sc, rays, cfg, cols, tf, ti)


@pytest.mark.parametrize("el", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", SCENES)
def test_row_orders_agree(name, el, monkeypatch):
    """The route's two plain modes: the table rows summed per tile, then
    in replay's block order (the default; test_gradients_match_autograd
    holds it to autograd), and, wide (forced), summed over all K x N
    entries in row_sum_plain's order: every field's gradient within
    GRAD_RTOL (float64) or GRAD_RTOL_F32 of that field's largest of the
    other and of autograd's over trace_rays_diff, the colors and the
    lights' fields bitwise. The camera rays only, as
    test_gradients_match_autograd."""
    sc, rays = _case(name)[:2]
    rays = tuple(r[:W * H] for r in rays)
    rtol = GRAD_RTOL if el == torch.float64 else GRAD_RTOL_F32
    trace.set_element(el)
    try:
        sc = trace.scene_astype(sc, el)
        rays = tuple(r.to(el) for r in rays)
        _, want = _grads(trace.trace_rays_diff, sc, rays, el)
        assert not diff.rows_wide(diff.tables(sc))
        cols, tiled = _grads(diff.trace_rays_fused, sc, rays, el)
        monkeypatch.setattr(diff, "rows_wide", lambda T, smem=0: True)
        cols2, wide = _grads(diff.trace_rays_fused, sc, rays, el)
    finally:
        trace.set_element(torch.float32)
    assert torch.equal(cols, cols2)
    for k in ttrain.DIFFERENTIABLE_FIELDS:
        if k.startswith("l_") or k == "amb_col":
            assert torch.equal(tiled[k], wide[k]), k
        for x, y in ((tiled[k], wide[k]), (wide[k], want[k])):
            err = (x - y).abs().max()
            assert err <= rtol * y.abs().max(), (k, float(err))


def _warp_sums(x, v: int):
    """csrc/diff.cu warp_sums<V> on a warp's 32 lanes, transliterated:
    x (32, V) float32, each lane's values; returns the (32,) sums the
    lanes return (lane p: value p * V / 32)."""
    y = [list(row) for row in x]
    h = 16
    while h >= 1:
        n = v * h // 16
        if n >= 2:
            new = []
            for p in range(32):
                up = (p & h) != 0
                mine, peer = y[p], y[p ^ h]
                row = list(mine)
                for j in range(n // 2):
                    keep = mine[j + n // 2] if up else mine[j]
                    send = peer[j] if (p ^ h) & h else peer[j + n // 2]
                    row[j] = np.float32(keep + send)
                new.append(row)
            y = new
        else:
            y = [[np.float32(y[p][0] + y[p ^ h][0])] + y[p][1:]
                 for p in range(32)]
        h //= 2
    return np.array([y[p][0] for p in range(32)], dtype=np.float32)


@pytest.mark.parametrize("v", [4, 16, 32])
def test_warp_sums_are_the_butterflys_bits(v):
    """The backward's warp_sums<V> (all of a row's leaves summed at once)
    gives each value the xor butterfly's tree, so the bits of
    replay._tile_sums of that value alone, on seeded values with signed
    zeros, ties and a wide range; lane p returns value p * V / 32."""
    rs = np.random.RandomState(v)
    x = (rs.standard_normal((32, v)) * 10.0 ** rs.randint(-8, 8, (32, v))
         ).astype(np.float32)
    x[rs.rand(32, v) < 0.2] = 0.0
    x[rs.rand(32, v) < 0.1] = -0.0
    x[:, 0] = -x[::-1, 0]
    got = _warp_sums(x, v)
    want = rp._tile_sums(torch.from_numpy(x.T.copy()))[:, 0]
    for p in range(32):
        assert got[p].view(np.int32) == want[p * v // 32].numpy().view(
            np.int32), p


def test_argtypes_match_the_c_entry_points():
    """diff.ARGTYPES lists csrc/diff.cu's extern "C" functions, pointers
    as c_void_p and ints as c_int, in its order (whitted_tape_launch is
    held to cuda_kernel.ARGTYPES with the rest of csrc/whitted.cu by
    tests/test_torch_paths_kernel.py)."""
    src = open(os.path.join(CSRC, "diff.cu")).read()
    found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert {name for name, _ in found} == set(diff.ARGTYPES)
    for name, params in found:
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in params.split(",")]
        assert diff.ARGTYPES[name] == want, name
    assert "whitted_tape_launch" in ck.ARGTYPES


def test_route_refusals():
    """The route raises, before any work: rays or s_fwd that require grad
    (not differentiated), a device other than the CPU and a card, and the
    float64 element type off the CPU."""
    sc, rays = _case("test17")[:2]
    org, dirs, t_min = rays
    with pytest.raises(ValueError, match="require grad"):
        diff.trace_rays_fused(sc, org.clone().requires_grad_(True), dirs,
                              t_min, CFG)
    with pytest.raises(ValueError, match="require grad"):
        diff.trace_rays_fused(dataclasses.replace(
            sc, s_fwd=sc.s_fwd.clone().requires_grad_(True)), *rays, CFG)
    meta = tuple(r.to("meta") for r in rays)
    with pytest.raises(ValueError, match="unsupported device"):
        diff.trace_rays_fused(sc, *meta, CFG)
    trace.set_element(torch.float64)
    try:
        with pytest.raises(ValueError, match="float64"):
            diff.trace_rays_fused(sc, *(r.to("meta") for r in rays), CFG)
    finally:
        trace.set_element(torch.float32)


@pytest.mark.parametrize("name", ("test17", "test18"))
@pytest.mark.parametrize("what", ("schlick", "deep_stack"))
def test_plain_route_takes_what_the_kernels_lack(name, what):
    """The plain versions take Schlick Fresnel and a stack of 20 (as the
    kernels now do too: test_kernel_code_schlick_and_deep_stack_bitwise_
    plain, test_card_takes_schlick_and_deep_stacks): in float64 the colors
    bitwise trace_rays_diff's and every field's gradient within GRAD_RTOL
    of autograd's (Schlick's colors differ from the exact Fresnel's, so
    its branch is taken)."""
    sc, rays = _case(name)[:2]
    cfg = (CFG._replace(schlick=True) if what == "schlick"
           else CFG._replace(stack=20))
    trace.set_element(torch.float64)
    try:
        sc = trace.scene_astype(sc, torch.float64)
        rays = tuple(r.to(torch.float64) for r in rays)
        fused = lambda *a: diff.trace_rays_fused(*a[:-1], cfg)
        plain = lambda *a: trace.trace_rays_diff(*a[:-1], cfg)
        want_c, want = _grads(plain, sc, rays, torch.float64)
        got_c, got = _grads(fused, sc, rays, torch.float64)
        if what == "schlick":
            assert not torch.equal(got_c, trace.trace_rays(sc, *rays, CFG))
    finally:
        trace.set_element(torch.float32)
    assert torch.equal(got_c, want_c)
    for k in ttrain.DIFFERENTIABLE_FIELDS:
        err = (got[k] - want[k]).abs().max()
        assert err <= GRAD_RTOL * want[k].abs().max(), (k, float(err))


def test_stack_slots_count_the_tape():
    """stack_slots, the plain backward's slots, is the tape's 4-bit slot
    field wherever a bounce pushes or pops, on the three scenes; on a
    tape of 20 pushes then 20 pops, slots 0..19 then 19..0 (past the
    field's 16)."""
    seen = 0
    for name in SCENES:
        ti = _case(name)[4]
        fl = ti[:, 0]
        moved = (fl & (diff.PUSH | diff.POP)) != 0
        seen += int(moved.sum())
        field = (fl >> diff.SLOT_SHIFT) & diff.SLOT_MASK
        assert torch.equal(diff.stack_slots(ti)[moved], field[moved].long())
    assert seen > 0
    flags = torch.tensor([diff.PUSH] * 20 + [diff.POP] * 20, dtype=torch.int32)
    ti = flags[:, None, None].expand(40, 3, 1).contiguous()
    assert diff.stack_slots(ti)[:, 0].tolist() == list(range(20)) + list(
        range(19, -1, -1))


def test_step_runs_the_fused_route(monkeypatch):
    """make_train_step on 1 and 2 CPU blocks: each block's loss runs the
    plain forward once and its gradient the plain backward once (the
    kernels' places on the card); trace_rays_diff's row gathers
    (Gathered) never run."""
    calls = {"forward": 0, "backward": 0}
    real_f, real_b = diff.forward_plain, diff.backward_plain

    def fwd(*a):
        calls["forward"] += 1
        return real_f(*a)

    def bwd(*a):
        calls["backward"] += 1
        return real_b(*a)

    def refuse(*a, **kw):
        raise AssertionError("trace_rays_diff's gathers ran in the step")

    monkeypatch.setattr(diff, "forward_plain", fwd)
    monkeypatch.setattr(diff, "backward_plain", bwd)
    monkeypatch.setattr(trace.Gathered, "__init__", refuse)
    sc = _compiled("test17")
    target = torch.zeros((W * H, 3))
    for blocks in (1, 2):
        calls.update(forward=0, backward=0)
        step_fn, opt_init = ttrain.make_train_step(
            W, H, cfg=CFG, mesh=ray_mesh([CPU] * blocks))
        params = ttrain.extract_params(sc)
        step_fn.run(params, opt_init(params), sc, target, 2)
        assert calls == {"forward": 2 * blocks, "backward": 2 * blocks}


# ---- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _card_case(name, dev, cfg, w=800, h=480):
    """(scene, rays, forward_plain's outputs, Tables, a seeded g_cols) on
    the card."""
    sc = _compiled(name, dev)
    rays = _rays(sc, w, h)
    T = diff.tables(sc)
    g = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (rays[1].shape[0], 3)).astype(np.float32)).to(dev)
    return (sc, rays) + diff.forward_plain(sc, *rays, cfg) + (T, g)


def _card_bitwise(sc, rays, cfg, cols, tf, ti, T, g, wide):
    """Two launches of the tape forward and of the backward (``wide``: its
    second mode) and light sums, bitwise forward_plain's (the tape's words
    that its contract reads, ``diff.tape_read``) and backward_rows_plain's
    (its tiles through replay._block_sums)."""
    struct = ck.scene_struct(sc)
    g_s, g_m, ids, tiles = diff.backward_rows_plain(
        g, T, tf, ti, cfg.stack, cfg.schlick, wide)
    for _ in range(2):
        c2, tf2, ti2 = diff.forward_kernel(sc, struct, *rays, cfg)
        gs2, gm2, ids2, lpart = diff.backward_rows_kernel(g, T, tf, ti, cfg,
                                                          wide)
        la = diff.light_sums_kernel(lpart)
        torch.cuda.synchronize()
        assert torch.equal(BITS(c2), BITS(cols))
        assert diff.tape_differs(tf, ti, tf2, ti2) == 0
        if wide:
            assert torch.equal(BITS(gs2), BITS(g_s))
            assert torch.equal(BITS(gm2), BITS(g_m))
            assert torch.equal(ids2, ids)
        else:
            assert gs2 is None and gm2 is None and ids2 is None
        assert torch.equal(BITS(la), BITS(rp._block_sums(tiles)))
    return c2


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_kernels_bitwise_plain_on_card(name):
    """800x480 on the card: the tape launch's colors bitwise the Whitted
    kernel's and forward_plain's, its tape bitwise forward_plain's; the
    backward launch's partials, the table rows' among them, through the
    light sums bitwise replay._block_sums of backward_rows_plain's tiles
    (and in the wide mode its row gradients and ids); two launches bitwise
    each other."""
    dev = _card()
    sc, rays, cols, tf, ti, T, g = _card_case(name, dev, CFG)
    want = ck.trace_rays_cuda(sc, *rays, CFG._replace(cull=False))
    for wide in (False, True):
        c2 = _card_bitwise(sc, rays, CFG, cols, tf, ti, T, g, wide)
        assert torch.equal(BITS(c2), BITS(want))


@pytest.mark.cuda
@pytest.mark.parametrize("what, name", [("schlick", "test17"),
                                        ("schlick", "test18"),
                                        ("deep_stack", "test18")])
def test_card_takes_schlick_and_deep_stacks(what, name):
    """On the card the kernels take Schlick Fresnel and a stack past 16
    slots (DEEP_CFG, its stacks past 16 at 200x120: the device-memory
    scratch), each bitwise its plain version (``_card_bitwise``), which
    the CPU tests hold to autograd's. (Before, the route raised on the
    card for both.)"""
    dev = _card()
    cfg = CFG._replace(schlick=True) if what == "schlick" else DEEP_CFG
    w, h = (800, 480) if what == "schlick" else (200, 120)
    sc, rays, cols, tf, ti, T, g = _card_case(name, dev, cfg, w, h)
    if what == "deep_stack":
        assert int(_stack_tops(ti).max()) > diff.LOCAL_SLOTS
    _card_bitwise(sc, rays, cfg, cols, tf, ti, T, g, False)


@pytest.mark.cuda
@pytest.mark.parametrize("what, name", [("schlick", "test17"),
                                        ("schlick", "test18"),
                                        ("deep_stack", "test18")])
@pytest.mark.parametrize("gate", ["unculled", "culled"])
def test_whitted_kernel_takes_schlick_and_deep_stacks_on_card(
        what, name, gate, monkeypatch):
    """The main path's Whitted kernel takes what the step's kernels take:
    trace_rays_cuda with Schlick Fresnel at 200x120, and with DEEP_CFG's
    stack (past 16 slots, in the device-memory scratch) at 200x120 plus
    one ray (a ragged warp), unculled and culled (the gate's floor
    lowered to cull the scene), bitwise the plain trace_rays, two
    launches bitwise, one launch each."""
    dev = _card()
    if gate == "culled":
        monkeypatch.setattr(ck, "CULL_MIN_SURFACES", 1)
    cfg = (TraceConfig(schlick=True) if what == "schlick"
           else DEEP_CFG)._replace(cull=gate == "culled")
    sc = _compiled(name, dev)
    org, dirs, t_min = _rays(sc, 200, 120)
    if what == "deep_stack":
        dirs, t_min = torch.cat([dirs, dirs[:1]]), torch.cat([t_min,
                                                              t_min[:1]])
        org = org[:1].expand(dirs.shape[0], 3).contiguous()
    struct = ck.scene_struct(sc)
    inst = ck.whitted_instance(struct, cfg, dirs.shape[0])
    assert inst["cull"] == (gate == "culled")
    assert inst["deep"] == (what == "deep_stack")
    want = trace.trace_rays(sc, org, dirs, t_min, cfg)
    before = ck.launches
    got = [ck.trace_rays_cuda(sc, org, dirs, t_min, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    assert ck.launches == before + 2
    for x in got:
        assert torch.equal(BITS(x), BITS(want))
    assert not torch.equal(want, trace.trace_rays(
        sc, org, dirs, t_min, TraceConfig(cull=cfg.cull)))


@pytest.mark.cuda
def test_single_branch_modes_take_any_stack_on_card():
    """The path records, emit and the two rounds on test13 (single-branch:
    they read no stack) at a stack of 40, bitwise their plain versions at
    200x120."""
    dev = _card()
    sc = _compiled("test13", dev)
    rays = _rays(sc, 200, 120)
    cfg = TraceConfig(stack=40)
    pk = ck.trace_paths(sc, *rays, cfg._replace(max_segments=8), 8)
    pp = trace.trace_paths(sc, *rays, cfg._replace(max_segments=8), 8)
    ek = ck.trace_rays_emit_cuda(sc, *rays, cfg, 4)
    ek = (ek[0].clone(), ek[1])
    ep = trace.trace_rays_emit(sc, *rays, cfg, 4)
    rk = ck.trace_rays_rounds(sc, *rays, cfg, 4)
    torch.cuda.synchronize()
    for x, y in ((pk[0], pp[0]), (ek[0], ep[0]), (ek[1], ep[1]),
                 (rk, trace.trace_rays(sc, *rays, cfg))):
        assert torch.equal(BITS(x), BITS(y))
    assert torch.equal(pk[1], pp[1])


@pytest.mark.cuda
def test_backward_past_48kb_bitwise_plain_on_card():
    """demo03's tables (256 surfaces) need 79 KB of accumulators a block,
    past the 48 KB a launch has without the shared-memory opt-in, and
    inside a block's 227 KB (not the wide mode): at 200x120 the tape and
    backward launches and the light sums bitwise their plain versions,
    two launches each (``_card_bitwise``)."""
    dev = _card()
    sc, rays, cols, tf, ti, T, g = _card_case("demo03", dev, CFG, 200, 120)
    assert 4 * rp.BWD_WARPS * diff.table_columns(T) > 48 * 1024
    assert not diff.rows_wide(T)
    _card_bitwise(sc, rays, CFG, cols, tf, ti, T, g, False)


@pytest.mark.cuda
def test_step_launches_the_fused_kernels_on_card():
    """One eager make_train_step step on test17 at 96x64: one tape
    forward, one backward and one light-sum call, no row-sum call (the
    tables fit the backward's accumulators) and no row gather (the
    autograd route's bounce reads); with the tables forced wide, one
    row-sum call more."""
    from quadray_tpu_torch.ops import row_gather as rg
    dev = _card()
    sc = _compiled("test17", dev)
    counters = lambda: (diff.launches, diff.backward_launches,
                        diff.light_sum_launches, rg.launches,
                        rg.backward_launches)
    for wide, rows in ((False, 0), (True, 1)):
        step_fn, opt_init = ttrain.make_train_step(96, 64, cfg=CFG,
                                                   eager=True)
        params = ttrain.extract_params(sc)
        before = counters()
        real = diff.rows_wide
        diff.rows_wide = (lambda T, smem=0: True) if wide else real
        try:
            step_fn(params, opt_init(params), sc,
                    torch.zeros((96 * 64, 3), device=dev))
        finally:
            diff.rows_wide = real
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counters(), before)) == (
            1, 1, 1, 0, rows)
