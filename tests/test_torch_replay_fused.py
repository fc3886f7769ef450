"""The fused replay (``ops/replay.py`` ``replay_color_fused``, its plain
version ``replay_plain``; ``csrc/replay.cu`` ``replay_forward_launch``,
``replay_backward_launch``): replay_color's colors and their gradient in
one forward and one backward launch for all K segments, the backward an
adjoint written out by hand.

On the CPU: ``replay_plain`` against the JAX replay_color run op by op
(test01, test02, test04 at 64x40; test13 at 48x32), at the ties JAX
splits in
half (the local weight's clip at 0 on test18's materials and on test13
with rfl + trn = 1, the loss clip on test13's lane 1041), against
autograd's replay_color on five scenes; the kernel file's per-ray
functions built with g++ and held to the plain version; the wrapper's
routes and the C signatures. The records are the port's plain
``trace_paths``'s (bitwise the JAX kernel's, tests/test_torch_paths.py),
handed to both replays as numpy. On the card (``cuda`` cases): the
kernels bitwise the plain version, and CUDA inputs never take it.

JAX is imported inside the tests that use it, so the card's tests run on
a GPU machine without it:
    python -m pytest tests/test_torch_replay_fused.py --noconftest -q -m cuda
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

from quadray_tpu_torch.ops import replay as rp
from quadray_tpu_torch.ops import row_gather as rg

torch.set_num_threads(1)

W, H, K = 64, 40, 4
# every float field replay_color differentiates
FIELDS = ("s_pos", "s_inv", "s_sci", "s_scjh", "s_sciw", "m_col", "m_dff",
          "m_spc", "m_pow", "m_rfl", "m_trn", "m_rfr", "m_ext", "l_pos",
          "l_col", "l_on", "l_cnt", "l_lnr", "l_qdr", "amb_col")
# replay_plain against autograd's replay_color (the same f32 forward; the
# adjoint's sums in another order) on every lane: tests/test_torch_replay.py
# 's GRAD_RTOL_ALL, the bound the port's replay_color meets against JAX's
# on all lanes; measured up to 2.3e-4 of a field's largest gradient
# (s_inv, test04 at 64x40, its ill-conditioned lanes), 6.0e-5 elsewhere
AUTOGRAD_RTOL = 1e-3
# the ties (tests/test_torch_local_weight.py, tests/test_torch_loss_clip.py)
TIE_RTOL = 1e-5
# the kernel's per-ray arithmetic built with g++ against the plain
# version: rsqrt, exp and log differ by an ulp between glibc and
# PyTorch's CPU kernels, so within a few ulps of each row's largest
REHEARSAL_RTOL = 1e-4
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "quadray_tpu_torch", "csrc", "replay.cu")
BITS = lambda t: t.contiguous().view(torch.int32)


def _compile_jax(name, fresnel=True):
    from quadray_tpu.models.scenes.loader import load_scene
    from quadray_tpu.scene import schema as S
    from quadray_tpu.scene.compile import compile_scene
    sd = load_scene(name)
    opts = S.OPTS_FULL & ~sd.opts
    return compile_scene(S.SceneDef(root=sd.root, opts=opts if fresnel
                                    else opts | S.OPTS_FRESNEL))


def _rays(j, w, h):
    import jax.numpy as jnp
    from quadray_tpu.ops.rays import camera_rays as jrays
    org1, dirs = jrays(j.cam_pos, j.cam_hor, j.cam_ver, j.cam_nrm,
                       j.cam_pov, w, h, 1)
    n = dirs.shape[0]
    jr = (jnp.broadcast_to(org1[None, :], (n, 3)), dirs,
          jnp.full((n,), j.cam_pov, jnp.float32))
    return jr, tuple(torch.from_numpy(np.array(a)) for a in jr)


@pytest.fixture(scope="module")
def case():
    """case(name, fresnel=True, edit=None) -> (JAX scene, JAX rays, port
    rays, records (K, N) numpy) at W x H, K segments; edit(j) changes the
    compiled JAX scene first. Made once a module."""
    from test_torch_replay import _torch_scene
    from quadray_tpu_torch.ops.trace import TraceConfig, trace_paths
    made = {}

    def get(name, fresnel=True, edit=None):
        key = (name, fresnel, edit)
        if key not in made:
            j = _compile_jax(name, fresnel)
            if edit is not None:
                j = edit(j)
            jr, tr = _rays(j, W, H)
            sc, _ = _torch_scene(j, ())
            _, paths = trace_paths(sc, *tr, TraceConfig(max_segments=K,
                                                        stack=4), K)
            made[key] = (j, jr, tr, paths.numpy())
        return made[key]
    return get


def _leaves(j, fields):
    from test_torch_replay import _torch_scene
    return _torch_scene(j, fields)


def _jax_grads(j, jr, paths, fields, jit=True, clip=True):
    """grads(wmask) -> (JAX colors, JAX grads) of sum(clip(cols) * wmask)
    (of sum(cols * wmask) without clip); jitted once (op by op without
    jit: one forward, a backward a call)."""
    import jax
    import jax.numpy as jnp
    from quadray_tpu.ops.replay import replay_color as jreplay
    from quadray_tpu.ops.trace import TraceConfig as JConfig
    jpaths = jnp.asarray(paths)
    params = {k: getattr(j, k) for k in fields}

    def out(params):
        cols = jreplay(j.replace(**params), *jr, jpaths,
                       JConfig(max_segments=K, stack=4))
        c2 = jnp.minimum(jnp.maximum(cols, 0.0), 1.0) if clip else cols
        return c2, cols

    def cot(c2, wmask):
        w = wmask if wmask.ndim == 2 else wmask[:, None]
        return jnp.broadcast_to(jnp.asarray(w, c2.dtype), c2.shape)

    if jit:
        @jax.jit
        def both(params, wmask):
            (c2, cols), vjp = jax.vjp(out, params)
            return cols, vjp((cot(c2, wmask), jnp.zeros_like(cols)))[0]
        return lambda wmask: both(params, wmask)
    with jax.disable_jit():
        (c2, cols), vjp = jax.vjp(out, params)

    def grads(wmask):
        with jax.disable_jit():
            return cols, vjp((cot(c2, wmask), jnp.zeros_like(cols)))[0]
    return grads


def _plain_grads(j, tr, paths, wmask, fields, fn=None, clip=True):
    """(port colors, {field: grad}) of the same loss through fn
    (replay_plain by default)."""
    fn = fn or rp.replay_plain
    sc, leaves = _leaves(j, fields)
    cols = fn(sc, *tr, torch.from_numpy(paths))
    w = torch.from_numpy(wmask)
    w = w if w.dim() == 2 else w[:, None]
    zero, one = torch.tensor(0.0), torch.tensor(1.0)
    c2 = torch.minimum(torch.maximum(cols, zero), one) if clip else cols
    (c2 * w).sum().backward()
    return cols.detach().numpy(), {k: v.grad.numpy() for k, v in
                                   leaves.items()}


def _close(got, want, fields, rtol):
    for k in fields:
        b = np.asarray(want[k])
        scale = np.abs(b).max()
        err = np.abs(got[k] - b).max()
        assert err <= rtol * scale, (
            f"{k}: max |grad diff| {err:.3e} vs max |grad| {scale:.3e}")


def _well(j, tr, paths):
    """The lanes whose replayed color moves by at most PRIMAL_ATOL when
    the ray moves by one ulp."""
    from test_torch_replay import PRIMAL_ATOL, _torch_scene, _ulp_sensitivity
    sc, _ = _torch_scene(j, ())
    tp = torch.from_numpy(paths)
    with torch.no_grad():
        s = _ulp_sensitivity(lambda d: rp.replay_color(sc, tr[0], d, tr[2],
                                                       tp), tr[1])
    return s, s <= PRIMAL_ATOL


@pytest.mark.parametrize("name", ["test01", "test02", "test04"])
def test_plain_matches_jax_replay(case, name):
    """replay_plain against the JAX replay_color, op by op (one forward,
    a backward a weighting), under tests/test_torch_replay.py's bounds
    (which it holds against the jitted one): colors within PRIMAL_ATOL on the
    well-conditioned lanes (over 99%) and within their one-ulp change on
    the others; every DIFFERENTIABLE_FIELDS gradient within GRAD_RTOL of
    its largest on those lanes and GRAD_RTOL_ALL on all of them."""
    from test_torch_replay import GRAD_RTOL, GRAD_RTOL_ALL, PRIMAL_ATOL
    from quadray_tpu_torch.parallel.train import DIFFERENTIABLE_FIELDS
    j, jr, tr, paths = case(name)
    s, well = _well(j, tr, paths)
    assert well.mean() > 0.99
    jax_grads = _jax_grads(j, jr, paths, DIFFERENTIABLE_FIELDS, jit=False)
    for wmask, rtol in ((well, GRAD_RTOL), (np.ones_like(well),
                                            GRAD_RTOL_ALL)):
        wmask = wmask.astype(np.float32)
        want, jg = jax_grads(wmask)
        want = np.asarray(want)
        got, pg = _plain_grads(j, tr, paths, wmask, DIFFERENTIABLE_FIELDS)
        d = np.abs(got - want).max(axis=1)
        assert d[well].max() <= PRIMAL_ATOL
        assert np.all(d[~well] <= s[~well])
        _close(pg, jg, DIFFERENTIABLE_FIELDS, rtol)


@pytest.fixture(scope="module")
def test13_48():
    """test13 at 48x32, K=4: (JAX scene, port rays, records, the
    well-conditioned lanes, grads(cotangent) of the JAX replay run op by
    op over DIFFERENTIABLE_FIELDS: one forward, a backward a call)."""
    from test_torch_replay import _torch_scene
    from quadray_tpu_torch.ops.trace import TraceConfig, trace_paths
    from quadray_tpu_torch.parallel.train import DIFFERENTIABLE_FIELDS
    j = _compile_jax("test13")
    jr, tr = _rays(j, 48, 32)
    sc, _ = _torch_scene(j, ())
    _, paths = trace_paths(sc, *tr, TraceConfig(max_segments=K, stack=4), K)
    paths = paths.numpy()
    _, well = _well(j, tr, paths)
    return j, tr, paths, well, _jax_grads(j, jr, paths,
                                          DIFFERENTIABLE_FIELDS, jit=False)


def test_plain_matches_op_by_op_jax_on_test13(test13_48):
    """test13 (104 surfaces, over the JAX replay's one-hot limit of 64) at
    48x32, K=4, against the JAX replay run op by op (jitted, XLA's CPU
    contraction moves its gradients, ROADMAP section 3), under
    tests/test_torch_replay.py's bounds as tests/test_torch_row_gather.py
    holds replay_color there: colors within PRIMAL_ATOL on the
    well-conditioned lanes, every DIFFERENTIABLE_FIELDS gradient within
    GRAD_RTOL of its largest on those lanes and GRAD_RTOL_ALL on all.
    Measured: 1.63e-5 and 5.3e-4 (s_sci); autograd's replay_color 1.63e-5
    and 1.78e-4. The well-conditioned lanes are all but one (808), and the
    all-lane gap is that lane's: weighted alone, its gradient is held
    field by field within the change that a one-ulp move of its ray's
    direction makes in replay_plain's gradient (measured: s_sci 1.47e-3
    off JAX against 2.72e-3 from the move, s_inv 1.10e-3 against
    5.42e-3, of largest gradients 2.75 and 5.49): the gap is rounding,
    where an adjoint fault would be the size of the gradient."""
    from test_torch_replay import GRAD_RTOL, GRAD_RTOL_ALL, PRIMAL_ATOL
    from quadray_tpu_torch.parallel.train import DIFFERENTIABLE_FIELDS
    j, tr, paths, well, jax_grads = test13_48
    assert well.mean() > 0.99
    for wmask, rtol in ((well, GRAD_RTOL), (np.ones_like(well),
                                            GRAD_RTOL_ALL)):
        wmask = wmask.astype(np.float32)
        want, jg = jax_grads(wmask)
        got, pg = _plain_grads(j, tr, paths, wmask, DIFFERENTIABLE_FIELDS)
        d = np.abs(got - np.asarray(want)).max(axis=1)
        assert d[well].max() <= PRIMAL_ATOL
        _close(pg, jg, DIFFERENTIABLE_FIELDS, rtol)
    for i in np.nonzero(~well)[0]:
        wmask = np.zeros(well.shape, np.float32)
        wmask[i] = 1.0
        _, jg = jax_grads(wmask)
        _, pg = _plain_grads(j, tr, paths, wmask, DIFFERENTIABLE_FIELDS)
        moved = {k: 0.0 for k in DIFFERENTIABLE_FIELDS}
        for c in range(3):
            for to in (np.inf, -np.inf):
                dirs = tr[1].numpy().copy()
                dirs[i, c] = np.nextafter(dirs[i, c], np.float32(to))
                _, qg = _plain_grads(j, (tr[0], torch.from_numpy(dirs),
                                         tr[2]), paths, wmask,
                                     DIFFERENTIABLE_FIELDS)
                for k in moved:
                    moved[k] = max(moved[k],
                                   float(np.abs(qg[k] - pg[k]).max()))
        for k in DIFFERENTIABLE_FIELDS:
            gap = float(np.abs(pg[k] - np.asarray(jg[k])).max())
            assert gap <= moved[k], (
                f"lane {i} {k}: {gap:.3e} off JAX, its gradient moves "
                f"{moved[k]:.3e} with its ray")


def _tie13(j):
    """test13 with every reflective or transmissive material at rfl + trn
    = 1 (0.25 + 0.75 where it transmits, else 1 + 0)."""
    import jax.numpy as jnp
    rfl, trn = np.array(j.m_rfl), np.array(j.m_trn)
    rfl = np.where(trn > 0, 0.25, np.where(rfl > 0, 1.0, rfl))
    trn = np.where(trn > 0, 0.75, trn)
    return j.replace(m_rfl=jnp.asarray(rfl.astype(np.float32)),
                     m_trn=jnp.asarray(trn.astype(np.float32)))


@pytest.mark.parametrize("name,fresnel,edit", [
    ("test18", False, None), ("test13", True, _tie13)],
    ids=["test18", "test13_tied"])
def test_local_weight_ties_match_jax(case, name, fresnel, edit):
    """The local weight 1 - m_trn - m_rfl clipped at 0, an exact 0 on
    test18's materials 5-7 (test18 without Fresnel: its glass then takes
    one branch, as the records need) and on test13 with rfl + trn = 1:
    jnp.maximum's gradient at the tie is one half. d/d m_rfl and d/d m_trn
    of the colors weighted by seeded normal weights against the JAX
    replay op by op, within TIE_RTOL of the largest and of each tied
    entry that the records reach."""
    j, jr, tr, paths = case(name, fresnel, edit)
    rfl, trn = np.asarray(j.m_rfl), np.asarray(j.m_trn)
    tied = np.nonzero((rfl + trn == 1.0) & ((rfl > 0) | (trn > 0)))[0]
    wt = np.random.RandomState(0).standard_normal(
        (tr[1].shape[0], 3)).astype(np.float32)
    fields = ("m_rfl", "m_trn")
    _, jg = _jax_grads(j, jr, paths, fields, jit=False, clip=False)(wt)
    _, pg = _plain_grads(j, tr, paths, wt, fields, clip=False)
    _close(pg, jg, fields, TIE_RTOL)
    reached = 0
    for k in fields:
        want = np.asarray(jg[k])
        for m in tied:
            if want[m] != 0.0:
                reached += 1
                assert abs(pg[k][m] - want[m]) <= TIE_RTOL * abs(want[m]), (
                    k, m, pg[k][m], want[m])
    assert reached


def test_loss_clip_tie_matches_jax(test13_48):
    """tests/test_torch_loss_clip.py's case through the fused replay's
    plain version: test13 at 48x32, K=4, the training loss
    (``_weighted_mse``, jnp.clip's half gradient at a tie) of lane 1041
    alone (w one-hot), whose red channel is an exact 0: d/d m_col[6, 0]
    against the JAX replay run op by op, its loss's cotangent 2 (clip(c)
    - target) w / 3, within TIE_RTOL of its value."""
    from quadray_tpu_torch.parallel import train as ttrain
    j, tr, paths, _, jax_grads = test13_48
    lane = 1041
    n = tr[1].shape[0]
    target = np.zeros((n, 3), np.float32)
    target[lane] = np.random.RandomState(1041).uniform(0.25, 0.75, 3)
    w = np.zeros((n,), np.float32)
    w[lane] = 1.0
    sc, leaves = _leaves(j, ("m_col",))
    cols = rp.replay_plain(sc, *tr, torch.from_numpy(paths))
    assert cols[lane, 0].item() == 0.0
    ttrain._weighted_mse(cols, torch.from_numpy(target),
                         torch.from_numpy(w)).backward()
    got = leaves["m_col"].grad[6, 0].item()
    jcols, _ = jax_grads(np.zeros((n,), np.float32))
    c2 = np.minimum(np.maximum(np.asarray(jcols), 0.0), 1.0)
    _, jg = jax_grads((2.0 * (c2 - target) * w[:, None] / 3.0).astype(
        np.float32))
    want = float(np.asarray(jg["m_col"])[6, 0])
    assert want != 0.0
    assert abs(got - want) <= TIE_RTOL * abs(want), (got, want)


def _port_case(name, w=W, h=H, k=K):
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops.rays import camera_rays
    from quadray_tpu_torch.ops.trace import TraceConfig, trace_paths
    from quadray_tpu_torch.scene import schema as S
    from quadray_tpu_torch.scene.compile import compile_scene
    sd = load_scene(name)
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device="cpu")
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, w, h, 1)
    tmin = sc.cam_pov.expand(dirs.shape[0])
    _, paths = trace_paths(sc, org, dirs, tmin,
                           TraceConfig(max_segments=k, stack=4), k)
    return sc, (org, dirs, tmin), paths


def _grads_of(fn, sc, rays, paths, wt):
    leaves = {k: getattr(sc, k).detach().clone().requires_grad_(True)
              for k in FIELDS}
    cols = fn(dataclasses.replace(sc, **leaves), *rays, paths)
    (cols * wt).sum().backward()
    return cols.detach(), {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("name,w,h", [
    ("test01", 32, 20), ("test04", 64, 40), ("test13", 32, 20),
    ("test14", 32, 20), ("demo03", 32, 20)])
def test_plain_matches_autograd_replay(name, w, h):
    """replay_plain against autograd's replay_color on the same records,
    every float field, colors weighted by seeded normal weights: the
    colors bitwise (the same f32 operations), each field's gradient
    within AUTOGRAD_RTOL of its largest."""
    sc, rays, paths = _port_case(name, w, h)
    wt = torch.from_numpy(np.random.RandomState(7).standard_normal(
        (rays[1].shape[0], 3)).astype(np.float32))
    want, gw = _grads_of(rp.replay_color, sc, rays, paths, wt)
    got, gg = _grads_of(rp.replay_plain, sc, rays, paths, wt)
    assert torch.equal(BITS(got), BITS(want))
    for k in FIELDS:
        scale = float(gw[k].abs().max())
        err = float((gg[k] - gw[k]).abs().max())
        assert err <= AUTOGRAD_RTOL * scale or err == 0.0, (k, err, scale)


def test_plain_order_of_the_light_sums():
    """_tile_sums and _block_sums are the backward kernels' order: each
    tile of 32 rays an xor butterfly (lane p adds lane p ^ h for h = 16,
    8, 4, 2, 1), +0.0 past the last ray; from +0.0 in order a block's
    BWD_WARPS tiles, a group's LIGHT_GROUP blocks, then the groups:
    bitwise a literal float32 loop of that order, at ragged ray counts
    (up to three groups)."""
    rs = np.random.RandomState(3)

    def in_order(parts, per):
        out = []
        for b in range(0, len(parts), per):
            s = np.zeros(3, np.float32)
            for p in parts[b:b + per]:
                s = s + p
            out.append(s)
        return out

    for n in (1, 31, 33, 129, 1000, 2 * 4096 + 129):
        x = rs.standard_normal((3, n)).astype(np.float32)
        lanes = np.zeros((3, -(-n // 32) * 32), np.float32)
        lanes[:, :n] = x
        tiles = []
        for t in range(lanes.shape[1] // 32):
            v = lanes[:, 32 * t:32 * t + 32].copy()
            h = 16
            while h:
                v = np.stack([v[:, p] + v[:, p ^ h] for p in range(32)], 1)
                h //= 2
            tiles.append(v[:, 0])
        groups = in_order(in_order(tiles, rp.BWD_WARPS), rp.LIGHT_GROUP)
        want = in_order(groups, len(groups))[0]
        got = rp._block_sums(rp._tile_sums(torch.from_numpy(x)))
        assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_cpu_tensors_never_reach_the_library(monkeypatch):
    """On CPU tensors replay_color_fused runs the plain versions only; a
    training step's gradients flow to every trained field."""
    def refuse():
        raise AssertionError("the kernels' library was loaded")
    monkeypatch.setattr(rg, "_lib", refuse)
    sc, rays, paths = _port_case("test13", 16, 8, 2)
    f0, b0 = rp.launches, rp.backward_launches
    wt = torch.ones((rays[1].shape[0], 3))
    cols, grads = _grads_of(rp.replay_color_fused, sc, rays, paths, wt)
    assert (rp.launches, rp.backward_launches) == (f0, b0)
    want, _ = _grads_of(rp.replay_plain, sc, rays, paths, wt)
    assert torch.equal(BITS(cols), BITS(want))
    assert all(g is not None for g in grads.values())


def test_rays_that_require_grad_raise():
    sc, (org, dirs, tmin), paths = _port_case("test01", 8, 4, 2)
    for o, d in ((org.clone().requires_grad_(True), dirs),
                 (org, dirs.clone().requires_grad_(True))):
        with pytest.raises(ValueError, match="require grad"):
            rp.replay_color_fused(sc, o, d, tmin, paths)
        with pytest.raises(ValueError, match="require grad"):
            rp.replay_plain(sc, o, d, tmin, paths)
    with pytest.raises(ValueError, match="unsupported device"):
        rp.replay_color_fused(sc, org.to("meta"), dirs.to("meta"), tmin,
                              paths.to("meta"))


def test_argtypes_match_the_c_entry_points():
    """The library's ARGTYPES (ops/row_gather.py, which loads it) lists
    the fused replay's C entry points' parameters: pointers as c_void_p,
    ints as c_int, in csrc/replay.cu's order."""
    src = open(SRC).read()
    for fn in ("replay_forward_launch", "replay_backward_launch"):
        types = rg.ARGTYPES[fn]
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
        params = [p.strip() for p in m.group(1).split(",")]
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in params]
        assert types == want, fn


# ---- the kernel's arithmetic on the CPU ---------------------------------------

SHIM = r"""
#include <cmath>
#include <cstddef>
#include <cstdlib>
#define __device__
#define __forceinline__ inline
#define __restrict__
static inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline void __trap() { std::abort(); }
static inline bool __any_sync(unsigned, bool p) { return p; }
struct Dim3 { unsigned x; };
static Dim3 threadIdx{0}, blockDim{1};
static inline void __syncthreads() {}
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int SF = 19, MF = 10;
// one ray alone: its lights' and ambient's gradients, summed over its
// segments
template <int COUNT>
inline void warp_add(const float (&x)[COUNT], bool live, float* acc) {
  for (int j = 0; j < COUNT; ++j) acc[j] += live ? x[j] : 0.0f;
}
"""
DRIVER = r"""
extern "C" void fwd(const float* stab, const float* mtab, const float* ltab,
    const float* amb, const int* s_kind, const int* s_mat,
    const int* m_props, int ug, int uf, const float* org, int org_stride,
    const float* dirs, const int* paths, float* cols, float* state, int* ids,
    int n, int k, int ns, int nm, int nl) {
  const Tabs t{stab, mtab, ltab, amb, s_kind, s_mat, m_props, ns, nm, nl};
  for (int i = 0; i < n; ++i)
    fwd_ray(t, ug, uf, org, org_stride, dirs, paths, cols, state, ids, i, n,
            k);
}
extern "C" void bwd(const float* stab, const float* mtab, const float* ltab,
    const float* amb, const int* s_kind, const int* s_mat,
    const int* m_props, int ug, int uf, const int* paths, const float* state,
    const int* ids, const float* g_cols, float* g_s, float* g_m, float* lray,
    int n, int k, int ns, int nm, int nl) {
  const Tabs t{stab, mtab, ltab, amb, s_kind, s_mat, m_props, ns, nm, nl};
  for (int i = 0; i < n; ++i)
    bwd_ray(t, ug, uf, paths, state, ids, g_cols, g_s, g_m,
            lray + (size_t)i * (10 * nl + 3), i, true, n, k);
}
"""


def _c_block(src, start):
    at = src.index(start)
    depth, i = 0, src.index("{", at)
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
        if depth == 0:
            return src[at:i]


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """csrc/replay.cu's per-ray device functions (fwd_ray, bwd_ray and
    what they call) built with g++ behind a shim, one ray at a time; the
    warp's butterfly becomes the ray's own sum over its segments."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernel's per-ray functions on the CPU"
    src = open(SRC).read()
    body = src[src.index("constexpr int SEG_WARPS"):src.index(
        "__global__ void __launch_bounds__(SEG_THREADS)"
        "\n    replay_fwd_kernel")]
    for start in ("__device__ __forceinline__ float warp_sum(",
                  "template <int COUNT>\n__device__ __forceinline__ void "
                  "warp_add("):
        body = body.replace(_c_block(src, start), "")
    d = tmp_path_factory.mktemp("replay")
    (d / "r.cpp").write_text(SHIM + "namespace {\n" + body + "}\n" + DRIVER)
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(d / "r.so"), str(d / "r.cpp")],
                   check=True)
    return ctypes.CDLL(str(d / "r.so"))


@pytest.mark.parametrize("name", ["test01", "test04", "test13", "demo03"])
def test_kernel_arithmetic_matches_plain(rehearsal, name):
    """fwd_ray and bwd_ray on every ray against forward_plain and
    backward_rows_plain: the ids and the state's first segment bitwise,
    colors, state and each segment's row gradients within REHEARSAL_RTOL
    of each row's largest, and the lights' and ambient's gradients summed
    over the rays (float64) within REHEARSAL_RTOL of each one's."""
    sc, (org, dirs, _), paths = _port_case(name, 32, 20)
    tabs = [t.detach().contiguous() for t in rp._table_args(sc)]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    n, k = dirs.shape[0], paths.shape[0]
    ns, nm, nl = tabs[0].shape[1], tabs[1].shape[1], tabs[2].shape[0]
    flags = (int(tabs[7] > 0), int(tabs[8] > 0))
    cols, state, ids = rp.forward_plain(*tabs, org, dirs, paths)
    c2, s2 = torch.empty((n, 3)), torch.empty((k, rp.STATE_ROWS, n))
    i2 = torch.empty((2, k, n), dtype=torch.int32)
    dirs = dirs.contiguous()
    rehearsal.fwd(*map(ptr, tabs[:7]), *flags, ptr(org), 0, ptr(dirs),
                  ptr(paths), ptr(c2), ptr(s2), ptr(i2), n, k, ns, nm, nl)
    assert torch.equal(i2, ids)
    assert torch.equal(s2[0], state[0])
    scale = cols.abs().max()
    assert (c2 - cols).abs().max() <= REHEARSAL_RTOL * scale
    assert (s2 - state).abs().max() <= REHEARSAL_RTOL * state.abs().max()

    g = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (n, 3)).astype(np.float32))
    g_s, g_m, tiles = rp.backward_rows_plain(g, *tabs, paths, state, ids)
    gs2, gm2 = torch.empty_like(g_s), torch.empty_like(g_m)
    lray = torch.zeros((n, tiles.shape[0]))
    rehearsal.bwd(*map(ptr, tabs[:7]), *flags, ptr(paths), ptr(state),
                  ptr(ids), ptr(g), ptr(gs2), ptr(gm2), ptr(lray), n, k, ns,
                  nm, nl)
    for got, want in ((gs2, g_s), (gm2, g_m)):
        err = (got - want).abs().amax(dim=1)
        assert torch.all(err <= REHEARSAL_RTOL * want.abs().amax(dim=1))
    lw, lg = tiles.double().sum(1), lray.double().sum(0)
    assert torch.all((lg - lw).abs() <= REHEARSAL_RTOL * lw.abs())


# ---- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _card_case(name, dev, w=W, h=H, k=K):
    """A scene compiled on the card, its camera rays and the path-record
    kernel's records (the training step's)."""
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.rays import camera_rays
    from quadray_tpu_torch.ops.trace import TraceConfig
    from quadray_tpu_torch.scene import schema as S
    from quadray_tpu_torch.scene.compile import compile_scene
    sd = load_scene(name)
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device=dev)
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, w, h, 1)
    tmin = sc.cam_pov.expand(dirs.shape[0])
    _, paths = ck.trace_paths(sc, org, dirs, tmin,
                              TraceConfig(max_segments=k, stack=4), k)
    return sc, (org, dirs, tmin), paths


@pytest.mark.cuda
@pytest.mark.parametrize("name,w,h", [("test01", 800, 480),
                                      ("test13", 800, 480),
                                      ("demo03", 800, 480),
                                      ("test13", 33, 1)])
def test_kernels_bitwise_plain_on_card(name, w, h):
    """The fused forward and backward kernels bitwise forward_plain and
    backward_plain on the card (colors, state, ids, the four gradients),
    two launches bitwise each other; the colors bitwise autograd's
    replay_color's."""
    dev = _card()
    sc, (org, dirs, tmin), paths = _card_case(name, dev, w, h, 8)
    tabs = [t.detach() for t in rp._table_args(sc)]
    g = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (dirs.shape[0], 3)).astype(np.float32)).to(dev)
    want = rp.forward_plain(*tabs, org, dirs, paths)
    want = want + rp.backward_plain(g, *tabs, paths, want[1], want[2])
    for _ in range(2):
        got = rp._forward_kernel(*tabs, org, dirs, paths)
        got = got + rp._backward_kernel(g, *tabs, paths, got[1], got[2])
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(BITS(x), BITS(y))
    with torch.no_grad():
        ref = rp.replay_color(sc, org, dirs, tmin, paths)
    assert torch.equal(BITS(got[0]), BITS(ref))


@pytest.mark.cuda
def test_cuda_inputs_never_take_the_plain_versions(monkeypatch):
    """replay_color_fused forward and backward on the card with the plain
    versions made to raise: one forward, one backward and one row-sum
    launch, and no gather forward."""
    dev = _card()
    sc, rays, paths = _card_case("test13", dev)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")
    for fn in ("forward_plain", "backward_plain", "backward_rows_plain"):
        monkeypatch.setattr(rp, fn, refuse)
    monkeypatch.setattr(rg, "row_sum_plain", refuse)
    monkeypatch.setattr(rg, "gather_plain", refuse)
    before = (rp.launches, rp.backward_launches, rg.launches,
              rg.backward_launches)
    _grads_of(rp.replay_color_fused, sc, rays, paths,
              torch.ones((rays[1].shape[0], 3), device=dev))
    torch.cuda.synchronize()
    after = (rp.launches, rp.backward_launches, rg.launches,
             rg.backward_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0, 1)
