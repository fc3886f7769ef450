"""Bounding-sphere culling of the port: the culling tables against the
JAX package's, the plain tracer's cull masks (the CUDA kernel's warp
masks, ``ops/trace.py`` ``Cull``/``bundle_reach``) against the unculled
tracer and the JAX tracer, the reach predicate, the gate, and on the card
the kernel culled against unculled and plain; and the training step,
which traces unculled because its parameters move surfaces away from
their compiled bounding spheres.

JAX is imported inside the tests that use it, so the card's tests run on
a GPU machine without it:
    python -m pytest tests/test_torch_cull.py --noconftest -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.rays import camera_rays
from quadray_tpu_torch.ops.trace import (
    WARP, TraceConfig, bundle_reach, trace_paths, trace_rays,
    trace_rays_emit, trace_rays_resume)
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import FIELDS, compile_scene

torch.set_num_threads(1)

# the tolerance of tests/test_torch_trace.py (linear colours)
ATOL = 1e-5
W, H = 64, 40
# a band of rows of the 64x40 frame: whole warps of the frame's own
# bundles, at a tenth of its cost
ROWS = slice(18 * W, 22 * W)
BITS = lambda t: t.contiguous().view(torch.int32)


def _scene(name, device="cpu"):
    sd = load_scene(name)
    return compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         device=device)


def _rays(sc, rows=ROWS, w=W, h=H):
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, w, h, 1)
    dirs = dirs[rows].contiguous()
    return org, dirs, sc.cam_pov.expand(dirs.shape[0])


def _jax_scene(t):
    import jax.numpy as jnp
    from quadray_tpu.scene.compile import SceneArrays
    return SceneArrays(**{k: jnp.asarray(getattr(t, k).cpu().numpy())
                          for k in FIELDS})


@pytest.mark.parametrize("name", ["test01", "test13", "demo03"])
def test_cull_tables_match_jax(name):
    """bsph_t, shad_msk, cont_msk from one numpy scene: the many-surface
    scenes take the lsort and cont gates tests/test_cull.py never
    reaches. The JAX pack_scene runs jitted (one XLA compile, not one per
    op: 1 s a scene against 8); run eagerly it gives the same bits."""
    import jax
    import quadray_tpu.ops.pallas_kernel as pk
    t = _scene(name)
    j = _jax_scene(t)
    jp = jax.jit(pk.pack_scene, static_argnums=1)(j, pk.scene_struct(j))
    struct = ck.scene_struct(t)
    tp = ck.pack_scene(t, struct)
    for f in ("bsph_t", "shad_msk", "cont_msk"):
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), f
    gates = ck.cull_gates(struct, TraceConfig())
    assert gates.cull == gates.lsort == gates.cont == (name != "test01")


@pytest.mark.parametrize("mode", ["rays", "paths", "rounds"])
@pytest.mark.parametrize("name", ["test13", "demo03"])
def test_plain_cull_is_bitwise_neutral(name, mode):
    """The plain tracer with cull=True drops the hits of every surface its
    bundle masks skip: the same bits as cull=False, the check on the
    masks' conservativeness; and they do skip tests."""
    sc = _scene(name)
    rays = _rays(sc)
    on, off = TraceConfig(), TraceConfig(cull=False)
    stats = {}
    if mode == "rays":
        a = trace_rays(sc, *rays, on, stats)
        assert torch.equal(BITS(a), BITS(trace_rays(sc, *rays, off)))
    elif mode == "paths":
        cfg = TraceConfig(max_segments=8, stack=4)
        a = trace_paths(sc, *rays, cfg, 8, stats)
        b = trace_paths(sc, *rays, cfg._replace(cull=False), 8)
        assert torch.equal(a[1], b[1]) and torch.equal(BITS(a[0]),
                                                        BITS(b[0]))
    else:
        ca, sa = trace_rays_emit(sc, *rays, on, 2, stats)
        cb, sb = trace_rays_emit(sc, *rays, off, 2)
        assert torch.equal(BITS(ca), BITS(cb)) and torch.equal(BITS(sa),
                                                                BITS(sb))
        ra = trace_rays_resume(sc, sa, ca, on, 2, stats)
        assert torch.equal(BITS(ra), BITS(trace_rays_resume(sc, sb, cb, off,
                                                            2)))
        # the two rounds give trace_rays's bits
        assert torch.equal(BITS(ra), BITS(trace_rays(sc, *rays, on)))
    n = ck.scene_struct(sc).n_real
    assert stats["nearest_tests_kept"] + stats["nearest_tests_culled"] \
        == stats["walks"] * n
    assert stats["nearest_tests_culled"] > 0.2 * stats["nearest_tests_kept"]
    assert stats["shadow_tests_culled"] > 0


def test_plain_culled_matches_jax():
    """The culled plain tracer against the JAX jnp tracer on rows 12-26 of
    test13 at 64x40, within tests/test_torch_trace.py's tolerance; where
    XLA's FMA contraction moves a jitted lane off the JAX tracer run op by
    op (one lane of the frame, in row 27), the lane is held to the
    op-by-op run instead."""
    import jax
    import jax.numpy as jnp
    from quadray_tpu.ops.trace import TraceConfig as JConfig
    from quadray_tpu.ops.trace import trace_rays as jtrace
    t = _scene("test13")
    j = _jax_scene(t)
    org, dirs, tmin = _rays(t, slice(12 * W, 27 * W))
    got = trace_rays(t, org, dirs, tmin, TraceConfig()).numpy()
    jorg, jdirs = jnp.asarray(org.numpy()), jnp.asarray(dirs.numpy())
    jt = jnp.full((dirs.shape[0],), j.cam_pov, jnp.float32)
    want = np.asarray(jtrace(j, jorg, jdirs, jt, JConfig()))
    off = np.nonzero(np.abs(got - want).max(1) > ATOL)[0]
    assert len(off) <= 4
    if len(off):
        with jax.disable_jit():
            ops = np.asarray(jtrace(j, jorg, jdirs[off], jt[off], JConfig()))
        assert np.abs(got[off] - ops).max() <= ATOL


def _bundle(data, shadow):
    """A bundle of WARP rays drawn around a centre within +-10: origins
    spread up to 10 apart, unit directions around an axis spread up to
    fully incoherent, some lanes off (at least one on)."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    o = (rng.uniform(-10.0, 10.0, 3)
         + data.draw(st.floats(0.0, 10.0)) * rng.uniform(-1.0, 1.0, (WARP, 3)))
    axis = rng.normal(size=3)
    d = axis / np.linalg.norm(axis) + data.draw(st.floats(0.0, 2.0)) \
        * rng.normal(size=(WARP, 3))
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-3)
    if not shadow:
        # a nearest-hit ray's length does not matter, only its direction
        d *= data.draw(st.floats(0.01, 100.0))
    on = rng.random(WARP) < data.draw(st.floats(0.05, 1.0))
    on[data.draw(st.integers(0, WARP - 1))] = True
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32), torch.tensor(on))


@settings(max_examples=200, deadline=None, database=None, derandomize=True)
@given(data=st.data(), shadow=st.booleans())
def test_reach_keeps_every_sphere_a_ray_meets(data, shadow):
    """A sphere that any ray of the bundle passes through is reached: its
    centre lies within its radius of a point o + t d of a ray that is on,
    t >= 0 (a nearest-hit ray) or t in [0, 1] (a shadow ray)."""
    o, d, on = _bundle(data, shadow)
    lane = data.draw(st.sampled_from(np.nonzero(on.numpy())[0].tolist()))
    t = data.draw(st.floats(0.0, 1.0 if shadow else 50.0))
    rad = data.draw(st.floats(0.0, 3.0))
    u = torch.tensor(data.draw(st.tuples(*[st.floats(-1.0, 1.0)] * 3)),
                     dtype=torch.float64)
    u = u / max(float(u.norm()), 1e-9) * rad * 0.99
    c = o[lane].double() + t * d[lane].double() + u
    spheres = torch.tensor([[c[0]], [c[1]], [c[2]], [rad]],
                           dtype=torch.float32)
    reach = bundle_reach(o[None], d[None], on[None], spheres, shadow)
    assert bool(reach[0, 0])


@pytest.mark.parametrize("shadow", [False, True])
def test_reach_says_reach_for_nan_and_inf(shadow):
    """NaN in a sphere, an unbounded sphere (radius +inf) and NaN or inf in
    a ray that is on all come out as "reach"."""
    g = torch.Generator().manual_seed(6)
    o = torch.rand((1, WARP, 3), generator=g)
    d = torch.rand((1, WARP, 3), generator=g) + 0.1
    on = torch.ones((1, WARP), dtype=torch.bool)
    far = torch.tensor([[-1e6], [-1e6], [-1e6], [1.0]])   # behind the rays
    assert not bool(bundle_reach(o, d, on, far, shadow)[0, 0])
    for k in range(4):
        s = far.clone()
        s[k, 0] = float("nan")
        assert bool(bundle_reach(o, d, on, s, shadow)[0, 0]), k
    s = far.clone()
    s[3, 0] = float("inf")
    assert bool(bundle_reach(o, d, on, s, shadow)[0, 0])
    for bad in (float("nan"), float("inf"), -float("inf")):
        for t in (o, d):
            t2 = t.clone()
            t2[0, 5, 1] = bad
            args = (t2, d) if t is o else (o, t2)
            assert bool(bundle_reach(*args, on, far, shadow)[0, 0]), bad
    # a lane that is off adds nothing, whatever it holds
    o2 = o.clone()
    o2[0, 5] = float("nan")
    on2 = on.clone()
    on2[0, 5] = False
    assert not bool(bundle_reach(o2, d, on2, far, shadow)[0, 0])
    assert not bool(bundle_reach(o, d, on & False, far, shadow)[0, 0])


def test_cull_gates():
    """One gate for the wrappers and the plain tracer: bounds, lights,
    the branch stack, the real surface count (CULL_MIN_SURFACES to
    MAX_SURFACES) and the config's cull, lsort and unroll."""
    struct = ck.scene_struct(_scene("test13"))
    assert struct.nl > 0 and not struct.can_push and any(struct.bnd)
    gates = ck.cull_gates
    cfg = TraceConfig()
    assert gates(struct, cfg) == (True, True, True)
    assert gates(struct, cfg).flags == 7
    assert gates(struct, cfg._replace(cull=False)) == (False, False, False)
    assert gates(struct, cfg._replace(cull=False)).flags == 0
    assert gates(struct, cfg._replace(lsort=False)) == (True, False, False)
    unbounded = struct._replace(bnd=(0,) * len(struct.bnd))
    assert gates(unbounded, cfg) == (False, False, False)
    assert gates(struct._replace(nl=0), cfg) == (True, False, True)
    assert gates(struct._replace(can_push=True), cfg) == (True, True, False)
    assert gates(struct, cfg._replace(unroll=struct.n_real)) == (
        True, False, False)
    small = ck.scene_struct(_scene("test03"))
    assert ck.CULL_MIN_SURFACES <= small.n_real <= cfg.unroll
    assert gates(small, cfg) == (True, False, False)
    for name in ("test01", "test04"):
        tiny = ck.scene_struct(_scene(name))
        assert tiny.n_real < ck.CULL_MIN_SURFACES and any(tiny.bnd)
        assert gates(tiny, cfg) == (False, False, False)
    # more surfaces than a culled launch's masks hold: unculled
    g0 = struct.groups[0]
    big = struct._replace(groups=(g0._replace(count=ck.MAX_SURFACES + 1),))
    assert gates(big, cfg) == (False, False, False)
    assert gates(big._replace(groups=(g0._replace(count=ck.MAX_SURFACES),)),
                 cfg) == (True, True, True)
    assert gates(ck.scene_struct(_scene("test17")), cfg).cont is False


def test_training_traces_unculled_at_trained_params(monkeypatch):
    """Training re-packs the scene from its current parameters every step,
    while the bounding spheres (s_bsph) stay those of the compile. On
    test01, with the gate's floor lowered so that it culls, the parameters
    move its small sphere (bounding radius 0.09) out of its compiled
    bounding sphere into the camera's view; then two train steps. Each
    step's path records equal the unculled plain ``trace_paths`` at that
    step's parameters and hold the moved sphere's hits (a culled walk
    would skip them: the stale sphere is out of those rays' reach)."""
    from quadray_tpu_torch.parallel import train as ttrain
    monkeypatch.setattr(ck, "CULL_MIN_SURFACES", 1)
    sc = _scene("test01")
    cfg = TraceConfig(max_segments=8, stack=4)
    assert ck.cull_gates(ck.scene_struct(sc), cfg).cull
    k = 3
    pos = sc.s_pos.clone()
    pos[k] = sc.cam_pos + 2.5 * sc.cam_nrm + torch.tensor([0.8, 0.0, 0.4])
    assert float(((pos[k] - sc.s_bsph[k, :3]) ** 2).sum()) \
        > 100.0 * float(sc.s_bsph[k, 3])
    traced = []
    kernel_paths = ck.trace_paths_with_struct

    def spy(s2, *a, **kw):
        out = kernel_paths(s2, *a, **kw)
        # the step's Adam updates the parameters in place afterwards
        traced.append((dataclasses.replace(s2, s_pos=s2.s_pos.detach()
                                           .clone()), out[1]))
        return out

    monkeypatch.setattr(ck, "trace_paths_with_struct", spy)
    step, init = ttrain.make_train_step_fast(sc, W, H, cfg, lr=1e-2)
    params = {"s_pos": pos}
    opt = init(params)
    target = torch.zeros((W * H, 3))
    for _ in range(2):
        params, opt, _ = step(params, opt, sc, target)
    assert len(traced) == 2
    _, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                          sc.cam_pov, W, H, 1)
    org = sc.cam_pos[None, :].expand(dirs.shape[0], 3)
    tmin = sc.cam_pov.expand(dirs.shape[0])
    for s2, rec in traced:
        _, want = trace_paths(s2, org, dirs, tmin, cfg._replace(cull=False),
                              8)
        assert torch.equal(rec, want)
        assert bool((((rec & 0xFFF) == k) & ((rec >> 15) & 1 == 1)).any())


# ---- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["whole", "paths", "emit", "resume"])
@pytest.mark.parametrize("name", ["test01", "test13", "test17", "demo03"])
def test_kernel_culled_equals_unculled_and_plain_on_card(name, mode,
                                                         monkeypatch):
    """Every scene culls here: the gate's floor is lowered to 1."""
    dev = _card()
    monkeypatch.setattr(ck, "CULL_MIN_SURFACES", 1)
    sc = _scene(name, dev)
    struct = ck.scene_struct(sc)
    if struct.can_push and mode != "whole":
        pytest.skip("the path-record and rounds modes need a single-branch "
                    "scene")
    rays = _rays(sc, slice(None), 200, 120)
    on, off = TraceConfig(), TraceConfig(cull=False)
    if mode == "whole":
        runs = [ck.trace_rays_cuda(sc, *rays, c) for c in (on, off)]
        want = trace_rays(sc, *rays, on)
    elif mode == "paths":
        cfg = TraceConfig(max_segments=8, stack=4)
        runs = [torch.cat([BITS(c).T, p]) for c, p in (
            ck.trace_paths(sc, *rays, cfg._replace(cull=x), 8)
            for x in (True, False))]
        c, p = trace_paths(sc, *rays, cfg, 8)
        want = torch.cat([BITS(c).T, p])
    elif mode == "emit":
        def emit(c):
            cols, state = ck.trace_rays_emit_cuda(sc, *rays, c, 4)
            return torch.cat([BITS(cols.T), BITS(state)])
        runs = [emit(c) for c in (on, off)]
        cw, sw = trace_rays_emit(sc, *rays, on, 4)
        want = torch.cat([BITS(cw.T), BITS(sw)])
    else:
        runs, emitted = [], []
        for c in (on, off):
            cols, state = ck.trace_rays_emit_cuda(sc, *rays, c, 4)
            emitted.append((state, cols.clone()))
            idx, count = ck.compact_active(state)
            runs.append(ck.trace_rays_resume_cuda(sc, state, cols, idx, count,
                                                  c, 4))
        want = trace_rays_resume(sc, *emitted[0], on, 4)
    torch.cuda.synchronize()
    assert torch.equal(BITS(runs[0]), BITS(runs[1]))
    assert torch.equal(BITS(runs[0]), BITS(want))
