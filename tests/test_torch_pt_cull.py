"""Culling in the path tracer: the plain ``trace_pt`` culled against
unculled (bitwise) and against the JAX jnp ``trace_pt``, the per-ray
reach predicate (``ops/trace.py`` ``ray_reach``), PT's gate, and on the
card the PT kernel culled against unculled and plain.

JAX is imported inside the test that uses it, so the card's tests run on
a GPU machine without it:
    python -m pytest tests/test_torch_pt_cull.py --noconftest -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops import pt as tpt
from quadray_tpu_torch.ops.trace import TraceConfig, ray_reach
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import FIELDS, compile_scene

torch.set_num_threads(1)

DEPTH = 10
# tests/test_torch_pt.py's bar against the jnp estimator run op by op
ATOL = 2e-4
W, H = 64, 40
# a band of rows of the 64x40 frame
ROWS = slice(18 * W, 22 * W)
BITS = lambda t: t.contiguous().view(torch.int32)


def _emission(sc, seed):
    """chip_smoke.py's seeded emission in [0, 0.5) on both sides of every
    real surface, as numpy f32: every node's radiance then shows."""
    e = np.random.default_rng(seed).uniform(
        0.0, 0.5, tuple(sc.s_emis.shape)).astype(np.float32)
    return e * (sc.s_kind.cpu().numpy() > 0)[:, None, None]


def _scene(name, seed=None, device="cpu"):
    sd = load_scene(name)
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device=device)
    if seed is not None:
        sc = dataclasses.replace(sc, s_emis=sc.s_emis + torch.from_numpy(
            _emission(sc, seed)).to(device))
    return sc


def _inputs(sc, w, h, rows=slice(None)):
    dev = sc.device
    org, dirs, seeds = tpt.pt_camera_rays(sc, w, h,
                                          tpt.init_seeds(w * h, device=dev))
    dirs, seeds = dirs[rows].contiguous(), seeds[rows].contiguous()
    return org, dirs, sc.cam_pov.expand(dirs.shape[0]), seeds


@pytest.mark.parametrize("name,seed", [("test13", 13), ("demo03", 3),
                                       ("test18", None)])
def test_plain_pt_cull_is_bitwise_neutral(name, seed, monkeypatch):
    """The culled plain pass drops the hits of every surface its rays'
    masks skip: radiance and seeds bitwise the unculled pass's, and the
    masks do skip tests. test18 (8 surfaces, under the gate's floor)
    culls with the floor lowered."""
    monkeypatch.setattr(ck, "PT_CULL_MIN_SURFACES", 1)
    sc = _scene(name, seed)
    rays = _inputs(sc, W, H, ROWS)
    struct = ck.scene_struct(sc)
    assert ck.cull_gates(struct, TraceConfig(), pt=True).cull
    stats = {}
    a = tpt.trace_pt(sc, *rays, TraceConfig(depth=DEPTH), stats)
    b = tpt.trace_pt(sc, *rays, TraceConfig(depth=DEPTH, cull=False))
    assert torch.equal(BITS(a[0]), BITS(b[0])) and torch.equal(a[1], b[1])
    assert float(a[0].amax(dim=1).gt(0).float().mean()) > 0.05
    kept, culled = stats["nearest_tests_kept"], stats["nearest_tests_culled"]
    assert kept + culled == stats["walks"] * struct.n_real
    # measured 94% (test13), 97% (demo03), 37% (test18)
    assert culled > (0.3 if name == "test18" else 0.8) * (kept + culled)


def test_plain_culled_pt_matches_jnp_test03(monkeypatch):
    """test03 (9 surfaces, under PT's floor: the floor is lowered),
    culled: the plain pass against the JAX jnp trace_pt run op by op
    (jax.disable_jit, IEEE f32 without contraction) at 48x32, both with
    the same seeded emission: seeds bitwise, radiance within
    tests/test_torch_pt.py's 2e-4."""
    import jax
    import jax.numpy as jnp
    from quadray_tpu.ops import pt as jpt
    from quadray_tpu.ops.trace import TraceConfig as JConfig
    from quadray_tpu.scene.compile import SceneArrays
    t = _scene("test03", 3)
    struct = ck.scene_struct(t)
    assert struct.n_real < ck.PT_CULL_MIN_SURFACES
    assert not ck.cull_gates(struct, TraceConfig(), pt=True).cull
    monkeypatch.setattr(ck, "PT_CULL_MIN_SURFACES", 1)
    assert ck.cull_gates(struct, TraceConfig(), pt=True).cull
    j = SceneArrays(**{k: jnp.asarray(getattr(t, k).numpy()) for k in FIELDS})
    org, dirs, tmin, seeds = _inputs(t, 48, 32)
    stats = {}
    rad, out = tpt.trace_pt(t, org, dirs, tmin, seeds,
                            TraceConfig(depth=DEPTH), stats)
    assert stats["nearest_tests_culled"] > 0
    with jax.disable_jit():
        jr, js = jpt.trace_pt(j, jnp.asarray(org.numpy()),
                              jnp.asarray(dirs.numpy()),
                              jnp.asarray(tmin.numpy()),
                              jnp.asarray(seeds.numpy().view(np.uint32)),
                              JConfig(depth=DEPTH))
    assert np.array_equal(np.asarray(js), out.numpy().view(np.uint32))
    assert np.abs(np.asarray(jr) - rad.numpy()).max() <= ATOL
    assert float(rad.amax(dim=1).gt(0).float().mean()) > 0.25


def test_cull_gates_pt():
    """PT's gate: reach only (no lsort, no cont: no shadow pass, and a
    popped sibling does not come from the previous hit), PT's floor, off
    for cull=False, without bounding spheres and above MAX_SURFACES."""
    gates = ck.cull_gates
    cfg = TraceConfig()
    for name in ("test13", "demo03", "test17"):
        struct = ck.scene_struct(_scene(name))
        want = struct.n_real >= ck.PT_CULL_MIN_SURFACES
        assert gates(struct, cfg, pt=True) == (want, False, False), name
        assert gates(struct, cfg, pt=True).flags == int(want)
        assert gates(struct, cfg._replace(cull=False), pt=True).flags == 0
        assert gates(struct._replace(bnd=(0,) * len(struct.bnd)), cfg,
                     pt=True) == (False, False, False)
    struct = ck.scene_struct(_scene("test13"))
    assert gates(struct, cfg) == (True, True, True)   # the Whitted modes
    g0 = struct.groups[0]
    big = struct._replace(groups=(g0._replace(count=ck.MAX_SURFACES + 1),))
    assert gates(big, cfg, pt=True) == (False, False, False)
    at = big._replace(groups=(g0._replace(count=ck.MAX_SURFACES),))
    assert gates(at, cfg, pt=True) == (True, False, False)


def _ray(data):
    """One ray: an origin within +-10 (or +-1000), a direction of any
    length from 0.01 to 100."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    scale = data.draw(st.sampled_from([10.0, 1000.0]))
    o = rng.uniform(-scale, scale, 3)
    d = rng.normal(size=3)
    d = d / max(np.linalg.norm(d), 1e-3) * data.draw(st.floats(0.01, 100.0))
    return (torch.tensor(o[None], dtype=torch.float32),
            torch.tensor(d[None], dtype=torch.float32))


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(data=st.data())
def test_ray_reach_keeps_every_sphere_a_ray_meets(data):
    """A sphere that the ray passes through is reached: its centre lies
    within its radius of a point o + t d, t >= 0 (t up to far beyond the
    scenes' extent, the radius from 0 to large)."""
    o, d = _ray(data)
    t = data.draw(st.floats(0.0, 50.0))
    rad = data.draw(st.floats(0.0, 30.0))
    u = torch.tensor(data.draw(st.tuples(*[st.floats(-1.0, 1.0)] * 3)),
                     dtype=torch.float64)
    u = u / max(float(u.norm()), 1e-9) * rad * 0.99
    c = o[0].double() + t * d[0].double() + u
    spheres = torch.tensor([[c[0]], [c[1]], [c[2]], [rad]],
                           dtype=torch.float32)
    assert bool(ray_reach(o, d, spheres)[0, 0])


def test_ray_reach_says_reach_for_nan_and_inf():
    """NaN in a sphere, an unbounded sphere (radius +inf) and NaN or inf in
    the ray all come out as "reach"; a sphere behind the ray or off its
    line does not."""
    g = torch.Generator().manual_seed(7)
    o = torch.rand((4, 3), generator=g)
    d = torch.rand((4, 3), generator=g) + 0.1
    far = torch.tensor([[-1e6], [-1e6], [-1e6], [1.0]])   # behind the rays
    side = torch.tensor([[1e3], [-1e3], [0.0], [1.0]])    # off their lines
    for s in (far, side):
        assert not bool(ray_reach(o, d, s).any())
    for k in range(4):
        s = far.clone()
        s[k, 0] = float("nan")
        assert bool(ray_reach(o, d, s).all()), k
    s = far.clone()
    s[3, 0] = float("inf")
    assert bool(ray_reach(o, d, s).all())
    for bad in (float("nan"), float("inf"), -float("inf")):
        for which in ("o", "d"):
            o2, d2 = o.clone(), d.clone()
            (o2 if which == "o" else d2)[1, 2] = bad
            assert bool(ray_reach(o2, d2, far)[1, 0]), (bad, which)


# ---- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,seed", [("test13", 13), ("demo03", 3),
                                       ("test03", 3), ("test18", None)])
def test_pt_kernel_culled_equals_unculled_and_plain_on_card(name, seed,
                                                            monkeypatch):
    """The PT kernel culled against unculled, bitwise (radiance and
    seeds), and against the culled plain pass on the card (seeds equal,
    radiance within 1e-5), at 200x120; every scene culls here: the PT
    floor is lowered to 1."""
    dev = _card()
    monkeypatch.setattr(ck, "PT_CULL_MIN_SURFACES", 1)
    sc = _scene(name, seed, dev)
    rays = _inputs(sc, 200, 120)
    on = TraceConfig(depth=DEPTH)
    assert ck.cull_gates(ck.scene_struct(sc), on, pt=True).flags == 1
    before = ck.pt_launches
    cr, cs = ck.trace_pt_cuda(sc, *rays, on)
    ur, us = ck.trace_pt_cuda(sc, *rays, on._replace(cull=False))
    assert ck.pt_launches == before + 2
    pr, ps = tpt.trace_pt(sc, *rays, on)
    torch.cuda.synchronize()
    assert torch.equal(BITS(cr), BITS(ur)) and torch.equal(cs, us)
    assert torch.equal(cs, ps)
    assert float((cr - pr).abs().max()) <= 1e-5
