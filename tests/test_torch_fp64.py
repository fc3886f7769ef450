"""The port's exact metal Fresnel (``fresnel_metal_slow``) and its fp64
tier (``ops.trace.set_element``, the RT_ELEMENT=64 capability,
rtbase.h:331-361) against the JAX package's, on the CPU.

The reference builds the same tracer at fp32 and fp64 (core_make_x64.mk:44
x64f32/x64f64) and cross-compares them; here the plain tracer runs in
either precision. JAX's x64 mode is a process-global flag, so the JAX
f64 render runs in a subprocess, as tests/test_fp64.py does.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadray_tpu.ops.trace import fresnel_metal_slow as j_slow
from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops import trace as T
from quadray_tpu_torch.ops.rays import camera_rays
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
N_PLOT = 800
DOT = -np.cos((1.57 / N_PLOT) * np.arange(N_PLOT, dtype=np.float32))
# the port's f64 tier against JAX's on test01 at 160x96: measured max abs
# 1.5e-15 (the two contract f64 mul/add pairs differently), no pixel flips
F64_VS_JAX = 1e-12

_JAX_F64 = r"""
import os, sys
os.environ["JAX_ENABLE_X64"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from quadray_tpu.models.scenes.loader import load_scene
from quadray_tpu.scene import schema as S
from quadray_tpu.scene.compile import compile_scene
from quadray_tpu.ops import trace as T
from quadray_tpu.ops.rays import camera_rays
sd = load_scene("test01")
sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
org1, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                         sc.cam_pov, 160, 96, 1)
n = dirs.shape[0]
org = jnp.broadcast_to(org1[None, :], (n, 3))
t_min = jnp.full((n,), sc.cam_pov, jnp.float32)
up = lambda a: (a.astype(jnp.float64) if hasattr(a, "dtype")
                and jnp.issubdtype(a.dtype, jnp.floating) else a)
sc64 = jax.tree_util.tree_map(up, sc)
T.set_element(jnp.float64)
cols = T.trace_rays(sc64, org.astype(jnp.float64), dirs.astype(jnp.float64),
                    t_min.astype(jnp.float64), T.TraceConfig(stack=6))
np.save(sys.argv[1], np.asarray(cols))
"""


def closed_metal_slow(cos_i, eta, k2):
    """plot_fresnel_metal_slow C reference (tracer.cpp:5680-5700), as in
    tests/test_fresnel.py."""
    c2 = cos_i * cos_i
    s2 = 1.0 - c2
    t0 = eta * eta - k2 - s2
    a2b2 = np.sqrt(t0 * t0 + 4.0 * eta * eta * k2)
    t1 = a2b2 + c2
    a = np.sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * cos_i
    rs = (t1 - t2) / (t1 + t2)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / (t3 + t4)
    return 0.5 * (rp + rs)


def test_metal_slow_matches_jax_on_a_seeded_grid():
    rng = np.random.default_rng(7)
    dot = -rng.uniform(0.0, 1.0, 4096).astype(np.float32)
    rcp = rng.uniform(0.05, 3.0, 4096).astype(np.float32)
    ext2 = rng.uniform(0.0, 12.0, 4096).astype(np.float32)
    ours = T.fresnel_metal_slow(*(torch.from_numpy(v)
                                  for v in (dot, rcp, ext2))).numpy()
    ref = np.asarray(j_slow(*(jnp.asarray(v) for v in (dot, rcp, ext2))))
    assert ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1e-6


def test_metal_slow_matches_reference_closed_form():
    """The port of tests/test_fresnel.py:58."""
    eta, k = 0.27, 2.77          # gold, the reference's plot constants
    ours = T.fresnel_metal_slow(torch.from_numpy(DOT),
                                torch.tensor(eta, dtype=torch.float32),
                                torch.tensor(k * k, dtype=torch.float32))
    ref = closed_metal_slow(-DOT.astype(np.float64), eta, k * k)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_metal_fast_vs_slow_agree():
    """The port of tests/test_fresnel.py:66: the fast approximation tracks
    the exact conductor formula, both rising to ~1 at grazing."""
    eta = torch.tensor(0.27, dtype=torch.float32)
    k2 = torch.tensor(2.77 * 2.77, dtype=torch.float32)
    dot = torch.from_numpy(DOT)
    fast = T.fresnel_metal_fast(dot, eta, k2).numpy()
    slow = T.fresnel_metal_slow(dot, eta, k2).numpy()
    assert np.max(np.abs(fast - slow)) < 0.05
    assert fast[-1] > 0.98 and slow[-1] > 0.98


def _test01(w, h):
    sd = load_scene("test01")
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device="cpu")
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, w, h, 1)
    return sc, org, dirs, sc.cam_pov.expand(dirs.shape[0])


def _f64(fn, *args):
    T.set_element(F64)
    try:
        return fn(*args)
    finally:
        T.set_element(torch.float32)


def test_fp64_tier_against_f32(tmp_path):
    """test01 at 160x96, TraceConfig(stack=6), as tests/test_fp64.py: the
    f64 render agrees with the f32 one to f32 accuracy, the f32 bits do
    not move across a set_element round trip, and the f64 render agrees
    with the JAX package's f64 render (subprocess, JAX_ENABLE_X64=1)."""
    out = str(tmp_path / "jax64.npy")
    env = dict(os.environ, JAX_ENABLE_X64="1")
    env.pop("JAX_PLATFORMS", None)
    jax64 = subprocess.Popen([sys.executable, "-c", _JAX_F64, out],
                             cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        sc, org, dirs, tmin = _test01(160, 96)
        cfg = T.TraceConfig(stack=6)
        cols32 = T.trace_rays(sc, org, dirs, tmin, cfg)
        sc64 = T.scene_astype(sc, F64)
        assert sc64.s_pos.dtype == F64 and sc64.s_kind.dtype == torch.int32
        assert sc64.tex_data.dtype == F64
        cols64 = _f64(T.trace_rays, sc64, org.double(), dirs.double(),
                      tmin.double(), cfg)
        assert cols32.dtype == torch.float32 and cols64.dtype == F64
        assert (cols64 - cols32.double()).abs().max() < 2e-3
        assert torch.equal(T.trace_rays(sc, org, dirs, tmin, cfg), cols32)
        _, err = jax64.communicate(timeout=600)
    finally:
        jax64.kill()
    assert jax64.returncode == 0, err[-2000:]
    ref = np.load(out)
    assert ref.dtype == np.float64
    assert np.abs(cols64.numpy() - ref).max() <= F64_VS_JAX


def test_fp64_unit_sphere_root():
    """A unit sphere at the origin, a ray from (0.1, 0.2, -3) along +z:
    the f64 intersect's t is float64 and within 1e-12 of 3 - sqrt(1 -
    0.01 - 0.04) for the same f64 inputs, and no farther from its exact
    root than the f32 intersect from its own."""
    sdef = S.SceneDef(root=S.Array(objects=[
        S.obj(S.Sphere(rad=1.0)), S.obj(S.Camera(), pos=(0.0, -5.0, 0.0))]))
    sc = compile_scene(sdef, device="cpu")
    errs = []
    for dt in (torch.float32, F64):
        org = torch.tensor([[0.1, 0.2, -3.0]], dtype=dt)
        d = torch.tensor([[0.0, 0.0, 1.0]], dtype=dt)
        args = (T.scene_astype(sc, dt), org, d, torch.zeros(1, dtype=dt),
                torch.full((1,), 1e30, dtype=dt),
                torch.full((1,), -1, dtype=torch.int32),
                torch.ones(1, dtype=torch.int32),
                torch.zeros(1, dtype=torch.bool))
        h = T.intersect(*args) if dt == torch.float32 else \
            _f64(T.intersect, *args)
        assert h["t"].dtype == dt and bool(h["hit"][0])
        ox, oy, oz = (float(v) for v in org[0])
        errs.append(abs(float(h["t"][0]) - (-oz - math.sqrt(
            1.0 - ox * ox - oy * oy))))
    assert errs[1] <= 1e-12 and errs[1] <= errs[0]


def test_kernel_wrappers_refuse_f64():
    """The CUDA wrappers stay f32: the packer refuses an f64 scene and the
    tensor check f64 rays, with ValueError, before any launch; the
    two-round modes are f32 only."""
    sc, org, dirs, tmin = _test01(16, 8)
    sc64 = T.scene_astype(sc, F64)
    with pytest.raises(ValueError, match="f32"):
        ck.pack_scene(sc64, ck.scene_struct(sc64))
    with pytest.raises(ValueError, match="float32"):
        ck._check("org", org.double(), torch.float32, tuple(org.shape),
                  org.device)
    with pytest.raises(ValueError, match="f32"):
        _f64(T.trace_rays_emit, sc64, org.double(), dirs.double(),
             tmin.double(), T.TraceConfig(), 1)
    with pytest.raises(ValueError, match="float32 or float64"):
        T.set_element(torch.float16)
    assert T.ELEMENT == T.F32 == torch.float32
