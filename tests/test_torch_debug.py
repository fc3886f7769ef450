"""The port's debug tools (``utils/debug.py``: ``debug_pixel``,
``solver_state``, ``overlay_hit_ids``) against the JAX package's on the
same compiled scenes, on the CPU."""

import numpy as np
import pytest
import torch

from quadray_tpu.models.scenes.loader import load_scene as jload
from quadray_tpu.scene import schema as JS
from quadray_tpu.scene.compile import compile_scene as jcompile
from quadray_tpu.utils import debug as jd
from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import compile_scene
from quadray_tpu_torch.utils import debug as td

torch.set_num_threads(1)

W, H = 64, 40
EXACT = ("srf", "side", "hit", "depth", "thru", "osrf", "sp")
# f32 values of the same loop; XLA contracts the JAX tracer's mul/add
# pairs into FMAs on the CPU (tests/test_torch_trace.py: within 3.5e-6)
TOL = 1e-5


def _scenes(name):
    sd, jsd = load_scene(name), jload(name)
    return (compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                          device="cpu"),
            jcompile(JS.SceneDef(root=jsd.root,
                                 opts=JS.OPTS_FULL & ~jsd.opts)))


@pytest.mark.parametrize("name", ["test01", "test17"])
def test_debug_pixel_matches_jax(name):
    """Pixel (32, 20): test01 (clip programs), test17 (Fresnel glass: the
    branch stack pushes and pops)."""
    ours, ref = _scenes(name)
    logged = []
    a = td.debug_pixel(ours, 32, 20, W, H, log=logged.append)
    b = jd.debug_pixel(ref, 32, 20, W, H)
    assert len(a) == len(b) and len(a) >= 3
    assert a[-1]["segment"] == "final" and len(logged) == len(a)
    assert a[0]["hit"] and a[0]["srf"] >= 0
    if name == "test17":
        assert max(r["sp"] for r in a[:-1]) > 0   # a branch was pushed
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in EXACT:
            if k in rb:
                assert ra[k] == rb[k], (name, ra["segment"], k)
        if "t" in rb:
            assert ra["t"] == rb["t"] or abs(ra["t"] - rb["t"]) <= TOL
            np.testing.assert_allclose(ra["thr"], rb["thr"], rtol=0,
                                       atol=TOL)
            np.testing.assert_allclose(ra["x"], rb["x"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ra["acc"], rb["acc"], rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["test01", "test17"])
def test_solver_state_and_overlay_match_jax(name):
    ours, ref = _scenes(name)
    for org, d in (((0.0, -10.0, 1.0), (0.0, 1.0, 0.0)),
                   ((0.3, -7.0, 2.0), (0.1, 0.9, -0.2))):
        a = td.solver_state(ours, org, d)
        b = jd.solver_state(ref, org, d)
        assert a and [(r["srf"], r["kind"]) for r in a] == \
            [(r["srf"], r["kind"]) for r in b]
        for ra, rb in zip(a, b):
            for k in ("a", "b", "c", "disc"):
                assert abs(ra[k] - rb[k]) <= TOL * max(1.0, abs(rb[k])), k
    a = td.overlay_hit_ids(ours, W, H)
    b = jd.overlay_hit_ids(ref, W, H)
    assert a.shape == (H, W, 3) and a.dtype == np.uint8 and a.max() > 0
    assert (a != b).any(-1).mean() <= 0.005


def test_debug_tools_follow_the_element_type():
    """After set_element(torch.float64), on the upcast scene, the tools
    trace in float64: the same path and surfaces as in float32, its
    values within f32 accuracy of the f32 ones, and the solver's
    coefficients not the f32 ones."""
    from quadray_tpu_torch.ops import trace as T
    ours, _ = _scenes("test17")
    f32 = (td.debug_pixel(ours, 32, 20, W, H),
           td.solver_state(ours, (0.3, -7.0, 2.0), (0.1, 0.9, -0.2)),
           td.overlay_hit_ids(ours, W, H))
    T.set_element(torch.float64)
    try:
        sc64 = T.scene_astype(ours, torch.float64)
        assert td._vec((0.3, -7.0, 2.0), "cpu").dtype == torch.float64
        f64 = (td.debug_pixel(sc64, 32, 20, W, H),
               td.solver_state(sc64, (0.3, -7.0, 2.0), (0.1, 0.9, -0.2)),
               td.overlay_hit_ids(sc64, W, H))
    finally:
        T.set_element(torch.float32)
    assert len(f64[0]) == len(f32[0])
    for ra, rb in zip(f64[0], f32[0]):
        for k in EXACT:
            if k in rb:
                assert ra[k] == rb[k], (ra["segment"], k)
        if "t" in rb:
            assert abs(ra["t"] - rb["t"]) <= 1e-4 * max(1.0, abs(rb["t"]))
        np.testing.assert_allclose(ra["acc"], rb["acc"], rtol=0, atol=1e-4)
    diff = 0
    for ra, rb in zip(f64[1], f32[1]):
        for k in ("a", "b", "c", "disc"):
            assert abs(ra[k] - rb[k]) <= 1e-4 * max(1.0, abs(rb[k])), k
            diff += ra[k] != rb[k]
    assert diff > 0
    assert (f64[2] != f32[2]).any(-1).mean() <= 0.005
