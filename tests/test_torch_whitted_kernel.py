"""The host side of the main path's Whitted kernel (``csrc/whitted.cu``
``whole_kernel``, launched by ``whitted_launch`` from ``ops/cuda_kernel.py``
``trace_rays_cuda``): the instantiation ``whitted_launch`` picks for each of
the 21 golden scenes, and on either side of ``WHOLE_OWN_MAX_RAYS``; the
wrapper's launch arguments through a stood-in library on meta tensors; the
C entry point against ``ARGTYPES``; the plain tracer with per-ray masks
after the camera segment (the kernel's ``OWN`` instantiation) bitwise the
plain tracer without them, testing no more surfaces, and within the port's
bound of the JAX package's ``trace_rays``. On the card: every
instantiation bitwise the plain version at the edges of the grid and of a
ragged warp, launches on either side of ``WHOLE_OWN_MAX_RAYS``, and two
launches bitwise equal.

JAX is imported inside the one test that needs it: the card's tests run
on a GPU machine without it:
    python -m pytest tests/test_torch_whitted_kernel.py --noconftest -q -m cuda
"""

import contextlib
import ctypes
import os
import re
import types

import numpy as np
import pytest
import torch

from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.trace import TraceConfig, trace_rays
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "quadray_tpu_torch", "csrc", "whitted.cu")
GOLDEN = [f"test{i:02d}" for i in range(1, 19)] + ["demo01", "demo02",
                                                    "demo03"]
# a ragged warp's and the grid's edges: one ray, a warp less one, a warp
# and one more, 128 warps and one more ray, an 800x480 frame and one more
FRAME = 800 * 480
EDGES = (1, 31, 33, 4097, FRAME + 1)
# per-ray masks where the warp's keep more than this many surfaces (0:
# every culled segment after the camera's), and never (more than any
# scene has)
OWN_ON, OWN_OFF = 0, 1 << 20
# the port's plain tracer against the JAX jnp tracer, whose jitted mul/add
# XLA contracts into FMAs on the CPU: tests/test_torch_trace.py's bound
# (measured on test18 at 64x40: 3.53e-6, which ROADMAP section 3 rounds
# to 3.5e-6)
JAX_ATOL = 1e-5
BITS = lambda t: t.contiguous().view(torch.int32)


def _scene(name, device="cpu"):
    sd = load_scene(name)
    return compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         device=device)


def _source():
    with open(SRC) as fh:
        return fh.read()


def _rays(sc, w, h):
    from quadray_tpu_torch.ops.rays import camera_rays
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, w, h, 1)
    return org, dirs, sc.cam_pov.expand(dirs.shape[0])


# ---- the instantiation ------------------------------------------------------

# the instantiation whitted_launch runs for each scene's frame at the
# default TraceConfig: (can_push, cull, own)
WANT_INSTANCE = {
    **{n: (False, False, False) for n in (
        "test01", "test02", "test04", "test05", "test06", "test07",
        "test08", "test09", "test15")},
    **{n: (False, True, False) for n in (
        "test03", "test10", "test11", "test12", "demo01")},
    **{n: (False, True, True) for n in (
        "test13", "test14", "test16", "demo02", "demo03")},
    "test17": (True, False, False), "test18": (True, False, False),
}


def _instance(name, n):
    got = ck.whitted_instance(ck.scene_struct(_scene(name)), TraceConfig(), n)
    return got["can_push"], got["cull"], got["own"]


@pytest.mark.parametrize("name", list(WANT_INSTANCE))
def test_instance_of_each_scene(name):
    """A frame of each golden scene runs the expected instantiation: culled
    where the gate culls, with per-ray masks above EMIT_OWN_MIN_KEPT
    surfaces."""
    assert _instance(name, FRAME) == WANT_INSTANCE[name]


@pytest.mark.parametrize("name", [n for n, w in WANT_INSTANCE.items()
                                  if w[2]])
def test_per_ray_masks_stop_above_the_most_rays(name):
    """The scenes whose frames take per-ray masks take them in a launch of
    WHOLE_OWN_MAX_RAYS rays (four frames), and not in one ray more."""
    assert ck.WHOLE_OWN_MAX_RAYS == 4 * FRAME
    assert _instance(name, ck.WHOLE_OWN_MAX_RAYS)[2]
    assert _instance(name, ck.WHOLE_OWN_MAX_RAYS + 1) == (False, True, False)


# ---- the wrapper's launch -------------------------------------------------------

@pytest.mark.parametrize("cull", [True, False])
def test_whitted_launch_arguments(cull, monkeypatch):
    """The ctypes call of trace_rays_cuda, with the library, the device
    and the stream stood in for (meta tensors take the launch path): the
    bound argument count; after the stream, coop_max, the per-ray masks'
    floor and their most rays, Schlick's flag (0) and no stack scratch
    (test13 cannot push); the culling gates; no scratch but the output;
    one launch counted."""
    sc = _scene("test13")
    struct = ck.scene_struct(sc)
    calls, scratch = [], []
    fake = types.SimpleNamespace(
        whitted_launch=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(ck, "_lib", lambda: fake)
    monkeypatch.setattr(ck, "_launch_inputs", lambda fn, sc, org, dirs, t,
                        struct, ps: (torch.zeros((7, dirs.shape[0])),
                                     (0,) * 12 + (struct.ns,)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=1234))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: scratch.append(
        (a, k)) or empty(*a, **k))
    meta = lambda *s: empty(s, device="meta")
    cfg = TraceConfig(cull=cull)
    before = ck.launches
    cols = ck.trace_rays_cuda(sc, meta(3), meta(64, 3), meta(64), cfg)
    (args,) = calls
    assert len(args) == len(ck.ARGTYPES["whitted_launch"])
    flags = ck.cull_gates(struct, cfg).flags
    assert (flags != 0) == cull
    assert args[-7:] == (flags, 1234, ck.COOP_MAX_LIVE, ck.EMIT_OWN_MIN_KEPT,
                         ck.WHOLE_OWN_MAX_RAYS, 0, None)
    assert [a for a, k in scratch] == [((3, 64),)]
    assert tuple(cols.shape) == (64, 3)
    assert ck.launches == before + 1


def test_argtypes_match_the_c_entry_point():
    """ARGTYPES["whitted_launch"] against its extern "C" signature in
    csrc/whitted.cu (the scene tables' macro expanded): a pointer for each
    pointer parameter and the stream, an int for each int, a float for
    each float; coop_max, own_min, own_max, schlick and deep after the
    stream."""
    src = _source()
    scene = re.search(r"#define SCENE_PARAMS\s*\\\s*((?:[^\n]*\\\n)*[^\n]*)",
                      src).group(1).replace("\\\n", " ")
    params = re.search(r'extern "C" int whitted_launch\(([^)]*)\)',
                       src).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[-6:] == ["stream", "coop_max", "own_min", "own_max",
                          "schlick", "deep"]
    params = params.replace("SCENE_PARAMS", scene)
    kinds = ["p" if "*" in p else "f" if "float" in p else "i"
             for p in params.split(",")]
    kind = {ck._VOIDP: "p", ck._INT: "i", ctypes.c_float: "f"}
    assert kinds == [kind[t] for t in ck.ARGTYPES["whitted_launch"]]


# ---- the plain version of the per-ray masks ---------------------------------------

@pytest.mark.parametrize("name", ["test13", "test17"])
def test_plain_per_ray_masks_are_bitwise_and_test_less(name, monkeypatch):
    """The plain tracer with per-ray masks after the camera segment (the
    kernel's OWN instantiation, own_min 0: every culled segment after the
    camera's) bitwise the plain tracer without them at 64x40, culled, on a
    single-branch scene (test13) and on one that pushes branches (test17,
    whose popped branches have no continuation row; the gate's floor is
    lowered so that its 8 surfaces cull), with no more surface tests
    kept, and fewer."""
    monkeypatch.setattr(ck, "CULL_MIN_SURFACES", 1)
    sc = _scene(name)
    assert ck.scene_struct(sc).can_push == (name == "test17")
    rays, cfg = _rays(sc, 64, 40), TraceConfig()
    assert ck.cull_gates(ck.scene_struct(sc), cfg).cull
    s0, s1 = {}, {}
    want = trace_rays(sc, *rays, cfg, s0)
    got = trace_rays(sc, *rays, cfg, s1, own=(1, OWN_ON))
    assert torch.equal(BITS(got), BITS(want))
    assert s1["walks"] == s0["walks"]
    for k in ("nearest_tests_kept", "shadow_tests_kept"):
        assert s1[k] <= s0[k], k
    assert s1["nearest_tests_kept"] + s1["shadow_tests_kept"] \
        < s0["nearest_tests_kept"] + s0["shadow_tests_kept"]


def test_plain_per_ray_masks_match_jax(monkeypatch):
    """The same plain output on test18 at 64x40 (culled: the floor lowered
    to its 8 surfaces, per-ray masks after the camera segment) against the
    JAX package's jnp trace_rays on the same scene tables, within the
    port's bound for the plain tracer (tests/test_torch_trace.py)."""
    import jax.numpy as jnp
    from quadray_tpu.models.scenes.loader import load_scene as jload
    from quadray_tpu.ops.rays import camera_rays as jrays
    from quadray_tpu.ops.trace import TraceConfig as JConfig
    from quadray_tpu.ops.trace import trace_rays as jtrace
    from quadray_tpu.scene import schema as JS
    from quadray_tpu.scene.compile import compile_scene as jcompile
    from quadray_tpu_torch.scene.compile import (FIELDS,
                                                 scene_arrays_from_numpy)
    monkeypatch.setattr(ck, "CULL_MIN_SURFACES", 1)
    sd = jload("test18")
    j = jcompile(JS.SceneDef(root=sd.root, opts=JS.OPTS_FULL & ~sd.opts))
    sc = scene_arrays_from_numpy({k: np.asarray(getattr(j, k))
                                  for k in FIELDS}, device="cpu")
    org, dirs = jrays(j.cam_pos, j.cam_hor, j.cam_ver, j.cam_nrm, j.cam_pov,
                      64, 40, 1)
    tmin = jnp.full((dirs.shape[0],), j.cam_pov, jnp.float32)
    want = np.asarray(jtrace(j, org, dirs, tmin, JConfig()))
    rays = _rays(sc, 64, 40)
    assert np.array_equal(np.asarray(dirs), rays[1].numpy())
    got = trace_rays(sc, *rays, TraceConfig(), own=(1, OWN_ON)).numpy()
    assert np.abs(got - want).max() <= JAX_ATOL


# ---- on the card ------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


# (scene, gate): a single-branch scene and one that pushes branches,
# unculled, and culled with per-ray masks and without: every instantiation
# of whole_kernel runs
CARD_CASES = [(n, g) for n in ("test13", "test18")
              for g in ("unculled", "own", "warp")]


def _gate(monkeypatch, gate):
    """The TraceConfig of a case; culled cases lower the gate's floor to
    1 and pick the per-ray masks' floor."""
    if gate == "unculled":
        return TraceConfig(cull=False)
    monkeypatch.setattr(ck, "CULL_MIN_SURFACES", 1)
    monkeypatch.setattr(ck, "EMIT_OWN_MIN_KEPT",
                        OWN_ON if gate == "own" else OWN_OFF)
    return TraceConfig()


@pytest.mark.cuda
@pytest.mark.parametrize("name, gate", CARD_CASES)
def test_whole_kernel_edges_on_card(name, gate, monkeypatch):
    """Each instantiation at the edge ray counts: the colours bitwise the
    plain trace_rays' (with the kernel's masks where it takes per-ray
    masks), one launch each."""
    dev = _card()
    sc = _scene(name, dev)
    cfg = _gate(monkeypatch, gate)
    struct = ck.scene_struct(sc)
    inst = ck.whitted_instance(struct, cfg, EDGES[-1])
    assert inst["cull"] == (gate != "unculled")
    assert inst["own"] == (gate == "own")
    from chip_smoke import edge_rays
    rays = edge_rays(sc, EDGES[-1])
    want = trace_rays(sc, *rays, cfg,
                      own=(1, ck.EMIT_OWN_MIN_KEPT) if inst["own"] else None)
    org, dirs, tmin = rays
    for n in EDGES:
        before = ck.launches
        got = ck.trace_rays_cuda(sc, org, dirs[:n], tmin[:n], cfg)
        torch.cuda.synchronize()
        assert ck.launches == before + 1
        assert torch.equal(BITS(got), BITS(want[:n])), n


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [4, 5])
def test_whole_kernel_either_side_of_the_most_rays_on_card(frames):
    """test13 culled at the default floor in one launch of four frames'
    rays (per-ray masks) and of five (the warp's masks alone): bitwise the
    plain frame's colours repeated, one launch."""
    dev = _card()
    sc = _scene("test13", dev)
    cfg = TraceConfig()
    n = frames * FRAME
    assert ck.whitted_instance(ck.scene_struct(sc), cfg, n)["own"] \
        == (frames == 4)
    from chip_smoke import edge_rays
    want = trace_rays(sc, *edge_rays(sc, FRAME), cfg)
    before = ck.launches
    got = ck.trace_rays_cuda(sc, *edge_rays(sc, n), cfg)
    torch.cuda.synchronize()
    assert ck.launches == before + 1
    assert torch.equal(BITS(got), BITS(want.repeat(frames, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test01", "test13", "test18", "demo03"])
def test_whole_kernel_two_launches_bitwise_on_card(name):
    dev = _card()
    sc = _scene(name, dev)
    from chip_smoke import edge_rays
    rays = edge_rays(sc, 800 * 480)
    a = ck.trace_rays_cuda(sc, *rays)
    b = ck.trace_rays_cuda(sc, *rays)
    torch.cuda.synchronize()
    assert torch.equal(BITS(a), BITS(b))
