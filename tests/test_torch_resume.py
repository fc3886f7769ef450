"""The two-round retirement kernels' per-ray masks and RESUME's two modes
(``csrc/whitted.cu``: after the camera segment EMIT refines a warp's wide
mask by each ray's own tests; RESUME runs a warp per surviving ray when
few survive, ``resume_sparse``, and a thread per ray with per-ray masks
when many do).

On the CPU: the shadow segment's sphere test (``ops/trace.py``
``seg_reach``) against an f64 brute-force segment-sphere distance; the
plain emit and resume, whose masks are now the kernel's per-ray ones
(``Cull`` with ``own``), bitwise equal to the unculled plain rounds;
RESUME's switch (``resume_warp_max``, from ``cuda_kernel.RESUME_WARP_MAX``)
and how the wrappers pass it and the per-ray masks' thresholds
(``EMIT_OWN_MIN_KEPT``, ``RESUME_OWN_MIN_KEPT``, which the plain versions
read too) to the launch. On the card: RESUME forced sparse and forced
dense (RESUME_WARP_MAX set to the ray count and to 0) and at its default,
EMIT at k1 = 1 and 4, bitwise against the plain versions, and the switch
out of range raising.

JAX is not imported, so the card's tests run on a GPU machine without it:
    python -m pytest tests/test_torch_resume.py --noconftest -q -m cuda
"""

import contextlib
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.rays import camera_rays
from quadray_tpu_torch.ops.trace import (
    ACTIVE_ROW, TraceConfig, seg_reach, trace_rays, trace_rays_emit,
    trace_rays_resume)
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(1)

W, H = 64, 40
# a band of 8 rows of the 64x40 frame, whole warps of the frame's own:
# test13 keeps rays alive past 4 segments in rows 31 and 38 only, test14
# and demo03 (the same rays) keep 77% of the band's rays after 1 and none
# after 4
ROWS = slice(31 * W, 39 * W)
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


# ---- the shadow segment's sphere test -----------------------------------------

def _segment(data):
    """One shadow ray: an origin within +-10 (or +-1000), a segment of any
    length from 0.01 to 100."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    scale = data.draw(st.sampled_from([10.0, 1000.0]))
    o = rng.uniform(-scale, scale, 3)
    d = rng.normal(size=3)
    d = d / max(np.linalg.norm(d), 1e-3) * data.draw(st.floats(0.01, 100.0))
    return (torch.tensor(o[None], dtype=torch.float32),
            torch.tensor(d[None], dtype=torch.float32))


def _seg_dist(o, d, c):
    """f64 distance from c to the segment o + t d, t in [0, 1]."""
    o, d, c = (np.asarray(v, np.float64).reshape(3) for v in (o, d, c))
    t = np.clip(np.dot(c - o, d) / max(np.dot(d, d), 1e-300), 0.0, 1.0)
    return float(np.linalg.norm(c - (o + t * d)))


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(data=st.data())
def test_seg_reach_keeps_every_sphere_a_segment_meets(data):
    """A sphere whose centre lies within its radius of the segment (the
    f64 distance, the f32 inputs taken exactly) is reached: centres near a
    point o + t d with t from before the origin to past the light, radii
    from 0 to large."""
    o, d = _segment(data)
    t = data.draw(st.floats(-0.5, 1.5))
    rad = data.draw(st.floats(0.0, 30.0))
    u = np.array(data.draw(st.tuples(*[st.floats(-1.0, 1.0)] * 3)))
    u = u / max(float(np.linalg.norm(u)), 1e-9) * rad * data.draw(
        st.floats(0.0, 1.2))
    c = o[0].double().numpy() + t * d[0].double().numpy() + u
    spheres = torch.tensor([[c[0]], [c[1]], [c[2]], [rad]],
                           dtype=torch.float32)
    cf = spheres[:3, 0].double().numpy()
    if _seg_dist(o[0].numpy(), d[0].numpy(), cf) <= float(spheres[3, 0]):
        assert bool(seg_reach(o, d, spheres)[0, 0])


def test_seg_reach_says_reach_for_nan_and_inf():
    """NaN in a sphere, an unbounded sphere (radius +inf) and NaN or inf in
    the segment all come out as "reach"; a sphere behind the origin, past
    the light or off the segment does not."""
    g = torch.Generator().manual_seed(7)
    o = torch.rand((4, 3), generator=g)
    d = torch.rand((4, 3), generator=g) + 0.1
    behind = torch.tensor([[-1e3], [-1e3], [-1e3], [1.0]])
    past = torch.tensor([[1e3], [1e3], [1e3], [1.0]])     # beyond o + d
    side = torch.tensor([[1e3], [-1e3], [0.0], [1.0]])
    for s in (behind, past, side):
        assert not bool(seg_reach(o, d, s).any())
    for k in range(4):
        s = past.clone()
        s[k, 0] = float("nan")
        assert bool(seg_reach(o, d, s).all()), k
    s = past.clone()
    s[3, 0] = float("inf")
    assert bool(seg_reach(o, d, s).all())
    for bad in (float("nan"), float("inf"), -float("inf")):
        for which in ("o", "d"):
            o2, d2 = o.clone(), d.clone()
            (o2 if which == "o" else d2)[1, 2] = bad
            assert bool(seg_reach(o2, d2, past)[1, 0]), (bad, which)


def test_seg_reach_is_the_segment_not_the_line():
    """A sphere on the segment's line but past the light (t = 2) is not
    reached, one at t = 0.5 is; the zero segment reaches only the spheres
    around its origin."""
    o = torch.zeros((1, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]])
    s = torch.tensor([[2.0, 0.5], [0.0, 0.0], [0.0, 0.0], [0.1, 0.1]])
    assert seg_reach(o, d, s).tolist() == [[False, True]]
    near = torch.tensor([[0.05, 3.0], [0.0, 0.0], [0.0, 0.0], [0.1, 0.1]])
    assert seg_reach(o, torch.zeros((1, 3)), near).tolist() == [[True, False]]


# ---- the plain rounds with per-ray masks ---------------------------------------

@pytest.mark.parametrize("k1", [1, 4])
@pytest.mark.parametrize("name", ["test13", "demo03", "test14"])
def test_plain_rounds_with_own_masks_are_bitwise_unculled(name, k1):
    """Emit (the warp's masks for the camera segment, per-ray masks after
    it) and resume (per-ray masks) give the unculled rounds' bits:
    colours, all 21 state rows, the resumed colours, which are trace_rays's;
    the masks skip tests, and every count covers every walk."""
    sc = _scene(name)
    rays = _rays(sc)
    on, off = TraceConfig(), TraceConfig(cull=False)
    assert ck.cull_gates(ck.scene_struct(sc), on).cont
    se, sr = {}, {}
    ca, sa = trace_rays_emit(sc, *rays, on, k1, se)
    cb, sb = trace_rays_emit(sc, *rays, off, k1)
    assert torch.equal(BITS(ca), BITS(cb)) and torch.equal(BITS(sa), BITS(sb))
    alive = int((BITS(sa[ACTIVE_ROW]) != 0).sum())
    assert alive > 0 or (k1 == 4 and name != "test13")
    ra = trace_rays_resume(sc, sa, ca, on, k1, sr)
    rb = trace_rays_resume(sc, sb, cb, off, k1)
    assert torch.equal(BITS(ra), BITS(rb))
    if name == "test13":
        assert torch.equal(BITS(ra), BITS(trace_rays(sc, *rays, on)))
    n = ck.scene_struct(sc).n_real
    for stats in (se, sr) if alive else (se,):
        assert stats["nearest_tests_kept"] + stats["nearest_tests_culled"] \
            == stats["walks"] * n
        assert stats["nearest_tests_culled"] > 0.2 * stats[
            "nearest_tests_kept"]
        assert stats["shadow_tests_culled"] > 0


def test_own_masks_after_the_camera_segment_keep_fewer_tests(monkeypatch):
    """After the first hit a bundle of 32 rays keeps more of the scene than
    its rays do each: on test14's band (152 surfaces) the per-ray masks of
    emit's segments 1-3 keep fewer nearest and shadow tests than the
    warp's masks there (EMIT_OWN_MIN_KEPT raised to the surface count, so
    that no mask is refined), for the same output bits."""
    sc = _scene("test14")
    rays = _rays(sc, slice(31 * W, 35 * W))
    own, warp = {}, {}
    ca, sa = trace_rays_emit(sc, *rays, TraceConfig(), 4, own)
    monkeypatch.setattr(ck, "EMIT_OWN_MIN_KEPT",
                        ck.scene_struct(sc).n_real)
    cb, sb = trace_rays_emit(sc, *rays, TraceConfig(), 4, warp)
    assert torch.equal(BITS(ca), BITS(cb)) and torch.equal(BITS(sa), BITS(sb))
    assert own["walks"] == warp["walks"]
    for k in ("nearest_tests_kept", "shadow_tests_kept"):
        assert own[k] < warp[k], k


@pytest.mark.parametrize("name", ["test06", "test08"])
def test_plain_rounds_ignore_warp_max(name, monkeypatch):
    """trace_rays_rounds on CPU tensors (the plain versions) gives the same
    bits at every valid RESUME_WARP_MAX; the switch is checked all the
    same."""
    sc = _scene(name)
    rays = _rays(sc, slice(0, 4 * W))
    n = rays[1].shape[0]
    want = trace_rays(sc, *rays, TraceConfig())
    for wm in (ck.RESUME_WARP_MAX, 0, 1, n, n + 1):
        monkeypatch.setattr(ck, "RESUME_WARP_MAX", wm)
        got = ck.trace_rays_rounds(sc, *rays, TraceConfig(), 1)
        assert torch.equal(BITS(got), BITS(want)), wm
    monkeypatch.setattr(ck, "RESUME_WARP_MAX", -1)
    with pytest.raises(ValueError):
        ck.trace_rays_rounds(sc, *rays, TraceConfig(), 1)


# ---- the launch's switch --------------------------------------------------------

def test_resume_warp_max(monkeypatch):
    """RESUME_WARP_MAX at most the ray count (0: a thread each always; the
    ray count or more: a warp each always), never negative; 0 for a scene
    of more surfaces than the one-ray masks' words hold. The per-ray
    masks' thresholds are never negative either."""
    struct = ck.scene_struct(_scene("test13"))
    assert ck.resume_warp_max(struct, 10**6) == ck.RESUME_WARP_MAX > 0
    assert ck.resume_warp_max(struct, 100) == 100
    for wm, want in ((0, 0), (100, 100), (101, 100), (37, 37)):
        monkeypatch.setattr(ck, "RESUME_WARP_MAX", wm)
        assert ck.resume_warp_max(struct, 100) == want
    big = types.SimpleNamespace(n_real=ck.MAX_SURFACES + 1)
    assert ck.resume_warp_max(big, 10**6) == 0
    monkeypatch.setattr(ck, "RESUME_WARP_MAX", -1)
    with pytest.raises(ValueError):
        ck.resume_warp_max(struct, 100)
    monkeypatch.undo()
    assert ck.EMIT_OWN_MIN_KEPT >= 0 and ck.RESUME_OWN_MIN_KEPT >= 0
    for name in ("EMIT_OWN_MIN_KEPT", "RESUME_OWN_MIN_KEPT"):
        monkeypatch.setattr(ck, name, -1)
        with pytest.raises(ValueError):
            ck._check_own_min()
        monkeypatch.undo()
    assert ck.ARGTYPES["whitted_resume_launch"][-3:] == [ck.ctypes.c_int] * 3
    assert ck.ARGTYPES["whitted_emit_launch"][-2:] == [ck.ctypes.c_int] * 2


@contextlib.contextmanager
def _stood_in(monkeypatch, calls):
    """The library, the device, the stream and the tensor checks stood in
    for, so that meta tensors take the launch path of the rounds'
    wrappers; each ctypes call lands in ``calls``."""
    fake = types.SimpleNamespace(
        whitted_emit_launch=lambda *a: calls.append(("emit", a)) or 0,
        whitted_resume_launch=lambda *a: calls.append(("resume", a)) or 0)
    monkeypatch.setattr(ck, "_lib", lambda: fake)
    monkeypatch.setattr(ck, "_launch_inputs", lambda fn, sc, org, dirs, t,
                        struct, ps: (torch.zeros((7, dirs.shape[0])),
                                     (0,) * 12 + (struct.ns,)))
    monkeypatch.setattr(ck, "_check_device", lambda *a: None)
    monkeypatch.setattr(ck, "_check", lambda *a: None)
    monkeypatch.setattr(ck, "_scene_tables",
                        lambda sc, struct, ps, dev: (0,) * 12 + (struct.ns,))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=1234))
    yield


@pytest.mark.parametrize("warp_max", [None, 0, 64])
def test_warp_max_is_passed_to_the_launch(warp_max, monkeypatch):
    """The ctypes calls of trace_rays_rounds on meta tensors: emit gets
    EMIT_OWN_MIN_KEPT after the stream, resume its warp_max
    (RESUME_WARP_MAX, None its default, at most the ray count) and
    RESUME_OWN_MIN_KEPT, each then Schlick's flag (0), each call with its
    bound argument count and one
    launch counted; a negative switch raises before any launch."""
    sc = _scene("test13")
    calls = []
    meta = lambda *s: torch.empty(s, device="meta")
    if warp_max is not None:
        monkeypatch.setattr(ck, "RESUME_WARP_MAX", warp_max)
    monkeypatch.setattr(ck, "EMIT_OWN_MIN_KEPT", 17)
    monkeypatch.setattr(ck, "RESUME_OWN_MIN_KEPT", 5)
    with _stood_in(monkeypatch, calls):
        before = (ck.emit_launches, ck.resume_launches)
        ck.trace_rays_rounds(sc, meta(3), meta(64, 3), meta(64),
                             TraceConfig(), 4)
        (e, ea), (r, ra) = calls
        assert (e, r) == ("emit", "resume")
        assert len(ea) == len(ck.ARGTYPES["whitted_emit_launch"])
        assert len(ra) == len(ck.ARGTYPES["whitted_resume_launch"])
        assert ea[-3:] == (1234, 17, 0)
        assert ra[-4:] == (1234, 64 if warp_max is None else warp_max, 5, 0)
        assert (ck.emit_launches, ck.resume_launches) == (before[0] + 1,
                                                           before[1] + 1)
        for name in ("RESUME_WARP_MAX", "EMIT_OWN_MIN_KEPT",
                     "RESUME_OWN_MIN_KEPT"):
            with monkeypatch.context() as m:
                m.setattr(ck, name, -1)
                with pytest.raises(ValueError):
                    ck.trace_rays_rounds(sc, meta(3), meta(64, 3), meta(64),
                                         TraceConfig(), 4)
        assert len(calls) == 2 + 1   # the emit before RESUME_WARP_MAX's


# ---- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k1", [1, 4])
@pytest.mark.parametrize("name", ["test13", "demo02", "test14"])
def test_resume_modes_are_bitwise_on_card(name, k1, monkeypatch):
    """RESUME forced sparse (RESUME_WARP_MAX = n: a warp per survivor),
    forced dense (0: a thread each, per-ray masks) and at its default,
    from the kernel's emitted state at 200x120: the same bits as the plain
    resume, one launch each; and unculled too."""
    dev = _card()
    sc = _scene(name, dev)
    rays = _rays(sc, slice(None), 200, 120)
    n = rays[1].shape[0]
    for cfg in (TraceConfig(), TraceConfig(cull=False)):
        cols, state = ck.trace_rays_emit_cuda(sc, *rays, cfg, k1)
        want = trace_rays_resume(sc, state, cols.clone(), cfg, k1)
        idx, count = ck.compact_active(state)
        for wm in (n, 0, ck.RESUME_WARP_MAX):
            monkeypatch.setattr(ck, "RESUME_WARP_MAX", wm)
            before = ck.resume_launches
            got = ck.trace_rays_resume_cuda(sc, state, cols.clone(), idx,
                                            count, cfg, k1)
            assert ck.resume_launches == before + 1
            torch.cuda.synchronize()
            assert torch.equal(BITS(got), BITS(want)), (cfg.cull, wm)


@pytest.mark.cuda
@pytest.mark.parametrize("k1", [1, 4])
@pytest.mark.parametrize("name", ["test13", "demo02", "test14"])
def test_emit_is_bitwise_on_card(name, k1):
    """EMIT with per-ray masks after the camera segment (test13, demo02
    and test14 have more than EMIT_OWN_MIN_KEPT surfaces): colours and all
    21 state rows bitwise the plain emit's at 200x120, one launch."""
    dev = _card()
    sc = _scene(name, dev)
    rays = _rays(sc, slice(None), 200, 120)
    cfg = TraceConfig()
    want_c, want_s = trace_rays_emit(sc, *rays, cfg, k1)
    before = ck.emit_launches
    got_c, got_s = ck.trace_rays_emit_cuda(sc, *rays, cfg, k1)
    assert ck.emit_launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(BITS(got_c), BITS(want_c))
    assert torch.equal(BITS(got_s), BITS(want_s))


@pytest.mark.cuda
def test_warp_max_out_of_range_raises_on_card(monkeypatch):
    """A negative RESUME_WARP_MAX or per-ray threshold raises before the
    launch."""
    dev = _card()
    sc = _scene("test13", dev)
    rays = _rays(sc, slice(None), 32, 20)
    cols, state = ck.trace_rays_emit_cuda(sc, *rays, TraceConfig(), 1)
    idx, count = ck.compact_active(state)
    before = (ck.emit_launches, ck.resume_launches)
    for name in ("RESUME_WARP_MAX", "EMIT_OWN_MIN_KEPT",
                 "RESUME_OWN_MIN_KEPT"):
        with monkeypatch.context() as m:
            m.setattr(ck, name, -1)
            with pytest.raises(ValueError):
                ck.trace_rays_resume_cuda(sc, state, cols, idx, count,
                                          TraceConfig(), 1)
            if name == "EMIT_OWN_MIN_KEPT":
                with pytest.raises(ValueError):
                    ck.trace_rays_emit_cuda(sc, *rays, TraceConfig(), 1)
    assert (ck.emit_launches, ck.resume_launches) == before
