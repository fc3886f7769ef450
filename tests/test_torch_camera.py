"""The port's interactive camera (``engine.CameraController``,
``_find_camera``, ``Scene.update_action``, ``Scene.render_linear``)
against the JAX engine's on the CPU."""

import numpy as np
import pytest
import torch

from quadray_tpu import engine as JE
from quadray_tpu.models.scenes.loader import load_scene as jload
from quadray_tpu.scene import schema as JS
from quadray_tpu_torch import engine as E
from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS, frame_time
from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.scene import schema as S

torch.set_num_threads(1)

W, H = 64, 40
SCENES = [f"test{i:02d}" for i in range(1, 19)] + ["demo01", "demo02",
                                                    "demo03"]
CAM_ROWS = ("cam_pos", "cam_hor", "cam_ver", "cam_nrm", "s_pos")


def _cam_key(found):
    trm, cam = found
    return (tuple(trm.scl), tuple(trm.rot), tuple(trm.pos), cam.col,
            cam.amb, cam.pov, tuple(cam.dps), tuple(cam.drt))


@pytest.mark.parametrize("name", SCENES)
def test_controller_equals_jax_bitwise(name):
    """200 seeded (time, action) pairs over all ten codes, with the
    controller's clock advanced at random steps: pos and rot equal to the
    JAX controller's after every step (==, no tolerance)."""
    ours = E.CameraController(*E._find_camera(load_scene(name).root))
    ref = JE.CameraController(*JE._find_camera(jload(name).root))
    rng = np.random.default_rng(SCENES.index(name))
    # steps of up to 0.2 s, and now and then a long one that wraps rot[2]
    dts = np.where(rng.random(200) < 0.1, rng.uniform(0.0, 6000.0, 200),
                   rng.uniform(0.0, 200.0, 200))
    times = np.cumsum(dts).tolist()
    actions = rng.integers(1, 11, 200).tolist()
    advance = (rng.random(200) < 0.5).tolist()
    assert set(actions) == set(range(1, 11))
    for t, a, adv in zip(times, actions, advance):
        ours.update_action(t, a)
        ref.update_action(t, a)
        if adv:
            ours.advance(t)
            ref.advance(t)
        assert ours.pos == ref.pos and ours.rot == ref.rot, (t, a)
    assert ours.trm() == S.Transform3D(scl=ref.scl, rot=tuple(ref.rot),
                                       pos=tuple(ref.pos))


def test_find_camera_matches_jax():
    for name in SCENES:
        assert _cam_key(E._find_camera(load_scene(name).root)) == \
            _cam_key(JE._find_camera(jload(name).root)), name

    def nested(M):
        """Two cameras at the top, a third inside a nested array between
        them and a fourth two levels down at the end: the last one in
        hierarchy order is the deepest."""
        cam = lambda pov: M.Camera(pov=pov)
        inner = M.Array(objects=[M.obj(cam(3.0), pos=(0.0, 3.0, 0.0))])
        deep = M.Array(objects=[M.obj(M.Array(objects=[
            M.obj(cam(4.0), pos=(0.0, 4.0, 0.0))]))])
        head = [M.obj(cam(1.0), pos=(0.0, 1.0, 0.0)), M.obj(inner),
                M.obj(cam(2.0), pos=(0.0, 2.0, 0.0))]
        return (M.Array(objects=head + [M.obj(deep)]), M.Array(objects=head),
                M.Array(objects=[M.obj(M.Light())]))

    for ours, ref, pov in zip(nested(S), nested(JS), (4.0, 2.0, None)):
        a, b = E._find_camera(ours), JE._find_camera(ref)
        if pov is None:
            assert a is None and b is None
        else:
            assert _cam_key(a) == _cam_key(b) and a[1].pov == pov


def _drive(name, trace):
    """The same key trace through the JAX engine and the port's CPU
    engine, frame by frame (render_cli's dispatch: each frame's actions
    at its clock time, then the frame)."""
    from quadray_tpu_torch.models.scenes import demos
    from quadray_tpu.models.scenes import demos as jdemos
    is_demo = name.startswith("demo")
    ref = JE.Scene(jdemos.build(name) if is_demo else jload(name), W, H)
    ours = E.Scene(demos.build(name) if is_demo else load_scene(name), W, H,
                   device="cpu")
    for fi, keys in enumerate(trace):
        t = frame_time(fi)
        for key in keys.split("+"):
            if key != ".":
                ref.update_action(t, KEY_ACTIONS[key])
                ours.update_action(t, KEY_ACTIONS[key])
        yield fi, keys, ref, ours, ref.render(t), ours.render(t)


@pytest.mark.parametrize("name,trace", [
    ("test01", [".", "w", "left", "w+rise", "up", "d", "down+s", "fall"]),
    ("demo01", [".", "w+left", "right+a"]),
])
def test_scene_trace_matches_jax(name, trace):
    """Camera rows and surface positions within 1e-6 of the JAX engine's
    after every frame (its first update compiles eagerly with the camera
    as Python floats, later ones through its jitted pass with f32
    arrays), frames within the port's bar (max 1 LSB on at most 0.5% of
    the pixels, as tests/test_torch_engine.py), and a move changes the
    frame."""
    prev = None
    for fi, keys, ref, ours, a, b in _drive(name, trace):
        for k in CAM_ROWS:
            np.testing.assert_allclose(
                getattr(ours.arrays, k).numpy(),
                np.asarray(getattr(ref.arrays, k)), rtol=0, atol=1e-6,
                err_msg=f"{name} frame {fi} {k}")
        d = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
        assert d.max() <= 1 and (d > 0).mean() <= 0.005, (name, fi)
        if keys != ".":
            assert not np.array_equal(prev, b), (name, fi, keys)
        assert ours.camera is None if fi == 0 else \
            (ours.camera.pos == ref.camera.pos
             and ours.camera.rot == ref.camera.rot)
        prev = b


def test_camera_update_action():
    """The port of tests/test_engine.py::test_camera_update_action
    (rt_Camera::update_action semantics, object.cpp:495-573): forward
    motion moves along the heading, rotations clamp pitch, and frames
    actually change."""
    sc = E.Scene(load_scene("test01"), W, H, device="cpu")
    f0 = sc.render(0.0)
    sc.update_action(100.0, E.CAMERA_MOVE_FORWARD)
    assert sc.camera.pos != list(E._find_camera(sc.sdef.root)[0].pos)
    f1 = sc.render(100.0)
    assert not np.array_equal(f0, f1)
    sc.update_action(200.0, E.CAMERA_ROTATE_LEFT)
    f2 = sc.render(200.0)
    assert not np.array_equal(f1, f2)
    assert sc.camera.rot[2] != 0.0
    # pitch clamp: ROTATE_UP cannot push rot[0] above 0
    for t in range(3, 40):
        sc.update_action(t * 100.0, E.CAMERA_ROTATE_UP)
        sc.camera.advance(t * 100.0)
    assert sc.camera.rot[0] <= 0.0


def test_update_action_before_first_update_and_set_opts():
    """An action before any update starts the controller's clock at the
    scene's time (0), as JAX does; set_opts keeps the camera."""
    sc = E.Scene(load_scene("test01"), W, H, device="cpu")
    ref = JE.Scene(jload("test01"), W, H)
    for s in (sc, ref):
        s.update_action(500.0, E.CAMERA_MOVE_FORWARD)
    assert sc.camera.pos == ref.camera.pos
    sc.render(500.0)
    assert sc.camera._last_time == 500.0
    cam, pos = sc.camera, sc.arrays.cam_pos.clone()
    sc.set_opts(S.OPTS_FULL)
    assert sc.camera is cam and torch.equal(sc.arrays.cam_pos, pos)
    assert not torch.equal(
        E.Scene(load_scene("test01"), W, H, device="cpu").arrays.cam_pos, pos)


def test_render_linear_matches_jax():
    ref = JE.Scene(jload("test01"), W, H)
    ours = E.Scene(load_scene("test01"), W, H, device="cpu")
    for s in (ref, ours):
        s.update_action(300.0, E.CAMERA_MOVE_LEFT)
        s.update_action(300.0, E.CAMERA_ROTATE_DOWN)
    a = np.asarray(ref.render_linear(300.0))
    b = ours.render_linear(300.0)
    assert b.shape == (H, W, 3) and b.dtype == torch.float32
    assert np.abs(a - b.numpy()).max() <= 1e-5
