"""The port's user entry point, Scene.render, on the CPU."""

import os

import numpy as np
import pytest
import torch

from quadray_tpu_torch import Platform, Scene
from quadray_tpu_torch.models.scenes import demos
from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.utils.image import frame_cmp, load_bmp

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "golden")


def test_cpu_render_matches_golden_test01():
    """Full 800x480 frame through the plain tracer vs the reference C
    engine's frame (budget 0, as tests/test_golden.py)."""
    ref = load_bmp(os.path.join(GOLDEN, "ref_test01.bmp"))
    frame = Scene(load_scene("test01"), 800, 480, device="cpu").render(0.0)
    assert frame.shape == (480, 800, 3) and frame.dtype == np.uint8
    nbad, _ = frame_cmp(ref, frame, t_diff=3)
    assert nbad == 0


def test_animated_demo_matches_jax_engine():
    """demo01's animators (camera and light rotate with t) at two times:
    the port's frames against the JAX engine's CPU frames."""
    from quadray_tpu.engine import Scene as JScene
    from quadray_tpu.models.scenes import demos as jdemos
    w, h = 48, 32
    ours = Scene(demos.build("demo01"), w, h, device="cpu")
    ref = JScene(jdemos.build("demo01"), w, h)
    frames = []
    for t in (0.0, 2000.0):
        a, b = ref.render(t), ours.render(t)
        d = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
        assert d.max() <= 1 and (d > 0).mean() <= 0.005, t
        frames.append(b)
    assert not np.array_equal(frames[0], frames[1])


def test_cuda_scene_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Scene(load_scene("test01"), 16, 8, device="cuda").render(0.0)


def test_fsaa_and_save_frame(tmp_path):
    sc = Scene(load_scene("test01"), 40, 24, pfm=Platform(fsaa=4),
               device="cpu")
    frame = sc.render(0.0)
    path = str(tmp_path / "f.bmp")
    sc.save_frame(path)
    assert np.array_equal(load_bmp(path), frame)


def test_set_opts_and_print_state():
    sc = Scene(load_scene("test01"), 16, 8, device="cpu")
    sc.render(0.0)
    sc.set_opts(S.OPTS_FULL & ~S.OPTS_TILING)
    assert int(sc.arrays.s_bnd.sum()) == 0
    lines = []
    sc.print_state(log=lines.append)
    assert lines[0].startswith("scene 16x8") and len(lines) == 12


def test_path_tracing_matches_jax_engine():
    """set_pton + render_pt_pass(2) on test18 at 40x24 against the JAX
    engine's jnp path tracer: same seeds, so the same frame up to f32
    association; measured 0 differing pixels."""
    from quadray_tpu.engine import Platform as JPlatform, Scene as JScene
    from quadray_tpu.models.scenes.loader import load_scene as jload
    ref = JScene(jload("test18"), 40, 24, pfm=JPlatform(use_pallas=False))
    ours = Scene(load_scene("test18"), 40, 24, device="cpu")
    assert ref.set_pton(True) and ours.set_pton(True)
    a, b = ref.render_pt_pass(2), ours.render_pt_pass(2)
    d = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    assert d.max() <= 1 and int((d > 0).sum()) == 0
    assert b.mean() > 10.0
    # render() adds one pass while path tracing is on
    ours.render()
    assert ours._pt_samples == 3
    assert not ours.set_pton(False) and ours.render().shape == (24, 40, 3)


def test_entry_points_default_to_the_card():
    import inspect
    from quadray_tpu_torch.dryrun import dryrun_multichip
    from quadray_tpu_torch.parallel import checkpoint, train
    from quadray_tpu_torch.parallel.mesh import ray_mesh
    from quadray_tpu_torch.parallel.render import render_sharded_cuda
    from quadray_tpu_torch.scene import compile as comp
    for fn in (Scene.__init__, comp.compile_scene,
               comp.scene_arrays_from_numpy, train.params_from_numpy,
               train.opt_state_from_numpy, checkpoint.load_checkpoint,
               dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn.__qualname__
    # the sharded render runs on its mesh's devices, whose default is
    # every visible card, never the CPU
    assert "device" not in inspect.signature(render_sharded_cuda).parameters
    assert inspect.signature(ray_mesh).parameters["devices"].default is None
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in ray_mesh().devices)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ray_mesh()


def test_default_device_scene_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sc = Scene(load_scene("test01"), 16, 8)
    assert sc.device.type == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        sc.render(0.0)
