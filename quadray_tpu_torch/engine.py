"""Engine facade: Platform + Scene — the user-level API.

The PyTorch counterpart of ``quadray_tpu.engine`` (rt_Platform,
engine.h:79-156, and rt_Scene, engine.h:229-362): scene management,
per-frame update (the structure once, then the animators and the camera
through a batched numeric pass), render, progressive
path tracing, fsaa/depth options, frame save and state dump. A Scene
renders on its ``device`` (the card unless the caller names the CPU): on
a CUDA device through the hand-written kernels (``ops.cuda_kernel``), on
the CPU through their plain versions (``ops.trace``, ``ops.pt``). There
is no fallback between the two. On a CUDA device ``render`` replays one
CUDA graph a Whitted frame, the scene update and the pack included (the
interactive program), and ``render_pt_pass`` one a pass (``ops.graphs``:
the scene's programs, which live and die with it); ``update`` and
``render_linear`` stay eager. Interactive camera actions
(``update_action``, ``CameraController``) move the scene's camera between
frames, as RooT's hotkeys do (``apps.render_cli``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import SceneArrays, numeric_pass, \
    structure_pass
from quadray_tpu_torch.ops.trace import TraceConfig, render as _render, \
    to_frame


# camera action codes (RT_CAMERA_*, format.h / RooT key bindings)
CAMERA_MOVE_UP = 1
CAMERA_MOVE_DOWN = 2
CAMERA_MOVE_LEFT = 3
CAMERA_MOVE_RIGHT = 4
CAMERA_MOVE_BACK = 5
CAMERA_MOVE_FORWARD = 6
CAMERA_ROTATE_LEFT = 7
CAMERA_ROTATE_RIGHT = 8
CAMERA_ROTATE_UP = 9
CAMERA_ROTATE_DOWN = 10


class CameraController:
    """Interactive camera state (rt_Camera::update_action,
    object.cpp:495-573): WASD-style moves scaled by the camera's dps
    speeds in the heading frame (hor_sin/cos of the Z rotation), arrow
    rotations scaled by drt with the reference's pitch clamps. Python
    floats in the JAX controller's order, so its pos/rot are the JAX
    engine's bit for bit."""

    def __init__(self, trm: S.Transform3D, cam: S.Camera):
        self.pos = list(float(v) for v in trm.pos)
        self.rot = list(float(v) for v in trm.rot)
        self.scl = tuple(trm.scl)
        self.dps = tuple(float(v) for v in cam.dps)
        self.drt = tuple(float(v) for v in cam.drt)
        self._last_time = 0.0

    def update_action(self, time: float, action: int):
        t = (time - self._last_time) / 50.0
        hor_sin = math.sin(math.radians(self.rot[2]))
        hor_cos = math.cos(math.radians(self.rot[2]))
        dps, drt = self.dps, self.drt
        if action == CAMERA_MOVE_UP:
            self.pos[2] += dps[2] * t
        elif action == CAMERA_MOVE_DOWN:
            self.pos[2] -= dps[2] * t
        elif action == CAMERA_MOVE_LEFT:
            self.pos[0] -= dps[0] * t * hor_cos
            self.pos[1] -= dps[0] * t * hor_sin
        elif action == CAMERA_MOVE_RIGHT:
            self.pos[0] += dps[0] * t * hor_cos
            self.pos[1] += dps[0] * t * hor_sin
        elif action == CAMERA_MOVE_BACK:
            self.pos[0] += dps[1] * t * hor_sin
            self.pos[1] -= dps[1] * t * hor_cos
        elif action == CAMERA_MOVE_FORWARD:
            self.pos[0] -= dps[1] * t * hor_sin
            self.pos[1] += dps[1] * t * hor_cos
        elif action == CAMERA_ROTATE_LEFT:
            self.rot[2] += drt[0] * t
            if self.rot[2] >= 180.0:
                self.rot[2] -= 360.0
        elif action == CAMERA_ROTATE_RIGHT:
            self.rot[2] -= drt[0] * t
            if self.rot[2] <= -180.0:
                self.rot[2] += 360.0
        elif action == CAMERA_ROTATE_UP:
            if self.rot[0] < 0.0:
                self.rot[0] = min(self.rot[0] + drt[1] * t, 0.0)
        elif action == CAMERA_ROTATE_DOWN:
            if self.rot[0] > -180.0:
                self.rot[0] = max(self.rot[0] - drt[1] * t, -180.0)

    def advance(self, time: float):
        self._last_time = time

    def trm(self) -> S.Transform3D:
        return S.Transform3D(scl=self.scl, rot=tuple(self.rot),
                             pos=tuple(self.pos))


def _find_camera(arr: S.Array):
    """LAST (trm, Camera) in hierarchy order, recursing into sub-arrays:
    index 0 of the camera registry, which prepends on construction
    (object.cpp:429-431); the scene renders cam_head (engine.cpp:2923)."""
    found = None
    for ob in arr.objects:
        if isinstance(ob.item, S.Camera):
            found = (ob.trm, ob.item)
        if isinstance(ob.item, S.Array):
            sub = _find_camera(ob.item)
            if sub is not None:
                found = sub
    return found


class Platform:
    """Owns global config (fsaa, depth) and the scene list
    (rt_Platform, engine.cpp:512-798)."""

    def __init__(self, fsaa: int = 1, depth: int = 10):
        self.fsaa = fsaa
        self.depth = depth
        self.scenes = []

    def add(self, scene: "Scene"):
        self.scenes.append(scene)
        return scene

    def set_fsaa(self, fsaa: int):
        assert fsaa in (1, 2, 4)
        self.fsaa = fsaa


class Scene:
    """A scene instance bound to a framebuffer size and a device."""

    def __init__(self, sdef: S.SceneDef, width: int, height: int,
                 pfm: Optional[Platform] = None, cam_index: int = 0,
                 device="cuda"):
        self.sdef = sdef
        self.width = width
        self.height = height
        self.pfm = pfm or Platform()
        self.cam_index = cam_index
        self.device = torch.device(device)
        # effective opts: FULL minus the flags the scene def turns off
        # (rt_Scene ctor engine.cpp:2873 + set_opts engine.cpp:3714-3724)
        self.opts = S.OPTS_FULL & ~sdef.opts
        self._arrays: Optional[SceneArrays] = None
        self._shapes: Optional[dict] = None
        self._structure = None
        self._struct = None
        self.camera: Optional[CameraController] = None
        self._time = 0.0
        # the camera's transform at the last update or interactive frame
        # (the controller's, or None): the arrays are at (_time, _cam_trm)
        self._cam_trm = None
        self.frame = np.zeros((height, width, 3), np.uint8)
        # progressive path-tracer state (pseed/ptr planes analog,
        # engine.cpp:2875-2899, 3670-3700)
        self.pt_on = False
        self._pt_acc = None
        self._pt_samples = 0
        self._pt_seeds = None
        # the interactive and pass programs (ops.graphs), each for the key
        # of its last call; a new key replaces it
        self._pass_prog = None
        self._interactive_prog = None

    def update(self, t: float = 0.0) -> SceneArrays:
        """The scene's arrays at time t, incrementally (the JAX engine's
        update pipeline, quadray_tpu/engine.py:159-207): the first update,
        and the first after ``set_opts``, records the structure
        (``structure_pass``: the hierarchy walk and the relation compile,
        and every field no transform moves, on the device); every update
        then runs the numeric pass alone (``numeric_pass``: the animators
        and the camera on the host, the transform-dependent fields on a
        card in one launch of the scene update's kernel, on the CPU by its
        plain version), bitwise ``compile_scene``'s. Later frames keep
        the first frame's padded shapes and kernel structure. Once a
        camera action has been taken, the camera's transform is the
        controller's, and the controller's clock advances to t. A
        hierarchy that changed after its structure was recorded raises
        ValueError."""
        cam_trm = self._cam_trm = self._record(t)
        self._arrays = numeric_pass(self._structure, t, cam_trm)
        if self._struct is None and self.device.type == "cuda":
            from quadray_tpu_torch.ops.cuda_kernel import scene_struct
            self._struct = scene_struct(self._arrays)
        if self.camera is not None:
            self.camera.advance(t)
        return self._arrays

    def _record(self, t: float):
        """An update's first steps: the device checked, the time set, the
        structure recorded where there is none (and a replaced sdef
        refused); returns the camera's transform (the controller's, or
        None)."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Scene device {self.device}: CUDA is not "
                               "available")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self._time = t
        cam_trm = self.camera.trm() if self.camera is not None else None
        if self._structure is None:
            self._structure = structure_pass(
                S.SceneDef(root=self.sdef.root, opts=self.opts), time=t,
                cam_index=self.cam_index, cam_trm=cam_trm,
                device=self.device)
            self._shapes = dict(self._structure.shapes)
        elif self._structure.root is not self.sdef.root:
            raise ValueError("Scene.sdef was replaced after its structure "
                             "was recorded: make a new Scene")
        return cam_trm

    def update_action(self, t: float, action: int):
        """Interactive camera action (rt_Scene::update + update_action,
        engine.cpp:2968 + object.cpp:495-573): the first action takes the
        scene's camera (``_find_camera``) into a controller whose clock
        starts at the last update's time; the next ``update`` compiles
        the scene with the moved camera."""
        if self.camera is None:
            found = _find_camera(self.sdef.root)
            if found is None:
                raise ValueError("scene has no camera")
            self.camera = CameraController(*found)
            self.camera.advance(self._time)
        self.camera.update_action(t, action)

    @property
    def arrays(self) -> SceneArrays:
        """The scene's arrays at the last update's or interactive frame's
        time and camera; before any, ``update`` at the scene's time. An
        interactive frame hands out none of its program's buffers: the
        first read after it runs the numeric pass at that frame's time and
        camera (on a card one update launch where a group moved since the
        last pass), which neither advances the controller's clock nor
        reads a camera action taken since the frame."""
        if self._arrays is None:
            if self._structure is None:
                self.update(self._time)
            else:
                self._arrays = numeric_pass(self._structure, self._time,
                                            self._cam_trm)
        return self._arrays

    def set_pton(self, on: bool) -> bool:
        """Toggle progressive path tracing (set_pton analog,
        engine.cpp:3729-3742); resets accumulation on enable."""
        if on and (self.opts & S.OPTS_PT):
            on = False
        if on and not self.pt_on:
            self.reset_pt()
        self.pt_on = on
        return self.pt_on

    def reset_pt(self):
        from quadray_tpu_torch.ops.pt import init_seeds
        n = self.width * self.height
        self._pt_acc = torch.zeros((n, 3), dtype=torch.float32,
                                   device=self.device)
        self._pt_samples = 0
        self._pt_seeds = init_seeds(n, device=self.device)

    def pt_state(self) -> Optional[dict]:
        """The progressive render's state, for ``save_checkpoint``: the
        running sum (W*H, 3) f32, the per-pixel seeds (W*H,) int32 and the
        sample count; None before the first pass."""
        if self._pt_acc is None:
            return None
        # copies: on the card the sum and seeds are a pass program's
        # buffers, which the next pass overwrites
        return dict(acc=self._pt_acc.clone(), seeds=self._pt_seeds.clone(),
                    samples=self._pt_samples)

    def set_pt_state(self, state: dict):
        """Resume a progressive render from ``pt_state()``'s dict (from
        ``load_checkpoint(..., with_pt=True)``): the next pass continues
        the sum, seeds and sample count bit for bit. The state is copied:
        the next pass program stages the copies into its buffers."""
        n = self.width * self.height
        acc = state["acc"].to(self.device, torch.float32)
        seeds = state["seeds"].to(self.device, torch.int32)
        if tuple(acc.shape) != (n, 3) or tuple(seeds.shape) != (n,):
            raise ValueError(f"PT state of shapes {tuple(acc.shape)}, "
                             f"{tuple(seeds.shape)} for a {self.width}x"
                             f"{self.height} scene")
        self._pt_acc, self._pt_seeds = acc.clone(), seeds.clone()
        self._pt_samples = int(state["samples"])

    def render_pt_pass(self, passes: int = 1) -> np.ndarray:
        """Accumulate `passes` path-traced samples/pixel; return the frame
        of the running mean. On a CUDA device one replay of the scene's
        pass program a pass (``render_pt_program``), on the CPU the plain
        ``trace_pt`` issued op by op (``pt_passes``); both cull where PT's
        gate says so (``ops.cuda_kernel.cull_gates``), which changes no
        bit of the frame."""
        if self.device.type == "cuda":
            return self.render_pt_program(passes)
        from quadray_tpu_torch.ops.cuda_kernel import pt_passes
        sc = self.arrays
        if self._pt_acc is None:
            self.reset_pt()
        self._pt_acc, self._pt_seeds = pt_passes(
            sc, self.width, self.height, self._pt_acc, self._pt_seeds,
            passes, self._cfg(), self._struct)
        self._pt_samples += max(passes, 0)
        img = torch.clamp(self._pt_acc / max(self._pt_samples, 1), 0.0, 1.0)
        img = img.reshape(self.height, self.width, 3)
        self.frame = to_frame(img, sc.use_gamma).cpu().numpy()
        return self.frame

    def render_pt_program(self, passes: int = 1) -> np.ndarray:
        """``render_pt_pass`` through the scene's pass program
        (``ops.graphs.PassProgram``): on a CUDA device one replay of its
        CUDA graph a pass and one of its frame's, which is what
        ``render_pt_pass`` runs there; on the CPU the same bodies called
        eagerly, which the tests hold to ``render_pt_pass``. The running
        sum and seeds are then the program's buffers; ``pt_state`` copies
        them."""
        sc = self.arrays
        if self._pt_acc is None:
            self.reset_pt()
        prog = self._pass_program()
        self._pt_acc, self._pt_seeds = prog.passes(
            sc, self._pt_acc, self._pt_seeds, passes)
        self._pt_samples += max(passes, 0)
        self.frame = prog.frame(self._pt_samples)
        return self.frame

    def render(self, t: Optional[float] = None) -> np.ndarray:
        """Render a frame at time t; returns (H, W, 3) uint8: one
        path-traced pass while path tracing is on, else the Whitted frame.
        On a CUDA device the Whitted frame, update included, is one replay
        of the scene's interactive program (``render_interactive``); on
        the CPU the update, then the plain tracer (``render_linear``, then
        ``to_frame``)."""
        if self.device.type == "cuda" and not self.pt_on:
            return self.render_interactive(t)
        if t is not None:
            self.update(t)
        if self.pt_on:
            return self.render_pt_pass()
        img = self.render_linear()
        self.frame = to_frame(img, self.arrays.use_gamma).cpu().numpy()
        return self.frame

    def render_interactive(self, t: Optional[float] = None) -> np.ndarray:
        """The Whitted frame at time t, the scene update included, through
        the scene's interactive program (``ops.graphs.InteractiveProgram``,
        one for the scene's structure, size, fsaa and depth): on the host
        the structure's check, the animators, the camera and its sin and
        cos, written into the program's pinned buffer; on a CUDA device
        then one replay of its CUDA graph (the copy of those values, the
        update launch, the pack launch of the tables the moving fields
        feed, ray generation, the Whitted launch, the AA mean,
        ``to_frame`` and the copy into pinned host memory), which is what
        ``render`` runs there; on the CPU the same body called eagerly,
        which the tests hold to ``render``. t None draws the scene at the
        last update's or frame's time and camera, as ``render`` draws its
        arrays (a camera action taken since shows at the next t), and
        records the structure at the scene's time where there is none.
        The returned array is the caller's: a later frame never writes
        it. The program's field buffers are never handed out: after the
        frame ``arrays`` recomputes the scene's arrays at the frame's time
        and camera."""
        fresh = t is not None or self._structure is None
        if fresh:
            self._cam_trm = self._record(self._time if t is None else t)
        self.frame = self._interactive_program().run_at(self._time,
                                                         self._cam_trm)
        self._arrays = None
        if fresh and self.camera is not None:
            self.camera.advance(self._time)
        return self.frame

    def render_linear(self, t: Optional[float] = None) -> torch.Tensor:
        """The Whitted frame at time t as (H, W, 3) linear radiance on the
        scene's device, before ``to_frame``: through the CUDA kernel
        (``render_cuda``, issued op by op) on a CUDA device, the plain
        ``render`` on the CPU. (The JAX engine's ``render_linear`` always
        takes its jnp tracer.)"""
        if t is not None:
            self.update(t)
        cfg = self._cfg()
        if self.device.type == "cuda":
            from quadray_tpu_torch.ops.cuda_kernel import render_cuda
            return render_cuda(self.arrays, self.width, self.height,
                               self.pfm.fsaa, cfg, struct=self._struct)
        return _render(self.arrays, self.width, self.height, self.pfm.fsaa,
                       cfg)

    def _cfg(self) -> TraceConfig:
        return TraceConfig(depth=self.pfm.depth)

    def _kernel_struct(self):
        """The scene's KernelStruct (made here on the CPU, where update
        does not need it)."""
        if self._struct is None:
            from quadray_tpu_torch.ops.cuda_kernel import scene_struct
            self._struct = scene_struct(self.arrays)
        return self._struct

    def _interactive_program(self):
        """The interactive program for the scene's present key
        (``interactive_key``), replacing one made for another."""
        from quadray_tpu_torch.ops.graphs import (InteractiveProgram,
                                                  interactive_key)
        struct, cfg, fsaa = self._kernel_struct(), self._cfg(), self.pfm.fsaa
        key = interactive_key(self._structure, struct, self.width,
                              self.height, fsaa, cfg)
        if self._interactive_prog is None or \
                self._interactive_prog.key != key:
            self._interactive_prog = None   # its graph's memory goes first
            self._interactive_prog = InteractiveProgram(
                self._structure, struct, self.width, self.height, fsaa, cfg,
                self.device)
        return self._interactive_prog

    def _pass_program(self):
        """The pass program for the scene's present key (``pass_key``),
        replacing one made for another."""
        from quadray_tpu_torch.ops.graphs import PassProgram, pass_key
        struct, cfg = self._kernel_struct(), self._cfg()
        key = pass_key(struct, self.width, self.height, cfg)
        if self._pass_prog is None or self._pass_prog.key != key:
            self._pass_prog = None
            self._pass_prog = PassProgram(struct, self.width, self.height,
                                          cfg, self.device)
        return self._pass_prog

    def save_frame(self, path: str):
        from quadray_tpu_torch.utils.image import save_bmp
        save_bmp(path, self.frame)

    def set_opts(self, opts: int):
        self.opts = opts & ~self.sdef.opts
        self._arrays = None
        self._shapes = None
        self._structure = None
        self._struct = None
        self._pass_prog = self._interactive_prog = None

    def print_state(self, log=print):
        """State dump for reproduction (print_state analog,
        engine.cpp:47-418)."""
        sc = self.arrays
        log(f"scene {self.width}x{self.height} t={self._time} "
            f"device={self.device}")
        for k in ("s_tag", "s_pos", "s_sci", "s_scjh", "s_sciw", "l_pos",
                  "l_col", "cam_pos", "cam_hor", "cam_ver", "cam_nrm"):
            log(f"{k} = {getattr(sc, k).cpu().numpy()!r}")
