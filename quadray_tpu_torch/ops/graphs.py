"""One CUDA graph a Whitted frame and a path-traced pass.

The counterparts of the JAX package's execution model: ``render_pallas``
runs ray generation, the megakernel and the untile in one jit
(``quadray_tpu/ops/pallas_kernel.py:2872-2900``), and ``render_pt_pallas``
runs its passes in one dispatch (:2396-2472). Issued op by op from Python,
a frame of the port is some twenty small launches around the kernel, and
the host's work between them is most of an interactive frame.

A program here has fixed inputs: it owns a buffer for everything its body
reads that may change from frame to frame, and the body reads those
buffers only. On a CUDA device the body runs once on a side stream (the
warm-up, whose result stands) and is then captured into a
``torch.cuda.CUDAGraph``, which every later call replays (``capture``).
On the CPU the body is simply called, with the plain tracers in the
kernels' place.

- ``InteractiveProgram`` (one a ``Scene``): the interactive Whitted
  frame, update included: the copy of the moving nodes' values from the
  program's pinned buffer, the scene update's launch (``ops.update``)
  into the program's field buffers, one pack launch into its table
  buffers, camera rays, the Whitted launch
  (``ops.cuda_kernel.launch_whitted``), clamp, ``resolve_aa``,
  ``to_frame`` and a non-blocking copy into a pinned host buffer. The
  counterpart of the JAX engine's update, pack and render executables
  called back to back; ``Scene.render`` replays it on a CUDA device.
- ``PassProgram`` (one a ``Scene``, and the last few of
  ``render_pt_cuda``: ``pt_program``): ``pt_camera_rays``, the PT launch
  (``launch_pt``) and the running sum, in place in the program's sum and
  seeds; and a frame body for the mean. ``Scene.render_pt_pass`` and
  ``render_pt_cuda`` replay it once a pass.
- ``parallel.train.StepProgram`` (a training step: the re-pack, the paths
  launch, replay with its row gathers, or the all-surface tracer's
  bounces; the loss's gradients and Adam) takes ``capture``, ``Replay``
  and ``Inputs`` from here.

Hazards, and what is done about each:
- a capture bakes in pointers, while the incremental update hands a moved
  field, and the pack by parts a re-packed table, as a new tensor: the
  interactive program updates and packs into its own buffers inside the
  graph, and stages nothing; the pass and step programs' ``Inputs.stage``
  copies, device to device on the current stream, each input whose
  source is a new object, and nothing in a call that moved nothing;
- the interactive program's values are written into pinned host memory
  that its graph copies from: the host writes them only after the
  previous frame's wait;
- a capture freezes what the launches read from Python: the scene
  structure, the frame's size, fsaa, the TraceConfig, the culling gates
  and ``COOP_MAX_LIVE``, ``EMIT_OWN_MIN_KEPT`` and ``WHOLE_OWN_MAX_RAYS``.
  They are the program's key (``interactive_key``, ``pass_key``): a change of
  any of them makes a new program. The mean's divisor changes every call,
  so it runs outside the graph, as today's op;
- a replay does not pass through the launch wrappers, so it adds to their
  counters (``ops.cuda_kernel.launches``, ``pt_launches``, ...,
  ``ops.row_gather.launches``, ``backward_launches``, ``ops.replay
  .launches``, ``backward_launches``, ``ops.diff.launches``,
  ``backward_launches``, ``light_sum_launches``, ``ops.update.launches``)
  what its capture recorded;
- a frame returned to the caller is a copy of the pinned buffer, which
  the next frame overwrites.

A capture or a replay that fails raises; nothing falls back to eager
launches.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops import diff as dff
from quadray_tpu_torch.ops import replay as rp
from quadray_tpu_torch.ops import row_gather as rg
from quadray_tpu_torch.ops import update as upd
from quadray_tpu_torch.ops.pt import pt_camera_rays
from quadray_tpu_torch.ops.rays import camera_rays, resolve_aa
from quadray_tpu_torch.ops.trace import TraceConfig, to_frame

F32 = torch.float32
I32 = torch.int32

# the launch wrappers' counters, which a replay adds to, by name:
# (module, attribute)
COUNTERS = {k: (ck, k) for k in ("launches", "paths_launches",
                                 "pt_launches", "emit_launches",
                                 "resume_launches", "pack_launches",
                                 "cull_launches")}
COUNTERS.update(gather_launches=(rg, "launches"),
                gather_backward_launches=(rg, "backward_launches"),
                replay_launches=(rp, "launches"),
                replay_backward_launches=(rp, "backward_launches"),
                diff_launches=(dff, "launches"),
                diff_backward_launches=(dff, "backward_launches"),
                light_sum_launches=(dff, "light_sum_launches"),
                update_launches=(upd, "launches"))
CAMERA = ("cam_pos", "cam_hor", "cam_ver", "cam_nrm", "cam_pov")
# render_pt_cuda's pass programs kept, the most recently used
PT_PROGRAMS = 4


class Camera(NamedTuple):
    """A program's camera buffers, under SceneArrays' names (what
    ``pt_camera_rays`` reads of a scene)."""
    cam_pos: torch.Tensor
    cam_hor: torch.Tensor
    cam_ver: torch.Tensor
    cam_nrm: torch.Tensor
    cam_pov: torch.Tensor


class Replay:
    """A body captured in a CUDA graph (``capture``): a call replays the
    graph on the current stream and adds to the launch counters what the
    capture recorded (``counts``). ``ms``: host ms of the warm-up and the
    capture, the program's set-up; ``warmup_ms`` the warm-up's part (its
    host work: the launches' enqueue and their first-call work)."""

    def __init__(self, graph, counts: dict, ms: float,
                 warmup_ms: float = float("nan")):
        self.graph, self.counts, self.ms = graph, counts, ms
        self.warmup_ms = warmup_ms

    def __call__(self):
        self.graph.replay()
        for k, n in self.counts.items():
            mod, attr = COUNTERS[k]
            setattr(mod, attr, getattr(mod, attr) + n)


def capture(body, device: torch.device, release: bool = False):
    """Runs ``body`` once and returns what runs it again. On a CUDA
    device: the warm-up on a side stream, which also does the kernels'
    first-call work (the PT kernel's occupancy query) and whose results
    stand, then the capture of body into a CUDA graph, whose ``Replay`` is
    returned; the counters keep the warm-up's launches, not the
    capture's. The capture is on the same side stream, begun and ended
    directly: ``torch.cuda.graph`` would also synchronise the card, run
    Python's garbage collector and empty the allocator's cache at every
    capture, a frame's set-up that grows with the process's heap. With
    ``release`` (a training step, whose warm-up frees its saved
    activations) the warm-up is waited for and the allocator's cache
    emptied before the capture: the graph's own pool cannot take blocks
    cached outside it, and two steps' activations may not fit on the
    card. On the CPU, body itself."""
    if device.type != "cuda":
        body()
        return body
    t0 = time.perf_counter()
    with torch.cuda.device(device):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            body()
            t1 = time.perf_counter()
            if release:
                side.synchronize()
                torch.cuda.empty_cache()
            cur.wait_stream(side)
            before = {k: getattr(*c) for k, c in COUNTERS.items()}
            try:
                graph.capture_begin()
                try:
                    body()
                finally:
                    graph.capture_end()
            finally:
                counts = {k: getattr(*COUNTERS[k]) - v
                          for k, v in before.items()}
                for k, v in before.items():
                    setattr(*COUNTERS[k], v)
    return Replay(graph, {k: n for k, n in counts.items() if n},
                  (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3)


class Inputs:
    """A program's buffers for what its body reads that may change between
    calls, by name: ``stage`` writes a source into its buffer in place
    (made on the first stage), unless the source is the buffer itself or
    the object last staged there, which it holds so that no other object
    can take its identity. ``copies`` counts the buffers written."""

    def __init__(self):
        self.buf = {}
        self._src = {}
        self.copies = 0

    def own(self, name: str, buf: torch.Tensor):
        """A buffer the program makes itself (the running sum)."""
        self.buf[name] = self._src[name] = buf

    def stage(self, name: str, src: torch.Tensor):
        buf = self.buf.get(name)
        if buf is None:
            self.buf[name] = src.clone(memory_format=torch.contiguous_format)
        elif src is buf or src is self._src[name]:
            return
        elif src.shape != buf.shape or src.dtype != buf.dtype:
            raise ValueError(f"{name}: a {src.dtype} {tuple(src.shape)} "
                             f"source for a {buf.dtype} {tuple(buf.shape)} "
                             "buffer: the structure changed, make a new "
                             "program")
        else:
            buf.copy_(src, non_blocking=True)
        self._src[name] = src
        self.copies += 1

    def tables(self) -> ck.PackedScene:
        return ck.PackedScene(*(self.buf[f] for f in ck.PackedScene._fields))

    def camera(self) -> Camera:
        return Camera(*(self.buf[k] for k in CAMERA))


def pass_key(struct: ck.KernelStruct, width: int, height: int,
             cfg: TraceConfig) -> tuple:
    """What a PT pass's capture freezes: the structure, the frame, the
    config and PT's gates."""
    return (id(struct), width, height, cfg,
            ck.cull_gates(struct, cfg, pt=True).flags)


def _host_frame(width: int, height: int, device) -> torch.Tensor:
    return torch.empty((height, width, 3), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


class _Program:
    """What the two programs share: the structure, the frame, the config,
    the inputs and the pinned host frame."""

    def __init__(self, key, struct, width, height, cfg, device):
        self.key, self.struct, self.cfg = key, struct, cfg
        self.width, self.height = width, height
        self.device = torch.device(device)
        self.inputs = Inputs()
        self.host = _host_frame(width, height, self.device)
        self._sc = None

    def _send(self, img):
        """to_frame, then the copy into the pinned host frame."""
        self.host.copy_(to_frame(img, self.inputs.buf["use_gamma"]),
                        non_blocking=True)

    def _fetch(self) -> np.ndarray:
        """Waits for the host frame; returns a copy of it."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self.host.numpy().copy()


def interactive_key(st, struct: ck.KernelStruct, width: int, height: int,
                    fsaa: int, cfg: TraceConfig) -> tuple:
    """What an interactive frame's capture freezes: the kernel structure
    (by identity; the program holds it), the frame, the config, the
    Whitted gates, the module settings the launch reads, and last the
    scene structure (``SceneStructure``, by identity), whose plan and
    tables the update launch reads."""
    return (id(struct), width, height, fsaa, cfg,
            ck.cull_gates(struct, cfg).flags, ck.COOP_MAX_LIVE,
            ck.EMIT_OWN_MIN_KEPT, ck.WHOLE_OWN_MAX_RAYS, id(st))


class InteractiveProgram(_Program):
    """The interactive Whitted frame, update to frame, with fixed inputs,
    for one scene structure, (W, H, fsaa, TraceConfig, device) and the
    module settings of ``interactive_key``: the counterpart of the JAX
    engine's update, pack and render executables called back to back. Its
    body, captured in one CUDA graph: the copy of the moving nodes' values
    (``SceneStructure.local_inputs``) from the program's pinned buffer,
    the scene update's launch into the program's field buffers
    (``ops.update.launch``), one pack launch of the tables those fields
    feed into the program's table buffers (``ck.pack_parts``), camera
    rays, the Whitted launch (``ck.launch_whitted``), clamp,
    ``resolve_aa``, ``to_frame`` and the copy into the pinned host frame.
    ``run_at`` evaluates the animators and the camera on the host, writes
    their values into the pinned buffer and runs the body (the first
    time, and captures it) or replays it.

    The groups that can move (``SceneStructure.moving``) are rewritten
    at every replay, whether or not their transforms changed: the launch
    is deterministic, so an unmoved group's bits are the last frame's,
    and a graph that branched on the host's keys would need one capture a
    subset. The other fields, and the tables no moving field feeds, are
    the structure's last frame's, fixed. The program's buffers are never
    handed out: the engine marks its arrays stale after a frame
    (``Scene.render_interactive``)."""

    def __init__(self, st, struct: ck.KernelStruct, width: int, height: int,
                 fsaa: int, cfg: TraceConfig, device):
        super().__init__(interactive_key(st, struct, width, height, fsaa,
                                         cfg), struct, width, height, cfg,
                         device)
        self.fsaa = fsaa
        self.replay = None
        self.st = st
        self.fields = {k: torch.empty(s, dtype=F32, device=self.device)
                       for k, s in upd.field_shapes(st, st.moving).items()}
        self.parts = tuple(n for n, _, reads in ck.PACK_PARTS
                           if set(reads) & set(self.fields))
        nd = st.tables.nd
        self.local = torch.empty((nd, upd.IN_W), dtype=F32,
                                 device=self.device)
        self.values = torch.zeros((nd, upd.IN_W), dtype=F32,
                                  pin_memory=self.device.type == "cuda")
        self.scratch = torch.empty((st.tables.nq, 16), dtype=F32,
                                   device=self.device)
        self._sc = dataclasses.replace(st.last, **self.fields)
        self.stt = ck._struct_tensors(struct, self.device)
        fixed = ck._get_packed(st.last, struct)
        for k in CAMERA + ("use_gamma",):
            self.inputs.own(k, getattr(self._sc, k))
        for f in ck.PackedScene._fields:
            t = getattr(fixed, f)
            self.inputs.own(f, torch.empty_like(t) if f in self.parts
                            else t)

    def run_at(self, time: float, cam_trm) -> np.ndarray:
        """The frame at (time, cam_trm); raises ValueError where the
        hierarchy differs from the one recorded. The pinned values are
        written here, after the previous frame's wait (``_fetch``
        synchronises the stream a frame), so the copy of the frame before
        has read them."""
        self.stage_values(time, cam_trm)
        self.launch()
        return self._fetch()

    def stage_values(self, time: float, cam_trm):
        st = self.st
        st.check()
        self.values.numpy()[...] = st.local_inputs(
            st.local_values(time, cam_trm))

    def launch(self):
        if self.replay is None:
            self.replay = capture(self._body, self.device)
        else:
            self.replay()

    def _body(self):
        # the update and the pack into the program's buffers
        self.local.copy_(self.values, non_blocking=True)
        upd.launch(self.st, self.local, self.fields, self.scratch)
        ck.pack_parts(self.parts, self._sc, self.struct, self.stt,
                      out={p: self.inputs.buf[p] for p in self.parts})
        # render_cuda, then to_frame, on the buffers
        cam, w, h = self.inputs.camera(), self.width, self.height
        org, dirs = camera_rays(cam.cam_pos, cam.cam_hor, cam.cam_ver,
                                cam.cam_nrm, cam.cam_pov, w, h, self.fsaa)
        t_min = cam.cam_pov.expand(dirs.shape[0])
        cols = ck.launch_whitted(self._traced(), self.struct,
                                 self.inputs.tables(), org, dirs, t_min,
                                 self.cfg)
        self._send(resolve_aa(torch.clamp(cols, 0.0, 1.0), w, h, self.fsaa))

    def _traced(self):
        """The SceneArrays the Whitted launch is given: the kernel reads
        its shapes, the plain tracer on the CPU the scene itself. The
        plain tracer's culling tables are cached by the identity of the
        fields they read (ck._get_cull_plain), which the update writes in
        place: on the CPU it gets them as new tensors."""
        if self.device.type == "cuda":
            return self._sc
        return dataclasses.replace(self._sc, **{
            k: v.clone() for k, v in self.fields.items()})


class PassProgram(_Program):
    """A path-traced pass with fixed inputs, for one (structure, W, H,
    TraceConfig, device) and PT's gates (``pass_key``): ``passes`` adds n
    passes to its own running sum and seeds, the first by the body (and
    its capture), the rest by replays; ``frame`` is the uint8 frame of the
    mean."""

    def __init__(self, struct: ck.KernelStruct, width: int, height: int,
                 cfg: TraceConfig, device):
        super().__init__(pass_key(struct, width, height, cfg), struct,
                         width, height, cfg, device)
        n = width * height
        self.inputs.own("acc", torch.zeros((n, 3), dtype=F32,
                                           device=self.device))
        self.inputs.own("seeds", torch.zeros((n,), dtype=I32,
                                             device=self.device))
        self.mean = None       # the frame's mean, made by its first call
        self.replay = self.frame_replay = None

    def stage(self, sc, acc: Optional[torch.Tensor], seeds: torch.Tensor):
        """The scene's inputs (the camera, use_gamma and PT's packed
        tables; sc stays for the launch's shape checks and for the plain
        tracer on the CPU), the seeds, and the running sum. acc None is a
        run from a zero sum (``render_pt_cuda``), which takes the caller's
        seeds by value: the caller may write them in place between
        calls."""
        for k in CAMERA + ("use_gamma",):
            self.inputs.stage(k, getattr(sc, k))
        ps = ck.pt_tables(sc, self.struct, self.cfg)
        for f in ck.PackedScene._fields:
            self.inputs.stage(f, getattr(ps, f))
        self._sc = sc
        if acc is None:
            self.inputs.own("acc", self.inputs.buf["acc"].zero_())
            self.inputs.own("seeds", self.inputs.buf["seeds"].copy_(seeds))
        else:
            self.inputs.stage("acc", acc)
            self.inputs.stage("seeds", seeds)

    def passes(self, sc, acc: Optional[torch.Tensor], seeds: torch.Tensor,
               n: int):
        """n passes from (acc, seeds); returns the program's sum and seeds
        buffers, which the next call of any kind overwrites."""
        self.stage(sc, acc, seeds)
        for _ in range(n):
            if self.replay is None:
                self.replay = capture(self._pass, self.device)
            else:
                self.replay()
        return self.inputs.buf["acc"], self.inputs.buf["seeds"]

    def frame(self, samples: int) -> np.ndarray:
        """The frame of the running sum over ``samples`` (at least 1): the
        division is the eager op, outside the graph (its divisor changes
        every call), then clamp, to_frame and the copy, replayed."""
        if self.mean is None:
            self.mean = torch.empty_like(self.inputs.buf["acc"])
        torch.div(self.inputs.buf["acc"], max(samples, 1), out=self.mean)
        if self.frame_replay is None:
            self.frame_replay = capture(self._frame, self.device)
        else:
            self.frame_replay()
        return self._fetch()

    def _pass(self):
        # pt_passes' loop body, on the buffers, the sum and seeds in place
        b, n = self.inputs.buf, self.width * self.height
        org, dirs, seeds = pt_camera_rays(self.inputs.camera(), self.width,
                                          self.height, b["seeds"])
        rad, seeds = ck.launch_pt(self._sc, self.struct, self.inputs.tables(),
                                  org, dirs, b["cam_pov"].expand(n), seeds,
                                  self.cfg)
        b["acc"].add_(rad)
        b["seeds"].copy_(seeds)

    def _frame(self):
        self._send(torch.clamp(self.mean, 0.0, 1.0).reshape(
            self.height, self.width, 3))


_PT_PROGRAMS: OrderedDict = OrderedDict()


def pt_program(struct: ck.KernelStruct, width: int, height: int,
               cfg: TraceConfig, device) -> PassProgram:
    """``render_pt_cuda``'s pass program for the key, made on first use;
    the PT_PROGRAMS most recently used are kept (each holds the structure
    it was made for)."""
    device = torch.device(device)
    key = pass_key(struct, width, height, cfg) + (str(device),)
    prog = _PT_PROGRAMS.get(key)
    if prog is None:
        prog = _PT_PROGRAMS[key] = PassProgram(struct, width, height, cfg,
                                               device)
        while len(_PT_PROGRAMS) > PT_PROGRAMS:
            _PT_PROGRAMS.popitem(last=False)
    _PT_PROGRAMS.move_to_end(key)
    return prog
