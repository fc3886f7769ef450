"""Inverse rendering: optimize scene parameters from a target image.

The counterpart of ``quadray_tpu.parallel.train``: pixel L2 loss against a
target frame, gradients through the differentiable tracer to surface
transforms, quadric coefficients, materials and lights, and Adam on top.

Three steps, with the JAX names and call shapes, the mesh last and
optional, and without the ``fields`` argument the JAX steps take and
ignore (the params dict names the fields that train):
  * ``make_train_step_fast``: trace-replay differentiation. The path-record
    kernel (``ops.cuda_kernel.trace_paths_with_struct``, detached) traces
    the current scene, and ``ops.replay.replay_color_fused`` re-evaluates
    the colors along those paths, one forward and one backward launch for
    all K segments (on the CPU its plain version, ``replay_plain``).
  * ``make_train_scan_fast``: S such steps in one call, the counterpart of
    the JAX ``lax.scan`` of S steps in one executable; the losses stay on
    the device.
  * ``make_train_step``: the all-surface route, ``trace_rays_diff``'s
    colors and gradients through ``ops.diff.trace_rays_fused``: the
    Whitted kernel's walk with a tape forward, one backward launch with a
    hand-written adjoint (on the CPU their plain versions, which follow
    the element type); the counterpart of the JAX ``make_train_step``'s
    jitted ``step_fn``, and the only route for a scene where a material
    both reflects and transmits (``struct.can_push``), which the fast
    steps refuse. ``ops.trace.trace_rays_diff``, autograd over the plain
    tracer's bounces, stays as its reference.

Every step runs over a mesh (``parallel.mesh.RayMesh``); ``mesh=None``
is one block on the scene's device, built at call time. The rays are
padded to a multiple of the block count with ``dirs = 1``, ``target = 0``
and ``w = 0`` and split in contiguous blocks; each block computes its
shard's loss, ``sum(err * w) / max(sum(w) * 3, 1)``, and gradients on its
own device against a replica of the scene; loss and gradients are averaged over this process's blocks
in block order, then summed across ranks (``all_reduce``) and divided by
the world size: the JAX ``pmean`` over the ray axis, a mean of per-shard
means, padding included. One Adam update follows, the same on every
rank.

The mesh's layout picks the route a step takes (``step_route``):
  * "graph": one process, every block on the scene's device. The step is
    a ``StepProgram``: captured once into a CUDA graph (``ops.graphs
    .capture``) and replayed once a step, the counterpart of the JAX
    step's or scan's one executable; on the CPU its body is called, with
    the plain versions in the kernels' place.
  * "eager": blocks on several devices, or a process group (the
    all-reduce crosses the host or NCCL): every op of every step is
    queued from Python.
``eager=True`` asks for the eager route on any layout (to compare the
two). The routes give the same bits. A capture or a replay that fails
raises; nothing falls back to eager launches.

Parameters are a dict of tensors keyed by ``SceneArrays`` field. The
optimizer state is ``AdamState``, optax's ``(count, mu, nu)``; each step
runs optax.adam's update with its defaults (betas 0.9/0.999, eps 1e-8),
in its order, on the device (``FlatState.adam``). Steps are functional:
they return new params and a new state and leave their inputs as they
were. ``params_*_numpy`` and ``opt_state_*_numpy`` carry both across from
and to numpy, so a run can start from the JAX package's state.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops import trace
from quadray_tpu_torch.ops.diff import trace_rays_fused
from quadray_tpu_torch.ops.graphs import Inputs, capture
from quadray_tpu_torch.ops.replay import replay_color_fused
from quadray_tpu_torch.ops.trace import TraceConfig, clip
from quadray_tpu_torch.parallel.mesh import RayMesh
from quadray_tpu_torch.parallel.render import (check_replicas, replica,
                                               sharded_rays)
from quadray_tpu_torch.scene.compile import FIELDS, SceneArrays

# SceneArrays fields that make sense as optimization variables
DIFFERENTIABLE_FIELDS = (
    "s_pos", "s_inv", "s_sci", "s_scjh", "s_sciw",
    "m_col", "m_dff", "m_spc", "m_rfl", "m_trn", "m_rfr",
    "l_pos", "l_col", "l_cnt", "l_lnr", "l_qdr", "amb_col",
)

# optax.adam's defaults
BETAS = (0.9, 0.999)
EPS = 1e-8
# the step programs a trace-replay run keeps, the most recently used (each
# holds its graph's memory pool: the saved activations of a step, 0.5 GB
# at 800x480); an all-surface run keeps one, whose pool holds a block's
# tape and row gradients
STEP_PROGRAMS = 2
# a step's rays, target and weights (_sharded_primary), as a program
# stages them
RAYS = ("org", "dirs", "t_min", "target", "w")

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    """optax.adam's state: steps taken, first and second moments."""
    count: int
    mu: Params
    nu: Params


def extract_params(sc: SceneArrays, fields=DIFFERENTIABLE_FIELDS) -> Params:
    return {k: getattr(sc, k) for k in fields}


def adam_init(params: Params) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})


def loss_fn(params: Params, sc: SceneArrays, org, dirs, t_min, target, w,
            cfg: TraceConfig):
    """Weighted mean squared pixel error (w masks rays out) through the
    all-surface differentiable route (``ops.diff.trace_rays_fused``: one
    forward launch and a hand-written adjoint's backward launch on the
    card)."""
    cols = trace_rays_fused(dataclasses.replace(sc, **params), org, dirs,
                            t_min, cfg)
    return _weighted_mse(cols, target, w)


def _weighted_mse(cols, target, w):
    # jnp.clip's gradient, which halves at a channel of exactly 0 or 1
    cols = clip(cols, 0.0, 1.0)
    err = torch.sum(((cols - target) ** 2) * w[:, None])
    return err / torch.clamp(torch.sum(w) * 3.0, min=1.0)


def _loss_fast(params: Params, sc: SceneArrays, struct, org, dirs, t_min,
               target, w, cfg: TraceConfig, k_paths: int):
    """The trace-replay loss: path records from the kernel on the scene
    with the current parameters (detached: the discrete path structure is
    piecewise constant in them; unculled, as the scene's bounding spheres
    are those of ``sc``), colors replayed along them by the fused replay
    (its backward the hand-written adjoint)."""
    sc2 = dataclasses.replace(sc, **params)
    _, paths = ck.trace_paths_with_struct(sc2, struct, org, dirs, t_min,
                                          cfg, k_paths)
    cols = replay_color_fused(sc2, org, dirs, t_min, paths, cfg)
    return _weighted_mse(cols, target, w)


class FlatState:
    """A step's params and Adam state in flat buffers on one device, in
    the params' order: ``p``, ``mu`` and ``nu`` one vector each, ``count``
    a device scalar of the steps taken. ``leaves`` are the autograd leaves
    the loss takes, views of ``p``'s storage, so that the update of ``p``
    in place moves them; ``adam`` is the update both routes run. A flat
    gradient in the same order is one vector too."""

    def __init__(self, params: Params, device):
        self.names = list(params)
        self.shapes = [tuple(v.shape) for v in params.values()]
        dtype = params[self.names[0]].dtype
        for v in params.values():
            dtype = torch.promote_types(dtype, v.dtype)
        n = sum(math.prod(s) for s in self.shapes)
        self.p, self.mu, self.nu = (torch.empty((n,), dtype=dtype,
                                                device=device)
                                    for _ in range(3))
        self.count = torch.zeros((), dtype=dtype, device=device)
        self.leaves = {k: v.detach().requires_grad_(True)
                       for k, v in self.tree(self.p).items()}

    def tree(self, flat: torch.Tensor) -> Params:
        """flat's views in the params' names and shapes."""
        out, at = {}, 0
        for k, s in zip(self.names, self.shapes):
            n = math.prod(s)
            out[k] = flat[at:at + n].view(s)
            at += n
        return out

    def stage(self, params: Params, state: AdamState) -> None:
        """Writes params and state into the buffers in place."""
        with torch.no_grad():
            for buf, tree in ((self.p, params), (self.mu, state.mu),
                              (self.nu, state.nu)):
                torch.cat([tree[k].detach().reshape(-1)
                           for k in self.names], out=buf)
            self.count.fill_(state.count)

    def adam(self, g: torch.Tensor, lr: float) -> None:
        """optax.adam's update from the flat gradient g, in place:
        ``scale_by_adam`` then ``scale(-lr)`` and ``apply_updates``, in
        optax's order, the bias corrections from the device's count (the
        count incremented first), so that a captured step reads no host
        value but lr."""
        b1, b2 = BETAS
        with torch.no_grad():
            torch.add((1 - b1) * g, b1 * self.mu, out=self.mu)
            torch.add((1 - b2) * (g * g), b2 * self.nu, out=self.nu)
            self.count.add_(1)
            mu_hat = self.mu / (1 - b1 ** self.count)
            nu_hat = self.nu / (1 - b2 ** self.count)
            self.p.add_(-lr * (mu_hat / (torch.sqrt(nu_hat) + EPS)))

    def result(self, count: int, copy: bool = False):
        """(params, AdamState) of the buffers (copies of them with
        ``copy``); ``count`` the host's count of the steps taken."""
        p, mu, nu = ((t.clone() if copy else t)
                     for t in (self.p, self.mu, self.nu))
        return self.tree(p), AdamState(count, self.tree(mu), self.tree(nu))


def _sharded_primary(sc: SceneArrays, width: int, height: int, fsaa: int,
                     target, mesh: RayMesh):
    """The camera rays, the target and the weights padded to a multiple
    of the mesh's block count (``dirs = 1``, ``target = 0``, ``w = 0``)."""
    org, dirs, t_min, n = sharded_rays(sc, width, height, fsaa, mesh.size)
    npad = dirs.shape[0]
    w = torch.ones((npad,), dtype=dirs.dtype, device=dirs.device)
    if npad != n:
        w[n:] = 0.0
        target = torch.cat([target, target.new_zeros((npad - n, 3))])
    return org, dirs, t_min, target, w


def _mesh_grads(loss_of, leaves: Params, sc: SceneArrays, rays,
                mesh: RayMesh) -> torch.Tensor:
    """``loss_of(leaves, sc, org, dirs, t_min, target, w)`` on each of
    this process's blocks on its device; the loss and the gradients in
    the leaves' order as one flat vector on the rays' device, averaged
    over the blocks in order, summed across ranks and divided by the
    world size."""
    org, dirs, t_min, target, w = rays
    names = list(leaves)
    home = dirs.device
    copies = {home: leaves}
    total = None
    for dev, a, b in mesh.blocks(dirs.shape[0]):
        lv = copies.get(dev)
        if lv is None:
            lv = copies[dev] = {k: v.detach().to(dev).requires_grad_(True)
                                for k, v in leaves.items()}
        loss = loss_of(lv, replica(sc, dev), org.to(dev)[None, :].expand(
            b - a, 3), dirs[a:b].to(dev), t_min[a:b].to(dev),
            target[a:b].to(dev), w[a:b].to(dev))
        grads = torch.autograd.grad(loss, [lv[k] for k in names],
                                    allow_unused=True)
        flat = torch.cat([loss.detach().reshape(1).to(home)] + [
            (torch.zeros_like(leaves[k]) if g is None else g.to(home))
            .reshape(-1) for k, g in zip(names, grads)])
        total = flat if total is None else total + flat
    return mesh.all_reduce_sum(total / len(mesh.devices)) / mesh.world


def _step_body(loss_of, st: FlatState, lr: float, sc: SceneArrays, rays,
               mesh: RayMesh) -> torch.Tensor:
    """One step on st in place; returns the loss (a device scalar)."""
    mean = _mesh_grads(loss_of, st.leaves, sc, rays, mesh)
    st.adam(mean[1:], lr)
    return mean[0]


def _mesh_step(loss_of, params: Params, opt_state: AdamState, lr: float,
               sc: SceneArrays, rays, mesh: RayMesh):
    """The eager step: ``_step_body`` on fresh buffers holding copies of
    params and opt_state, on the rays' device."""
    st = FlatState(params, rays[1].device)
    st.stage(params, opt_state)
    loss = _step_body(loss_of, st, lr, sc, rays, mesh)
    return st.result(opt_state.count + 1) + (loss,)


class StepProgram:
    """A training step with fixed inputs, for one ``StepKey``: the
    counterpart of the body of the JAX scan's ``one_step``
    (``quadray_tpu/parallel/train.py:193-206``) or of the JAX
    ``make_train_step``'s ``step_fn`` (:258). Its body is ``_step_body``
    on the program's own buffers: the params and Adam's state
    (``FlatState``, updated in place), the scene's other fields and the
    rays, target and weights (``ops.graphs.Inputs``, staged by identity);
    each block's loss (trace-replay: the re-pack, the paths launch, its
    work queue zeroed by a ``cudaMemsetAsync`` in the launch, and the
    fused replay's forward; all-surface: the re-pack and the tape launch)
    and ``autograd.grad`` (the fused backward and its row sums; the
    all-surface backward launch, its row sums and light sums), the mean
    over the blocks and Adam. ``run``
    stages a call's inputs, then runs the body (the first time, on a side
    stream, and captures it: ``capture``, the allocator's cache emptied
    between the two, so that the graph's pool can take what the first
    step freed) or replays it, once a step, and copies each step's loss
    out of the program's loss scalar; it returns copies of the
    buffers."""

    def __init__(self, loss_of, lr: float, mesh: RayMesh, params: Params,
                 device):
        self.loss_of, self.lr, self.mesh = loss_of, lr, mesh
        self.device = torch.device(device)
        self.state = FlatState(params, self.device)
        self.inputs = Inputs()
        self.loss = torch.zeros((), dtype=self.state.p.dtype,
                                device=self.device)
        self.replay = None
        self._sc = self._rays = None

    def stage(self, params: Params, opt_state: AdamState, sc: SceneArrays,
              rays) -> None:
        self.state.stage(params, opt_state)
        leaves = self.state.leaves
        for k in FIELDS:
            if k not in leaves:
                self.inputs.stage(k, getattr(sc, k))
        for k, t in zip(RAYS, rays):
            self.inputs.stage(k, t)
        if self._sc is None:
            b = self.inputs.buf
            self._sc = SceneArrays(**{k: leaves[k] if k in leaves else b[k]
                                      for k in FIELDS})
            self._rays = tuple(b[k] for k in RAYS)

    def run(self, params: Params, opt_state: AdamState, sc: SceneArrays,
            rays, steps: int):
        self.stage(params, opt_state, sc, rays)
        losses = self.loss.new_empty((steps,))
        for i in range(steps):
            if self.replay is None:
                self.replay = capture(self._body, self.device,
                                      release=True)
            else:
                self.replay()
            losses[i].copy_(self.loss)
        return self.state.result(opt_state.count + steps, copy=True) + (
            losses,)

    def _body(self):
        self.loss.copy_(_step_body(self.loss_of, self.state, self.lr,
                                   self._sc, self._rays, self.mesh))


def step_route(mesh: Optional[RayMesh], device) -> str:
    """The route of a step over ``mesh`` (None: one block on
    ``device``, the scene's): "graph" in one process with every block on
    ``device`` (a ``StepProgram``), else "eager"."""
    device = torch.device(device)
    if mesh is None or (mesh.group is None
                        and all(d == device for d in mesh.devices)):
        return "graph"
    return "eager"


class StepKey(NamedTuple):
    """What a step's capture freezes: the loss's own (``_FastLoss.key``,
    ``_DiffLoss.key``), the frame, lr, each trained field's (name, shape,
    dtype), the blocks' devices and the device."""
    loss: tuple
    width: int
    height: int
    fsaa: int
    lr: float
    fields: tuple
    devices: tuple
    device: str


def step_key(loss_key: tuple, width: int, height: int, fsaa: int,
             lr: float, params: Params, mesh: RayMesh, device) -> StepKey:
    return StepKey(loss_key, width, height, fsaa, lr, tuple(
        (k, tuple(v.shape), v.dtype) for k, v in params.items()), tuple(
        str(d) for d in mesh.devices), str(torch.device(device)))


class _Run:
    """run_fn(params, opt_state, sc, target_flat, steps) -> (params,
    opt_state, losses (steps,)): ``steps`` steps from the rays padded once,
    on the route the mesh's layout picks (``step_route``), or eager;
    every rank must hold the same scene (``check_replicas``). The graph
    route keeps a ``StepProgram`` a key, the loss's ``keep`` most recently
    used (``programs``); a new program drops the oldest before its
    capture."""

    def __init__(self, loss_of, width: int, height: int, fsaa: int,
                 lr: float, mesh: Optional[RayMesh], eager: bool):
        self.loss_of, self.lr, self.mesh, self.eager = loss_of, lr, mesh, eager
        self.width, self.height, self.fsaa = width, height, fsaa
        self.programs: OrderedDict = OrderedDict()

    def route(self, sc: SceneArrays) -> str:
        return "eager" if self.eager else step_route(self.mesh, sc.device)

    def __call__(self, params: Params, opt_state: AdamState,
                 sc: SceneArrays, target_flat, steps: int):
        m = RayMesh((sc.device,)) if self.mesh is None else self.mesh
        check_replicas(sc, m)
        rays = _sharded_primary(sc, self.width, self.height, self.fsaa,
                                target_flat, m)
        if self.route(sc) == "eager":
            losses = []
            for _ in range(steps):
                params, opt_state, loss = _mesh_step(
                    self.loss_of, params, opt_state, self.lr, sc, rays, m)
                losses.append(loss)
            return params, opt_state, torch.stack(losses)
        key = step_key(self.loss_of.key(sc), self.width, self.height,
                       self.fsaa, self.lr, params, m, sc.device)
        prog = self.programs.get(key)
        if prog is None:
            while len(self.programs) >= self.loss_of.keep:
                self.programs.popitem(last=False)
            prog = self.programs[key] = StepProgram(
                self.loss_of, self.lr, m, params, sc.device)
        self.programs.move_to_end(key)
        return prog.run(params, opt_state, sc, rays, steps)


def _one_step(run_fn: _Run):
    def step_fn(params, opt_state, sc, target_flat):
        params, opt_state, losses = run_fn(params, opt_state, sc,
                                           target_flat, 1)
        return params, opt_state, losses[0]

    step_fn.run = run_fn
    return step_fn


class _FastLoss:
    """The trace-replay loss (``_loss_fast``) of one structure, config and
    K, and what a captured step freezes of it (``key``): the structure
    (by identity: the loss holds it, and with it the scene's shapes), the
    config, K and what the paths launch reads from Python, its gates and
    EMIT_OWN_MIN_KEPT."""
    keep = STEP_PROGRAMS

    def __init__(self, struct, cfg: TraceConfig, k_paths: int):
        self.struct, self.cfg, self.k_paths = struct, cfg, k_paths

    def __call__(self, p, s, org, dirs, t_min, target, w):
        return _loss_fast(p, s, self.struct, org, dirs, t_min, target, w,
                          self.cfg, self.k_paths)

    def key(self, sc: SceneArrays) -> tuple:
        gates = ck.cull_gates(self.struct, self.cfg._replace(cull=False))
        return (id(self.struct), self.cfg, self.k_paths, gates.flags,
                ck.EMIT_OWN_MIN_KEPT)


class _DiffLoss:
    """The all-surface loss (``loss_fn``) of one config, and what a
    captured step freezes of it (``key``): the config, the plain tracer's
    element type, every scene field's shape and dtype and, on the card,
    the scene's structure (the pack and the tape launch read its
    permutation and counts; ``cuda_kernel._get_struct``, by the integer
    tables' identity). One program is kept (``keep``): its pool is a
    block's tape, 0.5 kB a ray at cfg (8, 4) with two lights."""
    keep = 1

    def __init__(self, cfg: TraceConfig):
        self.cfg = cfg

    def __call__(self, p, s, org, dirs, t_min, target, w):
        return loss_fn(p, s, org, dirs, t_min, target, w, self.cfg)

    def key(self, sc: SceneArrays) -> tuple:
        # the KernelStruct the route finds on the card (none on the CPU)
        struct = None if sc.device.type == "cpu" else ck._get_struct(sc)
        return (self.cfg, trace.ELEMENT, tuple(
            (tuple(t.shape), t.dtype) for t in (getattr(sc, k)
                                                 for k in FIELDS)),
                None if struct is None else id(struct))


def _paths_struct(sc0: SceneArrays):
    struct = ck.scene_struct(sc0)
    ck.check_paths_struct(struct)
    return struct


def make_train_step_fast(sc0: SceneArrays, width: int, height: int,
                         cfg: TraceConfig = TraceConfig(max_segments=8,
                                                        stack=4),
                         fsaa: int = 1, lr: float = 1e-2,
                         k_paths: int = 8, mesh: RayMesh = None,
                         eager: bool = False):
    """Fast train step via trace-replay differentiation. Returns (step_fn,
    opt_init); step_fn(params, opt_state, sc, target_flat) -> (params,
    opt_state, loss), target_flat (W*H*fsaa, 3). Requires a single-branch
    scene with at most 16 lights (ValueError otherwise); ``sc0`` supplies
    the static kernel structure, which parameter updates cannot change.
    The params dict names the fields that train. One paths kernel launch
    a block; the mesh's layout picks the route, ``eager`` asks for the
    eager one (module docstring). ``step_fn.run`` is its run_fn."""
    return _one_step(_Run(_FastLoss(_paths_struct(sc0), cfg, k_paths),
                          width, height, fsaa, lr, mesh, eager)), adam_init


def make_train_scan_fast(sc0: SceneArrays, width: int, height: int,
                         cfg: TraceConfig = TraceConfig(max_segments=8,
                                                        stack=4),
                         fsaa: int = 1, lr: float = 1e-2,
                         k_paths: int = 8, mesh: RayMesh = None,
                         eager: bool = False):
    """Multi-step trace-replay training. Returns (run_fn, opt_init);
    run_fn(params, opt_state, sc, target_flat, steps) -> (params,
    opt_state, losses (steps,)). The same steps as make_train_step_fast,
    with the camera rays made once; the losses stay on the device. On the
    graph route the program's first call runs its first step and captures
    the step, and every other step is one replay; in a single process no
    step waits for the card (over gloo ranks each step's all-reduce waits
    for it). ``run_fn.programs`` holds the step programs."""
    return _Run(_FastLoss(_paths_struct(sc0), cfg, k_paths), width, height,
                fsaa, lr, mesh, eager), adam_init


def make_train_step(width: int, height: int,
                    cfg: TraceConfig = TraceConfig(max_segments=8, stack=4),
                    fsaa: int = 1, lr: float = 1e-2, mesh: RayMesh = None,
                    eager: bool = False):
    """Train step through the all-surface differentiable route (the
    colors and gradients of ``trace_rays_diff``, by ``ops.diff.
    trace_rays_fused``), any scene, two-branch ones included. Returns
    (step_fn, opt_init); step_fn(params, opt_state, sc, target_flat) ->
    (params, opt_state, loss). The mesh's layout picks the route, as for
    the fast steps; a block's loss is one pack launch and one tape launch
    (the forward) and its gradient one backward launch, its row sums and
    its light sums, on both routes; on the graph route a step is one
    replay of a CUDA graph of them, the mean over the blocks and Adam,
    whose pool holds a block's tape. More blocks of one device change the
    loss to the mean of the blocks' means, as JAX's pmean does. ``eager``
    asks for the eager route. ``step_fn.run`` is its run_fn."""
    return _one_step(_Run(_DiffLoss(cfg), width, height, fsaa, lr, mesh,
                          eager)), adam_init


# ---------------------------------------------------------------------------
# state to and from numpy
# ---------------------------------------------------------------------------

def params_from_numpy(d: Dict[str, np.ndarray], device="cuda") -> Params:
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in d.items()}


def params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def opt_state_from_numpy(state, device="cuda") -> AdamState:
    """AdamState from optax's (count, mu, nu) as numpy (for example the
    ``ScaleByAdamState`` of an ``optax.adam`` state)."""
    count, mu, nu = state
    return AdamState(int(count), params_from_numpy(mu, device),
                     params_from_numpy(nu, device))


def opt_state_to_numpy(state: AdamState):
    """(count i32, mu, nu) as numpy, in optax's order."""
    return (np.asarray(state.count, np.int32), params_to_numpy(state.mu),
            params_to_numpy(state.nu))
