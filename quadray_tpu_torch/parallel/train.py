"""Inverse rendering: optimize scene parameters from a target image.

The counterpart of ``quadray_tpu.parallel.train``: pixel L2 loss against a
target frame, gradients through the differentiable tracer to surface
transforms, quadric coefficients, materials and lights, and Adam on top.

Three steps, with the JAX names and call shapes, the mesh last and
optional, and without the ``fields`` argument the JAX steps take and
ignore (the params dict names the fields that train):
  * ``make_train_step_fast``: trace-replay differentiation. The path-record
    kernel (``ops.cuda_kernel.trace_paths_with_struct``, detached) traces
    the current scene, and ``ops.replay.replay_color`` re-evaluates the
    colors along those paths under autograd.
  * ``make_train_scan_fast``: S such steps in one call; the losses stay on
    the device and, in a single process, nothing inside the S steps waits
    for the card.
  * ``make_train_step``: the all-surface autodiff path through
    ``ops.trace.trace_rays_diff`` (plain PyTorch, any device).

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

Parameters are a dict of tensors keyed by ``SceneArrays`` field. The
optimizer state is ``AdamState``, optax's ``(count, mu, nu)``; each step
runs ``torch.optim.Adam`` with optax.adam's defaults (betas 0.9/0.999,
eps 1e-8, no weight decay) from that state. Steps are functional: they
return new params and a new state and leave their inputs as they were.
``params_*_numpy`` and ``opt_state_*_numpy`` carry both across from and to
numpy, so a run can start from the JAX package's state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch

from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.replay import replay_color
from quadray_tpu_torch.ops.trace import TraceConfig, clip, trace_rays_diff
from quadray_tpu_torch.parallel.mesh import RayMesh
from quadray_tpu_torch.parallel.render import (check_replicas, replica,
                                               sharded_rays)
from quadray_tpu_torch.scene.compile import SceneArrays

# SceneArrays fields that make sense as optimization variables
DIFFERENTIABLE_FIELDS = (
    "s_pos", "s_inv", "s_sci", "s_scjh", "s_sciw",
    "m_col", "m_dff", "m_spc", "m_rfl", "m_trn", "m_rfr",
    "l_pos", "l_col", "l_cnt", "l_lnr", "l_qdr", "amb_col",
)

# optax.adam's defaults
BETAS = (0.9, 0.999)
EPS = 1e-8

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
    all-surface differentiable tracer."""
    cols = trace_rays_diff(dataclasses.replace(sc, **params), org, dirs,
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
    are those of ``sc``), colors replayed along them under autograd."""
    sc2 = dataclasses.replace(sc, **params)
    _, paths = ck.trace_paths_with_struct(sc2, struct, org, dirs, t_min,
                                          cfg, k_paths)
    cols = replay_color(sc2, org, dirs, t_min, paths, cfg)
    return _weighted_mse(cols, target, w)


def _leaves(params: Params) -> Params:
    """Fresh autograd leaves holding copies of params (the caller's
    tensors are never updated in place)."""
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


def adam_step(leaves: Params, state: AdamState, lr: float) -> AdamState:
    """One ``torch.optim.Adam`` step on leaves holding their gradients,
    started from ``state``; updates leaves in place, returns the new
    state. A leaf the loss did not reach steps with a zero gradient, as
    optax does."""
    ps = list(leaves.values())
    opt = torch.optim.Adam(ps, lr=lr, betas=BETAS, eps=EPS, weight_decay=0.0)
    for k, p in leaves.items():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        opt.state[p] = {"step": torch.tensor(float(state.count)),
                        "exp_avg": state.mu[k].detach().clone(),
                        "exp_avg_sq": state.nu[k].detach().clone()}
    opt.step()
    return AdamState(state.count + 1,
                     {k: opt.state[p]["exp_avg"] for k, p in leaves.items()},
                     {k: opt.state[p]["exp_avg_sq"]
                      for k, p in leaves.items()})


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


def _mesh_step(loss_of, params: Params, opt_state: AdamState, lr: float,
               sc: SceneArrays, rays, mesh: RayMesh):
    """One step over the mesh: ``loss_of(leaves, sc, org, dirs, t_min,
    target, w)`` on each of this process's blocks on its device, loss and
    gradients averaged over the blocks in order, summed across ranks and
    divided by the world size, then one Adam step on the params'
    device."""
    org, dirs, t_min, target, w = rays
    leaves = _leaves(params)
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
    mean = mesh.all_reduce_sum(total / len(mesh.devices)) / mesh.world
    at = 1
    for k in names:
        size = leaves[k].numel()
        leaves[k].grad = mean[at:at + size].reshape(leaves[k].shape)
        at += size
    opt_state = adam_step(leaves, opt_state, lr)
    return ({k: p.detach() for k, p in leaves.items()}, opt_state,
            mean[0])


def _mesh_run(loss_of, width: int, height: int, fsaa: int, lr: float,
              mesh: RayMesh):
    """run_fn(params, opt_state, sc, target_flat, steps) -> (params,
    opt_state, losses (steps,)) of ``_mesh_step``s, the rays padded once;
    every rank must hold the same scene (``check_replicas``). A mesh of
    None is one block on the scene's device."""
    def run_fn(params, opt_state, sc, target_flat, steps: int):
        m = RayMesh((sc.device,)) if mesh is None else mesh
        check_replicas(sc, m)
        rays = _sharded_primary(sc, width, height, fsaa, target_flat, m)
        losses = []
        for _ in range(steps):
            params, opt_state, loss = _mesh_step(loss_of, params, opt_state,
                                                 lr, sc, rays, m)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return run_fn


def _one_step(run_fn):
    def step_fn(params, opt_state, sc, target_flat):
        params, opt_state, losses = run_fn(params, opt_state, sc,
                                           target_flat, 1)
        return params, opt_state, losses[0]

    return step_fn


def _fast_loss_of(struct, cfg: TraceConfig, k_paths: int):
    return lambda p, s, org, dirs, t_min, target, w: _loss_fast(
        p, s, struct, org, dirs, t_min, target, w, cfg, k_paths)


def _paths_struct(sc0: SceneArrays):
    struct = ck.scene_struct(sc0)
    ck.check_paths_struct(struct)
    return struct


def make_train_step_fast(sc0: SceneArrays, width: int, height: int,
                         cfg: TraceConfig = TraceConfig(max_segments=8,
                                                        stack=4),
                         fsaa: int = 1, lr: float = 1e-2,
                         k_paths: int = 8, mesh: RayMesh = None):
    """Fast train step via trace-replay differentiation. Returns (step_fn,
    opt_init); step_fn(params, opt_state, sc, target_flat) -> (params,
    opt_state, loss), target_flat (W*H*fsaa, 3). Requires a single-branch
    scene with at most 16 lights (ValueError otherwise); ``sc0`` supplies
    the static kernel structure, which parameter updates cannot change.
    The params dict names the fields that train. One paths kernel launch
    a block (module docstring)."""
    return _one_step(_mesh_run(_fast_loss_of(_paths_struct(sc0), cfg,
                                             k_paths),
                               width, height, fsaa, lr, mesh)), adam_init


def make_train_scan_fast(sc0: SceneArrays, width: int, height: int,
                         cfg: TraceConfig = TraceConfig(max_segments=8,
                                                        stack=4),
                         fsaa: int = 1, lr: float = 1e-2,
                         k_paths: int = 8, mesh: RayMesh = None):
    """Multi-step trace-replay training. Returns (run_fn, opt_init);
    run_fn(params, opt_state, sc, target_flat, steps) -> (params,
    opt_state, losses (steps,)). The same steps as make_train_step_fast,
    with the camera rays made once; the losses stay on the device, and in
    a single process no step waits for the card, so the host queues the S
    steps ahead of it (over gloo ranks, each step's all-reduce waits for
    it)."""
    return _mesh_run(_fast_loss_of(_paths_struct(sc0), cfg, k_paths), width,
                     height, fsaa, lr, mesh), adam_init


def make_train_step(width: int, height: int,
                    cfg: TraceConfig = TraceConfig(max_segments=8, stack=4),
                    fsaa: int = 1, lr: float = 1e-2, mesh: RayMesh = None):
    """Train step through the all-surface differentiable tracer
    (``trace_rays_diff``). Returns (step_fn, opt_init); step_fn(params,
    opt_state, sc, target_flat) -> (params, opt_state, loss)."""
    return _one_step(_mesh_run(
        lambda p, s, org, dirs, t_min, target, w: loss_fn(
            p, s, org, dirs, t_min, target, w, cfg),
        width, height, fsaa, lr, mesh)), adam_init


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
