"""Inverse rendering: optimize scene parameters from a target image.

The counterpart of ``quadray_tpu.parallel.train`` on one device: pixel L2
loss against a target frame, gradients through the differentiable tracer
to surface transforms, quadric coefficients, materials and lights, and
Adam on top. The mesh, the ray sharding and the gradient ``pmean`` of the
JAX package are not here; the device is the scene's.

Three steps, with the JAX names and call shapes minus the mesh and the
``fields`` argument the JAX steps take and ignore (the params dict names
the fields that train):
  * ``make_train_step_fast``: trace-replay differentiation. The path-record
    kernel (``ops.cuda_kernel.trace_paths_with_struct``, detached) traces
    the current scene, and ``ops.replay.replay_color`` re-evaluates the
    colors along those paths under autograd.
  * ``make_train_scan_fast``: S such steps in one call; the losses stay on
    the device and nothing inside the S steps waits for the card.
  * ``make_train_step``: the all-surface autodiff path through
    ``ops.trace.trace_rays_diff`` (plain PyTorch, any device).

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
from quadray_tpu_torch.ops.rays import camera_rays
from quadray_tpu_torch.ops.replay import replay_color
from quadray_tpu_torch.ops.trace import TraceConfig, trace_rays_diff
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
    cols = torch.clamp(cols, 0.0, 1.0)
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


def _primary(sc: SceneArrays, width: int, height: int, fsaa: int):
    """Camera rays as the JAX train steps take them: org is the camera
    position on every ray, t_min the camera's pov distance."""
    _, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                          sc.cam_pov, width, height, fsaa)
    n = dirs.shape[0]
    org = sc.cam_pos[None, :].expand(n, 3)
    w = torch.ones((n,), dtype=dirs.dtype, device=dirs.device)
    return org, dirs, sc.cam_pov.expand(n), w


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


def _step(loss_of, params: Params, opt_state: AdamState, lr: float):
    leaves = _leaves(params)
    loss = loss_of(leaves)
    loss.backward()
    opt_state = adam_step(leaves, opt_state, lr)
    return ({k: p.detach() for k, p in leaves.items()}, opt_state,
            loss.detach())


def _paths_struct(sc0: SceneArrays):
    struct = ck.scene_struct(sc0)
    ck.check_paths_struct(struct)
    return struct


def make_train_step_fast(sc0: SceneArrays, width: int, height: int,
                         cfg: TraceConfig = TraceConfig(max_segments=8,
                                                        stack=4),
                         fsaa: int = 1, lr: float = 1e-2,
                         k_paths: int = 8):
    """Fast train step via trace-replay differentiation. Returns (step_fn,
    opt_init); step_fn(params, opt_state, sc, target_flat) -> (params,
    opt_state, loss), target_flat (W*H*fsaa, 3). Requires a single-branch
    scene with at most 16 lights (ValueError otherwise); ``sc0`` supplies
    the static kernel structure, which parameter updates cannot change.
    The params dict names the fields that train."""
    struct = _paths_struct(sc0)

    def step_fn(params, opt_state, sc, target_flat):
        org, dirs, t_min, w = _primary(sc, width, height, fsaa)
        return _step(lambda p: _loss_fast(p, sc, struct, org, dirs, t_min,
                                          target_flat, w, cfg, k_paths),
                     params, opt_state, lr)

    return step_fn, adam_init


def make_train_scan_fast(sc0: SceneArrays, width: int, height: int,
                         cfg: TraceConfig = TraceConfig(max_segments=8,
                                                        stack=4),
                         fsaa: int = 1, lr: float = 1e-2,
                         k_paths: int = 8):
    """Multi-step trace-replay training. Returns (run_fn, opt_init);
    run_fn(params, opt_state, sc, target_flat, steps) -> (params,
    opt_state, losses (steps,)). The same steps as make_train_step_fast,
    with the camera rays made once; the losses stay on the device, and no
    step waits for the card, so the host queues the S steps ahead of
    it."""
    struct = _paths_struct(sc0)

    def run_fn(params, opt_state, sc, target_flat, steps: int):
        org, dirs, t_min, w = _primary(sc, width, height, fsaa)
        losses = []
        for _ in range(steps):
            params, opt_state, loss = _step(
                lambda p: _loss_fast(p, sc, struct, org, dirs, t_min,
                                     target_flat, w, cfg, k_paths),
                params, opt_state, lr)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return run_fn, adam_init


def make_train_step(width: int, height: int,
                    cfg: TraceConfig = TraceConfig(max_segments=8, stack=4),
                    fsaa: int = 1, lr: float = 1e-2):
    """Train step through the all-surface differentiable tracer
    (``trace_rays_diff``). Returns (step_fn, opt_init); step_fn(params,
    opt_state, sc, target_flat) -> (params, opt_state, loss)."""

    def step_fn(params, opt_state, sc, target_flat):
        org, dirs, t_min, w = _primary(sc, width, height, fsaa)
        return _step(lambda p: loss_fn(p, sc, org, dirs, t_min,
                                       target_flat, w, cfg),
                     params, opt_state, lr)

    return step_fn, adam_init


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
