"""The port's train steps (``parallel/train.py``) and training checkpoint
(``parallel/checkpoint.py``) against the JAX package's, on the recovery
task of tests/test_replay.py:96-119: test01 at 48x32 with every surface
moved by +0.05, the clean render as the target, K=4, Adam lr 5e-3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadray_tpu.models.scenes.loader import load_scene
from quadray_tpu.ops.trace import TraceConfig as JConfig
from quadray_tpu.ops.trace import render as jrender
from quadray_tpu.parallel import train as jtrain
from quadray_tpu.parallel.mesh import ray_mesh
from quadray_tpu.scene import schema as S
from quadray_tpu.scene.compile import compile_scene
from quadray_tpu_torch.ops.trace import TraceConfig
from quadray_tpu_torch.parallel import train as ttrain
from quadray_tpu_torch.parallel.checkpoint import (
    latest_checkpoint, load_checkpoint, save_checkpoint)
from quadray_tpu_torch.scene.compile import FIELDS, scene_arrays_from_numpy

torch.set_num_threads(1)

W, H, K, LR, STEPS = 48, 32, 4, 5e-3, 3
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
KW = dict(lr=LR, k_paths=K)


def _np(tree):
    return {k: np.array(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def task():
    """The JAX run, 4 steps: params and optax state before each step, and
    the losses. Its start is shared with the port's runs as numpy."""
    sd = load_scene("test01")
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    target = np.array(jnp.clip(jrender(sc, W, H, 1, JConfig(stack=6)),
                               0.0, 1.0).reshape(-1, 3))
    sc_p = sc.replace(s_pos=sc.s_pos + 0.05)
    step_fn, opt_init = jtrain.make_train_step_fast(
        ray_mesh(jax.devices()[:1]), sc_p, W, H,
        cfg=JConfig(max_segments=4, stack=4), interpret=True, **KW)
    params = jtrain.extract_params(sc_p)
    opt_state = opt_init(params)
    states, losses = [], []
    for _ in range(STEPS + 1):
        s = opt_state[0]
        states.append((_np(params), (np.array(s.count), _np(s.mu),
                                     _np(s.nu))))
        params, opt_state, loss = step_fn(params, opt_state, sc_p,
                                          jnp.asarray(target))
        losses.append(float(loss))
    states.append((_np(params), None))
    tsc = scene_arrays_from_numpy({k: np.asarray(getattr(sc_p, k))
                                   for k in FIELDS}, device="cpu")
    return dict(sc=tsc, target=torch.from_numpy(target), states=states,
                losses=losses)


def _port_step(tsc):
    return ttrain.make_train_step_fast(
        tsc, W, H, cfg=TraceConfig(max_segments=4, stack=4), **KW)


def _assert_params_close(got, want):
    for k, v in want.items():
        err = np.abs(got[k].detach().numpy() - v).max()
        assert err <= PARAM_ATOL, f"{k}: off by {err:.3e}"


def test_train_step_fast_matches_jax(task):
    step_fn, opt_init = _port_step(task["sc"])
    p0 = ttrain.params_from_numpy(task["states"][0][0], device="cpu")
    params, opt_state = p0, opt_init(p0)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step_fn(params, opt_state, task["sc"],
                                          task["target"])
        losses.append(float(loss))
    np.testing.assert_allclose(losses, task["losses"][:STEPS],
                               rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    want = task["states"][STEPS][0]
    _assert_params_close(params, want)
    # the recovery moved the parameters: Adam's steps of about lr each
    moved = max(np.abs(want[k] - task["states"][0][0][k]).max()
                for k in want)
    assert 0.5 * LR < moved <= STEPS * LR
    assert opt_state.count == STEPS


def test_train_scan_equals_steps(task):
    step_fn, opt_init = _port_step(task["sc"])
    run_fn, _ = ttrain.make_train_scan_fast(
        task["sc"], W, H, cfg=TraceConfig(max_segments=4, stack=4), **KW)
    p0 = ttrain.params_from_numpy(task["states"][0][0], device="cpu")
    p1, o1 = p0, opt_init(p0)
    losses = []
    for _ in range(STEPS):
        p1, o1, loss = step_fn(p1, o1, task["sc"], task["target"])
        losses.append(loss)
    p2, o2, losses2 = run_fn(p0, opt_init(p0), task["sc"], task["target"],
                             STEPS)
    assert losses2.shape == (STEPS,)
    assert torch.equal(losses2, torch.stack(losses))
    for k in p1:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(o1.mu[k], o2.mu[k])
        assert torch.equal(o1.nu[k], o2.nu[k])
    # the steps left their inputs as they were
    for k, v in task["states"][0][0].items():
        assert np.array_equal(p0[k].numpy(), v)


def test_adam_state_from_optax_reproduces_the_next_step(task):
    """Start the port from the JAX run's params and optax state after 3
    steps; its 4th step matches the JAX 4th step."""
    step_fn, _ = _port_step(task["sc"])
    params_np, state_np = task["states"][STEPS]
    params = ttrain.params_from_numpy(params_np, device="cpu")
    opt_state = ttrain.opt_state_from_numpy(state_np, device="cpu")
    assert opt_state.count == STEPS
    params, opt_state, loss = step_fn(params, opt_state, task["sc"],
                                      task["target"])
    np.testing.assert_allclose(float(loss), task["losses"][STEPS],
                               rtol=LOSS_RTOL)
    _assert_params_close(params, task["states"][STEPS + 1][0])
    count, mu, nu = ttrain.opt_state_to_numpy(opt_state)
    assert count.dtype == np.int32 and int(count) == STEPS + 1
    assert set(mu) == set(nu) == set(params)


def test_checkpoint_round_trip(task, tmp_path):
    step_fn, opt_init = _port_step(task["sc"])
    p0 = ttrain.params_from_numpy(task["states"][0][0], device="cpu")
    params, opt_state, _ = step_fn(p0, opt_init(p0), task["sc"],
                                   task["target"])
    path = save_checkpoint(str(tmp_path), 1, params, opt_state)
    save_checkpoint(str(tmp_path / "ckpt_00000007.npz"), 7, params,
                    opt_state)
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_00000007.npz")
    step, params2, opt_state2 = load_checkpoint(path, device="cpu")
    assert step == 1 and opt_state2.count == opt_state.count
    for k in params:
        assert torch.equal(params[k], params2[k])
        assert torch.equal(opt_state.mu[k], opt_state2.mu[k])
        assert torch.equal(opt_state.nu[k], opt_state2.nu[k])
    # resuming from the checkpoint continues the run bit for bit
    a = step_fn(params, opt_state, task["sc"], task["target"])
    b = step_fn(params2, opt_state2, task["sc"], task["target"])
    assert torch.equal(a[2], b[2])
    for k in params:
        assert torch.equal(a[0][k], b[0][k])
    assert load_checkpoint(str(tmp_path), device="cpu")[0] == 7


def test_all_surface_train_step_matches_fast_step_loss(task):
    """make_train_step (trace_rays_diff, all surfaces) on the same task:
    its loss is the fast step's loss, since replaying a path reproduces
    the traced color (test01 has no texture), and it lowers the loss."""
    step_fn, opt_init = ttrain.make_train_step(
        W, H, cfg=TraceConfig(max_segments=4, stack=4), lr=LR)
    p0 = ttrain.params_from_numpy(task["states"][0][0], device="cpu")
    params, opt_state = p0, opt_init(p0)
    losses = []
    for _ in range(2):
        params, opt_state, loss = step_fn(params, opt_state, task["sc"],
                                          task["target"])
        losses.append(float(loss))
    np.testing.assert_allclose(losses[0], task["losses"][0], rtol=LOSS_RTOL)
    assert losses[1] < losses[0]
