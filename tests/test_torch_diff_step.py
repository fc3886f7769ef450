"""The all-surface training step (``parallel/train.py`` ``make_train_step``,
the counterpart of the JAX ``make_train_step``'s jitted ``step_fn``) as one
program a step. The task: test17 (Fresnel glass: a material that both
reflects and transmits, which the fast steps refuse) at 24x16,
``TraceConfig(max_segments=8, stack=4)``, every differentiable field, Adam
lr 1e-2, the surfaces moved by +0.05, the clean scene's clipped render as
the target. The step's route is ops/diff.py's (one forward and one
backward launch with a hand-written adjoint; its plain versions on the
CPU). On the CPU the program's body runs where the card replays its
graph: held bitwise to the eager step on 1 and 2 blocks, and within
tests/test_torch_parallel.py's bounds of the JAX step; the bounce builds
no tensor from host data; each key field makes a new program. On the card:
the graphed steps bitwise the eager ones on 1 and 4 blocks.

JAX is imported inside the test that uses it, so the card's tests run on a
GPU machine without it:
    python -m pytest tests/test_torch_diff_step.py --noconftest -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.trace import TraceConfig, clip, render, \
    trace_rays_diff
from quadray_tpu_torch.parallel import train as ttrain
from quadray_tpu_torch.parallel.mesh import ray_mesh
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import FIELDS, compile_scene

torch.set_num_threads(1)

SCENE, W, H, LR, STEPS = "test17", 24, 16, 1e-2, 2
CFG = TraceConfig(max_segments=8, stack=4)
# tests/test_torch_parallel.py's bounds against the JAX step, and for
# optax's first moment
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4
MU_RTOL, MU_ATOL = 1e-4, 1e-8
CPU = torch.device("cpu")
BITS = lambda t: t.contiguous().view(torch.int32)


def _task(sc):
    """(sc with every surface moved by +0.05, the clipped plain render of
    sc as the target)."""
    target = clip(render(sc, W, H, 1, CFG), 0.0, 1.0).reshape(-1, 3)
    return dataclasses.replace(sc, s_pos=sc.s_pos + 0.05), target


def _compiled(name, device):
    sd = load_scene(name)
    return compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         device=device)


@pytest.fixture(scope="module")
def task():
    sc, target = _task(_compiled(SCENE, CPU))
    return dict(sc=sc, target=target, runs={})


def _start(sc, fields=ttrain.DIFFERENTIABLE_FIELDS):
    params = {k: getattr(sc, k).clone() for k in fields}
    return params, ttrain.adam_init(params)


def _run(task, blocks, eager):
    """STEPS steps from the start on ``blocks`` CPU blocks, on the graph
    route (the program's body) or the eager one; cached."""
    key = (blocks, eager)
    if key not in task["runs"]:
        step_fn, _ = ttrain.make_train_step(
            W, H, cfg=CFG, lr=LR, mesh=ray_mesh([CPU] * blocks),
            eager=eager)
        assert step_fn.run.route(task["sc"]) == ("eager" if eager
                                                 else "graph")
        p0, o0 = _start(task["sc"])
        task["runs"][key] = step_fn.run(p0, o0, task["sc"], task["target"],
                                        STEPS)
    return task["runs"][key]


def _assert_bitwise(a, b):
    (pa, oa, la), (pb, ob, lb) = a, b
    assert torch.equal(BITS(la), BITS(lb))
    assert oa.count == ob.count
    for what, x, y in (("params", pa, pb), ("mu", oa.mu, ob.mu),
                       ("nu", oa.nu, ob.nu)):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(BITS(x[k]), BITS(y[k])), (what, k)


@pytest.mark.parametrize("blocks", [1, 2])
def test_program_body_is_the_eager_step_bitwise(task, blocks):
    """On a two-branch scene (the fast steps refuse it), the program's
    body, its buffers updated in place over the steps, against the eager
    step's fresh buffers a step: loss, params, mu and nu bit for bit, on
    1 and on 2 blocks of one device; the loss falls."""
    struct = ck.scene_struct(task["sc"])
    assert struct.can_push
    with pytest.raises(ValueError):
        ck.check_paths_struct(struct)
    graph = _run(task, blocks, eager=False)
    _assert_bitwise(graph, _run(task, blocks, eager=True))
    assert graph[2].shape == (STEPS,)
    assert graph[2][-1] < graph[2][0]


def test_step_matches_the_jax_step():
    """One step of the port's make_train_step (the graph route's body)
    against the JAX make_train_step on one CPU device, on the same arrays
    (JAX's compile of test17): the loss, every field's params and optax's
    first moment (0.1 x the gradient) within tests/test_torch_parallel.py's
    bounds."""
    _against_jax({})


def test_schlick_step_matches_the_jax_step():
    """test_step_matches_the_jax_step with Schlick Fresnel
    (TraceConfig.schlick) on both sides, the same bounds."""
    _against_jax({"schlick": True})


def _against_jax(change: dict):
    """One step of each make_train_step, cfg (8, 4) with ``change``."""
    import jax
    import jax.numpy as jnp
    from quadray_tpu.models.scenes.loader import load_scene as jload
    from quadray_tpu.ops.trace import TraceConfig as JConfig
    from quadray_tpu.parallel import train as jtrain
    from quadray_tpu.parallel.mesh import ray_mesh as jmesh
    from quadray_tpu.scene import schema as JS
    from quadray_tpu.scene.compile import compile_scene as jcompile
    from quadray_tpu_torch.scene.compile import scene_arrays_from_numpy
    sd = jload(SCENE)
    jsc = jcompile(JS.SceneDef(root=sd.root, opts=JS.OPTS_FULL & ~sd.opts))
    sc, target = _task(scene_arrays_from_numpy(
        {k: np.asarray(getattr(jsc, k)) for k in FIELDS}, device="cpu"))
    jsc = jsc.replace(s_pos=jsc.s_pos + 0.05)
    step, opt_init = jtrain.make_train_step(
        jmesh(jax.devices()[:1]), W, H,
        cfg=JConfig(max_segments=8, stack=4)._replace(**change), lr=LR)
    jp = jtrain.extract_params(jsc)
    jp, jstate, jloss = step(jp, opt_init(jp), jsc, jnp.asarray(
        target.numpy()))
    step_fn, _ = ttrain.make_train_step(W, H, cfg=CFG._replace(**change),
                                        lr=LR)
    assert step_fn.run.route(sc) == "graph"
    p0, o0 = _start(sc)
    params, state, loss = step_fn(p0, o0, sc, target)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    for k, v in jp.items():
        err = np.abs(params[k].numpy() - np.asarray(v)).max()
        assert err <= PARAM_ATOL, f"{k}: off by {err:.3e}"
        np.testing.assert_allclose(state.mu[k].numpy(),
                                   np.asarray(jstate[0].mu[k]),
                                   rtol=MU_RTOL, atol=MU_ATOL, err_msg=k)


def _host_tensors(task, monkeypatch):
    """The calls of torch.tensor and torch.as_tensor made by the loss
    (``ttrain.loss_fn``) and its backward."""
    calls = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, a, kw))
            return _real(*a, **kw)

        monkeypatch.setattr(torch, name, spy)
    sc, target = task["sc"], task["target"]
    leaves = {k: getattr(sc, k).clone().requires_grad_(True)
              for k in ttrain.DIFFERENTIABLE_FIELDS}
    org, dirs, t_min, target, w = ttrain._sharded_primary(
        sc, W, H, 1, target, ray_mesh([CPU]))
    loss = ttrain.loss_fn(leaves, sc, org[None, :].expand(W * H, 3), dirs,
                          t_min, target, w, CFG)
    torch.autograd.grad(loss, list(leaves.values()))
    monkeypatch.undo()
    return calls


def _assert_scalar_bounds_only(calls):
    assert calls
    for name, a, kw in calls:
        assert "device" not in kw, (name, a, kw)
        assert len(a) == 1 and isinstance(a[0], float), (name, a, kw)


def test_bounce_builds_no_tensor_from_host_data(task, monkeypatch):
    """The loss through the step's route (loss_fn: ops/diff.py, what a
    captured step runs) and its backward call torch.tensor and
    torch.as_tensor only for the zero-dim bounds of the clips (scalars to
    a device op, no copy), never with a device: a CUDA graph cannot hold a
    host-to-device copy."""
    _assert_scalar_bounds_only(_host_tensors(task, monkeypatch))


def test_autograd_route_builds_no_tensor_from_host_data(task, monkeypatch):
    """The same of trace_rays_diff (the autograd route, the step's
    reference) in the loss's place."""
    monkeypatch.setattr(ttrain, "trace_rays_fused", trace_rays_diff)
    _assert_scalar_bounds_only(_host_tensors(task, monkeypatch))


def _recorded_captures(monkeypatch):
    """train's capture replaced by a recorder that runs it (on the CPU:
    the body) and counts the replays of what it returned."""
    rec = {"captures": 0, "replays": 0}
    real = ttrain.capture

    def capture(body, device, **kw):
        rec["captures"] += 1
        run = real(body, device, **kw)

        def replay():
            rec["replays"] += 1
            run()
        return replay

    monkeypatch.setattr(ttrain, "capture", capture)
    return rec


# each change: (make_train_step's arguments, the fields that train (None:
# every differentiable field), the frame's width, the scene (None: the
# task's), the StepKey field that must differ)
VARIANTS = {
    "lr": (dict(lr=2 * LR), None, W, None, "lr"),
    "W": (dict(), None, W // 2, None, "width"),
    "trained fields": (dict(), ("s_pos", "m_col"), W, None, "fields"),
    "cfg": (dict(cfg=CFG._replace(max_segments=4)), None, W, None, "loss"),
    "scene": (dict(), None, W, "test01", "loss"),
}


@pytest.mark.parametrize("change", list(VARIANTS))
def test_each_key_field_makes_a_new_program(task, monkeypatch, change):
    """A program is captured once and replayed after; a new lr, frame,
    set of trained fields, config or scene shape makes a program of
    another key, captured anew, and the one program the all-surface step
    keeps is the new one."""
    rec = _recorded_captures(monkeypatch)
    sc = task["sc"]
    base, _ = ttrain.make_train_step(W, H, cfg=CFG, lr=LR)
    p0, o0 = _start(sc)
    base.run(p0, o0, sc, task["target"], 2)
    assert rec == {"captures": 1, "replays": 1}
    (key0,) = base.run.programs
    kw, fields, w, scene, field = VARIANTS[change]
    if scene is not None:
        sc = _compiled(scene, CPU)
    step_fn = base
    if change != "trained fields" and scene is None:
        step_fn, _ = ttrain.make_train_step(w, H, **dict(
            dict(cfg=CFG, lr=LR), **kw))
    p, o = _start(sc, fields or ttrain.DIFFERENTIABLE_FIELDS)
    target = torch.zeros((w * H, 3))
    step_fn.run(p, o, sc, target, 2)
    assert rec == {"captures": 2, "replays": 2}
    (key,) = step_fn.run.programs
    differ = {f for f in ttrain.StepKey._fields
              if getattr(key, f) != getattr(key0, f)}
    if scene is not None:
        # another scene's shapes: the trained fields' shapes differ too
        assert differ == {"loss", "fields"}
    else:
        assert differ == {field}


# ---- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a step's graph has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 4])
def test_graphed_steps_bitwise_eager_on_card(blocks):
    """test17 at 96x64, every differentiable field training: 3 graphed
    steps (the first the warm-up, then replays) against 3 eager ones from
    the same state, bit for bit, and two eager runs from that state bit
    for bit, on 1 and 4 blocks of the card; the graph launches, a block,
    one pack, one tape forward, one backward and one light-sum call
    (ops/diff.py), no row-sum call (the tables fit the backward's
    accumulators), no row gather and no other counted kernel."""
    dev = _card()
    w, h = 96, 64
    sc = _compiled(SCENE, dev)
    target = torch.clamp(ck.render_cuda(sc, w, h, 1, CFG), 0.0,
                         1.0).reshape(-1, 3)
    sc = dataclasses.replace(sc, s_pos=sc.s_pos + 0.05)
    mesh = ray_mesh([dev] * blocks)
    runs = []
    for eager in (False, True, True):
        step_fn, opt_init = ttrain.make_train_step(w, h, cfg=CFG, lr=LR,
                                                   mesh=mesh, eager=eager)
        assert step_fn.run.route(sc) == ("eager" if eager else "graph")
        p0 = ttrain.extract_params(sc)
        runs.append(step_fn.run(p0, opt_init(p0), sc, target, 3))
        torch.cuda.synchronize()
        if not eager:
            (prog,) = step_fn.run.programs.values()
            assert prog.replay.counts == {
                "pack_launches": blocks, "diff_launches": blocks,
                "diff_backward_launches": blocks,
                "light_sum_launches": blocks}
    _assert_bitwise(runs[0], runs[1])
    _assert_bitwise(runs[1], runs[2])
    assert bool(torch.isfinite(runs[0][2]).all())
