"""One program a training step (``parallel/train.py`` ``StepProgram``, the
counterpart of the JAX ``make_train_scan_fast``'s one ``lax.scan``
executable): on the CPU the program's body runs where the card replays
its graph, and is held bitwise to the eager step; both against the JAX
scan, on the task of tests/test_torch_train.py (test01 at 48x32 with
every surface moved by +0.05, the clean render as the target, K=4,
max_segments=4, Adam lr 5e-3, every differentiable field, 3 steps).
Adam's update against
``optax.adam`` on random moments. On the card: the graphed steps bitwise
the eager ones on 1 and 4 blocks.

JAX is imported inside the tests that use it, so the card's tests run on
a GPU machine without it:
    python -m pytest tests/test_torch_step_graph.py --noconftest -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from quadray_tpu_torch.ops.trace import TraceConfig
from quadray_tpu_torch.parallel import train as ttrain
from quadray_tpu_torch.parallel.mesh import RayMesh, ray_mesh

torch.set_num_threads(1)

W, H, K, LR, STEPS = 48, 32, 4, 5e-3, 3
# tests/test_torch_train.py's bounds against the JAX step
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
ADAM_RTOL = 1e-6
CFG = TraceConfig(max_segments=4, stack=4)
CPU = torch.device("cpu")
BITS = lambda t: t.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def task():
    """The JAX scan: STEPS steps of make_train_scan_fast from the moved
    scene, every differentiable field training; its start as the port's.
    The target is the clean scene's plain render by the port (within
    3.5e-6 of JAX's), the same array for both."""
    import jax
    import jax.numpy as jnp
    from quadray_tpu.models.scenes.loader import load_scene
    from quadray_tpu.ops.trace import TraceConfig as JConfig
    from quadray_tpu.parallel import train as jtrain
    from quadray_tpu.parallel.mesh import ray_mesh as jmesh
    from quadray_tpu.scene import schema as S
    from quadray_tpu.scene.compile import compile_scene
    from quadray_tpu_torch.ops.trace import render
    from quadray_tpu_torch.scene.compile import (FIELDS,
                                                 scene_arrays_from_numpy)
    sd = load_scene("test01")
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    to_torch = lambda s: scene_arrays_from_numpy(
        {k: np.asarray(getattr(s, k)) for k in FIELDS}, device="cpu")
    target = render(to_torch(sc), W, H, 1, TraceConfig(stack=6)).reshape(
        -1, 3).numpy()
    sc_p = sc.replace(s_pos=sc.s_pos + 0.05)
    run_fn, opt_init = jtrain.make_train_scan_fast(
        jmesh(jax.devices()[:1]), sc_p, W, H, cfg=JConfig(max_segments=4,
                                                          stack=4),
        lr=LR, k_paths=K, interpret=True)
    params = jtrain.extract_params(sc_p)
    params, _, losses = run_fn(params, opt_init(params), sc_p,
                               jnp.asarray(target), STEPS)
    return dict(sc=to_torch(sc_p), target=torch.from_numpy(target),
                jax_losses=np.array(losses),
                jax_params={k: np.array(v) for k, v in params.items()},
                runs={})


def _start(sc, fields=ttrain.DIFFERENTIABLE_FIELDS):
    params = {k: getattr(sc, k).clone() for k in fields}
    return params, ttrain.adam_init(params)


def _run(task, blocks, eager, steps=STEPS):
    """``steps`` scan steps from the start on ``blocks`` CPU blocks, on
    the graph route (the program's body) or the eager one; cached."""
    key = (blocks, eager, steps)
    if key not in task["runs"]:
        run_fn, _ = ttrain.make_train_scan_fast(
            task["sc"], W, H, cfg=CFG, lr=LR, k_paths=K,
            mesh=ray_mesh([CPU] * blocks), eager=eager)
        assert run_fn.route(task["sc"]) == ("eager" if eager else "graph")
        p0, o0 = _start(task["sc"])
        task["runs"][key] = run_fn(p0, o0, task["sc"], task["target"],
                                   steps)
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
    """The program's body, its buffers updated in place over the steps,
    against the eager step's fresh buffers a step: loss, params, mu and
    nu bit for bit, on 1 and on 2 blocks of one device."""
    graph = _run(task, blocks, eager=False)
    _assert_bitwise(graph, _run(task, blocks, eager=True))
    assert graph[2].shape == (STEPS,)
    assert graph[2][-1] < graph[2][0]


def test_graph_route_matches_the_jax_scan(task):
    """STEPS steps of the graph route within tests/test_torch_train.py's
    bounds of the JAX make_train_scan_fast's."""
    params, _, losses = _run(task, 1, eager=False)
    np.testing.assert_allclose(losses.numpy(), task["jax_losses"],
                               rtol=LOSS_RTOL)
    for k, v in task["jax_params"].items():
        err = np.abs(params[k].numpy() - v).max()
        assert err <= PARAM_ATOL, f"{k}: off by {err:.3e}"


def test_run_leaves_the_callers_state_and_adds_the_steps(task):
    """A call stages the caller's params and state into the program's
    buffers and returns copies: the inputs are as they were, after a
    second call too, and the count is the input's plus the steps."""
    run_fn, _ = ttrain.make_train_scan_fast(task["sc"], W, H, cfg=CFG,
                                            lr=LR, k_paths=K)
    p0, o0 = _start(task["sc"])
    o0 = o0._replace(count=7, mu={k: v + 0.01 for k, v in o0.mu.items()},
                     nu={k: v + 0.02 for k, v in o0.nu.items()})
    keep = [{k: v.clone() for k, v in t.items()} for t in (p0, o0.mu, o0.nu)]
    p1, o1, _ = run_fn(p0, o0, task["sc"], task["target"], 2)
    p2, o2, _ = run_fn(p1, o1, task["sc"], task["target"], 1)
    assert (o0.count, o1.count, o2.count) == (7, 9, 10)
    assert all(type(o.count) is int for o in (o1, o2))
    for before, after in zip(keep, (p0, o0.mu, o0.nu)):
        for k in before:
            assert torch.equal(BITS(before[k]), BITS(after[k]))
    prog = run_fn.programs[next(iter(run_fn.programs))]
    for t in (p1, o1.mu, o1.nu):
        for v in t.values():
            assert v.untyped_storage().data_ptr() != \
                prog.state.p.untyped_storage().data_ptr()
    assert not torch.equal(p1["s_pos"], p2["s_pos"])


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


# each field of the key: (make_train_scan_fast's arguments, the fields
# that train (None: every differentiable field), the frame's width, the
# StepKey field that must differ)
VARIANTS = {
    "lr": (dict(lr=2 * LR), None, W, "lr"),
    "k_paths": (dict(k_paths=K - 1), None, W, "loss"),
    "W": (dict(), None, W // 2, "width"),
    "trained fields": (dict(), ("s_pos",), W, "fields"),
    "blocks": (dict(mesh=2), None, W, "devices"),
}


@pytest.mark.parametrize("change", list(VARIANTS))
def test_each_key_field_makes_a_new_program(task, monkeypatch, change):
    """A program is captured once and replayed after; a change of lr,
    k_paths, the frame, the trained fields or the block count makes a
    program of another key, captured anew. A field of another shape makes
    another key."""
    rec = _recorded_captures(monkeypatch)
    sc = task["sc"]
    base, _ = ttrain.make_train_scan_fast(sc, W, H, cfg=CFG, lr=LR,
                                          k_paths=K)
    p0, o0 = _start(sc)
    base(p0, o0, sc, task["target"], 2)
    assert rec == {"captures": 1, "replays": 1}
    (key0,) = base.programs
    kw, fields, w, field = VARIANTS[change]
    kw = dict(dict(cfg=CFG, lr=LR, k_paths=K), **kw)
    if "mesh" in kw:
        kw["mesh"] = ray_mesh([CPU] * kw["mesh"])
    run_fn = base
    if change != "trained fields":
        run_fn, _ = ttrain.make_train_scan_fast(sc, w, H, **kw)
    p, o = _start(sc, fields or ttrain.DIFFERENTIABLE_FIELDS)
    target = task["target"] if w == W else torch.zeros((w * H, 3))
    run_fn(p, o, sc, target, 2)
    assert rec == {"captures": 2, "replays": 2}
    key = list(run_fn.programs)[-1]
    differ = {f for f in ttrain.StepKey._fields
              if getattr(key, f) != getattr(key0, f)}
    # a new run's loss holds its own structure
    assert differ - {"loss"} == {field} - {"loss"}
    if field == "loss":
        assert key.loss[2] == K - 1 and key0.loss[2] == K
    if change == "trained fields":
        assert len(base.programs) == 2 and key.loss == key0.loss
        m = RayMesh((CPU,))
        cut = {"s_pos": p0["s_pos"][:-1]}
        assert (ttrain.step_key((), W, H, 1, LR, cut, m, CPU)
                != ttrain.step_key((), W, H, 1, LR, {"s_pos": p0["s_pos"]},
                                   m, CPU))


def test_routes_follow_the_layout(task):
    """One process with every block on the scene's device: the graph
    route, for the all-surface make_train_step too; blocks on other
    devices or a process group: eager."""
    cpu, card = CPU, torch.device("cuda", 0)
    assert ttrain.step_route(None, cpu) == "graph"
    assert ttrain.step_route(RayMesh((cpu,) * 4), cpu) == "graph"
    assert ttrain.step_route(RayMesh((cpu, card)), cpu) == "eager"
    assert ttrain.step_route(RayMesh((cpu,), group=object()), cpu) == "eager"
    step_fn, _ = ttrain.make_train_step(W, H, cfg=CFG, lr=LR)
    assert step_fn.run.route(task["sc"]) == "graph"
    fast, _ = ttrain.make_train_step_fast(task["sc"], W, H, cfg=CFG)
    assert fast.run.route(task["sc"]) == "graph"


def test_adam_update_matches_optax():
    """FlatState.adam against optax.adam's update on random params,
    gradients and moments of several scales, at counts 0, 1 and 41:
    params, moments within 1e-6 relative."""
    import jax.numpy as jnp
    import optax
    rs = np.random.RandomState(3)
    shapes = {"a": (7, 3), "b": (5,), "c": (2, 3, 3)}
    for count in (0, 1, 41):
        p, g, mu, nu = ({k: (rs.standard_normal(s) * 10.0 ** rs.randint(
            -3, 3, s)).astype(np.float32) for k, s in shapes.items()}
            for _ in range(4))
        nu = {k: np.abs(v) for k, v in nu.items()}
        opt = optax.adam(LR)
        state = opt.init({k: jnp.asarray(v) for k, v in p.items()})
        state = (state[0]._replace(
            count=jnp.asarray(count, jnp.int32),
            mu={k: jnp.asarray(v) for k, v in mu.items()},
            nu={k: jnp.asarray(v) for k, v in nu.items()}),) + state[1:]
        upd, new = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                              state, {k: jnp.asarray(v)
                                      for k, v in p.items()})
        want = optax.apply_updates({k: jnp.asarray(v) for k, v in p.items()},
                                   upd)
        t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
        st = ttrain.FlatState(t(p), CPU)
        st.stage(t(p), ttrain.AdamState(count, t(mu), t(nu)))
        st.adam(torch.cat([torch.from_numpy(g[k]).reshape(-1)
                           for k in st.names]), LR)
        got_p, got = st.result(count + 1)
        assert got.count == int(new[0].count) == count + 1
        for k in shapes:
            for x, y in ((got_p[k], want[k]), (got.mu[k], new[0].mu[k]),
                         (got.nu[k], new[0].nu[k])):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=ADAM_RTOL, atol=0, err_msg=k)


# ---- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a step's graph has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 4])
def test_graphed_steps_bitwise_eager_on_card(blocks):
    """test01 at 192x128, K=4, every differentiable field training: 4
    graphed steps (the first the warm-up, then replays) against 4 eager
    ones from the same state, bit for bit, on 1 and 4 blocks of the
    card; a second call replays only."""
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.rays import camera_rays
    from quadray_tpu_torch.scene import schema as S
    from quadray_tpu_torch.scene.compile import compile_scene
    dev = _card()
    w, h = 192, 128
    sd = load_scene("test01")
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device=dev)
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, w, h, 1)
    target = torch.clamp(ck.trace_rays_cuda(
        sc, org, dirs, sc.cam_pov.expand(dirs.shape[0]), CFG), 0.0, 1.0)
    sc = dataclasses.replace(sc, s_pos=sc.s_pos + 0.05)
    mesh = ray_mesh([dev] * blocks)
    runs = {}
    for eager in (False, True):
        run_fn, opt_init = ttrain.make_train_scan_fast(
            sc, w, h, cfg=CFG, lr=LR, k_paths=K, mesh=mesh, eager=eager)
        p0 = ttrain.extract_params(sc)
        ck.paths_launches = 0
        runs[eager] = run_fn(p0, opt_init(p0), sc, target, 4)
        torch.cuda.synchronize()
        assert ck.paths_launches == 4 * blocks
        if not eager:
            graph_fn = run_fn
    _assert_bitwise(runs[False], runs[True])
    prog = graph_fn.programs[next(iter(graph_fn.programs))]
    assert prog.replay.counts["paths_launches"] == blocks
    # the fused replay: one forward, one backward and one row-sum launch
    # a block, no gather forward
    assert prog.replay.counts["replay_launches"] == blocks
    assert prog.replay.counts["replay_backward_launches"] == blocks
    assert "gather_launches" not in prog.replay.counts
    assert prog.replay.counts["gather_backward_launches"] == blocks
