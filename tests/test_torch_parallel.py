"""The port's parallel layer (``quadray_tpu_torch/parallel/{mesh,render,
distributed,train}.py``) on CPU blocks: sharded frames bitwise the
unsharded frame for 1, 3 and 8 blocks and within the plain tracer's
tolerance of the JAX ``render_sharded`` on its 8-device CPU mesh; the
sharded train steps invariant in the block count within JAX's own bounds
(tests/test_multidevice.py:102-104), their loss, params and Adam's first
moment (the gradient), a block count that does not divide the rays
included, and against the JAX step on the same device count; padded
blocks stay finite; ``scaling_report``, the init's no-op, a rank's
default card and a 2-block checkpoint resume."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadray_tpu.models.scenes.loader import load_scene
from quadray_tpu.ops.trace import TraceConfig as JConfig
from quadray_tpu.ops.trace import render as jrender
from quadray_tpu.ops.trace import to_frame as jframe
from quadray_tpu.parallel import train as jtrain
from quadray_tpu.parallel.mesh import ray_mesh as jmesh
from quadray_tpu.parallel.render import render_sharded as jrender_sharded
from quadray_tpu.scene import schema as S
from quadray_tpu.scene.compile import compile_scene
from quadray_tpu_torch.models.scenes.loader import load_scene as tload
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.rays import camera_rays
from quadray_tpu_torch.ops.replay import replay_color
from quadray_tpu_torch.ops.trace import (TraceConfig, render, to_frame,
                                         trace_rays, trace_rays_diff)
from quadray_tpu_torch.parallel import train as ttrain
from quadray_tpu_torch.parallel.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
from quadray_tpu_torch.parallel.distributed import (
    assemble_frame, init_distributed, scaling_report)
from quadray_tpu_torch.parallel.mesh import (default_devices, pad_to,
                                             ray_mesh)
from quadray_tpu_torch.parallel.render import (
    _sharded_trace, render_sharded, render_sharded_cuda)
from quadray_tpu_torch.scene import schema as TS
from quadray_tpu_torch.scene.compile import (FIELDS, compile_scene as
                                             tcompile, scene_arrays_from_numpy)

torch.set_num_threads(1)

# tests/test_multidevice.py:23-24
W, H = 96, 64
CFG = TraceConfig(depth=2, max_segments=4, stack=2)
JCFG = JConfig(depth=2, max_segments=4, stack=2)
BLOCKS = (1, 3, 8)
# tests/test_torch_trace.py's tolerance of linear colours
ATOL = 1e-5
# the train steps: 48x32 = 1,536 rays, which 5 blocks do not divide
TW, TH, LR = 48, 32, 1e-2
FIELDS_TRAINED = ("m_col", "l_col")
# JAX's device-count invariance bounds (tests/test_multidevice.py:102-104)
INV_LOSS_RTOL, INV_PARAM_RTOL, INV_PARAM_ATOL = 1e-5, 1e-4, 1e-6
# tests/test_torch_train.py's bounds against the JAX step
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4
# optax's first moment against the port's (0.1 x the gradient, at most
# 5e-4 here; they agree to 3e-11)
MU_RTOL, MU_ATOL = 1e-4, 1e-8
CPU = torch.device("cpu")


def cpu_mesh(n):
    return ray_mesh([CPU] * n)


@pytest.fixture(scope="module")
def scenes():
    """test01 as tests/test_multidevice.py compiles it: the JAX arrays and
    the port's SceneArrays of the same tables."""
    sd = load_scene("test01")
    j = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    t = scene_arrays_from_numpy({k: np.asarray(getattr(j, k))
                                 for k in FIELDS}, device="cpu")
    return j, t


@pytest.fixture(scope="module")
def whole(scenes):
    return render(scenes[1], W, H, 1, CFG)


@pytest.mark.parametrize("blocks", BLOCKS)
def test_sharded_render_is_the_unsharded_render(scenes, whole, blocks):
    mesh = cpu_mesh(blocks)
    before = ck.launches
    a = render_sharded(scenes[1], W, H, mesh, cfg=CFG)
    b = render_sharded_cuda(scenes[1], W, H, mesh, cfg=CFG)
    assert ck.launches == before     # CPU blocks take the plain tracer
    assert a.shape == (H, W, 3)
    assert torch.equal(a, whole) and torch.equal(b, whole)


@pytest.mark.parametrize("blocks", BLOCKS)
def test_sharded_trace_culled_band(blocks):
    """A band of test13 at 64x40 (104 surfaces: the culled walk), padded
    to the block count as the sharded render pads, block edges off the
    warps' 32-ray edges."""
    sd = tload("test13")
    sc = tcompile(TS.SceneDef(root=sd.root, opts=TS.OPTS_FULL & ~sd.opts),
                  device="cpu")
    assert ck.cull_gates(ck.scene_struct(sc), TraceConfig()).cull
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, 64, 40, 1)
    dirs = dirs[18 * 64:22 * 64]
    n = dirs.shape[0]
    want = ck.trace_rays_cuda(sc, org, dirs, sc.cam_pov.expand(n))
    npad = pad_to(n, blocks)
    dpad = torch.cat([dirs, torch.ones((npad - n, 3))])
    tmin = sc.cam_pov.expand(npad)
    for fn in (ck.trace_rays_cuda, trace_rays):
        got = _sharded_trace(lambda s, o, d, t: fn(s, o, d, t, TraceConfig()),
                             sc, org, dpad, tmin, cpu_mesh(blocks))
        assert got.shape == (npad, 3)
        assert torch.equal(got[:n], want)


def test_sharded_render_matches_jax_render_sharded(scenes, whole):
    """The port's 8-block frame against the JAX render_sharded on 8 CPU
    devices: linear colours within ATOL, uint8 frames at most one level
    apart on at most 0.5% of the pixels."""
    j, t = scenes
    want = np.asarray(jrender_sharded(j, W, H, jmesh(jax.devices()[:8]),
                                      cfg=JCFG))
    got = render_sharded_cuda(t, W, H, cpu_mesh(8), cfg=CFG).numpy()
    assert np.abs(want - got).max() <= ATOL
    fa = np.asarray(jframe(jnp.asarray(want), j.use_gamma))
    fb = to_frame(torch.from_numpy(got), t.use_gamma).numpy()
    d = np.abs(fa.astype(np.int32) - fb.astype(np.int32)).max(-1)
    assert d.max() <= 1 and (d > 0).mean() <= 0.005


@pytest.fixture(scope="module")
def task(scenes):
    """tests/test_multidevice.py:73's task at 48x32: the clean render as
    the target, materials moved by +0.1; the start as numpy."""
    j, t = scenes
    target = np.array(jnp.clip(jrender(j, TW, TH, 1, JCFG), 0.0, 1.0)
                      .reshape(-1, 3))
    jp = j.replace(m_col=jnp.clip(j.m_col + 0.1, 0.0, 1.0))
    tp = scene_arrays_from_numpy({k: np.asarray(getattr(jp, k))
                                  for k in FIELDS}, device="cpu")
    start = {k: np.asarray(getattr(jp, k)) for k in FIELDS_TRAINED}
    return dict(jsc=jp, sc=tp, target=target, start=start, runs={})


def _make(kind, sc, mesh):
    if kind == "fast":
        return ttrain.make_train_step_fast(sc, TW, TH, cfg=CFG, lr=LR,
                                           k_paths=4, mesh=mesh)
    return ttrain.make_train_step(TW, TH, cfg=CFG, lr=LR, mesh=mesh)


def _run(task, kind, mesh, steps=1):
    """``steps`` steps from the start: (loss, params, Adam's first moment)
    as numpy. After one step the first moment is 0.1 x the step's
    gradient, which the params (moved by about lr in the gradient's sign
    whatever its scale) do not show."""
    step_fn, opt_init = _make(kind, task["sc"], mesh)
    params = ttrain.params_from_numpy(task["start"], device="cpu")
    opt_state = opt_init(params)
    target = torch.from_numpy(task["target"])
    for _ in range(steps):
        params, opt_state, loss = step_fn(params, opt_state, task["sc"],
                                          target)
    return (float(loss), ttrain.params_to_numpy(params),
            ttrain.params_to_numpy(opt_state.mu))


def _one_block(task, kind):
    if kind not in task["runs"]:
        task["runs"][kind] = _run(task, kind, cpu_mesh(1))
    return task["runs"][kind]


def _close(got, want, rtol, atol):
    return all(np.allclose(got[k], want[k], rtol=rtol, atol=atol)
               for k in want)


@pytest.mark.parametrize("kind", ["step", "fast"])
def test_one_block_mesh_is_the_unsharded_step(task, kind):
    """mesh=None is the one-device step: one block on the scene's device,
    the same loss, params and moments bit for bit."""
    loss, params, mu = _one_block(task, kind)
    want_loss, want, want_mu = _run(task, kind, None)
    assert loss == want_loss
    for k in want:
        assert np.array_equal(params[k], want[k]), k
        assert np.array_equal(mu[k], want_mu[k]), k


def _shard_mean(task, kind, blocks):
    """The loss and first moment a mesh of ``blocks`` must give, from the
    unsharded colours at the start: each real ray's error weighted
    1 / (3 * blocks * the real rays of its block), padding rows weighing
    0 (the mean over blocks of each block's weighted mean,
    tests/test_multidevice.py's pmean of per-shard losses). The loss in
    float64; the first moment after one Adam step, 0.1 x the gradient of
    that loss, through autograd on the whole frame."""
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in task["start"].items()}
    sc = dataclasses.replace(task["sc"], **leaves)
    _, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                          sc.cam_pov, TW, TH, 1)
    n = dirs.shape[0]
    org, t_min = sc.cam_pos[None, :].expand(n, 3), sc.cam_pov.expand(n)
    if kind == "fast":
        with torch.no_grad():
            _, paths = ck.trace_paths_with_struct(
                sc, ck.scene_struct(task["sc"]), org, dirs, t_min, CFG, 4)
        cols = replay_color(sc, org, dirs, t_min, paths, CFG)
    else:
        cols = trace_rays_diff(sc, org, dirs, t_min, CFG)
    err = ((torch.clamp(cols, 0.0, 1.0) - torch.from_numpy(task["target"]))
           ** 2).sum(1)
    m = pad_to(n, blocks) // blocks
    real = torch.tensor([min(m, n - (i // m) * m) for i in range(n)],
                        dtype=torch.float64)
    c = 1.0 / (3.0 * blocks * real)
    loss = float((err.detach().double() * c).sum())
    grads = torch.autograd.grad((err * c.float()).sum(), list(leaves.values()))
    return loss, {k: 0.1 * g.numpy() for k, g in zip(leaves, grads)}


@pytest.mark.parametrize("kind,blocks", [("step", 8), ("step", 5),
                                         ("fast", 8), ("fast", 5)])
def test_train_step_block_count_invariant(task, kind, blocks):
    """1 against N blocks within JAX's invariance bounds: the loss, the
    params and Adam's first moment (the gradient). Where the blocks do
    not divide the rays (5 blocks: 308 rays a block, 4 of them padding in
    the last), the mean of the per-shard means is not the global mean:
    the loss and the first moment are held to that mean's, computed from
    the unsharded colours (the 1-block loss differs by 0.74% here, and
    its moment falls outside the bounds), the params to the 1-block
    step's."""
    l1, p1, mu1 = _one_block(task, kind)
    ln, pn, mun = _run(task, kind, cpu_mesh(blocks))
    assert np.isfinite(l1)
    if pad_to(TW * TH, blocks) == TW * TH:
        assert np.isclose(l1, ln, rtol=INV_LOSS_RTOL), (l1, ln)
        want_mu = mu1
    else:
        want, want_mu = _shard_mean(task, kind, blocks)
        assert np.isclose(ln, want, rtol=INV_LOSS_RTOL), (ln, want)
        assert not np.isclose(l1, want, rtol=INV_LOSS_RTOL)
        assert not _close(mu1, want_mu, INV_PARAM_RTOL, INV_PARAM_ATOL)
    for k in p1:
        np.testing.assert_allclose(p1[k], pn[k], rtol=INV_PARAM_RTOL,
                                   atol=INV_PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(mun[k], want_mu[k], rtol=INV_PARAM_RTOL,
                                   atol=INV_PARAM_ATOL, err_msg=k)


def test_train_step_matches_jax_on_five_devices(task):
    """The port's 5-block make_train_step against the JAX make_train_step
    on 5 CPU devices (the padded case: 1,536 rays, 4 of padding): the
    loss, the params and optax's first moment."""
    step, opt_init = jtrain.make_train_step(
        jmesh(jax.devices()[:5]), TW, TH, cfg=JCFG, lr=LR,
        fields=FIELDS_TRAINED)
    params = {k: jnp.asarray(v) for k, v in task["start"].items()}
    params, state, jloss = step(params, opt_init(params), task["jsc"],
                                jnp.asarray(task["target"]))
    loss, got, mu = _run(task, "step", cpu_mesh(5))
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    for k, v in params.items():
        err = np.abs(got[k] - np.asarray(v)).max()
        assert err <= PARAM_ATOL, f"{k}: off by {err:.3e}"
        jmu = np.asarray(state[0].mu[k])
        np.testing.assert_allclose(mu[k], jmu, rtol=MU_RTOL, atol=MU_ATOL,
                                   err_msg=k)


def test_fast_steps_on_padded_blocks_stay_finite(scenes):
    """Two fast steps on 8 blocks of 30x17 = 510 rays (2 rays of padding,
    w = 0), every field training (tests/test_multidevice.py:152: padded
    lanes once poisoned every parameter through the gradient mean)."""
    w, h = 30, 17
    assert pad_to(w * h, 8) == w * h + 2
    sc = scenes[1]
    step, opt_init = ttrain.make_train_step_fast(
        sc, w, h, cfg=CFG, k_paths=4, mesh=cpu_mesh(8))
    params = ttrain.extract_params(sc)
    opt_state = opt_init(params)
    target = torch.zeros((w * h, 3))
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state, sc, target)
        assert np.isfinite(float(loss))
    for k, v in params.items():
        assert bool(torch.isfinite(v).all()), k


def test_scaling_report_harness(scenes):
    def fn(mesh):
        render_sharded(scenes[1], 32, 16, mesh, cfg=CFG)

    rep = scaling_report(fn, device_counts=[1, 2], frames=2,
                         devices=[CPU] * 2)
    assert rep["process_count"] == 1 and rep["device_kind"] == "cpu"
    assert [r["devices"] for r in rep["rows"]] == [1, 2]
    assert all(r["seconds_per_frame"] > 0 for r in rep["rows"])
    assert rep["rows"][0]["efficiency"] == 1.0
    assert rep["rows"][0]["speedup"] == 1.0
    with pytest.raises(ValueError):
        scaling_report(fn, device_counts=[4], devices=[CPU] * 2)


def test_distributed_init_noop(monkeypatch):
    for k in ("QUADRAY_COORDINATOR", "QUADRAY_NUM_PROCESSES",
              "QUADRAY_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()
    out = assemble_frame(torch.ones((4, 4, 3)))
    assert isinstance(out, np.ndarray) and out.shape == (4, 4, 3)
    mesh = cpu_mesh(3)
    assert mesh.group is None and mesh.world == 1 and mesh.size == 3
    # contiguous blocks in ray order
    assert mesh.blocks(12) == [(CPU, 0, 4), (CPU, 4, 8), (CPU, 8, 12)]


def test_default_mesh_is_one_card_a_rank(monkeypatch):
    """A rank's default blocks are its own card under an initialised
    process group (the rank modulo the visible cards), every visible card
    in one process; four cards and the group's rank stand in here."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert default_devices() == tuple(cards)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    for r in range(6):
        monkeypatch.setattr(torch.distributed, "get_rank",
                            lambda group=None, r=r: r)
        assert default_devices() == (cards[r % 4],)


@pytest.mark.parametrize("cuda", [True, False])
def test_init_binds_the_rank_to_its_card(monkeypatch, cuda):
    """init_distributed joins from the env, gloo for CPU tensors and NCCL
    for CUDA ones where a card is visible (gloo alone where none is), and
    makes the rank's own card the current device; the group itself is a
    stand-in here."""
    dist = torch.distributed
    calls, joined = {}, []
    for k, v in (("QUADRAY_COORDINATOR", "127.0.0.1:29500"),
                 ("QUADRAY_NUM_PROCESSES", "8"), ("QUADRAY_PROCESS_ID", "5")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4 * cuda)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("card", d))
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(joined))
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 5)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: joined.append((a, kw)))
    assert init_distributed() is True and init_distributed() is True
    assert joined == [(("cpu:gloo,cuda:nccl" if cuda else "gloo",),
                       dict(init_method="tcp://127.0.0.1:29500",
                            world_size=8, rank=5))]
    assert calls == ({"card": 1} if cuda else {})
    if cuda:
        assert default_devices() == (torch.device("cuda", 1),)


def test_checkpoint_resume_training_two_blocks(task, tmp_path):
    """tests/test_multidevice.py:205 on a 2-block mesh: 4 steps against 2,
    a checkpoint, a restore and 2 more, bitwise."""
    step, opt_init = ttrain.make_train_step(TW, TH, cfg=CFG, lr=LR,
                                            mesh=cpu_mesh(2))
    target = torch.from_numpy(task["target"])
    params = ttrain.params_from_numpy({"m_col": task["start"]["m_col"]},
                                      device="cpu")
    opt_state = opt_init(params)
    p_ref, s_ref = params, opt_state
    for _ in range(4):
        p_ref, s_ref, _ = step(p_ref, s_ref, task["sc"], target)
    p, s = params, opt_state
    for _ in range(2):
        p, s, _ = step(p, s, task["sc"], target)
    path = save_checkpoint(str(tmp_path), 2, p, s)
    step_no, p2, s2 = load_checkpoint(path, device="cpu")
    assert step_no == 2
    for _ in range(2):
        p2, s2, _ = step(p2, s2, task["sc"], target)
    for k in p_ref:
        assert torch.equal(p_ref[k], p2[k]), k
