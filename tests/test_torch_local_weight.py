"""The local weight ``1 - m_trn - m_rfl`` clipped at 0, in the plain
differentiable tracer (``ops/trace.py`` ``trace_rays_diff``, ``local_w``)
and in replay (``ops/replay.py`` ``replay_color``, ``lw``), against the
JAX package's ``jnp.maximum(..., 0.0)`` (``quadray_tpu/ops/trace.py``,
``quadray_tpu/ops/replay.py``), whose gradient at a tie (rfl + trn == 1,
an exact 0) is one half; ``torch.clamp``'s is all of it. ROADMAP section
3's cases: test18's materials 5-7 are tied as compiled, and test13 with
every reflective or transmissive material set to rfl + trn = 1; the loss
is the colours weighted by seeded normal weights (``RandomState(0)``)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from quadray_tpu.models.scenes.loader import load_scene
from quadray_tpu.ops.rays import camera_rays as jrays
from quadray_tpu.ops.replay import replay_color as jreplay
from quadray_tpu.ops.trace import TraceConfig as JConfig
from quadray_tpu.ops.trace import trace_rays_diff as jdiff
from quadray_tpu.scene import schema as S
from quadray_tpu.scene.compile import compile_scene
from quadray_tpu_torch.ops import replay as treplay
from quadray_tpu_torch.ops import trace as ttrace

from test_torch_replay import _torch_scene

torch.set_num_threads(1)

# the two packages run the same f32 operations; their gradients agree to a
# few ulps of each field's largest (a missing half at a tie is off by 100%)
GRAD_RTOL = 1e-5
FIELDS = ("m_rfl", "m_trn")


def _rays(j, w, h):
    org1, dirs = jrays(j.cam_pos, j.cam_hor, j.cam_ver, j.cam_nrm,
                       j.cam_pov, w, h, 1)
    n = dirs.shape[0]
    jr = (jnp.broadcast_to(org1[None, :], (n, 3)), dirs,
          jnp.full((n,), j.cam_pov, jnp.float32))
    return jr, tuple(torch.from_numpy(np.array(a)) for a in jr)


def _compiled(name):
    sd = load_scene(name)
    return compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))


def _weights(n):
    return np.random.RandomState(0).standard_normal((n, 3)).astype(
        np.float32)


def _held(got, want, ties):
    """Each field's gradient within GRAD_RTOL of its largest, and each
    tied entry's within GRAD_RTOL of its own value."""
    for k in FIELDS:
        a, b = got[k], np.asarray(want[k])
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= GRAD_RTOL * scale, (k, a, b)
        for m in ties[k]:
            assert b[m] != 0.0, (k, m)
            assert abs(a[m] - b[m]) <= GRAD_RTOL * abs(b[m]), (k, m, a[m],
                                                             b[m])


def test_trace_rays_diff_local_weight_tie_matches_jax():
    """test18 at 32x20, max_segments=3, stack=4: materials 5, 6 and 7 have
    (rfl, trn) (1, 0), (0, 1) and (0, 1), so their local weight is an
    exact 0; d/d m_rfl and d/d m_trn equal JAX's (with torch.clamp the
    port gave 0.554 against 0.277 for m_rfl[7])."""
    j = _compiled("test18")
    rfl, trn = np.asarray(j.m_rfl), np.asarray(j.m_trn)
    tied = [m for m in range(rfl.shape[0]) if rfl[m] + trn[m] == 1.0]
    assert {5, 6, 7} <= set(tied)
    jr, tr = _rays(j, 32, 20)
    wt = _weights(tr[1].shape[0])
    jcfg = JConfig(max_segments=3, stack=4)

    def jloss(params):
        return jnp.sum(jdiff(j.replace(**params), *jr, jcfg) * wt)
    with jax.disable_jit():   # op by op: no XLA contraction
        jg = jax.grad(jloss)({k: getattr(j, k) for k in FIELDS})
    sc, leaves = _torch_scene(j, FIELDS)
    got = ttrace.trace_rays_diff(sc, *tr, ttrace.TraceConfig(
        max_segments=3, stack=4))
    (got * torch.from_numpy(wt)).sum().backward()
    _held({k: leaves[k].grad.numpy() for k in FIELDS}, jg,
          {"m_rfl": [7], "m_trn": [6]})


def test_replay_local_weight_tie_matches_jax():
    """replay_color on test13 at 48x32, K=4, with every reflective or
    transmissive material set to rfl + trn = 1 (0.25 + 0.75 where it
    transmits, else 1 + 0), on the port's plain records of that scene
    (bitwise the JAX kernel's, tests/test_torch_paths.py): d/d m_trn and
    d/d m_rfl against the JAX replay run op by op (jitted, XLA's CPU
    contraction moves test13's gradients, ROADMAP section 3)."""
    w, h, k = 48, 32, 4
    j = _compiled("test13")
    rfl, trn = np.array(j.m_rfl), np.array(j.m_trn)
    moved = (rfl > 0) | (trn > 0)
    rfl = np.where(trn > 0, 0.25, np.where(rfl > 0, 1.0, rfl)).astype(
        np.float32)
    trn = np.where(trn > 0, 0.75, trn).astype(np.float32)
    assert moved.sum() >= 2 and np.all((rfl + trn)[moved] == 1.0)
    j = j.replace(m_rfl=jnp.asarray(rfl), m_trn=jnp.asarray(trn))
    jr, tr = _rays(j, w, h)
    cfg = ttrace.TraceConfig(max_segments=k, stack=4)
    sc, _ = _torch_scene(j, ())
    _, paths = ttrace.trace_paths(sc, *tr, cfg, k)
    wt = _weights(tr[1].shape[0])

    def jloss(params):
        return jnp.sum(jreplay(j.replace(**params), *jr,
                               jnp.asarray(paths.numpy()),
                               JConfig(max_segments=k, stack=4)) * wt)
    with jax.disable_jit():
        jg = jax.grad(jloss)({f: getattr(j, f) for f in FIELDS})
    tsc, leaves = _torch_scene(j, FIELDS)
    cols = treplay.replay_color(tsc, *tr, paths, cfg)
    (cols * torch.from_numpy(wt)).sum().backward()
    # the tied materials that the records hit carry a gradient
    hit = [m for m in np.nonzero(moved)[0]
           if np.asarray(jg["m_trn"])[m] != 0.0]
    assert hit
    _held({f: leaves[f].grad.numpy() for f in FIELDS}, jg,
          {"m_rfl": [], "m_trn": hit})
