"""Trace-replay differentiation of the port (``ops.replay.replay_color``)
and its all-surface reference (``ops.trace.trace_rays_diff``) against the
JAX package's on the same inputs: the same path records, made by the JAX
package's path-record kernel in Pallas interpret mode, carried across as
numpy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadray_tpu.models.scenes.loader import load_scene
from quadray_tpu.ops.pallas_kernel import trace_paths as jpaths
from quadray_tpu.ops.rays import camera_rays as jrays
from quadray_tpu.ops.replay import replay_color as jreplay
from quadray_tpu.ops.trace import TraceConfig as JConfig
from quadray_tpu.ops.trace import trace_rays_diff as jdiff
from quadray_tpu.scene import schema as S
from quadray_tpu.scene.compile import compile_scene
from quadray_tpu_torch.ops.replay import replay_color
from quadray_tpu_torch.ops.trace import TraceConfig, trace_rays_diff
from quadray_tpu_torch.parallel.train import DIFFERENTIABLE_FIELDS
from quadray_tpu_torch.scene.compile import FIELDS, SceneArrays

torch.set_num_threads(1)

W, H, K = 64, 40, 4
PRIMAL_ATOL = 1e-5
GRAD_RTOL = 1e-4      # of each field's largest absolute gradient
# over all lanes, ill-conditioned ones included (cause measured below, in
# test_replay_matches_jax_replay); under tests/test_replay.py's 5e-3
GRAD_RTOL_ALL = 1e-3


def _setup(name):
    sd = load_scene(name)
    j = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    org1, dirs = jrays(j.cam_pos, j.cam_hor, j.cam_ver, j.cam_nrm,
                       j.cam_pov, W, H, 1)
    n = dirs.shape[0]
    org = jnp.broadcast_to(org1[None, :], (n, 3))
    tmin = jnp.full((n,), j.cam_pov, jnp.float32)
    tt = tuple(torch.from_numpy(np.array(a)) for a in (org, dirs, tmin))
    return j, (org, dirs, tmin), tt


def _torch_scene(j, fields):
    """The JAX scene's tables as a port SceneArrays; ``fields`` become
    autograd leaves. Returns (scene, leaves)."""
    leaves = {k: torch.tensor(np.asarray(getattr(j, k)), requires_grad=True)
              for k in fields}
    rest = {k: torch.tensor(np.asarray(getattr(j, k))) for k in FIELDS
            if k not in fields}
    return SceneArrays(**leaves, **rest), leaves


def _grads_close(got, want, fields, rtol=GRAD_RTOL):
    for k in fields:
        a = got[k].grad.numpy()
        b = np.asarray(want[k])
        scale = np.abs(b).max()
        err = np.abs(a - b).max()
        assert err <= rtol * scale, (
            f"{k}: max |grad diff| {err:.3e} vs max |grad| {scale:.3e}")


def _ulp_sensitivity(color_of, dirs):
    """Per lane, the largest change of color_of(dirs) when one component
    of the ray direction moves by one ulp either way."""
    base = color_of(dirs)
    s = torch.zeros(dirs.shape[0])
    for e in range(3):
        for to in (np.inf, -np.inf):
            d2 = dirs.clone()
            d2[:, e] = torch.nextafter(d2[:, e], torch.full_like(d2[:, e], to))
            s = torch.maximum(s, (color_of(d2) - base).abs().amax(dim=1))
    return s.numpy()


@pytest.mark.parametrize("name", ["test01", "test02", "test04"])
def test_replay_matches_jax_replay(name):
    j, jr, tr = _setup(name)
    _, paths = jpaths(j, *jr, JConfig(), k_paths=K, interpret=True)
    tpaths = torch.from_numpy(np.array(paths))
    sc, _ = _torch_scene(j, ())
    with torch.no_grad():
        s = _ulp_sensitivity(lambda dirs: replay_color(
            sc, tr[0], dirs, tr[2], tpaths, TraceConfig()), tr[1])
    well = s <= PRIMAL_ATOL
    assert well.mean() > 0.99

    @jax.jit
    def jgrads(params, wmask):
        def jloss(params):
            cols = jreplay(j.replace(**params), *jr, paths, JConfig())
            return jnp.sum(jnp.clip(cols, 0.0, 1.0) * wmask[:, None]), cols
        return jax.value_and_grad(jloss, has_aux=True)(params)

    def both(wmask):
        """(JAX colors, JAX grads, port colors, port leaves) for the sum
        of clipped colors weighted by wmask."""
        (_, want), jg = jgrads(
            {k: getattr(j, k) for k in DIFFERENTIABLE_FIELDS}, wmask)
        tsc, leaves = _torch_scene(j, DIFFERENTIABLE_FIELDS)
        got = replay_color(tsc, *tr, tpaths, TraceConfig())
        (torch.clamp(got, 0.0, 1.0)
         * torch.from_numpy(wmask)[:, None]).sum().backward()
        return np.asarray(want), jg, got.detach().numpy(), leaves

    # Colors within PRIMAL_ATOL on every lane whose replayed color moves
    # by less than that when its ray direction moves by one ulp; on the
    # others (test04: 14 lanes of 2560, up to 9.4e-5 per ulp) within that
    # 1-ulp change, as in tests/test_torch_paths.py.
    want, jg, got, leaves = both(well.astype(np.float32))
    d = np.abs(got - want).max(axis=1)
    assert d[well].max() <= PRIMAL_ATOL
    assert np.all(d[~well] <= s[~well])
    # gradients of the well-conditioned lanes: GRAD_RTOL
    _grads_close(leaves, jg, DIFFERENTIABLE_FIELDS, GRAD_RTOL)
    # gradients of every lane: GRAD_RTOL_ALL. Measured on test04: the 14
    # ill-conditioned lanes alone differ by up to 2.2e-3 of the largest
    # gradient (s_pos, s_scjh), all lanes together by 5.0e-4 (s_scjh),
    # the other 2546 lanes by 2.0e-5; test01 and test02 have no such lane.
    _, jg, _, leaves = both(np.ones_like(s, np.float32))
    _grads_close(leaves, jg, DIFFERENTIABLE_FIELDS, GRAD_RTOL_ALL)


def test_trace_rays_diff_matches_jax():
    """The all-surface differentiable tracer, test01 at 64x40 with 3
    segments (tests/test_replay.py:51-93 methodology): interior lanes
    only, whose 4-neighbourhood keeps its first-hit surface. The first
    segment's records give the first-hit surfaces; they are those of the
    K=4 records above, whose compiled kernel is reused."""
    j, jr, tr = _setup("test01")
    cfg = JConfig(max_segments=3, stack=2)
    _, paths = jpaths(j, *jr, JConfig(), k_paths=K, interpret=True)
    g = (np.asarray(paths)[0] & 0xFFF).reshape(H, W)
    edge = np.zeros_like(g, bool)
    edge[1:, :] |= g[1:, :] != g[:-1, :]
    edge[:-1, :] |= g[1:, :] != g[:-1, :]
    edge[:, 1:] |= g[:, 1:] != g[:, :-1]
    edge[:, :-1] |= g[:, 1:] != g[:, :-1]
    wmask = (~edge.reshape(-1)).astype(np.float32)
    fields = DIFFERENTIABLE_FIELDS

    def jloss(params):
        cols = jdiff(j.replace(**params), *jr, cfg)
        return jnp.sum(jnp.clip(cols, 0.0, 1.0) * wmask[:, None]), cols

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: getattr(j, k) for k in fields})
    sc, leaves = _torch_scene(j, fields)
    got = trace_rays_diff(sc, *tr, TraceConfig(max_segments=3, stack=2))
    (torch.clamp(got, 0.0, 1.0)
     * torch.from_numpy(wmask)[:, None]).sum().backward()
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() \
        <= PRIMAL_ATOL
    _grads_close(leaves, jg, fields)
