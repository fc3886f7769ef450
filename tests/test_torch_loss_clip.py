"""The port's clip (``ops/trace.py`` ``clip``) against ``jnp.clip``,
whose gradient at a tie with either bound is one half where
``torch.clamp`` passes all of it: the helper itself, the training loss
``_weighted_mse`` on seeded colours with exact 0s and 1s and on ROADMAP
section 3's case (test13 at 48x32, K=4, lane 1041, whose red channel is
exactly 0.0), and the two clips of ``replay_color`` and of the plain
tracer's shading (``trace_rays_diff``) going through it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadray_tpu_torch.ops import replay as treplay
from quadray_tpu_torch.ops import trace as ttrace
from quadray_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

# the JAX and port losses are the same f32 operations in the same order up
# to the final division, so their gradients agree to a few ulps
GRAD_RTOL = 1e-6
# ROADMAP's case runs the replay in both packages (op by op in JAX), which
# agree within 1.6e-5 of the largest gradient (ROADMAP section 3); a
# missing half at the tie is off by 100%
CASE_RTOL = 1e-4


def _tied(rs, n, lo, hi):
    """Seeded values around [lo, hi] with every fourth one exactly lo and
    every fifth exactly hi."""
    x = rs.uniform(lo - 0.5, hi + 0.5, n).astype(np.float32)
    x[::4] = lo
    x[1::5] = hi
    return x


@pytest.mark.parametrize("lo, hi", [(0.0, 1.0), (1e-6, 1.0)])
def test_clip_matches_jnp_clip_and_its_gradient(lo, hi):
    """Forward bitwise jnp.clip's (and torch.clamp's, NaN kept); the
    gradient of a weighted sum jnp.clip's, one half at each tie."""
    rs = np.random.RandomState(7)
    x = _tied(rs, 4001, lo, hi)
    x[7] = np.nan
    wt = rs.standard_normal(x.shape).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_()
    got = ttrace.clip(t, lo, hi)
    (got * torch.from_numpy(wt)).sum().backward()
    want, jvjp = jax.vjp(lambda v: jnp.clip(v, lo, hi), jnp.asarray(x))
    (jg,) = jvjp(jnp.asarray(wt))
    # bitwise, NaN as NaN whatever its payload
    bits = lambda a: np.where(np.isnan(a), -1, np.asarray(a).view(np.int32))
    assert np.array_equal(bits(got.detach().numpy()), bits(want))
    assert np.array_equal(bits(got.detach().numpy()),
                          bits(torch.clamp(t, lo, hi).detach().numpy()))
    assert np.isnan(got[7].item())
    # the gradient equal in value (a zero's sign aside) where x is a number
    # (at a NaN, whose loss is NaN, torch passes the gradient, JAX 0)
    num = ~np.isnan(x)
    assert np.array_equal(t.grad.numpy()[num], np.asarray(jg)[num])
    ties = (x == lo) | (x == hi)
    assert np.array_equal(t.grad.numpy()[ties], 0.5 * wt[ties])


def _jax_loss(cols, target, w):
    """The reference's loss (quadray_tpu/parallel/train.py:45-47, 88-90)."""
    cols = jnp.clip(cols, 0.0, 1.0)
    err = jnp.sum(((cols - target) ** 2) * w[:, None])
    return err / jnp.maximum(jnp.sum(w) * 3.0, 1.0)


def test_weighted_mse_gradient_matches_jax_at_ties():
    """Seeded colours with exact 0s and 1s (and some masked rays): the
    loss and its gradient against the reference's, within GRAD_RTOL of
    the largest gradient; at the ties the gradient is half torch.clamp's."""
    rs = np.random.RandomState(15)
    n = 3 * 1024
    cols = _tied(rs, n, 0.0, 1.0).reshape(-1, 3)
    target = rs.uniform(0.0, 1.0, cols.shape).astype(np.float32)
    w = (rs.uniform(size=cols.shape[0]) < 0.9).astype(np.float32)
    t = torch.from_numpy(cols).requires_grad_()
    loss = ttrain._weighted_mse(t, torch.from_numpy(target),
                                torch.from_numpy(w))
    loss.backward()
    jl, jg = jax.value_and_grad(_jax_loss)(jnp.asarray(cols),
                                           jnp.asarray(target),
                                           jnp.asarray(w))
    jg = np.asarray(jg)
    scale = np.abs(jg).max()
    assert abs(loss.item() - float(jl)) <= GRAD_RTOL * abs(float(jl))
    assert np.abs(t.grad.numpy() - jg).max() <= GRAD_RTOL * scale
    ties = ((cols == 0.0) | (cols == 1.0)) & (w[:, None] > 0) & (
        cols != target)
    assert ties.sum() > 100
    # the loss as it was, with torch.clamp
    c = torch.from_numpy(cols).requires_grad_()
    wt = torch.from_numpy(w)
    (torch.sum(((torch.clamp(c, 0.0, 1.0) - torch.from_numpy(target)) ** 2)
               * wt[:, None])
     / torch.clamp(torch.sum(wt) * 3.0, min=1.0)).backward()
    assert np.allclose(t.grad.numpy()[ties], 0.5 * c.grad.numpy()[ties],
                       rtol=GRAD_RTOL, atol=0.0)


def test_roadmap_case_test13_lane_1041_matches_jax():
    """ROADMAP section 3: test13 at 48x32, K=4, the trace-replay loss of
    lane 1041 alone (w one-hot; target seeded), whose red channel is
    exactly 0.0 (material 6, colour (0, 0.50, 0.82)): d loss / d
    m_col[6, 0] against the reference's loss over the JAX replay, op by
    op, on the same records (the port's plain trace_paths, bitwise the
    JAX kernel's: tests/test_torch_paths.py). With torch.clamp the port
    gave twice JAX's (0.2234 against 0.1117 on the clean render)."""
    from test_torch_replay import _torch_scene
    from quadray_tpu.models.scenes.loader import load_scene
    from quadray_tpu.ops.rays import camera_rays as jrays
    from quadray_tpu.ops.replay import replay_color as jreplay
    from quadray_tpu.ops.trace import TraceConfig as JConfig
    from quadray_tpu.scene import schema as S
    from quadray_tpu.scene.compile import compile_scene

    w, h, k, lane = 48, 32, 4, 1041
    sd = load_scene("test13")
    j = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    org1, dirs = jrays(j.cam_pos, j.cam_hor, j.cam_ver, j.cam_nrm,
                       j.cam_pov, w, h, 1)
    n = dirs.shape[0]
    jr = (jnp.broadcast_to(org1[None, :], (n, 3)), dirs,
          jnp.full((n,), j.cam_pov, jnp.float32))
    # the lane alone: the loss and its gradient are its own
    jr = tuple(a[lane:lane + 1] for a in jr)
    tr = tuple(torch.from_numpy(np.array(a)) for a in jr)
    cfg = ttrace.TraceConfig(max_segments=k, stack=4)
    sc, _ = _torch_scene(j, ())
    _, tpaths = ttrace.trace_paths(sc, *tr, cfg, k)
    target = np.random.RandomState(1041).uniform(
        0.25, 0.75, (1, 3)).astype(np.float32)
    wmask = np.ones((1,), np.float32)

    tsc, leaves = _torch_scene(j, ("m_col",))
    cols = treplay.replay_color(tsc, *tr, tpaths, cfg)
    assert cols[0, 0].item() == 0.0       # the tie
    ttrain._weighted_mse(cols, torch.from_numpy(target),
                         torch.from_numpy(wmask)).backward()
    got = leaves["m_col"].grad[6, 0].item()

    def jloss(m_col):
        c = jreplay(j.replace(m_col=m_col), *jr,
                    jnp.asarray(tpaths.numpy()), JConfig(max_segments=k,
                                                         stack=4))
        return _jax_loss(c, jnp.asarray(target), jnp.asarray(wmask))
    with jax.disable_jit():
        want = float(jax.grad(jloss)(j.m_col)[6, 0])
    assert want != 0.0
    assert abs(got - want) <= CASE_RTOL * abs(want), (got, want)


def test_replay_and_shading_clip_through_the_helper(monkeypatch):
    """The clips of replay_color (specular cosine, Fresnel) and of the
    plain tracer's shading under trace_rays_diff go through clip, with
    jnp.clip's bounds (quadray_tpu/ops/replay.py:268, 305; ops/trace.py:
    459, 549), so their gradients split ties as JAX's do."""
    from test_torch_replay import _torch_scene
    from quadray_tpu.models.scenes.loader import load_scene
    from quadray_tpu.scene import schema as S
    from quadray_tpu.scene.compile import compile_scene
    from quadray_tpu_torch.ops.rays import camera_rays

    seen = {"replay": set(), "trace": set()}
    clip = ttrace.clip

    def spy(where):
        def f(x, lo, hi):
            seen[where].add((lo, hi))
            return clip(x, lo, hi)
        return f
    monkeypatch.setattr(treplay, "clip", spy("replay"))
    monkeypatch.setattr(ttrace, "clip", spy("trace"))
    sd = load_scene("test13")
    j = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    sc, leaves = _torch_scene(j, ("m_col",))
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, 16, 8, 1)
    tmin = sc.cam_pov.expand(dirs.shape[0])
    cfg = ttrace.TraceConfig(max_segments=2, stack=4)
    _, paths = ttrace.trace_paths(sc, org, dirs, tmin, cfg, 2)
    treplay.replay_color(sc, org, dirs, tmin, paths, cfg).sum().backward()
    ttrace.trace_rays_diff(sc, org, dirs, tmin, cfg).sum().backward()
    assert seen["replay"] == {(1e-6, 1.0), (0.0, 1.0)}
    assert seen["trace"] == {(1e-6, 1.0), (0.0, 1.0)}
