"""The port's plain Whitted tracer (the CUDA kernel's plain version)
against the JAX package's tracers on identical scene tables. The kernel
itself is tested on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadray_tpu.models.scenes.loader import load_scene
from quadray_tpu.ops.rays import camera_rays as jrays
from quadray_tpu.ops.trace import TraceConfig as JConfig
from quadray_tpu.ops.trace import to_frame as jframe
from quadray_tpu.ops.trace import trace_rays as jtrace
from quadray_tpu.scene import schema as S
from quadray_tpu.scene.compile import compile_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.rays import camera_rays
from quadray_tpu_torch.ops.trace import TraceConfig, to_frame, trace_rays
from quadray_tpu_torch.scene.compile import FIELDS, scene_arrays_from_numpy

torch.set_num_threads(1)

# Linear colors: the port takes sqrt/rsqrt correctly rounded and the
# specular power as exp(p*log c), and XLA contracts the jitted JAX
# tracer's mul/add pairs into FMAs on the CPU; measured max abs diff
# 3.5e-6 (test18) at 64x40 over these scenes.
ATOL = 1e-5

# scene -> the feature it is picked for
SCENES = {
    "test01": "clip programs",
    "test03": "texture; clip programs of width NC=8",
    "test11": "4 lights on pane planes: the exact-boundary case",
    "test15": "conic singularity and texture",
    "test17": "branch stack (can_push), Fresnel and texture",
    "test18": "branch stack (can_push) and Fresnel",
}


def _scene(name):
    sd = load_scene(name)
    j = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    t = scene_arrays_from_numpy({k: np.asarray(getattr(j, k))
                                 for k in FIELDS}, device="cpu")
    return j, t


def _rays(j, t, w, h):
    org, dirs = jrays(j.cam_pos, j.cam_hor, j.cam_ver, j.cam_nrm, j.cam_pov,
                      w, h, 1)
    torg, tdirs = camera_rays(t.cam_pos, t.cam_hor, t.cam_ver, t.cam_nrm,
                              t.cam_pov, w, h, 1)
    assert np.array_equal(np.asarray(dirs), tdirs.numpy())
    n = dirs.shape[0]
    return (org, dirs, jnp.full((n,), j.cam_pov, jnp.float32),
            torg, tdirs, t.cam_pov.expand(n))


def _compare(want, got, use_gamma):
    """Linear colors within ATOL; uint8 frames at most 1 level apart on
    at most 0.5% of pixels."""
    assert np.abs(want - got).max() <= ATOL
    fa = np.asarray(jframe(jnp.clip(want, 0.0, 1.0), use_gamma))
    fb = to_frame(torch.clamp(torch.from_numpy(got), 0.0, 1.0),
                  torch.tensor(float(use_gamma))).numpy()
    d = np.abs(fa.astype(np.int32) - fb.astype(np.int32)).max(-1)
    assert d.max() <= 1 and (d > 0).mean() <= 0.005


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_tracer_matches_jnp(name):
    j, t = _scene(name)
    org, dirs, tmin, torg, tdirs, ttmin = _rays(j, t, 64, 40)
    want = np.asarray(jtrace(j, org, dirs, tmin, JConfig()))
    got = trace_rays(t, torg, tdirs, ttmin, TraceConfig()).numpy()
    _compare(want, got, np.asarray(j.use_gamma))


def test_plain_tracer_matches_pallas_interpret():
    """Against the TPU kernel itself, run in Pallas interpret mode on the
    CPU (as tests/test_cull.py runs it), culling off."""
    from quadray_tpu.ops.pallas_kernel import trace_rays_pallas
    j, t = _scene("test01")
    org, dirs, tmin, torg, tdirs, ttmin = _rays(j, t, 64, 32)
    org = jnp.broadcast_to(org[None, :], dirs.shape)
    want = np.asarray(trace_rays_pallas(j, org, dirs, tmin,
                                        JConfig(cull=False), interpret=True))
    got = trace_rays(t, torg, tdirs, ttmin, TraceConfig()).numpy()
    _compare(want, got, np.asarray(j.use_gamma))


def test_wrapper_on_cpu_tensors_takes_plain_tracer():
    _, t = _scene("test17")
    org, dirs = camera_rays(t.cam_pos, t.cam_hor, t.cam_ver, t.cam_nrm,
                            t.cam_pov, 24, 16, 1)
    tmin = t.cam_pov.expand(dirs.shape[0])
    before = ck.launches
    got = ck.trace_rays_cuda(t, org, dirs, tmin, TraceConfig())
    assert ck.launches == before
    assert torch.equal(got, trace_rays(t, org, dirs, tmin, TraceConfig()))


def test_trace_rays_chunks_are_independent(monkeypatch):
    import quadray_tpu_torch.ops.trace as tr
    _, t = _scene("test18")
    org, dirs = camera_rays(t.cam_pos, t.cam_hor, t.cam_ver, t.cam_nrm,
                            t.cam_pov, 20, 12, 1)
    tmin = t.cam_pov.expand(dirs.shape[0])
    whole = trace_rays(t, org, dirs, tmin, TraceConfig())
    monkeypatch.setattr(tr, "CHUNK", 37)
    assert torch.equal(whole, trace_rays(t, org, dirs, tmin, TraceConfig()))


def test_work_counts_match_the_path_records():
    """The plain tracers' work counts (the kernels' bounds read them): on
    a single-branch scene every segment run writes a non-zero path record,
    and every hit's clear light bit is a shadow ray no blocker stopped.
    Counting changes no output, and trace_rays counts what trace_paths
    does."""
    from quadray_tpu_torch.ops.trace import trace_paths
    _, t = _scene("test01")
    org, dirs = camera_rays(t.cam_pos, t.cam_hor, t.cam_ver, t.cam_nrm,
                            t.cam_pov, 40, 24, 1)
    tmin = t.cam_pov.expand(dirs.shape[0])
    cfg = TraceConfig(max_segments=8, stack=4)
    stats, stats_r = {}, {}
    cols, paths = trace_paths(t, org, dirs, tmin, cfg, 8, stats)
    want = trace_paths(t, org, dirs, tmin, cfg, 8)
    assert torch.equal(cols, want[0]) and torch.equal(paths, want[1])
    assert stats["walks"] == int((paths != 0).sum()) > dirs.shape[0]
    nl = int(t.l_on.sum())
    hits = paths[((paths >> 15) & 1) == 1]
    lit = sum(int((((hits >> (16 + l)) & 1) == 0).sum()) for l in range(nl))
    assert stats["shadow_open"] == lit > 0
    assert 0 < stats["shadow_blocked"] <= hits.numel() * nl - lit
    assert torch.equal(trace_rays(t, org, dirs, tmin, cfg, stats_r), cols)
    assert stats_r == stats
