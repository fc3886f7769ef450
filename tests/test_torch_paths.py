"""The plain version of the path-record kernel (``ops.trace.trace_paths``)
against the TPU kernel it ports, the JAX package's ``trace_paths``
(pallas_kernel.py:2296) run in Pallas interpret mode on the CPU. The CUDA
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase D)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadray_tpu.models.scenes.loader import load_scene
from quadray_tpu.ops.pallas_kernel import trace_paths as jpaths
from quadray_tpu.ops.rays import camera_rays as jrays
from quadray_tpu.ops.trace import TraceConfig as JConfig
from quadray_tpu.scene import schema as S
from quadray_tpu.scene.compile import compile_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.trace import TraceConfig, trace_paths, trace_rays
from quadray_tpu_torch.scene.compile import FIELDS, scene_arrays_from_numpy

torch.set_num_threads(1)

W, H, K = 64, 40, 4
ATOL = 1e-5

# scene -> the feature it is picked for
SCENES = {
    "test01": "clip programs, one light",
    "test02": "three lights",
    "test04": "reflect and transmit continuations",
    "test11": "4 lights on pane planes: the exact-boundary case",
    "test15": "conic singularity and texture",
}


def _setup(name, w=W, h=H):
    sd = load_scene(name)
    j = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    t = scene_arrays_from_numpy({k: np.asarray(getattr(j, k))
                                 for k in FIELDS}, device="cpu")
    org1, dirs = jrays(j.cam_pos, j.cam_hor, j.cam_ver, j.cam_nrm,
                       j.cam_pov, w, h, 1)
    n = dirs.shape[0]
    org = jnp.broadcast_to(org1[None, :], (n, 3))
    tmin = jnp.full((n,), j.cam_pov, jnp.float32)
    tt = tuple(torch.from_numpy(np.array(a)) for a in (org, dirs, tmin))
    return j, t, (org, dirs, tmin), tt


def _ulp_sensitivity(t, org, dirs, tmin, cfg):
    """Per lane, the largest color change of the plain tracer when one
    component of the ray direction moves by one ulp either way."""
    base = trace_rays(t, org, dirs, tmin, cfg)
    s = torch.zeros(dirs.shape[0])
    for e in range(3):
        for to in (np.inf, -np.inf):
            d2 = dirs.clone()
            d2[:, e] = torch.nextafter(d2[:, e], torch.full_like(d2[:, e], to))
            s = torch.maximum(s, (trace_rays(t, org, d2, tmin, cfg)
                                  - base).abs().amax(dim=1))
    return s.numpy()


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_paths_match_pallas_interpret(name):
    j, t, jr, tr = _setup(name)
    want_c, want_p = jpaths(j, *jr, JConfig(), k_paths=K, interpret=True)
    want_c, want_p = np.asarray(want_c), np.asarray(want_p)
    got_c, got_p = trace_paths(t, *tr, TraceConfig(), K)
    assert got_p.dtype == torch.int32 and got_p.shape == (K, W * H)
    assert np.array_equal(got_p.numpy(), want_p)
    # Colors: within ATOL on every lane whose color moves by less than
    # ATOL when its ray direction moves by one ulp. On the others the f32
    # result is ill-conditioned and no two orderings of the arithmetic
    # agree to ATOL: on test04 (14 lanes of 2560) one ulp moves the color
    # by up to 9.4e-5, and the JAX package's own jnp tracer and Pallas
    # kernel differ there by 6.2e-5. There the bar is that 1-ulp change
    # (measured: at most 0.75 of it).
    d = np.abs(got_c.numpy() - want_c).max(axis=1)
    s = _ulp_sensitivity(t, *tr, TraceConfig(max_segments=K))
    well = s <= ATOL
    assert well.mean() > 0.99
    assert d[well].max() <= ATOL
    assert np.all(d[~well] <= s[~well])


def test_plain_paths_never_push_like_the_kernel():
    """Training moves m_trn off 0 on opaque materials, so a lane can have
    both a reflection and a transmission to follow, though the scene's
    structure says it cannot (can_push False). The kernel has no branch
    stack then: it follows the reflection and drops the transmission, and
    so must the plain version. Here a version that pushed would differ
    from the kernel on 194 of 2560 lanes. (At the size of the test01 case
    above, the JAX kernel's compiled form is reused.)"""
    j, t, jr, tr = _setup("test01")
    j = j.replace(m_trn=j.m_trn + 5e-3)
    t = scene_arrays_from_numpy({k: np.asarray(getattr(j, k))
                                 for k in FIELDS}, device="cpu")
    _, want_p = jpaths(j, *jr, JConfig(), k_paths=K, interpret=True)
    _, got_p = trace_paths(t, *tr, TraceConfig(), K)
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))


def test_can_push_scene_raises():
    """test17 holds a material that can spawn both a reflection and a
    transmission, which a single path record cannot hold
    (pallas_kernel.py:499, :2306)."""
    _, t, _, tr = _setup("test17", 8, 4)
    with pytest.raises(ValueError):
        trace_paths(t, *tr, TraceConfig(), K)
    with pytest.raises(ValueError):
        ck.trace_paths(t, *tr, TraceConfig(), K)


def test_more_than_16_lights_raise():
    _, t, _, _ = _setup("test01", 8, 4)
    struct = ck.scene_struct(t)._replace(nl=17)
    with pytest.raises(ValueError):
        ck.check_paths_struct(struct)


def test_wrapper_on_cpu_tensors_takes_plain_version():
    _, t, _, tr = _setup("test02", 24, 16)
    before = ck.paths_launches
    got_c, got_p = ck.trace_paths(t, *tr, TraceConfig(), K)
    got2_c, got2_p = ck.trace_paths_with_struct(t, ck.scene_struct(t), *tr,
                                                TraceConfig(), K)
    assert ck.paths_launches == before
    want_c, want_p = trace_paths(t, *tr, TraceConfig(), K)
    for c, p in ((got_c, got_p), (got2_c, got2_p)):
        assert torch.equal(c, want_c) and torch.equal(p, want_p)


def test_records_follow_the_layout():
    """Bit fields of the plain records on test04 (continuations): a lane
    records 0 after the segment it retired in, a miss keeps side +1 and
    sets every active light's bit, and the colors equal trace_rays
    capped at K segments."""
    _, t, _, tr = _setup("test04", 32, 20)
    cols, p = trace_paths(t, *tr, TraceConfig(), K)
    assert torch.equal(cols, trace_rays(t, *tr,
                                        TraceConfig(max_segments=K)))
    p = p.numpy().astype(np.int64) & 0xFFFFFFFF
    nl = int(t.l_on.sum())
    hit = (p >> 15) & 1
    kind = (p >> 13) & 3
    assert set(np.unique(kind)) <= {0, 1, 2} and kind.max() > 0
    # a continuation needs a hit, and a lane that stopped stays at 0
    assert np.all(hit[kind > 0] == 1)
    stopped = np.cumsum(np.vstack([np.zeros((1, p.shape[1]), np.int64),
                                   kind[:-1] == 0]), axis=0) > 0
    assert np.all(p[stopped] == 0)
    miss = (p != 0) & (hit == 0)
    assert miss.any()
    want_miss = (1 << 12) | (((1 << nl) - 1) << 16)
    assert np.all(p[miss] == want_miss)
    assert np.all(p >> (16 + nl) == 0)
