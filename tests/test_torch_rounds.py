"""Two-round retirement: the plain versions of the emit and resume kernels
(``ops.trace.trace_rays_emit`` / ``trace_rays_resume``) against the TPU
kernels they port, the JAX package's ``_trace_tiled_emit`` and
``_trace_rounds_impl`` (pallas_kernel.py:2525, :2614) run in Pallas
interpret mode on the CPU, and the driver ``trace_rays_rounds`` against
the monolithic tracer. The CUDA kernels themselves are held to the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py phase F).

The JAX runs use ``TraceConfig(cull=False)`` at the default ``sub=64``:
with ``sub=8`` the reference's rounds driver fails at these sizes
(ROADMAP.md section 3)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadray_tpu.models.scenes.loader import load_scene
from quadray_tpu.ops import pallas_kernel as pk
from quadray_tpu.ops.rays import camera_rays as jrays
from quadray_tpu.ops.trace import TraceConfig as JConfig
from quadray_tpu.ops.trace import trace_rays as jtrace
from quadray_tpu.scene import schema as S
from quadray_tpu.scene.compile import compile_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.rays import camera_rays
from quadray_tpu_torch.ops.trace import (STATE_I32, STATE_ROWS, TraceConfig,
                                         trace_rays, trace_rays_emit,
                                         trace_rays_resume)
from quadray_tpu_torch.scene.compile import FIELDS, scene_arrays_from_numpy

torch.set_num_threads(1)

W, H = 64, 40
JCFG = JConfig(cull=False)
# colors and float state rows: the JAX kernel runs under XLA on the CPU,
# which contracts mul/add pairs into FMAs; the port never contracts
ATOL = 1e-5
# (scene, k1): 3-surface scenes with lanes still alive at the cut (test08
# keeps 50% of its rays after 2 segments, test06 4% after 3)
CASES = [("test08", 2), ("test06", 3)]


def _scene(name):
    sd = load_scene(name)
    j = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    t = scene_arrays_from_numpy({k: np.asarray(getattr(j, k))
                                 for k in FIELDS}, device="cpu")
    return j, t


@functools.lru_cache(maxsize=None)
def _jax_rounds(name, k1):
    """The JAX emit outputs (3 color + 21 state tiles) and the JAX rounds
    colors for the scene's 64x40 camera rays, padded as
    _prep_and_trace_rounds pads them (pallas_kernel.py:2778)."""
    j, t = _scene(name)
    org1, dirs = jrays(j.cam_pos, j.cam_hor, j.cam_ver, j.cam_nrm, j.cam_pov,
                       W, H, 1)
    n = dirs.shape[0]
    block = JCFG.sub * pk.LANES
    npad = -(-n // block) * block

    def prep(a, fill=0.0):
        a = jnp.concatenate([a, jnp.full((npad - n,), fill, a.dtype)])
        return a.reshape(npad // pk.LANES, pk.LANES)

    org = jnp.broadcast_to(org1[None, :], (n, 3))
    tmin = jnp.full((n,), j.cam_pov, jnp.float32)
    tiles = ([prep(org.T[i]) for i in range(3)]
             + [prep(dirs.T[i], 1.0) for i in range(3)]
             + [prep(tmin, pk.BIG)])
    struct = pk._get_struct(j)
    ps = pk._get_packed(j, struct)
    emit = pk._trace_tiled_emit(ps, *tiles, struct=struct,
                                cfg=JCFG._replace(max_segments=k1),
                                interpret=True)
    rounds = pk._trace_rounds_impl(ps, *tiles, struct=struct, cfg=JCFG,
                                   k1=k1, interpret=True)
    cols = lambda c: np.stack([np.asarray(x).reshape(-1)[:n] for x in c], 1)
    torg, tdirs = camera_rays(t.cam_pos, t.cam_hor, t.cam_ver, t.cam_nrm,
                              t.cam_pov, W, H, 1)
    assert np.array_equal(np.asarray(dirs), tdirs.numpy())
    return (j, t, (torg, tdirs, t.cam_pov.expand(n)), cols(emit[:3]),
            [np.asarray(a) for a in emit[3:]], cols(rounds))


@pytest.mark.parametrize("name,k1", CASES)
def test_plain_emit_matches_pallas_interpret(name, k1):
    """Colors within ATOL; the i32 rows (depth, osrf, oside, thru, active)
    equal; the other float rows within ATOL. They are not bitwise: on the
    CPU, XLA contracts the JAX kernel's mul/add pairs into FMAs, and the
    hit points (ox oy oz, oloc) of most lanes differ by a few ulps
    (measured: up to 7.0e-6). Colors stay within ATOL on all lanes but one
    of 2560 on test06 (1.5e-5): there the port equals the JAX package's
    own jnp tracer run op by op (no XLA fusion, so no contraction)
    bitwise, and the compiled jnp tracer equals the Pallas kernel. So on
    lanes over ATOL (at most 0.1% of them) the bar is the op-by-op jnp
    tracer, within ATOL."""
    j, t, rays, want_c, want_s, _ = _jax_rounds(name, k1)
    n = rays[1].shape[0]
    cols, state = trace_rays_emit(t, *rays, TraceConfig(), k1)
    assert cols.shape == (n, 3) and state.shape == (len(STATE_ROWS), n)
    off = np.nonzero(np.abs(cols.numpy() - want_c).max(axis=1) > ATOL)[0]
    assert off.size <= n // 1000
    if off.size:
        org, dirs, tmin = (jnp.asarray(np.array(r.expand(s).numpy()))[off]
                           for r, s in zip(rays, ((n, 3), (n, 3), (n,))))
        with jax.disable_jit():
            ref = np.asarray(jtrace(j, org, dirs, tmin,
                                    JConfig(max_segments=k1)))
        assert np.abs(cols.numpy()[off] - ref).max() <= ATOL
    assert torch.equal(state[18:21].T, cols)       # acc rows are the colors
    want = ck.rounds_state_from_numpy(want_s, n, device="cpu")
    for k, row in enumerate(STATE_ROWS[:18]):
        if k in STATE_I32:
            assert torch.equal(state[k].view(torch.int32),
                               want[k].view(torch.int32)), row
        else:
            assert (state[k] - want[k]).abs().max() <= ATOL, row
    act = state[17].view(torch.int32)
    assert 0 < int(act.sum()) < n        # lanes on both sides of the cut
    # a retired lane keeps thru 0
    assert not bool((state[13].view(torch.int32)[act == 0] != 0).any())


@pytest.mark.parametrize("name,k1", CASES)
def test_plain_resume_from_jax_state_matches_pallas_rounds(name, k1):
    """Round 2 of the plain version, started from the JAX kernel's own
    emitted state and colors, against the JAX rounds driver's colors,
    within ATOL."""
    _, t, _, want_c, want_s, want_r = _jax_rounds(name, k1)
    n = want_c.shape[0]
    state = ck.rounds_state_from_numpy(want_s, n, device="cpu")
    got = trace_rays_resume(t, state, torch.from_numpy(want_c), TraceConfig(),
                            k1)
    assert np.abs(got.numpy() - want_r).max() <= ATOL
    # the round trip to the JAX tiles keeps every lane's bits
    back = ck.rounds_state_to_numpy(state, rows=want_s[0].shape[0])
    for a, b in zip(back, want_s):
        assert a.dtype == b.dtype
        assert np.array_equal(a.reshape(-1)[:n].view(np.int32),
                              b.reshape(-1)[:n].view(np.int32))


def _camera(name, w, h):
    _, t = _scene(name)
    org, dirs = camera_rays(t.cam_pos, t.cam_hor, t.cam_ver, t.cam_nrm,
                            t.cam_pov, w, h, 1)
    return t, (org, dirs, t.cam_pov.expand(dirs.shape[0]))


@pytest.mark.parametrize("name,w,h", [("test06", 32, 20), ("test08", 32, 20),
                                      ("test14", 16, 10)])
def test_plain_rounds_equal_monolithic(name, w, h):
    """trace_rays_rounds on CPU tensors (the plain emit, compaction and
    resume) equals the plain monolithic tracer bitwise, for the wavefront
    and rounds budgets, k1 = 2, and k1 at or past max_segments (round 1's
    colors); no kernel is launched."""
    t, rays = _camera(name, w, h)
    cfg = TraceConfig(max_segments=12)
    want = trace_rays(t, *rays, cfg)
    before = (ck.launches, ck.emit_launches, ck.resume_launches)
    for k1 in (ck.WAVE_K1, 2, ck.ROUNDS_K1, 12, 20):
        got = ck.trace_rays_rounds(t, *rays, cfg, k1)
        assert torch.equal(got, want), k1
    assert (ck.launches, ck.emit_launches, ck.resume_launches) == before


def test_can_push_scene_takes_the_monolithic_tracer():
    """test17 can push a branch (both Fresnel branches fire), which one
    resumable ray cannot hold (pallas_kernel.py:498): the driver returns
    trace_rays's colors (:2767), the rounds themselves raise."""
    t, rays = _camera("test17", 24, 16)
    cfg = TraceConfig()
    assert torch.equal(ck.trace_rays_rounds(t, *rays, cfg, ck.WAVE_K1),
                       trace_rays(t, *rays, cfg))
    with pytest.raises(ValueError):
        trace_rays_emit(t, *rays, cfg, 2)
    with pytest.raises(ValueError):
        ck.trace_rays_emit_cuda(t, *rays, cfg, 2)
    with pytest.raises(ValueError):
        ck.check_rounds_struct(ck.scene_struct(t))


def test_compact_active_is_a_stable_partition():
    rng = np.random.default_rng(7)
    for n, p in ((1000, 0.3), (257, 0.0), (64, 1.0), (0, 0.5)):
        act = rng.random(n) < p
        state = torch.zeros((len(STATE_ROWS), n))
        state[17] = torch.from_numpy(act.astype(np.int32)).view(torch.float32)
        idx, count = ck.compact_active(state)
        assert idx.dtype == count.dtype == torch.int32
        assert count.shape == (1,) and int(count) == int(act.sum())
        k = int(count)
        assert np.array_equal(idx[:k].numpy(), np.nonzero(act)[0])
        assert np.array_equal(idx[k:].numpy(), np.nonzero(~act)[0])
