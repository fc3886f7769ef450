"""The port's path tracer (ops/pt.py) against the JAX package's on the CPU.

Bars:
  * seeds bitwise equal, at any N: both versions draw four uniforms per
    lane per iteration while any lane of the call is active;
  * radiance within 2e-4 (the JAX package's own bar between its jnp and
    Pallas versions, tests/test_pt.py:106-130) of the jnp estimator
    evaluated op by op (``jax.disable_jit``: IEEE f32, no contraction).
    Compiled, XLA contracts mul/add pairs into FMAs on the CPU, and a path
    tracer amplifies such an ulp through later bounces: on test18 at 96x48
    the JAX package's own compiled and op-by-op runs differ by 9.9e-3 on
    one lane of 4608. Against the compiled versions the bar holds on every
    lane where the JAX package agrees with itself to 2e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadray_tpu.models.scenes.loader import load_scene
from quadray_tpu.ops import pt as jpt
from quadray_tpu.ops.trace import TraceConfig as JConfig
from quadray_tpu.scene import schema as S
from quadray_tpu.scene.compile import compile_scene
from quadray_tpu_torch.models.scenes.loader import load_scene as tload
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops import pt as tpt
from quadray_tpu_torch.ops.trace import TraceConfig
from quadray_tpu_torch.scene import schema as TS
from quadray_tpu_torch.scene.compile import (
    FIELDS, PROP_LIGHT, compile_scene as tcompile, scene_arrays_from_numpy)

torch.set_num_threads(1)

ATOL = 2e-4
DEPTH = 10


def _u32(t):
    return t.numpy().view(np.uint32)


def _scene(name):
    sd = load_scene(name)
    j = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    t = scene_arrays_from_numpy({k: np.asarray(getattr(j, k))
                                 for k in FIELDS}, device="cpu")
    return j, t


def _primary(j, t, w, h):
    """The same jittered primary rays and seeds for both packages."""
    n = w * h
    jo, jd, js = jpt.pt_camera_rays(j, w, h, jpt.init_seeds(n))
    to, td, ts = tpt.pt_camera_rays(t, w, h, tpt.init_seeds(n, device="cpu"))
    assert np.array_equal(np.asarray(js), _u32(ts))
    assert np.array_equal(np.asarray(jd), td.numpy())
    jt = jnp.full((n,), j.cam_pov, jnp.float32)
    return (jo, jd, jt, js), (to, td, t.cam_pov.expand(n), ts)


@pytest.fixture(scope="module")
def test18():
    """test18 at 96x48: the plain pass and the jnp estimator's pass, run
    op by op (about 20 s, paid once for the tests below)."""
    j, t = _scene("test18")
    jin, tin = _primary(j, t, 96, 48)
    rad, seeds = tpt.trace_pt(t, *tin, TraceConfig(depth=DEPTH))
    with jax.disable_jit():
        er, es = jpt.trace_pt(j, *jin, JConfig(depth=DEPTH))
    return dict(j=j, t=t, jin=jin, tin=tin, rad=rad.numpy(), seeds=seeds,
                eager=np.asarray(er), eager_seeds=np.asarray(es))


def _self_consistent(compiled, eager):
    """Lanes where the JAX package's compiled run agrees with its op-by-op
    run to ATOL; at most one lane in a thousand may be left out."""
    keep = np.abs(compiled - eager).max(1) <= ATOL
    assert (~keep).sum() <= keep.size // 1000, (~keep).sum()
    return keep


def test_lcg_matches_jax():
    rng = np.random.default_rng(3)
    s0 = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(
        np.uint32)
    js, ts = jnp.asarray(s0), torch.from_numpy(s0.view(np.int32).copy())
    for _ in range(5):
        js, ju = jpt.lcg_uniform(js)
        ts, tu = tpt.lcg_uniform(ts)
        assert np.array_equal(np.asarray(js), _u32(ts))
        assert np.array_equal(np.asarray(ju), tu.numpy())
    for fs in (1, 7, 2 ** 31 + 5):
        assert np.array_equal(np.asarray(jpt.init_seeds(1000, fs)),
                              _u32(tpt.init_seeds(1000, fs, device="cpu")))
    u = torch.from_numpy(rng.random(4096, dtype=np.float32))
    assert np.array_equal(np.asarray(jpt.tent_jitter(jnp.asarray(u.numpy()))),
                          tpt.tent_jitter(u).numpy())


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 7, 64, 120, 264, 1001])
def test_lcg_jump_equals_sequential_steps(k):
    rng = np.random.default_rng(k)
    s0 = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=512,
                                       dtype=np.int64).astype(np.int32))
    s, j = s0, jnp.asarray(s0.numpy().view(np.uint32))
    for _ in range(k):
        s, j = tpt.lcg_next(s), jpt.lcg_next(j)
    assert torch.equal(tpt.lcg_jump(s0, k), s)
    assert np.array_equal(np.asarray(j), _u32(s))


def test_pt_camera_rays_match_jax():
    """Directions and seeds bitwise at a size that is not square."""
    j, t = _scene("test01")
    _primary(j, t, 56, 36)


def test_trace_pt_matches_jnp_test18(test18):
    d = test18
    assert np.array_equal(d["eager_seeds"], _u32(d["seeds"]))
    assert np.abs(d["rad"] - d["eager"]).max() <= ATOL
    assert d["rad"].max() > 1.0          # the Cornell box is lit
    jr, js = jpt.trace_pt(d["j"], *d["jin"], JConfig(depth=DEPTH))
    assert np.array_equal(np.asarray(js), _u32(d["seeds"]))
    keep = _self_consistent(np.asarray(jr), d["eager"])
    assert np.abs(np.asarray(jr) - d["rad"])[keep].max() <= ATOL


def test_trace_pt_matches_pallas_interpret_test18(test18):
    """Against the TPU kernel itself in Pallas interpret mode: one call of
    4608 <= 8192 lanes is one grid block, so its seeds follow the same
    iteration count."""
    from quadray_tpu.ops.pallas_kernel import trace_pt_pallas
    d = test18
    jo, jd, jt, js = d["jin"]
    pr, ps = trace_pt_pallas(d["j"], jo, jd, jt, js, JConfig(depth=DEPTH),
                             interpret=True)
    assert np.array_equal(np.asarray(ps), _u32(d["seeds"]))
    keep = _self_consistent(np.asarray(pr), d["eager"])
    assert np.abs(np.asarray(pr) - d["rad"])[keep].max() <= ATOL


def _emission(t, seed):
    """chip_smoke.py phase E1's seeded emission in [0, 0.5) on both sides
    of every real surface of the port's scene t, as numpy f32."""
    e = np.random.default_rng(seed).uniform(
        0.0, 0.5, tuple(t.s_emis.shape)).astype(np.float32)
    return e * (t.s_kind.numpy() > 0)[:, None, None]


def test_trace_pt_matches_jnp_refractive_textured():
    """test17: Fresnel glass (the shallow two-branch pushes) and a
    texture; lanes run into the 66-node cap. Its paths seldom reach its
    small light, so every surface gets the same seeded emission in both
    packages: each node's branch weights, pops and emission row then show
    in the radiance of most lanes."""
    j, t = _scene("test17")
    e = _emission(t, 17)
    j = j.replace(s_emis=j.s_emis + jnp.asarray(e))
    t = dataclasses.replace(t, s_emis=t.s_emis + torch.from_numpy(e))
    jin, tin = _primary(j, t, 48, 32)
    jr, js = jpt.trace_pt(j, *jin, JConfig(depth=DEPTH))
    tr, ts = tpt.trace_pt(t, *tin, TraceConfig(depth=DEPTH))
    assert np.array_equal(np.asarray(js), _u32(ts))
    assert np.abs(np.asarray(jr) - tr.numpy()).max() <= ATOL
    assert torch.equal(ts, tpt.lcg_jump(tin[3], 4 * 6 * (DEPTH + 1)))
    assert (tr.amax(dim=1) > 0).float().mean() > 0.25   # measured 0.436


def _iterations(seeds_in, seeds_out):
    """The call's iteration count M: seeds_out = lcg_jump(seeds_in, 4 M)."""
    ms = [m for m in range(6 * (DEPTH + 1) + 1)
          if torch.equal(tpt.lcg_jump(seeds_in, 4 * m), seeds_out)]
    assert len(ms) == 1, ms
    return ms[0]


def test_seeds_advance_by_the_call_iteration_count(test18):
    """Every lane's seed advances 4*M draws, M the whole call's count,
    also on lanes that retired earlier: each of 24 lanes traced alone
    retires at its own iteration, which is also the count of nodes the
    plain version reports for it (``stats``, the PT kernel's bound)."""
    d = test18
    to, td, tt, ts = d["tin"]
    m = _iterations(ts, d["seeds"])
    lanes = np.random.default_rng(0).choice(td.shape[0], 24, replace=False)
    alone = []
    for i in lanes:
        sl = slice(int(i), int(i) + 1)
        stats = {}
        rad, s = tpt.trace_pt(d["t"], to, td[sl], tt[sl], ts[sl],
                              TraceConfig(depth=DEPTH), stats)
        assert np.array_equal(rad.numpy(), d["rad"][sl])
        alone.append(_iterations(ts[sl], s))
        assert stats == {"walks": alone[-1]}
    assert len(set(alone)) > 3 and max(alone) <= m
    assert min(alone) < m


def _pt_case(name, emis_seed):
    """The port's scene (with chip_smoke.py phase E1's seeded emission on
    every real surface when emis_seed is given), its jittered primary rays
    and seeds at 48x32, and the plain pass over all of them."""
    sd = tload(name)
    t = tcompile(TS.SceneDef(root=sd.root, opts=TS.OPTS_FULL & ~sd.opts),
                 device="cpu")
    if emis_seed is not None:
        t = dataclasses.replace(t, s_emis=t.s_emis + torch.from_numpy(
            _emission(t, emis_seed)))
    n = 48 * 32
    org, dirs, seeds = tpt.pt_camera_rays(t, 48, 32,
                                          tpt.init_seeds(n, device="cpu"))
    tmin = t.cam_pov.expand(n)
    rad, out = tpt.trace_pt(t, org, dirs, tmin, seeds,
                            TraceConfig(depth=DEPTH))
    return t, (org, dirs, tmin, seeds), rad, out


@pytest.fixture(scope="module", params=[("test18", None), ("test17", 17)],
                ids=["test18", "test17+emission"])
def pt_case(request):
    return _pt_case(*request.param)


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_trace_pt_permuted_samples_permute_outputs(pt_case):
    """What the PT kernel's path regeneration relies on: a sample's result
    does not depend on its lane or its neighbours. Tracing the samples in
    another order permutes the radiance and the output seeds, bitwise."""
    t, (org, dirs, tmin, seeds), rad, out = pt_case
    perm = torch.from_numpy(np.random.default_rng(5).permutation(
        dirs.shape[0]))
    prad, pout = tpt.trace_pt(t, org, dirs[perm], tmin[perm], seeds[perm],
                              TraceConfig(depth=DEPTH))
    assert torch.equal(_bits(prad), _bits(rad[perm]))
    assert torch.equal(pout, out[perm])


def test_trace_pt_prefix_alone_equals_whole_call(pt_case):
    """The first 301 samples traced alone: radiance bitwise as in the whole
    call, and their seeds equal the whole call's after 4*(M_whole -
    M_prefix) more draws, M each call's largest node count, which the
    plain version also reports per sample ("sample_nodes")."""
    t, (org, dirs, tmin, seeds), rad, out = pt_case
    k = 301
    stats = {"sample_nodes": None}
    crad, cout = tpt.trace_pt(t, org, dirs[:k], tmin[:k], seeds[:k],
                              TraceConfig(depth=DEPTH), stats)
    assert torch.equal(_bits(crad), _bits(rad[:k]))
    m_whole, m_prefix = _iterations(seeds, out), _iterations(seeds[:k], cout)
    assert m_prefix == int(stats["sample_nodes"].max())
    assert stats["walks"] == int(stats["sample_nodes"].sum())
    assert m_prefix < m_whole
    assert torch.equal(tpt.lcg_jump(cout, 4 * (m_whole - m_prefix)),
                       out[:k])


def test_emission_rows_are_light_rows():
    """The kernel reads every hit row's emission (sp_f 38-43), as the jnp
    tracer reads s_emis; only LIGHT-tagged surfaces carry any."""
    for name in ("test01", "test03", "test11", "test13", "test17",
                 "test18"):
        sd = tload(name)
        t = tcompile(TS.SceneDef(root=sd.root,
                                 opts=TS.OPTS_FULL & ~sd.opts),
                     device="cpu")
        light = ((t.m_props[t.s_mat.long()] & PROP_LIGHT) != 0).any(1)
        emis = t.s_emis.abs().sum((1, 2))
        assert bool((emis[~light] == 0).all()) and bool((emis > 0).any())
        st = ck.scene_struct(t)
        ps = ck.pack_scene(t, st)
        perm = torch.tensor(st.perm)
        assert torch.equal(ps.sp_f[:, 38:44], t.s_emis.reshape(-1, 6)[perm])


def test_wrappers_on_cpu_tensors_take_plain_tracer(test18):
    d = test18
    to, td, tt, ts = d["tin"]
    sl = slice(0, 384)
    before = ck.pt_launches
    rad, s = ck.trace_pt_cuda(d["t"], to, td[sl], tt[sl], ts[sl],
                              TraceConfig(depth=DEPTH))
    want = tpt.trace_pt(d["t"], to, td[sl], tt[sl], ts[sl],
                        TraceConfig(depth=DEPTH))
    assert torch.equal(rad, want[0]) and torch.equal(s, want[1])
    # render_pt_cuda on CPU seeds runs the plain passes, bitwise
    seeds = tpt.init_seeds(24 * 16, device="cpu")
    img, s2 = ck.render_pt_cuda(d["t"], 24, 16, seeds, 2,
                                TraceConfig(depth=DEPTH))
    acc, s1 = torch.zeros((24 * 16, 3)), seeds
    for _ in range(2):
        o, dd, s1 = tpt.pt_camera_rays(d["t"], 24, 16, s1)
        r, s1 = tpt.trace_pt(d["t"], o, dd, tt[:24 * 16], s1,
                             TraceConfig(depth=DEPTH))
        acc = acc + r
    assert torch.equal(img, (acc / 2.0).reshape(16, 24, 3))
    assert torch.equal(s2, s1)
    assert ck.pt_launches == before
