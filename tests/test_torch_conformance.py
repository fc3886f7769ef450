"""The kernel-op conformance tier of the port (``ops/conformance.py``, the
counterpart of tests/test_conformance.py's ``_pallas_elementwise``): each
case's plain PyTorch version against the JAX test's own function through
jnp on the CPU, on the same seeded inputs, and the plain Whitted tracer
against the jnp tracer on random non-camera rays. The CUDA kernels are
held to the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py phase G)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadray_tpu.models.scenes.loader import load_scene
from quadray_tpu.ops.pallas_kernel import _root, _sdiv
from quadray_tpu.ops.trace import D_EPS, T_EPS
from quadray_tpu.ops.trace import TraceConfig as JConfig
from quadray_tpu.ops.trace import trace_rays as jtrace
from quadray_tpu.scene import schema as S
from quadray_tpu.scene.compile import compile_scene
from quadray_tpu_torch.ops import conformance as cf
from quadray_tpu_torch.ops.trace import TraceConfig, trace_rays
from quadray_tpu_torch.scene.compile import FIELDS, scene_arrays_from_numpy

torch.set_num_threads(1)


def _feq(a, b, scale):
    """Magnitude-scaled float compare (FEQ, simd_test.cpp:38-50, as
    tests/test_conformance.py:37-44): lanes off by more than scale f32
    epsilons of the larger magnitude."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    tol = scale * np.finfo(np.float32).eps * np.maximum(
        np.maximum(np.abs(a), np.abs(b)), 1e-20)
    return int((np.abs(a - b) > tol).sum())


def _roots(a, b, c):
    """tests/test_conformance.py:90-113."""
    disc = b * b - a * c
    quad_ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    sgn_b = jnp.where(b >= 0.0, 1.0, -1.0)
    q = -(b + sgn_b * sq)
    b_pos = b > 0.0

    def root(num, den):
        nz = num == 0.0
        den = jnp.where(nz, 1.0, den)
        ok = den != 0.0
        return jnp.where(ok, num / jnp.where(ok, den, 1.0), 1e30), ok

    t1, ok1 = root(jnp.where(b_pos, q, c), jnp.where(b_pos, a, q))
    t2, ok2 = root(jnp.where(b_pos, c, q), jnp.where(b_pos, q, a))
    dmask = quad_ok & (disc < D_EPS)
    sgn_a = jnp.where(a >= 0.0, 1.0, -1.0)
    u = (t1 - t2) * sgn_a
    tdff = jnp.where(u >= 0.0, -0.5 * u - jnp.abs(T_EPS * t1), 0.0) * sgn_a
    tdff = jnp.where(dmask & ok1 & ok2, tdff, 0.0)
    return jnp.where(quad_ok & ok1, t1 + tdff, 1e30) \
        + 1e-3 * jnp.where(quad_ok & ok2, t2 - tdff, 1e30)


def _fresnel(eta, dot):
    """tests/test_conformance.py:131-144."""
    k = 1.0 - eta * eta + (eta * dot) ** 2
    tir = k < 0.0
    sq = jnp.sqrt(jnp.maximum(k, 0.0))
    den1 = eta * dot - sq
    den2 = dot - eta * sq
    rs = jnp.where(jnp.abs(den1) < 1e-30, 1.0,
                   (eta * dot + sq) / jnp.where(jnp.abs(den1) < 1e-30,
                                                1.0, den1))
    rp = jnp.where(jnp.abs(den2) < 1e-30, 1.0,
                   (dot + eta * sq) / jnp.where(jnp.abs(den2) < 1e-30,
                                                1.0, den2))
    F = jnp.clip(0.5 * (rs * rs + rp * rp), 0.0, 1.0)
    return jnp.where(tir, 1.0, F)


def _root_sdiv(num, den):
    """tests/test_conformance.py:195-197, through the Pallas kernel's own
    _root/_sdiv."""
    r, ok = _root(num, den)
    return r + 1e3 * ok.astype(np.float32) + 1e-3 * _sdiv(num, den)


# case -> (the JAX test's function, FEQ scale or None for bitwise).
# Bitwise where every op of the case is correctly rounded in both (the
# roots, Fresnel and root/sdiv blocks included: IEEE +-*/ and sqrt, no
# FMA in eager jnp); the JAX test's scale where a math-library function
# is in the chain (4 for exp and log, 64 for the power). rsqrt: the port
# rounds 1/sqrt once (the kernel's __frsqrt_rn), lax.rsqrt on the CPU does
# not (140 of 1024 lanes an ulp off, measured).
WANT = {
    "add": (lambda x, y: x + y, None),
    "mul": (lambda x, y: x * y, None),
    "div": (lambda x, y: x / y, None),
    "sqrt": (jnp.sqrt, None),
    "rsqrt": (jax.lax.rsqrt, 4.0),
    "exp": (jnp.exp, 4.0),
    "log": (jnp.log, 4.0),
    "fma": (lambda x, y: x * y + y, None),
    "min_max": (lambda x, y: jnp.maximum(x, y) - jnp.minimum(x, y), None),
    "abs_neg": (lambda x: abs(-x), None),
    "roots": (_roots, None),
    "fresnel": (_fresnel, None),
    "spec_pow": (lambda x, p: jnp.exp(p * jnp.log(x)), 64.0),
    "gather": (lambda t, i: jnp.take_along_axis(t, i, axis=1), None),
    "root_sdiv": (_root_sdiv, None),
}


def test_every_case_has_a_reference():
    assert set(WANT) == set(cf.CASES) == set(cf.NARGS)


@pytest.mark.parametrize("name", cf.CASES)
def test_plain_case_matches_jax(name):
    args = cf.case_inputs(name)
    want = np.asarray(WANT[name][0](*(jnp.asarray(a) for a in args)))
    got = cf.plain(name, *(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = WANT[name][1]
    if scale is None:
        assert np.array_equal(got.numpy().view(np.int32),
                              want.astype(np.float32).view(np.int32))
    else:
        assert _feq(got.numpy(), want, scale) == 0


def test_case_inputs_follow_the_jax_test():
    """At 8 rows the inputs are tests/test_conformance.py's own values
    (its _rand: RandomState(seed).uniform(lo, hi, (8, 128)) in f32)."""
    x, y = cf.case_inputs("div")
    assert np.array_equal(x, np.random.RandomState(1).uniform(
        0.5, 1e3, (8, 128)).astype(np.float32))
    assert np.array_equal(y, np.random.RandomState(2).uniform(
        0.5, 1e3, (8, 128)).astype(np.float32))
    num, den = cf.case_inputs("root_sdiv")
    assert not num[0, :8].any() and not den[1, :8].any()
    a, b, c = cf.case_inputs("roots", rows=16)
    assert a.shape == b.shape == c.shape == (16, 128)


def test_wrapper_on_cpu_tensors_takes_plain_version():
    before = cf.launches
    for name in cf.CASES:
        args = [torch.from_numpy(a) for a in cf.case_inputs(name)]
        assert torch.equal(cf.conformance(name, *args),
                           cf.plain(name, *args))
    assert cf.launches == before
    x = torch.zeros((8, 128))
    with pytest.raises(ValueError):
        cf.conformance("nope", x)
    with pytest.raises(ValueError):
        cf.conformance("add", x)


@pytest.mark.parametrize("scene,seed", [("test01", 1), ("test10", 10),
                                        ("test17", 17)])
def test_plain_tracer_matches_jnp_on_random_rays(scene, seed):
    """tests/test_conformance.py:215-246 for the plain tracer, held to
    that test's bar: under 0.2% of lanes off by more than 2e-3 (the JAX
    test seeds with hash(scene), which changes between processes; here
    the seed is fixed)."""
    sd = load_scene(scene)
    j = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    t = scene_arrays_from_numpy({k: np.asarray(getattr(j, k))
                                 for k in FIELDS}, device="cpu")
    org, dirs = cf.random_rays(2048, seed)
    t_min = np.zeros((2048,), np.float32)
    want = np.asarray(jtrace(j, jnp.asarray(org), jnp.asarray(dirs),
                             jnp.asarray(t_min),
                             JConfig(stack=4, max_segments=12)))
    got = trace_rays(t, torch.from_numpy(org), torch.from_numpy(dirs),
                     torch.from_numpy(t_min),
                     TraceConfig(stack=4, max_segments=12)).numpy()
    d = np.abs(got - want)
    assert (d > 2e-3).mean() < 0.002, d.max()
    assert np.isfinite(got).all() and (got.max(axis=1) > 0).mean() > 0.05
