"""What the Whitted modes read of TraceConfig: Schlick Fresnel
(``cfg.schlick``) and branch stacks past the kernels' 16 local slots, as
the reference's jnp tracer takes them, and the all-surface forward's tape
contract (``ops/diff.py`` ``tape_read``).

On the CPU, at 24x16 or smaller: the port's plain ``trace_rays`` with
Schlick on test17 and test18, and with DEEP_CFG (48 segments, 24 slots,
no cutoff) on test18, against the JAX jnp ``trace_rays`` within JAX_ATOL;
``cuda_kernel.whitted_scratch``, the wrappers' check, as a pure function;
``whole_kernel``'s unculled walk (``csrc/whitted.cu``, built with g++
behind the shim of ``tests/test_torch_diff_fused.py``) bitwise the plain
``trace_rays`` with Schlick and with its stacks in the device-memory
scratch's layout; the tape's contract: every word it does not read NaN
and the unread texels 2**30, and the gradients of the plain backward and
of the backward kernel's per-ray code (every bounce computed, as in a warp
where another lane hits) bitwise those of the zero-filled tape. The same
kernels on the card: ``tests/test_torch_diff_fused.py``'s ``cuda`` cases
and ``chip_smoke.py`` phases W and T (JAX is imported only inside the
tests that use it).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops import diff
from quadray_tpu_torch.ops.trace import TraceConfig, trace_rays
from test_torch_diff_fused import (  # noqa: F401  (rehearsal: a fixture)
    BITS, CFG, CPU, CSRC, DEEP_CFG, SHIM, _EXP, _LOG,
    _bwd_host, _case, _compiled, _p, _poisoned, _rays, _stack_tops,
    _tape_host, rehearsal)

torch.set_num_threads(1)

# the port's plain tracer against the JAX jnp tracer, whose jitted mul/add
# XLA contracts into FMAs on the CPU (ROADMAP section 3's delta)
JAX_ATOL = 3.5e-6
SMALL_W, SMALL_H = 24, 16


def _jax_pair(name, cfg):
    """(the port's plain trace_rays, the JAX jnp trace_rays) at 24x16 on
    the same scene tables and rays, numpy."""
    import jax.numpy as jnp
    from quadray_tpu.models.scenes.loader import load_scene as jload
    from quadray_tpu.ops.rays import camera_rays as jrays
    from quadray_tpu.ops.trace import TraceConfig as JConfig
    from quadray_tpu.ops.trace import trace_rays as jtrace
    from quadray_tpu.scene import schema as JS
    from quadray_tpu.scene.compile import compile_scene as jcompile
    from quadray_tpu_torch.ops.rays import camera_rays
    from quadray_tpu_torch.scene.compile import (FIELDS,
                                                 scene_arrays_from_numpy)
    sd = jload(name)
    j = jcompile(JS.SceneDef(root=sd.root, opts=JS.OPTS_FULL & ~sd.opts))
    sc = scene_arrays_from_numpy({k: np.asarray(getattr(j, k))
                                  for k in FIELDS}, device="cpu")
    org, dirs = jrays(j.cam_pos, j.cam_hor, j.cam_ver, j.cam_nrm, j.cam_pov,
                      SMALL_W, SMALL_H, 1)
    tmin = jnp.full((dirs.shape[0],), j.cam_pov, jnp.float32)
    want = np.asarray(jtrace(j, org, dirs, tmin, JConfig(
        depth=cfg.depth, max_segments=cfg.max_segments, stack=cfg.stack,
        cutoff=cfg.cutoff, schlick=cfg.schlick)))
    o, d = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                       sc.cam_pov, SMALL_W, SMALL_H, 1)
    assert np.array_equal(np.asarray(dirs), d.numpy())
    got = trace_rays(sc, o, d, sc.cam_pov.expand(d.shape[0]), cfg).numpy()
    return got, want, sc, (o, d, sc.cam_pov.expand(d.shape[0]))


@pytest.mark.parametrize("name", ["test17", "test18"])
def test_plain_schlick_matches_jax(name):
    """(a) The plain trace_rays with Schlick Fresnel against the JAX jnp
    trace_rays with it, within JAX_ATOL; Schlick's colors are not the
    exact Fresnel's."""
    cfg = TraceConfig(schlick=True)
    got, want, sc, rays = _jax_pair(name, cfg)
    assert np.abs(got - want).max() <= JAX_ATOL
    exact = trace_rays(sc, *rays, TraceConfig()).numpy()
    assert not np.array_equal(got, exact)


def test_plain_deep_stack_matches_jax():
    """(b) The same at DEEP_CFG (48 segments, 24 slots, no cutoff) on
    test18, whose stacks pass the kernels' 16 local slots there."""
    got, want, sc, rays = _jax_pair("test18", DEEP_CFG)
    assert np.abs(got - want).max() <= JAX_ATOL
    ti = diff.forward_plain(sc, *rays, DEEP_CFG)[2]
    assert int(_stack_tops(ti).max()) > ck.MAX_STACK


def test_whitted_scratch_is_what_the_kernel_reads():
    """(c) The wrappers' check as a pure function: any stack of 1 or more
    on a single-branch scene (no scratch: it never pushes); on one that
    pushes, the 16 local slots up to 16 held slots (min(stack,
    max_segments)) and past that a scratch of n x d x SLOT floats; a
    stack of 0 refused."""
    single = ck.scene_struct(_compiled("test13"))
    push = ck.scene_struct(_compiled("test17"))
    assert not single.can_push and push.can_push
    n = 777
    for stack in (1, 16, 17, 40, 1000):
        cfg = TraceConfig(stack=stack)
        assert ck.whitted_scratch(single, cfg, n) is None
        d = min(stack, cfg.max_segments)
        want = None if d <= ck.MAX_STACK else (n, d, ck.SLOT)
        assert ck.whitted_scratch(push, cfg, n) == want
    assert ck.whitted_scratch(push, TraceConfig(stack=40, max_segments=16),
                              n) is None
    assert ck.whitted_scratch(push, DEEP_CFG, n) == (n, 24, 15)
    for struct in (single, push):
        with pytest.raises(ValueError, match="stack"):
            ck.whitted_scratch(struct, TraceConfig(stack=0), n)
    inst = ck.whitted_instance(push, DEEP_CFG, n)
    assert inst["deep"] and not ck.whitted_instance(push, CFG, n)["deep"]


# ---- whole_kernel's unculled walk on the CPU ---------------------------------

# whole_kernel's grid, one thread after another (blockIdx and threadIdx
# set as the card's would be): the unculled instantiations that
# whitted_launch picks (whole_instance), the branch stack in MAX_STACK
# local slots or, deep, in the scratch (n, d, SLOT)
WHOLE_HOST_LOOP = r"""
extern "C" void whole_host(const float* rays, float* out,
    const float* sp_f, const int* sp_i, const float* cl_f, const float* mat_f,
    const int* mat_i, const float* lg_f, const float* misc, const int* tex_pk,
    const float* tex_lut, const float* bsph, const int* shad, const int* cont,
    int rows, int n, int ns, int nc, int nl, int depth, int max_segments,
    int stack, float cutoff, int can_push, int schlick, float* deep) {
  const Tables T{sp_f, sp_i, cl_f, mat_f, mat_i, lg_f, misc, tex_pk, tex_lut,
                 bsph, shad, cont, ns, nc, nl, (rows + 31) / 32,
                 (rows + 127) / 128 * 128};
  const Cfg cfg{depth, max_segments, stack, cutoff, 0, 0, 0, schlick};
  for (int i = 0; i < n; ++i) {
    blockIdx.x = i / W_BLOCK;
    threadIdx.x = i % W_BLOCK;
    if (schlick)
      whole_instance<true>(deep ? 2 : can_push, 0)(rays, out, n, T, cfg,
                                                  deep);
    else
      whole_instance<false>(deep ? 2 : can_push, 0)(rays, out, n, T, cfg,
                                                   deep);
  }
}
"""


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    """csrc/whitted.cu's device code up to its first __global__ and
    whole_kernel, built with g++ behind the diff tests' shim."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernel's per-ray code on the CPU"
    common = open(os.path.join(CSRC, "common.cuh")).read().replace(
        "#pragma once", "").replace("#include <cuda_runtime.h>", "")
    w = open(os.path.join(CSRC, "whitted.cu")).read()
    body = w[w.index("namespace {"):w.index(
        "// The two rounds of two-round retirement")]
    body += w[w.index("// ---- the whole-trace kernel"):w.index(
        "// The differentiable route's forward: a thread a ray")]
    body += w[w.index("// whole_kernel's instantiations"):w.index(
        "// C entry point (bound with ctypes)")]
    shim = SHIM + "#define __launch_bounds__(...)\n#define __shared__ static\n"
    out = tmp_path_factory.mktemp("whole")
    (out / "w.cpp").write_text(shim + common + body + "}\n"
                               + WHOLE_HOST_LOOP)
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-w",
                    "-shared", "-fPIC", "-o", str(out / "w.so"),
                    str(out / "w.cpp")], check=True)
    lib = ctypes.CDLL(str(out / "w.so"))
    lib.set_math(_EXP, _LOG)
    return lib


def _whole(lib, sc, rays, cfg):
    """whole_host's colors (n, 3) and the scratch it was given (None where
    whitted_scratch asks for none)."""
    org, dirs, t_min = rays
    n = dirs.shape[0]
    struct = ck.scene_struct(sc)
    ps = ck.pack_scene(sc, struct, cull=False)   # alive while tabs point in
    tabs = ck._scene_tables(sc, struct, ps, CPU)
    soa = torch.cat([org.expand(n, 3).T, dirs.T, t_min[None]]).contiguous()
    out = torch.full((3, n), float("nan"))
    shape = ck.whitted_scratch(struct, cfg, n)
    deep = None if shape is None else torch.full(shape, float("nan"))
    lib.whole_host(_p(soa), _p(out),
                   *(ctypes.c_void_p(p) for p in tabs[:12]), tabs[12], n,
                   struct.n_real, struct.nc, struct.nl, cfg.depth,
                   cfg.max_segments, cfg.stack, ctypes.c_float(cfg.cutoff),
                   int(struct.can_push), int(cfg.schlick),
                   None if deep is None else _p(deep))
    return out.T, deep


@pytest.mark.parametrize("name, what", [("test17", "schlick"),
                                        ("test18", "schlick"),
                                        ("test18", "deep"),
                                        ("test13", "deep"),
                                        ("test18", "default")])
def test_whole_kernel_code_bitwise_plain(whole, name, what):
    """whole_kernel's unculled walk bitwise the plain trace_rays at 24x16:
    with Schlick Fresnel on test17 and test18 (not the exact Fresnel's
    colors), with DEEP_CFG's stack on test18 in the scratch (its stacks
    pass 16 slots; the slots the stacks never reached stay NaN) and on
    test13, which never pushes (no scratch), and at the default cfg."""
    sc = _compiled(name)
    rays = _rays(sc, SMALL_W, SMALL_H)
    cfg = {"schlick": TraceConfig(schlick=True), "deep": DEEP_CFG,
           "default": TraceConfig()}[what]
    got, deep = _whole(whole, sc, rays, cfg)
    want = trace_rays(sc, *rays, cfg)
    assert torch.equal(BITS(got), BITS(want))
    if what == "schlick":
        assert not torch.equal(want, trace_rays(sc, *rays, TraceConfig()))
    if what == "deep" and name == "test18":
        ti = diff.forward_plain(sc, *rays, cfg)[2]
        top = int(_stack_tops(ti).max())
        assert top > ck.MAX_STACK
        assert not bool(torch.isnan(deep[:, top - 1]).all())
        assert bool(torch.isnan(deep[:, top:]).all())
    else:
        assert deep is None


# ---- the tape's contract ---------------------------------------------------------

@pytest.mark.parametrize("name, what", [("test15", "default"),
                                        ("test17", "default"),
                                        ("test18", "default"),
                                        ("test17", "schlick"),
                                        ("test18", "schlick"),
                                        ("test18", "deep")])
def test_unread_tape_words_change_no_gradient(rehearsal, name, what):
    """(d) The tape's contract (``diff.tape_read``): every word it does
    not read NaN (an i32 word its bits) and the unread texels 2**30; the
    plain backward's outputs in both modes (its tiles; wide, its row
    gradients and ids) and those of the backward kernel's per-ray code
    (``back_bounce`` built with g++, every bounce computed as in a warp
    where another lane hits, or as a ray alone) bitwise the zero-filled
    tape's, and the kernel forward's own tape (unwritten words NaN) the
    same; with Schlick Fresnel and with DEEP_CFG's stack too."""
    sc, rays = _case(name)[:2]
    cfg = {"schlick": CFG._replace(schlick=True), "deep": DEEP_CFG,
           "default": CFG}[what]
    if what == "deep":
        rays = tuple(r[:SMALL_W * SMALL_H] for r in rays)
    _, tf, ti = diff.forward_plain(sc, *rays, cfg)
    ptf, pti = _poisoned(tf, ti)
    mf, mi = diff.tape_read(ti)
    assert bool((~mf).any()) and bool((pti[:, 1][~mi[:, 1]] == 2 ** 30).all())
    _, ktf, kti = _tape_host(rehearsal, sc, rays, cfg, tf, ti)
    T = diff.tables(sc)
    g = torch.from_numpy(np.random.RandomState(7).standard_normal(
        (tf.shape[2], 3)).astype(np.float32))
    for wide in (False, True):
        want = diff.backward_rows_plain(g, T, tf, ti, cfg.stack, cfg.schlick,
                                        wide)
        runs = [diff.backward_rows_plain(g, T, ptf, pti, cfg.stack,
                                         cfg.schlick, wide)]
        for tape in ((ptf, pti), (ktf, kti)):
            for all_any in (True, False):
                runs.append(_bwd_host(rehearsal, sc, cfg, *tape, g, wide,
                                      all_any))
        for got in runs:
            for x, y in zip(got, want):
                if y is not None:
                    assert torch.equal(BITS(x), BITS(y)), wide
