"""The scene pack as one launch (``csrc/pack.cu`` ``pack_launch``, host
side ``ops/cuda_kernel.py`` ``pack_plan``/``pack_args``/``pack_parts``):
the kernel's per-thread code built with g++ behind a shim and run over
its whole grid on CPU tensors, every table bitwise its plain version
(PACK_PARTS) on the golden compiles, on demo01's and demo02's moved
frames and on adversarial arrays; the arguments' layout against the C
struct; which parts ``_PackCache`` packs in its one call; the plain parts
bitwise the jitted JAX ``pack_scene``; and on the card the launch bitwise
the plain parts, never the plain parts on a CUDA scene, and the launch
replayed from a CUDA graph.

JAX is imported inside the tests that use it, so the card's tests run on
a GPU machine without it:
    python -m pytest tests/test_torch_pack_kernel.py --noconftest -q -m cuda
"""

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from quadray_tpu_torch import engine as E
from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS, frame_time
from quadray_tpu_torch.models.scenes import demos
from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import FIELDS, SceneArrays, compile_scene

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "quadray_tpu_torch", "csrc")
SRC = os.path.join(CSRC, "pack.cu")
GOLDEN = [f"test{i:02d}" for i in range(1, 19)] + ["demo01", "demo02",
                                                    "demo03"]
# the parts a J3 frame of demo01 or demo02 re-packs (their spheres and
# lights move), and the training step's (unculled)
MOVED = ("sp_f", "cl_f", "lg_f", "bsph_t", "shad_msk", "cont_msk")
SUBSETS = (ck.PART_NAMES, MOVED, ck.PART_NAMES[:7])
# J3's camera trace (chip_smoke.py J3_TRACE)
TRACE = "w,left,w,right,s,up,d,down,a,.".split(",")
CPU = torch.device("cpu")


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        _bits(a), _bits(b))


def _compiled(name, device="cpu"):
    sd = load_scene(name)
    return compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         device=device)


def _moved_frames(name, n=4):
    """The arrays of ``n`` frames of J3's trace after the first, through
    Scene.update with the trace's camera actions (the spheres and lights
    of demo01 and demo02 move every frame)."""
    sc = E.Scene(demos.build(name), 32, 20, device="cpu")
    sc.update(0.0)
    out = []
    for fi in range(1, n + 1):
        t = frame_time(fi)
        if TRACE[fi % len(TRACE)] in KEY_ACTIONS:
            sc.update_action(t, KEY_ACTIONS[TRACE[fi % len(TRACE)]])
        out.append(sc.update(t))
    return out, ck.scene_struct(out[0])


def _plain(names, sc, struct):
    stt = ck._struct_tensors(struct, sc.device)
    return {n: fn(sc, struct, stt) for n, fn, _ in ck.PACK_PARTS
            if n in names}


# ---- the kernel's code on the CPU ---------------------------------------------

SHIM = r"""
#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(n)
#define __restrict__
using std::max;
using std::min;
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
static inline float __fsqrt_rn(float x) { return std::sqrt(x); }
static inline float __frsqrt_rn(float x) { return 1.0f / std::sqrt(x); }
static inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
// the double sqrt of the plain version's device, as the card's sqrt is
// the card's: torch's CPU sqrt gives +NaN for a negative argument (a
// radius squared below 0), the x86 instruction -NaN
static inline double plain_sqrt(double x) {
  return x < 0.0 ? std::numeric_limits<double>::quiet_NaN() : std::sqrt(x);
}
#define sqrt plain_sqrt
// one thread stands for the block: it stages every row of a tile itself
struct Dim3 { unsigned x; };
static Dim3 threadIdx{0}, blockDim{1};
static inline void __syncthreads() {}
"""
# every thread of the grid in turn, each with the whole block's staging
GRID_LOOP = r"""
extern "C" void pack_host(const PackArgs* a) {
  static Staged st;
  for (int b = 0; b < a->start[NPARTS]; ++b)
    for (int t = 0; t < THREADS; ++t) pack_thread(*a, b, t, st);
}
"""


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """csrc/pack.cu's device code (common.cuh's helpers, PackArgs and
    everything up to the __global__ kernel) built with g++ behind a shim,
    -ffp-contract=off as nvcc's --fmad=false."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernel's device code on the CPU"
    src = open(SRC).read()
    common = open(os.path.join(CSRC, "common.cuh")).read()
    common = common.replace("#pragma once", "").replace(
        "#include <cuda_runtime.h>", "")
    body = src[src.index("namespace {"):src.index(
        "__global__ void __launch_bounds__(THREADS) pack_kernel")]
    d = tmp_path_factory.mktemp("pack")
    (d / "p.cpp").write_text(SHIM + common + body + "}\n" + GRID_LOOP)
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(d / "p.so"), str(d / "p.cpp")],
                   check=True)
    lib = ctypes.CDLL(str(d / "p.so"))
    lib.pack_host.argtypes = [ctypes.POINTER(ck._PackArgs)]
    lib.pack_host.restype = None
    return lib


def _rehearse(lib, names, sc, struct):
    """The tables ``names`` as the kernel's grid writes them, through the
    wrapper's own plan and arguments on CPU tensors."""
    plan = ck.pack_plan(names, struct, sc.l_pos.shape[0],
                        sc.tex_data.shape[0])
    stt = ck._struct_tensors(struct, sc.device)
    args, tables = ck.pack_args(plan, sc, stt, CPU)
    lib.pack_host(ctypes.byref(args))
    return tables


def _assert_rehearsal_is_plain(lib, sc, struct, label):
    for names in SUBSETS:
        got, want = _rehearse(lib, names, sc, struct), _plain(names, sc,
                                                               struct)
        assert tuple(got) == tuple(want) == tuple(names), label
        for n in names:
            assert _same(got[n], want[n]), (label, names, n)


@pytest.mark.parametrize("name", GOLDEN)
def test_rehearsal_bitwise_plain_on_golden_scenes(rehearsal, name):
    """Every part, in the three launches the port makes (every part, a J3
    frame's moved parts, the training step's seven), bitwise the plain
    parts on the golden scene's compile."""
    sc = _compiled(name)
    _assert_rehearsal_is_plain(rehearsal, sc, ck.scene_struct(sc), name)


@pytest.mark.parametrize("name", ["demo01", "demo02"])
def test_rehearsal_bitwise_plain_on_moved_frames(rehearsal, name):
    """demo01 and demo02 after Scene.update at four frames of J3's trace,
    each with its camera action: moved spheres and lights."""
    frames, struct = _moved_frames(name)
    for fi, sc in enumerate(frames):
        _assert_rehearsal_is_plain(rehearsal, sc, struct, (name, fi))


def _adversarial(ns, nl, seed):
    """Arrays of ``ns`` surface rows (NC 3, NM 5, 4 light rows of which
    ``nl`` are active, 300 texels) from a seeded RandomState, with the
    values the kernel must carry through: NaN, +-inf, -0.0 and
    out-of-range clip bounds in s_cmin/s_cmax, NaN, +-inf and negative
    radii in s_bsph, unbounded rows, c_ref -1, and texels at k/255 and
    (k + 0.5)/255."""
    rng = np.random.RandomState(seed)
    nc, nm, nlr, ntex = 3, 5, 4, 300
    f = lambda *s: rng.uniform(-4.0, 4.0, s).astype(np.float32)
    i = lambda hi, *s: rng.randint(0, hi, s).astype(np.int32)
    d = {k: f(ns, 3) for k in ("s_pos", "s_sci", "s_scjh", "s_cmin",
                               "s_cmax")}
    d.update(s_inv=f(ns, 3, 3), s_fwd=f(ns, 3, 3), s_sciw=f(ns),
             s_emis=f(ns, 2, 3), s_tag=i(5, ns), s_sing=i(2, ns),
             s_mat=i(nm, ns, 2), s_bnd=i(2, ns))
    d["s_kind"] = i(4, ns)
    d["s_kind"][0] = 1   # at least one real surface
    d["s_sing"][d["s_kind"] == 1] = 0   # planes have no singularity
    weird = np.array([np.nan, np.inf, -np.inf, -0.0, 1e31, -1e31, 0.0],
                     np.float32)
    for k in ("s_cmin", "s_cmax"):
        d[k].reshape(-1)[::3] = np.resize(weird, d[k].reshape(-1)[::3].size)
    bsph = np.concatenate([f(ns, 3), rng.uniform(0.0, 1.5, (ns, 1))
                           .astype(np.float32) ** 2], axis=1)
    odd = np.array([[np.nan, 0, 0, 1], [0, np.inf, 0, 1], [0, 0, -np.inf, 1],
                    [0, 0, 0, np.nan], [0, 0, 0, np.inf], [0, 0, 0, -1.0],
                    [-0.0, -0.0, -0.0, -0.0]], np.float32)
    rows = rng.permutation(ns)[:min(ns // 4, len(odd))]
    bsph[rows] = odd[:len(rows)]
    d["s_bsph"] = bsph
    d["c_op"] = i(3, ns, nc)
    d["c_ref"] = rng.randint(-1, ns, (ns, nc)).astype(np.int32)
    d["c_side"] = rng.choice([-1.0, 1.0], (ns, nc)).astype(np.float32)
    d.update(m_props=i(1 << 10, nm), m_col=f(nm, 3), m_tex_scl=f(nm, 2),
             m_tex_off=f(nm, 2), m_tex_base=np.full(nm, -1, np.int32),
             m_tex_xmask=i(4, nm), m_tex_ymask=i(4, nm),
             m_tex_xshift=i(4, nm))
    for k in ("m_dff", "m_spc", "m_pow", "m_rfl", "m_trn", "m_rfr",
              "m_ext"):
        d[k] = f(nm)
    k8 = rng.randint(0, 255, (ntex, 3))
    half = rng.rand(ntex, 3) < 0.5
    d["tex_data"] = ((k8 + 0.5 * half).astype(np.float32)
                     / np.float32(255.0)).astype(np.float32)
    d.update(l_pos=f(nlr, 3), l_col=f(nlr, 3), l_cnt=f(nlr), l_lnr=f(nlr),
             l_qdr=f(nlr), l_on=(np.arange(nlr) < nl).astype(np.float32))
    d.update(cam_pos=f(3), cam_hor=f(3), cam_ver=f(3), cam_nrm=f(3),
             cam_pov=np.float32(0.5), amb_col=f(3),
             use_gamma=np.float32(1.0),
             use_fresnel=np.float32(rng.randint(2)))
    sc = SceneArrays(**{k: torch.from_numpy(np.array(d[k]))
                        for k in FIELDS})
    return sc, ck.scene_struct(sc)


@pytest.mark.parametrize("ns,nl", [(1, 1), (31, 0), (32, 2), (33, 4),
                                   (129, 3), (1100, 1)])
def test_rehearsal_bitwise_plain_on_adversarial_arrays(rehearsal, ns, nl):
    """Table heights either side of a word (31, 32, 33) and of bsph_t's
    128-column rows (129), a single row, no light (shad_msk's (NS, 1)
    zeros), and more rows than one staged tile (1100 > TILE = 1024)."""
    sc, struct = _adversarial(ns, nl, seed=ns)
    assert struct.ns == ns and struct.nl == nl
    _assert_rehearsal_is_plain(rehearsal, sc, struct, (ns, nl))
    if ns >= 33:   # the arrays do reach the cases they are made for
        p = _plain(ck.PART_NAMES, sc, struct)
        assert torch.isnan(p["sp_f"][:, 19:25]).any()
        assert (_bits(p["sp_f"][:, 19:25]) == -2 ** 31).any()   # -0.0
        assert (p["sp_f"][:, 19:25].abs() == np.float32(1e30)).any()
        assert torch.isnan(p["bsph_t"]).any()
        assert torch.isinf(p["bsph_t"][3]).any()
        w = torch.cat([p["shad_msk"].reshape(-1), p["cont_msk"].reshape(-1)])
        assert (w < 0).any() and (w != 0).any() and (w != -1).any()


def test_f32_sqrt_is_the_plain_versions_f64_sqrt():
    """cont_msk's distances: csrc/pack.cu takes the f32 sqrt where the
    plain version takes the f64 sqrt rounded to f32; the two agree for
    every f32 >= 0 (f64 has more than 2 * 24 + 2 bits), here on 2^21
    seeded bit patterns over the whole range, denormals, 0, -0 and inf."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 0x7f800000, 1 << 21).astype(np.uint32).view(
        np.float32)
    x = np.concatenate([x, np.float32([0.0, -0.0, np.inf, 1e-45, 3e-38])])
    a = np.sqrt(x)
    b = np.sqrt(x.astype(np.float64)).astype(np.float32)
    assert np.array_equal(a.view(np.int32), b.view(np.int32))


def test_pack_args_mirror_the_c_struct():
    """ops/cuda_kernel.py _PackArgs lists csrc/pack.cu's PackArgs fields in
    order, pointers as c_void_p, ints as c_int, arrays at their lengths;
    PACK_THREADS is the kernel's THREADS and the part order its order."""
    src = open(SRC).read()
    body = re.search(r"struct PackArgs \{(.*?)\n\};", src, re.S).group(1)
    want = []
    for line in body.split("\n"):
        line = line.split("//")[0].strip()
        if not line:
            continue
        ptr = "*" in line
        for name in line.rstrip(";").split(",")[:]:
            name = name.replace("const", "").replace("long long", "")
            name = re.sub(r"\b(int|float|void)\b|\*", "", name).strip()
            m = re.match(r"(\w+)(?:\[(\w+)(?: \+ 1)?\])?", name)
            n = len(ck.PART_NAMES) + ("+ 1" in line) if m.group(2) else 0
            want.append((m.group(1), ptr, n))
    got = []
    for name, ty in ck._PackArgs._fields_:
        if issubclass(ty, ctypes.Array):
            got.append((name, ty._type_ is ctypes.c_void_p, ty._length_))
        else:
            got.append((name, ty is ctypes.c_void_p, 0))
    assert got == want
    assert re.search(r"constexpr int THREADS = (\d+);", src).group(1) == \
        str(ck.PACK_THREADS)
    order = re.search(r"constexpr int (SP_F = 0.*?);", src, re.S).group(1)
    assert [k.split("=")[0].strip().lower() for k in order.split(",")] == \
        list(ck.PART_NAMES)


def test_pack_plan_lays_out_each_part_once():
    """Each part of a launch owns ceil(threads / PACK_THREADS) blocks,
    contiguous, in PART_NAMES order; the parts not launched own none; an
    unknown part or more active lights than light rows raise."""
    sc = _compiled("demo02")
    struct = ck.scene_struct(sc)
    for names in SUBSETS + (("shad_msk",), ("tex_pk", "sp_i")):
        plan = ck.pack_plan(names, struct, 4, sc.tex_data.shape[0])
        assert plan.names == tuple(n for n in ck.PART_NAMES if n in names)
        for p, n in enumerate(ck.PART_NAMES):
            blocks = plan.start[p + 1] - plan.start[p]
            assert blocks == -(-plan.count[p] // ck.PACK_THREADS)
            assert (plan.count[p] > 0) == (n in names)
        assert {k for k, *_ in plan.fields} == {
            k for n, _, fields in ck.PACK_PARTS if n in names
            for k in fields}
    with pytest.raises(ValueError, match="no part named"):
        ck.pack_plan(("sp_f", "bogus"), struct, 4, 1)
    with pytest.raises(ValueError, match="active lights"):
        ck.pack_plan(("lg_f",), struct, 2, 1)


def test_pack_args_check_every_field():
    """The arguments refuse a field of the wrong type, shape or device or
    that is not contiguous, before any launch."""
    sc = _compiled("test13")
    struct = ck.scene_struct(sc)
    stt = ck._struct_tensors(struct, sc.device)
    plan = ck.pack_plan(ck.PART_NAMES, struct, sc.l_pos.shape[0],
                        sc.tex_data.shape[0])
    ck.pack_args(plan, sc, stt, CPU)
    for bad in (dict(s_pos=sc.s_pos.double()), dict(c_ref=sc.c_ref[:, :1]),
                dict(s_inv=sc.s_inv.transpose(1, 2)),
                dict(m_props=sc.m_props.to("meta"))):
        with pytest.raises(ValueError, match=next(iter(bad))):
            ck.pack_args(plan, dataclasses.replace(sc, **bad), stt, CPU)


def test_stale_parts_are_packed_in_one_call(monkeypatch):
    """_PackCache hands pack_parts, in one call, exactly the parts whose
    declared fields are new objects (and the structure's first frame all
    of them); a frame that moved nothing calls it with none."""
    sd = demos.build("demo02")
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device="cpu")
    struct = ck.scene_struct(sc)
    calls = []
    real = ck.pack_parts

    def record(names, *a):
        calls.append(tuple(names))
        return real(names, *a)
    monkeypatch.setattr(ck, "pack_parts", record)
    # room for every field's entry, so no part's first entry is evicted
    cache = ck._PackCache(maxlen=len(FIELDS) + 1)
    cache(sc, struct, cull=False)
    cache(sc, struct)
    cache(sc, struct)
    cache(dataclasses.replace(sc, cam_pos=sc.cam_pos + 1), struct)
    assert calls == [ck.PART_NAMES[:7], ck.CULL_PARTS, (), ()]
    for k in FIELDS:
        calls.clear()
        cache(dataclasses.replace(sc, **{k: getattr(sc, k).clone()}), struct)
        assert calls == [tuple(n for n, _, fields in ck.PACK_PARTS
                               if k in fields)], k
    moved = dict(s_pos=sc.s_pos.clone(), s_inv=sc.s_inv.clone(),
                 s_bsph=sc.s_bsph.clone(), l_pos=sc.l_pos.clone())
    calls.clear()
    got = cache(dataclasses.replace(sc, **moved), struct)
    assert calls == [MOVED]
    want = ck.pack_scene(dataclasses.replace(sc, **moved), struct)
    for f in ck.PackedScene._fields:
        assert _same(getattr(got, f), getattr(want, f)), f


def test_cpu_scene_never_reaches_the_library(monkeypatch):
    """A CPU scene takes the plain parts: pack_scene, the cache and
    cull_table launch nothing and never load csrc/pack.cu."""
    def refuse(*a, **k):
        raise AssertionError("a CPU scene reached the pack's library")
    monkeypatch.setattr(ck, "_pack_lib", refuse)
    sc = _compiled("test13")
    struct = ck.scene_struct(sc)
    before = (ck.pack_launches, ck.cull_launches)
    ps = ck.pack_scene(sc, struct)
    ck._PackCache()(sc, struct, False)
    stt = ck._struct_tensors(struct, sc.device)
    assert _same(ck.cull_table("cont_msk", sc, struct, stt), ps.cont_msk)
    assert (ck.pack_launches, ck.cull_launches) == before
    with pytest.raises(ValueError, match="not a culling table"):
        ck.cull_table("sp_f", sc, struct, stt)


@pytest.mark.parametrize("name", ["demo01", "demo02"])
def test_plain_parts_match_jitted_jax_on_moved_frames(name):
    """Every table of the port's pack_scene on the CPU bitwise the jitted
    JAX pack_scene on the same numpy arrays, at demo01's and demo02's
    moved frames (one XLA compile a scene: the structure is the same)."""
    import jax
    import jax.numpy as jnp
    import quadray_tpu.ops.pallas_kernel as pk
    from quadray_tpu.scene.compile import SceneArrays as JArrays
    frames, struct = _moved_frames(name, 3)
    jpack = jax.jit(pk.pack_scene, static_argnums=1)
    for fi, sc in enumerate(frames):
        j = JArrays(**{k: jnp.asarray(getattr(sc, k).numpy())
                       for k in FIELDS})
        jp = jpack(j, pk.scene_struct(j))
        tp = ck.pack_scene(sc, struct)
        for f in jp._fields:
            a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, (fi, f)
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), \
                (fi, f)


# ---- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (csrc/pack.cu has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test03", "test11", "test13", "demo02",
                                  "demo03"])
def test_pack_launch_bitwise_plain_on_card(name):
    """The one launch of every part, of a J3 frame's moved parts and of
    the training step's seven, bitwise the plain parts on the card; one
    launch each, counted as a culling launch where it wrote a culling
    table."""
    dev = _card()
    sc = _compiled(name, dev)
    struct = ck.scene_struct(sc)
    stt = ck._struct_tensors(struct, dev)
    for names in SUBSETS:
        before = (ck.pack_launches, ck.cull_launches)
        got = ck.pack_parts(names, sc, struct, stt)
        after = (ck.pack_launches, ck.cull_launches)
        assert after[0] == before[0] + 1
        assert after[1] == before[1] + any(n in ck.CULL_PARTS for n in names)
        want = _plain(names, sc, struct)
        torch.cuda.synchronize()
        for n in names:
            assert _same(got[n], want[n]), (name, names, n)


@pytest.mark.cuda
def test_cuda_scene_never_takes_the_plain_parts(monkeypatch):
    """pack_scene, the cache and cull_table on a CUDA scene with every
    plain part made to raise: one launch each."""
    dev = _card()
    sc = _compiled("demo02", dev)
    struct = ck.scene_struct(sc)

    def refuse(*a, **k):
        raise AssertionError("a plain part ran on a CUDA scene")
    monkeypatch.setattr(ck, "_PART_PLAIN", {n: refuse
                                            for n in ck.PART_NAMES})
    before = ck.pack_launches
    ck.pack_scene(sc, struct)
    ck.pack_scene(sc, struct, cull=False)
    ck._PackCache()(sc, struct)
    stt = ck._struct_tensors(struct, dev)
    ck.cull_table("shad_msk", sc, struct, stt)
    torch.cuda.synchronize()
    assert ck.pack_launches == before + 4


@pytest.mark.cuda
def test_pack_captured_in_a_cuda_graph_replays_bitwise():
    """pack_scene (every part, and the training step's seven) captured in
    a CUDA graph, its inputs then overwritten in place with another
    frame's arrays and the graph replayed: the tables bitwise a fresh
    pack_scene of that frame."""
    dev = _card()
    frames, struct = _moved_frames("demo02", 2)
    a, b = (sc.to(dev) for sc in frames)
    for cull in (True, False):
        bufs = dataclasses.replace(a, **{k: getattr(a, k).clone()
                                         for k in FIELDS})
        ck.pack_scene(bufs, struct, cull)   # builds and loads the library
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            ps = ck.pack_scene(bufs, struct, cull)
        for k in FIELDS:
            getattr(bufs, k).copy_(getattr(b, k))
        graph.replay()
        want = ck.pack_scene(b, struct, cull)
        torch.cuda.synchronize()
        for f in ck.PackedScene._fields:
            assert _same(getattr(ps, f), getattr(want, f)), (cull, f)
