"""The scene update as one launch (``csrc/update.cu`` ``update_launch``,
host side ``ops/update.py``) and the interactive frame as one program
(``ops/graphs.py`` ``InteractiveProgram``, ``Scene.render_interactive``):
the kernel's block code built with g++ behind a shim and run on CPU
tensors through the wrapper's own arguments, every field bitwise its plain
version (``SceneStructure.moved_fields``) on the golden scenes, the demos'
animations and camera traces, moving surfaces and lights and adversarial
transforms; the arguments' layout against the C struct; a CPU structure
never reaching the library; the program's body on the CPU against
``Scene.render`` and ``compile_scene``; the fields against the JAX
engine's jitted update; and on the card the launch bitwise the plain
version, replayed from a CUDA graph, the program's frames uint8-equal to
the eager ones, and no plain version on a CUDA scene.

JAX is imported inside the test that uses it, so the card's tests run on
a GPU machine without it:
    python -m pytest tests/test_torch_update_kernel.py --noconftest -q -m cuda
"""

import ctypes
import math
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
from quadray_tpu_torch.ops import graphs as G
from quadray_tpu_torch.ops import update as U
from quadray_tpu_torch.scene import compile as C
from quadray_tpu_torch.scene import schema as S

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "quadray_tpu_torch", "csrc")
SRC = os.path.join(CSRC, "update.cu")
GOLDEN = [f"test{i:02d}" for i in range(1, 19)] + ["demo01", "demo02",
                                                    "demo03"]
# tests/test_torch_incremental.py TIMES
TIMES = (0.0, 1234.5, 5000.0, 77777.7)
# chip_smoke.py J3_TRACE
TRACE = "w,left,w,right,s,up,d,down,a,.".split(",")
GROUPS = tuple(C.MOVED_GROUPS)
W, H = 32, 20


def _sdef(name):
    return demos.build(name) if name.startswith("demo") else load_scene(name)


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        _bits(a), _bits(b))


def _structure(sdef, time=0.0, cam_trm=None, device="cpu"):
    return C.structure_pass(S.SceneDef(root=sdef.root,
                                       opts=S.OPTS_FULL & ~sdef.opts),
                            time=time, cam_trm=cam_trm, device=device)


def _full(sc: E.Scene, t: float):
    return C.compile_scene(
        S.SceneDef(root=sc.sdef.root, opts=sc.opts), time=t,
        cam_index=sc.cam_index, device=sc.device,
        cam_trm=sc.camera.trm() if sc.camera is not None else None,
        **sc._shapes)


def _act(sc, fi):
    key = TRACE[fi % len(TRACE)]
    if fi and key in KEY_ACTIONS:
        sc.update_action(frame_time(fi), KEY_ACTIONS[key])


# ---- the kernel's code on the CPU ---------------------------------------------

SHIM = r"""
#include <cmath>
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(n)
static inline double __dmul_rn(double a, double b) { return a * b; }
static inline double __dadd_rn(double a, double b) { return a + b; }
static inline double __dsqrt_rn(double x) { return std::sqrt(x); }
static inline float __double2float_rn(double x) { return (float)x; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline void __syncthreads() {}
"""
# one thread stands for the block: it takes every row of each level, then
# every output row
BLOCK = r"""
}
extern "C" void update_host(const UpdateArgs* a) { update_block(*a, 0, 1); }
"""


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """csrc/update.cu's device code (UpdateArgs and everything up to the
    __global__ kernel) built with g++ behind a shim, -ffp-contract=off as
    nvcc's --fmad=false."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernel's device code on the CPU"
    src = open(SRC).read()
    body = src[src.index("namespace {"):src.index(
        "__global__ void __launch_bounds__(THREADS) update_kernel")]
    d = tmp_path_factory.mktemp("update")
    (d / "u.cpp").write_text(SHIM + body + BLOCK)
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(d / "u.so"), str(d / "u.cpp")],
                   check=True)
    lib = ctypes.CDLL(str(d / "u.so"))
    lib.update_host.argtypes = [ctypes.POINTER(U._UpdateArgs)]
    lib.update_host.restype = None
    return lib


def _rehearse(lib, st, groups, inp):
    """The fields of ``groups`` as the kernel's block writes them, through
    the wrapper's own arguments on CPU tensors (outputs filled with NaN
    first, so a row the kernel misses shows)."""
    outs = {k: torch.full(s, float("nan"))
            for k, s in U.field_shapes(st, groups).items()}
    scratch = torch.full((st.tables.nq, 16), float("nan"))
    args = U.update_args(st, torch.from_numpy(inp), scratch, outs)
    lib.update_host(ctypes.byref(args))
    return outs


def _assert_rehearsal_is_plain(lib, st, vals, label):
    """Every group at once and each group alone: bitwise the plain
    version on the same staged values."""
    inp = st.local_inputs(vals)
    assert inp.shape == (st.tables.nd, U.IN_W) and inp.dtype == np.float32
    for groups in (GROUPS,) + tuple((g,) for g in GROUPS):
        got = _rehearse(lib, st, groups, inp)
        want = st.moved_fields(groups, vals)
        assert tuple(got) == tuple(want), (label, groups)
        for k in want:
            assert _same(got[k], torch.from_numpy(want[k])), (label, k)


@pytest.mark.parametrize("name", GOLDEN)
def test_rehearsal_bitwise_plain_on_golden_scenes(rehearsal, name):
    """Each golden scene's structure at t = 0: the kernel's fields bitwise
    moved_fields', which structure_pass holds to compile_scene's."""
    st = _structure(_sdef(name))
    _assert_rehearsal_is_plain(rehearsal, st, st.local_values(0.0, None),
                               name)


@pytest.mark.parametrize("name", ["demo01", "demo02", "demo03"])
def test_rehearsal_bitwise_plain_on_animation_and_camera_trace(rehearsal,
                                                              name):
    """demo01-03 at TIMES, then J3's camera trace (ten frames, a camera
    action a frame), each frame's values as Scene.update takes them."""
    sc = E.Scene(_sdef(name), W, H, device="cpu")
    sc.update(0.0)
    st = sc._structure
    for t in TIMES:
        _assert_rehearsal_is_plain(rehearsal, st, st.local_values(t, None),
                                   (name, t))
    for fi in range(1, len(TRACE) + 1):
        _act(sc, fi)
        t = frame_time(fi)
        _assert_rehearsal_is_plain(
            rehearsal, st, st.local_values(t, sc.camera.trm()
                                           if sc.camera else None),
            (name, fi))
        sc.update(t)


def test_rehearsal_bitwise_plain_with_moving_surfaces_and_lights(
        rehearsal):
    """tests/test_torch_incremental.py's rig on test11: a surface, an
    array of surfaces and the first light's holder animated in scale,
    rotation and position."""
    from test_torch_incremental import _rig
    st = _structure(_rig(load_scene("test11")))
    assert all(st.deps[g] for g in GROUPS)
    for t in (0.0, 333.3, 4321.0, 98765.4):
        _assert_rehearsal_is_plain(rehearsal, st, st.local_values(t, None),
                                   t)


def _chain(levels, anim):
    """``levels`` nested arrays, each moved by ``anim(level)``, the deepest
    holding a sphere, a plane, a light and the camera; a sphere and a
    light beside the chain at each level."""
    inner = S.Array(objects=[
        S.obj(S.Sphere(rad=0.5), pos=(0.3, -0.2, 0.1)),
        S.obj(S.Plane(min=(-2.0, -2.0, -S.INF), max=(2.0, 2.0, S.INF))),
        S.obj(S.Light(), pos=(0.0, 0.0, 2.0)),
        S.obj(S.Camera(), rot=(-90.0, 0.0, 0.0), pos=(0.0, -5.0, 0.5))])
    for lv in range(levels - 1, -1, -1):
        inner = S.Array(objects=[
            S.obj(inner, anim=anim(lv)),
            S.obj(S.Sphere(rad=0.25 + 0.1 * lv), pos=(lv, 0.5, -0.5)),
            S.obj(S.Light(src=0.5), pos=(-lv, 1.0, 1.0))])
    return S.SceneDef(root=inner)


def _turning(signs):
    """Animators in scale, rotation past +-360 degrees and position, the
    scale's signs ``signs`` (a negative scale mirrors)."""
    def anim(lv):
        def f(t):
            k = lv + 1
            return S.Transform3D(
                scl=tuple(s * (1.0 + 0.05 * k * math.sin(t / 700.0))
                          for s in signs(lv)),
                rot=(400.0 + 0.3 * k * t, -725.5 - 0.01 * t, 1080.0 * k
                     + t / 9.0),
                pos=(0.1 * k * math.cos(t / 300.0), -0.2 * k, 0.05 * t))
        return f
    return anim


def _zeros(lv):
    """Signed zeros in every angle and position, flipping with t."""
    def f(t):
        z = -0.0 if (int(t) + lv) % 2 else 0.0
        return S.Transform3D(scl=(1.0, -1.0 if lv % 2 else 1.0, 1.0),
                             rot=(z, -z, z), pos=(-z, z, -z))
    return f


def _camera_only():
    sd = load_scene("test13")
    assert not any(o.anim for o in sd.root.objects)
    return sd


ADVERSARIAL = {
    "chain of 8, turning": lambda: _chain(8, _turning(lambda lv: (
        1.0, 1.0, 1.0))),
    "chain of 8, negative scales": lambda: _chain(8, _turning(lambda lv: (
        -1.0 if lv % 2 else 1.0, 1.0, -1.0 if lv % 3 else 1.0))),
    "chain of 3, signed zeros": lambda: _chain(3, _zeros),
    "camera only (test13)": _camera_only,
}


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_rehearsal_bitwise_plain_on_adversarial_transforms(rehearsal, case):
    """A chain of 8 levels whose every level moves (angles past 360
    degrees either way, negative scales), signed zeros in angles and
    positions, and a scene whose only moving node is the camera moved by
    camera actions: the kernel's fields bitwise the plain version's, and
    structure_pass's compile_scene check passes at each time."""
    sd = ADVERSARIAL[case]()
    sc = E.Scene(sd, W, H, device="cpu")
    sc.update(0.0)
    st = sc._structure
    if case.startswith("chain of 8"):
        assert int(st.level.max()) >= 8 and len(st.deps["surf"]) == 8
        assert np.unique(st.level[np.concatenate(
            list(st.need.values()))]).size >= 8
    if case.startswith("camera"):
        assert [g for g in GROUPS if st.deps[g]] == ["cam"]
    for fi, t in enumerate((0.0, 1.0, 2.0, 333.3, 98765.4)):
        sc.update_action(t, (E.CAMERA_ROTATE_LEFT, E.CAMERA_MOVE_FORWARD,
                             E.CAMERA_ROTATE_DOWN)[fi % 3])
        cam = sc.camera.trm()
        _assert_rehearsal_is_plain(rehearsal, st, st.local_values(t, cam),
                                   (case, t))
        full = _full(sc, t)
        got = sc.update(t)
        for k in C.FIELDS:
            assert _same(getattr(got, k), getattr(full, k)), (case, t, k)


def test_signed_zero_angles_reach_the_staged_values():
    """The signed-zero case does stage -0.0 angles' sines and positions
    (so the rehearsal above sees them)."""
    st = _structure(ADVERSARIAL["chain of 3, signed zeros"](), time=1.0)
    inp = st.local_inputs(st.local_values(1.0, None))
    neg = np.signbit(inp) & (inp == 0)
    assert neg[:, 3:6].any() and neg[:, 9:12].any()


# ---- the host side ---------------------------------------------------------------

def test_update_args_mirror_the_c_struct():
    """ops/update.py _UpdateArgs lists csrc/update.cu's UpdateArgs fields
    in order, pointers as c_void_p, ints as c_int; THREADS and the staged
    row's width are the kernel's."""
    src = open(SRC).read()
    body = re.search(r"struct UpdateArgs \{(.*?)\n\};", src, re.S).group(1)
    want = []
    for line in body.split("\n"):
        line = line.split("//")[0].strip()
        if not line:
            continue
        ptr = "*" in line
        for name in line.rstrip(";").split(","):
            name = re.sub(r"\b(const|int|float)\b|\*", "", name).strip()
            want.append((name, ptr))
    got = [(name, ty is ctypes.c_void_p) for name, ty in
           U._UpdateArgs._fields_]
    assert got == want
    assert all(ty in (ctypes.c_void_p, ctypes.c_int)
               for _, ty in U._UpdateArgs._fields_)
    assert re.search(r"constexpr int THREADS = (\d+);", src).group(1) == \
        str(U.THREADS)
    assert re.search(r"constexpr int IN_W = (\d+);", src).group(1) == \
        str(U.IN_W)


def test_update_args_check_every_tensor():
    """The arguments refuse staged values, scratch or an output of the
    wrong type, shape or device, and outputs that are part of a group."""
    st = _structure(demos.build("demo02"))
    inp = torch.from_numpy(st.local_inputs(st.local_values(0.0, None)))
    scratch = torch.zeros((st.tables.nq, 16))
    outs = {k: torch.zeros(s) for k, s in U.field_shapes(st, GROUPS).items()}
    U.update_args(st, inp, scratch, outs)
    for bad in (dict(local=inp.double()), dict(local=inp[:-1]),
                dict(scratch=scratch[:, :8]),
                dict(s_inv=outs["s_inv"].transpose(1, 2)),
                dict(l_pos=outs["l_pos"].to("meta"))):
        (k, v), = bad.items()
        args = dict(local=inp, scratch=scratch, outs=dict(outs))
        if k in outs:
            args["outs"][k] = v
        else:
            args[k] = v
        with pytest.raises(ValueError, match=k):
            U.update_args(st, args["local"], args["scratch"], args["outs"])
    with pytest.raises(ValueError, match="whole groups"):
        U.update_args(st, inp, scratch, {"s_pos": outs["s_pos"]})


def test_plan_orders_rows_by_level():
    """The plan's scratch rows: every node that can move under a group,
    by level, each level's rows after its parents'; the references point
    at a scratch row only for nodes that move."""
    st = _structure(_chain(8, _turning(lambda lv: (1.0, 1.0, 1.0))))
    p = st.plan
    need = np.unique(np.concatenate(list(st.need.values())))
    assert p["par"].size == p["src"].size == need.size == st.tables.nq
    starts = p["lv_start"]
    assert starts[0] == 0 and starts[-1] == need.size
    assert np.all(np.diff(starts) > 0)
    for lv in range(starts.size - 1):
        for q in range(starts[lv], starts[lv + 1]):
            assert p["par"][q] < starts[lv]      # a row of an earlier level
    moving = set(need.tolist())
    for ref, node in zip(p["surf"], st.nodes["surf"]):
        assert (ref >= 0) == (int(node) in moving)
        if ref < 0:
            assert -ref - 1 == node


def test_cpu_structure_never_reaches_the_library(monkeypatch):
    """A CPU scene takes the plain version: structure_pass, updates over
    demo02's animation and a camera trace, and interactive frames launch
    nothing and never load csrc/update.cu."""
    def refuse(*a, **k):
        raise AssertionError("a CPU structure reached the update's library")
    monkeypatch.setattr(U, "_lib", refuse)
    before = U.launches
    sc = E.Scene(_sdef("demo02"), 16, 10, device="cpu")
    for fi in range(4):
        _act(sc, fi)
        sc.update(frame_time(fi))
    sc.render_interactive(frame_time(4))
    sc.render_interactive(frame_time(5))
    assert U.launches == before


# ---- the interactive program on the CPU -------------------------------------

def _stand_in_tracer(monkeypatch):
    """tests/test_torch_graph.py's stand-in for the plain Whitted tracer
    (a cheap function of the rays, the config and the moving fields), on
    the eager path and in the program's body."""
    from test_torch_graph import _stand_in_tracer as stand_in
    return stand_in(monkeypatch)


def _assert_program_frames_match(name, frames, first=0):
    """``frames`` frames of J3's camera trace through the program's body
    and through Scene.render (from frame ``first``; before it the eager
    scene is only updated): uint8-equal frames, the scene's arrays after
    each program frame bitwise compile_scene's at its time and camera, the
    program's field and table buffers bitwise those arrays and a fresh
    pack_scene of them, and no input staged."""
    eager = E.Scene(_sdef(name), W, H, device="cpu")
    prog = E.Scene(_sdef(name), W, H, device="cpu")
    for fi in range(frames):
        _act(eager, fi)
        _act(prog, fi)
        t = frame_time(fi)
        got = prog.render_interactive(t)
        if fi < first:
            eager.update(t)
        else:
            assert np.array_equal(got, eager.render(t)), (name, fi)
        assert prog._arrays is None
        full = _full(prog, t)
        arr = prog.arrays
        for k in C.FIELDS:
            assert _same(getattr(arr, k), getattr(full, k)), (name, fi, k)
        p = prog._interactive_prog
        tables = ck.pack_scene(full, prog._struct)
        for f in ck.PackedScene._fields:
            assert _same(p.inputs.buf[f], getattr(tables, f)), (fi, f)
        for k, v in p.fields.items():
            assert _same(v, getattr(full, k)), (fi, k)
    assert p.parts == ("sp_f", "cl_f", "lg_f", "bsph_t", "shad_msk",
                       "cont_msk")
    assert p.inputs.copies == 0


@pytest.mark.parametrize("name", ["demo01", "demo02"])
def test_interactive_program_matches_render(name):
    """demo01 and demo02 at 32x20 with the plain tracer: the frame after
    the first, after a camera action (and demo02's light array turning
    with t)."""
    _assert_program_frames_match(name, 2, first=1)


@pytest.mark.parametrize("name", ["demo01", "demo02"])
def test_interactive_program_stages_j3_trace(monkeypatch, name):
    """J3's whole camera trace (ten actions and a still frame) with the
    stand-in tracer: at every frame what the program traces (its camera,
    fields and tables) is the eager frame's."""
    calls = _stand_in_tracer(monkeypatch)
    _assert_program_frames_match(name, len(TRACE) + 1)
    assert len(calls) == 2 * (len(TRACE) + 1)


def test_interactive_program_packs_nothing_where_only_the_camera_moves(
        monkeypatch):
    """demo03 (its surfaces and lights never move), with the stand-in
    tracer: the program updates the camera alone and its body calls the
    pack with no part; the frames are Scene.render's."""
    _stand_in_tracer(monkeypatch)
    calls = []
    real = ck.pack_parts

    def record(names, *a, **k):
        calls.append(tuple(names))
        return real(names, *a, **k)
    monkeypatch.setattr(ck, "pack_parts", record)
    eager = E.Scene(_sdef("demo03"), 16, 10, device="cpu")
    prog = E.Scene(_sdef("demo03"), 16, 10, device="cpu")
    for fi in range(3):
        _act(eager, fi)
        _act(prog, fi)
        assert np.array_equal(prog.render_interactive(frame_time(fi)),
                              eager.render(frame_time(fi)))
    p = prog._interactive_prog
    assert set(p.fields) == set(C.MOVED_GROUPS["cam"]) and p.parts == ()
    assert calls.count(()) == 3


def test_interactive_key_and_program_lifetime():
    """The program is kept across frames, made anew for a new key (fsaa)
    and dropped by set_opts with the structure it was made for; a frame
    with t None renders at the last time."""
    sc = E.Scene(_sdef("test01"), 16, 10, device="cpu")
    a = sc.render_interactive(0.0)
    p = sc._interactive_prog
    assert p.st is sc._structure and p.key[-1] == id(sc._structure)
    assert np.array_equal(sc.render_interactive(), a)
    assert sc._interactive_prog is p
    sc.pfm.set_fsaa(2)
    sc.render_interactive(0.0)
    assert sc._interactive_prog is not p
    sc.set_opts(S.OPTS_FULL & ~S.OPTS_TILING)
    assert sc._interactive_prog is None
    b = sc.render_interactive(0.0)
    assert sc._interactive_prog.st is sc._structure
    assert np.array_equal(b, sc.render(0.0))


def test_frame_without_a_time_keeps_the_last_camera():
    """As Scene.render draws its arrays where t is None: after a camera
    action, render_interactive() draws the last frame's time and camera,
    and Scene.arrays after a program frame is that frame's (the action
    shows at the next t), bitwise an eager CPU Scene driven the same
    way; the next t draws the moved camera."""
    eager = E.Scene(_sdef("demo01"), 16, 10, device="cpu")
    prog = E.Scene(_sdef("demo01"), 16, 10, device="cpu")
    first = prog.render_interactive(100.0)
    assert np.array_equal(first, eager.render(100.0))
    for sc in (eager, prog):
        sc.update_action(150.0, E.CAMERA_ROTATE_LEFT)
    for k in C.FIELDS:
        assert _same(getattr(prog.arrays, k), getattr(eager.arrays, k)), k
    assert np.array_equal(prog.render_interactive(), first)
    assert np.array_equal(eager.render(), first)
    moved = prog.render_interactive(200.0)
    assert np.array_equal(moved, eager.render(200.0))
    assert not np.array_equal(moved, first)
    for k in C.FIELDS:
        assert _same(getattr(prog.arrays, k), getattr(eager.arrays, k)), k


def test_interactive_frame_refuses_a_changed_hierarchy():
    sdef = _sdef("test01")
    sc = E.Scene(sdef, 16, 10, device="cpu")
    sc.render_interactive(0.0)
    sdef.root.objects.append(S.obj(S.Sphere(rad=1.0), pos=(0.0, 5.0, 0.0)))
    with pytest.raises(ValueError, match="hierarchy changed"):
        sc.render_interactive(1.0)


def test_fields_match_jax_jitted_update_within_two_ulps():
    """demo01's fields at two later times and after camera actions
    against the JAX engine's frames there, which its Scene.update computes
    with its jitted numeric pass (_update_jit), within
    tests/test_torch_scene.py's bar of 2 ulps at each row's magnitude."""
    from quadray_tpu import engine as JE
    from quadray_tpu.models.scenes import demos as jdemos
    from test_torch_scene import _row_ulps
    ref = JE.Scene(jdemos.build("demo01"), W, H)
    ours = E.Scene(_sdef("demo01"), W, H, device="cpu")
    ref.update(0.0)
    ours.update(0.0)
    frames = []
    for t in (1234.5, 2345.6):
        frames.append((ref.update(t), ours.update(t)))
    for sc, rl, mf in ((ref, JE.CAMERA_ROTATE_LEFT, JE.CAMERA_MOVE_FORWARD),
                       (ours, E.CAMERA_ROTATE_LEFT, E.CAMERA_MOVE_FORWARD)):
        sc.update_action(2500.0, rl)
        sc.update_action(2500.0, mf)
    frames.append((ref.update(2500.0), ours.update(2500.0)))
    assert ref._update_jit is not None
    for a_sc, b_sc in frames:
        for k in C.FIELDS:
            a, b = np.asarray(getattr(a_sc, k)), getattr(b_sc, k).numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if a.dtype.kind == "f":
                assert _row_ulps(a, b) <= 2.0, k
            else:
                assert np.array_equal(a, b), k


# ---- on the card -----------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (csrc/update.cu has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test11", "test13", "demo01", "demo02",
                                  "demo03"])
def test_update_launch_bitwise_plain_on_card(dev, name):
    """Every group at once and each alone, through J3's camera trace: one
    launch each, bitwise moved_fields on the same values."""
    sc = E.Scene(_sdef(name), 200, 120, device=dev)
    sc.update(0.0)
    st = sc._structure
    for fi in range(1, len(TRACE) + 1):
        _act(sc, fi)
        vals = st.local_values(frame_time(fi), sc.camera.trm()
                               if sc.camera else None)
        for groups in (GROUPS,) + tuple((g,) for g in GROUPS):
            before = U.launches
            got = U.moved_fields(st, groups, st.local_inputs(vals))
            assert U.launches == before + 1
            want = st.moved_fields(groups, vals)
            torch.cuda.synchronize()
            for k in want:
                assert _same(got[k].cpu(), torch.from_numpy(want[k])), \
                    (name, fi, groups, k)


@pytest.mark.cuda
def test_update_captured_in_a_cuda_graph_replays_bitwise(dev):
    """The launch after a copy from pinned memory, both captured in a
    CUDA graph (as the interactive program's body); new values written
    into the pinned buffer and the graph replayed: the fields bitwise the
    plain version's of those values."""
    sc = E.Scene(_sdef("demo02"), 200, 120, device=dev)
    sc.update(0.0)
    st = sc._structure
    host = torch.empty((st.tables.nd, U.IN_W), pin_memory=True)
    local = torch.empty((st.tables.nd, U.IN_W), device=dev)
    scratch = torch.empty((st.tables.nq, 16), device=dev)
    outs = {k: torch.empty(s, device=dev)
            for k, s in U.field_shapes(st, GROUPS).items()}
    host.numpy()[...] = st.local_inputs(st.local_values(0.0, None))

    def body():
        local.copy_(host, non_blocking=True)
        U.launch(st, local, outs, scratch)
    body()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for t in (33.3, 1000.0, 77777.7):
        vals = st.local_values(t, None)
        host.numpy()[...] = st.local_inputs(vals)
        graph.replay()
        torch.cuda.synchronize()
        want = st.moved_fields(GROUPS, vals)
        for k in want:
            assert _same(outs[k].cpu(), torch.from_numpy(want[k])), (t, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["demo01", "demo02", "demo03", "test13"])
def test_interactive_frames_match_eager_on_card(dev, name):
    """J3's trace at 200x120: Scene.render replays one graph a frame (the
    update, the Whitted launch and the pack of the moving parts counted
    from the capture, nothing else), each frame uint8-equal to
    render_cuda + to_frame on compile_scene's arrays, and the scene's
    arrays after it bitwise those."""
    from quadray_tpu_torch.ops.trace import TraceConfig, to_frame
    sc = E.Scene(_sdef(name), 200, 120, device=dev)
    for fi in range(2 * len(TRACE) + 1):
        _act(sc, fi)
        t = frame_time(fi)
        before = (ck.launches, U.launches, ck.pack_launches)
        frame = sc.render(t)
        p = sc._interactive_prog
        if fi:
            assert isinstance(p.replay, G.Replay)
            assert (ck.launches - before[0], U.launches - before[1],
                    ck.pack_launches - before[2]) == (1, 1, int(bool(
                        p.parts))), fi
        full = _full(sc, t)
        want = to_frame(ck.render_cuda(full, 200, 120, 1, TraceConfig(
            depth=sc.pfm.depth), struct=sc._struct), full.use_gamma)
        assert np.array_equal(frame, want.cpu().numpy()), (name, fi)
        for k in C.FIELDS:
            assert _same(getattr(sc.arrays, k), getattr(full, k)), (fi, k)
    assert p.inputs.copies == 0


@pytest.mark.cuda
def test_cuda_scene_never_takes_the_plain_version(dev, monkeypatch):
    """With the plain version and the plain pack parts made to raise:
    a CUDA Scene records its structure, updates and renders interactive
    frames through the kernels alone."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on a CUDA scene")
    monkeypatch.setattr(C.SceneStructure, "moved_fields", refuse)
    monkeypatch.setattr(C.SceneStructure, "fields_from_inputs", refuse)
    monkeypatch.setattr(ck, "_PART_PLAIN", {n: refuse
                                            for n in ck.PART_NAMES})
    sc = E.Scene(_sdef("demo02"), 200, 120, device=dev)
    before = U.launches
    for fi in range(4):
        _act(sc, fi)
        sc.render(frame_time(fi))
        sc.update(frame_time(fi) + 5.0)
    torch.cuda.synchronize()
    assert U.launches > before + 4
