"""The engine's incremental update (``scene/compile.py`` ``structure_pass``
and ``numeric_pass``, ``Scene.update``) and the pack by parts
(``ops/cuda_kernel.py`` ``_get_packed``): every SceneArrays field of the
numeric pass bitwise ``compile_scene``'s at the same time and camera, the
time-invariant fields the same tensors across frames, the packed tables
bitwise a full ``pack_scene``'s, culled and unculled, no hierarchy walk
after the first frame, and a changed hierarchy refused.

JAX is imported inside the one test that uses it, so the card's test runs
on a GPU machine without it:
    python -m pytest tests/test_torch_incremental.py --noconftest -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from quadray_tpu_torch import engine as E
from quadray_tpu_torch.apps.render_cli import frame_time
from quadray_tpu_torch.models.scenes import demos
from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.scene import compile as C
from quadray_tpu_torch.scene import schema as S

torch.set_num_threads(1)

W, H = 32, 20
# demo03's animator calls math.sin of t, which the JAX engine cannot trace
TIMES = (0.0, 1234.5, 5000.0, 77777.7)


def _sdef(name):
    return demos.build(name) if name.startswith("demo") else load_scene(name)


def _full(sc: E.Scene, t: float):
    """The plain version of sc's frame at t: compile_scene with the
    scene's shapes and its controller's camera."""
    return C.compile_scene(
        S.SceneDef(root=sc.sdef.root, opts=sc.opts), time=t,
        cam_index=sc.cam_index, device=sc.device,
        cam_trm=sc.camera.trm() if sc.camera is not None else None,
        **sc._shapes)


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


def _assert_fields_equal(got, want):
    for k in C.FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert torch.equal(_bits(a), _bits(b)), k


def _assert_packs_equal(got, struct):
    """The cached pack of the frame ``got`` bitwise a full pack_scene of
    the plain compile, culled and unculled."""
    for cull in (True, False):
        a = ck._get_packed(got[0], struct, cull)
        b = ck.pack_scene(got[1], struct, cull)
        for f in ck.PackedScene._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert x.shape == y.shape and torch.equal(_bits(x), _bits(y)), \
                (f, cull)


def _no_walk(monkeypatch):
    """Make any hierarchy walk, full compile or structure pass raise."""
    def refuse(*a, **k):
        raise AssertionError("a hierarchy walk after the first frame")
    for mod, name in ((C, "_walk"), (C, "compile_scene"),
                      (C, "structure_pass"), (E, "structure_pass"),
                      (C.SceneStructure, "__init__")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("name", ["demo01", "demo02", "demo03"])
def test_numeric_pass_matches_compile_over_animation(name, monkeypatch):
    """demo01-03 at TIMES: every field bitwise compile_scene's, after the
    first frame no walk, the invariant fields the first frame's tensors,
    and the packs bitwise a full pack_scene's, culled and unculled."""
    sc = E.Scene(_sdef(name), W, H, device="cpu")
    first = sc.update(TIMES[0])
    struct = ck.scene_struct(first)
    for t in TIMES:
        with monkeypatch.context() as m:
            _no_walk(m)
            got = sc.update(t)
        _assert_fields_equal(got, _full(sc, t))
        for k in C.FIELDS:
            if k not in C.MOVED_FIELDS:
                assert getattr(got, k) is getattr(first, k), k
        _assert_packs_equal((got, _full(sc, t)), struct)
    # demo01 and demo02 animate a light array holding an emissive surface
    moves = {g: bool(sc._structure.deps[g]) for g in C.MOVED_GROUPS}
    assert moves == {"surf": name != "demo03", "light": name != "demo03",
                     "cam": True}


def _actions(seed, n):
    """Seeded (time, action, update) steps over all ten camera actions, as
    tests/test_torch_camera.py draws them."""
    rng = np.random.default_rng(seed)
    dts = np.where(rng.random(n) < 0.1, rng.uniform(0.0, 6000.0, n),
                   rng.uniform(0.0, 200.0, n))
    times = np.cumsum(dts).tolist()
    actions = rng.integers(1, 11, n).tolist()
    upd = (rng.random(n) < 0.7).tolist()
    assert set(actions) == set(range(1, 11))
    return zip(times, actions, upd)


@pytest.mark.parametrize("name,steps,stride",
                         [("test01", 80, 1), ("test13", 60, 2)])
def test_numeric_pass_matches_compile_under_camera_actions(
        name, steps, stride, monkeypatch):
    """A seeded sequence of camera actions: after every update (test01)
    or every second one (test13), every field bitwise compile_scene's
    with the controller's camera and the packs bitwise pack_scene's; a
    camera-only frame re-packs no table (the same tensors as the frame
    before) and moves only the camera's rows."""
    sc = E.Scene(_sdef(name), W, H, device="cpu")
    prev = sc.update(0.0)
    struct = ck.scene_struct(prev)
    prev_pack = ck._get_packed(prev, struct)
    checked = 0
    for i, (t, a, upd) in enumerate(_actions(7, steps)):
        sc.update_action(t, a)
        if not upd:
            continue
        with monkeypatch.context() as m:
            _no_walk(m)
            got = sc.update(t)
        for k in C.FIELDS:
            if k not in C.MOVED_GROUPS["cam"]:
                assert getattr(got, k) is getattr(prev, k), k
        pack = ck._get_packed(got, struct)
        assert all(x is y for x, y in zip(pack, prev_pack))
        if i % stride == 0:
            full = _full(sc, t)
            _assert_fields_equal(got, full)
            _assert_packs_equal((got, full), struct)
            checked += 1
        prev, prev_pack = got, pack
    assert checked >= steps // (3 * stride)


def _rig(sdef):
    """Animators on a top-level surface, a top-level array of surfaces and
    the array or object that holds the first light, each moving scale,
    rotation and position with t."""
    objs = sdef.root.objects

    def anim(base, k):
        def f(t):
            s = 1.0 + 0.1 * k * np.sin(t / 900.0)
            return S.Transform3D(
                scl=tuple(float(v) * s for v in base.scl),
                rot=(base.rot[0] + 0.01 * k * t, base.rot[1] - 0.02 * t,
                     (base.rot[2] + t * k / 70.0) % 360.0),
                pos=tuple(float(v) + 0.3 * k * np.cos(t / (500.0 + k))
                          for v in base.pos))
        return f

    srf = next(o for o in objs if isinstance(o.item, S.Surface))
    arr = next(o for o in objs if isinstance(o.item, S.Array)
               and any(isinstance(c.item, S.Surface) for c in o.item.objects))

    def holds_light(o):
        if isinstance(o.item, S.Light):
            return True
        return isinstance(o.item, S.Array) and any(
            holds_light(c) for c in o.item.objects)

    lgt = next(o for o in objs if holds_light(o))
    for k, o in enumerate((srf, arr, lgt), 1):
        o.anim = anim(o.trm, k)
    return sdef


def test_moving_surfaces_and_lights_match_compile(monkeypatch):
    """test11 (12 surfaces, 4 lights) with surfaces and lights animated:
    s_pos, s_inv, s_fwd, s_bsph and l_pos bitwise compile_scene's at
    every time, with the culling tables (bounding spheres, shadow and
    continuation masks) re-packed bitwise."""
    sc = E.Scene(_rig(load_scene("test11")), W, H, device="cpu")
    first = sc.update(0.0)
    struct = ck.scene_struct(first)
    assert all(sc._structure.deps[g] for g in C.MOVED_GROUPS)
    for t in (0.0, 333.3, 4321.0, 98765.4):
        with monkeypatch.context() as m:
            _no_walk(m)
            got = sc.update(t)
        full = _full(sc, t)
        _assert_fields_equal(got, full)
        _assert_packs_equal((got, full), struct)
        for k in C.MOVED_GROUPS["surf"] + C.MOVED_GROUPS["light"]:
            assert t == 0.0 or not torch.equal(getattr(got, k),
                                               getattr(first, k)), k


def test_unmoved_frame_returns_the_same_arrays():
    """A frame whose animators and camera give the transforms of the
    frame before is that frame's SceneArrays itself."""
    sc = E.Scene(_sdef("test13"), W, H, device="cpu")
    a = sc.update(0.0)
    assert sc.update(500.0) is a
    sc.update_action(600.0, E.CAMERA_MOVE_FORWARD)
    b = sc.update(600.0)
    assert b is not a and sc.update(700.0) is b


def test_zero_sign_change_is_a_move():
    """A transform whose only change is the sign of a zero moves its group
    (the frames' keys are bits, not values): the frame is recomputed,
    bitwise compile_scene's, and a frame with the same bits is not."""
    sdef = _sdef("test01")
    ob = next(o for o in sdef.root.objects if isinstance(o.item, S.Surface))
    base = ob.trm
    ob.anim = lambda t: S.Transform3D(
        scl=base.scl, rot=base.rot,
        pos=(float(base.pos[0]), float(base.pos[1]), 0.0 if t < 1.0
             else -0.0))
    sc = E.Scene(sdef, W, H, device="cpu")
    a = sc.update(0.0)
    b = sc.update(2.0)
    assert b is not a and sc.update(3.0) is b
    _assert_fields_equal(b, _full(sc, 2.0))


def test_plain_culling_tables_are_the_plain_versions(monkeypatch):
    """The plain tracer's culling (ops/trace.py Cull) builds its tables
    with their plain versions (CULL_PLAIN), never through the pack that
    the kernels read, so no culling kernel is shared by a kernel and the
    plain tracer it is held against."""
    from quadray_tpu_torch.ops.trace import Cull, TraceConfig
    assert [fn for _, fn, _ in ck._get_cull_plain._def] == [
        ck.CULL_PLAIN[k] for k in ck.CULL_PARTS]
    sd = _sdef("demo02")
    sc = C.compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         time=900.0, device="cpu")
    struct = ck.scene_struct(sc)

    def refuse(*a, **k):
        raise AssertionError("the plain tracer read the kernels' pack")
    monkeypatch.setattr(ck, "_get_packed", refuse)
    monkeypatch.setattr(ck, "cull_table", refuse)
    cull = Cull(sc, TraceConfig())
    assert cull.gates.cull and cull.gates.lsort and cull.gates.cont
    stt = ck._struct_tensors(struct, sc.device)
    n = struct.n_real
    assert torch.equal(cull.spheres,
                       ck.CULL_PLAIN["bsph_t"](sc, struct, stt)[:, 0, :n])


def test_demo01_matches_jax_within_two_ulps():
    """demo01 at two times and a camera-moved frame against the JAX
    package's eager compile_scene, within tests/test_torch_scene.py's bar
    of 2 ulps at each row's magnitude."""
    from quadray_tpu.models.scenes import demos as jdemos
    from quadray_tpu.scene import schema as JS
    from quadray_tpu.scene.compile import compile_scene as jcompile
    from test_torch_scene import _row_ulps
    jd = jdemos.build("demo01")
    jdef = JS.SceneDef(root=jd.root, opts=JS.OPTS_FULL & ~jd.opts)
    sc = E.Scene(_sdef("demo01"), W, H, device="cpu")
    frames = []
    for t in (0.0, 2345.6):
        frames.append((sc.update(t), jcompile(jdef, time=t)))
    sc.update_action(2500.0, E.CAMERA_ROTATE_LEFT)
    sc.update_action(2500.0, E.CAMERA_MOVE_FORWARD)
    got = sc.update(2500.0)
    c = sc.camera
    frames.append((got, jcompile(jdef, time=2500.0, cam_trm=JS.Transform3D(
        scl=c.scl, rot=tuple(c.rot), pos=tuple(c.pos)))))
    for got, ref in frames:
        for k in C.FIELDS:
            a, b = np.asarray(getattr(ref, k)), getattr(got, k).numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if a.dtype.kind == "f":
                assert _row_ulps(a, b) <= 2.0, k
            else:
                assert np.array_equal(a, b), k


def test_changed_structure_raises_and_set_opts_records_again():
    sdef = _sdef("test01")
    sc = E.Scene(sdef, W, H, device="cpu")
    sc.update(0.0)
    root = sdef.root
    extra = S.obj(S.Surface(tag=S.TAG_SPHERE, rad=1.0), pos=(0.0, 5.0, 0.0))
    root.objects.append(extra)
    with pytest.raises(ValueError, match="hierarchy changed"):
        sc.update(1.0)
    root.objects.pop()
    sc.update(2.0)
    # a static transform changed in place, a replaced item, a new animator
    ob = next(o for o in root.objects if isinstance(o.item, S.Surface))
    pos = ob.trm.pos
    ob.trm.pos = (pos[0] + 1.0, pos[1], pos[2])
    with pytest.raises(ValueError, match="static transform"):
        sc.update(3.0)
    ob.trm.pos = pos
    item = ob.item
    ob.item = dataclasses.replace(item, rad=2.0)
    with pytest.raises(ValueError, match="hierarchy changed"):
        sc.update(4.0)
    ob.item = item
    ob.anim = lambda t: ob.trm
    with pytest.raises(ValueError, match="hierarchy changed"):
        sc.update(5.0)
    ob.anim = None
    root.relations.append(S.Relation(0, S.REL_MINUS_OUTER, 1))
    with pytest.raises(ValueError, match="hierarchy changed"):
        sc.update(6.0)
    root.relations.pop()
    sc.update(7.0)
    sc.sdef = dataclasses.replace(sdef, root=S.Array(
        objects=list(root.objects), relations=list(root.relations)))
    with pytest.raises(ValueError, match="new Scene"):
        sc.update(8.0)
    # set_opts records the structure again: the added object, culling
    # off, and the new padded shapes
    sc.sdef = sdef
    root.objects.append(extra)
    old = sc._structure
    sc.set_opts(S.OPTS_FULL & ~S.OPTS_TILING)
    got = sc.update(9.0)
    assert sc._structure is not old
    _assert_fields_equal(got, _full(sc, 9.0))
    assert int(got.s_bnd.sum()) == 0 and int((got.s_kind > 0).sum()) == 5


def test_pack_parts_read_what_they_declare():
    """Each part of the pack, and scene_struct, reads exactly the
    SceneArrays fields it is keyed on (PACK_PARTS, STRUCT_FIELDS)."""
    sc = C.compile_scene(S.SceneDef(root=_sdef("demo02").root), device="cpu")
    struct = ck.scene_struct(sc)
    stt = ck._struct_tensors(struct, sc.device)

    class Reads:
        def __init__(self):
            self.seen = set()

        def __getattr__(self, k):
            self.seen.add(k)
            return getattr(sc, k)

    for name, fn, fields in ck.PACK_PARTS:
        r = Reads()
        fn(r, struct, stt)
        assert r.seen == set(fields), name
    r = Reads()
    ck.scene_struct(r)
    assert r.seen == set(ck.STRUCT_FIELDS)


def test_cached_pack_never_reuses_a_stale_part():
    """Every field replaced by a changed tensor: the cached pack equals a
    fresh pack_scene of the changed scene, and differs from the old pack
    where a part reads the field."""
    sd = _sdef("demo02")
    sc = C.compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         device="cpu")
    struct = ck.scene_struct(sc)
    cache = ck._PackCache()
    base = cache(sc, struct)
    read = {k for _, _, fields in ck.PACK_PARTS for k in fields}
    for k in C.FIELDS:
        v = getattr(sc, k)
        new = (v + 0.25 if v.is_floating_point()
               else torch.roll(v, 1, dims=0))
        sc2 = dataclasses.replace(sc, **{k: new})
        got, want = cache(sc2, struct), ck.pack_scene(sc2, struct)
        changed = False
        for f in ck.PackedScene._fields:
            a, b = getattr(got, f), getattr(want, f)
            assert torch.equal(_bits(a), _bits(b)), (k, f)
            changed |= not torch.equal(_bits(a), _bits(getattr(base, f)))
        assert changed == (k in read), k


def test_get_struct_keys_on_the_fields_it_reads():
    sc = C.compile_scene(S.SceneDef(root=_sdef("test03").root), device="cpu")
    a = ck._get_struct(sc)
    assert ck._get_struct(dataclasses.replace(sc, s_pos=sc.s_pos + 1)) is a
    b = ck._get_struct(dataclasses.replace(sc, s_bnd=sc.s_bnd * 0))
    assert b is not a and not any(b.bnd)


@pytest.mark.cuda
def test_incremental_update_on_card():
    """demo01 and test13 on the card through J3's trace: the arrays and
    the packed tables bitwise the plain compile's and pack's, and the
    frame uint8-equal to the full path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS
    from quadray_tpu_torch.ops.trace import TraceConfig, to_frame
    trace = "w,left,w,right,s,up,d,down,a,.".split(",")
    for name in ("demo01", "test13"):
        sc = E.Scene(_sdef(name), 200, 120, device="cuda")
        for fi in range(12):
            t = frame_time(fi)
            if fi:
                sc.update_action(t, KEY_ACTIONS.get(trace[fi % len(trace)],
                                                    E.CAMERA_MOVE_UP))
            frame = sc.render(t)
            full = _full(sc, t)
            _assert_fields_equal(sc.arrays, full)
            _assert_packs_equal((sc.arrays, full), sc._struct)
            lin = ck.render_cuda(full, 200, 120, 1, TraceConfig(
                depth=sc.pfm.depth), struct=sc._struct)
            assert np.array_equal(frame, to_frame(lin, full.use_gamma)
                                  .cpu().numpy()), (name, fi)


def test_cull_tables_on_cpu_take_the_plain_versions():
    """cull_table on a CPU scene is its plain version, bit for bit, and
    launches nothing; an unsupported device raises."""
    sd = _sdef("demo02")
    sc = C.compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         time=900.0, device="cpu")
    struct = ck.scene_struct(sc)
    stt = ck._struct_tensors(struct, sc.device)
    before = ck.cull_launches
    for name in ck.CULL_PARTS:
        a = ck.cull_table(name, sc, struct, stt)
        b = ck.CULL_PLAIN[name](sc, struct, stt)
        assert torch.equal(_bits(a), _bits(b)), name
    assert ck.cull_launches == before
    meta = dataclasses.replace(sc, s_bsph=sc.s_bsph.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ck.cull_table("bsph_t", meta, struct, stt)


@pytest.mark.cuda
def test_plain_culling_launches_no_kernel_on_card():
    """On the card too, the plain tracer's culling tables are the plain
    versions': building them launches no culling kernel, and they are
    bitwise the kernels'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from quadray_tpu_torch.ops.trace import Cull, TraceConfig
    sd = _sdef("demo02")
    sc = C.compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         time=900.0, device="cuda")
    before = ck.cull_launches
    cull = Cull(sc, TraceConfig())
    assert cull.gates.cull and ck.cull_launches == before
    struct = ck.scene_struct(sc)
    ps = ck._get_packed(sc, struct)
    assert ck.cull_launches == before + 1   # one pack launch, all tables
    assert torch.equal(cull.spheres, ps.bsph_t[:, 0, :struct.n_real])


@pytest.mark.cuda
def test_cull_kernels_match_plain_on_card():
    """csrc/pack.cu's three culling tables bitwise their plain versions on
    the card, on scenes with clips, several lights and animated spheres."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in ("test03", "test11", "test13", "demo02", "demo03"):
        sd = _sdef(name)
        for t in (0.0, 2500.0):
            sc = C.compile_scene(S.SceneDef(root=sd.root,
                                            opts=S.OPTS_FULL & ~sd.opts),
                                 time=t, device="cuda")
            struct = ck.scene_struct(sc)
            stt = ck._struct_tensors(struct, sc.device)
            before = ck.cull_launches
            for part in ck.CULL_PARTS:
                a = ck.cull_table(part, sc, struct, stt)
                b = ck.CULL_PLAIN[part](sc, struct, stt)
                assert torch.equal(_bits(a), _bits(b)), (name, t, part)
            assert ck.cull_launches == before + 3
