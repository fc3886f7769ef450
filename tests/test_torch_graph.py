"""One CUDA graph a frame and a path-traced pass (``ops/graphs.py``): the
interactive and pass programs against the eager paths they replace.

On the CPU a program's body is called each time (``capture`` returns it),
with the plain tracers in the kernels' place; the interactive program's
buffers, its key, the returned frames' ownership, the pass program's
staging and its in-place sum and seeds are the same code as on the card. Held bitwise to
``Scene.render`` (``render_linear`` + ``to_frame``), ``render_pt_pass``
(``pt_passes``) and ``render_pt_cuda``, and, as a whole, to the JAX
engine. A stand-in for the plain tracer, a cheap function of everything
it is given, stands in where J3's 61-frame trace on test13 or demo02's
animation would take minutes: on the CPU the body's tracer reads the frame's
SceneArrays, as the eager path's does, so what is held there is every
input beside the tracer's scene (the camera, the rays, the AA mean,
to_frame, use_gamma) and the program's tables, held bitwise to a fresh
``pack_scene`` at every frame.

JAX is imported inside the two tests that use it, so the card's cases
run on a GPU machine without it:
    python -m pytest tests/test_torch_graph.py --noconftest -q -m cuda
"""

import numpy as np
import pytest
import torch

from quadray_tpu_torch import Platform, Scene
from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS, frame_time
from quadray_tpu_torch.models.scenes import demos
from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops import graphs as G
from quadray_tpu_torch.ops import trace as T
from quadray_tpu_torch.ops.pt import init_seeds
from quadray_tpu_torch.ops.trace import TraceConfig, to_frame
from quadray_tpu_torch.parallel.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
from quadray_tpu_torch.scene import schema as S

torch.set_num_threads(1)

W, H = 64, 40
# chip_smoke.py J3_TRACE: a camera action a frame, "." none
J3_TRACE = "w,left,w,right,s,up,d,down,a,.".split(",")
J3_FRAMES = 60


def _sdef(name):
    return demos.build(name) if name.startswith("demo") else load_scene(name)


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        _bits(a), _bits(b))


def _act(sc, fi):
    for key in J3_TRACE[fi % len(J3_TRACE)].split("+"):
        if fi and key in KEY_ACTIONS:
            sc.update_action(frame_time(fi), KEY_ACTIONS[key])


def _stand_in_tracer(monkeypatch):
    """The plain Whitted tracer, on the eager path (ops.trace.render) and
    in the program's body (ops.cuda_kernel.launch_whitted), replaced by a
    cheap function of the rays, the config and the fields a frame moves;
    returns its call count."""
    calls = []

    def tracer(sc, org, dirs, t_min, cfg):
        calls.append(1)
        moved = sum((f.flatten() * torch.arange(f.numel())).sum()
                    for f in (sc.s_pos, sc.l_pos, sc.s_bsph)) + sc.use_gamma
        cols = torch.stack([dirs[:, 0] * 31.0 + org[0],
                            dirs[:, 1] * 37.0 + org[1] + t_min,
                            dirs[:, 2] * 41.0 + org[2] + cfg.depth], dim=1)
        return torch.frac((cols + moved).abs() * 7.0) * 1.2 - 0.1

    monkeypatch.setattr(T, "trace_rays", tracer)
    monkeypatch.setattr(ck, "trace_rays", tracer)
    return calls


def _assert_staged(sc):
    """The interactive program's buffers hold the frame's camera,
    use_gamma and a fresh pack_scene of its arrays (the scene's arrays
    after the frame), bit for bit, and it staged no input."""
    prog, arr = sc._interactive_prog, sc.arrays
    assert prog.inputs.copies == 0
    buf = prog.inputs.buf
    for k in G.CAMERA + ("use_gamma",):
        assert _same(buf[k], getattr(arr, k)), k
    want = ck.pack_scene(arr, sc._struct)
    for f in ck.PackedScene._fields:
        assert _same(buf[f], getattr(want, f)), f


def _j3_pair(name, fsaa):
    mk = lambda: Scene(_sdef(name), W, H, pfm=Platform(fsaa=fsaa),
                       device="cpu")
    return mk(), mk()


@pytest.mark.parametrize("fsaa", [1, 2])
def test_frame_program_matches_render_on_j3_trace(fsaa):
    """test01 with the plain tracer: one pass through J3's actions (the
    first frame and one frame each), the interactive program's frames
    bitwise Scene.render's, and every frame it returned still as it
    was."""
    eager, prog = _j3_pair("test01", fsaa)
    got = []
    for fi in range(len(J3_TRACE) + 1):
        _act(eager, fi)
        _act(prog, fi)
        want = eager.render(frame_time(fi))
        frame = prog.render_interactive(frame_time(fi))
        assert frame.shape == (H, W, 3) and frame.dtype == np.uint8
        assert np.array_equal(frame, want), fi
        got.append((frame, want))
    assert all(np.array_equal(f, w) for f, w in got)
    assert not np.array_equal(got[0][0], got[-1][0])


@pytest.mark.parametrize("fsaa", [1, 2])
@pytest.mark.parametrize("name", ["test01", "test13"])
def test_frame_program_stages_j3_trace(monkeypatch, name, fsaa):
    """J3's whole trace (60 frames after the first): at every frame the
    interactive program's frame bitwise Scene.render's, its buffers the
    frame's camera and a fresh pack, nothing staged; a frame whose camera
    and scene did not move ("." on a scene without animators) too."""
    calls = _stand_in_tracer(monkeypatch)
    eager, prog = _j3_pair(name, fsaa)
    still = 0
    for fi in range(J3_FRAMES + 1):
        _act(eager, fi)
        _act(prog, fi)
        want = eager.render(frame_time(fi))
        frame = prog.render_interactive(frame_time(fi))
        assert np.array_equal(frame, want), fi
        _assert_staged(prog)
        if fi and J3_TRACE[fi % len(J3_TRACE)] == ".":
            still += 1
    assert still == J3_FRAMES // len(J3_TRACE)
    assert len(calls) == 2 * (J3_FRAMES + 1)


@pytest.mark.parametrize("fsaa", [1, 2])
def test_frame_program_stages_animation(monkeypatch, fsaa):
    """demo02's animation (its surfaces and lights move with t): the
    moved pack parts reach the buffers, frame by frame, and the frames are
    Scene.render's; a repeated frame is the same frame."""
    _stand_in_tracer(monkeypatch)
    eager, prog = _j3_pair("demo02", fsaa)
    moved, frames, last = set(), [], None
    for t in (0.0, 33.3, 66.7, 1000.0):
        frame = prog.render_interactive(t)
        assert np.array_equal(frame, eager.render(t)), t
        _assert_staged(prog)
        buf = prog._interactive_prog.inputs.buf
        if last is not None:
            moved |= {k for k in buf if not _same(buf[k], last[k])}
        last = {k: v.clone() for k, v in buf.items()}
        frames.append(frame)
    assert {"sp_f", "lg_f", "bsph_t", "shad_msk"} <= moved, moved
    assert not np.array_equal(frames[0], frames[-1])
    assert np.array_equal(prog.render_interactive(1000.0), frames[-1])
    _assert_staged(prog)


def test_frame_with_nothing_moved_copies_nothing():
    """The interactive program owns every input it reads (the camera and
    use_gamma are its field buffers or the structure's, the tables its
    own or the structure's pack): it stages none, and a repeated frame is
    the same frame, a new array."""
    sc = Scene(load_scene("test01"), 16, 10, device="cpu")
    a = sc.render_interactive(0.0)
    prog = sc._interactive_prog
    assert set(prog.inputs.buf) == set(G.CAMERA) | {"use_gamma"} | set(
        ck.PackedScene._fields)
    b = sc.render_interactive(0.0)
    assert sc._interactive_prog is prog and prog.inputs.copies == 0
    assert np.array_equal(a, b) and a is not b


def test_returned_frame_is_the_callers():
    """A frame returned earlier is unchanged after later ones, and the
    pinned buffer is never handed out."""
    sc = Scene(load_scene("test01"), 32, 20, device="cpu")
    first = sc.render_interactive(0.0)
    kept = first.copy()
    sc.update_action(100.0, KEY_ACTIONS["left"])
    second = sc.render_interactive(100.0)
    assert np.array_equal(first, kept) and not np.array_equal(first, second)
    assert not np.shares_memory(second, sc._interactive_prog.host.numpy())


def _recorded_captures(monkeypatch):
    """graphs.capture replaced by a recorder that runs it (on the CPU: the
    body) and counts the replays of what it returned."""
    rec = {"captures": 0, "replays": 0}
    real = G.capture

    def capture(body, device):
        rec["captures"] += 1
        run = real(body, device)

        def replay():
            rec["replays"] += 1
            run()
        return replay

    monkeypatch.setattr(G, "capture", capture)
    return rec


CHANGES = {
    "set_opts": lambda sc, mp: sc.set_opts(S.OPTS_FULL & ~S.OPTS_TILING),
    "set_fsaa": lambda sc, mp: sc.pfm.set_fsaa(2),
    "depth": lambda sc, mp: setattr(sc.pfm, "depth", 4),
    "COOP_MAX_LIVE": lambda sc, mp: mp.setattr(ck, "COOP_MAX_LIVE", 0),
    "EMIT_OWN_MIN_KEPT": lambda sc, mp: mp.setattr(ck, "EMIT_OWN_MIN_KEPT",
                                                   8),
    "WHOLE_OWN_MAX_RAYS": lambda sc, mp: mp.setattr(
        ck, "WHOLE_OWN_MAX_RAYS", 100),
    "CULL_MIN_SURFACES": lambda sc, mp: mp.setattr(ck, "CULL_MIN_SURFACES",
                                                   1),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_new_key_makes_a_new_capture(monkeypatch, change):
    """What a capture freezes is the program's key: after each change the
    next frame captures anew (and replays after that), with the frame the
    eager path renders; without one, frames replay."""
    rec = _recorded_captures(monkeypatch)
    sc = Scene(load_scene("test01"), 16, 10, device="cpu")
    sc.render_interactive(0.0)
    sc.render_interactive(0.0)
    assert rec == {"captures": 1, "replays": 1}
    CHANGES[change](sc, monkeypatch)
    frame = sc.render_interactive(0.0)
    assert rec == {"captures": 2, "replays": 1}
    assert np.array_equal(sc.render_interactive(0.0), frame)
    assert rec == {"captures": 2, "replays": 2}
    assert np.array_equal(frame, sc.render(0.0))


@pytest.mark.parametrize("change", ["depth", "PT_CULL_MIN_SURFACES"])
def test_a_new_pass_key_makes_a_new_capture(monkeypatch, change):
    """The pass program's key: depth and PT's gates; the running sum
    carries over into the new program's buffers."""
    rec = _recorded_captures(monkeypatch)
    sc = Scene(load_scene("test18"), 16, 10, device="cpu")
    ref = Scene(load_scene("test18"), 16, 10, device="cpu")
    assert sc.set_pton(True) and ref.set_pton(True)
    sc.render_pt_program(2)
    ref.render_pt_pass(2)
    # a pass capture and two replays' worth: the first pass is the body,
    # the second a replay; the frame body its own capture
    assert rec == {"captures": 2, "replays": 1}
    for s in (sc, ref):
        if change == "depth":
            s.pfm.depth = 6
    if change != "depth":
        monkeypatch.setattr(ck, change, 1)
    got, want = sc.render_pt_program(1), ref.render_pt_pass(1)
    assert rec == {"captures": 4, "replays": 1}
    assert np.array_equal(got, want)
    assert _same(sc._pt_acc, ref._pt_acc) and _same(sc._pt_seeds,
                                                     ref._pt_seeds)


def test_replay_adds_the_launches_its_capture_recorded(monkeypatch):
    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    monkeypatch.setattr(ck, "launches", 5)
    monkeypatch.setattr(ck, "pt_launches", 7)
    run = G.Replay(Graph(), {"launches": 1, "pt_launches": 2}, 0.0)
    run()
    run()
    assert (Graph.replays, ck.launches, ck.pt_launches) == (2, 7, 11)


def test_inputs_stage_copies_new_objects_only():
    inp = G.Inputs()
    a = torch.arange(6, dtype=torch.float32)
    inp.stage("x", a)
    buf = inp.buf["x"]
    assert buf is not a and torch.equal(buf, a) and inp.copies == 1
    inp.stage("x", a)
    inp.stage("x", buf)
    assert inp.copies == 1
    b = a + 1
    inp.stage("x", b)
    assert inp.buf["x"] is buf and torch.equal(buf, b) and inp.copies == 2
    with pytest.raises(ValueError, match="structure changed"):
        inp.stage("x", torch.zeros(7))


PT_W, PT_H = 40, 24


def _pt_scene(w=24, h=16):
    sc = Scene(load_scene("test18"), w, h, device="cpu")
    assert sc.set_pton(True)
    return sc


def test_pass_program_matches_pt_passes_and_resumes(tmp_path):
    """Calls of 1, 2 and 3 passes: the program's frames, sum and seeds
    bitwise render_pt_pass's (pt_passes); pt_state hands out copies; a
    checkpoint of the program's state, resumed in another Scene's
    program, continues bit for bit."""
    eager, prog = _pt_scene(), _pt_scene()
    states = []
    for n in (1, 2, 3):
        want = eager.render_pt_pass(n)
        got = prog.render_pt_program(n)
        assert np.array_equal(got, want), n
        assert _same(prog._pt_acc, eager._pt_acc), n
        assert _same(prog._pt_seeds, eager._pt_seeds), n
        assert prog._pt_samples == eager._pt_samples
        states.append((want, eager._pt_acc.clone(), eager._pt_seeds.clone()))
    state = prog.pt_state()
    buf = prog._pass_prog.inputs.buf
    assert state["acc"] is not buf["acc"] and prog._pt_acc is buf["acc"]
    assert state["seeds"] is not buf["seeds"]

    first = _pt_scene()
    first.render_pt_program(1)
    path = save_checkpoint(str(tmp_path), 1, None, None, first.pt_state())
    pt = load_checkpoint(path, device="cpu", with_pt=True)[3]
    resumed = _pt_scene()
    resumed.set_pt_state(pt)
    got = resumed.render_pt_program(2)
    want, acc, seeds = states[1]
    assert np.array_equal(got, want)
    assert _same(resumed._pt_acc, acc) and _same(resumed._pt_seeds, seeds)


def test_pt_program_matches_render_pt_cuda():
    """render_pt_cuda's program (pt_program), run on the CPU from a zero
    sum twice with the same seeds tensor, against render_pt_cuda's CPU
    path (pt_passes): a run takes the caller's seeds by value, and the
    seeds it returns are the program's, which the next run overwrites."""
    sc = Scene(load_scene("test18"), 24, 16, device="cpu").arrays
    cfg = TraceConfig(depth=10)
    struct = ck.scene_struct(sc)
    img, seeds = ck.render_pt_cuda(sc, 24, 16, init_seeds(24 * 16,
                                                          device="cpu"), 2,
                                   cfg, struct)
    prog = G.pt_program(struct, 24, 16, cfg, "cpu")
    assert G.pt_program(struct, 24, 16, cfg, "cpu") is prog
    start = init_seeds(24 * 16, device="cpu")
    for _ in range(2):
        acc, got_seeds = prog.passes(sc, None, start, 2)
        assert _same((acc / 2.0).reshape(16, 24, 3), img)
        assert _same(got_seeds, seeds) and got_seeds is not start


def test_frame_program_matches_jax_engine():
    """The slice as a whole: test01's frame through the interactive
    program against the JAX engine's, with test_torch_engine's
    tolerance."""
    from quadray_tpu.engine import Scene as JScene
    from quadray_tpu.models.scenes.loader import load_scene as jload
    w, h = 48, 32
    a = JScene(jload("test01"), w, h).render(0.0)
    b = Scene(load_scene("test01"), w, h,
              device="cpu").render_interactive(0.0)
    d = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    assert d.max() <= 1 and (d > 0).mean() <= 0.005


def test_pass_program_matches_jax_engine():
    """The slice as a whole: two test18 passes through the pass program
    against the JAX engine's jnp path tracer, 0 differing pixels (as
    test_torch_engine's eager passes)."""
    from quadray_tpu.engine import Platform as JPlatform, Scene as JScene
    from quadray_tpu.models.scenes.loader import load_scene as jload
    ref = JScene(jload("test18"), PT_W, PT_H, pfm=JPlatform(use_pallas=False))
    assert ref.set_pton(True)
    a, b = ref.render_pt_pass(2), _pt_scene(PT_W, PT_H).render_pt_program(2)
    d = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    assert int((d > 0).sum()) == 0 and b.mean() > 10.0


# ---- on the card: the graphs against the eager launches ---------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda", 0)


def _eager_frame(sc):
    img = sc.render_linear()
    return to_frame(img, sc.arrays.use_gamma).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test13", "demo02"])
def test_graphed_render_matches_eager_on_card(dev, name):
    """J3's trace at 200x120: Scene.render replays one graph a frame (the
    interactive program's: one Whitted launch counted), uint8-equal to
    render_linear + to_frame, and every frame it returned kept."""
    sc = Scene(_sdef(name), 200, 120, device=dev)
    got = []
    for fi in range(J3_FRAMES + 1):
        _act(sc, fi)
        before = ck.launches
        frame = sc.render(frame_time(fi))
        assert ck.launches == before + 1, fi
        want = _eager_frame(sc)
        assert np.array_equal(frame, want), fi
        got.append((frame, want))
    assert isinstance(sc._interactive_prog.replay, G.Replay)
    assert all(np.array_equal(f, w) for f, w in got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test18", "test13"])
def test_graphed_passes_match_eager_on_card(dev, name):
    """render_pt_pass replays one graph a pass (one PT launch each),
    bitwise pt_passes; render_pt_cuda's graphed passes too."""
    sc = Scene(_sdef(name), 200, 120, device=dev)
    assert sc.set_pton(True)
    cfg = TraceConfig(depth=10)
    acc = torch.zeros((200 * 120, 3), device=dev)
    seeds = init_seeds(200 * 120, device=dev)
    for n in (1, 2, 3):
        before = ck.pt_launches
        sc.render_pt_pass(n)
        assert ck.pt_launches == before + n
        acc, seeds = ck.pt_passes(sc.arrays, 200, 120, acc, seeds, n, cfg,
                                  sc._struct)
        assert _same(sc._pt_acc, acc) and _same(sc._pt_seeds, seeds), n
    img, out = ck.render_pt_cuda(sc.arrays, 200, 120,
                                 init_seeds(200 * 120, device=dev), 6, cfg,
                                 sc._struct)
    assert _same(img, (acc / 6.0).reshape(120, 200, 3))
    assert _same(out, seeds)
