"""The CUDA kernel on the card (skipped without one).

Imports no JAX, so it runs on a GPU machine without it:
    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from quadray_tpu_torch import Scene
from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.rays import camera_rays
from quadray_tpu_torch.ops.replay import replay_color
from quadray_tpu_torch.ops.trace import (TraceConfig, trace_paths,
                                         trace_rays, trace_rays_diff)
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import compile_scene
from quadray_tpu_torch.utils.image import frame_cmp, load_bmp

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "golden")
BUDGET = {"test11": 8, "test14": 3, "test16": 45, "demo03": 3}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _rays(name, dev, w, h):
    sd = load_scene(name)
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device=dev)
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, w, h, 1)
    return sc, org, dirs, sc.cam_pov.expand(dirs.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test01", "test03", "test11", "test13",
                                  "test15", "test17", "test18", "demo01"])
def test_kernel_matches_plain_on_card(dev, name):
    """Same CUDA math library and the same f32 operation order on both
    sides: measured bitwise on an H100; the bar is the CPU tests' 1e-5."""
    sc, org, dirs, tmin = _rays(name, dev, 200, 120)
    before = ck.launches
    got = ck.trace_rays_cuda(sc, org, dirs, tmin, TraceConfig())
    want = trace_rays(sc, org, dirs, tmin, TraceConfig())
    torch.cuda.synchronize()
    assert ck.launches == before + 1
    assert got.shape == (dirs.shape[0], 3)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test01", "test11", "test13", "test17",
                                  "demo03"])
def test_cuda_scene_golden(dev, name):
    ref = load_bmp(os.path.join(GOLDEN, f"ref_{name}.bmp"))
    frame = Scene(load_scene(name), 800, 480, device=dev).render(0.0)
    nbad, _ = frame_cmp(ref, frame, t_diff=3)
    assert nbad <= BUDGET.get(name, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test01", "test04", "test11", "test13",
                                  "test15", "demo01"])
def test_paths_kernel_matches_plain_on_card(dev, name):
    """The path-record kernel: records equal to the plain version's on
    every lane, colors within 1e-5, one launch per call."""
    sc, org, dirs, tmin = _rays(name, dev, 200, 120)
    cfg = TraceConfig(max_segments=8, stack=4)
    before = ck.paths_launches
    got_c, got_p = ck.trace_paths(sc, org, dirs, tmin, cfg, 8)
    want_c, want_p = trace_paths(sc, org, dirs, tmin, cfg, 8)
    torch.cuda.synchronize()
    assert ck.paths_launches == before + 1
    assert got_p.dtype == torch.int32 and got_p.shape == (8, dirs.shape[0])
    assert torch.equal(got_p, want_p)
    assert (got_c - want_c).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_replay_of_kernel_records_matches_kernel_colors(dev):
    sc, org, dirs, tmin = _rays("test01", dev, 200, 120)
    cfg = TraceConfig(max_segments=8, stack=4)
    cols, paths = ck.trace_paths(sc, org, dirs, tmin, cfg, 8)
    rep = replay_color(sc, org, dirs, tmin, paths, cfg)
    assert (rep - cols).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_fast_path_grads_match_all_surface_grads_on_card(dev):
    """d(sum of interior pixels)/d(s_pos, m_col, l_pos) through replay of
    the kernel's records vs through trace_rays_diff (the methodology of
    tests/test_replay.py:51-93): interior lanes keep their first-hit
    surface over their 4-neighbourhood; rel 5e-3 of the largest
    gradient."""
    w, h = 64, 40
    sc, org, dirs, tmin = _rays("test01", dev, w, h)
    cfg = TraceConfig(max_segments=3, stack=2)
    _, paths = ck.trace_paths(sc, org, dirs, tmin, cfg, 3)
    g = (paths[0] & 0xFFF).reshape(h, w)
    edge = torch.zeros_like(g, dtype=torch.bool)
    edge[1:, :] |= g[1:, :] != g[:-1, :]
    edge[:-1, :] |= g[1:, :] != g[:-1, :]
    edge[:, 1:] |= g[:, 1:] != g[:, :-1]
    edge[:, :-1] |= g[:, 1:] != g[:, :-1]
    wmask = (~edge.reshape(-1)).float()[:, None]
    fields = ("s_pos", "m_col", "l_pos")

    def grads(colors_of):
        leaves = {k: getattr(sc, k).clone().requires_grad_(True)
                  for k in fields}
        cols = colors_of(dataclasses.replace(sc, **leaves))
        (torch.clamp(cols, 0.0, 1.0) * wmask).sum().backward()
        return {k: v.grad for k, v in leaves.items()}

    ga = grads(lambda s: replay_color(s, org, dirs, tmin, paths, cfg))
    gb = grads(lambda s: trace_rays_diff(s, org, dirs, tmin, cfg))
    for k in fields:
        scale = max(gb[k].abs().max().item(), 1e-6)
        rel = (ga[k] - gb[k]).abs().max().item() / scale
        assert rel < 5e-3, f"{k}: replay grad off by rel {rel:.2e}"


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    """The wrong element type, shape or device and a stack of 0 raise; a
    stack past 16 slots and Schlick Fresnel, which the reference's jnp
    tracer takes, are taken (bitwise the plain tracer)."""
    sc, org, dirs, tmin = _rays("test01", dev, 8, 4)
    with pytest.raises(ValueError):
        ck.trace_rays_cuda(sc, org, dirs.double(), tmin, TraceConfig())
    with pytest.raises(ValueError):
        ck.trace_rays_cuda(sc, org, dirs[:, :2], tmin, TraceConfig())
    with pytest.raises(ValueError):
        ck.trace_rays_cuda(sc.to("cpu"), org, dirs, tmin, TraceConfig())
    with pytest.raises(ValueError):
        ck.trace_rays_cuda(sc, org, dirs, tmin, TraceConfig(stack=0))
    for cfg in (TraceConfig(stack=17), TraceConfig(schlick=True)):
        got = ck.trace_rays_cuda(sc, org, dirs, tmin, cfg)
        want = trace_rays(sc, org, dirs, tmin, cfg)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _pt_rays(name, dev, w, h, emis_seed=None):
    """Jittered primary rays and seeds; with emis_seed, every real surface
    gets a seeded emission in [0, 0.5) on both sides (as chip_smoke.py
    phase E1), so that paths that seldom reach the light gather some."""
    from quadray_tpu_torch.ops.pt import init_seeds, pt_camera_rays
    sc, _, _, tmin = _rays(name, dev, w, h)
    if emis_seed is not None:
        e = np.random.default_rng(emis_seed).uniform(
            0.0, 0.5, tuple(sc.s_emis.shape)).astype(np.float32)
        sc = dataclasses.replace(sc, s_emis=sc.s_emis + torch.from_numpy(
            e).to(dev) * (sc.s_kind > 0)[:, None, None])
    org, dirs, seeds = pt_camera_rays(sc, w, h, init_seeds(w * h,
                                                           device=dev))
    return sc, org, dirs, tmin, seeds


@pytest.mark.cuda
@pytest.mark.parametrize("name,emis_seed,w,h,n", [
    ("test18", None, 200, 120, None), ("test17", 17, 200, 120, None),
    ("test15", 15, 200, 120, None), ("test05", 5, 200, 120, None),
    ("test18", None, 800, 480, None)] + [
    ("test18", None, 800, 480, k) for k in (1, 31, 33, 24007)])
def test_pt_kernel_matches_plain_on_card(dev, name, emis_seed, w, h, n):
    """The PT kernel against the plain trace_pt on the card: seeds equal,
    radiance within 1e-5, one launch per call, over 5% of the lanes lit.
    n: the first n samples only, the edges of the kernel's work queue (one
    sample, a warp less or more one lane, not a whole number of blocks;
    all under the persistent grid's thread count, while the whole 800x480
    frame is over it); too few to ask that any be lit."""
    from quadray_tpu_torch.ops.pt import trace_pt
    sc, org, dirs, tmin, seeds = _pt_rays(name, dev, w, h, emis_seed)
    if n is not None:
        dirs, tmin, seeds = dirs[:n], tmin[:n], seeds[:n]
    cfg = TraceConfig(depth=10)
    before = ck.pt_launches
    got_r, got_s = ck.trace_pt_cuda(sc, org, dirs, tmin, seeds, cfg)
    want_r, want_s = trace_pt(sc, org, dirs, tmin, seeds, cfg)
    torch.cuda.synchronize()
    assert ck.pt_launches == before + 1
    assert got_r.shape == (dirs.shape[0], 3) and got_s.dtype == torch.int32
    assert torch.equal(got_s, want_s)
    assert (got_r - want_r).abs().max().item() <= 1e-5
    if n is None:
        assert (got_r.amax(dim=1) > 0).float().mean().item() > 0.05


@pytest.mark.cuda
def test_pt_kernel_two_launches_bitwise_equal(dev):
    """The work queue hands samples to lanes in an order that changes from
    launch to launch; the radiance and seeds do not."""
    sc, org, dirs, tmin, seeds = _pt_rays("test18", dev, 800, 480)
    cfg = TraceConfig(depth=10)
    r1, s1 = ck.trace_pt_cuda(sc, org, dirs, tmin, seeds, cfg)
    r2, s2 = ck.trace_pt_cuda(sc, org, dirs, tmin, seeds, cfg)
    torch.cuda.synchronize()
    assert torch.equal(r1.contiguous().view(torch.int32),
                       r2.contiguous().view(torch.int32))
    assert torch.equal(s1, s2)


@pytest.mark.cuda
def test_pt_fused_equals_chained(dev):
    """The engine carries its pass state across calls: 1 then 3
    Scene.render_pt_pass passes against one render_pt_cuda of 4 from the
    same seeds, radiance and seeds bitwise (both run pt_passes; the port
    has no fused path)."""
    from quadray_tpu_torch.ops.pt import init_seeds
    w, h = 200, 120
    scene = Scene(load_scene("test18"), w, h, device=dev)
    assert scene.set_pton(True)
    scene.render_pt_pass(1)
    scene.render_pt_pass(3)
    img, seeds = ck.render_pt_cuda(scene.arrays, w, h,
                                   init_seeds(w * h, device=dev), 4,
                                   TraceConfig(depth=10), scene._struct)
    assert torch.equal(seeds, scene._pt_seeds)
    assert torch.equal(img, (scene._pt_acc / 4.0).reshape(h, w, 3))


@pytest.mark.cuda
def test_pt_wrapper_rejects_what_the_kernel_does_not_take(dev):
    sc, org, dirs, tmin, seeds = _pt_rays("test18", dev, 8, 4)
    cfg = TraceConfig()
    with pytest.raises(ValueError):
        ck.trace_pt_cuda(sc, org, dirs, tmin, seeds.cpu(), cfg)
    with pytest.raises(ValueError):
        ck.trace_pt_cuda(sc, org, dirs, tmin, seeds.long(), cfg)
    with pytest.raises(ValueError):
        ck.trace_pt_cuda(sc, org, dirs, tmin, seeds[:-1], cfg)
    with pytest.raises(ValueError):
        ck.trace_pt_cuda(sc, org, dirs[:, :2], tmin, seeds, cfg)
    with pytest.raises(ValueError):
        ck.trace_pt_cuda(sc.to("cpu"), org, dirs, tmin, seeds, cfg)
    with pytest.raises(ValueError):
        ck.trace_pt_cuda(sc, org, dirs, tmin, seeds,
                         TraceConfig(depth=ck.PT_MAX_DEPTH + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("name,k1", [("test08", 2), ("test14", 2),
                                     ("demo03", 3)])
def test_emit_resume_kernels_match_plain_on_card(dev, name, k1):
    """Round 1: colors and all 21 state rows bitwise against the plain
    trace_rays_emit; round 2 from the kernel's state: colors bitwise
    against the plain trace_rays_resume; one launch each."""
    from quadray_tpu_torch.ops.trace import trace_rays_emit, trace_rays_resume
    sc, org, dirs, tmin = _rays(name, dev, 200, 120)
    cfg = TraceConfig()
    before = (ck.emit_launches, ck.resume_launches)
    cols, state = ck.trace_rays_emit_cuda(sc, org, dirs, tmin, cfg, k1)
    want_c, want_s = trace_rays_emit(sc, org, dirs, tmin, cfg, k1)
    torch.cuda.synchronize()
    assert state.shape == (21, dirs.shape[0])
    assert torch.equal(cols.view(torch.int32), want_c.view(torch.int32))
    assert torch.equal(state.view(torch.int32), want_s.view(torch.int32))
    emitted = cols.clone()
    idx, count = ck.compact_active(state)
    got = ck.trace_rays_resume_cuda(sc, state, cols, idx, count, cfg, k1)
    want = trace_rays_resume(sc, state, emitted, cfg, k1)
    torch.cuda.synchronize()
    assert (ck.emit_launches, ck.resume_launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert 0 < int(count) < dirs.shape[0]
    assert torch.equal(got.contiguous().view(torch.int32),
                       want.view(torch.int32))


@pytest.mark.cuda
def test_rounds_match_monolithic_on_card(dev):
    """tests/test_conformance.py:249-274 on the card, bitwise: test14 at
    400x240, TraceConfig(stack=6), k1 = 3; and both presets."""
    sc, org, dirs, tmin = _rays("test14", dev, 400, 240)
    cfg = TraceConfig(stack=6)
    mono = ck.trace_rays_cuda(sc, org, dirs, tmin, cfg)
    for k1 in (3, ck.ROUNDS_K1, ck.WAVE_K1):
        got = ck.trace_rays_rounds(sc, org, dirs, tmin, cfg, k1)
        assert torch.equal(got.contiguous().view(torch.int32),
                           mono.contiguous().view(torch.int32)), k1


@pytest.mark.cuda
def test_rounds_take_the_monolithic_kernel_on_can_push_scenes(dev):
    sc, org, dirs, tmin = _rays("test17", dev, 64, 40)
    before = (ck.launches, ck.emit_launches, ck.resume_launches)
    got = ck.trace_rays_rounds(sc, org, dirs, tmin, TraceConfig())
    assert (ck.launches, ck.emit_launches, ck.resume_launches) == (
        before[0] + 1, before[1], before[2])
    assert torch.equal(got, ck.trace_rays_cuda(sc, org, dirs, tmin,
                                               TraceConfig()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["add", "mul", "div", "sqrt", "rsqrt", "exp",
                                  "log", "fma", "min_max", "abs_neg", "roots",
                                  "fresnel", "spec_pow", "gather",
                                  "root_sdiv"])
def test_conformance_kernel_matches_plain_on_card(dev, name):
    """Each conformance kernel against its plain version on the same card
    tensors: bitwise for the correctly rounded ops (rsqrt: 1/sqrt in f64
    rounded once), FEQ at tests/test_conformance.py's scale where a math
    library function is in the chain (exp 4, log 4, the power 64), 8 for
    the blocks."""
    from quadray_tpu_torch.ops import conformance as cf
    feq = {"exp": 4.0, "log": 4.0, "spec_pow": 64.0, "roots": 8.0,
           "fresnel": 8.0, "root_sdiv": 8.0}
    for rows in (8, 3000):
        args = [torch.from_numpy(a).to(dev)
                for a in cf.case_inputs(name, rows)]
        before = cf.launches
        got = cf.conformance(name, *args)
        want = cf.plain(name, *args)
        torch.cuda.synchronize()
        assert cf.launches == before + 1
        assert got.shape == (rows, 128) and got.dtype == torch.float32
        if name in feq:
            a = got.double().cpu().numpy()
            b = want.double().cpu().numpy()
            tol = feq[name] * np.finfo(np.float32).eps * np.maximum(
                np.maximum(np.abs(a), np.abs(b)), 1e-20)
            assert not (np.abs(a - b) > tol).any()
        else:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name,seed", [("test01", 1), ("test10", 10),
                                       ("test17", 17)])
def test_kernel_matches_plain_on_random_rays(dev, name, seed):
    """tests/test_conformance.py:215-246 on the card, bitwise: 2048
    random non-camera rays, TraceConfig(stack=4, max_segments=12)."""
    from quadray_tpu_torch.ops.conformance import random_rays
    sc, _, _, _ = _rays(name, dev, 8, 4)
    org, dirs = (torch.from_numpy(a).to(dev) for a in random_rays(2048, seed))
    tmin = torch.zeros((2048,), dtype=torch.float32, device=dev)
    cfg = TraceConfig(stack=4, max_segments=12)
    got = ck.trace_rays_cuda(sc, org, dirs, tmin, cfg)
    want = trace_rays(sc, org, dirs, tmin, cfg)
    assert torch.equal(got.contiguous().view(torch.int32),
                       want.view(torch.int32))


@pytest.mark.cuda
def test_kernel_refuses_f64_on_card(dev):
    """The kernels stay f32: float64 rays, or a float64 scene (the fp64
    tier's, ops.trace.scene_astype), raise ValueError before any launch,
    never a silent down-cast."""
    from quadray_tpu_torch.ops.trace import scene_astype
    sc, org, dirs, tmin = _rays("test01", dev, 32, 16)
    before = ck.launches
    with pytest.raises(ValueError, match="need f32"):
        ck.trace_rays_cuda(sc, org, dirs.double(), tmin)
    with pytest.raises(ValueError, match="f32"):
        ck.trace_rays_cuda(scene_astype(sc, torch.float64), org.double(),
                           dirs.double(), tmin.double())
    assert ck.launches == before


@pytest.mark.cuda
def test_render_cli_frame_matches_plain_on_card(dev, tmp_path, monkeypatch):
    """One render_cli frame on the card after a camera move (demo01 at
    200x120, saved with -i): one Whitted launch a frame; a Scene replayed
    through the same tokens renders, through the kernel, within 1e-5 of
    the plain version on the same compiled arrays and TraceConfig, and
    the app's saved frame equals the plain uint8 frame."""
    from quadray_tpu_torch.apps import render_cli
    from quadray_tpu_torch.models.scenes import demos
    from quadray_tpu_torch.ops.trace import render, to_frame
    monkeypatch.chdir(tmp_path)
    before = ck.launches
    stats = render_cli.main(["-x", "200", "-y", "120", "-f", "2", "-i",
                             "-k", ".,w+left"])
    assert stats["scene"].device.type == "cuda"
    assert stats["whitted_frames"] == 2 and ck.launches == before + 2
    sc = Scene(demos.build("demo01"), 200, 120, device=dev)
    sc.update(render_cli.frame_time(0))
    for key in ("w", "left"):
        sc.update_action(render_cli.frame_time(1), render_cli.KEY_ACTIONS[key])
    sc.update(render_cli.frame_time(1))
    lin = sc.render_linear()
    want = render(sc.arrays, 200, 120, 1, TraceConfig(depth=sc.pfm.depth))
    assert float((lin - want).abs().max()) <= 1e-5
    assert np.array_equal(load_bmp("dump/demo01_f0001.bmp"),
                          to_frame(want, sc.arrays.use_gamma).cpu().numpy())


@pytest.mark.cuda
def test_plot_fresnel_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """plot_fresnel evaluates its curves on the card by default: within
    1e-6 of -c's, and the same six BMPs within 1 LSB."""
    from quadray_tpu_torch.apps import plot_fresnel
    card, cpu = plot_fresnel.curves(device=dev), plot_fresnel.curves(
        device="cpu")
    for k in cpu:
        np.testing.assert_allclose(card[k], cpu[k], rtol=0, atol=1e-6)
    for sub, argv in (("card", []), ("cpu", ["-c"])):
        os.makedirs(tmp_path / sub)
        monkeypatch.chdir(tmp_path / sub)
        plot_fresnel.main(argv)
    names = sorted(os.listdir(tmp_path / "cpu" / "dump"))
    assert len(names) == 6
    assert names == sorted(os.listdir(tmp_path / "card" / "dump"))
    for n in names:
        a = load_bmp(str(tmp_path / "card" / "dump" / n)).astype(np.int32)
        b = load_bmp(str(tmp_path / "cpu" / "dump" / n)).astype(np.int32)
        assert np.abs(a - b).max() <= 1, n
