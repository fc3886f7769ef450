"""The port's apps (``quadray_tpu_torch.apps``: ``render_cli``,
``core_test``, ``plot_fresnel``) and ``utils/digits.py`` on the CPU,
against the JAX package's apps and engine."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quadray_tpu_torch.apps import core_test, plot_fresnel, render_cli
from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS, frame_time
from quadray_tpu_torch.utils.image import load_bmp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 40


def _close(a, b):
    """The port's frame bar against the JAX engine (as
    tests/test_torch_engine.py): max 1 LSB on at most 0.5% of the pixels."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    return d.max() <= 1 and (d > 0).mean() <= 0.005


def _jax_shots(tokens):
    """The frames the JAX engine holds at each f4 of the key trace,
    driven in-process as render_cli's dispatch drives it (demo01)."""
    from quadray_tpu.engine import Scene as JScene
    from quadray_tpu.models.scenes import demos as jdemos
    sc = JScene(jdemos.build("demo01"), W, H)
    shots = []
    for fi, keys in enumerate(tokens):
        t = frame_time(fi)
        for key in keys.split("+"):
            if key in KEY_ACTIONS:
                sc.update_action(t, KEY_ACTIONS[key])
            elif key == "f4":
                shots.append(sc.frame.copy())
        sc.render(t)
    return shots


def test_render_cli_scripted_flythrough(tmp_path):
    """The port of tests/test_engine.py::test_render_cli_scripted_flythrough:
    the module run as a program on the CPU; a demo01 flythrough driven by
    key tokens moves the camera (the two saved frames differ), and each
    saved frame is the JAX engine's after the same tokens."""
    trace = "w+w,f4,w+left,f4"
    r = subprocess.run(
        [sys.executable, "-m", "quadray_tpu_torch.apps.render_cli", "-c",
         "-x", str(W), "-y", str(H), "-f", "4", "-k", trace],
        capture_output=True, text=True, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "AVG FPS" in r.stdout
    f0 = load_bmp(str(tmp_path / "dump" / "scr000.bmp"))
    f1 = load_bmp(str(tmp_path / "dump" / "scr001.bmp"))
    assert f0.shape == (H, W, 3)
    assert (f0 != f1).any()
    j0, j1 = _jax_shots(trace.split(","))
    assert _close(j0, f0) and _close(j1, f1)


def test_render_cli_toggles(tmp_path, monkeypatch, capsys):
    """a2, the q toggle (one PT frame), a scene switch on the same device,
    f1's state dump and the HUD, in-process: main returns its statistics;
    -q and -s are parsed, not read, and noted on stderr."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.models.scenes import demos
    monkeypatch.chdir(tmp_path)
    stats = render_cli.main(["-c", "-x", "16", "-y", "10", "-f", "4", "-hud",
                             "-q", "-s", "8", "-k", "a2,q,d2,f1"])
    out, err = capsys.readouterr()
    assert "-q and -s are parsed and not read" in err
    assert "AVG FPS" in out and "cam_pos = " in out
    # q at frame 1 turned path tracing on for that frame only: d2 at frame
    # 2 put a new scene (demo02, path tracing off) in place
    assert stats["frames"] == 4 and stats["pt_frames"] == 1
    assert stats["whitted_frames"] == 3 and stats["avg_fps"] > 0
    sc = stats["scene"]
    for name, want in (("demo02", True), ("demo01", False)):
        ref = Scene(demos.build(name), 16, 10, device="cpu")
        assert torch.equal(sc.arrays.s_pos, ref.update(frame_time(3)).s_pos) \
            == want, name
    assert not sc.pt_on
    assert sc.device.type == "cpu" and sc.pfm.fsaa == 2
    assert sc.frame.shape == (10, 16, 3)
    # the HUD's digits are drawn white into the returned frame
    assert (sc.frame[2:9, 2:14] == 255).all(-1).any()


def test_core_test_cpu_level1_ok(tmp_path, monkeypatch, capsys):
    """core_test -c -b 1 -e 1 at 800x480 against golden/ref_test01.bmp,
    resolved from the repository root whatever the working directory."""
    monkeypatch.chdir(tmp_path)
    assert core_test.main(["-c", "-b", "1", "-e", "1"]) == 0
    out = capsys.readouterr().out
    assert "RUN LEVEL =  1" in out and "vs reference golden: OK" in out
    assert "0 scene(s) with differences" in out


def test_core_test_k_needs_the_card(capsys):
    """-k compares the kernel with its plain version; with -c it refuses
    (it never compares the plain tracer with itself)."""
    with pytest.raises(SystemExit) as e:
        core_test.main(["-c", "-k"])
    assert e.value.code != 0
    assert "-k" in capsys.readouterr().err


def test_draw_number_matches_jax():
    from quadray_tpu.utils.digits import draw_number as jdraw
    from quadray_tpu_torch.utils.digits import draw_number
    rng = np.random.default_rng(3)
    for text, x, y in (("123.4", 2, 2), ("0 9.87x65", 5, 30),
                       ("4567", 55, 36), ("", 0, 0)):
        base = rng.integers(0, 256, (40, 64, 3), dtype=np.uint8)
        a, b = base.copy(), base.copy()
        assert draw_number(a, text, x, y) is a
        jdraw(b, text, x, y)
        assert np.array_equal(a, b), text


def test_plot_fresnel_matches_jax_app(tmp_path, monkeypatch):
    """The same six BMPs as apps/plot_fresnel.py, within 1 LSB (the port
    with -c, on the CPU)."""
    jax_app = importlib.import_module("apps.plot_fresnel")
    for sub, run in (("jax", jax_app.main),
                     ("port", lambda: plot_fresnel.main(["-c"]))):
        os.makedirs(tmp_path / sub)
        monkeypatch.chdir(tmp_path / sub)
        run()
    names = sorted(os.listdir(tmp_path / "jax" / "dump"))
    assert len(names) == 6 and "plot_fresnel_metal_slow.bmp" in names
    assert names == sorted(os.listdir(tmp_path / "port" / "dump"))
    for n in names:
        a = load_bmp(str(tmp_path / "jax" / "dump" / n)).astype(np.int32)
        b = load_bmp(str(tmp_path / "port" / "dump" / n)).astype(np.int32)
        assert np.abs(a - b).max() <= 1, n


def test_plot_fresnel_defaults_to_the_card(tmp_path, monkeypatch):
    """Without -c the curves are evaluated on the card: where CUDA is
    missing, the app raises and writes no plot (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs it")
    monkeypatch.chdir(tmp_path)
    with pytest.raises((RuntimeError, AssertionError)):
        plot_fresnel.main([])
    assert not any(n.startswith("plot_") for n in
                   os.listdir(tmp_path / "dump"))
