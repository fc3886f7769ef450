"""The port's bench (``quadray_tpu_torch/bench.py``) on the CPU, against
the JAX package's bench (``bench.py`` at the repository root), which these
tests only parse or compare and never import or run: the same tables and
sizes, the same JSON line, the same marginals; the K-frame batch against
the port's and the JAX package's renders; the golden guard at the real
size; and no run without a card. The cells run here at tiny sizes with a
stand-in clock: the bench has no CPU clock."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quadray_tpu.models.scenes.loader import load_scene as jload_scene
from quadray_tpu.ops.trace import TraceConfig as JConfig
from quadray_tpu.ops.trace import render as jrender
from quadray_tpu.scene import schema as JS
from quadray_tpu.scene.compile import compile_scene as jcompile_scene
from quadray_tpu_torch import bench
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.trace import render
from quadray_tpu_torch.scene.compile import FIELDS, scene_arrays_from_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the plain tracer against the jitted jnp tracer on the CPU, where XLA
# contracts mul/add pairs into FMAs (ROADMAP §3: at most 3.5e-6)
JAX_ATOL = 3.5e-6


def _root_bench_constants() -> dict:
    """The module-level constants of the root bench.py, read from its
    source with ast (numbers, tuples, dicts and their arithmetic)."""
    ops = {ast.Add: float.__add__, ast.Sub: float.__sub__,
           ast.Mult: float.__mul__, ast.Div: float.__truediv__}

    def value(node):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.BinOp):
            return ops[type(node.op)](float(value(node.left)),
                                      float(value(node.right)))
        if isinstance(node, ast.Tuple):
            return tuple(value(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return {value(k): value(v) for k, v in zip(node.keys,
                                                       node.values)}
        raise ValueError(ast.dump(node))

    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            try:
                val = value(node.value)
            except (ValueError, KeyError):
                continue
            if isinstance(target, ast.Name):
                out[target.id] = val
            elif isinstance(target, ast.Tuple):
                out.update(zip((t.id for t in target.elts), val))
    return out


@pytest.mark.parametrize("name", ["BASELINE", "WIDTH", "HEIGHT", "FSAA",
                                  "K_SMALL", "K_BIG", "REPS"])
def test_constants_equal_the_jax_bench(name):
    assert getattr(bench, name) == _root_bench_constants()[name]


@pytest.mark.parametrize(
    "t_small, t_big, n_small, n_big, want, fell_back", [
    (10.0, 66.0, 8, 64, 1.0, False),        # (66 - 10) / 56
    (20.0, 120.0, 2, 12, 10.0, False),      # bench_train's (t12 - t2) / 10
    (50.0, 40.0, 8, 64, 40.0 / 64, True),   # marginal < 0
    (64.0, 64.0, 8, 64, 1.0, True),         # marginal 0
    (-600.0, 1.0, 8, 64, 1.0 / 64, True),   # marginal >= t_big
])
def test_marginal_and_its_fallback(t_small, t_big, n_small, n_big, want,
                                   fell_back):
    """bench.py:128-135 and :193-195."""
    per, fb = bench.marginal(t_small, t_big, n_small, n_big)
    assert per == pytest.approx(want, rel=1e-12) and fb == fell_back


@pytest.mark.parametrize("t4, t20, want", [
    (4.0, 20.0, 1.0),                 # (t20 - t4) / 16
    (20.0, 4.0, 1e-6),                # negative: the floor
    (5.0, 5.0, 1e-6),                 # zero: the floor
])
def test_pt_marginal_and_its_floor(t4, t20, want):
    """bench.py:243, max((t20 - t4) / 16, 1e-9 s), here in ms."""
    assert bench.pt_marginal(t4, t20, 4, 20) == pytest.approx(want,
                                                               rel=1e-12)


class _Clock:
    """A stand-in for CardClock: runs fn and returns the next scripted
    ms; no time is taken."""

    def __init__(self, times):
        self.times = iter(times)

    def events(self, fn):
        fn()
        return float(next(self.times))

    host = events


# tiny sizes of the three cells: (16x10, K 1 and 2, 2 reps, 2 main-path
# calls), PT spp 1 and 2, train 1 and 2 steps
TINY_SCENE = dict(width=16, height=10, ks=(1, 2), reps=2, main_calls=2)
TINY_PT = dict(width=16, height=10, spps=(1, 2), reps=1)
TINY_TRAIN = dict(width=16, height=10, steps=(1, 2), reps=1)


@pytest.fixture(scope="module")
def cells():
    """Each cell run once on the CPU at its tiny size with scripted
    times (K=1 reps 1, 2; K=2 reps 3, 4; main path 5, 6)."""
    cfg = bench.BENCH_CFG
    return {
        "test01": bench.bench_scene("test01", cfg, "cpu",
                                    _Clock([1, 2, 3, 4, 5, 6]),
                                    **TINY_SCENE),
        "pt_test18": bench.bench_pt("cpu", _Clock([1, 3]), **TINY_PT),
        "train_test01": bench.bench_train("cpu", _Clock([10, 25]),
                                          **TINY_TRAIN),
    }


def test_bench_scene_cell_on_the_cpu(cells):
    """best 1 and 3 ms: marginal 2 ms a frame; the reps' marginals 2 and
    2; main path median of 5 and 6."""
    e = cells["test01"]
    assert e == {"rays_per_s": 80000, "ms_per_frame": 2.0,
                 "vs_baseline": round(80000 / bench.BASELINE["test01"], 4),
                 "ms_per_frame_median": 2.0, "ms_per_frame_min": 2.0,
                 "ms_per_frame_max": 2.0, "main_path_ms_per_frame": 5.5}


def test_bench_scene_falls_back_on_the_cpu():
    """A bigger batch timed faster than the small one: t_big / K_BIG."""
    e = bench.bench_scene("test01", bench.BENCH_CFG, "cpu",
                          _Clock([5, 6, 4, 3, 1, 1]), **TINY_SCENE)
    assert e["ms_per_frame"] == 1.5          # 3 / 2
    assert (e["ms_per_frame_min"], e["ms_per_frame_max"]) == (1.5, 2.0)


def test_pt_and_train_cells_on_the_cpu(cells):
    assert cells["pt_test18"] == {"ms_per_spp_pass": 2.0,
                                  "paths_per_s": 80000}
    assert cells["train_test01"] == {
        "ms_per_step": 15.0, "fwd_bwd_rays_per_s": round(160 / 15e-3)}


def test_card_clock_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA card"):
        bench.CardClock("cpu")
    with pytest.raises(ValueError, match="CUDA card"):
        bench.bench_scene("test01", bench.BENCH_CFG, "cpu")


def test_frame_batch_is_k_frames_of_render():
    """test01 at 32x20, K = 3, on the scene tables of the JAX compile: the
    batch's colours (the plain tracer, as trace_rays_cuda takes it on CPU
    tensors), clipped, equal the port's render frame by frame, bitwise,
    and lie within JAX_ATOL of the JAX jnp render."""
    w, h, k = 32, 20, 3
    cfg = bench.BENCH_CFG
    sd = jload_scene("test01")
    j = jcompile_scene(JS.SceneDef(root=sd.root,
                                   opts=JS.OPTS_FULL & ~sd.opts))
    t = scene_arrays_from_numpy({f: np.asarray(getattr(j, f))
                                 for f in FIELDS}, device="cpu")
    batch = bench.frame_batch(t, k, w, h)
    assert tuple(batch[1].shape) == (k * w * h, 3)
    before = ck.launches
    cols = torch.clamp(bench.trace_batch(t, batch, cfg), 0.0, 1.0)
    assert ck.launches == before
    want = render(t, w, h, 1, cfg).reshape(-1, 3)
    jwant = np.asarray(jrender(j, w, h, 1, JConfig(**cfg._asdict())))
    for f in range(k):
        frame = cols[f * w * h:(f + 1) * w * h]
        assert torch.equal(frame, want)
        assert np.abs(frame.numpy().reshape(h, w, 3) - jwant).max() \
            <= JAX_ATOL


@pytest.fixture(scope="module")
def test01_frame():
    """test01 at 800x480 through the benched path on the CPU."""
    return bench.guard_frame("test01", bench.BENCH_CFG, "cpu")


def test_guard_passes_test01_at_the_real_size(test01_frame, monkeypatch):
    assert test01_frame.shape == (bench.HEIGHT, bench.WIDTH, 3)
    monkeypatch.setattr(bench, "guard_frame", lambda *a: test01_frame)
    assert bench.guard("test01", bench.BENCH_CFG, "cpu") == 0


def _as_card(monkeypatch):
    """main() past its card check on the CPU: one card, and the device
    entry stood in."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bench, "device_info", lambda dev: {
        "name": "stand-in", "count": 1, "power_limit": "not read"})


def _last_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_guard_refuses_a_pushed_block(test01_frame, monkeypatch, capsys):
    """A 2x2 block pushed by +8 (isolated pixels are forgiven, a block is
    not) gives bench.py's value-0 line with "error", and exit code 1;
    no cell runs."""
    frame = test01_frame.copy()
    block = frame[240:242, 400:402]
    assert block.max() <= 255 - 8
    frame[240:242, 400:402] = block + 8
    _as_card(monkeypatch)
    monkeypatch.setattr(bench, "guard_frame", lambda *a: frame)

    def no_cell(*a, **k):
        raise AssertionError("a cell ran after a failed guard")

    for cell in ("bench_scene", "bench_pt", "bench_train"):
        monkeypatch.setattr(bench, cell, no_cell)
    assert bench.main(["--device", "cuda:0"]) == 1
    line = _last_line(capsys)
    assert (line["metric"], line["value"], line["unit"],
            line["vs_baseline"]) == (bench.METRIC, 0, "rays/s", 0.0)
    assert line["error"] == "golden mismatch: 4 bad px"


def _stub_cells(monkeypatch, cells, fail=None):
    """Every guard in budget and every cell answering with its tiny CPU
    result (``fail`` raises instead)."""
    monkeypatch.setattr(bench, "guard", lambda name, cfg, dev: 0)

    def cell(key):
        def run(*a, **k):
            if key == fail:
                raise RuntimeError(f"{key} broke")
            return dict(cells[key])
        return run

    monkeypatch.setattr(bench, "bench_scene", cell("test01"))
    monkeypatch.setattr(bench, "bench_pt", cell("pt_test18"))
    monkeypatch.setattr(bench, "bench_train", cell("train_test01"))


def test_line_schema_matches_the_jax_bench(cells, monkeypatch, capsys):
    """The line main() assembles carries BENCH_r05.json's parsed line's
    metric, unit and every key, top level, in extra and in each cell; the
    port adds keys and drops none."""
    with open(os.path.join(REPO, "BENCH_r05.json")) as fh:
        jax_line = json.load(fh)["parsed"]
    _as_card(monkeypatch)
    _stub_cells(monkeypatch, cells)
    assert bench.main(["--device", "cuda:0"]) == 0
    line = _last_line(capsys)
    assert (line["metric"], line["unit"]) == (jax_line["metric"],
                                              jax_line["unit"])
    assert set(jax_line) <= set(line) and "error" not in line
    assert set(jax_line["extra"]) <= set(line["extra"])
    for key, entry in jax_line["extra"].items():
        assert set(entry) <= set(line["extra"][key]), key
    for name in ("test01",) + bench.SCENES:
        assert line["extra"][name]["bad_px"] == 0
    assert line["value"] == cells["test01"]["rays_per_s"]
    assert line["extra"]["device"]["name"] == "stand-in"


def test_a_failed_cell_fails_the_run(cells, monkeypatch, capsys):
    """No swallowed error: the cell's entry holds it, the line is still
    printed, and the exit code is 1."""
    _as_card(monkeypatch)
    _stub_cells(monkeypatch, cells, fail="pt_test18")
    assert bench.main(["--device", "cuda:0"]) == 1
    line = _last_line(capsys)
    assert line["extra"]["pt_test18"] == {
        "error": "RuntimeError: pt_test18 broke"}
    assert "pt_test18" in line["error"]
    assert line["value"] == cells["test01"]["rays_per_s"]


def test_a_scene_out_of_budget_gets_no_number(cells, monkeypatch, capsys):
    _as_card(monkeypatch)
    _stub_cells(monkeypatch, cells)
    monkeypatch.setattr(bench, "guard",
                        lambda name, cfg, dev: 4 if name == "demo03" else 0)
    assert bench.main(["--device", "cuda:0"]) == 1
    entry = _last_line(capsys)["extra"]["demo03"]
    assert entry == {"bad_px": 4,
                     "error": "golden mismatch: 4 bad px, budget 3"}


def test_no_card_no_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) != 0
    assert bench.main(["--device", "cpu"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_no_card_no_line_as_a_program(tmp_path):
    """``python -m quadray_tpu_torch.bench`` where torch sees no card."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "quadray_tpu_torch.bench"],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr
