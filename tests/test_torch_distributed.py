"""The port's parallel layer across processes: two gloo ranks on the CPU
over localhost, each ``python -m quadray_tpu_torch.dryrun`` (its worker
checks itself and exits non-zero on any failure; module docstring there),
read back here and held against this process's own one-process frame and
in-process 2-block step. Skipped only where localhost TCP is refused, as
tests/test_multidevice.py:248 is."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from quadray_tpu_torch.dryrun import (CFG, FRAME_H, FRAME_W, HEIGHT,
                                      K_PATHS, WIDTH, digest, flat_params,
                                      train_task)
from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.parallel import train as tr
from quadray_tpu_torch.parallel.mesh import ray_mesh
from quadray_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, TIMEOUT = 2, 120


@pytest.fixture(scope="module")
def ranks():
    """Each rank's JSON line (the worker's own checks passed)."""
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError as e:
            pytest.skip(f"no localhost TCP: {e}")
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "quadray_tpu_torch.dryrun", "--rank", str(i),
         "--world", str(WORLD), "--port", str(port), "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("the two-process run timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
        tag = f"OK rank {i}: "
        found = [ln for ln in out.splitlines() if ln.startswith(tag)]
        assert found, out[-3000:]
        lines.append(json.loads(found[0][len(tag):]))
    return lines


def test_ranks_join_one_mesh(ranks):
    """init_distributed engaged on both, global_ray_mesh spans their two
    blocks, and the all_reduce summed both ranks."""
    for i, r in enumerate(ranks):
        assert (r["rank"], r["world"], r["blocks"]) == (i, WORLD, WORLD)
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["all_reduce"] == [2.0 * k + 1.0 for k in range(8)]


def test_ranks_frame_is_the_one_process_frame(ranks):
    sc = compile_scene(load_scene("test01"), device="cpu")
    want = digest(ck.render_cuda(sc, FRAME_W, FRAME_H))
    assert [r["frame"] for r in ranks] == [want] * WORLD


def test_ranks_step_is_the_in_process_step(ranks):
    """The 2-rank fast step is bitwise the in-process 2-block step here,
    its params and Adam's first moment (0.1 x the gradient), and equal on
    both ranks."""
    sc_p, target = train_task("cpu")
    step_fn, opt_init = tr.make_train_step_fast(
        sc_p, WIDTH, HEIGHT, cfg=CFG, k_paths=K_PATHS,
        mesh=ray_mesh([torch.device("cpu")] * WORLD))
    p0 = tr.extract_params(sc_p)
    params, state, loss = step_fn(p0, opt_init(p0), sc_p, target)
    assert [r["params"] for r in ranks] == [digest(flat_params(params))] * 2
    assert [r["mu"] for r in ranks] == [digest(flat_params(state.mu))] * 2
    assert [r["loss"] for r in ranks] == [float(loss)] * WORLD
    assert all(r["bitwise_in_process"] for r in ranks)


def test_ranks_refuse_differing_scenes(ranks):
    for r in ranks:
        assert "rank(s) [1] differs" in r["refused"]
