"""Time the trace-replay training step of two checkouts on one card, or
of its two routes in this checkout.

    python3 scripts/ab_train.py OTHER_ROOT [--rounds 2] [--steps 10]
    python3 scripts/ab_train.py OTHER_ROOT --all-surface [--rounds 2] \
        [--steps 3]
    python3 scripts/ab_train.py --routes [--rounds 2] [--steps 10]

OTHER_ROOT is another checkout of this repository (quadray_tpu_torch/ and
golden/scenes/ are enough), for example the parent commit unpacked with
git archive into a directory that .gitignore lists.
The two packages share a name, so each measurement is its own process
(python3 scripts/ab_train.py --worker ROOT) importing quadray_tpu_torch
from ROOT and building its kernels there; the processes run in turns,
a b b a per round (a the other checkout, b this one). A worker takes
bench_train's task (chip_smoke.py train_task: test01 at 800x480, every
surface moved by +0.05, the clean kernel render as the target,
TraceConfig(max_segments=8, stack=4), K=8, Adam lr 1e-2, every
DIFFERENTIABLE_FIELDS entry training) and measures make_train_scan_fast's
ms/step on one block and on 4 blocks of the card (CUDA events around
--steps one-step calls after 2), then one one-block step under
torch.profiler: its kernel launches and their device time. Prints each
worker's JSON line, then the means of each side.

--all-surface has each worker measure the all-surface make_train_step
instead, on test17 (the same configuration) at 800x480 on one block of
the graph route: ms/step (CUDA events around --steps one-step calls
after 2, the first the program's warm-up and capture) and the peak
memory allocated over them (the scene and target included), then one
step under torch.profiler: its kernel launches, their device time and
the part of it in PyTorch's indexing_backward kernels (the backward of
table lookups by index_put_ with accumulate).

--routes measures this checkout alone, in one process: the same task on
the eager route (make_train_scan_fast(..., eager=True)) against the graph
route (one CUDA graph a step), a b b a per round, on 1 and 4 blocks, then
each route's one-block step under torch.profiler; then the all-surface
make_train_step on test17 (the same configuration; a material there both
reflects and transmits, which the fast steps refuse), eager against
graphed, a b b a per round, on 1 and 4 blocks, each call with a step
function of its own and the allocator's cache emptied after it (a
1-block graph's pool and an eager step's memory may not fit on the card
together).

Needs a CUDA card; exits with code 2 without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, K, LR = 800, 480, 8, 1e-2


def step_ms(run_fn, params, opt, sc, target, steps: int) -> float:
    state = [params, opt]

    def one():
        state[0], state[1], _ = run_fn(state[0], state[1], sc, target, 1)

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(steps):
        one()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / steps


def task(dev, name: str = "test01"):
    """bench_train's task (on another scene: the same configuration):
    (the moved scene, the target, TraceConfig)."""
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.rays import camera_rays
    from quadray_tpu_torch.ops.trace import TraceConfig
    from quadray_tpu_torch.scene import schema as S
    from quadray_tpu_torch.scene.compile import compile_scene
    cfg = TraceConfig(max_segments=8, stack=4)
    sd = load_scene(name)
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device=dev)
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, W, H, 1)
    target = torch.clamp(ck.trace_rays_cuda(
        sc, org, dirs, sc.cam_pov.expand(dirs.shape[0]), cfg), 0.0, 1.0)
    return dataclasses.replace(sc, s_pos=sc.s_pos + 0.05), target, cfg


def profiled(run_fn, params, opt, sc, target) -> dict:
    """One one-step call after one, under torch.profiler: its kernel
    launches, their device ms and the host's launch calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run_fn(params, opt, sc, target, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_fn(params, opt, sc, target, 1)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type != DeviceType.CPU]
    calls = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CPU and e.key.startswith(
                    ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cudaMemcpy", "cudaMemset")))
    return {"kernel_launches": sum(e.count for e in kernels),
            "device_ms": sum(e.self_device_time_total
                             for e in kernels) / 1e3,
            "index_backward_ms": sum(
                e.self_device_time_total for e in kernels
                if "indexing_backward_kernel" in e.key) / 1e3,
            "host_launch_calls": calls}


def worker(root: str, steps: int, all_surface: bool):
    from quadray_tpu_torch.parallel import train as tr
    from quadray_tpu_torch.parallel.mesh import ray_mesh
    dev = torch.device("cuda", 0)
    if all_surface:
        sc, target, cfg = task(dev, "test17")
        step_fn, opt_init = tr.make_train_step(W, H, cfg=cfg, lr=LR)
        p = tr.extract_params(sc)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        out = {"root": root, "ms_per_step_1": step_ms(
            step_fn.run, p, opt_init(p), sc, target, steps)}
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        out.update(profiled(step_fn.run, p, opt_init(p), sc, target))
        print("RESULT " + json.dumps(out), flush=True)
        return
    sc, target, cfg = task(dev)
    out = {"root": root}
    for blocks in (1, 4):
        run_fn, opt_init = tr.make_train_scan_fast(
            sc, W, H, cfg=cfg, lr=LR, k_paths=K,
            mesh=None if blocks == 1 else ray_mesh([dev] * blocks))
        p = tr.extract_params(sc)
        out[f"ms_per_step_{blocks}"] = step_ms(run_fn, p, opt_init(p), sc,
                                               target, steps)
    run_fn, opt_init = tr.make_train_scan_fast(sc, W, H, cfg=cfg, lr=LR,
                                               k_paths=K)
    p = tr.extract_params(sc)
    prof = profiled(run_fn, p, opt_init(p), sc, target)
    out["kernel_launches"] = prof["kernel_launches"]
    out["device_ms"] = prof["device_ms"]
    print("RESULT " + json.dumps(out), flush=True)


def routes(rounds: int, steps: int, smi: str):
    """Eager against graphed in this process (module docstring)."""
    from quadray_tpu_torch.parallel import train as tr
    from quadray_tpu_torch.parallel.mesh import ray_mesh
    dev = torch.device("cuda", 0)
    sc, target, cfg = task(dev)
    res = {}
    for blocks in (1, 4):
        mesh = None if blocks == 1 else ray_mesh([dev] * blocks)
        fns = {}
        for mode in ("eager", "graph"):
            fns[mode], opt_init = tr.make_train_scan_fast(
                sc, W, H, cfg=cfg, lr=LR, k_paths=K, mesh=mesh,
                eager=mode == "eager")
            assert fns[mode].route(sc) == mode
        p = tr.extract_params(sc)
        for _ in range(rounds):
            for mode in ("eager", "graph", "graph", "eager"):
                ms = step_ms(fns[mode], p, opt_init(p), sc, target, steps)
                print(f"{blocks} block(s) {mode}: {ms:.3f} ms/step",
                      flush=True)
                res.setdefault(f"ms_per_step_{blocks}_{mode}", []).append(ms)
        if blocks == 1:
            for mode, fn in fns.items():
                for k, v in profiled(fn, p, opt_init(p), sc,
                                     target).items():
                    res[f"{k}_{mode}"] = [v]
    del fns
    sc, target, cfg = task(dev, "test17")
    for blocks in (1, 4):
        mesh = None if blocks == 1 else ray_mesh([dev] * blocks)
        p = tr.extract_params(sc)
        for _ in range(rounds):
            for mode in ("eager", "graph", "graph", "eager"):
                step_fn, opt_init = tr.make_train_step(
                    W, H, cfg=cfg, lr=LR, mesh=mesh, eager=mode == "eager")
                assert step_fn.run.route(sc) == mode
                ms = step_ms(step_fn.run, p, opt_init(p), sc, target, steps)
                del step_fn
                torch.cuda.empty_cache()
                print(f"all-surface test17 {blocks} block(s) {mode}: "
                      f"{ms:.3f} ms/step", flush=True)
                res.setdefault(f"all_surface_ms_per_step_{blocks}_{mode}",
                               []).append(ms)
    print(json.dumps({"device": smi, "root": REPO, "steps": steps,
                      "mean": {k: float(np.mean(v)) for k, v in res.items()},
                      "runs": res}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?", help="the other checkout's root")
    ap.add_argument("--routes", action="store_true",
                    help="eager against graphed in this checkout")
    ap.add_argument("--all-surface", action="store_true",
                    help="time the all-surface make_train_step on test17")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False")
        sys.exit(2)
    if args.worker:
        sys.path.insert(0, args.worker)
        worker(args.worker, args.steps, args.all_surface)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.routes:
        sys.path.insert(0, REPO)
        routes(args.rounds, args.steps, smi)
        return
    if not args.other:
        ap.error("give OTHER_ROOT or --routes")
    sides = {"a": os.path.abspath(args.other), "b": REPO}
    res = {"a": [], "b": []}
    for _ in range(args.rounds):
        for side in "abba":
            root = sides[side]
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root,
                 "--steps", str(args.steps)]
                + (["--all-surface"] if args.all_surface else []),
                cwd=root, capture_output=True,
                text=True, env=dict(os.environ, PYTHONPATH=root))
            line = [ln for ln in r.stdout.splitlines()
                    if ln.startswith("RESULT ")]
            if r.returncode != 0 or not line:
                raise RuntimeError(f"worker for {root} failed (rc "
                                   f"{r.returncode}):\n{r.stderr[-3000:]}")
            got = json.loads(line[0][len("RESULT "):])
            print(side, json.dumps(got), flush=True)
            res[side].append(got)
    summary = {side: {k: float(np.mean([g[k] for g in runs]))
                      for k in runs[0] if k != "root"}
               for side, runs in res.items()}
    print(json.dumps({"device": smi, "a": sides["a"], "b": sides["b"],
                      "mean": summary}))


if __name__ == "__main__":
    main()
