"""Time the interactive frame (Scene.render on the card, Whitted) of two
checkouts on one card.

    python3 scripts/ab_interactive.py OTHER_ROOT [--rounds 1] [--frames 60]

OTHER_ROOT is another checkout of this repository (quadray_tpu_torch/ and
golden/scenes/ are enough), for example the parent commit unpacked with
git archive into a directory that .gitignore lists. The two packages share
a name, so each measurement is its own process (python3
scripts/ab_interactive.py --worker ROOT) importing quadray_tpu_torch from
ROOT and building its kernels there; the processes run in turns, a b b a
per round (a the other checkout, b this one).

A worker drives chip_smoke.py J3's loop through the public entry point
alone: on demo01-03 and test13 at 800x480, a new Scene each, a first
frame (the structure, the program's capture), then --frames frames of
J3's camera trace (a camera action a frame, then Scene.render at the
frame's time). Per frame, on the host clock: the whole call; the update
(the time inside Scene.update and, where the checkout has one,
InteractiveProgram.stage_values); the table build (inside
ops.cuda_kernel._get_packed); the rest. The device ms of the frame's
graph (CUDA events around graphs.Replay's call) and the card's share of
the loop's window that it kept busy; the pack and update launches, the
inputs staged into the frame's program (Inputs.copies) and its warm-up
and capture ms. Then on demo02 one torch.profiler window of 10 frames:
host launch calls, device ops and ms a frame. Whatever a checkout lacks
(an update kernel, a counter) is reported as null. Prints each worker's
JSON line, then the means of each side and b/a. Needs a CUDA card; exits
with code 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 800, 480
# chip_smoke.py J3_SCENES, J3_TRACE and O_PROFILED
SCENES = ("demo01", "demo02", "demo03", "test13")
TRACE = "w,left,w,right,s,up,d,down,a,.".split(",")
PROFILED = 10


def _sdef(name):
    from quadray_tpu_torch.models.scenes import demos
    from quadray_tpu_torch.models.scenes.loader import load_scene
    return demos.build(name) if name.startswith("demo") else load_scene(name)


def _program(sc):
    """The Scene's Whitted frame program, whichever the checkout has."""
    return (getattr(sc, "_interactive_prog", None)
            or getattr(sc, "_frame_prog", None))


def _act(sc, fi):
    from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS, frame_time
    for key in TRACE[fi % len(TRACE)].split("+"):
        if fi and key in KEY_ACTIONS:
            sc.update_action(frame_time(fi), KEY_ACTIONS[key])


class Timed:
    """Host ms of the calls to obj.name inside the context, in place."""

    def __init__(self, obj, name, rec):
        self.obj, self.name, self.rec = obj, name, rec
        self.fn = getattr(obj, name, None)

    def __enter__(self):
        if self.fn is None:
            return self
        fn, rec = self.fn, self.rec

        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            rec.append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(self.obj, self.name, call)
        return self

    def __exit__(self, *exc):
        if self.fn is not None:
            setattr(self.obj, self.name, self.fn)


def frames(name, dev, n):
    """chip_smoke.py J3's loop on one new Scene: the split and counts."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.apps.render_cli import frame_time
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import graphs
    try:
        from quadray_tpu_torch.ops import update as upd
    except ImportError:
        upd = None
    sc = Scene(_sdef(name), W, H, device=dev)
    sc.render(0.0)
    prog = _program(sc)
    copies0 = prog.inputs.copies
    ck.pack_launches = 0
    if upd is not None:
        upd.launches = 0
    events, update, pack, frame_ms = [], [], [], []
    replay = graphs.Replay.__call__

    def timed_replay(self):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        replay(self)
        b.record()
        events.append((a, b))

    stage = getattr(graphs, "InteractiveProgram", None)
    w0, w1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    graphs.Replay.__call__ = timed_replay
    try:
        with Timed(sc, "update", update), Timed(ck, "_get_packed", pack), \
                Timed(stage, "stage_values", update):
            w0.record()
            t0 = time.perf_counter()
            for fi in range(1, n + 1):
                tf = time.perf_counter()
                _act(sc, fi)
                sc.render(frame_time(fi))
                frame_ms.append((time.perf_counter() - tf) * 1e3)
            dt = time.perf_counter() - t0
            w1.record()
    finally:
        graphs.Replay.__call__ = replay
    torch.cuda.synchronize()
    kern = [a.elapsed_time(b) for a, b in events]
    if len(kern) != n:
        raise RuntimeError(f"{name}: {len(kern)} graph replays in {n} "
                           "frames")
    upd_ms, pack_ms = sum(update) / n, sum(pack) / n
    ms = dt * 1e3 / n
    return dict(ms=ms, update=upd_ms, pack=pack_ms,
                rest=float(np.mean(frame_ms)) - upd_ms - pack_ms,
                graph_device_ms=float(np.mean(kern)),
                busy=sum(kern) / w0.elapsed_time(w1),
                pack_launches=ck.pack_launches / n,
                update_launches=(upd.launches / n if upd is not None
                                 else None),
                copies=(prog.inputs.copies - copies0) / n,
                capture_ms=prog.replay.ms,
                warmup_ms=getattr(prog.replay, "warmup_ms", None))


def profiled(dev, n):
    """One torch.profiler window of n demo02 frames after one: host
    launch calls, device kernels, memsets and copies, and their device
    ms, a frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.apps.render_cli import frame_time
    sc = Scene(_sdef("demo02"), W, H, device=dev)
    sc.render(0.0)
    _act(sc, 1)
    sc.render(frame_time(1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fi in range(2, n + 2):
            _act(sc, fi)
            sc.render(frame_time(fi))
        torch.cuda.synchronize()
    events = prof.events()
    dev_ev = [e for e in events if e.device_type != DeviceType.CPU]
    calls = sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.name.startswith(("cudaLaunch", "cuLaunch",
                                       "cudaGraphLaunch", "cudaMemcpy",
                                       "cudaMemset")))
    if not dev_ev:
        return dict(calls=calls / n, device_ops=None, device_ms=None)
    return dict(calls=calls / n, device_ops=len(dev_ev) / n,
                device_ms=sum(e.time_range.end - e.time_range.start
                              for e in dev_ev) / 1e3 / n)


def worker(root, n):
    import quadray_tpu_torch
    if os.path.dirname(os.path.dirname(
            os.path.abspath(quadray_tpu_torch.__file__))) != root:
        raise RuntimeError(f"imported {quadray_tpu_torch.__file__}, not "
                           f"the package of {root}")
    dev = torch.device("cuda", 0)
    out = {"root": root}
    for name in SCENES:
        for k, v in frames(name, dev, n).items():
            out[f"{name} {k}"] = v
    for k, v in profiled(dev, PROFILED).items():
        out[f"demo02 profiled {k}"] = v
    print("RESULT " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?", help="the other checkout's root")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--frames", type=int, default=60)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False")
        sys.exit(2)
    if args.worker:
        sys.path.insert(0, args.worker)
        worker(args.worker, args.frames)
        return
    if not args.other:
        ap.error("give OTHER_ROOT")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sides = {"a": os.path.abspath(args.other), "b": REPO}
    res = {"a": [], "b": []}
    for _ in range(args.rounds):
        for side in "abba":
            root = sides[side]
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root,
                 "--frames", str(args.frames)], cwd=root,
                capture_output=True, text=True,
                env=dict(os.environ, PYTHONPATH=root))
            line = [ln for ln in r.stdout.splitlines()
                    if ln.startswith("RESULT ")]
            if r.returncode != 0 or not line:
                raise RuntimeError(f"worker for {root} failed (rc "
                                   f"{r.returncode}):\n{r.stderr[-3000:]}")
            got = json.loads(line[0][len("RESULT "):])
            print(side, json.dumps(got), flush=True)
            res[side].append(got)

    def mean(runs, k):
        v = [g[k] for g in runs if g.get(k) is not None]
        return float(np.mean(v)) if v else None

    keys = [k for k in res["b"][0] if k != "root"]
    summary = {side: {k: mean(runs, k) for k in keys}
               for side, runs in res.items()}
    for k in keys:
        a, b = summary["a"][k], summary["b"][k]
        ratio = f"{b / a:.3f}" if a and b is not None else "n/a"
        print(f"{k}: a {a} -> b {b} (b/a {ratio})")
    print(json.dumps({"device": smi, "a": sides["a"], "b": sides["b"],
                      "mean": summary}))


if __name__ == "__main__":
    main()
