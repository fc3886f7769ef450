"""Time the Whitted kernels of versions of csrc/whitted.cu on one card.

    python3 scripts/ab_whitted.py OTHER.cu [MORE.cu ...] [--rounds 8]
        [--reps 20] [--modes whitted paths emit resume pt]
        [--cull on off] [--k1 1 4] [--coop 0 1 2 4 8 16 32]
        [--own-min 0 8 16 32 64] [--own-max N] [--resume-warp 0 1024 n]
        [--frames 64]
        [--scenes test03 test10 ...] [--rounds-scenes test13 demo02 ...]
        [--paths-scenes test01 test13 demo03 | single] [--sweep-others]
        [--sass]

OTHER.cu is another version of quadray_tpu_torch/csrc/whitted.cu with the
same C entry points (whitted_launch, whitted_paths_launch,
whitted_emit_launch, whitted_resume_launch, whitted_pt_launch) and
arguments, for example the parent commit's, unpacked with git archive
into a directory that .gitignore lists (with the headers it includes
beside it), or a variant of this checkout's (another culling design).
A version whose whitted_pt_launch ends at the stream (before PT culling),
whose whitted_launch does (before the cooperative tail) or whose
whitted_emit_launch and whitted_resume_launch do (before per-ray masks
and RESUME's two modes; the parent of that change times the warp's masks
after EMIT's camera segment) is called with this checkout's arguments
too: the cull flags, coop_max, the Whitted mode's own_min and own_max
(before whole_kernel), the rounds' own_min and RESUME's warp_max, and
every mode's Schlick flag (0 here) and whole_kernel's stack scratch
(none here) come after the stream, and it ignores them. All are built with the port's
nvcc flags and loaded into one process; the ptxas lines
(registers, stack frame, spills) of every build are printed, one line
each for every template instantiation. For each
case (a scene at 800x480, the Whitted mode, the path-record mode of the
training step, round 1 or round 2 of two-round retirement, or one
path-traced pass at depth 10) and each --cull setting (on: the default
TraceConfig's gates, ops/cuda_kernel.py cull_gates, PT's for the PT
pass; off: cull=False) the scene is packed once, every version must give
the same output bitwise, and then the kernel launch alone is timed in
turns, this checkout's version (b) and OTHER (a) in the order a b b a,
a b b a, ...: CUDA events around --reps launches after a warm-up. With
more versions (a1, a2, ... in the order given) a round is
a1 a2 ... b b ... a2 a1. --coop sweeps this checkout's coop_max (the
cooperative tail's switch, ops/cuda_kernel.py COOP_MAX_LIVE, the default)
in the Whitted cases: each value is a version of its own (b0, b4, ...),
timed in the same rounds (a b0 b4 b4 b0 a); --frames K times the Whitted
cases as one launch of K frames' rays, as the port's bench batches them;
--own-min sweeps the Whitted cases' own_min (the per-ray masks' floor,
ops/cuda_kernel.py EMIT_OWN_MIN_KEPT, the default) the same way (o0, o8,
...; a value above every scene's surfaces turns the masks off), and
--own-max sets their own_max (the most rays of a launch with per-ray
masks, WHOLE_OWN_MAX_RAYS by default); --resume-warp sweeps
RESUME's switch (warp_max, ops/cuda_kernel.py RESUME_WARP_MAX; n: every
ray, so always a warp per survivor) in the resume cases the same way;
--sweep-others sweeps
the OTHER versions too (a0, a4, ...: variants of this checkout's design).
--k1 takes several values (the emit and resume cases run at each) and
--rounds-scenes replaces their scenes; --paths-scenes replaces the
path-record cases' scenes ("single": every single-branch golden scene).
--sass counts, from cuobjdump -sass of every build, each path-record
and whole-trace kernel's loads by kind: LDG (device memory), LDS
(shared), LD (generic), LDL/STL (local memory: the stack and spills).
Prints each case's range and
mean per version, then one JSON line with every case's times, means and
the ratio of the means of each version of this checkout to each other
version. --scenes replaces the Whitted cases' scenes (for example the
golden scenes the default gate culls). Needs a CUDA card; exits with
code 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

W, H = 800, 480
# (scene, mode): test13, test14 and demo03 are the kernel table's heavy
# Whitted scenes (demo02 has three lights), test01 (the training step's
# scene), test13 and demo03 the path-record mode, test13 the two rounds of two-round retirement
# after --k1 segments (resume from the state this checkout's emit leaves),
# test18 the path tracer's pass (bench_pt's scene) and the three other
# scenes of chip_smoke.py phase E1, whose samples reach the node cap (the
# PT gate culls none of the four), then the heavy PT cases the gate
# culls, test13 (104 surfaces) and demo03 (152)
CASES = [("test13", "whitted"), ("test14", "whitted"), ("demo02", "whitted"),
         ("demo03", "whitted"), ("test01", "whitted"), ("test01", "paths"),
         ("test13", "paths"),
         ("test13", "emit"), ("test13", "resume"), ("test18", "pt"),
         ("test17", "pt"), ("test15", "pt"), ("test05", "pt"),
         ("test13", "pt"), ("demo03", "pt")]
K_PATHS = 8
MODES = ("whitted", "paths", "emit", "resume", "pt")
PT_DEPTH = 10
GOLDEN = [f"test{i:02d}" for i in range(1, 19)] + ["demo01", "demo02",
                                                    "demo03"]
# PT scenes whose paths seldom reach their light get chip_smoke.py's seeded
# emission on every surface, so that the bitwise check compares radiance,
# not zeros; emission changes no path, so the time is the scene's own
PT_EMISSION = {"test17": 17, "test15": 15, "test05": 5, "test13": 13,
               "demo03": 3}


def build_others(srcs: list) -> list:
    """Builds every OTHER source with parallel nvcc processes; returns the
    loaded libraries in the order given."""
    from quadray_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    builds = []
    for src in srcs:
        with open(src, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
        out = os.path.join(_build.BUILD_DIR, f"libwhitted_other_{digest}.so")
        proc = None
        if not os.path.exists(out):
            proc = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 out, src], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        builds.append((src, out, proc))
    libs = []
    for src, out, proc in builds:
        if proc is not None:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {src}:\n{err}")
            print_ptxas(src, err)
        libs.append(ctypes.CDLL(out))
    return libs


def print_ptxas(which: str, text: str):
    for line in text.splitlines():
        if any(k in line for k in ("entry function", "registers",
                                   "stack frame")):
            print(f"ptxas {which}: {line.strip()}", flush=True)


SASS_KINDS = ("LDG", "LDS", "LD", "LDL", "STL")


def sass_loads(which: str, path: str):
    """Prints, for each path-record and whole-trace kernel of the library
    at path, its SASS load and store instructions by kind (cuobjdump
    -sass)."""
    from quadray_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        # paths_kernel, whole_kernel, or a parent's megakernel instantiation
        # with EMIT_PATHS (whitted_kernel<CAN_PUSH, EMIT_PATHS = true, ...>)
        if not any(k in name for k in ("paths_kernel", "whole_kernel",
                                       "whitted_kernelILb0ELb1E")):
            continue
        ops = []
        for ln in chunk.splitlines():
            if not ln.strip().startswith("/*") or "*/" not in ln:
                continue
            words = ln.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):   # a predicate
                words = words[1:]
            if words and not words[0].startswith("/*"):
                ops.append(words[0].split(".")[0])
        counts = {k: sum(o == k for o in ops) for k in SASS_KINDS}
        print(f"sass {which}: {name}: " + " ".join(
            f"{k} {v}" for k, v in counts.items())
            + f" (instructions {len(ops)})", flush=True)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of this checkout's entry points (ops/cuda_kernel
    .py ARGTYPES), which OTHER must share."""
    from quadray_tpu_torch.ops.cuda_kernel import ARGTYPES
    for fn, types in ARGTYPES.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def launcher(lib, name: str, mode: str, dev, cull: bool, k1: int,
             opt, frames: int = 1):
    """(run, tensors to keep alive): run() launches lib's kernel on the
    case's inputs, culled as the default TraceConfig's gates say or not
    at all, and returns its output buffer; the rounds split after k1
    segments. opt: the Whitted mode's (coop_max, own_min, own_max),
    RESUME's warp_max ("n": every ray)."""
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.rays import camera_rays
    from quadray_tpu_torch.ops.trace import TraceConfig
    from quadray_tpu_torch.scene import schema as S
    from quadray_tpu_torch.scene.compile import compile_scene
    from chip_smoke import with_emission
    sd = load_scene(name)
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device=dev)
    if mode == "pt" and name in PT_EMISSION:
        sc = with_emission(sc, PT_EMISSION[name])
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, W, H, 1)
    if mode == "whitted" and frames > 1:
        # one launch of several frames' rays one after another, as the
        # port's bench batches them
        dirs = dirs.repeat(frames, 1)
    tmin = sc.cam_pov.expand(dirs.shape[0])
    struct = ck.scene_struct(sc)
    ps = ck.pack_scene(sc, struct)
    rays, tables = ck._launch_inputs("ab", sc, org, dirs, tmin, struct, ps)
    n = dirs.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the cull flags of this case's TraceConfig, the stream and the mode's
    # option, in the entry point's order
    if mode == "pt":
        gates = ck.cull_gates(struct, TraceConfig(depth=PT_DEPTH, cull=cull),
                              pt=True)
        last = [stream, gates.flags]
    else:
        gates = ck.cull_gates(struct, TraceConfig(
            **({} if mode != "paths" else dict(max_segments=K_PATHS,
                                                stack=4)), cull=cull))
        last = [gates.flags, stream]
        if mode == "whitted":
            # and Schlick's flag (0) and no stack scratch (the default
            # stack of 10 holds in local slots)
            last += list(opt) + [0, None]
        elif mode == "resume":
            last += [n if opt == "n" else min(int(opt), n),
                     ck.RESUME_OWN_MIN_KEPT, 0]
    if mode == "pt":
        from quadray_tpu_torch.ops.pt import init_seeds
        seeds = init_seeds(n, device=dev)
        out = torch.empty((3, n), dtype=torch.float32, device=dev)
        seeds_out = torch.empty((n,), dtype=torch.int32, device=dev)
        iters = torch.empty((2,), dtype=torch.int32, device=dev)

        def run():
            err = lib.whitted_pt_launch(
                rays.data_ptr(), seeds.data_ptr(), out.data_ptr(),
                seeds_out.data_ptr(), iters.data_ptr(), *tables, n,
                struct.n_real, struct.nc, struct.nl, PT_DEPTH, *last)
            assert err == 0, err
            return torch.cat([out.view(torch.int32), seeds_out[None]])
    elif mode == "whitted":
        cfg = TraceConfig()
        out = torch.empty((3, n), dtype=torch.float32, device=dev)

        def run():
            err = lib.whitted_launch(
                rays.data_ptr(), out.data_ptr(), *tables, n, struct.n_real,
                struct.nc, struct.nl, cfg.depth, cfg.max_segments,
                cfg.stack, cfg.cutoff, int(struct.can_push), *last)
            assert err == 0, err
            return out
    elif mode in ("emit", "resume"):
        from quadray_tpu_torch.ops.trace import STATE_ROWS
        cfg = TraceConfig()
        out = torch.empty((3, n), dtype=torch.float32, device=dev)
        state = torch.empty((len(STATE_ROWS), n), dtype=torch.float32,
                            device=dev)

        def run():
            err = lib.whitted_emit_launch(
                rays.data_ptr(), out.data_ptr(), state.data_ptr(), *tables,
                n, struct.n_real, struct.nc, struct.nl, cfg.depth, k1,
                cfg.cutoff, *last[:2], ck.EMIT_OWN_MIN_KEPT, 0)
            assert err == 0, err
            return torch.cat([out.view(torch.int32), state.view(torch.int32)])
        if mode == "resume":
            # round 2 over round 1's survivors, colours written in place
            # (the same values every launch)
            run()
            idx, count = ck.compact_active(state)

            def run():
                err = lib.whitted_resume_launch(
                    state.data_ptr(), idx.data_ptr(), count.data_ptr(),
                    out.data_ptr(), *tables, n, struct.n_real, struct.nc,
                    struct.nl, cfg.depth, cfg.max_segments - k1, cfg.cutoff,
                    *last)
                assert err == 0, err
                return out
    else:
        cfg = TraceConfig(max_segments=K_PATHS, stack=4)
        out = torch.empty((3, n), dtype=torch.float32, device=dev)
        paths = torch.empty((K_PATHS, n), dtype=torch.int32, device=dev)
        queue = torch.empty((1,), dtype=torch.int32, device=dev)
        last += [queue.data_ptr(), struct.nm, ck.EMIT_OWN_MIN_KEPT, 0]

        def run():
            err = lib.whitted_paths_launch(
                rays.data_ptr(), out.data_ptr(), paths.data_ptr(), *tables,
                n, struct.n_real, struct.nc, struct.nl, cfg.depth, K_PATHS,
                cfg.cutoff, *last)
            assert err == 0, err
            return torch.cat([out.view(torch.int32), paths])
        return run, (rays, ps, sc, queue)
    # the tables are passed as raw pointers: keep their tensors alive
    return run, (rays, ps, sc)


def ms_per_launch(run, reps: int) -> float:
    run()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="+",
                    help="the other versions of whitted.cu")
    ap.add_argument("--rounds", type=int, default=8,
                    help="rounds of a b b a per case")
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per timing")
    ap.add_argument("--modes", nargs="+", default=list(MODES),
                    choices=MODES,
                    help="the cases' modes to run")
    ap.add_argument("--cull", nargs="+", default=["on", "off"],
                    choices=["on", "off"],
                    help="the cull settings to run each Whitted case at")
    ap.add_argument("--k1", type=int, nargs="+", default=None,
                    help="segments of round 1 in the emit and resume cases, "
                    "each a case (default ROUNDS_K1; 1 times the primary "
                    "segment)")
    ap.add_argument("--scenes", nargs="+", default=None,
                    help="the Whitted cases' scenes (default: CASES')")
    ap.add_argument("--rounds-scenes", nargs="+", default=None,
                    help="the emit and resume cases' scenes (default: "
                    "CASES')")
    ap.add_argument("--coop", type=int, nargs="+", default=None,
                    help="coop_max values of this checkout's Whitted cases "
                    "(default COOP_MAX_LIVE alone)")
    ap.add_argument("--frames", type=int, default=1,
                    help="frames a Whitted launch traces, their rays one "
                    "after another (the port's bench batches 8 and 64)")
    ap.add_argument("--own-min", type=int, nargs="+", default=None,
                    help="own_min values of this checkout's Whitted cases "
                    "(default EMIT_OWN_MIN_KEPT alone)")
    ap.add_argument("--own-max", type=int, default=None,
                    help="own_max of this checkout's Whitted cases (default "
                    "WHOLE_OWN_MAX_RAYS)")
    ap.add_argument("--resume-warp", nargs="+", default=None,
                    help="warp_max values (integers, or n for every ray) of "
                    "this checkout's resume cases (default RESUME_WARP_MAX "
                    "alone)")
    ap.add_argument("--paths-scenes", nargs="+", default=None,
                    help="the path-record cases' scenes (default: CASES'; "
                    "single: every single-branch golden scene)")
    ap.add_argument("--sass", action="store_true",
                    help="count the path-record and whole-trace kernels' "
                    "SASS loads")
    ap.add_argument("--sweep-others", action="store_true",
                    help="sweep --coop and --resume-warp on the OTHER "
                    "versions too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False")
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from quadray_tpu_torch.ops._build import load_library
    dev = torch.device("cuda", 0)
    labels = ["a"] if len(args.other) == 1 else [
        f"a{j + 1}" for j in range(len(args.other))]
    for k, src in zip(labels, args.other):
        print(f"{k}: {src}", flush=True)
    libs = dict(zip(labels, map(bind, build_others(args.other))))
    libs["b"] = bind(load_library("whitted"))
    ptxas = os.path.join(os.path.dirname(libs["b"]._name),
                         "whitted.ptxas.txt")
    if os.path.exists(ptxas):
        with open(ptxas) as fh:
            print_ptxas("b", fh.read())
    if args.sass:
        for k, lib in libs.items():
            sass_loads(k, lib._name)
    from quadray_tpu_torch.ops.cuda_kernel import (
        COOP_MAX_LIVE, EMIT_OWN_MIN_KEPT, RESUME_WARP_MAX, ROUNDS_K1,
        WHOLE_OWN_MAX_RAYS)
    own_max = WHOLE_OWN_MAX_RAYS if args.own_max is None else args.own_max
    result = {"device": smi, "other": dict(zip(labels, args.other)),
              "rounds": args.rounds, "reps": args.reps,
              "frames": args.frames,
              "coop_max_live": COOP_MAX_LIVE,
              "own_min": EMIT_OWN_MIN_KEPT, "own_max": own_max,
              "resume_warp_max": RESUME_WARP_MAX, "cases": {}}
    # each mode's option (launcher's opt): its default and the sweep's
    # values, {version suffix: value}
    default = {"whitted": (COOP_MAX_LIVE, EMIT_OWN_MIN_KEPT, own_max),
               "emit": None,
               "resume": RESUME_WARP_MAX, "paths": None, "pt": None}
    sweeps = {"whitted": {
        **{str(c): (c, EMIT_OWN_MIN_KEPT, own_max)
           for c in args.coop or ()},
        **{f"o{m}": (COOP_MAX_LIVE, m, own_max) for m in args.own_min or ()}},
        "resume": {w: w for w in args.resume_warp or ()}}
    table = CASES if args.scenes is None else (
        [(n, "whitted") for n in args.scenes]
        + [c for c in CASES if c[1] != "whitted"])
    if args.paths_scenes is not None:
        names = args.paths_scenes
        if names == ["single"]:
            from quadray_tpu_torch.models.scenes.loader import load_scene
            from quadray_tpu_torch.ops import cuda_kernel as ck
            from quadray_tpu_torch.scene import schema as S
            from quadray_tpu_torch.scene.compile import compile_scene
            names = [g for g in GOLDEN if not ck.scene_struct(compile_scene(
                S.SceneDef(root=load_scene(g).root, opts=S.OPTS_FULL
                           & ~load_scene(g).opts), device=dev)).can_push]
        table = [c for c in table if c[1] != "paths"] + [
            (n, "paths") for n in names]
    if args.rounds_scenes is not None:
        table = [c for c in table if c[1] not in ("emit", "resume")] + [
            (n, m) for m in ("emit", "resume") for n in args.rounds_scenes]
    cases = [(name, mode, cull, k1) for name, mode in table
             if mode in args.modes for cull in args.cull
             for k1 in (args.k1 or [ROUNDS_K1]
                        if mode in ("emit", "resume") else [0])]
    for name, mode, cull, k1 in cases:
        # this checkout's versions: one per value of the mode's sweep
        sweep = sweeps.get(mode)
        mine = {f"b{v}": c for v, c in sweep.items()} if sweep else {
            "b": default[mode]}
        others = ({f"{k}@{v}": (k, c) for k in labels
                   for v, c in sweep.items()}
                  if sweep and args.sweep_others
                  else {k: (k, default[mode]) for k in labels})
        runs = {v: launcher(libs[k], name, mode, dev, cull == "on", k1, c,
                            args.frames)
                for v, (k, c) in others.items()}
        runs.update({k: launcher(libs["b"], name, mode, dev, cull == "on",
                                 k1, c, args.frames) for k, c in mine.items()})
        outs = {k: runs[k][0]().clone() for k in runs}
        torch.cuda.synchronize()
        ref = next(iter(mine))
        for k in runs:
            if not torch.equal(outs[k].view(torch.int32),
                               outs[ref].view(torch.int32)):
                raise AssertionError(f"{name} {mode}: {k} and {ref} differ")
        order = list(others) + list(mine) + list(mine)[::-1] \
            + list(others)[::-1]
        times = {k: [] for k in runs}
        for _ in range(args.rounds):
            for k in order:
                times[k].append(ms_per_launch(runs[k][0], args.reps))
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        case = f"{name} {mode} cull {cull}" \
            + (f" k1={k1}" if mode in ("emit", "resume") else "")
        result["cases"][case] = {
            **{f"{k}_ms": v for k, v in times.items()},
            **{f"{k}_mean": v for k, v in mean.items()},
            **{f"{b}_over_{k}": mean[b] / mean[k] for b in mine
               for k in others}}
        print(f"{case}: " + "; ".join(
            f"{k} {min(times[k]):.4f}-{max(times[k]):.4f} mean "
            f"{mean[k]:.4f} ms" for k in list(others) + list(mine)) + "; "
            + " ".join(f"{b}/{k} {mean[b] / mean[k]:.4f}" for b in mine
                       for k in others), flush=True)
    print(json.dumps(result))

if __name__ == "__main__":
    main()
