"""Time the Whitted kernels of two versions of csrc/whitted.cu on one card.

    python3 scripts/ab_whitted.py OTHER.cu [--rounds 8] [--reps 20]

OTHER.cu is another version of quadray_tpu_torch/csrc/whitted.cu with the
same C entry points (whitted_launch, whitted_paths_launch,
whitted_pt_launch) and table layout, for example the parent commit's,
unpacked with git archive into a directory that .gitignore lists (with
the headers it includes beside it). Both are built with the port's nvcc
flags and loaded into one process; the ptxas lines (registers, stack
frame, spills) of both builds are printed. For each case (a scene at
800x480, the Whitted mode, the path-record mode of the training step or
one path-traced pass) the scene is packed once, both versions must give
the same output bitwise, and then the kernel launch alone is timed in
turns, this checkout's version (b) and OTHER (a) in the order a b b a,
a b b a, ...: CUDA events around --reps launches after a warm-up. Prints
each round's ms per launch, then one JSON line with every case's times,
means and the b/a ratio of the means. Needs a CUDA card; exits with code
2 without one.
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
# (scene, mode): test13 and demo03 are the kernel table's heavy Whitted
# scenes (demo02 has three lights), test01 and test13 the training step's
# path-record mode, test18 the path tracer's pass (depth 10)
CASES = [("test13", "whitted"), ("demo02", "whitted"), ("demo03", "whitted"),
         ("test01", "whitted"), ("test01", "paths"), ("test13", "paths"),
         ("test18", "pt")]
K_PATHS = 8


def build_other(src: str) -> ctypes.CDLL:
    from quadray_tpu_torch.ops import _build
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"libwhitted_other_{digest}.so")
    if not os.path.exists(out):
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                              "-v", "-o", out, src], check=True,
                             capture_output=True, text=True)
        print_ptxas("a", res.stderr)
    return ctypes.CDLL(out)


def print_ptxas(which: str, text: str):
    for line in text.splitlines():
        if any(k in line for k in ("entry function", "registers",
                                   "stack frame")):
            print(f"ptxas {which}: {line.strip()}", flush=True)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of this checkout's entry points (ops/cuda_kernel
    .py _lib), which OTHER must share."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    ref = ck._lib()
    for fn in ("whitted_launch", "whitted_paths_launch",
               "whitted_pt_launch"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def launcher(lib, name: str, mode: str, dev):
    """(run, tensors to keep alive): run() launches lib's kernel on the
    case's inputs and returns its output buffer."""
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.rays import camera_rays
    from quadray_tpu_torch.ops.trace import TraceConfig
    from quadray_tpu_torch.scene import schema as S
    from quadray_tpu_torch.scene.compile import compile_scene
    sd = load_scene(name)
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device=dev)
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, W, H, 1)
    tmin = sc.cam_pov.expand(dirs.shape[0])
    struct = ck.scene_struct(sc)
    ps = ck.pack_scene(sc, struct)
    rays, tables = ck._launch_inputs("ab", sc, org, dirs, tmin, struct, ps)
    n = dirs.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mode == "pt":
        from quadray_tpu_torch.ops.pt import init_seeds
        seeds = init_seeds(n, device=dev)
        out = torch.empty((3, n), dtype=torch.float32, device=dev)
        seeds_out = torch.empty((n,), dtype=torch.int32, device=dev)
        iters = torch.empty((1,), dtype=torch.int32, device=dev)

        def run():
            err = lib.whitted_pt_launch(
                rays.data_ptr(), seeds.data_ptr(), out.data_ptr(),
                seeds_out.data_ptr(), iters.data_ptr(), *tables, n,
                struct.n_real, struct.nc, struct.nl, 10, stream)
            assert err == 0, err
            return torch.cat([out.view(torch.int32), seeds_out[None]])
    elif mode == "whitted":
        cfg = TraceConfig()
        out = torch.empty((3, n), dtype=torch.float32, device=dev)

        def run():
            err = lib.whitted_launch(
                rays.data_ptr(), out.data_ptr(), *tables, n, struct.n_real,
                struct.nc, struct.nl, cfg.depth, cfg.max_segments,
                cfg.stack, cfg.cutoff, int(struct.can_push), stream)
            assert err == 0, err
            return out
    else:
        cfg = TraceConfig(max_segments=K_PATHS, stack=4)
        out = torch.empty((3, n), dtype=torch.float32, device=dev)
        paths = torch.empty((K_PATHS, n), dtype=torch.int32, device=dev)

        def run():
            err = lib.whitted_paths_launch(
                rays.data_ptr(), out.data_ptr(), paths.data_ptr(), *tables,
                n, struct.n_real, struct.nc, struct.nl, cfg.depth, K_PATHS,
                cfg.cutoff, stream)
            assert err == 0, err
            return torch.cat([out.view(torch.int32), paths])
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
    ap.add_argument("other", help="the other version of whitted.cu")
    ap.add_argument("--rounds", type=int, default=8,
                    help="rounds of a b b a per case")
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per timing")
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
    libs = {"a": bind(build_other(args.other)),
            "b": bind(load_library("whitted"))}
    ptxas = os.path.join(os.path.dirname(libs["b"]._name),
                         "whitted.ptxas.txt")
    if os.path.exists(ptxas):
        with open(ptxas) as fh:
            print_ptxas("b", fh.read())
    result = {"device": smi, "other": args.other, "rounds": args.rounds,
              "reps": args.reps, "cases": {}}
    for name, mode in CASES:
        runs = {}
        for k, lib in libs.items():
            runs[k] = launcher(lib, name, mode, dev)
        outs = {k: runs[k][0]().clone() for k in runs}
        torch.cuda.synchronize()
        if not torch.equal(outs["a"].view(torch.int32),
                           outs["b"].view(torch.int32)):
            raise AssertionError(f"{name} {mode}: the two versions differ")
        times = {"a": [], "b": []}
        for _ in range(args.rounds):
            for k in ("a", "b", "b", "a"):
                times[k].append(ms_per_launch(runs[k][0], args.reps))
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        case = f"{name} {mode}"
        result["cases"][case] = {"a_ms": times["a"], "b_ms": times["b"],
                                 "a_mean": mean["a"], "b_mean": mean["b"],
                                 "b_over_a": mean["b"] / mean["a"]}
        print(f"{case}: a {min(times['a']):.4f}-{max(times['a']):.4f} "
              f"mean {mean['a']:.4f} ms; b {min(times['b']):.4f}-"
              f"{max(times['b']):.4f} mean {mean['b']:.4f} ms; b/a "
              f"{mean['b'] / mean['a']:.4f}", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
