"""core_test-analog on the port: differential test harness over the 18
test scenes.

    python -m quadray_tpu_torch.apps.core_test [options]

The port of ``apps/core_test.py`` (test/core_test.cpp's workflow): render
each run level through ``quadray_tpu_torch.Scene`` and compare it with
the reference C engine's golden BMP under the per-channel threshold and
isolated-pixel forgiveness rule (core_test.cpp:96-145). ``-k`` also
traces the run level's camera rays through the CUDA kernel and through
its plain PyTorch version on the same card tensors and prints their
largest difference (the original's "optimized vs brute-force"
differential, re-targeted at kernel vs plain version).

  -b n / -e n   first/last run level (default 1..18)
  -x/-y         resolution (default 800x480, the goldens')
  -i            save rendered/diff images to dump/
  -t n          diff threshold (default 3)
  -k            also run the CUDA kernel against the plain tracer (card)
  -c            render on the CPU (the plain tracer); not with -k
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# the goldens live at the repository root, beside the package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m quadray_tpu_torch.apps.core_test",
        description=__doc__.split("\n")[0])
    ap.add_argument("-b", type=int, default=1)
    ap.add_argument("-e", type=int, default=18)
    ap.add_argument("-x", type=int, default=800)
    ap.add_argument("-y", type=int, default=480)
    ap.add_argument("-i", action="store_true")
    ap.add_argument("-t", type=int, default=3)
    ap.add_argument("-k", action="store_true")
    ap.add_argument("-c", action="store_true")
    args = ap.parse_args(argv)
    if args.k and args.c:
        ap.error("-k compares the CUDA kernel with its plain version on the "
                 "card; on the CPU (-c) there is no kernel to compare")
    return args


def run(argv=None) -> dict:
    """Run the harness; returns {"levels": {name: {"ms", "nbad",
    "kernel_diff"}}, "failures": n}: nbad is the bad-pixel count against
    the golden (None without one at this size), kernel_diff the -k max
    abs difference (None without -k), failures the run levels with bad
    pixels."""
    args = parse_args(argv)
    import numpy as np

    from quadray_tpu_torch.engine import Scene
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.utils.image import load_bmp, save_bmp, frame_cmp

    device = "cpu" if args.c else "cuda"
    os.makedirs("dump", exist_ok=True)
    failures = 0
    levels = {}
    for lvl in range(args.b, args.e + 1):
        name = f"test{lvl:02d}"
        golden = os.path.join(ROOT, "golden", f"ref_{name}.bmp")
        print(f"-------------------  RUN LEVEL = {lvl:2d}  "
              f"-------------------")
        sc = Scene(load_scene(name), args.x, args.y, device=device)
        t0 = time.time()
        frame = sc.render(0.0)
        dt = (time.time() - t0) * 1000.0
        print(f"Time F = {dt:.0f}")
        res = levels[name] = dict(ms=dt, nbad=None, kernel_diff=None)
        if os.path.exists(golden) and (args.x, args.y) == (800, 480):
            ref = load_bmp(golden)
            nbad, _ = frame_cmp(ref, frame, t_diff=args.t)
            res["nbad"] = nbad
            status = "OK" if nbad == 0 else f"DIFF {nbad} px"
            print(f"vs reference golden: {status}")
            failures += nbad > 0
            if args.i:
                save_bmp(f"dump/scr{lvl:02d}.bmp", frame)
                d = (np.abs(ref.astype(int) - frame.astype(int))
                     .max(-1).astype(np.uint8))
                save_bmp(f"dump/dff{lvl:02d}.bmp", np.stack([d] * 3, -1))
        if args.k:
            res["kernel_diff"] = kernel_vs_plain(sc.arrays, args.x, args.y)
            print(f"kernel vs plain maxdiff = {res['kernel_diff']:.2e}")
    print(f"\n{failures} scene(s) with differences")
    return dict(levels=levels, failures=failures)


def kernel_vs_plain(arr, width: int, height: int) -> float:
    """Max abs difference of the camera rays' linear colors, CUDA kernel
    (``trace_rays_cuda``) against the plain ``trace_rays``, on the same
    card tensors, TraceConfig(stack=6)."""
    from quadray_tpu_torch.ops.cuda_kernel import trace_rays_cuda
    from quadray_tpu_torch.ops.rays import camera_rays
    from quadray_tpu_torch.ops.trace import TraceConfig, trace_rays
    org, dirs = camera_rays(arr.cam_pos, arr.cam_hor, arr.cam_ver,
                            arr.cam_nrm, arr.cam_pov, width, height, 1)
    tmin = arr.cam_pov.expand(dirs.shape[0])
    cfg = TraceConfig(stack=6)
    a = trace_rays(arr, org, dirs, tmin, cfg)
    b = trace_rays_cuda(arr, org, dirs, tmin, cfg)
    return float((a - b).abs().max())


def main(argv=None) -> int:
    return 1 if run(argv)["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
