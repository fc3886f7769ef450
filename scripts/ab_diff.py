"""Time versions of csrc/diff.cu, the all-surface step's backward launch,
on one card.

    python3 scripts/ab_diff.py OTHER.cu [OTHER.cu ...] [--scenes test17 ...]
        [--rounds 3] [--reps 5]

Each OTHER.cu is another version of quadray_tpu_torch/csrc/diff.cu with
the same C entry points (diff_backward_launch, diff_backward_occupancy),
for example a variant written into a directory that .gitignore lists.
Every version is built with the port's nvcc flags (ptxas lines printed)
and loaded into one process. Cases: chip_smoke.py T's, the step's moved
scene at 800x480 with TraceConfig(max_segments=8, stack=4), the tape from
this checkout's tape launch and a seeded colour gradient. Every version's
partials must equal this checkout's bitwise; then this checkout's (b) and
each OTHER (a1 a2 ...) are timed in turns, forward then back each round:
CUDA graphs of --reps calls of the backward launch and its light sums,
device ms a call, and each version's blocks an SM. Prints each case's
means, then one JSON line. Needs a CUDA card; exits with code 2 without
one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from ab_pack import build  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("others", nargs="+")
    ap.add_argument("--scenes", nargs="+",
                    default=["test15", "test17", "test18"])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_diff.py needs a CUDA card")
        sys.exit(2)
    import chip_smoke as cs
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import diff
    dev = torch.device("cuda", 0)
    libs = {"b": diff._lib()}
    for j, src in enumerate(args.others):
        lib = build(src, "diff")
        for fn, types in diff.ARGTYPES.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        libs[f"a{j + 1}"] = lib
    cfg = cs.train_cfg()
    bits = lambda t: t.contiguous().view(torch.int32)
    out = {}
    for name in args.scenes:
        sc, _, rays = cs.train_task(dev, name)
        struct = ck.scene_struct(sc)
        _, tf, ti = diff.forward_kernel(sc, struct, *rays, cfg)
        T = diff.tables(sc)
        g = torch.from_numpy(np.random.RandomState(29).standard_normal(
            (rays[1].shape[0], 3)).astype(np.float32)).to(dev)
        real = diff._lib

        def run(key):
            diff._lib = lambda: libs[key]
            try:
                return diff.light_sums_kernel(diff.backward_rows_kernel(
                    g, T, tf, ti, cfg)[3])
            finally:
                diff._lib = real

        want = run("b")
        occ = {}
        for key in libs:
            got = run(key)
            torch.cuda.synchronize()
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"{name}: {key} off this checkout's")
            diff._lib = lambda key=key: libs[key]
            try:
                occ[key] = diff.backward_occupancy(cfg, diff.table_columns(T))
            finally:
                diff._lib = real
        order = list(libs)
        times = {k: [] for k in libs}
        for r in range(args.rounds):
            for key in (order if r % 2 == 0 else order[::-1]):
                times[key].append(cs.graph_ms(lambda: run(key), args.reps))
        out[name] = {k: {"ms": float(np.mean(v)), "runs": v,
                         "blocks_per_sm": occ[k]} for k, v in times.items()}
        print(f"{name} 800x480 K={cfg.max_segments}: backward launch + "
              "light sums, device ms a call: " + "; ".join(
                  f"{k} {np.mean(v):.4f} ({occ[k]} blocks an SM)"
                  for k, v in times.items()))
        del sc, rays, tf, ti, T, g
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
