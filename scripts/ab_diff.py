"""Time versions of the all-surface step's kernels on one card: csrc/diff.cu
(the backward launch) or, with --forward, csrc/whitted.cu (the tape
forward).

    python3 scripts/ab_diff.py OTHER.cu [OTHER.cu ...] [--scenes test17 ...]
        [--rounds 3] [--reps 5] [--cfg default deep schlick]
    python3 scripts/ab_diff.py --forward OTHER_whitted.cu [...]
        [--cfg default deep schlick]

Each OTHER.cu is another version of quadray_tpu_torch/csrc/diff.cu with
the same C entry points (diff_backward_launch, diff_backward_occupancy),
or with --forward of csrc/whitted.cu (whitted_tape_launch, the same
arguments), for example the parent commit's, unpacked with git archive
into a directory that .gitignore lists, or a variant written there. Every
version is built with the port's nvcc flags (ptxas lines printed) and
loaded into one process (the builds run as parallel nvcc processes; each
kernel's ptxas lines are printed by entry function). Cases: chip_smoke.py
T's, the step's moved scene
at 800x480 with TraceConfig(max_segments=8, stack=4) (--cfg: also T's
Schlick and deep-stack configs, chip_smoke.py t_cfg), a seeded colour
gradient. The backward: the tape from this checkout's tape launch; every
version's partials must equal this checkout's bitwise. With --ordered
this checkout's backward is also timed (o) on the tape with its rays in
a stable order by hit mask (each ray's mask over K <= 10 bounces; past
10, 32 x min(last hit + 1, 31) + min(hits, 31)), the tape and g_cols
permuted beforehand: what the backward would take were its warps to
take the rays in that order, with a tape as coalesced as the ray
order's, so a ceiling on what ordering the rays could win; beside it
torch.sort(key, stable=True) of the keys and the warp-bounces with a hit
in either order. The forward: every
version's colours bitwise this checkout's and its tape in every word of
the tape's contract (ops/diff.py tape_read; a version from before the
contract writes the others too). Then this checkout's (b) and each OTHER
(a1 a2 ...) are timed in turns, forward then back each round: CUDA graphs
of --reps calls of the backward launch and its light sums, or of the
forward (the pack launch and the tape launch, as T times it), device ms
a call, and the backward's blocks an SM. Prints each case's means, then
one JSON line. Needs a CUDA card; exits with code 2 without one.
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

from ab_pack import build_many  # noqa: E402


def order_keys(ti):
    """Each ray's key from the tape's flags: its hit mask over K <= 10
    bounces, past 10 32 x min(last hit + 1, 31) + min(hits, 31)."""
    from quadray_tpu_torch.ops import diff
    hit = (ti[:, 0] & diff.HIT) != 0
    ks = torch.arange(hit.shape[0], device=ti.device)[:, None]
    if hit.shape[0] <= 10:
        return (hit.int() << ks.int()).sum(0).int()
    last = torch.where(hit, ks, -1).amax(0)
    return ((last + 1).clamp(max=31) * 32
            + hit.int().sum(0).clamp(max=31)).int()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("others", nargs="+")
    ap.add_argument("--scenes", nargs="+",
                    default=["test15", "test17", "test18"])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--forward", action="store_true",
                    help="time versions of whitted.cu's tape forward")
    ap.add_argument("--cfg", nargs="+", default=["default"],
                    choices=["default", "schlick", "deep"],
                    help="chip_smoke.py t_cfg's configs to run each scene at")
    ap.add_argument("--ordered", action="store_true",
                    help="also time the backward on the tape with its rays "
                    "ordered by hit mask (the ceiling of ordering them)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_diff.py needs a CUDA card")
        sys.exit(2)
    import chip_smoke as cs
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import diff
    dev = torch.device("cuda", 0)
    mod, argtypes = (ck, ck.ARGTYPES) if args.forward else (diff,
                                                           diff.ARGTYPES)
    libs = {"b": mod._lib()}
    built = build_many(args.others, "whitted" if args.forward else "diff")
    for j, lib in enumerate(built):
        for fn, types in argtypes.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = types
                getattr(lib, fn).restype = ctypes.c_int
        libs[f"a{j + 1}"] = lib
    bits = lambda t: t.contiguous().view(torch.int32)
    out = {}
    real = mod._lib
    for what in args.cfg:
        cfg = cs.t_cfg(what)
        for name in args.scenes:
            sc, _, rays = cs.train_task(dev, name)
            struct = ck.scene_struct(sc)
            _, tf, ti = diff.forward_kernel(sc, struct, *rays, cfg)
            T = diff.tables(sc)
            g = torch.from_numpy(np.random.RandomState(29).standard_normal(
                (rays[1].shape[0], 3)).astype(np.float32)).to(dev)

            def run(key):
                mod._lib = lambda: libs[key]
                try:
                    if args.forward:
                        return diff.forward_kernel(sc, struct, *rays, cfg)
                    return diff.light_sums_kernel(diff.backward_rows_kernel(
                        g, T, tf, ti, cfg)[3])
                finally:
                    mod._lib = real

            want = run("b")
            occ = {}
            for key in libs:
                got = run(key)
                torch.cuda.synchronize()
                same = (torch.equal(bits(got[0]), bits(want[0]))
                        and diff.tape_differs(want[1], want[2], got[1],
                                              got[2]) == 0
                        if args.forward else
                        torch.equal(bits(got), bits(want)))
                if not same:
                    raise AssertionError(f"{name}: {key} off this "
                                         "checkout's")
                if not args.forward:
                    mod._lib = lambda key=key: libs[key]
                    try:
                        occ[key] = diff.backward_occupancy(
                            cfg, diff.table_columns(T))
                    finally:
                        mod._lib = real
            del want, got
            runs = {k: (lambda k=k: run(k)) for k in libs}
            case = f"{name} {what}"
            if args.ordered and not args.forward:
                keys = order_keys(ti)
                perm = torch.sort(keys, stable=True)[1]
                tfo = tf[:, :, perm].contiguous()
                tio = ti[:, :, perm].contiguous()
                go = g[perm].contiguous()
                runs["o"] = lambda: diff.light_sums_kernel(
                    diff.backward_rows_kernel(go, T, tfo, tio, cfg)[3])

                def hit(t):
                    h = torch.nn.functional.pad((t[:, 0] & diff.HIT) != 0,
                                                (0, -t.shape[2] % 32))
                    return int(h.view(t.shape[0], -1, 32).any(2).sum())
                ordered = {
                    "keys": int(torch.unique(keys).numel()),
                    "torch_sort_ms": cs.graph_ms(
                        lambda: torch.sort(keys, stable=True), args.reps),
                    "warp_bounces_with_hit": [hit(ti), hit(tio)],
                    "warp_bounces_run": [int(diff.warp_bounces(ti).sum()),
                                         int(diff.warp_bounces(tio).sum())]}
                print(f"{case}: rays ordered by hit mask {ordered}",
                      flush=True)
            order = list(runs)
            times = {k: [] for k in runs}
            for r in range(args.rounds):
                for key in (order if r % 2 == 0 else order[::-1]):
                    times[key].append(cs.graph_ms(runs[key], args.reps))
            out[case] = {k: {"ms": float(np.mean(v)), "runs": v,
                             "blocks_per_sm": occ.get(k)}
                         for k, v in times.items()}
            part = ("forward (pack + tape launch)" if args.forward
                    else "backward launch + light sums")
            print(f"{case} 800x480 K={cfg.max_segments}: {part}, device ms "
                  "a call: " + "; ".join(
                      f"{k} {np.mean(v):.4f} ({min(v):.4f}-{max(v):.4f})"
                      + (f" ({occ[k]} blocks an SM)" if k in occ else "")
                      for k, v in times.items())
                  + "; " + " ".join(
                      f"b/{k} {np.mean(times['b']) / np.mean(v):.4f}"
                      for k, v in times.items() if k != "b"), flush=True)
            del sc, rays, tf, ti, T, g
            torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
