"""Time the conformance kernels of versions of csrc/conformance.cu on one card.

    python3 scripts/ab_conformance.py OTHER.cu [MORE.cu ...] [--rounds 5]
        [--reps 200] [--rows 3000]

OTHER.cu is another version of quadray_tpu_torch/csrc/conformance.cu with
the same C entry point, conformance_launch, for example the parent
commit's, unpacked with git archive into a directory that .gitignore
lists (with common.cuh beside it). A version from before the 16-byte path
ends its arguments at the stream and ignores the vec flag after it. Every
version is built with the port's nvcc flags and loaded into one process.
Each case runs on chip_smoke.py G3's inputs (--rows x 128 elements;
384,000 by default): every version's output must equal this checkout's
bitwise; then each version (a, or a1 a2 ... in the order given, and this
checkout's, b) and the one PyTorch call of the case (chip_smoke.py
LIBRARY, where the case has one: t) are timed in turns, a b t t b a per
round: CUDA graphs of --reps launches, device ms a launch. Prints each
case's means and ratios, then one JSON line. Needs a CUDA card; exits
with code 2 without one.
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


def build(src: str) -> ctypes.CDLL:
    from quadray_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    out = os.path.join(_build.BUILD_DIR, f"libconformance_other_{digest}.so")
    if not os.path.exists(out):
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                               src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n{proc.stderr}")
    return ctypes.CDLL(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="+",
                    help="the other versions of conformance.cu")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=200,
                    help="launches in one CUDA graph")
    ap.add_argument("--rows", type=int, default=None,
                    help="rows of 128 elements (default chip_smoke G_ROWS)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False")
        sys.exit(2)
    from chip_smoke import G_ROWS, LIBRARY, graph_ms
    from quadray_tpu_torch.ops import conformance as cf
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    rows = args.rows or G_ROWS
    labels = ["a"] if len(args.other) == 1 else [
        f"a{j + 1}" for j in range(len(args.other))]
    mine = cf._lib()
    libs = dict(zip(labels, map(build, args.other)))
    libs["b"] = mine
    for k in labels:
        libs[k].conformance_launch.argtypes = \
            mine.conformance_launch.argtypes
        libs[k].conformance_launch.restype = ctypes.c_int
        print(f"{k}: {args.other[labels.index(k)]}", flush=True)
    result = {"device": smi, "rows": rows, "reps": args.reps,
              "other": dict(zip(labels, args.other)), "cases": {}}
    for name in cf.CASES:
        xs = [torch.from_numpy(a).to(dev)
              for a in cf.case_inputs(name, rows)]
        floats = [a for a in xs if a.dtype == torch.float32] + [None] * 3
        idx = xs[1] if name == "gather" else None
        ptr = lambda t: None if t is None else t.data_ptr()
        outs = {k: torch.empty_like(xs[0], dtype=torch.float32)
                for k in libs}
        n = xs[0].numel()
        vec = int(cf.vector_split(n, outs["b"], *xs)[0] > 0)

        def run(k):
            # the current stream: a CUDA graph captures on its own
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = libs[k].conformance_launch(
                cf.CASES.index(name), ptr(floats[0]), ptr(floats[1]),
                ptr(floats[2]), ptr(idx), outs[k].data_ptr(), n, stream,
                vec)
            assert err == 0, err
        fns = {k: (lambda k=k: run(k)) for k in libs}
        if name in LIBRARY:
            fns["t"] = lambda: LIBRARY[name](*xs)
        for k in libs:
            fns[k]()
        torch.cuda.synchronize()
        for k in labels:
            if not torch.equal(outs[k].view(torch.int32),
                               outs["b"].view(torch.int32)):
                raise AssertionError(f"{name}: {k} and b differ")
        order = labels + [k for k in ("b", "t") if k in fns]
        times = {k: [] for k in order}
        for _ in range(args.rounds):
            for k in order + order[::-1]:
                times[k].append(graph_ms(fns[k], args.reps))
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        ratio = {f"b_over_{k}": mean["b"] / mean[k] for k in order
                 if k != "b"}
        result["cases"][name] = {**{f"{k}_ms": v for k, v in times.items()},
                                 **{f"{k}_mean": v for k, v in mean.items()},
                                 **ratio}
        print(f"{name} {n} elements: " + " ".join(
            f"{k} {mean[k]:.5f}" for k in order) + " ms; " + " ".join(
            f"{r.replace('_over_', '/')} {v:.3f}" for r, v in ratio.items()),
            flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
