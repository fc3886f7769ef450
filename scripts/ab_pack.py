"""Time versions of csrc/pack.cu, the scene pack's one launch, on one card.

    python3 scripts/ab_pack.py [OTHER.cu ...] [--cull CULL.cu] [--rounds 5]
        [--reps 20]

Each OTHER.cu is another version of quadray_tpu_torch/csrc/pack.cu with
the same C entry point and PackArgs (pack_launch), for example a variant
written into a directory that .gitignore lists; its "common.cuh" is found
beside it or in this checkout's csrc/. CULL.cu is a csrc/cull.cu from
before the pack kernel (the parent commit's, unpacked with git archive),
whose cull_launch writes one culling table a launch: it is timed as its
three launches for the three culling tables. Every version is built with
the port's nvcc flags (ptxas lines printed) and loaded into one process.
Cases: chip_smoke.py K2's (demo02 at frame 10 of J3's trace: the three
culling tables, the parts J3's frames re-pack, a whole pack), then
test13 and demo03 as compiled. Every version's tables must equal this
checkout's pack_parts' bitwise; then this checkout's (b), each OTHER (a1
a2 ...) and CULL (c) are timed in turns, forward then back each round:
CUDA graphs of --reps calls, device ms a call. Prints each case's means,
then one JSON line. Needs a CUDA card; exits with code 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))


def build_many(srcs, entry: str) -> list:
    """Build each source with the port's nvcc flags, their nvcc processes
    started together, and load it; prints each kernel's ptxas lines with
    its entry function."""
    from quadray_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    outs, procs = [], []
    for src in srcs:
        with open(src, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
        out = os.path.join(_build.BUILD_DIR, f"lib{entry}_other_{digest}.so")
        if not os.path.exists(out) and out not in outs:
            procs.append((src, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                 _build.CSRC, "-o", out, src], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        outs.append(out)
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n{err}")
        for line in err.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill")):
                print(f"ptxas {src}: {line.strip()}",
                      flush=True)
    return [ctypes.CDLL(out) for out in outs]


def build(src: str, entry: str) -> ctypes.CDLL:
    return build_many([src], entry)[0]


def pack_with(lib):
    """pack_parts on another build of pack.cu (the same plan and
    arguments)."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    lib.pack_launch.argtypes = [ctypes.POINTER(ck._PackArgs),
                                ctypes.c_void_p]
    lib.pack_launch.restype = ctypes.c_int

    def run(names, sc, struct, stt):
        dev = sc.s_pos.device
        plan = ck.pack_plan(names, struct, sc.l_pos.shape[0],
                            sc.tex_data.shape[0])
        args, tables = ck.pack_args(plan, sc, stt, dev)
        err = lib.pack_launch(ctypes.byref(args),
                              torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"pack_launch: CUDA error {err}")
        return tables
    return run


def cull_with(lib):
    """The three culling tables by an old csrc/cull.cu, one launch each
    (its cull_launch)."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    lib.cull_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                                + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.cull_launch.restype = ctypes.c_int

    def run(names, sc, struct, stt):
        dev, ns, nl = sc.s_pos.device, struct.ns, struct.nl
        nw = -(-ns // 32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = {}
        for table, name in enumerate(ck.CULL_PARTS):
            if name not in names:
                continue
            shape = ((4, 1, -(-ns // ck.LANES) * ck.LANES) if table == 0
                     else (ns, max(1, nl * nw) if table == 1 else 2 * nw))
            t = torch.empty(shape, dtype=torch.float32 if table == 0
                            else torch.int32, device=dev)
            out[name] = t
            if table == 1 and nl == 0:
                t.zero_()
                continue
            err = lib.cull_launch(
                table, stt.perm.data_ptr(), sc.s_bsph.data_ptr(),
                sc.s_bnd.data_ptr(), sc.l_pos.data_ptr(),
                sc.s_inv.data_ptr(), sc.s_pos.data_ptr(),
                sc.s_kind.data_ptr(), sc.s_mat.data_ptr(),
                sc.m_props.data_ptr(), sc.use_fresnel.data_ptr(),
                t.data_ptr(), ns, nl, stream)
            if err:
                raise RuntimeError(f"cull_launch: CUDA error {err}")
        return out
    return run


def cases(dev):
    """(label, scene arrays, structure, {subset: part names})."""
    from chip_smoke import K_MOVED, compiled, j3_scene
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.apps.render_cli import frame_time
    from quadray_tpu_torch.ops import cuda_kernel as ck
    subsets = {"culling": ck.CULL_PARTS, "moved": K_MOVED,
               "whole": ck.PART_NAMES}
    scene = Scene(j3_scene("demo02"), 800, 480, device=dev)
    for fi in range(1, 11):   # as chip_smoke.py cull_inputs
        sc = scene.update(frame_time(fi))
    yield "demo02 frame 10", sc, ck.scene_struct(sc), subsets
    for name in ("test13", "demo03"):
        sc = compiled(name, dev)
        yield name, sc, ck.scene_struct(sc), subsets


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="*", help="other versions of pack.cu")
    ap.add_argument("--cull", default=None,
                    help="an old cull.cu, timed for the culling tables")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20,
                    help="calls in one CUDA graph")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    from chip_smoke import graph_ms
    from quadray_tpu_torch.ops import cuda_kernel as ck
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    versions = {"b": ck.pack_parts}
    for i, src in enumerate(args.other):
        versions[f"a{i + 1}"] = pack_with(build(src, "pack"))
    if args.cull:
        versions["c"] = cull_with(build(args.cull, "cull"))
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    result = {}
    for label, sc, struct, subsets in cases(dev):
        stt = ck._struct_tensors(struct, dev)
        for what, names in subsets.items():
            want = ck.pack_parts(names, sc, struct, stt)
            live = {}
            for key, fn in versions.items():
                if key == "c" and what != "culling":
                    continue
                got = fn(names, sc, struct, stt)
                torch.cuda.synchronize()
                for n in names:
                    if not torch.equal(bits(got[n]), bits(want[n])):
                        raise AssertionError(f"{key} {label} {n} differs")
                live[key] = fn
            times = {k: [] for k in live}
            order = list(live)
            for r in range(args.rounds):
                for key in (order if r % 2 == 0 else order[::-1]):
                    times[key].append(graph_ms(
                        lambda fn=live[key]: fn(names, sc, struct, stt),
                        args.reps))
            means = {k: float(np.mean(v)) for k, v in times.items()}
            result[f"{label} {what}"] = {
                k: {"mean": means[k], "min": float(np.min(times[k])),
                    "max": float(np.max(times[k]))} for k in times}
            print(f"{label} {what} ({'+'.join(names)}), device ms a call "
                  f"(mean of {args.rounds} graphs of {args.reps}; {smi}): "
                  + ", ".join(f"{k} {means[k]:.5f} ({min(times[k]):.5f}-"
                              f"{max(times[k]):.5f})" for k in times))
    print(json.dumps({"device": smi, "versions": {
        "b": "this checkout", **{f"a{i + 1}": s for i, s in
                                 enumerate(args.other)},
        **({"c": args.cull} if args.cull else {})}, "cases": result}))


if __name__ == "__main__":
    main()
