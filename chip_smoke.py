"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --only A   # kernel build + kernel-vs-plain only
    python3 chip_smoke.py --only D   # kernel build + the training path only

Builds the Whitted kernel (quadray_tpu_torch/csrc/whitted.cu, both entry
points) with nvcc, then:
  A. kernel vs its plain PyTorch version (ops/trace.py), both on the card,
     at 200x120 on seven scenes chosen for their features and at the main
     path's 800x480 on two; max abs diff of linear colors <= 1e-5;
  B. the main path, Scene(load_scene(n), 800, 480, device="cuda")
     .render(0.0), for all 21 golden scenes: every frame within its golden
     budget (frame_cmp t_diff=3) and every scene through the kernel (its
     launch count rises); then ms/frame per scene (CUDA events, after one
     warm-up), and the plain version's ms/frame on test01, test13, demo03;
  C. one animated demo through Scene.update at t=0 and t=1, each frame
     held against the plain version's frame on the card.
  D. the training path (bench.py bench_train's configuration: test01 at
     800x480, TraceConfig(max_segments=8, stack=4), K=8, Adam lr 1e-2):
     D1 the path-record kernel vs its plain version (ops/trace.py
     trace_paths) on six scenes at 200x120 and two at 800x480, records
     equal and colors within 1e-5; D2 replay of the kernel's records vs
     the kernel's colors within 1e-5; D3 10 steps of make_train_scan_fast
     recovering surface positions moved by +0.05, toward the clean
     render: the loss falls and the paths kernel launches once per step;
     then bench_train's step (every differentiable field trains): its
     ms/step and split (paths kernel, replay fwd+bwd, Adam) beside the
     plain version's step; D4 the paths kernel vs its plain version on test13
     and demo03 at 800x480.
Any failure raises (exit code != 0). The last two lines are the kernel
table and {"ok": true, "device": {...}} as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "golden")
W, H = 800, 480
SCENES = [f"test{i:02d}" for i in range(1, 19)] + ["demo01", "demo02",
                                                    "demo03"]
# golden budgets of the JAX package (tests/test_golden.py, tests/test_tpu.py)
BUDGET = {"test11": 8, "test14": 3, "test16": 45, "demo03": 3}
PHASE_A = [(n, 200, 120) for n in ("test01", "test03", "test13", "test15",
                                    "test17", "test18", "demo01")] + [
    (n, W, H) for n in ("test01", "test13")]
PLAIN_TIMED = ["test01", "test13", "demo03"]
ATOL = 1e-5
# phase D: bench_train's training configuration (bench.py:143)
K_PATHS, TRAIN_LR, TRAIN_STEPS = 8, 1e-2, 10
# the counted run recovers the moved surfaces' positions. With every
# DIFFERENTIABLE_FIELDS entry training at lr 1e-2 (bench_train's step,
# which D3 times) the loss falls at step 1 and climbs after it: Adam
# moves each of the 17 fields by about lr a step.
RECOVER_FIELDS = ("s_pos",)
PHASE_D1 = [(n, 200, 120) for n in ("test01", "test04", "test11", "test13",
                                    "test15", "demo01")] + [
    (n, W, H) for n in ("test01", "test13")]


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of fn() over reps runs, CUDA events, after warm-up runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def compiled(name: str, dev):
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.scene import schema as S
    from quadray_tpu_torch.scene.compile import compile_scene
    sd = load_scene(name)
    return compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         device=dev)


def primary(sc, w, h):
    from quadray_tpu_torch.ops.rays import camera_rays
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, w, h, 1)
    return org, dirs, sc.cam_pov.expand(dirs.shape[0])


def phase_a(dev, cases):
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import TraceConfig, trace_rays
    cfg = TraceConfig()
    worst = 0.0
    for name, w, h in cases:
        sc = compiled(name, dev)
        org, dirs, tmin = primary(sc, w, h)
        got = ck.trace_rays_cuda(sc, org, dirs, tmin, cfg)
        want = trace_rays(sc, org, dirs, tmin, cfg)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"A {name}: kernel output not finite")
        d = (got - want).abs()
        nd = int((d.amax(dim=1) > 0).sum())
        mx = float(d.max())
        worst = max(worst, mx)
        log(f"A {name} {w}x{h}: rays={dirs.shape[0]} differing={nd} "
            f"max_abs={mx:.3e} bitwise={nd == 0}")
        if not mx <= ATOL:
            raise AssertionError(f"A {name}: max abs {mx} > {ATOL}")
        del want
        torch.cuda.empty_cache()
    return worst


def phase_b(dev):
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.utils.image import load_bmp, frame_cmp
    refs = {n: load_bmp(os.path.join(GOLDEN, f"ref_{n}.bmp")) for n in SCENES}
    scenes = {n: Scene(load_scene(n), W, H, device=dev) for n in SCENES}
    # main path, counted: the launch count is zeroed right before the run
    # and read right after; every scene must have launched the kernel
    ck.launches = 0
    frames, per_scene = {}, {}
    for n in SCENES:
        before = ck.launches
        frames[n] = scenes[n].render(0.0)
        per_scene[n] = ck.launches - before
    torch.cuda.synchronize()
    launches = ck.launches
    fails = []
    for n in SCENES:
        nbad, _ = frame_cmp(refs[n], frames[n], t_diff=3)
        ok = nbad <= BUDGET.get(n, 0) and per_scene[n] > 0
        log(f"B {n}: bad_px={nbad} budget={BUDGET.get(n, 0)} "
            f"launches={per_scene[n]}{'' if ok else '  FAIL'}")
        if not ok:
            fails.append(n)
    if fails:
        raise AssertionError(f"B: scenes outside budget or not launched: "
                             f"{fails}")
    return scenes, launches


def phase_b_timing(scenes):
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import TraceConfig, render
    cfg = TraceConfig()
    rows = {}
    for n in SCENES:
        sc, st = scenes[n].arrays, scenes[n]._struct
        ms = cuda_ms(lambda: ck.render_cuda(sc, W, H, 1, cfg, st), 5)
        plain = None
        if n in PLAIN_TIMED:
            plain = cuda_ms(lambda: render(sc, W, H, 1, cfg), 1)
            torch.cuda.empty_cache()
        rows[n] = (ms, plain)
        log(f"T {n}: kernel_ms/frame={ms:.3f} "
            f"Mray/s={W * H / ms / 1e3:.1f} plain_ms/frame="
            f"{'not timed' if plain is None else f'{plain:.1f}'}")
    return rows


def phase_c(dev):
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.models.scenes import demos
    from quadray_tpu_torch.ops.trace import TraceConfig, render, to_frame
    sc = Scene(demos.build("demo01"), W, H, device=dev)
    prev = None
    for t in (0.0, 1.0):
        arr = sc.update(t)
        frame = sc.render()
        plain = to_frame(render(arr, W, H, 1, TraceConfig()),
                         arr.use_gamma).cpu().numpy()
        torch.cuda.empty_cache()
        d = np.abs(frame.astype(np.int32) - plain.astype(np.int32)).max(-1)
        moved = -1 if prev is None else int(
            (np.abs(frame.astype(np.int32) - prev).max(-1) > 0).sum())
        log(f"C demo01 t={t}: px_vs_plain>1={int((d > 1).sum())} "
            f"px_vs_plain==1={int((d == 1).sum())} px_changed_since_prev="
            f"{moved}")
        if int((d > 1).sum()) > 0 or (d > 0).mean() > 0.005:
            raise AssertionError(f"C demo01 t={t}: kernel frame differs "
                                 "from the plain frame")
        prev = frame.astype(np.int32)


def phase_d1(dev):
    """The path-record kernel vs its plain version on the card."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import trace_paths
    cfg = train_cfg()
    worst = 0.0
    for name, w, h in PHASE_D1:
        sc = compiled(name, dev)
        org, dirs, tmin = primary(sc, w, h)
        got_c, got_p = ck.trace_paths(sc, org, dirs, tmin, cfg, K_PATHS)
        want_c, want_p = trace_paths(sc, org, dirs, tmin, cfg, K_PATHS)
        torch.cuda.synchronize()
        n_rec = int((got_p != want_p).any(dim=0).sum())
        mx = float((got_c - want_c).abs().max())
        worst = max(worst, mx)
        log(f"D1 {name} {w}x{h} K={K_PATHS}: rays={dirs.shape[0]} "
            f"record_lanes_differing={n_rec} max_abs_color={mx:.3e} "
            f"segments_recorded={int((got_p != 0).sum())}")
        if n_rec or not torch.equal(got_p, want_p):
            raise AssertionError(f"D1 {name}: {n_rec} lanes' records differ")
        if not (mx <= ATOL and bool(torch.isfinite(got_c).all())):
            raise AssertionError(f"D1 {name}: colors off by {mx}")
        del want_c, want_p
        torch.cuda.empty_cache()
    return worst


def train_cfg():
    from quadray_tpu_torch.ops.trace import TraceConfig
    return TraceConfig(max_segments=8, stack=4)


def train_task(dev):
    """bench_train's configuration: test01 at 800x480, the clean scene's
    kernel render (clipped) as the target, surfaces moved by +0.05."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    sc = compiled("test01", dev)
    cfg = train_cfg()
    org, dirs, tmin = primary(sc, W, H)
    target = torch.clamp(ck.trace_rays_cuda(sc, org, dirs, tmin,
                                            cfg), 0.0, 1.0)
    sc_p = dataclasses.replace(sc, s_pos=sc.s_pos + 0.05)
    return sc_p, target, (sc_p.cam_pos[None, :].expand(dirs.shape[0], 3),
                          dirs, tmin)


def phase_d2(dev):
    """Replay of the kernel's records reproduces the kernel's colors."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.replay import replay_color
    sc, _, rays = train_task(dev)
    cfg = train_cfg()
    cols, paths = ck.trace_paths(sc, *rays, cfg, K_PATHS)
    rep = replay_color(sc, *rays, paths, cfg)
    mx = float((rep - cols).abs().max())
    log(f"D2 test01 {W}x{H}: replay vs kernel colors max_abs={mx:.3e}")
    if not mx <= ATOL:
        raise AssertionError(f"D2: replay off the kernel by {mx}")
    return mx


def phase_d3(dev):
    """Training through make_train_scan_fast: the counted main-path run,
    then bench_train's step time and its split."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.replay import replay_color
    from quadray_tpu_torch.ops.trace import trace_paths
    from quadray_tpu_torch.parallel import train as tr
    sc, target, rays = train_task(dev)
    cfg = train_cfg()
    run_fn, opt_init = tr.make_train_scan_fast(sc, W, H, cfg=cfg,
                                               lr=TRAIN_LR, k_paths=K_PATHS)
    # main path, counted: recover the moved surface positions
    p0 = tr.extract_params(sc, RECOVER_FIELDS)
    # and no step waits for the card: a synchronising CUDA call inside
    # run_fn warns under the sync debug mode
    opt0 = opt_init(p0)
    ck.launches = ck.paths_launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            params, opt_state, losses = run_fn(p0, opt0, sc, target,
                                               TRAIN_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches, whitted = ck.paths_launches, ck.launches
    syncs = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
             if "called a synchronizing" in str(w.message)]
    losses = [float(x) for x in losses]
    log(f"D3 test01 {W}x{H} K={K_PATHS} lr={TRAIN_LR} fields="
        f"{','.join(RECOVER_FIELDS)}: losses "
        + " ".join(f"{x:.6e}" for x in losses))
    log(f"D3 launches: whitted_paths={launches} whitted={whitted}; "
        f"host syncs inside the {TRAIN_STEPS} steps: {len(syncs)}")
    if syncs:
        raise AssertionError("D3: run_fn synchronised: "
                             + " | ".join(sorted(set(syncs))))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"D3: loss did not fall: {losses}")
    if launches != TRAIN_STEPS:
        raise AssertionError(f"D3: {launches} paths-kernel launches in "
                             f"{TRAIN_STEPS} steps")
    for k, v in params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"D3: parameter {k} not finite")

    # bench_train's step, every DIFFERENTIABLE_FIELDS entry training:
    # 2 warm-up steps, then the mean of 10
    p_all = tr.extract_params(sc)
    state = [p_all, opt_init(p_all)]
    all_losses = []

    def steps(n):
        state[0], state[1], ls = run_fn(state[0], state[1], sc, target, n)
        all_losses.append(ls)

    step_ms = cuda_ms(lambda: steps(1), 10, warmup=2)
    log("D3 all-field losses (12 steps from the moved scene): "
        + " ".join(f"{float(x):.6e}" for x in torch.cat(all_losses)))

    # the split: each piece of the step alone, on the same inputs
    struct = ck.scene_struct(sc)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in state[0].items()}
    sc2 = dataclasses.replace(sc, **leaves)
    sc_fixed = dataclasses.replace(sc, **state[0])

    def loss_of(s2, paths):
        cols = replay_color(s2, *rays, paths, cfg)
        return ((torch.clamp(cols, 0.0, 1.0) - target) ** 2).mean()

    repack_ms = cuda_ms(lambda: ck.trace_paths_with_struct(
        sc2, struct, *rays, cfg, K_PATHS), 10)
    kernel_ms = cuda_ms(lambda: ck.trace_paths(
        sc_fixed, *rays, cfg, K_PATHS), 10)
    _, paths = ck.trace_paths_with_struct(sc2, struct, *rays, cfg,
                                          K_PATHS)

    def replay_fwd_bwd():
        for v in leaves.values():
            v.grad = None
        loss_of(sc2, paths).backward()

    replay_ms = cuda_ms(replay_fwd_bwd, 10)
    adam_ms = cuda_ms(lambda: tr.adam_step(leaves, state[1], TRAIN_LR), 10)

    # the plain version's step: plain trace_paths on the card, 2 steps
    def plain_step():
        lv = {k: v.detach().clone().requires_grad_(True)
              for k, v in state[0].items()}
        s2 = dataclasses.replace(sc, **lv)
        with torch.no_grad():
            _, p = trace_paths(s2, *rays, cfg, K_PATHS)
        loss_of(s2, p).backward()
        tr.adam_step(lv, state[1], TRAIN_LR)

    plain_step_ms = cuda_ms(plain_step, 2)
    plain_paths_ms = cuda_ms(lambda: trace_paths(
        sc_fixed, *rays, cfg, K_PATHS), 2)
    torch.cuda.empty_cache()
    log(f"D3 ms/step={step_ms:.3f} (paths kernel with re-pack "
        f"{repack_ms:.3f} of which kernel {kernel_ms:.3f}, replay fwd+bwd "
        f"{replay_ms:.3f}, Adam {adam_ms:.3f}) plain_ms/step="
        f"{plain_step_ms:.1f} (plain trace_paths {plain_paths_ms:.1f})")
    return launches, kernel_ms, plain_paths_ms


def phase_d4(dev):
    """The paths kernel alone vs its plain version on heavy scenes."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import trace_paths
    cfg = train_cfg()
    for name in ("test13", "demo03"):
        sc = compiled(name, dev)
        org, dirs, tmin = primary(sc, W, H)
        ms = cuda_ms(lambda: ck.trace_paths(sc, org, dirs, tmin, cfg,
                                            K_PATHS), 5)
        plain = cuda_ms(lambda: trace_paths(sc, org, dirs, tmin, cfg,
                                            K_PATHS), 1)
        torch.cuda.empty_cache()
        log(f"D4 {name} {W}x{H} K={K_PATHS}: paths kernel ms={ms:.3f} "
            f"plain ms={plain:.1f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["A", "D"], default=None,
                    help="run only phase A (build + kernel vs plain) or "
                    "only phase D (training path)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    from quadray_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library("whitted")
    log(f"kernel build and load: {time.perf_counter() - t0:.1f} s")
    ptxas = os.path.join(_build.BUILD_DIR, "whitted.ptxas.txt")
    if os.path.exists(ptxas):
        with open(ptxas) as fh:
            for line in fh:
                if "registers" in line or "stack frame" in line:
                    log(f"ptxas: {line.strip()}")
    dev = torch.device("cuda", 0)

    if args.only != "D":
        t0 = time.perf_counter()
        max_err = phase_a(dev, PHASE_A[:2] if args.only else PHASE_A)
        log(f"phase A ok ({time.perf_counter() - t0:.1f} s)")
        if args.only:
            return
        t0 = time.perf_counter()
        scenes, launches = phase_b(dev)
        log(f"phase B ok ({time.perf_counter() - t0:.1f} s)")
        rows = phase_b_timing(scenes)
        t0 = time.perf_counter()
        phase_c(dev)
        log(f"phase C ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    d_err = phase_d1(dev)
    phase_d2(dev)
    d_launches, d_ms, d_plain = phase_d3(dev)
    phase_d4(dev)
    log(f"phase D ok ({time.perf_counter() - t0:.1f} s)")
    if args.only:
        return

    ms, plain = rows["test13"]
    log("kernel table: whitted ms/plain_ms are test13 800x480 frames "
        "(render_cuda vs plain render); whitted_paths ms/plain_ms are "
        "test01 800x480 K=8 path-record traces (the training step's), "
        "launches the 10-step training run's, max_abs_err the worst "
        "color error of D1 (its records equal the plain version's)")
    log(json.dumps({"kernels": [{
        "name": "whitted", "route": "cuda",
        "source": "quadray_tpu_torch/csrc/whitted.cu",
        "replaces": "quadray_tpu/ops/pallas_kernel.py:2201",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain}, {
        "name": "whitted_paths", "route": "cuda",
        "source": "quadray_tpu_torch/csrc/whitted.cu",
        "replaces": "quadray_tpu/ops/pallas_kernel.py:2250",
        "launches": d_launches, "max_abs_err": d_err,
        "ms": d_ms, "plain_ms": d_plain}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
