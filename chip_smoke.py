"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --only A   # kernel build + kernel-vs-plain only
    python3 chip_smoke.py --only D   # kernel build + the training path only
    python3 chip_smoke.py --only E   # kernel build + the path tracer only
    python3 chip_smoke.py --only H   # kernel build + bounding-sphere culling
    python3 chip_smoke.py --only I   # kernel build + RESUME's two modes
    python3 chip_smoke.py --only J   # kernel build + the apps on the card
    python3 chip_smoke.py --only K   # kernel build + the scene pack
    python3 chip_smoke.py --only L   # kernel build + the parallel layer
    python3 chip_smoke.py --only M   # kernel build + the port's bench
    python3 chip_smoke.py --only N   # kernel build + the main path's kernel
    python3 chip_smoke.py --only O   # kernel build + a CUDA graph a frame
    python3 chip_smoke.py --only P   # kernel build + a CUDA graph a step
    python3 chip_smoke.py --only Q   # kernel build + the all-surface step
    python3 chip_smoke.py --only R   # kernel build + the fused replay
    python3 chip_smoke.py --only S   # kernel build + the all-surface gather
    python3 chip_smoke.py --only T   # kernel build + the fused all-surface
    python3 chip_smoke.py --only U   # kernel build + the update's launch
    python3 chip_smoke.py --only W   # kernel build + Schlick, deep stacks

Builds the Whitted kernel (quadray_tpu_torch/csrc/whitted.cu, all five
entry points), the conformance kernels, the scene pack's kernel
(csrc/pack.cu), replay's kernels (csrc/replay.cu: the fused replay and
the row gathers), the scene update's kernel (csrc/update.cu) and the
all-surface route's backward (csrc/diff.cu) with parallel nvcc processes,
then:
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
     the kernel's colors within 1e-5; D3 make_train_scan_fast recovering
     surface positions moved by +0.05, toward the clean render: a first
     call of one step, which captures the step's CUDA graph, then 10
     counted steps, each a replay: the loss falls, the paths kernel, the
     fused replay's forward and backward and the row sums launch once
     per step, the gather's forward never, and no step synchronises with
     the host; then bench_train's step (every differentiable field
     trains, graphed): its ms/step and split (paths kernel, replay
     fwd+bwd with the fused kernels' device ms in it, Adam, each piece
     eager) beside the plain
     version's step, and the top device ops of one step under
     torch.profiler; D4 the paths kernel vs its plain version on test13
     and demo03 at 800x480; D5 the replay gather kernels
     (ops/row_gather.py, csrc/replay.cu) against their plain versions on
     every segment of the records of test01, test13 and demo03 at 800x480
     with a seeded gradient: forward and backward bitwise, two launches
     each; their device ms a step beside the plain versions' and
     index_select + index_add_'s; two make_train_step_fast steps from one
     state bitwise equal (loss, params, Adam's moments).
  E. the path tracer (bench.py bench_pt's configuration: test18 at 800x480,
     depth 10): E1 the PT kernel vs its plain version (ops/pt.py trace_pt)
     on the card, one pass at 200x120 on test18 (the Cornell box: Fresnel
     glass, a metal, an area light), test17 (Fresnel glass: the two-branch
     pushes; texture), test15 (texture), test05 (metal mirrors), test13
     and demo03 (104 and 152 surfaces: the PT gate culls them), then
     test18 at 800x480 and its first 1, 31, 33 and 24,007 samples: seeds
     equal, radiance within 1e-5, over 5% of the lanes lit (not asked of
     the prefixes); two launches on test18 at 800x480 bitwise equal.
     Paths in test17, test15, test05, test13 and demo03 seldom reach their
     lights, so these get a seeded emission on every surface; E2 the main
     path, Scene(load_scene("test18"), 800, 480, device="cuda") with
     set_pton(True) and render_pt_pass(64), against
     golden/ref_test18_pt64.bmp under the four limits of tests/test_pt.py
     (global mean per channel < 2.5, 16x16 block mean < 3.5, p95 < 9,
     max < 18), with exactly 64 PT launches; E3 the engine's state across
     calls: render_pt_pass(1) then render_pt_pass(3) equal one
     render_pt_cuda of 4 passes, bitwise (both replay a pass program's
     graph a pass, ops/graphs.py); E4 ms per pass (mean of 20 after 2 warm-up passes,
     CUDA events), the kernel alone, the plain version's pass, the call's
     iteration count M, the nodes run and the share of issue slots a
     one-sample-per-thread layout would fill (warps of 32 consecutive
     samples, each as long as its longest); then on test13 and demo03 the
     kernel alone and ms per pass, culled and unculled, the plain count's
     share of nearest tests culled and the bound; E5 the main path on
     test13 and demo03 (the PT gate culls them): Scene(..., device="cuda")
     with set_pton(True) and render_pt_pass(64), exactly 64 PT launches,
     the sum and seeds bitwise equal to render_pt_cuda's 64 unculled
     passes; E6 the sweep that sets PT's floor: every golden scene at
     800x480, one pass culled (floor lowered to 1) against unculled,
     bitwise, and the kernel's device ms of each.
  F. two-round retirement (trace_rays_rounds): F1 the emit and resume
     kernels vs their plain versions, bitwise, at 200x120 and at 800x480
     (test14 k1=3, test13 k1=4 and 1), resume at RESUME_WARP_MAX (test13
     takes a warp per survivor at k1=4 and a thread each at k1=1) and
     forced into either mode; F2 every golden scene through the
     rounds bitwise equal to render_cuda, F3 their device times (emit,
     compaction, resume, one rounds call, against the monolithic kernel);
  G. the conformance tier: G1 the conformance kernels vs numpy and their
     plain versions, G2 the Whitted kernel on random rays, G3 device ms;
  H. bounding-sphere culling (on by default: every phase above runs the
     default TraceConfig, whose gates, ops/cuda_kernel.py cull_gates, cull
     every scene of CULL_MIN_SURFACES surfaces or more with bounding
     spheres; the training step's path records are traced unculled). H1,
     H2 and H3 lower that floor to 1, so that every golden scene culls: H1
     every golden scene at 800x480, culled against unculled kernel output,
     bitwise, in the four Whitted modes (colours; path records; emit's
     colours and state and resume's colours), and the culled frames' bad
     pixels equal to the unculled kernel's counts (test11 6, test14 2,
     test16 38, demo03 2, else 0); H2 the culled kernel against the culled
     plain version on phase A's and F1's cases; H3 the kernel's device ms
     culled and unculled on every golden scene (CUDA graphs), beside what
     the default gate picks, and the plain version's count of the surface
     tests that culling keeps and skips on test13, test14, demo02, demo03
     and test01; H4 the cooperative tail of the culled Whitted kernel
     (ops/cuda_kernel.py COOP_MAX_LIVE): every golden scene at 800x480,
     culled (the floor lowered), with the tail off (0), at its default
     and from every warp's first segment (32), in both branch modes
     (test17 and test18 push branches): the three frames bitwise equal
     with the exact bad-pixel counts, and each setting's device ms (CUDA
     graphs).
  I. RESUME's two modes (a warp per survivor, or a thread each with
     per-ray masks) and EMIT's per-ray masks after the camera segment: I1
     the counted run, the 19 single-branch golden scenes at 800x480
     through trace_rays_rounds at k1 = 4 and 1 with RESUME forced sparse,
     forced dense and at RESUME_WARP_MAX, every frame bitwise
     render_cuda's with the exact bad-pixel counts, one emit and one
     resume launch a call; I2 the sweep of RESUME's switch (warp_max) on
     the same 38 cases, resume device ms (CUDA graphs) and their sums.
  J. the interactive and developer entry points on the card, in-process:
     J1 apps/core_test (quadray_tpu_torch.apps.core_test) -b 1 -e 18 -k
     at 800x480: each run level's bad pixels equal H1's exact counts
     (test11 6, test14 2, test16 38, else 0), so the app counts 3
     failures, and its kernel vs plain difference within 1e-5 on every
     level; J2 render_cli -i on demo01-03 at 800x480, 30 frames of one
     key trace (all ten camera actions, a2 then a1, q twice, f4, f1): one
     Whitted launch per Whitted frame and one PT launch per PT frame; the
     frames it saved after a move, after a rotation and at a2 equal to
     the plain version's uint8 frame on a second Scene replayed through
     the same tokens, whose kernel frame is within 1e-5 of the plain one
     on the same compiled arrays; the final camera equal to a host replay
     of the trace through CameraController; J3 the interactive frame's
     cost, demo01-03 and test13 at 800x480 with a camera action each
     frame, two runs of 60 frames through Scene.render (one replay of the
     interactive program's graph a frame: the update, the pack and the
     frame): AVG FPS, and in the same loop ms/frame split into the update
     (the host's part: the check, the animators, the camera, sin and cos,
     the pinned write), the table build (none on the host) and the rest,
     the frame graph's device ms (CUDA events) and the card's share of
     the window it kept busy, update launches, inputs staged and capture
     ms; beside the update and the table build,
     a full compile_scene and pack_scene at 10 of the same frames' times
     and cameras; J4 float64 rays and a float64 scene raise ValueError
     before any launch; J5 plot_fresnel on the card against -c; J6 the
     incremental update held at every frame of J3's trace (61 frames a
     scene, demo01-03 and test13 at 800x480, through Scene.render): every
     SceneArrays field bitwise compile_scene's, every packed table,
     culled and unculled, bitwise pack_scene's, the interactive
     program's field and table buffers bitwise those, one replay a frame
     launching the update, the Whitted kernel and (where surfaces or
     lights move) the pack once each and staging nothing, and the frame
     uint8-equal to render_cuda's on the plain compile.
  K. the scene pack's kernel (csrc/pack.cu pack_launch, one launch for
     any subset of the ten tables, which every pack on the card makes;
     J3, J6 and D3 count its launches on the main path): K1 the launch of
     every part, of a J3 frame's moved parts and of the training step's
     seven against their plain versions (ops/cuda_kernel.py PACK_PARTS)
     on the 21 golden scenes and 10 frames of each J3 scene, bitwise, one
     launch each; K2 on demo02 at a J3 frame the device ms of the three
     culling tables in one launch, of J3's moved parts and of a whole
     pack (CUDA graphs), a call's host ms and its ms with the host's
     launch work (CUDA events), the plain parts' ms and the bound.
  L. the parallel layer (quadray_tpu_torch/parallel/, one card; blocks of
     a ray mesh on cuda:0 stand in for cards): L1 the counted main-path
     run, all 21 golden scenes at 800x480 through render_sharded_cuda on
     4 blocks, and test13 and demo03 on 1, 2, 7 and 8, each frame bitwise
     render_cuda's, within its golden budget, one Whitted launch a block;
     the plain render_sharded on test13 at 200x120 within 1e-5 of the
     kernel's; L2 the sharded fast train step at bench_train's
     configuration (every field) on 1 vs 4 blocks within JAX's
     device-count bounds (loss rtol 1e-5, params rtol 1e-4 atol 1e-6), 10
     counted make_train_scan_fast steps on 4 blocks (the loss falls, one
     paths launch a block a step), ms/step on 1 and 4 blocks; L3 the
     multi-process worker (python -m quadray_tpu_torch.dryrun): two gloo
     ranks on cuda:0, the frame bitwise render_cuda's, the fast step
     bitwise the in-process 2-block step and the params equal across
     ranks, then a world-size-1 NCCL group, then NCCL asked for
     two ranks on one card (its refusal logged); L4 dryrun_multichip(8) on
     the card, render_sharded_cuda ms/frame on test13 over 1, 2, 4 and 8
     blocks beside render_cuda's, and scaling_report over the card's
     devices and over blocks of one card (blocks on one card show what
     sharding costs, not scaling).
  N. the main path's Whitted kernel (csrc/whitted.cu whole_kernel, which
     whitted_launch runs: one thread a ray, the tables in device memory;
     culled, per-ray masks after the camera segment in a launch of at most
     WHOLE_OWN_MAX_RAYS rays): N1 each of its six instantiations (test13
     and test18, unculled and culled with and without per-ray masks) at
     1, 31, 33, 4,097 and 384,001 rays bitwise the plain trace_rays' on
     the card, one launch each, and two launches at 384,001 bitwise
     equal; test13 culled at the default floor on either side of
     WHOLE_OWN_MAX_RAYS (four and five frames' rays), with and without
     the masks; N2 each instantiation's ptxas line; N3 a frame launched
     alone against its share of a launch of 64 frames, kernel device ms
     (CUDA events), on test01, test13, demo02 and demo03.
  W. the Whitted kernels at what the jnp tracer takes of TraceConfig:
     whole_kernel with Schlick Fresnel on test17 and test18, unculled and
     with culling forced (the gate's floor lowered, as H does); test18 at
     W_DEEP (48 segments, a stack of 24, no cutoff: its stacks pass the
     16 local slots) in the device-memory scratch, unculled and culled,
     at 384,001 rays; each bitwise the plain trace_rays and two launches
     bitwise; the W_DEEP frame through Scene.render (the interactive
     program's capture and a replay uint8-equal to render_cuda +
     to_frame) and render_sharded_cuda on 2 blocks (bitwise render_cuda);
     the path records, emit and the rounds at a stack of 40 on test13
     (single-branch: no stack read) bitwise their plain versions; each
     case's kernel device ms (CUDA graphs) beside the default cfg's.
  M. the port's bench (quadray_tpu_torch/bench.py): M1 its cells in this
     process, each counted: test01's K-frame batches (K = 8 and 64) in
     one Whitted launch each, frames 0 and K-1 bitwise render_cuda's at
     the bench's TraceConfig, then bench_scene("test01") (one launch a
     batch: 2 x (1 + REPS) plus 1 + MAIN_PATH_CALLS main-path frames),
     bench_pt (one PT launch a pass) and bench_train (one paths launch a
     step); M2 python -m quadray_tpu_torch.bench in full as a
     subprocess: exit code 0, its last line with the JAX bench's metric,
     all ten scenes' entries with bad_px within budget and positive
     numbers, pt_test18 and train_test01 positive, the device entry
     naming the card and its power limit; the line printed with an M2
     prefix; M3 each scene's marginal ms/frame beside phase B's
     render_cuda ms/frame and main_path_ms_per_frame (printed, not held).
  O. one CUDA graph a frame and a pass (quadray_tpu_torch/ops/graphs.py:
     Scene.render replays the scene's interactive program (phase U),
     render_pt_pass and render_pt_cuda a pass program a pass): O1 the 21 golden scenes
     through Scene.render, the capture frame and a replayed one
     uint8-equal to render_cuda + to_frame, one launch each, the capture
     ms; O2 J3's trace on demo01-03 and test13, every frame uint8-equal
     to render_cuda + to_frame, one launch a frame, every returned frame
     unchanged at the end, the inputs copied a frame, and demo02 at fsaa
     2 (a new program); O3 E2's and E5's 64 passes (test18; test13 and
     demo03 culled) through render_pt_pass, one PT launch a pass, sum,
     seeds and frame bitwise pt_passes' from the same seeds, a test18
     checkpoint after 32 graphed passes resumed in a new Scene bitwise
     the 64 eager passes, and render_pt_cuda's 4 graphed passes bitwise
     the eager ones; O4 eager against graphed in this process, a b b a:
     J3's split, main_path_ms_per_frame on the bench's ten scenes and
     bench_pt's ms/spp-pass; O5 one torch.profiler window each of an
     interactive frame (demo02) and a PT pass (test18), eager and
     graphed: host launch calls, device ops and ms, busy share.
  P. one CUDA graph a training step (parallel/train.py StepProgram, the
     graph route of make_train_scan_fast and make_train_step_fast): P1 on
     bench_train's task (test01 800x480, K=8, every field) on 1 block and
     on 4 blocks of cuda:0, 10 graphed steps against 10 eager ones
     (eager=True) from one state, loss, params and Adam's moments
     bitwise, the same launch counts, the first call's warm-up and
     capture ms and the memory the graph keeps; P2 ms/step eager against
     graphed, a b b a, calls of 10 steps, on 1 and 4 blocks, and one-step
     calls of each route under torch.profiler: host launch calls, device
     ops and ms, busy share.
  S. the all-surface step's row gather (ops/trace.py Gathered over
     ops/row_gather.py RowGather, csrc/replay.cu row_gather_launch and
     row_gather_backward_launch) at the route's own shapes: the row ids
     of each of the 8 bounces of trace_rays_diff on test17 and test18 at
     800x480 (the step's moved scene), a seeded gradient: forward bitwise
     gather_plain and backward bitwise row_sum_plain, two launches each;
     device ms of a step's gathers (CUDA graphs) beside the bound, the
     plain versions' ms and index_select + index_put_ with accumulate
     (what autograd ran for the lookups before the gather). The step no
     longer takes this route (phase T); trace_rays_diff is its reference.
  T. the all-surface route in one forward and one backward launch
     (ops/diff.py trace_rays_fused: csrc/whitted.cu whitted_tape_launch,
     csrc/diff.cu diff_backward_launch, which sums the table rows' and the
     lights' gradients itself, and csrc/replay.cu's light sums) on test15,
     test17 and test18 at 800x480 (the step's moved scene), a seeded
     gradient of the colors: the tape launch's colors bitwise the Whitted
     kernel's (unculled) and forward_plain's, its tape bitwise
     forward_plain's in every word of the tape's contract (diff.tape_read:
     the flags word of every ray-bounce, the rest of a hit; the kernel
     writes no other); the backward, run on the kernel's own tape, its
     partials through the light sums bitwise replay._block_sums of
     backward_rows_plain's tiles on forward_plain's; the wide
     mode forced (backward_kernel's threshold argument 0): its row
     gradients and ids bitwise the plain wide mode's, its four gradients
     through the row sums bitwise backward_plain's wide ones; two launches
     each bitwise; every field's gradient within T_GRAD_RTOL of
     autograd's trace_rays_diff on the card; then T_EXTRA, Schlick
     Fresnel and a stack past 16 slots (T_DEEP) on test17 and test18, the
     same checks but the wide mode's and the Whitted kernel's; device ms
     of the forward (with its pack launch), of the backward launch and of
     the light sums (CUDA graphs) beside the bounds (bytes and FP32
     operations), the plain versions' ms (CUDA events), the backward's
     blocks an SM, the forward's warp-bounces and the share of their
     lanes active and with a hit; then T_SMEM_SCENE (demo03) at the step's cfg, whose
     accumulators (79 KB a block) need the shared-memory opt-in past
     48 KB: the tape launch and the backward launch with its light sums
     bitwise their plain versions, two launches each.
  Q. the all-surface training step (parallel/train.py make_train_step,
     the counterpart of the JAX make_train_step's jitted step_fn; the
     fused route of phase T, one pack, tape, backward and light-sum
     launch a block, no row sums) as one
     CUDA graph, on the two golden scenes where a material both reflects
     and transmits, which the fast steps refuse (test17, test18), every
     differentiable field, TraceConfig(max_segments=8, stack=4): Q1
     test17 at 64x40, one graphed step on the card against the eager
     step on the CPU from the same arrays, loss within 1e-4 relative,
     params within 1e-4; Q2 test17 and test18 at 800x480 on 1 and 4
     blocks of cuda:0, from one state: 3 eager one-step calls chained, a
     graphed call of 3 steps (warm-up, capture, replays) bitwise the
     chain, then two graphed one-step calls and (the program dropped) an
     eager one, each bitwise the chain's first step; ms/step in that
     order (a b b a), the capture's ms, the graph's pool and the peak
     memory, and on test17 1 block a profiler window of each route (host
     launch calls, device ops and ms, busy share, top ops; each with the
     profiler's warm-up step; the graphed one must list the fused
     route's kernels) and of the eager step with trace_rays_diff in its
     place (the autograd route before this one, its window split by
     lookup family: ops/trace.py's record_function ranges); each graph
     records one pack, tape forward, backward and light-sum launch a
     block, and the fused route's counters, set to 0 before the phase,
     are read after it (the row sums' stay 0); Q4 the step with Schlick
     Fresnel on test17 and with T_DEEP's stack on test18, 800x480, 1 and
     4 blocks, graphed bitwise eager, the same launches a graph; Q3
     BASELINE.json config 5's frame, 1920x1080: make_train_step on test17
     over the fewest blocks of cuda:0 whose memory at Q2's peak a ray
     fits in 85% of the card (doubled while the eager step does not fit)
     and make_train_scan_fast on demo03 at K=8 on one block, 2 steps each
     graphed bitwise eager, ms/step, pool and peak.
  U. the scene update as one launch (csrc/update.cu update_launch,
     ops/update.py; the counterpart of the JAX engine's _update_jit) and
     the interactive frame as one CUDA graph (ops/graphs.py
     InteractiveProgram: the copy of the moving nodes' values from pinned
     memory, the update, the pack of the tables its fields feed, the
     Whitted frame): U1 the launch bitwise its plain version
     (SceneStructure.moved_fields) on the 21 golden scenes and at every
     frame of J3's trace on demo01-03 and test13, every group at once and
     each alone, one launch each; U2 the program's frames uint8-equal to
     render_cuda on the plain compile (J6, which runs Scene.render; with
     --only U, J6 again under this label); U4 the launch's device ms
     (CUDA graphs), host ms, the plain version's ms and the bound on J3's
     scenes. This route's split, launches, inputs staged and capture ms
     are J3's, its profiler window O5's graphed frame; the parent
     commit's route is measured against it by scripts/ab_interactive.py.
  R. the fused replay (csrc/replay.cu replay_forward_launch and
     replay_backward_launch, ops/replay.py replay_color_fused, whose
     plain version is replay_plain): R1 on the path-record kernel's own
     records of test01, test13 and demo03 at 800x480, K=8, with a seeded
     colour gradient: colors, saved state and ids bitwise forward_plain's
     and the colors bitwise autograd's replay_color's; the row gradients,
     the lights' and ambient's sums and the tables' gradients bitwise
     backward_plain's; two launches bitwise; every float field's
     gradient within 1e-3 of its largest against autograd's
     replay_color; device ms (CUDA graphs) of the forward, the backward
     and the row sums beside their bounds, the row sums beside
     index_add_, the plain version's and autograd's ms; R2
     one make_train_step_fast step on each route launches the paths
     kernel, the fused forward and backward and the row sums once each
     and the gather's forward never.
Any failure raises (exit code != 0). The last two lines are the kernel
table and {"ok": true, "device": {...}} as JSON; each kernel's bound_ms
is the larger of its bytes over 3.35 TB/s and the FP32 operations of the
surface tests its inputs need (counted by the plain version on the same
inputs, ops/trace.py count_work, priced by OPS_*) over 67 TFLOP/s.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
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
# D1's ray counts at the edges of the path-record kernel's persistent grid
# and of a ragged warp: one ray, a warp less one, a warp and one more, 128
# warps and one more ray, a frame and one more
PATHS_EDGES = (1, 31, 33, 4097, W * H + 1)
# D1: test13 with this many small spheres added (crowded_scene): with 384
# its tables but cl_f fit in the path-record kernel's shared-memory budget
# (cl_f stays in device memory), with 640 they do not fit (the
# instantiation that reads device memory)
CROWDS = (384, 640)
# D4: the walks of the path-record kernel on the training step's scene
# and the two heavy ones
PHASE_D4 = ("test01", "test13", "demo03")
# D5: the scenes whose path records the replay gather kernels are held
# on (4, 104 and 152 surfaces: one band of the backward, two, three), the
# launches of one timing, and the bytes a ray of one segment moves:
# forward 4 + 1 B of ids in, 29 floats and 3 ints out; backward 29
# gradient floats and two ids in (csrc/replay.cu)
PHASE_D5 = ("test01", "test13", "demo03")
D5_REPS = 20
GATHER_FWD_BYTES, GATHER_BWD_BYTES = 5 + 29 * 4 + 3 * 4, 29 * 4 + 2 * 4
# phase R: the fused replay (csrc/replay.cu replay_forward_launch and
# replay_backward_launch) on the path-record kernel's own records of these
# scenes (4, 104 and 152 surfaces) at 800x480, K=8, every float field; the
# launches of one timing; autograd's replay_color is held within
# tests/test_torch_replay.py's GRAD_RTOL_ALL of each field's largest
PHASE_R = ("test01", "test13", "demo03")
R_REPS = 20
R_GRAD_RTOL = 1e-3
R_FIELDS = ("s_pos", "s_inv", "s_sci", "s_scjh", "s_sciw", "m_col", "m_dff",
            "m_spc", "m_pow", "m_rfl", "m_trn", "m_rfr", "m_ext", "l_pos",
            "l_col", "l_on", "l_cnt", "l_lnr", "l_qdr", "amb_col")
# FP32 operations of one live ray segment, counted from csrc/replay.cu
# (each + - * / sqrt rsqrt exp log one): the forward's segment with its
# Fresnel and continuation, and each light's term; the backward recomputes
# both and runs an adjoint about twice as long (an estimate)
R_SEG_OPS, R_LIGHT_OPS, R_BWD_FACTOR = 230, 60, 3
# phase E: bench_pt's configuration (bench.py:199-244)
PT_DEPTH, PT_PASSES, PT_TIMED = 10, 64, 20
# (scene, width, height, seed of the added emission or None)
PHASE_E1 = [("test18", 200, 120, None), ("test17", 200, 120, 17),
            ("test15", 200, 120, 15), ("test05", 200, 120, 5),
            ("test13", 200, 120, 13), ("demo03", 200, 120, 3),
            ("test18", W, H, None)]
# E4-E5: the heavy scenes the PT gate culls (104 and 152 surfaces), whose
# paths seldom reach their lights (a pass at 64x40 on the CPU lit 0.08%
# of the lanes of each; E1 adds emission to them)
PT_HEAVY = ("test13", "demo03")
PT_HEAVY_REPS = 10
# E1: prefixes of test18's 800x480 samples for the edges of the PT
# kernel's work queue: one sample, a warp less or more one lane, and a
# count that is not a whole number of blocks, each under the thread count
# of the persistent grid (132 SMs x 5 blocks x 128 threads)
PT_PREFIXES = (1, 31, 33, 24007)
# E1: the least share of lanes that must gather light, so that a wrong
# branch or pop shows (one test18 pass at 100x60 on the CPU lit 8% of its
# lanes; test17, test15, test05 with the added emission 48%, 46%, 100%)
PT_LIT = 0.05
# phase N: the main path's Whitted kernel (csrc/whitted.cu whole_kernel).
# Its six instantiations (CAN_PUSH x unculled, or culled with or without
# per-ray masks) all run on these scenes, a single-branch scene and one
# that pushes branches, each unculled and culled (the floor lowered) with
# per-ray masks after the camera segment (own_min 0) and without (own_min
# above any scene's surfaces), at a ragged warp's and the grid's edge ray
# counts (PATHS_EDGES)
PHASE_N1 = ("test13", "test18")
N_GATES = (("unculled", None), ("own", 0), ("warp", 1 << 20))
# and test13 culled at the default own_min in launches of this many
# frames' rays, on either side of WHOLE_OWN_MAX_RAYS (four frames)
N1_FRAMES = (4, 5)
# N3: a frame launched alone against its share of a launch of 64 frames
# (the bench's K_BIG; quadray_tpu_torch/bench.py), kernel alone
PHASE_N3 = ("test01", "test13", "demo02", "demo03")
N3_FRAMES, N3_REPS = 64, 5
# phase W: what the Whitted modes take of TraceConfig as the jnp tracer
# does: Schlick Fresnel on the scenes with Fresnel glass (whole_kernel,
# unculled and with the gate's floor lowered to cull them); W_DEEP's
# stacks past the 16 local slots (no throughput cutoff: every glass hit
# both reflects and transmits, so test18's stacks reach 23 at 24x16) in
# the device-memory scratch, through trace_rays_cuda, Scene.render's
# interactive program and the sharded render on W_SHARDS blocks; and the
# single-branch modes (path records, emit, resume) at a stack of W_STACK,
# which they never read, on W_SINGLE; device ms (CUDA graphs) of W_REPS
# launches beside the default cfg's
W_SCHLICK = ("test17", "test18")
W_DEEP = dict(depth=24, max_segments=48, stack=24, cutoff=0.0)
W_DEEP_SCENE = "test18"
W_STACK, W_SINGLE, W_SHARDS, W_REPS = 40, "test13", 2, 5
# golden/ref_test18_pt64.bmp limits (tests/test_pt.py:43-53)
PT_LIMITS = {"global_mean": 2.5, "block_mean": 3.5, "block_p95": 9.0,
             "block_max": 18.0}
# phase F: (scene, width, height, k1) of the emit/resume kernels against
# their plain versions; test14 (152 surfaces) keeps 56% of its rays alive
# at segment 2 and 16% at segment 3, test08 50% at 2, test16 (93
# surfaces, clip programs) a few percent at 2; test13 (104 surfaces) at
# the main path's 800x480 keeps 1,002 rays after 4 segments (fewer than
# RESUME_WARP_MAX: a warp per survivor) and 132,480 after 1 (a thread
# each). Resume runs each case at RESUME_WARP_MAX and forced into either
# mode (F1_RESUME_MODES)
PHASE_F1 = [("test08", 200, 120, 2), ("test14", 200, 120, 2),
            ("test16", 200, 120, 2), ("test14", W, H, 3),
            ("test13", W, H, 4), ("test13", W, H, 1)]
# (name, RESUME_WARP_MAX: None the default, "n" every ray, so always a
# warp per survivor)
F1_RESUME_MODES = (("default", None), ("sparse", "n"), ("dense", 0))
# F3: the monolithic kernel against the two rounds, heavy scenes
PHASE_F3 = ["test13", "test14", "demo02", "demo03"]
F3_ROUNDS, F3_REPS = 4, 10
# phase H: the exact bad-pixel counts of the unculled kernel's frames
# (and of the JAX package on the CPU), which the culled frames must keep
GOLDEN_BAD = {"test11": 6, "test14": 2, "test16": 38, "demo03": 2}
PHASE_H3 = ["test13", "test14", "demo02", "demo03", "test01"]
# phase G: the conformance kernels' timing size (384,000 elements, one
# 800x480 frame's rays) and launches per timing
G_ROWS, G_REPS = W * H // 128, 50
# FP32 operations (mul, add, sub, div, sqrt; compares not counted) of one
# surface test in quadray_tpu_torch/csrc/whitted.cu, counted from its
# source: a plane's nearest or shadow test; a quadric's (or two-plane's)
# shadow test and its nearest test, which also forms both roots' gradients
OPS_PLANE, OPS_QUADRIC_SHADOW, OPS_QUADRIC = 48, 100, 112
# H100 SXM: HBM bytes/s and FP32 FLOP/s outside the tensor cores (NVIDIA's
# data sheet)
HBM_RATE, FP32_RATE = 3.35e12, 67e12


def log(*a):
    print(*a, flush=True)


def graph_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over reps calls captured in one CUDA graph
    and replayed (CUDA events around a replay, after a warm-up replay):
    the time of the launches without the host's time between them, which
    is most of a small kernel's wall time."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    del g
    return ms


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


def phase_a(dev, cases, label="A"):
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
        log(f"{label} {name} {w}x{h}: rays={dirs.shape[0]} differing={nd} "
            f"max_abs={mx:.3e} bitwise={nd == 0}")
        if not mx <= ATOL:
            raise AssertionError(f"{label} {name}: max abs {mx} > {ATOL}")
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


def whitted_bound(dev, name):
    """The Whitted kernel's bound on one 800x480 frame of a scene: 28
    bytes in and 12 out per ray; the surface tests its rays need."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import TraceConfig, trace_rays
    sc = compiled(name, dev)
    stats = {}
    trace_rays(sc, *primary(sc, W, H), TraceConfig(), stats)
    torch.cuda.empty_cache()
    bound, by = bound_ms(W * H * 40, surface_ops(ck.scene_struct(sc), stats))
    log(f"T {name} work: {work_line(stats)}, bound_ms={bound:.4f} ({by})")
    return bound, by


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


def crowded_scene(dev, extra: int = CROWDS[-1]):
    """test13 with `extra` small spheres in a grid between the camera and
    the scene, every fourth a mirror (a single-branch scene still), to
    outgrow the path-record kernel's shared-memory budget
    (ops/cuda_kernel.py paths_staging): with CROWDS' 384 cl_f stays in
    device memory, with 640 every table does (the instantiation that reads
    device memory)."""
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.scene import schema as S
    from quadray_tpu_torch.scene.compile import compile_scene
    sd = load_scene("test13")
    plain = S.Material(tex=S.Texture(color=0x80C040), dff=0.8, spc=0.3,
                       pow=8.0)
    mirror = S.Material(tex=S.Texture(color=0xC0C0C0), dff=0.2, rfl=0.6)
    side = np.ceil(np.cbrt(extra)).astype(int)
    balls = [S.obj(S.Sphere(rad=0.15, side_outer=S.Side(
        material=mirror if k % 4 == 0 else plain)),
        pos=(-8.0 + 16.0 * (k % side) / side,
             -5.0 + 10.0 * (k // side % side) / side,
             1.0 + 8.0 * (k // side // side) / side))
        for k in range(extra)]
    root = S.Array(objects=list(sd.root.objects) + balls,
                   relations=list(sd.root.relations))
    return compile_scene(S.SceneDef(root=root, opts=S.OPTS_FULL & ~sd.opts),
                         device=dev)


def paths_case(label, sc, org, dirs, tmin, cull: bool):
    """One D1 case: the path-record kernel, culled as the training config's
    gate says (cull) or unculled (trace_paths_with_struct, the walk the
    training step runs), against its plain version with the same culling
    setting: records equal, colours within ATOL; returns the colours' max
    abs difference."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import trace_paths
    cfg = train_cfg() if cull else train_cfg()._replace(cull=False)
    before = ck.paths_launches
    if cull:
        got_c, got_p = ck.trace_paths(sc, org, dirs, tmin, cfg, K_PATHS)
    else:
        got_c, got_p = ck.trace_paths_with_struct(
            sc, ck.scene_struct(sc), org, dirs, tmin, cfg, K_PATHS)
    want_c, want_p = trace_paths(sc, org, dirs, tmin, cfg, K_PATHS)
    torch.cuda.synchronize()
    n_rec = int((got_p != want_p).any(dim=0).sum())
    mx = float((got_c - want_c).abs().max())
    log(f"D1 {label} {'culled' if cull else 'unculled'} K={K_PATHS}: "
        f"rays={dirs.shape[0]} record_lanes_differing={n_rec} "
        f"max_abs_color={mx:.3e} segments_recorded="
        f"{int((got_p != 0).sum())}")
    if ck.paths_launches != before + 1:
        raise AssertionError(f"D1 {label}: not one paths launch")
    if n_rec or not torch.equal(got_p, want_p):
        raise AssertionError(f"D1 {label}: {n_rec} lanes' records differ")
    if not (mx <= ATOL and bool(torch.isfinite(got_c).all())):
        raise AssertionError(f"D1 {label}: colors off by {mx}")
    return mx


def edge_rays(sc, n: int):
    """The first n camera rays of the 800x480 frame, the frame's first ray
    again after them where n is past it."""
    org, dirs, tmin = primary(sc, W, H)
    idx = torch.arange(n, device=dirs.device) % dirs.shape[0]
    return org, dirs[idx].contiguous(), tmin[idx].contiguous()


def phase_d1(dev):
    """The path-record kernel vs its plain version on the card, both walks
    (culled by the training config's gate, and unculled, the walk the
    training step runs), both instantiations (the tables in shared memory,
    and on crowded_scene in device memory), at PATHS_EDGES' ray counts;
    two launches bitwise equal."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    worst = 0.0
    for name, w, h in PHASE_D1:
        sc = compiled(name, dev)
        for cull in (True, False):
            worst = max(worst, paths_case(f"{name} {w}x{h}", sc,
                                          *primary(sc, w, h), cull))
        torch.cuda.empty_cache()
    for extra in (0,) + CROWDS:
        sc = crowded_scene(dev, extra) if extra else compiled("test13", dev)
        name = f"test13+{extra}" if extra else "test13"
        st = ck.paths_staging(ck.scene_struct(sc))
        log(f"D1 {name}: {ck.scene_struct(sc).n_real} surfaces, tables in "
            + ("shared memory, " + ", ".join(
                f"{k} {b}" for k, b in zip(ck.PATHS_TABLES, st.bytes))
               + f" B, {st.total} B a block" if st else
               f"device memory (over {ck.PATHS_SMEM_BYTES} B)"))
        if (st is None, st is not None and st.bytes[2] == 0) != (
                extra == CROWDS[1], extra == CROWDS[0]):
            raise AssertionError(f"D1 {name}: the wrong instantiation")
        for n in PATHS_EDGES:
            for cull in (True, False):
                worst = max(worst, paths_case(f"{name} n={n}", sc,
                                              *edge_rays(sc, n), cull))
            torch.cuda.empty_cache()
        rays = primary(sc, W, H)
        for cull in (True, False):
            cfg = train_cfg() if cull else train_cfg()._replace(cull=False)
            runs = [ck.trace_paths(sc, *rays, cfg, K_PATHS) for _ in (0, 1)]
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(*runs))
            log(f"D1 {name} {W}x{H} {'culled' if cull else 'unculled'}: "
                f"two launches bitwise equal: {same}")
            if not same:
                raise AssertionError(f"D1 {name}: two launches differ")
    return worst


def train_cfg():
    from quadray_tpu_torch.ops.trace import TraceConfig
    return TraceConfig(max_segments=8, stack=4)


def train_task(dev, name: str = "test01", w: int = W, h: int = H):
    """bench_train's configuration: test01 at 800x480, the clean scene's
    kernel render (clipped) as the target, surfaces moved by +0.05 (on
    another scene and frame for phase Q; on the CPU the plain render)."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    sc = compiled(name, dev)
    cfg = train_cfg()
    org, dirs, tmin = primary(sc, w, h)
    target = torch.clamp(ck.trace_rays_cuda(sc, org, dirs, tmin,
                                            cfg), 0.0, 1.0)
    sc_p = dataclasses.replace(sc, s_pos=sc.s_pos + 0.05)
    return sc_p, target, (sc_p.cam_pos[None, :].expand(dirs.shape[0], 3),
                          dirs, tmin)


def phase_d2(dev):
    """Replay of the kernel's records reproduces the kernel's colors."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.replay import replay_color_fused
    sc, _, rays = train_task(dev)
    cfg = train_cfg()
    cols, paths = ck.trace_paths(sc, *rays, cfg, K_PATHS)
    with torch.no_grad():
        rep = replay_color_fused(sc, *rays, paths, cfg)
    mx = float((rep - cols).abs().max())
    log(f"D2 test01 {W}x{H}: replay vs kernel colors max_abs={mx:.3e}")
    if not mx <= ATOL:
        raise AssertionError(f"D2: replay off the kernel by {mx}")
    return mx


def phase_d3(dev):
    """Training through make_train_scan_fast: the counted main-path run,
    then bench_train's step time and its split."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import replay as rp
    from quadray_tpu_torch.ops import row_gather as rg
    from quadray_tpu_torch.ops.replay import replay_color_fused
    from quadray_tpu_torch.ops.trace import trace_paths
    from quadray_tpu_torch.parallel import train as tr
    sc, target, rays = train_task(dev)
    cfg = train_cfg()
    run_fn, opt_init = tr.make_train_scan_fast(sc, W, H, cfg=cfg,
                                               lr=TRAIN_LR, k_paths=K_PATHS)
    # main path, counted: recover the moved surface positions
    p0 = tr.extract_params(sc, RECOVER_FIELDS)
    opt0 = opt_init(p0)
    route = run_fn.route(sc)
    if route != "graph":
        raise AssertionError(f"D3: one block on the card took the {route} "
                             "route")
    # the program's first call runs its first step and captures the step,
    # before the window (a capture may synchronise); then no step waits
    # for the card: a synchronising CUDA call inside run_fn warns under
    # the sync debug mode
    t0 = time.perf_counter()
    p0, opt0, first = run_fn(p0, opt0, sc, target, 1)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    prog = next(iter(run_fn.programs.values()))
    log(f"D3 route {route}: the first call (its step and the capture of "
        f"the step: {prog.replay.ms:.1f} ms of {first_ms:.1f}, loss "
        f"{float(first[0]):.6e}) ran before the sync-debug window; the "
        f"{TRAIN_STEPS} counted steps are replays of its graph")
    ck.launches = ck.paths_launches = ck.pack_launches = 0
    rg.launches = rg.backward_launches = 0
    rp.launches = rp.backward_launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            params, opt_state, losses = run_fn(p0, opt0, sc, target,
                                               TRAIN_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches, whitted, packs = ck.paths_launches, ck.launches, \
        ck.pack_launches
    gathers = (rg.launches, rg.backward_launches)
    fused = (rp.launches, rp.backward_launches)
    syncs = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
             if "called a synchronizing" in str(w.message)]
    losses = [float(x) for x in losses]
    log(f"D3 test01 {W}x{H} K={K_PATHS} lr={TRAIN_LR} fields="
        f"{','.join(RECOVER_FIELDS)}: losses "
        + " ".join(f"{x:.6e}" for x in losses))
    log(f"D3 launches (replays counted as their capture's): "
        f"whitted_paths={launches} whitted={whitted} pack={packs} "
        f"replay forward={fused[0]} backward={fused[1]} "
        f"replay_gather forward={gathers[0]} row sums={gathers[1]}; "
        f"host syncs inside the {TRAIN_STEPS} steps: {len(syncs)}")
    if syncs:
        raise AssertionError("D3: run_fn synchronised: "
                             + " | ".join(sorted(set(syncs))))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"D3: loss did not fall: {losses}")
    if launches != TRAIN_STEPS or packs != TRAIN_STEPS:
        raise AssertionError(f"D3: {launches} paths-kernel and {packs} "
                             f"pack launches in {TRAIN_STEPS} steps")
    if fused != (TRAIN_STEPS,) * 2 or gathers != (0, TRAIN_STEPS):
        raise AssertionError(f"D3: replay launches {fused}, gather forward "
                             f"and row sums {gathers}, expected "
                             f"{TRAIN_STEPS} fused forward and backward "
                             f"and row sums, no gather forward")
    for k, v in params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"D3: parameter {k} not finite")

    # bench_train's step, every DIFFERENTIABLE_FIELDS entry training
    # (a program of its own): 2 warm-up steps (the first captures), then
    # the mean of 10 graph replays, a call each
    p_all = tr.extract_params(sc)
    state = [p_all, opt_init(p_all)]
    all_losses = []

    def steps(n):
        state[0], state[1], ls = run_fn(state[0], state[1], sc, target, n)
        all_losses.append(ls)

    step_ms = cuda_ms(lambda: steps(1), 10, warmup=2)
    log("D3 all-field losses (12 steps from the moved scene): "
        + " ".join(f"{float(x):.6e}" for x in torch.cat(all_losses)))
    profile_step(lambda: steps(1), step_ms)

    # the split: each piece of the step alone, on the same inputs, eager
    struct = ck.scene_struct(sc)
    flat = tr.FlatState(state[0], dev)
    flat.stage(state[0], state[1])
    leaves = flat.leaves
    sc2 = dataclasses.replace(sc, **leaves)
    sc_fixed = dataclasses.replace(sc, **state[0])

    def loss_of(s2, paths):
        cols = replay_color_fused(s2, *rays, paths, cfg)
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
    grad = torch.zeros_like(flat.p)
    adam_ms = cuda_ms(lambda: flat.adam(grad, TRAIN_LR), 10)
    tabs = fused_tables(sc2)
    fwd = rp._forward_kernel(*tabs, *rays[:2], paths)
    g_cols = torch.ones((W * H, 3), device=dev)
    g_fwd = graph_ms(lambda: rp._forward_kernel(*tabs, *rays[:2], paths),
                     D5_REPS)
    g_bwd = graph_ms(lambda: rp._backward_kernel(g_cols, *tabs, paths,
                                                 fwd[1], fwd[2]), D5_REPS)
    del fwd

    # the plain version's step: plain trace_paths on the card, 2 steps
    def plain_step():
        st = tr.FlatState(state[0], dev)
        st.stage(state[0], state[1])
        s2 = dataclasses.replace(sc, **st.leaves)
        with torch.no_grad():
            _, p = trace_paths(s2, *rays, cfg, K_PATHS)
        g = torch.autograd.grad(loss_of(s2, p), list(st.leaves.values()),
                                allow_unused=True)
        st.adam(torch.cat([(torch.zeros_like(v) if x is None else x)
                           .reshape(-1) for v, x in zip(st.leaves.values(),
                                                        g)]), TRAIN_LR)

    stats = {}
    trace_paths(sc_fixed, *rays, cfg, K_PATHS, stats)
    # 28 bytes in, 12 out and a K-word record out per ray
    p_bound = bound_ms(W * H * (40 + 4 * K_PATHS), surface_ops(struct, stats))
    log(f"D3 paths kernel work: {work_line(stats)}, bound_ms="
        f"{p_bound[0]:.4f} ({p_bound[1]})")
    plain_step_ms = cuda_ms(plain_step, 2)
    plain_paths_ms = cuda_ms(lambda: trace_paths(
        sc_fixed, *rays, cfg, K_PATHS), 2)
    torch.cuda.empty_cache()
    log(f"D3 ms/step={step_ms:.3f} (graph replays, a call a step; the "
        f"split, each piece eager: paths kernel with re-pack "
        f"{repack_ms:.3f} of which kernel {kernel_ms:.3f}, replay fwd+bwd "
        f"{replay_ms:.3f} of which the fused forward {g_fwd:.4f} and "
        f"backward with its row sums {g_bwd:.4f} (device, CUDA graphs), Adam "
        f"{adam_ms:.3f}) plain_ms/step={plain_step_ms:.1f} (plain "
        f"trace_paths {plain_paths_ms:.1f})")
    return (launches, kernel_ms, plain_paths_ms, p_bound, gathers + fused,
            packs)


def profile_step(step, step_ms: float, top: int = 10):
    """One training step under torch.profiler: the device kernels' time
    and launches, the share of the unprofiled step (step_ms) the card is
    busy, and the top kernels by device time (names cut to 80
    characters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type != DeviceType.CPU),
                     key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"D3 profiler, one all-field step: {sum(e.count for e in kernels)} "
        f"kernel launches, {total:.3f} ms of device time, "
        f"{100 * total / step_ms:.1f}% of the {step_ms:.3f} ms step; top "
        "kernels: " + "; ".join(
            f"{e.key[:80]} {e.self_device_time_total / 1e3:.3f} ms "
            f"x{e.count}" for e in kernels[:top]))


def phase_d4(dev):
    """The paths kernel vs its plain version in both walks on PHASE_D4's
    scenes: culled as the training config's gate says (trace_paths) and
    unculled (trace_paths_with_struct, the walk the training step runs),
    each through its wrapper (the pack cached; the unculled wrapper packs
    afresh, as the step does) beside the bound of the work the plain
    version counts (as D3's: the same for both walks, which only skip
    tests that cannot hit). Returns {scene: {walk: (ms, bound)}}."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import trace_paths
    out = {}
    for name in PHASE_D4:
        sc = compiled(name, dev)
        struct = ck.scene_struct(sc)
        org, dirs, tmin = primary(sc, W, H)
        walks = {
            "culled": lambda: ck.trace_paths(sc, org, dirs, tmin,
                                             train_cfg(), K_PATHS),
            "unculled": lambda: ck.trace_paths_with_struct(
                sc, struct, org, dirs, tmin, train_cfg(), K_PATHS)}
        stats = {}
        plain = cuda_ms(lambda: trace_paths(sc, org, dirs, tmin, train_cfg(),
                                            K_PATHS, stats), 1, 0)
        bound = bound_ms(W * H * (40 + 4 * K_PATHS),
                         surface_ops(struct, stats))
        gate = ck.cull_gates(struct, train_cfg()).flags != 0
        out[name] = {}
        for walk, fn in walks.items():
            ms = cuda_ms(fn, 20)
            out[name][walk] = (ms, bound)
            log(f"D4 {name} {W}x{H} K={K_PATHS} {walk} walk"
                + ("" if gate or walk == "unculled" else
                   " (the gate does not cull this scene: unculled)")
                + f": paths kernel ms={ms:.4f} bound_ms={bound[0]:.4f} "
                f"({bound[1]}; {work_line(stats)}) share of bound "
                f"{bound[0] / ms:.3f}; plain ms={plain:.1f}")
        torch.cuda.empty_cache()
    return out


def gather_inputs(sc, paths):
    """Replay's tables of sc (detached) and each segment's gather
    arguments (s_kind, s_mat, m_props, srf, sidep)."""
    from quadray_tpu_torch.ops.replay import record_ids, row_tables
    with torch.no_grad():
        stab, mtab = row_tables(sc)
    return stab, mtab, [(sc.s_kind, sc.s_mat, sc.m_props, *record_ids(rec))
                        for rec in paths]


def gather_ms(stab, mtab, segs, grads):
    """Device ms of the gather kernels over the 8 segments of a step,
    (forward, backward), in CUDA graphs of D5_REPS steps."""
    from quadray_tpu_torch.ops import row_gather as rg
    ns, nm = stab.shape[1], mtab.shape[1]
    outs = [rg._forward(stab, mtab, *a) for a in segs]

    def fwd():
        for a in segs:
            rg._forward(stab, mtab, *a)

    def bwd():
        for a, o, (gs, gm) in zip(segs, outs, grads):
            rg._backward(gs, gm, a[3], o[1], ns, nm)

    return graph_ms(fwd, D5_REPS), graph_ms(bwd, D5_REPS)


def gather_others_ms(stab, mtab, segs, grads):
    """The same work as gather_ms by the plain versions (CUDA events:
    torch.unique syncs) and by index_select and index_add_ (CUDA graphs):
    (plain forward, plain backward, library forward, library backward)."""
    from quadray_tpu_torch.ops import row_gather as rg
    ns, nm = stab.shape[1], mtab.shape[1]
    midx = [rg.gather_plain(stab, mtab, *a)[1] for a in segs]

    def p_fwd():
        for a in segs:
            rg.gather_plain(stab, mtab, *a)

    def p_bwd():
        for a, m, (gs, gm) in zip(segs, midx, grads):
            rg.row_sum_plain(gs, a[3], ns)
            rg.row_sum_plain(gm, m, nm)

    def l_fwd():
        for a, m in zip(segs, midx):
            torch.index_select(stab, 1, a[3])
            torch.index_select(mtab, 1, m)

    def l_bwd():
        for a, m, (gs, gm) in zip(segs, midx, grads):
            stab.new_zeros(stab.shape).index_add_(1, a[3], gs)
            mtab.new_zeros(mtab.shape).index_add_(1, m, gm)

    return (cuda_ms(p_fwd, 3), cuda_ms(p_bwd, 2), graph_ms(l_fwd, D5_REPS),
            graph_ms(l_bwd, D5_REPS))


def gather_bound(n: int, k: int, ns: int, nm: int) -> tuple:
    """bound_ms of k segments' gathers and backward sums of n rays: the
    bytes of GATHER_FWD_BYTES and GATHER_BWD_BYTES a ray, the tables read
    and their gradients written once a segment; the backward's adds."""
    table = 4 * (29 + 1) * (ns + nm)
    return bound_ms(k * (n * (GATHER_FWD_BYTES + GATHER_BWD_BYTES)
                         + 2 * table), k * n * 29)


def phase_d5(dev, smi):
    """The replay gather kernels (csrc/replay.cu) against their plain
    versions on the path records of test01, test13 and demo03 at 800x480:
    forward and backward bitwise, two launches bitwise; their device ms
    beside index_select and index_add_; then two make_train_step_fast
    steps from one state, bitwise."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import row_gather as rg
    from quadray_tpu_torch.parallel import train as tr
    bits = lambda t: t.contiguous().view(torch.int32)
    cfg = train_cfg()
    rs = np.random.RandomState(5)
    worst, out = 0.0, {}
    for name in PHASE_D5:
        sc = compiled(name, dev)
        org, dirs, tmin = primary(sc, W, H)
        _, paths = ck.trace_paths(sc, org, dirs, tmin, cfg, K_PATHS)
        stab, mtab, segs = gather_inputs(sc, paths)
        ns, nm, n = stab.shape[1], mtab.shape[1], dirs.shape[0]
        grads = [tuple(torch.from_numpy(rs.standard_normal((f, n)).astype(
            np.float32)).to(dev) for f in (19, 10)) for _ in segs]
        differ, rows_hit = 0, []
        for a, (gs, gm) in zip(segs, grads):
            want = rg.gather_plain(stab, mtab, *a)
            want_g = (rg.row_sum_plain(gs, a[3], ns),
                      rg.row_sum_plain(gm, want[1], nm))
            for _ in range(2):
                got = rg._forward(stab, mtab, *a)
                got_g = rg._backward(gs, gm, a[3], got[1], ns, nm)
                torch.cuda.synchronize()
                for x, y in zip(got + got_g, want + want_g):
                    differ += int((bits(x) != bits(y)).sum())
                    if x.dtype == torch.float32:
                        worst = max(worst, float((x - y).abs().max()))
            rows_hit.append(int(torch.unique(a[3]).numel()))
        ms = (gather_ms(stab, mtab, segs, grads)
              + gather_others_ms(stab, mtab, segs, grads))
        bound = gather_bound(n, K_PATHS, ns, nm)
        out[name] = ms + bound
        log(f"D5 {name} {W}x{H} K={K_PATHS} ({ns} surface rows, {nm} "
            f"material rows; surfaces hit a segment {rows_hit}): kernel vs "
            f"plain, forward and backward, two launches each: {differ} "
            f"words differ; ms a step ({smi}): kernel forward {ms[0]:.4f} "
            f"backward {ms[1]:.4f}, plain {ms[2]:.3f} / {ms[3]:.3f}, "
            f"index_select {ms[4]:.4f}, index_add_ {ms[5]:.4f}; bound "
            f"{bound[0]:.4f} ({bound[1]})")
        if differ:
            raise AssertionError(f"D5 {name}: kernels off their plain "
                                 f"versions in {differ} words")
        del grads, paths
        torch.cuda.empty_cache()

    # two steps from one state: the same bits
    sc, target, _ = train_task(dev)
    step_fn, opt_init = tr.make_train_step_fast(
        sc, W, H, cfg=cfg, lr=TRAIN_LR, k_paths=K_PATHS)
    p0 = tr.extract_params(sc)
    o0 = opt_init(p0)
    runs = [step_fn(p0, o0, sc, target) for _ in range(2)]
    torch.cuda.synchronize()
    (pa, oa, la), (pb, ob, lb) = runs
    same = {"loss": torch.equal(bits(la), bits(lb))}
    for what, a, b in (("params", pa, pb), ("mu", oa.mu, ob.mu),
                       ("nu", oa.nu, ob.nu)):
        same[what] = all(torch.equal(bits(a[k]), bits(b[k])) for k in a)
    log(f"D5 two make_train_step_fast steps from one state (test01, every "
        f"field; route {step_fn.run.route(sc)}: the first call the "
        f"program's warm-up and capture, the second a replay): bitwise "
        f"{same}; loss {float(la):.9e}")
    if not all(same.values()):
        raise AssertionError(f"D5: two steps from one state differ: {same}")
    return worst, out


def replay_bounds(n: int, k: int, ns: int, nm: int, nl: int,
                  live: int) -> dict:
    """bound_ms of the fused replay's three parts on n rays of k segments,
    live of them hit or continued: the forward reads the records and the
    rays and writes the colors, each segment's 9-float state and 2 ids;
    the backward reads every record, the colors' gradient and the state
    and ids of the live segments only (a dead one adds nothing), and
    writes 29 row gradients a ray a segment; the row sums read those and
    the ids and write the tables' gradients (csrc/replay.cu). Bytes and
    operations of the backward are both counted on the live segments."""
    kn = k * n
    tables = 4 * (29 + 3) * (ns + nm) + 4 * 10 * nl
    ops = live * (R_SEG_OPS + nl * R_LIGHT_OPS)
    return {"forward": bound_ms(4 * kn + 24 * n + 44 * kn + tables, ops),
            "backward": bound_ms(4 * kn + 12 * n + 44 * live + 116 * kn
                                 + tables, R_BWD_FACTOR * ops),
            "row_sums": bound_ms(124 * kn + 4 * 29 * (ns + nm), 29 * kn)}


def fused_tables(sc):
    """The fused replay's table arguments of sc, detached."""
    from quadray_tpu_torch.ops import replay as rp
    with torch.no_grad():
        return [t.detach() for t in rp._table_args(sc)]


def replay_grads(fn, sc, rays, paths, g):
    """{field: gradient of sum(g * fn(...))} for R_FIELDS."""
    leaves = {k: getattr(sc, k).detach().clone().requires_grad_(True)
              for k in R_FIELDS}
    cols = fn(dataclasses.replace(sc, **leaves), *rays, paths, train_cfg())
    (cols * g).sum().backward()
    return cols.detach(), {k: v.grad for k, v in leaves.items()}


def phase_r1(dev, smi):
    """The fused replay against its plain version and autograd's
    replay_color on PHASE_R's records: colors, saved state and ids
    bitwise forward_plain's and the colors bitwise replay_color's; row
    gradients, light and ambient sums and the tables' gradients bitwise
    backward_plain's; two launches bitwise; every field's gradient within
    R_GRAD_RTOL of autograd's; device ms of each part (CUDA graphs)
    beside the plain version's and autograd's. Returns {scene: numbers},
    with the largest absolute difference of the kernels' float outputs
    from the plain version's: the forward's (colors, state) and the
    backward's (the four tables' gradients)."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import replay as rp
    from quadray_tpu_torch.ops import row_gather as rg
    bits = lambda t: t.contiguous().view(torch.int32)
    cfg = train_cfg()
    rs = np.random.RandomState(19)
    out = {}
    for name in PHASE_R:
        sc = compiled(name, dev)
        rays = primary(sc, W, H)
        org, dirs, _ = rays
        n = dirs.shape[0]
        _, paths = ck.trace_paths(sc, *rays, cfg, K_PATHS)
        tabs = fused_tables(sc)
        ns, nm, nl = tabs[0].shape[1], tabs[1].shape[1], tabs[2].shape[0]
        g = torch.from_numpy(rs.standard_normal((n, 3)).astype(
            np.float32)).to(dev)
        counts0 = (rp.launches, rp.backward_launches, rg.launches,
                   rg.backward_launches)
        runs = [rp._forward_kernel(*tabs, org, dirs, paths) for _ in range(2)]
        runs = [f + rp._backward_kernel(g, *tabs, paths, f[1], f[2])
                for f in runs]
        counts = tuple(a - b for a, b in zip(
            (rp.launches, rp.backward_launches, rg.launches,
             rg.backward_launches), counts0))
        want = rp.forward_plain(*tabs, org, dirs, paths)
        want = want + rp.backward_plain(g, *tabs, paths, want[1], want[2])
        with torch.no_grad():
            ref = rp.replay_color(sc, *rays, paths, cfg)
        torch.cuda.synchronize()
        differ = sum(int((bits(x) != bits(y)).sum()) for got in runs
                     for x, y in zip(got, want))
        abs_err = [max(float((got[j] - want[j]).abs().max()) for got in runs
                   for j in part) for part in ((0, 1), (3, 4, 5, 6))]
        differ_ref = int((bits(runs[0][0]) != bits(ref)).sum())
        _, g_ref = replay_grads(rp.replay_color, sc, rays, paths, g)
        _, g_fused = replay_grads(rp.replay_color_fused, sc, rays, paths, g)
        rel = {}
        for k in R_FIELDS:
            scale = float(g_ref[k].abs().max())
            err = float((g_fused[k] - g_ref[k]).abs().max())
            rel[k] = err / scale if scale > 0 else err
        worst = max(rel, key=rel.get)
        live_at = (((paths >> 15) & 1) != 0) | (((paths >> 13) & 3) != 0)
        live = int(live_at.sum())
        # lanes of the warps that the backward does not skip
        live_lanes = 32 * int(live_at.reshape(K_PATHS, -1, 32).any(-1).sum())
        bounds = replay_bounds(n, K_PATHS, ns, nm, nl, live)
        state, ids = runs[0][1], runs[0][2]
        g_s, g_m, _ = rp.backward_rows_kernel(g, *tabs, paths, state, ids)
        ids_s, ids_m = ids[0].reshape(-1), ids[1].reshape(-1)
        ms = {"forward": graph_ms(
            lambda: rp._forward_kernel(*tabs, org, dirs, paths), R_REPS),
              "backward": graph_ms(
            lambda: rp.backward_rows_kernel(g, *tabs, paths, state, ids),
            R_REPS)}
        ms["row_sums"] = graph_ms(lambda: rg._backward(
            g_s, g_m, ids_s, ids_m, ns, nm), R_REPS)
        ms["library_row_sums"] = graph_ms(lambda: (
            tabs[0].new_zeros((19, ns)).index_add_(1, ids_s, g_s),
            tabs[1].new_zeros((10, nm)).index_add_(1, ids_m, g_m)), R_REPS)
        ms["plain_forward"] = cuda_ms(
            lambda: rp.forward_plain(*tabs, org, dirs, paths), 2)
        ms["plain_backward"] = cuda_ms(lambda: rp._block_sums(
            rp.backward_rows_plain(g, *tabs, paths, state, ids)[2]), 1)
        ms["plain_row_sums"] = cuda_ms(lambda: (
            rg.row_sum_plain(g_s, ids_s, ns),
            rg.row_sum_plain(g_m, ids_m, nm)), 1)
        ms["autograd"] = cuda_ms(lambda: replay_grads(
            rp.replay_color, sc, rays, paths, g), 3)
        out[name] = {"ms": ms, "bounds": bounds, "differ": differ,
                     "err": abs_err, "differ_ref": differ_ref, "rel": rel,
                     "live": live}
        log(f"R1 {name} {W}x{H} K={K_PATHS} ({ns} surfaces, {nm} materials, "
            f"{nl} lights; {live} live ray segments of {K_PATHS * n}, "
            f"{live_lanes} lanes of warps with a live one): "
            f"launches (forward, backward, gather forward, row sums) "
            f"{counts}; kernels vs plain (colors, state, ids, four "
            f"gradients), two launches: {differ} words differ, largest "
            f"absolute difference forward {abs_err[0]!r} backward "
            f"{abs_err[1]!r}; "
            f"colors vs "
            f"replay_color: {differ_ref} words differ; gradients vs "
            f"autograd: worst {worst} {rel[worst]:.3e} of its largest "
            f"(limit {R_GRAD_RTOL})")
        log(f"R1 {name} ms ({smi}; CUDA graphs of {R_REPS}): forward "
            f"{ms['forward']:.4f}, bound "
            f"{bounds['forward'][0]:.4f} ({bounds['forward'][1]}); backward "
            f"{ms['backward']:.4f}, bound "
            f"{bounds['backward'][0]:.4f} ({bounds['backward'][1]}); row "
            f"sums {ms['row_sums']:.4f}, bound {bounds['row_sums'][0]:.4f} "
            f"({bounds['row_sums'][1]}), index_add_ "
            f"{ms['library_row_sums']:.4f}; plain forward "
            f"{ms['plain_forward']:.3f}, backward {ms['plain_backward']:.3f}"
            f", row sums {ms['plain_row_sums']:.3f}; autograd replay_color "
            f"forward+backward {ms['autograd']:.3f}")
        if counts != (2, 2, 0, 2):
            raise AssertionError(f"R1 {name}: launches {counts}")
        if differ or differ_ref:
            raise AssertionError(f"R1 {name}: the kernels are off the plain "
                                 f"version in {differ} words, off "
                                 f"replay_color's colors in {differ_ref}")
        if not rel[worst] <= R_GRAD_RTOL:
            raise AssertionError(f"R1 {name}: {worst}'s gradient off "
                                 f"autograd's by {rel[worst]:.3e}")
        del runs, want, g_s, g_m, state, ids
        torch.cuda.empty_cache()
    return out


def phase_r2(dev):
    """A training step on bench_train's task goes through the fused
    kernels, on both routes, and never through the gather's forward: one
    make_train_step_fast step each, counted."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import replay as rp
    from quadray_tpu_torch.ops import row_gather as rg
    from quadray_tpu_torch.parallel import train as tr
    sc, target, _ = train_task(dev)
    for eager in (False, True):
        step_fn, opt_init = tr.make_train_step_fast(
            sc, W, H, cfg=train_cfg(), lr=TRAIN_LR, k_paths=K_PATHS,
            eager=eager)
        p0 = tr.extract_params(sc)
        o0 = opt_init(p0)
        step_fn(p0, o0, sc, target)
        torch.cuda.synchronize()
        ck.paths_launches = rp.launches = rp.backward_launches = 0
        rg.launches = rg.backward_launches = 0
        _, _, loss = step_fn(p0, o0, sc, target)
        torch.cuda.synchronize()
        counts = (ck.paths_launches, rp.launches, rp.backward_launches,
                  rg.launches, rg.backward_launches)
        route = step_fn.run.route(sc)
        log(f"R2 one make_train_step_fast step, route {route}: launches "
            f"(paths, replay forward, replay backward, gather forward, row "
            f"sums) {counts}; loss {float(loss):.9e}")
        if counts != (1, 1, 1, 0, 1):
            raise AssertionError(f"R2 route {route}: launches {counts}")


def bound_ms(n_bytes: float, ops: float) -> tuple:
    """The least time the card could take for this work: (ms, what bounds
    it), the larger of bytes over HBM_RATE and operations over FP32_RATE."""
    t_bytes, t_ops = n_bytes / HBM_RATE, ops / FP32_RATE
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def surface_ops(struct, stats) -> float:
    """FP32 operations of the surface tests a call's inputs need, from the
    plain version's count of its work (ops/trace.py count_work): every
    nearest-hit walk tests every real surface; a shadow ray that no
    blocker stops tests every blocker, and one that is stopped needs one
    test (the cheapest kind among the blockers)."""
    planes = sum(g.count for g in struct.groups if g.is_plane)
    others = struct.n_real - planes
    b_planes = sum(g.n_block for g in struct.groups if g.is_plane)
    b_others = sum(g.n_block for g in struct.groups) - b_planes
    one_test = OPS_PLANE if b_planes else OPS_QUADRIC_SHADOW
    return (stats.get("walks", 0) * (planes * OPS_PLANE + others * OPS_QUADRIC)
            + stats.get("shadow_open", 0) * (b_planes * OPS_PLANE
                                             + b_others * OPS_QUADRIC_SHADOW)
            + stats.get("shadow_blocked", 0) * one_test)


def work_line(stats) -> str:
    return " ".join(f"{k}={stats.get(k, 0)}" for k in (
        "walks", "shadow_open", "shadow_blocked"))


def iterations(seeds_in, seeds_out) -> int:
    """A PT call's iteration count M: every seed advanced 4*M draws."""
    from quadray_tpu_torch.ops.pt import lcg_jump
    for m in range(6 * (PT_DEPTH + 1) + 1):
        if torch.equal(lcg_jump(seeds_in, 4 * m), seeds_out):
            return m
    raise AssertionError("PT seeds are not advanced 4*M draws")


def with_emission(sc, seed: int):
    """sc with a seeded emission in [0, 0.5) added on both sides of every
    real surface: every path then gathers light at each node, so a wrong
    branch weight, stack pop or emission row shows in its radiance."""
    e = np.random.default_rng(seed).uniform(
        0.0, 0.5, tuple(sc.s_emis.shape)).astype(np.float32)
    e = torch.from_numpy(e).to(sc.s_emis.device)
    return dataclasses.replace(
        sc, s_emis=sc.s_emis + e * (sc.s_kind > 0)[:, None, None])


def pt_inputs(sc, w, h, dev):
    from quadray_tpu_torch.ops.pt import init_seeds, pt_camera_rays
    org, dirs, seeds = pt_camera_rays(sc, w, h, init_seeds(w * h,
                                                           device=dev))
    return org, dirs, sc.cam_pov.expand(w * h), seeds


def lane_utilisation(nodes) -> float:
    """The share of issue slots that run a node when each thread owns one
    sample: a warp of 32 consecutive samples runs as long as its longest
    one. nodes: (N,) nodes per sample (trace_pt's "sample_nodes")."""
    n = nodes.shape[0]
    warps = torch.zeros((n + 31) // 32 * 32, dtype=torch.float64,
                        device=nodes.device)
    warps[:n] = nodes
    warps = warps.view(-1, 32)
    return float(warps.sum() / (32 * warps.amax(dim=1).sum()))


def phase_e1(dev):
    """The PT kernel vs its plain version on the card: seeds and radiance,
    on every case and on prefixes of the last; two launches equal."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.pt import trace_pt
    from quadray_tpu_torch.ops.trace import TraceConfig
    cfg = TraceConfig(depth=PT_DEPTH)
    worst = 0.0

    def compare(label, sc, rays, lit_min):
        got_r, got_s = ck.trace_pt_cuda(sc, *rays, cfg)
        m = iterations(rays[3], got_s)
        stats = {"sample_nodes": None}
        want_r, want_s = trace_pt(sc, *rays, cfg, stats)
        torch.cuda.synchronize()
        d = (got_r - want_r).abs()
        nd = int((d.amax(dim=1) > 0).sum())
        mx = float(d.max())
        n_seed = int((got_s != want_s).sum())
        lit = float((got_r.amax(dim=1) > 0).float().mean())
        log(f"E1 {label}: rays={rays[1].shape[0]} M={m} seeds_differing="
            f"{n_seed} lanes_differing={nd} max_abs={mx:.3e} mean_radiance="
            f"{float(got_r.mean()):.6f} lit_lanes={lit:.4f} "
            f"one_sample_per_thread_lane_utilisation="
            f"{lane_utilisation(stats['sample_nodes']):.4f}")
        if n_seed or not torch.equal(got_s, want_s):
            raise AssertionError(f"E1 {label}: {n_seed} seeds differ")
        if not (mx <= ATOL and bool(torch.isfinite(got_r).all())):
            raise AssertionError(f"E1 {label}: radiance off by {mx}")
        if not lit > lit_min:
            raise AssertionError(f"E1 {label}: only {lit:.4f} of the lanes "
                                 "gathered any light")
        return got_r, got_s, mx

    for name, w, h, seed in PHASE_E1:
        sc = compiled(name, dev)
        if seed is not None:
            sc = with_emission(sc, seed)
        rays = pt_inputs(sc, w, h, dev)
        label = f"{name} {w}x{h}{'' if seed is None else ' +emission'}"
        got_r, got_s, mx = compare(label, sc, rays, PT_LIT)
        worst = max(worst, mx)
        torch.cuda.empty_cache()
    # the samples of the last case (test18 at 800x480): a second launch
    # gives the same bits (the queue hands samples to lanes in another
    # order), and prefixes that end inside a warp or a block
    again_r, again_s = ck.trace_pt_cuda(sc, *rays, cfg)
    same = torch.equal(got_r.view(torch.int32), again_r.view(torch.int32)) \
        and torch.equal(got_s, again_s)
    log(f"E1 {label}: two launches bitwise equal={same}")
    if not same:
        raise AssertionError(f"E1 {label}: two launches differ")
    for n in PT_PREFIXES:
        _, _, mx = compare(f"{label} prefix", sc, (rays[0], rays[1][:n],
                                                   rays[2][:n], rays[3][:n]),
                           -1.0)
        worst = max(worst, mx)
    return worst


def pt_stats(frame, ref):
    """tests/test_pt.py's four statistics of a frame against the golden."""
    frame, ref = frame.astype(np.float32), ref.astype(np.float32)
    mean_d = np.abs(frame.reshape(-1, 3).mean(0) - ref.reshape(-1, 3)
                    .mean(0))
    B = 16
    fb = frame.reshape(H // B, B, W // B, B, 3).mean((1, 3))
    rb = ref.reshape(H // B, B, W // B, B, 3).mean((1, 3))
    d = np.abs(fb - rb)
    return {"global_mean": float(mean_d.max()), "block_mean":
            float(d.mean()), "block_p95": float(np.percentile(d, 95)),
            "block_max": float(d.max())}


def phase_e2(dev):
    """The main path, counted: 64 progressive passes through the engine,
    held to the reference engine's 64-spp frame."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.utils.image import load_bmp
    ref = load_bmp(os.path.join(GOLDEN, "ref_test18_pt64.bmp"))
    scene = Scene(load_scene("test18"), W, H, device=dev)
    scene.update(0.0)
    if not scene.set_pton(True):
        raise AssertionError("E2: set_pton(True) refused")
    torch.cuda.synchronize()
    ck.pt_launches = 0
    t0 = time.perf_counter()
    frame = scene.render_pt_pass(PT_PASSES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ck.pt_launches
    stats = pt_stats(frame, ref)
    log(f"E2 test18 {W}x{H} {PT_PASSES} passes: pt_launches={launches} "
        f"wall={wall:.3f} s " + " ".join(
            f"{k}={v:.4f} (limit {PT_LIMITS[k]})" for k, v in stats.items()))
    if launches != PT_PASSES:
        raise AssertionError(f"E2: {launches} PT launches for {PT_PASSES} "
                             "passes")
    bad = [k for k, v in stats.items() if not v < PT_LIMITS[k]]
    if bad or frame.shape != (H, W, 3):
        raise AssertionError(f"E2: outside the golden's limits: {bad}")
    return scene, launches


def phase_e3(dev, scene):
    """The engine carries its pass state (sum, seeds, sample count) across
    calls: 1 then 3 passes through render_pt_pass equal one render_pt_cuda
    of 4 passes from fresh seeds. Both replay a pass program's graph a
    pass (ops/graphs.py), the Scene's and render_pt_cuda's own."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.pt import init_seeds
    from quadray_tpu_torch.ops.trace import TraceConfig, to_frame
    scene.reset_pt()
    scene.render_pt_pass(1)
    frame = scene.render_pt_pass(3)
    img, seeds = ck.render_pt_cuda(scene.arrays, W, H,
                                   init_seeds(W * H, device=dev), 4,
                                   TraceConfig(depth=PT_DEPTH),
                                   scene._struct)
    want = (scene._pt_acc / 4.0).reshape(H, W, 3)
    same_f = np.array_equal(frame, to_frame(
        img, scene.arrays.use_gamma).cpu().numpy())
    same_r, same_s = torch.equal(img, want), torch.equal(seeds,
                                                         scene._pt_seeds)
    log(f"E3 test18 {W}x{H} 1 + 3 passes vs 4 in one call: radiance="
        f"{same_r} seeds={same_s} frame={same_f}")
    if not (same_r and same_s and same_f):
        raise AssertionError("E3: passes split over calls differ from one "
                             "call's")


def phase_e4(dev):
    """bench_pt's pass: ms per pass, the kernel alone and the plain pass;
    M, the nodes run and the bound."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.pt import init_seeds, trace_pt
    from quadray_tpu_torch.ops.trace import TraceConfig
    sc = compiled("test18", dev)
    struct = ck.scene_struct(sc)
    cfg = TraceConfig(depth=PT_DEPTH)
    state = [init_seeds(W * H, device=dev)]

    def one_pass():
        _, state[0] = ck.render_pt_cuda(sc, W, H, state[0], 1, cfg, struct)

    pass_ms = cuda_ms(one_pass, PT_TIMED, warmup=2)
    rays = pt_inputs(sc, W, H, dev)
    kernel_ms = cuda_ms(lambda: ck.trace_pt_cuda(sc, *rays, cfg, struct),
                        PT_TIMED, warmup=2)
    m = iterations(rays[3], ck.trace_pt_cuda(sc, *rays, cfg, struct)[1])
    plain_ms = cuda_ms(lambda: trace_pt(sc, *rays, cfg), 1)
    stats = {"sample_nodes": None}
    trace_pt(sc, *rays, cfg, stats)
    nodes = stats["walks"]
    util = lane_utilisation(stats.pop("sample_nodes"))
    torch.cuda.empty_cache()
    # bytes: 7 f32 ray words and an i32 seed in, 3 f32 and a seed out
    bound, bound_by = bound_ms(W * H * 48, surface_ops(struct, stats))
    log(f"E4 test18 {W}x{H} depth {PT_DEPTH}: ms/pass={pass_ms:.3f} "
        f"(ray gen + kernel + sum, mean of {PT_TIMED}) kernel_ms="
        f"{kernel_ms:.3f} plain_ms/pass={plain_ms:.1f} M={m} nodes={nodes} "
        f"({nodes / (W * H):.3f} per sample) lane utilisation of one sample "
        f"per thread={util:.4f} bound_ms={bound:.4f} ({bound_by})")
    return kernel_ms, plain_ms, bound, bound_by


def phase_e4_heavy(dev):
    """The heavy PT scenes at 800x480, depth 10: the kernel alone and ms
    per pass (ray gen + kernel + sum), culled (the default gate) and
    unculled, CUDA events in turns on off off on; the plain version's
    count of the nearest tests the masks keep and skip, and the bound
    (every node testing every real surface, as for test18). Returns per
    scene (culled ms, unculled ms, bound ms, what bounds it, share of the
    nearest tests culled)."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.pt import init_seeds, trace_pt
    from quadray_tpu_torch.ops.trace import TraceConfig
    on = TraceConfig(depth=PT_DEPTH)
    cfgs = {"on": on, "off": on._replace(cull=False)}
    rows = {}
    for name in PT_HEAVY:
        sc = compiled(name, dev)
        struct = ck.scene_struct(sc)
        if not ck.cull_gates(struct, on, pt=True).cull:
            raise AssertionError(f"E4 {name}: the PT gate does not cull")
        rays = pt_inputs(sc, W, H, dev)
        state = [init_seeds(W * H, device=dev)]

        def one_pass(cfg):
            _, state[0] = ck.render_pt_cuda(sc, W, H, state[0], 1, cfg, struct)

        kern = {k: [] for k in cfgs}
        passes = {k: [] for k in cfgs}
        for k in ("on", "off", "off", "on"):
            kern[k].append(cuda_ms(lambda: ck.trace_pt_cuda(
                sc, *rays, cfgs[k], struct), PT_HEAVY_REPS, warmup=2))
            passes[k].append(cuda_ms(lambda: one_pass(cfgs[k]),
                                     PT_HEAVY_REPS, warmup=2))
        stats = {}
        trace_pt(sc, *rays, on, stats)
        torch.cuda.empty_cache()
        kept, culled = stats["nearest_tests_kept"], stats["nearest_tests_culled"]
        share = culled / (kept + culled)
        bound, bound_by = bound_ms(W * H * 48, surface_ops(struct, stats))
        ms = {k: float(np.mean(v)) for k, v in kern.items()}
        log(f"E4 {name} {W}x{H} depth {PT_DEPTH} ({struct.n_real} surfaces): "
            f"kernel_ms culled={ms['on']:.4f} unculled={ms['off']:.4f} "
            f"(culled/unculled {ms['on'] / ms['off']:.4f}); ms/pass culled="
            f"{np.mean(passes['on']):.3f} unculled={np.mean(passes['off']):.3f}"
            f"; nodes={stats['walks']} ({stats['walks'] / (W * H):.3f} per "
            f"sample) nearest tests kept={kept} culled={culled} share_culled="
            f"{share:.4f}; bound_ms={bound:.4f} ({bound_by})")
        rows[name] = (ms["on"], ms["off"], bound, bound_by, share)
    return rows


def phase_e5(dev):
    """The main path at full width on the heavy scenes the PT gate culls:
    64 passes through the engine, the PT launches counted (zeroed right
    before, read right after), held bitwise (the running sum and the
    seeds) against render_pt_cuda's 64 unculled passes from the same
    seeds. Returns the launches of the counted runs."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.pt import init_seeds
    from quadray_tpu_torch.ops.trace import TraceConfig
    launches = {}
    for name in PT_HEAVY:
        scene = Scene(load_scene(name), W, H, device=dev)
        scene.update(0.0)
        if not scene.set_pton(True):
            raise AssertionError(f"E5 {name}: set_pton(True) refused")
        gates = ck.cull_gates(scene._struct, TraceConfig(depth=PT_DEPTH),
                              pt=True)
        torch.cuda.synchronize()
        ck.pt_launches = 0
        t0 = time.perf_counter()
        frame = scene.render_pt_pass(PT_PASSES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = ck.pt_launches
        img, seeds = ck.render_pt_cuda(
            scene.arrays, W, H, init_seeds(W * H, device=dev), PT_PASSES,
            TraceConfig(depth=PT_DEPTH, cull=False), scene._struct)
        want = (scene._pt_acc / float(PT_PASSES)).reshape(H, W, 3)
        same_r = torch.equal(img.view(torch.int32), want.view(torch.int32))
        same_s = torch.equal(seeds, scene._pt_seeds)
        lit = float((scene._pt_acc.amax(dim=1) > 0).float().mean())
        log(f"E5 {name} {W}x{H} {PT_PASSES} passes: gate cull={gates.cull} "
            f"pt_launches={launches[name]} wall={wall:.3f} s culled == "
            f"unculled: sum={same_r} seeds={same_s}; lit_pixels={lit:.4f} "
            f"frame {frame.shape}")
        if not gates.cull:
            raise AssertionError(f"E5 {name}: the PT gate does not cull")
        if launches[name] != PT_PASSES:
            raise AssertionError(f"E5 {name}: {launches[name]} PT launches "
                                 f"for {PT_PASSES} passes")
        if not (same_r and same_s and frame.shape == (H, W, 3)
                and bool(torch.isfinite(scene._pt_acc).all())):
            raise AssertionError(f"E5 {name}: the culled passes differ from "
                                 "the unculled ones")
        del scene
        torch.cuda.empty_cache()
    return launches


def phase_e6(dev):
    """The sweep that sets PT's floor: every golden scene at 800x480,
    one PT pass at depth 10 with culling forced (the floor lowered to 1)
    against unculled, radiance and seeds bitwise, and the kernel's device
    ms of each (CUDA events, turns on off off on), beside whether the
    default gate culls it."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import TraceConfig
    on = TraceConfig(depth=PT_DEPTH)
    cfgs = {"on": on, "off": on._replace(cull=False)}
    rows, fails = {}, []
    with cull_every_scene("PT_CULL_MIN_SURFACES") as floor:
        for n in SCENES:
            sc = compiled(n, dev)
            struct = ck.scene_struct(sc)
            if not ck.cull_gates(struct, on, pt=True).cull:
                raise AssertionError(f"E6 {n}: the forced gate does not cull")
            rays = pt_inputs(sc, W, H, dev)
            a = ck.trace_pt_cuda(sc, *rays, on, struct)
            b = ck.trace_pt_cuda(sc, *rays, cfgs["off"], struct)
            same = torch.equal(_bits(a[0]), _bits(b[0])) and torch.equal(
                a[1], b[1])
            times = {k: [] for k in cfgs}
            for k in ("on", "off", "off", "on"):
                times[k].append(cuda_ms(lambda: ck.trace_pt_cuda(
                    sc, *rays, cfgs[k], struct), 10, warmup=2))
            ms = {k: float(np.mean(v)) for k, v in times.items()}
            default = struct.n_real >= floor
            log(f"E6 {n} {W}x{H} ({struct.n_real} surfaces, culled by "
                f"default: {default}): culled==unculled {same}; pt kernel "
                f"ms culled {ms['on']:.4f} unculled {ms['off']:.4f} ratio "
                f"{ms['on'] / ms['off']:.4f}")
            rows[n] = (struct.n_real, ms, default)
            if not same:
                fails.append(n)
            torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"E6: culled PT output differs: {fails}")
    slower = [n for n, (_, ms, c) in rows.items()
              if c and ms["on"] > ms["off"]]
    faster_below = [n for n, (_, ms, c) in rows.items()
                    if not c and ms["on"] < ms["off"]]
    log(f"E6: scenes the default PT gate culls where culling was slower: "
        f"{slower or 'none'}; below the floor of {floor} where it was "
        f"faster: {faster_below or 'none'}")
    return rows


# ---- phase F: two-round retirement ------------------------------------------

def phase_f1(dev, label="F1"):
    """The emit and resume kernels against their plain versions on the
    card: emit's colors and all 21 state rows, then resume from the
    kernel's state in each of F1_RESUME_MODES, bitwise; the two rounds
    equal the monolithic kernel."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import (
        ACTIVE_ROW, STATE_I32, STATE_ROWS, TraceConfig, trace_rays_emit,
        trace_rays_resume)
    cfg = TraceConfig()
    worst = 0.0
    bits = lambda t: t.contiguous().view(torch.int32)
    main_modes = set()   # the modes RESUME_WARP_MAX picks at 800x480
    for name, w, h, k1 in PHASE_F1:
        sc = compiled(name, dev)
        rays = primary(sc, w, h)
        cols_k, state_k = ck.trace_rays_emit_cuda(sc, *rays, cfg, k1)
        cols_p, state_p = trace_rays_emit(sc, *rays, cfg, k1)
        torch.cuda.synchronize()
        rows = [STATE_ROWS[k] for k in range(len(STATE_ROWS))
                if not torch.equal(bits(state_k[k]), bits(state_p[k]))]
        floats = [k for k in range(len(STATE_ROWS)) if k not in STATE_I32]
        emit_err = max(float((cols_k - cols_p).abs().max()),
                       float((state_k[floats] - state_p[floats]).abs()
                             .max()))
        alive = float((bits(state_k[ACTIVE_ROW]) != 0).float().mean())
        same_cols = torch.equal(bits(cols_k), bits(cols_p))
        idx, count = ck.compact_active(state_k)
        res_p = trace_rays_resume(sc, state_k, cols_k.clone(), cfg, k1)
        mono = ck.trace_rays_cuda(sc, *rays, cfg)
        struct = ck.scene_struct(sc)
        survivors = int(count)
        log(f"{label} {name} {w}x{h} k1={k1}: rays={w * h} alive_after_round1="
            f"{alive:.4f} survivors={survivors} emit colors bitwise="
            f"{same_cols} state rows differing={rows or 'none'} "
            f"max_abs={emit_err:.3e}")
        if rows or not same_cols:
            raise AssertionError(f"{label} {name}: emit differs from its "
                                 f"plain version (rows {rows})")
        if not 0 < alive < 1:
            raise AssertionError(f"{label} {name}: no lane on one side of "
                                 "the cut")
        for mode, value in F1_RESUME_MODES:
            with ck_value("RESUME_WARP_MAX", ck.RESUME_WARP_MAX
                          if value is None else w * h if value == "n"
                          else value):
                warp_max = ck.resume_warp_max(struct, w * h)
                # resume writes into the colours it is given
                res_k = ck.trace_rays_resume_cuda(
                    sc, state_k, cols_k.clone(), idx, count, cfg, k1)
            torch.cuda.synchronize()
            ran = "sparse" if survivors <= warp_max else "dense"
            nd = int((bits(res_k) != bits(res_p)).any(dim=1).sum())
            res_err = float((res_k - res_p).abs().max())
            worst = max(worst, emit_err, res_err)
            same_mono = torch.equal(bits(res_k), bits(mono))
            log(f"{label} {name} {w}x{h} k1={k1} resume {mode} (warp_max="
                f"{warp_max}: ran {ran}): lanes_differing={nd} max_abs="
                f"{res_err:.3e} rounds==monolithic={same_mono}")
            if nd or not same_mono or mode not in (ran, "default"):
                raise AssertionError(f"{label} {name}: resume {mode} "
                                     f"differs ({nd} lanes), rounds != "
                                     f"monolithic ({same_mono}) or ran "
                                     f"{ran}")
            if mode == "default" and (w, h) == (W, H):
                main_modes.add(ran)
            del res_k
        del state_p, res_p
        torch.cuda.empty_cache()
    if main_modes != {"sparse", "dense"}:
        raise AssertionError(f"{label}: at {W}x{H} RESUME_WARP_MAX picked "
                             f"only {sorted(main_modes)}")
    return worst


def phase_f2(dev):
    """The counted run: every golden scene at 800x480 through
    trace_rays_rounds at k1 = ROUNDS_K1 and WAVE_K1, each frame bitwise
    equal to render_cuda's and inside its golden budget; single-branch
    scenes launch emit and resume once a call (and the monolithic kernel
    never), test17 and test18 the monolithic kernel only; no host sync
    inside a call."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.rays import camera_rays, resolve_aa
    from quadray_tpu_torch.ops.trace import TraceConfig, to_frame
    from quadray_tpu_torch.utils.image import load_bmp, frame_cmp
    cfg = TraceConfig()
    cases = []
    for n in SCENES:
        scene = Scene(load_scene(n), W, H, device=dev)
        sc = scene.arrays
        org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver,
                                sc.cam_nrm, sc.cam_pov, W, H, 1)
        rays = (org, dirs, sc.cam_pov.expand(dirs.shape[0]))
        struct = ck.scene_struct(sc)
        mono = ck.render_cuda(sc, W, H, 1, cfg, struct)
        cases.append((n, sc, struct, rays, mono))
    torch.cuda.synchronize()
    single = [n for n, _, st, _, _ in cases if not st.can_push]
    counters = ("emit_launches", "resume_launches", "launches")
    # main path, counted: every count zeroed right before, read right after
    for c in counters:
        setattr(ck, c, 0)
    runs, syncs = [], []
    for n, sc, struct, rays, mono in cases:
        # the packed tables (set-up, cached per scene: 8 scenes at a
        # time) are uploaded before the calls, which must not wait
        ck._get_packed(sc, struct)
        for k1 in (ck.ROUNDS_K1, ck.WAVE_K1):
            before = [getattr(ck, c) for c in counters]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    cols = ck.trace_rays_rounds(sc, *rays, cfg, k1, struct)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs += [f"{n}: {w.message}" for w in caught
                      if "called a synchronizing" in str(w.message)]
            runs.append((n, k1, [getattr(ck, c) - b for c, b in
                                 zip(counters, before)], cols))
    torch.cuda.synchronize()
    totals = {c: getattr(ck, c) for c in counters}
    refs = {n: load_bmp(os.path.join(GOLDEN, f"ref_{n}.bmp")) for n in SCENES}
    byname = {c[0]: c for c in cases}
    fails = []
    for n, k1, (ne, nr, nm), cols in runs:
        _, sc, struct, _, mono = byname[n]
        img = resolve_aa(torch.clamp(cols, 0.0, 1.0), W, H, 1)
        same = torch.equal(img.contiguous().view(torch.int32),
                           mono.contiguous().view(torch.int32))
        nbad, _ = frame_cmp(refs[n], to_frame(img, sc.use_gamma).cpu()
                            .numpy(), t_diff=3)
        want = (0, 0, 1) if struct.can_push else (1, 1, 0)
        ok = same and nbad <= BUDGET.get(n, 0) and (ne, nr, nm) == want
        log(f"F2 {n} k1={k1}: bitwise_vs_render_cuda={same} bad_px={nbad} "
            f"budget={BUDGET.get(n, 0)} launches emit={ne} resume={nr} "
            f"monolithic={nm}{'' if ok else '  FAIL'}")
        if not ok:
            fails.append(f"{n} k1={k1}")
    log(f"F2 launches over {len(runs)} calls: {totals}; single-branch "
        f"scenes {len(single)}; host syncs inside the calls: {len(syncs)}")
    if fails or syncs or len(single) != 19:
        raise AssertionError(f"F2: failed {fails}; syncs {sorted(set(syncs))};"
                             f" single-branch scenes {len(single)}")
    return totals


def rounds_bounds(name, sc, struct, rays, k1):
    """Bounds of the emit and resume kernels on these rays, from the work
    the plain versions count: emit reads 28 bytes and writes 12 + 84 per
    ray; resume reads 84 (20 state rows and its index) and writes 12 per
    surviving ray."""
    from quadray_tpu_torch.ops.trace import (ACTIVE_ROW, TraceConfig,
                                             trace_rays_emit,
                                             trace_rays_resume)
    cfg = TraceConfig()
    se, sr, sw = {}, {}, {}
    cols, state = trace_rays_emit(sc, *rays, cfg, k1, se)
    alive = int((state[ACTIVE_ROW].view(torch.int32) != 0).sum())
    trace_rays_resume(sc, state, cols, cfg, k1, sr)
    if k1 > 1:
        # the tests the warp masks alone would keep after segment 0
        with ck_value("EMIT_OWN_MIN_KEPT", struct.n_real):
            trace_rays_emit(sc, *rays, cfg, k1, sw)
        log(f"F3 {name} emit k1={k1} surface tests kept, per-ray masks after the "
            f"camera segment: {cull_shares(se)}; the warp's masks alone: "
            f"{cull_shares(sw)}")
    log(f"F3 {name} resume k1={k1} surface tests kept, per-ray masks: "
        f"{cull_shares(sr)}")
    del cols, state
    torch.cuda.empty_cache()
    n = rays[1].shape[0]
    return (bound_ms(n * (28 + 12 + 84), surface_ops(struct, se)),
            bound_ms(alive * (84 + 12), surface_ops(struct, sr)), se, sr)


def phase_f3(dev):
    """The monolithic kernel against the two rounds at k1 = 1 and 4, part
    by part, in alternating turns in one process (CUDA events); the share
    of rays alive after round 1; each kernel's bound."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import (TraceConfig, trace_rays_emit,
                                             trace_rays_resume)
    cfg = TraceConfig()
    result = {}
    for name in PHASE_F3:
        sc = compiled(name, dev)
        struct = ck.scene_struct(sc)
        rays = primary(sc, W, H)
        fns = {"monolithic": lambda: ck.trace_rays_cuda(sc, *rays, cfg,
                                                        struct)}
        alive = {}
        for k1 in (ck.WAVE_K1, ck.ROUNDS_K1):
            cols, state = ck.trace_rays_emit_cuda(sc, *rays, cfg, k1, struct)
            idx, count = ck.compact_active(state)
            alive[k1] = int(count)
            fns[f"k1={k1} emit"] = (lambda k1=k1: ck.trace_rays_emit_cuda(
                sc, *rays, cfg, k1, struct))
            fns[f"k1={k1} compact"] = (lambda state=state:
                                       ck.compact_active(state))
            fns[f"k1={k1} resume"] = (
                lambda k1=k1, s=state, c=cols, i=idx, n=count:
                ck.trace_rays_resume_cuda(sc, s, c, i, n, cfg, k1, struct))
            fns[f"k1={k1} rounds"] = (lambda k1=k1: ck.trace_rays_rounds(
                sc, *rays, cfg, k1, struct))
        times = {k: [] for k in fns}
        order = list(fns)
        for r in range(F3_ROUNDS):
            for k in (order if r % 2 == 0 else order[::-1]):
                times[k].append(graph_ms(fns[k], F3_REPS))
        n = W * H
        line = " ".join(f"{k}={np.mean(v):.4f} ({min(v):.4f}-{max(v):.4f})"
                        for k, v in times.items())
        log(f"F3 {name} {W}x{H} device ms (CUDA graphs of {F3_REPS} "
            f"calls, mean of {F3_ROUNDS} turns): {line}; alive after round "
            "1: " + ", ".join(
                f"k1={k} {v / n:.4f}" for k, v in alive.items()))
        mono = np.mean(times["monolithic"])
        for k1 in (ck.WAVE_K1, ck.ROUNDS_K1):
            parts = [np.mean(times[f"k1={k1} {p}"])
                     for p in ("emit", "compact", "resume")]
            call = np.mean(times[f"k1={k1} rounds"])
            log(f"F3 {name} k1={k1} rounds total: emit {parts[0]:.4f} + "
                f"compaction {parts[1]:.4f} + resume {parts[2]:.4f} = "
                f"{sum(parts):.4f} ms; one trace_rays_rounds call "
                f"{call:.4f} ms; monolithic {mono:.4f} ms; rounds / "
                f"monolithic {call / mono:.4f}")
        bounds = {}
        for k1 in (ck.WAVE_K1, ck.ROUNDS_K1):
            be, br, se, sr = rounds_bounds(name, sc, struct, rays, k1)
            bounds[k1] = (be, br)
            log(f"F3 {name} k1={k1} bounds: emit {be[0]:.4f} ({be[1]}; "
                f"{work_line(se)}), resume {br[0]:.4f} ({br[1]}; "
                f"{work_line(sr)})")
        result[name] = (times, alive, bounds)
        if name == "test13":
            # the plain versions' times (one run each, k1 = ROUNDS_K1)
            k1 = ck.ROUNDS_K1
            cols, state = trace_rays_emit(sc, *rays, cfg, k1)
            pe = cuda_ms(lambda: trace_rays_emit(sc, *rays, cfg, k1), 1, 0)
            pr = cuda_ms(lambda: trace_rays_resume(sc, state, cols, cfg, k1),
                         1, 0)
            log(f"F3 test13 k1={k1} plain ms: emit {pe:.1f} resume {pr:.1f}")
            result["plain"] = (pe, pr)
            del cols, state
        torch.cuda.empty_cache()
    return result


# ---- phase G: the kernel-op conformance tier ---------------------------------

def _np_roots(a, b, c):
    f = np.float32
    disc = b * b - a * c
    quad_ok = disc >= 0
    sq = np.sqrt(np.maximum(disc, f(0)))
    q = -(b + np.where(b >= 0, f(1), f(-1)) * sq)
    b_pos = b > 0

    def root(num, den):
        den = np.where(num == 0, f(1), den)
        ok = den != 0
        return np.where(ok, num / np.where(ok, den, f(1)), f(1e30)), ok

    t1, ok1 = root(np.where(b_pos, q, c), np.where(b_pos, a, q))
    t2, ok2 = root(np.where(b_pos, c, q), np.where(b_pos, q, a))
    sgn_a = np.where(a >= 0, f(1), f(-1))
    u = (t1 - t2) * sgn_a
    tdff = np.where(u >= 0, f(-0.5) * u - np.abs(f(1e-7) * t1), f(0)) * sgn_a
    tdff = np.where(quad_ok & (disc < f(1e-11)) & ok1 & ok2, tdff, f(0))
    return (np.where(quad_ok & ok1, t1 + tdff, f(1e30))
            + f(1e-3) * np.where(quad_ok & ok2, t2 - tdff, f(1e30)))


def _np_sdiv(num, den, fb):
    bad = np.abs(den) < np.float32(1e-30)
    return np.where(bad, np.float32(fb), num / np.where(bad, np.float32(1),
                                                        den))


def _np_fresnel(eta, dot):
    f = np.float32
    ed = eta * dot
    k = f(1) - eta * eta + ed * ed
    sq = np.sqrt(np.maximum(k, f(0)))
    rs = _np_sdiv(ed + sq, ed - sq, 1.0)
    rp = _np_sdiv(dot + eta * sq, dot - eta * sq, 1.0)
    F = np.clip(f(0.5) * (rs * rs + rp * rp), f(0), f(1))
    return np.where(k < 0, f(1), F)


def _np_root_sdiv(num, den):
    f = np.float32
    d = np.where(num == 0, f(1), den)
    ok = d != 0
    r = np.where(ok, num / np.where(ok, d, f(1)), f(1e30))
    return r + f(1e3) * ok.astype(f) + f(1e-3) * _np_sdiv(num, den, 1e30)


# numpy f32 on the host: what each conformance kernel must give
NUMPY_REF = {
    "add": lambda x, y: x + y,
    "mul": lambda x, y: x * y,
    "div": lambda x, y: x / y,
    "sqrt": np.sqrt,
    "rsqrt": lambda x: (1.0 / np.sqrt(x.astype(np.float64))).astype(
        np.float32),
    "exp": np.exp,
    "log": np.log,
    "fma": lambda x, y: x * y + y,
    "min_max": lambda x, y: np.maximum(x, y) - np.minimum(x, y),
    "abs_neg": lambda x: np.abs(-x),
    "roots": _np_roots,
    "fresnel": _np_fresnel,
    "spec_pow": lambda x, p: np.exp(p * np.log(x)),
    "gather": lambda t, i: np.take_along_axis(t, i, axis=1),
    "root_sdiv": _np_root_sdiv,
}
# the bars: None bitwise (correctly rounded ops; rsqrt against 1/sqrt in
# f64 rounded once), else tests/test_conformance.py's FEQ scale
FEQ_SCALE = {"exp": 4.0, "log": 4.0, "spec_pow": 64.0, "roots": 8.0,
             "fresnel": 8.0, "root_sdiv": 8.0}
# one PyTorch call computing each case's function, where there is one
LIBRARY = {
    "add": torch.add, "mul": torch.mul, "div": torch.div, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "exp": torch.exp, "log": torch.log,
    "fma": lambda x, y: torch.addcmul(y, x, y),
    "abs_neg": lambda x: torch.abs(x), "spec_pow": torch.pow,
    "gather": lambda t, i: torch.gather(t, 1, i.long()),
}
# FP32 operations per element of each case (for its bound; all are
# bytes-bound by far)
CASE_OPS = {"roots": 30, "fresnel": 20, "spec_pow": 3, "root_sdiv": 6}


def feq_bad(a, b, scale) -> int:
    """Lanes outside tests/test_conformance.py's FEQ (_feq :37-44)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    tol = scale * np.finfo(np.float32).eps * np.maximum(
        np.maximum(np.abs(a), np.abs(b)), 1e-20)
    return int((np.abs(a - b) > tol).sum())


def conf_check(name, got, want) -> int:
    """Lanes of got (a kernel's output) off want under the case's bar."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if name in FEQ_SCALE:
        return feq_bad(got, want, FEQ_SCALE[name])
    return int((got.view(np.int32) != want.view(np.int32)).sum())


def phase_g1(dev):
    """Every conformance kernel on the tier's (8, 128) inputs (counted),
    against numpy f32 on the host and against its plain version on the
    card (the torch CUDA ops), then the same on 384,000 elements against
    the plain version."""
    from quadray_tpu_torch.ops import conformance as cf
    cf.launches = 0
    runs = {}
    for name in cf.CASES:
        host = cf.case_inputs(name)
        args = [torch.from_numpy(a).to(dev) for a in host]
        runs[name] = (host, args, cf.conformance(name, *args))
    torch.cuda.synchronize()
    launches = cf.launches
    worst, fails = 0.0, []
    for name, (host, args, got) in runs.items():
        with np.errstate(all="ignore"):
            ref = NUMPY_REF[name](*host)
        card = cf.plain(name, *args)
        big = [torch.from_numpy(a).to(dev)
               for a in cf.case_inputs(name, rows=G_ROWS)]
        got_big, card_big = cf.conformance(name, *big), cf.plain(name, *big)
        g = got.cpu().numpy()
        bad = (conf_check(name, g, ref), conf_check(name, g, card.cpu()),
               conf_check(name, got_big.cpu(), card_big.cpu()))
        bits = int((got.view(torch.int32) != card.view(torch.int32)).sum())
        err = float((got - card).abs().max())
        worst = max(worst, err, float((got_big - card_big).abs().max()))
        bar = (f"FEQ {FEQ_SCALE[name]:g}" if name in FEQ_SCALE
               else "bitwise")
        log(f"G1 {name}: bar={bar} off_vs_numpy={bad[0]} "
            f"off_vs_plain_on_card={bad[1]} off_vs_plain_at_{G_ROWS}x128="
            f"{bad[2]} lanes_not_bitwise_vs_plain={bits} max_abs={err:.3e}")
        if any(bad):
            fails.append(name)
    log(f"G1 conformance launches (the 15 cases at 8x128): {launches}")
    if fails or launches != len(cf.CASES):
        raise AssertionError(f"G1: cases off their bar: {fails}; launches "
                             f"{launches}")
    return launches, worst


def phase_g2(dev):
    """The Whitted kernel against the plain tracer on 2048 random
    non-camera rays (tests/test_conformance.py:215-246), bitwise."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.conformance import random_rays
    from quadray_tpu_torch.ops.trace import TraceConfig, trace_rays
    cfg = TraceConfig(stack=4, max_segments=12)
    for name, seed in (("test01", 1), ("test10", 10), ("test17", 17)):
        sc = compiled(name, dev)
        org, dirs = (torch.from_numpy(a).to(dev)
                     for a in random_rays(2048, seed))
        tmin = torch.zeros((2048,), dtype=torch.float32, device=dev)
        got = ck.trace_rays_cuda(sc, org, dirs, tmin, cfg)
        want = trace_rays(sc, org, dirs, tmin, cfg)
        torch.cuda.synchronize()
        nd = int((got.view(torch.int32) != want.view(torch.int32))
                 .any(dim=1).sum())
        lit = float((got.amax(dim=1) > 0).float().mean())
        log(f"G2 {name} 2048 random rays: lanes_differing={nd} max_abs="
            f"{float((got - want).abs().max()):.3e} lit_lanes={lit:.4f}")
        if nd:
            raise AssertionError(f"G2 {name}: {nd} lanes differ")


def phase_g3(dev):
    """Each conformance kernel at 384,000 elements against its plain
    version and the one PyTorch call that computes its function; the
    bounds (bytes: each input read once, the output written once)."""
    from quadray_tpu_torch.ops import conformance as cf
    rows = {}
    for name in cf.CASES:
        args = [torch.from_numpy(a).to(dev)
                for a in cf.case_inputs(name, rows=G_ROWS)]
        n = args[0].numel()
        wall = cuda_ms(lambda: cf.conformance(name, *args), G_REPS)
        ms = graph_ms(lambda: cf.conformance(name, *args), G_REPS)
        plain = graph_ms(lambda: cf.plain(name, *args), G_REPS)
        lib = (graph_ms(lambda: LIBRARY[name](*args), G_REPS)
               if name in LIBRARY else None)
        bound = bound_ms(n * 4 * (len(args) + 1), n * CASE_OPS.get(name, 1))
        rows[name] = (ms, plain, lib, bound)
        log(f"G3 {name} {n} elements, device ms (CUDA graphs): kernel="
            f"{ms:.5f} plain={plain:.5f} library="
            f"{'none' if lib is None else f'{lib:.5f}'} kernel/library="
            f"{'none' if lib is None else f'{ms / lib:.3f}'} bound="
            f"{bound[0]:.5f} ({bound[1]}); kernel through the wrapper, "
            f"launch to launch: {wall:.4f}")
    return rows


# ---- phase H: bounding-sphere culling -----------------------------------------

def _bits(t):
    return t.contiguous().view(torch.int32)


@contextlib.contextmanager
def cull_every_scene(name: str = "CULL_MIN_SURFACES"):
    """cull_gates' floor of real surfaces (``name``: the Whitted modes',
    or PT's PT_CULL_MIN_SURFACES) lowered to 1 inside the block, so that
    every scene with bounding spheres culls (kernel and plain version
    alike: both ask cull_gates); yields the floor it lowered."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    floor = getattr(ck, name)
    setattr(ck, name, 1)
    try:
        yield floor
    finally:
        setattr(ck, name, floor)


def phase_h1(dev):
    """Every golden scene at 800x480: the culled kernel against the
    unculled one, bitwise, in the four Whitted modes; the culled frames'
    bad pixels."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.rays import resolve_aa
    from quadray_tpu_torch.ops.trace import TraceConfig, to_frame
    from quadray_tpu_torch.utils.image import load_bmp, frame_cmp
    on, off = TraceConfig(), TraceConfig(cull=False)
    t_on, t_off = train_cfg(), train_cfg()._replace(cull=False)
    k1 = ck.ROUNDS_K1
    fails = []
    for n in SCENES:
        sc = compiled(n, dev)
        struct = ck.scene_struct(sc)
        rays = primary(sc, W, H)
        gates = ck.cull_gates(struct, on)
        if not gates.cull:
            raise AssertionError(f"H1 {n}: the forced gate does not cull")
        checks = {}
        cols = ck.trace_rays_cuda(sc, *rays, on, struct)
        checks["whole"] = torch.equal(
            _bits(cols), _bits(ck.trace_rays_cuda(sc, *rays, off, struct)))
        if not struct.can_push:
            pc, pp = ck.trace_paths(sc, *rays, t_on, K_PATHS)
            qc, qp = ck.trace_paths(sc, *rays, t_off, K_PATHS)
            checks["paths"] = torch.equal(pp, qp) and torch.equal(
                _bits(pc), _bits(qc))
            rounds = []
            for cfg in (on, off):
                ec, es = ck.trace_rays_emit_cuda(sc, *rays, cfg, k1, struct)
                emitted = ec.clone()
                idx, count = ck.compact_active(es)
                rc = ck.trace_rays_resume_cuda(sc, es, ec, idx, count, cfg,
                                               k1, struct)
                rounds.append((emitted, es, rc))
            checks["emit"] = all(torch.equal(_bits(a), _bits(b)) for a, b in
                                 zip(rounds[0][:2], rounds[1][:2]))
            checks["resume"] = torch.equal(_bits(rounds[0][2]),
                                           _bits(rounds[1][2]))
        torch.cuda.synchronize()
        img = resolve_aa(torch.clamp(cols, 0.0, 1.0), W, H, 1)
        nbad, _ = frame_cmp(load_bmp(os.path.join(GOLDEN, f"ref_{n}.bmp")),
                            to_frame(img, sc.use_gamma).cpu().numpy(),
                            t_diff=3)
        ok = all(checks.values()) and nbad == GOLDEN_BAD.get(n, 0)
        log(f"H1 {n} {W}x{H}: gates cull={gates.cull} lsort={gates.lsort} "
            f"cont={gates.cont} culled==unculled "
            + " ".join(f"{k}={v}" for k, v in checks.items())
            + f" bad_px={nbad}{'' if ok else '  FAIL'}")
        if not ok:
            fails.append(n)
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"H1: culled output differs or bad pixels "
                             f"moved: {fails}")


def cull_shares(stats) -> str:
    """The share of the surface tests that the cull masks skip."""
    out = []
    for k in ("nearest_tests", "shadow_tests"):
        kept, culled = stats.get(k + "_kept", 0), stats.get(k + "_culled", 0)
        out.append(f"{k}: kept={kept} culled={culled} share_culled="
                   f"{culled / max(kept + culled, 1):.4f}")
    kept = stats.get("nearest_tests_kept", 0) + stats.get(
        "shadow_tests_kept", 0)
    culled = stats.get("nearest_tests_culled", 0) + stats.get(
        "shadow_tests_culled", 0)
    out.append(f"all: share_culled={culled / max(kept + culled, 1):.4f}")
    return "; ".join(out)


def phase_h3(dev, floor: int):
    """The Whitted kernel's device ms culled (every scene culls: the floor
    is lowered) and unculled on every golden scene (CUDA graphs, turns on
    off off on), beside whether the default gate culls it; on PHASE_H3's
    scenes the plain version's count of the surface tests culling keeps
    and skips."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import TraceConfig, trace_rays
    on, off = TraceConfig(), TraceConfig(cull=False)
    rows = {}
    for n in SCENES:
        sc = compiled(n, dev)
        struct = ck.scene_struct(sc)
        rays = primary(sc, W, H)
        with_floor = (struct.n_real >= floor
                      and ck.cull_gates(struct, on).cull)
        stats = {}
        if n in PHASE_H3:
            trace_rays(sc, *rays, on, stats)
            torch.cuda.empty_cache()
        fns = {"on": lambda: ck.trace_rays_cuda(sc, *rays, on, struct),
               "off": lambda: ck.trace_rays_cuda(sc, *rays, off, struct)}
        times = {k: [] for k in fns}
        for k in ("on", "off", "off", "on"):
            times[k].append(graph_ms(fns[k], F3_REPS))
        work = (f"{work_line(stats)}; {cull_shares(stats)}; "
                if stats else "")
        log(f"H3 {n} {W}x{H} ({struct.n_real} surfaces, culled by "
            f"default: {with_floor}): {work}whitted "
            f"device ms culled {np.mean(times['on']):.4f} unculled "
            f"{np.mean(times['off']):.4f}")
        rows[n] = (stats, times, with_floor)
    return rows


@contextlib.contextmanager
def ck_value(name: str, value: int):
    """ops/cuda_kernel.py's constant `name` (COOP_MAX_LIVE,
    RESUME_WARP_MAX, EMIT_OWN_MIN_KEPT) set to value inside the block."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    default = getattr(ck, name)
    setattr(ck, name, value)
    try:
        yield default
    finally:
        setattr(ck, name, default)


def phase_h4(dev):
    """Every golden scene at 800x480, culled (called with the floor
    lowered): the Whitted kernel with the cooperative tail off, at its
    default and from the first segment, bitwise equal frames with the
    exact bad-pixel counts; the device ms of each setting (CUDA graphs,
    turns 0 d 32 32 d 0)."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.rays import resolve_aa
    from quadray_tpu_torch.ops.trace import TraceConfig, to_frame
    from quadray_tpu_torch.utils.image import load_bmp, frame_cmp
    cfg = TraceConfig()
    settings = (0, ck.COOP_MAX_LIVE, 32)
    fails, rows, modes = [], {}, set()
    for n in SCENES:
        sc = compiled(n, dev)
        struct = ck.scene_struct(sc)
        if not ck.cull_gates(struct, cfg).cull:
            raise AssertionError(f"H4 {n}: the forced gate does not cull")
        modes.add(struct.can_push)
        rays = primary(sc, W, H)
        cols = {}
        for c in settings:
            with ck_value("COOP_MAX_LIVE", c):
                cols[c] = ck.trace_rays_cuda(sc, *rays, cfg, struct)
        torch.cuda.synchronize()
        same = all(torch.equal(_bits(cols[c]), _bits(cols[0]))
                   for c in settings)
        img = resolve_aa(torch.clamp(cols[0], 0.0, 1.0), W, H, 1)
        nbad, _ = frame_cmp(load_bmp(os.path.join(GOLDEN, f"ref_{n}.bmp")),
                            to_frame(img, sc.use_gamma).cpu().numpy(),
                            t_diff=3)
        times = {c: [] for c in settings}
        for c in settings + settings[::-1]:
            with ck_value("COOP_MAX_LIVE", c):
                times[c].append(graph_ms(
                    lambda: ck.trace_rays_cuda(sc, *rays, cfg, struct),
                    F3_REPS))
        ms = {c: float(np.mean(times[c])) for c in settings}
        ok = same and nbad == GOLDEN_BAD.get(n, 0)
        log(f"H4 {n} {W}x{H} ({struct.n_real} surfaces, can_push="
            f"{struct.can_push}): coop 0 == {settings[1]} == 32: {same} "
            f"bad_px={nbad}; whitted device ms "
            + " ".join(f"coop{c}={ms[c]:.4f}" for c in settings)
            + ("" if ok else "  FAIL"))
        if not ok:
            fails.append(n)
        rows[n] = ms
        del cols
        torch.cuda.empty_cache()
    if fails or modes != {False, True}:
        raise AssertionError(f"H4: frames differ or bad pixels moved: "
                             f"{fails}; branch modes {sorted(modes)}")
    return rows


# ---- phase I: RESUME's two modes and EMIT's per-ray masks -------------------

# I2: RESUME's switch (warp_max) swept; "n" is every ray (always sparse)
PHASE_I2 = [0, 512, 1024, 2048, 4096, 8192, 16384, 32768, "n"]


def single_branch_cases(dev):
    """The golden scenes without a branch stack at 800x480: (name, scene,
    struct, camera rays, render_cuda's frame)."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import TraceConfig
    cases = []
    for n in SCENES:
        sc = compiled(n, dev)
        struct = ck.scene_struct(sc)
        if struct.can_push:
            continue
        cases.append((n, sc, struct, primary(sc, W, H),
                      ck.render_cuda(sc, W, H, 1, TraceConfig(), struct)))
    torch.cuda.synchronize()
    return cases


def phase_i1(dev, cases):
    """The counted run of RESUME's modes: the 19 single-branch golden
    scenes at 800x480 through trace_rays_rounds at k1 = ROUNDS_K1 and
    WAVE_K1, EMIT with per-ray masks after the camera segment (its
    default), RESUME forced sparse (warp_max = n: a warp per survivor),
    forced dense (0: a thread each, per-ray masks) and at RESUME_WARP_MAX:
    every frame bitwise render_cuda's, inside its budget, with the exact
    bad-pixel counts of phase H; one emit and one resume launch a call,
    the monolithic kernel none (the counts zeroed right before, read right
    after)."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.rays import resolve_aa
    from quadray_tpu_torch.ops.trace import TraceConfig, to_frame
    from quadray_tpu_torch.utils.image import load_bmp, frame_cmp
    cfg = TraceConfig()
    counters = ("emit_launches", "resume_launches", "launches")
    for c in counters:
        setattr(ck, c, 0)
    runs = []
    for n, sc, struct, rays, mono in cases:
        for k1 in (ck.ROUNDS_K1, ck.WAVE_K1):
            for mode, wm in (("sparse", rays[1].shape[0]), ("dense", 0),
                             ("default", ck.RESUME_WARP_MAX)):
                with ck_value("RESUME_WARP_MAX", wm):
                    runs.append((n, k1, mode, ck.trace_rays_rounds(
                        sc, *rays, cfg, k1, struct)))
    torch.cuda.synchronize()
    totals = {c: getattr(ck, c) for c in counters}
    byname = {c[0]: c for c in cases}
    fails = []
    for n, k1, mode, cols in runs:
        _, sc, _, _, mono = byname[n]
        img = resolve_aa(torch.clamp(cols, 0.0, 1.0), W, H, 1)
        same = torch.equal(_bits(img), _bits(mono))
        nbad, _ = frame_cmp(load_bmp(os.path.join(GOLDEN, f"ref_{n}.bmp")),
                            to_frame(img, sc.use_gamma).cpu().numpy(),
                            t_diff=3)
        ok = (same and nbad == GOLDEN_BAD.get(n, 0)
              and nbad <= BUDGET.get(n, 0))
        if not ok or mode == "default":
            log(f"I1 {n} k1={k1} resume {mode}: bitwise_vs_render_cuda="
                f"{same} bad_px={nbad}{'' if ok else '  FAIL'}")
        if not ok:
            fails.append(f"{n} k1={k1} {mode}")
    want = len(runs)
    log(f"I1 {len(cases)} single-branch scenes x 2 k1 x 3 RESUME modes: "
        f"launches {totals} (want emit = resume = {want}, monolithic 0); "
        f"frames off: {fails or 'none'}")
    if (fails or len(cases) != 19 or totals["emit_launches"] != want
            or totals["resume_launches"] != want or totals["launches"]):
        raise AssertionError(f"I1: failed {fails}; launches {totals}; "
                             f"scenes {len(cases)}")
    return totals


def phase_i2(dev, cases):
    """The sweep behind RESUME_WARP_MAX: on each single-branch golden scene
    at 800x480 and k1 = ROUNDS_K1 and WAVE_K1, the resume kernel's device
    ms (CUDA graphs, the values in turns forward and back) at every
    PHASE_I2 warp_max, from one emitted state; the sums over the 38 cases
    and the value with the smallest."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import TraceConfig
    cfg = TraceConfig()
    sums = {v: 0.0 for v in PHASE_I2}
    rows = {}
    for n, sc, struct, rays, _ in cases:
        for k1 in (ck.ROUNDS_K1, ck.WAVE_K1):
            cols, state = ck.trace_rays_emit_cuda(sc, *rays, cfg, k1, struct)
            idx, count = ck.compact_active(state)
            N = rays[1].shape[0]
            times = {v: [] for v in PHASE_I2}
            for v in PHASE_I2 + PHASE_I2[::-1]:
                with ck_value("RESUME_WARP_MAX", N if v == "n" else v):
                    times[v].append(graph_ms(
                        lambda: ck.trace_rays_resume_cuda(
                            sc, state, cols, idx, count, cfg, k1, struct),
                        F3_REPS))
            ms = {v: float(np.mean(t)) for v, t in times.items()}
            for v in PHASE_I2:
                sums[v] += ms[v]
            rows[(n, k1)] = (int(count), ms)
            log(f"I2 {n} k1={k1} survivors={int(count)}: resume device ms "
                + " ".join(f"{v}={ms[v]:.4f}" for v in PHASE_I2))
            del cols, state, idx, count
        torch.cuda.empty_cache()
    best = min(PHASE_I2, key=lambda v: sums[v])
    log("I2 sums over the 38 cases: " + " ".join(
        f"{v}={sums[v]:.4f}" for v in PHASE_I2) + f"; smallest at {best}; "
        f"RESUME_WARP_MAX = {ck.RESUME_WARP_MAX} sums "
        f"{sums.get(ck.RESUME_WARP_MAX, float('nan')):.4f}")
    return rows, sums, best


# ---- phase J: the interactive and developer entry points ---------------------

# J2's key trace (render_cli -k, one token a frame): all ten camera
# actions, a2 then a1, q twice (PT on frames 14-16, a move among them),
# f4 and f1; the frames J2 holds against the plain version: after a move,
# after a rotation, at a2
J2_TRACE = (".,w,s,a,d,rise,fall,left,right,up,down,a2,w+left,a1,q,w,.,q,"
            "f4,f1,w,left,s,right,rise,down,fall,up,d,.")
J2_CHECKED = {1: "move", 7: "rotation", 11: "a2"}
J2_FRAMES = 30
J2_SCENES = ("demo01", "demo02", "demo03")
# J3: its scenes, their trace, frame count and runs
J3_SCENES = ("demo01", "demo02", "demo03", "test13")
J3_TRACE = "w,left,w,right,s,up,d,down,a,."
J3_FRAMES = 60
J3_RUNS = 2
# J3's frames whose full compile and pack are timed beside the update
J3_FULL = 10
# phase O: eager against graphed in this order (a b b a), the passes of
# the test18 run checkpointed and resumed, and the frames or passes of
# each profiler window
O_ABBA = ("eager", "graph", "graph", "eager")
# phase P: steps graphed against eager, on these block counts of cuda:0;
# one-step calls under the profiler
P_STEPS = 10
P_BLOCKS = (1, 4)
P_PROFILED = 3
O_CHECKPOINT = 32
O_PROFILED = 10
# phase Q: the all-surface step (make_train_step) on the two golden scenes
# where a material both reflects and transmits (the fast steps refuse
# them), every differentiable field: Q1 one step on the card against the
# CPU at this frame, within tests/test_torch_step_graph.py's bounds; Q2
# steps graphed against eager on these block counts of cuda:0 at 800x480;
# Q3 BASELINE.json config 5's frame on the fewest blocks whose memory,
# at Q2's peak a ray, fits in this share of the card, and the trace-replay
# scan on demo03
Q_SCENES = ("test17", "test18")
Q1_W, Q1_H = 64, 40
Q_LOSS_RTOL, Q_PARAM_ATOL = 1e-4, 1e-4
Q_BLOCKS = (1, 4)
Q_STEPS = 3
Q3_W, Q3_H = 1920, 1080
Q3_MEMORY = 0.85
Q3_STEPS = 2
# ops/trace.py's record_function ranges, one a lookup family
LOOKUP_RANGES = "lookup."
# profile_window's warm-up calls: in whole runs of this script a profile
# lost its first 31 to 45 device records, so the warm-up holds more than
# that (the smallest window, O5's interactive frame, 33 records a call)
PROFILE_WARMUP = 3
# what Q2's graphed profiler window must list: the fused route's kernels
Q2_WINDOW_KERNELS = ("tape_kernel", "diff_bwd_kernel", "light_group_kernel",
                     "light_sum_kernel")
# phase T: the fused all-surface route's kernels on these scenes (two-plane
# surfaces, apex-singular cylinders, a texture and metal; Fresnel glass in
# a box; glass spheres) at 800x480; the gradients against autograd's
# trace_rays_diff on the card within this share of each field's largest
# (tests/test_torch_diff_fused.py's float32 bound: each route's own f32
# rounding, amplified by chains of internal reflections; 1e-5 does not
# hold at 800x480 on test15 or test18)
T_SCENES = ("test15", "test17", "test18")
T_GRAD_RTOL = 5e-5
T_REPS = 5
# T's Schlick and deep-stack cases (t_cfg), each bitwise its plain version;
# the deep stack: with no throughput cutoff each glass hit both reflects
# and transmits, so test18's stacks pass the kernels' 16 local slots (its
# scratch in device memory); its gradients against autograd's route at a
# smaller frame (autograd keeps every one of 48 bounces)
T_EXTRA = (("schlick", "test17"), ("schlick", "test18"), ("deep", "test17"),
           ("deep", "test18"))
T_DEEP = dict(depth=24, max_segments=48, stack=24, cutoff=0.0)
T_DEEP_GRAD_W, T_DEEP_GRAD_H = 200, 120
# T's scene whose backward accumulators (256 surfaces: 79 KB a block) pass
# the 48 KB a launch gets without the opt-in, held bitwise at the step's cfg
T_SMEM_SCENE = "demo03"


@contextlib.contextmanager
def quiet_in_tempdir():
    """Run an app in a fresh working directory (its dump/ files go there)
    with its standard output kept, not printed; yields the buffer."""
    import io
    import tempfile
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
            contextlib.redirect_stdout(buf):
        yield buf


def phase_j1():
    """core_test -b 1 -e 18 -k at 800x480 on the card, in-process."""
    from quadray_tpu_torch.apps import core_test
    from quadray_tpu_torch.ops import cuda_kernel as ck
    ck.launches = 0
    with quiet_in_tempdir():
        res = core_test.run(["-b", "1", "-e", "18", "-k"])
    launches = ck.launches
    fails = []
    for name, r in res["levels"].items():
        want = GOLDEN_BAD.get(name, 0)
        ok = r["nbad"] == want and r["kernel_diff"] <= ATOL
        log(f"J1 {name}: bad_px={r['nbad']} (H1: {want}) kernel_vs_plain="
            f"{r['kernel_diff']:.3e} frame_ms={r['ms']:.1f}"
            f"{'' if ok else '  FAIL'}")
        if not ok:
            fails.append(name)
    log(f"J1 core_test: {res['failures']} run levels with differences "
        f"(test11, test14, test16 as H1), whitted launches={launches}")
    if fails or len(res["levels"]) != 18 or res["failures"] != 3 \
            or launches < 36:
        raise AssertionError(f"J1: {fails}, failures={res['failures']}, "
                             f"launches={launches}")
    return launches


def camera_replay(sdef, tokens, frames):
    """The camera render_cli's loop leaves behind, replayed on the host
    through CameraController: the first action takes the scene's camera
    with its clock at the last update's time; each frame's update
    advances it to the frame's time."""
    from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS, frame_time
    from quadray_tpu_torch.engine import CameraController, _find_camera
    cam, last = None, 0.0
    for fi in range(frames):
        t = frame_time(fi)
        for key in tokens[fi % len(tokens)].split("+"):
            if key in KEY_ACTIONS:
                if cam is None:
                    cam = CameraController(*_find_camera(sdef.root))
                    cam.advance(last)
                cam.update_action(t, KEY_ACTIONS[key])
        if cam is not None:
            cam.advance(t)
        last = t
    return cam


def replay_scene(name, tokens, dev, upto):
    """A second Scene driven by the camera and antialiasing tokens of
    render_cli's loop, frame by frame up to frame ``upto``: yields (fi,
    scene) after each frame's update (compile_scene with the camera), as
    the app's Scene.render runs it, without rendering."""
    from quadray_tpu_torch import Platform, Scene
    from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS, frame_time
    from quadray_tpu_torch.models.scenes import demos
    pfm = Platform()
    sc = Scene(demos.build(name), W, H, pfm=pfm, device=dev)
    for fi in range(upto + 1):
        t = frame_time(fi)
        for key in tokens[fi % len(tokens)].split("+"):
            if key in KEY_ACTIONS:
                sc.update_action(t, KEY_ACTIONS[key])
            elif key in ("a1", "a2", "a4"):
                pfm.set_fsaa(int(key[1]))
            elif key not in (".", "f1", "f4"):
                raise ValueError(f"replay_scene: token {key} at frame {fi}")
        sc.update(t)
        yield fi, sc


def phase_j2(dev):
    """render_cli -i on demo01-03 at 800x480, J2_FRAMES frames each, one
    key trace: every Whitted frame one Whitted launch, every PT frame one
    PT launch; the frames it saved at J2_CHECKED against the plain version
    on a second Scene replayed through the same tokens (the kernel's
    linear frame within ATOL of the plain one on the same compiled arrays
    and TraceConfig, the saved frame equal to the plain uint8 frame); the
    final camera against a host replay."""
    from quadray_tpu_torch.apps import render_cli
    from quadray_tpu_torch.models.scenes import demos
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import TraceConfig, render, to_frame
    from quadray_tpu_torch.utils.image import load_bmp
    tokens = J2_TRACE.split(",")
    total = {"whitted": 0, "pt": 0}
    for name in J2_SCENES:
        ck.launches = ck.pt_launches = 0
        with quiet_in_tempdir() as out:
            st = render_cli.main(["-d", name[-1], "-f", str(J2_FRAMES), "-i",
                                  "-k", J2_TRACE])
            saved = {fi: load_bmp(f"dump/demo{name[-1].zfill(2)}_f"
                                  f"{fi:04d}.bmp") for fi in J2_CHECKED}
        whitted, pt = ck.launches, ck.pt_launches
        checked = {}
        for fi, sc in replay_scene(name, tokens, dev, max(J2_CHECKED)):
            if fi not in J2_CHECKED:
                continue
            lin = sc.render_linear()
            plain = render(sc.arrays, W, H, sc.pfm.fsaa,
                           TraceConfig(depth=sc.pfm.depth))
            checked[fi] = (
                float((lin - plain).abs().max()),
                np.array_equal(saved[fi], to_frame(
                    plain, sc.arrays.use_gamma).cpu().numpy()),
                sc.pfm.fsaa)
            del lin, plain
            torch.cuda.empty_cache()
        cam = st["scene"].camera
        ref = camera_replay(demos.build(name), tokens, J2_FRAMES)
        cam_ok = cam.pos == ref.pos and cam.rot == ref.rot
        for fi, (err, eq, fsaa) in sorted(checked.items()):
            log(f"J2 {name} frame {fi} ({J2_CHECKED[fi]}, fsaa={fsaa}): "
                f"replayed kernel max_abs vs plain={err:.3e}, app's saved "
                f"frame equal to plain uint8={eq}")
        log(f"J2 {name}: {st['frames']} frames, whitted={st['whitted_frames']}"
            f" launches={whitted}, pt={st['pt_frames']} launches={pt}, "
            f"camera pos={cam.pos} rot={cam.rot} host replay equal={cam_ok}, "
            f"AVG FPS={st['avg_fps']:.2f} (app, with f1, f4 and -i), "
            f"f1 lines={out.getvalue().count('cam_pos')}")
        ok = (whitted == st["whitted_frames"] and pt == st["pt_frames"]
              and st["pt_frames"] >= 1 and cam_ok
              and st["whitted_frames"] + st["pt_frames"] == J2_FRAMES
              and len(checked) == len(J2_CHECKED)
              and all(c[0] <= ATOL and c[1] for c in checked.values()))
        if not ok:
            raise AssertionError(f"J2 {name} failed")
        total["whitted"] += whitted
        total["pt"] += pt
    return total


def eager_render(sc, t):
    """Scene.render's Whitted frame issued op by op, as before the frame
    programs (the yardstick they are held to): the update, render_linear
    (render_cuda: camera rays, the kernel, clamp, the AA mean), to_frame
    and a pageable copy to the host."""
    from quadray_tpu_torch.ops.trace import to_frame
    sc.update(t)
    return to_frame(sc.render_linear(), sc.arrays.use_gamma).cpu().numpy()


def eager_render_pt(sc, w, h, seeds, spp, cfg, struct=None):
    """render_pt_cuda issued op by op, as before the pass programs: spp
    passes of pt_passes from a zero sum, then the mean."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=seeds.device)
    acc, seeds = ck.pt_passes(sc, w, h, acc, seeds, spp, cfg, struct)
    return (acc / float(max(spp, 1))).reshape(h, w, 3), seeds


# J3's ways to render a frame: eager_render, or Scene.render, which
# replays the scene's interactive program (ops/graphs.py: the update, the
# pack and the frame in one graph)
J3_RENDER = {"eager": eager_render, "graph": lambda sc, t: sc.render(t)}


@contextlib.contextmanager
def timed_render_calls(sc, mode: str = "graph"):
    """Time the calls a frame makes, in place, on ``sc``. "eager": the
    host clock around sc.update (the incremental update) and around
    ck._get_packed (the tables whose fields moved), and a CUDA event pair
    around the Whitted kernel's launch (recorded after the launch inputs
    are ready and after trace_rays_cuda returns). "graph": the host clock around the interactive program's
    host update (InteractiveProgram.stage_values: the structure's check,
    the animators, the camera and its sin and cos, the pinned write), no
    table build on the host (0), and the event pair around its launch
    (the replay of the graph that updates, packs and renders). No
    synchronisation is added. Yields a dict of per-call lists: update and
    pack (host ms), kernel (event pairs)."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import graphs
    rec = {"update": [], "pack": [], "kernel": []}
    saved = {k: getattr(ck, k) for k in ("_get_packed", "_launch_inputs",
                                         "trace_rays_cuda")}
    launch = graphs.InteractiveProgram.launch
    stage = graphs.InteractiveProgram.stage_values

    def host_timed(key, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            rec[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def launch_inputs(*a, **k):
        out = saved["_launch_inputs"](*a, **k)
        rec["kernel"].append([event(), None])
        return out

    def trace(*a, **k):
        out = saved["trace_rays_cuda"](*a, **k)
        rec["kernel"][-1][1] = event()
        return out

    def replay(prog):
        start = event()
        launch(prog)
        rec["kernel"].append([start, event()])
        rec["pack"].append(0.0)

    if mode == "graph":
        graphs.InteractiveProgram.stage_values = host_timed("update", stage)
        graphs.InteractiveProgram.launch = replay
    else:
        sc.update = host_timed("update", sc.update)
        ck._get_packed = host_timed("pack", saved["_get_packed"])
        ck._launch_inputs = launch_inputs
        ck.trace_rays_cuda = trace
    try:
        yield rec
    finally:
        if mode == "graph":
            graphs.InteractiveProgram.stage_values = stage
            graphs.InteractiveProgram.launch = launch
        else:
            del sc.update
        for k, v in saved.items():
            setattr(ck, k, v)


def j3_scene(name):
    from quadray_tpu_torch.models.scenes import demos
    from quadray_tpu_torch.models.scenes.loader import load_scene
    return demos.build(name) if name.startswith("demo") else load_scene(name)


def full_compile(sc, t, cam_trm):
    """The plain version of a Scene's update at (t, cam_trm):
    compile_scene with the scene's options, camera index and shapes."""
    from quadray_tpu_torch.scene import schema as S
    from quadray_tpu_torch.scene.compile import compile_scene
    return compile_scene(S.SceneDef(root=sc.sdef.root, opts=sc.opts),
                         time=t, cam_index=sc.cam_index, cam_trm=cam_trm,
                         device=sc.device, **sc._shapes)


def full_update_ms(sc, frames):
    """Host ms of the full compile_scene and of a full pack_scene (culled,
    as render_cuda packs) at each (t, cam_trm) of ``frames``, each timed
    after a synchronisation, none added inside."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    comp, pack = [], []
    for t, cam_trm in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = full_compile(sc, t, cam_trm)
        t1 = time.perf_counter()
        ck.pack_scene(full, sc._struct)
        t2 = time.perf_counter()
        comp.append((t1 - t0) * 1e3)
        pack.append((t2 - t1) * 1e3)
    torch.cuda.synchronize()
    return float(np.mean(comp)), float(np.mean(pack))


def update_steps_ms(sc, frames):
    """Host ms of each step of the incremental update and of each pack
    part it can re-pack, called directly at each (t, cam_trm) of
    ``frames`` on the Scene's recorded structure, each call followed by a
    synchronisation: the structure check, the animators and camera
    (local_values), their sin and cos (local_inputs), the update's launch
    for every group the scene can move (ops.update.moved_fields, its
    pinned copy included), the plain version (moved_fields) and its
    staged copy, the one pack launch of the
    PACK_PARTS entries that read a field of those groups (what a frame's
    table build launches), and each of those parts alone: a launch of
    that part only, and its plain version. Means over the frames."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import update as upd
    from quadray_tpu_torch.scene import compile as C
    st, struct = sc._structure, sc._struct
    groups = st.moving
    moved = {k for g in groups for k in C.MOVED_GROUPS[g]}
    stt = ck._struct_tensors(struct, sc.device)
    names = tuple(n for n, _, reads in ck.PACK_PARTS if moved & set(reads))
    rec = {}

    def timed(key, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        rec.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for t, cam_trm in frames:
        timed("check", st.check)
        vals = timed("animators and camera", st.local_values, t, cam_trm)
        inp = timed("sin and cos (local_inputs)", st.local_inputs, vals)
        timed("update launch (pinned copy, launch)", upd.moved_fields, st,
              groups, inp)
        fields = timed("moved fields (plain)", st.moved_fields, groups,
                       vals)
        timed("staged copy (plain)", C._staged, fields, sc.device)
        if names:
            timed(f"pack launch of {'+'.join(names)}", ck.pack_parts,
                  names, sc.arrays, struct, stt)
        for name, fn, _ in ck.PACK_PARTS:
            if name in names:
                timed(f"{name} launch", ck.pack_parts, (name,), sc.arrays,
                      struct, stt)
                timed(f"{name} plain", fn, sc.arrays, struct, stt)
    return {k: float(np.mean(v)) for k, v in rec.items()}


def phase_j3(dev, smi, modes=("graph",) * J3_RUNS, label="J3",
             extras=True):
    """The interactive frame's cost at 800x480: a frame after the trace's
    camera action, every frame the incremental update (the numeric pass
    and the tables its moved fields feed). Per scene a run of J3_FRAMES
    frames for each of ``modes``, each on a new Scene, as render_cli's
    loop runs them: "graph" Scene.render (one replay of the interactive
    program: the update, the pack and the frame), "eager" eager_render. AVG FPS on the
    host clock, and in the same loop and frames (timed_render_calls)
    ms/frame split into the update, the table build, and the rest (the
    launch or the replay, to_frame, the wait for the card and the copy to
    the host); the device ms of the kernel (eager) or of the frame's whole
    graph (graph) from CUDA events, and the card's share of the
    window (an event pair around the loop) that it kept the card busy;
    the update's launches, the inputs a program staged (Inputs.copies)
    and its warm-up and capture ms. With ``extras``, beside
    the update and the table build, the host ms of a full compile_scene
    and pack_scene (the path before the incremental update) at 10 of the
    same frames' times and cameras, and the update's steps and pack parts
    timed alone at those frames (update_steps_ms)."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS, frame_time
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import update as ud
    tokens = J3_TRACE.split(",")
    sdef = j3_scene
    launches = cull = packs = 0
    results = {}
    for name in J3_SCENES:
        for run, mode in enumerate(modes):
            render = J3_RENDER[mode]
            sc = Scene(sdef(name), W, H, device=dev)
            render(sc, 0.0)      # first compile, kernel structure, capture
            prog = sc._interactive_prog if mode == "graph" else None
            copies0 = prog.inputs.copies if prog is not None else 0
            ck.launches = ck.cull_launches = ck.pack_launches = 0
            ud.launches = 0
            w0, w1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            frame_ms, frames = [], []
            with timed_render_calls(sc, mode) as rec:
                w0.record()
                t0 = time.perf_counter()
                for fi in range(1, J3_FRAMES + 1):
                    tf = time.perf_counter()
                    for key in tokens[fi % len(tokens)].split("+"):
                        if key in KEY_ACTIONS:
                            sc.update_action(frame_time(fi), KEY_ACTIONS[key])
                    render(sc, frame_time(fi))
                    frame_ms.append((time.perf_counter() - tf) * 1e3)
                    if len(frames) < J3_FULL:
                        frames.append((frame_time(fi), sc.camera.trm()
                                       if sc.camera is not None else None))
                dt = time.perf_counter() - t0
                w1.record()
            torch.cuda.synchronize()
            launches += ck.launches
            run_cull, run_pack = ck.cull_launches, ck.pack_launches
            run_upd = ud.launches
            cull += run_cull
            packs += run_pack
            if not (ck.launches == len(rec["update"]) == len(rec["pack"])
                    == len(rec["kernel"]) == J3_FRAMES):
                raise AssertionError(f"{label} {name} {mode}: {ck.launches} "
                                     f"launches, {len(rec['kernel'])} timed")
            if not run_cull <= run_pack <= J3_FRAMES:
                raise AssertionError(f"{label} {name} {mode}: {run_pack} "
                                     f"pack launches ({run_cull} culling) "
                                     f"in {J3_FRAMES} frames")
            kern = [a.elapsed_time(b) for a, b in rec["kernel"]]
            window = w0.elapsed_time(w1)
            upd, pack = np.array(rec["update"]), np.array(rec["pack"])
            rest = np.array(frame_ms) - upd - pack
            full_comp, full_pack = (full_update_ms(sc, frames) if extras
                                    else (float("nan"),) * 2)
            r = dict(mode=mode, fps=J3_FRAMES / dt, ms=dt * 1e3 / J3_FRAMES,
                     update=upd.mean(), pack=pack.mean(), rest=rest.mean(),
                     kernel=float(np.mean(kern)),
                     busy=sum(kern) / window,
                     update_min=upd.min(), update_max=upd.max(),
                     full_compile=full_comp, full_pack=full_pack,
                     update_10=upd[:J3_FULL].mean(),
                     pack_10=pack[:J3_FULL].mean(),
                     cull=run_cull, pack_launches=run_pack,
                     update_launches=run_upd,
                     copies=(prog.inputs.copies - copies0
                             if prog is not None else float("nan")),
                     capture_ms=(prog.replay.ms if prog is not None
                                 else float("nan")),
                     warmup_ms=(prog.replay.warmup_ms if prog is not None
                                else float("nan")),
                     replay_counts=(prog.replay.counts if prog is not None
                                    else {}))
            results.setdefault(name, []).append(r)
            what = "kernel" if mode == "eager" else "frame graph"
            log(f"{label} {name} run {run + 1} ({mode}) {W}x{H} ({smi}): AVG "
                f"FPS={r['fps']:.2f} ms/frame={r['ms']:.3f} = update "
                f"{r['update']:.3f} (min {r['update_min']:.3f}, max "
                f"{r['update_max']:.3f}) + table build {r['pack']:.3f} + "
                f"launch, to_frame, wait and copy {r['rest']:.3f} (mean of "
                f"{J3_FRAMES}, host clock, same loop); {what} device "
                f"{r['kernel']:.4f} ms (CUDA events), card busy with the "
                f"{what} {100 * r['busy']:.2f}% of the {window:.1f} ms "
                f"window; on its first {J3_FULL} frames update {r['update_10']:.3f}"
                f" + table build {r['pack_10']:.3f} against a full "
                f"compile_scene {r['full_compile']:.3f} + pack_scene "
                f"{r['full_pack']:.3f} at the same times and cameras (host "
                f"clock, mean of {J3_FULL}); pack launches "
                f"{r['pack_launches']}, of which wrote culling tables "
                f"{r['cull']}; update launches {run_upd}; inputs staged "
                f"into the program {r['copies']}; the program's warm-up "
                f"and capture {r['capture_ms']:.1f} ms (warm-up's host "
                f"work {r['warmup_ms']:.1f}), its graph's launches "
                f"{r['replay_counts']}")
        if not extras:
            continue
        steps = update_steps_ms(sc, frames)
        results[name][-1]["steps"] = steps
        log(f"J3 {name} steps, each called alone at the last run's first "
            f"{J3_FULL} frames and synchronised (host ms, mean): "
            + ", ".join(f"{k} {v:.4f}" for k, v in steps.items()))
    if cull == 0:
        raise AssertionError("J3: no pack launch wrote a culling table")
    return launches, cull, packs, results


def phase_j4(dev):
    """No silent down-cast: float64 rays, and a float64 scene, raise
    ValueError before any launch."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import scene_astype
    sc = compiled("test01", dev)
    org, dirs, tmin = primary(sc, 64, 40)
    cases = (("f64 rays", sc, org, dirs.double(), tmin),
             ("f64 scene", scene_astype(sc, torch.float64), org.double(),
              dirs.double(), tmin.double()))
    before = ck.launches
    for label, s, o, d, t in cases:
        try:
            ck.trace_rays_cuda(s, o, d, t)
        except ValueError as e:
            log(f"J4 {label}: ValueError: {e}")
        else:
            raise AssertionError(f"J4 {label}: no ValueError")
    if ck.launches != before:
        raise AssertionError("J4: a launch ran")


def phase_j5(dev):
    """plot_fresnel on the card (its default) against -c: the five curves
    within 1e-6 and the six BMPs within 1 LSB."""
    from quadray_tpu_torch.apps import plot_fresnel
    from quadray_tpu_torch.utils.image import load_bmp
    card, cpu = plot_fresnel.curves(device=dev), plot_fresnel.curves(
        device="cpu")
    err = max(float(np.abs(card[k] - cpu[k]).max()) for k in cpu)
    bmps = {}
    for label, argv in (("card", []), ("cpu", ["-c"])):
        with quiet_in_tempdir():
            plot_fresnel.main(argv)
            bmps[label] = {n: load_bmp(f"dump/{n}").astype(np.int32)
                           for n in sorted(os.listdir("dump"))}
    lsb = max(int(np.abs(bmps["card"][n] - bmps["cpu"][n]).max())
              for n in bmps["cpu"])
    log(f"J5 plot_fresnel: curves on the card vs the CPU max_abs={err:.3e}"
        f", {len(bmps['card'])} BMPs, max difference {lsb} LSB")
    if err > 1e-6 or lsb > 1 or len(bmps["card"]) != 6 \
            or bmps["card"].keys() != bmps["cpu"].keys():
        raise AssertionError("J5: plot_fresnel on the card differs")


def phase_j6(dev, label="J6"):
    """J3's trace at 800x480 on demo01-03 and test13 through
    Scene.render, the incremental update held at every frame (the first
    one, the structure pass, and J3_FRAMES more): every SceneArrays field
    bitwise the plain compile_scene's at the same time and camera, every
    packed table the render used (culled, and the unculled tables)
    bitwise a full pack_scene's and the culling tables bitwise their
    plain versions (CULL_PLAIN) on the plain compile, the scene's kernel
    structure equal to scene_struct's of the plain compile, and the frame
    uint8-equal to
    render_cuda's on the plain compile. Scene.render is the interactive
    program's (ops/graphs.py InteractiveProgram): after the first frame
    one replay a frame, which launches the update once, the Whitted
    kernel once and the pack once where the scene's surfaces or lights
    can move (none where only the camera can), every launch counted from
    the graph (the counts set to 0 before each Scene.render and read
    after), and stages no input; the program's field buffers and table
    buffers bitwise the plain compile's fields and a full pack_scene of
    them. The first frame: the structure pass (whose update launch is
    held against compile_scene), the fixed tables' pack, and the
    program's warm-up. Counts, per packed table, the frames that
    re-packed the scene's eager arrays (Scene.arrays after the frame)."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS, frame_time
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import update as upd
    from quadray_tpu_torch.ops.trace import TraceConfig, to_frame
    from quadray_tpu_torch.scene.compile import FIELDS
    tokens = J3_TRACE.split(",")
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    same = lambda a, b: a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(bits(a), bits(b))
    launches = n_cull = n_pack = n_upd = 0
    for name in J3_SCENES:
        sc = Scene(j3_scene(name), W, H, device=dev)
        repacked = {f: 0 for f in ck.PackedScene._fields}
        fails, prev = [], None
        for fi in range(J3_FRAMES + 1):
            t = frame_time(fi)
            for key in tokens[fi % len(tokens)].split("+"):
                if fi and key in KEY_ACTIONS:
                    sc.update_action(t, KEY_ACTIONS[key])
            prog = sc._interactive_prog
            copies = prog.inputs.copies if prog is not None else 0
            ck.launches = ck.cull_launches = ck.pack_launches = 0
            upd.launches = 0
            frame = sc.render(t)
            prog = sc._interactive_prog
            # the first frame: the structure pass's update launch and the
            # warm-up's, the fixed tables' pack and the warm-up's (if any)
            want = (1, 1, int(bool(prog.parts))) if fi else (
                1, 2, 1 + int(bool(prog.parts)))
            got = (ck.launches, upd.launches, ck.pack_launches)
            if got != want or prog.inputs.copies != copies:
                raise AssertionError(
                    f"{label} {name} frame {fi}: whitted, update and pack "
                    f"launches {got} (want {want}), inputs staged "
                    f"{prog.inputs.copies - copies}")
            launches += ck.launches
            n_cull += ck.cull_launches
            n_pack += ck.pack_launches
            n_upd += upd.launches
            arr = sc.arrays
            full = full_compile(sc, t, sc.camera.trm()
                                if sc.camera is not None else None)
            if fi == 0 and ck.scene_struct(full) != sc._struct:
                fails.append("kernel structure")
            bad = [k for k in FIELDS if not same(getattr(arr, k),
                                                 getattr(full, k))]
            bad += [f"program's {k}" for k, v in prog.fields.items()
                    if not same(v, getattr(full, k))]
            tables = ck.pack_scene(full, sc._struct)
            bad += [f"program's {f}" for f in ck.PackedScene._fields
                    if not same(prog.inputs.buf[f], getattr(tables, f))]
            del tables
            for cull in (True, False):
                got = ck._get_packed(arr, sc._struct, cull)
                want = ck.pack_scene(full, sc._struct, cull)
                bad += [f"{f} cull={cull}" for f in ck.PackedScene._fields
                        if not same(getattr(got, f), getattr(want, f))]
                if cull:
                    stt = ck._struct_tensors(sc._struct, dev)
                    bad += [f"{f} vs its plain version" for f in
                            ck.CULL_PARTS if not same(getattr(got, f),
                            ck.CULL_PLAIN[f](full, sc._struct, stt))]
                if cull and prev is not None:
                    for f in repacked:
                        repacked[f] += getattr(got, f) is not getattr(prev, f)
                if cull:
                    prev = got
            lin = ck.render_cuda(full, W, H, sc.pfm.fsaa,
                                 TraceConfig(depth=sc.pfm.depth),
                                 struct=sc._struct)
            if not np.array_equal(frame, to_frame(
                    lin, full.use_gamma).cpu().numpy()):
                bad.append("frame")
            if bad:
                fails.append(f"frame {fi}: {bad}")
            del lin, full
        moved = list(sc._structure.moving)
        log(f"{label} {name} {W}x{H}: {J3_FRAMES + 1} frames through J3's "
            f"trace (the interactive program: after the first frame one "
            f"replay a frame, update, Whitted and pack launches "
            f"{prog.replay.counts}, no input staged; its fields and tables "
            f"bitwise the plain compile's and pack_scene's), "
            f"every field of the incremental update bitwise compile_scene's,"
            f" every packed table (culled and unculled) bitwise pack_scene's"
            f", the culling tables their plain versions' and every frame "
            f"uint8-equal to render_cuda's on the plain "
            f"compile: {'yes' if not fails else fails}; groups the scene "
            f"can move: {moved}; frames that re-packed each table after the "
            f"first: {repacked}")
        if fails:
            raise AssertionError(f"{label} {name}: {fails}")
        del sc, prog
        torch.cuda.empty_cache()
    return launches, n_cull, n_pack, n_upd


def cull_inputs(dev):
    """Phase K's cases: the 21 golden scenes as B compiles them, and J3's
    scenes at 10 frames of its trace's times (their animators move
    demo01's and demo02's spheres and lights)."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.apps.render_cli import frame_time
    from quadray_tpu_torch.ops import cuda_kernel as ck
    for name in SCENES:
        sc = compiled(name, dev)
        yield name, sc, ck.scene_struct(sc)
    for name in J3_SCENES:
        scene = Scene(j3_scene(name), W, H, device=dev)
        for fi in range(1, 11):
            sc = scene.update(frame_time(fi))
            yield f"{name} frame {fi}", sc, scene._struct or \
                ck.scene_struct(sc)


def cull_work(struct, sc) -> dict:
    """The operations of each culling table, counted over what this
    scene's data needs: pad rows and unbounded surfaces take no sphere
    arithmetic (their bits are set), and only plane rows whose materials
    continue have halfspaces. bsph_t: a sqrt a bounded sphere. shad_msk: 9
    a (light, receiver) for the receiver's segment, 3 a (light, blocker)
    for the light-to-blocker vector, 3 a (receiver, blocker) for the
    summed radii squared, 20 a (light, receiver, blocker) for the capsule
    test. cont_msk: 10 a plane row for its normal, 21 a (plane row,
    target) for the signed distance and the slack, 3 a (plane row,
    continuing side, target) for the side's selects."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    nl = struct.nl
    nb = sum(1 for b in struct.bnd if b > 0)
    planes = [struct.perm[r] for g in struct.groups if g.is_plane
              for r in range(g.start, g.start + g.count)]
    props = np.array(struct.props)
    mats = sc.s_mat.cpu().numpy()[planes]
    pm = props[mats]                                    # (planes, 2)
    fres = bool(sc.use_fresnel.item() > 0)
    can_trn = (pm & ck.PROP_OPAQUE) == 0
    can_rfl = ((pm & ck.PROP_REFLECT) != 0) | (fres & can_trn)
    sides = int((can_rfl | can_trn).sum())
    rows = int((can_rfl | can_trn).any(axis=1).sum())
    return {"bsph_t": nb,
            "shad_msk": nl * nb * (9 + 3) + 3 * nb * nb + 20 * nl * nb * nb,
            "cont_msk": 10 * rows + 21 * rows * nb + 3 * sides * nb}


def pack_work(struct, sc, names) -> tuple:
    """The bytes and operations of one pack launch of ``names``: each
    field and structure tensor its parts read, read once, each table
    written once; the culling tables' operations (cull_work), none for
    the copies."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    plan = ck.pack_plan(names, struct, sc.l_pos.shape[0],
                        sc.tex_data.shape[0])
    n_in = sum(getattr(sc, k).numel() * 4 for k, *_ in plan.fields)
    n_in += struct.ns * (8 + 8 * ("sp_i" in plan.names))   # perm, blk, ncl
    n_out = sum(int(np.prod(shape)) * 4 for shape, _ in plan.shapes.values())
    ops = cull_work(struct, sc)
    return n_in + n_out, sum(ops[n] for n in plan.names if n in ops)


def host_ms(fn, reps: int) -> float:
    """The host's ms a call of fn(): reps calls back to back on the host
    clock, without a synchronisation between them (the card runs behind),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / reps


# the parts a J3 frame of demo01 or demo02 re-packs: their spheres and
# lights move (s_pos, s_inv, s_fwd, s_bsph, l_pos)
K_MOVED = ("sp_f", "cl_f", "lg_f", "bsph_t", "shad_msk", "cont_msk")


def phase_k(dev):
    """The scene pack's kernel (csrc/pack.cu) against the plain parts
    (PACK_PARTS) on the card: K1 the launch of every part, of K_MOVED and
    of the training step's seven on every case of cull_inputs, each table
    bitwise, one launch each; K2 on demo02 at a J3 frame (128 rows, three
    lights, the scene whose tables J3 re-packs most), for the three
    culling tables, K_MOVED and a whole pack: the launch's device ms
    against the plain parts' (CUDA graphs of 20 calls), a call's host ms
    (host_ms) and its ms with the host's launch work (CUDA events), and
    the bound (pack_work)."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    subsets = {"every part": ck.PART_NAMES, "J3's moved parts": K_MOVED,
               "the training step's seven": ck.PART_NAMES[:7]}
    fails, n, err, cases = [], 0, 0.0, 0
    for label, sc, struct in cull_inputs(dev):
        cases += 1
        stt = ck._struct_tensors(struct, dev)
        want = {name: fn(sc, struct, stt) for name, fn, _ in ck.PACK_PARTS}
        for what, names in subsets.items():
            before = ck.pack_launches
            got = ck.pack_parts(names, sc, struct, stt)
            if ck.pack_launches != before + 1:
                fails.append(f"{label} {what}: "
                             f"{ck.pack_launches - before} launches")
            for name in names:
                a, b = got[name], want[name]
                n += 1
                if a.shape != b.shape or not torch.equal(bits(a), bits(b)):
                    fails.append(f"{label} {what} {name}")
                elif a.dtype == torch.float32:
                    fin = torch.isfinite(b)
                    if bool(fin.any()):
                        err = max(err, float((a[fin] - b[fin]).abs().max()))
    log(f"K1 scene pack, one launch vs the plain parts on the card: {cases} "
        f"cases ({len(SCENES)} golden scenes, {len(J3_SCENES)} x 10 J3 "
        f"frames) x 3 launches ({', '.join(subsets)}), {n} tables, one "
        f"launch each, bitwise: {'yes' if not fails else fails}")
    if fails:
        raise AssertionError(f"K1: {fails}")
    label, sc, struct = [c for c in cull_inputs(dev)
                         if c[0] == "demo02 frame 10"][0]
    stt = ck._struct_tensors(struct, dev)
    rows = {}
    for what, names in (("culling tables", ck.CULL_PARTS),
                        ("J3's moved parts", K_MOVED),
                        ("whole pack", ck.PART_NAMES)):
        def kern(names=names):
            return ck.pack_parts(names, sc, struct, stt)

        def plain(names=names):
            return [fn(sc, struct, stt) for name, fn, _ in ck.PACK_PARTS
                    if name in names]
        ms, plain_ms = graph_ms(kern, 20), graph_ms(plain, 20)
        call_ms, plain_call_ms = cuda_ms(kern, 20), cuda_ms(plain, 20)
        host, plain_host = host_ms(kern, 200), host_ms(plain, 20)
        nbytes, ops = pack_work(struct, sc, names)
        bound, by = bound_ms(nbytes, ops)
        rows[what] = dict(ms=ms, plain_ms=plain_ms, call_ms=call_ms,
                          host_ms=host, bound_ms=bound, bound_by=by)
        log(f"K2 {label} (NS={struct.ns}, {struct.nl} lights), {what} "
            f"({'+'.join(names)}): one launch {ms:.4f} ms device (CUDA "
            f"graph), {call_ms:.4f} ms a call with the host's launch work, "
            f"{host:.4f} ms of host work a call; plain {plain_ms:.4f} / "
            f"{plain_call_ms:.4f} / {plain_host:.4f} ms; bound "
            f"{bound:.6f} ms ({by}: {nbytes} B, {ops} operations)")
    return err, rows


# ---------------------------------------------------------------------------
# phase U: the scene update as one launch, the interactive frame as one graph
# ---------------------------------------------------------------------------

# the J3 frame at which U4 times the launch, and its CUDA graph's launches
U_FRAME = 10
U_REPS = 20


def update_work(st, groups) -> tuple:
    """The bytes and operations that the fields of ``groups`` need, the
    least an update launch of them could do: read once, the staged rows
    and the plan's rows (``par``, ``src``) of the nodes those groups'
    world matrices are composed from (``SceneStructure.need``), the
    level starts, the static local matrices of those nodes and the static
    world matrices of their unmoved parents and of the groups' unmoved
    nodes, each unique row once; for surfaces the surface and box
    references and the boxes, for lights the light references; the
    fields written once. A float operation each multiply and add: 64
    multiply-adds a composed world matrix, 81 more where it builds its
    local matrix from staged values, a surface's inverse (53) and a
    bounded surface's sphere (209)."""
    from quadray_tpu_torch.ops import update as upd
    from quadray_tpu_torch.scene.compile import SRC_STATIC
    need = np.unique(np.concatenate([st.need[g] for g in groups]))
    own = need[st.src[need] != SRC_STATIC]
    composed = set(need.tolist())
    refs = set(st.parent[need].tolist())
    for g in groups:
        refs |= set(st.nodes[g].tolist())
    w_rows = len(refs - composed)
    l_rows = need.size - own.size
    n_in = (own.size * upd.IN_W * 4 + need.size * 2 * 4
            + st.plan["lv_start"].size * 4 + (w_rows + l_rows) * 64)
    ops = 2 * (64 * need.size + 81 * own.size)
    if "surf" in groups:
        n_surf, n_box = st.nodes["surf"].size, st.bnd.size
        n_in += n_surf * 2 * 4 + n_box * (3 + 24) * 4
        ops += 53 * n_surf + 209 * n_box
    if "light" in groups:
        n_in += st.nodes["light"].size * 4
    n_out = sum(int(np.prod(s)) * 4
                for s in upd.field_shapes(st, groups).values())
    return n_in + n_out, ops


def trace_scene(name, dev, frames):
    """A Scene of ``name`` at 800x480 taken through J3's trace: yields
    (frame, time, the camera's transform, the scene) before each frame's
    update, the frame's camera action taken."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS, frame_time
    tokens = J3_TRACE.split(",")
    sc = Scene(j3_scene(name), W, H, device=dev)
    sc.update(0.0)
    for fi in range(frames + 1):
        t = frame_time(fi)
        for key in tokens[fi % len(tokens)].split("+"):
            if fi and key in KEY_ACTIONS:
                sc.update_action(t, KEY_ACTIONS[key])
        yield fi, t, sc.camera.trm() if sc.camera is not None else None, sc
        sc.update(t)


def phase_u1(dev):
    """The scene update's kernel (csrc/update.cu update_launch) against
    its plain version (SceneStructure.moved_fields) on the card: each
    golden scene's structure at t = 0 (structure_pass already held its
    launch against compile_scene) and every frame of J3's trace on
    demo01-03 and test13 at the values Scene.render takes there, every
    group at once and each alone, one launch each, bitwise. Returns the
    largest absolute difference over the finite elements (0 where
    bitwise) and the launches."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import update as upd
    from quadray_tpu_torch.scene.compile import MOVED_GROUPS
    sets = (tuple(MOVED_GROUPS),) + tuple((g,) for g in MOVED_GROUPS)
    fails, err, n = [], 0.0, [0, 0]

    def check(label, st, vals):
        nonlocal err
        inp = st.local_inputs(vals)
        for groups in sets:
            before = upd.launches
            got = upd.moved_fields(st, groups, inp)
            if upd.launches != before + 1:
                fails.append(f"{label} {groups}: "
                             f"{upd.launches - before} launches")
            n[0] += 1
            for k, v in st.moved_fields(groups, vals).items():
                a, b = got[k].cpu(), torch.from_numpy(v)
                n[1] += 1
                if a.shape != b.shape or not torch.equal(
                        a.view(torch.int32), b.view(torch.int32)):
                    fails.append(f"{label} {groups} {k}")
                fin = torch.isfinite(b) & torch.isfinite(a)
                if bool(fin.any()):
                    err = max(err, float((a[fin] - b[fin]).abs().max()))

    for name in SCENES:
        sc = Scene(load_scene(name), W, H, device=dev)
        sc.update(0.0)
        check(name, sc._structure, sc._structure.local_values(0.0, None))
        del sc
    for name in J3_SCENES:
        for fi, t, cam, sc in trace_scene(name, dev, J3_FRAMES):
            check(f"{name} frame {fi}", sc._structure,
                  sc._structure.local_values(t, cam))
    log(f"U1 scene update, one launch vs the plain version (moved_fields) "
        f"on the card: {len(SCENES)} golden scenes at t=0 and "
        f"{len(J3_SCENES)} x {J3_FRAMES + 1} frames of J3's trace, every "
        f"group at once and each alone: {n[0]} launches, {n[1]} fields, one "
        f"launch each, bitwise: {'yes' if not fails else fails[:20]}; "
        f"max_abs_err {err:.3e}")
    if fails:
        raise AssertionError(f"U1: {fails[:20]}")
    return err, n[0]


def phase_u4(dev, smi):
    """The update's launch on J3's scenes at frame U_FRAME of its trace,
    for the groups the interactive program rewrites: device ms (CUDA
    graphs of U_REPS launches), the eager launch's host ms a call (the
    staged values' pinned copy and the launch, ops.update.moved_fields),
    the plain version's host ms (moved_fields, numpy) and with its staged
    copy, the bound (update_work). Returns the rows by scene."""
    from quadray_tpu_torch.ops import update as upd
    from quadray_tpu_torch.scene import compile as C
    rows = {}
    for name in J3_SCENES:
        for fi, t, cam, sc in trace_scene(name, dev, U_FRAME):
            if fi == U_FRAME:
                break
        st = sc._structure
        groups = st.moving
        vals = st.local_values(t, cam)
        inp = st.local_inputs(vals)
        local = torch.from_numpy(inp).to(dev)
        scratch = torch.empty((st.tables.nq, 16), device=dev)
        outs = {k: torch.empty(s, device=dev)
                for k, s in upd.field_shapes(st, groups).items()}
        ms = graph_ms(lambda: upd.launch(st, local, outs, scratch), U_REPS)
        call = host_ms(lambda: upd.moved_fields(st, groups, inp), 200)
        plain = host_ms(lambda: st.moved_fields(groups, vals), 50)
        staged = host_ms(lambda: C._staged(st.moved_fields(groups, vals),
                                           dev), 50)
        nbytes, ops = update_work(st, groups)
        bound, by = bound_ms(nbytes, ops)
        rows[name] = dict(ms=ms, host_ms=call, plain_ms=plain,
                          plain_staged_ms=staged, bound_ms=bound,
                          bound_by=by, groups=groups)
        log(f"U4 {name} frame {U_FRAME} ({smi}), groups {groups}, "
            f"{st.tables.nq} scratch rows in "
            f"{st.tables.lv_start.shape[0] - 1} levels, NS={st.ns}: one "
            f"launch {ms:.4f} ms device (CUDA graph), {call:.4f} ms of host "
            f"work a call (pinned copy and launch); plain version "
            f"{plain:.4f} ms host, {staged:.4f} ms with its staged copy; "
            f"bound {bound:.6f} ms ({by}: {nbytes} B, {ops} operations)")
        del sc
    return rows


# ---------------------------------------------------------------------------
# phase L: the parallel layer
# ---------------------------------------------------------------------------

# L1: the golden scenes on 4 blocks of the card; test13 and demo03 also on
# these block counts (7: 54,858 rays a block, not a whole number of warps)
L_BLOCKS, L_MORE, L_MORE_SCENES = 4, (1, 2, 7, 8), ("test13", "demo03")
# L1's plain check and L4's frame times
L_PLAIN = ("test13", 200, 120)
L_TIMED_BLOCKS = (1, 2, 4, 8)
# L2: the sharded fast step on these block counts; JAX's device-count
# invariance bounds (tests/test_multidevice.py:102-104)
L_STEP_BLOCKS = (1, 4)
INV_LOSS_RTOL, INV_PARAM_RTOL, INV_PARAM_ATOL = 1e-5, 1e-4, 1e-6
# L3: the multi-process worker's time limit
L_WORKER_TIMEOUT = 240


def card_mesh(dev, blocks):
    from quadray_tpu_torch.parallel.mesh import ray_mesh
    return ray_mesh([dev] * blocks)


def phase_l1(dev):
    """render_sharded_cuda against render_cuda on the golden scenes, the
    counted main-path run of the parallel layer."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import TraceConfig, to_frame
    from quadray_tpu_torch.parallel.render import (render_sharded,
                                                   render_sharded_cuda)
    from quadray_tpu_torch.utils.image import load_bmp, frame_cmp
    cases, arrays = [], {}
    for n in SCENES:
        s = Scene(load_scene(n), W, H, device=dev)
        s.update(0.0)
        arrays[n] = (s.arrays, TraceConfig(depth=s.pfm.depth))
        cases += [(n, L_BLOCKS)] + [(n, b) for b in L_MORE
                                    if n in L_MORE_SCENES]
    want = {n: ck.render_cuda(a, W, H, 1, cfg) for n, (a, cfg) in
            arrays.items()}
    meshes = {b: card_mesh(dev, b) for _, b in cases}
    # main path, counted: zeroed right before the run, read right after
    ck.launches = 0
    got, per_frame = [], []
    for n, b in cases:
        before = ck.launches
        a, cfg = arrays[n]
        got.append(render_sharded_cuda(a, W, H, meshes[b], 1, cfg))
        per_frame.append(ck.launches - before)
    torch.cuda.synchronize()
    launches = ck.launches
    fails = []
    for (n, b), img, k in zip(cases, got, per_frame):
        same = torch.equal(img, want[n])
        frame = to_frame(img, arrays[n][0].use_gamma).cpu().numpy()
        nbad, _ = frame_cmp(load_bmp(os.path.join(GOLDEN, f"ref_{n}.bmp")),
                            frame, t_diff=3)
        ok = same and k == b and nbad <= BUDGET.get(n, 0)
        log(f"L1 {n} {b} blocks: bitwise_render_cuda={same} launches={k} "
            f"bad_px={nbad} budget={BUDGET.get(n, 0)}"
            f"{'' if ok else '  FAIL'}")
        if not ok:
            fails.append(f"{n}/{b}")
    log(f"L1 launches: whitted {launches} over {len(cases)} frames "
        f"(expected {sum(b for _, b in cases)})")
    if fails or launches != sum(b for _, b in cases):
        raise AssertionError(f"L1: frames not bitwise render_cuda's, "
                             f"outside budget or not launched once a "
                             f"block: {fails}")
    n, w, h = L_PLAIN
    a, cfg = arrays[n]
    plain = render_sharded(a, w, h, meshes[L_BLOCKS], 1, cfg)
    kern = render_sharded_cuda(a, w, h, meshes[L_BLOCKS], 1, cfg)
    mx = float((plain - kern).abs().max())
    log(f"L1 {n} {w}x{h} {L_BLOCKS} blocks: plain render_sharded vs "
        f"render_sharded_cuda max_abs={mx:.3e}")
    if not mx <= ATOL:
        raise AssertionError(f"L1: plain sharded render off by {mx}")
    return launches, arrays


def phase_l2(dev, smi):
    """The sharded fast train step: 1 vs 4 blocks, the counted scan on 4
    blocks, ms/step."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import replay as rp
    from quadray_tpu_torch.ops import row_gather as rg
    from quadray_tpu_torch.parallel import train as tr
    sc, target, _ = train_task(dev)
    cfg = train_cfg()
    res = {}
    for b in L_STEP_BLOCKS:
        step_fn, opt_init = tr.make_train_step_fast(
            sc, W, H, cfg=cfg, lr=TRAIN_LR, k_paths=K_PATHS,
            mesh=card_mesh(dev, b))
        p0 = tr.extract_params(sc)
        params, state, loss = step_fn(p0, opt_init(p0), sc, target)
        res[b] = (float(loss), params, state.mu, step_fn.run.route(sc))
    (l1, p1, m1, r1), (ln, pn, mn, rn) = (res[L_STEP_BLOCKS[0]],
                                          res[L_STEP_BLOCKS[-1]])

    def worst(a, b):
        return (max(float((a[k] - b[k]).abs().max()) for k in a),
                all(torch.equal(a[k], b[k]) for k in a))

    def close(a, b):
        return all(torch.allclose(a[k], b[k], rtol=INV_PARAM_RTOL,
                                  atol=INV_PARAM_ATOL) for k in a)

    # after one step the params moved by about lr in the gradient's sign
    # whatever its scale; Adam's first moment is 0.1 x the gradient
    ok = (np.isclose(l1, ln, rtol=INV_LOSS_RTOL) and close(p1, pn)
          and close(m1, mn))
    top = max(float(v.abs().max()) for v in m1.values())
    log(f"L2 test01 {W}x{H} K={K_PATHS} every field, one step (routes "
        f"{r1}, {rn}): loss "
        f"{L_STEP_BLOCKS[0]} block {l1:.9e}, {L_STEP_BLOCKS[-1]} blocks "
        f"{ln:.9e}; largest |diff| and bitwise: params %.3e %s, Adam's "
        f"first moment %.3e %s (largest |moment| {top:.3e}; rtol "
        f"{INV_PARAM_RTOL}, atol {INV_PARAM_ATOL}){'' if ok else '  FAIL'}"
        % (worst(p1, pn) + worst(m1, mn)))
    if not ok:
        raise AssertionError("L2: the 4-block step is off the 1-block "
                             "step beyond JAX's invariance bounds")

    b = L_STEP_BLOCKS[-1]
    run_fn, opt_init = tr.make_train_scan_fast(
        sc, W, H, cfg=cfg, lr=TRAIN_LR, k_paths=K_PATHS,
        mesh=card_mesh(dev, b))
    p0 = tr.extract_params(sc, RECOVER_FIELDS)
    opt0 = opt_init(p0)
    # main path, counted
    ck.paths_launches = 0
    rg.launches = rg.backward_launches = 0
    rp.launches = rp.backward_launches = 0
    params, _, losses = run_fn(p0, opt0, sc, target, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = ck.paths_launches
    gathers = (rg.launches, rg.backward_launches, rp.launches,
               rp.backward_launches)
    losses = [float(x) for x in losses]
    log(f"L2 {b} blocks, {TRAIN_STEPS} steps of make_train_scan_fast "
        f"(route {run_fn.route(sc)}: the first step the program's warm-up "
        f"before its capture, the rest replays), fields "
        f"{','.join(RECOVER_FIELDS)}: losses "
        + " ".join(f"{x:.6e}" for x in losses)
        + f"; paths launches {launches} (expected {b * TRAIN_STEPS}), "
        f"gather forward, row sums, fused replay forward and backward "
        f"{gathers}")
    if launches != b * TRAIN_STEPS:
        raise AssertionError(f"L2: {launches} paths launches")
    if gathers != (0,) + (b * TRAIN_STEPS,) * 3:
        raise AssertionError(f"L2: replay launches {gathers}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"L2: loss did not fall: {losses}")
    for k, v in params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"L2: parameter {k} not finite")

    ms = {}
    for b in L_STEP_BLOCKS:
        run_fn, opt_init = tr.make_train_scan_fast(
            sc, W, H, cfg=cfg, lr=TRAIN_LR, k_paths=K_PATHS,
            mesh=card_mesh(dev, b))
        p_all = tr.extract_params(sc)
        state = [p_all, opt_init(p_all)]

        def one():
            state[0], state[1], _ = run_fn(state[0], state[1], sc, target, 1)

        ms[b] = cuda_ms(one, 10, warmup=2)
    log(f"L2 ms/step ({smi}; CUDA events, mean of 10 after 2, every "
        f"field, route {run_fn.route(sc)}: graph replays, a call a step): "
        + ", ".join(f"{b} block(s) {t:.3f}" for b, t in ms.items()))
    split = l2_split(sc, target)
    log(f"L2 split over the blocks of a step ({smi}; CUDA events, mean of "
        "5 after 1): " + ", ".join(f"{b} block(s): paths kernel with re-pack "
                           f"{p:.3f}, replay fwd+bwd {r:.3f}"
                           for b, (p, r) in split.items()))
    return launches, gathers


def l2_split(sc, target):
    """The two parts of a sharded fast step that run once a block, each
    timed over every block of the frame: the paths kernel with its
    re-pack, and the fused replay's forward and backward (one
    autograd.grad a block, as the step takes it)."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.replay import replay_color_fused
    from quadray_tpu_torch.parallel import train as tr
    cfg = train_cfg()
    struct = ck.scene_struct(sc)
    _, dirs, tmin = primary(sc, W, H)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tr.extract_params(sc).items()}
    sc2 = dataclasses.replace(sc, **leaves)
    out = {}
    for b in L_STEP_BLOCKS:
        m = dirs.shape[0] // b
        blocks = [(sc.cam_pos[None, :].expand(m, 3), dirs[i * m:(i + 1) * m],
                   tmin[i * m:(i + 1) * m], target[i * m:(i + 1) * m])
                  for i in range(b)]
        paths = [ck.trace_paths_with_struct(sc2, struct, *r[:3], cfg,
                                            K_PATHS)[1] for r in blocks]

        def trace():
            for r in blocks:
                ck.trace_paths_with_struct(sc2, struct, *r[:3], cfg, K_PATHS)

        def replay():
            for r, p in zip(blocks, paths):
                cols = replay_color_fused(sc2, *r[:3], p, cfg)
                loss = ((torch.clamp(cols, 0.0, 1.0) - r[3]) ** 2).mean()
                torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)

        out[b] = (cuda_ms(trace, 5), cuda_ms(replay, 5))
    return out


def run_ranks(world, backend, timeout=L_WORKER_TIMEOUT):
    """The multi-process worker (quadray_tpu_torch/dryrun.py), one process
    a rank on this card, ``backend`` None for init_distributed's default:
    [(returncode, output, timed out)], every process stopped."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "quadray_tpu_torch.dryrun", "--rank", str(r),
         "--world", str(world), "--port", str(port), "--device", "cuda"]
        + ([] if backend is None else ["--backend", backend]), cwd=REPO,
        env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append((p.communicate(timeout=timeout)[0], False))
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append((p.communicate()[0], True))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out, hung) for p, (out, hung) in zip(procs, outs)]


def rank_lines(runs, label):
    lines = []
    for r, (rc, out, hung) in enumerate(runs):
        tag = f"OK rank {r}: "
        found = [ln for ln in out.splitlines() if ln.startswith(tag)]
        if rc != 0 or hung or not found:
            raise AssertionError(f"{label}: rank {r} failed (rc {rc}, "
                                 f"timed out {hung}):\n{out[-3000:]}")
        lines.append(json.loads(found[0][len(tag):]))
    return lines


def phase_l3(dev):
    """Two gloo ranks on this card, then a world-size-1 NCCL group and one
    of init_distributed's default backend (cpu:gloo,cuda:nccl), then NCCL
    asked for two ranks on one card."""
    from quadray_tpu_torch.dryrun import FRAME_H, FRAME_W, digest
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.scene.compile import compile_scene
    sc = compile_scene(load_scene("test01"), device=dev)
    want = digest(ck.render_cuda(sc, FRAME_W, FRAME_H))
    for world, backend in ((2, "gloo"), (1, "nccl"), (1, None)):
        t0 = time.perf_counter()
        lines = rank_lines(run_ranks(world, backend),
                           f"L3 {backend} world {world}")
        backend = lines[0]["backend"]
        frames = [ln["frame"] for ln in lines]
        params = [ln["params"] + "/" + ln["mu"] for ln in lines]
        log(f"L3 {backend} world {world} on {[ln['device'] for ln in lines]}"
            f": frame digests {frames} (render_cuda {want}), params/first "
            f"moment digests {params}, losses "
            f"{[ln['loss'] for ln in lines]}, the step bitwise the "
            f"in-process {world}-block step "
            f"{[ln['bitwise_in_process'] for ln in lines]}, all_reduce "
            f"{lines[0]['all_reduce']}, refused differing scenes: "
            f"{[ln['refused'] is not None for ln in lines]} "
            f"({time.perf_counter() - t0:.1f} s)")
        if frames != [want] * world or len(set(params)) != 1:
            raise AssertionError(f"L3 {backend}: frames not render_cuda's "
                                 "or params differ across ranks")
    runs = run_ranks(2, "nccl", timeout=120)
    why = sorted({ln.strip() for _, out, _ in runs
                  for ln in out.splitlines() if "Duplicate GPU" in ln})
    log(f"L3 NCCL, two ranks on one card: return codes "
        f"{[rc for rc, _, _ in runs]}, timed out {[h for _, _, h in runs]}"
        f"; {why[0] if why else 'no duplicate-GPU message'}")


def phase_l4(dev, arrays, smi):
    """dryrun_multichip(8) on the card; render_sharded_cuda ms/frame on
    test13 over 1, 2, 4, 8 blocks; scaling_report."""
    from quadray_tpu_torch.dryrun import dryrun_multichip
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.parallel.distributed import scaling_report
    from quadray_tpu_torch.parallel.render import render_sharded_cuda
    dryrun_multichip(8, device="cuda")
    a, cfg = arrays["test13"]
    ms = {"render_cuda": cuda_ms(lambda: ck.render_cuda(a, W, H, 1, cfg),
                                 10, warmup=2)}
    for b in L_TIMED_BLOCKS:
        mesh = card_mesh(dev, b)
        ms[b] = cuda_ms(lambda: render_sharded_cuda(a, W, H, mesh, 1, cfg),
                        10, warmup=2)
    log(f"L4 test13 {W}x{H} ms/frame ({smi}; CUDA events, mean of 10 "
        "after 2; blocks on one card): " + ", ".join(
            f"{k if k == 'render_cuda' else f'{k} blocks'} {v:.3f}"
            for k, v in ms.items()))

    def fn(mesh):
        render_sharded_cuda(a, W, H, mesh, 1, cfg)
        torch.cuda.synchronize()

    for devices, counts in ((None, None), ([dev] * max(L_TIMED_BLOCKS),
                                           list(L_TIMED_BLOCKS))):
        rep = scaling_report(fn, counts, frames=3, devices=devices)
        log(f"L4 scaling_report ({smi}; host clock, best of 3) "
            + ("over the card's devices" if devices is None
               else "over blocks of one card") + ": " + json.dumps(rep))
        if rep["rows"][0]["efficiency"] != 1.0 or not all(
                r["seconds_per_frame"] > 0 for r in rep["rows"]):
            raise AssertionError("L4: scaling_report malformed")
    return ms


M2_TIMEOUT = 600


# ---- phase N: the main path's Whitted kernel ----------------------------------

def phase_n1(dev):
    """Every instantiation of whole_kernel (PHASE_N1 x N_GATES) at the edge
    ray counts, bitwise the plain trace_rays on the card (per-ray masks as
    the kernel takes them: the same bits either way), one launch each; two
    launches of a frame and one more ray bitwise equal; test13 culled in
    launches of N1_FRAMES frames, the masks on and then off. Returns the
    worst abs difference, 0.0: any differing word raises."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import TraceConfig, trace_rays

    def check(what, sc, rays, want, cfg, counts):
        for n in counts:
            before = ck.launches
            got = ck.trace_rays_cuda(sc, rays[0], rays[1][:n], rays[2][:n],
                                     cfg)
            torch.cuda.synchronize()
            nd = int((_bits(got) != _bits(want[:n])).any(1).sum())
            if ck.launches != before + 1 or nd:
                raise AssertionError(f"N1 {what} n={n}: {nd} rays differ, "
                                     f"launches {ck.launches - before}")
        return got

    seen = set()
    for name in PHASE_N1:
        sc = compiled(name, dev)
        struct = ck.scene_struct(sc)
        rays = edge_rays(sc, PATHS_EDGES[-1])
        for gate, own_min in N_GATES:
            cfg = TraceConfig(cull=gate != "unculled")
            with cull_every_scene(), contextlib.ExitStack() as stack:
                if own_min is not None:
                    stack.enter_context(ck_value("EMIT_OWN_MIN_KEPT",
                                                 own_min))
                inst = ck.whitted_instance(struct, cfg, PATHS_EDGES[-1])
                want = trace_rays(sc, *rays, cfg, own=(
                    1, ck.EMIT_OWN_MIN_KEPT) if inst["own"] else None)
                got = check(f"{name} {gate}", sc, rays, want, cfg,
                            PATHS_EDGES)
                again = ck.trace_rays_cuda(sc, *rays, cfg)
                torch.cuda.synchronize()
                if not torch.equal(_bits(got), _bits(again)):
                    raise AssertionError(f"N1 {name} {gate}: two launches "
                                         "differ")
            key = tuple(int(inst[k]) for k in ("can_push", "cull", "own"))
            seen.add(key)
            log(f"N1 {name} {gate}: whole_kernel<CAN_PUSH={key[0]}, "
                f"CULL={key[1]}, OWN={key[2]}> surfaces={struct.n_real} "
                f"rays={list(PATHS_EDGES)} bitwise plain, two launches "
                "bitwise")
            del want
            torch.cuda.empty_cache()
    if len(seen) != 6:
        raise AssertionError(f"N1: {len(seen)} of whole_kernel's 6 "
                             "instantiations ran")
    sc = compiled("test13", dev)
    struct, cfg = ck.scene_struct(sc), TraceConfig()
    frame = primary(sc, W, H)
    want = trace_rays(sc, *frame, cfg)
    sides = []
    for k in N1_FRAMES:
        rays = edge_rays(sc, k * W * H)
        inst = ck.whitted_instance(struct, cfg, k * W * H)
        check(f"test13 {k} frames", sc, rays, want.repeat(k, 1), cfg,
              (k * W * H,))
        sides.append(inst["own"])
        log(f"N1 test13 culled, one launch of {k} frames ({k * W * H} rays,"
            f" WHOLE_OWN_MAX_RAYS {ck.WHOLE_OWN_MAX_RAYS}): whole_kernel<"
            f"OWN={int(inst['own'])}> bitwise plain")
        del rays
        torch.cuda.empty_cache()
    if sides != [True, False]:
        raise AssertionError(f"N1: per-ray masks {sides} in launches of "
                             f"{N1_FRAMES} frames, not on then off")
    return 0.0


def phase_w(dev, smi):
    """Phase W (W_SCHLICK, W_DEEP, W_STACK above): each kernel bitwise its
    plain version on the card at 800x480, two launches bitwise, one launch
    each counted; the interactive program's frames (capture and replay)
    uint8-equal to render_cuda + to_frame; kernel ms beside the default
    cfg's. Returns {case: {"ms", "default_ms", "instance"}}."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import diff
    from quadray_tpu_torch.ops.trace import (TraceConfig, to_frame,
                                             trace_paths, trace_rays,
                                             trace_rays_emit)
    from quadray_tpu_torch.parallel.mesh import ray_mesh
    from quadray_tpu_torch.parallel.render import render_sharded_cuda
    out = {}

    def whole(label, sc, rays, cfg, base):
        struct = ck.scene_struct(sc)
        inst = ck.whitted_instance(struct, cfg, rays[1].shape[0])
        want = trace_rays(sc, *rays, cfg)
        ck.launches = 0
        got = [ck.trace_rays_cuda(sc, *rays, cfg) for _ in range(2)]
        torch.cuda.synchronize()
        launches = ck.launches
        nd = [int((_bits(g) != _bits(want)).any(1).sum()) for g in got]
        ms = graph_ms(lambda: ck.trace_rays_cuda(sc, *rays, cfg), W_REPS)
        ms0 = graph_ms(lambda: ck.trace_rays_cuda(sc, *rays, base), W_REPS)
        differs = not torch.equal(_bits(want), _bits(trace_rays(
            sc, *rays, base)))
        out[label] = dict(ms=ms, default_ms=ms0, instance=inst)
        log(f"W {label}: whole_kernel<CAN_PUSH={int(inst['can_push'])}, "
            f"CULL={int(inst['cull'])}, OWN={int(inst['own'])}, DEEP="
            f"{int(inst['deep'])}> rays={rays[1].shape[0]}, rays differing "
            f"from the plain trace_rays {nd}, launches {launches}; "
            f"colors differ from the default cfg's: {differs}; kernel ms "
            f"({smi}) {ms:.4f} against the default cfg's {ms0:.4f} "
            f"({ms / ms0:.2f}x)")
        if any(nd) or launches != 2 or not differs:
            raise AssertionError(f"W {label}: off its plain version "
                                 f"({nd}), {launches} launches or the "
                                 "default cfg's colors")
        return got[0]

    for name in W_SCHLICK:
        sc = compiled(name, dev)
        rays = primary(sc, W, H)
        for gate in ("unculled", "culled"):
            cull = gate == "culled"
            base = TraceConfig(cull=cull)
            with cull_every_scene():
                whole(f"{name} schlick {gate}", sc, rays,
                      base._replace(schlick=True), base)
        del sc, rays
        torch.cuda.empty_cache()
    sc = compiled(W_DEEP_SCENE, dev)
    deep = TraceConfig(**W_DEEP)
    height = int(diff.stack_slots(diff.forward_plain(
        sc, *primary(sc, W, H), deep)[2]).max()) + 1
    log(f"W {W_DEEP_SCENE} {TraceConfig(**W_DEEP)}: the plain tracer's "
        f"stacks reach {height} slots (local slots {ck.MAX_STACK})")
    if height <= ck.MAX_STACK:
        raise AssertionError(f"W: {W_DEEP_SCENE}'s stacks reach {height}")
    for gate in ("unculled", "culled"):
        cull = gate == "culled"
        with cull_every_scene():
            cfg = deep._replace(cull=cull)
            rays = edge_rays(sc, W * H + 1)
            whole(f"{W_DEEP_SCENE} deep {gate}", sc, rays, cfg,
                  TraceConfig(cull=cull))
    # the same config through the main path's entry points
    sc_r = Scene(load_scene(W_DEEP_SCENE), W, H, device=dev)
    sc_r._cfg = lambda: deep
    ck.launches = 0
    frames = [sc_r.render(0.0), sc_r.render(0.0)]
    torch.cuda.synchronize()
    launches = ck.launches
    lin = ck.render_cuda(sc_r.arrays, W, H, sc_r.pfm.fsaa, deep, sc_r._struct)
    want = to_frame(lin, sc_r.arrays.use_gamma).cpu().numpy()
    replay = sc_r._interactive_prog.replay
    same = [np.array_equal(f, want) for f in frames]
    sharded = render_sharded_cuda(sc_r.arrays, W, H,
                                  ray_mesh([dev] * W_SHARDS), 1, deep)
    torch.cuda.synchronize()
    same_sharded = torch.equal(_bits(sharded), _bits(lin))
    log(f"W {W_DEEP_SCENE} deep through Scene.render (the interactive "
        f"program's capture frame and a replay) uint8-equal to render_cuda "
        f"+ to_frame: {same}, Whitted launches {launches}, the graph's "
        f"launches {replay.counts}; render_sharded_cuda on {W_SHARDS} "
        f"blocks bitwise render_cuda: {same_sharded}")
    if not all(same) or launches != 2 or not same_sharded \
            or replay.counts.get("launches") != 1:
        raise AssertionError("W: the deep stack's frames differ through "
                             "Scene.render or render_sharded_cuda")
    del sc_r, lin, sharded
    torch.cuda.empty_cache()
    # the single-branch modes at a stack they never read
    sc = compiled(W_SINGLE, dev)
    rays = primary(sc, W, H)
    cfg = TraceConfig(stack=W_STACK)
    base = TraceConfig()
    k = 8
    ck.paths_launches = ck.emit_launches = ck.resume_launches = 0
    cols_k, paths_k = ck.trace_paths(sc, *rays, cfg._replace(
        max_segments=k), k)
    cols_p, paths_p = trace_paths(sc, *rays, cfg._replace(max_segments=k), k)
    ecols_k, state_k = ck.trace_rays_emit_cuda(sc, *rays, cfg, 4)
    ecols_p, state_p = trace_rays_emit(sc, *rays, cfg, 4)
    ecols_k = ecols_k.clone()
    rounds = ck.trace_rays_rounds(sc, *rays, cfg, 4)
    want = trace_rays(sc, *rays, cfg)
    torch.cuda.synchronize()
    nd = {"paths colors": int((_bits(cols_k) != _bits(cols_p)).sum()),
          "paths records": int((paths_k != paths_p).sum()),
          "emit colors": int((_bits(ecols_k) != _bits(ecols_p)).sum()),
          "emit state": int((_bits(state_k) != _bits(state_p)).sum()),
          "rounds colors": int((_bits(rounds) != _bits(want)).sum())}
    counts = (ck.paths_launches, ck.emit_launches, ck.resume_launches)
    times = {}
    for what, fn in (("paths", lambda c: ck.trace_paths(
            sc, *rays, c._replace(max_segments=k), k)),
            ("rounds", lambda c: ck.trace_rays_rounds(sc, *rays, c, 4))):
        times[what] = (graph_ms(lambda: fn(cfg), W_REPS),
                       graph_ms(lambda: fn(base), W_REPS))
        out[f"{W_SINGLE} stack {W_STACK} {what}"] = dict(
            ms=times[what][0], default_ms=times[what][1], instance=None)
    log(f"W {W_SINGLE} stack={W_STACK} (single-branch: no stack read): "
        f"words differing from the plain versions {nd}; launches (paths, "
        f"emit, resume) {counts}; ms ({smi}) paths {times['paths'][0]:.4f} "
        f"against the default cfg's {times['paths'][1]:.4f}, rounds (emit "
        f"+ compaction + resume) {times['rounds'][0]:.4f} against "
        f"{times['rounds'][1]:.4f}")
    if any(nd.values()) or counts != (1, 2, 1):
        raise AssertionError(f"W {W_SINGLE} stack={W_STACK}: {nd}, "
                             f"launches {counts}")
    return out


def phase_n3(dev):
    """A frame launched alone against its share of a launch of N3_FRAMES
    frames (the frames' rays one after another, as the bench's batches),
    kernel device ms from CUDA events around N3_REPS launches after a
    warm-up, at the default TraceConfig; returns {scene: (alone, share)}."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import TraceConfig
    out = {}
    for name in PHASE_N3:
        sc = compiled(name, dev)
        struct = ck.scene_struct(sc)
        org, dirs, tmin = primary(sc, W, H)
        big = (org, dirs.repeat(N3_FRAMES, 1), tmin.repeat(N3_FRAMES))
        cfg = TraceConfig()
        alone = cuda_ms(lambda: ck.trace_rays_cuda(sc, org, dirs, tmin, cfg,
                                                   struct), N3_REPS * 4)
        share = cuda_ms(lambda: ck.trace_rays_cuda(sc, *big, cfg, struct),
                        N3_REPS) / N3_FRAMES
        out[name] = (alone, share)
        log(f"N3 {name}: one frame alone {alone:.4f} ms, a frame's share of "
            f"a {N3_FRAMES}-frame launch {share:.4f} ms, alone/share "
            f"{alone / share:.3f}")
        del big
        torch.cuda.empty_cache()
    return out


def eager_pt_frame(acc, samples, use_gamma, w=W, h=H):
    """Scene.render_pt_pass's frame of a running sum issued op by op, as
    before the pass programs."""
    from quadray_tpu_torch.ops.trace import to_frame
    img = torch.clamp(acc / max(samples, 1), 0.0, 1.0).reshape(h, w, 3)
    return to_frame(img, use_gamma).cpu().numpy()


def phase_o1(dev):
    """The golden scenes through Scene.render: the first frame (the
    interactive program's warm-up, then its capture) and a replayed one, each
    uint8-equal to render_cuda + to_frame, one Whitted launch each (the
    count set to 0 before and read after). Returns the capture ms
    (warm-up and capture, set-up) by scene."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import graphs
    from quadray_tpu_torch.ops.trace import to_frame
    capture, fails = {}, []
    for n in SCENES:
        sc = Scene(load_scene(n), W, H, device=dev)
        ck.launches = 0
        frames = [sc.render(0.0), sc.render(0.0)]
        torch.cuda.synchronize()
        launches = ck.launches
        want = to_frame(ck.render_cuda(sc.arrays, W, H, sc.pfm.fsaa,
                                       sc._cfg(), sc._struct),
                        sc.arrays.use_gamma).cpu().numpy()
        prog = sc._interactive_prog
        replay = prog.replay
        same = [np.array_equal(f, want) for f in frames]
        capture[n] = replay.ms
        # the interactive program's graph: the update, the pack of the
        # tables its moving fields feed (none where only the camera
        # moves) and the Whitted launch
        counts = {"launches": 1, "update_launches": 1}
        if prog.parts:
            counts["pack_launches"] = 1
            if set(prog.parts) & set(ck.CULL_PARTS):
                counts["cull_launches"] = 1
        log(f"O1 {n}: capture frame, replayed frame uint8-equal to "
            f"render_cuda + to_frame: {same}; launches {launches}; "
            f"warm-up + capture {replay.ms:.1f} ms (warm-up's host work "
            f"{replay.warmup_ms:.1f}); the graph's launches "
            f"{replay.counts}")
        if not all(same) or launches != 2 or not isinstance(
                replay, graphs.Replay) or replay.counts != counts:
            fails.append(n)
        del sc
    if fails:
        raise AssertionError(f"O1: graphed frames differ or miscounted: "
                             f"{fails}")
    v = sorted(capture.values())
    log(f"O1 capture (set-up, host ms, warm-up and capture of an "
        f"interactive program) over the {len(v)} scenes: min {v[0]:.1f}, "
        f"median "
        f"{v[len(v) // 2]:.1f}, max {v[-1]:.1f}")
    return capture


def phase_o2(dev):
    """J3's trace on demo01-03 and test13 through Scene.render (one
    replay of the interactive program a frame after the first), every
    frame uint8-equal to render_cuda + to_frame on the frame's arrays,
    one Whitted launch a frame; every frame returned kept as it was to
    the end; no input staged into the program (its update and pack write
    its buffers inside the graph). Then fsaa 2 (a new key, so a new
    capture) on demo02 for three frames."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS, frame_time
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.trace import to_frame
    tokens = J3_TRACE.split(",")

    def eager(sc):
        return to_frame(ck.render_cuda(sc.arrays, W, H, sc.pfm.fsaa,
                                       sc._cfg(), sc._struct),
                        sc.arrays.use_gamma).cpu().numpy()

    for name in J3_SCENES:
        sc = Scene(j3_scene(name), W, H, device=dev)
        kept, bad, copies = [], [], []
        for fi in range(J3_FRAMES + 1):
            t = frame_time(fi)
            for key in tokens[fi % len(tokens)].split("+"):
                if fi and key in KEY_ACTIONS:
                    sc.update_action(t, KEY_ACTIONS[key])
            n0 = sc._interactive_prog.inputs.copies if fi else 0
            ck.launches = 0
            frame = sc.render(t)
            if ck.launches != 1:
                raise AssertionError(f"O2 {name} frame {fi}: {ck.launches} "
                                     "launches")
            copies.append(sc._interactive_prog.inputs.copies - n0)
            if not np.array_equal(frame, eager(sc)):
                bad.append(fi)
            kept.append((frame, frame.copy()))
        changed = [i for i, (a, b) in enumerate(kept)
                   if not np.array_equal(a, b)]
        fsaa = []
        if name == "demo02":
            sc.pfm.set_fsaa(2)
            prog = sc._interactive_prog
            for fi in range(J3_FRAMES + 1, J3_FRAMES + 4):
                fsaa.append(np.array_equal(sc.render(frame_time(fi)),
                                           eager(sc)))
            fsaa.append(sc._interactive_prog is not prog)
        log(f"O2 {name} {W}x{H}: {J3_FRAMES + 1} frames of J3's trace "
            f"graphed, uint8-equal to render_cuda + to_frame: "
            f"{'all' if not bad else f'not at {bad}'}; returned frames "
            f"changed later: {changed or 'none'}; inputs copied a frame "
            f"after the first: {sorted(set(copies[1:]))} (frames that "
            f"copied none: {copies[1:].count(0)})"
            + (f"; fsaa 2, a new program, three frames equal: {fsaa}"
               if fsaa else ""))
        if bad or changed or not all(fsaa) or any(copies):
            raise AssertionError(f"O2 {name}: frames {bad}, changed "
                                 f"{changed}, fsaa {fsaa}, inputs staged "
                                 f"{copies}")
        del sc, kept
        torch.cuda.empty_cache()


def phase_o3(dev):
    """Graphed passes against the eager ones, bitwise: E2's 64 passes on
    test18 and E5's culled test13 and demo03 through render_pt_pass (one
    PT launch a pass), the sum, seeds and frame against pt_passes' from
    the same seeds; a test18 checkpoint after O_CHECKPOINT passes resumed
    in a new Scene for the rest against the 64 eager passes; and
    render_pt_cuda's graphed passes against eager_render_pt. Returns the
    pass programs' capture ms."""
    import tempfile
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.pt import init_seeds
    from quadray_tpu_torch.ops.trace import TraceConfig
    from quadray_tpu_torch.parallel.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
    cfg = TraceConfig(depth=PT_DEPTH)
    same = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32)) \
        if a.dtype == torch.float32 else torch.equal(a, b)

    def pt_scene(name):
        sc = Scene(load_scene(name), W, H, device=dev)
        sc.update(0.0)
        if not sc.set_pton(True):
            raise AssertionError(f"O3 {name}: set_pton(True) refused")
        return sc

    capture, eager64 = {}, None
    for name in ("test18",) + PT_HEAVY:
        sc = pt_scene(name)
        ck.pt_launches = 0
        frame = sc.render_pt_pass(PT_PASSES)
        torch.cuda.synchronize()
        launches = ck.pt_launches
        acc, seeds = ck.pt_passes(
            sc.arrays, W, H, torch.zeros((W * H, 3), device=dev),
            init_seeds(W * H, device=dev), PT_PASSES, cfg, sc._struct)
        want = eager_pt_frame(acc, PT_PASSES, sc.arrays.use_gamma)
        ok = [same(sc._pt_acc, acc), same(sc._pt_seeds, seeds),
              np.array_equal(frame, want)]
        prog = sc._pass_prog
        capture[name] = (prog.replay.ms, prog.frame_replay.ms)
        log(f"O3 {name} {W}x{H} {PT_PASSES} graphed passes against "
            f"pt_passes: sum, seeds, frame bitwise {ok}; pt_launches "
            f"{launches}; warm-up + capture of the pass "
            f"{capture[name][0]:.1f} ms, of the frame {capture[name][1]:.1f}"
            f" ms; gate cull="
            f"{ck.cull_gates(sc._struct, cfg, pt=True).cull}")
        if not all(ok) or launches != PT_PASSES:
            raise AssertionError(f"O3 {name}: {ok}, {launches} launches")
        if name == "test18":
            eager64 = (acc, seeds, want)
        img, out = ck.render_pt_cuda(sc.arrays, W, H,
                                     init_seeds(W * H, device=dev), 4, cfg,
                                     sc._struct)
        img2, out2 = eager_render_pt(sc.arrays, W, H,
                                     init_seeds(W * H, device=dev), 4, cfg,
                                     sc._struct)
        if not (same(img, img2) and same(out, out2)):
            raise AssertionError(f"O3 {name}: render_pt_cuda's graphed "
                                 "passes differ from the eager ones")
        del sc, acc, seeds, img, img2
        torch.cuda.empty_cache()
    first = pt_scene("test18")
    first.render_pt_pass(O_CHECKPOINT)
    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(tmp, O_CHECKPOINT, None, None,
                               first.pt_state())
        pt = load_checkpoint(path, device=dev, with_pt=True)[3]
    resumed = pt_scene("test18")
    resumed.set_pt_state(pt)
    frame = resumed.render_pt_pass(PT_PASSES - O_CHECKPOINT)
    ok = [same(resumed._pt_acc, eager64[0]),
          same(resumed._pt_seeds, eager64[1]),
          np.array_equal(frame, eager64[2])]
    log(f"O3 test18 checkpoint after {O_CHECKPOINT} graphed passes, resumed "
        f"in a new Scene for {PT_PASSES - O_CHECKPOINT} more: sum, seeds, "
        f"frame bitwise the {PT_PASSES} eager passes' {ok}; render_pt_cuda "
        "4 graphed passes bitwise eager_render_pt's on all three: True")
    if not all(ok):
        raise AssertionError("O3: the resumed graphed run differs")
    return capture


def abba_summary(label, rows, base: str = "eager"):
    """rows: [(mode, value)] in a b b a order; logs each mode's mean and
    graph's over ``base``'s."""
    by = {}
    for mode, v in rows:
        by.setdefault(mode, []).append(v)
    log(f"{label}: " + ", ".join(f"{m} {' / '.join(f'{x:.4f}' for x in v)}"
                                 f" (mean {np.mean(v):.4f})"
                                 for m, v in by.items())
        + f"; graph / {base} "
        f"{np.mean(by['graph']) / np.mean(by[base]):.3f}")
    return {m: float(np.mean(v)) for m, v in by.items()}


def phase_o4(dev, smi):
    """Eager against graphed in one process, a b b a: J3's split (a run
    of J3_FRAMES frames a mode on each scene), main_path_ms_per_frame on
    the bench's ten scenes (median host ms of MAIN_PATH_CALLS frames after
    one, a mode at a time on one Scene) and bench_pt's ms/spp-pass
    (render_pt_cuda against eager_render_pt, through bench.bench_pt)."""
    import statistics
    from quadray_tpu_torch import Scene, bench
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    out = {}
    _, _, _, j3 = phase_j3(dev, smi, modes=O_ABBA, label="O4 J3",
                           extras=False)
    for name, runs in j3.items():
        for key in ("ms", "update", "pack", "rest", "kernel", "busy"):
            out[f"J3 {name} {key}"] = abba_summary(
                f"O4 J3 {name} {key} ({smi})",
                [(r["mode"], r[key]) for r in runs])
    clock = bench.CardClock(dev)
    for name in ("test01",) + bench.SCENES:
        sc = Scene(load_scene(name), W, H, device=dev)
        rows = []
        for mode in O_ABBA:
            fn = lambda: J3_RENDER[mode](sc, 0.0)
            fn()
            rows.append((mode, statistics.median(
                clock.host(fn) for _ in range(bench.MAIN_PATH_CALLS))))
        out[f"main {name}"] = abba_summary(
            f"O4 main_path_ms_per_frame {name} ({smi})", rows)
        del sc
    rows = []
    for mode in O_ABBA:
        saved = ck.render_pt_cuda
        if mode == "eager":
            ck.render_pt_cuda = eager_render_pt
        try:
            rows.append((mode, bench.bench_pt(dev, clock)[
                "ms_per_spp_pass"]))
        finally:
            ck.render_pt_cuda = saved
    out["pt"] = abba_summary(f"O4 bench_pt ms/spp-pass test18 ({smi})",
                             rows)
    return out


def lookup_families(events, n: int) -> dict:
    """An eager window's device ms a call by lookup family (ops/trace.py's
    record_function ranges "lookup.*"): the forward, the kernels launched
    inside each range; the backward, the kernels of the autograd nodes
    whose sequence numbers the ops inside the range took (RowGather's
    backward node counted with the tables)."""
    from torch.autograd import DeviceType
    fam, seq = {}, {}

    def walk(e, name):
        for c in e.cpu_children:
            if c.sequence_nr >= 0:
                seq[c.sequence_nr] = name
            walk(c, name)

    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(
                LOOKUP_RANGES):
            fam.setdefault(e.name, [0.0, 0.0])[0] += e.device_time_total
            walk(e, e.name)
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(
                "autograd::engine::evaluate_function: "):
            name = seq.get(e.sequence_nr)
            if name is None and "RowGather" in e.name:
                name = LOOKUP_RANGES + "tables"
            if name is not None:
                fam.setdefault(name, [0.0, 0.0])[1] += e.device_time_total
    return {k: (f / 1e3 / n, b / 1e3 / n) for k, (f, b) in fam.items()}


def profile_window(label, fn, n: int, smi, prefix: str = "O5",
                   top: int = 0, families: bool = False):
    """fn(i) for i < n under torch.profiler after PROFILE_WARMUP calls
    fn(-1) that are the profile's warm-up steps (torch.profiler's
    schedule: tracing on, nothing recorded): the host's launch calls (the
    CUDA API calls that queue work), the device's kernels, memsets and
    copies, their device ms, the share of PyTorch's indexing_backward
    kernels in it, and the card's busy share of the window (the union of
    their intervals over the host clock around the n calls and a
    synchronize); where no call launches a graph, the launch calls with no
    device record (each queues one device op); with ``top``, that many
    device ops by device time (names cut to 60 characters); with
    ``families``, the device ms of each lookup family
    (``lookup_families``). The device side of a record_function range is
    no device op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=PROFILE_WARMUP, active=n, repeat=1)) as prof:
        for _ in range(PROFILE_WARMUP):
            fn(-1)
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
            if i == n - 1:
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            prof.step()
    events = prof.events()
    dev_ev = [e for e in events if e.device_type != DeviceType.CPU
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith(LOOKUP_RANGES)]
    api = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith((
                "cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy",
                "cudaMemset")):
            api[e.name] = api.get(e.name, 0) + 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_ev)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    dev_ms = sum(b - a for a, b in spans) / 1e3
    if not dev_ev:
        log(f"{prefix} {label}: the profiler saw no device work: device "
            "ms and "
            f"busy share not measured; host calls {api}")
        return None
    index_ms = sum(e.time_range.end - e.time_range.start for e in dev_ev
                   if "indexing_backward_kernel" in e.name) / 1e3
    r = dict(calls=sum(api.values()) / n, device_ops=len(dev_ev) / n,
             device_ms=dev_ms / n, busy=busy / 1e3 / wall, wall=wall / n,
             index_backward_ms=index_ms / n,
             index_backward_share=index_ms / dev_ms,
             unrecorded=(None if api.get("cudaGraphLaunch") else
                         sum(api.values()) - len(dev_ev)),
             names={e.name for e in dev_ev})
    log(f"{prefix} {label} ({smi}), {n} under torch.profiler: a "
        f"{r['wall']:.4f} "
        f"ms each on the host clock; host launch calls a call "
        f"{r['calls']:.1f} ({ {k: v / n for k, v in api.items()} }); device "
        f"kernels, memsets and copies a call {r['device_ops']:.1f}, device "
        f"{r['device_ms']:.4f} ms a call; card busy {100 * r['busy']:.2f}% "
        f"of the window; PyTorch's indexing_backward kernels "
        f"{r['index_backward_ms']:.4f} ms a call, "
        f"{100 * r['index_backward_share']:.2f}% of the device time"
        + ("" if r["unrecorded"] is None else
           f"; launch calls with no device record {r['unrecorded']}"))
    if top:
        by = {}
        for e in dev_ev:
            t, c = by.get(e.name, (0.0, 0))
            by[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
        log(f"{prefix} {label}: top device ops a call: " + "; ".join(
            f"{k[:60]} {t / 1e3 / n:.4f} ms x{c / n:.0f}" for k, (t, c) in
            sorted(by.items(), key=lambda kv: -kv[1][0])[:top]))
    if families:
        fam = r["families"] = lookup_families(events, n)
        total = sum(f + b for f, b in fam.values())
        log(f"{prefix} {label}: lookup families a call, device ms forward "
            "/ backward: " + "; ".join(
                f"{k[len(LOOKUP_RANGES):]} {f:.4f} / {b:.4f} "
                f"({100 * (f + b) / r['device_ms']:.2f}%)"
                for k, (f, b) in sorted(fam.items()))
            + f"; together {total:.4f} ms, "
            f"{100 * total / r['device_ms']:.2f}% of the device time")
    return r


def phase_o5(dev, smi):
    """One torch.profiler window each for an interactive frame (demo02,
    800x480, J3's trace, O_PROFILED frames) and a PT pass (test18,
    O_PROFILED passes at depth 10), eager and graphed."""
    from quadray_tpu_torch import Scene
    from quadray_tpu_torch.apps.render_cli import KEY_ACTIONS, frame_time
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.pt import init_seeds
    from quadray_tpu_torch.ops.trace import TraceConfig
    tokens = J3_TRACE.split(",")
    out = {}
    for mode in ("eager", "graph"):
        sc = Scene(j3_scene("demo02"), W, H, device=dev)
        render = J3_RENDER[mode]

        def frame(i):
            fi = i + 2
            for key in tokens[fi % len(tokens)].split("+"):
                if key in KEY_ACTIONS:
                    sc.update_action(frame_time(fi), KEY_ACTIONS[key])
            render(sc, frame_time(fi))

        render(sc, 0.0)
        out[f"frame {mode}"] = profile_window(
            f"interactive frame, demo02 {W}x{H}, {mode}", frame, O_PROFILED,
            smi)
        del sc
    sc = Scene(load_scene("test18"), W, H, device=dev)
    sc.update(0.0)
    sc.set_pton(True)
    cfg, n = TraceConfig(depth=PT_DEPTH), W * H
    state = [torch.zeros((n, 3), device=dev), init_seeds(n, device=dev)]

    def eager_pass(i):
        state[:] = ck.pt_passes(sc.arrays, W, H, state[0], state[1], 1, cfg,
                                sc._struct)
        eager_pt_frame(state[0], i + 2, sc.arrays.use_gamma)

    out["pass eager"] = profile_window(
        f"PT pass, test18 {W}x{H} depth {PT_DEPTH}, eager (pt_passes and "
        "the frame)", eager_pass, O_PROFILED, smi)
    out["pass graph"] = profile_window(
        f"PT pass, test18 {W}x{H} depth {PT_DEPTH}, graph "
        "(render_pt_pass(1), with its frame)",
        lambda i: sc.render_pt_pass(1), O_PROFILED, smi)
    return out


def phase_p1(dev, smi):
    """The graphed step against the eager one, bitwise: P_STEPS steps of
    make_train_scan_fast from one state on bench_train's task (every
    field) on each of P_BLOCKS, graph route and eager=True; the first
    call's warm-up and capture ms and the memory it keeps (the graph's
    pool). Returns ({blocks: ({route: run_fn}, the graphed run's params
    and state)}, the task)."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import replay as rp
    from quadray_tpu_torch.ops import row_gather as rg
    from quadray_tpu_torch.parallel import train as tr
    bits = lambda t: t.contiguous().view(torch.int32)
    sc, target, _ = train_task(dev)
    out = {}
    for b in P_BLOCKS:
        mesh = None if b == 1 else card_mesh(dev, b)
        fns, runs, counts = {}, {}, {}
        for mode in ("graph", "eager"):
            fns[mode], opt_init = tr.make_train_scan_fast(
                sc, W, H, cfg=train_cfg(), lr=TRAIN_LR, k_paths=K_PATHS,
                mesh=mesh, eager=mode == "eager")
            if fns[mode].route(sc) != mode:
                raise AssertionError(f"P1 {b} blocks: the {mode} run took "
                                     f"the {fns[mode].route(sc)} route")
            p0 = tr.extract_params(sc)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            mem0 = (torch.cuda.memory_allocated(dev),
                    torch.cuda.memory_reserved(dev))
            ck.paths_launches = rg.launches = rg.backward_launches = 0
            rp.launches = rp.backward_launches = 0
            t0 = time.perf_counter()
            runs[mode] = fns[mode](p0, opt_init(p0), sc, target, P_STEPS)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts[mode] = (ck.paths_launches, rp.launches,
                            rp.backward_launches, rg.launches,
                            rg.backward_launches)
            if mode == "graph":
                torch.cuda.empty_cache()
                prog = next(iter(fns[mode].programs.values()))
                kept = (torch.cuda.memory_allocated(dev) - mem0[0],
                        torch.cuda.memory_reserved(dev) - mem0[1])
                log(f"P1 {b} block(s), route graph: the first call of "
                    f"{P_STEPS} steps {ms:.1f} ms, of which the first step "
                    f"and the capture {prog.replay.ms:.1f} ms; the graph's "
                    f"launches {prog.replay.counts}; memory kept after "
                    f"the call: allocated +{kept[0] / 2**20:.1f} MiB, "
                    f"reserved +{kept[1] / 2**20:.1f} MiB (the graph's "
                    "pool and the program's buffers)")
        same = {"loss": torch.equal(bits(runs["graph"][2]),
                                    bits(runs["eager"][2]))}
        (pa, oa, _), (pb, ob, _) = runs["graph"], runs["eager"]
        for what, x, y in (("params", pa, pb), ("mu", oa.mu, ob.mu),
                           ("nu", oa.nu, ob.nu)):
            same[what] = all(torch.equal(bits(x[k]), bits(y[k])) for k in x)
        losses = [float(x) for x in runs["graph"][2]]
        log(f"P1 test01 {W}x{H} K={K_PATHS} every field, {b} block(s), "
            f"{P_STEPS} steps graphed against eager from one state: "
            f"bitwise {same}; counts (paths, replay forward, backward, "
            f"gather forward, row sums) "
            f"graph {counts['graph']} eager {counts['eager']}; losses "
            + " ".join(f"{x:.6e}" for x in losses))
        want = (b * P_STEPS,) * 3 + (0, b * P_STEPS)
        if not all(same.values()) or set(counts.values()) != {want}:
            raise AssertionError(f"P1 {b} blocks: graphed steps off the "
                                 f"eager ones: {same}, counts {counts}")
        if oa.count != P_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"P1 {b} blocks: count {oa.count}, "
                                 f"losses {losses}")
        out[b] = (fns, runs["graph"][:2])
        del runs
    return out, (sc, target)


def phase_p2(dev, smi, fns, task):
    """Eager against graphed in this process, a b b a: ms/step of calls of
    P_STEPS steps (CUDA events around each call, the runs warmed by P1),
    on each of P_BLOCKS; then P_PROFILED one-step calls of each route on
    one block under torch.profiler."""
    sc, target = task
    out = {}
    for b, (runs, start) in fns.items():
        state = {mode: list(start) for mode in runs}
        rows = []
        for mode in O_ABBA:
            def call():
                p, o, _ = runs[mode](*state[mode], sc, target, P_STEPS)
                state[mode][:] = [p, o]
            rows.append((mode, cuda_ms(call, 1, warmup=0) / P_STEPS))
        out[b] = abba_summary(f"P2 ms/step, {b} block(s), calls of "
                              f"{P_STEPS} steps ({smi})", rows)
    runs, start = fns[P_BLOCKS[0]]
    for mode in ("eager", "graph"):
        state = list(start)

        def step(i):
            p, o, _ = runs[mode](*state, sc, target, 1)
            state[:] = [p, o]

        out[f"profile {mode}"] = profile_window(
            f"one training step a call, test01 {W}x{H} K={K_PATHS} every "
            f"field, {P_BLOCKS[0]} block, {mode}", step, P_PROFILED, smi,
            prefix="P2")
    return out


def release_memory(dev):
    """Drops what earlier work left cached on the card (render_pt_cuda's
    pass programs, unreachable programs and their graphs' pools, the
    allocator's cache) and starts a new peak."""
    import gc
    from quadray_tpu_torch.ops import graphs
    graphs._PT_PROGRAMS.clear()
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def same_bits(a, b) -> dict:
    """Two runs' (params, AdamState, losses): which of loss, params, mu
    and nu are bitwise equal."""
    bits = lambda t: t.contiguous().view(torch.int32)
    (pa, oa, la), (pb, ob, lb) = a, b
    same = {"loss": torch.equal(bits(la), bits(lb))}
    for what, x, y in (("params", pa, pb), ("mu", oa.mu, ob.mu),
                       ("nu", oa.nu, ob.nu)):
        same[what] = all(torch.equal(bits(x[k]), bits(y[k])) for k in x)
    return same


def timed_run(run_fn, sc, target, steps: int, chained: bool = False):
    """run_fn ``steps`` steps from sc's every differentiable field and a
    fresh Adam state, in one call or (``chained``) a one-step call a step,
    each from the last one's params and state: ((params, state, losses),
    ms a step, CUDA events around the calls; with ``chained`` the first
    call's result too)."""
    from quadray_tpu_torch.parallel import train as tr
    p0 = tr.extract_params(sc)
    out = []

    def run():
        if not chained:
            out.append(run_fn(p0, tr.adam_init(p0), sc, target, steps))
            return
        p, o = p0, tr.adam_init(p0)
        for _ in range(steps):
            out.append(run_fn(p, o, sc, target, 1))
            p, o = out[-1][:2]

    ms = cuda_ms(run, 1, warmup=0) / steps
    if not chained:
        return out[0], ms
    return out[-1][:2] + (torch.cat([r[2] for r in out]),), ms, out[0]


def gib(n: int) -> str:
    return f"{n / 2**30:.2f} GiB"


def route_gathers(sc, rays, cfg) -> list:
    """Each bounce's row-gather arguments (s_kind, s_mat, m_props, srf,
    sidep) in trace_rays_diff on sc, recorded by a stand-in for RowGather
    around a forward under no_grad."""
    from quadray_tpu_torch.ops import row_gather as rg
    from quadray_tpu_torch.ops.trace import trace_rays_diff
    real, segs = rg.RowGather, []

    class Stand:
        @staticmethod
        def apply(stab, mtab, *a):
            segs.append(a)
            return real.apply(stab, mtab, *a)

    rg.RowGather = Stand
    try:
        with torch.no_grad():
            trace_rays_diff(sc, *rays, cfg)
    finally:
        rg.RowGather = real
    return segs


def index_put_ms(stab, mtab, segs, grads) -> float:
    """The backward autograd ran for the lookups before the gather: each
    bounce's row gradients added into the tables by index_put_ with
    accumulate (a sort, then each row summed serially), (NT, F) tables,
    ms a step (CUDA events)."""
    from quadray_tpu_torch.ops import row_gather as rg
    midx = [rg.gather_plain(stab, mtab, *a)[1].long() for a in segs]
    srf = [a[3].long() for a in segs]

    def bwd():
        for s_, m, (gs, gm) in zip(srf, midx, grads):
            stab.new_zeros(stab.T.shape).index_put_((s_,), gs.T,
                                                    accumulate=True)
            mtab.new_zeros(mtab.T.shape).index_put_((m,), gm.T,
                                                    accumulate=True)

    return cuda_ms(bwd, 2)


def phase_s(dev, smi):
    """The row gather at the all-surface route's shapes: each bounce's
    row ids of trace_rays_diff on Q's scenes at 800x480 (the step's moved
    scene), a seeded gradient: the kernels bitwise gather_plain and
    row_sum_plain, two launches each; a step's device ms (CUDA graphs)
    beside the bound, the plain versions (CUDA events), index_select,
    index_add_ and index_put_ with accumulate. Returns {scene: times}."""
    from quadray_tpu_torch.ops import row_gather as rg
    bits = lambda t: t.contiguous().view(torch.int32)
    cfg = train_cfg()
    rs = np.random.RandomState(23)
    out = {}
    for name in Q_SCENES:
        sc, _, rays = train_task(dev, name)
        segs = route_gathers(sc, rays, cfg)
        with torch.no_grad():
            stab, mtab = rg.row_tables(sc)
        ns, nm, n = stab.shape[1], mtab.shape[1], rays[1].shape[0]
        grads = [tuple(torch.from_numpy(rs.standard_normal((f, n)).astype(
            np.float32)).to(dev) for f in (rg.SURFACE_ROWS,
                                           rg.MATERIAL_ROWS)) for _ in segs]
        differ, hit, worst = 0, [], 0.0
        for a, (gs, gm) in zip(segs, grads):
            want = rg.gather_plain(stab, mtab, *a)
            want_g = (rg.row_sum_plain(gs, a[3], ns),
                      rg.row_sum_plain(gm, want[1], nm))
            for _ in range(2):
                got = rg._forward(stab, mtab, *a)
                got_g = rg._backward(gs, gm, a[3], got[1], ns, nm)
                torch.cuda.synchronize()
                for x, y in zip(got + got_g, want + want_g):
                    differ += int((bits(x) != bits(y)).sum())
                    if x.dtype == torch.float32:
                        worst = max(worst, float((x - y).abs().max()))
            hit.append((int(torch.unique(a[3]).numel()),
                        int(torch.unique(want[1]).numel())))
        k_fwd, k_bwd = gather_ms(stab, mtab, segs, grads)
        p_fwd, p_bwd, l_fwd, l_add = gather_others_ms(stab, mtab, segs,
                                                      grads)
        l_put = index_put_ms(stab, mtab, segs, grads)
        bound = gather_bound(n, len(segs), ns, nm)
        out[name] = dict(bounces=len(segs), rays=n, ms=k_fwd + k_bwd,
                         forward_ms=k_fwd, backward_ms=k_bwd,
                         plain_ms=p_fwd + p_bwd, library_ms=l_fwd + l_put,
                         index_select_ms=l_fwd, index_put_ms=l_put,
                         index_add_ms=l_add, bound_ms=bound[0],
                         bound_by=bound[1], max_abs_err=worst)
        log(f"S {name} {W}x{H}, {len(segs)} bounces of trace_rays_diff "
            f"({ns} surface rows, {nm} material rows; distinct surfaces and "
            f"materials a bounce {hit}): kernel vs plain, forward and "
            f"backward, two launches each: {differ} words differ; ms a "
            f"step ({smi}): kernel forward {k_fwd:.4f} backward "
            f"{k_bwd:.4f}, plain {p_fwd:.3f} / {p_bwd:.3f}, index_select "
            f"{l_fwd:.4f}, index_add_ {l_add:.4f}, index_put_ with "
            f"accumulate {l_put:.4f}; bound {bound[0]:.4f} ({bound[1]})")
        if differ or len(segs) != cfg.max_segments:
            raise AssertionError(f"S {name}: {len(segs)} gathers, kernels "
                                 f"off their plain versions in {differ} "
                                 "words")
        del sc, rays, segs, grads, stab, mtab
        torch.cuda.empty_cache()
    return out


def diff_bounds(n: int, k: int, words: int, ns: int, nm: int, nl: int,
                struct, stats, hits: int) -> dict:
    """bound_ms of the fused all-surface route's parts on n rays of k
    bounces, ``hits`` of the k n ray-bounces hits: the forward reads the
    rays (28 bytes a ray), writes the colors (12) and the tape's contract
    (``diff.tape_read``: the flags word of every ray-bounce, the 12
    floats, the texel and the light words of a hit) and does the surface
    tests its walks need (``surface_ops`` of forward_plain's count) and
    each hit's shading (R_SEG_OPS, R_LIGHT_OPS a light); the backward reads
    the flags word of every ray-bounce, and the rest of the tape (12
    floats, the texel and the light words) only of a hit, as replay's
    bound counts a live segment's state, and the colors' gradient, writes
    each block's partial of every table column (``diff.table_columns``),
    recomputes and differentiates each hit (R_BWD_FACTOR times its
    forward) and adds each hit's 29 row and 10 NL + 3 light and ambient
    gradients into the sums once; the light sums read the partials and
    write the tables' gradients (the two together, "backward", count
    neither the partials' writes nor their reads: they are no input or
    output of the pair); the wide mode's row sums read 29 row gradients
    and 2 ids a ray a bounce, which its backward writes."""
    from quadray_tpu_torch.ops import replay as rp
    kn = k * n
    shade = hits * (R_SEG_OPS + nl * R_LIGHT_OPS)
    cols = 10 * nl + 3 + 19 * ns + 10 * nm
    blocks = -(-n // (rp.BWD_WARPS * rp.WARP))
    launch = (4 * kn + 4 * hits * (12 + words - 1) + 12 * n
              + 4 * blocks * cols,
              R_BWD_FACTOR * shade + hits * (29 + 10 * nl + 3))
    sums = (4 * blocks * cols + 4 * cols, blocks * cols)
    # the backward as phase T times it: the launch and the light sums, a
    # function of the tape, g_cols and the tables to the tables' gradients;
    # the partials pass between its two launches and are not counted
    return {"forward": bound_ms(40 * n + 4 * kn + 4 * hits * (12 + words - 1),
                                surface_ops(struct, stats) + shade),
            "backward": bound_ms(launch[0] + sums[0] - 8 * blocks * cols,
                                 launch[1] + sums[1]),
            "backward_launch": bound_ms(*launch),
            "light_sums": bound_ms(*sums),
            "row_sums": bound_ms(124 * kn + 4 * 29 * (ns + nm), 29 * kn)}


def fused_grads(fn, sc, rays, g, cfg=None):
    """{field: gradient of sum(g * fn(sc, *rays, cfg))} for every
    differentiable field (cfg: train_cfg() by default)."""
    from quadray_tpu_torch.parallel import train as tr
    leaves = {k: getattr(sc, k).detach().clone().requires_grad_(True)
              for k in tr.DIFFERENTIABLE_FIELDS}
    cols = fn(dataclasses.replace(sc, **leaves), *rays, cfg or train_cfg())
    (cols * g).sum().backward()
    return {k: v.grad for k, v in leaves.items()}


def t_cfg(what: str):
    """Phase T's and Q4's TraceConfig by case: the step's (``default``),
    with Schlick Fresnel, or T_DEEP's stack past the 16 local slots."""
    from quadray_tpu_torch.ops.trace import TraceConfig
    if what == "deep":
        return TraceConfig(**T_DEEP)
    return train_cfg()._replace(schlick=what == "schlick")


def t_case(dev, smi, name: str, what: str, wide: bool) -> dict:
    """Phase T on one scene and case (``t_cfg``) at 800x480: the kernels
    against their plain versions, two launches each, bitwise (the forward,
    and on the default case the Whitted kernel's colors; the backward's
    partials through the light sums; with ``wide`` the forced wide mode,
    its row gradients and ids and its four gradients through the row sums,
    against its own plain version); the route's gradients against
    autograd's trace_rays_diff (the deep case at T_DEEP_GRAD_W x
    T_DEEP_GRAD_H; none for ``smem``, the step's cfg on a scene whose
    accumulators need the opt-in past 48 KB of shared memory); device ms
    beside the bounds and the plain versions' ms; the backward's blocks
    an SM."""
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops import diff
    from quadray_tpu_torch.ops import replay as rp
    from quadray_tpu_torch.ops import row_gather as rg
    from quadray_tpu_torch.ops.trace import trace_rays_diff
    bits = lambda t: t.contiguous().view(torch.int32)
    cfg = t_cfg(what)
    sc, _, rays = train_task(dev, name)
    struct = ck.scene_struct(sc)
    n, k = rays[1].shape[0], cfg.max_segments
    stats = {}
    cols, tf, ti = diff.forward_plain(sc, *rays, cfg, stats)
    T = diff.tables(sc)
    g = torch.from_numpy(np.random.RandomState(29).standard_normal(
        (n, 3)).astype(np.float32)).to(dev)
    tiles = diff.backward_rows_plain(g, T, tf, ti, cfg.stack,
                                     cfg.schlick)[3]
    g_la = rp._block_sums(tiles)
    del tiles
    # the tape is compared where its contract says the backward reads it
    # (diff.tape_read; the kernel leaves the other words unwritten), and
    # the backward runs on the kernel's own tape
    pairs = [("colors", lambda o: o[0], cols), ("sums", lambda o: o[3], g_la)]
    if what == "default":
        pairs.append(("colors vs whitted", lambda o: o[0],
                      ck.trace_rays_cuda(sc, *rays, cfg._replace(cull=False))))
    if wide:
        ws, wm, wids, wtiles = diff.backward_rows_plain(
            g, T, tf, ti, cfg.stack, cfg.schlick, True)
        want_w = diff.backward_plain(g, T, tf, ti, cfg.stack, cfg.schlick,
                                     True)
        pairs += [("wide g_s", lambda o: o[4][0], ws),
                  ("wide g_m", lambda o: o[4][1], wm),
                  ("wide ids", lambda o: o[4][2], wids),
                  ("wide sums", lambda o: o[4][3], rp._block_sums(wtiles))]
        pairs += [(f"wide {f}", lambda o, j=j: o[5][j], want_w[j])
                  for j, f in enumerate(("stab", "mtab", "ltab", "amb"))]
        del wtiles
    rows_before = rg.backward_launches
    differ, worst = {}, 0.0
    for _ in range(2):
        out = list(diff.forward_kernel(sc, struct, *rays, cfg))
        out.append(diff.light_sums_kernel(diff.backward_rows_kernel(
            g, T, out[1], out[2], cfg)[3]))
        if wide:
            w4 = diff.backward_rows_kernel(g, T, out[1], out[2], cfg, True)
            out.append(w4[:3] + (diff.light_sums_kernel(w4[3]),))
            out.append(diff.backward_kernel(g, T, out[1], out[2], cfg,
                                            smem=0))
        torch.cuda.synchronize()
        differ["tape"] = differ.get("tape", 0) + diff.tape_differs(
            tf, ti, out[1], out[2])
        for what_, get, y in pairs:
            x = get(out)
            differ[what_] = differ.get(what_, 0) + int(
                (bits(x) != bits(y)).sum())
            if x.dtype == torch.float32:
                worst = max(worst, float((x - y).abs().max()))
        del out
    rows = rg.backward_launches - rows_before
    rel = {}
    if what != "smem":
        if what == "deep":
            sc_g, _, rays_g = train_task(dev, name, T_DEEP_GRAD_W,
                                         T_DEEP_GRAD_H)
            g_g = g[:rays_g[1].shape[0]].contiguous()
        else:
            sc_g, rays_g, g_g = sc, rays, g
        got = fused_grads(diff.trace_rays_fused, sc_g, rays_g, g_g, cfg)
        want = fused_grads(trace_rays_diff, sc_g, rays_g, g_g, cfg)
        rel = {f: float((got[f] - want[f]).abs().max()
                        / max(float(want[f].abs().max()), 1e-30))
               for f in got}
        del got, want, sc_g, rays_g, g_g
        torch.cuda.empty_cache()
    fl = ti[:, 0]
    hits = int(((fl & diff.HIT) != 0).sum())
    # the forward's warp-bounces: a warp runs bounce k while a lane of it
    # is active; the share of its lanes that are, and that hit
    pad = (-n) % 32
    lanes = lambda m: torch.nn.functional.pad(m, (0, pad)).view(k, -1, 32)
    act = lanes((fl & diff.ACTIVE) != 0)
    runs = int(act.any(2).sum())
    live_share = int(act.sum()) / (32 * runs)
    hit_share_run = hits / (32 * runs)
    step = ((fl & diff.PUSH) != 0).int() - ((fl & diff.POP) != 0).int()
    height = int(torch.cumsum(step, dim=0).max())
    nl, words = T.ltab.shape[0], ti.shape[1]
    ns, nm = T.stab.shape[1], T.mtab.shape[1]
    bounds = diff_bounds(n, k, words, ns, nm, nl, struct, stats, hits)
    k_fwd = graph_ms(lambda: diff.forward_kernel(sc, struct, *rays, cfg),
                     T_REPS)
    k_bwd = graph_ms(lambda: diff.light_sums_kernel(
        diff.backward_rows_kernel(g, T, tf, ti, cfg)[3]), T_REPS)
    k_launch = graph_ms(lambda: diff.backward_rows_kernel(g, T, tf, ti, cfg),
                        T_REPS)
    lpart = diff.backward_rows_kernel(g, T, tf, ti, cfg)[3]
    k_sums = graph_ms(lambda: diff.light_sums_kernel(lpart), T_REPS)
    del lpart
    r = dict(case=what, scene=name, rays=n, bounces=k, hits=hits,
             hit_share=hits / (k * n), height=height,
             warp_bounces=runs, live_lane_share=live_share,
             hit_lane_share=hit_share_run, forward_ms=k_fwd,
             backward_ms=k_bwd, backward_launch_ms=k_launch,
             light_sums_ms=k_sums,
             blocks_per_sm=diff.backward_occupancy(cfg, diff.table_columns(T)),
             bounds={p: {"bound_ms": b[0], "bound_by": b[1]}
                     for p, b in bounds.items()},
             max_abs_err=worst, grad_rel=max(rel.values(), default=None),
             smem_bytes=4 * rp.BWD_WARPS * diff.table_columns(T),
             tape_bytes=(tf.numel() + ti.numel()) * 4,
             tape_written_bytes=4 * (k * n + hits * (12 + words - 1)),
             forward_bound_share=bounds["forward"][0] / k_fwd)
    if wide:
        rw = diff.backward_rows_kernel(g, T, tf, ti, cfg, True)
        r["wide_backward_ms"] = graph_ms(lambda: diff.backward_kernel(
            g, T, tf, ti, cfg, smem=0), T_REPS)
        r["wide_row_sums_ms"] = graph_ms(lambda: rg._backward(
            rw[0], rw[1], rw[2][0], rw[2][1], ns, nm), T_REPS)
        r["wide_row_sum_launches"] = rows
        del rw
    if what == "default":
        r["plain_forward_ms"] = cuda_ms(
            lambda: diff.forward_plain(sc, *rays, cfg), 1)
        r["plain_backward_ms"] = cuda_ms(lambda: rp._block_sums(
            diff.backward_rows_plain(g, T, tf, ti, cfg.stack)[3]), 1)
        r["flags"] = {"push": int(((fl & diff.PUSH) != 0).sum()),
                      "pop": int(((fl & diff.POP) != 0).sum()),
                      "own": int(((fl & diff.OWN) != 0).sum()),
                      "nudge": int(((fl & diff.NUDGE) != 0).sum()),
                      "textured": int((((fl & diff.HIT) != 0)
                                       & (ti[:, 1] >= 0)).sum())}
    gw, gh = (T_DEEP_GRAD_W, T_DEEP_GRAD_H) if what == "deep" else (W, H)
    log(f"T {name} {what} {W}x{H} K={k} stack={cfg.stack} schlick="
        f"{cfg.schlick} ({ns} surfaces, {nl} lights; hits {hits} of "
        f"{k * n} ray-bounces ({100 * hits / (k * n):.2f}%), stack height "
        f"up to {height}; tape {r['tape_bytes'] / n:.0f} B a ray "
        f"allocated, {r['tape_written_bytes'] / n:.1f} written (the "
        f"contract); the forward runs {runs} warp-bounces, "
        f"{100 * live_share:.2f}% of their lanes active, "
        f"{100 * hit_share_run:.2f}% with a hit"
        + (f"; {r['flags']}" if "flags" in r else "")
        + f"): kernels vs plain, two launches each"
        + (", the wide mode forced too" if wide else "")
        + f", words differing {differ}; largest absolute difference "
        f"{worst:.3e}"
        + (f"; gradients vs autograd's trace_rays_diff at {gw}x{gh}, of "
           "each field's largest: "
           + " ".join(f"{f}={v:.1e}" for f, v in rel.items())
           + f" (bound {T_GRAD_RTOL})" if rel else "")
        + f"; ms ({smi}): forward (pack "
        f"+ tape launch) {k_fwd:.4f}, backward (launch + light sums) "
        f"{k_bwd:.4f} "
        f"(launch {k_launch:.4f}, light sums {k_sums:.4f}); the "
        f"accumulators {r['smem_bytes']} B a block (past 48 KB: the "
        f"opt-in {r['smem_bytes'] > 48 * 1024}), backward blocks an SM "
        f"{r['blocks_per_sm']}"
        + (f"; wide mode (launch, row sums, light sums) "
           f"{r['wide_backward_ms']:.4f}, its row sums "
           f"{r['wide_row_sums_ms']:.4f}, row-sum launches {rows}"
           if wide else "")
        + (f"; plain forward {r['plain_forward_ms']:.2f}, plain backward "
           f"(rows + sums) {r['plain_backward_ms']:.2f}"
           if what == "default" else "")
        + "; bounds "
        + " ".join(f"{p} {b[0]:.4f} ({b[1]})" for p, b in bounds.items())
        + f"; the forward at {100 * r['forward_bound_share']:.1f}% of its "
        f"bound (set by {bounds['forward'][1]})")
    if any(differ.values()):
        raise AssertionError(f"T {name} {what}: kernels off their plain "
                             f"versions: {differ}")
    if wide and rows != 2:
        raise AssertionError(f"T {name}: the forced wide mode made {rows} "
                             "row-sum launches, not 2")
    if what == "deep" and name == "test18" and height <= 16:
        raise AssertionError(f"T {name} deep: the stack reached {height}")
    bad = {f: v for f, v in rel.items() if not v <= T_GRAD_RTOL}
    if bad:
        raise AssertionError(f"T {name} {what}: gradients off autograd's: "
                             f"{bad}")
    return r


def phase_t(dev, smi):
    """The fused all-surface route's kernels against their plain versions
    and autograd's route (the module docstring's T): T_SCENES at the
    step's cfg with the wide mode forced too, then T_EXTRA's Schlick and
    deep-stack cases, then T_SMEM_SCENE's tables, whose accumulators take
    the shared-memory opt-in past 48 KB (the backward launch and light
    sums bitwise their plain version). Returns ({scene: the default
    case's numbers, with "cases": the others'}, T_SMEM_SCENE's
    numbers)."""
    from quadray_tpu_torch.ops import diff
    out = {}
    for name in T_SCENES:
        out[name] = t_case(dev, smi, name, "default", True)
        torch.cuda.empty_cache()
    for what, name in T_EXTRA:
        out[name].setdefault("cases", {})[what] = t_case(dev, smi, name,
                                                         what, False)
        torch.cuda.empty_cache()
    big = t_case(dev, smi, T_SMEM_SCENE, "smem", False)
    torch.cuda.empty_cache()
    if not big["smem_bytes"] > 48 * 1024 or big["smem_bytes"] > (
            diff.ROWS_SMEM_BYTES):
        raise AssertionError(f"T {T_SMEM_SCENE}: {big['smem_bytes']} B of "
                             "accumulators, not past 48 KB inside a block")
    return out, big


@contextlib.contextmanager
def autograd_route():
    """make_train_step's loss through trace_rays_diff (autograd over the
    plain tracer's bounces, each bounce's table reads one row gather): the
    route before the fused one, for a profiler window."""
    from quadray_tpu_torch.ops.trace import trace_rays_diff
    from quadray_tpu_torch.parallel import train as tr

    saved = tr.trace_rays_fused
    tr.trace_rays_fused = trace_rays_diff
    try:
        yield
    finally:
        tr.trace_rays_fused = saved


def phase_q1(dev):
    """One all-surface step on the card (the graph route) against the same
    step on the CPU (eager), test17 at Q1_W x Q1_H from the same arrays:
    the loss within Q_LOSS_RTOL, every field's params within
    Q_PARAM_ATOL."""
    from quadray_tpu_torch.parallel import train as tr
    from quadray_tpu_torch.parallel.render import replica
    cpu = torch.device("cpu")
    sc, target, _ = train_task(cpu, "test17", Q1_W, Q1_H)
    runs = {}
    for d, eager in ((cpu, True), (dev, False)):
        step_fn, opt_init = tr.make_train_step(
            Q1_W, Q1_H, cfg=train_cfg(), lr=TRAIN_LR, eager=eager)
        s = replica(sc, d)
        if step_fn.run.route(s) != ("eager" if eager else "graph"):
            raise AssertionError(f"Q1: the {d} step took the "
                                 f"{step_fn.run.route(s)} route")
        p0 = tr.extract_params(s)
        runs[eager] = step_fn(p0, opt_init(p0), s, target.to(d))
    (pc, _, lc), (pg, _, lg) = runs[True], runs[False]
    rel = abs(float(lg) - float(lc)) / abs(float(lc))
    worst = max(float((pg[k].cpu() - pc[k]).abs().max()) for k in pc)
    log(f"Q1 test17 {Q1_W}x{Q1_H} every field, one make_train_step step: "
        f"the card's graphed loss {float(lg):.8e} against the CPU's "
        f"{float(lc):.8e} (relative {rel:.2e}, bound {Q_LOSS_RTOL}); params "
        f"off by at most {worst:.2e} (bound {Q_PARAM_ATOL})")
    if not (rel <= Q_LOSS_RTOL and worst <= Q_PARAM_ATOL):
        raise AssertionError("Q1: the card's step off the CPU's")


def phase_q2(dev, smi):
    """The all-surface step at 800x480 on each of Q_SCENES and Q_BLOCKS
    blocks of cuda:0, every field, each run from the scene's params and a
    fresh state: eager, Q_STEPS one-step calls chained; the graph route,
    a call of Q_STEPS steps (the warm-up, the capture, replays), bitwise
    the chain's last; two one-step graphed calls and, the program
    dropped, one eager, each bitwise the chain's first step (two eager
    steps from one state, and graphed ones); ms/step in that order (a b b
    a), the capture's ms, the graph's pool and the peak memory; on the
    first scene and 1 block a profiler window of each route and of the
    eager step through trace_rays_diff (the autograd route before this
    one), that window split by lookup family. The fused route's and the
    row gather's counters are set to 0 before and read after: each graph
    records one pack, tape, backward and light-sum launch a
    block (none of the row sums). Returns (the first scene's 1-block
    peak allocated bytes a ray, the launches over the phase)."""
    from quadray_tpu_torch.ops import diff
    from quadray_tpu_torch.ops import row_gather as rg
    from quadray_tpu_torch.parallel import train as tr
    per_ray = None
    rg.launches = rg.backward_launches = 0
    diff.launches = diff.backward_launches = diff.light_sum_launches = 0
    for name in Q_SCENES:
        sc, target, _ = train_task(dev, name)
        for b in Q_BLOCKS:
            mesh = None if b == 1 else card_mesh(dev, b)
            fns = {mode: tr.make_train_step(W, H, cfg=train_cfg(),
                                            lr=TRAIN_LR, mesh=mesh,
                                            eager=mode == "eager")[0].run
                   for mode in ("eager", "graph")}
            for mode, fn in fns.items():
                if fn.route(sc) != mode:
                    raise AssertionError(f"Q2 {name} {b} blocks: the {mode} "
                                         f"run took the {fn.route(sc)} route")
            profiled = per_ray is None
            release_memory(dev)
            e_last, ms_e1, e_first = timed_run(fns["eager"], sc, target,
                                               Q_STEPS, chained=True)
            peak_e = torch.cuda.max_memory_allocated(dev)
            release_memory(dev)
            res0 = torch.cuda.memory_reserved(dev)
            g1, ms_g1 = timed_run(fns["graph"], sc, target, Q_STEPS)
            prog = next(iter(fns["graph"].programs.values()))
            pool = torch.cuda.memory_reserved(dev) - res0
            peak_g = torch.cuda.max_memory_allocated(dev)
            g2, ms_g2 = timed_run(fns["graph"], sc, target, 1)
            g3, ms_g3 = timed_run(fns["graph"], sc, target, 1)
            capture, warmup = prog.replay.ms, prog.replay.warmup_ms
            counts = prog.replay.counts
            p0 = tr.extract_params(sc)

            def one(fn):
                state = [p0, tr.adam_init(p0)]

                def step(i):
                    p, o, _ = fn(*state, sc, target, 1)
                    state[:] = [p, o]
                return step

            if profiled:
                graph_window(name, one(fns["graph"]), smi)
            del prog
            fns["graph"] = None
            release_memory(dev)
            e2, ms_e2 = timed_run(fns["eager"], sc, target, 1)
            if profiled:
                profile_window(
                    f"one all-surface step a call, {name} {W}x{H} every "
                    "field, 1 block, eager", one(fns["eager"]), 1, smi,
                    prefix="Q2", top=8)
                rows0 = (rg.launches, rg.backward_launches)
                with autograd_route():
                    profile_window(
                        f"one all-surface step a call, {name} {W}x{H} "
                        "every field, 1 block, eager, through "
                        "trace_rays_diff (the autograd route before the "
                        "fused one)", one(fns["eager"]), 1, smi,
                        prefix="Q2", top=8, families=True)
                autograd_rows = (rg.launches - rows0[0],
                                 rg.backward_launches - rows0[1])
                release_memory(dev)
                per_ray = peak_g / (W * H)
            same = {f"graph {Q_STEPS} steps": same_bits(g1, e_last),
                    "graph 1 step": same_bits(g2, e_first),
                    "graph 1 step again": same_bits(g3, e_first),
                    "eager 1 step again": same_bits(e2, e_first)}
            losses = [float(x) for x in g1[2]]
            log(f"Q2 {name} {W}x{H} every field, {b} block(s), from one "
                f"state ({smi}): bitwise the eager chain {same}; losses "
                + " ".join(f"{x:.6e}" for x in losses)
                + f"; the graph's first call {ms_g1 * Q_STEPS:.1f} ms, of "
                f"which warm-up and capture {capture:.1f} (warm-up "
                f"{warmup:.1f}); counted launches {counts}; the graph's "
                f"pool (reserved) {gib(pool)}; peak allocated eager "
                f"{gib(peak_e)}, graph {gib(peak_g)}")
            if not all(all(v.values()) for v in same.values()):
                raise AssertionError(f"Q2 {name} {b} blocks: runs differ: "
                                     f"{same}")
            if not all(np.isfinite(losses)):
                raise AssertionError(f"Q2 {name}: losses {losses}")
            want = {k: b for k in ("pack_launches", "diff_launches",
                                   "diff_backward_launches",
                                   "light_sum_launches")}
            if counts != want:
                raise AssertionError(f"Q2 {name} {b} blocks: the graph "
                                     f"recorded {counts}, not {want}")
            abba_summary(f"Q2 ms/step {name} {W}x{H}, {b} block(s) ({smi})",
                         list(zip(O_ABBA, (ms_e1, ms_g2, ms_g3, ms_e2))))
            del fns, e_last, e_first, e2, g1, g2, g3
            release_memory(dev)
    launches = {"forward": rg.launches,
                "backward": rg.backward_launches - autograd_rows[1],
                "autograd_window_row_sums": autograd_rows[1],
                "diff_forward": diff.launches,
                "diff_backward": diff.backward_launches,
                "light_sums": diff.light_sum_launches}
    log(f"Q2 launches over the phase (eager steps and graph replays, "
        f"counted as their capture's; the row gather's forward and "
        f"autograd_window_row_sums only in the autograd route's profiler "
        f"window, backward the fused route's row sums): {launches}")
    if not (launches["diff_forward"] and launches["diff_backward"]
            and launches["light_sums"]) or launches["backward"]:
        raise AssertionError(f"Q2: the fused route's kernels never "
                             f"launched, or the row sums did: {launches}")
    return per_ray, launches


def graph_window(name, fn, smi):
    """Q2's profiler window of one graphed step (``profile_window``, once);
    raises unless it lists Q2_WINDOW_KERNELS."""
    r = profile_window(
        f"one all-surface step a call, {name} {W}x{H} every field, 1 "
        "block, graph", fn, 1, smi, prefix="Q2", top=12)
    names = r["names"] if r else set()
    missing = [k for k in Q2_WINDOW_KERNELS
               if not any(k in x for x in names)]
    if missing:
        raise AssertionError(f"Q2: the graphed window lists no {missing}")


def phase_q4(dev, smi):
    """The all-surface step with Schlick Fresnel (test17) and with T_DEEP's
    stack past 16 slots (test18) at 800x480, on Q_BLOCKS blocks: eager,
    Q_STEPS one-step calls chained, and a graphed call of Q_STEPS steps,
    bitwise; each graph records one pack, tape, backward and light-sum
    launch a block and no row sums; ms/step, pool and peak."""
    from quadray_tpu_torch.parallel import train as tr
    for what, name in (("schlick", "test17"), ("deep", "test18")):
        cfg = t_cfg(what)
        sc, target, _ = train_task(dev, name)
        for b in Q_BLOCKS:
            mesh = None if b == 1 else card_mesh(dev, b)
            fns = {mode: tr.make_train_step(W, H, cfg=cfg, lr=TRAIN_LR,
                                            mesh=mesh,
                                            eager=mode == "eager")[0].run
                   for mode in ("eager", "graph")}
            release_memory(dev)
            e_last, ms_e, _ = timed_run(fns["eager"], sc, target, Q_STEPS,
                                        chained=True)
            release_memory(dev)
            res0 = torch.cuda.memory_reserved(dev)
            g1, ms_g1 = timed_run(fns["graph"], sc, target, Q_STEPS)
            pool = torch.cuda.memory_reserved(dev) - res0
            peak = torch.cuda.max_memory_allocated(dev)
            _, ms_g = timed_run(fns["graph"], sc, target, 1)
            prog = next(iter(fns["graph"].programs.values()))
            counts = prog.replay.counts
            same = same_bits(g1, e_last)
            log(f"Q4 {name} {what} {W}x{H} (stack {cfg.stack}, "
                f"max_segments {cfg.max_segments}, schlick {cfg.schlick}), "
                f"{b} block(s) ({smi}): graphed {Q_STEPS} steps bitwise the "
                f"eager chain {same}; ms/step eager {ms_e:.2f}, graphed "
                f"{ms_g:.2f} (the first call {ms_g1 * Q_STEPS:.1f} ms); "
                f"counted launches {counts}; pool {gib(pool)}, peak "
                f"{gib(peak)}; losses "
                + " ".join(f"{float(x):.6e}" for x in g1[2]))
            want = {k: b for k in ("pack_launches", "diff_launches",
                                   "diff_backward_launches",
                                   "light_sum_launches")}
            if not all(same.values()) or counts != want:
                raise AssertionError(f"Q4 {name} {what} {b} blocks: {same}, "
                                     f"{counts}")
            if not bool(torch.isfinite(g1[2]).all()):
                raise AssertionError(f"Q4 {name} {what}: losses {g1[2]}")
            del fns, prog, e_last, g1
            release_memory(dev)
        del sc, target


def q3_pair(label, make, sc, target, steps: int, smi):
    """``steps`` steps of make(eager) from sc's params, eager then graphed
    (the program's first call: warm-up, capture, replays), bitwise; then
    a one-step graphed call for the graph's ms/step and a profiler window
    of one graphed step (device ops and ms, busy share); the pool and the
    peak memory; the program dropped after."""
    dev = sc.device
    release_memory(dev)
    e, ms_e = timed_run(make(True), sc, target, steps)
    peak_e = torch.cuda.max_memory_allocated(dev)
    release_memory(dev)
    res0 = torch.cuda.memory_reserved(dev)
    graph = make(False)
    if graph.route(sc) != "graph":
        raise AssertionError(f"Q3 {label}: graph route not taken")
    g, ms_g1 = timed_run(graph, sc, target, steps)
    pool = torch.cuda.memory_reserved(dev) - res0
    peak_g = torch.cuda.max_memory_allocated(dev)
    _, ms_g = timed_run(graph, sc, target, 1)
    capture = next(iter(graph.programs.values())).replay.ms
    from quadray_tpu_torch.parallel import train as tr
    state = [tr.extract_params(sc)]
    state.append(tr.adam_init(state[0]))

    def step(i):
        state[:] = graph(*state, sc, target, 1)[:2]

    profile_window(f"one graphed step a call, {label}", step, 1, smi,
                   prefix="Q3", top=6)
    del graph
    release_memory(dev)
    same = same_bits(g, e)
    log(f"Q3 {label}, {steps} steps from one state ({smi}): graphed "
        f"bitwise eager {same}; ms/step eager {ms_e:.2f}, graphed "
        f"{ms_g:.2f} (the first call {ms_g1 * steps:.1f} ms, of which "
        f"warm-up and capture {capture:.1f}); the graph's pool "
        f"{gib(pool)}; peak allocated eager {gib(peak_e)}, graph "
        f"{gib(peak_g)}; losses " + " ".join(f"{float(x):.6e}"
                                            for x in e[2]))
    if not all(same.values()):
        raise AssertionError(f"Q3 {label}: graphed steps off the eager ones")
    if not bool(torch.isfinite(e[2]).all()):
        raise AssertionError(f"Q3 {label}: losses {e[2]}")


def phase_q3(dev, smi, per_ray: float):
    """BASELINE.json config 5's frame (1920x1080, every field): the
    all-surface step on test17 over the fewest of 1, 2, 4, ... blocks of
    cuda:0 whose peak memory, at Q2's peak a ray (``per_ray`` bytes),
    fits in Q3_MEMORY of the card (doubled while the eager step does not
    fit), then make_train_scan_fast on demo03 (152 surfaces) at K=8 on
    one block: Q3_STEPS steps each, graphed bitwise eager."""
    from quadray_tpu_torch.parallel import train as tr
    total = torch.cuda.get_device_properties(dev).total_memory
    rays = Q3_W * Q3_H
    blocks = 1
    while per_ray * rays / blocks > Q3_MEMORY * total:
        blocks *= 2
    log(f"Q3: Q2's peak {per_ray / 1e3:.1f} kB a ray predicts "
        f"{gib(per_ray * rays / blocks)} on {blocks} block(s) of a "
        f"{gib(total)} card")
    sc, target, _ = train_task(dev, "test17", Q3_W, Q3_H)
    while True:
        make = lambda eager: tr.make_train_step(
            Q3_W, Q3_H, cfg=train_cfg(), lr=TRAIN_LR,
            mesh=card_mesh(dev, blocks), eager=eager)[0].run
        try:
            q3_pair(f"make_train_step test17 {Q3_W}x{Q3_H} every field, "
                    f"{blocks} block(s)", make, sc, target, Q3_STEPS, smi)
            break
        except torch.cuda.OutOfMemoryError:
            if blocks >= 64:
                raise
        # (the next q3_pair releases what the failed step left)
        log(f"Q3 test17: the eager step on {blocks} block(s) does not fit; "
            "doubling them")
        blocks *= 2
    del sc, target
    sc, target, _ = train_task(dev, "demo03", Q3_W, Q3_H)
    q3_pair(f"make_train_scan_fast demo03 {Q3_W}x{Q3_H} K={K_PATHS} every "
            "field, 1 block",
            lambda eager: tr.make_train_scan_fast(
                sc, Q3_W, Q3_H, cfg=train_cfg(), lr=TRAIN_LR,
                k_paths=K_PATHS, eager=eager)[0], sc, target, Q3_STEPS, smi)
    del sc, target
    release_memory(dev)


def phase_m1(dev):
    """The bench's cells in this process, each driven with its launch
    count set to 0 just before and read just after."""
    from quadray_tpu_torch import bench
    from quadray_tpu_torch.ops import cuda_kernel as ck
    cfg = bench.BENCH_CFG
    sc = bench.compiled("test01", dev)
    want = ck.render_cuda(sc, W, H, 1, cfg).reshape(-1, 3)
    n = W * H
    for k in (bench.K_SMALL, bench.K_BIG):
        batch = bench.frame_batch(sc, k)
        ck.launches = 0
        cols = bench.trace_batch(sc, batch, cfg)
        torch.cuda.synchronize()
        launches = ck.launches
        cols = torch.clamp(cols, 0.0, 1.0)
        same = [torch.equal(cols[f * n:(f + 1) * n], want)
                for f in (0, k - 1)]
        log(f"M1 test01 K={k}: {k * n} rays, launches={launches}, frames "
            f"0 and {k - 1} bitwise render_cuda's: {same}")
        if launches != 1 or not all(same):
            raise AssertionError(f"M1 K={k}: launches {launches}, frames "
                                 f"equal {same}")
        del batch, cols
    torch.cuda.empty_cache()
    counted = (
        ("bench_scene test01", "launches",
         lambda: bench.bench_scene("test01", cfg, dev),
         2 * (1 + bench.REPS) + 1 + bench.MAIN_PATH_CALLS),
        ("bench_pt", "pt_launches", lambda: bench.bench_pt(dev),
         sum(bench.PT_SPP) * (1 + bench.PT_REPS)),
        ("bench_train", "paths_launches", lambda: bench.bench_train(dev),
         sum(bench.TRAIN_STEPS) * (1 + bench.TRAIN_REPS)))
    for cell, counter, fn, expected in counted:
        setattr(ck, counter, 0)
        entry = fn()
        torch.cuda.synchronize()
        launches = getattr(ck, counter)
        log(f"M1 {cell}: {entry} {counter}={launches} (expected "
            f"{expected})")
        if launches != expected:
            raise AssertionError(f"M1 {cell}: {launches} {counter}, "
                                 f"expected {expected}")
        torch.cuda.empty_cache()


def phase_m2(dev, smi):
    """python -m quadray_tpu_torch.bench in full, its line checked."""
    from quadray_tpu_torch import bench
    r = subprocess.run(
        [sys.executable, "-m", "quadray_tpu_torch.bench", "--device",
         f"cuda:{dev.index}"], cwd=REPO, capture_output=True, text=True,
        timeout=M2_TIMEOUT, env=dict(os.environ, PYTHONPATH=REPO))
    for line in r.stderr.splitlines():
        if any(k in line for k in ("marginal", "ms/spp-pass", "ms/step",
                                   "golden guard", "failed", "Error")):
            log(f"M2 {line}")
    if r.returncode != 0:
        raise AssertionError(f"M2: the bench exited {r.returncode}:\n"
                             f"{r.stderr[-4000:]}\n{r.stdout[-2000:]}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    log("M2 " + json.dumps(line))
    extra = line["extra"]
    bad = []
    if line["metric"] != bench.METRIC or not line["value"] > 0 \
            or not line["vs_baseline"] > 0 or "error" in line:
        bad.append("headline")
    for name in ("test01",) + bench.SCENES:
        e = extra.get(name, {})
        if "error" in e or not e.get("bad_px", 1 << 30) <= \
                bench.BUDGET.get(name, 0) or not all(
                    e.get(k, 0) > 0 for k in (
                        "rays_per_s", "ms_per_frame", "vs_baseline",
                        "ms_per_frame_median", "ms_per_frame_min",
                        "ms_per_frame_max", "main_path_ms_per_frame")):
            bad.append(name)
    for cell, keys in (("pt_test18", ("ms_per_spp_pass", "paths_per_s")),
                       ("train_test01", ("ms_per_step",
                                         "fwd_bwd_rays_per_s"))):
        if not all(extra.get(cell, {}).get(k, 0) > 0 for k in keys):
            bad.append(cell)
    info = extra.get("device", {})
    if info.get("name") != torch.cuda.get_device_name(dev) or \
            info.get("power_limit") != smi.split(",")[-1].strip():
        bad.append("device")
    if bad:
        raise AssertionError(f"M2: entries wrong or missing: {bad}")
    return line


def phase_m3(line, rows):
    """Each scene's marginal beside phase B's render_cuda ms/frame and the
    main path's; printed, not held."""
    from quadray_tpu_torch import bench
    for name in ("test01",) + bench.SCENES:
        e = line["extra"][name]
        b = "not run" if rows is None else f"{rows[name][0]:.4f}"
        log(f"M3 {name}: marginal {e['ms_per_frame']} (median "
            f"{e['ms_per_frame_median']}, {e['ms_per_frame_min']}-"
            f"{e['ms_per_frame_max']}) ms/frame, phase B render_cuda {b}, "
            f"main path {e['main_path_ms_per_frame']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only",
                    choices=["A", "D", "E", "F", "G", "H", "I", "J", "K",
                             "L", "M", "N", "O", "P", "Q", "R", "S", "T",
                             "U", "W"],
                    default=None,
                    help="run only phase A (build + kernel vs plain), D "
                    "(training path), E (path tracer), F (two-round "
                    "retirement), G (conformance tier), H (culling), I "
                    "(RESUME's two modes and its switch's sweep), J (the "
                    "apps and the interactive frame), K (the culling "
                    "tables' kernels), L (the parallel layer), M (the "
                    "port's bench), N (the main path's Whitted kernel), O (one "
                    "CUDA graph a frame and a pass), P (one CUDA graph a "
                    "training step), Q (the all-surface training step as "
                    "one CUDA graph, at 800x480 and 1920x1080), R (the "
                    "fused replay), S (the all-surface step's row gather "
                    "at its shapes), T (the fused all-surface route's "
                    "kernels), U (the scene "
                    "update as one launch, the interactive frame as one "
                    "CUDA graph) or W (the Whitted kernels with Schlick "
                    "Fresnel and stacks past 16 slots)")
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
    _build.load_libraries("whitted", "conformance", "pack", "replay",
                          "update", "diff")
    log(f"kernel build (parallel nvcc) and load: "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = os.path.join(_build.BUILD_DIR, "whitted.ptxas.txt")
    if os.path.exists(ptxas):
        with open(ptxas) as fh:
            for line in fh:
                if any(k in line for k in ("entry function", "registers",
                                           "stack frame")):
                    log(f"ptxas: {line.strip()}")
    if os.path.exists(ptxas):
        with open(ptxas) as fh:
            text = fh.read()
        for chunk in text.split("Compiling entry function")[1:]:
            m = re.search(r"paths_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E",
                          chunk)
            if m:
                log(f"ptxas paths_kernel<CULL={m.group(1)}, SM={m.group(2)}"
                    f", OWN={m.group(3)}, SCHLICK={m.group(4)}> (path "
                    "records): " + "; ".join(
                        re.findall(
                            r"\d+ bytes stack frame, \d+ bytes spill "
                            r"stores, \d+ bytes spill loads|Used \d+ "
                            r"registers[^\n]*", chunk)))
        from quadray_tpu_torch.ops.cuda_kernel import PATHS_SMEM_BYTES
        log(f"paths_kernel dynamic shared memory budget: {PATHS_SMEM_BYTES} "
            "B a block (the tables of a scene that fits; D1 prints each "
            "scene's)")
        for chunk in text.split("Compiling entry function")[1:]:
            m = re.search(r"whole_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)ELb"
                          r"(\d)E", chunk)
            if m:
                log(f"ptxas whole_kernel<CAN_PUSH={m.group(1)}, CULL="
                    f"{m.group(2)}, OWN={m.group(3)}, DEEP={m.group(4)}, "
                    f"SCHLICK={m.group(5)}> (the main path): "
                    + "; ".join(re.findall(
                        r"\d+ bytes stack frame, \d+ bytes spill stores, "
                        r"\d+ bytes spill loads|Used \d+ registers[^\n]*",
                        chunk)))
    ptxas = os.path.join(_build.BUILD_DIR, "conformance.ptxas.txt")
    if os.path.exists(ptxas):
        with open(ptxas) as fh:
            text = fh.read()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        stack = sorted(set(re.findall(r"(\d+) bytes stack frame", text)))
        spill = sorted(set(re.findall(r"(\d+) bytes spill stores", text)))
        log(f"ptxas conformance: {len(regs)} kernels, {min(regs)}-"
            f"{max(regs)} registers, stack frames {stack}, spill stores "
            f"{spill}")
    ptxas = os.path.join(_build.BUILD_DIR, "pack.ptxas.txt")
    if os.path.exists(ptxas):
        with open(ptxas) as fh:
            for line in fh:
                if any(k in line for k in ("registers", "spill")):
                    log(f"ptxas pack: {line.strip()}")
    ptxas = os.path.join(_build.BUILD_DIR, "update.ptxas.txt")
    if os.path.exists(ptxas):
        with open(ptxas) as fh:
            for line in fh:
                if any(k in line for k in ("registers", "spill")):
                    log(f"ptxas update: {line.strip()}")
    ptxas = os.path.join(_build.BUILD_DIR, "replay.ptxas.txt")
    if os.path.exists(ptxas):
        with open(ptxas) as fh:
            for line in fh:
                if any(k in line for k in ("Compiling entry", "registers",
                                           "spill")):
                    log(f"ptxas replay: {line.strip()}")
    ptxas = os.path.join(_build.BUILD_DIR, "diff.ptxas.txt")
    if os.path.exists(ptxas):
        with open(ptxas) as fh:
            for line in fh:
                if any(k in line for k in ("Compiling entry", "registers",
                                           "spill")):
                    log(f"ptxas diff: {line.strip()}")
    ptxas = os.path.join(_build.BUILD_DIR, "whitted.ptxas.txt")
    if os.path.exists(ptxas):
        with open(ptxas) as fh:
            text = fh.read()
        for chunk in text.split("Compiling entry function")[1:]:
            m = re.search(r"tape_kernelILi(\d+)E", chunk.split("\n")[0])
            if m:
                log(f"ptxas tape_kernel<{m.group(1)}> (the all-surface "
                    "forward; 0: the stack in device memory): "
                    + "; ".join(re.findall(
                        r"\d+ bytes stack frame, \d+ bytes spill stores, "
                        r"\d+ bytes spill loads|Used \d+ registers[^\n]*",
                        chunk)))
    dev = torch.device("cuda", 0)
    only = args.only

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"phase {name} ok ({time.perf_counter() - t0:.1f} s)")
        return out

    if only in (None, "A"):
        max_err = phase("A", phase_a, dev, PHASE_A[:2] if only else PHASE_A)
        if only:
            return
        scenes, launches = phase("B", phase_b, dev)
        rows = phase_b_timing(scenes)
        del scenes
        w_bound = whitted_bound(dev, "test13")
        phase("C", phase_c, dev)

    if only in (None, "N"):
        t0 = time.perf_counter()
        n_err = phase_n1(dev)
        n3 = phase_n3(dev)
        log(f"phase N ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "W"):
        w_rows = phase("W", phase_w, dev, smi)

    if only in (None, "D"):
        t0 = time.perf_counter()
        d_err = phase_d1(dev)
        phase_d2(dev)
        d_launches, d_ms, d_plain, d_bound, d_gathers, d_packs = \
            phase_d3(dev)
        d4 = phase_d4(dev)
        d5_err, d5 = phase_d5(dev, smi)
        log(f"phase D ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "R"):
        t0 = time.perf_counter()
        r1 = phase_r1(dev, smi)
        phase_r2(dev)
        log(f"phase R ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "E"):
        t0 = time.perf_counter()
        e_err = phase_e1(dev)
        scene, e_launches = phase_e2(dev)
        phase_e3(dev, scene)
        del scene
        torch.cuda.empty_cache()
        e_ms, e_plain, e_bound, e_by = phase_e4(dev)
        e_heavy = phase_e4_heavy(dev)
        phase_e5(dev)
        phase_e6(dev)
        log(f"phase E ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "F"):
        t0 = time.perf_counter()
        f_err = phase_f1(dev)
        f_launches = phase_f2(dev)
        f3 = phase_f3(dev)
        log(f"phase F ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "G"):
        t0 = time.perf_counter()
        g_launches, g_err = phase_g1(dev)
        phase_g2(dev)
        g3 = phase_g3(dev)
        log(f"phase G ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "H"):
        t0 = time.perf_counter()
        with cull_every_scene() as floor:
            phase_h1(dev)
            phase_a(dev, PHASE_A, "H2")
            phase_f1(dev, "H2")
            h3 = phase_h3(dev, floor)
            phase_h4(dev)
        # the default floor culls a scene where the forced run said it pays
        slower = [n for n, (_, t, c) in h3.items()
                  if c and np.mean(t["on"]) > np.mean(t["off"])]
        log(f"H3: scenes the default gate culls where culling was slower: "
            f"{slower or 'none'}")
        log(f"phase H ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "I"):
        t0 = time.perf_counter()
        cases = single_branch_cases(dev)
        phase_i1(dev, cases)
        phase_i2(dev, cases)
        del cases
        torch.cuda.empty_cache()
        log(f"phase I ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "J"):
        t0 = time.perf_counter()
        j1 = phase_j1()
        j2 = phase_j2(dev)
        j3_launches, j3_cull, j3_pack, j3 = phase_j3(dev, smi)
        j3_upd = sum(r["update_launches"] for runs in j3.values()
                     for r in runs)
        phase_j4(dev)
        phase_j5(dev)
        j6_launches, j6_cull, j6_pack, j6_upd = phase_j6(dev)
        j_whitted = j1 + j2["whitted"] + j3_launches + j6_launches
        log(f"J launches: whitted {j_whitted} (J1 {j1}, J2 {j2['whitted']}, "
            f"J3 {j3_launches}, J6 {j6_launches}), pt {j2['pt']} (J2), "
            f"pack {j3_pack + j6_pack} (J3 {j3_pack}, J6 {j6_pack}), of "
            f"which wrote culling tables {j3_cull + j6_cull} (J3 {j3_cull}, "
            f"J6 {j6_cull}), update {j3_upd + j6_upd} (J3 {j3_upd}, J6 "
            f"{j6_upd})")
        log(f"phase J ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "U"):
        t0 = time.perf_counter()
        u_err, u_launches = phase_u1(dev)
        if only:
            phase_j6(dev, "U2")
        else:
            log("U2: J6 above (Scene.render is the interactive program)")
        u4 = phase_u4(dev, smi)
        log(f"phase U ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "K"):
        k_err, k_rows = phase("K", phase_k, dev)

    if only in (None, "L"):
        t0 = time.perf_counter()
        l_whitted, l_arrays = phase_l1(dev)
        l_paths, l_gathers = phase_l2(dev, smi)
        phase_l3(dev)
        phase_l4(dev, l_arrays, smi)
        del l_arrays
        log(f"phase L ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "M"):
        t0 = time.perf_counter()
        phase_m1(dev)
        torch.cuda.empty_cache()
        m2 = phase_m2(dev, smi)
        phase_m3(m2, rows if only is None else None)
        log(f"phase M ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "O"):
        t0 = time.perf_counter()
        phase_o1(dev)
        phase_o2(dev)
        phase_o3(dev)
        torch.cuda.empty_cache()
        phase_o4(dev, smi)
        phase_o5(dev, smi)
        log(f"phase O ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "P"):
        t0 = time.perf_counter()
        fns, task = phase_p1(dev, smi)
        phase_p2(dev, smi, fns, task)
        del fns, task
        torch.cuda.empty_cache()
        log(f"phase P ok ({time.perf_counter() - t0:.1f} s)")

    if only in (None, "S"):
        release_memory(dev)
        s_rows = phase("S", phase_s, dev, smi)

    if only in (None, "T"):
        release_memory(dev)
        t_rows, t_demo03 = phase("T", phase_t, dev, smi)

    if only in (None, "Q"):
        t0 = time.perf_counter()
        release_memory(dev)
        log(f"Q: on the card before the phase: allocated "
            f"{gib(torch.cuda.memory_allocated(dev))}, reserved "
            f"{gib(torch.cuda.memory_reserved(dev))}")
        phase_q1(dev)
        per_ray, q_launches = phase_q2(dev, smi)
        phase_q4(dev, smi)
        phase_q3(dev, smi, per_ray)
        log(f"phase Q ok ({time.perf_counter() - t0:.1f} s)")
    if only:
        return

    from quadray_tpu_torch.ops.cuda_kernel import ROUNDS_K1 as k1
    t_err = max([r["max_abs_err"] for r in t_rows.values()]
                + [c["max_abs_err"] for r in t_rows.values()
                   for c in r.get("cases", {}).values()]
                + [t_demo03["max_abs_err"]])
    ms, plain = rows["test13"]
    times, _, bounds = f3["test13"]
    lib_cases = [n for n in g3 if n in LIBRARY]
    g_sum = [sum(g3[n][i] for n in lib_cases) for i in range(3)]
    g_bound = sum(g3[n][3][0] for n in lib_cases)
    log("kernel table: whitted ms/plain_ms are test13 800x480 frames "
        "(render_cuda vs plain render), launches B's 21 frames plus phase "
        "J's (core_test's 18 frames and -k, render_cli's Whitted frames, "
        "J3's interactive frames, J6's checked frames) and L1's (the "
        "sharded frames, one launch a block); whitted_paths "
        "ms/plain_ms are test01 800x480 K=8 path-record traces (the "
        "training step's), launches the 10-step training run's (D3) and "
        "the 10-step sharded run's on 4 blocks (L2), "
        "max_abs_err the worst "
        "color error of D1 (its records equal the plain version's); "
        "whitted_pt ms/plain_ms are one test18 800x480 depth-10 pass "
        "(trace_pt_cuda vs plain trace_pt), launches E2's 64 passes "
        "plus J2's PT frames, "
        "max_abs_err the worst radiance error of E1 (its seeds equal the "
        "plain version's); whitted_emit and whitted_resume ms/plain_ms "
        "are test13 800x480 at k1=4 (trace_rays_emit_cuda / "
        "trace_rays_resume_cuda vs the plain versions), launches F2's "
        "counted run, max_abs_err the worst of F1; bound_ms for the same "
        "inputs; no single PyTorch call traces rays, so library_ms is "
        "null for those five; conformance ms/plain_ms/bound_ms/library_ms "
        "are sums over the " + str(len(lib_cases)) + " cases that have one "
        "PyTorch call (" + ",".join(lib_cases) + ") at 384,000 elements, "
        "launches G1's 15 cases, max_abs_err G1's worst against the plain "
        "versions; every row ran culled where the default TraceConfig's "
        "gates cull (test18 does not: 8 surfaces, under PT's floor); "
        "whitted_pt's heavy entry is one test13 800x480 depth-10 pass, "
        "culled (ms) and unculled (unculled_ms), kernel alone, with its "
        "bound and the plain version's share of nearest tests culled; "
        "pack ms/plain_ms/bound_ms are a whole pack (the ten tables) of "
        "demo02 at a J3 frame in one launch against the plain parts (K2, "
        "CUDA graphs; its moved_parts and culling_tables entries the "
        "launches of J3's moved parts and of the three culling tables "
        "alone), launches the main path's in J3 and J6 (the frames whose "
        "spheres or lights moved, and each J6 scene's first) and D3's (one "
        "a step, graph replays counted as their capture's), max_abs_err "
        "K1's over the float tables (every table bitwise); no PyTorch call "
        "packs the scene, so library_ms is null; replay_forward and "
        "replay_backward "
        "ms/plain_ms/bound_ms are the fused replay on test01's 800x480 "
        "K=8 records (R1, CUDA graphs; backward without its row sums), "
        "launches D3's and L2's counted runs, max_abs_err R1's largest "
        "absolute difference from the plain version (colors and state; "
        "the tables' gradients); no single PyTorch call "
        "computes replay, so library_ms is null; replay_gather "
        "ms/plain_ms/bound_ms/library_ms are the row sums of the same "
        "step (R1: one call over all K x N entries; the library two "
        "index_add_), launches the row sums' in D3's and L2's counted "
        "runs and Q2's (forward_launches the gather forward's: 0 on the "
        "trace-replay steps, one a bounce a block in make_train_step's), "
        "max_abs_err D5's and S's (every word bitwise), d5_per_segment "
        "D5's per-segment gather and backward, all_surface the all-surface "
        "step's gathers: S's ms/plain_ms/bound_ms a step of 8 bounces at "
        "800x480 on Q's scenes (forward and row sums, CUDA graphs), "
        "library_ms index_select + index_put_ with accumulate (the lookups' "
        "backward before the gather), Q2's launches; update ms/plain_ms/bound_ms are "
        "one launch of demo02's three groups at frame 10 of J3's trace "
        "(U4, CUDA graphs) against the plain version's host ms "
        "(moved_fields, numpy; scenes: each J3 scene's), launches the main "
        "path's in J3 and J6 (one a frame, replays counted as their "
        "capture's, with each Scene's structure pass and warm-up), "
        "checked_launches U1's, max_abs_err U1's (every field bitwise); no "
        "PyTorch call computes the update, so library_ms is null; "
        "diff_forward ms/plain_ms/bound_ms are the fused all-surface "
        "route's forward on test17 800x480 K=8 (T: the pack and the tape "
        "launch, CUDA graphs, against forward_plain), diff_backward the "
        "backward launch and its light sums, which carry the table rows' "
        "sums (against backward_rows_plain's tiles and "
        "replay._block_sums; the forced wide mode's row sums are "
        "replay_gather's), launches Q2's counted run, max_abs_err T's "
        "largest absolute difference from the plain versions on "
        "T_SCENES, T_EXTRA and T_SMEM_SCENE (every word bitwise), scenes "
        "T's rows (the Schlick and deep-stack cases under cases); no "
        "single PyTorch "
        "call traces rays or differentiates them, so library_ms is null")
    culled = ("on: warp reach masks (origin box + direction cone or "
              "endpoint capsule per warp, __ballot_sync over the bounding "
              "spheres), lsort and cont masks where cull_gates say so")
    from quadray_tpu_torch.ops.cuda_kernel import (COOP_MAX_LIVE,
                                                   EMIT_OWN_MIN_KEPT,
                                                   PATHS_SMEM_BYTES,
                                                   RESUME_WARP_MAX,
                                                   WHOLE_OWN_MAX_RAYS)
    coop = (f"cooperative tail: a culled warp with at most {COOP_MAX_LIVE} "
            "rays left (COOP_MAX_LIVE) runs them one at a time on all 32 "
            "lanes, the kept surfaces and blockers dealt out by rank and "
            "the nearest hit reduced by an xor butterfly on (t, original "
            "id); bitwise the per-lane walk (H4)")
    whitted_design = (
        "whole_kernel, one thread a ray, ceil(n / 128) blocks of 128 "
        "threads, the scene tables in device memory; unculled, five "
        "blocks an SM (96 registers); culled, four blocks an SM (128 "
        "registers), per-ray masks after the camera segment where the "
        f"warp's keeps more than {EMIT_OWN_MIN_KEPT} surfaces "
        f"(EMIT_OWN_MIN_KEPT) in a launch of at most {WHOLE_OWN_MAX_RAYS} "
        "rays (WHOLE_OWN_MAX_RAYS); " + coop)
    conf_design = ("four consecutive elements a thread, one 16-byte load "
                   "(float4; int4 for the gather's indices) per input and "
                   "one 16-byte store, blocks of 256 threads; one element "
                   "at a time for a ragged tail or an unaligned pointer, "
                   "and one element a thread for the roots, Fresnel and "
                   "root/sdiv blocks (mostly arithmetic)")
    own = ("per-ray masks: the warp's mask refined by each lane's own "
           "sphere tests (half-line for a nearest pass, segment for a "
           "shadow pass) and its own cont or lsort row, each lane walking "
           "its own bits")
    emit_design = ("culled: the warp's masks for the camera segment; after "
                   f"it, where the warp's mask keeps more than "
                   f"{EMIT_OWN_MIN_KEPT} (EMIT_OWN_MIN_KEPT) surfaces, "
                   + own)
    resume_design = (f"two modes, both launched, chosen on the device by "
                     f"the survivor count: up to {RESUME_WARP_MAX} "
                     "(RESUME_WARP_MAX) a warp per survivor (resume_sparse: "
                     "one-ray masks, kept surfaces dealt out by rank, "
                     "butterfly on (t, original id)); more, a thread each "
                     "with " + own)
    pt_culled = ("on from PT_CULL_MIN_SURFACES surfaces: per-ray reach "
                 "masks (each lane tests its own ray against the bounding "
                 "spheres of a word and walks its own bits), reach only")
    paths_design = (
        "paths_kernel, a persistent grid of 256-thread blocks, each warp "
        "taking the next 32 rays from a work queue; each block copies the "
        "scene tables into its shared memory (one cp.async.bulk a table "
        f"on an mbarrier) where they fit in {PATHS_SMEM_BYTES} B "
        "(PATHS_SMEM_BYTES), else the instantiation that reads device "
        "memory; culled, per-ray masks after the camera segment where the "
        f"warp's keeps more than {EMIT_OWN_MIN_KEPT} surfaces")
    heavy = e_heavy["test13"]
    r = r1["test01"]
    replay_fwd_design = (
        "a thread a ray runs its K segments in replay_color's f32 "
        "operations and order (blocks of 128), saving each segment's "
        "entry state and row ids; the scene tables read through L1 "
        "(staging them in each block's shared memory measured as fast or "
        "slower, PERF.md)")
    replay_bwd_design = (
        "a thread a ray runs the segments in reverse, each recomputed from "
        "its saved state with the hand-written adjoint; a warp with no live "
        "ray skips a segment; 29 row gradients a ray a segment to device "
        "memory (summed by replay_gather's row sums); the lights' and "
        "ambient's gradients an xor butterfly a segment into the warp's "
        "accumulators, warps in order, then blocks in order (no atomics)")
    log(json.dumps({"kernels": [{
        "name": "whitted", "route": "cuda", "culling": culled,
        "design": whitted_design,
        "source": "quadray_tpu_torch/csrc/whitted.cu",
        "replaces": "quadray_tpu/ops/pallas_kernel.py:2201",
        "launches": launches + j_whitted + l_whitted,
        "design_deep_stack": "past 16 slots (min(stack, max_segments)) "
                             "on a scene that can push, the ray's slots "
                             "in a device-memory scratch (n, d, 15) from "
                             "the caching allocator; the cooperative tail "
                             "works on its owner's slots there",
        "max_abs_err": max(max_err, n_err),
        "frame_alone_vs_share_of_64": {
            n: {"alone_ms": a, "share_ms": b} for n, (a, b) in n3.items()},
        "ms": ms, "plain_ms": plain, "bound_ms": w_bound[0],
        "bound_by": w_bound[1], "library_ms": None,
        "schlick_and_deep_stack": w_rows}, {
        "name": "whitted_paths", "route": "cuda", "culling": culled,
        "design": paths_design,
        "source": "quadray_tpu_torch/csrc/whitted.cu",
        "replaces": "quadray_tpu/ops/pallas_kernel.py:2250",
        "launches": d_launches + l_paths, "max_abs_err": d_err,
        "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound[0],
        "bound_by": d_bound[1], "library_ms": None,
        "walks": {name: {walk: {"ms": v[0], "bound_ms": v[1][0],
                                "bound_by": v[1][1]}
                         for walk, v in walks.items()}
                  for name, walks in d4.items()}}, {
        "name": "whitted_pt", "route": "cuda", "culling": pt_culled,
        "source": "quadray_tpu_torch/csrc/whitted.cu",
        "replaces": "quadray_tpu/ops/pallas_kernel.py:2313",
        "launches": e_launches + j2["pt"], "max_abs_err": e_err,
        "ms": e_ms, "plain_ms": e_plain, "bound_ms": e_bound,
        "bound_by": e_by, "library_ms": None,
        "heavy": {"scene": "test13", "ms": heavy[0],
                  "unculled_ms": heavy[1], "bound_ms": heavy[2],
                  "bound_by": heavy[3], "share_culled": heavy[4]}}, {
        "name": "whitted_emit", "route": "cuda", "culling": culled,
        "design": emit_design,
        "source": "quadray_tpu_torch/csrc/whitted.cu",
        "replaces": "quadray_tpu/ops/pallas_kernel.py:2525",
        "launches": f_launches["emit_launches"], "max_abs_err": f_err,
        "ms": float(np.mean(times[f"k1={k1} emit"])),
        "plain_ms": f3["plain"][0], "bound_ms": bounds[k1][0][0],
        "bound_by": bounds[k1][0][1], "library_ms": None}, {
        "name": "whitted_resume", "route": "cuda", "culling": culled,
        "design": resume_design,
        "source": "quadray_tpu_torch/csrc/whitted.cu",
        "replaces": "quadray_tpu/ops/pallas_kernel.py:2572",
        "launches": f_launches["resume_launches"], "max_abs_err": f_err,
        "ms": float(np.mean(times[f"k1={k1} resume"])),
        "plain_ms": f3["plain"][1], "bound_ms": bounds[k1][1][0],
        "bound_by": bounds[k1][1][1], "library_ms": None}, {
        "name": "conformance", "route": "cuda", "design": conf_design,
        "source": "quadray_tpu_torch/csrc/conformance.cu",
        "replaces": "tests/test_conformance.py:18",
        "launches": g_launches, "max_abs_err": g_err,
        "ms": g_sum[0], "plain_ms": g_sum[1], "bound_ms": g_bound,
        "bound_by": "bytes", "library_ms": g_sum[2]}, {
        "name": "pack", "route": "cuda",
        "design": "one launch for any subset of the ten tables, each part "
                  "a contiguous range of 128-thread blocks: a thread an "
                  "element of the copies, a column of bsph_t, an output "
                  "word of 32 surfaces of shad_msk and cont_msk, whose "
                  "blocks first stage the permuted rows' spheres in "
                  "shared memory (1,024 rows a tile)",
        "source": "quadray_tpu_torch/csrc/pack.cu",
        "replaces": "quadray_tpu/ops/pallas_kernel.py:300",
        "note": "the JAX pack_scene under _pack_jit (pallas_kernel.py:"
                "300-435, :2143), one XLA executable, not a Pallas kernel",
        "launches": j3_pack + j6_pack + d_packs,
        "culling_launches": j3_cull + j6_cull, "max_abs_err": k_err,
        "ms": k_rows["whole pack"]["ms"],
        "plain_ms": k_rows["whole pack"]["plain_ms"],
        "bound_ms": k_rows["whole pack"]["bound_ms"],
        "bound_by": k_rows["whole pack"]["bound_by"], "library_ms": None,
        "host_ms": k_rows["whole pack"]["host_ms"],
        "moved_parts": k_rows["J3's moved parts"],
        "culling_tables": k_rows["culling tables"]}, {
        "name": "replay_forward", "route": "cuda",
        "design": replay_fwd_design,
        "source": "quadray_tpu_torch/csrc/replay.cu",
        "replaces": "quadray_tpu/ops/replay.py:58",
        "note": "the JAX replay_color (jnp, differentiated by "
                "jax.value_and_grad), not a Pallas kernel",
        "launches": d_gathers[2] + l_gathers[2],
        "max_abs_err": r["err"][0],
        "ms": r["ms"]["forward"], "plain_ms": r["ms"]["plain_forward"],
        "bound_ms": r["bounds"]["forward"][0],
        "bound_by": r["bounds"]["forward"][1], "library_ms": None}, {
        "name": "replay_backward", "route": "cuda",
        "design": replay_bwd_design,
        "source": "quadray_tpu_torch/csrc/replay.cu",
        "replaces": "quadray_tpu/ops/replay.py:58",
        "note": "the gradient of the JAX replay_color, which "
                "jax.value_and_grad derives",
        "launches": d_gathers[3] + l_gathers[3],
        "max_abs_err": r["err"][1],
        "ms": r["ms"]["backward"],
        "plain_ms": r["ms"]["plain_backward"],
        "bound_ms": r["bounds"]["backward"][0],
        "bound_by": r["bounds"]["backward"][1], "library_ms": None}, {
        "name": "replay_gather", "route": "cuda",
        "design": "the row sums: a block a (1024 entries, 64-row band), a "
                  "warp's 8 tiles each an xor butterfly per distinct row, "
                  "warp accumulators in shared memory added in warp order, "
                  "then the blocks' partials in block order; one call over "
                  "all K x N entries of the fused backward. Its forward "
                  "gather (a thread a ray, one launch a segment) runs only "
                  "in replay_color, the reference",
        "source": "quadray_tpu_torch/csrc/replay.cu",
        "replaces": "quadray_tpu/ops/replay.py:107-135",
        "note": "the JAX replay's one-hot row lookups (jnp contractions "
                "in replay_color), not a Pallas kernel",
        "launches": d_gathers[1] + l_gathers[1] + q_launches["backward"],
        "launches_by_path": {"replay (D3, L2)": d_gathers[1] + l_gathers[1],
                             "all_surface (Q2)": q_launches["backward"],
                             "all_surface forced wide (T, checks)": sum(
                                 r.get("wide_row_sum_launches", 0)
                                 for r in t_rows.values())},
        "forward_launches": d_gathers[0] + l_gathers[0]
        + q_launches["forward"],
        "max_abs_err": max(d5_err, max(r["max_abs_err"]
                                       for r in s_rows.values())),
        "ms": r["ms"]["row_sums"], "plain_ms": r["ms"]["plain_row_sums"],
        "bound_ms": r["bounds"]["row_sums"][0],
        "bound_by": r["bounds"]["row_sums"][1],
        "library_ms": r["ms"]["library_row_sums"],
        "d5_per_segment": {"forward_ms": d5["test01"][0],
                           "backward_ms": d5["test01"][1]},
        "all_surface": {"route": "trace_rays_diff, the reference of "
                                 "make_train_step's fused route (ops/"
                                 "trace.py Gathered, one gather a bounce)",
                        "replaces": "quadray_tpu/ops/trace.py:388, "
                                    "405-461, 514-569, 642 under "
                                    "jax.value_and_grad",
                        "launches": q_launches, "scenes": s_rows}}, {
        "name": "update", "route": "cuda",
        "design": "one block of 256 threads: the world matrices of the "
                  "nodes that can move composed level by level from the "
                  "root into scratch rows (a thread a node, a barrier "
                  "between levels; each product the plain version's "
                  "float64 multiply-add chain rounded to f32), then a "
                  "thread a surface row, light row or the camera; sin and "
                  "cos of the angles staged from the host; in the "
                  "interactive frame's CUDA graph after the copy of those "
                  "values from pinned memory, before the pack",
        "source": "quadray_tpu_torch/csrc/update.cu",
        "replaces": "quadray_tpu/engine.py:195",
        "note": "the JAX engine's _update_jit over _compile_scene_impl "
                "(quadray_tpu/scene/compile.py:635), one XLA executable, "
                "not a Pallas kernel",
        "launches": j3_upd + j6_upd, "checked_launches": u_launches,
        "max_abs_err": u_err,
        "ms": u4["demo02"]["ms"], "plain_ms": u4["demo02"]["plain_ms"],
        "bound_ms": u4["demo02"]["bound_ms"],
        "bound_by": u4["demo02"]["bound_by"], "library_ms": None,
        "host_ms": u4["demo02"]["host_ms"],
        "scenes": {n: {k: v for k, v in r.items() if k != "groups"}
                   for n, r in u4.items()}}, {
        "name": "diff_forward", "route": "cuda",
        "design": "tape_kernel<CAP>: the Whitted walk of whole_kernel "
                  "(segment<> with TAPE; exact or Schlick Fresnel), "
                  "unculled, one thread a ray on ceil(n / 128) blocks, the "
                  "branch stack's min(stack, K) slots in local memory (4, "
                  "8 or 16) or past 16 in a device-memory scratch; each "
                  "bounce writes the tape's contract in (K, F, N) layout, "
                  "coalesced, each word once: its flags word, and where it "
                  "hits its entry state (12 floats, kept in registers "
                  "until the hit is known), texel and light bits (2 + "
                  "ceil(NL / 32) words, built in a register); after the "
                  "pack of the step's tables (one csrc/pack.cu launch)",
        "source": "quadray_tpu_torch/csrc/whitted.cu",
        "replaces": "quadray_tpu/ops/trace.py:725",
        "note": "the forward of the JAX trace_rays_diff inside "
                "make_train_step's jitted step_fn (one XLA executable), "
                "not a Pallas kernel",
        "launches": q_launches["diff_forward"],
        "max_abs_err": t_err,
        "ms": t_rows["test17"]["forward_ms"],
        "plain_ms": t_rows["test17"]["plain_forward_ms"],
        "bound_ms": t_rows["test17"]["bounds"]["forward"]["bound_ms"],
        "bound_by": t_rows["test17"]["bounds"]["forward"]["bound_by"],
        "library_ms": None, "scenes": t_rows}, {
        "name": "diff_backward", "route": "cuda",
        "design": "diff_bwd_kernel<CAP>: a thread a ray, blocks of 128, "
                  "the bounces in reverse from the tape, each hit "
                  "recomputed for its picked surface and root (exact or "
                  "Schlick Fresnel) and its hand-written adjoint taken; "
                  "the branch stack's adjoints (4, 8 or 16 local slots, "
                  "past 16 a device-memory scratch) until the pushing "
                  "bounce, each slot counted from the tape's pushes and "
                  "pops; every table gradient summed in the kernel: for "
                  "each row a live lane of a warp hit (and the lights and "
                  "ambient), an xor butterfly a leaf and bounce, the "
                  "leaves masked by the lanes' row ids, into the warp's "
                  "shared-memory accumulators, warps in order, then "
                  "replay.cu's light sums in block and group order (no "
                  "atomics, no row gradients to device memory); tables "
                  "whose accumulators pass 227 KB a block take the wide "
                  "mode (the rows to device memory, replay_gather's row "
                  "sums)",
        "source": "quadray_tpu_torch/csrc/diff.cu",
        "replaces": "quadray_tpu/parallel/train.py:250",
        "note": "the reverse pass of jax.value_and_grad over the JAX "
                "trace_rays_diff, which XLA derives, not a Pallas kernel",
        "launches": q_launches["diff_backward"],
        "light_sum_launches": q_launches["light_sums"],
        "row_sum_launches": q_launches["backward"],
        "blocks_per_sm": {"test17": t_rows["test17"]["blocks_per_sm"],
                          "demo03's tables": t_demo03["blocks_per_sm"]},
        "max_abs_err": t_err,
        "ms": t_rows["test17"]["backward_ms"],
        "plain_ms": t_rows["test17"]["plain_backward_ms"],
        "bound_ms": t_rows["test17"]["bounds"]["backward"]["bound_ms"],
        "bound_by": t_rows["test17"]["bounds"]["backward"]["bound_by"],
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
